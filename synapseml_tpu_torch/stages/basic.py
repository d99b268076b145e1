"""Basic utility transformers (the port's copy of the JAX package's
``stages/basic.py``).

Rebuilds of the small stages in ``core/src/main/scala/.../stages/``:
``DropColumns.scala``, ``SelectColumns.scala``, ``RenameColumn.scala``,
``Repartition.scala``, ``Cacher.scala``, ``Lambda.scala``, ``UDFTransformer.scala``,
``Explode.scala``, ``Timer.scala``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, List

import numpy as np

from ..core import ComplexParam, Estimator, Model, Param, Table, Transformer
from ..core.clock import StopWatch
from ..core.params import ParamValidators

__all__ = [
    "DropColumns",
    "SelectColumns",
    "RenameColumn",
    "Repartition",
    "Cacher",
    "Lambda",
    "UDFTransformer",
    "Explode",
    "Timer",
    "TimerModel",
]

_logger = logging.getLogger("synapseml_tpu_torch.stages")


class DropColumns(Transformer):
    """Drop the listed columns (``DropColumns.scala``)."""

    cols = Param("columns to drop", list, default=[])

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, *self.cols)
        return table.drop(*self.cols)


class SelectColumns(Transformer):
    """Keep only the listed columns (``SelectColumns.scala``)."""

    cols = Param("columns to keep", list, validator=ParamValidators.non_empty())

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, *self.cols)
        return table.select(*self.cols)


class RenameColumn(Transformer):
    """Rename one column (``RenameColumn.scala``)."""

    input_col = Param("existing column name", str)
    output_col = Param("new column name", str)

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        return table.rename({self.input_col: self.output_col})


class Repartition(Transformer):
    """Change the logical partition count (``Repartition.scala``).

    ``disable=True`` passes through unchanged, mirroring the reference param.
    """

    n = Param("target partition count", int, validator=ParamValidators.gt(0))
    disable = Param("if true, pass through unchanged", bool, default=False)

    def _transform(self, table: Table) -> Table:
        if self.disable:
            return table
        return table.repartition(self.n)


class Cacher(Transformer):
    """Materialization hint (``Cacher.scala``). The eager columnar substrate is always
    materialized, so this is API-parity no-op (``disable`` kept for compatibility)."""

    disable = Param("if true, do nothing", bool, default=False)

    def _transform(self, table: Table) -> Table:
        return table.cache() if not self.disable else table


class Lambda(Transformer):
    """Arbitrary ``Table -> Table`` function stage (``Lambda.scala``).

    The reference warns these don't serialize their closures; same here — save/load
    persists only metadata, and loading yields an identity lambda with a warning.
    """

    transform_func = ComplexParam("function Table -> Table", object, default=None)

    def _transform(self, table: Table) -> Table:
        fn = self.transform_func
        if fn is None:
            _logger.warning("Lambda(%s): no transform_func (deserialized?); passing through", self.uid)
            return table
        return fn(table)


class UDFTransformer(Transformer):
    """Apply a python function to column(s) producing a new column
    (``UDFTransformer.scala``; ``UDFUtils.oldUdf`` injection).

    ``vectorized=True`` hands the whole column array(s) to ``udf`` (preferred — lets the
    udf be a torch function over the full batch); otherwise applies per row.
    """

    input_col = Param("single input column", str, default=None)
    input_cols = Param("multiple input columns", list, default=None)
    output_col = Param("output column", str, default="output")
    udf = ComplexParam("python callable", object, default=None)
    vectorized = Param("call udf on whole columns instead of per-row", bool, default=False)

    def _transform(self, table: Table) -> Table:
        if self.udf is None:
            raise ValueError(f"UDFTransformer({self.uid}): udf is not set")
        cols = self.input_cols if self.input_cols else [self.input_col]
        if cols == [None]:
            raise ValueError("set input_col or input_cols")
        self._validate_input(table, *cols)
        arrays = [table[c] for c in cols]
        if self.vectorized:
            out = self.udf(*arrays)
        else:
            vals = [self.udf(*row) for row in zip(*arrays)]
            out = vals
        return table.with_column(self.output_col, out)


class Explode(Transformer):
    """One row per element of a sequence column, other columns replicated
    (``Explode.scala``)."""

    input_col = Param("sequence column to explode", str)
    output_col = Param("output column (defaults to input)", str, default=None)

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        col = table[self.input_col]
        lengths = np.array([len(v) for v in col], dtype=np.int64)
        idx = np.repeat(np.arange(table.num_rows), lengths)
        flat: List[Any] = [x for v in col for x in v]
        out_name = self.output_col or self.input_col
        base = table.drop(self.input_col).take(idx) if out_name == self.input_col else table.take(idx)
        return base.with_column(out_name, flat)


class TimerModel(Model):
    """Fitted Timer: times the wrapped fitted stage's transform.

    ``profile_dir`` additionally writes a ``torch.profiler`` trace of the
    transform into that directory (a Chrome trace, with the device's
    kernels when the transform runs on the GPU)."""

    inner_model = ComplexParam("wrapped fitted transformer", object, default=None)
    log_to_logger = Param("emit timing to logger", bool, default=True)
    profile_dir = Param("capture a torch profiler trace into this directory",
                        str, default=None)

    def _transform(self, table: Table) -> Table:
        sw = StopWatch()
        if self.profile_dir:
            with _profile_trace(self.profile_dir), sw.measure():
                out = self.inner_model.transform(table)
        else:
            with sw.measure():
                out = self.inner_model.transform(table)
        self._last_elapsed_s = sw.elapsed_s
        if self.log_to_logger:
            _logger.info("%s.transform took %.4fs", type(self.inner_model).__name__, sw.elapsed_s)
        return out


@contextlib.contextmanager
def _profile_trace(log_dir: str):
    """A ``torch.profiler`` trace of the block, written to
    ``log_dir/trace_<pid>_<ns>.json``; the device's activity is traced
    when a GPU is present."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Timer(Estimator):
    """Time fit/transform of a wrapped stage (``Timer.scala``)."""

    stage = ComplexParam("wrapped stage", object, default=None)
    log_to_logger = Param("emit timing to logger", bool, default=True)

    def _fit(self, table: Table) -> TimerModel:
        st = self.stage
        sw = StopWatch()
        if isinstance(st, Estimator):
            with sw.measure():
                inner = st.fit(table)
        else:
            inner = st
        if self.log_to_logger and sw.elapsed_ns:
            _logger.info("%s.fit took %.4fs", type(st).__name__, sw.elapsed_s)
        m = TimerModel(inner_model=inner, log_to_logger=self.log_to_logger)
        m._last_fit_s = sw.elapsed_s
        return m
