"""Per-partition scalers (reference ``cyber/feature/scalers.py``).

``StandardScalarScaler``: per-partition (x - mean) / std_pop, falling back to
x - mean when std == 0 (reference ``StandardScalarScalerModel:156-183``).
``LinearScalarScaler``: per-partition linear map onto
[min_required, max_required]; degenerate partitions (min == max) map to the
midpoint (reference ``LinearScalarScalerModel:241-280``).

Stats are keyed by the partition value (``partition_key=None`` = one global
partition), stored as a plain dict so models persist via the JSON path.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..core import ComplexParam, Estimator, Model, Param, Table

__all__ = ["StandardScalarScaler", "StandardScalarScalerModel",
           "LinearScalarScaler", "LinearScalarScalerModel"]

_GLOBAL = "__global__"


def _partition_values(table: Table, partition_key: Optional[str], n: int):
    if partition_key is None:
        return np.array([_GLOBAL] * n, dtype=object)
    return np.array([str(v) for v in table[partition_key].tolist()],
                    dtype=object)


class _ScalerBase(Estimator):
    _abstract_stage = True

    input_col = Param("column to scale", str, default="input")
    output_col = Param("scaled output column", str, default="output")
    partition_key = Param("partition column (None = global)", str, default=None)

    def _group_stats(self, table: Table, stat_fn) -> Dict[str, list]:
        self._validate_input(table, self.input_col)
        if self.partition_key is not None:
            self._validate_input(table, self.partition_key)
        x = np.asarray(table[self.input_col], dtype=np.float64)
        parts = _partition_values(table, self.partition_key, len(x))
        return {p: stat_fn(x[parts == p]) for p in np.unique(parts)}


class StandardScalarScaler(_ScalerBase):
    coefficient_factor = Param("multiply scaled output by this", float,
                               default=1.0)

    def _fit(self, table: Table) -> "StandardScalarScalerModel":
        stats = self._group_stats(
            table, lambda v: [float(v.mean()), float(v.std())])
        return StandardScalarScalerModel(
            input_col=self.input_col, output_col=self.output_col,
            partition_key=self.partition_key,
            coefficient_factor=self.coefficient_factor,
            per_group_stats=stats)


class StandardScalarScalerModel(Model):
    input_col = Param("column to scale", str, default="input")
    output_col = Param("scaled output column", str, default="output")
    partition_key = Param("partition column", str, default=None)
    coefficient_factor = Param("output multiplier", float, default=1.0)
    per_group_stats = ComplexParam("partition -> [mean, std_pop]", dict,
                                   default=None)

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        x = np.asarray(table[self.input_col], dtype=np.float64)
        parts = _partition_values(table, self.partition_key, len(x))
        out = np.empty(len(x))
        for p in np.unique(parts):
            m = parts == p
            mean, std = self.per_group_stats.get(str(p), [0.0, 1.0])
            if std != 0.0:
                out[m] = self.coefficient_factor * (x[m] - mean) / std
            else:
                out[m] = x[m] - mean
        return table.with_column(self.output_col, out)


class LinearScalarScaler(_ScalerBase):
    min_required_value = Param("target range lower bound", float, default=0.0)
    max_required_value = Param("target range upper bound", float, default=1.0)

    def _fit(self, table: Table) -> "LinearScalarScalerModel":
        stats = self._group_stats(
            table, lambda v: [float(v.min()), float(v.max())])
        return LinearScalarScalerModel(
            input_col=self.input_col, output_col=self.output_col,
            partition_key=self.partition_key,
            min_required_value=self.min_required_value,
            max_required_value=self.max_required_value,
            per_group_stats=stats)


class LinearScalarScalerModel(Model):
    input_col = Param("column to scale", str, default="input")
    output_col = Param("scaled output column", str, default="output")
    partition_key = Param("partition column", str, default=None)
    min_required_value = Param("target range lower bound", float, default=0.0)
    max_required_value = Param("target range upper bound", float, default=1.0)
    per_group_stats = ComplexParam("partition -> [min, max]", dict,
                                   default=None)

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        x = np.asarray(table[self.input_col], dtype=np.float64)
        parts = _partition_values(table, self.partition_key, len(x))
        out = np.empty(len(x))
        for p in np.unique(parts):
            m = parts == p
            lo, hi = self.per_group_stats.get(str(p), [0.0, 0.0])
            delta = hi - lo
            if delta != 0.0:
                a = (self.max_required_value - self.min_required_value) / delta
                b = self.max_required_value - a * hi
                out[m] = a * x[m] + b
            else:
                out[m] = (self.min_required_value
                          + self.max_required_value) / 2.0
        return table.with_column(self.output_col, out)
