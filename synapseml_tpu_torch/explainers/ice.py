"""ICE / PDP transformer (port of ``synapseml_tpu/explainers/ice.py``).

Reference: ``explainers/ICEExplainer.scala`` (``ICETransformer``) +
``ICEFeature.scala`` (``ICECategoricalFeature`` numTopValues,
``ICENumericFeature`` numSplits/rangeMin/rangeMax). ``kind='individual'``
emits one dependence map per input row (ICE); ``kind='average'`` emits a
single-row partial-dependence table (PDP).

The grid explode is batched: for each feature, one Table of n*V rows is scored
in a single model call (the reference explodes an array literal per row).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..core import Param, Table
from ..core.params import ParamValidators
from .base import LocalExplainer

__all__ = ["ICETransformer", "ICECategoricalFeature", "ICENumericFeature"]


class ICECategoricalFeature:
    """Reference ``ICECategoricalFeature(name, numTopValues, outputColName)``."""

    DEFAULT_NUM_TOP_VALUES = 100

    def __init__(self, name: str, num_top_values: Optional[int] = None,
                 output_col_name: Optional[str] = None):
        if num_top_values is not None and num_top_values <= 0:
            raise ValueError("num_top_values must be > 0")
        self.name = name
        self.num_top_values = num_top_values or self.DEFAULT_NUM_TOP_VALUES
        self.output_col_name = output_col_name or f"{name}_dependence"

    def grid(self, col: np.ndarray) -> List[Any]:
        vals, counts = np.unique(col.astype(object), return_counts=True)
        order = np.argsort(-counts, kind="stable")
        return [vals[i] for i in order[: self.num_top_values]]


class ICENumericFeature:
    """Reference ``ICENumericFeature(name, numSplits, rangeMin, rangeMax,
    outputColName)``."""

    DEFAULT_NUM_SPLITS = 10

    def __init__(self, name: str, num_splits: Optional[int] = None,
                 range_min: Optional[float] = None,
                 range_max: Optional[float] = None,
                 output_col_name: Optional[str] = None):
        if num_splits is not None and num_splits <= 0:
            raise ValueError("num_splits must be > 0")
        if range_min is not None and range_max is not None and range_min > range_max:
            raise ValueError("range_min must be <= range_max")
        self.name = name
        self.num_splits = num_splits or self.DEFAULT_NUM_SPLITS
        self.range_min = range_min
        self.range_max = range_max
        self.output_col_name = output_col_name or f"{name}_dependence"

    def grid(self, col: np.ndarray) -> List[float]:
        vals = np.asarray(col, np.float64)
        lo = self.range_min if self.range_min is not None else float(np.nanmin(vals))
        hi = self.range_max if self.range_max is not None else float(np.nanmax(vals))
        return list(np.linspace(lo, hi, self.num_splits + 1))


def _as_feature(spec, categorical: bool):
    if isinstance(spec, (ICECategoricalFeature, ICENumericFeature)):
        return spec
    if isinstance(spec, str):
        spec = {"name": spec}
    if categorical:
        return ICECategoricalFeature(spec["name"], spec.get("num_top_values"),
                                     spec.get("output_col_name"))
    return ICENumericFeature(spec["name"], spec.get("num_splits"),
                             spec.get("range_min"), spec.get("range_max"),
                             spec.get("output_col_name"))


class ICETransformer(LocalExplainer):
    """One-way feature-dependence explainer (reference ``ICETransformer``)."""

    kind = Param("'individual' (ICE per row) or 'average' (PDP)", str,
                 default="individual",
                 validator=ParamValidators.in_list(["individual", "average"]))
    categorical_features = Param("categorical feature specs: names or dicts "
                                 "{name, num_top_values, output_col_name}", list,
                                 default=[])
    numeric_features = Param("numeric feature specs: names or dicts "
                             "{name, num_splits, range_min, range_max, "
                             "output_col_name}", list, default=[])
    num_samples = Param("optional row subsample before computing dependence",
                        int, default=None)

    def _transform(self, table: Table) -> Table:
        if self.model is None:
            raise ValueError(f"{type(self).__name__}({self.uid}): model is not set")
        feats = ([_as_feature(f, True) for f in self.categorical_features]
                 + [_as_feature(f, False) for f in self.numeric_features])
        if not feats:
            raise ValueError(f"{type(self).__name__}({self.uid}): no features "
                             "given; set categorical_features/numeric_features")
        if self.num_samples:
            table = table.shuffle(self.seed).slice(
                0, min(self.num_samples, table.num_rows))
        n = table.num_rows
        classes = self._target_class_matrix(table)                # (n, T)

        dep_cols: Dict[str, np.ndarray] = {}
        for f in feats:
            self._validate_input(table, f.name)
            grid = f.grid(table[f.name])
            V = len(grid)
            # n*V rows: every row scored at every grid value
            cols = {}
            for c in table.column_names:
                cols[c] = np.repeat(table[c], V, axis=0)
            gv = np.asarray(grid, dtype=object)
            col = np.tile(gv, n)
            if isinstance(f, ICENumericFeature):
                col = col.astype(np.float64)
            cols[f.name] = col
            scored = self.model.transform(Table(cols))
            Y = self._extract_target(scored, np.repeat(classes, V, axis=0))
            Y = Y.reshape(n, V, -1)                               # (n, V, T)
            if self.kind == "average":
                pdp = Y.mean(axis=0)                              # (V, T)
                out = np.empty(1, dtype=object)
                out[0] = {grid[v]: pdp[v].copy() for v in range(V)}
            else:
                out = np.empty(n, dtype=object)
                for i in range(n):
                    out[i] = {grid[v]: Y[i, v].copy() for v in range(V)}
            dep_cols[f.output_col_name] = out

        if self.kind == "average":
            return Table(dep_cols)
        res = table
        for name, col in dep_cols.items():
            res = res.with_column(name, col)
        return res
