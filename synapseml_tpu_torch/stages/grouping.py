"""Grouping / repartitioning / balancing stages.

Rebuilds of ``core/.../stages/StratifiedRepartition.scala``, ``EnsembleByKey.scala``,
``ClassBalancer.scala`` and ``SummarizeData.scala``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..core import Estimator, Model, Param, Table, Transformer
from ..core.params import ParamValidators

__all__ = [
    "StratifiedRepartition",
    "EnsembleByKey",
    "ClassBalancer",
    "ClassBalancerModel",
    "SummarizeData",
]


class StratifiedRepartition(Transformer):
    """Repartition so every partition sees every label
    (``StratifiedRepartition.scala``; needed e.g. so each GBDT worker has at least one
    instance of each class — same constraint our distributed GBDT has per mesh shard).

    Modes (reference ``SPConstants``): ``equal`` — resample (with replacement) so labels
    are equally represented; ``original`` — keep original ratios; ``mixed`` — heuristic
    between the two (labels rarer than the equal share are upsampled to it).
    """

    label_col = Param("label column", str, default="label")
    mode = Param("equal | original | mixed", str, default="mixed",
                 validator=ParamValidators.in_list(["equal", "original", "mixed"]))
    seed = Param("rng seed", int, default=0)

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.label_col)
        labels = np.asarray(table[self.label_col])
        uniq, counts = np.unique(labels, return_counts=True)
        n, k = table.num_rows, len(uniq)
        rng = np.random.default_rng(self.seed)
        if self.mode == "original":
            fracs = {u: 1.0 for u in uniq}
        elif self.mode == "equal":
            share = n / k
            fracs = {u: share / c for u, c in zip(uniq, counts)}
        else:  # mixed: upsample only labels below the equal share
            share = n / k
            fracs = {u: max(1.0, share / c) for u, c in zip(uniq, counts)}
        # Per-label cyclic dealing: each label's rows are spread round-robin over
        # partitions (with rotating offsets), so every partition sees every label that
        # has >= 1 row per partition's share — the stage's contract.
        P = table.npartitions
        idx_parts: List[np.ndarray] = []
        for u, c in zip(uniq, counts):
            rows = np.nonzero(labels == u)[0]
            want = int(round(fracs[u] * c))
            if want <= c:
                take = rng.choice(rows, size=want, replace=False)
            else:
                take = np.concatenate([rows, rng.choice(rows, size=want - c, replace=True)])
            idx_parts.append(take)
        idx = np.concatenate(idx_parts)
        order = np.argsort(np.arange(len(idx)) % P, kind="stable")
        return table.take(idx[order])


class EnsembleByKey(Transformer):
    """Group rows by key column(s) and aggregate score columns
    (``EnsembleByKey.scala``): strategy ``mean`` over scalars or fixed-dim vectors;
    ``collapse_group=True`` emits one row per key, else broadcasts the aggregate back
    onto every row of the group."""

    keys = Param("key columns", list, validator=ParamValidators.non_empty())
    cols = Param("columns to aggregate", list, validator=ParamValidators.non_empty())
    new_col_names = Param("output names (defaults to '<strategy>(col)')", list, default=None)
    strategy = Param("aggregation strategy", str, default="mean",
                     validator=ParamValidators.in_list(["mean"]))
    collapse_group = Param("collapse each group to one row", bool, default=True)

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, *self.keys, *self.cols)
        out_names = self.new_col_names or [f"{self.strategy}({c})" for c in self.cols]
        if len(out_names) != len(self.cols):
            raise ValueError(
                f"EnsembleByKey({self.uid}): new_col_names has {len(out_names)} entries "
                f"for {len(self.cols)} cols"
            )
        key_arrays = [table[k] for k in self.keys]
        key_tuples = list(zip(*[a.tolist() for a in key_arrays]))
        uniq: Dict[tuple, int] = {}
        group_of = np.empty(table.num_rows, dtype=np.int64)
        for i, kt in enumerate(key_tuples):
            group_of[i] = uniq.setdefault(kt, len(uniq))
        n_groups = len(uniq)
        agg_cols: Dict[str, np.ndarray] = {}
        for col, out_name in zip(self.cols, out_names):
            v = np.asarray(table[col], dtype=np.float64)
            if v.ndim == 1:
                sums = np.zeros(n_groups)
                np.add.at(sums, group_of, v)
            else:
                sums = np.zeros((n_groups,) + v.shape[1:])
                np.add.at(sums, group_of, v)
            cnt = np.bincount(group_of, minlength=n_groups).astype(np.float64)
            agg = sums / cnt.reshape((-1,) + (1,) * (sums.ndim - 1))
            agg_cols[out_name] = agg
        if self.collapse_group:
            first_row = np.zeros(n_groups, dtype=np.int64)
            seen = np.zeros(n_groups, dtype=bool)
            for i in range(table.num_rows):
                g = group_of[i]
                if not seen[g]:
                    first_row[g] = i
                    seen[g] = True
            base = table.select(*self.keys).take(first_row)
            for name, v in agg_cols.items():
                base = base.with_column(name, v)
            return base
        out = table
        for name, v in agg_cols.items():
            out = out.with_column(name, v[group_of])
        return out


class ClassBalancerModel(Model):
    """Adds a per-row weight column from the fitted label->weight map."""

    input_col = Param("label column", str, default="label")
    output_col = Param("weight column", str, default="weight")
    values = Param("label values (as strings)", list, default=[])
    weights = Param("weight per label value", list, default=[])

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        table_vals = table[self.input_col]
        lut = dict(zip(self.values, self.weights))
        w = np.empty(len(table_vals), dtype=np.float64)
        for i, v in enumerate(table_vals):
            try:
                w[i] = lut[str(v)]
            except KeyError:
                raise ValueError(
                    f"ClassBalancerModel({self.uid}): label {v!r} in column "
                    f"{self.input_col!r} was not seen during fit (known: {self.values})"
                ) from None
        return table.with_column(self.output_col, w)


class ClassBalancer(Estimator):
    """Compute inverse-frequency class weights (``ClassBalancer.scala``):
    weight(label) = max_class_count / count(label)."""

    input_col = Param("label column", str, default="label")
    output_col = Param("weight column", str, default="weight")

    def _fit(self, table: Table) -> ClassBalancerModel:
        self._validate_input(table, self.input_col)
        uniq, counts = np.unique(np.asarray(table[self.input_col]), return_counts=True)
        top = counts.max()
        return ClassBalancerModel(
            input_col=self.input_col,
            output_col=self.output_col,
            values=[str(u) for u in uniq],
            weights=(top / counts).tolist(),
        )


class SummarizeData(Transformer):
    """Per-numeric-column summary statistics table (``SummarizeData.scala``):
    counts (rows, unique, missing/NaN), basic (mean/std/min/max), percentiles
    (P0.5, P1, P5, P25, P50, P75, P95, P99, P99.5)."""

    counts = Param("include count block", bool, default=True)
    basic = Param("include basic stats block", bool, default=True)
    percentiles = Param("include percentiles block", bool, default=True)
    error_threshold = Param("percentile approximation error (API parity; exact here)",
                            float, default=0.0)

    _PCTS = [0.5, 1, 5, 25, 50, 75, 95, 99, 99.5]

    def _transform(self, table: Table) -> Table:
        cols: Dict[str, List] = {"Feature": []}
        rows: List[Dict[str, float]] = []
        for name in table.column_names:
            v = table[name]
            if v.dtype == object or v.ndim != 1 or not np.issubdtype(v.dtype, np.number):
                continue
            x = v.astype(np.float64)
            finite = x[np.isfinite(x)]
            rec: Dict[str, float] = {}
            if self.counts:
                rec["Count"] = float(len(x))
                rec["Unique Value Count"] = float(len(np.unique(finite)))
                rec["Missing Value Count"] = float(len(x) - len(finite))
            if self.basic:
                rec["Mean"] = float(finite.mean()) if len(finite) else np.nan
                rec["Standard Deviation"] = float(finite.std(ddof=1)) if len(finite) > 1 else np.nan
                rec["Min"] = float(finite.min()) if len(finite) else np.nan
                rec["Max"] = float(finite.max()) if len(finite) else np.nan
            if self.percentiles:
                qs = np.percentile(finite, self._PCTS) if len(finite) else [np.nan] * len(self._PCTS)
                for p, q in zip(self._PCTS, qs):
                    rec[f"P{p}"] = float(q)
            cols["Feature"].append(name)
            rows.append(rec)
        if rows:
            for key in rows[0]:
                cols[key] = [r[key] for r in rows]
        return Table(cols)
