"""Balance measures over sensitive feature columns.

Reference semantics (kept exactly, incl. metric names and edge-case
conventions):

- ``FeatureBalanceMeasure`` (``FeatureBalanceMeasure.scala:38-182``): per
  sensitive feature, association metrics between each pair of feature values
  (classA > classB lexically) against a binarized label — dp, sdc, ji, llr,
  pmi, n_pmi_y, n_pmi_xy, s_pmi, krc, t_test (``AssociationMetrics``,
  ``FeatureBalanceMeasure.scala:187-266``); gap(A,B) = 0 when the two values
  are equal (the -inf - -inf guard at ``:144``).
- ``DistributionBalanceMeasure`` (``DistributionBalanceMeasure.scala:38-231``):
  per sensitive feature, distance of the observed value distribution from
  uniform — kl_divergence, js_dist, inf_norm_dist, total_variation_dist,
  wasserstein_dist, chi_sq_stat, chi_sq_p_value.
- ``AggregateBalanceMeasure`` (``AggregateBalanceMeasure.scala``): inequality
  indices over the JOINT distribution of all sensitive columns —
  atkinson_index, theil_l_index, theil_t_index.

These are count statistics over a handful of classes; the math is plain
vectorized numpy (the reference's Spark groupBys exist for data distribution,
not compute).
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict

import numpy as np

from ..core import Param, Table, Transformer
from ..core.params import ParamValidators

__all__ = ["FeatureBalanceMeasure", "DistributionBalanceMeasure",
           "AggregateBalanceMeasure"]

ASSOCIATION_METRICS = ["dp", "sdc", "ji", "llr", "pmi", "n_pmi_y", "n_pmi_xy",
                       "s_pmi", "krc", "t_test"]
DISTRIBUTION_METRICS = ["kl_divergence", "js_dist", "inf_norm_dist",
                        "total_variation_dist", "wasserstein_dist",
                        "chi_sq_stat", "chi_sq_p_value"]
AGGREGATE_METRICS = ["atkinson_index", "theil_l_index", "theil_t_index"]


class _BalanceBase(Transformer):
    """Shared sensitive-column params (reference ``DataBalanceParams``)."""

    _abstract_stage = True

    sensitive_cols = Param("sensitive feature columns", list, default=[])
    output_col = Param("output measure-struct column", str, default="measures")
    verbose = Param("include extra diagnostic fields", bool, default=False)

    def _check(self, table: Table):
        if not self.sensitive_cols:
            raise ValueError(f"{type(self).__name__}({self.uid}): "
                             "sensitive_cols must be set")
        self._validate_input(table, *self.sensitive_cols)


def _association_metrics(n_pos_feature: float, n_feature: float,
                         n_pos: float, n: float) -> Dict[str, float]:
    """Reference ``AssociationMetrics`` (``FeatureBalanceMeasure.scala:203-266``)."""
    p_pos = n_pos / n
    p_feat = n_feature / n
    p_pos_feat = n_pos_feature / n
    dp = p_pos_feat / p_feat
    with np.errstate(divide="ignore"):
        pmi = -math.inf if dp == 0.0 else math.log(dp)
        llr = math.log(p_pos_feat / p_pos) if p_pos > 0 else math.nan
    def _div(a: float, b: float) -> float:
        """IEEE division like the Scala reference: x/0 = ±inf, 0/0 = NaN
        (Python raises ZeroDivisionError; e.g. b = log(p_pos) is 0 when the
        label column is all-positive)."""
        with np.errstate(divide="ignore", invalid="ignore"):
            return float(np.float64(a) / np.float64(b))

    out = {
        "dp": dp,
        "sdc": p_pos_feat / (p_feat + p_pos),
        "ji": p_pos_feat / (p_feat + p_pos - p_pos_feat),
        "llr": llr,
        "pmi": pmi,
        "n_pmi_y": 0.0 if p_pos == 0 else _div(pmi, math.log(p_pos)),
        "n_pmi_xy": 0.0 if p_pos_feat == 0 else _div(pmi,
                                                     math.log(p_pos_feat)),
        "s_pmi": (0.0 if p_feat * p_pos == 0
                  else math.log(p_pos_feat ** 2 / (p_feat * p_pos))
                  if p_pos_feat > 0 else -math.inf),
    }
    a = n ** 2 * (1 - 2 * p_feat - 2 * p_pos + 2 * p_pos_feat
                  + 2 * p_feat * p_pos)
    b = n * (2 * p_feat + 2 * p_pos - 4 * p_pos_feat - 1)
    c = n ** 2 * math.sqrt((p_feat - p_feat ** 2) * (p_pos - p_pos ** 2))
    out["krc"] = (a + b) / c if c != 0 else math.nan
    out["t_test"] = ((p_pos_feat - p_feat * p_pos)
                     / math.sqrt(p_feat * p_pos)) if p_feat * p_pos > 0 \
        else math.nan
    return out


class FeatureBalanceMeasure(_BalanceBase):
    """Association-metric gaps between value pairs of each sensitive feature
    (reference ``FeatureBalanceMeasure.scala:38``)."""

    label_col = Param("binary label column (>0 -> 1)", str, default="label")
    feature_name_col = Param("output: sensitive feature name", str,
                             default="FeatureName")
    class_a_col = Param("output: first compared value", str, default="ClassA")
    class_b_col = Param("output: second compared value", str, default="ClassB")

    def __init__(self, uid=None, **kw):
        kw.setdefault("output_col", "FeatureBalanceMeasure")
        super().__init__(uid=uid, **kw)

    def _transform(self, table: Table) -> Table:
        self._check(table)
        self._validate_input(table, self.label_col)
        y = (np.asarray(table[self.label_col], dtype=np.float64) > 0)
        n = float(len(y))
        n_pos = float(y.sum())
        names, cls_a, cls_b, measures = [], [], [], []
        for col in self.sensitive_cols:
            vals = np.array([str(v) for v in table[col].tolist()])
            levels_arr, inv, counts = np.unique(vals, return_inverse=True,
                                                return_counts=True)
            pos_counts = np.bincount(inv, weights=y.astype(np.float64),
                                     minlength=len(levels_arr))
            levels = [str(v) for v in levels_arr]
            per_value = {
                v: _association_metrics(float(pos_counts[i]),
                                        float(counts[i]), n_pos, n)
                for i, v in enumerate(levels)
            }
            # pairs with A > B (reference crossJoin filter :139)
            for i, a in enumerate(levels):
                for b in levels[:i]:
                    gaps = {}
                    for metric in ASSOCIATION_METRICS:
                        va, vb = per_value[a][metric], per_value[b][metric]
                        gaps[metric] = 0.0 if va == vb else va - vb
                    if self.verbose:
                        gaps["prA"] = per_value[a]["dp"]
                        gaps["prB"] = per_value[b]["dp"]
                    names.append(col)
                    cls_a.append(a)
                    cls_b.append(b)
                    measures.append(gaps)
        meas = np.empty(len(measures), dtype=object)
        meas[:] = measures
        return Table({
            self.feature_name_col: np.array(names, dtype=object),
            self.class_a_col: np.array(cls_a, dtype=object),
            self.class_b_col: np.array(cls_b, dtype=object),
            self.output_col: meas,
        })


def _chi2_sf(x: float, k: int) -> float:
    """Survival function of chi-squared with k dof: 1 - P(k/2, x/2) via the
    regularized incomplete gamma (series + continued fraction, the standard
    Numerical-Recipes-style evaluation; no scipy dependency)."""
    if x <= 0 or k <= 0:
        return 1.0
    a, xx = k / 2.0, x / 2.0
    gln = math.lgamma(a)
    if xx < a + 1.0:
        # lower series
        ap, s, delta = a, 1.0 / a, 1.0 / a
        for _ in range(500):
            ap += 1.0
            delta *= xx / ap
            s += delta
            if abs(delta) < abs(s) * 1e-14:
                break
        p = s * math.exp(-xx + a * math.log(xx) - gln)
        return max(0.0, 1.0 - p)
    # upper continued fraction
    tiny = 1e-300
    b = xx + 1.0 - a
    c = 1.0 / tiny
    d = 1.0 / b
    h = d
    for i in range(1, 500):
        an = -i * (i - a)
        b += 2.0
        d = an * d + b
        d = tiny if abs(d) < tiny else d
        c = b + an / c
        c = tiny if abs(c) < tiny else c
        d = 1.0 / d
        delta = d * c
        h *= delta
        if abs(delta - 1.0) < 1e-14:
            break
    return min(1.0, h * math.exp(-xx + a * math.log(xx) - gln))


class DistributionBalanceMeasure(_BalanceBase):
    """Observed-vs-uniform distribution distances per sensitive feature
    (reference ``DistributionBalanceMeasure.scala:38``)."""

    feature_name_col = Param("output: sensitive feature name", str,
                             default="FeatureName")

    def __init__(self, uid=None, **kw):
        kw.setdefault("output_col", "DistributionBalanceMeasure")
        super().__init__(uid=uid, **kw)

    def _transform(self, table: Table) -> Table:
        self._check(table)
        n = float(table.num_rows)
        names, measures = [], []
        for col in self.sensitive_cols:
            counts = np.array(sorted(
                Counter(str(v) for v in table[col].tolist()).values()),
                dtype=np.float64)
            k = len(counts)
            obs = counts / n
            ref = np.full(k, 1.0 / k)
            ref_count = ref * n
            with np.errstate(divide="ignore", invalid="ignore"):
                kl = float(np.sum(obs * np.log(obs / ref)))
                avg = (obs + ref) / 2
                js = math.sqrt((np.sum(ref * np.log(ref / avg))
                                + np.sum(obs * np.log(obs / avg))) / 2)
            absdiff = np.abs(obs - ref)
            chi = float(np.sum((counts - ref_count) ** 2 / ref_count))
            measures.append({
                "kl_divergence": kl,
                "js_dist": js,
                "inf_norm_dist": float(absdiff.max()),
                "total_variation_dist": float(absdiff.sum() * 0.5),
                "wasserstein_dist": float(absdiff.mean()),
                "chi_sq_stat": chi,
                "chi_sq_p_value": _chi2_sf(chi, k - 1),
            })
            names.append(col)
        meas = np.empty(len(measures), dtype=object)
        meas[:] = measures
        return Table({self.feature_name_col: np.array(names, dtype=object),
                      self.output_col: meas})


class AggregateBalanceMeasure(_BalanceBase):
    """Inequality indices over the joint sensitive distribution
    (reference ``AggregateBalanceMeasure.scala``)."""

    epsilon = Param("Atkinson epsilon (1 - alpha)", float, default=1.0)
    error_tolerance = Param("Atkinson alpha~0 switch tolerance", float,
                            default=1e-12, validator=ParamValidators.gt(0))

    def __init__(self, uid=None, **kw):
        kw.setdefault("output_col", "AggregateBalanceMeasure")
        super().__init__(uid=uid, **kw)

    def _transform(self, table: Table) -> Table:
        self._check(table)
        n = float(table.num_rows)
        joint = Counter(
            tuple(str(table[c][i]) for c in self.sensitive_cols)
            for i in range(table.num_rows))
        probs = np.array(list(joint.values()), dtype=np.float64) / n
        k = float(len(probs))
        norm = probs / probs.mean()
        alpha = 1.0 - self.epsilon
        if abs(alpha) < self.error_tolerance:
            # exp(sum/k), not exp(sum)^(1/k): the un-rooted product underflows
            # to 0 for a few hundred skewed classes, pinning the index at 1
            atkinson = 1.0 - float(np.exp(np.sum(np.log(norm)) / k))
        else:
            atkinson = 1.0 - float(np.sum(norm ** alpha) / k) ** (1.0 / alpha)
        measures = {
            "atkinson_index": atkinson,
            "theil_l_index": float(-np.sum(np.log(norm)) / k),
            "theil_t_index": float(np.sum(norm * np.log(norm)) / k),
        }
        meas = np.empty(1, dtype=object)
        meas[0] = measures
        return Table({self.output_col: meas})
