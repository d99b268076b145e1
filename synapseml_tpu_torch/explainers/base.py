"""Local-explainer base classes (LIME + KernelSHAP orchestration).

Port of ``synapseml_tpu/explainers/base.py`` (reference
``explainers/LocalExplainer.scala``, ``LIMEBase.scala``,
``KernelSHAPBase.scala``: create samples -> score with the wrapped model ->
per-row weighted regression). Sample states for all rows are one batched
array drawn on the host, the wrapped model (any port stage) scores ONE
concatenated Table, and every (row, target-class) regression is solved in
one batch on the explainer's ``device`` (``regression.fit_regression_batch``:
the lasso through hand kernel L, least squares through a batched SVD).

Output schema (matches ``LIMEBase.transformSchema``): ``output_col`` holds one
(T, k) coefficient matrix per row (KernelSHAP: (T, k+1), intercept first),
and ``metrics_col`` holds the per-target r^2 vector.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..core import ComplexParam, Param, Table, Transformer
from ..core.params import ParamValidators
from .regression import fit_regression_batch

__all__ = ["LocalExplainer", "LIMEBase", "KernelSHAPBase"]


class LocalExplainer(Transformer):
    """Shared params: wrapped model, explain target, output columns."""

    _abstract_stage = True

    model = ComplexParam("the fitted model (Transformer) to explain", object,
                         default=None)
    target_col = Param("model output column to explain (probability for "
                       "classifiers, prediction for regressors)", str,
                       default="probability")
    target_classes = Param("class indices to explain for multiclass outputs",
                           list, default=[0])
    target_classes_col = Param("optional column holding per-row class-index "
                               "lists (overrides target_classes)", str,
                               default=None)
    output_col = Param("explanation output column", str, default="explanation")
    metrics_col = Param("per-target r^2 output column", str, default="r2")
    seed = Param("sampling seed", int, default=0)
    device = Param("'cuda[:i]' (default: the GPU) or 'cpu': where the regressions run",
                   str, default=None)

    def _check_ready(self, table: Table) -> None:
        if self.model is None:
            raise ValueError(f"{type(self).__name__}({self.uid}): model is not set")
        for c in (self.output_col, self.metrics_col):
            if c in table:
                raise ValueError(
                    f"{type(self).__name__}({self.uid}): input already has column {c!r}")

    def _target_class_matrix(self, table: Table) -> np.ndarray:
        """(n, T) class indices per input row."""
        n = table.num_rows
        if self.target_classes_col:
            self._validate_input(table, self.target_classes_col)
            rows = [np.atleast_1d(np.asarray(v, np.int64))
                    for v in table[self.target_classes_col]]
            T = len(rows[0]) if rows else 1
            if any(len(r) != T for r in rows):
                raise ValueError("target_classes_col rows must all have the same "
                                 "number of class indices")
            return np.stack(rows) if rows else np.zeros((0, 1), np.int64)
        classes = np.asarray(self.target_classes or [0], np.int64)
        return np.tile(classes, (n, 1))

    def _extract_target(self, scored: Table, classes_per_sample: np.ndarray
                        ) -> np.ndarray:
        """(N,) or (N,C) target column -> (N, T) explained outputs.

        Reference ``HasExplainTarget.extractTarget``: vector outputs are sliced
        at the target class indices; scalar outputs are used as-is.
        """
        if self.target_col not in scored:
            raise ValueError(
                f"{type(self).__name__}({self.uid}): model output has no column "
                f"{self.target_col!r}; available: {scored.column_names}")
        col = scored[self.target_col]
        if col.dtype == object:
            col = np.stack([np.asarray(v, np.float64) for v in col])
        col = np.asarray(col, np.float64)
        if col.ndim == 1:
            return col[:, None].repeat(classes_per_sample.shape[1], axis=1) \
                if classes_per_sample.shape[1] > 1 else col[:, None]
        return np.take_along_axis(col, classes_per_sample, axis=1)


def _slice_rows(res_coef: np.ndarray, r2: np.ndarray, ks: np.ndarray,
                with_intercept: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Unpad per-row coefficient matrices -> object columns."""
    n = res_coef.shape[0]
    out = np.empty(n, dtype=object)
    met = np.empty(n, dtype=object)
    for i in range(n):
        k = int(ks[i])
        if with_intercept:
            # (T, 1 + k): intercept first, as the reference emits
            out[i] = np.concatenate(
                [res_coef[i, :, -1:], res_coef[i, :, :k]], axis=1)
        else:
            out[i] = res_coef[i, :, :k].copy()
        met[i] = r2[i].copy()
    return out, met


class LIMEBase(LocalExplainer):
    """LIME: perturb -> score -> kernel-weighted lasso per row/target."""

    _abstract_stage = True

    num_samples = Param("samples per row", int, default=1000,
                        validator=ParamValidators.gt(0))
    regularization = Param("lasso alpha (0 = weighted least squares)", float,
                           default=0.0, validator=ParamValidators.gt_eq(0))
    kernel_width = Param("distance->weight kernel width", float, default=0.75,
                         validator=ParamValidators.gt(0))

    def _generate_samples(self, table: Table, rng: np.random.Generator):
        """-> (samples_table [n*m rows, row-major], states (n,m,kmax),
        distances (n,m), ks (n,))."""
        raise NotImplementedError

    def _transform(self, table: Table) -> Table:
        self._check_ready(table)
        n = table.num_rows
        if n == 0:
            return table.with_column(self.output_col, np.empty(0, object)) \
                        .with_column(self.metrics_col, np.empty(0, object))
        rng = np.random.default_rng(self.seed)
        samples_table, states, distances, ks = self._generate_samples(table, rng)
        m = states.shape[1]

        classes = self._target_class_matrix(table)           # (n, T)
        per_sample = np.repeat(classes, m, axis=0)           # (n*m, T)
        scored = self.model.transform(samples_table)
        Y = self._extract_target(scored, per_sample)         # (n*m, T)
        T = Y.shape[1]
        Y = Y.reshape(n, m, T)

        t = distances / self.kernel_width
        weights = np.exp(-0.5 * t * t)  # sqrt(exp(-t^2)), LIMEBase kernelFunc

        res = fit_regression_batch(states, Y, weights, alpha=self.regularization,
                                   fit_intercept=True, device=self.device)
        coef = np.asarray(res.coefficients)                  # (n, T, kmax)
        # append intercept slot so _slice_rows can address it uniformly
        coef_ext = np.concatenate(
            [coef, np.asarray(res.intercept)[..., None]], axis=-1)
        out, met = _slice_rows(coef_ext, np.asarray(res.r_squared), ks,
                               with_intercept=False)
        return table.with_column(self.output_col, out) \
                    .with_column(self.metrics_col, met)


class KernelSHAPBase(LocalExplainer):
    """KernelSHAP: coalitions -> score (averaged over background) -> WLS."""

    _abstract_stage = True

    num_samples = Param("coalition budget per row (default 2k+2048, clamped to "
                        "[k+2, 2^k])", int, default=None)
    inf_weight = Param("weight standing in for infinity on the empty/full "
                       "coalitions", float, default=1e8,
                       validator=ParamValidators.gt_eq(1))

    def _generate_samples(self, table: Table, rng: np.random.Generator):
        """-> (samples_table [n*m*b rows, bg fastest], coalitions (n,m,kmax),
        weights (n,m), ks (n,), n_bg b)."""
        raise NotImplementedError

    def _transform(self, table: Table) -> Table:
        self._check_ready(table)
        n = table.num_rows
        if n == 0:
            return table.with_column(self.output_col, np.empty(0, object)) \
                        .with_column(self.metrics_col, np.empty(0, object))
        rng = np.random.default_rng(self.seed)
        samples_table, coalitions, weights, ks, n_bg = \
            self._generate_samples(table, rng)
        m = coalitions.shape[1]

        classes = self._target_class_matrix(table)              # (n, T)
        per_sample = np.repeat(classes, m * n_bg, axis=0)       # (n*m*b, T)
        scored = self.model.transform(samples_table)
        Y = self._extract_target(scored, per_sample)            # (n*m*b, T)
        T = Y.shape[1]
        # mean over the background axis = the reference's
        # groupBy(id, coalition).agg(mean(target))
        Y = Y.reshape(n, m, n_bg, T).mean(axis=2)

        res = fit_regression_batch(coalitions, Y, weights, alpha=0.0,
                                   fit_intercept=True, device=self.device)
        coef_ext = np.concatenate(
            [np.asarray(res.coefficients), np.asarray(res.intercept)[..., None]],
            axis=-1)
        out, met = _slice_rows(coef_ext, np.asarray(res.r_squared), ks,
                               with_intercept=True)
        return table.with_column(self.output_col, out) \
                    .with_column(self.metrics_col, met)
