"""KernelSHAP explainers: tabular / vector / text / image (port of
``synapseml_tpu/explainers/shap.py``).

Reference: ``explainers/TabularSHAP.scala``, ``VectorSHAP.scala``,
``TextSHAP.scala``, ``ImageSHAP.scala`` + ``KernelSHAPSampler.scala``.

Per modality:
- tabular/vector: a coalition keeps the instance's value where its bit is 1 and
  the background row's value where 0 (``KernelSHAPTabularSampler
  .createNewSample``); every background row is scored for every coalition and
  the targets averaged — the reference's crossJoin + groupBy(coalition) mean.
- text/image: off tokens are dropped / off superpixels painted background (no
  background rows — b = 1).

Variable feature counts (text/image) are padded: padded coalition rows carry
weight 0 and score the original observation, padded feature columns are all
zero so the minimum-norm/CD solvers assign them exactly 0.
"""

from __future__ import annotations

import numpy as np

from ..core import ComplexParam, Param, Table
from ..core.params import ParamValidators
from .base import KernelSHAPBase
from .lime import _repeat_other_cols
from .samplers import effective_num_samples, kernel_shap_coalitions
from .superpixel import mask_image, slic_superpixels

__all__ = ["TabularSHAP", "VectorSHAP", "TextSHAP", "ImageSHAP"]


class TabularSHAP(KernelSHAPBase):
    """KernelSHAP over named feature columns (reference ``TabularSHAP.scala``)."""

    input_cols = Param("feature columns to explain", list, default=[])
    background_data = ComplexParam("background Table (required; every row is "
                                   "scored per coalition)", object, default=None)

    def _generate_samples(self, table: Table, rng: np.random.Generator):
        cols = self.input_cols
        if not cols:
            raise ValueError(f"{type(self).__name__}({self.uid}): input_cols is empty")
        self._validate_input(table, *cols)
        bg = self.background_data
        if bg is None:
            raise ValueError(f"{type(self).__name__}({self.uid}): background_data "
                             "is required for tabular SHAP")
        n, k, b = table.num_rows, len(cols), bg.num_rows
        m = effective_num_samples(self.num_samples, k)
        coalitions = np.zeros((n, m, k))
        weights = np.zeros((n, m))
        for i in range(n):
            coalitions[i], weights[i] = kernel_shap_coalitions(
                rng, k, m, self.inf_weight)

        # sample layout: row-major (instance, coalition, background)
        sampled = {}
        for j, c in enumerate(cols):
            inst = table[c]                      # (n,)
            bgv = bg[c]                          # (b,)
            s = coalitions[:, :, j]              # (n, m)
            on = np.repeat(s.astype(bool).reshape(n * m), b)
            inst_rep = np.repeat(inst, m * b, axis=0)
            bg_rep = np.tile(bgv, n * m)
            out = np.where(on, inst_rep, bg_rep)
            sampled[c] = out
        sampled.update(_repeat_other_cols(table, m * b, cols))
        return Table(sampled), coalitions, weights, np.full(n, k), b


class VectorSHAP(KernelSHAPBase):
    """KernelSHAP over a vector column (reference ``VectorSHAP.scala``)."""

    input_col = Param("vector feature column", str, default="features")
    background_data = ComplexParam("background Table (required)", object,
                                   default=None)

    def _generate_samples(self, table: Table, rng: np.random.Generator):
        self._validate_input(table, self.input_col)
        x = np.asarray(table[self.input_col], np.float64)     # (n, k)
        bg = self.background_data
        if bg is None:
            raise ValueError(f"{type(self).__name__}({self.uid}): background_data "
                             "is required for vector SHAP")
        bgx = np.asarray(bg[self.input_col], np.float64)       # (b, k)
        n, k = x.shape
        b = bgx.shape[0]
        m = effective_num_samples(self.num_samples, k)
        coalitions = np.zeros((n, m, k))
        weights = np.zeros((n, m))
        for i in range(n):
            coalitions[i], weights[i] = kernel_shap_coalitions(
                rng, k, m, self.inf_weight)
        # s*x + (1-s)*bg, broadcast to (n, m, b, k)
        mix = (coalitions[:, :, None, :] * x[:, None, None, :]
               + (1.0 - coalitions[:, :, None, :]) * bgx[None, None, :, :])
        cols = {self.input_col: mix.reshape(n * m * b, k)}
        cols.update(_repeat_other_cols(table, m * b, [self.input_col]))
        return Table(cols), coalitions, weights, np.full(n, k), b


class TextSHAP(KernelSHAPBase):
    """KernelSHAP over token lists (reference ``TextSHAP.scala``)."""

    tokens_col = Param("column holding per-row token lists", str, default="tokens")

    def _generate_samples(self, table: Table, rng: np.random.Generator):
        self._validate_input(table, self.tokens_col)
        toks = [list(v) for v in table[self.tokens_col]]
        n = table.num_rows
        ks = np.asarray([len(t) for t in toks])
        if (ks == 0).any():
            raise ValueError(f"{type(self).__name__}({self.uid}): empty token list")
        kmax = int(ks.max())
        ms = [effective_num_samples(self.num_samples, int(k)) for k in ks]
        m = max(ms)
        coalitions = np.zeros((n, m, kmax))
        weights = np.zeros((n, m))
        samples = np.empty(n * m, dtype=object)
        for i in range(n):
            k, mi = int(ks[i]), ms[i]
            S, w = kernel_shap_coalitions(rng, k, mi, self.inf_weight)
            coalitions[i, :mi, :k] = S
            weights[i, :mi] = w
            coalitions[i, mi:, :k] = 1.0        # weight-0 padding: full coalition
            for j in range(m):
                keep = coalitions[i, j, :k].astype(bool)
                samples[i * m + j] = [t for t, on in zip(toks[i], keep) if on]
        cols = {self.tokens_col: samples}
        cols.update(_repeat_other_cols(table, m, [self.tokens_col]))
        return Table(cols), coalitions, weights, ks, 1


class ImageSHAP(KernelSHAPBase):
    """KernelSHAP over superpixels (reference ``ImageSHAP.scala``)."""

    input_col = Param("decoded image column (HxWxC arrays)", str, default="image")
    superpixel_col = Param("existing superpixel column (computed when absent)",
                           str, default=None)
    cell_size = Param("superpixel cell size", float, default=16.0,
                      validator=ParamValidators.gt(0))
    modifier = Param("superpixel compactness", float, default=130.0,
                     validator=ParamValidators.gt(0))
    background_value = Param("fill value for masked-off superpixels", float,
                             default=0.0)

    def _generate_samples(self, table: Table, rng: np.random.Generator):
        self._validate_input(table, self.input_col)
        imgs = table[self.input_col]
        if self.superpixel_col:
            self._validate_input(table, self.superpixel_col)
            spds = list(table[self.superpixel_col])
        else:
            spds = [slic_superpixels(img, self.cell_size, self.modifier)
                    for img in imgs]
        n = table.num_rows
        ks = np.asarray([len(s) for s in spds])
        kmax = int(ks.max())
        ms = [effective_num_samples(self.num_samples, int(k)) for k in ks]
        m = max(ms)
        coalitions = np.zeros((n, m, kmax))
        weights = np.zeros((n, m))
        samples = np.empty(n * m, dtype=object)
        for i in range(n):
            k, mi = int(ks[i]), ms[i]
            S, w = kernel_shap_coalitions(rng, k, mi, self.inf_weight)
            coalitions[i, :mi, :k] = S
            weights[i, :mi] = w
            coalitions[i, mi:, :k] = 1.0
            for j in range(m):
                samples[i * m + j] = mask_image(imgs[i], spds[i],
                                                coalitions[i, j, :k],
                                                self.background_value)
        cols = {self.input_col: samples}
        cols.update(_repeat_other_cols(table, m, [self.input_col]))
        return Table(cols), coalitions, weights, ks, 1
