"""LIME explainers: tabular / vector / text / image (port of
``synapseml_tpu/explainers/lime.py``).

Reference: ``explainers/TabularLIME.scala``, ``VectorLIME.scala``,
``TextLIME.scala``, ``ImageLIME.scala`` + the samplers in ``Sampler.scala``
(``LIMETabularSampler``, ``LIMEVectorSampler``, ``LIMETextSampler``,
``LIMEImageSampler``). Sampling semantics per modality:

- tabular/vector: continuous features perturb Gaussian(instance, stddev) with
  the *sampled value* as the regression state and ``|s - x| / stddev`` as the
  per-feature distance; categorical features resample from the background
  frequency table with a 1/0 match state. One identity sample is prepended
  (``LIMETabularSampler.sampleIdentity``).
- text/image: on/off Bernoulli(``sampling_fraction``) masks over tokens /
  superpixels; off features are dropped / painted background; distance is
  ``||1-s||/sqrt(k)``.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core import ComplexParam, Param, Table
from ..core.params import ParamValidators
from .base import LIMEBase
from .samplers import lime_onoff_states, onoff_distances
from .stats import ContinuousFeatureStats, DiscreteFeatureStats, collect_feature_stats
from .superpixel import SuperpixelData, mask_image, slic_superpixels

__all__ = ["TabularLIME", "VectorLIME", "TextLIME", "ImageLIME"]


def _repeat_other_cols(table: Table, repeat: int, exclude: List[str]) -> dict:
    cols = {}
    for c in table.column_names:
        if c not in exclude:
            cols[c] = np.repeat(table[c], repeat, axis=0)
    return cols


class TabularLIME(LIMEBase):
    """LIME over named feature columns (reference ``TabularLIME.scala``)."""

    input_cols = Param("feature columns to explain", list, default=[])
    categorical_cols = Param("subset of input_cols treated as categorical", list,
                             default=[])
    background_data = ComplexParam("background Table for feature statistics "
                                   "(defaults to the input)", object, default=None)

    def _generate_samples(self, table: Table, rng: np.random.Generator):
        cols = self.input_cols
        if not cols:
            raise ValueError(f"{type(self).__name__}({self.uid}): input_cols is empty")
        self._validate_input(table, *cols)
        bg = self.background_data if self.background_data is not None else table
        stats = collect_feature_stats(bg, cols, self.categorical_cols)

        n, k = table.num_rows, len(cols)
        m = self.num_samples + 1  # + identity sample
        states = np.zeros((n, m, k))
        dists = np.zeros((n, m, k))
        sampled_cols = {}
        for j, (c, st) in enumerate(zip(cols, stats)):
            col = table[c]
            if isinstance(st, ContinuousFeatureStats):
                vals = np.asarray(col, np.float64)
                s = st.sample_states(rng, vals, m - 1)          # (n, m-1)
                s = np.concatenate([vals[:, None], s], axis=1)  # identity first
                states[:, :, j] = s
                dists[:, :, j] = st.distance(vals, s)
                sampled_cols[c] = s.reshape(-1).astype(col.dtype
                                                       if col.dtype.kind == "f"
                                                       else np.float64)
            else:
                assert isinstance(st, DiscreteFeatureStats)
                orig = col.astype(object)
                s = st.sample_values(rng, n, m - 1)             # (n, m-1) objects
                full = np.empty((n, m), dtype=object)
                full[:, 0] = orig
                full[:, 1:] = s
                match = (full == orig[:, None])
                states[:, :, j] = match.astype(np.float64)
                dists[:, :, j] = 1.0 - match
                sampled_cols[c] = full.reshape(-1)
        distance = np.linalg.norm(dists, axis=2) / np.sqrt(k)
        sampled_cols.update(_repeat_other_cols(table, m, cols))
        return Table(sampled_cols), states, distance, np.full(n, k)


class VectorLIME(LIMEBase):
    """LIME over a single vector column (reference ``VectorLIME.scala``)."""

    input_col = Param("vector feature column", str, default="features")
    background_data = ComplexParam("background Table for per-dim stddev "
                                   "(defaults to the input)", object, default=None)

    def _generate_samples(self, table: Table, rng: np.random.Generator):
        self._validate_input(table, self.input_col)
        x = np.asarray(table[self.input_col], np.float64)
        if x.ndim != 2:
            raise ValueError(f"{type(self).__name__}({self.uid}): column "
                             f"{self.input_col!r} must hold fixed-width vectors")
        bg = self.background_data if self.background_data is not None else table
        bgx = np.asarray(bg[self.input_col], np.float64)
        std = bgx.std(axis=0)                                    # (k,)

        n, k = x.shape
        m = self.num_samples + 1
        noise = rng.normal(size=(n, m - 1, k)) * std
        states = np.concatenate([x[:, None, :], x[:, None, :] + noise], axis=1)
        safe = np.where(std == 0, 1.0, std)
        dists = np.where(std == 0, 0.0, np.abs(states - x[:, None, :]) / safe)
        distance = np.linalg.norm(dists, axis=2) / np.sqrt(k)
        cols = {self.input_col: states.reshape(n * m, k)}
        cols.update(_repeat_other_cols(table, m, [self.input_col]))
        return Table(cols), states, distance, np.full(n, k)


class TextLIME(LIMEBase):
    """LIME over token lists (reference ``TextLIME.scala`` — the model consumes
    the subsetted token column)."""

    tokens_col = Param("column holding per-row token lists", str, default="tokens")
    sampling_fraction = Param("probability a token stays on", float, default=0.7,
                              validator=ParamValidators.in_range(0, 1))

    def _generate_samples(self, table: Table, rng: np.random.Generator):
        self._validate_input(table, self.tokens_col)
        toks = [list(v) for v in table[self.tokens_col]]
        n = table.num_rows
        ks = np.asarray([len(t) for t in toks])
        if (ks == 0).any():
            raise ValueError(f"{type(self).__name__}({self.uid}): empty token list")
        kmax = int(ks.max())
        m = self.num_samples
        states = lime_onoff_states(rng, n, m, kmax, self.sampling_fraction)
        # mask out padding and compute distances on the true k only
        dist = np.zeros((n, m))
        samples = np.empty(n * m, dtype=object)
        for i in range(n):
            k = int(ks[i])
            states[i, :, k:] = 0.0
            dist[i] = onoff_distances(states[i, :, :k])
            for j in range(m):
                keep = states[i, j, :k].astype(bool)
                samples[i * m + j] = [t for t, on in zip(toks[i], keep) if on]
        cols = {self.tokens_col: samples}
        cols.update(_repeat_other_cols(table, m, [self.tokens_col]))
        return Table(cols), states, dist, ks


class ImageLIME(LIMEBase):
    """LIME over superpixels of a decoded image column (reference
    ``ImageLIME.scala`` + ``LIMEImageSampler``)."""

    input_col = Param("decoded image column (HxWxC arrays)", str, default="image")
    superpixel_col = Param("existing superpixel column (computed when absent)",
                           str, default=None)
    cell_size = Param("superpixel cell size", float, default=16.0,
                      validator=ParamValidators.gt(0))
    modifier = Param("superpixel compactness", float, default=130.0,
                     validator=ParamValidators.gt(0))
    sampling_fraction = Param("probability a superpixel stays on", float,
                              default=0.7, validator=ParamValidators.in_range(0, 1))
    background_value = Param("fill value for masked-off superpixels", float,
                             default=0.0)

    def _superpixels(self, table: Table) -> List[SuperpixelData]:
        if self.superpixel_col:
            self._validate_input(table, self.superpixel_col)
            return list(table[self.superpixel_col])
        return [slic_superpixels(img, self.cell_size, self.modifier)
                for img in table[self.input_col]]

    def _generate_samples(self, table: Table, rng: np.random.Generator):
        self._validate_input(table, self.input_col)
        imgs = table[self.input_col]
        spds = self._superpixels(table)
        n = table.num_rows
        ks = np.asarray([len(s) for s in spds])
        kmax = int(ks.max())
        m = self.num_samples
        states = lime_onoff_states(rng, n, m, kmax, self.sampling_fraction)
        dist = np.zeros((n, m))
        samples = np.empty(n * m, dtype=object)
        for i in range(n):
            k = int(ks[i])
            states[i, :, k:] = 0.0
            dist[i] = onoff_distances(states[i, :, :k])
            for j in range(m):
                samples[i * m + j] = mask_image(imgs[i], spds[i], states[i, j, :k],
                                                self.background_value)
        cols = {self.input_col: samples}
        cols.update(_repeat_other_cols(table, m, [self.input_col]))
        return Table(cols), states, dist, ks
