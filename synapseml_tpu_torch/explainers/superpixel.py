"""Superpixel segmentation + masking for image explainers.

A copy of ``synapseml_tpu/explainers/superpixel.py`` (host numpy): the same
segments and masked images, bit for bit.

Role parity with the reference's region-growing clusterer and mask helpers
(``lime/Superpixel.scala:148-267``, ``SuperpixelData``, ``maskImage``;
``SuperpixelTransformer.scala``), but the algorithm is SLIC-style k-means over
(color, position) — a dense, fully-vectorized computation instead of the
reference's per-pixel Java loops. Images are HxWxC float/uint8 arrays (the
framework's decoded-image convention, see ``image/ops.py``).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core import Param, Table, Transformer
from ..core.params import ParamValidators

__all__ = ["slic_superpixels", "mask_image", "SuperpixelTransformer", "SuperpixelData"]


class SuperpixelData:
    """Cluster decomposition: ``clusters[i]`` is an (n_i, 2) int array of (y, x).

    Mirrors the reference's ``SuperpixelData(clusters: Seq[Seq[(Int, Int)]])``.
    """

    def __init__(self, clusters: List[np.ndarray], shape):
        self.clusters = clusters
        self.shape = tuple(shape)

    def __len__(self) -> int:
        return len(self.clusters)

    def to_dict(self):
        return {"shape": list(self.shape),
                "clusters": [c.tolist() for c in self.clusters]}

    @staticmethod
    def from_dict(d):
        return SuperpixelData([np.asarray(c, np.int32).reshape(-1, 2)
                               for c in d["clusters"]], tuple(d["shape"]))


def slic_superpixels(img: np.ndarray, cell_size: float = 16.0,
                     modifier: float = 130.0, n_iter: int = 5) -> SuperpixelData:
    """Segment ``img`` (H, W, C) into ~``(H/cell)*(W/cell)`` superpixels.

    SLIC k-means in (color, position) space: distance
    ``||rgb - c_rgb||^2 + (modifier/cell_size)^2 * ||xy - c_xy||^2``. Higher
    ``modifier`` -> more compact clusters (same knob direction as the
    reference's ``modifier``). Fully vectorized; empty clusters are dropped.
    """
    img = np.asarray(img, np.float64)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    step = max(int(cell_size), 2)
    ys = np.arange(step // 2, H, step)
    xs = np.arange(step // 2, W, step)
    cy, cx = np.meshgrid(ys, xs, indexing="ij")
    centers_xy = np.stack([cy.ravel(), cx.ravel()], axis=1).astype(np.float64)  # (K,2)
    centers_rgb = img[cy.ravel(), cx.ravel()]  # (K,C)

    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    pix_xy = np.stack([yy.ravel(), xx.ravel()], axis=1).astype(np.float64)  # (P,2)
    pix_rgb = img.reshape(-1, C)

    sw = (modifier / cell_size) ** 2
    labels = None
    for _ in range(max(n_iter, 1)):
        # (P,K) color + spatial distance; P*K is fine at explainer image sizes
        dc = ((pix_rgb[:, None, :] - centers_rgb[None]) ** 2).sum(-1)
        ds = ((pix_xy[:, None, :] - centers_xy[None]) ** 2).sum(-1)
        labels = np.argmin(dc + sw * ds, axis=1)
        for k in range(len(centers_xy)):  # K is small (~(H/step)*(W/step))
            sel = labels == k
            if sel.any():
                centers_xy[k] = pix_xy[sel].mean(0)
                centers_rgb[k] = pix_rgb[sel].mean(0)

    clusters = [pix_xy[labels == k].astype(np.int32)
                for k in range(len(centers_xy)) if (labels == k).any()]
    return SuperpixelData(clusters, (H, W))


def mask_image(img: np.ndarray, spd: SuperpixelData, states: np.ndarray,
               background: float = 0.0) -> np.ndarray:
    """Keep clusters whose state is truthy; paint the rest ``background``
    (reference ``Superpixel.maskImage`` paints off-clusters black)."""
    assert len(spd) == len(states), (len(spd), len(states))
    out = np.array(img, copy=True)
    for c, s in zip(spd.clusters, states):
        if not s:
            out[c[:, 0], c[:, 1]] = background
    return out


class SuperpixelTransformer(Transformer):
    """Adds a superpixel-decomposition column for an image column
    (reference ``lime/SuperpixelTransformer.scala``)."""

    input_col = Param("decoded image column (HxWxC arrays)", str, default="image")
    output_col = Param("superpixel decomposition column", str, default="superpixels")
    cell_size = Param("target superpixel cell size in pixels", float, default=16.0,
                      validator=ParamValidators.gt(0))
    modifier = Param("spatial compactness weight", float, default=130.0,
                     validator=ParamValidators.gt(0))

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        col = table[self.input_col]
        out = np.empty(table.num_rows, dtype=object)
        for i in range(table.num_rows):
            out[i] = slic_superpixels(col[i], self.cell_size, self.modifier)
        return table.with_column(self.output_col, out)
