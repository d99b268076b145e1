"""Quantile feature binning — the dense path of the JAX package's ``BinMapper``.

A copy of ``synapseml_tpu/gbdt/binning.py`` for dense numeric features: the
same numpy RNG and quantile rule, so a mapper fitted here has the same edges
as the reference's, and ``to_dict``/``from_dict`` read and write the same
dictionary. Categorical features, ``max_bin_by_feature`` and the sparse (CSR)
path are not ported yet and raise ``NotImplementedError``.

Bin layout per feature: bins ``0..n_bins-2`` cover finite values by quantile
ranges; NaN and infinities map to the last bin (the missing bin). Split
"value <= upper_edge[b]" is "bin <= b"; NaN compares false, so missing rows
follow the right branch.

:meth:`BinMapper.transform_torch` bins a tensor on its own device (a
``searchsorted`` over the f64 edges, identical to the numpy transform).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

__all__ = ["BinMapper", "bin_dtype"]


class BinMapper:
    """Fit per-feature quantile bin edges; transform float matrices to int bins."""

    def __init__(self, max_bin: int = 255, sample_cnt: int = 200_000, seed: int = 0):
        if max_bin < 2:
            raise ValueError(f"max_bin must be >= 2, got {max_bin}")
        if sample_cnt < 1:
            raise ValueError(f"sample_cnt must be >= 1, got {sample_cnt}")
        self.max_bin = int(max_bin)
        self.sample_cnt = int(sample_cnt)
        self.seed = seed
        self.upper_edges: Optional[List[np.ndarray]] = None
        self.n_features: Optional[int] = None

    @property
    def n_bins(self) -> int:
        """Total bins per feature including the reserved missing bin."""
        return self.max_bin + 1

    @property
    def missing_bin(self) -> int:
        return self.max_bin

    def sample_indices(self, n: int) -> Optional[np.ndarray]:
        """Row indices ``fit`` subsamples for edge estimation (None = all)."""
        if n <= self.sample_cnt:
            return None
        rng = np.random.default_rng(self.seed)
        return rng.choice(n, size=self.sample_cnt, replace=False)

    def fit(self, x: np.ndarray) -> "BinMapper":
        x = np.asarray(x)
        n, d = x.shape
        idx = self.sample_indices(n)
        sample = np.asarray(x if idx is None else x[idx], dtype=np.float64)
        edges: List[np.ndarray] = []
        for j in range(d):
            col = sample[:, j]
            col = col[np.isfinite(col)]
            if col.size == 0:
                edges.append(np.array([np.inf]))
                continue
            uniq = np.unique(col)
            if len(uniq) <= self.max_bin:
                # exact: one bin per distinct value; upper edge = midpoint to next
                ue = np.empty(len(uniq))
                ue[:-1] = (uniq[:-1] + uniq[1:]) / 2
                ue[-1] = np.inf
                edges.append(ue)
            else:
                qs = np.quantile(col, np.linspace(0, 1, self.max_bin + 1)[1:-1])
                edges.append(np.concatenate([np.unique(qs), [np.inf]]))
        self.upper_edges = edges
        self.n_features = d
        return self

    def transform_column(self, j: int, col: np.ndarray) -> np.ndarray:
        """Bin one feature's raw values (NaN -> missing bin)."""
        out = np.searchsorted(self.upper_edges[j], col, side="left").astype(np.int32)
        np.clip(out, 0, len(self.upper_edges[j]) - 1, out=out)
        miss = ~np.isfinite(col)
        if miss.any():
            out[miss] = self.missing_bin
        return out

    def _check_fitted(self, d: int) -> None:
        if self.upper_edges is None:
            raise RuntimeError("BinMapper.transform called before fit")
        if d != self.n_features:
            raise ValueError(f"expected {self.n_features} features, got {d}")

    def transform(self, x: np.ndarray) -> np.ndarray:
        """Float matrix -> int32 bin matrix (NaN -> missing bin)."""
        x = np.asarray(x, dtype=np.float64)
        n, d = x.shape
        self._check_fitted(d)
        out = np.empty((n, d), dtype=np.int32)
        for j in range(d):
            out[:, j] = self.transform_column(j, x[:, j])
        return out

    def transform_torch(self, x: torch.Tensor) -> torch.Tensor:
        """(n, d) float tensor -> (n, d) bins of :func:`bin_dtype` on ``x``'s device.

        Compares in float64 against the f64 edges, so it gives exactly what
        :meth:`transform` gives for the same values."""
        n, d = x.shape
        self._check_fitted(d)
        emax = max(len(e) for e in self.upper_edges)
        table = np.full((d, emax), np.inf)
        for j, e in enumerate(self.upper_edges):
            table[j, : len(e)] = e
        last = torch.tensor([len(e) - 1 for e in self.upper_edges], device=x.device)
        xt = x.to(torch.float64).t().contiguous()                    # (d, n)
        t = torch.from_numpy(table).to(x.device)
        out = torch.searchsorted(t, xt, side="left")                 # (d, n)
        out = torch.minimum(out, last[:, None])
        out = torch.where(torch.isfinite(xt), out, self.missing_bin)
        return out.t().to(torch_bin_dtype(self.n_bins)).contiguous()

    def bin_upper_value(self, feature: int, b):
        """Raw-value threshold of split 'bin <= b'."""
        ue = self.upper_edges[feature]
        return ue[np.clip(b, 0, len(ue) - 1)]

    def to_dict(self) -> dict:
        """The reference's mapper dictionary (no categorical features)."""
        return {
            "max_bin": self.max_bin,
            "max_bin_by_feature": None,
            "sample_cnt": self.sample_cnt,
            "seed": self.seed,
            "upper_edges": [e.tolist() for e in (self.upper_edges or [])],
            "categorical_features": [],
            "cat_values": {},
        }

    @staticmethod
    def from_dict(d: dict) -> "BinMapper":
        if d.get("categorical_features") or d.get("cat_values"):
            raise NotImplementedError("categorical features are not ported yet")
        if d.get("max_bin_by_feature"):
            raise NotImplementedError("max_bin_by_feature is not ported yet")
        m = BinMapper(max_bin=d["max_bin"], sample_cnt=d["sample_cnt"], seed=d["seed"])
        if d.get("upper_edges"):
            m.upper_edges = [np.asarray(e, dtype=np.float64) for e in d["upper_edges"]]
            m.n_features = len(m.upper_edges)
        return m


def bin_dtype(n_bins: int):
    """Narrowest integer dtype holding bin ids: int8 up to 127 bins, int16 up
    to 32767 (the reference's storage rule, ``binning.py:365-373``)."""
    if n_bins <= 127:
        return np.int8
    if n_bins <= 32767:
        return np.int16
    return np.int32


def torch_bin_dtype(n_bins: int) -> torch.dtype:
    return {np.int8: torch.int8, np.int16: torch.int16,
            np.int32: torch.int32}[bin_dtype(n_bins)]
