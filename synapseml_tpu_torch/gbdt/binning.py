"""Quantile and categorical feature binning — the dense ``BinMapper``.

A copy of ``synapseml_tpu/gbdt/binning.py`` for dense features: the same
numpy RNG, quantile rule and category rule, so a mapper fitted here has the
same edges and category values as the reference's, and ``to_dict`` /
``from_dict`` read and write the same dictionary (a mapper fitted by either
package loads in the other). The sparse (CSR) path is not ported yet.

Bin layout per feature: bins ``0..n_bins-2`` cover finite values by quantile
ranges; NaN and infinities map to the last bin (the missing bin). Split
"value <= upper_edge[b]" is "bin <= b"; NaN compares false, so missing rows
follow the right branch. A categorical feature gives each of its most
frequent ``max_bin`` values its own bin (their position among the sorted
values); unseen values and NaN go to the missing bin.

:meth:`BinMapper.transform_torch` bins a tensor on its own device: through
kernel D (:func:`~.device_predict.device_bin_cat`) when that is exact (the
reference's ``use_device_bin`` rule, ``boost.py:1720-1723``), else by a
``searchsorted`` over the f64 edges, the numpy transform's arithmetic.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["BinMapper", "bin_dtype"]


class BinMapper:
    """Fit per-feature quantile bin edges or category values; transform float
    matrices to int bins.

    ``categorical_features`` lists the column indices treated as categories;
    ``max_bin_by_feature`` overrides ``max_bin`` per feature (entries <= 0
    keep ``max_bin``)."""

    def __init__(self, max_bin: int = 255, sample_cnt: int = 200_000, seed: int = 0,
                 categorical_features: Optional[List[int]] = None,
                 max_bin_by_feature: Optional[List[int]] = None):
        if max_bin < 2:
            raise ValueError(f"max_bin must be >= 2, got {max_bin}")
        if sample_cnt < 1:
            raise ValueError(f"sample_cnt must be >= 1, got {sample_cnt}")
        self.max_bin = int(max_bin)
        self.sample_cnt = int(sample_cnt)
        self.seed = seed
        self.categorical_features = sorted(set(categorical_features or []))
        self.max_bin_by_feature = ([int(b) for b in max_bin_by_feature]
                                   if max_bin_by_feature else None)
        if self.max_bin_by_feature and any(0 < b < 2 for b in self.max_bin_by_feature):
            raise ValueError("max_bin_by_feature entries must be >= 2 (or <= 0 "
                             "for the max_bin default)")
        self.upper_edges: Optional[List[np.ndarray]] = None
        self.cat_values: Dict[int, np.ndarray] = {}  # feature -> sorted category values
        self.n_features: Optional[int] = None
        self._tables: Dict[str, tuple] = {}  # device -> kernel D's packed table

    def _feature_max_bin(self, j: int) -> int:
        mbf = self.max_bin_by_feature
        if mbf and j < len(mbf) and mbf[j] > 0:
            return mbf[j]
        return self.max_bin

    @property
    def _effective_max_bin(self) -> int:
        if self.max_bin_by_feature:
            return max(self.max_bin, *[b for b in self.max_bin_by_feature
                                       if b > 0] or [self.max_bin])
        return self.max_bin

    @property
    def n_bins(self) -> int:
        """Total bins per feature including the reserved missing bin."""
        return self._effective_max_bin + 1

    @property
    def missing_bin(self) -> int:
        return self._effective_max_bin

    def sample_indices(self, n: int) -> Optional[np.ndarray]:
        """Row indices ``fit`` subsamples for edge estimation (None = all)."""
        if n <= self.sample_cnt:
            return None
        rng = np.random.default_rng(self.seed)
        return rng.choice(n, size=self.sample_cnt, replace=False)

    def fit(self, x: np.ndarray) -> "BinMapper":
        x = np.asarray(x)
        n, d = x.shape
        if self.max_bin_by_feature and len(self.max_bin_by_feature) != d:
            raise ValueError(f"max_bin_by_feature has {len(self.max_bin_by_feature)} "
                             f"entries for {d} features")
        idx = self.sample_indices(n)
        sample = np.asarray(x if idx is None else x[idx], dtype=np.float64)
        edges: List[np.ndarray] = []
        self.cat_values = {}
        for j in range(d):
            col = sample[:, j]
            col = col[np.isfinite(col)]
            fmb = self._feature_max_bin(j)
            if j in self.categorical_features:
                vals, counts = np.unique(col, return_counts=True)
                if len(vals) > fmb:  # keep the most frequent categories
                    vals = vals[np.argsort(-counts, kind="stable")[:fmb]]
                self.cat_values[j] = np.sort(vals)
                edges.append(np.array([np.inf]))  # placeholder, unused for categories
                continue
            if col.size == 0:
                edges.append(np.array([np.inf]))
                continue
            uniq = np.unique(col)
            if len(uniq) <= fmb:
                # exact: one bin per distinct value; upper edge = midpoint to next
                ue = np.empty(len(uniq))
                ue[:-1] = (uniq[:-1] + uniq[1:]) / 2
                ue[-1] = np.inf
                edges.append(ue)
            else:
                qs = np.quantile(col, np.linspace(0, 1, fmb + 1)[1:-1])
                edges.append(np.concatenate([np.unique(qs), [np.inf]]))
        self.upper_edges = edges
        self.n_features = d
        self._tables = {}
        return self

    def transform_column(self, j: int, col: np.ndarray) -> np.ndarray:
        """Bin one feature's raw values (NaN and unseen categories -> missing bin)."""
        if j in self.cat_values:
            vals = self.cat_values[j]
            idx = np.clip(np.searchsorted(vals, col), 0, max(len(vals) - 1, 0))
            known = np.isfinite(col) & (len(vals) > 0)
            if len(vals):
                known &= vals[idx] == col
            return np.where(known, idx, self.missing_bin).astype(np.int32)
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

    def device_binnable(self, x: torch.Tensor) -> bool:
        """The reference's ``use_device_bin`` rule: kernel D bins ``x`` exactly
        when its values are f32 (an f32 tensor, or f64 values that survive
        the round trip; NaN does) and every category value is f32."""
        from .device_predict import cats_f32_representable

        if not cats_f32_representable(self):
            return False
        if x.dtype == torch.float32:
            return True
        xd = x.to(torch.float64)
        return bool(((xd == xd.to(torch.float32).to(torch.float64))
                     | torch.isnan(xd)).all())

    def device_table(self, device) -> tuple:
        """Kernel D's (table, lens, cat_flags) on ``device``, packed once."""
        from .device_predict import pack_feature_table

        key = str(device)
        if key not in self._tables:
            self._tables[key] = tuple(torch.from_numpy(a).to(device)
                                      for a in pack_feature_table(self))
        return self._tables[key]

    def transform_torch(self, x: torch.Tensor) -> torch.Tensor:
        """(n, d) tensor -> (n, d) bins of :func:`bin_dtype` on ``x``'s device.

        Gives exactly what :meth:`transform` gives for the same values:
        through kernel D where :meth:`device_binnable` holds, else by the
        host arithmetic (a searchsorted in f64 over the edges and category
        values) on the device."""
        from .device_predict import device_bin_cat

        n, d = x.shape
        self._check_fitted(d)
        out_dtype = torch_bin_dtype(self.n_bins)
        if self.device_binnable(x):
            table, lens, cat_flags = self.device_table(x.device)
            return device_bin_cat(x.to(torch.float32), table, lens, cat_flags,
                                  self.missing_bin, out_dtype)
        rows = [self.cat_values[j] if j in self.cat_values else e
                for j, e in enumerate(self.upper_edges)]
        emax = max(max(len(r) for r in rows), 1)
        table = np.full((d, emax), np.inf)
        for j, r in enumerate(rows):
            table[j, : len(r)] = r
        lens = torch.tensor([len(r) for r in rows], device=x.device)
        is_cat = torch.tensor([j in self.cat_values for j in range(d)], device=x.device)
        xt = x.to(torch.float64).t().contiguous()                    # (d, n)
        t = torch.from_numpy(table).to(x.device)
        pos = torch.searchsorted(t, xt, side="left")                 # (d, n)
        num = torch.minimum(pos, lens[:, None] - 1)
        at = torch.gather(t, 1, pos.clamp(max=emax - 1))
        cat = torch.where((pos < lens[:, None]) & (at == xt), pos, self.missing_bin)
        out = torch.where(is_cat[:, None], cat, num)
        out = torch.where(torch.isfinite(xt), out, self.missing_bin)
        return out.t().to(out_dtype).contiguous()

    @property
    def realized_n_bins(self) -> int:
        """Compact bin count: the most edges or categories of any feature,
        plus the missing bin."""
        if self.upper_edges is None:
            raise RuntimeError("realized_n_bins before fit")
        mx = max((len(e) for e in self.upper_edges), default=1)
        if self.cat_values:
            mx = max(mx, max(len(v) for v in self.cat_values.values()))
        return max(mx, 2) + 1

    def bin_upper_value(self, feature: int, b):
        """Raw-value threshold of split 'bin <= b'; NaN for a categorical
        feature (its splits are sets, not thresholds)."""
        if feature in self.cat_values:
            return np.full(np.shape(b), np.nan) if np.ndim(b) else np.nan
        ue = self.upper_edges[feature]
        return ue[np.clip(b, 0, len(ue) - 1)]

    def to_dict(self) -> dict:
        """The reference's mapper dictionary."""
        return {
            "max_bin": self.max_bin,
            "max_bin_by_feature": self.max_bin_by_feature,
            "sample_cnt": self.sample_cnt,
            "seed": self.seed,
            "upper_edges": [e.tolist() for e in (self.upper_edges or [])],
            "categorical_features": self.categorical_features,
            "cat_values": {str(k): v.tolist() for k, v in self.cat_values.items()},
        }

    @staticmethod
    def from_dict(d: dict) -> "BinMapper":
        m = BinMapper(max_bin=d["max_bin"], sample_cnt=d["sample_cnt"], seed=d["seed"],
                      categorical_features=d.get("categorical_features"),
                      max_bin_by_feature=d.get("max_bin_by_feature"))
        if d.get("upper_edges"):
            m.upper_edges = [np.asarray(e, dtype=np.float64) for e in d["upper_edges"]]
            m.n_features = len(m.upper_edges)
        m.cat_values = {int(k): np.asarray(v, dtype=np.float64)
                        for k, v in (d.get("cat_values") or {}).items()}
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
