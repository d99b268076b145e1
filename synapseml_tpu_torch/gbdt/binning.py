"""Quantile and categorical feature binning — the dense ``BinMapper``.

A copy of ``synapseml_tpu/gbdt/binning.py`` for dense features: the same
numpy RNG, quantile rule and category rule, so a mapper fitted here has the
same edges and category values as the reference's, and ``to_dict`` /
``from_dict`` read and write the same dictionary (a mapper fitted by either
package loads in the other). The sparse (CSR) half, :meth:`BinMapper.fit_csr`
and :meth:`BinMapper.transform_csr`, gives the reference's edges and bins
for a CSR matrix without densifying it: the fit folds each feature's implicit
zeros in as the reference does, vectorised over the features that take one
bin per distinct value (hashed counts: nearly all of them), and the
transform bins every stored entry at once by a binary search over the
concatenated edges, on the CPU or on the entries' device.

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
        self._flat: Dict[str, tuple] = {}    # device -> the CSR transform's edge table

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
        self._tables, self._flat = {}, {}
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

    # -- sparse (CSR) ----------------------------------------------------------------
    #
    # The reference's CSR half (binning.py:171-330): implicit zeros take part
    # in the edges as LightGBM counts them (a feature's values are its stored
    # entries plus rows - nnz_j zeros).

    def fit_csr(self, csr) -> "BinMapper":
        """Fit the edges of a :class:`~.sparse.CSRMatrix` without densifying
        it: the reference's ``fit_csr``, edge for edge. A feature's finite
        stored values plus its implicit zeros: at most its max_bin distinct
        values take one bin each (edges at the midpoints), more take
        weighted quantiles with the zero mass as one weighted point; a
        categorical feature keeps its most frequent categories, the implicit
        zero one of them. The one-bin-per-value features are done together:
        one sort of the sampled (feature, value) pairs."""
        n, d = csr.shape
        if self.max_bin_by_feature and len(self.max_bin_by_feature) != d:
            raise ValueError(f"max_bin_by_feature has {len(self.max_bin_by_feature)} "
                             f"entries for {d} features")
        idx = self.sample_indices(n)
        s = csr if idx is None else csr.take_rows(np.sort(idx))
        s_n = s.shape[0]
        n_zero = s_n - np.bincount(s.indices, minlength=d)       # implicit zeros
        fin = np.isfinite(s.values)
        cols = torch.from_numpy(s.indices[fin].astype(np.int64))
        vals = torch.from_numpy(s.values[fin])
        # (feature, value) ascending: by value, then stably by feature
        vals, o1 = torch.sort(vals, stable=True)
        cols, o2 = torch.sort(cols[o1], stable=True)
        c_s, v_s = cols.numpy(), vals[o2].numpy()
        del cols, vals, o1, o2
        first = np.ones(len(c_s), dtype=bool)
        first[1:] = (c_s[1:] != c_s[:-1]) | (v_s[1:] != v_s[:-1])
        uc, uv = c_s[first], v_s[first]                          # distinct pairs
        n_uniq = np.bincount(uc, minlength=d)
        has_zero = np.zeros(d, dtype=bool)
        has_zero[uc[uv == 0.0]] = True
        add_zero = (n_zero > 0) & ~has_zero & (n_uniq > 0)
        fmb = np.array([self._feature_max_bin(j) for j in range(d)]) if \
            self.max_bin_by_feature else np.full(d, self.max_bin)
        is_cat = np.zeros(d, dtype=bool)
        is_cat[[j for j in self.categorical_features if j < d]] = True
        exact = ~is_cat & (n_uniq + add_zero <= fmb)
        # one bin per distinct value (and [inf] for a feature with no finite
        # stored value): edges at the midpoints, inf last
        keep = exact[uc]
        zc = np.flatnonzero(exact & add_zero)
        pc = np.concatenate([uc[keep], zc])
        pv = np.concatenate([uv[keep], np.zeros(len(zc))])
        o = np.lexsort((pv, pc))
        pc, pv = pc[o], pv[o]
        lens = np.where(exact, np.maximum(n_uniq + add_zero, 1), 0)
        last = np.ones(len(pc), dtype=bool)
        last[:-1] = pc[1:] != pc[:-1]
        mids = np.empty(len(pc))
        mids[:-1] = (pv[:-1] + pv[1:]) / 2
        mids[last] = np.inf
        flat = np.full(int(lens.sum()), np.inf)
        offs = np.zeros(d + 1, dtype=np.int64)
        np.cumsum(lens, out=offs[1:])
        # a feature's pairs fill its first slots, in order
        flat[offs[pc] + np.arange(len(pc)) - np.searchsorted(pc, pc)] = mids
        edges: List[np.ndarray] = np.split(flat, offs[1:-1])
        # the rest feature by feature, as the reference does it
        run = np.zeros(d + 1, dtype=np.int64)
        np.cumsum(np.bincount(c_s, minlength=d), out=run[1:])
        self.cat_values = {}
        zero_edge = np.array([np.inf])
        for j in np.flatnonzero(~exact):
            col = v_s[run[j]:run[j + 1]]
            if is_cat[j]:
                vals_j, counts = np.unique(col, return_counts=True)
                if n_zero[j] > 0:
                    p = np.searchsorted(vals_j, 0.0)
                    if p < len(vals_j) and vals_j[p] == 0.0:
                        counts[p] += n_zero[j]
                    else:
                        vals_j = np.insert(vals_j, p, 0.0)
                        counts = np.insert(counts, p, n_zero[j])
                if len(vals_j) > fmb[j]:
                    vals_j = vals_j[np.argsort(-counts, kind="stable")[:fmb[j]]]
                self.cat_values[int(j)] = np.sort(vals_j)
                edges[j] = zero_edge
                continue
            # weighted quantiles: the sorted values, the zero mass folded in
            sv = col
            w = np.ones(len(sv))
            if n_zero[j] > 0:
                p = np.searchsorted(sv, 0.0)
                sv = np.insert(sv, p, 0.0)
                w = np.insert(w, p, n_zero[j])
            cw = np.cumsum(w)
            targets = np.linspace(0, 1, fmb[j] + 1)[1:-1] * cw[-1]
            take = np.searchsorted(cw, targets, side="left")
            qs = sv[np.clip(take, 0, len(sv) - 1)]
            edges[j] = np.concatenate([np.unique(qs), [np.inf]])
        self.upper_edges = edges
        self.n_features = d
        self._tables, self._flat = {}, {}
        return self

    def _flat_table(self, device) -> tuple:
        """(flat, offs, lens, is_cat) on ``device``: every feature's edges, or
        its category values, end to end in f64, with each feature's offset
        and length; made once a device."""
        key = str(device)
        if key not in self._flat:
            rows = [self.cat_values[j] if j in self.cat_values else e
                    for j, e in enumerate(self.upper_edges)]
            lens = np.array([len(r) for r in rows], dtype=np.int64)
            offs = np.zeros(len(rows) + 1, dtype=np.int64)
            np.cumsum(lens, out=offs[1:])
            flat = np.concatenate(rows).astype(np.float64) if rows else np.zeros(0)
            is_cat = np.zeros(len(rows), dtype=bool)
            is_cat[list(self.cat_values)] = True
            self._flat[key] = tuple(torch.from_numpy(a).to(device)
                                    for a in (flat, offs, lens, is_cat))
        return self._flat[key]

    def _bin_values(self, cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        """int32 bin of each (feature, value) pair on their device:
        :meth:`transform_column`'s rule, by a lower bound over the feature's
        slice of the flat table (the count of edges below the value)."""
        flat, offs, lens, is_cat = self._flat_table(vals.device)
        cols = cols.long()
        vals = vals.to(torch.float64)
        lo, n_e = offs[cols], lens[cols]
        hi = lo + n_e
        last = max(int(flat.numel()) - 1, 0)
        for _ in range(int(lens.max()).bit_length() if lens.numel() else 0):
            mid = (lo + hi) // 2
            less = flat[mid.clamp(max=last)] < vals
            go = lo < hi
            lo, hi = torch.where(go & less, mid + 1, lo), torch.where(go & ~less, mid, hi)
        pos = lo - offs[cols]
        num = torch.minimum(pos, n_e - 1)
        at = torch.clamp(pos, max=torch.clamp(n_e - 1, min=0))
        cat = torch.where((n_e > 0) & (flat[(offs[cols] + at).clamp(max=last)] == vals),
                          at, self.missing_bin)
        out = torch.where(is_cat[cols], cat, num)
        return torch.where(torch.isfinite(vals), out, self.missing_bin).to(torch.int32)

    def transform_csr_torch(self, cols: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
        """(nnz,) int32 bin of each stored entry (``cols`` its column, ``vals``
        its value, on one device); NaN and unseen categories -> the missing
        bin. The bins :meth:`transform` gives the densified matrix there."""
        if self.upper_edges is None:
            raise RuntimeError("BinMapper.transform_csr called before fit")
        if not cols.numel():
            return torch.empty(0, dtype=torch.int32, device=cols.device)
        return self._bin_values(cols, vals)

    def transform_csr(self, csr) -> np.ndarray:
        """(nnz,) int32 bin of each stored entry of a CSR matrix, in CSR
        order (the reference's ``transform_csr``, in one vectorised pass)."""
        n, d = csr.shape
        self._check_fitted(d)
        return self.transform_csr_torch(torch.from_numpy(csr.indices),
                                        torch.from_numpy(csr.values)).numpy()

    def zero_bins(self, compact: bool = False) -> np.ndarray:
        """(d,) int32 bin of value 0.0 in each feature, the bin of a sparse
        matrix's implicit entries. ``compact``: a categorical feature without
        a 0 category gets the compact missing bin ``realized_n_bins - 1``
        (sparse training's bin space) instead of ``missing_bin``."""
        if self.upper_edges is None:
            raise RuntimeError("zero_bins before fit")
        d = self.n_features
        out = self._bin_values(torch.arange(d), torch.zeros(d, dtype=torch.float64)).numpy()
        if compact:
            out = np.where(out == self.missing_bin, self.realized_n_bins - 1, out)
        return out.astype(np.int32)

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
