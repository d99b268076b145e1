"""Sparse (CSR) features for the GBDT engine: the container, the binned
layout on the device and the sparse histogram (kernel G).

Port of ``synapseml_tpu/gbdt/sparse.py`` on one device. The canonical
workload is hashed text (the VW featurizer's ``(indices, values)`` columns)
flowing into a LightGBM estimator: a few stored entries a row over up to
2^18 hashed columns.

- :class:`CSRMatrix` is the reference's host container, numpy for numpy:
  duplicate (row, column) entries are summed at construction, and
  :meth:`CSRMatrix.from_pairs` masks hashed indices into ``2**num_bits``
  slots.
- :class:`SparseBinned` is the port's own layout on the device. The entry
  set (row, feature, bin) never changes during a fit, so it is sorted once
  by cell ``feature * B + bin``, stable in CSR order (the reference's
  ``np.lexsort((bins, cols))``, ``sparse.py:488``), and kept as two (nnz,)
  int32 arrays: each entry's row and its cell. A feature's entries are the
  run ``starts[f]:starts[f + 1]``; value 0.0 is not stored, and each
  feature's implicit zeros belong to its ``zero_bin``. Beside them it keeps
  the row-major view, the cells in CSR order (``row_cells``) and
  ``row_ptr``, the CSR ``indptr``: a row's entries without a pass over all.
- :func:`sparse_histogram_split` gives the (2, d, B, 3) histograms of both
  children of a split, each feature's zero bin holding the side's total
  minus the feature's stored cells (LightGBM's most-frequent-bin trick).
  The reference builds it scatter-free for the TPU (a chunked cumsum with a
  mean-centred prefix, differenced at the cell ends, ``_cell_sum_fn``,
  ``sparse.py:312``); here CUDA tensors launch kernel G
  (``csrc/sparse_hist.cu``), which chooses on the card between two paths
  by the summed side's entries (:func:`g_path`): a small side is walked row
  by row over the row-major view, a large one streamed in cell order (a
  warp sums each run of equal cells); every output cell is written once.
  CPU tensors take the plain version :func:`sparse_hist_plain` (a gather
  and ``index_add_``); :func:`sparse_hist_rows_plain` is the row walk's
  plain twin. On gradients pre-rounded by ``boost._preround`` every sum is
  exact in any order, so all of them agree bit for bit.
- :func:`shard_sparse_binned` is a rank's block of the rows on a
  data-parallel mesh (the reference's ``shard_sparse_binned``,
  ``sparse.py:531``), and :func:`sparse_hist_mesh` is G's mesh use: the
  side forced from the all-reduced member counts, no sibling subtraction in
  the kernel (the grower all-reduces the sum first).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from ..kernels.build import CudaKernel

__all__ = ["CSRMatrix", "SparseBinned", "is_sparse_input", "as_csr", "build_sparse_binned",
           "pack_entries",
           "sparse_histogram", "sparse_histogram_split", "sparse_histogram_side",
           "sparse_hist", "sparse_hist_mesh", "sparse_hist_plain", "sparse_hist_rows_plain",
           "sparse_column", "shard_sparse_binned", "SPARSE_HIST_MESH_KERNEL",
           "leaf_feature_hist", "g_plan", "g_hot", "g_path", "g_summed_sides",
           "g_summed_entries",
           "SPARSE_HIST_KERNEL", "SPARSE_HIST_TRACE", "G_ENTRIES", "G_SMEM", "G_HOT_SMEM",
           "G_HOT_SHARE", "G_WALK_PER_MILLE", "G_PATH_STREAM", "G_PATH_WALK"]


class CSRMatrix:
    """Host CSR feature matrix: ``indptr`` (n+1,) int64, ``indices`` (nnz,)
    int32 column ids (any order within a row), ``values`` (nnz,) f64.
    Duplicate (row, column) entries are summed at construction (scipy's
    ``sum_duplicates``, VW's scatter-add)."""

    __slots__ = ("indptr", "indices", "values", "shape", "_csc_order")

    def __init__(self, indptr, indices, values, shape: Tuple[int, int]):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.indices = np.asarray(indices, dtype=np.int32)
        self.values = np.asarray(values, dtype=np.float64)
        self._csc_order = None
        n, d = shape
        self.shape = (int(n), int(d))
        if self.indptr.shape != (self.shape[0] + 1,):
            raise ValueError(f"indptr must have shape ({self.shape[0] + 1},), "
                             f"got {self.indptr.shape}")
        if self.indices.shape != self.values.shape:
            raise ValueError("indices and values must align")
        if self.indices.size and (self.indices.min() < 0 or self.indices.max() >= self.shape[1]):
            raise ValueError(f"column index out of range for d={self.shape[1]}")
        self._coalesce()

    def _coalesce(self) -> None:
        """Sum duplicate (row, column) entries in place (no-op when none)."""
        nnz = self.indices.size
        if nnz < 2:
            return
        # strictly increasing columns within every row: no duplicates
        same_row = np.ones(nnz - 1, dtype=bool)
        b = self.indptr[1:-1]
        same_row[b[(b > 0) & (b < nnz)] - 1] = False
        if (np.diff(self.indices)[same_row] > 0).all():
            return
        rows = self.row_ids()
        order = np.lexsort((self.indices, rows))
        r_s, c_s = rows[order], self.indices[order]
        dup = np.zeros(len(order), dtype=bool)
        dup[1:] = (r_s[1:] == r_s[:-1]) & (c_s[1:] == c_s[:-1])
        if not dup.any():
            return
        group = np.cumsum(~dup) - 1
        keep = ~dup
        self.indices = c_s[keep]
        self.values = np.bincount(group, weights=self.values[order])
        self.indptr = np.zeros(self.shape[0] + 1, dtype=np.int64)
        np.cumsum(np.bincount(r_s[keep], minlength=self.shape[0]), out=self.indptr[1:])

    @staticmethod
    def from_scipy(m) -> "CSRMatrix":
        m = m.tocsr().copy()
        m.sum_duplicates()
        return CSRMatrix(m.indptr, m.indices, m.data, m.shape)

    @staticmethod
    def from_pairs(col, num_bits: int = 18) -> "CSRMatrix":
        """An object column of ``(indices, values)`` pairs (the VW featurizer's
        output; None for an empty row) -> CSR over ``2**num_bits`` columns,
        each index masked into them. A row whose masked indices meet is
        coalesced as the reference does it (``np.unique`` order, values
        summed in the row's order); the other rows keep their order. One
        pass over the concatenated pairs, not a loop a row."""
        n = len(col)
        d = 1 << int(num_bits)
        lens = np.fromiter((0 if v is None else len(v[0]) for v in col), np.int64, n)
        present = [v for v in col if v is not None]
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(lens, out=indptr[1:])
        if not present or not indptr[-1]:
            return CSRMatrix(indptr, np.empty(0, np.int32), np.empty(0), (n, d))
        idx = (np.concatenate([np.asarray(v[0], np.uint32) for v in present])
               & np.uint32(d - 1)).astype(np.int32)
        val = np.concatenate([np.asarray(v[1], np.float64) for v in present])
        rows = np.repeat(np.arange(n, dtype=np.int64), lens)
        same_row = rows[1:] == rows[:-1]
        if not (np.diff(idx)[same_row] > 0).all():
            order = np.lexsort((idx, rows))
            r_s, c_s = rows[order], idx[order]
            dup = np.zeros(len(order), dtype=bool)
            dup[1:] = (r_s[1:] == r_s[:-1]) & (c_s[1:] == c_s[:-1])
            if dup.any():
                hit = np.zeros(n, dtype=bool)
                hit[r_s[dup]] = True
                mine = hit[r_s]                      # sorted entries of the rows that meet
                group = np.cumsum(~dup[mine]) - 1
                first = ~dup & mine
                keep = ~hit[rows]                    # the other rows, in their order
                rows = np.concatenate([rows[keep], r_s[first]])
                idx = np.concatenate([idx[keep], c_s[first]])
                val = np.concatenate([val[keep], np.bincount(group, weights=val[order][mine])])
                by_row = np.argsort(rows, kind="stable")
                idx, val = idx[by_row], val[by_row]
                np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
        return CSRMatrix(indptr, idx, val, (n, d))

    @property
    def nnz(self) -> int:
        return int(self.indices.size)

    @property
    def density(self) -> float:
        n, d = self.shape
        return self.nnz / max(n * d, 1)

    def row_ids(self) -> np.ndarray:
        """(nnz,) row id of every stored entry."""
        return np.repeat(np.arange(self.shape[0], dtype=np.int32), np.diff(self.indptr))

    def row_slice(self, lo: int, hi: int) -> "CSRMatrix":
        a, b = int(self.indptr[lo]), int(self.indptr[hi])
        return CSRMatrix(self.indptr[lo:hi + 1] - a, self.indices[a:b], self.values[a:b],
                         (hi - lo, self.shape[1]))

    def take_rows(self, idx: np.ndarray) -> "CSRMatrix":
        idx = np.asarray(idx)
        lens = self.indptr[idx + 1] - self.indptr[idx]
        indptr = np.zeros(len(idx) + 1, dtype=np.int64)
        np.cumsum(lens, out=indptr[1:])
        gather = (np.repeat(self.indptr[idx] - indptr[:-1], lens)
                  + np.arange(int(indptr[-1]), dtype=np.int64))
        return CSRMatrix(indptr, self.indices[gather], self.values[gather],
                         (len(idx), self.shape[1]))

    def __getitem__(self, rows: slice) -> "CSRMatrix":
        """A run of rows, ``m[lo:hi]`` (as scipy slices rows)."""
        lo, hi, step = rows.indices(self.shape[0])
        if step != 1:
            raise IndexError("CSRMatrix takes a slice of consecutive rows; use take_rows")
        return self.row_slice(lo, max(hi, lo))

    def toarray(self) -> np.ndarray:
        n, d = self.shape
        out = np.zeros((n, d), dtype=np.float64)
        out[self.row_ids(), self.indices] = self.values
        return out

    def tocsc_order(self) -> np.ndarray:
        """(nnz,) permutation sorting the entries by (column, row); cached.
        A stable sort by column alone gives it, since CSR order is row
        order."""
        if self._csc_order is None:
            self._csc_order = np.argsort(self.indices, kind="stable")
        return self._csc_order

    def __repr__(self) -> str:
        return (f"CSRMatrix(shape={self.shape}, nnz={self.nnz}, "
                f"density={self.density:.4f})")


def is_sparse_input(x) -> bool:
    """True for an accepted sparse feature input (CSRMatrix or scipy sparse)."""
    if isinstance(x, CSRMatrix):
        return True
    try:
        import scipy.sparse as sp
    except ImportError:
        return False
    return sp.issparse(x)


def as_csr(x) -> CSRMatrix:
    if isinstance(x, CSRMatrix):
        return x
    import scipy.sparse as sp

    if sp.issparse(x):
        return CSRMatrix.from_scipy(x)
    raise TypeError(f"not a sparse matrix: {type(x).__name__}")


# ---------------------------------------------------------------------------------
# The binned layout on the device
# ---------------------------------------------------------------------------------

# Kernel G's work split, which the host plans once for a SparseBinned
# (:func:`g_plan`): at most G_ENTRIES entries a block of the stream, and a
# light group of features whose (features, B, 6) f32 sums fit G_SMEM bytes
# of shared memory. The row walk's hot features (:func:`g_hot`): those held
# by more than G_HOT_SHARE of the rows, the most first, as many as fit
# their (B, 3) f32 sums in G_HOT_SMEM bytes of a block's shared memory
# (the hotter half of them when both sides are summed, 6 channels a cell).
G_ENTRIES = 4096
G_SMEM = 48 * 1024
G_HOT_SMEM = 96 * 1024
G_HOT_SHARE = 1 / 64
# G's path rule (csrc/sparse_hist.cu's kWalkPerMille and path ids; a CPU
# test holds them to the source): the row walk when the summed side(s) hold
# fewer than G_WALK_PER_MILLE thousandths of the entries, else the stream
G_WALK_PER_MILLE = 250
G_PATH_STREAM, G_PATH_WALK = 0, 1


class SparseBinned:
    """Binned CSR entries on one device, sorted by cell ``feature * B + bin``
    (stable in CSR order), with their row-major view.

    ``rows`` (nnz,) int32 row of each entry; ``cells`` (nnz,) int32 its cell;
    ``starts`` (d + 1,) int64 each feature's first entry; ``zero_bin`` (d,)
    int32 each feature's bin of value 0.0 (the implicit entries' bin), all
    in the compact bin space of ``n_bins`` bins. ``row_cells`` (nnz,) int32
    the same cells in CSR order and ``row_ptr`` (n + 1,) int64 each row's
    first of them (the CSR ``indptr``): kernel G's row walk reads a small
    side's rows there. ``n`` rows, ``max_run`` the most entries of one
    feature (the bound of :func:`sparse_column`). ``counts`` (d,) int64
    numpy, each feature's entries, kept on the host for ``plan``: kernel
    G's work list, hot features and scratch (:class:`GPlan`), made at G's
    first call on this SparseBinned (eval sets and replays never call G)
    and kept."""

    __slots__ = ("rows", "cells", "starts", "zero_bin", "row_cells", "row_ptr", "d", "n_bins",
                 "n", "max_run", "counts", "plan")

    def __init__(self, rows, cells, starts, zero_bin, row_cells, row_ptr, d: int, n_bins: int,
                 n: int, max_run: int, counts: np.ndarray):
        self.rows = rows
        self.cells = cells
        self.starts = starts
        self.zero_bin = zero_bin
        self.row_cells = row_cells
        self.row_ptr = row_ptr
        self.d = int(d)
        self.n_bins = int(n_bins)
        self.n = int(n)
        self.max_run = int(max_run)
        self.counts = counts
        self.plan = None

    @property
    def device(self) -> torch.device:
        return self.rows.device

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    def __repr__(self) -> str:
        return (f"SparseBinned(nnz={self.nnz}, n={self.n}, d={self.d}, "
                f"n_bins={self.n_bins}, max_run={self.max_run}, device={self.device})")


class GPlan:
    """Kernel G's work list and scratch for one SparseBinned on one CUDA
    device.

    The stream's: ``items`` (K, 6) int32, one block's work each: features
    ``[f0, f1)``, entries ``[e0, e1)``, the heavy slot (-1: the block owns
    its features) and the slot's block count; ``acc`` (heavy, B, 6) f32 and
    ``tickets`` (heavy + 1,) int32 the heavy features' sums and arrival
    counters (zero between launches), the first ticket the rows pass's;
    ``max_feats`` the most features of one item. The row walk's: ``hot``
    (d,) uint8, 0 or 1 + the feature's slot of a block's shared slice, and
    ``hot_feats`` (n_hot,) int32 each slot's feature (:func:`g_hot`);
    ``touched`` (d,) uint8 and ``scratch`` (2, d * B, 4) f32 (a side's
    cells, the fourth channel unused), zero between launches. ``rowsum``
    (10,) f32 the rows pass's sums, member rows and member entries (zero
    between launches); ``state`` (3,) int32 the smaller side and the path
    (``G_PATH_*``) the rows pass chose, read by tests, and the stream's
    item queue."""

    __slots__ = ("items", "acc", "tickets", "rowsum", "state", "max_feats", "hot", "hot_feats",
                 "n_hot", "touched", "scratch")

    def __init__(self, items: np.ndarray, heavy: int, max_feats: int, hot_feats: np.ndarray,
                 d: int, B: int, device):
        # from pinned memory, so the copies do not synchronise the host
        pinned = lambda a: torch.from_numpy(a).pin_memory().to(device, non_blocking=True)
        self.items = pinned(items)
        self.max_feats = max_feats
        self.acc = torch.zeros((max(heavy, 1), B, 6), dtype=torch.float32, device=device)
        self.tickets = torch.zeros(heavy + 1, dtype=torch.int32, device=device)
        self.rowsum = torch.zeros(10, dtype=torch.float32, device=device)
        self.state = torch.zeros(3, dtype=torch.int32, device=device)
        hot = np.zeros(d, dtype=np.uint8)
        hot[hot_feats] = np.arange(1, len(hot_feats) + 1)
        self.hot = pinned(hot)
        self.hot_feats = pinned(np.ascontiguousarray(hot_feats, dtype=np.int32))
        self.n_hot = len(hot_feats)
        self.touched = torch.zeros(d, dtype=torch.uint8, device=device)
        self.scratch = torch.zeros((2, d * B, 4), dtype=torch.float32, device=device)


def g_hot(counts: np.ndarray, n: int, n_bins: int, smem: int = G_HOT_SMEM,
          share: float = G_HOT_SHARE) -> np.ndarray:
    """The row walk's hot features (int32, the most entries first): those
    held by more than ``share`` of the ``n`` rows, at most as many as fit
    their (B, 3) f32 sums in ``smem`` bytes (and 255, the slots a uint8
    names). A stop word -- a feature of nearly every row -- is hot: its
    few cells would otherwise take an atomic from each member row."""
    k = min(smem // (n_bins * 12), 255)
    order = np.argsort(-np.asarray(counts, dtype=np.int64), kind="stable")[:k]
    return order[np.asarray(counts)[order] > share * n].astype(np.int32)


def g_path(summed_entries: int, nnz: int) -> int:
    """Kernel G's path (``G_PATH_WALK`` or ``G_PATH_STREAM``) for a call
    whose summed side(s) hold ``summed_entries`` of the ``nnz`` entries: the
    rule the rows pass's last block applies on the card."""
    return G_PATH_WALK if summed_entries * 1000 < nnz * G_WALK_PER_MILLE else G_PATH_STREAM


def g_summed_sides(side: torch.Tensor, ctrl) -> Tuple[int, ...]:
    """The side(s) a G call sums for ``ctrl`` (half, slot, forced): both in
    both-sides mode; in half mode the forced side, else the right iff it
    has no more members than the left (the reference's smaller child)."""
    half, _, forced = (int(v) for v in (ctrl.tolist() if torch.is_tensor(ctrl) else ctrl))
    if not half:
        return (0, 1)
    if forced >= 0:
        return (forced,)
    return (int(int((side == 1).sum()) <= int((side == 0).sum())),)


def g_summed_entries(sb: "SparseBinned", side: torch.Tensor, ctrl) -> int:
    """The entries of the side(s) a G call sums (what :func:`g_path` reads)."""
    lens = (sb.row_ptr[1:] - sb.row_ptr[:-1]).to(side.device)
    return sum(int(lens[side == s].sum()) for s in g_summed_sides(side, ctrl))


def g_plan(counts: np.ndarray, n_bins: int, entries: int = G_ENTRIES,
           smem: int = G_SMEM) -> Tuple[np.ndarray, int, int]:
    """Kernel G's blocks over features with ``counts`` entries each: (items
    (K, 6) int32, heavy features, most features of one block).

    A feature with more than ``entries`` entries is heavy: it gets a block
    per ``entries`` of them, which add their sums into one slot, and the
    last to arrive writes the feature. The others go in runs of consecutive
    features holding at most ``entries`` entries and at most ``smem // (B *
    24)`` features (their sums fit a block's shared memory); such a block
    writes its features' cells itself. The items come the most entries
    first (the stream's blocks take them in that order from a queue)."""
    if n_bins * 6 * 4 > 227 * 1024:
        raise ValueError(f"n_bins={n_bins}: one feature's (B, 6) f32 sums must fit a "
                         "block's shared memory")
    d = len(counts)
    starts = np.zeros(d + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    f_max = max(1, smem // (n_bins * 6 * 4))
    items, heavy, most, f = [], 0, 1, 0
    while f < d:
        c = int(counts[f])
        if c > entries:
            k = -(-c // entries)
            for j in range(k):
                e0 = int(starts[f]) + j * entries
                items.append((f, f + 1, e0, min(e0 + entries, int(starts[f + 1])), heavy, k))
            heavy += 1
            f += 1
            continue
        last = int(np.searchsorted(starts, starts[f] + entries, side="right")) - 1
        f1 = min(max(last, f + 1), f + f_max, d)
        items.append((f, f1, int(starts[f]), int(starts[f1]), -1, 1))
        most = max(most, f1 - f)
        f = f1
    if starts[-1] >= 2 ** 31:
        raise ValueError(f"{int(starts[-1])} entries: kernel G indexes them with int32")
    items.sort(key=lambda it: it[2] - it[3])
    return np.asarray(items, dtype=np.int32).reshape(-1, 6), heavy, most


def pack_entries(rows: torch.Tensor, cols: torch.Tensor, bins: torch.Tensor,
                 row_ptr: torch.Tensor, zero_bin: np.ndarray, n: int, d: int,
                 n_bins: int) -> SparseBinned:
    """The layout of binned entries given in CSR order (``rows``, ``cols``,
    ``bins`` (nnz,) int tensors on one device, bins in ``[0, n_bins)``, and
    the CSR ``indptr`` (n + 1,) on that device as ``row_ptr``): one stable
    sort of the cell ids, on that device; the cells before the sort are the
    row-major view."""
    dev = rows.device
    if d * n_bins >= 2 ** 31:
        raise ValueError(f"d * B = {d * n_bins} cells: cell ids are int32")
    row_cells = (cols.to(torch.int32) * n_bins + bins.to(torch.int32)).contiguous()
    key = row_cells
    if key.numel():
        key, order = torch.sort(row_cells, stable=True)
        rows = rows[order]
    # the entries' feature counts on their device: only (d,) comes back
    counts = torch.bincount(cols.long(), minlength=d).cpu().numpy().astype(np.int64)
    starts = np.zeros(d + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    return SparseBinned(rows=rows.to(torch.int32).contiguous(),
                        cells=key.to(torch.int32).contiguous(),
                        starts=torch.from_numpy(starts).to(dev),
                        zero_bin=torch.as_tensor(zero_bin, dtype=torch.int32).to(dev),
                        row_cells=row_cells, row_ptr=row_ptr.to(torch.int64).contiguous(),
                        d=d, n_bins=n_bins, n=n, max_run=max(int(counts.max()) if d else 0, 1),
                        counts=counts)


def build_sparse_binned(csr: CSRMatrix, mapper, device="cpu") -> SparseBinned:
    """Bin a host CSR matrix through a fitted ``BinMapper`` and lay it out on
    ``device``.

    Bins are the mapper's compact space (``mapper.realized_n_bins``): real
    bins as the dense transform gives them, the missing bin moved down to
    ``B - 1``, so trees grown here compare with dense-grown ones. The
    entries are binned and sorted on ``device``, so the host never sorts
    them; ``indptr`` goes up once, as ``row_ptr`` and the rows' lengths."""
    dev = torch.device(device)
    n, d = csr.shape
    B = mapper.realized_n_bins
    cols = torch.from_numpy(csr.indices).to(dev)
    bins = mapper.transform_csr_torch(cols, torch.from_numpy(csr.values).to(dev))
    row_ptr = torch.from_numpy(csr.indptr).to(dev)
    rows = torch.repeat_interleave(torch.arange(n, dtype=torch.int32, device=dev),
                                   row_ptr[1:] - row_ptr[:-1])
    return pack_entries(rows, cols, torch.clamp(bins, max=B - 1), row_ptr,
                        mapper.zero_bins(compact=True), n, d, B)


def shard_sparse_binned(csr: CSRMatrix, mapper, n_shards: int, row_pad: int, rank: int,
                        device="cpu") -> Tuple[SparseBinned, int]:
    """Rank ``rank``'s block of the rows on a data-parallel mesh of
    ``n_shards`` (the reference's ``shard_sparse_binned``, ``sparse.py:531``):
    the rows, padded with ``row_pad`` wrapped copies of the first ones (the
    caller gives them weight -0.0), split into equal contiguous blocks; the
    block is binned and laid out by :func:`build_sparse_binned` with local
    row ids. Returns (the block's SparseBinned, rows a block)."""
    n, _ = csr.shape
    if row_pad > n:
        # wrapped padding replicates the first row_pad rows
        raise ValueError(
            f"sparse training set has {n} rows for {n_shards} shards "
            f"(needs {row_pad} wrapped padding rows); use fewer shards or more rows")
    total = n + row_pad
    if total % n_shards:
        raise ValueError(f"padded rows {total} not divisible by {n_shards}")
    local = total // n_shards
    rows = np.arange(rank * local, (rank + 1) * local) % n
    return build_sparse_binned(csr.take_rows(rows), mapper, device), local


# ---------------------------------------------------------------------------------
# The sparse histogram (kernel G)
# ---------------------------------------------------------------------------------

SPARSE_HIST_KERNEL = CudaKernel(
    name="gbdt_sparse_hist", source="sparse_hist", symbol="smt_sparse_hist",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p],
    replaces="synapseml_tpu/gbdt/sparse.py:312 (_cell_sum_fn, with the zero-bin "
             "residual of sparse_histogram_split :377 and sparse_histogram_side :415)")
# G's mesh use (sparse_hist_mesh): the same entry with the side forced and
# no parent, counted apart
SPARSE_HIST_MESH_KERNEL = CudaKernel(
    name="gbdt_sparse_hist_mesh", source="sparse_hist", symbol="smt_sparse_hist",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p],
    replaces="synapseml_tpu/gbdt/grow.py:665 (the mesh's half pass: counts psum'd "
             ":674-677, the smaller child summed, psum'd, then subtracted :686-695)")
# G's four device kernels' names in a profiler trace, as substrings
SPARSE_HIST_TRACE = ("sparse_",)

_G_POINTERS = ("rows", "cells", "row_cells", "row_ptr", "side", "panel", "zero_bin", "items",
               "hot", "hot_feats", "acc", "tickets", "rowsum", "state", "touched", "scratch",
               "ctrl", "out", "totals", "parent")
_G_INTS = ("n", "d", "B", "nnz", "n_items", "max_feats", "n_hot", "device")


class _GArgs(ctypes.Structure):
    """``GArgs`` of ``csrc/sparse_hist.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in _G_POINTERS]
                + [(name, ctypes.c_int) for name in _G_INTS])


def _residual(h: torch.Tensor, tot: torch.Tensor, zero_bin: torch.Tensor) -> torch.Tensor:
    """(d, B, 3) stored cells -> each feature's zero bin += total - its cells
    (the reference's one-hot broadcast, ``sparse.py:400-405``)."""
    d = h.shape[0]
    per_feat = h.sum(dim=1)                                          # (d, 3)
    idx = torch.arange(d, device=h.device)
    h[idx, zero_bin.long()] = h[idx, zero_bin.long()] + (tot[None, :] - per_feat)
    return h


def _sides(panel: torch.Tensor, side: torch.Tensor, totals: torch.Tensor, ctrl: torch.Tensor):
    """The rows pass: ``totals`` written; (half, slot, the sides to sum)."""
    half, slot, _ = (int(v) for v in ctrl.tolist())
    p = panel[:, :3]
    for s in (0, 1):
        totals[s] = (p * (side == s).to(torch.float32)[:, None]).sum(0)
    return half, slot, g_summed_sides(side, ctrl)


def sparse_hist_plain(sb: SparseBinned, panel: torch.Tensor, side: torch.Tensor,
                      out: torch.Tensor, totals: torch.Tensor, ctrl: torch.Tensor,
                      parent: Optional[torch.Tensor] = None) -> None:
    """Plain PyTorch version of :func:`sparse_hist` (same arguments): the
    sides' totals and member counts, then a gather of the panel at the
    entries' rows and ``index_add_`` into the cells, and the zero-bin
    residual."""
    half, slot, sides = _sides(panel, side, totals, ctrl)
    p = panel[:, :3]
    d, B = sb.d, sb.n_bins
    side_e = side[sb.rows.long()]
    p_e = p[sb.rows.long()]
    cells = sb.cells.long()
    for s in sides:
        h = torch.zeros(d * B, 3, dtype=torch.float32, device=p.device)
        m = side_e == s
        h.index_add_(0, cells[m], p_e[m])
        out[s] = _residual(h.reshape(d, B, 3), totals[s], sb.zero_bin)
        if half and parent is not None:
            out[1 - s] = parent[slot] - out[s]


def sparse_hist_rows_plain(sb: SparseBinned, panel: torch.Tensor, side: torch.Tensor,
                           out: torch.Tensor, totals: torch.Tensor, ctrl: torch.Tensor,
                           parent: Optional[torch.Tensor] = None) -> None:
    """Plain twin of G's row walk (same arguments as :func:`sparse_hist`):
    the member rows of each summed side in CSR order, each row's entries
    read from the row-major view (``row_ptr``, ``row_cells``) and its panel
    added into their cells with ``index_add_``, then the zero-bin residual
    and the sibling. Tests and ``chip_smoke.py`` hold the kernel and
    :func:`sparse_hist_plain` to it."""
    half, slot, sides = _sides(panel, side, totals, ctrl)
    p = panel[:, :3]
    d, B = sb.d, sb.n_bins
    ptr = sb.row_ptr
    for s in sides:
        members = torch.nonzero(side == s)[:, 0]
        lens = ptr[members + 1] - ptr[members]
        n_e = int(lens.sum())
        # each member entry's place in row_cells: its row's start + its rank in the row
        starts = torch.repeat_interleave(ptr[members], lens, output_size=n_e)
        rank = (torch.arange(n_e, device=p.device)
                - torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens, output_size=n_e))
        h = torch.zeros(d * B, 3, dtype=torch.float32, device=p.device)
        h.index_add_(0, sb.row_cells[starts + rank].long(),
                     p[torch.repeat_interleave(members, lens, output_size=n_e)])
        out[s] = _residual(h.reshape(d, B, 3), totals[s], sb.zero_bin)
        if half and parent is not None:
            out[1 - s] = parent[slot] - out[s]


def _check_g(sb: SparseBinned, panel, side, out, totals, ctrl, parent) -> None:
    dev = sb.device
    shape = (2, sb.d, sb.n_bins, 3)
    for name, t, want, dt in (("panel", panel, (sb.n, 4), torch.float32),
                              ("side", side, (sb.n,), torch.int32),
                              ("out", out, shape, torch.float32),
                              ("totals", totals, (2, 3), torch.float32),
                              ("ctrl", ctrl, (3,), torch.int32),
                              ("parent", parent, shape, torch.float32)):
        if t is None:
            continue
        if tuple(t.shape) != want or t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise TypeError(f"{name} must be a contiguous {want} {dt} tensor on {dev}, got "
                            f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if parent is not None and parent.data_ptr() == out.data_ptr():
        raise ValueError("parent and out must be different buffers")


def sparse_hist(sb: SparseBinned, panel: torch.Tensor, side: torch.Tensor,
                out: torch.Tensor, totals: torch.Tensor, ctrl: torch.Tensor,
                parent: Optional[torch.Tensor] = None) -> None:
    """One sparse histogram pass of a growth step, written into ``out`` and
    ``totals``; every control value is read on the device.

    ``panel`` (n, 4) f32 ``[g·w, h·w, w, 0]``; ``side`` (n,) int32, 0 left,
    1 right, >= 2 not a member; ``ctrl`` (3,) int32 ``(half, slot,
    forced)``. ``totals`` (2, 3) gets each side's panel sum. Then, with
    ``half`` 0, ``out`` (2, d, B, 3) gets both sides' histograms; with
    ``half`` 1, only the smaller side's (``forced`` if >= 0, else the right
    side iff it has no more member rows than the left, the reference's
    rule, ``grow.py:662``) is summed and written into its slot, and, given
    ``parent`` (2, d, B, 3), the other slot gets ``parent[slot]`` minus it
    (the sibling by subtraction, ``grow.py:689-695``). Each feature's zero
    bin holds the side's total minus the feature's stored cells. CPU
    tensors take :func:`sparse_hist_plain`; CUDA tensors launch kernel G:
    four device kernels, the rows pass (totals, the smaller side, and the
    path by :func:`g_path`), then the stream, the row walk and the walk's
    epilogue, of which the path's run and the others return at once."""
    _check_g(sb, panel, side, out, totals, ctrl, parent)
    if sb.device.type == "cpu":
        sparse_hist_plain(sb, panel, side, out, totals, ctrl, parent)
        return
    _launch_g(SPARSE_HIST_KERNEL, sb, panel, side, out, totals, ctrl, parent)


def sparse_hist_mesh(sb: SparseBinned, panel: torch.Tensor, side: torch.Tensor,
                     out: torch.Tensor, totals: torch.Tensor, ctrl: torch.Tensor) -> None:
    """Kernel G's mesh use: :func:`sparse_hist` with no ``parent``, so a
    half-mode call (``ctrl`` = (1, slot, forced), ``forced`` from the
    all-reduced member counts) sums only the forced side into its slot of
    ``out`` and leaves the other slot as it was; the grower all-reduces the
    sum and subtracts it from the kept global parent. CPU tensors take
    :func:`sparse_hist_plain`; CUDA tensors launch G, counted by
    ``SPARSE_HIST_MESH_KERNEL``."""
    _check_g(sb, panel, side, out, totals, ctrl, None)
    if sb.device.type == "cpu":
        sparse_hist_plain(sb, panel, side, out, totals, ctrl)
        return
    _launch_g(SPARSE_HIST_MESH_KERNEL, sb, panel, side, out, totals, ctrl, None)


def _launch_g(kernel: CudaKernel, sb: SparseBinned, panel, side, out, totals, ctrl,
              parent) -> None:
    dev = sb.device
    if dev.type != "cuda":
        raise ValueError(f"kernel G needs a SparseBinned built on a CUDA device, got {dev}")
    if sb.plan is None:
        sb.plan = GPlan(*g_plan(sb.counts, sb.n_bins), g_hot(sb.counts, sb.n, sb.n_bins),
                        sb.d, sb.n_bins, dev)
    pl = sb.plan
    ptr = lambda t: None if t is None else t.data_ptr()
    args = _GArgs(**{name: ptr(t) for name, t in (
                      ("rows", sb.rows), ("cells", sb.cells), ("row_cells", sb.row_cells),
                      ("row_ptr", sb.row_ptr), ("side", side), ("panel", panel),
                      ("zero_bin", sb.zero_bin), ("items", pl.items), ("hot", pl.hot),
                      ("hot_feats", pl.hot_feats), ("acc", pl.acc), ("tickets", pl.tickets),
                      ("rowsum", pl.rowsum), ("state", pl.state), ("touched", pl.touched),
                      ("scratch", pl.scratch), ("ctrl", ctrl), ("out", out),
                      ("totals", totals), ("parent", parent))},
                  n=sb.n, d=sb.d, B=sb.n_bins, nnz=sb.nnz, n_items=pl.items.shape[0],
                  max_feats=pl.max_feats, n_hot=pl.n_hot, device=dev.index)
    kernel(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)


def _panel4(ghc: torch.Tensor) -> torch.Tensor:
    return torch.cat([ghc.to(torch.float32),
                      torch.zeros(ghc.shape[0], 1, dtype=torch.float32, device=ghc.device)],
                     dim=1).contiguous()


def _ctrl(half: int, slot: int, forced: int, device) -> torch.Tensor:
    return torch.tensor([half, slot, forced], dtype=torch.int32, device=device)


def sparse_histogram_split(sb: SparseBinned, ghc: torch.Tensor, side: torch.Tensor):
    """(2, d, B, 3) histograms of both children of a split and (2, 3) side
    totals (the reference's ``sparse_histogram_split``). ``ghc`` (n, 3)
    ``[g·w, h·w, w]``; ``side`` (n,) int, 0 left, 1 right, >= 2 not a
    member."""
    dev = sb.device
    out = torch.empty((2, sb.d, sb.n_bins, 3), dtype=torch.float32, device=dev)
    totals = torch.empty((2, 3), dtype=torch.float32, device=dev)
    sparse_hist(sb, _panel4(ghc), side.to(torch.int32).contiguous(), out, totals,
                _ctrl(0, 0, -1, dev))
    return out, totals


def sparse_histogram_side(sb: SparseBinned, ghc: torch.Tensor, mask: torch.Tensor):
    """(d, B, 3) histogram of the rows in ``mask`` and their (3,) total (the
    reference's ``sparse_histogram_side``): the one-side pass of kernel G."""
    dev = sb.device
    out = torch.empty((2, sb.d, sb.n_bins, 3), dtype=torch.float32, device=dev)
    totals = torch.empty((2, 3), dtype=torch.float32, device=dev)
    side = torch.where(mask.to(torch.bool), 0, 2).to(torch.int32).contiguous()
    sparse_hist(sb, _panel4(ghc), side, out, totals, _ctrl(1, 0, 0, dev))
    return out[0], totals[0]


def sparse_histogram(sb: SparseBinned, ghc: torch.Tensor) -> torch.Tensor:
    """(d, B, 3) histogram of every row (the root histogram)."""
    side = torch.zeros(ghc.shape[0], dtype=torch.int32, device=ghc.device)
    return sparse_histogram_split(sb, ghc, side)[0][0]


def _feature_run(sb: SparseBinned, f: torch.Tensor):
    """(rows, bins, valid) of feature ``f``'s entries (a (1,) int64 tensor on
    the device), padded to ``max_run`` without reading ``f`` on the host."""
    start = sb.starts[f]
    j = torch.arange(sb.max_run, device=sb.device)
    valid = j < sb.starts[f + 1] - start
    pos = torch.clamp(start + j, max=max(sb.nnz - 1, 0))
    return sb.rows[pos].long(), sb.cells[pos].long() - f * sb.n_bins, valid


def sparse_column(sb: SparseBinned, f, n: Optional[int] = None) -> torch.Tensor:
    """(n,) int32 bin column of feature ``f`` (an int, or a one-element int
    tensor on the device, which is not read back): each stored entry's bin,
    the zero bin elsewhere. A bounded gather of ``max_run`` entries at the
    feature's run and one scatter, not an O(nnz) pass (``sparse.py:458``)."""
    n = sb.n if n is None else n
    f = torch.as_tensor(f, device=sb.device).long().reshape(1)
    col = sb.zero_bin[f].expand(n + 1).clone()
    if sb.nnz:
        rows, bins, valid = _feature_run(sb, f)
        col[torch.where(valid, rows, n)] = bins.to(torch.int32)
    return col[:n]


def leaf_feature_hist(sb: SparseBinned, f: torch.Tensor, ghc: torch.Tensor,
                      member: torch.Tensor) -> torch.Tensor:
    """(B, 3) histogram of feature ``f`` (a (1,) int64 tensor) over the
    ``member`` rows, with the zero-bin residual (the reference's
    ``leaf_feature_hist``, ``grow.py:597``): what a categorical split's left
    set is read from."""
    B = sb.n_bins
    g = ghc * member.to(torch.float32)[:, None]
    hist = torch.zeros(B, 3, dtype=torch.float32, device=ghc.device)
    if sb.nnz:
        rows, bins, valid = _feature_run(sb, f)
        panel = torch.where(valid[:, None], g[rows], 0.0)
        hist.index_add_(0, torch.where(valid, bins, 0), panel)
    zb = sb.zero_bin[f].long()
    hist[zb] = hist[zb] + (g.sum(0) - hist.sum(0))
    return hist
