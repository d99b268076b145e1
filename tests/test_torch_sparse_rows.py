"""Kernel G's row walk on the CPU: the row-major view of a ``SparseBinned``,
the walk's plain twin ``sparse_hist_rows_plain`` against the plain version
and the JAX package's sparse histograms, the hot features, and the rule by
which G's rows pass chooses its path (a CPU model of the source's).

The kernel itself runs only on the card (``tests/test_torch_kernels.py``,
``-k sparse``); these tests hold what it is checked against.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapseml_tpu.gbdt import sparse as ref_sparse
from synapseml_tpu.gbdt.binning import BinMapper as RefBinMapper
from synapseml_tpu_torch.gbdt.binning import BinMapper
from synapseml_tpu_torch.gbdt.boost import _preround
from synapseml_tpu_torch.gbdt.sparse import (G_HOT_SHARE, G_PATH_STREAM, G_PATH_WALK,
                                             G_WALK_PER_MILLE, CSRMatrix, build_sparse_binned,
                                             g_hot, g_path, g_summed_entries, g_summed_sides,
                                             pack_entries,
                                             sparse_hist_plain, sparse_hist_rows_plain)
from synapseml_tpu_torch.kernels.build import CSRC_DIR
from synapseml_tpu_torch.tools.kernel_cases import SPARSE_HIST_CASES, sparse_hist_case

from torch_threads import one_torch_thread  # noqa: F401

sp = pytest.importorskip("scipy.sparse")

# (half, slot, forced) of each mode, as the card tests run them
G_MODES = {"both_sides": (0, 0, -1), "half_kept_slot0": (1, 0, -1),
           "half_kept_slot1": (1, 1, -1), "forced_left": (1, 0, 0), "forced_right": (1, 1, 1)}


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return bool(torch.equal(a.isnan(), b.isnan()) and torch.equal(a.nan_to_num(), b.nan_to_num()))


# -- the row-major view --------------------------------------------------------------


def _view_csr(case):
    rng = np.random.default_rng(7)
    if case == "empty_rows":  # every third row and the last ten hold nothing
        X = sp.random(600, 80, density=0.06, random_state=7,
                      data_rvs=lambda k: rng.integers(1, 6, k).astype(float)).tocsr()
        keep = (np.arange(600) % 3 != 0) & (np.arange(600) < 590)
        X = sp.csr_matrix(X.multiply(keep[:, None]))
        X.eliminate_zeros()
        return CSRMatrix.from_scipy(X)
    if case == "coalesced_duplicates":  # repeated (row, column) entries summed
        n, nnz = 400, 3000
        rows = np.sort(rng.integers(0, n, nnz))
        cols = rng.integers(0, 40, nnz)
        indptr = np.zeros(n + 1, np.int64)
        np.cumsum(np.bincount(rows, minlength=n), out=indptr[1:])
        return CSRMatrix(indptr, cols, rng.integers(1, 4, nnz).astype(float), (n, 40))
    # vw_sparse: (indices, values) pairs whose hashed indices collide in 2^6 slots
    col = np.empty(500, dtype=object)
    for i in range(500):
        k = int(rng.integers(0, 12))
        col[i] = None if k == 0 else (rng.integers(0, 1 << 20, k), rng.integers(1, 5, k) * 1.0)
    return CSRMatrix.from_pairs(col, num_bits=6)


@pytest.mark.parametrize("case", ["empty_rows", "coalesced_duplicates", "vw_sparse_pairs"])
def test_row_view_equals_csr(case):
    """``row_ptr`` is the CSR ``indptr`` and ``row_cells`` each entry's cell
    ``feature * B + bin`` in CSR order; sorted stably they are the layout's
    cell-sorted entries."""
    csr = _view_csr(case)
    mapper = BinMapper(max_bin=15).fit_csr(csr)
    sb = build_sparse_binned(csr, mapper, "cpu")
    B = sb.n_bins
    assert sb.row_ptr.dtype == torch.int64 and sb.row_cells.dtype == torch.int32
    np.testing.assert_array_equal(sb.row_ptr.numpy(), csr.indptr)
    bins = np.minimum(mapper.transform_csr(csr), B - 1)
    np.testing.assert_array_equal(sb.row_cells.numpy(),
                                  csr.indices.astype(np.int64) * B + bins)
    order = np.argsort(sb.row_cells.numpy(), kind="stable")
    np.testing.assert_array_equal(sb.row_cells.numpy()[order], sb.cells.numpy())
    np.testing.assert_array_equal(csr.row_ids()[order], sb.rows.numpy())
    if case == "empty_rows":
        assert (np.diff(csr.indptr) == 0).sum() >= 200


# -- the row walk's plain twin ---------------------------------------------------------


@pytest.mark.parametrize("mode", sorted(G_MODES))
@pytest.mark.parametrize("case", SPARSE_HIST_CASES)
def test_rows_plain_bit_equal_to_plain(case, mode):
    """The walk's twin gives the plain version's bits on every case and
    mode: totals, the summed side(s), the sibling, and the slot a forced
    half pass leaves as it was."""
    sb, panel, side, kept = sparse_hist_case(case, "cpu")
    half, slot, forced = G_MODES[mode]
    g = torch.Generator().manual_seed(3)
    kept.copy_(_preround(torch.randn(kept.numel(), 1, generator=g), 1 << 20).view_as(kept))
    parent = kept if half and forced < 0 else None
    ctrl = torch.tensor([half, slot, forced], dtype=torch.int32)
    runs = []
    for fn in (sparse_hist_plain, sparse_hist_rows_plain):
        out = torch.full((2, sb.d, sb.n_bins, 3), float("nan"))
        tot = torch.full((2, 3), float("nan"))
        fn(sb, panel, side, out, tot, ctrl, parent)
        runs.append((out, tot))
    assert _same_bits(runs[0][0], runs[1][0]) and _same_bits(runs[0][1], runs[1][1])


def _sparse_data(n, d, density, seed=0):
    rng = np.random.default_rng(seed)
    return sp.random(n, d, density=density, random_state=seed,
                     data_rvs=lambda k: rng.integers(1, 4, k).astype(float)).tocsr()


def _pair(X, max_bin=31):
    c, r = CSRMatrix.from_scipy(X), ref_sparse.CSRMatrix.from_scipy(X)
    pm, rm = BinMapper(max_bin=max_bin).fit_csr(c), RefBinMapper(max_bin=max_bin).fit_csr(r)
    return ref_sparse.build_sparse_binned(r, rm), build_sparse_binned(c, pm, "cpu")


def _grid_panel(n, seed, weight):
    rng = np.random.default_rng(seed)
    nb = 1 << max(n - 1, 1).bit_length()
    g = _preround(torch.from_numpy(rng.normal(size=(n, 1)).astype(np.float32)), nb)[:, 0]
    h = _preround(torch.from_numpy((rng.random((n, 1)) * 0.25).astype(np.float32)), nb)[:, 0]
    w = torch.from_numpy(weight.astype(np.float32))
    return torch.stack([g * w, h * w, w], dim=-1), rng


# fixtures in the reference's exact regime (ROADMAP queue 3): a few entries a
# row over hundreds of rows, so its chunk prefixes stay on the grid
@pytest.mark.parametrize("shape", [(300, 25, 0.05), (1500, 400, 0.05), (4000, 300, 0.05),
                                   (1200, 120, 0.08)])
def test_rows_plain_equals_reference(shape):
    """The walk's twin against the reference's ``sparse_histogram_split``
    (both sides) and ``sparse_histogram_side`` (one masked side), bit for
    bit, with rows of weight 0 among them."""
    n = shape[0]
    rsb, psb = _pair(_sparse_data(*shape))
    ghc, rng = _grid_panel(n, 1, (np.arange(n) % 7 != 0).astype(float))
    panel = torch.cat([ghc, torch.zeros(n, 1)], 1).contiguous()
    side = rng.integers(0, 3, n).astype(np.int32)
    out, tot = torch.empty(2, psb.d, psb.n_bins, 3), torch.empty(2, 3)
    sparse_hist_rows_plain(psb, panel, torch.from_numpy(side), out, tot,
                           torch.tensor([0, 0, -1], dtype=torch.int32))
    r2, rtot = ref_sparse.sparse_histogram_split(rsb, jnp.asarray(ghc.numpy()),
                                                 jnp.asarray(side))
    np.testing.assert_array_equal(out.numpy(), np.asarray(r2))
    np.testing.assert_array_equal(tot.numpy(), np.asarray(rtot))
    mask = rng.random(n) < 0.05
    one = torch.from_numpy(np.where(mask, 0, 2).astype(np.int32))
    sparse_hist_rows_plain(psb, panel, one, out, tot, torch.tensor([1, 0, 0], dtype=torch.int32))
    rh, rt = ref_sparse.sparse_histogram_side(rsb, jnp.asarray(ghc.numpy()), jnp.asarray(mask))
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(rh))
    np.testing.assert_array_equal(tot[0].numpy(), np.asarray(rt))


# -- the hot features and the path rule ------------------------------------------------


def test_g_hot_takes_the_stop_words_first():
    counts = np.array([5, 1000, 0, 400, 16, 999, 17], dtype=np.int64)
    n = 1024  # more than n / 64 = 16 entries
    assert g_hot(counts, n, 8).tolist() == [1, 5, 3, 6]
    # room for two features' (B, 3) sums
    assert g_hot(counts, n, 8, smem=2 * 8 * 12).tolist() == [1, 5]
    assert g_hot(counts, n, 8, share=0.5).tolist() == [1, 5]
    assert len(g_hot(np.full(1000, 99), 100, 1)) == 255  # slots a uint8 names
    sb = sparse_hist_case("stop_word")[0]
    assert g_hot(sb.counts, sb.n, sb.n_bins).tolist() == [3]
    assert G_HOT_SHARE * sb.n < sb.counts[3]


def test_path_rule_mirrors_the_source():
    src = (CSRC_DIR / "sparse_hist.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kWalkPerMille") == G_WALK_PER_MILLE
    assert (const("kPathStream"), const("kPathWalk")) == (G_PATH_STREAM, G_PATH_WALK)
    assert "summed * 1000 < (long long)a.nnz * kWalkPerMille ? kPathWalk : kPathStream" in src
    assert "a->n_hot > 255" in src


def _four_a_row(n):
    """A SparseBinned of ``n`` rows of exactly 4 entries (feature r % 50 + k)."""
    r = np.repeat(np.arange(n), 4)
    cols = (r % 50 + np.tile(np.arange(4), n)).astype(np.int64)
    return pack_entries(torch.from_numpy(r), torch.from_numpy(cols), torch.from_numpy(r % 3),
                        torch.arange(0, 4 * n + 1, 4), np.zeros(53, np.int32), n, 53, 3)


@pytest.mark.parametrize("mode", sorted(G_MODES))
@pytest.mark.parametrize("offset", [-1, 0, 1])
def test_path_rule_at_the_threshold(mode, offset):
    """The summed side(s) one row (4 entries) below, at and above the
    threshold's row count: the row walk strictly below G_WALK_PER_MILLE
    thousandths of the entries, else the stream."""
    n = 1000
    sb = _four_a_row(n)
    k = n * G_WALK_PER_MILLE // 1000 + offset  # rows on the summed side(s)
    half, slot, forced = G_MODES[mode]
    side = np.full(n, 3, np.int32)
    summed_side = forced if forced >= 0 else 1
    if half:
        side[:k] = summed_side
        side[k:] = 1 - summed_side  # the other side is larger: the summed one is smaller
    else:
        side[:k] = np.arange(k) % 2  # the leaf's k rows, on both sides
    summed = g_summed_entries(sb, torch.from_numpy(side), (half, slot, forced))
    assert summed == 4 * k
    want = G_PATH_WALK if 4 * k * 1000 < sb.nnz * G_WALK_PER_MILLE else G_PATH_STREAM
    assert g_path(summed, sb.nnz) == want
    assert want == (G_PATH_WALK if offset < 0 else G_PATH_STREAM)


# the side summed in half mode for (left members, right members): ties go
# right, the reference's smaller child
SUMMED = {(3, 5): (0,), (5, 3): (1,), (4, 4): (1,), (0, 0): (1,)}


@pytest.mark.parametrize("mode", sorted(G_MODES))
@pytest.mark.parametrize("counts", sorted(SUMMED))
def test_summed_sides(mode, counts):
    """Both sides in both-sides mode; in half mode the forced side, else the
    right iff it has no more members than the left. Rows of neither side
    (2, 3) do not count. The same from a tuple and from ``ctrl`` as a call
    passes it (a tensor)."""
    half, slot, forced = G_MODES[mode]
    side = torch.tensor([2] + [0] * counts[0] + [3] + [1] * counts[1], dtype=torch.int32)
    want = (0, 1) if not half else (forced,) if forced >= 0 else SUMMED[counts]
    assert g_summed_sides(side, G_MODES[mode]) == want
    assert g_summed_sides(side, torch.tensor(G_MODES[mode], dtype=torch.int32)) == want


def test_path_rule_edges():
    assert g_path(0, 0) == G_PATH_STREAM          # nothing stored: the stream's blocks
    assert g_path(0, 10) == G_PATH_WALK           # members without entries
    assert g_path(10, 10) == G_PATH_STREAM        # every entry
    sb = sparse_hist_case("rows_40")[0]
    side = sparse_hist_case("rows_40")[2]
    assert g_summed_entries(sb, side, (1, 0, -1)) < 40 * 20
    assert g_path(g_summed_entries(sb, side, (1, 0, -1)), sb.nnz) == G_PATH_WALK
    assert g_path(g_summed_entries(sb, side, (0, 0, -1)), sb.nnz) == G_PATH_STREAM
