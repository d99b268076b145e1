"""The port's sparse (CSR) GBDT path against the JAX package's, on the CPU.

Each single-device case of ``tests/test_gbdt_sparse.py`` runs here as a
parity test: the same seeded inputs through ``synapseml_tpu`` and through
``synapseml_tpu_torch`` with ``device="cpu"``. Trees must be identical
(parents, features, bins, category sets); leaf values agree within the
binary/l2 tolerances ROADMAP queue 3 states for XLA's ``exp`` and ``exp2``.

The sparse histogram probe: the reference sums a cell as the difference of
two chunk-local prefixes plus a mean-centred inter-chunk offset
(``sparse.py:312``); on ``_preround``'s grid that is exact while a chunk's
prefix stays within the grid's exact range, which holds for every fixture
here. With many entries a row over few rows (``PREFIX_ROUNDS``: 1,000 rows
at 40 entries a row, 3 chunks) the prefixes leave it and the reference's
cells are off by up to ~1.5e-4; the port's cells are the exact sums there
(bit-equal to a float64 histogram), within ``REF_PREFIX_TOL`` of the
reference's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapseml_tpu.gbdt import sparse as ref_sparse
from synapseml_tpu.gbdt.binning import BinMapper as RefBinMapper
from synapseml_tpu.gbdt.boost import GBDTBooster as RefBooster
from synapseml_tpu.gbdt.boost import train as ref_train
from synapseml_tpu.gbdt.grow import TreeConfig as RefTreeConfig
from synapseml_tpu.gbdt.grow import _prefix_bins, _thresh_l1
from synapseml_tpu_torch.gbdt.binning import BinMapper
from synapseml_tpu_torch.gbdt.boost import GBDTBooster, _preround, train
from synapseml_tpu_torch.gbdt.grow import TreeConfig, grow_tree_sparse, predict_binned
from synapseml_tpu_torch.gbdt.sparse import (CSRMatrix, build_sparse_binned, g_plan,
                                             leaf_feature_hist, sparse_column, sparse_hist,
                                             sparse_histogram, sparse_histogram_side,
                                             sparse_histogram_split)
from synapseml_tpu_torch.gbdt.split_search import split_search
from synapseml_tpu_torch.tools.kernel_cases import (SPARSE_HIST_CASES, full_pass,
                                                    grow_sparse_full_pass, sparse_hist_case)

from torch_threads import one_torch_thread  # noqa: F401

sp = pytest.importorskip("scipy.sparse")

CPU = "cpu"
# binary leaves: XLA's CPU exp in the sigmoid (ROADMAP queue 3)
BINARY_LEAF_TOL = 1e-3
# l2 leaves: XLA's inexact exp2 in _preround (ROADMAP queue 3)
L2_LEAF_TOL = 1e-4
# the reference's prefix-difference cells where the chunk prefixes leave the
# pre-rounding grid's exact range (module docstring)
PREFIX_ROUNDS = (1000, 400, 0.1)
REF_PREFIX_TOL = 2e-4


def _sparse_data(n=1500, d=400, density=0.05, seed=0):
    rng = np.random.default_rng(seed)
    X = sp.random(n, d, density=density, random_state=seed,
                  data_rvs=lambda k: rng.integers(1, 4, k).astype(float)).tocsr()
    w = rng.normal(size=d) * (rng.random(d) < 0.2)
    y = ((X @ w) + 0.1 * rng.normal(size=n) > 0).astype(float)
    return X, y


def _cat_sparse_data(n=800, d=60, seed=0):
    """Sparse matrix whose column 0 is an informative categorical."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, d))
    for i in range(n):
        cols = rng.choice(np.arange(1, d), size=6, replace=False)
        dense[i, cols] = rng.integers(1, 4, size=6)
    cats = rng.integers(0, 6, size=n).astype(np.float64)
    dense[:, 0] = cats
    y = (np.isin(cats, [1, 4]).astype(np.float64) * 2
         + dense[:, 3] - dense[:, 7]
         + 0.1 * rng.normal(size=n) > 1).astype(np.float64)
    return sp.csr_matrix(dense), dense, y


def _auc(y, p):
    order = np.argsort(p)
    rank = np.empty_like(order, dtype=np.float64)
    rank[order] = np.arange(1, len(p) + 1)
    pos = y > 0
    n1, n0 = pos.sum(), (~pos).sum()
    return (rank[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0)


def _same_trees(bp, br, leaf_tol):
    for f in ("parent", "feature", "bin"):
        np.testing.assert_array_equal(getattr(bp, f), getattr(br, f), err_msg=f)
    if br.cat_set is not None and (br.bin < 0).any():
        np.testing.assert_array_equal(bp.cat_set, br.cat_set)
    np.testing.assert_allclose(bp.leaf_value, br.leaf_value, rtol=0, atol=leaf_tol)
    np.testing.assert_allclose(bp.tree_scale, br.tree_scale, rtol=1e-12)


# -- the CSR container -------------------------------------------------------------


def test_csr_from_scipy_roundtrip():
    X, _ = _sparse_data(200, 50)
    c, r = CSRMatrix.from_scipy(X), ref_sparse.CSRMatrix.from_scipy(X)
    np.testing.assert_array_equal(c.toarray(), X.toarray())
    assert c.nnz == X.nnz and c.shape == X.shape
    for f in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(c, f), getattr(r, f))


def test_csr_coalesces_duplicates_as_reference():
    rows = np.array([0, 0, 1, 1, 1, 2])
    cols = np.array([3, 3, 0, 5, 0, 1])
    vals = np.arange(1.0, 7.0)
    indptr = np.array([0, 2, 5, 6])
    c = CSRMatrix(indptr, cols, vals, (3, 6))
    r = ref_sparse.CSRMatrix(indptr, cols, vals, (3, 6))
    for f in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(c, f), getattr(r, f))
    dense = np.zeros((3, 6))
    np.add.at(dense, (rows, cols), vals)
    np.testing.assert_array_equal(c.toarray(), dense)


def test_csr_from_pairs_masks_indices():
    col = np.empty(4, object)
    col[0] = (np.array([5, 1 << 20], np.uint32), np.array([1.0, 2.0], np.float32))
    col[1] = None
    col[2] = (np.array([7], np.uint32), np.array([3.0], np.float32))
    col[3] = (np.array([3, 3 + 1024, 9], np.uint32), np.array([1.0, 4.0, 2.0]))
    c = CSRMatrix.from_pairs(col, num_bits=10)
    r = ref_sparse.CSRMatrix.from_pairs(col, num_bits=10)
    assert c.shape == (4, 1024)
    dense = c.toarray()
    assert dense[0, 5] == 1.0 and dense[0, (1 << 20) % 1024] == 2.0
    assert dense[1].sum() == 0 and dense[2, 7] == 3.0 and dense[3, 3] == 5.0
    for f in ("indptr", "indices", "values"):
        np.testing.assert_array_equal(getattr(c, f), getattr(r, f))


def test_csr_take_rows_and_slice():
    X, _ = _sparse_data(100, 30)
    c = CSRMatrix.from_scipy(X)
    idx = np.array([3, 17, 50, 99])
    np.testing.assert_array_equal(c.take_rows(idx).toarray(), X.toarray()[idx])
    np.testing.assert_array_equal(c.row_slice(10, 40).toarray(), X.toarray()[10:40])
    np.testing.assert_array_equal(c[10:40].toarray(), X.toarray()[10:40])
    r = ref_sparse.CSRMatrix.from_scipy(X)
    np.testing.assert_array_equal(c.tocsc_order(), r.tocsc_order())


# -- binning -------------------------------------------------------------------------


def _bin_cases():
    rng = np.random.default_rng(0)
    X, _ = _sparse_data(800, 60)
    Xq = sp.random(3000, 40, density=0.2, random_state=1,
                   data_rvs=lambda k: rng.normal(size=k)).tocsr()
    Xq.data[::17] = np.nan
    Xq.data[::23] = np.inf
    Xq.data[::29] = -np.inf
    Xq.data[::31] = 0.0      # explicit zeros are stored entries
    Xq.data[::37] = -0.0
    Xc = Xq.copy()
    Xc.data = np.round(Xc.data * 3)
    D = np.zeros((50, 5))
    D[:, 0] = rng.integers(1, 5, 50)   # a feature stored in every row
    D[:, 2] = np.nan                   # a feature of NaN only
    empty = sp.csr_matrix((np.zeros(0), (np.zeros(0, int), np.zeros(0, int))), shape=(10, 4))
    return {
        "exact": (X, dict(max_bin=255)),
        "two_bins": (X, dict(max_bin=2)),
        "quantile_nonfinite": (Xq, dict(max_bin=16)),
        "categorical": (Xq, dict(max_bin=255, categorical_features=[0, 3])),
        "categorical_capped": (Xc, dict(max_bin=4, categorical_features=[1, 2, 5])),
        "sampled": (Xc, dict(max_bin=255, sample_cnt=500, seed=3, categorical_features=[7])),
        "by_feature": (Xc, dict(max_bin=8, max_bin_by_feature=[3] * 10 + [0] * 30)),
        "full_and_nan_columns": (sp.csr_matrix(D), dict(max_bin=3)),
        "no_entries": (empty, dict(max_bin=10)),
    }


@pytest.mark.parametrize("case", sorted(_bin_cases()))
def test_fit_and_transform_csr_match_reference(case):
    X, kw = _bin_cases()[case]
    c, r = CSRMatrix.from_scipy(X), ref_sparse.CSRMatrix.from_scipy(X)
    pm, rm = BinMapper(**kw).fit_csr(c), RefBinMapper(**kw).fit_csr(r)
    assert len(pm.upper_edges) == len(rm.upper_edges)
    for j, (a, b) in enumerate(zip(pm.upper_edges, rm.upper_edges)):
        np.testing.assert_array_equal(a, b, err_msg=f"feature {j}")
    assert sorted(pm.cat_values) == sorted(rm.cat_values)
    for j in rm.cat_values:
        np.testing.assert_array_equal(pm.cat_values[j], rm.cat_values[j])
    assert pm.realized_n_bins == rm.realized_n_bins
    np.testing.assert_array_equal(pm.transform_csr(c), rm.transform_csr(r))
    for compact in (False, True):
        np.testing.assert_array_equal(pm.zero_bins(compact), rm.zero_bins(compact))
    # a mapper fitted here loads in the reference and bins alike
    rm2 = RefBinMapper.from_dict(pm.to_dict())
    np.testing.assert_array_equal(rm2.transform_csr(r), pm.transform_csr(c))


def test_fit_csr_matches_dense_fit_exact_path():
    X, _ = _sparse_data(800, 60)
    m_sparse = BinMapper(max_bin=255).fit_csr(CSRMatrix.from_scipy(X))
    m_dense = BinMapper(max_bin=255).fit(X.toarray())
    for a, b in zip(m_sparse.upper_edges, m_dense.upper_edges):
        np.testing.assert_allclose(a, b)


def test_transform_csr_matches_dense_transform():
    X, _ = _sparse_data(500, 40)
    c = CSRMatrix.from_scipy(X)
    m = BinMapper(max_bin=255).fit_csr(c)
    dense_bins = m.transform(X.toarray())
    np.testing.assert_array_equal(m.transform_csr(c), dense_bins[c.row_ids(), c.indices])
    zb = m.zero_bins()
    zero = X.toarray() == 0
    for j in range(X.shape[1]):
        assert (dense_bins[zero[:, j], j] == zb[j]).all()


def test_quantile_path_weighted_zero_mass():
    rng = np.random.default_rng(3)
    n = 2000
    vals = rng.normal(size=n // 4)
    rows = rng.choice(n, size=n // 4, replace=False)
    X = sp.csr_matrix((vals, (rows, np.zeros(len(rows), int))), shape=(n, 1))
    m = BinMapper(max_bin=16).fit_csr(CSRMatrix.from_scipy(X))
    e = m.upper_edges[0]
    assert (e[:-1] >= 0).any() and len(e) <= 17
    r = RefBinMapper(max_bin=16).fit_csr(ref_sparse.CSRMatrix.from_scipy(X))
    np.testing.assert_array_equal(e, r.upper_edges[0])


# -- the sparse histogram (kernel G's plain version) ---------------------------------


def _binned_pair(X, max_bin=31):
    c, r = CSRMatrix.from_scipy(X), ref_sparse.CSRMatrix.from_scipy(X)
    pm, rm = BinMapper(max_bin=max_bin).fit_csr(c), RefBinMapper(max_bin=max_bin).fit_csr(r)
    return pm, ref_sparse.build_sparse_binned(r, rm), build_sparse_binned(c, pm, CPU)


def _exact_hist(pm, X, sb, ghc, side):
    """(2, d, B, 3) float64 histograms from the densified bins."""
    dense = pm.transform(X.toarray())
    dense = np.where(dense >= sb.n_bins, sb.n_bins - 1, dense)
    out = np.zeros((2, sb.d, sb.n_bins, 3))
    g = ghc.astype(np.float64)
    for s in (0, 1):
        m = side == s
        for j in range(sb.d):
            np.add.at(out[s, j], dense[m, j], g[m])
    return out


def _grid_panel(n, seed, weight=None):
    rng = np.random.default_rng(seed)
    nb = 1 << max(n - 1, 1).bit_length()
    g = _preround(torch.from_numpy(rng.normal(size=(n, 1)).astype(np.float32)), nb)[:, 0]
    h = _preround(torch.from_numpy((rng.random((n, 1)) * 0.25).astype(np.float32)), nb)[:, 0]
    w = torch.ones(n) if weight is None else torch.from_numpy(weight.astype(np.float32))
    return torch.stack([g * w, h * w, w], dim=-1), rng


@pytest.mark.parametrize("shape", [(300, 25, 0.05), (1500, 400, 0.05), (4000, 300, 0.05),
                                   PREFIX_ROUNDS])
def test_sparse_histogram_split_exact_and_against_reference(shape):
    X, _ = _sparse_data(*shape)
    pm, rsb, psb = _binned_pair(X)
    n = X.shape[0]
    ghc, rng = _grid_panel(n, 1)
    side = rng.integers(0, 3, n).astype(np.int32)
    h2, tot = sparse_histogram_split(psb, ghc, torch.from_numpy(side))
    exact = _exact_hist(pm, X, psb, ghc.numpy(), side)
    np.testing.assert_array_equal(h2.numpy(), exact.astype(np.float32))
    assert np.array_equal(h2.numpy().astype(np.float64), exact)
    r2, rtot = ref_sparse.sparse_histogram_split(rsb, jnp.asarray(ghc.numpy()),
                                                 jnp.asarray(side))
    np.testing.assert_array_equal(tot.numpy(), np.asarray(rtot))
    if shape == PREFIX_ROUNDS:  # the reference's prefixes round (module docstring)
        err = np.abs(np.asarray(r2) - exact).max()
        assert 0 < err <= REF_PREFIX_TOL
    else:
        np.testing.assert_array_equal(h2.numpy(), np.asarray(r2))


def test_sparse_histogram_matches_numpy():
    from synapseml_tpu_torch.gbdt.histogram import histogram_plain

    X, _ = _sparse_data(300, 25)
    pm, _, sb = _binned_pair(X)
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.normal(size=300).astype(np.float32))
    h = torch.from_numpy(rng.random(300).astype(np.float32) + 0.5)
    w = torch.ones(300)
    got = sparse_histogram(sb, torch.stack([g * w, h * w, w], -1))
    dense = pm.transform(X.toarray())
    dense = torch.from_numpy(np.where(dense >= sb.n_bins, sb.n_bins - 1, dense))
    torch.testing.assert_close(got, histogram_plain(dense, g, h, w, sb.n_bins),
                               rtol=1e-4, atol=1e-4)


def test_sparse_histogram_side_matches_reference():
    X, _ = _sparse_data(1200, 120, density=0.08, seed=5)
    _, rsb, psb = _binned_pair(X)
    ghc, rng = _grid_panel(1200, 2, weight=(np.arange(1200) % 7 != 0).astype(float))
    mask = rng.random(1200) < 0.4
    h, tot = sparse_histogram_side(psb, ghc, torch.from_numpy(mask))
    rh, rtot = ref_sparse.sparse_histogram_side(rsb, jnp.asarray(ghc.numpy()),
                                                jnp.asarray(mask))
    np.testing.assert_array_equal(h.numpy(), np.asarray(rh))
    np.testing.assert_array_equal(tot.numpy(), np.asarray(rtot))


@pytest.mark.parametrize("case", SPARSE_HIST_CASES)
def test_sparse_hist_modes_on_edge_cases(case):
    """The plain version in its three modes on the kernel's shared edge cases:
    both sides; the smaller side with the sibling from the kept histogram
    (equal to the both-sides pass); one forced side."""
    sb, panel, side, parent = sparse_hist_case(case, CPU)
    shape = (2, sb.d, sb.n_bins, 3)
    full, tot = torch.empty(shape), torch.empty(2, 3)
    sparse_hist(sb, panel, side, full, tot, torch.tensor([0, 0, -1], dtype=torch.int32))
    ref = _exact_hist_sb(sb, panel, side)
    assert torch.equal(full, ref)
    # parent slot 1 holds the union of both sides: the sibling is exact
    half, tot_h = torch.full(shape, np.nan), torch.empty(2, 3)
    parent[1] = full[0] + full[1]
    sparse_hist(sb, panel, side, half, tot_h, torch.tensor([1, 1, -1], dtype=torch.int32),
                parent)
    assert torch.equal(half, full) and torch.equal(tot_h, tot)
    one = torch.full(shape, np.nan)
    sparse_hist(sb, panel, side, one, tot_h, torch.tensor([1, 0, 1], dtype=torch.int32))
    assert torch.equal(one[1], full[1]) and bool(one[0].isnan().all())


def _exact_hist_sb(sb, panel, side):
    """(2, d, B, 3) histograms of a SparseBinned, summed in float64."""
    d, B = sb.d, sb.n_bins
    out = torch.zeros(2, d * B, 3, dtype=torch.float64)
    rows, cells = sb.rows.long(), sb.cells.long()
    p = panel[:, :3].double()
    for s in (0, 1):
        m = side[rows] == s
        out[s].index_add_(0, cells[m], p[rows[m]])
        tot = (p * (side == s).double()[:, None]).sum(0)
        h = out[s].view(d, B, 3)
        h[torch.arange(d), sb.zero_bin.long()] += tot - h.sum(1)
    return out.view(2, d, B, 3).float()


def test_g_plan_covers_every_feature_and_entry():
    counts = np.array([0, 5, 9000, 0, 3, 4096, 4097, 1, 0] + [2] * 100, dtype=np.int64)
    items, heavy, most = g_plan(counts, 8, entries=4096, smem=8 * 24 * 10)
    assert heavy == 2 and most <= 10
    starts = np.concatenate([[0], np.cumsum(counts)])
    feats = np.zeros(len(counts), int)
    ents = np.zeros(starts[-1], int)
    for f0, f1, e0, e1, slot, k in items:
        assert e1 - e0 <= 4096 and f1 > f0
        ents[e0:e1] += 1
        if slot < 0:
            feats[f0:f1] += 1
            assert (e0, e1) == (starts[f0], starts[f1])
        else:
            assert f1 == f0 + 1 and counts[f0] > 4096 and k == -(-counts[f0] // 4096)
    feats[[2, 6]] += 1
    assert (feats == 1).all() and (ents == 1).all()


def test_sparse_column_matches_dense():
    X, _ = _sparse_data(200, 30)
    pm, rsb, psb = _binned_pair(X)
    dense = pm.transform(X.toarray())
    dense = np.where(dense >= psb.n_bins, psb.n_bins - 1, dense)
    for f in [0, 7, 29]:
        col = sparse_column(psb, f, 200).numpy()
        np.testing.assert_array_equal(col, dense[:, f])
        np.testing.assert_array_equal(col, np.asarray(ref_sparse.sparse_column(rsb, f, 200)))


def test_leaf_feature_hist_matches_histogram_row():
    X, _ = _sparse_data(600, 50)
    _, _, sb = _binned_pair(X)
    ghc, rng = _grid_panel(600, 4)
    member = torch.from_numpy(rng.random(600) < 0.5)
    h2, _ = sparse_histogram_split(sb, ghc, torch.where(member, 0, 2))
    for f in (0, 13, 49):
        row = leaf_feature_hist(sb, torch.tensor([f]), ghc, member)
        assert torch.equal(row, h2[0, f])


def _ref_best_of_children(h2, fmask, cmask, cfg):
    """The reference's sparse ``numeric_gain`` + argmax (``grow.py:530-565``,
    non-voting), as it stands there, in jnp."""
    B = h2.shape[-2]
    pos = jnp.arange(B)

    def gain_term(G, H):
        return _thresh_l1(G, cfg.lambda_l1) ** 2 / (H + cfg.lambda_l2)

    def parts(G, H, C, GL, HL, CL, fm, extra):
        GT, HT, CT = (a.sum(-1, keepdims=True) for a in (G, H, C))
        GR, HR, CR = GT - GL, HT - HL, CT - CL
        g = gain_term(GL, HL) + gain_term(GR, HR) - gain_term(GT, HT)
        valid = ((pos < B - 1) & (CL >= cfg.min_data_in_leaf) & (CR >= cfg.min_data_in_leaf)
                 & (HL >= cfg.min_sum_hessian) & (HR >= cfg.min_sum_hessian) & extra
                 & (fm[..., None] > 0))
        return jnp.where(valid, g, -jnp.inf)

    G, H, C = h2[..., 0], h2[..., 1], h2[..., 2]
    cum = _prefix_bins(h2)
    gain = parts(G, H, C, cum[..., 0], cum[..., 1], cum[..., 2], fmask, True)
    if cmask is not None:
        order = jnp.argsort(-(G / (H + cfg.cat_smooth)), axis=-1)
        cums = _prefix_bins(jnp.take_along_axis(h2, order[..., None], axis=-2))
        g_cat = parts(G, H, C, cums[..., 0], cums[..., 1], cums[..., 2], fmask,
                      pos + 1 <= cfg.max_cat_threshold)
        gain = jnp.where(cmask[..., None] > 0, g_cat, gain)
    flat = gain.reshape(2, -1)
    idx = jnp.argmax(flat, axis=-1)
    return (np.asarray(jnp.take_along_axis(flat, idx[:, None], axis=-1)[:, 0]),
            np.asarray(idx // B), np.asarray(idx % B))


@pytest.mark.parametrize("cat", [False, True])
def test_split_search_full_entry_equals_reference_sparse_gain(cat):
    """Kernel E's full-table entry (its plain version here) over a (2, d, B,
    3) child pair gives the reference sparse grower's per-child best."""
    X, dense, _ = _cat_sparse_data(n=800)
    c = CSRMatrix.from_scipy(X)
    pm = BinMapper(max_bin=31, categorical_features=[0] if cat else None).fit_csr(c)
    sb = build_sparse_binned(c, pm, CPU)
    ghc, rng = _grid_panel(800, 6)
    side = torch.from_numpy(rng.integers(0, 3, 800).astype(np.int32))
    h2, _ = sparse_histogram_split(sb, ghc, side)
    fmask = (torch.from_numpy(rng.random(sb.d)) < 0.9).float()
    cmask = torch.zeros(sb.d)
    cmask[0] = 1.0
    cfg = TreeConfig(n_bins=sb.n_bins, min_data_in_leaf=5, lambda_l1=0.5, lambda_l2=1.0)
    gain, feat, bins = split_search(h2, fmask, cmask if cat else None, 2, cfg)
    rcfg = RefTreeConfig(n_bins=sb.n_bins, min_data_in_leaf=5, lambda_l1=0.5, lambda_l2=1.0)
    rg, rf, rb = _ref_best_of_children(jnp.asarray(h2.numpy()), jnp.asarray(fmask.numpy()),
                                       jnp.asarray(cmask.numpy()) if cat else None, rcfg)
    np.testing.assert_array_equal(feat.numpy(), rf)
    np.testing.assert_array_equal(bins.numpy(), rb)
    np.testing.assert_allclose(gain.numpy(), rg, rtol=1e-6)


def test_predict_binned_sparse_equals_dense_replay():
    X, y = _sparse_data(600, 80)
    b = train({"objective": "binary", "num_iterations": 3, "num_leaves": 7,
               "min_data_in_leaf": 5}, X, y, device=CPU)
    c = CSRMatrix.from_scipy(X)
    sb = build_sparse_binned(c, b.mapper, CPU)
    dense = torch.from_numpy(np.minimum(b.mapper.transform(X.toarray()), sb.n_bins - 1))
    from synapseml_tpu_torch.gbdt.grow import GrownTree
    for t in range(3):
        tree = GrownTree(*(torch.from_numpy(getattr(b, f)[t, 0]) for f in
                           ("parent", "feature", "bin", "gain", "leaf_value", "leaf_hess")))
        assert torch.equal(predict_binned(tree, sb), predict_binned(tree, dense))


# -- training --------------------------------------------------------------------------


BINARY = {"objective": "binary", "num_iterations": 20, "num_leaves": 15, "min_data_in_leaf": 5}


def test_sparse_train_matches_reference_and_dense_auc():
    X, y = _sparse_data()
    bp = train(BINARY, X, y, device=CPU)
    _same_trees(bp, ref_train(BINARY, X, y), BINARY_LEAF_TOL)
    b_dense = train(BINARY, X.toarray(), y, device=CPU)
    auc_s = _auc(y, bp.predict(X, device=CPU))
    assert auc_s > 0.9
    assert abs(auc_s - _auc(y, b_dense.predict(X.toarray(), device=CPU))) < 0.02


def test_sparse_predict_matches_densified_exactly():
    X, y = _sparse_data(800, 200)
    b = train({"objective": "binary", "num_iterations": 10, "num_leaves": 15,
               "min_data_in_leaf": 5}, X, y, device=CPU)
    np.testing.assert_array_equal(b.raw_predict(X, device=CPU),
                                  b.raw_predict(X.toarray(), device=CPU))
    np.testing.assert_array_equal(b.predict_leaf(X, device=CPU),
                                  b.predict_leaf(X.toarray(), device=CPU))
    np.testing.assert_array_equal(b.predict(CSRMatrix.from_scipy(X), device=CPU),
                                  b.predict(X.toarray(), device=CPU))


@pytest.mark.parametrize("boosting", ["gbdt", "goss"])
def test_sparse_regression_and_goss(boosting):
    X, _ = _sparse_data(1000, 150)
    rng = np.random.default_rng(5)
    w = rng.normal(size=150) * (rng.random(150) < 0.3)
    y = np.asarray(X @ w) + 0.05 * rng.normal(size=1000)
    params = {"objective": "regression", "num_iterations": 15, "num_leaves": 15,
              "min_data_in_leaf": 5, "boosting": boosting}
    bp = train(params, X, y, device=CPU)
    _same_trees(bp, ref_train(params, X, y), L2_LEAF_TOL)
    assert np.corrcoef(bp.predict(X, device=CPU), y)[0, 1] > 0.8


def test_sparse_multiclass_matches_reference():
    X, _ = _sparse_data(600, 60, density=0.1, seed=7)
    y = np.random.default_rng(7).integers(0, 3, 600).astype(float)
    params = {"objective": "multiclass", "num_class": 3, "num_iterations": 3,
              "num_leaves": 7, "min_data_in_leaf": 5}
    _same_trees(train(params, X, y, device=CPU), ref_train(params, X, y), 1e-4)


def _evals(b, key):
    return np.array([r[key] for r in b.evals_result])


def test_sparse_eval_early_stopping():
    X, y = _sparse_data(1200, 200)
    params = {"objective": "binary", "num_iterations": 50, "num_leaves": 15,
              "min_data_in_leaf": 5, "early_stopping_round": 3}
    bp = train(params, X[:900], y[:900], eval_set=[(X[900:], y[900:])], device=CPU)
    br = ref_train(params, X[:900], y[:900], eval_set=[(X[900:], y[900:])])
    assert bp.evals_result and len(bp.evals_result) <= 50
    assert bp.best_iteration == br.best_iteration
    n = min(len(bp.evals_result), len(br.evals_result))
    np.testing.assert_allclose(_evals(bp, "eval0_binary_logloss")[:n],
                               _evals(br, "eval0_binary_logloss")[:n], atol=1e-5)
    _same_trees(bp, br, BINARY_LEAF_TOL)


def test_sparse_eval_host_loop_matches_device_eval():
    X, y = _sparse_data(1200, 200)
    params = {"objective": "binary", "num_iterations": 12, "num_leaves": 15,
              "min_data_in_leaf": 5}
    b_dev = train(params, X[:900], y[:900], eval_set=[(X[900:], y[900:])], device=CPU)
    seen = []
    b_host = train(params, X[:900], y[:900], eval_set=[(X[900:], y[900:])], device=CPU,
                   callbacks=[lambda info: seen.append(info["iteration"])])
    assert seen == list(range(12))
    np.testing.assert_allclose(_evals(b_host, "eval0_binary_logloss"),
                               _evals(b_dev, "eval0_binary_logloss"), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(b_host.predict(X[900:], device=CPU),
                                  b_dev.predict(X[900:], device=CPU))
    br = ref_train(params, X[:900], y[:900], eval_set=[(X[900:], y[900:])],
                   callbacks=[lambda info: None])
    np.testing.assert_allclose(_evals(b_host, "eval0_binary_logloss"),
                               _evals(br, "eval0_binary_logloss"), atol=1e-6)


def test_sparse_eval_host_metric():
    X, y = _sparse_data(900, 150)
    params = {"objective": "binary", "num_iterations": 8, "num_leaves": 15,
              "min_data_in_leaf": 5, "metric": "auc", "early_stopping_round": 4}
    bp = train(params, X[:700], y[:700], eval_set=[(X[700:], y[700:])], device=CPU)
    br = ref_train(params, X[:700], y[:700], eval_set=[(X[700:], y[700:])])
    assert bp.evals_result and "eval0_auc" in bp.evals_result[0]
    assert bp.evals_result[-1]["eval0_auc"] > 0.7
    assert bp.best_iteration == br.best_iteration
    n = min(len(bp.evals_result), len(br.evals_result))
    np.testing.assert_allclose(_evals(bp, "eval0_auc")[:n], _evals(br, "eval0_auc")[:n],
                               atol=1e-6)


def test_sparse_eval_set_needs_sparse_training():
    X, y = _sparse_data(300, 40)
    with pytest.raises(ValueError, match="sparse eval_set requires sparse training"):
        train({"objective": "binary", "num_iterations": 2}, X.toarray(), y,
              eval_set=[(X, y)], device=CPU)


def test_sparse_dart_eval_set():
    X, y = _sparse_data(600, 80)
    params = {"objective": "binary", "boosting": "dart", "num_iterations": 8,
              "num_leaves": 7, "min_data_in_leaf": 5, "drop_rate": 0.5, "seed": 3}
    bp = train(params, X[:450], y[:450], eval_set=[(X[450:], y[450:])], device=CPU)
    br = ref_train(params, X[:450], y[:450], eval_set=[(X[450:], y[450:])])
    assert len(bp.evals_result) == 8
    np.testing.assert_allclose(_evals(bp, "eval0_binary_logloss"),
                               _evals(br, "eval0_binary_logloss"), atol=1e-6)
    _same_trees(bp, br, BINARY_LEAF_TOL)


def test_sparse_dart_trains():
    X, y = _sparse_data(600, 80)
    params = {"objective": "binary", "boosting": "dart", "num_iterations": 12,
              "num_leaves": 7, "min_data_in_leaf": 5, "drop_rate": 0.5, "seed": 3}
    bp = train(params, X, y, device=CPU)
    assert bp.num_trees == 12 and len(np.unique(np.round(bp.tree_scale, 8))) > 1
    assert _auc(y, bp.predict(X, device=CPU)) > 0.8
    _same_trees(bp, ref_train(params, X, y), BINARY_LEAF_TOL)
    b_dense = train(params, X.toarray(), y, device=CPU)
    np.testing.assert_allclose(bp.predict(X, device=CPU),
                               b_dense.predict(X.toarray(), device=CPU), rtol=1e-6, atol=1e-7)


def test_sparse_categorical_trains():
    X, dense, y = _cat_sparse_data()
    params = {"objective": "binary", "num_iterations": 10, "num_leaves": 7,
              "min_data_in_leaf": 5, "categorical_feature": [0]}
    b = train(params, X, y, device=CPU)
    assert b.cat_set is not None and (b.bin == -1).any()
    assert ((b.predict(X, device=CPU) > .5) == (y > .5)).mean() > 0.95
    np.testing.assert_array_equal(b.predict(X, device=CPU), b.predict(dense, device=CPU))
    b2 = GBDTBooster.from_json(b.to_json())
    np.testing.assert_array_equal(b2.predict(X, device=CPU), b.predict(X, device=CPU))
    _same_trees(b, ref_train(params, X, y), BINARY_LEAF_TOL)


def test_sparse_contrib_matches_densified():
    X, y = _sparse_data(500, 80)
    params = {"objective": "binary", "num_iterations": 6, "num_leaves": 7,
              "min_data_in_leaf": 5}
    b = train(params, X, y, device=CPU)
    c_sp = b.predict_contrib(X[:40], device=CPU)
    assert isinstance(c_sp, CSRMatrix) and c_sp.shape == (40, 81)
    np.testing.assert_allclose(c_sp.toarray(), b.predict_contrib(X[:40].toarray(), device=CPU),
                               atol=1e-12)
    np.testing.assert_allclose(c_sp.toarray().sum(axis=1), b.raw_predict(X[:40], device=CPU),
                               atol=1e-6)
    a_sp = b.predict_contrib(X[:40], approximate=True, device=CPU).toarray()
    np.testing.assert_allclose(a_sp, b.predict_contrib(X[:40].toarray(), approximate=True,
                                                       device=CPU), atol=1e-12)
    # against the reference booster of the same trees
    rb = RefBooster.from_json(b.to_json())
    np.testing.assert_allclose(c_sp.toarray(), rb.predict_contrib(X[:40]).toarray(),
                               atol=1e-9)


def test_sparse_contrib_multiclass_and_categorical():
    X, dense, _ = _cat_sparse_data(n=600)
    ym = np.random.default_rng(9).integers(0, 3, size=600).astype(np.float64)
    params = {"objective": "multiclass", "num_class": 3, "num_iterations": 4,
              "num_leaves": 7, "min_data_in_leaf": 5, "categorical_feature": [0]}
    bm = train(params, X, ym, device=CPU)
    cs = bm.predict_contrib(X[:20], device=CPU)
    cd = bm.predict_contrib(dense[:20], device=CPU)
    assert isinstance(cs, list) and len(cs) == 3
    for c in range(3):
        np.testing.assert_allclose(cs[c].toarray(), cd[c], atol=1e-12)
    _same_trees(bm, ref_train(params, X, ym), 1e-4)


def test_sparse_continued_training():
    X, y = _sparse_data(800, 120)
    params = {"objective": "binary", "num_iterations": 5, "num_leaves": 7,
              "min_data_in_leaf": 5}
    b1 = train(params, X, y, device=CPU)
    b2 = train(params, X, y, init_booster=b1, mapper=b1.mapper, device=CPU)
    assert b2.num_trees == 10
    assert _auc(y, b2.predict(X, device=CPU)) >= _auc(y, b1.predict(X, device=CPU)) - 1e-6
    r1 = ref_train(params, X, y)
    r2 = ref_train(params, X, y, init_booster=r1, mapper=r1.mapper)
    _same_trees(b2, r2, BINARY_LEAF_TOL)


def test_sparse_model_string_roundtrip():
    X, y = _sparse_data(500, 80)
    b = train({"objective": "binary", "num_iterations": 5, "num_leaves": 7,
               "min_data_in_leaf": 5}, X, y, device=CPU)
    want = b.predict(X, device=CPU)
    np.testing.assert_array_equal(GBDTBooster.from_json(b.to_json()).predict(X, device=CPU),
                                  want)
    text = b.save_native_model()
    np.testing.assert_allclose(GBDTBooster.from_model_string(text).predict(X, device=CPU),
                               want, rtol=1e-6)
    # either package reads the other's model string
    np.testing.assert_allclose(RefBooster.from_json(b.to_json()).predict(X), want, rtol=1e-6)


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_sparse_half_pass_matches_full_pass(objective):
    """Every sparse fit takes the half pass (the smaller child summed, its
    sibling by subtraction): the full-pass oracle's trees and leaves bit for
    bit, whatever ``leaf_local`` says, and the reference's trees under
    either of its passes."""
    X, y = _sparse_data(1200, 120, density=0.08, seed=5)
    if objective == "regression":
        y = np.asarray(X @ np.random.default_rng(5).normal(size=120))
    params = {"objective": objective, "num_iterations": 6, "num_leaves": 15,
              "min_data_in_leaf": 5}
    b_half = train(params, X, y, device=CPU)
    with full_pass():
        b_full = train(params, X, y, device=CPU)
    b_key = train({**params, "leaf_local": True}, X, y, device=CPU)
    for f in ("parent", "feature", "bin", "leaf_value", "leaf_hess"):
        np.testing.assert_array_equal(getattr(b_half, f), getattr(b_full, f))
        np.testing.assert_array_equal(getattr(b_key, f), getattr(b_half, f))
    tol = BINARY_LEAF_TOL if objective == "binary" else L2_LEAF_TOL
    for leaf_local in (False, True):
        _same_trees(b_half, ref_train({**params, "leaf_local": leaf_local}, X, y), tol)


def test_sparse_multiclass_half_pass_matches_full_pass():
    """Multiclass grows each class's tree on its own, so it takes the half
    pass too (the reference keeps multiclass on its full pass): the
    oracle's and the reference's trees."""
    X, _ = _sparse_data(600, 60, density=0.1, seed=7)
    y = np.random.default_rng(7).integers(0, 3, 600).astype(float)
    params = {"objective": "multiclass", "num_class": 3, "num_iterations": 3,
              "num_leaves": 7, "min_data_in_leaf": 5}
    b_half = train(params, X, y, device=CPU)
    with full_pass():
        b_full = train(params, X, y, device=CPU)
    for f in ("parent", "feature", "bin", "leaf_value", "leaf_hess"):
        np.testing.assert_array_equal(getattr(b_half, f), getattr(b_full, f))
    np.testing.assert_array_equal(b_half.predict(X, device=CPU), b_full.predict(X, device=CPU))
    _same_trees(b_half, ref_train({**params, "leaf_local": True}, X, y), 1e-4)


def test_grow_tree_sparse_half_pass_carries_the_right_parent():
    """A tree whose later splits come back to a leaf of an earlier step
    (not a child of the step before) mixes half and full passes, and
    equals the full-pass oracle's."""
    X, y = _sparse_data(2000, 60, density=0.15, seed=11)
    c = CSRMatrix.from_scipy(X)
    m = BinMapper(max_bin=31).fit_csr(c)
    sb = build_sparse_binned(c, m, CPU)
    ghc, _ = _grid_panel(2000, 12)
    cfg = TreeConfig(n_bins=sb.n_bins, num_leaves=31, min_data_in_leaf=5)
    fm = torch.ones(sb.d)
    full, node_f = grow_sparse_full_pass(sb, ghc[:, 0], ghc[:, 1], ghc[:, 2], fm, cfg)
    half, node_h = grow_tree_sparse(sb, ghc[:, 0], ghc[:, 1], ghc[:, 2], fm, cfg)
    parents = full.parent.numpy()
    assert any(p not in (parents[s - 1], s) for s, p in enumerate(parents) if s and p >= 0)
    for a, b in zip(full, half):
        if a is not None:
            assert torch.equal(a, b)
    assert torch.equal(node_f, node_h)


def test_hashed_text_pipeline():
    """Hashed text (the reference's VW featurizer) into the port's classifier
    with ``sparse_num_bits=14``: the fit takes the sparse path, matches the
    reference estimator's predictions, and its SHAP pairs add up to the
    margin."""
    from synapseml_tpu import Table as RefTable
    from synapseml_tpu.gbdt.estimators import LightGBMClassifier as RefClassifier
    from synapseml_tpu.vw.featurizer import VowpalWabbitFeaturizer
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.gbdt.estimators import LightGBMClassifier

    rng = np.random.default_rng(0)
    pos, neg = ["great", "good", "excellent"], ["bad", "awful", "terrible"]
    filler = [f"w{i}" for i in range(100)]
    texts, labels = [], []
    for _ in range(600):
        yv = int(rng.random() < 0.5)
        words = list(rng.choice(pos if yv else neg, size=2)) + list(rng.choice(filler, size=6))
        rng.shuffle(words)
        texts.append(" ".join(words))
        labels.append(float(yv))
    feats = VowpalWabbitFeaturizer(input_cols=["text"], string_split_cols=["text"]).transform(
        RefTable({"text": np.array(texts, object), "label": np.array(labels)}))
    col = feats["features"]
    params = dict(num_iterations=15, num_leaves=7, min_data_in_leaf=5, sparse_num_bits=14)
    t = Table({"features": col, "label": np.array(labels)},
              meta={"features": {"type": "vw_sparse"}})
    model = LightGBMClassifier(device=CPU, features_shap_col="shap", leaf_prediction_col="leaf",
                               **params).fit(t)
    out = model.transform(t)
    p = np.asarray(out["probability"])[:, 1]
    assert _auc(np.array(labels), p) > 0.95
    assert model.booster.mapper.n_features == 1 << 14
    ref = RefClassifier(**params).fit(feats)
    np.testing.assert_allclose(p, np.asarray(ref.transform(feats)["probability"])[:, 1],
                               atol=1e-6)
    X = CSRMatrix.from_pairs(col, num_bits=14)
    np.testing.assert_array_equal(np.asarray(out["leaf"]),
                                  model.booster.predict_leaf(X, device=CPU).astype(np.float64))
    idx0, _ = out["shap"][0]
    assert idx0.max() == 1 << 14  # the expected-value column d
    np.testing.assert_allclose(np.array([v.sum() for _, v in out["shap"]]),
                               model.booster.raw_predict(X, device=CPU), atol=1e-6)


def test_sparse_estimator_validation_rows_and_batches():
    """A pair column through the estimator with validation rows and
    ``num_batches=2`` (each batch continues the last on CSR row slices)."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.gbdt.estimators import LightGBMRegressor

    X, _ = _sparse_data(800, 64, density=0.1, seed=3)
    y = np.asarray(X @ np.random.default_rng(3).normal(size=64))
    c = CSRMatrix.from_scipy(X)
    col = np.empty(800, object)
    for i in range(800):
        a, b = c.indptr[i], c.indptr[i + 1]
        col[i] = (c.indices[a:b].astype(np.uint32), c.values[a:b])
    val = np.arange(800) >= 600
    t = Table({"features": col, "label": y, "val": val})
    est = LightGBMRegressor(device=CPU, num_iterations=6, num_leaves=7, min_data_in_leaf=5,
                            sparse_num_bits=6, validation_indicator_col="val",
                            num_batches=2)
    model = est.fit(t)
    assert model.booster.num_trees == 6 and model.sparse_num_bits == 6
    want = train({"objective": "regression", "num_iterations": 3, "num_leaves": 7,
                  "min_data_in_leaf": 5}, c[:300], y[:300], device=CPU,
                 eval_set=[(c[600:], y[600:])])
    np.testing.assert_array_equal(model.booster.parent[:3], want.parent)
    pred = np.asarray(model.transform(t)["prediction"])
    np.testing.assert_array_equal(pred, model.booster.predict(c, device=CPU))


def test_hashed_text_rows_schema():
    """``schema_data.hashed_text_rows``: counts of hashed tokens, ascending
    columns a row, about 80 tokens a review, a balanced binary label."""
    from synapseml_tpu_torch.tools.schema_data import HASHED_TEXT_TOKENS, hashed_text_rows

    X, y = hashed_text_rows(0, 4000, 14)
    assert X.shape == (4000, 1 << 14) and set(np.unique(y)) == {0.0, 1.0}
    assert 0.4 < y.mean() < 0.6
    assert (X.values >= 1).all() and (X.values == np.round(X.values)).all()
    tokens = np.add.reduceat(X.values, X.indptr[:-1])
    assert abs(tokens.mean() - HASHED_TEXT_TOKENS) < 2
    same_row = np.repeat(np.arange(4000), np.diff(X.indptr))
    assert (np.diff(X.indices)[same_row[1:] == same_row[:-1]] > 0).all()
    X2, y2 = hashed_text_rows(0, 4000, 14)
    assert np.array_equal(X.indices, X2.indices) and np.array_equal(y, y2)
