"""Growth over a row partition (the port's only growth path: smaller-child
histograms, the sibling as parent minus child; the reference's
``leaf_local``) on the CPU.

At n = 6,000 rows (where the reference's ``leaf_local`` engages, above
2,048), and at 2,000 rows (where the reference falls back to its full pass),
in every case:

- the port grows the same trees as the full pass it replaced
  (``kernel_cases.grow_full_pass``): ``parent``, ``feature``, ``bin``,
  ``cat_set``, ``leaf_value`` and ``leaf_hess`` bit-equal (histogram sums on
  ``_preround``'s grid are exact in any order, so parent minus the smaller
  child is the other child). The exception is GOSS with an amplification
  that is not a power of two (``goss_off_grid``: top_rate=0.2,
  other_rate=0.3, 8/3): ``g * w`` leaves the grid, cells round, and only
  the tree structure is held equal, the leaves within the repo's off-grid
  GOSS tolerance (1e-3; 1.3e-6 seen);
- it matches the reference's ``leaf_local=True``: identical trees, and
  leaves within a tolerance of ROADMAP queue 3 named by its cause. XLA's
  ``exp`` and ``torch.exp`` differ in the last place, so after pre-rounding
  a few gradients land on the neighbouring grid point: binary leaves within
  1e-3 (4.2e-4 seen), and bit-equal with XLA's ``exp`` in the port's
  sigmoid; multiclass within 1e-4. Lambdarank's reference grid comes from
  XLA's inexact ``exp2``: bit-equal on that grid.

Then the plain versions against numpy models and the reference: the
partition step over its two id buffers, two steps in a row (empty child,
one row, all rows, a deep leaf in the second buffer; int8/int16/int32 bins;
d = 1, 33, 300), the row-list histogram over the same cases, and the step's
epilogue (the sibling by subtraction) against the reference's, bit for bit;
two trees from one partition and one workspace against the full pass; and
``grow_tree`` with NaN gradients on rows of zero weight, where the port must
follow the reference's leaf-local path.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import synapseml_tpu_torch.gbdt.boost as port_boost
from synapseml_tpu.gbdt.boost import train as ref_train
from synapseml_tpu.gbdt.grow import TreeConfig as RefTreeConfig
from synapseml_tpu.gbdt.grow import grow_tree as ref_grow_tree
from synapseml_tpu_torch.gbdt.boost import train
from synapseml_tpu_torch.gbdt.grow import TreeConfig, grow_tree
from synapseml_tpu_torch.gbdt.histogram import histogram_rows, histogram_rows_plain, sibling
from synapseml_tpu_torch.gbdt.partition import RowPartition, partition_plain
from synapseml_tpu_torch.gbdt.split_search import SplitWorkspace
from synapseml_tpu_torch.tools.kernel_cases import (PARTITION_CASES, full_pass, grow_full_pass,
                                                    partition_case, rank_rows,
                                                    rows_histogrammed)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

N = 6000
PARAMS = dict(objective="binary", num_iterations=3, num_leaves=15, max_bin=63)
TREE_FIELDS = ("parent", "feature", "bin", "cat_set", "leaf_value", "leaf_hess")


def _rows(n=N, d=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = (x[:, 0] + 0.4 * x[:, 5] + 0.2 * rng.normal(size=n) > 0).astype(np.float64)
    return x, y, rng


def _reference_grid(x: torch.Tensor, n_bound: int) -> torch.Tensor:
    """The port's ``_preround`` on the reference's grid (XLA's ``exp2`` of the
    exponent, inexact on this CPU; ``tests/test_torch_ranker.py``)."""
    m = torch.max(torch.abs(x), dim=0).values
    delta = m * torch.tensor(float(n_bound), dtype=torch.float32)
    e = torch.ceil(torch.log2(torch.clamp(delta, min=1e-35)))
    factor = torch.tensor(np.asarray(jax.jit(jnp.exp2)(jnp.asarray(e.numpy()))))
    return (x + factor) - factor


def _xla_sigmoid(z: torch.Tensor) -> torch.Tensor:
    """The port's sigmoid with the reference's exponential (XLA's)."""
    e = torch.from_numpy(np.array(jax.jit(jnp.exp)(jnp.asarray((-z).numpy()))))
    return 1.0 / (1.0 + e)


def _case(name):
    """(params, x, y, train keyword arguments, leaf tolerance against the
    reference) of one case."""
    x, y, rng = _rows()
    kw, tol = {}, 1e-3  # binary: XLA's exp against torch.exp
    if name == "binary":
        params = dict(PARAMS)
    elif name == "multiclass":
        y = np.digitize(x[:, 1] + 0.5 * x[:, 2], [-0.5, 0.5]).astype(np.float64)
        params = dict(PARAMS, objective="multiclass", num_class=3)
        tol = 1e-4  # XLA's exp against torch.exp: a gradient an ulp apart
    elif name == "lambdarank":
        x, y, sizes = rank_rows(n_queries=300)
        params = dict(PARAMS, objective="lambdarank")
        kw, tol = dict(group=sizes), 5e-3  # the reference's grid (XLA's exp2)
    elif name == "goss":
        params = dict(PARAMS, boosting="goss")
    elif name == "goss_off_grid":  # amplification (1 - 0.2) / 0.3 = 8/3
        params = dict(PARAMS, boosting="goss", top_rate=0.2, other_rate=0.3)
    elif name == "bagging_feature_fraction":
        params = dict(PARAMS, bagging_fraction=0.5, bagging_freq=1, feature_fraction=0.7)
    elif name == "categorical":
        x[:, 2] = rng.integers(0, 12, size=len(x))
        y = ((x[:, 0] + np.isin(x[:, 2], [1, 4, 7, 9]) - 0.5) > 0).astype(np.float64)
        params = dict(PARAMS, categorical_feature=[2])
    elif name == "max_depth":
        params = dict(PARAMS, max_depth=3)
    elif name == "nan_features":
        x[rng.random(x.shape) < 0.05] = np.nan
        x[:, 3] = np.where(x[:, 0] > 0.5, np.nan, x[:, 3])
        params = dict(PARAMS)
    elif name == "rows_2000":  # <= 2,048: the reference's full pass
        x, y = x[:2000], y[:2000]
        params = dict(PARAMS)
    return params, x, y, kw, tol


CASES = ["binary", "multiclass", "lambdarank", "goss", "goss_off_grid",
         "bagging_feature_fraction", "categorical", "max_depth", "nan_features", "rows_2000"]


@pytest.mark.parametrize("name", CASES)
def test_leaf_local_equals_full_pass_and_reference(name, monkeypatch):
    params, x, y, kw, tol = _case(name)
    with full_pass():
        full = train(params, x, y, device="cpu", **kw)
    local = train(params, x, y, device="cpu", **kw)
    # leaf_local is accepted and changes nothing
    assert local.leaf_value.tobytes() == train(dict(params, leaf_local=True), x, y,
                                               device="cpu", **kw).leaf_value.tobytes()
    exact = TREE_FIELDS if name != "goss_off_grid" else ("parent", "feature", "bin")
    for field in exact:
        a, b = getattr(local, field), getattr(full, field)
        assert (a is None and b is None) or np.array_equal(a, b), field
    np.testing.assert_allclose(local.leaf_value, full.leaf_value, rtol=0, atol=1e-3)
    assert (local.parent >= 0).sum() > 10  # the trees split
    ref = ref_train(dict(params, leaf_local=True), x, y, **kw)
    for field in ("parent", "feature", "bin"):
        np.testing.assert_array_equal(getattr(local, field), getattr(ref, field), err_msg=field)
    if name == "categorical":
        assert (local.bin < 0).any()
        np.testing.assert_array_equal(local.cat_set, ref.cat_set)
    np.testing.assert_allclose(local.leaf_value, ref.leaf_value, rtol=0, atol=tol)
    if params["objective"] == "multiclass" or name == "goss_off_grid":
        return  # XLA's exp (multiclass); cells that round in another order (off grid)
    # with the reference's exp (binary) or grid (lambdarank): bit-equal
    if name == "lambdarank":
        monkeypatch.setattr(port_boost, "_preround", _reference_grid)
    else:
        monkeypatch.setattr(port_boost, "_sigmoid", _xla_sigmoid)
    local = train(params, x, y, device="cpu", **kw)
    for field in ("parent", "feature", "bin", "leaf_value", "leaf_hess"):
        np.testing.assert_array_equal(getattr(local, field), getattr(ref, field), err_msg=field)


# -- the partition step and the row-list histogram against numpy ------------------

def _numpy_partition(ids, seg, side, bins, leaf, feat, in_set, node, s):
    """The step as a stable partition in numpy, into the same range of the
    other buffer: (ids, seg, side, node, small, smaller_right)."""
    ids, seg, side, node = ids.copy(), seg.copy(), side.copy(), node.copy()
    b, c = seg[leaf]
    src = side[leaf]
    rows = ids[src, b:b + c].copy()
    left = in_set[bins[rows, feat]]
    ids[1 - src, b:b + c] = np.concatenate([rows[left], rows[~left]])
    node[rows[~left]] = s + 1
    nl = int(left.sum())
    seg[leaf] = (b, nl)
    seg[s + 1] = (b + nl, c - nl)
    side[leaf] = side[s + 1] = 1 - src
    right_smaller = c - nl <= nl
    small = (b + nl, c - nl, 1 - src) if right_smaller else (b, nl, 1 - src)
    return ids, seg, side, node, np.array(small), right_smaller


def _load_partition(part, ids, seg, side):
    part.begin_tree()
    part.ids.copy_(torch.from_numpy(ids))
    part.seg.copy_(torch.from_numpy(seg))
    part.side.copy_(torch.from_numpy(side))


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("d", [1, 33, 300])
@pytest.mark.parametrize("case", sorted(PARTITION_CASES))
def test_partition_plain_matches_numpy(case, d, dtype):
    """Two steps in a row: the case's split, then leaf s + 1 (the new right
    child, in the other buffer) split again on feature 0; after each, the
    whole state (both buffers, seg, side, node, small, smaller_right)."""
    n, B = 257, 17
    bins, ids, seg, side, node, s, leaf, in_set = partition_case(n, B, d, dtype, case, seed=d)
    part = RowPartition(n, seg.shape[0], "cpu")
    _load_partition(part, ids, seg, side)
    node_t = torch.from_numpy(node.copy())
    state = (ids, seg, side, node)
    steps = ((s, leaf, d - 1, in_set),
             (s + 1, s + 1, 0, np.random.default_rng(d).random(B) < 0.5))
    for step, lf, feat, ins in steps:
        part.split(step, torch.from_numpy(bins), node_t, torch.tensor([lf, feat]),
                   torch.tensor([True]), torch.from_numpy(ins))
        want = _numpy_partition(*state[:3], bins, lf, feat, ins, state[3], step)
        state = want[:4]
        np.testing.assert_array_equal(part.ids.numpy(), want[0])
        np.testing.assert_array_equal(part.seg.numpy(), want[1])
        np.testing.assert_array_equal(part.side.numpy(), want[2])
        np.testing.assert_array_equal(node_t.numpy(), want[3])
        np.testing.assert_array_equal(part.small.numpy(), want[4])
        assert bool(part.smaller_right[0]) == want[5]
        b, c = want[1][lf]
        np.testing.assert_array_equal(part.rows(lf).numpy(), want[0][want[2][lf], b:b + c])
        if step == s and case in ("empty_left", "empty_right"):
            empty, full = (leaf, s + 1) if case == "empty_left" else (s + 1, leaf)
            assert part.seg[empty, 1] == 0 and part.seg[full, 1] == seg[leaf, 1]


def test_partition_inert_step_changes_nothing():
    n = 300
    bins, ids, seg, side, node, s, leaf, in_set = partition_case(n, 9, 4, np.int8, "deep",
                                                                 seed=1)
    part = RowPartition(n, seg.shape[0], "cpu")
    _load_partition(part, ids, seg, side)
    part.small.fill_(7)
    node_t = torch.from_numpy(node.copy())
    partition_plain(part, s, torch.from_numpy(bins), node_t, torch.tensor([leaf, 0]),
                    torch.tensor([False]), torch.from_numpy(in_set))
    np.testing.assert_array_equal(part.ids.numpy(), ids)
    np.testing.assert_array_equal(part.seg.numpy(), seg)
    np.testing.assert_array_equal(part.side.numpy(), side)
    np.testing.assert_array_equal(node_t.numpy(), node)
    assert part.small.tolist() == [0, 0, 0] and bool(part.smaller_right[0])


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32])
@pytest.mark.parametrize("d", [1, 33, 300])
@pytest.mark.parametrize("span", ["empty", "one_row", "all_rows", "middle"])
def test_histogram_rows_plain_matches_numpy(span, d, dtype):
    """Over a list in either of two id buffers (the other holds other ids),
    into a new output and added into a zeroed one."""
    n, B = 513, 31
    rng = np.random.default_rng(d)
    bins = rng.integers(0, B, size=(n, d)).astype(dtype)
    # values on a grid of 1/8: every sum is exact in any order
    g = rng.integers(-40, 40, n).astype(np.float32) / 8
    h = rng.integers(1, 40, n).astype(np.float32) / 8
    w = (rng.random(n) < 0.7).astype(np.float32)
    ids = np.stack([rng.permutation(n), rng.permutation(n)]).astype(np.int32)
    begin, count, buf = {"empty": (100, 0, 0), "one_row": (7, 1, 1), "all_rows": (0, n, 0),
                         "middle": (50, 300, 1)}[span]
    rows = ids[buf, begin:begin + count]
    want = np.zeros((d, B, 3), np.float64)
    for f in range(d):
        for c, v in enumerate((g * w, h * w, w)):
            np.add.at(want[f, :, c], bins[rows, f].astype(np.int64), v[rows])
    t = lambda a: torch.from_numpy(a)
    args = (t(bins), t(g), t(h), t(w), B, t(ids), torch.tensor([begin, count, buf],
                                                               dtype=torch.int32))
    got = histogram_rows(*args)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    assert torch.equal(got, histogram_rows_plain(*args))
    out = torch.zeros(d, B, 3)
    assert histogram_rows(*args, out=out) is out and torch.equal(out, got)
    with pytest.raises(TypeError, match=r"\(2, m\)"):  # kernel P's two buffers, no fewer
        histogram_rows(*args[:5], t(ids[buf]), args[6])


# -- the step's epilogue against the reference's sibling by subtraction -----------

def _special_cells(rng, shape):
    """Values on a 1/8 grid with NaN, +-inf and -0.0 in some cells."""
    x = (rng.integers(-64, 64, size=shape) / 8).astype(np.float32)
    flat = x.reshape(-1)
    pick = rng.permutation(flat.size)
    flat[pick[:3]] = np.nan
    flat[pick[3:6]] = np.inf
    flat[pick[6:9]] = -np.inf
    flat[pick[9:15]] = -0.0
    flat[pick[15:21]] = 0.0
    return x


def _same_bits(a: np.ndarray, b: np.ndarray) -> None:
    """Bit for bit, every NaN matched by a NaN (its sign and payload aside)."""
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    keep = ~np.isnan(a)
    np.testing.assert_array_equal(a[keep].view(np.int32), b[keep].view(np.int32))


@pytest.mark.parametrize("case", ["smaller_right", "smaller_left", "inert"])
def test_sibling_plain_matches_reference(case):
    """The epilogue (the CPU takes its plain version) against the reference's
    ``jnp.where(ok, hists.at[s + 1].set(child).at[l].add(-child), hists)``,
    ``child = jnp.where(smaller_right, h_small, hists[l] - h_small)``, run
    through JAX on the CPU: bit for bit, with NaN, +-inf and -0.0 in the
    leaves and the child; ``small`` zero afterwards. An inert step comes
    with an empty child (zero) on the right, and leaf s + 1 empty."""
    rng = np.random.default_rng(["smaller_right", "smaller_left", "inert"].index(case))
    L, d, B, s, leaf = 7, 3, 5, 4, 2
    hists = _special_cells(rng, (L, d, B, 3))
    hists[leaf] = _special_cells(rng, (d, B, 3))  # the split leaf has each kind
    small = _special_cells(rng, (d, B, 3))
    ok, right = case != "inert", case != "smaller_left"
    if not ok:
        small[:] = 0.0
        hists[s + 1] = 0.0
    child = jnp.where(right, jnp.asarray(small), jnp.asarray(hists)[leaf] - jnp.asarray(small))
    ref = jnp.where(ok, jnp.asarray(hists).at[s + 1].set(child).at[leaf].add(-child),
                    jnp.asarray(hists))
    h_t, small_t = torch.from_numpy(hists.copy()), torch.from_numpy(small.copy())
    sibling(h_t, small_t, torch.tensor([leaf]), torch.tensor([right]), s)
    _same_bits(h_t.numpy(), np.asarray(ref))
    assert not small_t.any() and not torch.signbit(small_t).any()
    # NaN reached the leaves: the child's (a split) or the kept leaf's (inert)
    assert np.isnan(hists[leaf] if not ok else small if right else hists[leaf] - small).any()


def test_two_trees_from_one_partition_and_workspace_match_full_pass():
    """One RowPartition and one SplitWorkspace for two trees (as a fit holds
    them), each equal to the full pass's tree: P's per-step counters and the
    epilogue's zeroed buffer are reset for the second tree."""
    x, y, rng = _rows(n=3000, d=6, seed=4)
    B, L = 16, 12
    edges = np.quantile(x, np.linspace(0, 1, B + 1)[1:-1], axis=0)
    bins = torch.from_numpy(np.stack([np.searchsorted(edges[:, j], x[:, j])
                                      for j in range(x.shape[1])], axis=1).astype(np.int8))
    cfg = TreeConfig(n_bins=B, num_leaves=L, min_data_in_leaf=5.0)
    fm = torch.ones(x.shape[1])
    ws = SplitWorkspace(x.shape[1], fm, None, cfg, "cpu")
    part = RowPartition(len(y), L, "cpu")
    for tree in range(2):
        g = torch.from_numpy((rng.integers(-64, 64, len(y)) / 16).astype(np.float32))
        h = torch.full((len(y),), 0.25)
        w = torch.from_numpy((rng.random(len(y)) < 0.8).astype(np.float32))
        got, node = grow_tree(bins, g, h, w, fm, cfg, workspace=ws, partition=part)
        want, want_node = grow_full_pass(bins, g, h, w, fm, cfg)
        for field in ("parent", "feature", "bin", "gain", "leaf_value", "leaf_hess"):
            assert torch.equal(getattr(got, field), getattr(want, field)), (tree, field)
        assert torch.equal(node, want_node)
        assert (got.parent >= 0).sum() == L - 1
        assert not ws.small_hist.any()


def test_grow_tree_nan_gradients_follow_reference_leaf_local():
    """NaN gradients on rows of zero weight: kernel A adds such rows (g * 0 is
    NaN), so the root's histogram holds NaN in each feature's cell of those
    rows, every gain is NaN (which argmax takes as the maximum) and every
    step is inert, in the port and in both of the reference's paths. The
    port's tree and rows' leaves equal the reference's leaf-local ones, NaN
    for NaN."""
    x, y, rng = _rows(n=3000, d=6, seed=3)
    B, L = 16, 8
    edges = np.quantile(x, np.linspace(0, 1, B + 1)[1:-1], axis=0)
    bins = np.stack([np.searchsorted(edges[:, j], x[:, j]) for j in range(x.shape[1])],
                    axis=1).astype(np.int32)
    g = (rng.integers(-64, 64, len(y)) / 16).astype(np.float32)
    h = np.full(len(y), 0.25, np.float32)
    w = (rng.random(len(y)) < 0.8).astype(np.float32)
    g[np.nonzero(w == 0)[0][:3]] = np.nan
    fm = np.ones(x.shape[1], np.float32)
    kw = dict(num_leaves=L, min_data_in_leaf=5.0)
    ref_tree, ref_node = ref_grow_tree(jnp.asarray(bins), jnp.asarray(g), jnp.asarray(h),
                                       jnp.asarray(w), jnp.asarray(fm),
                                       RefTreeConfig(n_bins=B, leaf_local=True, **kw))
    t = lambda a: torch.from_numpy(a)
    port_tree, port_node = grow_tree(t(bins), t(g), t(h), t(w), t(fm),
                                     TreeConfig(n_bins=B, **kw))
    for field in ("parent", "feature", "bin", "gain", "leaf_value", "leaf_hess"):
        np.testing.assert_array_equal(getattr(port_tree, field).numpy(),
                                      np.asarray(getattr(ref_tree, field)), err_msg=field)
    np.testing.assert_array_equal(port_node.numpy(), np.asarray(ref_node))
    assert (port_tree.parent < 0).all() and np.isnan(port_tree.leaf_value[0].item())


def test_rows_histogrammed_counts_the_partition():
    """The counts that chip_smoke.py reads off a fitted tree (rows_histogrammed)
    are the partition's: the split leaves' rows, the right children's and
    the smaller children's, step by step."""
    x, y, _ = _rows()
    params = dict(PARAMS, num_iterations=1)
    booster = train(params, x, y, device="cpu")
    leaves = booster.predict_leaf(x, device="cpu")[:, 0]
    counts = np.bincount(leaves, minlength=15)
    split, right, small = rows_histogrammed(booster.parent[0, 0], counts)
    part = RowPartition(N, 15, "cpu")
    part.begin_tree()
    want = [0, 0, 0]
    binned = booster.mapper.transform_torch(torch.from_numpy(x))
    node = torch.zeros(N, dtype=torch.int32)
    tree = booster
    for s in range(14):
        leaf, feat, b = (int(tree.parent[0, 0, s]), int(tree.feature[0, 0, s]),
                         int(tree.bin[0, 0, s]))
        ok = leaf >= 0
        in_set = torch.arange(booster.mapper.n_bins) <= b
        part.split(s, binned, node, torch.tensor([max(leaf, 0), feat]), torch.tensor([ok]),
                   in_set & ok)
        if ok:
            n_l, n_r = (int(v) for v in part.seg[[leaf, s + 1], 1])
            want[0] += n_l + n_r
            want[1] += n_r
            want[2] += int(part.small[1])
    assert [split, right, small] == want and small < right < split
    np.testing.assert_array_equal(node.numpy(), leaves)
