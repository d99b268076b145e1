"""Kernel B's layout and plain versions on the CPU: ``pack_trees`` walked top
-down gives the replay's leaf ids, the port's plain scores and leaf ids are
bit-equal to the JAX package's ``device_raw_scores`` / ``device_leaf_indices``,
``predict_leaf`` and ``leaf_prediction_col`` match the reference model, and
the bound's visit count holds on a tree counted by hand."""

import numpy as np
import pytest
import torch

from synapseml_tpu import Table as RefTable
from synapseml_tpu.gbdt import LightGBMRegressor as RefRegressor
from synapseml_tpu.gbdt.boost import train as ref_train
from synapseml_tpu.gbdt.device_predict import device_leaf_indices as ref_leaf_indices
from synapseml_tpu.gbdt.device_predict import device_raw_scores as ref_raw_scores
from synapseml_tpu_torch.core import Table, TableSchema
from synapseml_tpu_torch.gbdt.convert import model_from_state
from synapseml_tpu_torch.gbdt.device_predict import (device_leaf_indices, device_raw_scores,
                                                     pack_trees)
from synapseml_tpu_torch.tools.score_bench import (path_visits, random_trees, tree_bound,
                                                   tree_bytes)


def records(packed, q):
    """(units, 5) int64 records of tree ``q``: feature, cat, threshold or
    bitset word, left, right; decoded from either record width."""
    words = packed.nodes[q].to(torch.int64)
    if packed.narrow:
        w = words.view(-1, 2)
        sign16 = lambda x: ((x & 0xFFFF) ^ 0x8000) - 0x8000
        cat = (w[:, 0] >> 15) & 1
        thr = torch.where(cat == 1, (w[:, 0] >> 16) & 0xFFFF, sign16(w[:, 0] >> 16))
        return torch.stack([w[:, 0] & 0x7FFF, cat, thr, sign16(w[:, 1]), sign16(w[:, 1] >> 16)], 1)
    w = words.view(-1, 4)
    return torch.stack([w[:, 0] & 0x7FFFFFFF, (w[:, 0] < 0).long(), w[:, 1], w[:, 2], w[:, 3]], 1)


def walk_packed(binned: torch.Tensor, packed):
    """Torch walk of the packed layout, as the kernel walks it: (T, C, n) leaf
    ids and the steps each row took in each tree."""
    T, C, S = packed.shape
    n = binned.shape[0]
    b = binned.to(torch.int64)
    B = packed.cat_bins
    rows = torch.arange(n)
    leaves = torch.empty(T * C, n, dtype=torch.int32)
    steps = torch.zeros(T * C, n, dtype=torch.int64)
    for q in range(T * C):
        words = packed.nodes[q].to(torch.int64)
        recs = records(packed, q)
        ref = torch.zeros(n, dtype=torch.int64)
        live = torch.ones(n, dtype=torch.bool)
        while live.any():
            nd = recs[ref.clamp(min=0)]
            v = b[rows, nd[:, 0]]
            right = v > nd[:, 2]
            cat = nd[:, 1] == 1
            if cat.any():
                u = torch.where(v < 0, v + B, v)
                inside = (u >= 0) & (u < B)
                w = words[(nd[:, 2] + u.clamp(0, max(B - 1, 0)) // 32).clamp(0, len(words) - 1)]
                in_set = inside & (((w >> (u.clamp(min=0) % 32)) & 1) == 1)
                right = torch.where(cat, ~in_set, right)
            nxt = torch.where(right, nd[:, 4], nd[:, 3])
            steps[q] += live.to(torch.int64)
            ref = torch.where(live, nxt, ref)
            live = ref >= 0
        leaves[q] = (~ref).to(torch.int32)
    return leaves.view(T, C, n), steps.view(T, C, n)


def _lists(rng, T, C, S, d, n_bins, kind, cat=False):
    """(parent, feature, bins, cat_set) replay lists of one kind of tree."""
    if kind == "random":
        # parent in [-1, s + 1]: -1 anywhere, parents not created yet (dead)
        parent = np.stack([rng.integers(-1, s + 2, size=(T, C)) for s in range(S)], -1)
    elif kind == "chain":
        parent = np.broadcast_to(np.arange(S), (T, C, S)).copy()
    else:  # "balanced-ish": each split refines a leaf that exists
        parent = random_trees(rng, T, C, S + 1, d, n_bins, dead_rate=0.1)["parent"]
    parent = parent.astype(np.int32)
    feature = rng.integers(0, d, size=(T, C, S)).astype(np.int32)
    bins = rng.integers(0, n_bins, size=(T, C, S)).astype(np.int32)
    cat_set = None
    if cat:
        is_cat = rng.random((T, C, S)) < 0.4
        bins[is_cat] = -1
        cat_set = (rng.random((T, C, S, n_bins)) < 0.5).astype(np.int8)
    return parent, feature, bins, cat_set


def _scan_as_written(leaves, leaf_value, scale):
    """The reference's ``acc + scale_t * leaf_value`` over trees, each product
    and sum rounded to f32 on its own (numpy never fuses them), from the
    reference's own leaf ids."""
    T, C, n = leaves.shape
    acc = np.zeros((n, C), np.float32)
    for t in range(T):
        vals = np.stack([leaf_value[t, c][leaves[t, c]] for c in range(C)], 1)
        acc = acc + np.float32(scale[t]) * vals
    return acc


def _assert_scores_match_reference(got, leaves_ref, leaf_value, scale, compiled):
    """Bit-equal to the reference's scan as written; within one f32 rounding a
    tree of the reference as XLA's CPU backend compiles it, which contracts
    ``acc + sc * v`` into a fused multiply-add (measured: it matches an f64
    sum rounded once, not the two roundings the program writes)."""
    np.testing.assert_array_equal(got, _scan_as_written(leaves_ref, leaf_value, scale))
    T = leaves_ref.shape[0]
    tol = T * np.spacing(np.float32(np.abs(compiled).max()))
    np.testing.assert_allclose(got, compiled, rtol=0, atol=tol)


CASES = [("random", 6, False), ("random", 6, True), ("chain", 9, False),
         ("leafwise", 14, True), ("leafwise", 0, False), ("random", 1, True)]


@pytest.mark.parametrize("kind,S,cat", CASES)
def test_packed_walk_gives_replay_leaves(kind, S, cat):
    rng = np.random.default_rng(S + 10 * cat)
    T, C, d, n_bins, n = 5, 2, 4, 12, 700
    parent, feature, bins, cat_set = _lists(rng, T, C, S, d, n_bins, kind, cat)
    binned = torch.from_numpy(rng.integers(0, n_bins, size=(n, d)).astype(np.int16))
    packed = pack_trees(parent, feature, bins, cat_set)
    assert packed.narrow
    got, steps = walk_packed(binned, packed)
    want = device_leaf_indices(binned, parent, feature, bins, cat_set)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # a row takes one step per level of its leaf (a tree with no live split
    # takes one step through its single record, for a leaf of depth 0)
    depth = packed.depth.gather(2, want.long())
    roots = torch.stack([records(packed, q)[0] for q in range(T * C)]).view(T, C, 5)
    has_split = roots[:, :, 3] != roots[:, :, 4]
    torch.testing.assert_close(torch.where(has_split[:, :, None], steps, 0),
                               depth.to(torch.int64), rtol=0, atol=0)


@pytest.mark.parametrize("cat", [False, True])
def test_packed_walk_wide_records(cat):
    """Thresholds past int16 (bins of a 40,000-bin mapper) take 16-byte
    records; the walk still gives the replay's leaves."""
    rng = np.random.default_rng(3 + cat)
    T, C, S, d, n_bins, n = 3, 2, 12, 5, 40_000, 500
    parent, feature, bins, cat_set = _lists(rng, T, C, S, d, n_bins, "leafwise")
    if cat:
        bins[rng.random((T, C, S)) < 0.3] = -1
        cat_set = (rng.random((T, C, S, 70)) < 0.5).astype(np.int8)
    binned = torch.from_numpy(rng.integers(0, n_bins, size=(n, d)).astype(np.int32))
    binned[:50] %= 70
    packed = pack_trees(parent, feature, bins, cat_set)
    assert not packed.narrow
    got, _ = walk_packed(binned, packed)
    torch.testing.assert_close(got, device_leaf_indices(binned, parent, feature, bins, cat_set),
                               rtol=0, atol=0)


def test_packed_chain_depth_and_negative_bins():
    """A chain of S splits reaches depth S; bins below zero (as int8 may
    hold) go left of every non-negative numeric threshold and, in a
    categorical split, index the set from its end as jnp.take does."""
    S, n_bins = 7, 10
    parent = np.arange(S, dtype=np.int32)[None, None]
    feature = np.zeros((1, 1, S), np.int32)
    bins = np.full((1, 1, S), 3, np.int32)
    bins[0, 0, 2] = -1
    cat_set = np.zeros((1, 1, S, n_bins), np.int8)
    cat_set[0, 0, 2, n_bins - 2] = 1      # bin -2 is in split 2's set
    packed = pack_trees(parent, feature, bins, cat_set)
    assert packed.depth[0, 0].tolist() == [1, 2, 3, 4, 5, 6, 7, 7]
    binned = torch.tensor([[-2], [-3], [5], [3], [-20]], dtype=torch.int8)
    got, _ = walk_packed(binned, packed)
    want = device_leaf_indices(binned, parent, feature, bins, cat_set)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    ref = ref_leaf_indices(binned.numpy(), parent, feature, bins, cat_set)
    np.testing.assert_array_equal(want.numpy(), ref)


@pytest.mark.parametrize("C", [1, 3, 9])
@pytest.mark.parametrize("cat", [False, True])
def test_plain_matches_reference_bit_for_bit(C, cat):
    rng = np.random.default_rng(C + 20 * cat)
    T, S, d, n_bins, n = 4, 10, 5, 16, 600
    parent, feature, bins, cat_set = _lists(rng, T, C, S, d, n_bins, "leafwise", cat)
    leaf_value = rng.standard_normal((T, C, S + 1)).astype(np.float32)
    scale = rng.uniform(0.05, 0.3, size=T)
    binned = rng.integers(0, n_bins, size=(n, d)).astype(np.int32)
    bt = torch.from_numpy(binned.astype(np.int8))
    got = device_raw_scores(bt, parent, feature, bins, leaf_value, scale, cat_set)
    ref_leaves = ref_leaf_indices(binned, parent, feature, bins, cat_set)
    _assert_scores_match_reference(
        got.numpy(), ref_leaves, leaf_value, scale,
        ref_raw_scores(binned, parent, feature, bins, leaf_value, scale, cat_set))
    got_leaf = device_leaf_indices(bt, parent, feature, bins, cat_set)
    np.testing.assert_array_equal(got_leaf.numpy(), ref_leaves)
    walked, _ = walk_packed(bt, pack_trees(parent, feature, bins, cat_set))
    torch.testing.assert_close(walked, got_leaf, rtol=0, atol=0)


def test_plain_matches_reference_booster_with_categorical_features():
    """A reference booster fit on the CPU with a categorical feature: its own
    bins and tree arrays through both packages' scoring functions."""
    rng = np.random.default_rng(61)
    n = 800
    cats = rng.integers(0, 12, size=n).astype(np.float64)
    y = np.isin(cats, [2, 3, 9]).astype(np.float64) + 0.1 * rng.normal(size=n)
    x = np.stack([cats, rng.normal(size=n)], axis=1)
    b = ref_train({"objective": "regression", "num_iterations": 5, "num_leaves": 6,
                   "min_data_in_leaf": 5, "categorical_feature": [0]}, x, y)
    assert b.cat_set is not None and (b.bin < 0).any()
    binned = b._binned(x)
    args = (b.parent, b.feature, b.bin)
    bt = torch.from_numpy(np.asarray(binned).astype(np.int32))
    got = device_raw_scores(bt, *args, b.leaf_value, b.tree_scale, b.cat_set)
    ref_leaves = ref_leaf_indices(binned, *args, b.cat_set)
    _assert_scores_match_reference(
        got.numpy(), ref_leaves, b.leaf_value, b.tree_scale,
        ref_raw_scores(binned, *args, b.leaf_value, b.tree_scale, b.cat_set))
    leaves = device_leaf_indices(bt, *args, b.cat_set)
    np.testing.assert_array_equal(leaves.numpy(), ref_leaves)
    walked, _ = walk_packed(bt, pack_trees(*args, b.cat_set))
    torch.testing.assert_close(walked, leaves, rtol=0, atol=0)


def test_predict_leaf_and_leaf_prediction_col_match_reference():
    rng = np.random.default_rng(5)
    n, d = 1500, 6
    x = rng.normal(size=(n, d)).astype(np.float32)
    y = 2 * x[:, 0] + np.sin(x[:, 1]) + 0.1 * rng.normal(size=n)
    ref_model = RefRegressor(num_iterations=4, num_leaves=9, max_bin=31,
                             leaf_prediction_col="leaves").fit(
        RefTable({"features": x, "label": y}))
    port = model_from_state(ref_model.booster.state_dict(), device="cpu",
                            leaf_prediction_col="leaves")
    want = ref_model.booster.predict_leaf(x)
    got = port.booster.predict_leaf(x, device="cpu")
    assert got.dtype == np.int32 and got.shape == (n, 4)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(port.booster.predict_leaf(x, num_iteration=2, device="cpu"),
                                  ref_model.booster.predict_leaf(x, num_iteration=2))
    out = port.transform(Table({"features": x}))
    ref_out = ref_model.transform(RefTable({"features": x}))
    assert np.asarray(out["leaves"]).dtype == np.float64
    np.testing.assert_array_equal(np.asarray(out["leaves"]), np.asarray(ref_out["leaves"]))
    assert "leaves" in port.transform_schema(TableSchema.from_table(Table({"features": x})))


def test_visits_and_bound_on_a_hand_counted_tree():
    """Splits: s0 splits leaf 0 (root), s1 splits leaf 1, s2 is dead (its
    parent, leaf 5, never exists), s3 splits leaf 0 again. Leaf depths:
    0 -> 2, 1 -> 2, 2 -> 2, 4 -> 2; leaf 3 never exists."""
    parent = np.array([[[0, 1, 5, 0]]], np.int32)
    feature = np.array([[[0, 1, 0, 1]]], np.int32)
    bins = np.array([[[4, 2, 0, 1]]], np.int32)
    packed = pack_trees(parent, feature, bins)
    assert packed.depth[0, 0].tolist() == [2, 2, 2, 0, 2]
    binned = torch.tensor([[5, 3], [5, 0], [1, 9], [1, 0]], dtype=torch.int8)
    leaves = device_leaf_indices(binned, parent, feature, bins)
    assert leaves[0, 0].tolist() == [2, 1, 4, 0]
    assert path_visits(leaves, packed.depth) == 8
    # 4 rows x 2 int8 bins, 3 narrow records (the live splits) of 8 bytes
    # padded to 32, 5 leaf values + 1 scale, 4 scores
    assert packed.narrow and packed.units == 2
    n_bytes = tree_bytes(4, 2, 1, packed, leaf=False)
    assert n_bytes == 8 + 32 + 24 + 16
    assert tree_bytes(4, 2, 1, packed, leaf=True) == 8 + 32 + 16
    assert tree_bound(n_bytes, 8, 1e9) == (8 / 1e9 * 1e3, "operations")
    assert tree_bound(n_bytes, 8, 1e15)[1] == "bytes"
