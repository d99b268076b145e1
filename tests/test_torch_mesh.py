"""The port's GBDT mesh on the CPU: ``train(..., mesh=)`` over a gloo world.

The reference's dense mesh tests (``tests/test_gbdt.py`` ``:204``, ``:222``,
``:240``, ``:258``, ``:279``, ``:378``, ``:406``, ``:420``, ``:823``,
``:839``, ``:1002``, ``:1032``, ``:1087``, ``:1107``, ``:1157``, ``:1174``,
``:1187``) carried over: each port fit runs on every rank of one
persistent 8-rank gloo world (``tests/torch_mesh.py``; 8 x 1 and 4 x 2
layouts, the reference's ``eight_device_mesh`` is (4, 2)), every rank must
return the same booster, and the mesh trees (``parent``, ``feature``,
``bin``, ``cat_set``, ``leaf_value``) must be bit-identical to the port's
own single-device fit wherever the reference holds that for itself (and at
``:204``, where the reference asks only for 95 % agreement: pre-rounded
histograms are exact in any order). Each also matches the reference's own
mesh fit on the same shard counts, run once in this process, within the
tolerances ROADMAP queue 3 gives their causes: binary leaves to 1e-3
(XLA's ``exp`` in the sigmoid), lambdarank leaves to 5e-3 (XLA's
``exp2`` in the reference's rounding grid).

Then the plain twins of the mesh's kernel entries, with no world: kernel
P's mesh entry and pick against its one-launch step, G's forced
parent-less half mode plus the subtraction against its half mode with the
parent, and a mesh with no process group.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

from synapseml_tpu.gbdt.boost import _metric_ndcg
from synapseml_tpu.gbdt.boost import train as ref_train
from synapseml_tpu.gbdt import GBDTDataset as RefDataset
from synapseml_tpu.runtime.layout import SpecLayout as RefLayout

from synapseml_tpu_torch.gbdt.boost import GBDTBooster, _preround, train
from synapseml_tpu_torch.gbdt.metrics import METRICS
from synapseml_tpu_torch.gbdt.partition import RowPartition, partition_plain, pick_plain
from synapseml_tpu_torch.gbdt.sparse import (g_summed_sides, sparse_hist, sparse_hist_mesh)
from synapseml_tpu_torch.runtime.layout import MeshUnavailableError, SpecLayout
from synapseml_tpu_torch.tools.kernel_cases import (PARTITION_CASES, partition_case,
                                                    sparse_hist_case)
from tests.torch_mesh import MeshWorld
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

BINARY_TOL = 1e-3      # XLA's exp in the reference's sigmoid (ROADMAP queue 3)
LAMBDARANK_TOL = 5e-3  # XLA's exp2 in the reference's pre-rounding grid
EIGHT = ("build", 8, 1)
FOUR_TWO = ("build", 4, 2)
RAW_EIGHT = ("raw", (8,), ("data",))
RAW_FOUR_TWO = ("raw", (4, 2), ("data", "model"))
TREE_FIELDS = ("parent", "feature", "bin", "cat_set", "leaf_value")


@pytest.fixture(scope="module")
def world():
    w = MeshWorld(8)
    yield w
    w.close()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    n, d = 3000, 8
    x = rng.normal(size=(n, d))
    logit = 2 * x[:, 0] - 1.5 * x[:, 1] + x[:, 2] * x[:, 3]
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(float)
    return x, y


def _ref_mesh(shape):
    devs = np.asarray(jax.devices()[:8])
    return Mesh(devs.reshape(shape), ("data",) if len(shape) == 1 else ("data", "model"))


def _auc(y, p):
    return METRICS["auc"][0](y, p, np.ones(len(y)))


def _booster(state: dict) -> GBDTBooster:
    b = GBDTBooster.from_state_dict(state)
    b.evals_result, b.sampled_rows = state["evals_result"], state["sampled_rows"]
    return b


def _same_fields(a, b, fields=TREE_FIELDS):
    for f in fields:
        va, vb = getattr(a, f), getattr(b, f)
        if va is None or vb is None:
            assert va is None and vb is None, f
        else:  # NaN thresholds (categorical splits) compare equal
            np.testing.assert_array_equal(va, vb, err_msg=f)


def mesh_fit(world, layout, params, x, y, **kw):
    """(rank 0's booster, collectives, plain P / pick calls) of one fit on
    every rank, after checking that every rank returned the same booster."""
    res = world.run("fit", layout=layout, params=params, x=x, y=y, **kw)
    first = _booster(res[0]["booster"])
    for r in res[1:]:
        _same_fields(_booster(r["booster"]), first,
                     TREE_FIELDS + ("leaf_hess", "tree_scale", "threshold", "best_iteration"))
    return first, res[0]["collectives"], res[0]["calls"]


def close_to_reference(port, ref, tol):
    """The reference's trees, leaves within ``tol`` (a queue-3 cause)."""
    assert port.num_trees == ref.num_trees
    for f in ("parent", "feature", "bin"):
        np.testing.assert_array_equal(getattr(port, f), np.asarray(getattr(ref, f)), err_msg=f)
    if ref.cat_set is not None or port.cat_set is not None:
        np.testing.assert_array_equal(port.cat_set, np.asarray(ref.cat_set))
    np.testing.assert_allclose(port.leaf_value, np.asarray(ref.leaf_value), rtol=0, atol=tol)


def _steps(params, classes=1):
    return params["num_iterations"] * classes * (params["num_leaves"] - 1)


# -- the reference's dense mesh tests ------------------------------------------------

def test_distributed_matches_single_device(world, data):
    """``:204``: an 8-rank 1-D mesh (a raw DeviceMesh) grows the
    single-device trees bit for bit; per split step kernel P's mesh entry
    and its pick run once, and two all-reduces (the counts, the child)."""
    x, y = data
    params = {"objective": "binary", "num_iterations": 15, "num_leaves": 15,
              "min_data_in_leaf": 5}
    bd, coll, calls = mesh_fit(world, RAW_EIGHT, params, x[:2400], y[:2400])
    _same_fields(bd, train(params, x[:2400], y[:2400], device="cpu"))
    steps = _steps(params)
    assert calls == {"split_mesh": steps, "pick": steps}
    assert coll == {"sum:data": params["num_iterations"] + 2 * steps,
                    "max:data": 2 * params["num_iterations"]}
    ref = ref_train(params, x[:2400], y[:2400], mesh=_ref_mesh((8,)))
    close_to_reference(bd, ref, BINARY_TOL)
    p_mesh, p_ref = bd.predict(x[2400:], device="cpu"), np.asarray(ref.predict(x[2400:]))
    assert np.corrcoef(p_mesh, p_ref)[0, 1] > 0.999


def test_layout_single_chip_matches_pre_layout_bitwise(data):
    """``:222``: a (1, 1) layout in a one-rank world grows the plain fit's
    trees; the reference's (1, 1) layout gives its own."""
    x, y = data
    params = {"objective": "binary", "num_iterations": 8, "num_leaves": 15,
              "min_data_in_leaf": 5}
    w = MeshWorld(1)
    try:
        b_lay, coll, _ = mesh_fit(w, ("build", 1, 1), params, x[:1200], y[:1200])
    finally:
        w.close()
    _same_fields(b_lay, train(params, x[:1200], y[:1200], device="cpu"))
    assert coll["sum:data"] == params["num_iterations"] + 2 * _steps(params)
    ref = ref_train(params, x[:1200], y[:1200],
                    mesh=RefLayout.build(data=1, model=1, devices=jax.devices()[:1]))
    close_to_reference(b_lay, ref, BINARY_TOL)


def test_layout_wraps_raw_mesh_bitwise(world, data):
    """``:240``: ``as_layout`` of a raw 1-D DeviceMesh and
    ``SpecLayout.build(data=8, model=1)`` give identical trees."""
    x, y = data
    params = {"objective": "binary", "num_iterations": 6, "num_leaves": 15,
              "min_data_in_leaf": 5}
    b_raw, _, _ = mesh_fit(world, RAW_EIGHT, params, x[:2400], y[:2400])
    b_lay, _, _ = mesh_fit(world, EIGHT, params, x[:2400], y[:2400])
    _same_fields(b_lay, b_raw)
    _same_fields(b_lay, train(params, x[:2400], y[:2400], device="cpu"))
    ref = ref_train(params, x[:2400], y[:2400], mesh=_ref_mesh((8,)))
    close_to_reference(b_lay, ref, BINARY_TOL)


def test_feature_parallel_matches_data_parallel(world, data):
    """``:258``: the (4, 2) layout histograms each rank's column block and
    assembles the child with one all-reduce over both axes; the trees are
    the 8 x 1 data-parallel ones and the single-device ones, bit for bit."""
    x, y = data
    params = {"objective": "binary", "num_iterations": 8, "num_leaves": 15,
              "min_data_in_leaf": 5}
    b_fp, coll, _ = mesh_fit(world, FOUR_TWO, params, x[:2400], y[:2400])
    b_dp, _, _ = mesh_fit(world, EIGHT, params, x[:2400], y[:2400])
    _same_fields(b_fp, b_dp)
    _same_fields(b_fp, train(params, x[:2400], y[:2400], device="cpu"))
    steps = _steps(params)
    # the root and each child over both axes, the counts over the data axis
    assert coll == {"sum:data+model": params["num_iterations"] + steps, "sum:data": steps,
                    "max:data": 2 * params["num_iterations"]}
    ref = ref_train(params, x[:2400], y[:2400],
                    mesh=RefLayout.build(data=4, model=2, devices=jax.devices()[:8]))
    close_to_reference(b_fp, ref, BINARY_TOL)


def test_feature_parallel_2d_mesh_via_raw_mesh(world, data):
    """``:279``: a raw 2-D (data, model) DeviceMesh engages the same
    feature-parallel path, with GOSS drawn per shard; AUC above 0.9, and
    the reference's GOSS mesh trees (its draws, per shard, are the port's)."""
    x, y = data
    params = {"objective": "binary", "num_iterations": 12, "num_leaves": 15,
              "min_data_in_leaf": 5, "boosting": "goss", "seed": 3}
    b, _, _ = mesh_fit(world, RAW_FOUR_TWO, params, x[:2400], y[:2400])
    assert _auc(y[2400:], b.predict(x[2400:], device="cpu")) > 0.9
    ref = ref_train(params, x[:2400], y[:2400], mesh=_ref_mesh((4, 2)))
    close_to_reference(b, ref, BINARY_TOL)


def test_gbdt_device_dataset_on_mesh(world, data):
    """``:378``: a device-resident dataset (a tensor) gives each rank its
    block of the cached bins and trains the host matrix's mesh trees, which
    are the single-device ones; an uneven row count pads by wrapping."""
    x, y = data
    params = {"objective": "binary", "num_iterations": 10, "num_leaves": 15,
              "min_data_in_leaf": 5, "max_bin": 63}
    b_dev, _, _ = mesh_fit(world, RAW_EIGHT, params, x[:2400].astype(np.float32),
                           y[:2400], dataset="device", dataset_kw={"max_bin": 63})
    b_host, _, _ = mesh_fit(world, RAW_EIGHT, params, x[:2400].astype(np.float32),
                            y[:2400])
    _same_fields(b_dev, b_host)
    _same_fields(b_dev, train(params, x[:2400].astype(np.float32), y[:2400], device="cpu"))
    b2, _, _ = mesh_fit(world, RAW_EIGHT, params, x[:2395].astype(np.float32), y[:2395],
                        dataset="device", dataset_kw={"max_bin": 63})
    assert _auc(y[:2395], b2.predict(x[:2395], device="cpu")) > 0.9
    ds = RefDataset(jax.numpy.asarray(x[:2400], jax.numpy.float32),
                    label=jax.numpy.asarray(y[:2400], jax.numpy.float32), max_bin=63)
    close_to_reference(b_dev, ref_train(params, ds, mesh=_ref_mesh((8,))), BINARY_TOL)


def test_gbdt_dataset_on_mesh(world, data):
    """``:406``: a host dataset on a mesh: its bins taken by row, the
    single-device trees, AUC above 0.9."""
    x, y = data
    params = {"objective": "binary", "num_iterations": 5, "num_leaves": 7,
              "min_data_in_leaf": 5}
    b, _, _ = mesh_fit(world, RAW_EIGHT, params, x[:2400], y[:2400], dataset="host",
                       dataset_kw={"max_bin": 63})
    assert np.isfinite(b.leaf_value).all()
    assert _auc(y[2400:], b.predict(x[2400:], device="cpu")) > 0.9
    from synapseml_tpu_torch.gbdt import GBDTDataset

    _same_fields(b, train(params, GBDTDataset(x[:2400], label=y[:2400], max_bin=63,
                                              device="cpu")))
    ref = ref_train(params, RefDataset(x[:2400], max_bin=63), y[:2400], mesh=_ref_mesh((8,)))
    close_to_reference(b, ref, BINARY_TOL)


def test_distributed_tolerates_empty_shard(world):
    """``:420``: a shard whose rows all have weight 0 poisons nothing; a
    user's zero weight keeps its count, so the trees are the single
    device's."""
    rng = np.random.default_rng(44)
    n = 2400
    x = rng.normal(size=(n, 6))
    y = (x[:, 0] > 0).astype(np.float64)
    w = np.ones(n)
    w[:300] = 0.0  # shard 0 contributes nothing
    params = {"objective": "binary", "num_iterations": 10, "num_leaves": 7,
              "min_data_in_leaf": 5}
    b, _, _ = mesh_fit(world, RAW_EIGHT, params, x, y, weight=w)
    assert np.isfinite(b.leaf_value).all()
    acc = ((b.predict(x[300:], device="cpu") > 0.5) == (y[300:] > 0.5)).mean()
    assert acc > 0.95, acc
    _same_fields(b, train(params, x, y, weight=w, device="cpu"))
    close_to_reference(b, ref_train(params, x, y, weight=w, mesh=_ref_mesh((8,))), BINARY_TOL)


def test_voting_parallel_trains_accurately(world):
    """``:823``: voting on the (4, 2) mesh (the model axis replicates):
    accuracy above 0.93 and the informative features in the trees, and the
    reference's voting trees. The votes and candidates are all-reduced,
    kernel E's full-table entry scores them."""
    rng = np.random.default_rng(63)
    n, d = 4096, 24
    x = rng.normal(size=(n, d))
    y = (x[:, 3] + 0.7 * x[:, 11] - 0.5 * x[:, 17] > 0).astype(np.float64)
    params = {"objective": "binary", "num_iterations": 10, "num_leaves": 15,
              "min_data_in_leaf": 5}
    b_vote, coll, calls = mesh_fit(world, FOUR_TWO,
                                   {**params, "parallelism": "voting_parallel", "top_k": 4},
                                   x, y)
    acc = ((b_vote.predict(x, device="cpu") > 0.5) == (y > 0.5)).mean()
    assert acc > 0.93
    used = set(b_vote.feature[b_vote.parent >= 0].tolist())
    assert {3, 11, 17} & used
    # the smaller child is a local choice: P's one-launch step, no counts reduced
    assert calls == {"split": _steps(params)} and "sum:data+model" not in coll
    # the same votes, ties broken in lax.top_k's order: the reference's trees
    ref = ref_train({**params, "parallelism": "voting_parallel", "top_k": 4}, x, y,
                    mesh=_ref_mesh((4, 2)))
    close_to_reference(b_vote, ref, BINARY_TOL)


def test_voting_parallel_single_replica_matches_data_parallel():
    """``:839``: without a mesh, voting is the data-parallel tree."""
    rng = np.random.default_rng(64)
    x = rng.normal(size=(500, 8))
    y = x[:, 0] - x[:, 5]
    params = {"objective": "regression", "num_iterations": 3, "num_leaves": 7,
              "min_data_in_leaf": 5}
    b_d = train({**params, "parallelism": "data_parallel"}, x, y, device="cpu")
    b_v = train({**params, "parallelism": "voting_parallel"}, x, y, device="cpu")
    _same_fields(b_v, b_d)
    ref = ref_train({**params, "parallelism": "voting_parallel"}, x, y)
    np.testing.assert_allclose(b_v.predict(x, device="cpu"), np.asarray(ref.predict(x)),
                               rtol=0, atol=1e-4)  # l2: the reference's exp2 grid


def _rank_data():
    rng = np.random.default_rng(11)
    sizes = rng.integers(3, 20, size=60)
    n = int(sizes.sum())
    xr = rng.normal(size=(n, 12))
    rel = np.zeros(n)
    start = 0
    for sz in sizes:
        sc = xr[start:start + sz, 0] + 0.5 * xr[start:start + sz, 3]
        rel[start:start + sz] = np.clip(np.argsort(np.argsort(sc)) * 4 // sz, 0, 3)
        start += sz
    return xr, rel, sizes


def test_lambdarank_mesh_matches_single_replica(world):
    """``:1002``: whole queries a shard (the reference's order and padding),
    kernel F over each rank's own query groups: the single-device trees
    and NDCG."""
    from synapseml_tpu.gbdt.boost import make_lambdarank_mesh as ref_layout
    from synapseml_tpu_torch.gbdt.lambdarank import group_aligned_layout

    xr, rel, sizes = _rank_data()
    params = {"objective": "lambdarank", "num_iterations": 10, "num_leaves": 15,
              "min_data_in_leaf": 3}
    b8, _, _ = mesh_fit(world, FOUR_TWO, params, xr, rel, group=sizes)
    b1 = train(params, xr, rel, group=sizes, device="cpu")
    _same_fields(b8, b1)
    ndcg = _metric_ndcg(10)
    w = np.ones(len(rel))
    n1 = ndcg(rel, b1.predict(xr, device="cpu"), w, sizes)
    n8 = ndcg(rel, b8.predict(xr, device="cpu"), w, sizes)
    assert n8 > 0.9
    assert abs(n1 - n8) < 1e-9
    _, _, order, w_mask, local = ref_layout(sizes, 4, "data")
    port = group_aligned_layout(sizes, 4)
    np.testing.assert_array_equal(port[0], order)
    np.testing.assert_array_equal(port[1], w_mask)
    assert port[2] == local
    ref = ref_train(params, xr, rel, group=sizes, mesh=_ref_mesh((4, 2)))
    close_to_reference(b8, ref, LAMBDARANK_TOL)


def test_lambdarank_mesh_device_dataset_matches_numpy(world):
    """``:1032``: a device-resident dataset's group-aligned blocks come
    from its cached bins, and the fit is the numpy matrix's mesh fit (same
    mapper) bit for bit."""
    rng = np.random.default_rng(12)
    xr = rng.normal(size=(64, 4)).astype(np.float32)
    rel = rng.integers(0, 3, size=64).astype(np.float64)
    group = np.full(8, 8)
    params = {"objective": "lambdarank", "num_iterations": 3, "num_leaves": 7,
              "min_data_in_leaf": 3}
    bd, _, _ = mesh_fit(world, FOUR_TWO, params, xr, rel, group=group, dataset="device")
    res = world.run("fit", layout=FOUR_TWO, params=params, x=xr.astype(np.float64), y=rel,
                    group=group, mapper_of=xr)
    bn = _booster(res[0]["booster"])
    _same_fields(bd, bn)
    np.testing.assert_allclose(bd.predict(xr.astype(np.float64), device="cpu"),
                               bn.predict(xr.astype(np.float64), device="cpu"), rtol=1e-6)
    ds = RefDataset(jax.numpy.asarray(xr), label=jax.numpy.asarray(rel, jax.numpy.float32))
    close_to_reference(bd, ref_train(params, ds, group=group, mesh=_ref_mesh((4, 2))),
                       LAMBDARANK_TOL)


def test_continued_training_device_dataset_mesh(world):
    """``:1087``: continued training from a device dataset on the mesh:
    each rank scores the first booster over its block; eight trees, the
    single-device continuation's."""
    rng = np.random.default_rng(22)
    x = rng.normal(size=(1024, 8)).astype(np.float32)
    y = (x[:, 1] + x[:, 2] > 0).astype(np.float32)
    params = {"objective": "binary", "num_iterations": 4, "num_leaves": 7,
              "min_data_in_leaf": 5, "max_bin": 63}
    b2, _, _ = mesh_fit(world, FOUR_TWO, params, x, y, dataset="device",
                        dataset_kw={"max_bin": 63}, continue_with=params)
    assert b2.num_trees == 8
    acc = ((b2.predict(x.astype(np.float64), device="cpu") > .5) == (y > .5)).mean()
    assert acc > 0.9
    from synapseml_tpu_torch.gbdt import GBDTDataset

    ds = GBDTDataset(torch.as_tensor(x), label=y, max_bin=63, device="cpu")
    _same_fields(b2, train(params, ds, init_booster=train(params, ds)))
    rds = RefDataset(jax.numpy.asarray(x), label=jax.numpy.asarray(y), max_bin=63)
    mesh = _ref_mesh((4, 2))
    ref = ref_train(params, rds, init_booster=ref_train(params, rds, mesh=mesh), mesh=mesh)
    close_to_reference(b2, ref, BINARY_TOL)


def test_distributed_matches_single_device_nondivisible(world):
    """``:1107``: 2,501 rows over 4 data shards: the wrapped padding rows
    have weight and count 0, so the trees are the single device's."""
    rng = np.random.default_rng(31)
    n = 2501
    x = rng.normal(size=(n, 8))
    y = (x[:, 0] - x[:, 3] > 0).astype(np.float64)
    params = {"objective": "binary", "num_iterations": 8, "num_leaves": 15,
              "min_data_in_leaf": 5}
    bd, _, _ = mesh_fit(world, FOUR_TWO, params, x, y)
    bs = train(params, x, y, device="cpu")
    _same_fields(bd, bs)
    np.testing.assert_array_equal(bd.predict(x, device="cpu"), bs.predict(x, device="cpu"))
    close_to_reference(bd, ref_train(params, x, y, mesh=_ref_mesh((4, 2))), BINARY_TOL)


@pytest.fixture(scope="module")
def mesh_device_bin_pair(world):
    """One (4, 2) mesh fit of f32 rows with a categorical feature and an
    eval set with early stopping, the single-device fit, and the
    reference's mesh fit, shared by the three tests below."""
    rng = np.random.default_rng(77)
    n = 3000
    cats = rng.integers(0, 20, size=n).astype(np.float32)
    num = rng.normal(size=(n, 5)).astype(np.float32)
    x = np.concatenate([cats[:, None], num], axis=1)
    noise = 0.1 * rng.normal(size=n)
    y = ((num[:, 0] * num[:, 1] + num[:, 2] + noise > 0)
         | np.isin(cats, [1, 5, 7])).astype(np.float64)
    xt, yt, xv, yv = x[:2400], y[:2400], x[2400:], y[2400:]
    params = {"objective": "binary", "num_iterations": 30, "num_leaves": 7,
              "min_data_in_leaf": 5, "categorical_feature": [0],
              "early_stopping_round": 5, "metric": "auc"}
    bd, _, _ = mesh_fit(world, FOUR_TWO, params, xt, yt, eval_set=[(xv, yv)])
    bh = train(params, xt, yt, eval_set=[(xv, yv)], device="cpu")
    ref = ref_train(params, xt, yt, eval_set=[(xv, yv)], mesh=_ref_mesh((4, 2)))
    return bd, bh, ref, xt


def test_mesh_device_bin_matches_host_bin_bitwise(mesh_device_bin_pair):
    """``:1157``: each rank bins its own block (kernel D's plain version
    here) and the trees are the single-device ones bit for bit."""
    bd, bh, ref, xt = mesh_device_bin_pair
    assert bd.num_trees == bh.num_trees
    _same_fields(bd, bh)
    np.testing.assert_array_equal(bd.predict(xt, device="cpu"), bh.predict(xt, device="cpu"))
    close_to_reference(bd, ref, BINARY_TOL)


def test_mesh_device_bin_categorical_matches_host_bin(mesh_device_bin_pair):
    """``:1174``: the mesh trees use categorical splits on column 0, with
    the single-device fit's and the reference's category sets."""
    bd, bh, ref, _ = mesh_device_bin_pair
    T = bd.num_trees
    assert ((bd.feature[:T] == 0) & (bd.bin[:T] < 0) & (bd.parent[:T] >= 0)).any()
    np.testing.assert_array_equal(bd.cat_set[:T], bh.cat_set[:T])
    np.testing.assert_array_equal(bd.cat_set[:T], np.asarray(ref.cat_set)[:T])


def test_mesh_device_eval_early_stop_matches_host(mesh_device_bin_pair):
    """``:1187``: every rank scores the replicated eval set, so early
    stopping stops at the single-device iteration with its trees."""
    bd, bh, ref, _ = mesh_device_bin_pair
    assert bd.best_iteration is not None
    assert bd.best_iteration == bh.best_iteration == ref.best_iteration
    _same_fields(bd, bh)
    ours = [r["eval0_auc"] for r in bd.evals_result]
    np.testing.assert_allclose(ours, [r["eval0_auc"] for r in bh.evals_result], rtol=0,
                               atol=1e-6)


def test_estimator_mesh_param(world, data):
    """The estimators' ``mesh`` Param: ``LightGBMClassifier(mesh=...)`` and
    ``LightGBMRanker(mesh=..., parallelism=..., top_k=...)`` fit over the
    mesh with the reference's names and defaults."""
    from synapseml_tpu_torch.gbdt.estimators import LightGBMRanker

    x, y = data
    params = {"num_iterations": 4, "num_leaves": 7, "min_data_in_leaf": 5}
    res = world.run("estimator", layout=EIGHT, params=params, x=x[:1000], y=y[:1000])
    b = _booster(res[0])
    for r in res[1:]:
        _same_fields(_booster(r), b)
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.gbdt.estimators import LightGBMClassifier

    one = LightGBMClassifier(device="cpu", **params).fit(
        Table({"features": x[:1000], "label": y[:1000]})).booster
    _same_fields(b, one)
    xr, rel, sizes = _rank_data()
    group = np.repeat(np.arange(len(sizes)), sizes)
    res = world.run("estimator", layout=FOUR_TWO, cls="LightGBMRanker",
                    params=dict(params, parallelism="voting_parallel", top_k=6),
                    x=xr, y=rel, group=group)
    assert np.isfinite(_booster(res[0]).leaf_value).all()
    assert LightGBMRanker().parallelism == "data_parallel" and LightGBMRanker().top_k == 20


# -- plain twins and errors, no world -------------------------------------------------

@pytest.mark.parametrize("case", sorted(PARTITION_CASES))
@pytest.mark.parametrize("flip", [False, True])
def test_partition_mesh_entry_plain_twin(case, flip):
    """Kernel P's mesh entry (routing and local counts) followed by its pick
    over the counts: with the local counts as the global ones it IS the
    one-launch step; with another rank's counts that make the other child
    globally smaller, it takes that child's local slice."""
    n, d, B = 257, 5, 17
    bins, ids, seg, side, node, s, leaf, in_set = partition_case(n, B, d, np.int8, case,
                                                                 seed=3)
    runs = []
    for mesh in (False, True):
        part = RowPartition(n, seg.shape[0], "cpu")
        part.begin_tree()
        part.ids.copy_(torch.from_numpy(ids))
        part.seg.copy_(torch.from_numpy(seg))
        part.side.copy_(torch.from_numpy(side))
        node_t = torch.from_numpy(node.copy())
        choice, ok = torch.tensor([leaf, d - 1]), torch.tensor([True])
        partition_plain(part, s, torch.from_numpy(bins), node_t, choice, ok,
                        torch.from_numpy(in_set), mesh=mesh)
        if mesh:
            n_left, n_right = (int(v) for v in part.counts)
            assert n_left + n_right == int(seg[leaf, 1])
            if flip:  # another rank's rows make the local smaller child the larger
                other = 2 * n + 1
                part.counts += torch.tensor([0, other] if n_right <= n_left else [other, 0],
                                            dtype=torch.int32)
            pick_plain(part, s, choice, ok)
        runs.append({k: t.clone() for k, t in (("ids", part.ids), ("seg", part.seg),
                                                ("side", part.side), ("node", node_t),
                                                ("small", part.small),
                                                ("smaller_right", part.smaller_right))})
    one, mesh = runs
    for k in ("ids", "seg", "side", "node"):
        assert torch.equal(one[k], mesh[k]), k
    if not flip:
        assert torch.equal(one["small"], mesh["small"])
        assert torch.equal(one["smaller_right"], mesh["smaller_right"])
    else:
        right = bool(mesh["smaller_right"][0])
        assert right != bool(one["smaller_right"][0])
        child = s + 1 if right else leaf
        assert mesh["small"].tolist() == [int(one["seg"][child, 0]),
                                          int(one["seg"][child, 1]),
                                          int(one["side"][child])]


def test_partition_mesh_inert_step_plain_twin():
    """An inert step: the mesh entry writes counts (0, 0) and moves no row;
    the pick records the empty child on the right."""
    bins, ids, seg, side, node, s, leaf, in_set = partition_case(300, 9, 4, np.int8, "deep",
                                                                 seed=1)
    part = RowPartition(300, seg.shape[0], "cpu")
    part.begin_tree()
    part.counts.fill_(7)
    choice, ok = torch.tensor([leaf, 0]), torch.tensor([False])
    partition_plain(part, s, torch.from_numpy(bins), torch.from_numpy(node.copy()), choice,
                    ok, torch.from_numpy(in_set), mesh=True)
    assert part.counts.tolist() == [0, 0]
    pick_plain(part, s, choice, ok)
    assert part.small.tolist() == [0, 0, 0] and bool(part.smaller_right[0])


@pytest.mark.parametrize("case", ["rows_40", "non_members", "nan_and_zeros", "one_side",
                                  "no_entries"])
@pytest.mark.parametrize("slot", [0, 1])
def test_sparse_hist_mesh_plain_twin(case, slot):
    """G's mesh use: the forced side summed with no parent, then the
    sibling as the kept parent minus it, equals G's half mode with the
    parent (the same side chosen by the member counts), bit for bit; the
    slot not summed is left as it was."""
    sb, panel, side, kept = sparse_hist_case(case, "cpu")
    g = torch.Generator().manual_seed(5)
    kept.copy_(_preround(torch.randn(kept.numel(), 1, generator=g), 1 << 20).view_as(kept))
    shape = (2, sb.d, sb.n_bins, 3)
    want, want_tot = torch.full(shape, float("nan")), torch.full((2, 3), float("nan"))
    sparse_hist(sb, panel, side, want, want_tot,
                torch.tensor([1, slot, -1], dtype=torch.int32), kept)
    forced = g_summed_sides(side, (1, slot, -1))[0]
    got, tot = torch.full(shape, float("nan")), torch.full((2, 3), float("nan"))
    sparse_hist_mesh(sb, panel, side, got, tot, torch.tensor([1, slot, forced],
                                                             dtype=torch.int32))
    assert got[1 - forced].isnan().all()
    got[1 - forced] = kept[slot] - got[forced]
    assert torch.equal(got, want) and torch.equal(tot, want_tot)


def test_mesh_without_process_group_raises(data):
    """A mesh asked for with no process group initialised is an error that
    names the process group, never a silent mesh of one."""
    x, y = data
    assert not torch.distributed.is_initialized()
    with pytest.raises(MeshUnavailableError, match="process group"):
        SpecLayout.build(data=1, device_type="cpu")
    with pytest.raises(MeshUnavailableError, match="process group"):
        train({"num_iterations": 1}, x[:100], y[:100], device="cpu", mesh=object())
