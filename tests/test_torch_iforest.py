"""The port's isolation forest against the JAX package's, on the CPU.

Trees are built by the same code from the same ``default_rng(random_seed)``
draws: bit-equal heap arrays. Scores: within ``SCORE_TOL`` of the
reference's: the path lengths are the same f32 values, but XLA sums the
trees' in another order and its ``pow`` rounds differently (1-2 ulps of a
score in (0, 1)). Predictions are identical. The card's path (kernel B over
re-binned rows and replay lists) is held here through its plain versions:
the re-binning and the replay lists route every row as the heap descent
does, bit for bit.
"""

import numpy as np
import pytest
import torch

from synapseml_tpu import Table as RefTable
from synapseml_tpu.isolationforest import IsolationForest as RefForest
from synapseml_tpu.isolationforest import IsolationForestModel as RefModel
from synapseml_tpu_torch.core import STAGE_REGISTRY, Table, load_stage
from synapseml_tpu_torch.gbdt.device_predict import leaf_indices_plain, raw_scores_plain
from synapseml_tpu_torch.isolationforest import IsolationForest, IsolationForestModel
from synapseml_tpu_torch.isolationforest import forest as F
from synapseml_tpu_torch.tools.kernel_cases import forest_probe_rows, forest_rows
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCORE_TOL = 1e-6
HEAP = ("tree_features", "tree_thresholds", "tree_path_lens")


def _both(x, **params):
    ref = RefForest(**params).fit(RefTable({"features": x}))
    port = IsolationForest(device="cpu", **params).fit(Table({"features": x}))
    return ref, port


FITS = {
    "default": dict(random_seed=1),
    "small": dict(num_estimators=30, max_samples=64, random_seed=3),
    "bootstrap": dict(num_estimators=20, max_samples=100, bootstrap=True, random_seed=7),
    "features": dict(num_estimators=25, max_features=0.4, random_seed=2),
    "contaminated": dict(num_estimators=50, max_samples=128, contamination=0.05,
                         random_seed=3),
}


@pytest.mark.parametrize("name", sorted(FITS))
def test_trees_bit_equal_and_scores_within_tolerance(name):
    x = forest_rows(0, 700, 6)
    ref, port = _both(x, **FITS[name])
    for k in HEAP:
        np.testing.assert_array_equal(np.asarray(port.get(k)), np.asarray(ref.get(k)))
    for k in ("depth_limit", "c_norm"):
        assert port.get(k) == ref.get(k)
    assert port.score_threshold == pytest.approx(ref.score_threshold, abs=SCORE_TOL)
    probe = forest_probe_rows(port, x).astype(np.float64)
    r = ref.transform(RefTable({"features": probe}))
    p = port.transform(Table({"features": probe}))
    np.testing.assert_allclose(p["outlierScore"], np.asarray(r["outlierScore"]), rtol=0,
                               atol=SCORE_TOL)
    np.testing.assert_array_equal(p["predictedLabel"], np.asarray(r["predictedLabel"]))
    assert p["outlierScore"].dtype == np.float64


def test_outliers_score_high_and_contamination_flags_them():
    x = forest_rows(1, 1000, 4)
    x[-25:] = np.random.default_rng(2).normal(size=(25, 4)) * 0.5 + 8.0
    truth = np.r_[np.zeros(975), np.ones(25)]
    _, port = _both(x, num_estimators=50, max_samples=128, contamination=25 / 1000,
                    random_seed=3)
    out = port.transform(Table({"features": x}))
    s = out["outlierScore"]
    assert 0 <= s.min() and s.max() <= 1
    assert s[truth == 1].min() > np.median(s[truth == 0])
    assert out["predictedLabel"][truth == 1].mean() > 0.9


def test_rebin_routes_ties_nan_and_infinities_as_the_reference():
    x = forest_rows(3, 400, 5)
    _, port = _both(x, num_estimators=40, max_samples=128, random_seed=4)
    probe = torch.from_numpy(forest_probe_rows(port, x))
    plan = F.forest_plan(port.tree_features, port.tree_thresholds, port.tree_path_lens, 5,
                         "cpu")
    assert plan.bin_dtype == torch.int16
    b = F.rebin(probe, plan).long()
    # x > u_j exactly when bin > j, for every threshold of every feature
    for f in range(5):
        u = plan.uniq[f]
        u = u[torch.isfinite(u)]
        want = probe[:, f:f + 1] > u[None, :]
        got = b[:, f:f + 1] > torch.arange(len(u))[None, :]
        assert torch.equal(got, want)
    assert (b[torch.isnan(probe)] == 0).all()
    lens = torch.tensor([len(u[torch.isfinite(u)]) for u in plan.uniq])
    pos_inf = torch.isposinf(probe)
    assert torch.equal(b[pos_inf], lens.expand_as(b)[pos_inf])
    assert (b[torch.isneginf(probe)] == 0).all()


def test_heap_to_replay_gives_the_heap_descents_leaves():
    x = forest_rows(4, 500, 4)
    _, port = _both(x, num_estimators=12, max_samples=256, random_seed=5)
    feat = np.asarray(port.tree_features)
    parent, rfeat, thr, leaf = F.heap_to_replay(feat, port.tree_thresholds,
                                                port.tree_path_lens)
    T, nodes = feat.shape
    assert parent.shape == (T, 1, (nodes - 1) // 2) and leaf.shape[-1] == parent.shape[-1] + 1
    assert ((parent >= 0).sum(axis=(1, 2)) == (feat >= 0).sum(1)).all()
    # every split refines an existing leaf, and leaves get the heap's path lengths
    for t in range(T):
        n = int((parent[t, 0] >= 0).sum())
        assert (parent[t, 0, :n] <= np.arange(n)).all() and (parent[t, 0, n:] == -1).all()
        heap_leaves = np.sort(np.asarray(port.tree_path_lens)[t][_reached_leaves(feat[t])])
        np.testing.assert_array_equal(np.sort(leaf[t, 0, :n + 1]), heap_leaves)
    probe = torch.from_numpy(forest_probe_rows(port, x))
    plan = F.forest_plan(feat, port.tree_thresholds, port.tree_path_lens, 4, "cpu")
    binned = F.rebin(probe, plan)
    replay = raw_scores_plain(binned, plan.parent, plan.feature, plan.bins, plan.leaf_value,
                              np.ones(T, np.float32))[:, 0]
    heap = F.path_lengths_plain(probe, feat, port.tree_thresholds, port.tree_path_lens,
                                port.depth_limit)
    assert torch.equal(replay, heap)
    ids = leaf_indices_plain(binned, plan.parent, plan.feature, plan.bins)
    assert int(ids.max()) <= int((parent >= 0).sum(axis=(1, 2)).max())


def _reached_leaves(feat_t):
    reach = np.zeros(len(feat_t), bool)
    reach[0] = True
    for i in range(len(feat_t)):
        if reach[i] and feat_t[i] >= 0:
            reach[2 * i + 1] = reach[2 * i + 2] = True
    return reach & (feat_t < 0)


def test_bins_widen_to_int32_past_32767_thresholds():
    T, nodes = 1, 2 ** 16 - 1                 # one deep heap tree splitting one feature
    feat = np.full((T, nodes), -1, np.int32)
    thr = np.zeros((T, nodes), np.float32)
    internal = np.arange(2 ** 15 - 1)
    feat[0, internal] = 0
    thr[0, internal] = np.arange(len(internal), dtype=np.float32)
    plan = F.forest_plan(feat, thr, np.ones((T, nodes), np.float32), 1, "cpu")
    assert plan.bin_dtype == torch.int16
    more = np.full((1, 2 ** 17 - 1), -1, np.int32)
    more[0, :2 ** 15] = 0
    thr2 = np.zeros(more.shape, np.float32)
    thr2[0, :2 ** 15] = np.arange(2 ** 15, dtype=np.float32)
    plan = F.forest_plan(more, thr2, np.ones(more.shape, np.float32), 1, "cpu")
    assert plan.bin_dtype == torch.int32


def test_save_load_registry_and_state_both_ways(tmp_path):
    x = forest_rows(5, 300, 3)
    ref, port = _both(x, num_estimators=15, contamination=0.1, random_seed=6)
    assert STAGE_REGISTRY["IsolationForest"] is IsolationForest
    assert STAGE_REGISTRY["IsolationForestModel"] is IsolationForestModel
    port.save(str(tmp_path / "m"))
    loaded = load_stage(str(tmp_path / "m"))
    assert isinstance(loaded, IsolationForestModel)
    t = Table({"features": x})
    np.testing.assert_array_equal(loaded.transform(t)["outlierScore"],
                                  port.transform(t)["outlierScore"])
    # the reference's trees scored by the port, the port's by the reference
    from_ref = IsolationForestModel.from_state(
        {k: ref.get(k) for k in port.state_dict()}, device="cpu")
    np.testing.assert_array_equal(from_ref.transform(t)["outlierScore"],
                                  port.transform(t)["outlierScore"])
    to_ref = RefModel(**port.state_dict())
    np.testing.assert_array_equal(np.asarray(to_ref.transform(RefTable({"features": x}))
                                             ["outlierScore"]),
                                  np.asarray(ref.transform(RefTable({"features": x}))
                                             ["outlierScore"]))


def test_estimator_and_model_default_to_the_gpu():
    from synapseml_tpu_torch.runtime.device import DeviceUnavailableError

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    x = forest_rows(6, 100, 3)
    model = IsolationForest(num_estimators=5).fit(Table({"features": x}))
    with pytest.raises(DeviceUnavailableError):
        model.transform(Table({"features": x}))
