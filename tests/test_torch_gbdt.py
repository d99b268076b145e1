"""Port parity: the GBDT main path (binning -> boosting -> scoring) against the
JAX package on the same numpy inputs, on the CPU through the kernels' plain
versions."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapseml_tpu import Table as RefTable
from synapseml_tpu.core.stage import STAGE_NAME_COLLISIONS as REF_COLLISIONS
from synapseml_tpu.core.stage import STAGE_REGISTRY as REF_REGISTRY
from synapseml_tpu.gbdt import LightGBMClassifier as RefClassifier
from synapseml_tpu.gbdt import LightGBMRegressor as RefRegressor
from synapseml_tpu.gbdt.binning import BinMapper as RefBinMapper
from synapseml_tpu.gbdt.grow import TreeConfig as RefTreeConfig
from synapseml_tpu.gbdt.grow import grow_tree as ref_grow_tree
from synapseml_tpu_torch.core import Table, load_stage
from synapseml_tpu_torch.core.stage import STAGE_REGISTRY
from synapseml_tpu_torch.gbdt.binning import BinMapper
from synapseml_tpu_torch.gbdt.boost import _preround, train
from synapseml_tpu_torch.gbdt.convert import model_from_state
from synapseml_tpu_torch.gbdt.estimators import LightGBMClassifier, LightGBMRegressor
from synapseml_tpu_torch.gbdt.grow import TreeConfig, grow_tree, predict_binned
from synapseml_tpu_torch.runtime.device import DeviceUnavailableError, resolve_device

ITERS = 5
PARAMS = dict(num_iterations=ITERS, num_leaves=15, max_bin=63)


def _data(seed=0, n=3000, d=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y_cls = (x[:, 0] + 0.4 * x[:, 5] + 0.2 * rng.normal(size=n) > 0).astype(np.float64)
    y_reg = 2 * x[:, 0] + np.sin(x[:, 1]) + 0.1 * rng.normal(size=n)
    return x, y_cls, y_reg


def test_binning_matches_reference_edges():
    x, _, _ = _data(3, n=5000)
    x[::7, 2] = np.nan
    ref = RefBinMapper(max_bin=31, sample_cnt=1000, seed=5).fit(x)
    port = BinMapper(max_bin=31, sample_cnt=1000, seed=5).fit(x)
    for a, b in zip(ref.upper_edges, port.upper_edges):
        np.testing.assert_array_equal(a, b)
    assert port.to_dict() == {**ref.to_dict(), "upper_edges": port.to_dict()["upper_edges"]}
    np.testing.assert_array_equal(port.transform(x), ref.transform(x))
    binned = port.transform_torch(torch.from_numpy(x))
    assert binned.dtype == torch.int8
    np.testing.assert_array_equal(binned.numpy(), ref.transform(x))


def test_grow_one_tree_matches_reference():
    """n=2000, d=6, max_bin=31, num_leaves=7 on pre-rounded (tie-free)
    gradients: identical replay arrays, leaf values within rtol 1e-6."""
    rng = np.random.default_rng(11)
    n, d = 2000, 6
    x = rng.normal(size=(n, d))
    mapper = RefBinMapper(max_bin=31).fit(x)
    binned = mapper.transform(x).astype(np.int8)
    p = 1 / (1 + np.exp(-(x[:, 0] - 0.5 * x[:, 3])))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    g = _preround(torch.tensor(0.5 - y + 0.1 * x[:, 2], dtype=torch.float32)[:, None], 2048)[:, 0]
    h = _preround(torch.tensor(0.2 + 0.05 * np.abs(x[:, 1]), dtype=torch.float32)[:, None],
                  2048)[:, 0]
    w = np.ones(n, np.float32)
    fm = np.ones(d, np.float32)
    ref, ref_node = ref_grow_tree(jnp.asarray(binned), jnp.asarray(g.numpy()),
                                  jnp.asarray(h.numpy()), jnp.asarray(w), jnp.asarray(fm),
                                  RefTreeConfig(n_bins=32, num_leaves=7))
    tree, node = grow_tree(torch.from_numpy(binned), g, h, torch.from_numpy(w),
                           torch.from_numpy(fm), TreeConfig(n_bins=32, num_leaves=7))
    for field in ("parent", "feature", "bin"):
        np.testing.assert_array_equal(getattr(tree, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)
    assert (tree.parent.numpy() >= 0).sum() == 6  # every step split
    np.testing.assert_allclose(tree.leaf_value.numpy(), np.asarray(ref.leaf_value),
                               rtol=1e-6)
    np.testing.assert_array_equal(node.numpy(), np.asarray(ref_node))
    np.testing.assert_array_equal(predict_binned(tree, torch.from_numpy(binned)).numpy(),
                                  node.numpy())


def _assert_same_trees(ref_booster, port_booster, leaf_atol):
    for field in ("parent", "feature", "bin"):
        np.testing.assert_array_equal(getattr(port_booster, field),
                                      getattr(ref_booster, field), err_msg=field)
    np.testing.assert_allclose(port_booster.threshold, ref_booster.threshold)
    np.testing.assert_allclose(port_booster.base_score, ref_booster.base_score)
    np.testing.assert_allclose(port_booster.leaf_value, ref_booster.leaf_value,
                               rtol=0, atol=leaf_atol)


def test_classifier_fit_transform_matches_reference():
    """Whole slice, binary: identical trees; raw scores and probabilities
    within 1e-5 (sigmoid/exp may differ by an ulp between the frameworks;
    pre-rounding absorbs it in the trees)."""
    x, y, _ = _data()
    ref = RefTable({"features": x, "label": y}).ml_fit(RefClassifier(**PARAMS))
    port = Table({"features": x, "label": y}).ml_fit(LightGBMClassifier(device="cpu",
                                                                         **PARAMS))
    _assert_same_trees(ref.booster, port.booster, leaf_atol=1e-6)
    ro = ref.transform(RefTable({"features": x}))
    po = port.transform(Table({"features": x}))
    for col in ("rawPrediction", "probability"):
        np.testing.assert_allclose(po[col], ro[col], rtol=0, atol=1e-5, err_msg=col)
    np.testing.assert_array_equal(po["prediction"], ro["prediction"])


def test_regressor_fit_transform_matches_reference():
    """Whole slice, l2: identical trees, predictions within 1e-5. Leaf values
    agree to 1e-4, not exactly: the reference's CPU program computes the
    pre-rounding factor as exp(k * ln 2), which is not exactly 2**k, so a few
    l2 gradients land on the neighbouring grid point (the port rounds on the
    exact power-of-two grid the reference intends)."""
    x, _, y = _data(1)
    ref = RefTable({"features": x, "label": y}).ml_fit(RefRegressor(**PARAMS))
    port = Table({"features": x, "label": y}).ml_fit(LightGBMRegressor(device="cpu",
                                                                       **PARAMS))
    _assert_same_trees(ref.booster, port.booster, leaf_atol=1e-4)
    np.testing.assert_allclose(port.transform(Table({"features": x}))["prediction"],
                               ref.transform(RefTable({"features": x}))["prediction"],
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_reference_weights_carried_across(kind):
    """A booster trained by the JAX package scores the same through the port:
    its state_dict -> convert -> port transform, within 1e-6."""
    x, y_cls, y_reg = _data(2)
    if kind == "classifier":
        ref = RefTable({"features": x, "label": y_cls}).ml_fit(RefClassifier(**PARAMS))
        model = model_from_state(ref.booster.state_dict(), labels=ref.labels, device="cpu")
        cols = ("rawPrediction", "probability", "prediction")
    else:
        ref = RefTable({"features": x, "label": y_reg}).ml_fit(RefRegressor(**PARAMS))
        model = model_from_state(ref.booster.state_dict(), device="cpu")
        cols = ("prediction",)
    ro = ref.transform(RefTable({"features": x}))
    po = model.transform(Table({"features": x}))
    for col in cols:
        np.testing.assert_allclose(po[col], ro[col], rtol=0, atol=1e-6, err_msg=col)


def test_save_load_round_trip_and_separate_registries(tmp_path):
    x, y, _ = _data(4, n=1000)
    model = LightGBMClassifier(device="cpu", num_iterations=3, num_leaves=7,
                               max_bin=31).fit(Table({"features": x, "label": y}))
    path = str(tmp_path / "model")
    model.save(path)
    loaded = load_stage(path)
    assert type(loaded) is type(model)
    a = model.transform(Table({"features": x}))
    b = loaded.transform(Table({"features": x}))
    for col in ("rawPrediction", "probability", "prediction"):
        np.testing.assert_array_equal(a[col], b[col])
    # the two packages keep separate stage registries: no port class is
    # registered (or shadowing) in the reference's
    assert "LightGBMClassifier" in STAGE_REGISTRY
    assert STAGE_REGISTRY["LightGBMClassifier"] is LightGBMClassifier
    assert REF_REGISTRY["LightGBMClassifier"] is RefClassifier
    assert not [c for c in REF_REGISTRY.values()
                if c.__module__.startswith("synapseml_tpu_torch")]
    assert not [m for mods in REF_COLLISIONS.values() for m in mods
                if m.startswith("synapseml_tpu_torch")]


def test_device_rule_and_unported_params():
    if torch.cuda.is_available():
        pytest.skip("checks the no-card error; a card is visible")
    with pytest.raises(DeviceUnavailableError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    x, y, _ = _data(5, n=200)
    with pytest.raises(DeviceUnavailableError):
        LightGBMClassifier(num_iterations=1).fit(Table({"features": x, "label": y}))
    with pytest.raises(ValueError, match="boosting must be"):
        train({"boosting": "gbrt"}, x, y, device="cpu")
    # lambdarank is ported: without query groups it is the reference's ValueError
    with pytest.raises(ValueError, match="requires group"):
        train({"objective": "lambdarank"}, x, y, device="cpu")
