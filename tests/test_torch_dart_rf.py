"""Port parity: DART and random-forest boosting, and dart / goss / rf models
carried across, against the JAX package on the same numpy inputs, on the
CPU.

DART's drops come from the same numpy generator as the reference's, and
its margins keep the reference's f32 roundings, so trees and tree scales
are identical. The reference's defaults (``skip_drop=0.5``,
``drop_rate=0.1``) drop no tree in a few iterations, so the DART fixture
sets ``skip_drop=0`` and ``drop_rate=0.5``.
"""

import numpy as np
import pytest

from synapseml_tpu import Table as RefTable
from synapseml_tpu.gbdt import LightGBMClassifier as RefClassifier
from synapseml_tpu.gbdt import LightGBMRegressor as RefRegressor
from synapseml_tpu.gbdt.boost import train as ref_train
from synapseml_tpu_torch.core import Table
from synapseml_tpu_torch.gbdt.boost import GBDTBooster, train
from synapseml_tpu_torch.gbdt.convert import booster_from_state, model_from_state
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(num_iterations=5, num_leaves=15, max_bin=63)
DART = dict(boosting="dart", skip_drop=0.0, drop_rate=0.5, num_iterations=8)
RF = dict(boosting="rf", bagging_fraction=0.7, bagging_freq=1)
BOOSTING = {"gbdt": {}, "goss": dict(boosting="goss"), "dart": DART, "rf": RF}


def _data(seed=0, n=3000, d=8):
    """The fixture of ``tests/test_torch_gbdt.py::_data``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y_cls = (x[:, 0] + 0.4 * x[:, 5] + 0.2 * rng.normal(size=n) > 0).astype(np.float64)
    y_reg = 2 * x[:, 0] + np.sin(x[:, 1]) + 0.1 * rng.normal(size=n)
    return x, y_cls, y_reg


def _assert_same(ref, port, leaf_atol=0.0):
    assert port.boosting == ref.boosting
    for field in ("parent", "feature", "bin"):
        np.testing.assert_array_equal(getattr(port, field), getattr(ref, field),
                                      err_msg=field)
    np.testing.assert_allclose(port.leaf_value, ref.leaf_value, rtol=0, atol=leaf_atol)
    np.testing.assert_allclose(port.tree_scale, ref.tree_scale, rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", ["weighted", "uniform_drop", "xgboost_dart_mode"])
def test_dart_matches_reference(mode):
    """Drops happen (some tree keeps less than lr of weight), and trees,
    leaves, scales and margins equal the reference's."""
    x, y, _ = _data()
    extra = {"uniform_drop": True} if mode == "uniform_drop" else (
        {"xgboost_dart_mode": True} if mode == "xgboost_dart_mode" else {})
    params = dict(PARAMS, objective="binary", **DART, **extra)
    ref = ref_train(params, x, y)
    port = train(params, x, y, device="cpu")
    _assert_same(ref, port)
    assert (port.tree_scale < 0.1 - 1e-9).any(), "no tree was dropped"
    np.testing.assert_allclose(port.raw_predict(x, device="cpu"), ref.raw_predict(x),
                               rtol=0, atol=1e-6)


def test_dart_regression_with_bagging_matches_reference():
    x, _, y = _data(1)
    params = dict(PARAMS, objective="regression", bagging_fraction=0.6, bagging_freq=1,
                  **DART)
    _assert_same(ref_train(params, x, y), train(params, x, y, device="cpu"),
                 leaf_atol=1e-4)  # l2's exp2 pre-rounding factor (ROADMAP queue 3)


@pytest.mark.parametrize("bagging", ["plain", "class_aware"])
def test_rf_matches_reference(bagging):
    """rf: learning rate 1, margins left at the base score, every tree's
    scale 1, scores averaged over the trees."""
    x, y, _ = _data(2)
    params = dict(PARAMS, objective="binary", **RF)
    if bagging == "class_aware":
        params.update(bagging_fraction=1.0, pos_bagging_fraction=0.6,
                      neg_bagging_fraction=0.8)
    ref = ref_train(params, x, y)
    port = train(params, x, y, device="cpu")
    _assert_same(ref, port)
    np.testing.assert_array_equal(port.tree_scale, np.ones(PARAMS["num_iterations"]))
    raw = port.raw_predict(x, device="cpu")
    np.testing.assert_allclose(raw, ref.raw_predict(x), rtol=0, atol=1e-6)
    # a model cut at 2 trees averages those 2
    np.testing.assert_allclose(port.raw_predict(x, num_iteration=2, device="cpu"),
                               ref.raw_predict(x, num_iteration=2), rtol=0, atol=1e-6)


@pytest.mark.parametrize("boosting", sorted(BOOSTING))
def test_models_carried_across_per_boosting(boosting):
    """A reference model of each boosting type scores the same through the
    port (state_dict -> convert -> transform), within 1e-6, and keeps its
    boosting type through the port's own state_dict."""
    x, y_cls, y_reg = _data(3)
    params = dict(PARAMS, **BOOSTING[boosting])
    if boosting == "rf":
        ref = RefTable({"features": x, "label": y_reg}).ml_fit(RefRegressor(
            boosting_type="rf", bagging_fraction=0.7, bagging_freq=1, **PARAMS))
        model = model_from_state(ref.booster.state_dict(), device="cpu")
        cols = ("prediction",)
    else:
        est = RefClassifier(boosting_type=params.pop("boosting", "gbdt"), **params)
        ref = RefTable({"features": x, "label": y_cls}).ml_fit(est)
        model = model_from_state(ref.booster.state_dict(), labels=ref.labels, device="cpu")
        cols = ("rawPrediction", "probability", "prediction")
    assert model.booster.boosting == ref.booster.boosting == boosting
    ro = ref.transform(RefTable({"features": x}))
    po = model.transform(Table({"features": x}))
    for col in cols:
        np.testing.assert_allclose(po[col], ro[col], rtol=0, atol=1e-6, err_msg=col)
    again = GBDTBooster.from_state_dict(model.booster.state_dict())
    assert again.boosting == boosting
    np.testing.assert_array_equal(again.raw_predict(x, device="cpu"),
                                  model.booster.raw_predict(x, device="cpu"))


def test_unported_boosting_state_refused():
    x, y, _ = _data(4, n=300)
    state = ref_train(dict(PARAMS, num_iterations=1), x, y).state_dict()
    state["boosting"] = "lambdarank-dart"
    with pytest.raises(NotImplementedError, match="boosting"):
        booster_from_state(state)


@pytest.mark.parametrize("boosting", ["goss", "dart", "rf"])
def test_multiclass_boosting_matches_reference(boosting):
    """Four classes: one bag, GOSS sample (on |g| summed over the classes)
    and drop set per iteration, shared by the C trees."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3000, 8)).astype(np.float32)
    y = np.digitize(x[:, 0] + 0.5 * x[:, 3] + 0.3 * rng.normal(size=3000),
                    [-0.7, 0.0, 0.7]).astype(np.float64)
    params = dict(PARAMS, objective="multiclass", num_class=4, **BOOSTING[boosting])
    if boosting == "dart":
        params["num_iterations"] = 6
    ref = ref_train(params, x, y)
    port = train(params, x, y, device="cpu")
    assert port.parent.shape[:2] == (params["num_iterations"], 4)
    _assert_same(ref, port)
