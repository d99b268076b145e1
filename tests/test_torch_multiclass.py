"""Port parity, multiclass and the pointwise objectives: training, leaf
renewal, the classifier stage over 3+ labels with categorical slots, and
carried-across multiclass boosters against the JAX package on the same numpy
inputs, on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapseml_tpu import Table as RefTable
from synapseml_tpu.gbdt import LightGBMClassifier as RefClassifier
from synapseml_tpu.gbdt import LightGBMRegressor as RefRegressor
from synapseml_tpu.gbdt.boost import _renewed_leaf_values as ref_renewed_leaf_values
from synapseml_tpu.gbdt.boost import train as ref_train
from synapseml_tpu_torch.core import Table, load_stage
from synapseml_tpu_torch.gbdt.boost import OBJECTIVES, _renewed_leaf_values, train
from synapseml_tpu_torch.gbdt.convert import model_from_state
from synapseml_tpu_torch.gbdt.estimators import LightGBMClassifier, LightGBMRegressor

PARAMS = dict(num_iterations=5, num_leaves=15, max_bin=63)
# predictions: exp/softmax may differ by an ulp between the frameworks
PRED_ATOL = 1e-5
# Leaf values within 1e-6 of the reference's, except where its compiled CPU
# program rounds a gradient differently, so that after pre-rounding a few
# gradients land on the neighbouring grid point (trees stay identical;
# ROADMAP queue 3): l2 (exp2 in the rounding factor), multiclass
# (XLA's exp against torch.exp) and tweedie (XLA contracts -y*e1 + e2 into
# an FMA). With the reference's exp and FMA put into the port, those leaves
# are bit-equal.
LEAF_ATOL = {"mean_squared_error": 1e-4, "multiclass": 1e-4, "tweedie": 1e-4}


def _data(seed=0, n=3000, d=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, 1] = rng.integers(0, 12, size=n)
    effect = rng.normal(size=12)
    z = effect[x[:, 1].astype(int)] + x[:, 0]
    noise = 0.3 * rng.normal(size=n)
    return x, z, noise, rng


def _assert_same_trees(ref, port):
    leaf_atol = LEAF_ATOL.get(ref.objective, 1e-6)
    for field in ("parent", "feature", "bin"):
        np.testing.assert_array_equal(getattr(port, field), getattr(ref, field),
                                      err_msg=field)
    if ref.cat_set is not None:
        np.testing.assert_array_equal(port.cat_set, ref.cat_set)
    np.testing.assert_allclose(port.base_score, ref.base_score)
    np.testing.assert_allclose(port.leaf_value, ref.leaf_value, rtol=0, atol=leaf_atol)


@pytest.mark.parametrize("num_class", [3, 7])
def test_train_multiclass_matches_reference(num_class):
    """C trees an iteration, one per class: identical trees, probabilities
    within PRED_ATOL."""
    x, z, noise, _ = _data(num_class)
    y = np.digitize(z + noise, np.linspace(-1.5, 1.5, num_class - 1)).astype(np.float64)
    params = dict(PARAMS, objective="multiclass", num_class=num_class,
                  categorical_feature=[1] if num_class == 3 else None)
    ref = ref_train(params, x, y)
    port = train(params, x, y, device="cpu")
    assert port.num_class == num_class and port.parent.shape == (5, num_class, 14)
    _assert_same_trees(ref, port)
    prob = port.predict(x, device="cpu")
    assert prob.shape == (len(x), num_class)
    np.testing.assert_allclose(prob.sum(1), 1.0, rtol=1e-12)
    np.testing.assert_allclose(prob, ref.predict(x), rtol=0, atol=PRED_ATOL)
    np.testing.assert_array_equal(port.predict_leaf(x, device="cpu"), ref.predict_leaf(x))


@pytest.mark.parametrize("objective,extra", [
    ("l1", {}), ("mae", {}), ("huber", {"alpha": 0.5}), ("quantile", {"alpha": 0.3}),
    ("poisson", {}), ("tweedie", {"tweedie_variance_power": 1.3}),
    ("mean_squared_error", {}), ("l1", {"max_bin_by_feature": [0, 100, 0, 0, 8, 0]})])
def test_train_pointwise_objective_matches_reference(objective, extra):
    """Identical trees; l1 and quantile renew their leaves as residual
    percentiles, poisson and tweedie predict exp(raw)."""
    x, z, noise, rng = _data(1)
    if objective in ("poisson", "tweedie"):
        y = np.exp(0.3 * z) * rng.poisson(2, size=len(z))
    else:
        y = z + noise
    params = dict(PARAMS, objective=objective, **extra)
    ref = ref_train(params, x, y)
    port = train(params, x, y, device="cpu")
    _assert_same_trees(ref, port)
    np.testing.assert_allclose(port.predict(x, device="cpu"), ref.predict(x), rtol=0,
                               atol=PRED_ATOL * max(1.0, float(np.abs(y).max())))


def test_renewed_leaf_values_match_reference():
    rng = np.random.default_rng(3)
    n, L = 2000, 9
    node = rng.integers(0, L - 1, size=n).astype(np.int32)      # leaf L-1 stays empty
    y = rng.normal(size=n).astype(np.float32)
    raw = rng.normal(size=n).astype(np.float32)
    w = rng.integers(1, 4, size=n).astype(np.float32)
    for alpha in (0.5, 0.1, 0.9):
        want = ref_renewed_leaf_values(jnp.asarray(node), jnp.asarray(y), jnp.asarray(raw),
                                       jnp.asarray(w), alpha, L)
        got = _renewed_leaf_values(*(torch.from_numpy(a) for a in (node, y, raw, w)),
                                   alpha, L)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got[L - 1] == 0.0


def test_objective_table_and_unported():
    assert {"l1", "mae", "huber", "poisson", "quantile", "tweedie", "multiclass",
            "softmax", "mean_squared_error"} <= set(OBJECTIVES)
    x, z, noise, _ = _data(2, n=300)
    with pytest.raises(NotImplementedError, match="not ported"):
        train(dict(PARAMS, objective="cross_entropy"), x, z, device="cpu")
    # lambdarank trains now; without query groups it is the reference's ValueError
    with pytest.raises(ValueError, match="requires group"):
        train(dict(PARAMS, objective="lambdarank"), x, z, device="cpu")
    # sampling, dart and early stopping train now (without an eval set,
    # early stopping has nothing to watch: every iteration is kept)
    for ported in ({"bagging_fraction": 0.5, "bagging_freq": 1}, {"boosting": "dart"},
                   {"feature_fraction": 0.5}, {"early_stopping_round": 5}):
        booster = train(dict(PARAMS, **ported), x, z, device="cpu")
        assert booster.num_trees == PARAMS["num_iterations"]
        assert booster.best_iteration is None


def _slot_table(table_cls, x, y=None):
    cols = {"features": x} if y is None else {"features": x, "label": y}
    return table_cls(cols, meta={"features": {"slot_names": [f"s{i}" for i in
                                                              range(x.shape[1])]}})


@pytest.fixture(scope="module")
def fitted_classifiers():
    """Reference and port classifiers over four string labels, with column 1
    categorical by slot name."""
    x, z, noise, _ = _data(4)
    labels = np.array(["ant", "bee", "cat", "dog"])
    y = labels[np.digitize(z + noise, [-0.8, 0.0, 0.8])]
    kw = dict(PARAMS, categorical_slot_names=["s1"], cat_smooth=5.0, max_cat_threshold=8)
    ref = _slot_table(RefTable, x, y).ml_fit(RefClassifier(**kw))
    port = _slot_table(Table, x, y).ml_fit(LightGBMClassifier(device="cpu", **kw))
    return x, ref, port


def test_classifier_multiclass_categorical_matches_reference(fitted_classifiers, tmp_path):
    """3+ labels -> multiclass with num_class set; fit -> transform -> save ->
    load, against the reference stage."""
    x, ref, port = fitted_classifiers
    assert port.booster.objective == "multiclass" and port.booster.num_class == 4
    _assert_same_trees(ref.booster, port.booster)
    assert (port.booster.bin < 0).any()
    ro = ref.transform(RefTable({"features": x}))
    po = port.transform(Table({"features": x}))
    for col in ("rawPrediction", "probability"):
        assert po[col].shape == (len(x), 4)
        np.testing.assert_allclose(po[col], ro[col], rtol=0, atol=PRED_ATOL, err_msg=col)
    np.testing.assert_array_equal(po["prediction"], ro["prediction"])
    path = str(tmp_path / "model")
    port.save(path)
    loaded = load_stage(path)
    lo = loaded.transform(Table({"features": x}))
    for col in ("rawPrediction", "probability", "prediction"):
        np.testing.assert_array_equal(lo[col], po[col])


def test_reference_multiclass_model_carried_across(fitted_classifiers):
    x, ref, _ = fitted_classifiers
    model = model_from_state(ref.booster.state_dict(), labels=ref.labels, device="cpu")
    ro = ref.transform(RefTable({"features": x}))
    mo = model.transform(Table({"features": x}))
    for col in ("rawPrediction", "probability"):
        np.testing.assert_allclose(mo[col], ro[col], rtol=0, atol=1e-6, err_msg=col)
    np.testing.assert_array_equal(mo["prediction"], ro["prediction"])


def test_slot_names_need_metadata_and_one_label_fails():
    x, z, noise, _ = _data(5, n=300)
    y = (z > 0).astype(float)
    with pytest.raises(ValueError, match="slot_names"):
        LightGBMClassifier(device="cpu", num_iterations=1, categorical_slot_names=["s1"]
                           ).fit(Table({"features": x, "label": y}))
    with pytest.raises(ValueError, match="2 classes"):
        LightGBMClassifier(device="cpu", num_iterations=1).fit(
            Table({"features": x, "label": np.zeros(len(x))}))


@pytest.mark.parametrize("objective", ["quantile", "tweedie"])
def test_regressor_objective_params_match_reference(objective):
    x, z, noise, rng = _data(6, n=2000)
    y = z + noise if objective == "quantile" else np.exp(0.2 * z) * rng.poisson(2, len(z))
    kw = dict(PARAMS, objective=objective, alpha=0.2, tweedie_variance_power=1.7,
              categorical_slot_indexes=[1])
    ref = RefTable({"features": x, "label": y}).ml_fit(RefRegressor(**kw))
    port = Table({"features": x, "label": y}).ml_fit(LightGBMRegressor(device="cpu", **kw))
    _assert_same_trees(ref.booster, port.booster)
    np.testing.assert_allclose(port.transform(Table({"features": x}))["prediction"],
                               ref.transform(RefTable({"features": x}))["prediction"],
                               rtol=0, atol=PRED_ATOL * max(1.0, float(np.abs(y).max())))
