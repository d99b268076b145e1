"""Port parity: the booster's model surface against the JAX package on the
same numpy inputs, on the CPU: TreeSHAP and Saabas contributions, feature
importance, LightGBM text models both ways, the JSON model string, and the
stages' ``features_shap_col``, ``save_native_model`` / ``load_native_model``,
``get_feature_importances`` and ``init_score_col``.

The boosters compared are the same trees (a reference booster carried
across with ``booster_from_state``, or one LightGBM text read by both), so
contributions agree to 1e-9 (f64 sums in the same order) and model texts
byte for byte. Saabas departs from the reference in two places, each
checked here (ROADMAP queue 3): ``bin < 0`` splits route by set
membership, and the categorical refusal looks at the used trees only.
"""

import numpy as np
import pytest
import torch

from synapseml_tpu import Table as RefTable
from synapseml_tpu.gbdt import GBDTBooster as RefBooster
from synapseml_tpu.gbdt import LightGBMClassifier as RefClassifier
from synapseml_tpu.gbdt.boost import train as ref_train
from synapseml_tpu_torch.core import ColumnSpec, Table, TableSchema
from synapseml_tpu_torch.gbdt.boost import GBDTBooster, train
from synapseml_tpu_torch.gbdt.convert import booster_from_state
from synapseml_tpu_torch.gbdt.estimators import (LightGBMClassificationModel,
                                                 LightGBMClassifier, LightGBMRanker,
                                                 LightGBMRankerModel, LightGBMRegressionModel,
                                                 LightGBMRegressor)
from synapseml_tpu_torch.tools.kernel_cases import (TWO_TREES, many_thresholds_rows,
                                                    many_thresholds_text, native_texts,
                                                    one_split_text)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

KZERO = 1e-35


def _data(seed=3, n=3000, d=6):
    """The fixture of ``tests/test_native_model.py``, plus a categorical column."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = (x[:, 0] - 0.8 * x[:, 2] > 0).astype(float)
    yr = x[:, 0] * 2 + x[:, 1]
    return x, y, yr


_MODELS = {
    "binary": dict(objective="binary", num_iterations=8),
    "regression": dict(objective="regression", num_iterations=6),
    "multiclass": dict(objective="multiclass", num_class=3, num_iterations=5),
    "categorical": dict(objective="binary", num_iterations=6, categorical_feature=[1],
                        min_data_in_leaf=5),
    "rf": dict(objective="binary", boosting="rf", num_iterations=5, bagging_fraction=0.6,
               bagging_freq=1),
    "dart": dict(objective="binary", boosting="dart", num_iterations=6, drop_rate=0.4,
                 skip_drop=0.0),
}


def _model(kind):
    """(reference booster, the port's booster of the same trees, rows)."""
    x, y, yr = _data()
    params = dict(num_leaves=15, max_bin=63, **_MODELS[kind])
    if kind == "multiclass":
        target = np.digitize(x[:, 0], [-0.5, 0.5]).astype(float)
    elif kind == "regression":
        target = yr
    elif kind == "categorical":
        x = x.copy()
        x[:, 1] = np.random.default_rng(0).integers(0, 6, len(x))
        target = ((x[:, 1] % 2 == 0) ^ (x[:, 0] > 0)).astype(float)
    else:
        target = y
    ref = ref_train(params, x, target)
    return ref, booster_from_state(ref.state_dict()), x


@pytest.mark.parametrize("kind", ["binary", "regression", "multiclass", "categorical", "rf"])
def test_predict_contrib_exact_matches_reference(kind):
    ref, port, x = _model(kind)
    probe = x[:400]
    got = port.predict_contrib(probe, device="cpu")
    np.testing.assert_allclose(got, ref.predict_contrib(probe), rtol=0, atol=1e-9)
    raw = port.raw_predict(probe, device="cpu")
    np.testing.assert_allclose(got.sum(axis=-1).T if got.ndim == 3 else got.sum(axis=1),
                               raw, rtol=0, atol=1e-5)  # additivity against f32 margins
    np.testing.assert_allclose(port.predict_contrib(probe, num_iteration=2, device="cpu"),
                               ref.predict_contrib(probe, num_iteration=2), rtol=0, atol=1e-9)


@pytest.mark.parametrize("kind", ["binary", "regression", "multiclass", "rf"])
def test_predict_contrib_saabas_matches_reference_on_numeric_models(kind):
    ref, port, x = _model(kind)
    probe = x[:400].copy()
    probe[::7, 2] = np.nan
    np.testing.assert_allclose(port.predict_contrib(probe, approximate=True, device="cpu"),
                               ref.predict_contrib(probe, approximate=True), rtol=0, atol=1e-9)


def test_saabas_routes_set_splits_by_membership():
    """A zero_as_missing split (default right, threshold 1.0): zeros and NaN
    go right. The port's Saabas follows the set, as the exact path and the
    scores do, so contributions add up to the margin; the reference's
    threshold compare sends them left (its caveat, ADVICE.md)."""
    text = one_split_text(4, 1.0)
    port, ref = GBDTBooster.from_native_model(text), RefBooster.from_native_model(text)
    x = np.array([[-2.0], [0.0], [5e-36], [0.5], [2.0], [np.nan]])
    raw = port.raw_predict(x, device="cpu")
    np.testing.assert_array_equal(raw, ref.raw_predict(x))
    np.testing.assert_array_equal(raw, [-1, 1, 1, -1, 1, 1])
    saabas = port.predict_contrib(x, approximate=True, device="cpu")
    np.testing.assert_allclose(saabas.sum(axis=1), raw, rtol=0, atol=1e-12)
    np.testing.assert_allclose(port.predict_contrib(x, device="cpu").sum(axis=1), raw,
                               rtol=0, atol=1e-12)
    ref_sum = ref.predict_contrib(x, approximate=True).sum(axis=1)
    assert not np.allclose(ref_sum, raw)  # the reference loses additivity here
    # default_left set splits (NaN left) agree with the reference
    text = one_split_text(10, 0.25)
    port, ref = GBDTBooster.from_native_model(text), RefBooster.from_native_model(text)
    np.testing.assert_allclose(port.predict_contrib(x, approximate=True, device="cpu"),
                               ref.predict_contrib(x, approximate=True), rtol=0, atol=1e-12)


def test_saabas_categorical_refusal_scoped_to_used_trees():
    """Tree 1 holds a categorical split: with num_iteration=1 the port walks
    tree 0 only and adds up; the reference refuses (ADVICE.md). Over both
    trees both refuse."""
    port, ref = (GBDTBooster.from_native_model(TWO_TREES),
                 RefBooster.from_native_model(TWO_TREES))
    x = np.array([[0.0, 0.0], [1.0, 2.0], [0.7, 3.0], [np.nan, 1.0]])
    got = port.predict_contrib(x, num_iteration=1, approximate=True, device="cpu")
    np.testing.assert_allclose(got.sum(axis=1), port.raw_predict(x, num_iteration=1,
                                                                 device="cpu"), atol=1e-12)
    with pytest.raises(ValueError, match="categorical"):
        ref.predict_contrib(x, num_iteration=1, approximate=True)
    for b in (port, ref):
        with pytest.raises(ValueError, match="categorical"):
            b.predict_contrib(x, approximate=True, **({"device": "cpu"} if b is port else {}))
    np.testing.assert_allclose(port.predict_contrib(x, device="cpu"), ref.predict_contrib(x),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["binary", "multiclass", "categorical"])
@pytest.mark.parametrize("importance_type", ["split", "gain"])
def test_feature_importance_matches_reference(kind, importance_type):
    ref, port, _ = _model(kind)
    for it in (None, 2):
        np.testing.assert_array_equal(port.feature_importance(importance_type, it),
                                      ref.feature_importance(importance_type, it))
    with pytest.raises(ValueError, match="importance_type"):
        port.feature_importance("cover")


@pytest.mark.parametrize("kind", sorted(_MODELS))
def test_native_text_and_json_match_reference(kind):
    """The LightGBM text of the same trees is the reference's byte for byte,
    and so is the JSON model string; each package reads the other's."""
    ref, port, x = _model(kind)
    text = port.save_native_model()
    assert text == ref.save_native_model()
    assert port.to_json() == ref.to_json()
    probe = x[:300]
    back = GBDTBooster.from_native_model(text)
    np.testing.assert_allclose(back.raw_predict(probe, device="cpu"),
                               RefBooster.from_native_model(text).raw_predict(probe),
                               rtol=0, atol=1e-6)
    for s in (port.to_json(), text):
        again = GBDTBooster.from_model_string(s)
        np.testing.assert_allclose(again.raw_predict(probe, device="cpu"),
                                   port.raw_predict(probe, device="cpu"), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(RefBooster.from_json(port.to_json()).raw_predict(probe),
                                  ref.raw_predict(probe))
    with pytest.raises(ValueError, match="format"):
        GBDTBooster.from_json('{"format": "other"}')


_PROBES = np.array([-2.0, -1.0, -0.2, 0.0, 5e-36, -5e-36, KZERO, -KZERO, 2e-35, -2e-35,
                    0.25, 1.0, 1.5, 2.0, 3.0, 7.0, 9.9, np.nan])


@pytest.mark.parametrize("name", sorted(native_texts()))
def test_import_handwritten_text_scores_as_reference(name):
    text = native_texts()[name]
    port, ref = GBDTBooster.from_native_model(text), RefBooster.from_native_model(text)
    d = port.mapper.n_features
    grid = np.stack(np.meshgrid(*([_PROBES] * d), indexing="ij"), -1).reshape(-1, d)
    for field in ("parent", "feature", "threshold", "bin", "leaf_value", "cat_set"):
        a, b = getattr(port, field), getattr(ref, field)
        assert (a is None and b is None) or np.array_equal(a, b, equal_nan=True), field
    for e_port, e_ref in zip(port.mapper.upper_edges, ref.mapper.upper_edges):
        np.testing.assert_array_equal(e_port, e_ref)
    np.testing.assert_array_equal(port.raw_predict(grid, device="cpu"),
                                  ref.raw_predict(grid, backend="host"))
    assert port.feature_names == ref.feature_names and port.boosting == ref.boosting


def test_import_randomized_differential():
    """Random pointer trees over every missing_type x default_left
    combination, as in ``tests/test_native_model.py``: the port's import
    scores as an independent interpreter of LightGBM's decisions and as the
    reference's import."""
    rng = np.random.default_rng(123)

    def ref_predict(tree, row):
        node = 0
        while True:
            f = tree["split_feature"][node]
            t = tree["threshold"][node]
            dt = tree["decision_type"][node]
            mt = dt & (3 << 2)
            v = row[f]
            if mt != (2 << 2) and np.isnan(v):
                v = 0.0
            if mt == (2 << 2) and np.isnan(v):
                go_left = bool(dt & 2)
            elif mt == (1 << 2) and abs(v) <= KZERO:
                go_left = bool(dt & 2)
            else:
                go_left = v <= t
            child = tree["left_child"][node] if go_left else tree["right_child"][node]
            if child < 0:
                return tree["leaf_value"][~child]
            node = child

    for trial in range(20):
        d = int(rng.integers(2, 5))
        n_splits = int(rng.integers(1, 6))
        split_feature, threshold, decision_type, left_child, right_child = [], [], [], [], []
        for s in range(n_splits):
            split_feature.append(int(rng.integers(0, d)))
            threshold.append(float(np.round(rng.normal(), 3) if rng.random() < 0.8
                                   else rng.choice([-KZERO, KZERO, 0.0])))
            decision_type.append(int(rng.choice([0, 1 << 2, 2 << 2])) | int(rng.choice([0, 2])))
            left_child.append(-1)
            right_child.append(-1)
        open_slots = [(0, "l"), (0, "r")]
        for s in range(1, n_splits):
            node, side = open_slots.pop(int(rng.integers(len(open_slots))))
            (left_child if side == "l" else right_child)[node] = s
            open_slots += [(s, "l"), (s, "r")]
        nl = 0
        for node, side in open_slots:
            (left_child if side == "l" else right_child)[node] = ~nl
            nl += 1
        leaf_value = [float(np.round(rng.normal(), 3)) for _ in range(nl)]
        tree = dict(split_feature=split_feature, threshold=threshold,
                    decision_type=decision_type, left_child=left_child,
                    right_child=right_child, leaf_value=leaf_value)
        text = "\n".join([
            "tree", "num_class=1", "num_tree_per_iteration=1", f"max_feature_idx={d - 1}",
            "objective=regression", "", "Tree=0", f"num_leaves={nl}", "num_cat=0",
            "split_feature=" + " ".join(map(str, split_feature)),
            "split_gain=" + " ".join(["1"] * n_splits),
            "threshold=" + " ".join(repr(t) for t in threshold),
            "decision_type=" + " ".join(map(str, decision_type)),
            "left_child=" + " ".join(map(str, left_child)),
            "right_child=" + " ".join(map(str, right_child)),
            "leaf_value=" + " ".join(repr(v) for v in leaf_value),
            "leaf_weight=" + " ".join(["1"] * nl), "", "end of trees", ""])
        port = GBDTBooster.from_native_model(text)
        probes = np.concatenate([rng.normal(size=(30, d)), np.zeros((2, d)),
                                 np.full((1, d), KZERO), np.full((1, d), -KZERO),
                                 np.full((1, d), 5e-36), np.full((1, d), 2e-35),
                                 np.full((1, d), np.nan)])
        got = port.raw_predict(probes, device="cpu")
        want = np.array([ref_predict(tree, row) for row in probes])
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=f"trial {trial}: {tree}")
        np.testing.assert_array_equal(
            got, RefBooster.from_native_model(text).raw_predict(probes, backend="host"))
        np.testing.assert_allclose(port.predict_contrib(probes, device="cpu").sum(axis=1), got,
                                   atol=1e-6)


@pytest.mark.parametrize("n_thr,zero_split", [(3000, True), (33000, False)])
def test_import_many_thresholds_scores_as_reference(n_thr, zero_split):
    """Thousands of thresholds on one feature: kernel D's table and the bins'
    width (int16, then int32 past 32,767 bins) on the port's binning path;
    scores equal the reference's host replay."""
    text = many_thresholds_text(n_thr, zero_split=zero_split)
    port, ref = GBDTBooster.from_native_model(text), RefBooster.from_native_model(text)
    x = many_thresholds_rows(port, 1000)
    assert port.mapper.device_binnable(torch.from_numpy(x))
    np.testing.assert_array_equal(port.predict_leaf(x, device="cpu"),
                                  ref.predict_leaf(x.astype(np.float64), backend="host"))
    # the port sums trees in f32 (kernel B's order), the reference's host loop in f64
    np.testing.assert_allclose(port.raw_predict(x, device="cpu"),
                               ref.raw_predict(x.astype(np.float64), backend="host"),
                               rtol=0, atol=1e-6)


# -- the stages ------------------------------------------------------------------------

def _stage_data():
    x, y, yr = _data()
    return x.astype(np.float32), y, yr


def test_classifier_features_shap_col_matches_reference():
    x, y, _ = _stage_data()
    params = dict(num_iterations=5, num_leaves=15, max_bin=63, features_shap_col="shap")
    port = LightGBMClassifier(device="cpu", **params).fit(Table({"features": x, "label": y}))
    ref = RefClassifier(**params).fit(RefTable({"features": x, "label": y}))
    probe = {"features": x[:300]}
    out = port.transform(Table(probe))
    shap = np.asarray(out["shap"])
    assert shap.shape == (300, x.shape[1] + 1)
    np.testing.assert_allclose(shap, np.asarray(ref.transform(RefTable(probe))["shap"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(shap.sum(axis=1), np.asarray(out["rawPrediction"])[:, 1],
                               rtol=0, atol=1e-5)
    schema = port.transform_schema(TableSchema.from_table(Table(probe)))
    assert schema["shap"] == ColumnSpec("any", "any")


def test_multiclass_shap_is_flattened_class_major():
    x, _, _ = _stage_data()
    y = np.digitize(x[:, 0], [-0.5, 0.5]).astype(float)
    m = LightGBMClassifier(device="cpu", num_iterations=3, num_leaves=7, max_bin=31,
                           features_shap_col="shap").fit(Table({"features": x, "label": y}))
    probe = x[:50]
    shap = np.asarray(m.transform(Table({"features": probe}))["shap"])
    d = x.shape[1] + 1
    per_class = m.booster.predict_contrib(probe, device="cpu")
    assert shap.shape == (50, 3 * d)
    for c in range(3):
        np.testing.assert_array_equal(shap[:, c * d:(c + 1) * d], per_class[c])


@pytest.mark.parametrize("fmt", ["lightgbm", "json"])
def test_stage_save_load_native_model(tmp_path, fmt):
    x, y, yr = _stage_data()
    path = str(tmp_path / "model.txt")
    for est, cls, col in ((LightGBMClassifier, LightGBMClassificationModel, "probability"),
                          (LightGBMRegressor, LightGBMRegressionModel, "prediction")):
        m = est(device="cpu", num_iterations=4, max_bin=63).fit(
            Table({"features": x, "label": y if est is LightGBMClassifier else yr}))
        m.save_native_model(path, fmt=fmt)
        head = open(path).read()[:5]
        assert head == ("tree\n" if fmt == "lightgbm" else '{"for')
        back = cls.load_native_model(path, device="cpu")
        t = Table({"features": x[:200]})
        np.testing.assert_allclose(np.asarray(back.transform(t)[col]),
                                   np.asarray(m.transform(t)[col]), rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(m.get_feature_importances("gain"),
                                      m.booster.feature_importance("gain"))
    with pytest.raises(ValueError, match="fmt"):
        m.save_native_model(path, fmt="onnx")


def test_init_score_col_admitted_not_read():
    """The reference admits init_score_col in the input schema and trains as
    without it; so does the port."""
    x, y, _ = _stage_data()
    for est in (LightGBMClassifier, LightGBMRegressor, LightGBMRanker):
        spec = est(init_score_col="init").input_schema()
        assert spec["init"] == ColumnSpec("float", "any")
        assert "init" not in est().input_schema()
    cols = {"features": x, "label": y}
    plain = LightGBMClassifier(device="cpu", num_iterations=3, max_bin=31).fit(Table(cols))
    with_col = LightGBMClassifier(device="cpu", num_iterations=3, max_bin=31,
                                  init_score_col="init").fit(
        Table(dict(cols, init=np.full(len(y), 5.0))))
    np.testing.assert_array_equal(with_col.booster.leaf_value, plain.booster.leaf_value)


def test_ranker_model_surface():
    from synapseml_tpu_torch.tools.schema_data import mslr_rows

    x, y, sizes = mslr_rows(1, 30, 600)
    m = LightGBMRanker(device="cpu", num_iterations=3, num_leaves=7, max_bin=31,
                       features_shap_col="shap").fit(
        Table({"features": x, "label": y, "group": np.repeat(np.arange(30), sizes)}))
    assert isinstance(m, LightGBMRankerModel)
    out = m.transform(Table({"features": x[:100]}))
    np.testing.assert_allclose(np.asarray(out["shap"]).sum(axis=1),
                               np.asarray(out["prediction"]), rtol=0, atol=1e-5)
    assert "objective=lambdarank" in m.booster.save_native_model()
