"""The port's train stages (``TrainClassifier``, ``TrainRegressor``,
``ComputeModelStatistics``, ``ComputePerInstanceStatistics``) against the
JAX package's, on the CPU, at the Adult Census schema of SynapseML's
notebook (``schema_data.adult_columns``: 8 string columns, 6 numeric, the
``income`` label as strings).

- ``Featurize`` inside the train stages gives the same matrix bit for bit.
- The learners grow the same trees; binary leaves and probabilities agree
  within 1e-3 and l2 leaves within 1e-4 (XLA's ``exp`` and ``exp2`` on the
  reference's side, ROADMAP queue 3).
- The statistics stages give the same tables within 1e-9 on the same scored
  rows, and where the two packages' predictions are equal.
"""

import numpy as np
import pytest
import torch

from synapseml_tpu.gbdt import LightGBMClassifier as RefClassifier
from synapseml_tpu.gbdt import LightGBMRegressor as RefRegressor
from synapseml_tpu_torch.gbdt import LightGBMClassifier, LightGBMRegressor
from synapseml_tpu_torch.runtime.device import DeviceUnavailableError
from synapseml_tpu_torch.tools.schema_data import adult_columns, adult_rows
from torch_parity import PORT, REF, assert_same
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BINARY_TOL = 1e-3
L2_TOL = 1e-4
STATS_TOL = 1e-9
LEARNER = dict(num_iterations=5, num_leaves=15, min_data_in_leaf=5)


def _adult(m, n=3000, seed=0):
    x, y, _ = adult_rows(seed, n)
    return m.Table(adult_columns(x, y))


def _learner(m, regression=False, **kw):
    if m is REF:
        return (RefRegressor if regression else RefClassifier)(**LEARNER, **kw)
    return (LightGBMRegressor if regression else LightGBMClassifier)(
        device="cpu", **LEARNER, **kw)


def _same_trees(port, ref, tol):
    for f in ("parent", "feature", "bin"):
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f), err_msg=f)
    if ref.cat_set is not None:
        np.testing.assert_array_equal(port.cat_set, ref.cat_set)
    np.testing.assert_allclose(port.leaf_value, ref.leaf_value, rtol=0, atol=tol)


def _fit_classifier(m, n=3000, **kw):
    t = _adult(m, n)
    model = m.TrainClassifier(model=_learner(m), label_col="income", **kw).fit(t)
    held = _adult(m, 1000, seed=1)
    return model, held, model.transform(held)


def test_train_classifier_matches_reference():
    ref_model, ref_held, ref_out = _fit_classifier(REF)
    model, held, out = _fit_classifier(PORT)
    assert_same(ref_model.featurizer.transform(ref_held), model.featurizer.transform(held))
    assert model.featurizer.plan == ref_model.featurizer.plan
    _same_trees(model.inner_model.booster, ref_model.inner_model.booster, BINARY_TOL)
    np.testing.assert_allclose(np.asarray(out["probability"]),
                               np.asarray(ref_out["probability"]), rtol=0, atol=BINARY_TOL)
    assert out["prediction"].tolist() == ref_out["prediction"].tolist()
    assert set(out["prediction"].tolist()) <= {"<=50K", ">50K"}
    assert out.column_names == ref_out.column_names


def test_compute_model_statistics_classification_matches_reference():
    ref_model, _, ref_out = _fit_classifier(REF)
    _, _, out = _fit_classifier(PORT)
    kw = dict(label_col="income", evaluation_metric="classification")
    # the same scored rows through both stages
    same = (REF.ComputeModelStatistics(**kw).transform(REF.Table(
                {c: out[c] for c in out.column_names})),
            PORT.ComputeModelStatistics(**kw).transform(out))
    assert_same(same[0], same[1], atol=STATS_TOL)
    # each package's own scores: predictions equal, so every count statistic
    ref_stats = REF.ComputeModelStatistics(**kw).transform(ref_out)
    stats = PORT.ComputeModelStatistics(**kw).transform(out)
    assert stats.column_names == ["accuracy", "precision", "recall", "AUC"]
    for c in ("accuracy", "precision", "recall"):
        assert abs(float(stats[c][0]) - float(ref_stats[c][0])) <= STATS_TOL
    assert abs(float(stats["AUC"][0]) - float(ref_stats["AUC"][0])) <= BINARY_TOL
    np.testing.assert_array_equal(stats.meta["confusion_matrix"]["matrix"],
                                  ref_stats.meta["confusion_matrix"]["matrix"])
    assert stats.meta["confusion_matrix"]["classes"] == ["<=50K", ">50K"]
    assert float(stats["AUC"][0]) > 0.8


def test_compute_model_statistics_auto_and_per_instance_match_reference():
    _, _, out = _fit_classifier(PORT, n=2000)
    table = {c: out[c] for c in out.column_names}
    for kw in ({"label_col": "income"}, {"label_col": "income", "scored_labels_col":
                                          "prediction", "probability_col": "nope"}):
        assert_same(REF.ComputeModelStatistics(**kw).transform(REF.Table(table)),
                    PORT.ComputeModelStatistics(**kw).transform(PORT.Table(table)),
                    atol=STATS_TOL)
    for kw in ({"label_col": "income"}, {"label_col": "income", "probability_col": "x"}):
        assert_same(REF.ComputePerInstanceStatistics(**kw).transform(REF.Table(table)),
                    PORT.ComputePerInstanceStatistics(**kw).transform(PORT.Table(table)),
                    atol=STATS_TOL)


def _fit_regressor(m):
    cols = adult_columns(*adult_rows(3, 2500)[:2])
    cols["target"] = cols.pop("hours-per-week") + 0.5 * (cols["income"] == ">50K")
    t = m.Table(cols)
    model = m.TrainRegressor(model=_learner(m, regression=True),
                             label_col="target").fit(t)
    return model, model.transform(t)


def test_train_regressor_and_statistics_match_reference():
    ref_model, ref_out = _fit_regressor(REF)
    model, out = _fit_regressor(PORT)
    _same_trees(model.inner_model.booster, ref_model.inner_model.booster, L2_TOL)
    np.testing.assert_allclose(np.asarray(out["prediction"]),
                               np.asarray(ref_out["prediction"]), rtol=0, atol=L2_TOL * 5)
    table = {c: out[c] for c in ("target", "prediction")}
    for stage in ("ComputeModelStatistics", "ComputePerInstanceStatistics"):
        kw = dict(label_col="target", evaluation_metric="regression")
        if stage == "ComputeModelStatistics":
            kw["scores_col"] = "prediction"
        assert_same(getattr(REF, stage)(**kw).transform(REF.Table(table)),
                    getattr(PORT, stage)(**kw).transform(PORT.Table(table)), atol=STATS_TOL)
    auto = PORT.ComputeModelStatistics(label_col="target").transform(PORT.Table(table))
    assert auto.column_names == ["mean_squared_error", "root_mean_squared_error",
                                 "mean_absolute_error", "R^2"]
    assert float(auto["R^2"][0]) > 0.0


def test_trained_pipeline_save_load_round_trip(tmp_path):
    """A fitted pipeline holding ``Featurize`` and the trained model comes
    back from ``save_stage`` / ``load_stage`` and scores the same."""
    t = _adult(PORT, 1500)
    pipe = PORT.Pipeline(stages=[
        PORT.TrainClassifier(model=_learner(PORT), label_col="income"),
        PORT.ComputePerInstanceStatistics(label_col="income"),
    ]).fit(t)
    pipe.save(str(tmp_path / "p"))
    back = PORT.load_stage(str(tmp_path / "p"))
    assert type(back.stages[0]).__name__ == "TrainedClassifierModel"
    assert type(back.stages[0].featurizer).__name__ == "FeaturizeModel"
    held = _adult(PORT, 500, seed=2)
    assert_same(pipe.transform(held), back.transform(held))


def test_default_learners_run_on_the_card(monkeypatch):
    """With no ``model`` the train stages take the port's LightGBM
    estimators at their defaults: on the GPU, so with none visible the fit
    raises rather than falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    t = _adult(PORT, 200)
    with pytest.raises(DeviceUnavailableError):
        PORT.TrainClassifier(label_col="income").fit(t)
    with pytest.raises(DeviceUnavailableError):
        PORT.TrainRegressor(label_col="age").fit(t)
