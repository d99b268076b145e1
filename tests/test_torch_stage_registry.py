"""Every stage of the port's pipeline-stage library (``stages``,
``featurize``, ``train``, ``exploratory``, ``cyber``) and of ``nn`` and
``recommendation``, one recipe each:

- it is registered in the port's ``STAGE_REGISTRY`` (its fitted model too);
- run through both packages on the same table, its output (an estimator's
  fitted model's output) equals the JAX package's;
- it comes back from ``save_stage`` / ``load_stage`` with the same params,
  and the loaded stage (or fitted model) gives the same output. A callable
  param (``Lambda``, ``UDFTransformer``) does not persist: it loads as None,
  as in the JAX package.
"""

import numpy as np
import pytest

from synapseml_tpu.core import Estimator as RefEstimator
from synapseml_tpu.gbdt import LightGBMClassifier as RefClassifier
from synapseml_tpu.gbdt import LightGBMRegressor as RefRegressor
from synapseml_tpu_torch.core import STAGE_REGISTRY, Estimator
from synapseml_tpu_torch.gbdt import LightGBMClassifier, LightGBMRegressor
from torch_parity import PORT, REF, assert_same
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PACKAGES = ("synapseml_tpu_torch.stages", "synapseml_tpu_torch.featurize",
            "synapseml_tpu_torch.train", "synapseml_tpu_torch.exploratory",
            "synapseml_tpu_torch.cyber", "synapseml_tpu_torch.nn",
            "synapseml_tpu_torch.recommendation")
TINY_GBDT = dict(num_iterations=2, num_leaves=4, min_data_in_leaf=1)


def _table(m, n=24):
    rng = np.random.default_rng(11)
    a = rng.normal(size=n)
    a[::5] = np.nan
    return m.Table({
        "a": a, "b": rng.normal(size=n), "label": (np.arange(n) % 3 == 0).astype(np.int64),
        "text": np.array([f"the cat {i % 4} sat" for i in range(n)], dtype=object),
        "cat": np.array([["x", "y", "z", None][i % 4] for i in range(n)], dtype=object),
        "vec": np.concatenate([rng.normal(size=(n, 2)), np.zeros((n, 1))], axis=1),
        "seq": [[i, i + 1][: 1 + i % 2] for i in range(n)],
        "tenant": np.array(["t0", "t1"] * (n // 2), dtype=object),
        "u": np.array([f"u{i % 5}" for i in range(n)], dtype=object),
        "ui": np.arange(n) % 6, "ri": (np.arange(n) * 7) % 5,
    }, npartitions=2)


def _scored(m, n=24):
    rng = np.random.default_rng(12)
    y = (np.arange(n) % 3 == 0).astype(np.int64)
    pred = np.where(rng.random(n) < 0.8, y, 1 - y)
    p1 = np.clip(0.7 * y + 0.3 * rng.random(n), 0, 1)
    return m.Table({"label": y, "prediction": pred,
                    "probability": np.stack([1 - p1, p1], axis=1)})


def _on_cpu(m):
    """The port's device Param for a CPU run (the reference has none)."""
    return {} if m is REF else {"device": "cpu"}


def _ranked(m, n=24):
    rng = np.random.default_rng(13)
    return m.Table({"prediction": [list(rng.permutation(8)[:4]) for _ in range(n)],
                    "label": [list(rng.permutation(8)[:3]) for _ in range(n)]})


def _sar(m, **params):
    return m.SAR(user_col="ui", item_col="ri", support_threshold=1, **params, **_on_cpu(m))


def _learner(m, regression=False):
    if m is REF:
        return (RefRegressor if regression else RefClassifier)(**TINY_GBDT)
    return (LightGBMRegressor if regression else LightGBMClassifier)(device="cpu",
                                                                      **TINY_GBDT)


# name -> (makes the stage, makes its input table, float tolerance against the reference)
RECIPES = {
    "DropColumns": (lambda m: m.DropColumns(cols=["b"]), _table, 0),
    "SelectColumns": (lambda m: m.SelectColumns(cols=["a", "label"]), _table, 0),
    "RenameColumn": (lambda m: m.RenameColumn(input_col="a", output_col="z"), _table, 0),
    "Repartition": (lambda m: m.Repartition(n=3), _table, 0),
    "Cacher": (lambda m: m.Cacher(), _table, 0),
    "Lambda": (lambda m: m.Lambda(transform_func=lambda t: t.with_column("c", t["b"] * 2)),
               _table, 0),
    "UDFTransformer": (lambda m: m.UDFTransformer(input_col="b", output_col="o",
                                                  udf=lambda v: v + 1, vectorized=True),
                       _table, 0),
    "Explode": (lambda m: m.Explode(input_col="seq"), _table, 0),
    "Timer": (lambda m: m.Timer(stage=m.ValueIndexer(input_col="cat", output_col="ci"),
                                log_to_logger=False), _table, 0),
    "FixedMiniBatchTransformer": (lambda m: m.FixedMiniBatchTransformer(batch_size=5),
                                  _table, 0),
    "DynamicMiniBatchTransformer": (lambda m: m.DynamicMiniBatchTransformer(max_batch_size=7),
                                    _table, 0),
    "TimeIntervalMiniBatchTransformer": (
        lambda m: m.TimeIntervalMiniBatchTransformer(millis_to_wait=10, max_batch_size=5),
        _table, 0),
    "FlattenBatch": (lambda m: m.FlattenBatch(),
                     lambda m: m.FixedMiniBatchTransformer(batch_size=5).transform(
                         _table(m).drop("seq")), 0),
    "PartitionConsolidator": (lambda m: m.PartitionConsolidator(), _table, 0),
    "StratifiedRepartition": (lambda m: m.StratifiedRepartition(label_col="label", seed=3),
                              _table, 0),
    "EnsembleByKey": (lambda m: m.EnsembleByKey(keys=["label"], cols=["b", "vec"]),
                      _table, 0),
    "ClassBalancer": (lambda m: m.ClassBalancer(input_col="label"), _table, 0),
    "SummarizeData": (lambda m: m.SummarizeData(), _table, 0),
    "TextPreprocessor": (lambda m: m.TextPreprocessor(input_col="text", output_col="tp",
                                                      map={"cat": "dog", "sat": "ran"}),
                         _table, 0),
    "UnicodeNormalize": (lambda m: m.UnicodeNormalize(input_col="text", output_col="un"),
                         _table, 0),
    "MultiColumnAdapter": (lambda m: m.MultiColumnAdapter(
        base_stage=m.ValueIndexer(), input_cols=["cat", "u"], output_cols=["ci", "uix"]),
        _table, 0),
    "CleanMissingData": (lambda m: m.CleanMissingData(input_cols=["a"], cleaning_mode="Median"),
                         _table, 0),
    "ValueIndexer": (lambda m: m.ValueIndexer(input_col="cat", output_col="ci"), _table, 0),
    "IndexToValue": (lambda m: m.IndexToValue(input_col="label", output_col="lv",
                                              levels=np.array(["no", "yes"], dtype=object)),
                     _table, 0),
    "DataConversion": (lambda m: m.DataConversion(cols=["label", "b"], convert_to="string"),
                       _table, 0),
    "CountSelector": (lambda m: m.CountSelector(input_col="vec", output_col="sel"), _table, 0),
    "Featurize": (lambda m: m.Featurize(input_cols=["a", "cat", "text", "vec"],
                                        num_features=64), _table, 0),
    "FastVectorAssembler": (lambda m: m.FastVectorAssembler(input_cols=["b", "vec"]),
                            _table, 0),
    "TextFeaturizer": (lambda m: m.TextFeaturizer(input_col="text", num_features=16,
                                                  n_gram_length=2), _table, 0),
    "MultiNGram": (lambda m: m.MultiNGram(input_col="text", lengths=[1, 2]), _table, 0),
    "PageSplitter": (lambda m: m.PageSplitter(input_col="text", maximum_page_length=6,
                                              minimum_page_length=3), _table, 0),
    "TrainClassifier": (lambda m: m.TrainClassifier(model=_learner(m), label_col="label",
                                                    input_cols=["a", "b", "cat", "vec"]),
                        _table, 1e-3),
    "TrainRegressor": (lambda m: m.TrainRegressor(model=_learner(m, True), label_col="b",
                                                  input_cols=["a", "cat", "vec"]),
                       _table, 1e-4),
    "ComputeModelStatistics": (lambda m: m.ComputeModelStatistics(), _scored, 1e-12),
    "ComputePerInstanceStatistics": (lambda m: m.ComputePerInstanceStatistics(), _scored,
                                     1e-12),
    "FeatureBalanceMeasure": (lambda m: m.FeatureBalanceMeasure(
        sensitive_cols=["tenant", "u"], label_col="label", verbose=True), _table, 0),
    "DistributionBalanceMeasure": (lambda m: m.DistributionBalanceMeasure(
        sensitive_cols=["u"]), _table, 0),
    "AggregateBalanceMeasure": (lambda m: m.AggregateBalanceMeasure(
        sensitive_cols=["tenant", "u"]), _table, 0),
    "ComplementAccessTransformer": (lambda m: m.ComplementAccessTransformer(
        indexed_col_names=["ui", "ri"], partition_key="tenant", complementset_factor=2),
        _table, 0),
    "IdIndexer": (lambda m: m.IdIndexer(input_col="u", partition_key="tenant",
                                        output_col="uid"), _table, 0),
    "MultiIndexer": (lambda m: m.MultiIndexer(indexers=[
        m.IdIndexer(input_col="u", partition_key="tenant", output_col="uid"),
        m.IdIndexer(input_col="cat", partition_key="tenant", output_col="cid")]), _table, 0),
    "LinearScalarScaler": (lambda m: m.LinearScalarScaler(
        input_col="b", output_col="ls", partition_key="tenant"), _table, 0),
    "StandardScalarScaler": (lambda m: m.StandardScalarScaler(
        input_col="b", output_col="ss", partition_key="tenant"), _table, 0),
    "AccessAnomaly": (lambda m: m.AccessAnomaly(user_col="u", res_col="text",
                                                likelihood_col="b", max_iter=3, rank_param=2,
                                                **_on_cpu(m)), _table, 1e-3),
    "KNN": (lambda m: m.KNN(features_col="vec", values_col="u", k=3, **_on_cpu(m)),
            _table, 1e-5),
    "ConditionalKNN": (lambda m: m.ConditionalKNN(features_col="vec", values_col="u",
                                                  label_col="ui", conditioner_col="seq", k=3,
                                                  **_on_cpu(m)), _table, 1e-5),
    "SAR": (lambda m: _sar(m), _table, 1e-5),
    "RecommendationIndexer": (lambda m: m.RecommendationIndexer(
        user_input_col="u", item_input_col="text"), _table, 0),
    "RankingAdapter": (lambda m: m.RankingAdapter(k=3, recommender=_sar(m)), _table, 1e-5),
    "RankingEvaluator": (lambda m: m.RankingEvaluator(k=3, n_items=8), _ranked, 1e-12),
    "RankingTrainValidationSplit": (lambda m: m.RankingTrainValidationSplit(
        user_col="ui", item_col="ri", estimator=_sar(m),
        estimator_param_maps=[{"similarity_function": "jaccard"},
                              {"similarity_function": "lift"}],
        evaluator=m.RankingEvaluator(k=3), seed=2), _table, 1e-5),
}
CALLABLE_PARAMS = {"Lambda": "transform_func", "UDFTransformer": "udf"}


def _registered():
    return sorted(name for name, cls in STAGE_REGISTRY.items()
                  if cls.__module__.startswith(PACKAGES))


def _run(m, name):
    """(the stage, its fitted model or None, the output table)."""
    make, table, _ = RECIPES[name]
    stage, t = make(m), table(m)
    if isinstance(stage, (Estimator, RefEstimator)):
        model = stage.fit(t)
        return stage, model, model.transform(t)
    return stage, None, stage.transform(t)


def test_every_library_stage_has_a_recipe():
    """The recipes cover every registered stage of the library; what they do
    not name is a model that one of them fits."""
    fitted = set()
    for name in RECIPES:
        model = _run(PORT, name)[1]
        if model is not None:
            fitted.add(type(model).__name__)
    names = set(_registered())
    assert names - set(RECIPES) - fitted == set()
    assert set(RECIPES) <= names
    assert {"TimerModel", "ClassBalancerModel", "FeaturizeModel", "TrainedClassifierModel",
            "TrainedRegressorModel", "MultiIndexerModel", "AccessAnomalyModel", "KNNModel",
            "ConditionalKNNModel", "SARModel", "RankingAdapterModel",
            "RankingTrainValidationSplitModel", "RecommendationIndexerModel"} <= fitted


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_stage_matches_reference_and_round_trips(name, tmp_path):
    atol = RECIPES[name][2]
    _, _, ref_out = _run(REF, name)
    stage, model, out = _run(PORT, name)
    assert_same(ref_out, out, atol=atol)
    assert STAGE_REGISTRY[name] is type(stage)
    t = RECIPES[name][1](PORT)
    for obj in (stage, model):
        if obj is None:
            continue
        path = str(tmp_path / type(obj).__name__)
        obj.save(path)
        back = PORT.load_stage(path)
        assert type(back) is type(obj)
        assert back.uid == obj.uid
        assert back.simple_param_values() == obj.simple_param_values()
        if obj is stage and name in CALLABLE_PARAMS:
            assert back.get(CALLABLE_PARAMS[name]) is None
            continue
        if obj is stage and model is not None:
            continue  # the estimator's output is its model's, checked next
        assert_same(obj.transform(t), back.transform(t))
