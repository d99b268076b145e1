"""Run one recipe through both packages and compare what comes out.

``REF`` and ``PORT`` are namespaces that hold the same names, taken from the
JAX package and from the port: ``Table``, ``load_stage``, and every stage
class of the pipeline-stage library (``stages``, ``featurize``, ``train``,
``exploratory``, ``cyber``, ``nn``, ``recommendation``). A parity test writes its recipe once as a
function of such a namespace, runs ``both(recipe)`` and holds the port's
result to the reference's with :func:`assert_same`.
"""

from types import SimpleNamespace

import numpy as np

import synapseml_tpu.core as ref_core
import synapseml_tpu.cyber as ref_cyber
import synapseml_tpu.exploratory as ref_exploratory
import synapseml_tpu.featurize as ref_featurize
import synapseml_tpu.nn as ref_nn
import synapseml_tpu.recommendation as ref_recommendation
import synapseml_tpu.stages as ref_stages
import synapseml_tpu.train as ref_train_stages
import synapseml_tpu_torch.core as port_core
import synapseml_tpu_torch.cyber as port_cyber
import synapseml_tpu_torch.exploratory as port_exploratory
import synapseml_tpu_torch.featurize as port_featurize
import synapseml_tpu_torch.nn as port_nn
import synapseml_tpu_torch.recommendation as port_recommendation
import synapseml_tpu_torch.stages as port_stages
import synapseml_tpu_torch.train as port_train_stages

_CYBER = ["AccessAnomaly", "AccessAnomalyModel", "ComplementAccessTransformer", "IdIndexer",
          "IdIndexerModel", "MultiIndexer", "MultiIndexerModel", "LinearScalarScaler",
          "LinearScalarScalerModel", "StandardScalarScaler", "StandardScalarScalerModel"]
_NN = ["KNN", "KNNModel", "ConditionalKNN", "ConditionalKNNModel"]
_RECOMMENDATION = ["SAR", "SARModel", "AdvancedRankingMetrics", "RankingAdapter",
                   "RankingAdapterModel", "RankingEvaluator", "RankingTrainValidationSplit",
                   "RankingTrainValidationSplitModel", "RecommendationIndexer",
                   "RecommendationIndexerModel"]


def _namespace(core, stages, featurize, train, exploratory, cyber, nn, recommendation, name):
    names = {"Table": core.Table, "Pipeline": core.Pipeline,
             "TableSchema": core.TableSchema, "ColumnSpec": core.ColumnSpec,
             "load_stage": core.load_stage, "name": name}
    for mod in (stages, featurize, train, exploratory):
        names.update({k: getattr(mod, k) for k in mod.__all__})
    names.update({k: getattr(cyber, k) for k in _CYBER})
    names.update({k: getattr(nn, k) for k in _NN})
    names.update({k: getattr(recommendation, k) for k in _RECOMMENDATION})
    return SimpleNamespace(**names)


REF = _namespace(ref_core, ref_stages, ref_featurize, ref_train_stages, ref_exploratory,
                 ref_cyber, ref_nn, ref_recommendation, "ref")
PORT = _namespace(port_core, port_stages, port_featurize, port_train_stages,
                  port_exploratory, port_cyber, port_nn, port_recommendation, "port")


def both(recipe):
    """``(recipe(REF), recipe(PORT))``."""
    return recipe(REF), recipe(PORT)


def _same_value(a, b, path, atol):
    if hasattr(a, "column_names") and hasattr(b, "column_names"):
        assert_same(a, b, atol, path)
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a, key=str) == sorted(b, key=str), path
        for k in a:
            _same_value(a[k], b[k], f"{path}[{k!r}]", atol)
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_value(x, y, f"{path}[{i}]", atol)
    elif isinstance(a, np.ndarray) and a.dtype != object:
        b = np.asarray(b)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        assert a.dtype.kind == b.dtype.kind, (path, a.dtype, b.dtype)
        if atol and a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=0, atol=atol, err_msg=path)
        else:
            np.testing.assert_array_equal(b, a, err_msg=path)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and b.dtype == object and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_value(x, y, f"{path}[{i}]", atol)
    elif isinstance(a, float) and np.isnan(a):
        assert isinstance(b, float) and np.isnan(b), path
    elif isinstance(a, float) and atol:
        assert abs(a - b) <= atol, (path, a, b)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


def assert_same(ref, port, atol=0.0, path="table"):
    """The same columns in the same order, the same partitions and metadata,
    and equal values (floats within ``atol`` where it is given)."""
    assert port.column_names == ref.column_names, (path, port.column_names,
                                                   ref.column_names)
    assert port.npartitions == ref.npartitions, path
    _same_value(ref.meta, port.meta, f"{path}.meta", atol)
    for c in ref.column_names:
        _same_value(ref[c], port[c], f"{path}[{c!r}]", atol)
