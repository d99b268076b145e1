"""Port parity: eval metrics, eval sets and early stopping against the JAX
package on the same numpy inputs, on the CPU.

The device metrics run in f32 in both packages, summed in different orders
(torch against XLA), so an eval series agrees to about 1e-7 (AUC) and 1e-6
(l2), not bit for bit: assertions on a series carry ``SERIES_ATOL`` /
``SERIES_RTOL``. A stop decision compares a metric with the best so far,
so each early-stopping fixture is one whose every decision clears its
threshold by more than ``MARGIN`` (checked on the reference's series), and
then the stop point, ``best_iteration`` and the trees are equal. DART's
eval runs the reference's host path (f64 margins, numpy metric), so its
series is equal.
"""

import warnings

import numpy as np
import pytest
import torch

from synapseml_tpu import Table as RefTable
from synapseml_tpu.gbdt import LightGBMClassifier as RefClassifier
from synapseml_tpu.gbdt.boost import train as ref_train
from synapseml_tpu_torch.core import Table
from synapseml_tpu_torch.gbdt.boost import train
from synapseml_tpu_torch.gbdt.estimators import LightGBMClassifier
from synapseml_tpu_torch.gbdt.metrics import DEFAULT_METRIC, METRICS, device_metric
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(num_leaves=15, max_bin=63)
SERIES_ATOL, SERIES_RTOL = 1e-6, 1e-5
MARGIN = 1e-5


def _data(seed=0, n=3000, d=8):
    """The fixture of ``tests/test_torch_gbdt.py::_data``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y_cls = (x[:, 0] + 0.4 * x[:, 5] + 0.2 * rng.normal(size=n) > 0).astype(np.float64)
    y_reg = 2 * x[:, 0] + np.sin(x[:, 1]) + 0.1 * rng.normal(size=n)
    return x, y_cls, y_reg


def _series(booster):
    keys = [k for k in booster.evals_result[0] if k != "iteration"]
    return {k: np.array([rec[k] for rec in booster.evals_result]) for k in keys}


def _decision_margin(series, higher_better, min_delta):
    """Smallest distance of a metric from the threshold it was held to."""
    best, out = (-np.inf if higher_better else np.inf), np.inf
    for m in series:
        thr = best + min_delta if higher_better else best - min_delta
        if np.isfinite(thr):
            out = min(out, abs(m - thr))
        if (m > thr) if higher_better else (m < thr):
            best = m
    return out


@pytest.mark.parametrize("name", sorted(METRICS))
def test_device_metric_matches_numpy(name):
    """Each torch twin against the numpy version, on f32 scores with ties."""
    rng = np.random.default_rng(len(name))
    n = 5000
    multi = name.startswith("multi")
    if multi:
        y = rng.integers(0, 4, size=n).astype(np.float64)
        score = rng.normal(size=(n, 4)).astype(np.float32)
    else:
        y = (rng.random(n) < 0.4).astype(np.float64)
        score = np.round(rng.normal(size=n) * 8).astype(np.float32) / 8  # ties
    want = METRICS[name][0](y, score.astype(np.float64), np.ones(n))
    got = device_metric(name)(torch.tensor(y, dtype=torch.float32), torch.from_numpy(score),
                              torch.ones(n))
    assert got.dim() == 0 and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=1e-6)


def test_metric_defaults_and_unknown_metric():
    assert DEFAULT_METRIC["binary"] == "binary_logloss" and METRICS["auc"][1]
    x, y, _ = _data(1, n=300)
    with pytest.raises(ValueError, match="unknown metric"):
        train(dict(PARAMS, num_iterations=1, objective="binary", metric="ndcg"), x, y,
              device="cpu")


# (name, params, target, the reference's stop point: trees kept, best_iteration)
EARLY_STOP = {
    "auc_first_chunk": (dict(objective="binary", metric="auc", early_stopping_round=3,
                             num_iterations=40, bagging_fraction=0.5, bagging_freq=1),
                        "cls", (7, 4)),
    "l2_second_chunk": (dict(objective="regression", metric="l2", early_stopping_round=3,
                             num_iterations=70, learning_rate=0.1, num_leaves=4,
                             early_stopping_min_delta=3e-3), "reg", (62, 59)),
}


@pytest.mark.parametrize("case", sorted(EARLY_STOP))
def test_early_stopping_matches_reference(case):
    """The stop point (inside the first 32-iteration chunk, and in the
    second), the trees kept (the chunk's overshoot dropped),
    ``best_iteration`` and ``evals_result`` equal the reference's."""
    extra, target, (kept, best) = EARLY_STOP[case]
    x, y_cls, y_reg = _data()
    xe, ye_cls, ye_reg = _data(5, n=1500)
    y, ye = (y_cls, ye_cls) if target == "cls" else (y_reg, ye_reg)
    params = dict(PARAMS, **extra)
    ref = ref_train(params, x, y, eval_set=[(xe, ye)])
    port = train(params, x, y, device="cpu", eval_set=[(xe, ye)])
    assert (ref.num_trees, ref.best_iteration) == (kept, best)
    assert (port.num_trees, port.best_iteration) == (kept, best)
    for field in ("parent", "feature", "bin"):
        np.testing.assert_array_equal(getattr(port, field), getattr(ref, field))
    rs, ps = _series(ref), _series(port)
    assert list(ps) == list(rs) == [f"eval0_{extra['metric']}"]
    for k in rs:
        assert len(ps[k]) == len(rs[k]) == kept
        assert _decision_margin(rs[k], extra["metric"] == "auc",
                                extra.get("early_stopping_min_delta", 0.0)) > MARGIN
        np.testing.assert_allclose(ps[k], rs[k], rtol=SERIES_RTOL, atol=SERIES_ATOL)
    assert [r["iteration"] for r in port.evals_result] == list(range(kept))
    # predictions stop at best_iteration
    np.testing.assert_array_equal(port.raw_predict(xe, device="cpu"),
                                  port.raw_predict(xe, num_iteration=best, device="cpu"))


@pytest.mark.parametrize("boosting", ["gbdt", "rf"])
def test_eval_without_patience_matches_reference(boosting):
    """No early stopping: every iteration's record for two eval sets (rf's
    metric reads the average of its trees), no ``best_iteration``."""
    x, y, _ = _data(2)
    sets = [_data(6, n=1000)[:2], _data(7, n=700)[:2]]
    params = dict(PARAMS, objective="binary", metric="auc", num_iterations=6)
    if boosting == "rf":
        params.update(boosting="rf", bagging_fraction=0.7, bagging_freq=1)
    ref = ref_train(params, x, y, eval_set=sets)
    port = train(params, x, y, device="cpu", eval_set=sets)
    assert port.best_iteration is None and ref.best_iteration is None
    assert port.num_trees == 6
    rs, ps = _series(ref), _series(port)
    assert list(ps) == list(rs) == ["eval0_auc", "eval1_auc"]
    for k in rs:
        np.testing.assert_allclose(ps[k], rs[k], rtol=SERIES_RTOL, atol=SERIES_ATOL)
    # the eval series is the metric of the model cut at each iteration
    xe, ye = sets[0]
    for i in (0, 5):
        score = port.raw_predict(xe, num_iteration=i + 1, device="cpu")
        assert abs(METRICS["auc"][0](ye, score, np.ones(len(ye))) - ps["eval0_auc"][i]) < 1e-6


def test_dart_eval_and_warning_match_reference():
    """DART ignores early stopping (a warning, no best_iteration) and keeps
    the reference's host metric: an equal eval series."""
    x, y, _ = _data(3)
    xe, ye, _ = _data(8, n=1000)
    params = dict(PARAMS, objective="binary", boosting="dart", skip_drop=0.0, drop_rate=0.5,
                  num_iterations=8, metric="binary_logloss", early_stopping_round=2)
    with pytest.warns(UserWarning, match="ignored with boosting='dart'"):
        port = train(params, x, y, device="cpu", eval_set=[(xe, ye)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = ref_train(params, x, y, eval_set=[(xe, ye)])
    assert port.best_iteration is None and port.num_trees == 8
    np.testing.assert_array_equal(port.tree_scale, ref.tree_scale)
    rs, ps = _series(ref), _series(port)
    np.testing.assert_array_equal(ps["eval0_binary_logloss"], rs["eval0_binary_logloss"])


def test_validation_indicator_col_through_the_estimator():
    """Rows marked by ``validation_indicator_col`` leave the training set and
    become the eval set: the port's stage stops where the reference's
    stops, with the same trees, series and predictions."""
    x, y, _ = _data(4)
    val = np.zeros(len(y), dtype=bool)
    val[::4] = True
    params = dict(PARAMS, num_iterations=40, metric="auc", early_stopping_round=3,
                  bagging_fraction=0.5, bagging_freq=1, feature_fraction=0.8,
                  validation_indicator_col="is_val")
    cols = {"features": x, "label": y, "is_val": val}
    ref = RefTable(cols).ml_fit(RefClassifier(**params))
    est = LightGBMClassifier(device="cpu", **params)
    assert "is_val" in est.input_schema().columns
    port = Table(cols).ml_fit(est)
    rb, pb = ref.booster, port.booster
    assert pb.best_iteration == rb.best_iteration and pb.best_iteration is not None
    assert pb.num_trees == rb.num_trees < 40
    for field in ("parent", "feature", "bin"):
        np.testing.assert_array_equal(getattr(pb, field), getattr(rb, field))
    rs, ps = _series(rb), _series(pb)
    assert _decision_margin(rs["eval0_auc"], True, 0.0) > MARGIN
    np.testing.assert_allclose(ps["eval0_auc"], rs["eval0_auc"], rtol=SERIES_RTOL,
                               atol=SERIES_ATOL)
    # the validation rows were not trained on: the same fit without them
    plain = train(dict(PARAMS, objective="binary", num_iterations=pb.num_trees,
                       bagging_fraction=0.5, bagging_freq=1, feature_fraction=0.8),
                  x[~val], y[~val], device="cpu")
    np.testing.assert_array_equal(plain.parent, pb.parent)
    po = port.transform(Table({"features": x}))
    ro = ref.transform(RefTable({"features": x}))
    np.testing.assert_allclose(po["probability"], ro["probability"], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="is_val"):
        Table({"features": x, "label": y}).ml_fit(est)


@pytest.mark.parametrize("metric", ["multi_logloss", "multi_error"])
def test_multiclass_eval_matches_reference(metric):
    """Four classes, bagged: the stop point and the series of the softmax
    metrics. multi_error is a count over the rows divided by their number,
    exact in f32, so its series (ties included) is equal."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3000, 8)).astype(np.float32)
    y = np.digitize(x[:, 0] + 0.5 * x[:, 3] + 0.3 * rng.normal(size=3000),
                    [-0.7, 0.0, 0.7]).astype(np.float64)
    xe = rng.normal(size=(1000, 8)).astype(np.float32)
    ye = np.digitize(xe[:, 0] + 0.5 * xe[:, 3] + 0.3 * rng.normal(size=1000),
                     [-0.7, 0.0, 0.7]).astype(np.float64)
    params = dict(PARAMS, objective="multiclass", num_class=4, num_iterations=40,
                  num_leaves=7, learning_rate=0.3, metric=metric, early_stopping_round=3,
                  bagging_fraction=0.7, bagging_freq=1)
    ref = ref_train(params, x, y, eval_set=[(xe, ye)])
    port = train(params, x, y, device="cpu", eval_set=[(xe, ye)])
    assert (port.num_trees, port.best_iteration) == (ref.num_trees, ref.best_iteration)
    assert port.num_trees < 40
    np.testing.assert_array_equal(port.parent, ref.parent)
    rs, ps = _series(ref)[f"eval0_{metric}"], _series(port)[f"eval0_{metric}"]
    if metric == "multi_error":
        np.testing.assert_array_equal(ps, rs)
    else:
        assert _decision_margin(rs, False, 0.0) > MARGIN
        np.testing.assert_allclose(ps, rs, rtol=SERIES_RTOL, atol=SERIES_ATOL)
