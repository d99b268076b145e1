"""The rest of the dense training surface against the JAX package, on the
CPU: a custom objective (``fobj``), continued training (``init_booster``),
a fitted ``mapper``, ``callbacks``, the estimators' ``num_batches`` and the
classifier's ``is_unbalance``, and the Params ``max_bin_by_feature``,
``verbosity`` and ``use_barrier_execution_mode``.

Tolerances against the reference, each by its cause (ROADMAP queue 3): the
reference's ``_preround`` grid comes from XLA's inexact ``exp2`` (l2 leaves
within 1e-4), and XLA's ``exp`` differs from ``torch.exp`` in the last
place (binary and logistic leaves within 1e-3). With the reference's grid
and exponential put into the port, the fits are bit-equal, and the tests
say so where they check it.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import synapseml_tpu_torch.gbdt.boost as port_boost
from synapseml_tpu import Table as RefTable
from synapseml_tpu.gbdt import LightGBMClassifier as RefClassifier
from synapseml_tpu.gbdt import LightGBMRegressor as RefRegressor
from synapseml_tpu.gbdt.binning import BinMapper as RefBinMapper
from synapseml_tpu.gbdt.boost import train as ref_train
from synapseml_tpu_torch.core import Table, load_stage
from synapseml_tpu_torch.gbdt.binning import BinMapper
from synapseml_tpu_torch.gbdt.boost import train
from synapseml_tpu_torch.gbdt.estimators import (LightGBMClassifier, LightGBMRanker,
                                                 LightGBMRegressor)
from test_torch_leaf_local import _reference_grid, _xla_sigmoid
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(num_iterations=5, num_leaves=15, max_bin=63)
L2_ATOL = 1e-4      # the reference's pre-rounding grid (XLA's exp2)
BINARY_ATOL = 1e-3  # XLA's exp against torch.exp


def _data(seed=0, n=3000, d=8):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y_cls = (x[:, 0] + 0.4 * x[:, 5] + 0.2 * rng.normal(size=n) > 0).astype(np.float64)
    y_reg = 2 * x[:, 0] + np.sin(x[:, 1]) + 0.1 * rng.normal(size=n)
    return x, y_cls, y_reg


def _same_trees(a, b, atol=0.0):
    for field in ("parent", "feature", "bin"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field), err_msg=field)
    np.testing.assert_allclose(a.leaf_value, b.leaf_value, rtol=0, atol=atol)
    np.testing.assert_allclose(a.tree_scale, b.tree_scale, rtol=0, atol=0)
    np.testing.assert_allclose(a.base_score, b.base_score, rtol=0, atol=0)


def _on_reference_numerics(monkeypatch):
    """The reference's pre-rounding grid and exponential in the port."""
    monkeypatch.setattr(port_boost, "_preround", _reference_grid)
    monkeypatch.setattr(port_boost, "_sigmoid", _xla_sigmoid)


# -- fobj ----------------------------------------------------------------------------

def _l2_fobj(score, y, w):
    """Operators only: the same on jnp arrays and torch tensors."""
    return score - y, score * 0 + 1


def test_fobj_l2_form_matches_reference_and_builtin(monkeypatch):
    x, _, y = _data(1)
    params = dict(PARAMS, objective="regression")
    port = train(params, x, y, device="cpu", fobj=_l2_fobj)
    builtin = train(params, x, y, device="cpu")
    _same_trees(port, builtin)
    np.testing.assert_array_equal(port.leaf_hess, builtin.leaf_hess)
    ref = ref_train(params, x, y, fobj=_l2_fobj)
    _same_trees(port, ref, L2_ATOL)
    _on_reference_numerics(monkeypatch)
    _same_trees(train(params, x, y, device="cpu", fobj=_l2_fobj), ref)


def test_fobj_logistic_matches_reference():
    """A logistic objective written out: its exp is each framework's own, so
    leaves agree within BINARY_ATOL, trees are identical, and the fit is the
    built-in binary's."""
    x, y, _ = _data(2)

    def port_fobj(score, yy, w):
        p = 1 / (1 + torch.exp(-score))
        return p - yy, p * (1 - p)

    def ref_fobj(score, yy, w):
        p = 1 / (1 + jnp.exp(-score))
        return p - yy, p * (1 - p)

    params = dict(PARAMS, objective="binary")
    port = train(params, x, y, device="cpu", fobj=port_fobj)
    _same_trees(port, train(params, x, y, device="cpu"))
    _same_trees(port, ref_train(params, x, y, fobj=ref_fobj), BINARY_ATOL)


def test_fobj_multiclass_gets_score_matrix():
    x, _, _ = _data(3, n=2000)
    y = np.digitize(x[:, 1], [-0.5, 0.5]).astype(np.float64)
    seen = []

    def fobj(score, yy, w):
        seen.append(tuple(score.shape))
        onehot = (yy[:, None] == torch.arange(3)[None, :]).to(torch.float32)
        return score - onehot, torch.ones_like(score)

    booster = train(dict(PARAMS, objective="multiclass", num_class=3, num_iterations=2),
                    x, y, device="cpu", fobj=fobj)
    assert seen == [(2000, 3)] * 2 and booster.parent.shape == (2, 3, 14)


# -- continued training --------------------------------------------------------------

@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_init_booster_two_stage_matches_reference(objective, monkeypatch):
    x, y_cls, y_reg = _data(4)
    y = y_cls if objective == "binary" else y_reg
    params = dict(PARAMS, objective=objective)
    xe, ye = x[:500] + 0.1, y[:500]
    p1 = train(params, x, y, device="cpu")
    p2 = train(params, x, y, device="cpu", init_booster=p1, eval_set=[(xe, ye)])
    r1 = ref_train(params, x, y)
    r2 = ref_train(params, x, y, init_booster=r1, eval_set=[(xe, ye)])
    assert p2.num_trees == 10 and p2.best_iteration is None
    assert p2.mapper is p1.mapper
    _same_trees(p2, r2, L2_ATOL if objective == "regression" else BINARY_ATOL)
    # the eval series starts from the prior trees' margins
    assert [r["iteration"] for r in p2.evals_result] == list(range(5))
    np.testing.assert_allclose([list(r.values()) for r in p2.evals_result],
                               [list(r.values()) for r in r2.evals_result], rtol=1e-5, atol=1e-6)
    _on_reference_numerics(monkeypatch)
    q1 = train(params, x, y, device="cpu")
    _same_trees(train(params, x, y, device="cpu", init_booster=q1), r2)


@pytest.mark.parametrize("boost_from_average", [False, True])
def test_two_stages_equal_one_fit(boost_from_average):
    """5 + 5 iterations give the trees of one 10-iteration fit. With base 0 the
    init margins are the fit's own f32 sums (kernel B's plain version adds
    the trees in order, acc + scale * value, as the loop does), so this is
    exact by construction. With a base score the init margins are
    f32(base + sum) rounded once, against the loop's running f32 sums from
    f32(base): an ulp apart at most, which this fixture's pre-rounding grid
    absorbs (the same trees and leaves)."""
    x, _, y = _data(5)
    params = dict(PARAMS, objective="regression", boost_from_average=boost_from_average)
    first = train(params, x, y, device="cpu")
    both = train(params, x, y, device="cpu", init_booster=first)
    one = train(dict(params, num_iterations=10), x, y, device="cpu")
    _same_trees(both, one)
    np.testing.assert_array_equal(both.raw_predict(x, device="cpu"),
                                  one.raw_predict(x, device="cpu"))


def test_init_booster_checks_objective():
    x, y, _ = _data(6, n=1000)
    first = train(dict(PARAMS, objective="binary", num_iterations=2), x, y, device="cpu")
    with pytest.raises(ValueError, match="different objective/num_class"):
        train(dict(PARAMS, objective="regression"), x, y, device="cpu", init_booster=first)


# -- callbacks and mapper ------------------------------------------------------------

def test_callback_stop_keeps_the_iteration():
    x, y, _ = _data(7)
    params = dict(PARAMS, objective="binary", num_iterations=10)
    calls = []

    def cb(env):
        calls.append(env)
        return env["iteration"] == 3

    stopped = train(params, x, y, device="cpu", callbacks=[cb],
                    eval_set=[(x[:400], y[:400])])
    assert stopped.num_trees == 4 and [c["iteration"] for c in calls] == [0, 1, 2, 3]
    assert calls[-1]["evals"] == stopped.evals_result[-1]
    _same_trees(stopped, train(dict(params, num_iterations=4), x, y, device="cpu"))
    seen = []
    train(dict(params, num_iterations=2), x, y, device="cpu",
          callbacks=[lambda env: seen.append(env["evals"])])
    assert seen == [None, None]


def test_callbacks_match_reference_eval_and_stop():
    x, y, _ = _data(8)
    params = dict(PARAMS, objective="binary", num_iterations=8)
    stop_at = lambda env: env["iteration"] == 5
    kw = dict(eval_set=[(x[:600], y[:600])], callbacks=[stop_at])
    port = train(params, x, y, device="cpu", **kw)
    ref = ref_train(params, x, y, **kw)
    assert port.num_trees == ref.num_trees == 6
    _same_trees(port, ref, BINARY_ATOL)
    assert [r["eval0_binary_logloss"] for r in port.evals_result] == pytest.approx(
        [r["eval0_binary_logloss"] for r in ref.evals_result], abs=1e-6)


def test_mapper_reuse_matches_reference():
    x, y, _ = _data(9)
    params = dict(PARAMS, objective="binary")
    port_mapper = BinMapper(max_bin=15).fit(x)
    ref_mapper = RefBinMapper(max_bin=15).fit(x)
    port = train(params, x, y, device="cpu", mapper=port_mapper)
    assert port.mapper is port_mapper and port.mapper.n_bins == ref_mapper.n_bins
    _same_trees(port, ref_train(params, x, y, mapper=ref_mapper), BINARY_ATOL)
    fitted = train(params, x, y, device="cpu")
    _same_trees(train(params, x, y, device="cpu", mapper=fitted.mapper), fitted)


# -- estimators ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_num_batches_matches_reference(kind):
    x, y_cls, y_reg = _data(10)
    cols = {"features": x, "label": y_cls if kind == "classifier" else y_reg,
            "w": np.random.default_rng(1).uniform(0.5, 2.0, len(x))}
    params = dict(PARAMS, num_iterations=7, num_batches=3, weight_col="w")
    ref_cls, port_cls = ((RefClassifier, LightGBMClassifier) if kind == "classifier"
                         else (RefRegressor, LightGBMRegressor))
    ref = RefTable(cols).ml_fit(ref_cls(**params)).booster
    port = Table(cols).ml_fit(port_cls(device="cpu", **params)).booster
    assert port.num_trees == ref.num_trees == 7
    _same_trees(port, ref, BINARY_ATOL if kind == "classifier" else L2_ATOL)


def test_num_batches_ranker_refused():
    x, y, _ = _data(11, n=200)
    table = Table({"features": x, "label": np.floor(y * 3), "group": np.arange(200) // 20})
    with pytest.raises(NotImplementedError, match="num_batches"):
        LightGBMRanker(device="cpu", num_batches=2, **PARAMS).fit(table)


def test_is_unbalance_matches_reference():
    x, _, _ = _data(12)
    y = (x[:, 0] > 1.0).astype(np.float64)  # about 16 % positives
    cols = {"features": x, "label": y}
    params = dict(PARAMS, is_unbalance=True)
    ref = RefTable(cols).ml_fit(RefClassifier(**params)).booster
    port = Table(cols).ml_fit(LightGBMClassifier(device="cpu", **params)).booster
    _same_trees(port, ref, BINARY_ATOL)
    plain = Table(cols).ml_fit(LightGBMClassifier(device="cpu", **PARAMS)).booster
    assert not np.array_equal(port.leaf_value, plain.leaf_value)
    assert port.base_score[0] > plain.base_score[0]  # positives weigh more


def test_new_params_round_trip_and_inert_keys(tmp_path):
    est = LightGBMClassifier(max_bin_by_feature=[0, 15], verbosity=2, num_batches=2,
                             use_barrier_execution_mode=True, is_unbalance=True)
    est.save(str(tmp_path / "est"))
    loaded = load_stage(str(tmp_path / "est"))
    for name, value in (("max_bin_by_feature", [0, 15]), ("verbosity", 2), ("num_batches", 2),
                        ("use_barrier_execution_mode", True), ("is_unbalance", True)):
        assert getattr(loaded, name) == value
    assert LightGBMRegressor().verbosity == -1 and LightGBMRegressor().num_batches == 0
    x, y, _ = _data(13, n=600)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        a = train(dict(PARAMS, objective="binary", hist_method="scatter", hist_chunk=4096),
                  x, y, device="cpu")
    _same_trees(a, train(dict(PARAMS, objective="binary"), x, y, device="cpu"))
    est = LightGBMClassifier(device="cpu", max_bin_by_feature=[0, 7] + [0] * 6, **PARAMS)
    mapper = Table({"features": x, "label": y}).ml_fit(est).booster.mapper
    assert mapper.max_bin_by_feature[1] == 7 and len(mapper.upper_edges[1]) <= 7
