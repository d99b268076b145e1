"""Port parity: the LambdaRank objective (kernel F's plain version), lambdarank
training and ``LightGBMRanker`` against the JAX package on the same numpy
inputs, on the CPU.

Tolerances and their causes:

- Gradients: XLA's CPU ``exp`` and ``log2`` (``log(x) * (1/ln 2)``) differ
  from the port's in the last place, and XLA sums over j in its own order,
  so g and h agree within ``GRAD_ULPS`` ulps of the largest |g| and |h| of
  the call, not bit for bit.
- Training: those differences vanish in ``_preround`` except where the
  reference's own grid is off: its CPU program computes the grid's
  ``exp2(k)`` inexactly (ROADMAP queue 3), so a few pre-rounded gradients
  land on a neighbouring grid point and leaf values move by up to
  ``LEAF_ATOL`` while the trees stay identical. Given the reference's grid
  (the port's ``_preround`` with XLA's ``exp2``), trees, leaves and NDCG
  series are bit-equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import synapseml_tpu_torch.gbdt.boost as port_boost
from synapseml_tpu import Table as RefTable
from synapseml_tpu.gbdt import LightGBMRanker as RefRanker
from synapseml_tpu.gbdt.boost import _group_tables, _lambda_grads, _metric_ndcg
from synapseml_tpu.gbdt.boost import train as ref_train
from synapseml_tpu_torch.core import Table
from synapseml_tpu_torch.gbdt.boost import GBDTBooster, train
from synapseml_tpu_torch.gbdt.convert import booster_from_state, model_from_state
from synapseml_tpu_torch.gbdt.estimators import LightGBMRanker, LightGBMRankerModel
from synapseml_tpu_torch.gbdt.lambdarank import (QueryGroups, exp_f32, lambda_grads,
                                                 lambda_grads_plain, pair_count)
from synapseml_tpu_torch.gbdt.metrics import metric_ndcg
from synapseml_tpu_torch.tools.kernel_cases import (RANK_CASES, RANK_CASES_WIDE, rank_case,
                                                    rank_rows)
from synapseml_tpu_torch.tools.schema_data import MSLR_FEATURES, MSLR_SHARES, mslr_rows
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

GRAD_ULPS = 4
LEAF_ATOL = 5e-3
PARAMS = dict(objective="lambdarank", num_iterations=5, num_leaves=15, max_bin=63,
              min_data_in_leaf=20)


def _ref_grads(score, y, w, sizes, truncation, sigma):
    G = int(sizes.max())
    idx, valid = _group_tables(sizes, G)
    g, h = _lambda_grads(jnp.asarray(score), jnp.asarray(y, jnp.float32), jnp.asarray(w),
                         jnp.asarray(idx), jnp.asarray(valid), len(y), G, truncation, sigma)
    return np.asarray(g), np.asarray(h)


def _port_grads(score, y, w, sizes, truncation, sigma, **kw):
    groups = QueryGroups(sizes, y, truncation)
    fn = lambda_grads_plain if kw else lambda_grads
    g, h = fn(torch.from_numpy(score), torch.from_numpy(y), torch.from_numpy(w), groups,
              sigma, **kw)
    return g.numpy(), h.numpy()


@pytest.mark.parametrize("case", [c for c in RANK_CASES if c not in RANK_CASES_WIDE])
def test_lambda_grads_match_reference(case):
    """Size-1 queries and queries of one label are in every case (the
    queries of 2,048 to 20,000 documents are card tests: the reference's
    dense (Q, G, G) tensors of them do not fit this test's memory)."""
    score, y, w, sizes, truncation, sigma = rank_case(case)
    g_ref, h_ref = _ref_grads(score, y, w, sizes, truncation, sigma)
    g, h = _port_grads(score, y, w, sizes, truncation, sigma)
    eps = np.finfo(np.float32).eps
    np.testing.assert_allclose(g, g_ref, rtol=0, atol=GRAD_ULPS * eps * np.abs(g_ref).max())
    np.testing.assert_allclose(h, h_ref, rtol=0, atol=GRAD_ULPS * eps * np.abs(h_ref).max())
    starts = np.cumsum(sizes) - sizes
    Q = len(sizes)
    for q in (3, Q // 2, 7, Q - 5):  # no pairs: g = 0, h = 1e-12 * w
        rows = slice(starts[q], starts[q] + sizes[q])
        np.testing.assert_array_equal(g[rows], 0.0)
        np.testing.assert_array_equal(h[rows], np.float32(1e-12) * w[rows])
    if case == "zero_weights":
        assert (g[w == 0] == 0).all() and (h[w == 0] == 0).all()


@pytest.mark.parametrize("cap", [1, 64, 2000, 1 << 30])
def test_plain_chunking_does_not_change_the_result(cap):
    """Chunks of every size, down to one query cut into single rows i, give
    the unchunked version's bits."""
    score, y, w, sizes, truncation, sigma = rank_case("ties", seed=2)
    want = _port_grads(score, y, w, sizes, truncation, sigma, cap=1 << 40)
    got = _port_grads(score, y, w, sizes, truncation, sigma, cap=cap)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_exp_f32_accuracy():
    x = torch.linspace(-20, 88, 400_001, dtype=torch.float32)
    got = exp_f32(x).double()
    want = torch.exp(x.double())
    ulp = torch.from_numpy(np.spacing(want.float().numpy())).double()
    assert float(((got - want).abs() / ulp).max()) <= 1.2
    edge = exp_f32(torch.tensor([88.5, 1000.0, -20.0, -500.0, 0.0]))
    assert torch.isinf(edge[:2]).all() and edge[2] == edge[3] and edge[4] == 1.0
    assert float(1.0 / (1.0 + edge[3])) == 1.0  # below -20, 1 + e^x rounds to 1


def test_pair_count_matches_brute_force():
    score, y, _, sizes, _, _ = rank_case("ties")
    for truncation in (3, 30):
        want, start = 0, 0
        for m in sizes:
            lab, s = y[start:start + m], score[start:start + m]
            start += m
            rank = np.empty(m, np.int64)
            rank[np.argsort(-s, kind="stable")] = np.arange(m)
            top = rank < truncation
            want += sum(1 for i in range(m) for j in range(i + 1, m)
                        if lab[i] != lab[j] and (top[i] or top[j]))
        assert pair_count(sizes, y, truncation, score) == want


def test_ndcg_metric_matches_reference():
    rng = np.random.default_rng(4)
    sizes = rng.integers(1, 30, 40)
    n = int(sizes.sum())
    y = rng.integers(0, 5, n).astype(np.float64)
    y[:sizes[0]] = 0  # a query with ideal DCG 0
    score = np.round(rng.normal(size=n), 1)
    for k in (1, 5, 10):
        assert metric_ndcg(k)(y, score, None, sizes) == _metric_ndcg(k)(y, score, None, sizes)


def test_lambdarank_train_matches_reference():
    """Identical trees and NDCG series; leaves within LEAF_ATOL (the
    reference's pre-rounding grid, module docstring)."""
    x, y, sizes = rank_rows()
    xe, ye, se = rank_rows(seed=5, n_queries=40)
    params = dict(PARAMS, num_iterations=6, early_stopping_round=2)
    kw = dict(group=sizes, eval_set=[(xe, ye)], eval_group=[se])
    ref = ref_train(params, x, y, **kw)
    port = train(params, x, y, device="cpu", **kw)
    for field in ("parent", "feature", "bin"):
        np.testing.assert_array_equal(getattr(port, field), getattr(ref, field), err_msg=field)
    np.testing.assert_allclose(port.leaf_value, ref.leaf_value, rtol=0, atol=LEAF_ATOL)
    assert port.best_iteration == ref.best_iteration
    assert [r["eval0_ndcg@10"] for r in port.evals_result] == pytest.approx(
        [r["eval0_ndcg@10"] for r in ref.evals_result], abs=1e-6)
    np.testing.assert_allclose(port.raw_predict(xe, device="cpu"), ref.raw_predict(xe),
                               rtol=0, atol=2e-2)


def _reference_grid(x: torch.Tensor, n_bound: int) -> torch.Tensor:
    """The port's ``_preround`` on the reference's grid: XLA's ``exp2`` of the
    grid's exponent (inexact on this CPU), everything else the port's."""
    m = torch.max(torch.abs(x), dim=0).values
    delta = m * torch.tensor(float(n_bound), dtype=torch.float32)
    e = torch.ceil(torch.log2(torch.clamp(delta, min=1e-35)))
    factor = torch.tensor(np.asarray(jax.jit(jnp.exp2)(jnp.asarray(e.numpy()))))
    return (x + factor) - factor


@pytest.mark.parametrize("schema", ["narrow", "mslr"])
def test_lambdarank_bit_equal_on_the_reference_grid(monkeypatch, schema):
    """With the reference's pre-rounding grid, the port's lambdarank fit is
    the reference's bit for bit, though the two gradients differ in the last
    place (XLA's exp and log2): trees, leaves and the eval NDCG series. The
    MSLR-schema case has queries of up to ~140 documents and 136 features."""
    if schema == "narrow":
        x, y, sizes = rank_rows()
        xe, ye, se = rank_rows(seed=5, n_queries=40)
        params = dict(PARAMS)
    else:
        x, y, sizes = mslr_rows(3, 60, 1800)
        xe, ye, se = mslr_rows(3, 20, 600, part=1)
        params = dict(PARAMS, num_iterations=4, max_bin=31, min_sum_hessian_in_leaf=5.0)
    monkeypatch.setattr(port_boost, "_preround", _reference_grid)
    kw = dict(group=sizes, eval_set=[(xe, ye)], eval_group=[se])
    ref = ref_train(params, x, y, **kw)
    port = train(params, x, y, device="cpu", **kw)
    for field in ("parent", "feature", "bin", "leaf_value", "leaf_hess"):
        np.testing.assert_array_equal(getattr(port, field), getattr(ref, field), err_msg=field)
    assert port.evals_result == ref.evals_result


def test_lambdarank_checks():
    x, y, sizes = rank_rows(n_queries=20)
    with pytest.raises(ValueError, match="requires group"):
        train(PARAMS, x, y, device="cpu")
    with pytest.raises(ValueError, match="sum to"):
        train(PARAMS, x, y, group=sizes[:-1], device="cpu")
    with pytest.raises(ValueError, match="eval_group"):
        train(PARAMS, x, y, group=sizes, eval_set=[(x, y)], device="cpu")
    booster = train(dict(PARAMS, num_iterations=2, sigmoid=2.0, lambdarank_truncation_level=5,
                         ndcg_at=3), x, y, group=sizes, eval_set=[(x, y)],
                    eval_group=[sizes], device="cpu")
    assert booster.objective == "lambdarank" and booster.base_score.tolist() == [0.0]
    assert list(booster.evals_result[0]) == ["iteration", "eval0_ndcg@3"]


def _ranker_table(seed, shuffle=True):
    """MSLR-schema rows (60 training queries, 20 validation queries) with a
    group id column, rows shuffled so the stage must sort them."""
    xt, yt, st = mslr_rows(seed, 60, 1800)
    xv, yv, sv = mslr_rows(seed, 20, 600, part=1)
    rng = np.random.default_rng(seed)
    ids = rng.permutation(80) * 7 + 3  # arbitrary ids, not in query order
    cols = {"features": np.concatenate([xt, xv]), "label": np.concatenate([yt, yv]),
            "group": np.repeat(ids, np.concatenate([st, sv])).astype(np.float64),
            "validation": np.r_[np.zeros(len(yt), bool), np.ones(len(yv), bool)]}
    if shuffle:
        perm = rng.permutation(len(cols["label"]))
        cols = {k: v[perm] for k, v in cols.items()}
    return cols


def test_ranker_fit_transform_matches_reference(monkeypatch):
    """The stage sorts by group, splits off the validation rows, trains with
    their NDCG and early stopping; on the reference's grid it is the
    reference's stage: trees, leaves, eval series, best_iteration and
    predictions."""
    monkeypatch.setattr(port_boost, "_preround", _reference_grid)
    cols = _ranker_table(0)
    params = dict(num_iterations=6, num_leaves=15, max_bin=31, min_data_in_leaf=20,
                  validation_indicator_col="validation", early_stopping_round=2,
                  ndcg_at=5, lambdarank_truncation_level=20)
    ref = RefRanker(**params).fit(RefTable(cols))
    port = LightGBMRanker(device="cpu", **params).fit(Table(cols))
    assert isinstance(port, LightGBMRankerModel)
    rb, pb = ref.booster, port.booster
    for field in ("parent", "feature", "bin", "leaf_value"):
        np.testing.assert_array_equal(getattr(pb, field), getattr(rb, field), err_msg=field)
    assert pb.evals_result == rb.evals_result and pb.best_iteration == rb.best_iteration
    assert list(pb.evals_result[0]) == ["iteration", "eval0_ndcg@5"]
    probe = {"features": cols["features"][:500]}
    np.testing.assert_allclose(np.asarray(port.transform(Table(probe))["prediction"]),
                               np.asarray(ref.transform(RefTable(probe))["prediction"]),
                               rtol=0, atol=1e-5)
    from synapseml_tpu_torch.core import TableSchema

    schema = port.transform_schema(TableSchema.from_table(Table(probe)))
    assert "prediction" in schema and schema["prediction"].dtype_class == "float"


def test_convert_reference_ranker():
    x, y, sizes = rank_rows(n_queries=60)
    ref = ref_train(dict(PARAMS, num_iterations=3), x, y, group=sizes)
    booster = booster_from_state(ref.state_dict())
    assert isinstance(booster, GBDTBooster) and booster.objective == "lambdarank"
    np.testing.assert_allclose(booster.raw_predict(x, device="cpu"), ref.raw_predict(x),
                               rtol=0, atol=1e-6)
    model = model_from_state(ref.state_dict(), device="cpu")
    assert isinstance(model, LightGBMRankerModel)
    out = np.asarray(model.transform(Table({"features": x}))["prediction"])
    np.testing.assert_allclose(out, ref.predict(x), rtol=0, atol=1e-6)


def test_mslr_rows_schema():
    x, y, sizes = mslr_rows(0, 300)
    assert x.shape == (int(sizes.sum()), MSLR_FEATURES) and x.dtype == np.float32
    assert len(sizes) == 300 and sizes.min() >= 1 and sizes.max() <= 1251
    assert abs(sizes.mean() - 120) < 1
    share = np.bincount(y.astype(np.int64), minlength=5) / len(y)
    np.testing.assert_allclose(share, MSLR_SHARES, atol=0.01)
    counts = x[:, :60]
    assert (counts == np.floor(counts)).all() and (counts == 0).mean() > 0.05
    # part 1 is another stream of rows over the same structure
    x1, _, s1 = mslr_rows(0, 300, part=1)
    assert not np.array_equal(s1, sizes)
    np.testing.assert_array_equal(mslr_rows(0, 300)[0][:5], x[:5])
