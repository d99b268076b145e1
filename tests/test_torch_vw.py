"""The port's VW engine against the JAX package's, on the CPU.

- ``tests/test_vw.py``'s featurizer, learner, estimator, contextual-bandit,
  interaction and zipper tests, and the two VW tests of
  ``tests/test_gbdt_crosscheck.py`` (``:223-284``), carried over to the port;
- bit for bit against the reference: the featurizer (every column kind,
  ``sum_collisions`` both ways), the interactions, ``pad_examples`` and
  ``predict_linear``, and the scores of a reference-trained state through
  ``model_from_state``;
- ``train_linear`` against the reference for each loss x {no penalty, l1,
  l2} x {1, 3 passes} x {no init state, an init state}, within ``W_TOL``:
  XLA computes ``lr * g / sqrt(g2)`` as ``(lr * g) * rsqrt(g2)`` fused into
  the subtraction with its own ``rsqrt`` (an ulp off for many
  inputs), the logistic ``exp`` with its own polynomial (the port takes
  ``exp_f32``), and the bias mean in an order of its own (the port sums
  pairwise). With XLA's ``rsqrt`` and the fused forms patched into the
  port's two step helpers, the hinge and quantile losses, whose gradients
  are sums exact in any order, give the reference's state bit for bit;
- kernel V's plan (each batch's short and long slot lists) and its
  schedule, modelled on the CPU op for op (a warp's gathers and then the
  ordered chain of a row; a long list's terms and then its ordered adds;
  the padding skipped and its effect applied once; the dense regime's
  marks; several batches carried in one launch), against the plain step
  at 0 ulps on every case of ``kernel_cases.VW_STEP_CASES``: what the card
  tests then hold the CUDA kernel to.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from synapseml_tpu.core import Table as RefTable
from synapseml_tpu.vw import estimators as ref_est
from synapseml_tpu.vw import featurizer as ref_feat
from synapseml_tpu.vw import learner as ref

from synapseml_tpu_torch.core import Pipeline, Table, load_stage
from synapseml_tpu_torch.gbdt.metrics import METRICS
from synapseml_tpu_torch.tools.kernel_cases import (VW_ODD_BATCHES, VW_REGIMES, VW_STEP_CASES,
                                                    vw_case_batch, vw_state_differs,
                                                    vw_step_case)
from synapseml_tpu_torch.vw import (VectorZipper, VowpalWabbitClassifier,
                                    VowpalWabbitContextualBandit, VowpalWabbitFeaturizer,
                                    VowpalWabbitInteractions, VowpalWabbitRegressor,
                                    model_from_state)
from synapseml_tpu_torch.vw import learner as port
from synapseml_tpu_torch.vw.estimators import parse_vw_args
from synapseml_tpu_torch.vw.learner import (LOSSES, StepHyper, StepPlan, StepState,
                                            pad_examples, predict_linear, train_linear)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# |port - reference| over w, g2, bias, bias_g2 and scale, relative to
# max(1, |reference|): the causes are in the module docstring; over
# test_train_linear_matches_reference's 48 fits the largest is 6.4e-7
W_TOL = 1e-5


def _auc(y, p):
    return METRICS["auc"][0](y, p, np.ones(len(y)))


def _close(a, b, tol=W_TOL) -> None:
    for f, x, y in zip(a._fields, a, b):
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        err = np.abs(x - y) / np.maximum(1.0, np.abs(x))
        assert float(err.max(initial=0.0)) <= tol, (f, float(err.max()))


@pytest.fixture(scope="module")
def tabular():
    rng = np.random.default_rng(0)
    n = 3000
    age = rng.uniform(18, 80, n)
    income = rng.normal(50, 15, n)
    city = rng.choice(["nyc", "sf", "chi", "austin"], n)
    logit = 0.06 * (age - 50) + 0.05 * (income - 50) + np.where(city == "sf", 1.0, 0.0)
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(float)
    yr = logit + rng.normal(scale=0.3, size=n)
    return Table({"age": age, "income": income, "city": city, "label": y}), y, yr


# -- tests/test_vw.py, on the port ---------------------------------------------------

def test_featurizer_column_kinds():
    t = Table({
        "num": np.array([1.5, 2.5]),
        "cat": np.array(["a", "b"], dtype=object),
        "txt": np.array(["red fast", "slow"], dtype=object),
        "vec": np.array([[1.0, 2.0], [3.0, 4.0]]),
        "map": np.array([{"k": 2.0, "c": "x"}, {"k": 3.0}], dtype=object),
    })
    f = VowpalWabbitFeaturizer(input_cols=["num", "cat", "txt", "vec", "map"],
                               string_split_cols=["txt"], output_col="features")
    out = f.transform(t)
    i0, v0 = out["features"][0]
    i1, v1 = out["features"][1]
    assert len(i0) == 8 and len(v0) == 8
    assert len(i1) == 6
    assert i0.dtype == np.uint32 and v0.dtype == np.float32
    t2 = Table({"cat": np.array(["a"], dtype=object)})
    o2 = VowpalWabbitFeaturizer(input_cols=["cat"], output_col="f").transform(t2)
    assert o2["f"][0][0][0] in i0


def test_featurizer_deterministic_seeded():
    t = Table({"c": np.array(["x", "y"], dtype=object)})
    f1 = VowpalWabbitFeaturizer(input_cols=["c"], output_col="f", hash_seed=1)
    f2 = VowpalWabbitFeaturizer(input_cols=["c"], output_col="f", hash_seed=2)
    a = f1.transform(t)["f"][0][0]
    b = f2.transform(t)["f"][0][0]
    assert (a != b).any()
    np.testing.assert_array_equal(a, f1.transform(t)["f"][0][0])


def test_interactions():
    t = Table({"a": np.array(["p", "q"], dtype=object),
               "b": np.array([[1.0, 2.0], [3.0, 4.0]])})
    ft = VowpalWabbitFeaturizer(input_cols=["a"], output_col="fa").transform(t)
    ft = VowpalWabbitFeaturizer(input_cols=["b"], output_col="fb").transform(ft)
    out = VowpalWabbitInteractions(input_cols=["fa", "fb"], output_col="fx").transform(ft)
    ix, vx = out["fx"][0]
    assert len(ix) == 2
    np.testing.assert_allclose(sorted(vx), [1.0, 2.0])
    assert np.all(ix < (1 << 30))


def _linear_rows(seed, n=2048, K=4, bits=10):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << bits, size=(n, K)).astype(np.int32)
    val = rng.normal(size=(n, K)).astype(np.float32)
    w_true = rng.normal(size=1 << bits).astype(np.float32)
    return idx, val, (np.take(w_true, idx) * val).sum(1)


def test_linear_learner_recovers_weights():
    idx, val, y = _linear_rows(2)
    st = train_linear(idx, val, y, num_bits=10, num_passes=16, device="cpu")
    p = predict_linear(st, idx, val)
    assert 1 - np.var(y - p) / np.var(y) > 0.95


def test_pad_examples_masks_bits():
    col = np.empty(2, dtype=object)
    col[0] = (np.array([2 ** 30, 5], np.uint32), np.array([1.0, 2.0], np.float32))
    col[1] = (np.array([7], np.uint32), np.array([3.0], np.float32))
    idx, val = pad_examples(col, 10)
    assert idx.shape == (2, 2)
    assert idx.max() < 1 << 10
    assert val[1, 1] == 0.0


def test_vw_classifier_pipeline(tabular, tmp_path):
    t, y, _ = tabular
    feat = VowpalWabbitFeaturizer(input_cols=["age", "income", "city"], output_col="features")
    m = Pipeline([feat, VowpalWabbitClassifier(num_passes=5, device="cpu")]).fit(t)
    out = m.transform(t)
    assert _auc(y, out["probability"][:, 1].astype(float)) > 0.9
    p = str(tmp_path / "vw")
    m.save(p)
    out2 = load_stage(p).transform(t)
    np.testing.assert_array_equal(out2["probability"], out["probability"])
    np.testing.assert_array_equal(out2["prediction"], out["prediction"])


def test_vw_regressor_raw_scale_features(tabular):
    t, _, yr = tabular
    t2 = t.with_column("label", yr)
    feat = VowpalWabbitFeaturizer(input_cols=["age", "income"], output_col="features")
    m = Pipeline([feat, VowpalWabbitRegressor(num_passes=10, device="cpu")]).fit(t2)
    rmse = np.sqrt(np.mean((m.transform(t2)["prediction"] - yr) ** 2))
    assert rmse < 0.5 * np.std(yr)


def test_vw_quantile_regression_coverage():
    rng = np.random.default_rng(11)
    n = 4000
    x = rng.uniform(0, 2, n)
    yq = x + rng.exponential(1.0, n)
    t = Table({"x": x, "label": yq})
    feat = VowpalWabbitFeaturizer(input_cols=["x"], output_col="features")
    for tau, lo, hi in [(0.9, 0.8, 0.99), (0.1, 0.01, 0.25)]:
        m = Pipeline([feat, VowpalWabbitRegressor(
            num_passes=20, device="cpu",
            pass_through_args=f"--loss_function quantile --quantile_tau {tau}",
        )]).fit(t)
        cover = float((yq <= np.asarray(m.transform(t)["prediction"])).mean())
        assert lo < cover < hi, (tau, cover)


def test_vw_args_passthrough():
    assert parse_vw_args("--loss_function hinge -b 20 --passes 3 -l 0.1") == {
        "loss_function": "hinge", "num_bits": 20, "num_passes": 3, "learning_rate": 0.1}
    with pytest.raises(ValueError):
        parse_vw_args("--passes")


def _bandit_columns(n=2000, K=3, seed=4):
    rng = np.random.default_rng(seed)
    ctx = rng.integers(0, 2, size=n)
    shared = np.empty(n, dtype=object)
    acts = np.empty(n, dtype=object)
    best = np.where(ctx == 0, 0, 2)
    chosen = rng.integers(1, K + 1, n)
    cost = np.where(chosen - 1 == best, 0.0, 1.0)
    for r in range(n):
        shared[r] = (np.array([100 + ctx[r]], np.uint32), np.ones(1, np.float32))
        acts[r] = [(np.array([200 + a, 1000 + 10 * ctx[r] + a], np.uint32),
                    np.ones(2, np.float32)) for a in range(K)]
    cols = {"shared": shared, "actionFeatures": acts, "chosenAction": chosen,
            "label": cost, "probability": np.full(n, 1 / K)}
    return cols, best


def test_vw_contextual_bandit():
    cols, best = _bandit_columns()
    cb = VowpalWabbitContextualBandit(features_col="actionFeatures", num_passes=5,
                                      device="cpu")
    out = cb.fit(Table(cols)).transform(Table(cols))
    picked = np.array([np.argmax(p) for p in out["prediction"]])
    assert (picked == best).mean() > 0.9
    np.testing.assert_allclose(out["prediction"][0].sum(), 1.0, rtol=1e-5)


def test_vw_additional_features(tabular):
    t, y, _ = tabular
    f1 = VowpalWabbitFeaturizer(input_cols=["age", "income"], output_col="f1")
    f2 = VowpalWabbitFeaturizer(input_cols=["city"], output_col="f2")
    tt = f2.transform(f1.transform(t))
    clf = VowpalWabbitClassifier(features_col="f1", additional_features=["f2"],
                                 num_passes=5, device="cpu")
    m = clf.fit(tt)
    assert _auc(y, m.transform(tt)["probability"][:, 1].astype(float)) > 0.9


def test_vector_zipper():
    t = Table({"a": np.array([1.0, 2.0]), "b": np.array([3.0, 4.0])})
    out = VectorZipper(input_cols=["a", "b"], output_col="z").transform(t)
    assert out["z"][0] == [1.0, 3.0] and out["z"][1] == [2.0, 4.0]
    t2 = Table({"a": np.array([1.0]), "s": np.array(["x"], dtype=object)})
    with pytest.raises(ValueError, match="share a type"):
        VectorZipper(input_cols=["a", "s"]).transform(t2)
    with pytest.raises(ValueError, match="empty"):
        VectorZipper().transform(t)


# -- tests/test_gbdt_crosscheck.py's VW tests, on the port ---------------------------------

def _dense_as_sparse(x, mask_bits=10):
    col = np.empty(len(x), dtype=object)
    idxs = np.arange(x.shape[1], dtype=np.uint32)
    for i in range(len(x)):
        col[i] = (idxs, x[i].astype(np.float32))
    return pad_examples(col, mask_bits=mask_bits)


def test_vw_classifier_matches_sklearn_sgd():
    """As the reference's, labels in {0, 1}: the logistic loss expects +-1,
    so the negatives give zero gradient (ROADMAP queue 3); the port
    reproduces it as parity."""
    from sklearn.linear_model import SGDClassifier

    rng = np.random.default_rng(83)
    n, d = 4000, 30
    x = rng.normal(size=(n, d))
    w_true = rng.normal(size=d) * (rng.random(d) < 0.5)
    y = (x @ w_true + 0.5 * rng.normal(size=n) > 0).astype(np.float64)
    tr, te = slice(0, 3000), slice(3000, None)
    idx_pad, val_pad = _dense_as_sparse(x)
    st = train_linear(idx_pad[tr], val_pad[tr], y[tr], num_bits=10, loss="logistic",
                      num_passes=5, learning_rate=0.5, device="cpu")
    ours = _auc(y[te], predict_linear(st, idx_pad[te], val_pad[te]))
    sk = SGDClassifier(loss="log_loss", max_iter=5, tol=None, random_state=0)
    sk.fit(x[tr], y[tr])
    theirs = _auc(y[te], sk.decision_function(x[te]))
    assert ours >= theirs - 0.02, (ours, theirs)
    assert ours > 0.9, ours


def test_vw_regressor_matches_sklearn_sgd():
    from sklearn.linear_model import SGDRegressor

    rng = np.random.default_rng(84)
    n, d = 4000, 25
    x = rng.normal(size=(n, d))
    w_true = rng.normal(size=d)
    y = x @ w_true + 0.3 * rng.normal(size=n)
    tr, te = slice(0, 3000), slice(3000, None)
    idx_pad, val_pad = _dense_as_sparse(x)
    st = train_linear(idx_pad[tr], val_pad[tr], y[tr], num_bits=10, loss="squared",
                      num_passes=5, learning_rate=1.0, device="cpu")
    ours = float(np.sqrt(np.mean((predict_linear(st, idx_pad[te], val_pad[te]) - y[te]) ** 2)))
    sk = SGDRegressor(max_iter=5, tol=None, random_state=0)
    sk.fit(x[tr], y[tr])
    theirs = float(np.sqrt(np.mean((sk.predict(x[te]) - y[te]) ** 2)))
    assert ours <= theirs * 1.15, (ours, theirs)


# -- bit for bit against the reference ----------------------------------------------------

def _kinds_table(table_cls, n=40, seed=1):
    rng = np.random.default_rng(seed)
    words = np.array(["red", "fast", "slow", "blue", "é", "x"], dtype=object)
    txt = np.array([" ".join(rng.choice(words, rng.integers(0, 5))) for _ in range(n)],
                   dtype=object)
    maps = np.empty(n, dtype=object)
    pairs = np.empty(n, dtype=object)
    objs = np.empty(n, dtype=object)
    for r in range(n):
        maps[r] = {"k": float(rng.normal()), "c": str(rng.choice(words)), "z": float(r)}
        k = int(rng.integers(0, 4))
        pairs[r] = (rng.integers(0, 2 ** 32, k, dtype=np.uint64).astype(np.uint32),
                    rng.normal(size=k).astype(np.float32))
        objs[r] = (None if r % 7 == 0 else [1.5, -2.0] if r % 3 else float(r))
    return table_cls({
        "num": rng.normal(size=n), "cat": rng.choice(words, n).astype(object), "txt": txt,
        "vec": rng.normal(size=(n, 3)), "mat": rng.normal(size=(n, 2, 2)), "map": maps,
        "pairs": pairs, "obj": objs})


@pytest.mark.parametrize("sum_collisions", [True, False])
@pytest.mark.parametrize("seed", [0, 7])
def test_featurizer_bit_equal(sum_collisions, seed):
    """Every column kind (numeric, string, split text, vector, matrix, map,
    (indices, values) pairs, an object column of None / lists / scalars)."""
    cols = ["num", "cat", "txt", "vec", "mat", "map", "pairs", "obj", "cat"]
    kw = dict(input_cols=cols, string_split_cols=["txt"], output_col="f", hash_seed=seed,
              sum_collisions=sum_collisions)
    a = ref_feat.VowpalWabbitFeaturizer(**kw).transform(_kinds_table(RefTable))["f"]
    b = VowpalWabbitFeaturizer(**kw).transform(_kinds_table(Table))["f"]
    for (ia, va), (ib, vb) in zip(a, b):
        assert ib.dtype == ia.dtype and vb.dtype == va.dtype
        np.testing.assert_array_equal(ib, ia)
        np.testing.assert_array_equal(vb.view(np.int32), va.view(np.int32))


@pytest.mark.parametrize("sum_collisions", [True, False])
@pytest.mark.parametrize("num_bits", [30, 6])
def test_interactions_bit_equal(sum_collisions, num_bits):
    def run(table_cls, feat_cls, inter_cls):
        t = _kinds_table(table_cls)
        t = feat_cls(input_cols=["cat", "txt"], string_split_cols=["txt"],
                     output_col="fa").transform(t)
        t = feat_cls(input_cols=["vec", "num"], output_col="fb").transform(t)
        t = feat_cls(input_cols=["map"], output_col="fc").transform(t)
        return inter_cls(input_cols=["fa", "fb", "fc"], output_col="fx", num_bits=num_bits,
                         sum_collisions=sum_collisions).transform(t)["fx"]

    a = run(RefTable, ref_feat.VowpalWabbitFeaturizer, ref_feat.VowpalWabbitInteractions)
    b = run(Table, VowpalWabbitFeaturizer, VowpalWabbitInteractions)
    for (ia, va), (ib, vb) in zip(a, b):
        np.testing.assert_array_equal(ib, ia)
        np.testing.assert_array_equal(vb.view(np.int32), va.view(np.int32))


def test_pad_examples_bit_equal():
    """Masking, padding, empty rows, mixed index dtypes, f64 values."""
    rng = np.random.default_rng(3)
    col = np.empty(60, dtype=object)
    for r in range(60):
        k = int(rng.integers(0, 9))
        ind = rng.integers(0, 2 ** 32, k, dtype=np.uint64)
        ind = ind.astype(np.uint32) if r % 2 else (ind % (2 ** 31)).astype(np.int64)
        col[r] = (ind, rng.normal(size=k) if r % 3 else rng.normal(size=k).astype(np.float32))
    for bits in (4, 18, 31):
        ia, va = ref.pad_examples(col, bits)
        ib, vb = pad_examples(col, bits)
        assert ib.dtype == ia.dtype and vb.dtype == va.dtype
        np.testing.assert_array_equal(ib, ia)
        np.testing.assert_array_equal(vb.view(np.int32), va.view(np.int32))
    empty = np.empty(3, dtype=object)
    for r in range(3):
        empty[r] = (np.empty(0, np.uint32), np.empty(0, np.float32))
    for a, b in zip(ref.pad_examples(empty, 8), pad_examples(empty, 8)):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("link", [None, "identity", "logistic"])
def test_predict_linear_bit_equal(link):
    idx, val, y = _linear_rows(5, n=700, K=6)
    st = ref.train_linear(idx, val, y, num_bits=10, num_passes=2)
    a = ref.predict_linear(st, idx, val, link=link)
    b = predict_linear(port.LinearLearnerState(*(np.asarray(s) for s in st)), idx, val,
                       link=link)
    assert b.dtype == a.dtype
    np.testing.assert_array_equal(b, a)


# -- train_linear against the reference -----------------------------------------------

def _init_state(bits, seed=9):
    rng = np.random.default_rng(seed)
    dim = 1 << bits
    scale = (rng.random(dim) * 2).astype(np.float32)
    scale[: dim // 4] = 0
    return port.LinearLearnerState(
        (rng.normal(size=dim) * 0.3).astype(np.float32),
        (rng.random(dim) + 0.1).astype(np.float32), np.asarray(np.float32(0.2)),
        np.asarray(np.float32(0.7)), scale)


def _fit_pair(case, loss, regime, passes, init, batch_size=256):
    idx, val, y_reg, y_pm1 = vw_step_case(case, 10)
    y = y_pm1 if loss in ("logistic", "hinge") else y_reg
    l1, l2 = VW_REGIMES[regime]
    kw = dict(num_bits=10, loss=loss, l1=l1, l2=l2, num_passes=passes, quantile_tau=0.25,
              batch_size=batch_size)
    init_state = _init_state(10) if init else None
    a = ref.train_linear(idx, val, y, init_state=None if init_state is None else
                         ref.LinearLearnerState(*init_state), **kw)
    b = train_linear(idx, val, y, init_state=init_state, device="cpu", **kw)
    return ref.LinearLearnerState(*(np.asarray(s) for s in a)), b


@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("regime", ["sparse", "l1", "l2"])
@pytest.mark.parametrize("loss", LOSSES)
def test_train_linear_matches_reference(loss, regime, passes, init):
    a, b = _fit_pair("slot0_feature", loss, regime, passes, init)
    _close(a, b)


def _xla_step_w(w, g, g2n, hp):
    """The reference's weight step as XLA computes it: fused subtractions
    with XLA's rsqrt."""
    r = torch.from_numpy(np.array(jax.lax.rsqrt(jnp.asarray(g2n.numpy()))))
    wn = port.fma_f32(-(hp.lr * g), r, w)
    if hp.l1:
        shrink = port.fma_f32(torch.full_like(wn, -hp.lr_l1), r, wn.abs())
        wn = port._sign(wn) * torch.clamp_min(shrink, 0.0)
    return wn


def _xla_step_b(b, gb, bg2n, hp):
    r = torch.from_numpy(np.array(jax.lax.rsqrt(jnp.asarray(bg2n.reshape(1).numpy()))))
    return port.fma_f32(-(hp.lr * gb).reshape(1), r, b.reshape(1))[0]


@pytest.mark.parametrize("regime", sorted(VW_REGIMES))
@pytest.mark.parametrize("loss", ["hinge", "quantile"])
@pytest.mark.parametrize("case", ["dup_within_row", "slot0_feature", "tail_padding_rows"])
def test_train_linear_bit_equal_with_xla_rsqrt(monkeypatch, case, loss, regime):
    """With XLA's rsqrt and its fused subtractions patched in, the port's
    step is the reference's bit for bit (gradients that sum exactly in any
    order: +-w and 0.75 w / -0.25 w at tau = 0.25, so the bias sum's order
    does not show): the scatter's row-major
    order, its start at l2 * w, the fused g2 and the prediction's fma chain,
    padding and duplicate slots included."""
    monkeypatch.setattr(port, "_step_w", _xla_step_w)
    monkeypatch.setattr(port, "_step_b", _xla_step_b)
    a, b = _fit_pair(case, loss, regime, 2, init=True)
    assert not vw_state_differs(a, b)


def test_train_linear_leaves_the_init_state():
    """A fit from an init state leaves the caller's arrays as they were (the
    device state is a copy, the scales included)."""
    init = _init_state(10)
    before = [np.array(x, copy=True) for x in init]
    idx, val, y_reg, _ = vw_step_case("slot0_feature", 10)
    train_linear(idx, val, y_reg, num_bits=10, init_state=init, device="cpu")
    assert not vw_state_differs(port.LinearLearnerState(*before), init)


def test_train_linear_rejects_bad_input():
    idx, val, y = _linear_rows(1, n=10)
    with pytest.raises(ValueError, match="feature index"):
        train_linear(idx + 1024, val, y, num_bits=10, device="cpu")
    bad = val.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="finite"):
        train_linear(idx, bad, y, num_bits=10, device="cpu")
    with pytest.raises(ValueError, match="unknown loss"):
        train_linear(idx, val, y, num_bits=10, loss="poisson", device="cpu")


def test_train_linear_defaults_to_the_card():
    from synapseml_tpu_torch.runtime.device import DeviceUnavailableError

    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    idx, val, y = _linear_rows(1, n=10)
    with pytest.raises(DeviceUnavailableError):
        train_linear(idx, val, y, num_bits=10)
    with pytest.raises(DeviceUnavailableError):
        VowpalWabbitRegressor().fit(Table({"features": _pairs(idx, val), "label": y}))


def _pairs(idx, val):
    col = np.empty(len(idx), dtype=object)
    for r in range(len(idx)):
        col[r] = (idx[r].astype(np.uint32), val[r])
    return col


# -- the estimators, their save/load and model_from_state ------------------------------

def _ref_and_port_models(kind, tabular, tmp_path):
    t, y, yr = tabular
    cols = {"age": t["age"], "income": t["income"], "city": t["city"]}
    ref_t = ref_feat.VowpalWabbitFeaturizer(input_cols=["age", "income", "city"],
                                            output_col="features").transform(RefTable(
                                                dict(cols, label=y if kind == "classifier"
                                                     else yr)))
    est = (ref_est.VowpalWabbitClassifier if kind == "classifier"
           else ref_est.VowpalWabbitRegressor)(num_passes=3)
    m = est.fit(ref_t)
    state = m.state._asdict() if hasattr(m.state, "_asdict") else m.state
    labels = getattr(m, "labels", None)
    pm = model_from_state(kind, {k: np.asarray(v) for k, v in state.items()},
                          labels=None if labels is None else np.asarray(labels))
    port_t = Table({"features": ref_t["features"]})
    return m, pm, ref_t, port_t


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_model_from_state_scores_bit_equal(kind, tabular, tmp_path):
    m, pm, ref_t, port_t = _ref_and_port_models(kind, tabular, tmp_path)
    a, b = m.transform(ref_t), pm.transform(port_t)
    for col in (("rawPrediction", "probability", "prediction") if kind == "classifier"
                else ("prediction",)):
        np.testing.assert_array_equal(np.asarray(b[col]), np.asarray(a[col]))
    p = str(tmp_path / kind)
    pm.save(p)
    c = load_stage(p).transform(port_t)
    for col in b.column_names:
        np.testing.assert_array_equal(np.asarray(c[col]), np.asarray(b[col]))


def test_model_from_state_bandit_bit_equal(tmp_path):
    cols, _ = _bandit_columns(n=300)
    m = ref_est.VowpalWabbitContextualBandit(features_col="actionFeatures",
                                             num_passes=2).fit(RefTable(cols))
    pm = model_from_state("contextual_bandit",
                          {k: np.asarray(v) for k, v in m.state._asdict().items()},
                          features_col="actionFeatures", epsilon=m.epsilon)
    a = m.transform(RefTable(cols))["prediction"]
    b = pm.transform(Table(cols))["prediction"]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(y, x)
    with pytest.raises(ValueError, match="labels"):
        model_from_state("classifier", m.state._asdict())


@pytest.mark.parametrize("cls", ["classifier", "regressor", "bandit"])
def test_estimator_transform_matches_reference(cls, tabular, tmp_path):
    """The port's fit against the reference's on the same table: the
    states within W_TOL and the transforms close; save/load of the port's
    estimator and model round-trips."""
    if cls == "bandit":
        cols, _ = _bandit_columns(n=600)
        kw = dict(features_col="actionFeatures", num_passes=2)
        a = ref_est.VowpalWabbitContextualBandit(**kw).fit(RefTable(cols))
        est = VowpalWabbitContextualBandit(device="cpu", **kw)
        b = est.fit(Table(cols))
        ta, tb = RefTable(cols), Table(cols)
    else:
        t, y, yr = tabular
        lab = y if cls == "classifier" else yr
        raw = {"age": t["age"], "income": t["income"], "city": t["city"], "label": lab}
        fk = dict(input_cols=["age", "income", "city"], output_col="features")
        ta = ref_feat.VowpalWabbitFeaturizer(**fk).transform(RefTable(raw))
        tb = VowpalWabbitFeaturizer(**fk).transform(Table(raw))
        ref_cls = (ref_est.VowpalWabbitClassifier if cls == "classifier"
                   else ref_est.VowpalWabbitRegressor)
        port_cls = VowpalWabbitClassifier if cls == "classifier" else VowpalWabbitRegressor
        a = ref_cls(num_passes=2, l2=1e-3).fit(ta)
        est = port_cls(num_passes=2, l2=1e-3, device="cpu")
        b = est.fit(tb)
    _close(port.LinearLearnerState(*(np.asarray(s) for s in a.state)), b.state)
    stats = b.performance_statistics
    assert stats["device"] == "cpu" and stats["kernel_launches"] == 0
    assert stats["batches_a_pass"] >= 1 and stats["pad_examples_s"] >= 0
    oa, ob = a.transform(ta), b.transform(tb)
    np.testing.assert_allclose(np.stack(list(ob["prediction"])).astype(np.float64),
                               np.stack(list(oa["prediction"])).astype(np.float64),
                               atol=1e-3)
    for stage in (est, b):
        p = str(tmp_path / type(stage).__name__)
        stage.save(p)
        back = load_stage(p)
        assert type(back) is type(stage)
        assert back.simple_param_values() == stage.simple_param_values()
    back = load_stage(str(tmp_path / type(b).__name__))
    for col in ob.column_names:
        x, y = np.asarray(ob[col]), np.asarray(back.transform(tb)[col])
        if x.dtype == object:
            for u, v in zip(x, y):
                np.testing.assert_array_equal(v, u)
        else:
            np.testing.assert_array_equal(y, x)


def test_stages_registered():
    from synapseml_tpu_torch.core import STAGE_REGISTRY

    for name in ("VowpalWabbitClassifier", "VowpalWabbitClassificationModel",
                 "VowpalWabbitRegressor", "VowpalWabbitRegressionModel",
                 "VowpalWabbitContextualBandit", "VowpalWabbitContextualBanditModel",
                 "VowpalWabbitFeaturizer", "VowpalWabbitInteractions", "VectorZipper"):
        assert STAGE_REGISTRY[name].__module__.startswith("synapseml_tpu_torch.vw."), name


# -- kernel V's schedule, modelled on the CPU ----------------------------------------------

_NEUTRAL = -0.0  # x + (-0) = x for every x: the kernel's skipped term


def _vw_batches(case, bits, rows=None, batch=None):
    """(bi, bv, by_reg, by_pm1, bw) of a case cut into its batches of
    ``batch`` rows (default: the case's; the last one padded with zero rows
    of weight 0), at most ``rows`` rows."""
    idx, val, y_reg, y_pm1 = vw_step_case(case, bits)
    B = batch or vw_case_batch(case)
    n = len(idx) if rows is None else min(rows, len(idx))
    nb = -(-n // B)

    def cut(a):
        out = np.zeros((nb * B,) + a.shape[1:], a.dtype)
        out[:n] = a[:n]
        return torch.from_numpy(out.reshape((nb, B) + a.shape[1:]))

    return (cut(idx), cut(val), cut(y_reg.astype(np.float32)), cut(y_pm1.astype(np.float32)),
            cut(np.ones(len(idx), np.float32)))


def _model_step(w, g2, g, hp):
    """csrc/vw_step.cu's step_slot over tensors: the slots' new (w, g2)."""
    g2n = port.fma_f32(g, g, g2)
    root = port.sqrt_f32(g2n)
    wn = w - (hp.lr * g) / root
    if hp.l1:
        m = wn.abs() - torch.full_like(root, hp.lr_l1) / root
        m = torch.where((m > 0) | torch.isnan(m), m, 0.0)
        wn = torch.where(wn > 0, 1.0, torch.where(wn < 0, -1.0, wn)) * m
    return wn, g2n


def _ordered_sums(g, terms, lens):
    """Each list's sum in its order: ``g[l]`` plus ``terms[l, 0..lens[l])``
    one add at a time (the lists side by side, as the kernel's threads and
    warps run)."""
    for e in range(int(lens.max()) if len(lens) else 0):
        on = lens > e
        g[on] = g[on] + terms[on, e]
    return g


def _kernel_model(st: StepState, bi, bv, by, bw, hp, plan: StepPlan, j0, j1):
    """One launch of kernel V over the plan's batches [j0, j1) (``bi`` ...
    ``bw`` hold them, batch j0 first), on the CPU in the source's schedule,
    the state carried from batch to batch as in the persistent kernel:
    - rows, a warp a row: the gathers of a 128-entry chunk at once, each
      entry's bvn, the live (w, bvn) pairs compacted in k order with a
      neutral pair (-0, +0) after an odd count, then the fma chain over the
      pairs; one fma of w[0] by +0 for a padded row; the padding flags;
    - slots: the short lists (a thread each) and then the long lists (a
      warp each: the terms of a 128-entry chunk computed at once, then
      added in order in groups of four, -0 past the list's end); slot 0's
      flag term; the bias summed pairwise;
    - the dense regime: every slot not marked with the batch's place in the
      launch (the marks are -1 when a launch starts)."""
    B, K = plan.ebm.shape[1:]
    P = 1 << max(B - 1, 0).bit_length()
    w, g2, s, bias = st.w, st.g2, st.s, st.bias
    mark = torch.full((st.dim,), -1)
    chunk = 128
    for j in range(j0, j1):
        jj = epoch = j - j0
        idx, val, ebm = bi[jj], bv[jj], plan.ebm[j]
        # 1. rows
        drop = port._dropped(idx, val)
        live = ~drop
        bvn = val / torch.clamp_min(torch.maximum(s[idx.long()], ebm), 1e-12)
        acc = torch.zeros(B)
        for k0 in range(0, K, chunk):
            lv = live[:, k0:k0 + chunk]
            at = torch.cumsum(lv.long(), 1) - 1
            n = int(lv.sum(1).max())
            pw = torch.full((B, n + 1), _NEUTRAL)
            pb = torch.zeros(B, n + 1)
            r, k = torch.nonzero(lv, as_tuple=True)
            pw[r, at[r, k]] = w[idx[:, k0:k0 + chunk].long()][r, k]
            pb[r, at[r, k]] = bvn[:, k0:k0 + chunk][r, k]
            for q in range(n + (n & 1)):
                acc = port.fma_f32(pw[:, q], pb[:, q], acc)
        padded = drop.any(1)
        acc = torch.where(padded, port.fma_f32(w[:1].expand(B), torch.zeros(B), acc), acc)
        dl = port._loss_grad(hp, acc + bias[0], by[jj], bw[jj])
        z = dl[padded] * 0.0
        flags = (1 if bool(torch.isnan(z).any()) else 0) | \
                (2 if bool((~torch.isnan(z) & ~torch.signbit(z)).any()) else 0)
        # 2. slots: the short lists, then the long ones
        u0, u1 = plan.ranges[j]
        ul = plan.long_from[j]
        new_w, new_g2 = w.clone(), g2.clone()
        for a, b, width in ((u0, ul, 8), (ul, u1, chunk)):
            if a == b:
                continue
            slots = plan.uslot[a:b].long()
            sn = torch.maximum(s[slots], plan.umax[a:b])
            den = torch.clamp_min(sn, 1e-12)
            starts, ends = plan.useg[a:b].long(), plan.useg[a + 1:b + 1].long()
            # whole groups: a thread's eight loads, a warp's adds four at a time
            group = 8 if width == 8 else 4
            lens = -(-(ends - starts) // group) * group
            pos = starts[:, None] + torch.arange(int(lens.max()))[None, :]
            inside = pos < ends[:, None]
            p = torch.where(inside, plan.ent[pos.clamp_max(plan.entries - 1)].long(), -1)
            ev = plan.evals[pos.clamp_max(plan.entries - 1)]
            terms = torch.where(p >= 0, dl[(p // K).clamp_min(0)] * (ev / den[:, None]),
                                _NEUTRAL)
            g = hp.l2 * w[slots] if (hp.dense and hp.l2) else torch.zeros(len(slots))
            g = _ordered_sums(g, terms, lens)
            zero = slots == 0
            if zero.any() and flags:
                g[zero] = g[zero] + (np.nan if flags & 1 else 0.0)
            s[slots] = sn
            new_w[slots], new_g2[slots] = _model_step(w[slots], g2[slots], g, hp)
            if hp.dense:
                mark[slots] = epoch
        total = dl.new_zeros(P)
        total[:B] = dl
        while len(total) > 1:
            total = total[0::2] + total[1::2]
        gb = total[0] / torch.full_like(total[0], float(B))
        bg2n = port.fma_f32(gb, gb, bias[1])
        bias.copy_(torch.stack([bias[0] - (hp.lr * gb) / port.sqrt_f32(bg2n), bg2n]))
        w.copy_(new_w)
        g2.copy_(new_g2)
        # 3. the dense regime's untouched slots
        if hp.dense:
            rest = mark != epoch
            g = hp.l2 * w[rest] if hp.l2 else torch.zeros(int(rest.sum()))
            w[rest], g2[rest] = _model_step(w[rest], g2[rest], g, hp)


@pytest.mark.parametrize("long_list", [4, 32])
@pytest.mark.parametrize("case", VW_STEP_CASES)
def test_step_plan_short_and_long_lists(case, long_list):
    """Each batch's distinct slots are in exactly one of its short lists (at
    most ``long_list`` entries, the longest first, then by slot) and its
    long lists (more, by slot), short first; every real entry in its slot's
    list once, in row-major order, with its value; slot 0 listed wherever
    the batch has padding; each batch's slots and entries in ``bounds``."""
    bi, bv, _, _, _ = _vw_batches(case, 10)
    nb, B, K = bi.shape
    plan = StepPlan(bi, bv, 1 << 10, long_list)
    ent, useg = plan.ent.numpy(), plan.useg.numpy()
    uslot, evals = plan.uslot.numpy(), plan.evals.numpy()
    assert plan.ulong.tolist() == plan.long_from
    assert plan.bounds.tolist() == [[u0, u1, int(useg[u0]), int(useg[u1])]
                                    for u0, u1 in plan.ranges]
    for j, (u0, u1) in enumerate(plan.ranges):
        ul = plan.long_from[j]
        assert u0 <= ul <= u1
        idx, val = bi[j].reshape(-1).numpy(), bv[j].reshape(-1).numpy()
        real = ~port._dropped(bi[j], bv[j]).reshape(-1).numpy()
        want = set(idx[real].tolist()) | ({0} if not real.all() else set())
        sizes = np.diff(useg[u0:u1 + 1])
        assert np.all(sizes[:ul - u0] <= long_list) and np.all(sizes[ul - u0:] > long_list)
        short = np.diff(sizes[:ul - u0])
        assert np.all(short <= 0) and np.all(np.diff(uslot[u0:ul])[short == 0] > 0)
        assert np.all(np.diff(uslot[ul:u1]) > 0)
        assert set(uslot[u0:u1].tolist()) == want and len(uslot[u0:u1]) == len(want)
        seen = []
        for u in range(u0, u1):
            e = ent[useg[u]:useg[u + 1]]
            v = evals[useg[u]:useg[u + 1]]
            live = e >= 0
            assert np.all(np.diff(e[live]) > 0)
            assert np.all(idx[e[live]] == uslot[u])
            assert np.array_equal(v[live].view(np.int32), val[e[live]].view(np.int32))
            assert live.all() or (uslot[u] == 0 and (~live).sum() == 1)
            seen += e[live].tolist()
        assert sorted(seen) == np.nonzero(real)[0].tolist()


@pytest.mark.parametrize("regime", sorted(VW_REGIMES))
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("case", [c for c in VW_STEP_CASES if c != "hashed_text"])
def test_kernel_schedule_model_equals_plain(case, loss, regime):
    """Kernel V's schedule (``_kernel_model``): two batches at 2^6 slots
    (many shared slots, long lists), the second partial, carried in one
    launch, against :func:`batch_step_plain` a batch, bit for bit."""
    B = vw_case_batch(case)
    bi, bv, by_reg, by_pm1, bw = _vw_batches(case, 6, rows=B + 44)
    by = by_pm1 if loss in ("logistic", "hinge") else by_reg
    nb = len(bi)
    l1, l2 = VW_REGIMES[regime]
    hp = StepHyper.make(loss, 0.5, l1, l2, 0.25)
    init = _init_state(6)
    init = init._replace(w=init.w * init.scale)
    a, b = StepState(*init, device="cpu"), StepState(*init, device="cpu")
    plan = StepPlan(bi, bv, 1 << 6)
    for j in range(nb):
        port.batch_step_plain(a, bi[j], bv[j], by[j], bw[j], hp)
    _kernel_model(b, bi, bv, by, bw, hp, plan, 0, nb)
    assert not vw_state_differs(a.numpy(), b.numpy())


@pytest.mark.parametrize("regime", ["sparse", "l1_l2"])
@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("case", ["slot0_feature", "warp_paths"])
@pytest.mark.parametrize("batch", VW_ODD_BATCHES)
def test_kernel_schedule_model_batch_sizes(batch, case, loss, regime):
    """Kernel V's schedule at batch sizes that reach its other branches (a
    bias summed by shuffles alone at 8 and 32 rows, blocks without rows at
    8, rows the card does not stage at 2,048): the case's first two batches
    and a part of a third (all of it past 2,048 rows: one partial batch) at
    2^6 slots, in one launch, against :func:`batch_step_plain` a batch, bit
    for bit."""
    bi, bv, by_reg, by_pm1, bw = _vw_batches(case, 6, rows=2 * batch + 3, batch=batch)
    by = by_pm1 if loss in ("logistic", "hinge") else by_reg
    l1, l2 = VW_REGIMES[regime]
    hp = StepHyper.make(loss, 0.5, l1, l2, 0.25)
    init = _init_state(6)
    init = init._replace(w=init.w * init.scale)
    a, b = StepState(*init, device="cpu"), StepState(*init, device="cpu")
    for j in range(len(bi)):
        port.batch_step_plain(a, bi[j], bv[j], by[j], bw[j], hp)
    _kernel_model(b, bi, bv, by, bw, hp, StepPlan(bi, bv, 1 << 6), 0, len(bi))
    assert not vw_state_differs(a.numpy(), b.numpy())


def test_kernel_schedule_model_nonfinite_gradient():
    """An infinite label in a padded row: NaN reaches slot 0 through the
    flags as it does through the plain version's padding term."""
    idx, val, y_reg, _ = vw_step_case("slot0_padding", 6)
    y_reg = y_reg.copy()
    y_reg[3] = np.inf
    bi = torch.from_numpy(idx[:256].copy())
    bv = torch.from_numpy(val[:256].copy())
    by = torch.from_numpy(y_reg[:256].copy())
    bw = torch.ones(256)
    hp = StepHyper.make("squared", 0.5, 0.0, 1e-2, 0.5)
    init = _init_state(6)
    init = init._replace(w=init.w * init.scale)
    a, b = StepState(*init, device="cpu"), StepState(*init, device="cpu")
    plan = StepPlan(bi[None], bv[None], 1 << 6)
    port.batch_step_plain(a, bi, bv, by, bw, hp)
    _kernel_model(b, bi[None], bv[None], by[None], bw[None], hp, plan, 0, 1)
    assert np.isnan(a.g2[0].item())
    assert not vw_state_differs(a.numpy(), b.numpy())


def test_step_batches_cpu_is_the_plain_step_a_batch():
    """:func:`step_batches` on CPU tensors: the plain step over the batches
    [j0, j1), as many calls of :func:`batch_step` would give."""
    bi, bv, by, _, bw = _vw_batches("warp_paths", 10)
    hp = StepHyper.make("squared", 0.5, 0.0, 1e-2, 0.5)
    init = _init_state(10)
    a, b = StepState(*init, device="cpu"), StepState(*init, device="cpu")
    port.step_batches(a, bi, bv, by, bw, hp, j0=1, j1=3)
    for j in (1, 2):
        port.batch_step(b, bi[j], bv[j], by[j], bw[j], hp)
    assert not vw_state_differs(a.numpy(), b.numpy())


def test_sqrt_f32_correctly_rounded():
    """The plain step's root against numpy's (IEEE sqrt) over 2^20 random
    f32 values of many magnitudes and the special values."""
    rng = np.random.default_rng(2)
    x = (rng.random(1 << 20) * 10.0 ** rng.integers(-30, 30, 1 << 20)).astype(np.float32)
    x = np.concatenate([x, np.array([0.0, np.inf, 1e-45, 3.4e38], np.float32)])
    got = port.sqrt_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), np.sqrt(x).view(np.int32))
