"""Port parity: the reference's random streams and the fits that draw from them.

The port's threefry (``gbdt/sampling.py``) against ``jax.random`` bit for
bit, GOSS's cut against ``jnp.quantile`` bit for bit, and sampled fits
(bagging, class-aware bagging, feature fraction, GOSS) against the JAX
package's ``train`` on the same numpy inputs with no mask injected: the
port draws the reference's masks itself, so the trees are identical.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from synapseml_tpu.gbdt.boost import train as ref_train
from synapseml_tpu_torch.gbdt import sampling
from synapseml_tpu_torch.gbdt.boost import train
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

PARAMS = dict(num_iterations=5, num_leaves=15, max_bin=63)
# Leaf values equal, except l2's: the reference's CPU program computes the
# pre-rounding factor as exp(k * ln 2), which misses 2**k for some k, so a
# few l2 gradients land on the neighbouring grid point (ROADMAP queue 3)
LEAF_ATOL = {"binary": 0.0, "regression": 1e-4, "quantile": 1e-6, "multiclass": 1e-4}


def _data(seed=0, n=3000, d=8):
    """The fixture of ``tests/test_torch_gbdt.py::_data``."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y_cls = (x[:, 0] + 0.4 * x[:, 5] + 0.2 * rng.normal(size=n) > 0).astype(np.float64)
    y_reg = 2 * x[:, 0] + np.sin(x[:, 1]) + 0.1 * rng.normal(size=n)
    return x, y_cls, y_reg


def _key(k):
    return tuple(int(v) for v in np.asarray(k))


@pytest.mark.parametrize("seed", [0, 3, 12345, -7, 2 ** 31 - 1])
def test_keys_match_jax(seed):
    """PRNGKey, split and fold_in over Python ints equal jax.random's keys."""
    k = jax.random.PRNGKey(seed)
    pk = sampling.prng_key(seed)
    assert _key(k) == pk
    for _ in range(3):
        k, k2 = jax.random.split(k)
        pk, pk2 = sampling.split(pk)
        assert (_key(k), _key(k2)) == (pk, pk2)
    for period in (0, 1, 7, 1000, 2 ** 32 - 1):
        assert _key(jax.random.fold_in(k, period)) == sampling.fold_in(pk, period)
    with pytest.raises(ValueError, match="32 bits"):
        sampling.prng_key(2 ** 31)


@pytest.mark.parametrize("n", [0, 1, 31, 100003])
@pytest.mark.parametrize("seed,period", [(0, 0), (3, 1), (3, 7), (99, 12)])
def test_uniform_bit_equal_to_jax(n, seed, period):
    """uniform(key, n) equals jax.random.uniform(key, (n,)) bit for bit, for
    a bagging key (fold_in) and a split key."""
    k = jax.random.fold_in(jax.random.PRNGKey(seed), period)
    pk = sampling.fold_in(sampling.prng_key(seed), period)
    for kk, pkk in ((k, pk), (jax.random.split(k)[1], sampling.split(pk)[1])):
        want = np.asarray(jax.random.uniform(kk, (n,)))
        got = sampling.uniform(pkk, n, "cpu")
        assert got.dtype == torch.float32 and got.shape == (n,)
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("n,q,ties", [(3000, 0.8, False), (3000, 0.8, True),
                                      (2, 0.9, False), (100003, 0.8, False),
                                      (7, 0.5, True), (1, 0.8, False)])
def test_goss_cut_bit_equal_to_jnp_quantile(n, q, ties):
    rng = np.random.default_rng(n)
    a = np.abs(rng.normal(size=n)).astype(np.float32)
    if ties:
        a = np.round(a * 4) / 4
    want = np.asarray(jnp.quantile(jnp.asarray(a), q))
    got = sampling.goss_cut(torch.from_numpy(a), q)
    assert got.dtype == torch.float32
    assert got.numpy().view(np.int32) == want.view(np.int32)


@pytest.mark.parametrize("n", [11, 3001])
def test_goss_cut_on_an_order_statistic(n):
    """At q = 0.8 the f32 position q * (n - 1) is an integer, so the cut is
    one of the values: the top set (|g| >= cut) includes it, as in the
    reference."""
    rng = np.random.default_rng(n)
    a = np.abs(rng.normal(size=n)).astype(np.float32)
    pos = np.float32(0.8) * np.float32(n - 1)
    assert pos == np.floor(pos)
    want = np.asarray(jnp.quantile(jnp.asarray(a), 0.8))
    got = sampling.goss_cut(torch.from_numpy(a), 0.8)
    assert got.numpy().view(np.int32) == want.view(np.int32)
    assert float(want) == np.sort(a)[int(pos)]
    np.testing.assert_array_equal((torch.from_numpy(a) >= got).numpy(), a >= want)


def _fit_pair(params, x, y, **kw):
    return ref_train(params, x, y, **kw), train(params, x, y, device="cpu", **kw)


def _assert_same_trees(ref, port, leaf_atol):
    for field in ("parent", "feature", "bin"):
        np.testing.assert_array_equal(getattr(port, field), getattr(ref, field),
                                      err_msg=field)
    np.testing.assert_allclose(port.leaf_value, ref.leaf_value, rtol=0, atol=leaf_atol)
    np.testing.assert_array_equal(port.tree_scale, ref.tree_scale)


SAMPLED = {
    "bagging_freq1": dict(bagging_fraction=0.5, bagging_freq=1),
    "bagging_freq3": dict(bagging_fraction=0.6, bagging_freq=3),
    "class_aware": dict(pos_bagging_fraction=0.5, neg_bagging_fraction=0.8, bagging_freq=1),
    "feature_fraction": dict(feature_fraction=0.6),
    "goss": dict(boosting="goss"),
    "goss_0.2_0.2": dict(boosting="goss", top_rate=0.2, other_rate=0.2),
}


@pytest.mark.parametrize("case", sorted(SAMPLED))
def test_sampled_binary_fit_matches_reference(case):
    """Binary fits that draw row and feature masks: identical trees, equal
    leaves and scales, the port's margins within 1e-6 of the reference's."""
    x, y, _ = _data()
    params = dict(PARAMS, objective="binary", **SAMPLED[case])
    ref, port = _fit_pair(params, x, y)
    _assert_same_trees(ref, port, LEAF_ATOL["binary"])
    np.testing.assert_allclose(port.raw_predict(x, device="cpu"), ref.raw_predict(x),
                               rtol=0, atol=1e-6)
    if case == "feature_fraction":
        # every split of tree t uses a feature of iteration t's mask, drawn
        # from the key schedule's k2 (the seed's key split once a tree)
        assert port.sampled_rows is None
        key, masked = sampling.prng_key(0), 0
        for t in range(PARAMS["num_iterations"]):
            key, k2 = sampling.split(key)
            mask = sampling.uniform(k2, x.shape[1], "cpu").numpy() < np.float32(0.6)
            masked += int((~mask).sum())
            assert mask[port.feature[t, 0][port.parent[t, 0] >= 0]].all()
        assert masked > 0
    else:
        assert port.sampled_rows.shape == (PARAMS["num_iterations"],)
        assert (0 < port.sampled_rows).all() and (port.sampled_rows < len(y)).all()


@pytest.mark.parametrize("objective", ["regression", "quantile"])
def test_bagged_regression_and_renewed_leaves_match_reference(objective):
    """l2 and quantile (leaves renewed as percentiles weighted by the bag)
    under bagging and feature fraction: identical trees."""
    x, _, y = _data(1)
    params = dict(PARAMS, objective=objective, alpha=0.3, bagging_fraction=0.5,
                  bagging_freq=2, feature_fraction=0.7)
    ref, port = _fit_pair(params, x, y)
    _assert_same_trees(ref, port, LEAF_ATOL[objective])


def test_bagged_multiclass_matches_reference():
    """One bag and one feature mask per iteration, shared by the C trees."""
    x, _, _ = _data(2)
    y = np.digitize(x[:, 0] + 0.5 * x[:, 3], [-0.5, 0.5]).astype(np.float64)
    params = dict(PARAMS, objective="multiclass", num_class=3, bagging_fraction=0.6,
                  bagging_freq=1, feature_fraction=0.7)
    ref, port = _fit_pair(params, x, y)
    assert port.parent.shape[:2] == (PARAMS["num_iterations"], 3)
    _assert_same_trees(ref, port, LEAF_ATOL["multiclass"])


def test_goss_off_grid_amplification_close_to_reference():
    """top_rate=0.1, other_rate=0.2: amp = 4.5 is not a power of two, so
    g * amp leaves the summation-exact grid and the order of a histogram's
    sums may move a split (on the card against the CPU). The fit stays
    within the stated tolerance: held-out AUC within 0.01, and where the
    trees are identical, leaves within 1e-3."""
    x, y, _ = _data(3)
    xe, ye, _ = _data(4, n=1000)
    params = dict(PARAMS, objective="binary", boosting="goss", top_rate=0.1, other_rate=0.2)
    ref, port = _fit_pair(params, x, y)

    def auc(score):
        order = np.argsort(score, kind="stable")
        ranks = np.empty(len(score))
        ranks[order] = np.arange(1, len(score) + 1)
        pos = ye > 0
        return (ranks[pos].sum() - pos.sum() * (pos.sum() + 1) / 2) / (pos.sum() * (~pos).sum())

    assert abs(auc(port.raw_predict(xe, device="cpu")) - auc(ref.raw_predict(xe))) <= 0.01
    if all(np.array_equal(getattr(port, f), getattr(ref, f))
           for f in ("parent", "feature", "bin")):
        np.testing.assert_allclose(port.leaf_value, ref.leaf_value, rtol=0, atol=1e-3)


def test_sampler_validation_matches_reference():
    x, y, _ = _data(5, n=300)
    with pytest.raises(ValueError, match="gbdt\\|goss\\|dart\\|rf"):
        train(dict(PARAMS, boosting="gbrt"), x, y, device="cpu")
    with pytest.raises(ValueError, match="rf"):
        train(dict(PARAMS, boosting="rf"), x, y, device="cpu")
    with pytest.raises(ValueError, match="binary"):
        train(dict(PARAMS, objective="regression", pos_bagging_fraction=0.5,
                   bagging_freq=1), x, y, device="cpu")


def test_sampled_categorical_fit_matches_reference():
    """Feature fraction and bagging over a categorical column: the feature
    mask reaches kernel E's categorical scoring too; identical trees and
    category sets."""
    rng = np.random.default_rng(6)
    n = 3000
    x = rng.normal(size=(n, 6)).astype(np.float32)
    x[:, 1] = rng.integers(0, 12, size=n)
    effect = rng.normal(size=12)
    y = (effect[x[:, 1].astype(int)] + x[:, 0] + 0.3 * rng.normal(size=n) > 0).astype(float)
    params = dict(PARAMS, objective="binary", categorical_feature=[1], feature_fraction=0.7,
                  bagging_fraction=0.6, bagging_freq=1)
    ref, port = _fit_pair(params, x, y)
    _assert_same_trees(ref, port, LEAF_ATOL["binary"])
    np.testing.assert_array_equal(port.cat_set, ref.cat_set)
    assert ((port.bin < 0) & (port.parent >= 0)).any()
