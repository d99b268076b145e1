"""The port's AccessAnomaly (ALS on the card's path, run here on the CPU) and
ConnectedComponents against the JAX package's, on the CPU.

- The ALS's initial factors are bit-equal to the reference's
  ``jax.random.uniform`` draws (the port's threefry).
- Per-tenant ids, connected components (their numbering too) and the
  history set are the reference's exactly.
- Scores agree within ``anomaly.ANOMALY_TOL`` (1e-3) in z units
  (``anomaly.scores_agree``): both ALS run 2 x max_iter batched k x k
  solves in f32 whose Gram sums and LU factorizations round in other orders
  than XLA's (each half-step's system and solution differ by an ulp or two;
  the iteration carries that forward). Three fixtures are held to 1e-3 of
  the dot product the score standardizes instead (``anomaly.dots_agree``),
  because their tenants' |mean / std| magnifies the dot's error in z units
  past 1e-3: ``test_fixture_cross_group_scores_high`` (|mean / std| 131,
  2.4e-3 in z), ``test_fixture_save_load`` (14, 1.3e-3) and the implicit
  case of ``test_scores_within_tolerance_on_logs`` (16, 1.2e-3). Explicit
  ALS carries the drift further: its case of that test (25 iterations, a
  200 x 150 tenant among three) differs by 4.0e-3 in z, and is held to
  ``EXPLICIT_TOL``. The rows that score 0 (history), NaN (unknown user or
  resource) and +inf (cross-component) are the same rows.
- A model carried across from the reference's fitted state
  (``from_state``) scores as the reference does within ``CARRIED_TOL``: the
  same f64 vectors, dotted in another order.
- Every fixture of ``tests/test_cyber.py``'s anomaly section runs through
  both packages.
"""

import jax
import numpy as np
import pytest
import torch

from synapseml_tpu import Table as RefTable
from synapseml_tpu import cyber as ref_cyber
from synapseml_tpu.cyber import anomaly as ref_anomaly
from synapseml_tpu_torch.core import Table, load_stage
from synapseml_tpu_torch.cyber import AccessAnomaly, AccessAnomalyModel, ConnectedComponents
from synapseml_tpu_torch.cyber import anomaly as port_anomaly
from synapseml_tpu_torch.tools.schema_data import access_rows
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ANOMALY_TOL = port_anomaly.ANOMALY_TOL
EXPLICIT_TOL = 5e-3       # explicit ALS's logs case, in z units (4.0e-3 measured)
CARRIED_TOL = 1e-12
SCORE = "anomaly_score"


def _both(cols):
    return RefTable(dict(cols)), Table(dict(cols))


def _fit(cols, **params):
    rt, pt = _both(cols)
    hist = params.pop("history", None)
    ref_p, port_p = dict(params), dict(params)
    if hist is not None:
        ref_p["history_access_df"], port_p["history_access_df"] = _both(hist)
    return (ref_cyber.AccessAnomaly(**ref_p).fit(rt),
            AccessAnomaly(device="cpu", **port_p).fit(pt))


def _scores(ref, port, cols):
    rt, pt = _both(cols)
    return (np.asarray(ref.transform(rt)[SCORE], np.float64),
            np.asarray(port.transform(pt)[SCORE], np.float64))


def _check(ref, port, cols, tol=ANOMALY_TOL, of_dot=False):
    """Score ``cols`` with both models and hold the port's to the reference's:
    the same NaN / inf / 0 rows, and finite scores within ``tol`` in z units
    (``scores_agree``) or, ``of_dot``, within ``tol`` of the dot
    (``dots_agree``, the tenants' centres from the reference model)."""
    a, b = _scores(ref, port, cols)
    for kind in (np.isnan, np.isposinf, np.isneginf, lambda s: s == 0.0):
        np.testing.assert_array_equal(kind(b), kind(a))
    ok = np.isfinite(a)
    err = np.abs(b[ok] - a[ok]).max(initial=0.0)
    if of_dot:
        by_tenant = port_anomaly.tenant_centres(ref.user_vectors)
        centres = np.array([by_tenant.get(t, 0.0) for t in
                            np.asarray(cols["tenant"]).astype(str)])
        assert port_anomaly.dots_agree(b[ok], a[ok], centres[ok], tol), err
    else:
        assert port_anomaly.scores_agree(b[ok], a[ok], tol), err
    return a, b


def _two_group(seed=0, n_users=12, n_res=10, events_per_user=18):
    rng = np.random.default_rng(seed)
    tenants, users, resources = [], [], []
    for u in range(n_users):
        pool = np.arange(0, n_res // 2) if u < n_users // 2 else np.arange(n_res // 2, n_res)
        for _ in range(events_per_user):
            tenants.append("t0")
            users.append(f"user{u}")
            resources.append(f"res{rng.choice(pool)}")
    for r in (0, n_res - 1):
        tenants.append("t0")
        users.append("bridge")
        resources.append(f"res{r}")
    return {"tenant": np.array(tenants, dtype=object), "user": np.array(users, dtype=object),
            "res": np.array(resources, dtype=object)}


def _logs(seed=0):
    """Three tenants of CyberML's schema (one with closed departments, so
    several components), with likelihoods."""
    return access_rows(seed, [("ta", 200, 150, 3000), ("tb", 120, 60, 1500),
                              ("tc", 60, 30, 600)], departments=4, closed=1, cross=0.1)


def _probe(cols, seed=0):
    """Training rows, shuffled (user, res) pairs of each tenant (some across
    components), unknown users and resources, and an unknown tenant."""
    rng = np.random.default_rng(seed)
    n = len(cols["tenant"])
    t, u, r = (np.asarray(cols[c], dtype=object) for c in ("tenant", "user", "res"))
    pick = rng.integers(0, n, 400)
    other = rng.permutation(pick)
    same_tenant = t[pick] == t[other]
    tenants = np.concatenate([t, t[pick][same_tenant], t[:5], t[:5], np.array(["zz"] * 2)])
    users = np.concatenate([u, u[pick][same_tenant], np.array(["nobody"] * 5), u[:5],
                            u[:2]])
    res = np.concatenate([r, r[other][same_tenant], r[:5], np.array(["nothing"] * 5), r[:2]])
    return {"tenant": tenants.astype(object), "user": users.astype(object),
            "res": res.astype(object)}


# -- ALS -----------------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 3, 17])
def test_als_initial_factors_bit_equal(seed):
    ku, ki = jax.random.split(jax.random.PRNGKey(seed))
    want_u = np.asarray(jax.random.uniform(ku, (37, 10), dtype=np.float32) * 0.1)
    want_v = np.asarray(jax.random.uniform(ki, (23, 10), dtype=np.float32) * 0.1)
    u, v = port_anomaly.als_initial_factors(37, 23, 10, seed, torch.device("cpu"))
    np.testing.assert_array_equal(u.numpy().view(np.uint32), want_u.view(np.uint32))
    np.testing.assert_array_equal(v.numpy().view(np.uint32), want_v.view(np.uint32))


@pytest.mark.parametrize("implicit", [True, False])
def test_als_factors_close_to_the_reference(implicit):
    rng = np.random.default_rng(1)
    ratings = np.where(rng.random((50, 30)) < 0.2, rng.uniform(5, 10, (50, 30)), 0.0)
    ru, rv = ref_anomaly._als(ratings, 6, 10, 1.0, implicit, 1.0, 2)
    pu, pv = port_anomaly.als(ratings, 6, 10, 1.0, implicit, 1.0, 2, torch.device("cpu"))
    for a, b in ((ru, pu), (rv, pv)):
        assert b.dtype == np.float32 and b.shape == a.shape
        np.testing.assert_array_equal(b == 0, a == 0)
        assert np.abs(b - a).max() <= 1e-3 * max(1.0, np.abs(a).max())


def test_gram_is_the_einsum():
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.random((7, 11)).astype(np.float32))
    f = torch.from_numpy(rng.random((11, 4)).astype(np.float32))
    torch.testing.assert_close(port_anomaly._gram(w, f), torch.einsum("bj,jk,jl->bkl", w, f, f),
                               rtol=1e-6, atol=1e-6)


# -- ids, components, history ---------------------------------------------------------------

def test_ids_per_tenant_equal_the_reference_indexer():
    cols = _logs(1)
    rt, _ = _both(cols)
    t = np.asarray(cols["tenant"]).astype(str)
    for col in ("user", "res"):
        ref = ref_cyber.IdIndexer(input_col=col, partition_key="tenant", output_col="ix",
                                  reset_per_partition=True).fit(rt)
        ids, vocab = port_anomaly._ids_per_tenant(t, np.asarray(cols[col]).astype(str))
        np.testing.assert_array_equal(ids, np.asarray(ref.transform(rt)["ix"]))
        assert {k: dict(zip(v.tolist(), range(1, len(v) + 1))) for k, v in vocab.items()} == \
            ref.vocab


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_component_ids_equal_the_reference(seed):
    cols = _logs(seed)
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(cols["tenant"]))
    cols = {k: v[order] for k, v in cols.items()}
    rt, pt = _both(cols)
    ref = ref_anomaly.ConnectedComponents("tenant", "user", "res").compute(rt)
    port = ConnectedComponents("tenant", "user", "res").compute(pt)
    assert port == ref
    assert len(set(port[0].values())) > 3      # several components per tenant


def test_connected_components_bipartite():
    cols = {"tenant": np.array(["t"] * 5, dtype=object),
            "user": np.array(["u1", "u2", "u2", "u3", "u4"], dtype=object),
            "res": np.array(["r1", "r1", "r2", "r3", "r3"], dtype=object)}
    rt, pt = _both(cols)
    users, res = ConnectedComponents("tenant", "user", "res").compute(pt)
    assert (users, res) == ref_anomaly.ConnectedComponents("tenant", "user", "res").compute(rt)
    assert users[("t", "u1")] == users[("t", "u2")] == res[("t", "r1")]
    assert users[("t", "u1")] != users[("t", "u3")]


# -- scores ------------------------------------------------------------------------------------

@pytest.mark.parametrize("implicit", [True, False])
def test_scores_within_tolerance_on_logs(implicit):
    cols = _logs(2)
    ref, port = _fit(cols, max_iter=25, rank_param=10, apply_implicit_cf=implicit)
    if implicit:
        a, _ = _check(ref, port, _probe(cols, 2), of_dot=True)
    else:
        a, _ = _check(ref, port, _probe(cols, 2), EXPLICIT_TOL)
    assert np.isinf(a).any() and np.isnan(a).any()
    for side in ("user_components", "res_components"):
        assert port.get(side) == ref.get(side)


def test_scores_without_likelihood_or_scaling():
    cols = _logs(3)
    plain = {k: v for k, v in cols.items() if k != "likelihood"}
    ref, port = _fit(plain, max_iter=6, rank_param=4)
    _check(ref, port, _probe(plain, 3))
    ref, port = _fit(cols, max_iter=6, rank_param=4, low_value=None, high_value=None)
    _check(ref, port, _probe(cols, 3))


def test_history_rows_score_zero():
    cols = _logs(4)
    hist = {k: v[:50] for k, v in cols.items() if k != "likelihood"}
    ref, port = _fit(cols, max_iter=5, rank_param=4, history=hist)
    _, b = _check(ref, port, _probe(cols, 4))
    assert (b[:50] == 0).all()
    assert port.history == ref.history


def test_transform_from_carried_state():
    cols = _logs(5)
    hist = {k: v[::7] for k, v in cols.items() if k != "likelihood"}
    ref, _ = _fit(cols, max_iter=5, rank_param=4, history=hist)
    port = AccessAnomalyModel.from_state(
        {k: ref.get_or_default(k) for k in AccessAnomalyModel._STATE}, device="cpu")
    _check(ref, port, _probe(cols, 5), CARRIED_TOL)
    back = ref_cyber.AccessAnomalyModel(**port.state_dict())
    _check(ref, back, _probe(cols, 5), 0.0)


def test_new_vectors_after_a_transform():
    """Vectors and components set after a transform are the ones scored:
    the looked-up sides are rebuilt when a param holds another object."""
    cols = _logs(6)
    ref_a, port = _fit(cols, max_iter=4, rank_param=4)
    ref_b, _ = _fit(cols, max_iter=4, rank_param=4, seed=9)
    probe = _probe(cols, 6)
    port.transform(Table(dict(probe)))
    port.set_params(**{k: ref_b.get_or_default(k) for k in ("user_vectors", "res_vectors",
                                                      "user_components", "res_components")})
    _check(ref_b, port, probe, CARRIED_TOL)


def test_default_device_needs_a_card(monkeypatch):
    from synapseml_tpu_torch.runtime.device import DeviceUnavailableError

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        AccessAnomaly().fit(Table(_two_group()))


# -- the reference's fixtures (tests/test_cyber.py's anomaly section), through both ------------

def _one(tenant, user, res):
    return {"tenant": np.array([tenant], dtype=object), "user": np.array([user], dtype=object),
            "res": np.array([res], dtype=object)}


def test_fixture_cross_group_scores_high():
    ref, port = _fit(_two_group(), max_iter=10, rank_param=8)
    s_in = _check(ref, port, _one("t0", "user0", "res1"))
    s_cross = _check(ref, port, _one("t0", "user0", "res8"), of_dot=True)
    assert s_cross[1][0] > s_in[1][0]


def test_fixture_scores_standardized():
    cols = _two_group()
    ref, port = _fit(cols, max_iter=10, rank_param=8)
    _, b = _check(ref, port, cols)
    assert np.isfinite(b).all() and abs(b.mean()) < 0.35 and 0.5 < b.std() < 2.0


def test_fixture_unknown_user_nan_and_disconnected_inf():
    cols = {"tenant": np.array(["t"] * 8, dtype=object),
            "user": np.array(["A1", "A2"] * 2 + ["B1", "B2"] * 2, dtype=object),
            "res": np.array(["RA1", "RA2", "RA2", "RA1", "RB1", "RB2", "RB2", "RB1"],
                            dtype=object)}
    ref, port = _fit(cols, max_iter=5, rank_param=4)
    q = {"tenant": np.array(["t", "t"], dtype=object),
         "user": np.array(["A1", "nobody"], dtype=object),
         "res": np.array(["RB1", "RA1"], dtype=object)}
    _, b = _check(ref, port, q)
    assert np.isinf(b[0]) and np.isnan(b[1])


def test_fixture_history_scores_zero():
    hist = _one("t0", "user0", "res0")
    ref, port = _fit(_two_group(), max_iter=5, rank_param=4, history=hist)
    a, b = _scores(ref, port, hist)
    assert a[0] == b[0] == 0.0


def test_fixture_explicit_cf_variant():
    params = dict(max_iter=8, rank_param=6, apply_implicit_cf=False, complementset_factor=2,
                  neg_score=1.0)
    ref, port = _fit(_two_group(seed=3), **params)
    s_in = _check(ref, port, _one("t0", "user1", "res2"))
    s_cross = _check(ref, port, _one("t0", "user1", "res9"))
    assert s_cross[1][0] > s_in[1][0]


def test_fixture_save_load(tmp_path):
    cols = _two_group()
    ref, port = _fit(cols, max_iter=5, rank_param=4)
    path = str(tmp_path / "aa")
    port.save(path)
    loaded = load_stage(path)
    assert isinstance(loaded, AccessAnomalyModel)
    _, b = _check(ref, loaded, cols, of_dot=True)
    np.testing.assert_array_equal(b, _scores(ref, port, cols)[1])


def test_fixture_multi_tenant_isolation():
    ta = _two_group(seed=1)
    tb = dict(ta, tenant=np.array(["t1"] * len(ta["tenant"]), dtype=object))
    both = {k: np.concatenate([ta[k], tb[k]]) for k in ("tenant", "user", "res")}
    ref, port = _fit(both, max_iter=5, rank_param=4)
    q = {"tenant": np.array(["t0", "t1"], dtype=object),
         "user": np.array(["user0", "user0"], dtype=object),
         "res": np.array(["res0", "res0"], dtype=object)}
    _, b = _check(ref, port, q)
    assert np.isfinite(b).all()
