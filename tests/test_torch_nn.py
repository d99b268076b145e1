"""The port's KNN / ConditionalKNN and its top-k (kernel K's plain version)
against the JAX package's, on the CPU.

- ``topk_select_plain`` (and ``topk_select`` on a CPU tensor) equals
  ``jax.lax.top_k`` exactly, values bit for bit and indices, on the probe
  rows where ``torch.topk`` and a descending sort depart from it (ties,
  +-NaN, +-0.0) and on every ``kernel_cases.TOPK_CASES`` case; k > N raises
  in both.
- KNN / ConditionalKNN return the reference's neighbours in the reference's
  order on every fixture of ``tests/test_nn.py``. Distances agree within
  ``DIST_TOL`` relative: the two inner products sum in another order (f32
  BLAS against XLA's HIGHEST-precision dot). Fixtures with tied scores use
  integer-valued vectors, whose inner products are exact in any order, so
  the order of ties is held exactly.
- A model carried across from the reference's fitted state transforms as the
  reference does.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu import Table as RefTable
from synapseml_tpu.nn import KNN as RefKNN
from synapseml_tpu.nn import ConditionalKNN as RefCKNN
from synapseml_tpu_torch.core import Table, load_stage
from synapseml_tpu_torch.kernels import all_kernels
from synapseml_tpu_torch.kernels.build import CSRC_DIR
from synapseml_tpu_torch.nn import (KNN, ConditionalKNN, ConditionalKNNModel, KNNModel,
                                    topk_select, topk_select_plain)
from synapseml_tpu_torch.nn import knn as port_knn
from synapseml_tpu_torch.nn import topk as port_topk
from synapseml_tpu_torch.runtime.device import DeviceUnavailableError
from synapseml_tpu_torch.tools.kernel_cases import TOPK_CASES, same_up_to_ties, topk_case
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

DIST_TOL = 1e-5


def _lax_top_k(x: np.ndarray, k: int):
    v, i = jax.lax.top_k(jnp.asarray(x), k)
    return np.asarray(v), np.asarray(i).astype(np.int64)


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return np.array_equal(np.asarray(a, np.float32).view(np.uint32),
                          np.asarray(b, np.float32).view(np.uint32))


# -- the top-k order --------------------------------------------------------------------

def test_probe_rows_where_torch_departs():
    """The two probe rows: lax.top_k's answer, which torch.topk and a
    descending sort do not give."""
    nan, inf = np.float32(np.nan), np.float32(np.inf)
    neg_nan = np.float32(np.copysign(np.nan, -1.0))
    a = np.array([[1, 3, 3, nan, -inf, 3, 2]], np.float32)
    b = np.array([[-0.0, 0.0, 1, neg_nan, nan, -inf, -inf]], np.float32)
    for x, k, want in ((a, 5, [3, 1, 2, 5, 6]), (b, 7, [4, 2, 1, 0, 5, 6, 3])):
        v, i = topk_select_plain(torch.from_numpy(x), k)
        assert i.tolist() == [want]
        rv, ri = _lax_top_k(x, k)
        assert ri.tolist() == [want]
        assert _same_bits(v.numpy(), rv)
    # torch's own calls give other answers on these rows
    assert torch.topk(torch.from_numpy(a), 5).indices.tolist() != [[3, 1, 2, 5, 6]]
    order = torch.sort(torch.from_numpy(b), descending=True, stable=True).indices
    assert order.tolist() != [[4, 2, 1, 0, 5, 6, 3]]


@pytest.mark.parametrize("case", TOPK_CASES)
def test_topk_cases_equal_lax_top_k(case):
    x, k = topk_case(case)
    rv, ri = _lax_top_k(x, k)
    for fn in (topk_select_plain, topk_select):
        v, i = fn(torch.from_numpy(x), k)
        assert v.dtype == torch.float32 and i.dtype == torch.int64
        np.testing.assert_array_equal(i.numpy(), ri)
        assert _same_bits(v.numpy(), rv)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_rows_with_duplicates_and_specials(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 400))
    x = rng.integers(-4, 5, (7, n)).astype(np.float32)
    specials = np.array([np.nan, np.copysign(np.nan, -1.0), 0.0, -0.0, np.inf, -np.inf],
                        np.float32)
    mask = rng.random(x.shape) < 0.3
    x[mask] = specials[rng.integers(0, len(specials), int(mask.sum()))]
    for k in sorted({1, n, int(rng.integers(1, n + 1))}):
        rv, ri = _lax_top_k(x, k)
        v, i = topk_select_plain(torch.from_numpy(x), k)
        np.testing.assert_array_equal(i.numpy(), ri)
        assert _same_bits(v.numpy(), rv)
    with pytest.raises(ValueError):
        topk_select_plain(torch.from_numpy(x), n + 1)
    with pytest.raises(ValueError):
        jax.lax.top_k(jnp.asarray(x), n + 1)


def test_order_key_is_the_total_order():
    vals = np.array([np.copysign(np.nan, -1.0), -np.inf, -3.5, -1e-45, -0.0, 0.0, 1e-45, 2.0,
                     np.inf, np.nan], np.float32)
    keys = port_topk.order_key(torch.from_numpy(vals)).tolist()
    assert keys == sorted(keys) and len(set(keys)) == len(keys)
    assert all(0 <= key < 2 ** 32 for key in keys)


def test_kernel_registered_and_constants_mirror_the_source():
    """TOPK_KERNEL is in ``all_kernels`` and bound to ``csrc/topk_select.cu``'s
    entry point with its argument count; TOPK_SMEM_K is the source's
    kSmemK."""
    k = all_kernels()["topk_select"]
    assert k is port_topk.TOPK_KERNEL and k.source == "topk_select"
    src = (CSRC_DIR / "topk_select.cu").read_text()
    m = re.search(r'extern "C" int ' + k.symbol + r"\((.*?)\)", src, re.S)
    assert m and len(m.group(1).split(",")) == len(k.argtypes)
    assert int(re.search(r"constexpr int kSmemK = (\d+);", src).group(1)) == port_topk.TOPK_SMEM_K
    assert "nn/knn.py:46" in k.replaces


def test_same_up_to_ties_rule():
    idx = np.array([[4, 2, 7]])
    val = np.array([[3.0, 2.0, 1.0]])
    assert same_up_to_ties(idx, val, idx, val, 1e-6)
    # a swap between near-equal scores passes, a swap across a gap does not
    assert same_up_to_ties(np.array([[4, 7, 2]]), np.array([[3.0, 1.0 + 1e-9, 1.0]]),
                           np.array([[4, 2, 7]]), np.array([[3.0, 1.0 + 1e-9, 1.0]]), 1e-6)
    assert not same_up_to_ties(np.array([[4, 7, 2]]), val, idx, val, 1e-6)


# -- KNN / ConditionalKNN against the reference ------------------------------------------

def _index(n=200, d=8, seed=0, integer=False):
    rng = np.random.default_rng(seed)
    feats = (rng.integers(-3, 4, (n, d)).astype(np.float64) if integer
             else rng.normal(size=(n, d)))
    values = np.array([f"v{i}" for i in range(n)], dtype=object)
    labels = np.array([i % 3 for i in range(n)], dtype=object)
    cols = {"features": feats, "values": values, "labels": labels}
    return RefTable(dict(cols)), Table(dict(cols)), feats


def _same_matches(ref_out, port_out, keys=("value", "label")):
    assert len(ref_out) == len(port_out)
    for a, b in zip(ref_out, port_out):
        assert [[m.get(k) for k in keys] for m in a] == [[m.get(k) for k in keys] for m in b]
        da = np.array([m["distance"] for m in a])
        db = np.array([m["distance"] for m in b])
        np.testing.assert_allclose(db, da, rtol=DIST_TOL, atol=DIST_TOL)


def _queries(cols, ref=True):
    return RefTable(dict(cols)) if ref else Table(dict(cols))


@pytest.mark.parametrize("integer", [False, True])
def test_knn_matches_reference(integer):
    rt, pt, feats = _index(integer=integer)
    rng = np.random.default_rng(1)
    q = (rng.integers(-3, 4, (17, 8)).astype(np.float64) if integer
         else rng.normal(size=(17, 8)))
    ref = RefKNN(k=4).fit(rt).transform(_queries({"features": q}))
    port = KNN(k=4, device="cpu").fit(pt).transform(_queries({"features": q}, False))
    _same_matches(ref["output"], port["output"])


def test_knn_k_larger_than_index():
    rt, pt, _ = _index(n=3)
    q = {"features": np.zeros((2, 8))}
    ref = RefKNN(k=10).fit(rt).transform(_queries(q))
    port = KNN(k=10, device="cpu").fit(pt).transform(_queries(q, False))
    assert len(port["output"][0]) == 3
    _same_matches(ref["output"], port["output"])


def test_knn_duplicate_keys_keep_the_reference_order():
    """Every key three times and all-zero queries: every score ties, so the
    reference's order (lowest index first) is the answer, and torch.topk's
    would not be."""
    rt, pt, feats = _index(n=60, integer=True)
    dup = {"features": np.concatenate([feats] * 3),
           "values": np.array([f"v{i}" for i in range(180)], dtype=object)}
    q = {"features": np.concatenate([np.zeros((2, 8)), feats[:3]])}
    ref = RefKNN(k=7).fit(RefTable(dict(dup))).transform(_queries(q))
    port = KNN(k=7, device="cpu").fit(Table(dict(dup))).transform(_queries(q, False))
    _same_matches(ref["output"], port["output"])
    assert [m["value"] for m in port["output"][0]] == [f"v{i}" for i in range(7)]


def test_knn_keeps_non_finite_scores():
    _, _, feats = _index(n=20)
    keys = feats.copy()
    keys[3] = np.inf
    keys[5, 0] = np.nan
    cols = {"features": keys, "values": np.arange(20)}
    q = {"features": np.ones((3, 8))}
    ref = RefKNN(k=20).fit(RefTable(dict(cols))).transform(_queries(q))
    port = KNN(k=20, device="cpu").fit(Table(dict(cols))).transform(_queries(q, False))
    for a, b in zip(ref["output"], port["output"]):
        assert [m["value"] for m in a] == [m["value"] for m in b]
        assert len(b) == 20
        np.testing.assert_allclose([m["distance"] for m in b], [m["distance"] for m in a],
                                   rtol=DIST_TOL)


def test_conditional_knn_respects_conditioner():
    rt, pt, feats = _index()
    rng = np.random.default_rng(2)
    q = rng.normal(size=(9, 8))
    conds = np.empty(9, dtype=object)
    for r in range(9):
        conds[r] = [r % 3]
    cols = {"features": q, "conditioner": conds}
    ref = RefCKNN(k=5).fit(rt).transform(_queries(cols))
    port = ConditionalKNN(k=5, device="cpu").fit(pt).transform(_queries(cols, False))
    _same_matches(ref["output"], port["output"])
    assert all(len(m) == 5 for m in port["output"])


def test_conditional_knn_multi_label_and_unseen():
    rt, pt, feats = _index(n=30)
    conds = np.empty(2, dtype=object)
    conds[0] = [0, 2]
    conds[1] = ["not-a-label"]
    cols = {"features": np.zeros((2, 8)), "conditioner": conds}
    ref = RefCKNN(k=30).fit(rt).transform(_queries(cols))
    port = ConditionalKNN(k=30, device="cpu").fit(pt).transform(_queries(cols, False))
    _same_matches(ref["output"], port["output"])
    assert {m["label"] for m in port["output"][0]} == {0, 2}
    assert port["output"][1] == []


def test_conditional_knn_ties_and_fewer_admissible_than_k():
    """Integer keys with repeats, one label admitted by few keys: the
    admissible ties in the reference's order, the -inf fill dropped."""
    rng = np.random.default_rng(5)
    feats = rng.integers(-1, 2, (90, 4)).astype(np.float64)
    labels = np.array(["a"] * 80 + ["b"] * 6 + ["c"] * 4, dtype=object)
    cols = {"features": feats, "values": np.arange(90), "labels": labels}
    conds = np.empty(6, dtype=object)
    for r, c in enumerate((["a"], ["b"], ["c"], ["b", "c"], ["a", "c"], [])):
        conds[r] = c
    q = {"features": rng.integers(-1, 2, (6, 4)).astype(np.float64), "conditioner": conds}
    ref = RefCKNN(k=8).fit(RefTable(dict(cols))).transform(_queries(q))
    port = ConditionalKNN(k=8, device="cpu").fit(Table(dict(cols))).transform(
        _queries(q, False))
    _same_matches(ref["output"], port["output"])
    assert [len(m) for m in port["output"]] == [8, 6, 4, 8, 8, 0]


def test_conditional_knn_save_load(tmp_path):
    rt, pt, feats = _index(n=40)
    cols = {"features": feats[:5], "conditioner": np.array([[0, 1, 2]] * 5, dtype=object)}
    ref = RefCKNN(k=3).fit(rt).transform(_queries(cols))
    model = ConditionalKNN(k=3, device="cpu").fit(pt)
    path = str(tmp_path / "cknn")
    model.save(path)
    loaded = load_stage(path)
    assert isinstance(loaded, ConditionalKNNModel)
    for m in (model, loaded):
        _same_matches(ref["output"], m.transform(_queries(cols, False))["output"])


@pytest.mark.parametrize("conditional", [False, True])
def test_model_from_the_reference_state(conditional):
    """The reference's fitted model carried across (``from_state``)
    transforms as the reference does, and ``state_dict`` carries it back."""
    rt, _, feats = _index(n=50, seed=3)
    q = np.random.default_rng(4).normal(size=(6, 8))
    cols = {"features": q}
    if conditional:
        conds = np.empty(6, dtype=object)
        for r in range(6):
            conds[r] = [r % 3, (r + 1) % 3]
        cols["conditioner"] = conds
    ref_model = (RefCKNN if conditional else RefKNN)(k=4).fit(rt)
    cls = ConditionalKNNModel if conditional else KNNModel
    port = cls.from_state({k: ref_model.get_or_default(k) for k in cls._STATE}, device="cpu")
    ref = ref_model.transform(_queries(cols))
    _same_matches(ref["output"], port.transform(_queries(cols, False))["output"])
    back = type(ref_model)(**port.state_dict())
    _same_matches(ref["output"], back.transform(_queries(cols))["output"])


def test_new_keys_after_a_transform():
    """Keys set after a transform are the ones searched: the uploaded keys
    are rebuilt when the param holds another array."""
    rt, pt, feats = _index(n=60, seed=7)
    q = {"features": np.random.default_rng(8).normal(size=(5, 8))}
    model = KNN(k=3, device="cpu").fit(pt)
    model.transform(_queries(q, False))
    other = np.random.default_rng(9).normal(size=(60, 8)).astype(np.float32)
    model.set_params(keys=other)
    want = RefKNN(k=3).fit(RefTable({"features": other, "values": np.asarray(
        model.values)})).transform(_queries(q))
    _same_matches(want["output"], model.transform(_queries(q, False))["output"])


def test_cache_holds_the_param_objects():
    """``Model._cached`` rebuilds for another device tag or for a param set
    to another object (even an equal one), and not otherwise."""
    model = KNNModel(keys=np.ones((4, 2), np.float32), device="cpu")
    built = []
    get = lambda tag: model._cached("probe", tag, ("keys",), lambda: built.append(1) or len(built))
    assert get("cpu") == get("cpu") == 1
    assert get("cuda:0") == 2
    model.set_params(keys=np.ones((4, 2), np.float32))
    assert get("cuda:0") == 3 and get("cuda:0") == 3


def test_query_chunks_do_not_change_the_answer(monkeypatch):
    """Queries in chunks of a few rows (a small score budget) give the same
    neighbours as one chunk, and the ConditionalKNN mask is formed a chunk at
    a time."""
    rt, pt, feats = _index(n=64)
    q = np.random.default_rng(6).normal(size=(23, 8))
    conds = np.empty(23, dtype=object)
    for r in range(23):
        conds[r] = [r % 3]
    cols = {"features": q, "conditioner": conds}
    whole = ConditionalKNN(k=5, device="cpu").fit(pt).transform(_queries(cols, False))
    monkeypatch.setattr(port_knn, "SCORE_BUDGET", 4 * 64 * 4)
    assert port_knn.chunk_rows(64) == 4
    seen = []
    real = port_knn.topk_select

    def spy(scores, k):
        seen.append(scores.shape[0])
        return real(scores, k)

    monkeypatch.setattr(port_knn, "topk_select", spy)
    model = ConditionalKNN(k=5, device="cpu").fit(pt)
    chunked = model.transform(_queries(cols, False))
    assert seen == [4, 4, 4, 4, 4, 3]
    _same_matches(whole["output"], chunked["output"])


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, pt, _ = _index(n=10)
    model = KNN(k=2).fit(pt)
    with pytest.raises(DeviceUnavailableError):
        model.transform(Table({"features": np.zeros((1, 8))}))
