"""The port's sequence-parallel attention on the CPU: ring and Ulysses over
an 8-rank gloo world (``tests/torch_mesh.py``), held to the JAX package's.

The reference's cases of ``tests/test_parallel.py`` (``:52-151``, ``:223``,
``:279``) carried over: the port's ``sequence_sharded_attention`` runs on
every rank of one persistent 8-rank world over a raw 1-D ``("seq",)``
mesh (the reference's 8-device mesh), and every rank's output is held to
the reference's ``sequence_sharded_attention`` on its 8-device CPU mesh,
over the same numpy inputs, at the reference's tolerances: 2e-4 in f32;
0.05 for bf16 inputs; 2e-5 for Ulysses with the flash kernel as its local
attention. The reference's block and interpret knobs are TPU-only and gone
(``parallel/ring.py``): its ``local="flash"`` cases run the port's kernel
(the plain attention on the CPU) at the same lengths. Errors (S not
divisible, a bad GQA group, an unknown strategy) are the reference's.
The ring never hands the plain attention a key block longer than
s_local. Then the plain attention's log-sum-exp against numpy's, and the
blocks' merge.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from synapseml_tpu.parallel import sequence_sharded_attention as ref_attention

from synapseml_tpu_torch.parallel.flash import dense_attention, flash_attention
from synapseml_tpu_torch.parallel.ring import merge_lse
from tests.torch_mesh import MeshWorld
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

SEQ = ("raw", (8,), ("seq",))
F32_TOL = 2e-4
BF16_TOL = 0.05
FLASH_LOCAL_TOL = 2e-5
LSE_TOL = 1e-5


@pytest.fixture(scope="module")
def world():
    w = MeshWorld(8)
    yield w
    w.close()


@pytest.fixture(scope="module")
def mesh():
    return Mesh(np.array(jax.devices()[:8]), ("seq",))


def _qkv(seed=0, b=2, s=64, h=8, d=16, h_kv=None):
    rng = np.random.default_rng(seed)
    mk = lambda heads: rng.normal(size=(b, s, heads, d)).astype(np.float32)
    return mk(h), mk(h if h_kv is None else h_kv), mk(h if h_kv is None else h_kv)


def _dense_reference(q, k, v, causal=False):
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = np.einsum("bqhd,bkhd->bqhk", q.astype(np.float64), k.astype(np.float64)) * scale
    if causal:
        S = s.shape[1]
        s = np.where(np.tril(np.ones((S, S), bool))[None, :, None, :], s, -np.inf)
    p = np.exp(s - s.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)
    return np.einsum("bqhk,bkhd->bqhd", p, v.astype(np.float64))


def _port(world, q, k, v, **kw):
    res = world.run("attention", layout=kw.pop("layout", SEQ), q=q, k=k, v=v, **kw)
    return res


def _ref(mesh, q, k, v, **kw):
    return np.asarray(ref_attention(q, k, v, mesh, **kw).astype(jnp.float32))


def _hold(res, ref, tol):
    for r, got in enumerate(res):
        assert "error" not in got, got.get("error")
        np.testing.assert_allclose(got["out"], ref, rtol=tol, atol=tol,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_matches_reference(world, mesh, strategy, causal):
    q, k, v = _qkv()
    res = _port(world, q, k, v, strategy=strategy, causal=causal)
    _hold(res, _ref(mesh, q, k, v, strategy=strategy, causal=causal), F32_TOL)
    _hold(res, _dense_reference(q, k, v, causal), F32_TOL)
    n = 8
    want = ({"shift:data": n - 1, "gather:data": 1} if strategy == "ring"
            else {"all_to_all:data": 4, "gather:data": 1})
    assert res[0]["collectives"] == want


def test_ring_attention_bf16_inputs(world, mesh):
    q, k, v = _qkv(seed=1)
    res = _port(world, q, k, v, strategy="ring", bf16=True)
    ref = _ref(mesh, jnp.asarray(q, jnp.bfloat16), jnp.asarray(k, jnp.bfloat16),
               jnp.asarray(v, jnp.bfloat16), strategy="ring")
    assert res[0]["dtype"] == "torch.bfloat16"
    _hold(res, ref, BF16_TOL)
    _hold(res, _dense_reference(q, k, v), BF16_TOL)


def _error_of(fn):
    with pytest.raises(ValueError) as ei:
        fn()
    return str(ei.value)


def test_sequence_length_must_divide(world, mesh):
    q, k, v = _qkv(s=63)
    want = _error_of(lambda: _ref(mesh, q, k, v))
    assert "divisible" in want
    assert [r["error"] for r in _port(world, q, k, v)] == [want] * 8


def test_ulysses_non_divisible_heads(world, mesh):
    q, k, v = _qkv(h=6)   # 6 heads over an 8-rank axis: zero-padded
    res = _port(world, q, k, v, strategy="ulysses")
    _hold(res, _ref(mesh, q, k, v, strategy="ulysses"), F32_TOL)
    _hold(res, _dense_reference(q, k, v), F32_TOL)


@pytest.mark.parametrize("strategy", ["ring", "ulysses"])
def test_gqa_grouped_kv_heads(world, mesh, strategy):
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, 64, 8, 16)).astype(np.float32)
    k = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, 64, 2, 16)).astype(np.float32)
    res = _port(world, q, k, v, strategy=strategy, causal=True)
    _hold(res, _ref(mesh, q, k, v, strategy=strategy, causal=True), F32_TOL)
    _hold(res, _dense_reference(q, np.repeat(k, 4, 2), np.repeat(v, 4, 2), True), F32_TOL)


def test_gqa_bad_group_raises(world, mesh):
    q, k, v = _qkv()
    k, v = k[:, :, :3], v[:, :, :3]
    want = _error_of(lambda: _ref(mesh, q, k, v))
    assert "multiple of kv heads" in want
    assert [r["error"] for r in _port(world, q, k, v)] == [want] * 8


def test_unknown_strategy(world, mesh):
    q, k, v = _qkv()
    want = _error_of(lambda: _ref(mesh, q, k, v, strategy="nope"))
    assert "strategy" in want
    assert [r["error"] for r in _port(world, q, k, v, strategy="nope")] == [want] * 8


# the reference's local="flash" cases (``:127-151``, ``:223``, ``:279``):
# (batch, length, heads, kv heads, head dim, causal, the reference's knobs)
_FLASH_CASES = {
    "s512-d64": (2, 512, 8, 8, 64, False, {}),
    "s512-d64-causal": (2, 512, 8, 8, 64, True, {}),
    "block-override-s96": (2, 96, 8, 8, 16, False, {"block_q": 32, "block_k": 32}),
    "auto-block-s96": (2, 96, 8, 8, 16, False, {}),
    "odd-length-s104-causal": (2, 104, 8, 8, 16, True, {}),
    "gqa-s128-causal": (2, 128, 8, 2, 16, True, {"block_q": 128, "block_k": 128}),
}


@pytest.mark.parametrize("case", sorted(_FLASH_CASES))
def test_ulysses_flash_local_matches_reference(world, mesh, case):
    b, s, h, h_kv, d, causal, knobs = _FLASH_CASES[case]
    q, k, v = _qkv(seed=9, b=b, s=s, h=h, d=d, h_kv=h_kv)
    res = _port(world, q, k, v, strategy="ulysses", local="flash", causal=causal)
    ref = _ref(mesh, q, k, v, strategy="ulysses", local="flash", causal=causal,
               interpret=True, **knobs)
    _hold(res, ref, FLASH_LOCAL_TOL)


def test_ring_peak_memory_is_blockwise(world):
    """No rank's plain attention ever sees more than one s_local key block:
    the (S, S) score matrix is never formed."""
    b, s, h, d = 1, 512, 4, 8
    q, k, v = _qkv(seed=2, b=b, s=s, h=h, d=d)
    for causal in (False, True):
        res = _port(world, q, k, v, strategy="ring", causal=causal)
        for r, got in enumerate(res):
            assert got["key_blocks"] and max(got["key_blocks"]) == s // 8, got["key_blocks"]
            # causal: rank r scores blocks 0..r only
            assert len(got["key_blocks"]) == (r + 1 if causal else 8)
        _hold(res, _dense_reference(q, k, v, causal), F32_TOL)


def test_ring_over_a_built_layout(world, mesh):
    """A (data=4, model=2) SpecLayout: the sequence over data, the model
    ranks replicas."""
    q, k, v = _qkv(seed=3, s=32)
    res = _port(world, q, k, v, strategy="ring", causal=True, layout=("build", 4, 2))
    _hold(res, _dense_reference(q, k, v, True), F32_TOL)
    assert res[0]["collectives"] == {"shift:data": 3, "gather:data": 1}


# -- the log-sum-exp of kernel C's plain version --------------------------------------------

_LSE_CASES = {
    "plain": (1, 16, 16, 4, 4, 8, False),
    "causal": (2, 33, 33, 2, 1, 32, True),
    "gqa-causal-sq<sk": (2, 24, 40, 4, 2, 16, True),
    "gqa-sq<sk": (2, 8, 50, 6, 3, 64, False),
}


def _np_lse(q, k, causal):
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    kx = np.repeat(k, h // h_kv, axis=2).astype(np.float64)
    sc = np.einsum("bqhd,bkhd->bhqk", q.astype(np.float64), kx) / math.sqrt(d)
    if causal:
        qpos = np.arange(s_q)[:, None] + (s_k - s_q)
        sc = np.where(qpos >= np.arange(s_k)[None, :], sc, -1e30)
    mx = sc.max(-1, keepdims=True)
    return (mx + np.log(np.exp(sc - mx).sum(-1, keepdims=True)))[..., 0]


@pytest.mark.parametrize("case", sorted(_LSE_CASES))
def test_plain_lse_matches_numpy(case):
    b, s_q, s_k, h, h_kv, d, causal = _LSE_CASES[case]
    rng = np.random.default_rng(41)
    q = rng.normal(size=(b, s_q, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s_k, h_kv, d)).astype(np.float32)
    v = rng.normal(size=(b, s_k, h_kv, d)).astype(np.float32)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = flash_attention(qt, kt, vt, causal=causal, return_lse=True)
    assert lse.shape == (b, h, s_q) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), _np_lse(q, k, causal), rtol=LSE_TOL,
                               atol=LSE_TOL)
    assert torch.equal(out, flash_attention(qt, kt, vt, causal=causal))


@pytest.mark.parametrize("causal", [False, True])
def test_merge_of_two_key_blocks_is_the_whole(causal):
    """Two halves of the keys scored apart and merged by their log-sum-exp
    give attention over all the keys (the ring's step)."""
    rng = np.random.default_rng(42)
    q = torch.from_numpy(rng.normal(size=(2, 16, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 32, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 32, 2, 16)).astype(np.float32))
    o1, l1 = dense_attention(q, k[:, :16], v[:, :16], return_lse=True)
    o2, l2 = dense_attention(q, k[:, 16:], v[:, 16:], causal=causal, return_lse=True)
    out, lse = merge_lse(o1.float(), l1, o2, l2)
    # causal: the 16 queries are the last 16 of 32 positions (end-aligned),
    # so they see all of the first half and the second half causally
    want, want_lse = dense_attention(q, k, v, causal=causal, return_lse=True)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=LSE_TOL, atol=LSE_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=LSE_TOL, atol=LSE_TOL)
