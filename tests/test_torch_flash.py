"""Port parity: flash attention's plain version against the JAX package's
Pallas kernel (interpret mode) and dense attention, with the reference's own
cases and tolerances (tests/test_parallel.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapseml_tpu.parallel.flash import dense_attention as ref_dense
from synapseml_tpu.parallel.flash import flash_attention as ref_flash
from synapseml_tpu_torch.parallel.flash import dense_attention, flash_attention


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(256, 256), (128, 512)])
def test_flash_matches_reference_f32(causal, sq, sk):
    rng = np.random.default_rng(7)
    q = rng.normal(size=(2, sq, 4, 64)).astype(np.float32)
    k = rng.normal(size=(2, sk, 4, 64)).astype(np.float32)
    v = rng.normal(size=(2, sk, 4, 64)).astype(np.float32)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                          causal=causal).numpy()
    pallas = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, block_q=64, block_k=128, interpret=True))
    dense = np.asarray(ref_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal))
    np.testing.assert_allclose(out, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, dense, rtol=2e-5, atol=2e-5)


def test_flash_bf16_within_tolerance():
    rng = np.random.default_rng(8)
    q, k, v = (rng.normal(size=(1, 256, 2, 64)).astype(np.float32) for _ in range(3))
    ref = np.asarray(ref_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    t = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    out = flash_attention(t(q), t(k), t(v), causal=True)
    assert out.dtype == torch.bfloat16
    assert float(np.abs(out.float().numpy() - ref).max()) < 5e-2
    # dense with the kernel's bf16 P.V cast stays within the same band
    pv = dense_attention(t(q), t(k), t(v), causal=True, pv_dtype=torch.bfloat16)
    assert float(np.abs(pv.float().numpy() - ref).max()) < 5e-2


def test_flash_gqa_grouped_matches_expanded():
    rng = np.random.default_rng(17)
    B, S, H, Hkv, D = 2, 256, 8, 2, 16
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, D)).astype(np.float32)
    grouped = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True).numpy()
    kx, vx = np.repeat(k, 4, axis=2), np.repeat(v, 4, axis=2)
    expanded = flash_attention(torch.from_numpy(q), torch.from_numpy(kx),
                               torch.from_numpy(vx), causal=True).numpy()
    np.testing.assert_allclose(grouped, expanded, rtol=1e-6, atol=1e-6)
    ref = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                               block_q=128, block_k=128, interpret=True))
    np.testing.assert_allclose(grouped, ref, rtol=2e-5, atol=2e-5)


def test_flash_odd_length_causal_gqa_matches_dense():
    """The kernel masks its ragged tail, so any length works (the reference's
    Mosaic tile minimum and dense fallback do not apply)."""
    rng = np.random.default_rng(11)
    q = rng.normal(size=(1, 300, 4, 64)).astype(np.float32)
    kv = rng.normal(size=(1, 300, 2, 64)).astype(np.float32)
    out = flash_attention(torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(kv),
                          causal=True).numpy()
    ref = np.asarray(ref_dense(jnp.asarray(q), jnp.repeat(jnp.asarray(kv), 2, axis=2),
                               jnp.repeat(jnp.asarray(kv), 2, axis=2), causal=True))
    np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)


def test_flash_shape_errors():
    q = torch.zeros(1, 256, 2, 64)
    with pytest.raises(ValueError, match="mismatch"):
        flash_attention(q, torch.zeros(1, 200, 2, 64), torch.zeros(1, 200, 4, 64))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention(torch.zeros(1, 256, 3, 64), torch.zeros(1, 256, 2, 64),
                        torch.zeros(1, 256, 2, 64))
    with pytest.raises(ValueError, match="s_q <= s_k"):
        flash_attention(q, torch.zeros(1, 128, 2, 64), torch.zeros(1, 128, 2, 64),
                        causal=True)
