"""Port parity: flash attention's plain version against the JAX package's
Pallas kernel (interpret mode) and dense attention, with the reference's own
cases and tolerances (tests/test_parallel.py)."""

import math
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapseml_tpu.parallel.flash import dense_attention as ref_dense
from synapseml_tpu.parallel.flash import flash_attention as ref_flash
from synapseml_tpu_torch.kernels.build import CSRC_DIR
from synapseml_tpu_torch.parallel.flash import (FLASH_F32_KERNEL, FLASH_KERNEL,
                                                KEY_TILE_BY_HEAD_DIM, KERNEL_HEAD_DIMS,
                                                dense_attention, flash_attention, kernel_for)


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


@pytest.mark.parametrize("head_dim", KERNEL_HEAD_DIMS)
def test_kernel_choice_is_by_dtype_and_head_dim(head_dim):
    """bf16 at every head dim goes to the wgmma kernel, f32 to the 3xTF32
    kernel; the key tile that the chip check drops is the one the CUDA source
    builds for this head dim (its wgmma_key_tile)."""
    assert kernel_for(torch.bfloat16, head_dim) is FLASH_KERNEL
    assert kernel_for(torch.float32, head_dim) is FLASH_F32_KERNEL
    assert FLASH_KERNEL.symbol != FLASH_F32_KERNEL.symbol
    src = open(os.path.join(CSRC_DIR, "flash_attn.cu")).read()
    rule = re.search(r"int wgmma_key_tile\(int D\) \{ return D <= (\d+) \? (\d+) : (\d+); \}",
                     src)
    assert rule
    small_max, small_tile, tile = (int(x) for x in rule.groups())
    assert KEY_TILE_BY_HEAD_DIM[head_dim] == (small_tile if head_dim <= small_max else tile)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """The kernel's tf32 rounding, the same as cvt.rna.tf32.f32 on finite
    values: 10 mantissa bits, nearest, ties away from zero (add half of the
    dropped range to the magnitude bits, then clear them)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _mm_tf32(a: torch.Tensor, b: torch.Tensor, passes: int) -> torch.Tensor:
    """a @ b as the f32 kernel forms it: 3xTF32, hi.hi summed apart from
    lo.hi + hi.lo (hi = tf32(x), lo = tf32(x - hi)), or one TF32 product for
    contrast."""
    if passes == 1:
        return _tf32(a) @ _tf32(b)
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return ah @ bh + (al @ bh + ah @ bl)


def _emulate_f32_kernel(q, k, v, causal, passes=3):
    """The f32 kernel's arithmetic in plain torch: key tiles of its size, both
    products in 3xTF32, the online softmax in base 2 with scale*log2(e) folded
    in, P split like any other operand."""
    _, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    tile = 32 if d == 128 else 64
    cl2 = torch.tensor(math.log2(math.e) / math.sqrt(d), dtype=torch.float32)
    qpos = torch.arange(s_q) + (s_k - s_q)
    kpos = torch.arange(s_k)
    out = torch.empty_like(q)
    for bi in range(q.shape[0]):
        for hi in range(h):
            qh, kh, vh = q[bi, :, hi], k[bi, :, hi // (h // h_kv)], v[bi, :, hi // (h // h_kv)]
            m, l = torch.full((s_q,), -1e30), torch.zeros(s_q)
            acc = torch.zeros(s_q, d)
            for k0 in range(0, s_k, tile):
                s = _mm_tf32(qh, kh[k0:k0 + tile].T, passes)
                if causal:
                    s = torch.where(qpos[:, None] >= kpos[None, k0:k0 + tile], s, -1e30)
                mx = torch.maximum(m, s.amax(-1))
                corr = torch.exp2(m * cl2 - mx * cl2)
                p = torch.exp2(s * cl2 - (mx * cl2)[:, None])
                m, l = mx, l * corr + p.sum(-1)
                acc = acc * corr[:, None] + _mm_tf32(p, vh[k0:k0 + tile], passes)
            out[bi, :, hi] = acc / torch.clamp(l, min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("head_dim", KERNEL_HEAD_DIMS)
def test_f32_kernel_3xtf32_arithmetic_holds_2e5(head_dim, causal):
    """The f32 kernel's numeric design, checked before any chip time: 3xTF32
    products stay within the f32 contract (2e-5) of the reference's dense
    attention and of its Pallas kernel (interpret mode), while one TF32
    product per multiply does not (about 1e-3)."""
    rng = np.random.default_rng(23 + head_dim)
    q = rng.normal(size=(1, 256, 2, head_dim)).astype(np.float32)
    k = rng.normal(size=(1, 256, 1, head_dim)).astype(np.float32)
    v = rng.normal(size=(1, 256, 1, head_dim)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    out = _emulate_f32_kernel(*t, causal).numpy()
    dense = np.asarray(ref_dense(jnp.asarray(q), jnp.repeat(jnp.asarray(k), 2, axis=2),
                                 jnp.repeat(jnp.asarray(v), 2, axis=2), causal=causal))
    pallas = np.asarray(ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=causal, block_q=64, block_k=128, interpret=True))
    assert float(np.abs(out - dense).max()) <= 2e-5
    assert float(np.abs(out - pallas).max()) <= 2e-5
    one_pass = _emulate_f32_kernel(*t, causal, passes=1).numpy()
    assert float(np.abs(one_pass - dense).max()) > 2e-5
