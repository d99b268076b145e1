"""Flash attention (kernel C) — port of ``synapseml_tpu/parallel/flash.py``.

Forward-only blockwise attention with an online softmax: the (S_q, S_k)
score matrix never reaches device memory. Layout (B, S, H, D) for queries and
(B, S_k, H_kv, D) for keys/values, ``H_kv`` dividing ``H`` (grouped-query
attention: query head ``h`` reads K/V head ``h // (H / H_kv)``, never
expanded). ``causal`` aligns the diagonal to the END of the keys (queries
are the last ``S_q`` positions); masked scores are a finite ``-1e30``.

On CUDA tensors :func:`flash_attention` launches ``csrc/flash_attn.cu``,
one of two kernels chosen by dtype alone (:func:`kernel_for`):

- bf16 at head dim 16, 32, 64 or 128: a warp-specialised Hopper kernel, TMA
  loads into a shared-memory ring and ``wgmma`` products, the swizzle set by
  the row width (``FLASH_KERNEL``; needs ``sm_90a``);
- f32 at the same head dims: ``mma.sync`` on the tensor cores in 3xTF32, each
  operand split into two tf32 halves and each product formed from three, for
  about f32 accuracy (``FLASH_F32_KERNEL``).

With ``return_lse=True`` the same kernel also writes each query row's
log-sum-exp, ``m + log(l)`` of its scaled scores over the keys it sees (f32,
(B, H, S_q); one store a row), through the source's ``*_lse`` entries,
counted apart (``FLASH_LSE_KERNEL``, ``FLASH_F32_LSE_KERNEL``): ring
attention merges the blocks of a row by it.

Both read q, k and v through 16-byte copies (TMA, ``cp.async``), so the
wrapper refuses a tensor whose data does not start on a 16-byte boundary.
On CPU tensors it runs :func:`dense_attention`, the plain PyTorch version.
The reference's TPU-only parts are gone: the block sizes are fixed for the
card, and the kernels mask the ragged tail themselves, so any sequence
length works (no dense fallback, no tile minimum).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..kernels.build import CudaKernel

__all__ = ["flash_attention", "dense_attention", "kernel_for", "FLASH_KERNEL",
           "FLASH_F32_KERNEL", "FLASH_LSE_KERNEL", "FLASH_F32_LSE_KERNEL",
           "KERNEL_HEAD_DIMS", "KEY_TILE_BY_HEAD_DIM"]

_NEG = -1e30
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
# keys per tile of the bf16 kernel at each head dim (wgmma_key_tile in the source)
KEY_TILE_BY_HEAD_DIM = {16: 256, 32: 256, 64: 128, 128: 128}

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
_REPLACES = "synapseml_tpu/parallel/flash.py:193 (_flash_bh_impl, pl.pallas_call at :272)"

FLASH_KERNEL = CudaKernel(
    name="flash_attention_fwd", source="flash_attn", symbol="smt_flash_fwd",
    argtypes=_ARGTYPES, replaces=_REPLACES)
FLASH_F32_KERNEL = CudaKernel(
    name="flash_attention_fwd_f32", source="flash_attn", symbol="smt_flash_fwd_f32",
    argtypes=_ARGTYPES, replaces=_REPLACES)
# the same kernels with each row's log-sum-exp written too (ring attention)
_LSE_ARGTYPES = _ARGTYPES[:4] + [ctypes.c_void_p] + _ARGTYPES[4:]
_LSE_REPLACES = _REPLACES + "; ring step synapseml_tpu/parallel/ring.py:87-122"
FLASH_LSE_KERNEL = CudaKernel(
    name="flash_attention_fwd_lse", source="flash_attn", symbol="smt_flash_fwd_lse",
    argtypes=_LSE_ARGTYPES, replaces=_LSE_REPLACES)
FLASH_F32_LSE_KERNEL = CudaKernel(
    name="flash_attention_fwd_f32_lse", source="flash_attn", symbol="smt_flash_fwd_f32_lse",
    argtypes=_LSE_ARGTYPES, replaces=_LSE_REPLACES)


def kernel_for(dtype: torch.dtype, head_dim: int, lse: bool = False) -> CudaKernel:
    """The kernel that serves ``dtype`` (at any head dim of
    ``KERNEL_HEAD_DIMS``): the wgmma kernel for bf16, the 3xTF32 kernel for
    f32; ``lse`` the entry that also writes each row's log-sum-exp."""
    if dtype == torch.bfloat16:
        return FLASH_LSE_KERNEL if lse else FLASH_KERNEL
    return FLASH_F32_LSE_KERNEL if lse else FLASH_F32_KERNEL


def _check(q, k, v, causal):
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    if k.shape != (b, s_k, h_kv, d) or v.shape != (b, s_k, h_kv, d):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    if h % h_kv:
        raise ValueError(f"query heads {h} must be a multiple of kv heads "
                         f"{h_kv} (GQA groups)")
    if causal and s_q > s_k:
        raise ValueError(f"causal flash attention needs s_q <= s_k, got "
                         f"s_q={s_q} > s_k={s_k}")


def dense_attention(q, k, v, causal: bool = False, pv_dtype: Optional[torch.dtype] = None,
                    q_chunk: int = 4096, return_lse: bool = False):
    """Plain PyTorch attention, the kernel's plain version: (B, S, H, D)
    layout, f32 scores and softmax, GQA heads mapped to their K/V group.

    One (batch, head, query chunk) at a time, so long sequences fit in
    memory. ``pv_dtype`` casts the probabilities (and V) for the P@V
    product, as the flash kernel does; by default P@V is f32. The result is
    in ``q``'s dtype; with ``return_lse`` also each row's log-sum-exp of its
    scaled, masked scores, f32 (B, H, S_q)."""
    _check(q, k, v, causal)
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    rep = h // h_kv
    scale = 1.0 / math.sqrt(d)
    pv = torch.float32 if pv_dtype is None else pv_dtype
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device) if return_lse else None
    kpos = torch.arange(s_k, device=q.device)
    for bi in range(b):
        for hi in range(h):
            kh = k[bi, :, hi // rep].float()
            vh = v[bi, :, hi // rep].to(pv)
            for q0 in range(0, s_q, q_chunk):
                qc = q[bi, q0:q0 + q_chunk, hi].float()
                sc = (qc @ kh.T) * scale
                if causal:
                    qpos = torch.arange(q0, q0 + qc.shape[0], device=q.device) + (s_k - s_q)
                    sc = torch.where(qpos[:, None] >= kpos[None, :], sc, _NEG)
                p = torch.exp(sc - sc.amax(-1, keepdim=True))
                p = p / p.sum(-1, keepdim=True)
                out[bi, q0:q0 + q_chunk, hi] = (p.to(pv) @ vh).to(q.dtype)
                if return_lse:
                    lse[bi, hi, q0:q0 + q_chunk] = torch.logsumexp(sc, -1)
    return (out, lse) if return_lse else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, return_lse: bool = False):
    """Blockwise online-softmax attention, ``q`` (B, S_q, H, D), ``k``/``v``
    (B, S_k, H_kv, D) -> (B, S_q, H, D) in ``q``'s dtype; with
    ``return_lse`` the pair (output, log-sum-exp (B, H, S_q) f32).

    CUDA tensors (f32 or bf16, head dim 16/32/64/128) launch kernel C (the
    kernel :func:`kernel_for` names); CPU tensors take the plain version."""
    _check(q, k, v, causal)
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, "
                         f"{v.device}")
    if q.device.type == "cpu":
        return dense_attention(q, k, v, causal=causal, return_lse=return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32,
                                                             torch.bfloat16):
        raise TypeError(f"flash kernel takes f32 or bf16 q/k/v of one dtype, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash kernel head dim must be one of {KERNEL_HEAD_DIMS}, "
                         f"got {d}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_q), dtype=torch.float32, device=q.device) if return_lse else None
    if q.numel() == 0 or s_k == 0:
        out.zero_()
        return (out, lse.fill_(float("-inf"))) if return_lse else out
    # TMA and cp.async read 16-byte aligned bases; the row strides (multiples
    # of 2*D bytes) always are
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"flash kernel needs 16-byte aligned tensors; {name} starts at "
                             f"{t.data_ptr():#x}")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()) + \
        ((lse.data_ptr(),) if return_lse else ())
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        kernel_for(q.dtype, d, return_lse)(*ptrs, b, s_q, s_k, h, h_kv, d, int(bool(causal)),
                                           stream)
    return (out, lse) if return_lse else out
