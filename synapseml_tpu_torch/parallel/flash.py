"""Flash attention (kernel C) — port of ``synapseml_tpu/parallel/flash.py``.

Forward-only blockwise attention with an online softmax: the (S_q, S_k)
score matrix never reaches device memory. Layout (B, S, H, D) for queries and
(B, S_k, H_kv, D) for keys/values, ``H_kv`` dividing ``H`` (grouped-query
attention: query head ``h`` reads K/V head ``h // (H / H_kv)``, never
expanded). ``causal`` aligns the diagonal to the END of the keys (queries
are the last ``S_q`` positions); masked scores are a finite ``-1e30``.

On CUDA tensors :func:`flash_attention` launches ``csrc/flash_attn.cu``:
bf16 products on the tensor cores (``mma.sync``) with f32 accumulation, f32
inputs on FMA. On CPU tensors it runs :func:`dense_attention`, the plain
PyTorch version. The reference's TPU-only parts are gone: the block
sizes are fixed for the card, and the kernel masks the ragged tail itself,
so any sequence length works (no dense fallback, no tile minimum).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ..kernels.build import CudaKernel

__all__ = ["flash_attention", "dense_attention", "FLASH_KERNEL", "KERNEL_HEAD_DIMS"]

_NEG = -1e30
KERNEL_HEAD_DIMS = (16, 32, 64, 128)

FLASH_KERNEL = CudaKernel(
    name="flash_attention_fwd", source="flash_attn", symbol="smt_flash_fwd",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    replaces="synapseml_tpu/parallel/flash.py:193 (_flash_bh_impl, pl.pallas_call at :272)")


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
                    q_chunk: int = 4096):
    """Plain PyTorch attention, the kernel's plain version: (B, S, H, D)
    layout, f32 scores and softmax, GQA heads mapped to their K/V group.

    One (batch, head, query chunk) at a time, so long sequences fit in
    memory. ``pv_dtype`` casts the probabilities (and V) for the P@V
    product, as the flash kernel does; by default P@V is f32. The result is
    in ``q``'s dtype."""
    _check(q, k, v, causal)
    b, s_q, h, d = q.shape
    s_k, h_kv = k.shape[1], k.shape[2]
    rep = h // h_kv
    scale = 1.0 / math.sqrt(d)
    pv = torch.float32 if pv_dtype is None else pv_dtype
    out = torch.empty_like(q)
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
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False) -> torch.Tensor:
    """Blockwise online-softmax attention, ``q`` (B, S_q, H, D), ``k``/``v``
    (B, S_k, H_kv, D) -> (B, S_q, H, D) in ``q``'s dtype.

    CUDA tensors (f32 or bf16, head dim 16/32/64/128) launch kernel C; CPU
    tensors take the plain version."""
    _check(q, k, v, causal)
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, "
                         f"{v.device}")
    if q.device.type == "cpu":
        return dense_attention(q, k, v, causal=causal)
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
    if q.numel() == 0 or s_k == 0:
        return out.zero_()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        FLASH_KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     1 if q.dtype == torch.bfloat16 else 0, b, s_q, s_k, h, h_kv, d,
                     int(bool(causal)), stream)
    return out
