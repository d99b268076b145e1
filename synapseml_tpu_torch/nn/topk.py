"""The k largest entries of each row in the reference's order: hand kernel K.

The JAX package ranks its score matrices with ``jax.lax.top_k``
(``nn/knn.py:46``, ``recommendation/sar.py:211``), which orders f32 values
by XLA's total order: +NaN, +inf down to +0.0, then -0.0, down to -inf, then
-NaN, equal bits lower index first. ``torch.topk`` breaks ties in its own
order and a descending sort puts -NaN first and -0.0 level with +0.0, so
neither returns the reference's neighbours or recommendations where scores
tie, which duplicate keys and equal SAR scores make common.

:func:`topk_select` orders by the key ``bits ^ (sign ? 0xFFFFFFFF :
0x80000000)`` (:func:`order_key`), descending, ties by ascending index, and
returns the input's own values: kernel K (``csrc/topk_select.cu``,
:data:`TOPK_KERNEL`) on a CUDA tensor, :func:`topk_select_plain` (a stable
descending sort of the same key) on a CPU tensor.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..kernels.build import CudaKernel

__all__ = ["TOPK_KERNEL", "TOPK_SMEM_K", "TOPK_TIE_TOL", "order_key",
           "topk_select", "topk_select_plain"]

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
TOPK_KERNEL = CudaKernel(
    name="topk_select", source="topk_select", symbol="smt_topk_select",
    argtypes=[_P, _LL, _LL, ctypes.c_int, _P, _P, _P, _P],
    replaces="synapseml_tpu/nn/knn.py:46 (jax.lax.top_k; also "
             "synapseml_tpu/recommendation/sar.py:211, SARModel._top_k)")

# csrc/topk_select.cu's kSmemK: up to this k the candidates sort in shared
# memory, past it in a global scratch the wrapper allocates
TOPK_SMEM_K = 4096
# Card against CPU (KNN, SAR): the two devices' f32 matrix products sum in
# other orders, so two scores closer than TOPK_TIE_TOL x max(1, the row's
# largest |score|) may trade places; the selection of equal scores is exact
TOPK_TIE_TOL = 1e-5


def order_key(scores: torch.Tensor) -> torch.Tensor:
    """The order-preserving key of f32 ``scores`` as an int64 tensor in
    [0, 2^32): ascending key is XLA's total order on f32."""
    bits = scores.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF, bits ^ 0x80000000)


def _check(scores: torch.Tensor, k: int) -> None:
    if scores.dim() != 2 or scores.dtype != torch.float32:
        raise ValueError(f"scores must be a (rows, n) float32 matrix, got "
                         f"{tuple(scores.shape)} {scores.dtype}")
    if not 0 <= k <= scores.shape[1]:
        raise ValueError(f"k={k} must lie in [0, n={scores.shape[1]}] (lax.top_k's rule)")


def topk_select_plain(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k(scores, k)`` as (values (rows, k) f32, indices (rows, k)
    int64): a stable descending sort of :func:`order_key`, the first k."""
    _check(scores, k)
    _, order = torch.sort(order_key(scores), dim=1, descending=True, stable=True)
    idx = order[:, :k].contiguous()
    return torch.gather(scores, 1, idx), idx


def topk_select(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k(scores, k)`` for a (rows, n) f32 matrix, 0 <= k <= n:
    kernel K on a CUDA tensor, :func:`topk_select_plain` on a CPU tensor.
    Returns (values (rows, k) f32, indices (rows, k) int64) on its device."""
    _check(scores, k)
    if scores.device.type == "cpu":
        return topk_select_plain(scores, k)
    scores = scores.contiguous()
    rows, n = scores.shape
    values = torch.empty((rows, k), dtype=torch.float32, device=scores.device)
    indices = torch.empty((rows, k), dtype=torch.int64, device=scores.device)
    if rows == 0 or k == 0:
        return values, indices
    scratch = None
    if k > TOPK_SMEM_K:
        scratch = torch.empty(rows * (1 << (k - 1).bit_length()), dtype=torch.int64,
                              device=scores.device)
    with torch.cuda.device(scores.device):
        stream = torch.cuda.current_stream(scores.device).cuda_stream
        TOPK_KERNEL(scores.data_ptr(), rows, n, int(k), values.data_ptr(), indices.data_ptr(),
                    None if scratch is None else scratch.data_ptr(), stream)
    return values, indices
