"""Gradient/hessian histograms — the GBDT engine's hot loop (kernel A).

Port of ``synapseml_tpu/gbdt/histogram.py``. For every (feature, bin) cell
the histogram sums the rows' ``[g·w, h·w, w]`` into a (d, B, 3) f32 tensor.
On CUDA tensors :func:`histogram` launches the hand-written kernel in
``csrc/histogram.cu`` (shared-memory sub-histograms with atomics, merged into
global memory with atomics; it forms the products itself, so no (n, 3)
panel is built); on CPU tensors it runs the plain PyTorch version
:func:`histogram_plain` (``index_add_``), which the CPU tests hold against
the reference's scatter path.

Summation order differs between the two (atomics), so raw gradients agree to
float rounding; gradients pre-rounded by ``boost._preround``, with 0/1
weights, make every cell exact in any order, and then the kernel is
bit-equal to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..kernels.build import CudaKernel

__all__ = ["histogram", "histogram_plain", "HIST_CHANNELS", "HIST_KERNEL"]

HIST_CHANNELS = 3  # grad, hess, count

_BIN_DTYPES = (torch.int8, torch.int16, torch.int32)

HIST_KERNEL = CudaKernel(
    name="gbdt_histogram", source="histogram", symbol="smt_histogram",
    argtypes=[ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p],
    replaces="synapseml_tpu/gbdt/histogram.py:27 (_hist_scatter / _hist_onehot)")


def histogram_plain(binned: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                    weight: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Plain PyTorch version: one ``index_add_`` over ``feature * B + bin``."""
    n, d = binned.shape
    ghc = torch.stack([grad * weight, hess * weight, weight], dim=-1)
    flat = binned.to(torch.int64) + torch.arange(d, device=binned.device)[None, :] * n_bins
    out = torch.zeros(d * n_bins, HIST_CHANNELS, dtype=torch.float32,
                      device=binned.device)
    vals = ghc[:, None, :].expand(n, d, HIST_CHANNELS).reshape(-1, HIST_CHANNELS)
    out.index_add_(0, flat.reshape(-1), vals)
    return out.reshape(d, n_bins, HIST_CHANNELS)


def _check(binned: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
           weight: torch.Tensor, n_bins: int) -> None:
    if binned.dim() != 2 or binned.dtype not in _BIN_DTYPES:
        raise TypeError(f"binned must be a 2-D int8/int16/int32 tensor, got "
                        f"{binned.dtype} of shape {tuple(binned.shape)}")
    for name, t in (("grad", grad), ("hess", hess), ("weight", weight)):
        if t.shape != (binned.shape[0],) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be ({binned.shape[0]},) float32, got "
                            f"{t.dtype} of shape {tuple(t.shape)}")
        if t.device != binned.device:
            raise ValueError(f"binned on {binned.device} but {name} on {t.device}")
    if n_bins < 1 or n_bins * HIST_CHANNELS * 4 > 227 * 1024:
        raise ValueError(f"n_bins={n_bins}: one feature's (B, 3) f32 histogram "
                         "must fit one block's shared memory")


def histogram(binned: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              weight: torch.Tensor, n_bins: int) -> torch.Tensor:
    """(d, B, 3) histogram of ``[grad, hess, count]``, each scaled by ``weight``.

    ``binned`` (n, d) int8/int16/int32 bins, read at their stored width;
    ``grad``/``hess``/``weight`` (n,) f32. CPU tensors take the plain
    version; CUDA tensors launch kernel A."""
    _check(binned, grad, hess, weight, n_bins)
    if binned.device.type == "cpu":
        return histogram_plain(binned, grad, hess, weight, n_bins)
    if binned.device.type != "cuda":
        raise ValueError(f"unsupported device {binned.device}")
    binned = binned.contiguous()
    grad, hess, weight = grad.contiguous(), hess.contiguous(), weight.contiguous()
    n, d = binned.shape
    out = torch.zeros(d, n_bins, HIST_CHANNELS, dtype=torch.float32,
                      device=binned.device)
    if n == 0 or d == 0:
        return out
    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        HIST_KERNEL(binned.data_ptr(), binned.element_size(), grad.data_ptr(),
                    hess.data_ptr(), weight.data_ptr(), out.data_ptr(), n, d, n_bins,
                    stream)
    return out
