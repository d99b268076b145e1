"""Gradient/hessian histograms — the GBDT engine's hot loop (kernel A).

Port of ``synapseml_tpu/gbdt/histogram.py``. For every (feature, bin) cell
the histogram sums the rows' ``[g·w, h·w, w]`` into a (d, B, 3) f32 tensor.
On CUDA tensors :func:`histogram` launches the hand-written kernel in
``csrc/histogram.cu`` (a warp per 32 rows, shared-memory sub-histograms with
conflict-free atomics, merged into global memory with atomics; it forms the
products itself, so no (n, 3) panel is built, and it skips the rows that
cannot change the result: weight 0 with finite g and h); on CPU tensors it
runs the plain PyTorch version :func:`histogram_plain` (``index_add_``),
which the CPU tests hold against the reference's scatter path.

Summation order differs between the two (atomics), so raw gradients agree to
float rounding; gradients pre-rounded by ``boost._preround``, with 0/1
weights, make every cell exact in any order, and then the kernel is
bit-equal to the plain version.

:func:`histogram_rows` is kernel A's row-list entry: the histogram of the
rows ``ids[buffer, begin:begin + count]``, with ``(begin, count, buffer)``
read on the device (kernel P's smaller child, :mod:`.partition`), so a
leaf-local growth step reads only that child's rows and never brings its
size to the host. The grower adds it into a persistent zeroed buffer, and
:func:`sibling` (the epilogue, a third entry of the same source) ends the
step in one launch: the smaller child's sibling by subtraction from the
split leaf, both written into the table, and the buffer zeroed again.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..kernels.build import CudaKernel

__all__ = ["histogram", "histogram_plain", "histogram_rows", "histogram_rows_plain",
           "sibling", "sibling_plain", "HIST_CHANNELS", "HIST_KERNEL", "HIST_ROWS_KERNEL",
           "SIBLING_KERNEL", "HIST_TRACE", "HIST_ROWS_TRACE", "SIBLING_TRACE"]

HIST_CHANNELS = 3  # grad, hess, count

_BIN_DTYPES = (torch.int8, torch.int16, torch.int32)

HIST_KERNEL = CudaKernel(
    name="gbdt_histogram", source="histogram", symbol="smt_histogram",
    argtypes=[ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p],
    replaces="synapseml_tpu/gbdt/histogram.py:27 (_hist_scatter / _hist_onehot)")
HIST_ROWS_KERNEL = CudaKernel(
    name="gbdt_histogram_rows", source="histogram", symbol="smt_histogram_rows",
    argtypes=[ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
    replaces="synapseml_tpu/gbdt/grow.py:223 (leaf_hist_local: the cumsum-scatter "
             "compaction into a power-of-two buffer, then histogram_panel)")
SIBLING_KERNEL = CudaKernel(
    name="gbdt_sibling", source="histogram", symbol="smt_sibling",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
              ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p],
    replaces="synapseml_tpu/gbdt/grow.py:408 (the sibling by subtraction, :408-414)")
# the entries' kernel names in a profiler trace (hist_kernel<BinT, kList>,
# sibling_kernel), each as substrings that the name holds
HIST_TRACE = ("hist_kernel<", "false>")
HIST_ROWS_TRACE = ("hist_kernel<", "true>")
SIBLING_TRACE = ("sibling_kernel",)


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
    if n_bins < 1 or (n_bins * HIST_CHANNELS + 1) * 4 > 227 * 1024:
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


def histogram_rows_plain(binned: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                         weight: torch.Tensor, n_bins: int, ids: torch.Tensor,
                         span: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`histogram_rows`: :func:`histogram_plain`
    over the gathered rows."""
    begin, count, buf = (int(v) for v in span)
    idx = ids[buf, begin:begin + count].long()
    return histogram_plain(binned[idx], grad[idx], hess[idx], weight[idx], n_bins)


def histogram_rows(binned: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                   weight: torch.Tensor, n_bins: int, ids: torch.Tensor, span: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(d, B, 3) histogram of the rows ``ids[span[2], span[0]:span[0] + span[1]]``.

    ``binned``, ``grad``, ``hess``, ``weight`` as :func:`histogram`; ``ids``
    (2, m) int32, kernel P's two buffers of row ids in ``[0, n)``; ``span``
    (3,) int32 (begin, count, buffer), read on the device. ``out``: a zeroed
    (d, B, 3) f32 buffer that the histogram is added into and returned (the
    grower's, which :func:`sibling` zeroes again); None: a new one. CPU
    tensors take the plain version; CUDA tensors launch kernel A's row-list
    entry."""
    _check(binned, grad, hess, weight, n_bins)
    if ids.dtype != torch.int32 or ids.dim() != 2 or ids.shape[0] != 2:
        raise TypeError(f"ids must be an int32 (2, m) tensor, got {ids.dtype} of "
                        f"shape {tuple(ids.shape)}")
    if span.dtype != torch.int32 or span.shape != (3,):
        raise TypeError(f"span must be an int32 tensor of shape (3,), got {span.dtype} of "
                        f"shape {tuple(span.shape)}")
    for name, t in (("ids", ids), ("span", span)):
        if t.device != binned.device:
            raise ValueError(f"binned on {binned.device} but {name} on {t.device}")
    d = binned.shape[1]
    shape = (d, n_bins, HIST_CHANNELS)
    if out is None:
        out = torch.zeros(shape, dtype=torch.float32, device=binned.device)
    elif out.shape != shape or out.dtype != torch.float32 or out.device != binned.device \
            or not out.is_contiguous():
        raise TypeError(f"out must be a contiguous {shape} float32 tensor on {binned.device}, "
                        f"got {out.dtype} {tuple(out.shape)} on {out.device}")
    if binned.device.type == "cpu":
        return out.add_(histogram_rows_plain(binned, grad, hess, weight, n_bins, ids, span))
    if binned.device.type != "cuda":
        raise ValueError(f"unsupported device {binned.device}")
    if d == 0 or ids.numel() == 0:
        return out
    binned = binned.contiguous()
    grad, hess, weight = grad.contiguous(), hess.contiguous(), weight.contiguous()
    ids, span = ids.contiguous(), span.contiguous()
    with torch.cuda.device(binned.device):
        stream = torch.cuda.current_stream(binned.device).cuda_stream
        HIST_ROWS_KERNEL(binned.data_ptr(), binned.element_size(), grad.data_ptr(),
                         hess.data_ptr(), weight.data_ptr(), out.data_ptr(), ids.data_ptr(),
                         ids.shape[1], span.data_ptr(), d, n_bins, stream)
    return out


def sibling_plain(hists: torch.Tensor, small: torch.Tensor, leaf: torch.Tensor,
                  smaller_right: torch.Tensor, s: int) -> None:
    """Plain PyTorch version of :func:`sibling`: the torch ops of the step's
    tail (``x - c`` as ``index_add_`` with ``alpha=-1``, the reference's
    ``.at[l].add(-child)``), then ``small`` zeroed."""
    child = torch.where(smaller_right, small, torch.index_select(hists, 0, leaf)[0] - small)
    hists[s + 1] = child
    hists.index_add_(0, leaf, child[None], alpha=-1)
    small.zero_()


def sibling(hists: torch.Tensor, small: torch.Tensor, leaf: torch.Tensor,
            smaller_right: torch.Tensor, s: int) -> None:
    """End growth step ``s``: ``child = small`` if ``smaller_right`` else
    ``hists[leaf] - small``; ``hists[s + 1] = child``, ``hists[leaf] -=
    child``; ``small = 0``. ``hists`` (L, d, B, 3) f32, ``small`` (d, B, 3)
    f32, ``leaf`` (1,) int64 (kernel E's ``choice[:1]``, a leaf ``<= s``),
    ``smaller_right`` (1,) bool (kernel P's), all read on the device. An
    inert step (``small`` zero, ``smaller_right`` set) leaves every leaf as it
    was. CPU tensors take the plain version; CUDA tensors launch the
    epilogue kernel."""
    L = hists.shape[0]
    if hists.dim() != 4 or small.shape != hists.shape[1:] or hists.dtype != torch.float32 \
            or small.dtype != torch.float32 or not 0 <= s < L - 1:
        raise TypeError(f"hists (L, d, B, 3) and small (d, B, 3) float32 with 0 <= s < L - 1, "
                        f"got {tuple(hists.shape)} {hists.dtype}, {tuple(small.shape)} "
                        f"{small.dtype}, s={s}")
    for name, t, dt in (("small", small, torch.float32), ("leaf", leaf, torch.int64),
                        ("smaller_right", smaller_right, torch.bool)):
        if t.device != hists.device or t.dtype != dt or (t is not small and t.shape != (1,)):
            raise TypeError(f"{name} must be {dt} on {hists.device}, got {t.dtype} "
                            f"{tuple(t.shape)} on {t.device}")
    if hists.device.type == "cpu":
        sibling_plain(hists, small, leaf, smaller_right, s)
        return
    if not (hists.is_contiguous() and small.is_contiguous()):
        raise TypeError("hists and small must be contiguous")
    with torch.cuda.device(hists.device):
        SIBLING_KERNEL(hists.data_ptr(), small.data_ptr(), leaf.data_ptr(),
                       smaller_right.data_ptr(), s, small.numel(),
                       torch.cuda.current_stream(hists.device).cuda_stream)
