"""Integer matmul and convolution of the quantized ONNX ops: hand kernel Q.

``MatMulInteger``, ``QLinearMatMul``, ``ConvInteger`` and ``QLinearConv``
(``ops.py``) contract zero-centred 8-bit operands into int32 sums, and the
QLinear ops requantize them. :func:`qmatmul` and :func:`qconv` are those
contractions: on a CUDA tensor they launch kernel Q (``csrc/qgemm.cu``:
``smt_qmatmul`` / ``smt_qconv``, raw uint8 / int8 operands on the tensor
cores, the zero points and the requantizing epilogue applied in the
kernel), on a CPU tensor their plain versions :func:`qmatmul_plain` /
:func:`qconv_plain` (the reference's arithmetic: widen to int32, subtract the
zero points, ``torch.matmul`` / ``F.conv2d`` in int32, then the same
epilogue in the same op order). Both give the reference's int32 sums modulo
2^32, exactly.

Zero points, scales and biases are tensors on the operands' device (0-d for a
scalar, 1-D along the spec's axis), so nothing is read back to the host.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..kernels.build import CudaKernel

__all__ = ["Requant", "qmatmul", "qconv", "qmatmul_plain", "qconv_plain",
           "QMATMUL_KERNEL", "QCONV_KERNEL"]

_QDTYPES = (torch.uint8, torch.int8)


class Requant(NamedTuple):
    """The QLinear ops' epilogue: ``saturate(round(float(acc + bias) * scale) +
    y_zp)`` into ``y_zp``'s dtype. ``scale`` is f32, computed by the caller in
    the reference's op order and broadcastable against the output (for a
    conv: 0-d or per output channel; for a matmul: against (M, N)); ``y_zp``
    likewise; ``bias`` int32 per output channel or None."""

    scale: torch.Tensor
    y_zp: torch.Tensor
    bias: Optional[torch.Tensor] = None


class _QArgs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("a", "b", "out", "a_zp_vec", "b_zp_vec", "bias", "scale_vec", "y_zp_vec")] + \
               [(name, ctypes.c_longlong) for name in
                ("a_batch", "b_batch", "out_batch", "lda", "ldb_k", "ldb_n", "a_zp_sm",
                 "b_zp_sn", "scale_sm", "scale_sn", "yzp_sm", "yzp_sn")] + \
               [("scale", ctypes.c_float)] + \
               [(name, ctypes.c_int) for name in
                ("M", "N", "K", "batch", "a_signed", "b_signed", "out_mode", "a_zp", "b_zp",
                 "y_zp", "n_img", "C", "H", "W", "KH", "KW", "OH", "OW", "sh", "sw", "ph", "pw",
                 "dh", "dw", "groups", "cin_g", "cout_g", "device")]


QMATMUL_KERNEL = CudaKernel(
    name="onnx_qmatmul", source="qgemm", symbol="smt_qmatmul",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p],
    replaces="synapseml_tpu/onnx/ops.py:795 (MatMulInteger; QLinearMatMul :860-861)")
QCONV_KERNEL = CudaKernel(
    name="onnx_qconv", source="qgemm", symbol="smt_qconv",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p],
    replaces="synapseml_tpu/onnx/ops.py:814 (ConvInteger :814-818; QLinearConv :834)")


def _conv_out_size(size: int, k: int, stride: int, dil: int, pad: Tuple[int, int]) -> int:
    return (size + pad[0] + pad[1] - dil * (k - 1) - 1) // stride + 1


# -- plain versions ------------------------------------------------------------------------

def _centre(q: torch.Tensor, zp: Optional[torch.Tensor], axis: int) -> torch.Tensor:
    """The reference's ``_zp_shift``: widen to int32, then subtract the zero
    point (a 1-D one lies along ``axis``)."""
    q = q.to(torch.int32)
    if zp is None:
        return q
    zp = zp.to(torch.int32)
    if zp.dim() == 1 and q.dim() > 1:
        shape = [1] * q.dim()
        shape[axis % q.dim()] = -1
        zp = zp.reshape(shape)
    return q - zp


def _requant_plain(acc: torch.Tensor, rq: Requant, qdtype: torch.dtype) -> torch.Tensor:
    if rq.bias is not None:
        acc = acc + rq.bias.to(torch.int32)
    y = torch.round(acc.to(torch.float32) * rq.scale) + rq.y_zp.to(torch.float32)
    info = torch.iinfo(qdtype)
    return torch.clamp(y, info.min, info.max).to(qdtype)


def qmatmul_plain(a, b, a_zp=None, b_zp=None, rq: Optional[Requant] = None) -> torch.Tensor:
    """Plain version of :func:`qmatmul`: int32 ``torch.matmul`` of the
    zero-centred operands (a 1-D ``a_zp`` along M, ``b_zp`` along N)."""
    acc = torch.matmul(_centre(a, a_zp, -2), _centre(b, b_zp, -1))
    return acc if rq is None else _requant_plain(acc, rq, rq.y_zp.dtype)


def qconv_plain(x, w, x_zp=None, w_zp=None, strides=(1, 1), pads=((0, 0), (0, 0)),
                dilations=(1, 1), groups: int = 1, rq: Optional[Requant] = None) -> torch.Tensor:
    """Plain version of :func:`qconv`: int32 convolution of the zero-centred
    operands, the padding zeros in the centred domain (real zero)."""
    xc, wc = _centre(x, x_zp, 0), _centre(w, w_zp, 0)
    rank = xc.dim() - 2
    flat = [p for pair in reversed(list(pads)) for p in pair]
    xc = F.pad(xc, flat) if any(flat) else xc
    if any(d != 1 for d in dilations):
        # torch's CPU convolution takes no dilation in int32: dilate the
        # kernel with zero taps instead (the same sums)
        size = [d * (k - 1) + 1 for d, k in zip(dilations, wc.shape[2:])]
        wd = wc.new_zeros(tuple(wc.shape[:2]) + tuple(size))
        wd[(slice(None), slice(None)) + tuple(slice(None, None, d) for d in dilations)] = wc
        wc = wd
    conv = (F.conv1d, F.conv2d, F.conv3d)[rank - 1]
    acc = conv(xc, wc, stride=tuple(strides), groups=groups)
    if rq is None:
        return acc
    chan = lambda s: s.reshape((1, -1) + (1,) * rank) if s.dim() == 1 else s
    return _requant_plain(acc, Requant(chan(rq.scale), chan(rq.y_zp),
                                       None if rq.bias is None else chan(rq.bias)),
                          rq.y_zp.dtype)


# -- kernel Q --------------------------------------------------------------------------------

def _check_q(t: torch.Tensor, what: str) -> None:
    if t.dtype not in _QDTYPES:
        raise TypeError(f"{what}: kernel Q takes uint8 or int8, got {t.dtype}")


def _vec(args: _QArgs, name: str, v: Optional[torch.Tensor], keep: list, dtype, dev,
         length: Optional[int] = None) -> Optional[torch.Tensor]:
    """Point ``args.<name>_vec`` at ``v`` (0-d: stride 0, broadcast), as
    ``dtype`` on ``dev``. Returns the tensor (None for None)."""
    if v is None:
        return None
    v = v.to(device=dev, dtype=dtype).contiguous()
    if length is not None and v.dim() == 1 and v.numel() != length:
        raise ValueError(f"{name}: {v.numel()} values, expected {length}")
    if v.dim() > 1:
        raise ValueError(f"{name}: a 0-d or 1-D tensor, got shape {tuple(v.shape)}")
    keep.append(v)
    return v


def _launch(kernel: CudaKernel, args: _QArgs, dev: torch.device) -> None:
    args.device = dev.index if dev.index is not None else torch.cuda.current_device()
    kernel(ctypes.addressof(args), torch.cuda.current_stream(dev).cuda_stream)


def _set_epilogue(args: _QArgs, rq: Optional[Requant], keep: list, dev, grid_mn, conv: bool):
    """The requantizing epilogue's fields; ``grid_mn`` = (M, N) of the output
    the scale and y_zp broadcast against (a conv's: (1, channels))."""
    if rq is None:
        args.out_mode = 0
        return torch.int32
    qdtype = rq.y_zp.dtype
    if qdtype not in _QDTYPES:
        raise TypeError(f"y_zero_point must be uint8 or int8, got {qdtype}")
    args.out_mode = 1 if qdtype == torch.uint8 else 2
    for name, v, dt in (("scale", rq.scale, torch.float32), ("y_zp", rq.y_zp, torch.int32)):
        v = v.to(device=dev, dtype=dt)
        if conv:
            if v.dim() > 1:
                raise ValueError(f"{name}: 0-d or per output channel, got {tuple(v.shape)}")
            full = v.reshape(-1) if v.dim() else v.reshape(1)
            full = full.expand(grid_mn[1]) if full.numel() == 1 else full
            if full.numel() != grid_mn[1]:
                raise ValueError(f"{name}: {full.numel()} values for {grid_mn[1]} channels")
            sm, sn = 0, full.stride(0)
        else:
            full = torch.broadcast_to(v.contiguous(), grid_mn)
            sm, sn = full.stride()
        keep.append(full)
        setattr(args, "scale_vec" if name == "scale" else "y_zp_vec", full.data_ptr())
        if name == "scale":
            args.scale_sm, args.scale_sn = sm, sn
        else:
            args.yzp_sm, args.yzp_sn = sm, sn
    if rq.bias is not None:
        bias = _vec(args, "bias", rq.bias, keep, torch.int32, dev, grid_mn[1])
        if bias.dim() == 0:
            bias = bias.expand(grid_mn[1]).contiguous()
            keep.append(bias)
        args.bias = bias.data_ptr()
    return qdtype


def qmatmul(a: torch.Tensor, b: torch.Tensor, a_zp: Optional[torch.Tensor] = None,
            b_zp: Optional[torch.Tensor] = None, rq: Optional[Requant] = None) -> torch.Tensor:
    """``sum_k (a - a_zp)(b - b_zp)`` over the last axis of ``a`` and the
    second to last of ``b`` (numpy's matmul broadcasting), int32; with ``rq``
    the QLinearMatMul epilogue. Kernel Q on a CUDA tensor, the plain version
    on a CPU tensor."""
    if a.device.type == "cpu":
        return qmatmul_plain(a, b, a_zp, b_zp, rq)
    _check_q(a, "A")
    _check_q(b, "B")
    dev = a.device
    if b.device != dev:
        raise ValueError(f"A on {dev}, B on {b.device}")
    a2, b2 = (a[None] if a.dim() == 1 else a), (b[:, None] if b.dim() == 1 else b)
    M, K = a2.shape[-2:]
    N = b2.shape[-1]
    if b2.shape[-2] != K:
        raise ValueError(f"MatMulInteger: A {tuple(a.shape)} and B {tuple(b.shape)} do not "
                         f"contract")
    batch = torch.broadcast_shapes(a2.shape[:-2], b2.shape[:-2])
    nb = 1
    for s in batch:
        nb *= int(s)
    # anything per row of A keeps A's batch apart from its rows
    per_row = (a_zp is not None and a_zp.dim() == 1) or (rq is not None and any(
        t.dim() >= 2 and t.shape[-2] > 1 for t in (rq.scale, rq.y_zp)))
    if b2.dim() == 2 and not per_row and a2.dim() > 2:
        # one GEMM over the flattened leading rows of A
        a3 = a2.reshape(1, -1, K).contiguous()
        M, nb = a3.shape[1], 1
        b3 = b2.contiguous()[None]
        b_batch = 0
    else:
        a3 = a2.expand(tuple(batch) + (M, K)).reshape(nb, M, K).contiguous()
        b3 = b2.contiguous() if b2.dim() == 2 else \
            b2.expand(tuple(batch) + (K, N)).reshape(nb, K, N).contiguous()
        b_batch = 0 if b3.dim() == 2 else K * N
        b3 = b3 if b3.dim() == 3 else b3[None]
    keep: list = []
    args = _QArgs()
    args.a, args.b = a3.data_ptr(), b3.data_ptr()
    args.a_batch, args.b_batch, args.out_batch = M * K, b_batch, M * N
    args.lda, args.ldb_k, args.ldb_n = K, N, 1
    args.M, args.N, args.K, args.batch = M, N, K, nb
    args.a_signed, args.b_signed = int(a.dtype == torch.int8), int(b.dtype == torch.int8)
    v = _vec(args, "a_zp", a_zp, keep, torch.int32, dev, a2.shape[-2])
    if v is not None:
        args.a_zp_vec, args.a_zp_sm = v.data_ptr(), 1 if v.dim() else 0
    v = _vec(args, "b_zp", b_zp, keep, torch.int32, dev, N)
    if v is not None:
        args.b_zp_vec, args.b_zp_sn = v.data_ptr(), 1 if v.dim() else 0
    odtype = _set_epilogue(args, rq, keep, dev, (M, N), conv=False)
    out = torch.empty((nb, M, N), dtype=odtype, device=dev)
    args.out = out.data_ptr()
    _launch(QMATMUL_KERNEL, args, dev)
    out = out.reshape(tuple(batch) + (a2.shape[-2], N)) if nb > 1 or a2.dim() > 2 \
        else out.reshape(a2.shape[-2], N)
    if a.dim() == 1:
        out = out.squeeze(-2)
    if b.dim() == 1:
        out = out.squeeze(-1)
    return out


def qconv(x: torch.Tensor, w: torch.Tensor, x_zp: Optional[torch.Tensor] = None,
          w_zp: Optional[torch.Tensor] = None, strides: Sequence[int] = (1, 1),
          pads: Sequence[Tuple[int, int]] = ((0, 0), (0, 0)),
          dilations: Sequence[int] = (1, 1), groups: int = 1,
          rq: Optional[Requant] = None) -> torch.Tensor:
    """Convolution (NCHW x OIHW, ``pads`` as (begin, end) a spatial axis) of
    the zero-centred operands, int32; a padded tap counts as ``x_zp`` (real
    zero); ``w_zp`` 0-d or per output channel; with ``rq`` the QLinearConv
    epilogue. Kernel Q on a CUDA tensor (1-D and 2-D), the plain version on
    a CPU tensor."""
    if x.device.type == "cpu":
        return qconv_plain(x, w, x_zp, w_zp, strides, pads, dilations, groups, rq)
    _check_q(x, "x")
    _check_q(w, "w")
    dev = x.device
    rank = x.dim() - 2
    if rank == 1:
        out = qconv(x[:, :, None], w[:, :, None], x_zp, w_zp, (1, strides[0]),
                    ((0, 0), tuple(pads[0])), (1, dilations[0]), groups, rq)
        return out[:, :, 0]
    if rank != 2:
        raise NotImplementedError(f"kernel Q convolves 1-D and 2-D images, not {rank}-D")
    if x_zp is not None and x_zp.numel() != 1:
        raise ValueError("ConvInteger: x_zero_point must be a scalar")
    n_img, C, H, W = x.shape
    cout, cin_g, KH, KW = w.shape
    if C != cin_g * groups or cout % groups:
        raise ValueError(f"conv: x {tuple(x.shape)}, w {tuple(w.shape)}, groups {groups}")
    OH = _conv_out_size(H, KH, strides[0], dilations[0], pads[0])
    OW = _conv_out_size(W, KW, strides[1], dilations[1], pads[1])
    xc, wc = x.contiguous(), w.contiguous()
    keep: list = []
    args = _QArgs()
    args.a, args.b = xc.data_ptr(), wc.data_ptr()
    args.M, args.N, args.K, args.batch = n_img * OH * OW, cout // groups, cin_g * KH * KW, 1
    args.a_signed, args.b_signed = int(x.dtype == torch.int8), int(w.dtype == torch.int8)
    v = _vec(args, "x_zp", None if x_zp is None else x_zp.reshape(()), keep, torch.int32, dev)
    if v is not None:
        args.a_zp_vec = v.data_ptr()
    v = _vec(args, "w_zp", w_zp, keep, torch.int32, dev, cout)
    if v is not None:
        args.b_zp_vec, args.b_zp_sn = v.data_ptr(), 1 if v.dim() else 0
    (args.n_img, args.C, args.H, args.W, args.KH, args.KW, args.OH, args.OW) = \
        (n_img, C, H, W, KH, KW, OH, OW)
    args.sh, args.sw = int(strides[0]), int(strides[1])
    args.ph, args.pw = int(pads[0][0]), int(pads[1][0])
    args.dh, args.dw = int(dilations[0]), int(dilations[1])
    args.groups, args.cin_g, args.cout_g = groups, cin_g, cout // groups
    odtype = _set_epilogue(args, rq, keep, dev, (1, cout), conv=True)
    out = torch.empty((n_img, cout, OH, OW), dtype=odtype, device=dev)
    args.out = out.data_ptr()
    _launch(QCONV_KERNEL, args, dev)
    return out
