"""Integer matmul and convolution of the quantized ONNX ops: hand kernel Q.

``MatMulInteger``, ``QLinearMatMul``, ``ConvInteger`` and ``QLinearConv``
(``ops.py``) contract zero-centred 8-bit operands into int32 sums, and the
QLinear ops requantize them. :func:`qmatmul` and :func:`qconv` are those
contractions: on a CUDA tensor they launch kernel Q (``csrc/qgemm.cu``:
``smt_qmatmul`` / ``smt_qconv``, raw uint8 / int8 operands on the tensor
cores through wgmma, the zero points and the requantizing epilogue applied
in the kernel), on a CPU tensor their plain versions :func:`qmatmul_plain` /
:func:`qconv_plain` (the reference's arithmetic: widen to int32, subtract the
zero points, ``torch.matmul`` / ``F.conv2d`` in int32, then the same
epilogue in the same op order). Both give the reference's int32 sums modulo
2^32, exactly.

Zero points, scales and biases are tensors on the operands' device (0-d for a
scalar, 1-D along the spec's axis), so nothing is read back to the host.

8-bit wgmma takes both operands K-major, so the kernel reads B *packed*
(:class:`QPacked`): a matmul's B transposed to (N, K), a conv's weight
reordered to (Cout, KH, KW, cin_p), rows zero-padded to a multiple of 16
bytes, with B's sums along k (the zero-point identity's ``sum b``).
:func:`pack_matmul_b` / :func:`pack_conv_w` make it; the ONNX executor packs
each weight initializer once and keeps it beside the upload
(``ops.ConstStore.packed``), and passes it as ``packed=``; a B computed in
the graph is packed on every call. A conv's x is written channels-last once
a call (:func:`channels_last`: the source's ``smt_qchannels_last``, counted
by :data:`QCL_KERNEL`), which the kernel gathers its im2col tiles from.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..kernels.build import CudaKernel

__all__ = ["Requant", "QPacked", "qmatmul", "qconv", "qmatmul_plain", "qconv_plain",
           "pack_matmul_b", "pack_conv_w", "channels_last", "channels_last_plain",
           "QMATMUL_KERNEL", "QCONV_KERNEL", "QCL_KERNEL"]

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


class QPacked(NamedTuple):
    """B as kernel Q reads it: ``bt`` (rows, ldb) of B's dtype, a row's k
    contiguous and zero from ``k`` on (``ldb`` a multiple of 16); ``colsum``
    int32, B's sum along k a row (None when not asked for); ``k`` the
    contraction's length (a conv's KH x KW x ``cin_p``); ``cin_p`` a conv's
    channels a group padded to a multiple of 4 (0 for a matmul)."""

    bt: torch.Tensor
    colsum: Optional[torch.Tensor]
    k: int
    cin_p: int = 0


class _QArgs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("a", "bt", "out", "b_colsum", "a_zp_vec", "b_zp_vec", "bias", "scale_vec",
                 "y_zp_vec")] + \
               [(name, ctypes.c_longlong) for name in
                ("out_batch", "a_zp_sm", "b_zp_sn", "scale_sm", "scale_sn", "yzp_sm",
                 "yzp_sn")] + \
               [("scale", ctypes.c_float)] + \
               [(name, ctypes.c_int) for name in
                ("M", "N", "K", "batch", "lda", "ldb", "b_batched", "a_signed", "b_signed",
                 "out_mode", "a_zp", "b_zp", "y_zp", "row_sums", "n_img", "H", "W", "KH", "KW",
                 "OH", "OW", "sh", "sw", "ph", "pw", "dh", "dw", "groups", "cin_p", "cout_g",
                 "device")]


QMATMUL_KERNEL = CudaKernel(
    name="onnx_qmatmul", source="qgemm", symbol="smt_qmatmul",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p],
    replaces="synapseml_tpu/onnx/ops.py:795 (MatMulInteger; QLinearMatMul :860-861)")
QCONV_KERNEL = CudaKernel(
    name="onnx_qconv", source="qgemm", symbol="smt_qconv",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p],
    replaces="synapseml_tpu/onnx/ops.py:814 (ConvInteger :814-818; QLinearConv :834)")
# the conv entry's channels-last copy of x (the layout the im2col gather reads)
QCL_KERNEL = CudaKernel(
    name="onnx_qconv_channels_last", source="qgemm", symbol="smt_qchannels_last",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_void_p],
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
    return acc if rq is None else _requant_conv(acc, rq)


def _requant_conv(acc: torch.Tensor, rq: Requant) -> torch.Tensor:
    """The QLinearConv epilogue over a conv's int32 sums, per output channel
    along dim 1 (the plain version's, op for op)."""
    chan = lambda s: s.reshape((1, -1) + (1,) * (acc.dim() - 2)) if s.dim() == 1 else s
    return _requant_plain(acc, Requant(chan(rq.scale), chan(rq.y_zp),
                                       None if rq.bias is None else chan(rq.bias)),
                          rq.y_zp.dtype)


# -- packing ----------------------------------------------------------------------------------

def _round16(k: int) -> int:
    return max(16, (k + 15) // 16 * 16)


def pack_matmul_b(b: torch.Tensor, colsum: bool = True) -> QPacked:
    """B (..., K, N) packed for kernel Q: (batches, N, ldb), each row B's
    column n along k, zero past K; ``colsum`` (batches, N) int32 when asked.
    One pass over B (a transpose), on B's device."""
    b3 = b.reshape(-1, *b.shape[-2:])
    K, N = b3.shape[-2:]
    bt = torch.zeros((b3.shape[0], N, _round16(K)), dtype=b.dtype, device=b.device)
    bt[..., :K] = b3.transpose(-1, -2)
    cs = b3.sum(dim=-2, dtype=torch.int32) if colsum else None
    return QPacked(bt, cs, int(K))


def pack_conv_w(w: torch.Tensor):
    """A conv weight (Cout, cin_g, KH, KW) (1-D: (Cout, cin_g, KW)) packed for
    kernel Q: (Cout, ldb), each row the output channel's taps in (kh, kw, c)
    order, channels padded to ``cin_p`` (a multiple of 4) with zeros, zero
    past K = KH x KW x cin_p; ``colsum`` (Cout,) int32. A 3-D weight (Cout,
    cin_g, KD, KH, KW) gives a tuple, one packed 2-D weight a depth tap."""
    if w.dim() == 5:
        return tuple(pack_conv_w(w[:, :, kd]) for kd in range(w.shape[2]))
    w4 = w[:, :, None] if w.dim() == 3 else w
    cout, cin_g, KH, KW = w4.shape
    cin_p = (cin_g + 3) // 4 * 4
    K = KH * KW * cin_p
    taps = torch.zeros((cout, KH, KW, cin_p), dtype=w.dtype, device=w.device)
    taps[..., :cin_g] = w4.permute(0, 2, 3, 1)
    bt = torch.zeros((cout, _round16(K)), dtype=w.dtype, device=w.device)
    bt[:, :K] = taps.reshape(cout, K)
    return QPacked(bt, w4.sum(dim=(1, 2, 3), dtype=torch.int32), K, cin_p)


def channels_last_plain(x: torch.Tensor, groups: int, cin_p: int,
                        x_zp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of :func:`channels_last` (torch ops)."""
    n, C, H, W = x.shape
    cin_g = C // groups
    xv = x.reshape(n, groups, cin_g, H, W).permute(0, 1, 3, 4, 2)
    if cin_p == cin_g:
        return xv.contiguous()
    out = torch.empty((n, groups, H, W, cin_p), dtype=x.dtype, device=x.device)
    out[..., :cin_g] = xv
    if x_zp is None:
        out[..., cin_g:] = 0
    else:
        out[..., cin_g:] = x_zp.reshape(()).to(x.dtype)
    return out


def channels_last(x: torch.Tensor, groups: int, cin_p: int,
                  x_zp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (images, C, H, W) as (images, groups, H, W, cin_p): each group's
    channels innermost, padded from C / groups to ``cin_p`` with ``x_zp``'s
    raw value (real zero; 0 without a zero point), so a padded channel adds
    (x_zp - x_zp) (w - w_zp) = 0 to every sum. Kernel Q's channels-last
    entry on a CUDA tensor, :func:`channels_last_plain` on a CPU tensor."""
    if x.device.type == "cpu":
        return channels_last_plain(x, groups, cin_p, x_zp)
    _check_q(x, "x")
    n, C, H, W = x.shape
    if C % groups or cin_p % 4 or cin_p < C // groups:
        raise ValueError(f"channels_last: C {C}, groups {groups}, cin_p {cin_p}")
    xc = x.contiguous()
    zp = None if x_zp is None else x_zp.reshape(()).to(device=x.device, dtype=torch.int32)
    out = torch.empty((n, groups, H, W, cin_p), dtype=x.dtype, device=x.device)
    dev = x.device
    QCL_KERNEL(xc.data_ptr(), out.data_ptr(), None if zp is None else zp.data_ptr(), 0, n,
               groups, C // groups, cin_p, H * W,
               dev.index if dev.index is not None else torch.cuda.current_device(),
               torch.cuda.current_stream(dev).cuda_stream)
    return out


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


def _aligned16(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def qmatmul(a: torch.Tensor, b: torch.Tensor, a_zp: Optional[torch.Tensor] = None,
            b_zp: Optional[torch.Tensor] = None, rq: Optional[Requant] = None,
            packed: Optional[QPacked] = None) -> torch.Tensor:
    """``sum_k (a - a_zp)(b - b_zp)`` over the last axis of ``a`` and the
    second to last of ``b`` (numpy's matmul broadcasting), int32; with ``rq``
    the QLinearMatMul epilogue. Kernel Q on a CUDA tensor, the plain version
    on a CPU tensor (which ignores ``packed``). ``packed``: a 2-D ``b``
    packed once (:func:`pack_matmul_b`, with ``colsum``); without it B is
    packed here, a pass over B a call."""
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
    else:
        a3 = a2.expand(tuple(batch) + (M, K)).reshape(nb, M, K).contiguous()
    b_batched = b2.dim() > 2
    if packed is not None:
        if b_batched or tuple(packed.bt.shape[1:2]) != (N,) or packed.k != K or \
                packed.bt.shape[0] != 1 or packed.bt.dtype != b.dtype:
            raise ValueError(f"packed B {tuple(packed.bt.shape)} (K {packed.k}) does not "
                             f"match B {tuple(b.shape)}")
        if a_zp is not None and packed.colsum is None:
            raise ValueError("A has a zero point: the packed B needs its column sums")
    else:
        bsrc = b2.expand(tuple(batch) + (K, N)).reshape(nb, K, N) if b_batched else b2
        packed = pack_matmul_b(bsrc, colsum=a_zp is not None)
    lda = _round16(K)
    if lda != K or not _aligned16(a3):
        ap = torch.zeros((nb, M, lda), dtype=a3.dtype, device=dev)
        ap[..., :K] = a3
        a3 = ap
    keep: list = [a3, packed]
    args = _QArgs()
    args.a, args.bt, args.out_batch = a3.data_ptr(), packed.bt.data_ptr(), M * N
    if a_zp is not None:
        args.b_colsum = packed.colsum.data_ptr()
    args.M, args.N, args.K, args.batch = M, N, K, nb
    args.lda, args.ldb, args.b_batched = lda, packed.bt.shape[-1], int(b_batched)
    args.a_signed, args.b_signed = int(a.dtype == torch.int8), int(b.dtype == torch.int8)
    v = _vec(args, "a_zp", a_zp, keep, torch.int32, dev, a2.shape[-2])
    if v is not None:
        args.a_zp_vec, args.a_zp_sm = v.data_ptr(), 1 if v.dim() else 0
    v = _vec(args, "b_zp", b_zp, keep, torch.int32, dev, N)
    if v is not None:
        args.b_zp_vec, args.b_zp_sn = v.data_ptr(), 1 if v.dim() else 0
        args.row_sums = 1
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
          rq: Optional[Requant] = None, packed: Optional[QPacked] = None) -> torch.Tensor:
    """Convolution (NCHW x OIHW, ``pads`` as (begin, end) a spatial axis) of
    the zero-centred operands, int32; a padded tap counts as ``x_zp`` (real
    zero); ``w_zp`` 0-d or per output channel; with ``rq`` the QLinearConv
    epilogue. Kernel Q on a CUDA tensor (1-, 2- and 3-D), the plain version on
    a CPU tensor (which ignores ``packed``). ``packed``: ``w`` packed once
    (:func:`pack_conv_w`); without it w is packed here, a pass a call."""
    if x.device.type == "cpu":
        return qconv_plain(x, w, x_zp, w_zp, strides, pads, dilations, groups, rq)
    _check_q(x, "x")
    _check_q(w, "w")
    dev = x.device
    rank = x.dim() - 2
    if rank == 1:
        out = qconv(x[:, :, None], w[:, :, None], x_zp, w_zp, (1, strides[0]),
                    ((0, 0), tuple(pads[0])), (1, dilations[0]), groups, rq, packed)
        return out[:, :, 0]
    if rank == 3:
        return _qconv3d(x, w, x_zp, w_zp, strides, pads, dilations, groups, rq, packed)
    if rank != 2:
        raise NotImplementedError(f"kernel Q convolves 1-, 2- and 3-D images, not {rank}-D")
    if x_zp is not None and x_zp.numel() != 1:
        raise ValueError("ConvInteger: x_zero_point must be a scalar")
    n_img, C, H, W = x.shape
    cout, cin_g, KH, KW = w.shape
    if C != cin_g * groups or cout % groups:
        raise ValueError(f"conv: x {tuple(x.shape)}, w {tuple(w.shape)}, groups {groups}")
    if packed is None:
        packed = pack_conv_w(w)
    elif packed.bt.shape[0] != cout or packed.k != KH * KW * packed.cin_p or \
            packed.cin_p < cin_g or packed.bt.dtype != w.dtype:
        raise ValueError(f"packed w {tuple(packed.bt.shape)} (K {packed.k}) does not match "
                         f"w {tuple(w.shape)}")
    OH = _conv_out_size(H, KH, strides[0], dilations[0], pads[0])
    OW = _conv_out_size(W, KW, strides[1], dilations[1], pads[1])
    xcl = channels_last(x, groups, packed.cin_p, x_zp)   # kernel Q's channels-last entry
    keep: list = [xcl, packed]
    args = _QArgs()
    args.a, args.bt = xcl.data_ptr(), packed.bt.data_ptr()
    if x_zp is not None:
        args.b_colsum = packed.colsum.data_ptr()
    args.M, args.N, args.K, args.batch = n_img * OH * OW, cout // groups, packed.k, 1
    args.ldb = packed.bt.shape[-1]
    args.a_signed, args.b_signed = int(x.dtype == torch.int8), int(w.dtype == torch.int8)
    v = _vec(args, "x_zp", None if x_zp is None else x_zp.reshape(()), keep, torch.int32, dev)
    if v is not None:
        args.a_zp_vec = v.data_ptr()
    v = _vec(args, "w_zp", w_zp, keep, torch.int32, dev, cout)
    if v is not None:
        args.b_zp_vec, args.b_zp_sn = v.data_ptr(), 1 if v.dim() else 0
        args.row_sums = 1
    (args.n_img, args.H, args.W, args.KH, args.KW, args.OH, args.OW) = \
        (n_img, H, W, KH, KW, OH, OW)
    args.sh, args.sw = int(strides[0]), int(strides[1])
    args.ph, args.pw = int(pads[0][0]), int(pads[1][0])
    args.dh, args.dw = int(dilations[0]), int(dilations[1])
    args.groups, args.cin_p, args.cout_g = groups, packed.cin_p, cout // groups
    odtype = _set_epilogue(args, rq, keep, dev, (1, cout), conv=True)
    out = torch.empty((n_img, cout, OH, OW), dtype=odtype, device=dev)
    args.out = out.data_ptr()
    _launch(QCONV_KERNEL, args, dev)
    return out


def _qconv3d(x, w, x_zp, w_zp, strides, pads, dilations, groups, rq, packed):
    """A 3-D conv as kernel Q's 2-D conv, one launch a depth tap ``kd``: the
    depth axis padded with ``x_zp``'s raw value (real zero, as the plain
    version's centred zeros), the tap's strided depth slice of x with the
    output depth folded into the images, ``w[:, :, kd]``; the int32 sums
    added over the taps, requantized after the last. Bit-equal to
    :func:`qconv_plain` (the same int32 sums, modulo 2^32)."""
    n_img, C, D, H, W = x.shape
    cout, KD = w.shape[0], w.shape[2]
    sd, dd, (lo, hi) = int(strides[0]), int(dilations[0]), pads[0]
    OD = _conv_out_size(D, KD, sd, dd, pads[0])
    if lo or hi:
        fill = (torch.zeros((), dtype=x.dtype, device=x.device) if x_zp is None
                else x_zp.reshape(()).to(device=x.device, dtype=x.dtype))
        x = torch.cat([fill.expand(n_img, C, lo, H, W), x, fill.expand(n_img, C, hi, H, W)], 2)
    if packed is None:
        packed = pack_conv_w(w)
    acc = None
    for kd in range(KD):
        start = kd * dd
        xs = x[:, :, start:start + (OD - 1) * sd + 1:sd]          # (n, C, OD, H, W)
        xs = xs.permute(0, 2, 1, 3, 4).reshape(n_img * OD, C, H, W)
        part = qconv(xs, w[:, :, kd], x_zp, w_zp, strides[1:], pads[1:], dilations[1:],
                     groups, None, packed[kd])
        acc = part if acc is None else acc.add_(part)
    acc = acc.reshape(n_img, OD, cout, *acc.shape[2:]).permute(0, 2, 1, 3, 4).contiguous()
    return acc if rq is None else _requant_conv(acc, rq)
