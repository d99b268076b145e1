"""The ONNX LSTM and GRU recurrence: hand kernel R.

``ops.py``'s ``LSTM`` and ``GRU`` (port of ``synapseml_tpu/onnx/ops.py::_lstm``
/ ``_gru``) project the whole sequence at once (``gx = x W^T + b``, a
``torch.matmul``, outside the recurrence as in the reference) and hand the
time steps to :func:`lstm_steps` / :func:`gru_steps`: kernel R
(``csrc/rnn_step.cu``) on a CUDA tensor, the plain version
(:func:`lstm_steps_plain` / :func:`gru_steps_plain`: the reference's step in
torch ops, in a Python loop) on a CPU tensor. Both take every operand in one
dtype, f32 or bf16, and round where the reference's ops round.

Kernel R has two entries, picked by :func:`rnn_plan` from the shape before
the launch: ``smt_rnn_persistent`` (:data:`RNN_KERNEL`), one cooperative
launch for all S steps with each block's rows of R resident in shared
memory and a grid barrier a step, wherever the plan places R; else
``smt_rnn_steps`` (:data:`RNN_STEP_KERNEL`), one launch a step from one C
call. Each counts its own launches (one a wrapper call).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..kernels.build import CudaKernel, library

__all__ = ["ACTIVATIONS", "RNN_KERNEL", "RNN_STEP_KERNEL", "rnn_plan", "lstm_steps",
           "gru_steps", "lstm_steps_plain", "gru_steps_plain"]

# the activations the reference takes (ops.py:_rnn_act), by kernel R's code
ACTIVATIONS = {"Sigmoid": 0, "Tanh": 1, "Relu": 2}
_TORCH_ACT = {0: torch.sigmoid, 1: torch.tanh, 2: torch.relu}

RNN_KERNEL = CudaKernel(
    name="onnx_rnn_steps", source="rnn_step", symbol="smt_rnn_persistent",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p],
    replaces="synapseml_tpu/onnx/ops.py:1140 (LSTM lax.scan step :1131-1140; GRU :1156-1166)")
# the one-launch-a-step entry, for shapes whose R the persistent entry cannot hold
RNN_STEP_KERNEL = CudaKernel(
    name="onnx_rnn_stepwise", source="rnn_step", symbol="smt_rnn_steps",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p],
    replaces="synapseml_tpu/onnx/ops.py:1140 (LSTM lax.scan step :1131-1140; GRU :1156-1166)")

# the persistent entry's constants (csrc/rnn_step.cu: kPB, kPRows, kPartLd,
# kHBufs)
P_BATCH_ROWS, P_ROWS, P_PART_LD, P_H_BUFS = 64, 32, 36, 3


class _RArgs(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in
                ("gx", "r", "h0", "p", "rb", "y", "c", "z", "rh")] + \
               [("clip", ctypes.c_float)] + \
               [(name, ctypes.c_int) for name in
                ("has_clip", "S", "B", "H", "kind", "lbr", "bf16", "act_f", "act_g", "act_h",
                 "device", "units")]


def _p_bytes(kind: int, lbr: int, bf16: bool, B: int, H: int, J: int) -> int:
    """The persistent entry's shared memory a block (csrc/rnn_step.cu's
    p_layout): R's G J rows and a zero row, at a row stride 4 words past a
    multiple of 32; the larger of the 8 warps' partial sums and three h tiles;
    the per-unit state."""
    kt, ldh, esz = (256, 264, 2) if bf16 else (64, 68, 4)
    hp = -(-H // kt) * kt
    ldr = hp + ((8 - hp) % 64 if bf16 else (4 - hp) % 32)
    G = 4 if kind == 0 else 3
    r_bytes = -(-(G * J + 1) * ldr * esz // 16) * 16
    work = max(8 * P_BATCH_ROWS * P_PART_LD * 4, P_H_BUFS * P_BATCH_ROWS * ldh * esz)
    return r_bytes + work + B * J * 4 * (2 if kind == 1 and not lbr else 1)


def rnn_plan(kind: int, lbr: int, bf16: bool, B: int, H: int, sms: int,
             smem: int) -> Optional[int]:
    """Hidden units a block (J) of the persistent entry on a card of ``sms``
    SMs and ``smem`` bytes of shared memory a block, or None where it cannot
    run: H not a multiple of 8 (16-byte h rows), a block's rows of one
    product past 32 (J = ceil(H / sms) units, all G gates; GRU with
    linear_before_reset=0 multiplies z, r and h apart), or its shared memory
    past ``smem``."""
    if H % 8 or H < 1:
        return None
    J = -(-H // sms)
    rows = (4 if kind == 0 else 3) * J if kind == 0 or lbr else 2 * J
    if rows > P_ROWS or _p_bytes(kind, lbr, bf16, B, H, J) > smem:
        return None
    return J


_LIMITS: dict = {}


def _card_limits(dev: torch.device) -> Tuple[int, int]:
    """(SMs, shared memory a block may opt in to) of ``dev``, asked once."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    got = _LIMITS.get(idx)
    if got is None:
        fn = library(RNN_KERNEL.source).smt_rnn_limits
        fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out = (ctypes.c_int * 2)()
        err = fn(idx, out)
        if err:
            raise RuntimeError(f"smt_rnn_limits: CUDA error {err}")
        got = _LIMITS[idx] = (int(out[0]), int(out[1]))
    return got


def _act_codes(acts: Sequence[str], n: int) -> Tuple[int, ...]:
    try:
        return tuple(ACTIVATIONS[a] for a in acts[:n])
    except KeyError as e:
        raise NotImplementedError(f"RNN activation {e.args[0]!r}") from None


def _squash(clip: Optional[float]):
    return (lambda v: torch.clamp(v, -clip, clip)) if clip is not None else (lambda v: v)


# -- plain versions (the reference's scan step, op for op) -------------------------------------

def lstm_steps_plain(gx: torch.Tensor, r: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                     p: Optional[torch.Tensor] = None, clip: Optional[float] = None,
                     acts: Sequence[str] = ("Sigmoid", "Tanh", "Tanh")):
    """(Y (S, B, H), h_S, c_S) of the LSTM steps over ``gx`` (S, B, 4H) (gates
    i, o, f, c; biases already added), ``r`` (4H, H), peepholes ``p`` (3H)."""
    f, g, h_act = (_TORCH_ACT[c] for c in _act_codes(acts, 3))
    squash = _squash(clip)
    hidden = r.shape[-1]
    pi, po, pf = (torch.zeros(hidden, dtype=gx.dtype, device=gx.device),) * 3 if p is None \
        else torch.split(p, hidden)
    h, c, ys = h0, c0, []
    for xt in gx:
        zi, zo, zf, zc = torch.split(xt + torch.matmul(h, r.T), hidden, dim=-1)
        i = f(squash(zi + pi * c))
        ft = f(squash(zf + pf * c))
        c = ft * c + i * g(squash(zc))
        o = f(squash(zo + po * c))
        h = o * h_act(c)
        ys.append(h)
    return torch.stack(ys) if ys else gx[:, :, :hidden].clone(), h, c


def gru_steps_plain(gx: torch.Tensor, r: torch.Tensor, h0: torch.Tensor,
                    rb: Optional[torch.Tensor] = None, lbr: int = 0,
                    clip: Optional[float] = None, acts: Sequence[str] = ("Sigmoid", "Tanh")):
    """(Y (S, B, H), h_S) of the GRU steps over ``gx`` (S, B, 3H) (gates z, r,
    h; the input bias already added), ``r`` (3H, H), recurrent bias ``rb``."""
    f, g = (_TORCH_ACT[c] for c in _act_codes(acts, 2))
    squash = _squash(clip)
    hidden = r.shape[-1]
    if rb is None:
        rb = torch.zeros(3 * hidden, dtype=gx.dtype, device=gx.device)
    rz, rr, rh = torch.split(r, hidden)
    rbz, rbr, rbh = torch.split(rb, hidden)
    h, ys = h0, []
    for xt in gx:
        xz, xr, xh = torch.split(xt, hidden, dim=-1)
        z = f(squash(xz + torch.matmul(h, rz.T) + rbz))
        rg = f(squash(xr + torch.matmul(h, rr.T) + rbr))
        if lbr:
            hh = g(squash(xh + rg * (torch.matmul(h, rh.T) + rbh)))
        else:
            hh = g(squash(xh + torch.matmul(rg * h, rh.T) + rbh))
        h = (1.0 - z) * hh + z * h
        ys.append(h)
    return torch.stack(ys) if ys else gx[:, :, :hidden].clone(), h


# -- kernel R ---------------------------------------------------------------------------------

def _launch(kind: int, gx, r, h0, c=None, p=None, rb=None, lbr=0, clip=None, acts=()):
    dtype = gx.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kernel R takes float32 or bfloat16, got {dtype}")
    S, B, GH = gx.shape
    H = r.shape[-1]
    n_gates = 4 if kind == 0 else 3
    if GH != n_gates * H or tuple(r.shape) != (n_gates * H, H):
        raise ValueError(f"gx {tuple(gx.shape)} and R {tuple(r.shape)} for hidden {H}")
    dev = gx.device
    keep = []

    def ptr(t, shape):
        if t is None:
            return None
        if t.dtype != dtype or t.device != dev or tuple(t.shape) != tuple(shape):
            raise ValueError(f"kernel R operand {tuple(t.shape)} {t.dtype} on {t.device}: "
                             f"expected {tuple(shape)} {dtype} on {dev}")
        t = t.contiguous()
        keep.append(t)
        return t.data_ptr()

    y = torch.empty((S, B, H), dtype=dtype, device=dev)
    if h0.data_ptr() % 16:   # the persistent entry streams h0 in 16-byte pieces
        h0 = h0.clone()
    args = _RArgs()
    args.gx, args.r, args.h0 = ptr(gx, (S, B, GH)), ptr(r, (GH, H)), ptr(h0, (B, H))
    args.p, args.rb = ptr(p, (3 * H,)), ptr(rb, (3 * H,))
    args.y = y.data_ptr()
    if c is not None:
        args.c = ptr(c, (B, H))
    units = rnn_plan(kind, lbr, dtype == torch.bfloat16, B, H, *_card_limits(dev))
    if kind == 1 and not lbr:
        scratch = torch.empty((2, B, H), dtype=dtype, device=dev)
        keep.append(scratch)
        args.z, args.rh = scratch[0].data_ptr(), scratch[1].data_ptr()
    args.has_clip, args.clip = int(clip is not None), float(clip or 0.0)
    args.S, args.B, args.H, args.kind, args.lbr = S, B, H, kind, int(bool(lbr))
    args.bf16 = int(dtype == torch.bfloat16)
    codes = _act_codes(acts, 3 if kind == 0 else 2) + (0,)
    args.act_f, args.act_g, args.act_h = codes[:3]
    args.device = dev.index if dev.index is not None else torch.cuda.current_device()
    args.units = units or 0
    kernel = RNN_KERNEL if units else RNN_STEP_KERNEL
    kernel(ctypes.addressof(args), torch.cuda.current_stream(dev).cuda_stream)
    return y


def lstm_steps(gx, r, h0, c0, p=None, clip=None, acts=("Sigmoid", "Tanh", "Tanh")):
    """The LSTM steps: kernel R on a CUDA tensor, :func:`lstm_steps_plain` on a
    CPU tensor. Returns (Y (S, B, H), h_S, c_S)."""
    if gx.device.type == "cpu":
        return lstm_steps_plain(gx, r, h0, c0, p, clip, acts)
    c = c0.contiguous().clone()   # the kernel updates the cell state in place
    y = _launch(0, gx, r, h0, c, p, None, 0, clip, acts)
    return y, (y[-1] if len(y) else h0), c


def gru_steps(gx, r, h0, rb=None, lbr=0, clip=None, acts=("Sigmoid", "Tanh")):
    """The GRU steps: kernel R on a CUDA tensor, :func:`gru_steps_plain` on a
    CPU tensor. Returns (Y (S, B, H), h_S)."""
    if gx.device.type == "cpu":
        return gru_steps_plain(gx, r, h0, rb, lbr, clip, acts)
    y = _launch(1, gx, r, h0, None, None, rb, lbr, clip, acts)
    return y, (y[-1] if len(y) else h0)
