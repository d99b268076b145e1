"""ONNX operator implementations on PyTorch.

Port of ``synapseml_tpu/onnx/ops.py``: every op type of the reference's
``OPS`` registry, by the same name. Each entry maps an ONNX op_type to
``fn(inputs, attrs, ctx) -> output | tuple``. ``inputs`` holds torch tensors
(computed on the executor's device), numpy arrays (graph constants:
initializers, Constant nodes, and anything derived only from them or from
*shapes*), or None for omitted optional inputs. Numpy-ness is significant, as
in the reference: ops that need static values (Reshape target, Slice bounds,
``CumSum.axis``, ...) take numpy only (:func:`_static`), and the executor
folds a node whose inputs are all constants on the host. Under the bf16
policy a floating constant is a CPU ``torch.bfloat16`` tensor (numpy has no
bfloat16) that the executor registers as a constant (:class:`ConstStore`).

Type promotion follows JAX's (``jnp.result_type``), not torch's:
:func:`result_type` is the lattice JAX promotes over, so a bf16 tensor meeting
a numpy f32 constant computes in f32, and ``MatMul`` under the bf16 policy
returns f32 (the reference's ``preferred_element_type``). One departure with a
cause: the reference runs without x64, so its int64 values come back int32;
the port keeps ONNX's int64 (ArgMax, Shape, Cast(to=INT64)).

The integer contractions of the quantized ops are hand kernel Q
(``qgemm.py``), the LSTM / GRU time steps hand kernel R (``rnn.py``).
"""

from __future__ import annotations

import contextvars
import functools
import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..image.resample import resize_array
from . import qgemm, rnn
from .wire import DataType, tensor_to_numpy

__all__ = ["OPS", "ConstStore", "result_type", "is_const"]

OPS: Dict[str, Callable] = {}


def op(*names: str):
    def deco(fn):
        for n in names:
            OPS[n] = fn
        return fn

    return deco


# ---------------------------------------------------------------------------------
# constants and their device copies
# ---------------------------------------------------------------------------------

class ConstStore:
    """The graph constants one executor owns, each uploaded to a device once.

    Keyed by identity: an entry holds its value, so an id in the store always
    names the same object. The executor adds every initializer (uploaded at
    construction) and every folded value of a plan; ops reach the store
    through :func:`_t` while the executor runs them. An entry also keeps the
    forms a kernel wants its constant in (:meth:`packed`: kernel Q's packed
    weights), made once a device; ``packs`` counts them."""

    def __init__(self):
        self._entries: Dict[int, list] = {}
        self.packs = 0

    def add(self, value, device: Optional[torch.device] = None) -> None:
        e = self._entries.setdefault(id(value), [value, {}, {}])
        if device is not None and device.type != "cpu":
            self.tensor(value, device)

    def owns(self, value) -> bool:
        e = self._entries.get(id(value))
        return e is not None and e[0] is value

    def tensor(self, value, device: torch.device) -> torch.Tensor:
        e = self._entries[id(value)]
        t = e[1].get(device)
        if t is None:
            t = e[1][device] = _host_tensor(value).to(device)
        return t

    def packed(self, value, device: torch.device, kind: str, make):
        """``make(tensor)`` of the constant ``value``'s copy on ``device``, made
        the first time ``kind`` is asked for there and kept with the entry."""
        e = self._entries[id(value)]
        got = e[2].get((kind, device))
        if got is None:
            got = e[2][(kind, device)] = make(self.tensor(value, device))
            self.packs += 1
        return got

    def channels_last(self, device: torch.device) -> None:
        """Keep the 4-D floating constants' copies on ``device`` in torch's
        channels-last memory format (convolution weights, for the opt-in
        channels-last run)."""
        for value, copies, _ in self._entries.values():
            t = copies.get(device)
            if t is not None and t.dim() == 4 and t.dtype.is_floating_point:
                copies[device] = t.contiguous(memory_format=torch.channels_last)


_STORE: contextvars.ContextVar[Optional[ConstStore]] = contextvars.ContextVar(
    "onnx_const_store", default=None)


def is_const(v) -> bool:
    """A graph constant: numpy, a Python / numpy scalar, or a tensor the
    running executor registered as one (a bf16 constant)."""
    if isinstance(v, np.ndarray) or np.isscalar(v):
        return True
    store = _STORE.get()
    return isinstance(v, torch.Tensor) and store is not None and store.owns(v)


def _host_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    arr = np.asarray(v)
    if not arr.flags.c_contiguous or not arr.flags.writeable:
        arr = arr.copy()
    return torch.from_numpy(arr)


def _t(v, device: Optional[torch.device] = None) -> torch.Tensor:
    """``v`` as a tensor on ``device`` (None: where it is, numpy on the CPU);
    a registered constant's device copy is the one uploaded once."""
    if v is None:
        return None
    if isinstance(v, torch.Tensor) and (device is None or v.device == device):
        return v
    if device is None or device.type == "cpu":
        return _host_tensor(v).to(device) if device is not None else _host_tensor(v)
    store = _STORE.get()
    if store is not None and store.owns(v):
        return store.tensor(v, device)
    return _host_tensor(v).to(device)


def _dev(*vals) -> Optional[torch.device]:
    """The device an op on ``vals`` runs on: a non-CPU tensor's, else the CPU."""
    for v in vals:
        if isinstance(v, torch.Tensor) and v.device.type != "cpu":
            return v.device
    return None


# ---------------------------------------------------------------------------------
# type promotion (JAX's lattice)
# ---------------------------------------------------------------------------------

_NODE_OF = {torch.bool: "b1", torch.uint8: "u1", torch.uint16: "u2", torch.uint32: "u4",
            torch.uint64: "u8", torch.int8: "i1", torch.int16: "i2", torch.int32: "i4",
            torch.int64: "i8", torch.bfloat16: "bf", torch.float16: "f2",
            torch.float32: "f4", torch.float64: "f8"}
_DTYPE_OF = {n: d for d, n in _NODE_OF.items()}
_PARENTS = {"b1": ("i*",), "i*": ("u1", "i1"), "u1": ("i2", "u2"), "u2": ("i4", "u4"),
            "u4": ("i4", "u8"), "u8": ("f*",), "i1": ("i2",), "i2": ("i4",), "i4": ("i8",),
            "i8": ("f*",), "f*": ("bf", "f2"), "bf": ("f4",), "f2": ("f4",), "f4": ("f8",),
            "f8": ()}


def _upper(node: str) -> frozenset:
    out, todo = {node}, [node]
    while todo:
        for p in _PARENTS[todo.pop()]:
            if p not in out:
                out.add(p)
                todo.append(p)
    return frozenset(out)


_UPPER = {n: _upper(n) for n in _PARENTS}


def _node(v) -> str:
    if isinstance(v, torch.Tensor):
        return _NODE_OF[v.dtype]
    if isinstance(v, torch.dtype):
        return _NODE_OF[v]
    if isinstance(v, bool):
        return "b1"
    if isinstance(v, int):
        return "i*"
    if isinstance(v, float):
        return "f*"
    dt = np.asarray(v).dtype if not isinstance(v, np.dtype) else v
    return _NODE_OF[torch.from_numpy(np.zeros(0, dt)).dtype]


def result_type(*vals) -> torch.dtype:
    """The dtype JAX promotes ``vals`` to (tensors, numpy arrays and scalars
    are strongly typed, Python scalars weakly), over the lattice the
    reference runs (x64 off: uint32 with a signed int stays int32), without
    its x64 truncation of the result: a weak int result is int64, a weak
    float float32, and int64 with uint64 float64 (``jnp.promote_types``)."""
    nodes = [_node(v) for v in vals if v is not None]
    if not nodes:
        raise ValueError("result_type of no values")
    common = functools.reduce(lambda a, b: a & b, (_UPPER[n] for n in nodes))
    lub = next(n for n in common if common <= _UPPER[n])
    if lub == "i*":
        return torch.int64
    if lub == "f*":
        return torch.float32 if "f*" in nodes else torch.float64
    return _DTYPE_OF[lub]


def _promote(*vals, dtype: Optional[torch.dtype] = None) -> List[Optional[torch.Tensor]]:
    """Every value as a tensor of their common (or the given) dtype, on the
    device the op runs on; Python scalars become 0-d tensors of that dtype."""
    dt = dtype or result_type(*vals)
    dev = _dev(*vals)
    out = []
    for v in vals:
        if v is None:
            out.append(None)
        elif isinstance(v, (bool, int, float)):
            out.append(torch.tensor(v, dtype=dt, device=dev))
        else:
            out.append(_t(v, dev).to(dt))
    return out


def _float(dt: torch.dtype) -> bool:
    return dt.is_floating_point


def _inexact(x: torch.Tensor) -> torch.Tensor:
    """jnp's promote to inexact: ints and bools to the default float (f32)."""
    return x if _float(x.dtype) else x.to(torch.float32)


# ---------------------------------------------------------------------------------
# static values
# ---------------------------------------------------------------------------------

def _static(v, what: str) -> np.ndarray:
    """Require a graph-constant (numpy) value; informative error otherwise."""
    if v is None:
        raise ValueError(f"{what}: missing required static input")
    if isinstance(v, np.ndarray) or np.isscalar(v):
        return np.asarray(v)
    if is_const(v):   # a bf16 constant
        return v.float().numpy()
    raise ValueError(
        f"{what} must be a graph constant (initializer / shape-derived), got a computed "
        f"tensor; this graph has genuinely data-dependent shapes, which the executor's "
        f"per-shape plan cannot fold")


def _ints(v, what: str) -> List[int]:
    return [int(x) for x in np.atleast_1d(_static(v, what))]


def _axis_list(attrs, inputs, idx, what, default=None):
    """axes from attrs (opset<13) or inputs[idx] (>=13)."""
    if attrs.get("axes") is not None:
        return [int(a) for a in attrs["axes"]]
    if len(inputs) > idx and inputs[idx] is not None:
        return _ints(inputs[idx], what)
    return default


def _shape(v) -> tuple:
    return tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v)


def _ndim(v) -> int:
    return len(_shape(v))


def _all_np(*vals) -> bool:
    return all(isinstance(v, np.ndarray) for v in vals)


# ---------------------------------------------------------------------------------
# elementwise math
# ---------------------------------------------------------------------------------

def _true_divide(a, b):
    a, b = _promote(a, b)
    if not _float(a.dtype):
        a, b = a.to(torch.float32), b.to(torch.float32)
    return torch.true_divide(a, b)


def _prelu(x, s):
    x, s = _promote(x, s)
    return torch.where(x >= 0, x, x * s)


def _binary(fn):
    return lambda a, b: fn(*_promote(a, b))


def _mod(a, b):
    """``jnp.mod``: the sign of the divisor; an integer divided by zero gives
    0 (torch's integer remainder raises on the CPU and is undefined on the
    card)."""
    a, b = _promote(a, b)
    if _float(a.dtype):
        return torch.remainder(a, b)
    zero = b == 0
    return torch.where(zero, torch.zeros_like(a), torch.remainder(a, torch.where(
        zero, torch.ones_like(b), b)))


_BINOPS = {
    "Add": _binary(torch.add), "Sub": _binary(torch.sub), "Mul": _binary(torch.mul),
    "Div": _true_divide, "Pow": _binary(torch.pow), "Mod": _mod,
    "PRelu": _prelu,
    "And": _binary(torch.logical_and), "Or": _binary(torch.logical_or),
    "Xor": _binary(torch.logical_xor),
    "BitwiseAnd": _binary(torch.bitwise_and), "BitwiseOr": _binary(torch.bitwise_or),
    "BitwiseXor": _binary(torch.bitwise_xor),
}
for _name, _fn in _BINOPS.items():
    OPS[_name] = (lambda f: lambda inputs, attrs, ctx: f(inputs[0], inputs[1]))(_fn)


def _unary(fn, inexact=False):
    def impl(x):
        x = _t(x, _dev(x))
        return fn(_inexact(x) if inexact else x)

    return impl


def _sign(x):
    """``jnp.sign``: NaN stays NaN and a zero keeps its sign."""
    if not _float(x.dtype):
        return torch.sign(x)
    return torch.where(torch.isnan(x) | (x == 0), x, torch.sign(x))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


_UNOPS = {
    "Sqrt": _unary(torch.sqrt, True), "Exp": _unary(torch.exp, True),
    "Log": _unary(torch.log, True), "Abs": _unary(torch.abs), "Neg": _unary(torch.neg),
    "Floor": _unary(torch.floor), "Ceil": _unary(torch.ceil),
    "Reciprocal": lambda x: _true_divide(1.0, x),
    "Sign": _unary(_sign), "Erf": _unary(torch.erf, True),
    "Not": _unary(torch.logical_not),
    "Relu": _unary(torch.relu), "Sigmoid": _unary(torch.sigmoid, True),
    "Tanh": _unary(torch.tanh, True), "Softplus": _unary(_softplus, True),
    "Softsign": _unary(lambda x: x / (1 + torch.abs(x)), True),
    "Identity": lambda x: x,
    "IsNaN": _unary(torch.isnan), "Sin": _unary(torch.sin, True),
    "Cos": _unary(torch.cos, True), "Tan": _unary(torch.tan, True),
    "Asin": _unary(torch.asin, True), "Acos": _unary(torch.acos, True),
    "Atan": _unary(torch.atan, True), "Sinh": _unary(torch.sinh, True),
    "Cosh": _unary(torch.cosh, True), "Asinh": _unary(torch.asinh, True),
    "Acosh": _unary(torch.acosh, True), "Atanh": _unary(torch.atanh, True),
    "BitwiseNot": _unary(torch.bitwise_not),
}
for _name, _fn in _UNOPS.items():
    OPS[_name] = (lambda f: lambda inputs, attrs, ctx: f(inputs[0]))(_fn)


@op("Round")
def _round(inputs, attrs, ctx):
    return torch.round(_t(inputs[0], _dev(inputs[0])))  # half to even, as the ONNX spec


_COMPARE = {"Equal": torch.eq, "Greater": torch.gt, "GreaterOrEqual": torch.ge,
            "Less": torch.lt, "LessOrEqual": torch.le}


@op("Equal", "Greater", "GreaterOrEqual", "Less", "LessOrEqual")
def _compare(inputs, attrs, ctx):
    return _COMPARE[ctx["op_type"]](*_promote(inputs[0], inputs[1]))


@op("Min", "Max", "Sum", "Mean")
def _variadic(inputs, attrs, ctx):
    vals = _promote(*[v for v in inputs if v is not None])
    red = {"Min": torch.minimum, "Max": torch.maximum}.get(ctx["op_type"])
    if red is not None:
        return functools.reduce(red, vals)
    s = functools.reduce(torch.add, vals)
    return _true_divide(s, len(vals)) if ctx["op_type"] == "Mean" else s


def _clip_values(x, lo, hi):
    """jnp.clip: ``minimum(maximum(x, lo), hi)`` with promotion."""
    x, lo, hi = _promote(x, lo, hi)
    if lo is not None:
        x = torch.maximum(x, lo)
    if hi is not None:
        x = torch.minimum(x, hi)
    return x


@op("Clip")
def _clip(inputs, attrs, ctx):
    lo, hi = attrs.get("min"), attrs.get("max")   # opset < 11: attributes
    if lo is None:
        lo = inputs[1] if len(inputs) > 1 else None
    if hi is None:
        hi = inputs[2] if len(inputs) > 2 else None
    return _clip_values(inputs[0], lo, hi)


@op("LeakyRelu")
def _leaky(inputs, attrs, ctx):
    x = _inexact(_t(inputs[0], _dev(inputs[0])))
    return torch.where(x >= 0, x, attrs.get("alpha", 0.01) * x)


@op("Elu")
def _elu(inputs, attrs, ctx):
    x = _inexact(_t(inputs[0], _dev(inputs[0])))
    return torch.where(x > 0, x, attrs.get("alpha", 1.0) * torch.expm1(x))


@op("Selu")
def _selu(inputs, attrs, ctx):
    a = attrs.get("alpha", 1.6732632423543772)
    g = attrs.get("gamma", 1.0507009873554805)
    x = _inexact(_t(inputs[0], _dev(inputs[0])))
    return g * torch.where(x > 0, x, a * (torch.exp(x) - 1.0))


@op("Celu")
def _celu(inputs, attrs, ctx):
    alpha = attrs.get("alpha", 1.0)
    x = _inexact(_t(inputs[0], _dev(inputs[0])))
    return torch.clamp(x, min=0.0) + alpha * torch.expm1(torch.clamp(x, max=0.0) / alpha)


@op("HardSigmoid")
def _hard_sigmoid(inputs, attrs, ctx):
    a, b = attrs.get("alpha", 0.2), attrs.get("beta", 0.5)
    x = _t(inputs[0], _dev(inputs[0]))
    return _clip_values(a * x + b, 0.0, 1.0)


@op("HardSwish")
def _hard_swish(inputs, attrs, ctx):
    x = _t(inputs[0], _dev(inputs[0]))
    return x * _clip_values(x / 6.0 + 0.5, 0.0, 1.0)


@op("Mish")
def _mish(inputs, attrs, ctx):
    x = _inexact(_t(inputs[0], _dev(inputs[0])))
    return x * torch.tanh(_softplus(x))


@op("Gelu")
def _gelu(inputs, attrs, ctx):
    x = _inexact(_t(inputs[0], _dev(inputs[0])))
    if attrs.get("approximate", "none") == "tanh":
        return F.gelu(x, approximate="tanh")
    # jax.nn.gelu's exact form, op for op: +inf -> inf, -inf -> NaN (F.gelu
    # gives NaN for +inf)
    return 0.5 * x * torch.special.erfc(-x * float(np.sqrt(0.5)))


@op("Softmax")
def _softmax(inputs, attrs, ctx):
    axis = attrs.get("axis", -1 if ctx["opset"] >= 13 else 1)
    x = _inexact(_t(inputs[0], _dev(inputs[0])))
    if ctx["opset"] >= 13:
        return torch.softmax(x, dim=axis)
    # pre-13: flatten trailing dims from axis, softmax over the flattened tail
    shape = x.shape
    axis = axis % x.dim()  # spec coerces negative axis to axis + rank
    lead = int(np.prod(shape[:axis])) if axis > 0 else 1
    return torch.softmax(x.reshape(lead, -1), dim=-1).reshape(shape)


@op("LogSoftmax")
def _log_softmax(inputs, attrs, ctx):
    axis = attrs.get("axis", -1 if ctx["opset"] >= 13 else 1)
    return torch.log_softmax(_inexact(_t(inputs[0], _dev(inputs[0]))), dim=axis)


@op("Einsum")
def _einsum(inputs, attrs, ctx):
    return torch.einsum(attrs["equation"], *_promote(*[v for v in inputs if v is not None]))


@op("CumSum")
def _cumsum(inputs, attrs, ctx):
    axis = int(_static(inputs[1], "CumSum.axis"))
    x = _t(inputs[0], _dev(inputs[0]))
    if attrs.get("reverse", 0):
        x = torch.flip(x, (axis,))
    out = torch.cumsum(x, dim=axis, dtype=x.dtype if x.dtype != torch.bool else torch.int64)
    if attrs.get("exclusive", 0):
        out = torch.roll(out, 1, axis)
        idx = [slice(None)] * out.dim()
        idx[axis] = 0
        out[tuple(idx)] = 0
    if attrs.get("reverse", 0):
        out = torch.flip(out, (axis,))
    return out


# ---------------------------------------------------------------------------------
# matmul / gemm
# ---------------------------------------------------------------------------------

def _accumulate(a, b, accum, fn):
    """``fn(a, b)`` of promoted operands; with ``accum`` (the bf16 policy's
    f32) the result in that dtype, as ``preferred_element_type`` gives it:
    f32 products of the exact operands, accumulated in f32."""
    a, b = _promote(a, b)
    if accum is not None and _float(a.dtype) and a.dtype != accum:
        a, b = a.to(accum), b.to(accum)
    return fn(a, b)


@op("MatMul")
def _matmul(inputs, attrs, ctx):
    return _accumulate(inputs[0], inputs[1], ctx.get("accum_dtype"), torch.matmul)


@op("Gemm")
def _gemm(inputs, attrs, ctx):
    a, b = inputs[0], inputs[1]
    a_dtype = result_type(a)
    ta, tb = attrs.get("transA", 0), attrs.get("transB", 0)
    out = _accumulate(a, b, ctx.get("accum_dtype"),
                      lambda x, y: torch.matmul(x.T if ta else x, y.T if tb else y))
    out = attrs.get("alpha", 1.0) * out
    if len(inputs) > 2 and inputs[2] is not None:
        c = _t(inputs[2], out.device) * attrs.get("beta", 1.0)  # beta weak: keeps c's dtype
        out = torch.add(*_promote(out, c))
    return out.to(a_dtype) if out.dtype != a_dtype else out


# ---------------------------------------------------------------------------------
# convolution / pooling
# ---------------------------------------------------------------------------------

def _resolve_pads(attrs, spatial_rank: int, x_shape, k_shape, strides, dilations):
    """ONNX pads [x1b,x2b,...,x1e,x2e,...] or auto_pad."""
    auto = attrs.get("auto_pad", "NOTSET")
    if auto in ("NOTSET", ""):
        pads = attrs.get("pads") or [0] * (2 * spatial_rank)
        return [(int(pads[i]), int(pads[i + spatial_rank])) for i in range(spatial_rank)]
    if auto == "VALID":
        return [(0, 0)] * spatial_rank
    # SAME_UPPER / SAME_LOWER
    out = []
    for i in range(spatial_rank):
        in_dim = x_shape[2 + i]
        eff_k = (k_shape[i] - 1) * dilations[i] + 1
        out_dim = -(-in_dim // strides[i])
        total = max(0, (out_dim - 1) * strides[i] + eff_k - in_dim)
        lo = total // 2 if auto == "SAME_UPPER" else (total + 1) // 2
        out.append((lo, total - lo))
    return out


def _pad_spatial(x: torch.Tensor, pads, value=0.0) -> torch.Tensor:
    """``x`` padded (or cropped, for negative pads) on its trailing spatial axes."""
    flat = [p for pair in reversed(list(pads)) for p in pair]
    return F.pad(x, flat, value=value) if any(flat) else x


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv_nd(x, w, strides, pads, dilations, groups):
    rank = x.dim() - 2
    sym = all(lo == hi for lo, hi in pads)
    if sym:
        return _CONV[rank](x, w, stride=strides, padding=[lo for lo, _ in pads],
                           dilation=dilations, groups=groups)
    return _CONV[rank](_pad_spatial(x, pads), w, stride=strides, dilation=dilations,
                       groups=groups)


@op("Conv")
def _conv(inputs, attrs, ctx):
    x, w = inputs[0], inputs[1]
    b = inputs[2] if len(inputs) > 2 else None
    x_dtype = result_type(x)
    rank = _ndim(x) - 2
    strides = [int(s) for s in attrs.get("strides", [1] * rank)]
    dilations = [int(d) for d in attrs.get("dilations", [1] * rank)]
    groups = int(attrs.get("group", 1))
    pads = _resolve_pads(attrs, rank, _shape(x), _shape(w)[2:], strides, dilations)
    xt, wt = _promote(x, w)
    out = _conv_nd(xt, wt, strides, pads, dilations, groups)
    if out.dtype != x_dtype:
        out = out.to(x_dtype)
    if b is not None:
        bt = _t(b, out.device)
        out = torch.add(*_promote(out, bt.reshape((1, -1) + (1,) * rank)))
    return out


@op("ConvTranspose")
def _conv_transpose(inputs, attrs, ctx):
    x, w = inputs[0], inputs[1]
    b = inputs[2] if len(inputs) > 2 else None
    x_dtype = result_type(x)
    rank = _ndim(x) - 2
    strides = [int(s) for s in attrs.get("strides", [1] * rank)]
    dilations = [int(d) for d in attrs.get("dilations", [1] * rank)]
    groups = int(attrs.get("group", 1))
    if groups != 1:
        raise NotImplementedError("grouped ConvTranspose not supported yet")
    kernel_spatial = _shape(w)[2:]
    pads = _resolve_pads(attrs, rank, _shape(x), kernel_spatial, strides, dilations)
    out_pads = [int(p) for p in attrs.get("output_padding", [0] * rank)]
    xt, wt = _promote(x, w)
    # the reference's form: a convolution of the input dilated by the strides
    # with the (C_in, C_out)-swapped, spatially flipped kernel
    w_t = torch.flip(wt.transpose(0, 1), dims=tuple(range(2, 2 + rank)))
    size = [(n - 1) * s + 1 for n, s in zip(xt.shape[2:], strides)]
    xd = xt.new_zeros(tuple(xt.shape[:2]) + tuple(size))
    xd[(slice(None), slice(None)) + tuple(slice(None, None, s) for s in strides)] = xt
    padding = []
    for i in range(rank):
        eff_k = (kernel_spatial[i] - 1) * dilations[i] + 1
        padding.append((eff_k - 1 - pads[i][0], eff_k - 1 - pads[i][1] + out_pads[i]))
    out = _CONV[rank](_pad_spatial(xd, padding), w_t, dilation=dilations)
    if out.dtype != x_dtype:
        out = out.to(x_dtype)
    if b is not None:
        out = torch.add(*_promote(out, _t(b, out.device).reshape((1, -1) + (1,) * rank)))
    return out


def _ceil_pads(x, kernel, strides, pads, ceil_mode):
    if not ceil_mode:
        return pads
    # extend end-padding so ceil-division windows fit
    new_pads = []
    for i in range(len(kernel)):
        in_dim = x.shape[2 + i] + pads[i][0] + pads[i][1]
        rem = (in_dim - kernel[i]) % strides[i]
        extra = (strides[i] - rem) % strides[i] if rem else 0
        new_pads.append((pads[i][0], pads[i][1] + extra))
    return new_pads


def _window_sum(x: torch.Tensor, kernel, strides) -> torch.Tensor:
    """Sums over the windows of an already padded ``x`` (reduce_window add)."""
    rank = len(kernel)
    if rank == 1:
        return _window_sum(x[..., None], list(kernel) + [1], list(strides) + [1])[..., 0]
    pool = {2: F.avg_pool2d, 3: F.avg_pool3d}[rank]
    return pool(x, tuple(kernel), tuple(strides), divisor_override=1)


@op("MaxPool")
def _maxpool(inputs, attrs, ctx):
    x = _t(inputs[0], _dev(inputs[0]))
    kernel = [int(k) for k in attrs["kernel_shape"]]
    rank = len(kernel)
    strides = [int(s) for s in attrs.get("strides", [1] * rank)]
    dil = [int(d) for d in attrs.get("dilations", [1] * rank)]
    if any(d != 1 for d in dil):
        raise NotImplementedError("dilated MaxPool not supported")
    pads = _resolve_pads(attrs, rank, x.shape, kernel, strides, [1] * rank)
    pads = _ceil_pads(x, kernel, strides, pads, attrs.get("ceil_mode", 0))
    neg = -math.inf if _float(x.dtype) else torch.iinfo(x.dtype).min
    xp = _pad_spatial(x, pads, value=neg)
    pool = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}[rank]
    return pool(xp, tuple(kernel), tuple(strides))


@op("AveragePool")
def _avgpool(inputs, attrs, ctx):
    x = _t(inputs[0], _dev(inputs[0]))
    kernel = [int(k) for k in attrs["kernel_shape"]]
    rank = len(kernel)
    strides = [int(s) for s in attrs.get("strides", [1] * rank)]
    pads = _resolve_pads(attrs, rank, x.shape, kernel, strides, [1] * rank)
    include_pad = attrs.get("count_include_pad", 0)
    eff_pads = _ceil_pads(x, kernel, strides, pads, attrs.get("ceil_mode", 0))
    out = _window_sum(_pad_spatial(x, eff_pads), kernel, strides)
    if include_pad:
        return out / float(np.prod(kernel))
    ones = torch.ones(x.shape[2:], dtype=x.dtype, device=x.device)[None, None]
    counts = _window_sum(_pad_spatial(ones, eff_pads), kernel, strides)
    return out / counts


@op("GlobalAveragePool")
def _gap(inputs, attrs, ctx):
    x = _t(inputs[0], _dev(inputs[0]))
    return _mean(x, tuple(range(2, x.dim())), keepdim=True)


@op("GlobalMaxPool")
def _gmp(inputs, attrs, ctx):
    x = _t(inputs[0], _dev(inputs[0]))
    return torch.amax(x, dim=tuple(range(2, x.dim())), keepdim=True)


@op("LRN")
def _lrn(inputs, attrs, ctx):
    x = _t(inputs[0], _dev(inputs[0]))
    size = int(attrs["size"])
    alpha, beta, bias = attrs.get("alpha", 1e-4), attrs.get("beta", 0.75), attrs.get("bias", 1.0)
    sq = x * x
    half = size // 2
    n, c = x.shape[:2]
    flat = sq.reshape(n, 1, c, -1)   # channels as a spatial axis
    flat = F.pad(flat, (0, 0, half, size - 1 - half))
    summed = _window_sum(flat, [size, 1], [1, 1]).reshape(x.shape)
    return x / torch.pow(bias + (alpha / size) * summed, beta)


# ---------------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------------

def _low(dt: torch.dtype) -> bool:
    return dt in (torch.float16, torch.bfloat16)


def _mean(x: torch.Tensor, axes, keepdim: bool) -> torch.Tensor:
    """jnp.mean: f16 / bf16 summed and divided in f32, the result cast back;
    ints to f32."""
    if _low(x.dtype):
        return torch.mean(x.float(), dim=axes, keepdim=keepdim).to(x.dtype)
    return torch.mean(_inexact(x), dim=axes, keepdim=keepdim)


def _var(x: torch.Tensor, axes, keepdim: bool) -> torch.Tensor:
    """jnp.var (ddof 0), in f32 for f16 / bf16 and cast back."""
    xf = x.float() if _low(x.dtype) else _inexact(x)
    m = torch.mean(xf, dim=axes, keepdim=True)
    d = xf - m
    out = torch.mean(d * d, dim=axes, keepdim=keepdim)
    return out.to(x.dtype) if _low(x.dtype) else out


@op("BatchNormalization")
def _batchnorm(inputs, attrs, ctx):
    x, scale, bias, mean, var = inputs[:5]
    x = _t(x, _dev(x))
    eps = attrs.get("epsilon", 1e-5)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    inv = torch.rsqrt(_t(var, x.device).to(torch.float32) + eps).to(x.dtype)
    s, b, m = (_t(v, x.device) for v in (scale, bias, mean))
    sinv = torch.mul(*_promote(s, inv))
    xm = torch.sub(*_promote(x, m.reshape(shape)))
    return torch.add(*_promote(torch.mul(*_promote(xm, sinv.reshape(shape))), b.reshape(shape)))


@op("InstanceNormalization")
def _instancenorm(inputs, attrs, ctx):
    x, scale, bias = inputs[:3]
    x = _t(x, _dev(x))
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(2, x.dim()))
    mean, var = _mean(x, axes, True), _var(x, axes, True)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    out = (x - mean) * torch.rsqrt(var + eps)
    out = torch.mul(*_promote(out, _t(scale, x.device).reshape(shape)))
    return torch.add(*_promote(out, _t(bias, x.device).reshape(shape)))


@op("LayerNormalization")
def _layernorm(inputs, attrs, ctx):
    x = _t(inputs[0], _dev(inputs[0]))
    scale = inputs[1] if len(inputs) > 1 else None
    bias = inputs[2] if len(inputs) > 2 else None
    axis = attrs.get("axis", -1)
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(axis % x.dim(), x.dim()))
    mean, var = _mean(x, axes, True), _var(x, axes, True)
    out = (x - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        out = torch.mul(*_promote(out, scale))
    if bias is not None:
        out = torch.add(*_promote(out, bias))
    return out


@op("GroupNormalization")
def _groupnorm(inputs, attrs, ctx):
    x, scale, bias = inputs[:3]
    x = _t(x, _dev(x))
    g = int(attrs["num_groups"])
    eps = attrs.get("epsilon", 1e-5)
    n, c = x.shape[:2]
    xg = x.reshape((n, g, c // g) + tuple(x.shape[2:]))
    axes = tuple(range(2, xg.dim()))
    out = ((xg - _mean(xg, axes, True)) * torch.rsqrt(_var(xg, axes, True) + eps)).reshape(x.shape)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    out = torch.mul(*_promote(out, _t(scale, x.device).reshape(shape)))
    return torch.add(*_promote(out, _t(bias, x.device).reshape(shape)))


@op("Dropout")
def _dropout(inputs, attrs, ctx):
    # inference-mode: identity (+ all-true mask as optional second output)
    x = inputs[0]
    dev = x.device if isinstance(x, torch.Tensor) else None
    return (x, torch.ones(_shape(x), dtype=torch.bool, device=dev))


# ---------------------------------------------------------------------------------
# shape / data movement  (static-shape discipline: see module docstring)
# ---------------------------------------------------------------------------------

@op("Shape")
def _shape_op(inputs, attrs, ctx):
    shp = np.asarray(_shape(inputs[0]), dtype=np.int64)
    start = attrs.get("start", 0)
    end = attrs.get("end")
    return shp[start:end]


@op("Size")
def _size(inputs, attrs, ctx):
    return np.asarray(int(np.prod(_shape(inputs[0]))), dtype=np.int64)


@op("Reshape")
def _reshape(inputs, attrs, ctx):
    if attrs.get("shape") is not None:  # opset<5 attribute form
        target = [int(s) for s in attrs["shape"]]
    else:
        target = _ints(inputs[1], "Reshape.shape")
    x = inputs[0]
    shape = _shape(x)
    if attrs.get("allowzero", 0) == 0:
        target = [shape[i] if s == 0 else s for i, s in enumerate(target)]
    return torch.reshape(_t(x, _dev(x)), target)


@op("Flatten")
def _flatten(inputs, attrs, ctx):
    x = _t(inputs[0], _dev(inputs[0]))
    axis = attrs.get("axis", 1)
    if axis < 0:
        axis += x.dim()
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    return torch.reshape(x, (lead, -1))


@op("Transpose")
def _transpose(inputs, attrs, ctx):
    perm = attrs.get("perm")
    x = _t(inputs[0], _dev(inputs[0]))
    return x.permute(*(perm if perm is not None else reversed(range(x.dim()))))


@op("Concat")
def _concat(inputs, attrs, ctx):
    vals = [v for v in inputs if v is not None]
    if _all_np(*vals):
        return np.concatenate([np.atleast_1d(v) for v in vals], axis=attrs.get("axis", 0))
    return torch.cat([torch.atleast_1d(v) for v in _promote(*vals)], dim=attrs.get("axis", 0))


@op("Split")
def _split(inputs, attrs, ctx):
    x = _t(inputs[0], _dev(inputs[0]))
    axis = attrs.get("axis", 0)
    splits = attrs.get("split")
    if splits is None and len(inputs) > 1 and inputs[1] is not None:
        splits = _ints(inputs[1], "Split.split")
    n_out = ctx["n_outputs"]
    if splits is None:
        dim = x.shape[axis]
        base = -(-dim // n_out) if attrs.get("num_outputs") else dim // n_out
        splits = [base] * (n_out - 1) + [dim - base * (n_out - 1)]
    return tuple(torch.split(x, [int(s) for s in splits], dim=axis))


def _slice_axis(x: torch.Tensor, axis: int, s, e, step: int) -> torch.Tensor:
    start, stop, step = slice(s, e, step).indices(x.shape[axis])
    if step > 0:
        idx = [slice(None)] * x.dim()
        idx[axis] = slice(start, stop, step)
        return x[tuple(idx)]
    # torch slices take no negative step: gather the positions
    pos = torch.arange(start, stop, step, device=x.device)
    return torch.index_select(x, axis, pos)


@op("Slice")
def _slice(inputs, attrs, ctx):
    x = inputs[0]
    if attrs.get("starts") is not None:  # opset<10 attribute form
        starts, ends = list(attrs["starts"]), list(attrs["ends"])
        axes = list(attrs.get("axes", range(len(starts))))
        steps = [1] * len(starts)
    else:
        starts = _ints(inputs[1], "Slice.starts")
        ends = _ints(inputs[2], "Slice.ends")
        axes = _ints(inputs[3], "Slice.axes") if len(inputs) > 3 and inputs[3] is not None \
            else list(range(len(starts)))
        steps = _ints(inputs[4], "Slice.steps") if len(inputs) > 4 and inputs[4] is not None \
            else [1] * len(starts)
    if isinstance(x, np.ndarray):
        idx = [slice(None)] * x.ndim
        for s, e, a, st in zip(starts, ends, axes, steps):
            idx[a % x.ndim] = slice(s if s > -(1 << 62) else None,
                                    e if -(1 << 62) < e < (1 << 62) else None, st)
        return x[tuple(idx)]
    x = _t(x, _dev(x))
    for s, e, a, st in zip(starts, ends, axes, steps):
        x = _slice_axis(x, a % x.dim(), s if s > -(1 << 62) else None,
                        e if -(1 << 62) < e < (1 << 62) else None, st)
    return x


def _wrap_index(idx: torch.Tensor, dim: int) -> torch.Tensor:
    idx = idx.to(torch.int64)
    return torch.where(idx < 0, idx + dim, idx)


@op("Gather")
def _gather(inputs, attrs, ctx):
    x, idx = inputs[0], inputs[1]
    axis = attrs.get("axis", 0)
    if isinstance(x, np.ndarray) and isinstance(idx, np.ndarray):
        return np.take(x, idx.astype(np.int64), axis=axis)
    dev = _dev(x, idx)
    x, idx = _t(x, dev), _t(idx, dev)
    axis = axis % x.dim()
    i = _wrap_index(idx, x.shape[axis])
    out = torch.index_select(x, axis, i.reshape(-1))
    return out.reshape(tuple(x.shape[:axis]) + tuple(i.shape) + tuple(x.shape[axis + 1:]))


@op("GatherElements")
def _gather_elements(inputs, attrs, ctx):
    dev = _dev(inputs[0], inputs[1])
    x, idx = _t(inputs[0], dev), _t(inputs[1], dev)
    axis = attrs.get("axis", 0) % x.dim()
    return torch.gather(x, axis, _wrap_index(idx, x.shape[axis]))


@op("GatherND")
def _gather_nd(inputs, attrs, ctx):
    batch_dims = attrs.get("batch_dims", 0)
    if batch_dims:
        raise NotImplementedError("GatherND batch_dims>0")
    dev = _dev(inputs[0], inputs[1])
    x, idx = _t(inputs[0], dev), _t(inputs[1], dev).to(torch.int64)
    return x[tuple(torch.movedim(idx, -1, 0))]


@op("ScatterND")
def _scatter_nd(inputs, attrs, ctx):
    data, indices, updates = inputs[:3]
    dev = _dev(data, indices, updates)
    out = _t(data, dev).clone()
    idx = _t(indices, dev).to(torch.int64)
    upd = _t(updates, dev).to(out.dtype)
    red = attrs.get("reduction", "none")
    k = idx.shape[-1]
    # the addressed slices as rows of a (prod(shape[:k]), rest) view
    dims = torch.tensor(out.shape[:k], device=dev)
    idx = torch.where(idx < 0, idx + dims, idx)
    strides = torch.tensor([int(np.prod(out.shape[i + 1:k])) for i in range(k)],
                           device=dev, dtype=torch.int64)
    rows = (idx * strides).sum(-1).reshape(-1)
    view = out.reshape((-1,) + tuple(out.shape[k:]))
    vals = upd.reshape((-1,) + tuple(out.shape[k:]))
    if red == "add":
        view.index_add_(0, rows, vals)
    elif red == "mul":
        index = rows.reshape((-1,) + (1,) * (view.dim() - 1)).expand_as(vals)
        view.scatter_reduce_(0, index, vals, "prod")
    else:
        view[rows] = vals
    return out


@op("Squeeze")
def _squeeze(inputs, attrs, ctx):
    x = inputs[0]
    axes = _axis_list(attrs, inputs, 1, "Squeeze.axes")
    if axes is None:
        axes = [i for i, d in enumerate(_shape(x)) if d == 1]
    nd = _ndim(x)
    if isinstance(x, np.ndarray):
        return np.squeeze(x, axis=tuple(a % nd for a in axes))
    return torch.squeeze(_t(x, _dev(x)), dim=tuple(a % nd for a in axes))


@op("Unsqueeze")
def _unsqueeze(inputs, attrs, ctx):
    x = inputs[0]
    axes = _axis_list(attrs, inputs, 1, "Unsqueeze.axes")
    out_rank = _ndim(x) + len(axes)
    axes = sorted(a % out_rank for a in axes)
    if isinstance(x, np.ndarray) or np.isscalar(x):
        return np.expand_dims(x, tuple(axes))
    x = _t(x, _dev(x))
    for a in axes:
        x = x.unsqueeze(a)
    return x


@op("Expand")
def _expand(inputs, attrs, ctx):
    target = _ints(inputs[1], "Expand.shape")
    x = _t(inputs[0], _dev(inputs[0]))
    # ONNX Expand uses bidirectional broadcast; broadcast_to needs the exact target
    in_shape = list(x.shape)
    rank = max(len(in_shape), len(target))
    in_shape = [1] * (rank - len(in_shape)) + in_shape
    target = [1] * (rank - len(target)) + list(target)
    final = [max(a, b) for a, b in zip(in_shape, target)]
    return torch.broadcast_to(x.reshape(in_shape), final)


@op("Tile")
def _tile(inputs, attrs, ctx):
    reps = _ints(inputs[1], "Tile.repeats")
    return torch.tile(_t(inputs[0], _dev(inputs[0])), reps)


def _pad_index(n: int, lo: int, hi: int, mode: str, device) -> torch.Tensor:
    """numpy's reflect / edge / wrap positions of a padded axis of length n."""
    i = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return i.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(i, n)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    j = torch.remainder(i, period)
    return torch.where(j >= n, period - j, j)


@op("Pad")
def _pad(inputs, attrs, ctx):
    x = _t(inputs[0], _dev(inputs[0]))
    mode = attrs.get("mode", "constant")
    if attrs.get("pads") is not None:  # opset<11
        pads = [int(p) for p in attrs["pads"]]
        cval = attrs.get("value", 0.0)
    else:
        pads = _ints(inputs[1], "Pad.pads")
        cval = inputs[2] if len(inputs) > 2 and inputs[2] is not None else 0.0
    rank = x.dim()
    axes = _ints(inputs[3], "Pad.axes") if len(inputs) > 3 and inputs[3] is not None \
        else list(range(rank))
    width = [(0, 0)] * rank
    half = len(pads) // 2
    for i, a in enumerate(axes):
        width[a % rank] = (pads[i], pads[i + half])
    if mode == "constant":
        value = cval if isinstance(cval, (int, float)) else _t(cval).reshape(()).item()
        flat = [p for pair in reversed(width) for p in pair]
        return F.pad(x, flat, value=value) if any(flat) else x
    jmode = {"reflect": "reflect", "edge": "edge", "wrap": "wrap"}[mode]
    for a, (lo, hi) in enumerate(width):
        if lo or hi:
            x = torch.index_select(x, a, _pad_index(x.shape[a], lo, hi, jmode, x.device))
    return x


@op("Cast", "CastLike")
def _cast(inputs, attrs, ctx):
    if ctx["op_type"] == "CastLike":
        dtype = result_type(inputs[1]) if not np.isscalar(inputs[1]) else \
            result_type(np.asarray(inputs[1]))
    else:
        dtype = DataType.to_torch(int(attrs["to"]))
    x = _t(inputs[0], _dev(inputs[0]))
    if _float(x.dtype) and not dtype.is_floating_point and dtype != torch.bool:
        return _saturating_int(x, dtype)
    return x.to(dtype)


def _saturating_int(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Float to integer as XLA's convert does it: toward zero, saturated at
    the type's range, NaN to 0. Clamped here, the same on the CPU and the
    card (``Tensor.to`` wraps or is undefined out of range)."""
    info = torch.iinfo(dtype)
    t = torch.trunc(x.to(torch.float64))
    hi, lo = t >= float(info.max), t <= float(info.min)
    inside = torch.where(hi | lo | torch.isnan(t), torch.zeros_like(t), t).to(dtype)
    return torch.where(hi, torch.full_like(inside, info.max),
                       torch.where(lo, torch.full_like(inside, info.min), inside))


def _qbroadcast(x, scale, zp, axis: int):
    """Per-axis quantization params broadcast against ``x``: a 1-D
    scale/zero_point lies along ``axis`` (ONNX per-channel form); scalars
    broadcast as-is."""
    dev = _dev(x, scale, zp)
    scale = _t(scale, dev)
    if zp is not None:
        zp = _t(zp, dev)
    nd = _ndim(x)
    if scale.dim() == 1 and nd > 1:
        shape = [1] * nd
        shape[axis % nd] = -1
        scale = scale.reshape(shape)
        if zp is not None and zp.dim() == 1:
            zp = zp.reshape(shape)
    return scale, zp


def _qinfo(zp) -> torch.dtype:
    return torch.uint8 if zp is None else result_type(zp)


@op("QuantizeLinear")
def _quantize_linear(inputs, attrs, ctx):
    # y = saturate(round(x / y_scale) + y_zero_point), round half to even;
    # output dtype follows the zero_point (uint8 when omitted, per spec)
    x, scale = inputs[0], inputs[1]
    zp = inputs[2] if len(inputs) > 2 else None
    qdtype = _qinfo(zp)
    scale, zp = _qbroadcast(x, scale, zp, int(attrs.get("axis", 1)))
    y = torch.round(_true_divide(x, scale))
    if zp is not None:
        y = y + zp.to(y.dtype)
    info = torch.iinfo(qdtype)
    return torch.clamp(y, info.min, info.max).to(qdtype)


@op("DequantizeLinear")
def _dequantize_linear(inputs, attrs, ctx):
    # y = (x - x_zero_point) * x_scale, in the scale's float dtype
    x, scale = inputs[0], inputs[1]
    zp = inputs[2] if len(inputs) > 2 else None
    scale, zp = _qbroadcast(x, scale, zp, int(attrs.get("axis", 1)))
    xf = _t(x, scale.device).to(scale.dtype)
    if zp is not None:
        xf = xf - zp.to(scale.dtype)
    return xf * scale


@op("DynamicQuantizeLinear")
def _dynamic_quantize_linear(inputs, attrs, ctx):
    # uint8 affine quantization with the data's own range (the range is
    # widened to include 0 so zero_point is always representable);
    # returns (y, y_scale, y_zero_point) exactly per spec
    x = _t(inputs[0], _dev(inputs[0]))
    xmax = torch.clamp(torch.max(x), min=0.0)
    xmin = torch.clamp(torch.min(x), max=0.0)
    scale = ((xmax - xmin) / 255.0).to(torch.float32)
    # all-zero input: the spec's scale is 0 -- quantize against 1.0 to keep
    # the arithmetic finite (y and zero_point are all zero either way)
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    zp = torch.clamp(torch.round(_true_divide(-xmin, safe)), 0, 255)
    y = torch.clamp(torch.round(_true_divide(x, safe)) + zp, 0, 255).to(torch.uint8)
    return y, scale, zp.to(torch.uint8)


@op("MatMulInteger")
def _matmul_integer(inputs, attrs, ctx):
    # int32 accumulation over zero-centred operands (kernel Q); per spec a
    # 1-D a_zero_point is per-row (M axis of A), a 1-D b_zero_point is
    # per-column (N axis of B). Output is always int32.
    dev = _dev(*inputs)
    a, b = _t(inputs[0], dev), _t(inputs[1], dev)
    a_zp = _t(inputs[2] if len(inputs) > 2 else None, dev)
    b_zp = _t(_nonzero_zp(inputs[3] if len(inputs) > 3 else None), dev)
    return qgemm.qmatmul(a, b, a_zp, b_zp, packed=_packed_b(inputs[1], b, dev, False))


def _nonzero_zp(zp):
    """A zero point, or None where it is a graph constant of zeros (the plan
    then knows that B's zero point takes no row sums of A)."""
    if isinstance(zp, (np.ndarray, np.generic)) and not np.any(zp):
        return None
    return zp


def _packed_b(const, b: torch.Tensor, dev, conv: bool):
    """Kernel Q's packed form of a constant B (a 2-D matmul B, or a conv
    weight), made once a device and kept by the executor's store; None for
    a B computed in the graph (packed a call by the wrapper)."""
    store = _STORE.get()
    if store is None or not is_const(const) or not store.owns(const) or \
            (not conv and b.dim() != 2):
        return None
    if conv:
        return store.packed(const, b.device, "qconv_w", qgemm.pack_conv_w)
    return store.packed(const, b.device, "qmatmul_b", qgemm.pack_matmul_b)


def _conv_geometry(attrs, x_shape, w_shape):
    rank = len(x_shape) - 2
    strides = [int(s) for s in attrs.get("strides", [1] * rank)]
    dilations = [int(d) for d in attrs.get("dilations", [1] * rank)]
    groups = int(attrs.get("group", 1))
    pads = _resolve_pads(attrs, rank, x_shape, w_shape[2:], strides, dilations)
    return strides, pads, dilations, groups


@op("ConvInteger")
def _conv_integer(inputs, attrs, ctx):
    # Conv over zero-centred operands (kernel Q; implicit padding represents
    # x_zero_point, i.e. real zero -- onnxruntime semantics); w_zero_point
    # may be per-output-channel (axis 0 of OIHW)
    dev = _dev(*inputs)
    x, w = _t(inputs[0], dev), _t(inputs[1], dev)
    x_zp = _t(inputs[2] if len(inputs) > 2 else None, dev)
    w_zp = _t(_nonzero_zp(inputs[3] if len(inputs) > 3 else None), dev)
    return qgemm.qconv(x, w, x_zp, w_zp, *_conv_geometry(attrs, x.shape, w.shape),
                       packed=_packed_b(inputs[1], w, dev, True))


def _f32(v, dev) -> torch.Tensor:
    return _t(v, dev).to(torch.float32)


@op("QLinearConv")
def _qlinear_conv(inputs, attrs, ctx):
    # full requantizing Conv (kernel Q): ConvInteger's zero-centred int32
    # accumulation, an optional int32 bias (per spec already quantized with
    # scale x_scale*w_scale, zero_point 0 -- added into the accumulator),
    # then rescale by x_scale*w_scale/y_scale, round half to even,
    # re-centre on y_zero_point and saturate to its dtype. w_scale /
    # w_zero_point may be per-output-channel (OIHW axis 0).
    x, x_scale, x_zp, w, w_scale, w_zp, y_scale, y_zp = inputs[:8]
    bias = inputs[8] if len(inputs) > 8 and inputs[8] is not None else None
    dev = _dev(*inputs)
    xt, wt = _t(x, dev), _t(w, dev)
    scale = _f32(x_scale, dev) * _f32(w_scale, dev) / _f32(y_scale, dev)
    rq = qgemm.Requant(scale, _t(y_zp, dev), None if bias is None else _t(bias, dev))
    return qgemm.qconv(xt, wt, _t(x_zp, dev), _t(_nonzero_zp(w_zp), dev),
                       *_conv_geometry(attrs, xt.shape, wt.shape), rq=rq,
                       packed=_packed_b(w, wt, dev, True))


@op("QLinearMatMul")
def _qlinear_matmul(inputs, attrs, ctx):
    # full requantizing matmul (kernel Q): int32 accumulate, rescale by
    # a_scale*b_scale/y_scale, round half to even, re-centre on y_zero_point
    # and saturate to its dtype. 1-D scales/zero_points are per-row for a and
    # y, per-column for b (same layout rule as MatMulInteger).
    a, a_scale, a_zp, b, b_scale, b_zp, y_scale, y_zp = inputs[:8]
    dev = _dev(*inputs)

    def _row(s):  # per-row params broadcast down the output's M axis
        s = _t(s, dev)
        return s.reshape(-1, 1) if s.dim() == 1 else s

    scale = _row(a_scale).to(torch.float32) * _f32(b_scale, dev) / \
        _row(y_scale).to(torch.float32)
    rq = qgemm.Requant(scale, _row(y_zp))
    bt = _t(b, dev)
    return qgemm.qmatmul(_t(a, dev), bt, _t(a_zp, dev), _t(_nonzero_zp(b_zp), dev), rq,
                         packed=_packed_b(b, bt, dev, False))


@op("Where")
def _where(inputs, attrs, ctx):
    c, a, b = inputs[:3]
    if _all_np(c, a, b):
        return np.where(c, a, b)
    a, b = _promote(a, b)
    return torch.where(_t(c, a.device).to(torch.bool), a, b)


@op("OneHot")
def _onehot(inputs, attrs, ctx):
    indices, depth, values = inputs[:3]
    axis = attrs.get("axis", -1)
    d = int(_static(depth, "OneHot.depth"))
    dev = _dev(indices, values)
    vals = _t(values, dev)
    idx = _t(indices, dev)
    if not _float(idx.dtype):
        idx = idx.to(torch.int64)
    # spec: negative indices in [-depth, -1] wrap; anything else is all-off.
    # A float index is compared with each column as it is (the reference's
    # jax.nn.one_hot), so 1.7 sets no column, where the spec would truncate
    valid = (idx >= -d) & (idx <= d - 1)
    idx = torch.where(valid, torch.where(idx < 0, idx + d, idx), torch.full_like(idx, -1))
    oh = (idx[..., None] == torch.arange(d, device=idx.device)).to(torch.float32)
    if axis != -1:
        oh = torch.movedim(oh, -1, axis % oh.dim())
    off_val, on_val = vals[0], vals[1]
    return torch.add(*_promote(torch.mul(*_promote(oh, on_val - off_val)), off_val))


@op("Range")
def _range(inputs, attrs, ctx):
    start, limit, delta = (_static(v, "Range") for v in inputs[:3])
    return np.arange(start.item(), limit.item(), delta.item(), dtype=np.asarray(start).dtype)


@op("ConstantOfShape")
def _constant_of_shape(inputs, attrs, ctx):
    shape = _ints(inputs[0], "ConstantOfShape.shape")
    t = attrs.get("value")
    if t is None:
        return np.zeros(shape, dtype=np.float32)
    v = tensor_to_numpy(t, external_dir=ctx.get("external_dir"))
    if isinstance(v, torch.Tensor):   # bf16
        return torch.full(shape, float(v.reshape(-1)[0]), dtype=v.dtype)
    return np.full(shape, v.reshape(-1)[0], dtype=v.dtype)


@op("Constant")
def _constant(inputs, attrs, ctx):
    if attrs.get("value") is not None:
        return tensor_to_numpy(attrs["value"], external_dir=ctx.get("external_dir"))
    for k in ("value_float", "value_int"):
        if attrs.get(k) is not None:
            return np.asarray(attrs[k])
    for k in ("value_floats", "value_ints"):
        if attrs.get(k) is not None:
            return np.asarray(attrs[k])
    raise ValueError("Constant node with no value attribute")


@op("DepthToSpace")
def _depth_to_space(inputs, attrs, ctx):
    x = _t(inputs[0], _dev(inputs[0]))
    b = int(attrs["blocksize"])
    n, c, h, w = x.shape
    if attrs.get("mode", "DCR") == "DCR":
        t = x.reshape(n, b, b, c // (b * b), h, w).permute(0, 3, 4, 1, 5, 2)
    else:
        t = x.reshape(n, c // (b * b), b, b, h, w).permute(0, 1, 4, 2, 5, 3)
    return t.reshape(n, c // (b * b), h * b, w * b)


@op("SpaceToDepth")
def _space_to_depth(inputs, attrs, ctx):
    x = _t(inputs[0], _dev(inputs[0]))
    b = int(attrs["blocksize"])
    n, c, h, w = x.shape
    t = x.reshape(n, c, h // b, b, w // b, b).permute(0, 3, 5, 1, 2, 4)
    return t.reshape(n, c * b * b, h // b, w // b)


@op("Resize")
def _resize(inputs, attrs, ctx):
    x = _t(inputs[0], _dev(inputs[0]))
    mode = attrs.get("mode", "nearest")
    sizes = None
    if len(inputs) > 3 and inputs[3] is not None:
        sizes = _ints(inputs[3], "Resize.sizes")
    elif len(inputs) > 2 and inputs[2] is not None:
        scales = np.asarray(_static(inputs[2], "Resize.scales"), dtype=np.float64)
        if scales.size:
            sizes = [int(np.floor(s * d)) for s, d in zip(scales, x.shape)]
    if sizes is None:
        raise ValueError("Resize needs scales or sizes")
    if len(sizes) != x.dim():
        # jax.image.resize's check (opset 18's ``axes`` form is not taken)
        raise ValueError(f"Resize: shape {list(sizes)} must have the rank of the input "
                         f"{tuple(x.shape)}")
    method = {"nearest": "nearest", "linear": "linear", "cubic": "cubic"}[mode]
    return resize_array(x, sizes, method)


@op("ArgMax", "ArgMin")
def _argminmax(inputs, attrs, ctx):
    axis = attrs.get("axis", 0)
    keepdims = attrs.get("keepdims", 1)
    fn = torch.argmax if ctx["op_type"] == "ArgMax" else torch.argmin
    x = _t(inputs[0], _dev(inputs[0]))
    if attrs.get("select_last_index", 0):
        x = torch.flip(x, (axis,))
        out = x.shape[axis] - 1 - fn(x, dim=axis)
    else:
        out = fn(x, dim=axis)
    return out.unsqueeze(axis) if keepdims else out


@op("TopK")
def _topk(inputs, attrs, ctx):
    x = _t(inputs[0], _dev(inputs[0]))
    k = int(_static(inputs[1], "TopK.k")) if len(inputs) > 1 else int(attrs["k"])
    axis = attrs.get("axis", -1)
    largest = attrs.get("largest", 1)
    xm = torch.movedim(x, axis, -1)
    # lax.top_k: descending, ties to the lower index (a stable sort)
    vals, idx = torch.sort(xm if largest else -xm, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    if not largest:
        vals = -vals
    return (torch.movedim(vals, -1, axis), torch.movedim(idx, -1, axis))


@op("Trilu")
def _trilu(inputs, attrs, ctx):
    x = _t(inputs[0], _dev(inputs[0]))
    k = int(_static(inputs[1], "Trilu.k")) if len(inputs) > 1 and inputs[1] is not None else 0
    return torch.triu(x, k) if attrs.get("upper", 1) else torch.tril(x, k)


@op("IsInf")
def _isinf(inputs, attrs, ctx):
    x = _t(inputs[0], _dev(inputs[0]))
    pos = attrs.get("detect_positive", 1)
    neg = attrs.get("detect_negative", 1)
    out = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    if pos:
        out = out | (x == math.inf)
    if neg:
        out = out | (x == -math.inf)
    return out


# ---------------------------------------------------------------------------------
# reductions
# ---------------------------------------------------------------------------------

def _keep_int(fn):
    """jnp's integer reductions keep the input's integer dtype (torch's sum
    and prod widen to int64); bool sums count in the default int."""
    def impl(x, axis, keepdims):
        out = fn(x, axis, keepdims)
        if not _float(x.dtype) and x.dtype != torch.bool and out.dtype != x.dtype:
            out = out.to(x.dtype)
        return out

    return impl


def _prod(x, axis, keepdims):
    axes = range(x.dim()) if axis is None else [a % x.dim() for a in axis]
    for a in sorted(axes, reverse=True):
        x = torch.prod(x, dim=a, keepdim=keepdims)
    return x


def _max(x, axis, keepdims):
    return torch.amax(x, dim=axis if axis is not None else tuple(range(x.dim())),
                      keepdim=keepdims)


def _min(x, axis, keepdims):
    return torch.amin(x, dim=axis if axis is not None else tuple(range(x.dim())),
                      keepdim=keepdims)


def _sum(x, axis, keepdims):
    return torch.sum(x, dim=axis, keepdim=keepdims)


def _reduce(fn_np, fn_torch, axes_from_input_opset: int):
    def impl(inputs, attrs, ctx):
        x = inputs[0]
        if ctx["opset"] >= axes_from_input_opset:
            axes = _axis_list({"axes": attrs.get("axes")}, inputs, 1, "Reduce.axes")
        else:
            axes = attrs.get("axes")
        keepdims = bool(attrs.get("keepdims", 1))
        if axes is None:
            if attrs.get("noop_with_empty_axes", 0):
                return x
            ax = None
        else:
            ax = tuple(int(a) for a in np.atleast_1d(axes))
        if isinstance(x, np.ndarray):
            return fn_np(x, axis=ax, keepdims=keepdims)
        x = _t(x, _dev(x))
        if ax == ():
            return x   # an empty axis list reduces nothing (the reference's jnp call)
        return fn_torch(x, ax, keepdims)

    return impl


def _np_reducer(fn):
    """A numpy reduction of ``fn(x)`` over (axis, keepdims)."""
    return lambda x, axis, keepdims: np.sum(fn(x), axis=axis, keepdims=keepdims)


def _logsumexp(x, axes, keepdims):
    return torch.logsumexp(_inexact(x), dim=axes if axes is not None else
                           tuple(range(x.dim())), keepdim=keepdims)


_int_sum = _keep_int(_sum)
OPS["ReduceSum"] = _reduce(np.sum, _int_sum, 13)
OPS["ReduceMean"] = _reduce(np.mean, _mean, 18)
OPS["ReduceMax"] = _reduce(np.max, _max, 18)
OPS["ReduceMin"] = _reduce(np.min, _min, 18)
OPS["ReduceProd"] = _reduce(np.prod, _keep_int(_prod), 18)
OPS["ReduceL1"] = _reduce(_np_reducer(np.abs), lambda x, a, k: _int_sum(torch.abs(x), a, k), 18)
OPS["ReduceL2"] = _reduce(
    lambda x, axis, keepdims: np.sqrt(_np_reducer(np.square)(x, axis, keepdims)),
    lambda x, a, k: torch.sqrt(_inexact(_int_sum(x * x, a, k))), 18)
OPS["ReduceSumSquare"] = _reduce(lambda x, axis, keepdims: np.sum(x * x, axis=axis,
                                                                  keepdims=keepdims),
                                 lambda x, a, k: _int_sum(x * x, a, k), 18)
OPS["ReduceLogSum"] = _reduce(lambda x, axis, keepdims: np.log(np.sum(x, axis=axis,
                                                                      keepdims=keepdims)),
                              lambda x, a, k: torch.log(_inexact(_int_sum(x, a, k))), 18)
OPS["ReduceLogSumExp"] = _reduce(
    lambda x, axis, keepdims: np.log(np.sum(np.exp(x), axis=axis, keepdims=keepdims)),
    _logsumexp, 18)


@op("If")
def _if(inputs, attrs, ctx):
    cond = inputs[0]
    then_fn = ctx["subgraph_runner"](attrs["then_branch"])
    else_fn = ctx["subgraph_runner"](attrs["else_branch"])
    if isinstance(cond, np.ndarray) or is_const(cond):  # constant condition
        return then_fn() if bool(np.asarray(_static(cond, "If.cond"))) else else_fn()
    raise NotImplementedError(
        "If with a computed condition not supported (branches may differ in shape); "
        "most exported models have constant conditions after shape specialization"
    )


# ---------------------------------------------------------------------------------
# recurrent (LSTM / GRU)
# ---------------------------------------------------------------------------------

def _rnn_common(op_type: str, inputs, attrs, n_gates: int):
    """Shared LSTM/GRU front end: forward single-direction slices, combined
    bias, initial hidden state, the common dtype of every operand."""
    if attrs.get("layout", 0) != 0:
        raise NotImplementedError(f"{op_type} layout=1")
    direction = attrs.get("direction", "forward")
    if direction != "forward":
        raise NotImplementedError(f"{op_type} direction={direction!r}")
    x, w, r = inputs[0], inputs[1], inputs[2]
    seq_lens = inputs[4] if len(inputs) > 4 else None
    if seq_lens is not None and not (
            isinstance(seq_lens, np.ndarray) and np.all(seq_lens == _shape(x)[0])):
        raise NotImplementedError(f"{op_type} with ragged sequence_lens")
    opt = lambda i: inputs[i] if len(inputs) > i else None
    b, init_h = opt(3), opt(5)
    extra = [opt(6), opt(7)] if n_gates == 4 else []
    vals = _promote(x, w, r, b, init_h, *extra)
    x, w, r, b, init_h = vals[:5]
    hidden = int(r.shape[-1])
    w2, r2 = w[0], r[0]  # (n_gates*H, I), (n_gates*H, H)
    if b is not None:
        wb, rb = torch.split(b[0], n_gates * hidden)
    else:
        wb = rb = torch.zeros((n_gates * hidden,), dtype=x.dtype, device=x.device)
    h0 = (torch.zeros((x.shape[1], hidden), dtype=x.dtype, device=x.device)
          if init_h is None else init_h[0])
    clip = attrs.get("clip")
    return x, w2, r2, wb, rb, h0, hidden, clip, vals[5:]


@op("LSTM")
def _lstm(inputs, attrs, ctx):
    """Single-layer forward LSTM; gate order iofc, optional peepholes, outputs
    ``Y (S,1,B,H)``, ``Y_h (1,B,H)``, ``Y_c (1,B,H)``. The time steps are
    kernel R (``rnn.lstm_steps``)."""
    x, w2, r2, wb, rb, h0, hidden, clip, (init_c, p) = _rnn_common("LSTM", inputs, attrs, 4)
    acts = attrs.get("activations") or ["Sigmoid", "Tanh", "Tanh"]
    c0 = torch.zeros_like(h0) if init_c is None else init_c[0]
    # the input projection has no step dependence: one batched matmul
    # outside the recurrence, only the H-recurrence stays sequential
    gx = torch.matmul(x, w2.T) + wb + rb  # (S, B, 4H)
    ys, h_t, c_t = rnn.lstm_steps(gx.contiguous(), r2.contiguous(), h0.contiguous(),
                                  c0.contiguous(), None if p is None else p[0].contiguous(),
                                  clip, acts)
    return ys[:, None], h_t[None], c_t[None]


@op("GRU")
def _gru(inputs, attrs, ctx):
    """Single-layer forward GRU; gate order zrh, both ``linear_before_reset``
    modes, outputs ``Y (S,1,B,H)``, ``Y_h (1,B,H)``. The time steps are
    kernel R (``rnn.gru_steps``)."""
    x, w2, r2, wb, rb, h0, hidden, clip, _ = _rnn_common("GRU", inputs, attrs, 3)
    acts = attrs.get("activations") or ["Sigmoid", "Tanh"]
    lbr = int(attrs.get("linear_before_reset", 0))
    gx = torch.matmul(x, w2.T) + wb  # (S, B, 3H)
    ys, h_t = rnn.gru_steps(gx.contiguous(), r2.contiguous(), h0.contiguous(),
                            rb.contiguous(), lbr, clip, acts)
    return ys[:, None], h_t[None]
