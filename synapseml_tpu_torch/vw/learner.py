"""Minibatched AdaGrad-SGD linear learner over hashed sparse features.

Port of ``synapseml_tpu/vw/learner.py``: VW's online loop with adaptive,
normalised per-coordinate rates (``--adaptive --normalized``), minibatched,
and its pass-boundary AllReduce over a mesh. Losses: squared | logistic |
hinge | quantile. :func:`train_linear` runs every pass of a fit in one call,
on the GPU unless the caller passes ``device="cpu"``.

One batch step (:func:`batch_step`) is kernel V (``csrc/vw_step.cu``) on a
CUDA tensor and :func:`batch_step_plain` on a CPU tensor; on the card a
fit's pass is one launch of kernel V over all its batches
(:func:`step_batches`). Both compute the reference's step in the order and
with the roundings its XLA program takes on the CPU (the prediction's sum
over k as a chain of fused multiply-adds, the scatter started at ``l2 * w``
and taken in row-major order, the fused ``g2 + g * g``), except three places
where the port fixes its own: XLA replaces ``lr * g / sqrt(g2)`` by ``(lr *
g) * rsqrt(g2)`` fused into the subtraction, with its own ``rsqrt`` (an ulp
off for many inputs), and the logistic loss's ``exp`` by its own polynomial,
where the port divides by a correctly rounded square root and takes
``exp_f32`` (the same op for op on both devices); and the order of XLA's sum
behind the bias mean is not one the port could pin down, so the port sums
pairwise. With XLA's ``rsqrt`` and the fused subtractions patched in, the
hinge and quantile losses (whose gradients sum exactly in any order) give
the reference's state bit for bit over padding, duplicate slots and slot 0
as a feature. So the port agrees with the reference within a tolerance that
those three cause, and the card gives the CPU's state bit for bit.

Under a mesh each data rank passes over its own block of rows (the
reference's ``reshard``: ``ceil(n / shards)`` rows a rank, padded with rows
of weight 0, then to whole batches), and at each pass end the state is
averaged over the data axis (one all-reduce sum of ``w``, ``g2``, ``b`` and
``bg2``, divided by the data size: the ``pmean``) and the scales are
all-reduced by max. With an ``fsdp`` axis each rank keeps only its
``1 / fsdp`` slice of ``w``, ``g2`` and ``scale`` between passes and
all-gathers them over the fsdp group at the start of each pass: placement
only, the state is bit-identical to the replicated path.
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.serialization import register_state_class
from ..kernels.build import CudaKernel

__all__ = ["LinearLearnerState", "pad_examples", "train_linear", "train_linear_plain",
           "predict_linear", "batch_step", "batch_step_plain", "step_batches", "StepPlan",
           "StepState", "StepHyper", "VW_KERNEL", "V_LONG_LIST", "V_CLUSTER_CTAS", "LOSSES",
           "fma_f32", "sqrt_f32"]

LOSSES = ("squared", "logistic", "hinge", "quantile")


class LinearLearnerState(NamedTuple):
    w: np.ndarray        # (2^b,) weights
    g2: np.ndarray       # (2^b,) adagrad accumulators
    bias: np.ndarray     # () bias weight
    bias_g2: np.ndarray  # ()
    scale: np.ndarray    # (2^b,) running max |x| per coordinate (VW --normalized)

    def state_dict(self):
        return self._asdict()

    @staticmethod
    def from_state_dict(d):
        return LinearLearnerState(
            np.asarray(d["w"]), np.asarray(d["g2"]),
            np.asarray(d["bias"]), np.asarray(d["bias_g2"]),
            np.asarray(d["scale"]))


register_state_class(LinearLearnerState)


def pad_examples(sparse_col: np.ndarray, mask_bits: int) -> Tuple[np.ndarray, np.ndarray]:
    """Object column of (indices, values) -> padded (n, K) int32/f32 arrays,
    K the longest row (at least 1); indices masked to ``mask_bits`` bits.

    Padding slots carry index 0 and value 0, so they are inert in gathers and
    scatter-adds. One numpy pass over the concatenated rows."""
    n = len(sparse_col)
    mask = np.uint32((1 << mask_bits) - 1)
    lens = np.fromiter((len(r[0]) for r in sparse_col), dtype=np.int64, count=n)
    K = max(int(lens.max()) if n else 1, 1)
    idx = np.zeros((n, K), dtype=np.int32)
    val = np.zeros((n, K), dtype=np.float32)
    live = np.nonzero(lens)[0]
    if live.size:
        ri = np.concatenate([np.asarray(sparse_col[r][0]) for r in live])
        rv = np.concatenate([np.asarray(sparse_col[r][1]) for r in live])
        rows = np.repeat(np.arange(n), lens)
        starts = np.cumsum(lens) - lens
        pos = np.arange(len(ri)) - np.repeat(starts, lens)
        idx[rows, pos] = (ri & mask).astype(np.int32)
        val[rows, pos] = rv
    return idx, val


# -- the step's constants and state ----------------------------------------------------

class StepHyper(NamedTuple):
    """A fit's step constants, each rounded to f32 where the reference rounds
    it: ``lr * l1`` is a Python product rounded once, ``1 - tau`` and
    ``-tau`` likewise. ``dense``: l1 or l2 set, so every slot moves every
    batch."""

    loss: int
    lr: float
    l1: float
    l2: float
    lr_l1: float
    q_hi: float
    q_lo: float
    dense: bool

    @classmethod
    def make(cls, loss: str, learning_rate: float, l1: float, l2: float,
             quantile_tau: float) -> "StepHyper":
        if loss not in LOSSES:
            raise ValueError(f"unknown loss {loss!r}; use squared|logistic|hinge|quantile")
        f = lambda x: float(np.float32(x))
        return cls(LOSSES.index(loss), f(learning_rate), f(l1), f(l2),
                   f(learning_rate * l1), f(1.0 - quantile_tau), f(-quantile_tau),
                   bool(l1) or bool(l2))


class StepState:
    """The learner's state on a device: ``buf`` = [w | g2 | b, bg2] (one
    tensor, so the pass-end mean is one all-reduce), ``s`` the scales."""

    def __init__(self, w, g2, bias, bias_g2, scale, device):
        dim = len(w)
        self.dim = dim
        self.buf = torch.empty(2 * dim + 2, dtype=torch.float32, device=device)
        self.buf[:dim] = torch.as_tensor(np.asarray(w, np.float32))
        self.buf[dim:2 * dim] = torch.as_tensor(np.asarray(g2, np.float32))
        self.buf[2 * dim] = float(np.float32(bias))
        self.buf[2 * dim + 1] = float(np.float32(bias_g2))
        # a copy: the caller's scales (an init state's) stay as they were
        self.s = torch.tensor(np.asarray(scale, np.float32), device=device)

    @property
    def w(self) -> torch.Tensor:
        return self.buf[:self.dim]

    @property
    def g2(self) -> torch.Tensor:
        return self.buf[self.dim:2 * self.dim]

    @property
    def bias(self) -> torch.Tensor:
        return self.buf[2 * self.dim:]

    def numpy(self) -> LinearLearnerState:
        buf, s = self.buf.cpu().numpy(), self.s.cpu().numpy()
        d = self.dim
        return LinearLearnerState(buf[:d].copy(), buf[d:2 * d].copy(),
                                  buf[2 * d:2 * d + 1].reshape(()).copy(),
                                  buf[2 * d + 1:].reshape(()).copy(), s.copy())


# -- exact f32 arithmetic in torch -----------------------------------------------------

def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to f32 (what ``__fmaf_rn`` and XLA's fused
    multiply-add give), from f64 operations: the product of two f32 values
    is exact in f64, the f64 sum is rounded to odd (Knuth's two-sum finds
    the error; an inexact even result moves one f64 ulp towards it), and the
    rounding of a round-to-odd result with 53 bits to 24 is the correctly
    rounded sum."""
    return _add_product(a.double() * b.double(), c)


def _add_product(p: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """:func:`fma_f32` of an f64 product ``p`` of two f32 values (exact)
    and f32 ``c``. An inexact f64 sum with an even last bit moves one ulp
    towards the exact value (the sign of the two-sum's error)."""
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0) & torch.isfinite(s)
    return torch.where(fix, torch.nextafter(s, err * torch.inf), s).float()


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 square root (``__fsqrt_rn``). PyTorch's CPU
    ``sqrt`` is not: its vectorised f32 and f64 versions miss the nearest
    value for about 0.7 % of inputs. The f64 root rounded to f32 is within
    an ulp; it is moved to the neighbour on the far side of a midpoint m
    where m^2 (exact in f64: m has 25 significant bits) says the root lies
    beyond it (no f32 input is the square of a midpoint)."""
    xd = x.double()
    r = torch.sqrt(xd).float()
    up = torch.nextafter(r, torch.full_like(r, torch.inf))
    dn = torch.nextafter(r, torch.zeros_like(r))
    hi = (r.double() + up.double()) * 0.5
    lo = (r.double() + dn.double()) * 0.5
    return torch.where(xd > hi * hi, up, torch.where(xd < lo * lo, dn, r))


def _sign(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign``: -1, +1, and the value itself for ±0 and NaN."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


def _loss_grad(hp: StepHyper, p: torch.Tensor, y: torch.Tensor, wt: torch.Tensor):
    """dL/dp times the importance weight, as the reference writes each loss."""
    if hp.loss == 0:  # squared
        return (p - y) * wt
    if hp.loss == 1:  # logistic, y in {-1, +1}
        from ..gbdt.lambdarank import exp_f32

        return (-y * wt) / (1.0 + exp_f32(y * p))
    if hp.loss == 2:  # hinge
        return torch.where(y * p < 1.0, -y, 0.0) * wt
    # quantile (pinball): the prediction sits above a tau-fraction of labels
    return torch.where(p >= y, hp.q_hi, hp.q_lo) * wt


def _pairwise_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``x`` zero-padded to a power of two, pairing neighbours at each
    level (kernel V's bias tree)."""
    n = 1 << max(len(x) - 1, 0).bit_length()
    if n > len(x):
        x = torch.cat([x, x.new_zeros(n - len(x))])
    while len(x) > 1:
        x = x[0::2] + x[1::2]
    return x[0]


def _step_w(w: torch.Tensor, g: torch.Tensor, g2n: torch.Tensor, hp: StepHyper):
    """The AdaGrad step of the weights at the new accumulators, then the L1
    shrink."""
    root = sqrt_f32(g2n)
    wn = w - (hp.lr * g) / root
    if hp.l1:
        # a tensor numerator: PyTorch computes scalar / tensor as
        # reciprocal(tensor) * scalar, two roundings
        wn = _sign(wn) * torch.clamp_min(wn.abs() - torch.full_like(root, hp.lr_l1) / root,
                                         0.0)
    return wn


def _step_b(b: torch.Tensor, gb: torch.Tensor, bg2n: torch.Tensor, hp: StepHyper):
    """The bias's AdaGrad step."""
    return b - (hp.lr * gb) / sqrt_f32(bg2n)


def _dropped(bi: torch.Tensor, bv: torch.Tensor) -> torch.Tensor:
    """Entries of index 0 and value +0.0: ``pad_examples``' padding (or a real
    entry that acts exactly as padding does)."""
    return (bi == 0) & (bv == 0) & ~torch.signbit(bv)


def batch_step_plain(st: StepState, bi: torch.Tensor, bv: torch.Tensor, by: torch.Tensor,
                     bw: torch.Tensor, hp: StepHyper) -> None:
    """Plain PyTorch version of one batch step (:func:`batch_step`), in
    place on ``st``. ``bi``/``bv`` (B, K) int32/f32, ``by``/``bw`` (B,) f32.

    The reference's ``batch_step`` (``vw/learner.py:130-153``) over full
    2^b vectors, each rounding stated:
    - ``s = max(s, |v|)`` over the batch's entries (exact);
    - ``bvn = v / max(s[i], 1e-12)``, one IEEE division;
    - ``pred = fma(w[i_k], bvn_k, acc)`` over k ascending from +0, then
      ``+ b``;
    - ``dl``: squared ``(p - y) * wt``; logistic ``(-y * wt) / (1 +
      exp_f32(y * p))``; hinge ``(y * p < 1 ? -y : 0) * wt``; quantile
      ``(p >= y ? 1 - tau : -tau) * wt``;
    - ``g`` starts at ``l2 * w`` (l2 set) or +0, and adds ``dl * bvn``
      (rounded) for each entry in row-major order (row by row, k
      ascending); the scatter runs in waves, a wave holding each slot's
      j-th entry, so no index repeats within one ``index_put_``;
    - ``g2 = fma(g, g, g2)``; ``w = w - (lr * g) / sqrt(g2)`` (the root
      correctly rounded, :func:`sqrt_f32`); with l1,
      ``w = sign(w) * max(|w| - (lr * l1) / sqrt(g2), 0)``;
    - ``gb`` = the pairwise sum of ``dl`` over the B rows (padding rows
      included) divided by B; ``bg2 = fma(gb, gb, bg2)``; ``b = b - (lr *
      gb) / sqrt(bg2)``.

    Padding entries (:func:`_dropped`) add ``dl * (+0)`` to slot 0: a sum
    started at +0 is never -0, so a zero term leaves it unchanged; a sum
    started at ``l2 * w`` can be -0, and becomes +0 if any term is +0; a
    NaN term (``dl`` not finite) makes it NaN. The waves leave padding out
    and add one term to slot 0 that has the same effect as all of them:
    NaN if one is NaN, else +0 if one is +0, else -0 (order among zeros and
    NaN does not matter, and a zero term before a non-zero one has none)."""
    B, K = bi.shape
    dim = st.dim
    w, g2, s = st.w, st.g2, st.s
    fi, fv = bi.reshape(-1).long(), bv.reshape(-1)
    s.scatter_reduce_(0, fi, fv.abs(), "amax", include_self=True)
    bvn = bv / torch.clamp_min(s[bi.long()], 1e-12)
    acc = torch.zeros(B, dtype=torch.float32, device=bv.device)
    prod = w[bi.long()].double() * bvn.double()
    for k in range(K):
        acc = _add_product(prod[:, k], acc)
    pred = acc + st.bias[0]
    dl = _loss_grad(hp, pred, by, bw)
    c = (dl[:, None] * bvn).reshape(-1)
    drop = _dropped(bi, bv).reshape(-1)
    pos = torch.nonzero(~drop)[:, 0]
    slot = fi[pos]
    order = torch.sort(slot, stable=True).indices
    pos, slot = pos[order], slot[order]
    rows_dropped = drop.view(B, K).any(dim=1)
    padded = bool(rows_dropped.any())
    new = torch.ones_like(slot, dtype=torch.bool)
    new[1:] = slot[1:] != slot[:-1]
    seg = torch.cumsum(new.long(), 0) - 1
    starts = torch.nonzero(new)[:, 0]
    u = slot[starts]
    if padded and not bool((u == 0).any()):
        u = torch.cat([u.new_zeros(1), u])  # slot 0 takes the padding's term
        seg = seg + 1
        starts = torch.cat([starts.new_zeros(1), starts])
    gu = hp.l2 * w[u] if hp.l2 else torch.zeros(len(u), dtype=torch.float32, device=w.device)
    if len(slot):
        rank = torch.arange(len(slot), device=slot.device) - starts[seg]
        wave = torch.sort(rank, stable=True).indices
        seg_w, c_w = seg[wave], c[pos[wave]]
        at = 0
        for n_j in torch.bincount(rank).tolist():
            sel = seg_w[at:at + n_j]
            gu[sel] = gu[sel] + c_w[at:at + n_j]
            at += n_j
    if padded:
        z = dl[rows_dropped] * 0.0
        term = torch.where(torch.isnan(z).any(), torch.nan,
                           torch.where((~torch.signbit(z)).any(), 0.0, -0.0))
        at0 = torch.nonzero(u == 0)[0, 0]
        gu[at0] = gu[at0] + term
    if hp.dense:
        at, g = slice(None), (hp.l2 * w if hp.l2 else torch.zeros_like(w))
        g[u] = gu
    else:
        # l1 = l2 = 0: a slot without entries has g = +0 and keeps its bits
        # (fma(0, 0, g2) = g2, w - (+0) = w), so only the batch's slots move
        at, g = u, gu
    g2n = fma_f32(g, g, g2[at])
    w[at] = _step_w(w[at], g, g2n, hp)
    g2[at] = g2n
    # a tensor divisor: on the card PyTorch divides by a host scalar as a
    # product with its reciprocal
    total = _pairwise_sum(dl)
    gb = total / torch.full_like(total, float(B))
    b, bg2 = st.bias[0], st.bias[1]
    bg2n = fma_f32(gb, gb, bg2)
    st.bias.copy_(torch.stack([_step_b(b, gb, bg2n, hp), bg2n]))


# -- kernel V --------------------------------------------------------------------------

_V_POINTERS = ("idx", "val", "y", "wt", "ebm", "ent", "evals", "useg", "uslot", "umax",
               "ulong", "bounds", "ws", "bias")
_V_FLOATS = ("lr", "l1", "l2", "lr_l1", "q_hi", "q_lo")
_V_INTS = ("B", "K", "P", "j0", "j1", "dim", "loss", "dense", "ctas")

# A slot list of more than V_LONG_LIST entries in a batch is a long list: a
# warp sums it (its terms in parallel, then the ordered adds); a shorter one
# is a thread's. The blocks of kernel V's thread-block cluster: 16 (more
# than 8 is a non-portable cluster size, which the H100 allows). Both chosen
# by tools/vw_step_bench.py on the H100 (PERF.md, PR 18).
V_LONG_LIST = 16
V_CLUSTER_CTAS = 16


class _VArgs(ctypes.Structure):
    """``VArgs`` of ``csrc/vw_step.cu``, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in _V_POINTERS]
                + [(name, ctypes.c_float) for name in _V_FLOATS]
                + [(name, ctypes.c_int) for name in _V_INTS])


VW_KERNEL = CudaKernel(
    name="vw_step", source="vw_step", symbol="smt_vw_step",
    argtypes=[ctypes.c_void_p, ctypes.c_void_p],
    replaces="synapseml_tpu/vw/learner.py:130 (train_linear -> batch_step, lax.scan :156)")


def _segments(key: torch.Tensor):
    """(each entry's run, each run's first entry) of a key whose equal values
    are adjacent."""
    new = torch.ones_like(key, dtype=torch.bool)
    new[1:] = key[1:] != key[:-1]
    return torch.cumsum(new.long(), 0) - 1, torch.nonzero(new)[:, 0]


class StepPlan:
    """Kernel V's plan of a fit's batches, built once a fit on the device (the
    batches are the same in every pass).

    Over the (nb, B, K) entries that are not padding (:func:`_dropped`),
    grouped by batch and then by slot, each slot's entries in row-major
    order: a batch's distinct slots come as its short lists (at most
    ``long_list`` entries: a thread sums one), the longest first and then
    by slot (so a warp's threads walk lists of one length), then its long
    lists by slot (a warp sums one). ``ent`` each entry's place in its
    batch (``r * K + k``; -1 for the one stand-in entry that puts slot 0 in
    the list of a batch whose only slot-0 entries are padding), ``evals``
    its value, ``useg`` the (U + 1,) starts of the slots' entries,
    ``uslot`` the slots, ``umax`` the batch's max |v| of each, ``ebm`` (nb,
    B, K) each entry's slot's ``umax`` (0 on padding), ``ranges`` each
    batch's [u0, u1), ``ulong`` (nb,) and ``long_from`` each batch's first
    long list, ``bounds`` (nb, 4) each batch's u0, u1, e0, e1."""

    def __init__(self, idx: torch.Tensor, val: torch.Tensor, dim: int,
                 long_list: int = V_LONG_LIST):
        nb, B, K = idx.shape
        dev = idx.device
        drop = _dropped(idx, val).reshape(nb, B * K)
        any_drop = drop.any(dim=1)
        zero_real = ((idx.reshape(nb, -1) == 0) & ~drop).any(dim=1)
        keep = ~drop
        # the stand-in: a batch with padding and no real slot-0 entry gets its
        # first padding entry kept, as an entry that adds nothing
        stand_in = any_drop & ~zero_real
        first_drop = torch.argmax(drop.to(torch.int8), dim=1)
        keep[stand_in, first_drop[stand_in]] = True
        flat = torch.nonzero(keep.reshape(-1))[:, 0]
        batch = flat // (B * K)
        slot = idx.reshape(-1)[flat].long()
        key = batch * dim + slot
        order = torch.sort(key, stable=True).indices
        key, flat = key[order], flat[order]
        # then stable by (batch, long, a short list's length descending):
        # each list stays whole and in row-major order
        seg, _ = _segments(key)
        size = torch.bincount(seg)[seg]
        is_long = size > long_list
        rank = torch.where(is_long, 0, long_list + 1 - size)
        order = torch.sort(((key // dim) * 2 + is_long.long()) * (long_list + 2) + rank,
                           stable=True).indices
        key, flat, is_long = key[order], flat[order], is_long[order]
        seg, starts = _segments(key)
        absv = val.reshape(-1)[flat].abs()
        umax = torch.zeros(len(starts), dtype=torch.float32, device=dev)
        umax.scatter_reduce_(0, seg, absv, "amax", include_self=True)
        ebm = torch.zeros(nb * B * K, dtype=torch.float32, device=dev)
        real = ~drop.reshape(-1)[flat]
        ebm[flat[real]] = umax[seg[real]]
        place = flat - (key // dim) * (B * K)
        self.long_list = int(long_list)
        self.ent = torch.where(real, place, -1).to(torch.int32).contiguous()
        self.evals = val.reshape(-1)[flat].contiguous()
        self.useg = torch.cat([starts, starts.new_tensor([len(key)])]).to(torch.int32).contiguous()
        self.uslot = (key[starts] % dim).to(torch.int32).contiguous()
        self.umax = umax.contiguous()
        self.ebm = ebm.view(nb, B, K)
        ubatch = key[starts] // dim
        ukind = ubatch * 2 + is_long[starts].long()
        ubound = torch.searchsorted(ubatch, torch.arange(nb + 1, device=dev))
        self.ulong = torch.searchsorted(ukind, torch.arange(nb, device=dev) * 2 + 1).to(
            torch.int32).contiguous()
        ebound = self.useg[ubound]
        self.bounds = torch.stack([ubound[:-1], ubound[1:], ebound[:-1], ebound[1:]], 1).to(
            torch.int32).contiguous()
        bounds = ubound.tolist()
        self.ranges: List[Tuple[int, int]] = list(zip(bounds[:-1], bounds[1:]))
        self.long_from: List[int] = self.ulong.tolist()
        self.entries = int(len(key))

    def sectors(self, j0: int, j1: Optional[int] = None) -> int:
        """Distinct 32-byte sectors of one 2^b f32 vector that the batches
        ``[j0, j1)`` touch together (default: batch ``j0`` alone), in each
        of ``w``, ``s``, ``g2``."""
        j1 = j0 + 1 if j1 is None else j1
        u0, u1 = self.ranges[j0][0], self.ranges[j1 - 1][1]
        return int(torch.unique(self.uslot[u0:u1] // 8).numel())


class _Scratch:
    """Kernel V's scratch of one fit on one device: the state as one 16-byte
    record a slot, ``ws`` (dim, 4) = {w, g2, s, mark} (mark's bits the
    place in its launch of the batch that last updated the slot in the
    dense regime, -1 at each launch).
    The rows' ``dl``, the bias tree and the padding flags live in the
    cluster's shared memory."""

    def __init__(self, B: int, dim: int, device):
        self.P = 1 << max(B - 1, 0).bit_length()
        self.ws = torch.empty(dim, 4, dtype=torch.float32, device=device)
        self._unmarked = torch.full((dim,), -1, dtype=torch.int32, device=device).view(
            torch.float32)

    def pack(self, st: "StepState") -> None:
        torch.stack([st.w, st.g2, st.s, self._unmarked], 1, out=self.ws)

    def unpack(self, st: "StepState") -> None:
        st.w.copy_(self.ws[:, 0])
        st.g2.copy_(self.ws[:, 1])
        st.s.copy_(self.ws[:, 2])


def _check(bi, bv, by, bw, shape) -> None:
    for t, dt in ((bi, torch.int32), (bv, torch.float32), (by, torch.float32),
                  (bw, torch.float32)):
        if t.dtype != dt or not t.is_contiguous() or t.device != bi.device:
            raise ValueError("kernel V takes contiguous int32 idx and f32 val/y/weight "
                             "on one device")
    if tuple(bi.shape) != shape or tuple(bv.shape) != shape or tuple(by.shape) != shape[:-1] \
            or tuple(bw.shape) != shape[:-1]:
        raise ValueError(f"kernel V's batches: idx {tuple(bi.shape)}, val {tuple(bv.shape)}, "
                         f"y {tuple(by.shape)}, weight {tuple(bw.shape)}; want {shape}")


def _launch(st: StepState, bi, bv, by, bw, hp: StepHyper, plan: StepPlan, j0: int, j1: int,
            scratch: Optional[_Scratch]) -> None:
    """One launch of kernel V over the plan's batches [j0, j1); ``bi`` ...
    ``bw`` hold those batches' data, batch j0 first."""
    if plan is None:
        raise ValueError("kernel V needs the fit's StepPlan")
    B, K = plan.ebm.shape[1:]
    if not 0 <= j0 < j1 <= len(plan.ranges):
        raise ValueError(f"batches [{j0}, {j1}) are not in the plan's {len(plan.ranges)}")
    _check(bi, bv, by, bw, (j1 - j0, B, K))
    if scratch is None:
        scratch = _Scratch(B, st.dim, bi.device)
    a = _VArgs(idx=bi.data_ptr(), val=bv.data_ptr(), y=by.data_ptr(), wt=bw.data_ptr(),
               ebm=plan.ebm.data_ptr(), ent=plan.ent.data_ptr(), evals=plan.evals.data_ptr(),
               useg=plan.useg.data_ptr(), uslot=plan.uslot.data_ptr(),
               umax=plan.umax.data_ptr(), ulong=plan.ulong.data_ptr(),
               bounds=plan.bounds.data_ptr(), ws=scratch.ws.data_ptr(),
               bias=st.bias.data_ptr(),
               lr=hp.lr, l1=hp.l1, l2=hp.l2, lr_l1=hp.lr_l1, q_hi=hp.q_hi, q_lo=hp.q_lo,
               B=B, K=K, P=scratch.P, j0=j0, j1=j1, dim=st.dim, loss=hp.loss,
               dense=int(hp.dense), ctas=V_CLUSTER_CTAS)
    with torch.cuda.device(bi.device):
        scratch.pack(st)
        VW_KERNEL(ctypes.addressof(a), torch.cuda.current_stream(bi.device).cuda_stream)
        scratch.unpack(st)


def step_batches(st: StepState, bi: torch.Tensor, bv: torch.Tensor, by: torch.Tensor,
                 bw: torch.Tensor, hp: StepHyper, plan: Optional[StepPlan] = None, j0: int = 0,
                 j1: Optional[int] = None, scratch: Optional[_Scratch] = None) -> None:
    """Batches ``[j0, j1)`` of a fit's (nb, B, K) / (nb, B) tensors, in place
    on ``st``, as ``j1 - j0`` calls of :func:`batch_step` would: one
    :func:`batch_step_plain` a batch for CPU tensors, ONE launch of kernel V
    for CUDA tensors (a persistent kernel that steps the batches in order)."""
    j1 = len(bi) if j1 is None else j1
    if bi.device.type == "cpu":
        for j in range(j0, j1):
            batch_step_plain(st, bi[j], bv[j], by[j], bw[j], hp)
        return
    if bi.device.type != "cuda":
        raise ValueError(f"unsupported device {bi.device}")
    _launch(st, bi[j0:j1], bv[j0:j1], by[j0:j1], bw[j0:j1], hp, plan, j0, j1, scratch)


def batch_step(st: StepState, bi: torch.Tensor, bv: torch.Tensor, by: torch.Tensor,
               bw: torch.Tensor, hp: StepHyper, plan: Optional[StepPlan] = None,
               j: int = 0, scratch: Optional[_Scratch] = None) -> None:
    """One batch step in place on ``st``: :func:`batch_step_plain` for CPU
    tensors, kernel V (one launch of the one batch) for CUDA tensors. On the
    card ``plan`` is the fit's :class:`StepPlan` and ``j`` this batch's place
    in it; ``scratch`` is reused across a fit's steps."""
    if bi.device.type == "cpu":
        return batch_step_plain(st, bi, bv, by, bw, hp)
    if bi.device.type != "cuda":
        raise ValueError(f"unsupported device {bi.device}")
    _launch(st, bi[None], bv[None], by[None], bw[None], hp, plan, j, j + 1, scratch)


# -- the fit ---------------------------------------------------------------------------

def _rows_of(n: int, shards: int, rank: int, batch_size: int):
    """The reference's ``reshard``: (first row, rows) of ``rank``'s block of
    ``ceil(n / shards)`` rows, and its batches."""
    per = -(-n // shards)
    nb = -(-per // batch_size)
    return rank * per, per, nb


def _batches(a: np.ndarray, first: int, per: int, nb: int, batch_size: int,
             device) -> torch.Tensor:
    """Rows [first, first + per) of ``a`` (zero rows past its end), padded
    with zero rows to ``nb`` whole batches, on ``device``: (nb, batch_size,
    ...). The rows go to the device as they are and are padded there."""
    take = torch.from_numpy(np.ascontiguousarray(a[first:min(first + per, len(a))])).to(device)
    out = torch.zeros((nb * batch_size,) + a.shape[1:], dtype=take.dtype, device=device)
    out[:len(take)] = take
    return out.view((nb, batch_size) + a.shape[1:])


def _synced(device) -> float:
    """The host clock once the device's queued work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _fsdp_slices(layout, dim: int):
    """(slice of this rank, chunk) of a 2^b vector stored over the fsdp axis."""
    f = layout.fsdp_size
    chunk = -(-dim // f)
    r = layout.fsdp_rank
    return slice(min(r * chunk, dim), min((r + 1) * chunk, dim)), chunk


def _fit(idx, val, y, num_bits, weight, loss, learning_rate, l1, l2, num_passes, batch_size,
         quantile_tau, init_state, mesh, axis, device, stats, plain: bool):
    from ..runtime.device import resolve_device

    idx = np.asarray(idx)
    val = np.asarray(val, dtype=np.float32)
    n, K = idx.shape
    dim = 1 << num_bits
    t0 = time.perf_counter()
    # extremes, not element-wise tests: one pass over each array, no temporary
    if idx.size and idx.max() >= dim:
        raise ValueError(f"feature index >= 2^{num_bits}; mask indices with pad_examples")
    if idx.size and idx.min() < 0:
        raise ValueError("feature indices must be >= 0")
    if val.size and not (np.isfinite(val.max()) and np.isfinite(val.min())):
        raise ValueError("feature values must be finite (a normalised scale needs them)")
    hp = StepHyper.make(loss, learning_rate, l1, l2, quantile_tau)
    dev = resolve_device(device)
    w_np = np.ones(n, np.float32) if weight is None else np.asarray(weight, np.float32)
    if init_state is None:
        st0 = (np.zeros(dim, np.float32), np.full(dim, 1e-6, np.float32),
               np.float32(0.0), np.float32(1e-6), np.zeros(dim, np.float32))
    else:
        # external states hold raw-space weights; training runs in the
        # normalised space w' = w * s
        st0 = (np.asarray(init_state.w) * np.asarray(init_state.scale), init_state.g2,
               init_state.bias, init_state.bias_g2, init_state.scale)
    layout = None
    if mesh is not None:
        from ..runtime.layout import as_layout

        layout = as_layout(mesh, data_axis=axis)
    shards, rank = (1, 0) if layout is None else (layout.data_size, layout.data_rank)
    first, per, nb = _rows_of(n, shards, rank, batch_size)
    cut = lambda a: _batches(a, first, per, nb, batch_size, dev)
    bi, bv = cut(idx.astype(np.int32, copy=False)), cut(val)
    by, bw = cut(np.asarray(y, np.float32)), cut(w_np)
    st = StepState(*st0, device=dev)
    on_card = dev.type == "cuda" and not plain
    t1 = _synced(dev)
    plan = StepPlan(bi, bv, dim) if on_card and nb else None
    scratch = _Scratch(batch_size, dim, dev) if on_card else None
    t2 = _synced(dev)
    fsdp = layout is not None and layout.fsdp_size > 1
    passes = max(1, int(num_passes))
    rec = {"device": str(dev), "batches_a_pass": nb, "at_rest_bytes": []}
    if fsdp:
        sl, chunk = _fsdp_slices(layout, dim)
        stored = _shard(st, sl, chunk)
        st = None
    launches0 = VW_KERNEL.launches
    for p in range(passes):
        if fsdp:
            st = _gather(stored, layout, dim, chunk)
        if plain:
            for j in range(nb):
                batch_step_plain(st, bi[j], bv[j], by[j], bw[j], hp)
        elif nb:
            # one launch a pass on the card
            step_batches(st, bi, bv, by, bw, hp, plan, 0, nb, scratch)
        if layout is not None:
            from ..runtime.collectives import all_reduce

            all_reduce(st.buf, layout, "sum", (layout.data_axis,))
            st.buf.div_(float(shards))
            all_reduce(st.s, layout, "max", (layout.data_axis,))
        if fsdp:
            stored = _shard(st, sl, chunk)
            rec["at_rest_bytes"].append(sum(t.numel() * t.element_size() for t in stored))
            st = None if p + 1 < passes else st
        else:
            rec["at_rest_bytes"].append((st.buf.numel() + st.s.numel()) * 4)
    rec["kernel_launches"] = VW_KERNEL.launches - launches0
    t3 = _synced(dev)
    out = st.numpy()
    rec["seconds"] = {"inputs": t1 - t0, "plan": t2 - t1, "passes": t3 - t2,
                      "read_back": time.perf_counter() - t3}
    if stats is not None:
        stats.update(rec)
    # fold the feature scales into the weights: raw-space w = w' / s
    scale = out.scale
    w_raw = np.where(scale > 0, out.w / np.maximum(scale, 1e-12), 0.0)
    return out._replace(w=w_raw.astype(np.float32))


def _shard(st: StepState, sl: slice, chunk: int) -> List[torch.Tensor]:
    """This rank's stored part: [w, g2, s] slices padded to ``chunk``, and
    the bias pair."""
    part = torch.zeros(3, chunk, dtype=torch.float32, device=st.s.device)
    n = sl.stop - sl.start
    part[0, :n] = st.w[sl]
    part[1, :n] = st.g2[sl]
    part[2, :n] = st.s[sl]
    return [part, st.bias.clone()]


def _gather(stored: List[torch.Tensor], layout, dim: int, chunk: int) -> StepState:
    """All-gather the fsdp parts into a full state (bits unchanged)."""
    from ..runtime.collectives import all_gather

    part, bias = stored
    full = all_gather(part.reshape(-1).contiguous(), layout, "fsdp")
    full = full.view(layout.fsdp_size, 3, chunk).transpose(0, 1).reshape(3, -1)[:, :dim]
    st = StepState.__new__(StepState)
    st.dim = dim
    st.buf = torch.cat([full[0], full[1], bias]).contiguous()
    st.s = full[2].contiguous()
    return st


def train_linear(
    idx: np.ndarray, val: np.ndarray, y: np.ndarray,
    num_bits: int = 18,
    weight: Optional[np.ndarray] = None,
    loss: str = "squared",
    learning_rate: float = 0.5,
    power_t: float = 0.5,       # kept for API parity; adagrad supersedes the schedule
    l1: float = 0.0,
    l2: float = 0.0,
    num_passes: int = 1,
    batch_size: int = 256,
    quantile_tau: float = 0.5,
    init_state: Optional[LinearLearnerState] = None,
    mesh=None, axis: str = "data",
    seed: int = 0,
    device=None,
    stats: Optional[Dict] = None,
) -> LinearLearnerState:
    """Train; returns the final state (raw-space weights). ``idx``/``val``:
    (n, K) padded examples (:func:`pad_examples`). Every pass runs in this
    call, on ``device`` (default: the GPU; ``"cpu"`` runs the plain step).
    ``mesh``: a :class:`~synapseml_tpu_torch.runtime.layout.SpecLayout` or a
    ``DeviceMesh``, every rank calling with the same rows. ``stats``: a dict
    filled with the fit's record (device, batches a pass, kernel V's
    launches, each pass end's at-rest bytes of this rank's state, and
    ``seconds``: the inputs' checks and upload, the plan, the passes and
    the read-back, each ended by a device synchronisation). ``power_t`` and
    ``seed`` are unused, as in the reference."""
    return _fit(idx, val, y, num_bits, weight, loss, learning_rate, l1, l2, num_passes,
                batch_size, quantile_tau, init_state, mesh, axis, device, stats, plain=False)


def train_linear_plain(idx, val, y, num_bits: int = 18, weight=None, loss: str = "squared",
                       learning_rate: float = 0.5, l1: float = 0.0, l2: float = 0.0,
                       num_passes: int = 1, batch_size: int = 256, quantile_tau: float = 0.5,
                       init_state=None, device=None, stats=None) -> LinearLearnerState:
    """:func:`train_linear` through :func:`batch_step_plain` on any device (on
    the card: the tests' and ``chip_smoke.py``'s yardstick of kernel V)."""
    return _fit(idx, val, y, num_bits, weight, loss, learning_rate, l1, l2, num_passes,
                batch_size, quantile_tau, init_state, None, "data", device, stats, plain=True)


def predict_linear(state: LinearLearnerState, idx: np.ndarray, val: np.ndarray,
                   link: Optional[str] = None) -> np.ndarray:
    """Raw margin (or linked) predictions on padded examples (host numpy)."""
    raw = (state.w[idx] * val).sum(axis=1) + state.bias
    if link in (None, "identity"):
        return raw
    if link == "logistic":
        return np.where(raw >= 0, 1 / (1 + np.exp(-np.abs(raw))),
                        np.exp(-np.abs(raw)) / (1 + np.exp(-np.abs(raw))))
    raise ValueError(f"unknown link {link!r}")
