"""The LambdaRank objective's gradient and hessian (kernel F).

Port of ``synapseml_tpu/gbdt/boost.py::_lambda_grads`` (``:170-211``) over
the group tables of ``_group_tables`` (``:156``). Rows are contiguous by
query; :class:`QueryGroups` holds a fit's queries on its device: kernel
F's blocks (each query's id, first row and size, the largest first), each
row's gain ``2^label - 1``, each query's truncated ideal DCG
(both depend on the labels only, so they are computed once a fit, on the
host, where the reference recomputes them every iteration) and the discount
table ``1 / log2(2 + r)``. All three tables are computed on the CPU in f32,
so the card and the CPU read the same bits. The pairs' exponentials are
:func:`exp_f32`, written out in round-to-nearest f32 operations that both
devices perform alike, so the card computes the CPU's gradients bit for bit
(libm's and CUDA's ``expf`` differ in the last place).

:func:`lambda_grads` launches ``csrc/lambdarank.cu`` on a CUDA tensor (one
block a query: ranks by a bitonic sort in shared memory, then each counted
pair evaluated once, from the side of its document ranked above the
truncation, into tables that both documents' sums read in j order) and runs
the plain PyTorch version :func:`lambda_grads_plain` on a CPU tensor. The
plain version is the reference's dense formulation, per chunk of queries
padded to the chunk's largest: a (queries, i, j) block of pair terms, with
the queries sorted by size and cut into chunks whose block stays under a
memory cap (a query larger than the cap alone is cut along i). Padding
entries are masked, and each sum over j is taken in j order, so the result
does not depend on the chunking, and the kernel, which sums in the same
order, gives the same bits where its exponentials are the plain version's.

Ranks are the stable descending order of a query's scores, -0.0 tied with
+0.0. A NaN score ranks after every other score of its query, in index
order: ``torch.argsort(-s, stable=True)`` of the query alone. The plain
version pads a query to its chunk's widest with -inf, and NaN sorts after
that padding, so it agrees on NaN scores only where the query is its
chunk's widest (``cap=1`` makes every query its own chunk); a pair with a
NaN score has NaN terms either way.

On a mesh, queries are sharded whole (:func:`group_aligned_layout`, the
reference's group-aligned layout): each rank's kernel F runs over its own
:class:`QueryGroups`.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..kernels.build import CudaKernel

__all__ = ["QueryGroups", "lambda_grads", "lambda_grads_plain", "group_aligned_layout",
           "LAMBDARANK_KERNEL",
           "SMEM_DOCS", "TOP_MAX", "CHUNK_COLS", "pair_count", "cell_count", "exp_f32"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
LAMBDARANK_KERNEL = CudaKernel(
    name="gbdt_lambdarank", source="lambdarank", symbol="smt_lambdarank",
    argtypes=[_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P, _P, _P, _P],
    replaces="synapseml_tpu/gbdt/boost.py:170 (_lambda_grads)")

# constants of csrc/lambdarank.cu (a CPU test holds them to the source)
SMEM_DOCS = 2048  # kSmemDocs: larger queries sort in a global scratch
TOP_MAX = 32      # kTopMax: a larger min(truncation, m) takes the two-sided second loop
CHUNK_COLS = 96   # kCols: columns of a chunk of the main loop
# elements of one (queries, i, j) block of the plain version: 64 MB of f32 on
# the CPU, 512 MB on the card
_PLAIN_CAP = {"cpu": 1 << 24, "cuda": 1 << 27}


# exp_f32: Cody-Waite reduction by ln 2 (LN2_HI has 16 significant bits, so
# k * LN2_HI is exact for the k in use) and a degree-8 Taylor polynomial
_LOG2E = float(np.float32(1.4426950408889634))
_LN2_HI = float(np.float32(0.693145751953125))
_LN2_LO = float(np.float32(1.428606820309417e-06))
_EXP_COEF = [float(np.float32(1.0 / f)) for f in (40320.0, 5040.0, 720.0, 120.0, 24.0, 6.0,
                                                   2.0, 1.0, 1.0)]
_EXP_LO, _EXP_HI = -20.0, 88.0


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """e^x in f32 from correctly rounded f32 products and sums, one op at a
    time (csrc/lambdarank.cu's ``exp_f32``, op for op): within 1.2 ulp of
    e^x on [-20, 88], +inf above 88, and e^-20 below -20 (where 1 + e^x
    rounds to 1 in f32 all the same)."""
    xc = torch.clamp(x, _EXP_LO, _EXP_HI)
    k = torch.round(xc * _LOG2E)                      # half to even, as rintf
    r = (xc - k * _LN2_HI) - k * _LN2_LO
    p = torch.full_like(r, _EXP_COEF[0])
    for c in _EXP_COEF[1:]:
        p = p * r + c
    scale = ((k.to(torch.int32) + 127) << 23).view(torch.float32)  # 2^k, exactly
    return torch.where(x > _EXP_HI, torch.inf, p * scale)


class QueryGroups:
    """A fit's contiguous query groups on ``device``: ``sizes`` (Q,) rows a
    query, ``label`` (n,) the rows' relevance, ``truncation`` the ideal DCG's
    depth (the reference's ``lambdarank_truncation_level``)."""

    def __init__(self, sizes, label, truncation: int, device="cpu"):
        sizes = np.asarray(sizes, dtype=np.int64).reshape(-1)
        if sizes.size and sizes.min() < 0:
            raise ValueError("query sizes must be >= 0")
        label = np.asarray(label, dtype=np.float64).reshape(-1)
        n = int(sizes.sum())
        if n != len(label):
            raise ValueError(f"group sizes sum to {n}, expected {len(label)}")
        if n >= 1 << 31:
            raise ValueError("at most 2^31 - 1 rows")
        self.sizes = sizes
        self.truncation = int(truncation)
        self.n = n
        self.G = int(sizes.max()) if sizes.size else 0
        offsets = np.zeros(len(sizes) + 1, dtype=np.int64)
        np.cumsum(sizes, out=offsets[1:])
        self.offsets_np = offsets
        dev = torch.device(device)
        lab = torch.from_numpy(label.astype(np.float32))
        gain = torch.exp2(lab) - 1.0
        disc = 1.0 / torch.log2(2.0 + torch.arange(max(self.G, 1), dtype=torch.float32))
        # kernel F's blocks: {query, first row, size, 0}, the largest queries first
        order = np.argsort(-sizes, kind="stable")
        self.blocks = torch.from_numpy(np.stack(
            [order, offsets[order], sizes[order], np.zeros_like(order)], 1).astype(np.int32)
        ).to(dev)
        self.gain = gain.to(dev)
        self.disc = disc.to(dev)
        self.max_dcg = self._ideal_dcg(gain, disc).to(dev)

    def _ideal_dcg(self, gain: torch.Tensor, disc: torch.Tensor) -> torch.Tensor:
        """(Q,) f32: each query's gains sorted descending, times the discount
        of their place, over the first ``truncation`` places, summed in place
        order and floored at 1e-12 (the reference's ``max_dcg``)."""
        Q, depth = len(self.sizes), min(self.truncation, self.G)
        out = torch.zeros(Q, dtype=torch.float32)
        for qs, gc in _query_chunks(self.sizes, 1, 1 << 24):
            if depth <= 0:
                break
            idx, valid = _padded(self.sizes[qs], self.offsets_np[qs], gc)
            g = torch.where(torch.from_numpy(valid), gain[torch.from_numpy(idx)], 0.0)
            ideal = torch.sort(g, dim=1, descending=True, stable=True).values
            acc = torch.zeros(len(qs), dtype=torch.float32)
            for r in range(min(depth, gc)):
                acc = acc + ideal[:, r] * disc[r]
            out[torch.from_numpy(qs)] = acc
        return torch.clamp(out, min=1e-12)


def group_aligned_layout(group_sizes, n_shards: int):
    """Queries to shards whole, by the reference's greedy row balance
    (``make_lambdarank_mesh``, ``boost.py:237-285``): a query goes to the
    shard its row midpoint falls in under an even ``n / n_shards`` split,
    so each shard holds a contiguous run of queries. Returns (``order``
    (n_shards * local,) int64, the input row of each slot, padding slots
    row 0; ``w_mask`` (n_shards * local,) f64, 1 on a real row, 0 on
    padding; ``local``, the rows a shard; the query ids of each shard)."""
    sizes = np.asarray(group_sizes, dtype=np.int64).reshape(-1)
    n = int(sizes.sum())
    starts = np.zeros(len(sizes) + 1, dtype=np.int64)
    np.cumsum(sizes, out=starts[1:])
    mids = starts[:-1] + sizes / 2.0
    shard_of = np.minimum((mids / (n / n_shards)).astype(np.int64), n_shards - 1)
    per_shard = [np.nonzero(shard_of == s)[0] for s in range(n_shards)]
    local = max(max(int(sizes[qs].sum()) for qs in per_shard), 1)
    order = np.zeros(n_shards * local, dtype=np.int64)
    w_mask = np.zeros(n_shards * local, dtype=np.float64)
    for s, qs in enumerate(per_shard):
        if len(qs):  # the shard's queries are consecutive: one run of rows
            lo, hi = int(starts[qs[0]]), int(starts[qs[-1] + 1])
            order[s * local:s * local + hi - lo] = np.arange(lo, hi)
            w_mask[s * local:s * local + hi - lo] = 1.0
    return order, w_mask, local, per_shard


def _padded(sizes: np.ndarray, starts: np.ndarray, gc: int):
    """(row-index table (Qc, gc), validity) of queries padded to ``gc``."""
    pos = np.arange(gc)[None, :]
    valid = pos < sizes[:, None]
    return np.where(valid, starts[:, None] + pos, 0), valid


def _query_chunks(sizes: np.ndarray, power: int, cap: int) -> List[Tuple[np.ndarray, int]]:
    """The queries sorted by size (stable), cut into chunks whose padded
    block of ``Qc * Gc ** power`` elements stays at most ``cap`` (a query
    over the cap alone is a chunk). Returns (query ids, Gc) per chunk."""
    order = np.argsort(sizes, kind="stable")
    out, i = [], 0
    while i < len(order):
        j = i + 1
        while j < len(order) and (j - i + 1) * max(int(sizes[order[j]]), 1) ** power <= cap:
            j += 1
        out.append((order[i:j], max(int(sizes[order[j - 1]]), 1)))
        i = j
    return out


def lambda_grads_plain(score: torch.Tensor, label: torch.Tensor, weight: torch.Tensor,
                       groups: QueryGroups, sigma: float = 1.0,
                       cap: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: the reference's (Q, G, G) pair terms, in chunks
    of at most ``cap`` elements (default: 2^24 on the CPU, 2^27 on a GPU);
    returns ``(g * w, max(h, 1e-12) * w)``.

    Block ``W[q, i, j]`` holds ``lam_ij`` where i beats j (else 0): its sum
    over j is the reference's ``lam.sum(2)`` and its sum over i, at column
    j, is ``lam.sum(1)`` (``lam_ji`` is ``W[q, j, i]``: the same operations on
    the same values). The pair terms are evaluated at the counted pairs
    only; both sums run in index order."""
    dev = score.device
    cap = _PLAIN_CAP.get(dev.type, _PLAIN_CAP["cpu"]) if cap is None else cap
    n = groups.n
    f32 = dict(dtype=torch.float32, device=dev)
    one = torch.tensor(1.0, **f32)
    sig = torch.tensor(np.float32(sigma), **f32)
    sig2 = torch.tensor(np.float32(sigma * sigma), **f32)  # the reference's sigma * sigma * rho
    g_out = torch.zeros(n, **f32)
    h_out = torch.zeros(n, **f32)
    offsets = groups.offsets_np
    for qs, gc in _query_chunks(groups.sizes, 2, cap):
        idx_np, valid_np = _padded(groups.sizes[qs], offsets[qs], gc)
        idx = torch.from_numpy(idx_np).to(dev)
        valid = torch.from_numpy(valid_np).to(dev)
        s = torch.where(valid, score[idx], -torch.inf)
        lab = torch.where(valid, label[idx], 0.0)
        gain = torch.where(valid, groups.gain[idx], 0.0)
        order = torch.argsort(-s, dim=1, stable=True)
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(gc, device=dev).expand_as(order).contiguous())
        disc = torch.where(valid, groups.disc[rank.clamp(max=groups.disc.numel() - 1)], 0.0)
        top = (rank < groups.truncation) & valid
        md = groups.max_dcg[torch.from_numpy(qs).to(dev)][:, None, None]
        ga, ha = torch.zeros(len(qs), gc, **f32), torch.zeros(len(qs), gc, **f32)
        gb, hb = ga.clone(), ha.clone()
        # rows i a block, so that one block holds at most `cap` elements
        step = max(1, cap // max(len(qs) * gc, 1))
        for i0 in range(0, gc, step):
            sl = slice(i0, min(i0 + step, gc))
            win = ((lab[:, sl, None] > lab[:, None, :]) & valid[:, sl, None] & valid[:, None, :]
                   & (top[:, sl, None] | top[:, None, :]))
            at = win.nonzero(as_tuple=True)
            q_, i_, j_ = at[0], at[1] + i0, at[2]
            sd = s[q_, i_] - s[q_, j_]
            rho = one / (one + exp_f32(sig * sd))
            delta = (torch.abs(gain[q_, i_] - gain[q_, j_])
                     * torch.abs(disc[q_, i_] - disc[q_, j_])) / md[q_, 0, 0]
            W = torch.zeros(win.shape, **f32)
            H = torch.zeros(win.shape, **f32)
            W[at] = (sig * rho) * delta
            H[at] = ((sig2 * rho) * (one - rho)) * delta
            g_a, h_a = ga[:, sl], ha[:, sl]
            for j in range(gc):            # sum over j, in j order
                g_a = g_a + W[:, :, j]
                h_a = h_a + H[:, :, j]
            ga[:, sl], ha[:, sl] = g_a, h_a
            for r in range(W.shape[1]):    # sum over the winners i, in i order
                gb = gb + W[:, r, :]
                hb = hb + H[:, r, :]
        g_q, h_q = -ga + gb, ha + hb
        g_out[idx[valid]] = g_q[valid]
        h_out[idx[valid]] = h_q[valid]
    return g_out * weight, torch.clamp(h_out, min=1e-12) * weight


def _check(score, label, weight, groups: QueryGroups) -> None:
    for name, t in (("score", score), ("label", label), ("weight", weight)):
        if t.shape != (groups.n,) or t.dtype != torch.float32:
            raise TypeError(f"{name} must be ({groups.n},) float32, got {t.dtype} of shape "
                            f"{tuple(t.shape)}")
        if t.device != score.device:
            raise ValueError(f"score on {score.device} but {name} on {t.device}")
    if groups.blocks.device != score.device:
        raise ValueError(f"query groups on {groups.blocks.device}, rows on {score.device}")


def lambda_grads(score: torch.Tensor, label: torch.Tensor, weight: torch.Tensor,
                 groups: QueryGroups, sigma: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(g * w, max(h, 1e-12) * w)``, each (n,) f32, of the LambdaRank
    objective at margins ``score`` over the rows' ``label`` and sample
    ``weight`` (all (n,) f32, rows contiguous by query as ``groups`` says).
    CPU tensors take the plain version; CUDA tensors launch kernel F (once).
    NaN scores rank last in their query (module docstring)."""
    _check(score, label, weight, groups)
    if score.device.type == "cpu":
        return lambda_grads_plain(score, label, weight, groups, sigma)
    if score.device.type != "cuda":
        raise ValueError(f"unsupported device {score.device}")
    score, label, weight = score.contiguous(), label.contiguous(), weight.contiguous()
    n, Q = groups.n, len(groups.sizes)
    g = torch.empty(n, dtype=torch.float32, device=score.device)
    h = torch.empty(n, dtype=torch.float32, device=score.device)
    if n == 0 or Q == 0:
        return g, h
    # queries over SMEM_DOCS sort their keys (16 bytes a row) and keep their
    # ranks (4) in global memory
    scratch = (torch.empty(5 * n, dtype=torch.int32, device=score.device)
               if groups.G > SMEM_DOCS else None)
    with torch.cuda.device(score.device):
        stream = torch.cuda.current_stream(score.device).cuda_stream
        LAMBDARANK_KERNEL(score.data_ptr(), label.data_ptr(), groups.gain.data_ptr(),
                          weight.data_ptr(), groups.blocks.data_ptr(), groups.max_dcg.data_ptr(),
                          groups.disc.data_ptr(), n, Q, groups.G,
                          groups.truncation, float(np.float32(sigma)),
                          float(np.float32(sigma * sigma)),
                          None if scratch is None else scratch.data_ptr(), g.data_ptr(),
                          h.data_ptr(), stream)
    return g, h


def pair_count(sizes, label, truncation: int, score=None) -> int:
    """Unordered pairs the gradient counts at these scores (default: all
    tied, iteration 0): documents of one query with different labels, one
    of them ranked above ``truncation``. Each needs one exponential (its
    rho feeds both documents)."""
    label = np.asarray(label, dtype=np.float64)
    score = np.zeros(len(label)) if score is None else np.asarray(score, dtype=np.float64)

    def differing(lab):  # pairs of different labels among `lab`
        _, counts = np.unique(lab, return_counts=True)
        return (len(lab) ** 2 - int((counts.astype(np.int64) ** 2).sum())) // 2

    total, start = 0, 0
    for m in np.asarray(sizes, dtype=np.int64):
        lab, s = label[start:start + m], score[start:start + m]
        start += int(m)
        below = np.argsort(-s, kind="stable")[truncation:]  # rank >= truncation
        total += differing(lab) - differing(lab[below])
    return total


def cell_count(sizes, truncation: int) -> Tuple[int, int]:
    """(cells kernel F visits, visits of its first design): over a query of
    m documents with T = min(truncation, m), the main loop's T(T-1)/2 top
    pairs and T(m - T) top-by-rest cells (each counted pair among them
    evaluated once), or m^2 where T > TOP_MAX (the two-sided second loop);
    the first design walked all m^2 ordered (i, j) for every query. Cells
    of one label are visited but not evaluated."""
    m = np.asarray(sizes, dtype=np.int64)
    t = np.clip(truncation, 0, m)
    cells = np.where(t > TOP_MAX, m * m, t * (t - 1) // 2 + t * (m - t))
    return int(cells.sum()), int((m * m).sum())
