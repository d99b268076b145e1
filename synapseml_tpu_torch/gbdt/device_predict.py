"""Batched booster scoring on the device (kernel B).

Port of ``synapseml_tpu/gbdt/device_predict.py::device_raw_scores`` and
``device_leaf_indices``. The model is a stack of replay-list trees (T, C, S):
split ``s`` turns leaf ``parent[s]`` into (``parent[s]``, ``s + 1``), rows
going right when their bin exceeds ``bin[s]``, or, where ``cat_set`` is given
and ``bin[s] < 0``, when their bin is not in the split's category set.
Scores accumulate ``scale_t * leaf_value`` in an (n, C) f32 buffer in tree
order, the reference's ``lax.scan`` over trees (``device_predict.py:95-98``),
so the sums round the same way.

On a CUDA tensor both functions launch ``csrc/tree_score.cu``, which walks
the trees top-down in the layout :func:`pack_trees` builds; on a CPU tensor
they run the plain PyTorch versions :func:`raw_scores_plain` and
:func:`leaf_indices_plain`, which replay the split lists through
:func:`~.grow.predict_binned` and never read the packed layout.

:func:`device_bin_cat` (kernel D, ``csrc/bin_features.cu``) bins raw f32
rows against the table :func:`pack_feature_table` builds from a
``BinMapper``; on a CPU tensor it runs :func:`device_bin_cat_plain`, the
reference's broadcast compare.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels.build import CudaKernel
from .grow import GrownTree, predict_binned

__all__ = ["PackedTrees", "pack_trees", "device_raw_scores", "device_leaf_indices",
           "raw_scores_plain", "leaf_indices_plain", "SCORE_KERNEL", "LEAF_KERNEL",
           "cats_f32_representable", "pack_feature_table", "device_bin_cat",
           "device_bin_cat_plain", "BIN_KERNEL"]

_P = ctypes.c_void_p
_I = ctypes.c_int
SCORE_KERNEL = CudaKernel(
    name="gbdt_tree_score", source="tree_score", symbol="smt_tree_score",
    argtypes=[_P, _I, ctypes.c_longlong, _I, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P, _P],
    replaces="synapseml_tpu/gbdt/device_predict.py:60 (_score_kernel)")
LEAF_KERNEL = CudaKernel(
    name="gbdt_tree_leaf", source="tree_score", symbol="smt_tree_leaf",
    argtypes=[_P, _I, ctypes.c_longlong, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    replaces="synapseml_tpu/gbdt/device_predict.py:25 (_leaf_kernel)")
BIN_KERNEL = CudaKernel(
    name="gbdt_bin_features", source="bin_features", symbol="smt_bin_features",
    argtypes=[_P, _P, _P, _P, _I, _P, ctypes.c_longlong, _I, _I, _I, _P],
    replaces="synapseml_tpu/gbdt/device_predict.py:208 (device_bin_cat)")

_CAT = 1 << 31  # record flag: categorical split
_I16 = (-(1 << 15), (1 << 15) - 1)


class PackedTrees(NamedTuple):
    """Replay-list trees as top-down node arrays (the kernel's layout).

    ``nodes`` (T*C, 4*units) int32, tree (t, c) at row ``t*C + c``: one
    record per live split, as many slots as the fullest tree has splits
    (record 0 is the root; a child >= 0 is a record, < 0 is ``~leaf``), then
    one bitset of ``ceil(cat_bins / 32)`` words per categorical record,
    padded to whole 16-byte units. A record is ``narrow`` (8 bytes:
    ``feature | cat << 15 | threshold or bitset word << 16``, ``left |
    right << 16``, 16-bit fields) when every field fits, else 16 bytes
    (``feature | cat << 31``, threshold or bitset word, left, right).
    ``depth`` (T, C, S+1) int32 is each leaf's depth (0 for a leaf that
    never exists)."""

    nodes: torch.Tensor
    depth: torch.Tensor
    units: int
    narrow: bool
    shape: tuple        # (T, C, S)
    cat_bins: int       # B of the category sets, 0 without them


def _host(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a), dtype=dtype)


def pack_trees(parent, feature, bins, cat_set=None, device="cpu") -> PackedTrees:
    """Turn (T, C, S) replay lists into one top-down node array per tree.

    Keeps the replay's semantics exactly: split ``s`` refines leaf
    ``parent[s]`` as it stands at step ``s``; ``parent[s] < 0`` is a split
    that never happened, and a split whose parent leaf does not exist yet is
    dead. Each live split turns the slot of leaf ``parent[s]`` into a record
    whose left child is that leaf and whose right child is the new leaf
    ``s + 1``, so every leaf keeps its replay id. A tree with no live split
    gets one record whose children are both leaf 0."""
    par = _host(parent, np.int64)
    T, C, S = par.shape
    Q, L = T * C, S + 1
    par = par.reshape(Q, S)
    fea = _host(feature, np.int64).reshape(Q, S)
    thr = _host(bins, np.int64).reshape(Q, S)
    cs = None if cat_set is None else _host(cat_set, np.int8).reshape(Q, S, -1)
    cat_bins = 0 if cs is None else cs.shape[-1]

    units = max(S, 1)
    rec = np.zeros((Q, units, 4), np.int64)
    rec[:, 0] = (0, 0, ~0, ~0)
    src = np.full((Q, units), -1, np.int64)       # split behind each record
    slot = np.full((Q, L), -2, np.int64)          # record holding each leaf, -1 root, -2 none
    side = np.zeros((Q, L), np.int64)             # 2: left child, 3: right child
    slot[:, 0] = -1
    depth = np.zeros((Q, L), np.int32)
    count = np.zeros(Q, np.int64)
    q_all = np.arange(Q)
    for s in range(S):
        p = par[:, s]
        pc = np.clip(p, 0, L - 1)
        live = (p >= 0) & (p < L) & (slot[q_all, pc] != -2)
        if not live.any():
            continue
        q, p = q_all[live], p[live]
        k = count[q]
        cat = (thr[q, s] < 0) if cs is not None else np.zeros(len(q), bool)
        rec[q, k] = np.stack([fea[q, s] | np.where(cat, _CAT, 0), thr[q, s], ~p,
                              np.full(len(q), ~(s + 1))], 1)
        src[q, k] = s
        at, sd = slot[q, p], side[q, p]
        inner = at >= 0
        rec[q[inner], at[inner], sd[inner]] = k[inner]
        slot[q, p], side[q, p] = k, 2
        slot[q, s + 1], side[q, s + 1] = k, 3
        dp = depth[q, p] + 1
        depth[q, p] = dp
        depth[q, s + 1] = dp
        count[q] += 1

    units = int(max(count.max(initial=0), 1))        # records of the fullest tree
    rec, src = rec[:, :units], src[:, :units]
    is_cat = (rec[:, :, 0] & _CAT) != 0
    n_cat = is_cat.sum(1)
    W = (cat_bins + 31) // 32
    thr_num = np.where(is_cat, 0, rec[:, :, 1])
    narrow = bool((rec[:, :, 0] & (_CAT - 1)).max(initial=0) < (1 << 15) and L <= (1 << 15)
                  and _I16[0] <= thr_num.min(initial=0) and thr_num.max(initial=0) <= _I16[1]
                  and 2 * units + int(n_cat.max(initial=0)) * W < (1 << 16))
    words = units * (2 if narrow else 4)
    if cs is not None:
        qc, kc = np.nonzero(is_cat)                  # row-major: creation order per tree
        first = np.cumsum(n_cat) - n_cat
        j = np.arange(len(qc)) - first[qc]           # tree-local categorical index
        rec[qc, kc, 1] = words + j * W
        members = np.zeros((len(qc), W * 32), bool)
        members[:, :cat_bins] = cs[qc, src[qc, kc]] > 0
        bitsets = np.packbits(members, axis=1, bitorder="little").view("<u4")
    total = (words + int(n_cat.max(initial=0)) * W + 3) // 4 * 4
    packed = np.zeros((Q, total), np.int64)
    if narrow:
        lo16 = lambda x: x & 0xFFFF
        packed[:, 0:words:2] = ((rec[:, :, 0] & 0x7FFF) | (is_cat << 15)
                                | (lo16(rec[:, :, 1]) << 16))
        packed[:, 1:words:2] = lo16(rec[:, :, 2]) | (lo16(rec[:, :, 3]) << 16)
    else:
        packed[:, :words] = rec.reshape(Q, words)
    if cs is not None and len(qc):
        cols = rec[qc, kc, 1][:, None] + np.arange(W)[None, :]
        packed[qc[:, None], cols] = bitsets.astype(np.int64)
    nodes = (packed & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return PackedTrees(
        nodes=torch.from_numpy(nodes).to(device),
        depth=torch.from_numpy(depth.reshape(T, C, L)).to(device),
        units=total // 4, narrow=narrow, shape=(T, C, S), cat_bins=cat_bins)


def _replay_trees(binned, parent, feature, bins, cat_set):
    """Yield (t, c, leaf ids (n,) int32) for every tree, by the plain replay."""
    as_t = lambda a, dt: torch.as_tensor(_host(a, dt), device=binned.device)
    parent, feature, bins = (as_t(a, np.int32) for a in (parent, feature, bins))
    cs = None if cat_set is None else as_t(cat_set, np.int8)
    T, C, _ = parent.shape
    for t in range(T):
        for c in range(C):
            tree = GrownTree(parent[t, c], feature[t, c], bins[t, c], None, None, None,
                             None if cs is None else cs[t, c])
            yield t, c, predict_binned(tree, binned)


def raw_scores_plain(binned, parent, feature, bins, leaf_value, scale,
                     cat_set=None) -> torch.Tensor:
    """Plain PyTorch version: each tree's leaves by the replay
    (:func:`~.grow.predict_binned`), summed tree by tree."""
    lv = torch.as_tensor(_host(leaf_value, np.float32), device=binned.device)
    sc = torch.as_tensor(_host(scale, np.float32), device=binned.device)
    T, C, _ = lv.shape
    acc = torch.zeros(binned.shape[0], C, dtype=torch.float32, device=binned.device)
    vals = [None] * C
    for t, c, leaf in _replay_trees(binned, parent, feature, bins, cat_set):
        vals[c] = lv[t, c][leaf.long()]
        if c == C - 1:
            acc = acc + sc[t] * torch.stack(vals, dim=1)
    return acc


def leaf_indices_plain(binned, parent, feature, bins, cat_set=None) -> torch.Tensor:
    """Plain PyTorch version of the leaf ids: (T, C, n) int32 by the replay."""
    T, C, _ = np.shape(parent)
    out = torch.empty(T, C, binned.shape[0], dtype=torch.int32, device=binned.device)
    for t, c, leaf in _replay_trees(binned, parent, feature, bins, cat_set):
        out[t, c] = leaf
    return out


def _check(binned, parent, feature, bins, cat_set, packed: Optional[PackedTrees]):
    if binned.dim() != 2 or binned.dtype not in (torch.int8, torch.int16, torch.int32):
        raise TypeError(f"binned must be a 2-D int8/int16/int32 tensor, got "
                        f"{binned.dtype} of shape {tuple(binned.shape)}")
    if binned.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {binned.device}")
    shape = tuple(np.shape(parent))
    if len(shape) != 3 or np.shape(feature) != shape or np.shape(bins) != shape:
        raise ValueError("parent, feature and bins must share one (T, C, S) shape")
    if cat_set is not None and tuple(np.shape(cat_set))[:3] != shape:
        raise ValueError(f"cat_set must be (T, C, S, B) with (T, C, S) = {shape}, got "
                         f"{tuple(np.shape(cat_set))}")
    if packed is not None and (packed.shape != shape or packed.nodes.device != binned.device):
        raise ValueError(f"packed trees of shape {packed.shape} on {packed.nodes.device} for "
                         f"trees of shape {shape} and bins on {binned.device}")
    f = _host(feature, np.int64)
    if f.size and (f.min() < 0 or f.max() >= binned.shape[1]):
        raise ValueError(f"split features must lie in [0, {binned.shape[1]})")


def device_raw_scores(binned: torch.Tensor, parent, feature, bins, leaf_value, scale,
                      cat_set=None, packed: Optional[PackedTrees] = None,
                      kernel: CudaKernel = SCORE_KERNEL) -> torch.Tensor:
    """(n, d) bins -> (n, C) f32 sum over trees of ``scale_t * leaf_value``.

    ``binned`` is an int8/int16/int32 tensor on the device that scores; the
    tree arrays (numpy or tensors) are ``parent``/``feature``/``bins``
    (T, C, S) int, ``leaf_value`` (T, C, S+1) f32, ``scale`` (T,), which is
    rounded to f32 as the reference does, and ``cat_set`` (T, C, S, B) int8
    or None. ``packed`` (from :func:`pack_trees` of the same trees, on the
    same device) saves packing them again at every call. ``kernel`` is the
    binding that launches B and counts it (another model's use of B, such
    as the isolation forest's, keeps its own count)."""
    _check(binned, parent, feature, bins, cat_set, packed)
    T, C, S = np.shape(parent)
    if np.shape(leaf_value) != (T, C, S + 1) or np.shape(scale) != (T,):
        raise ValueError(f"leaf_value must be ({T}, {C}, {S + 1}) and scale ({T},), "
                         f"got {np.shape(leaf_value)} and {np.shape(scale)}")
    dev = binned.device
    if dev.type == "cpu":
        return raw_scores_plain(binned, parent, feature, bins, leaf_value, scale, cat_set)
    if packed is None:
        packed = pack_trees(parent, feature, bins, cat_set, device=dev)
    binned = binned.contiguous()
    n, d = binned.shape
    if n == 0 or T == 0:
        return torch.zeros(n, C, dtype=torch.float32, device=dev)
    out = torch.empty(n, C, dtype=torch.float32, device=dev)
    lv = torch.as_tensor(leaf_value, dtype=torch.float32, device=dev).contiguous()
    sc = torch.as_tensor(scale, device=dev).to(torch.float32).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        kernel(binned.data_ptr(), binned.element_size(), n, d,
               packed.nodes.data_ptr(), packed.units, int(packed.narrow),
               lv.data_ptr(), sc.data_ptr(),
               T, C, S, packed.cat_bins, out.data_ptr(), stream)
    return out


def device_leaf_indices(binned: torch.Tensor, parent, feature, bins, cat_set=None,
                        packed: Optional[PackedTrees] = None) -> torch.Tensor:
    """(n, d) bins -> (T, C, n) int32 leaf index of every row in every tree,
    with the arguments of :func:`device_raw_scores`."""
    _check(binned, parent, feature, bins, cat_set, packed)
    T, C, S = np.shape(parent)
    dev = binned.device
    if dev.type == "cpu":
        return leaf_indices_plain(binned, parent, feature, bins, cat_set)
    if packed is None:
        packed = pack_trees(parent, feature, bins, cat_set, device=dev)
    binned = binned.contiguous()
    n, d = binned.shape
    out = torch.empty(T, C, n, dtype=torch.int32, device=dev)
    if n == 0 or T == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        LEAF_KERNEL(binned.data_ptr(), binned.element_size(), n, d,
                    packed.nodes.data_ptr(), packed.units, int(packed.narrow), T, C, S,
                    packed.cat_bins,
                    out.data_ptr(), stream)
    return out


# ---------------------------------------------------------------------------------
# Device binning (kernel D)
# ---------------------------------------------------------------------------------

def cats_f32_representable(mapper) -> bool:
    """True when every category value survives an f32 round trip: the
    precondition for binning categories on the device."""
    for vals in mapper.cat_values.values():
        v64 = np.asarray(vals, dtype=np.float64)
        if not np.array_equal(v64.astype(np.float32).astype(np.float64), v64):
            return False
    return True


def pack_feature_table(mapper):
    """Per-feature bin tables -> padded (d, Emax) f32 table, (d,) int32
    lengths and (d,) int8 categorical flags (the reference's
    ``pack_feature_table``, ``device_predict.py:150-206``).

    Numeric rows hold the upper edges, categorical rows the sorted category
    values; padding is +inf, which no finite value exceeds. The f64 edges
    are rounded DOWN to f32 (never up): for an f32 value ``v``,
    ``floor_f32(e) < v`` iff ``e < v``, so counting the rounded edges below
    ``v`` gives the host's bin. Category values must be exactly f32
    (check :func:`cats_f32_representable` first); a lossy one raises."""
    edges = mapper.upper_edges
    sizes = [len(mapper.cat_values[j]) if j in mapper.cat_values else len(e)
             for j, e in enumerate(edges)]
    emax = max(max(sizes), 1)
    out = np.full((len(edges), emax), np.inf, dtype=np.float32)
    lens = np.empty(len(edges), dtype=np.int32)
    cat_flags = np.zeros(len(edges), dtype=np.int8)
    for j, e in enumerate(edges):
        if j in mapper.cat_values:
            vals = np.asarray(mapper.cat_values[j], dtype=np.float64)
            v32 = vals.astype(np.float32)
            if not np.array_equal(v32.astype(np.float64), vals):
                raise ValueError(f"categorical feature {j} has values that are not "
                                 "exactly f32; device binning would mis-code them")
            out[j, : len(vals)] = v32
            lens[j] = len(vals)
            cat_flags[j] = 1
            continue
        e64 = np.asarray(e, dtype=np.float64)
        e32 = e64.astype(np.float32)
        out[j, : len(e)] = np.where(e32.astype(np.float64) > e64,
                                    np.nextafter(e32, np.float32(-np.inf)), e32)
        lens[j] = len(e)
    return out, lens, cat_flags


def device_bin_cat_plain(x: torch.Tensor, table: torch.Tensor, lens: torch.Tensor,
                         cat_flags: torch.Tensor, missing_bin: int,
                         out_dtype=torch.int32) -> torch.Tensor:
    """Plain PyTorch version: the reference's broadcast compare, in row chunks.

    Numeric: the count of table entries below ``v``, clamped to ``len - 1``;
    categorical: that count where an entry equals ``v`` (count below !=
    count at or below), else the missing bin; non-finite -> missing bin."""
    n, d = x.shape
    out = torch.empty(n, d, dtype=out_dtype, device=x.device)
    has_cat = bool((cat_flags > 0).any())
    lens = lens.to(torch.int64)
    step = max(1, (1 << 24) // max(table.numel(), 1))
    for i in range(0, n, step):
        xc = x[i:i + step]
        lt = (table[None] < xc[:, :, None]).sum(-1)
        bins = torch.minimum(lt, lens[None] - 1)
        if has_cat:
            le = (table[None] <= xc[:, :, None]).sum(-1)
            cat_bins = torch.where(lt != le, lt, missing_bin)
            bins = torch.where(cat_flags[None] > 0, cat_bins, bins)
        out[i:i + step] = torch.where(torch.isfinite(xc), bins, missing_bin).to(out_dtype)
    return out


def device_bin_cat(x: torch.Tensor, table: torch.Tensor, lens: torch.Tensor,
                   cat_flags: torch.Tensor, missing_bin: int,
                   out_dtype=torch.int32) -> torch.Tensor:
    """(n, d) f32 rows -> (n, d) bins of ``out_dtype`` (int8, int16 or int32).

    ``table`` (d, Emax) f32, ``lens`` (d,) int32 and ``cat_flags`` (d,) int8
    from :func:`pack_feature_table`, on ``x``'s device. Equal to
    ``BinMapper.transform`` for f32 values. CPU tensors take the plain
    version; CUDA tensors launch kernel D."""
    if x.dim() != 2 or x.dtype != torch.float32:
        raise TypeError(f"x must be a 2-D float32 tensor, got {x.dtype} of shape "
                        f"{tuple(x.shape)}")
    n, d = x.shape
    if (table.dim() != 2 or table.shape[0] != d or table.dtype != torch.float32
            or lens.shape != (d,) or lens.dtype != torch.int32
            or cat_flags.shape != (d,) or cat_flags.dtype != torch.int8):
        raise TypeError("table must be (d, Emax) float32, lens (d,) int32 and "
                        "cat_flags (d,) int8")
    if out_dtype not in (torch.int8, torch.int16, torch.int32):
        raise TypeError(f"out_dtype must be int8, int16 or int32, got {out_dtype}")
    if not all(t.device == x.device for t in (table, lens, cat_flags)):
        raise ValueError("x, table, lens and cat_flags must lie on one device")
    if x.device.type == "cpu":
        return device_bin_cat_plain(x, table, lens, cat_flags, missing_bin, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    x, table = x.contiguous(), table.contiguous()
    if x.data_ptr() % 16:  # the kernel reads x 16 bytes at a time
        x = x.clone()
    out = torch.empty(n, d, dtype=out_dtype, device=x.device)
    if n == 0 or d == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        BIN_KERNEL(x.data_ptr(), table.data_ptr(), lens.data_ptr(), cat_flags.data_ptr(),
                   int(table.shape[1]), out.data_ptr(), n, d, out.element_size(),
                   int(missing_bin), stream)
    return out
