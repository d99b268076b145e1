"""The split search and decision of a growth step (kernel E).

Port of ``synapseml_tpu/gbdt/grow.py`` ``_prefix_bins`` + ``gain_table`` +
``combined_gain`` + ``best_splits`` (non-voting branch, ``grow.py:95-116``,
``:252-313``) and of the decision half of its growth step (``:362-425``: the
depth cap, the argmax over leaves, ``split_detail`` and the step's record).
From the (L, d, B, 3) histograms of the leaves it finds, per leaf, the best
(gain, feature, bin):

- numeric features: entry ``b`` is the split 'bin <= b', from an inclusive
  prefix over bins;
- categorical features (``cat_mask``): the bins are ordered by
  G / (H + cat_smooth), descending and stable, and entry ``b`` is the set of
  the first ``b + 1`` bins in that order, at most ``max_cat_threshold``;
- the gain ``thresh_l1(GL)^2/(HL + l2) + thresh_l1(GR)^2/(HR + l2) -
  thresh_l1(G)^2/(H + l2)`` counts where ``b < B - 1``, both sides hold at
  least ``min_data_in_leaf`` rows and ``min_sum_hessian`` hessian, and the
  feature is in ``feature_mask``; elsewhere it is -inf;
- per leaf, the first maximum of the (d * B) table (a NaN counts as the
  maximum, as in ``torch.argmax`` and ``jnp.argmax``).

Two entries share ``csrc/split_search.cu``: :func:`split_search`, the whole
table (every leaf; leaves at or beyond ``n_active`` get gain -inf), and
:meth:`SplitWorkspace.step`, one growth step in one launch, which rescores
only the leaves the previous step changed and decides the split on the
device. CPU tensors take the plain versions (:func:`split_search_plain`, and
the same step bookkeeping over it). On gradients pre-rounded by
``boost._preround`` every prefix is exact in any order, and the kernel, which
rounds the gain as the torch ops do, gives the same bits.

:func:`vote_splits` is the voting-parallel search (PV-tree, the reference's
``best_splits`` voting branch, ``grow.py:300-347``): each rank scores its
LOCAL histograms per (leaf, feature) with the full-table entry, votes for
its ``top_k`` features a leaf, the votes are all-reduced, the ``2 top_k``
most voted features' histograms are all-reduced and scored again.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ..kernels.build import CudaKernel
from ..runtime.collectives import all_reduce

__all__ = ["split_search", "split_search_plain", "split_gains_plain", "category_key",
           "left_set", "vote_splits", "stable_top_k", "SplitWorkspace", "StepRecord",
           "SPLIT_KERNEL"]

_POINTERS = ("hists", "fmask", "cmask", "feat_gain", "feat_bin", "leaf_gain", "leaf_feat",
             "leaf_bin", "cat_left", "tickets", "parent", "feat", "bin", "gains", "cat_sets",
             "depth", "choice", "ok", "in_set")
_INTS = ("L", "d", "B", "n_active", "full", "max_depth", "max_cat", "device")
_FLOATS = ("l1", "l2", "min_data", "min_hess", "cat_smooth", "min_gain")


class _SplitArgs(ctypes.Structure):
    """``SplitArgs`` of ``csrc/split_search.cu``, field for field."""

    _fields_ = ([(n, ctypes.c_void_p) for n in _POINTERS] + [(n, ctypes.c_int) for n in _INTS]
                + [(n, ctypes.c_float) for n in _FLOATS])


SPLIT_KERNEL = CudaKernel(
    name="gbdt_split_search", source="split_search", symbol="smt_split_search",
    argtypes=[ctypes.POINTER(_SplitArgs), ctypes.c_int, ctypes.c_void_p],
    replaces="synapseml_tpu/gbdt/grow.py:300 (best_splits over gain_table, "
             "_prefix_bins :95; the step's decision :362-425)")


def category_key(G: torch.Tensor, H: torch.Tensor, cat_smooth: float) -> torch.Tensor:
    """Sort key of the categorical bins: -G / (H + cat_smooth), ascending and
    stable. Adding 0.0 turns -0.0 into +0.0, which a comparison sort treats
    as equal already; the kernel compares the same way."""
    return -(G / (H + cat_smooth)) + 0.0


def _thresh_l1(g, l1: float):
    return torch.sign(g) * torch.clamp(g.abs() - l1, min=0.0)


def left_set(row: torch.Tensor, is_cat, b, cfg) -> torch.Tensor:
    """(B,) left membership of split ``b`` of one leaf's (B, 3) histogram row
    (the reference's ``split_detail``): bins ``<= b`` for a numeric feature;
    for a categorical one, the bins of rank ``<= b`` in kernel E's order
    that hold rows of the leaf (an empty bin stays right, where unseen
    categories go)."""
    pos = torch.arange(row.shape[0], device=row.device)
    order = torch.argsort(category_key(row[:, 0], row[:, 1], cfg.cat_smooth), stable=True)
    rank = torch.empty_like(order)
    rank[order] = pos
    return torch.where(is_cat, (rank <= b) & (row[:, 2] > 0), pos <= b)


def split_gains_plain(hists: torch.Tensor, feature_mask: torch.Tensor, cat_mask, cfg):
    """(L, d, B) gain table: the reference's ``combined_gain``."""
    B = hists.shape[2]
    l1, l2 = cfg.lambda_l1, cfg.lambda_l2
    pos = torch.arange(B, device=hists.device)
    G, H, C = hists[..., 0], hists[..., 1], hists[..., 2]
    GT = G.sum(-1, keepdim=True)
    HT = H.sum(-1, keepdim=True)
    CT = C.sum(-1, keepdim=True)
    neg_inf = torch.tensor(float("-inf"), device=hists.device)

    def gain_term(g, h):
        return _thresh_l1(g, l1) ** 2 / (h + l2)

    def split_gain(cum, extra_valid):
        GL, HL, CL = cum[..., 0], cum[..., 1], cum[..., 2]
        GR, HR, CR = GT - GL, HT - HL, CT - CL
        g = gain_term(GL, HL) + gain_term(GR, HR) - gain_term(GT, HT)
        valid = ((pos < B - 1)
                 & (CL >= cfg.min_data_in_leaf) & (CR >= cfg.min_data_in_leaf)
                 & (HL >= cfg.min_sum_hessian) & (HR >= cfg.min_sum_hessian)
                 & extra_valid & (feature_mask[:, None] > 0))
        return torch.where(valid, g, neg_inf)

    gain = split_gain(torch.cumsum(hists, dim=-2), torch.ones((), dtype=torch.bool,
                                                               device=hists.device))
    if cat_mask is not None:
        order = torch.argsort(category_key(G, H, cfg.cat_smooth), dim=-1, stable=True)
        sorted_h = torch.take_along_dim(hists, order[..., None], dim=-2)
        gain_cat = split_gain(torch.cumsum(sorted_h, dim=-2),
                              pos + 1 <= cfg.max_cat_threshold)
        gain = torch.where(cat_mask[:, None] > 0, gain_cat, gain)
    return gain


def split_search_plain(hists: torch.Tensor, feature_mask: torch.Tensor, cat_mask,
                       n_active: int, cfg):
    """Plain PyTorch version: (L,) f32 best gain, (L,) int32 feature and bin."""
    L, d, B, _ = hists.shape
    flat = split_gains_plain(hists, feature_mask, cat_mask, cfg).reshape(L, d * B)
    neg_inf = torch.tensor(float("-inf"), device=hists.device)
    # torch.argmax and jnp.argmax both pick the FIRST maximal index (a NaN first)
    idx = torch.argmax(flat, dim=-1)
    best = flat.gather(1, idx[:, None])[:, 0]
    best = torch.where(torch.arange(L, device=hists.device) < n_active, best, neg_inf)
    return (best, torch.div(idx, B, rounding_mode="floor").to(torch.int32),
            (idx % B).to(torch.int32))


def _check(hists, feature_mask, cat_mask):
    if hists.dim() != 4 or hists.shape[-1] != 3 or hists.dtype != torch.float32:
        raise TypeError(f"hists must be (L, d, B, 3) float32, got {hists.dtype} of shape "
                        f"{tuple(hists.shape)}")
    d = hists.shape[1]
    for name, m in (("feature_mask", feature_mask), ("cat_mask", cat_mask)):
        if m is None:
            continue
        if m.shape != (d,) or m.dtype != torch.float32:
            raise TypeError(f"{name} must be ({d},) float32, got {m.dtype} of shape "
                            f"{tuple(m.shape)}")
        if m.device != hists.device:
            raise ValueError(f"hists on {hists.device} but {name} on {m.device}")
    if hists.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {hists.device}")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _kernel_args(hists, feature_mask, cat_mask, cfg, **pointers) -> _SplitArgs:
    L, d, B, _ = hists.shape
    return _SplitArgs(
        hists=hists.data_ptr(), fmask=feature_mask.data_ptr(), cmask=_ptr(cat_mask),
        **{k: _ptr(v) for k, v in pointers.items()}, L=L, d=d, B=B,
        max_depth=int(cfg.max_depth), max_cat=int(cfg.max_cat_threshold),
        device=hists.device.index, l1=cfg.lambda_l1, l2=cfg.lambda_l2,
        min_data=cfg.min_data_in_leaf, min_hess=cfg.min_sum_hessian,
        cat_smooth=cfg.cat_smooth, min_gain=max(cfg.min_gain_to_split, 0.0))


def split_search(hists: torch.Tensor, feature_mask: torch.Tensor, cat_mask, n_active: int,
                 cfg):
    """Best (gain, feature, bin) of each of the L leaves: (L,) f32, (L,) int32,
    (L,) int32.

    ``hists`` (L, d, B, 3) f32; ``feature_mask`` and ``cat_mask`` (d,) f32 in
    {0, 1} (``cat_mask`` None: every feature numeric); ``cfg`` a
    ``grow.TreeConfig``. CPU tensors take the plain version; CUDA tensors
    launch kernel E in its full mode (one block per (leaf, feature), the
    last of each leaf's blocks reducing the leaf)."""
    _check(hists, feature_mask, cat_mask)
    if hists.device.type == "cpu":
        return split_search_plain(hists, feature_mask, cat_mask, n_active, cfg)
    L, d, B, _ = hists.shape
    dev = hists.device
    hists = hists.contiguous()
    feature_mask = feature_mask.contiguous()
    cat_mask = None if cat_mask is None else cat_mask.contiguous()
    fbuf = torch.empty(L * d + L, dtype=torch.float32, device=dev)
    # feat_bin, leaf_feat, leaf_bin, then the tickets (0 between launches)
    ibuf = torch.zeros(L * d + 3 * L + 1, dtype=torch.int32, device=dev)
    gain, feat = fbuf[L * d:], ibuf[L * d:L * d + L]
    bins = ibuf[L * d + L:L * d + 2 * L]
    args = _kernel_args(hists, feature_mask, cat_mask, cfg, feat_gain=fbuf,
                        feat_bin=ibuf, leaf_gain=gain, leaf_feat=feat, leaf_bin=bins,
                        tickets=ibuf[L * d + 2 * L:])
    args.full, args.n_active = 1, int(n_active)
    SPLIT_KERNEL(ctypes.byref(args), 0, torch.cuda.current_stream(dev).cuda_stream)
    return gain, feat, bins


def _per_feature(hists: torch.Tensor, cat_mask: Optional[torch.Tensor], cfg):
    """Each (leaf, feature)'s best (gain, bin) of (N, k, B, 3) histograms,
    unmasked: the full-table entry over the table viewed as N * k
    one-feature leaves, once with every feature numeric and, when
    ``cat_mask`` is given, once with every feature categorical; ``cat_mask``
    (N, k) then picks each feature's. Returns ((N, k) f32, (N, k) int32)."""
    N, k, B, _ = hists.shape
    one = torch.ones(1, dtype=torch.float32, device=hists.device)
    view = hists.reshape(N * k, 1, B, 3)
    gain, _, bins = split_search(view, one, None, N * k, cfg)
    gain, bins = gain.view(N, k), bins.view(N, k)
    if cat_mask is not None:
        g_cat, _, b_cat = split_search(view, one, one, N * k, cfg)
        is_cat = cat_mask > 0
        gain = torch.where(is_cat, g_cat.view(N, k), gain)
        bins = torch.where(is_cat, b_cat.view(N, k), bins)
    return gain, bins


def stable_top_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of each row of ``x``, the lower
    index first among equal values (``lax.top_k``'s order)."""
    return torch.sort(x, dim=-1, descending=True, stable=True).indices[..., :k]


def vote_splits(hists: torch.Tensor, feature_mask: torch.Tensor, cat_mask, cfg, layout,
                top_k: int):
    """Voting-parallel best (gain, feature, bin) of each of N leaves from
    this rank's LOCAL (N, d, B, 3) histograms: (N,) f32, (N,) int32, (N,)
    int32, the same on every rank of ``layout``'s data axis.

    Per leaf, each rank votes for its ``min(top_k, d)`` best features
    (local gains); the votes are all-reduced and the ``min(2 top_k, d)``
    most voted (the lower index first among ties) are the candidates; their
    histograms are all-reduced and scored, and the leaf's best is the first
    maximum over (candidate, bin). The gains come from kernel E's
    full-table entry (:func:`_per_feature`). Two collectives."""
    N, d, B, _ = hists.shape
    k_local, k_global = min(top_k, d), min(2 * top_k, d)
    neg_inf = torch.tensor(float("-inf"), device=hists.device)
    gain, _ = _per_feature(hists, None if cat_mask is None else cat_mask.expand(N, d), cfg)
    gain = torch.where(feature_mask > 0, gain, neg_inf)
    votes = torch.zeros(N, d, dtype=torch.float32, device=hists.device)
    votes.scatter_add_(1, stable_top_k(gain, k_local),
                       torch.ones(N, k_local, dtype=torch.float32, device=hists.device))
    all_reduce(votes, layout, "sum", ("data",))
    sel = stable_top_k(votes, k_global)                                   # (N, 2k)
    cand = torch.gather(hists, 1, sel[:, :, None, None].expand(N, k_global, B, 3))
    all_reduce(cand, layout, "sum", ("data",))
    gain, bins = _per_feature(cand, None if cat_mask is None else cat_mask[sel], cfg)
    gain = torch.where(feature_mask[sel] > 0, gain, neg_inf)
    j = torch.argmax(gain, dim=1, keepdim=True)  # the first maximum, as jnp.argmax
    return (gain.gather(1, j)[:, 0], sel.gather(1, j)[:, 0].to(torch.int32),
            bins.gather(1, j)[:, 0].to(torch.int32))


class StepRecord(NamedTuple):
    """The (L - 1) splits of one tree, written by :meth:`SplitWorkspace.step`."""

    parent: torch.Tensor      # int32; -1 = inert step
    feature: torch.Tensor     # int32
    bin: torch.Tensor         # int32; -1: categorical
    gain: torch.Tensor        # f32; 0 on an inert step
    cat_set: Optional[torch.Tensor]  # (L - 1, B) int8, or None without cat_mask


class SplitWorkspace:
    """Kernel E's state for the trees of one fit, and its step entry.

    Holds the (L, d, B, 3) histograms of the tree being grown (``hists``; the
    grower writes leaf ``s + 1`` and the split leaf after each step), each
    (leaf, feature)'s and each leaf's best split from the step that last
    scored it, the per-leaf depth, and the outputs of the last decision:
    ``leaf`` and ``feature`` ((1,) int64 views of ``choice``), ``ok`` ((1,)
    bool) and ``in_set`` ((B,) bool, the left set of the split taken; all
    false on an inert step). Everything is allocated here, once; a tree
    takes a fresh :class:`StepRecord` from :meth:`begin_tree`.

    On the GPU the kernel's arguments are packed once (per tree, the
    record's pointers), so a step passes only ``s``, and its launches go to
    the stream current when the workspace was made. On the CPU each step
    runs the same bookkeeping over :func:`split_search_plain`."""

    def __init__(self, n_features: int, feature_mask: torch.Tensor,
                 cat_mask: Optional[torch.Tensor], cfg, device):
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        L, d, B = cfg.num_leaves, int(n_features), cfg.n_bins
        self.cfg = cfg
        self.hists = torch.empty((L, d, B, 3), dtype=torch.float32, device=dev)
        _check(self.hists, feature_mask, cat_mask)
        # the step's smaller child, added into by kernel A's row-list entry and
        # zeroed again by the sibling epilogue (histogram.sibling)
        self.small_hist = torch.zeros((d, B, 3), dtype=torch.float32, device=dev)
        self.fmask = feature_mask.contiguous()
        self.cmask = None if cat_mask is None else cat_mask.contiguous()
        fbuf = torch.empty(L * d + L, dtype=torch.float32, device=dev)
        # feat_bin, leaf_feat, leaf_bin, depth, then the tickets (0 between launches)
        ibuf = torch.zeros(L * d + 4 * L + 1, dtype=torch.int32, device=dev)
        self.leaf_gain, self.leaf_feat = fbuf[L * d:], ibuf[L * d:L * d + L]
        self.leaf_bin = ibuf[L * d + L:L * d + 2 * L]
        self.depth = ibuf[L * d + 2 * L:L * d + 3 * L]
        self.cat_left = (None if cat_mask is None
                         else torch.empty(L * d * B, dtype=torch.int8, device=dev))
        self.choice = torch.zeros(2, dtype=torch.int64, device=dev)
        self.leaf, self.feature = self.choice[0:1], self.choice[1:2]
        self.ok = torch.zeros(1, dtype=torch.bool, device=dev)
        self.in_set = torch.zeros(B, dtype=torch.bool, device=dev)
        self.record: Optional[StepRecord] = None
        self._bufs = (fbuf, ibuf)  # the views above point into these
        if dev.type == "cuda":
            self._args = _kernel_args(
                self.hists, self.fmask, self.cmask, cfg, feat_gain=fbuf, feat_bin=ibuf,
                leaf_gain=self.leaf_gain, leaf_feat=self.leaf_feat, leaf_bin=self.leaf_bin,
                cat_left=self.cat_left, tickets=ibuf[L * d + 3 * L:], depth=self.depth,
                choice=self.choice, ok=self.ok, in_set=self.in_set)
            self._args_ref = ctypes.byref(self._args)
            self._stream = torch.cuda.current_stream(dev).cuda_stream

    def begin_tree(self) -> StepRecord:
        """A fresh record for the next tree; its steps fill every entry."""
        L, B = self.cfg.num_leaves, self.cfg.n_bins
        dev = self.hists.device
        rec = torch.empty((3, L - 1), dtype=torch.int32, device=dev)
        self.record = StepRecord(
            rec[0], rec[1], rec[2], torch.empty(L - 1, dtype=torch.float32, device=dev),
            None if self.cmask is None else torch.empty((L - 1, B), dtype=torch.int8,
                                                        device=dev))
        if dev.type == "cuda":
            r = self.record
            self._args.parent, self._args.feat, self._args.bin = (
                r.parent.data_ptr(), r.feature.data_ptr(), r.bin.data_ptr())
            self._args.gains, self._args.cat_sets = r.gain.data_ptr(), _ptr(r.cat_set)
        return self.record

    def step(self, s: int) -> None:
        """Split step ``s`` (0 <= s < L - 1) of the current tree, after steps
        0..s-1: rescore the leaves step s - 1 changed, choose the split and
        write the record's entry ``s``, ``depth``, ``leaf``, ``feature``,
        ``ok`` and ``in_set``. One launch of kernel E on the GPU."""
        if self.hists.device.type == "cuda":
            SPLIT_KERNEL(self._args_ref, s, self._stream)
        else:
            self._step_plain(s)

    def _step_plain(self, s: int) -> None:
        cfg, rec = self.cfg, self.record
        if s == 0:
            self.depth.zero_()
            leaves = [0]
        else:
            p = int(rec.parent[s - 1])
            leaves = [s] if p < 0 else [s, p]
        idx = torch.tensor(leaves)
        g, f, b = split_search_plain(self.hists[idx], self.fmask, self.cmask, len(leaves), cfg)
        self.leaf_gain[idx], self.leaf_feat[idx], self.leaf_bin[idx] = g, f, b
        gain = self.leaf_gain[:s + 1]
        if cfg.max_depth > 0:
            gain = torch.where(self.depth[:s + 1] < cfg.max_depth, gain, float("-inf"))
        l = int(torch.argmax(gain))
        ok = bool(gain[l] > max(cfg.min_gain_to_split, 0.0))
        f_sel, b_sel = int(self.leaf_feat[l]), int(self.leaf_bin[l])
        is_cat = self.cmask is not None and bool(self.cmask[f_sel] > 0)
        in_set = left_set(self.hists[l, f_sel], torch.tensor(is_cat), b_sel, cfg) & ok
        rec.parent[s] = l if ok else -1
        rec.feature[s] = f_sel
        rec.bin[s] = -1 if is_cat else b_sel
        rec.gain[s] = gain[l] if ok else 0.0
        if rec.cat_set is not None:
            rec.cat_set[s] = in_set & is_cat
        if ok:
            self.depth[s + 1] = self.depth[l] = self.depth[l] + 1
        self.choice[0], self.choice[1] = l, f_sel
        self.ok[0] = ok
        self.in_set.copy_(in_set)
