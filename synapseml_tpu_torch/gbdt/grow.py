"""Leaf-wise tree growth — port of the dense branch of ``synapseml_tpu/gbdt/grow.py``.

Dense (n, d) bins, numeric and categorical splits, on one device or over
a mesh (below). The algorithm is the reference's:

- ``num_leaves`` leaf slots and ``num_leaves - 1`` split steps; a step whose
  best gain is not above ``min_gain_to_split`` is inert and records parent -1;
- the tree is a replay list of splits (parent leaf, feature, bin): split ``s``
  turns leaf ``parent[s]`` into (``parent[s]``, ``s + 1``), rows with
  ``bin > bin[s]`` going right; a categorical split has ``bin == -1`` and
  sends left the rows whose bin is in its category set ``cat_set[s]``;
- leaf-wise: each step splits the best-gain leaf anywhere in the tree;
- parent subtraction over a row partition: the rows stay grouped by leaf
  in a :class:`~.partition.RowPartition` (kernel P, LightGBM's
  ``DataPartition``), each step reads only the split leaf's rows, builds
  ONE histogram, the smaller child's (kernel A's row-list entry,
  :func:`~.histogram.histogram_rows`), and takes the sibling as parent minus
  child: the reference's ``leaf_local`` growth (``leaf_hist_local``,
  ``grow.py:384-414``), at every row count (the reference falls back to its
  full pass at 2,048 rows and below, where its power-of-two buffers buy
  nothing; the port reads the child's size on the device and needs no
  buffer). The step ends in one epilogue launch (:func:`~.histogram.sibling`):
  the sibling by subtraction and both children written into the table.
  Wherever every histogram cell is exact in any order, the trees
  are those of the reference's full pass too (parent minus the smaller
  child IS the other child). That holds when the gradients are finite and
  every weighted product ``g * w`` and ``h * w`` stays on
  ``boost._preround``'s grid: weights in {0, 1} (bagging) or a power of two
  (GOSS's default amplification, 8). Otherwise (GOSS at, say,
  ``top_rate=0.2, other_rate=0.3``: amplification 8/3) cells round, and the
  trees are the reference's ``leaf_local`` ones, not its full pass's: leaf
  values a few ulps apart (1.3e-6 seen), and a split can move where two
  gains tie within that. A NaN gradient reaches the root histogram and
  leaves every step inert on both reference paths; an infinite one can give
  inf - inf in the child taken by subtraction, as in the reference's
  ``leaf_local``;
- the decision half of each step (rescore the leaves the last step changed,
  cap the depth, choose the leaf, write the record and the left set) is
  kernel E's step entry (:meth:`~.split_search.SplitWorkspace.step`), one
  launch a step on the GPU.

The step loop never reads a value back to the host, so on the GPU a whole
tree is queued without a synchronisation.

On a mesh (a :class:`TreeMesh`, made by ``boost.train`` over a
:class:`~synapseml_tpu_torch.runtime.layout.SpecLayout`; the reference's
``axis_name`` / ``model_axis_name``, ``grow.py:119-450``) each rank holds a
block of the rows and every histogram the step reads is all-reduced
(:mod:`~synapseml_tpu_torch.runtime.collectives`), so every rank takes the
same decisions from the same table:

- data-parallel: the root histogram is all-reduced; a step runs E's step
  entry on that table, kernel P's mesh entry (routing and local counts),
  one all-reduce of the two counts, P's pick (the globally smaller child),
  A's row list over that child's LOCAL rows, one all-reduce of the child,
  then the epilogue. Pre-rounded sums are exact in any order, so the
  trees are the single-device ones bit for bit;
- feature-parallel (a model axis of size > 1): each rank histograms only
  its block of columns (a contiguous copy made once a fit,
  ``TreeMesh.binned_block``) into its slice of the child, and the one
  all-reduce over both axes assembles the (d, B, 3) child (the blocks are
  disjoint). Routing reads the full-width bins; the counts are reduced
  over the data axis only (ranks of one data coordinate hold the same
  rows);
- voting-parallel (:func:`_grow_tree_voting`): histograms stay local and
  each step's splits come from :func:`~.split_search.vote_splits`; the
  smaller child is a local choice (P's one-launch step), as in the
  reference, which all-reduces counts only in data mode.

Sparse (CSR) input grows through :func:`grow_tree_sparse`, the port of the
reference's ``_grow_tree_sparse`` (``grow.py:457-775``): at
hashed-text width an (L, d, B, 3) table is gigabytes, so it keeps each
leaf's best split (gain, feature, bin), its G and H totals and its depth,
and rebuilds the two children's (2, d, B, 3) histograms of each split with
kernel G (:mod:`.sparse`): only the smaller child's when the split leaf's
own histogram is kept from the step before, the other then by subtraction
(the reference's half pass, one path for every sparse fit); kernel E's
full-table entry finds each child's best split. On a mesh the half side
comes from the all-reduced member counts and G sums it with no parent
(:func:`~.sparse.sparse_hist_mesh`); both slots and the totals are
all-reduced in one collective, then the sibling is the kept global parent
minus the summed side. Voting sums both sides locally and votes
(``grow.py:554-571``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..runtime.collectives import all_reduce
from .histogram import histogram, histogram_rows, sibling
from .partition import RowPartition
from .sparse import (SparseBinned, leaf_feature_hist, sparse_column, sparse_hist,
                     sparse_hist_mesh)
from .split_search import SplitWorkspace, _thresh_l1, left_set, split_search, vote_splits

__all__ = ["TreeConfig", "GrownTree", "TreeMesh", "grow_tree", "grow_tree_sparse",
           "finish_tree", "left_set", "predict_binned"]


class TreeConfig(NamedTuple):
    """Growth hyperparameters (the reference's ``TreeConfig``, dense subset)."""

    n_bins: int
    num_leaves: int = 31
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: float = 20.0
    min_sum_hessian: float = 1e-3
    min_gain_to_split: float = 0.0
    cat_smooth: float = 10.0
    max_cat_threshold: int = 32
    max_depth: int = -1          # <= 0: unlimited
    max_delta_step: float = 0.0  # > 0: clamp leaf outputs


class TreeMesh(NamedTuple):
    """How the trees of a fit grow over a mesh: ``layout`` (a
    :class:`~synapseml_tpu_torch.runtime.layout.SpecLayout`), ``voting``
    (PV-tree with ``top_k`` votes a leaf), and for feature-parallel
    histograms this rank's column ``block`` (start, stop) and the
    contiguous copy of those columns of the rank's bins,
    ``binned_block``."""

    layout: object
    voting: bool = False
    top_k: int = 20
    block: Optional[tuple] = None
    binned_block: Optional[torch.Tensor] = None


class GrownTree(NamedTuple):
    """Replay-list tree: split ``s`` turns leaf ``parent[s]`` into (parent[s], s+1)."""

    parent: torch.Tensor      # (L-1,) int32; -1 = inert step
    feature: torch.Tensor     # (L-1,) int32
    bin: torch.Tensor         # (L-1,) int32; 'bin <= b goes left', -1: categorical
    gain: torch.Tensor        # (L-1,) f32
    leaf_value: torch.Tensor  # (L,) f32 (unshrunk)
    leaf_hess: torch.Tensor   # (L,) f32
    # (L-1, B) int8 left-going category membership of the splits with
    # bin < 0; None: every split is numeric
    cat_set: Optional[torch.Tensor] = None


def grow_tree(binned: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              row_weight: torch.Tensor, feature_mask: torch.Tensor, cfg: TreeConfig,
              cat_mask: Optional[torch.Tensor] = None,
              workspace: Optional[SplitWorkspace] = None,
              partition: Optional[RowPartition] = None,
              mesh: Optional[TreeMesh] = None):
    """Grow one tree. Returns (GrownTree, node_of_row (n,) int32).

    ``binned`` (n, d) int8/int16/int32; ``grad``/``hess``/``row_weight`` (n,)
    f32; ``feature_mask`` (d,) f32 in {0, 1}; ``cat_mask`` (d,) f32 in {0, 1}
    marks the categorical features (None: all numeric), and then the tree
    carries ``cat_set``. All on one device. ``workspace``: kernel E's
    :class:`~.split_search.SplitWorkspace` made for the same ``d``, masks,
    ``cfg`` and device (a fit makes one and passes it to each tree); None
    makes one for this tree. ``partition``: the fit's
    :class:`~.partition.RowPartition` for ``n`` rows and ``cfg.num_leaves``
    leaves on the same device (None makes one for this tree). ``mesh``: a
    :class:`TreeMesh`; the arguments are then this rank's rows (module
    docstring)."""
    n, d = binned.shape
    L, B = cfg.num_leaves, cfg.n_bins
    dev = binned.device
    ws = workspace if workspace is not None else SplitWorkspace(d, feature_mask, cat_mask,
                                                                 cfg, dev)
    if ws.hists.shape != (L, d, B, 3) or ws.hists.device != dev:
        raise ValueError(f"workspace made for {tuple(ws.hists.shape)} histograms on "
                         f"{ws.hists.device}, not ({L}, {d}, {B}, 3) on {dev}")
    hists = ws.hists
    part = partition if partition is not None else RowPartition(n, L, dev)
    if mesh is not None and mesh.voting:
        if mesh.block is not None:
            raise ValueError("parallelism='voting' keeps histograms local by design; it "
                             "composes with a data axis only (model axis size 1)")
        return _grow_tree_voting(binned, grad, hess, row_weight, feature_mask, cfg,
                                 cat_mask, ws, part, mesh)
    rec = ws.begin_tree()
    node = torch.zeros(n, dtype=torch.int32, device=dev)
    part.begin_tree()
    if mesh is not None:
        _grow_steps_mesh(binned, grad, hess, row_weight, cfg, ws, part, node, mesh)
        return finish_tree(hists, rec, cfg), node
    hists[0] = histogram(binned, grad, hess, row_weight, B)
    for s in range(L - 1):
        ws.step(s)  # kernel E: rescore, choose, write the record and ws.in_set
        part.split(s, binned, node, ws.choice, ws.ok, ws.in_set)  # kernel P
        # kernel A over the smaller child's rows, into ws.small_hist (zero)
        histogram_rows(binned, grad, hess, row_weight, B, part.ids, part.small,
                       out=ws.small_hist)
        # the epilogue: the sibling, both children into hists, small_hist
        # zeroed; an inert step (P records an empty child on the right) leaves
        # leaf s + 1 empty and the split leaf as it was (x - +0.0 == x)
        sibling(hists, ws.small_hist, ws.leaf, part.smaller_right, s)
    return finish_tree(hists, rec, cfg), node


def _grow_steps_mesh(binned, grad, hess, row_weight, cfg: TreeConfig, ws: SplitWorkspace,
                     part: RowPartition, node: torch.Tensor, mesh: TreeMesh) -> None:
    """The root and the split steps of a data- or feature-parallel tree
    (module docstring): per step E, P's mesh entry, the counts'
    all-reduce, P's pick, A's row list, the child's all-reduce, the
    epilogue. Nothing is read back to the host."""
    lay, B, hists = mesh.layout, cfg.n_bins, ws.hists
    if mesh.block is not None:  # feature-parallel: this rank's columns, both axes
        lo, hi = mesh.block
        hist_bins, small, axes = mesh.binned_block, ws.small_hist[lo:hi], ("data", "model")
        hists[0].zero_()
        hists[0, lo:hi] = histogram(hist_bins, grad, hess, row_weight, B)
    else:
        hist_bins, small, axes = binned, ws.small_hist, ("data",)
        hists[0] = histogram(binned, grad, hess, row_weight, B)
    all_reduce(hists[0], lay, "sum", axes)
    for s in range(cfg.num_leaves - 1):
        ws.step(s)  # kernel E on the all-reduced table every rank holds
        part.split(s, binned, node, ws.choice, ws.ok, ws.in_set, mesh=True)
        all_reduce(part.counts, lay, "sum", ("data",))  # the rows of a data coordinate
        part.pick(s, ws.choice, ws.ok)  # the globally smaller child's local rows
        histogram_rows(hist_bins, grad, hess, row_weight, B, part.ids, part.small, out=small)
        all_reduce(ws.small_hist, lay, "sum", axes)
        sibling(hists, ws.small_hist, ws.leaf, part.smaller_right, s)


def _grow_tree_voting(binned, grad, hess, row_weight, feature_mask, cfg: TreeConfig,
                      cat_mask, ws: SplitWorkspace, part: RowPartition, mesh: TreeMesh):
    """Voting-parallel growth (the reference's ``voting`` branch of
    ``grow_tree``): the (L, d, B, 3) table holds this rank's LOCAL
    histograms; each step scores every active leaf by
    :func:`~.split_search.vote_splits`, chooses the leaf on the device, sets
    the workspace's ``choice`` / ``ok`` / ``in_set`` (the left set of a
    categorical split from the leaf's all-reduced row of the feature) and
    runs P's one-launch step (the LOCAL smaller child), A's row list and the
    epilogue. Leaf values come from the all-reduced leaf totals."""
    n, d = binned.shape
    L, B = cfg.num_leaves, cfg.n_bins
    dev, lay = binned.device, mesh.layout
    hists = ws.hists
    has_cat = cat_mask is not None
    part.begin_tree()
    hists[0] = histogram(binned, grad, hess, row_weight, B)
    node = torch.zeros(n, dtype=torch.int32, device=dev)
    parent = torch.full((L - 1,), -1, dtype=torch.int32, device=dev)
    feat = torch.zeros(L - 1, dtype=torch.int32, device=dev)
    bin_ = torch.zeros(L - 1, dtype=torch.int32, device=dev)
    gains = torch.zeros(L - 1, device=dev)
    cat_sets = torch.zeros((L - 1, B), dtype=torch.int8, device=dev) if has_cat else None
    depth = torch.zeros(L, dtype=torch.int32, device=dev)
    pos = torch.arange(B, device=dev)
    not_cat = torch.zeros(1, dtype=torch.bool, device=dev)
    min_gain = max(cfg.min_gain_to_split, 0.0)
    for s in range(L - 1):
        gain, f_best, b_best = vote_splits(hists[:s + 1], feature_mask, cat_mask, cfg, lay,
                                           mesh.top_k)
        if cfg.max_depth > 0:
            gain = torch.where(depth[:s + 1] < cfg.max_depth, gain, float("-inf"))
        l = torch.argmax(gain, dim=0, keepdim=True)
        g_best = gain[l]
        ok = g_best > min_gain
        f_sel, b_sel = f_best[l].long(), b_best[l]
        if has_cat:
            is_cat = cat_mask[f_sel] > 0
            row = all_reduce(hists[l, f_sel].contiguous(), lay, "sum", ("data",))[0]
            in_set = left_set(row, is_cat, b_sel, cfg)
        else:
            is_cat, in_set = not_cat, pos <= b_sel
        ws.choice.copy_(torch.cat([l, f_sel]))
        ws.ok.copy_(ok)
        ws.in_set.copy_(in_set & ok)
        parent[s:s + 1] = torch.where(ok, l.to(torch.int32), -1)
        feat[s:s + 1] = f_sel.to(torch.int32)
        bin_[s:s + 1] = torch.where(is_cat, -1, b_sel)
        gains[s:s + 1] = torch.where(ok, g_best, 0.0)
        if has_cat:
            cat_sets[s] = (ws.in_set & is_cat).to(torch.int8)
        child = torch.where(ok, depth[l] + 1, depth[l])
        depth[s + 1:s + 2] = torch.where(ok, child, depth[s + 1:s + 2])
        depth.index_copy_(0, l, child)
        part.split(s, binned, node, ws.choice, ws.ok, ws.in_set)  # the local smaller child
        histogram_rows(binned, grad, hess, row_weight, B, part.ids, part.small,
                       out=ws.small_hist)
        sibling(hists, ws.small_hist, ws.leaf, part.smaller_right, s)
    tot = all_reduce(torch.stack([hists[:, 0, :, 0].sum(-1), hists[:, 0, :, 1].sum(-1)]),
                     lay, "sum", ("data",))
    return GrownTree(parent, feat, bin_, gains, _leaf_values(tot[0], tot[1], cfg), tot[1],
                     cat_sets), node


def _leaf_values(G_leaf: torch.Tensor, H_leaf: torch.Tensor, cfg: TreeConfig) -> torch.Tensor:
    leaf_value = -_thresh_l1(G_leaf, cfg.lambda_l1) / (H_leaf + cfg.lambda_l2)
    leaf_value = torch.where(H_leaf > 0, leaf_value, 0.0)
    if cfg.max_delta_step > 0:
        leaf_value = torch.clamp(leaf_value, -cfg.max_delta_step, cfg.max_delta_step)
    return leaf_value


def grow_tree_sparse(sb: SparseBinned, grad: torch.Tensor, hess: torch.Tensor,
                     row_weight: torch.Tensor, feature_mask: torch.Tensor, cfg: TreeConfig,
                     cat_mask: Optional[torch.Tensor] = None,
                     mesh: Optional[TreeMesh] = None):
    """Grow one tree over a :class:`~.sparse.SparseBinned` (the reference's
    ``_grow_tree_sparse``, ``grow.py:457``). Returns (GrownTree,
    node_of_row (n,) int32). ``mesh``: a :class:`TreeMesh`, ``sb`` and the
    arguments then this rank's rows (module docstring).

    Arguments as :func:`grow_tree`, in ``sb``'s compact bin space
    (``cfg.n_bins == sb.n_bins``). A step chooses the leaf of best gain
    among the leaves' summaries, routes its rows by the chosen feature's
    column (:func:`~.sparse.sparse_column`; a categorical split's left set
    from that leaf's histogram of the feature, :func:`~.sparse.leaf_feature_hist`),
    builds both children's histograms and the sides' totals (kernel G, one
    call) and takes each child's best split from them (kernel E's
    full-table entry, one launch over (2, d, B, 3)). When the split leaf is
    a child of the previous step, whose (2, d, B, 3) histograms are kept, G
    sums only its smaller child and writes the other as the kept histogram
    minus it (the reference's ``leaf_local`` half pass, ``grow.py:665-711``;
    G decides on the device, from the member counts); otherwise it sums
    both. The trees are the full pass's wherever histogram sums are exact
    (``kernel_cases.grow_sparse_full_pass``, the oracle, sums both children
    every step). Leaf values come from the sides' totals. Nothing is read back to the
    host: the chosen leaf and feature stay (1,) tensors on the device (an
    index by a 0-d device tensor would read it back)."""
    n, d, B, L = sb.n, sb.d, sb.n_bins, cfg.num_leaves
    if cfg.n_bins != B:
        raise ValueError(f"cfg.n_bins={cfg.n_bins} but the SparseBinned has {B} bins")
    dev = sb.device
    has_cat = cat_mask is not None
    lay = None if mesh is None else mesh.layout
    voting = mesh is not None and mesh.voting
    ghc = torch.stack([grad * row_weight, hess * row_weight, row_weight], dim=-1)
    panel = torch.cat([ghc, torch.zeros(n, 1, dtype=torch.float32, device=dev)],
                      dim=1).contiguous()
    # two (2, d, B, 3) histogram buffers, each followed by its (2, 3) side
    # totals, so that a mesh step all-reduces both in one collective
    cells = 2 * d * B * 3
    flat = [torch.empty(cells + 6, dtype=torch.float32, device=dev) for _ in range(2)]
    bufs = [f[:cells].view(2, d, B, 3) for f in flat]
    tots = [f[cells:].view(2, 3) for f in flat]
    # (half, slot, forced); filled on the device (a Python scalar assigned
    # into a CUDA tensor is a synchronising copy from the host)
    ctrl = torch.zeros(3, dtype=torch.int32, device=dev)
    ctrl[2:].fill_(-1)

    def children(out: torch.Tensor, f: torch.Tensor):
        """Both children's best splits from ``out``: under voting from the
        local histograms, after the all-reduce of the totals (the tail of
        ``f``); otherwise from the global ones."""
        if voting:
            all_reduce(f[cells:], lay, "sum", ("data",))
            return vote_splits(out, feature_mask, cat_mask, cfg, lay, mesh.top_k)
        return split_search(out, feature_mask, cat_mask, 2, cfg)

    side = torch.zeros(n, dtype=torch.int32, device=dev)
    sparse_hist(sb, panel, side, bufs[0], tots[0], ctrl)     # the root: every row left
    if lay is not None and not voting:
        all_reduce(flat[0], lay, "sum", ("data",))
    r_gain, r_feat, r_bin = children(bufs[0], flat[0])
    best_gain = torch.full((L,), float("-inf"), device=dev)
    best_gain[0] = r_gain[0]
    best_feat = torch.zeros(L, dtype=torch.int32, device=dev)
    best_feat[0] = r_feat[0]
    best_bin = torch.zeros(L, dtype=torch.int32, device=dev)
    best_bin[0] = r_bin[0]
    G_leaf = torch.zeros(L, device=dev)
    G_leaf[0] = tots[0][0, 0]
    H_leaf = torch.zeros(L, device=dev)
    H_leaf[0] = tots[0][0, 1]
    node = torch.zeros(n, dtype=torch.int32, device=dev)
    parent = torch.full((L - 1,), -1, dtype=torch.int32, device=dev)
    feat = torch.zeros(L - 1, dtype=torch.int32, device=dev)
    bin_ = torch.zeros(L - 1, dtype=torch.int32, device=dev)
    gains = torch.zeros(L - 1, device=dev)
    cat_sets = torch.zeros((L - 1, B), dtype=torch.int8, device=dev)
    depth = torch.zeros(L, dtype=torch.int32, device=dev)
    # the leaves whose histograms the kept buffer holds; the root split put
    # every row on side 0, so slot 0 is the root's histogram
    carry_ids = torch.zeros(2, dtype=torch.int64, device=dev)
    carry_ids[1:].fill_(-1)
    not_cat = torch.zeros((), dtype=torch.bool, device=dev)
    min_gain = max(cfg.min_gain_to_split, 0.0)
    for s in range(L - 1):
        leaf_gain = best_gain
        if cfg.max_depth > 0:
            leaf_gain = torch.where(depth < cfg.max_depth, leaf_gain, float("-inf"))
        l = torch.argmax(leaf_gain, dim=0, keepdim=True)
        g_best = leaf_gain[l]
        ok = g_best > min_gain
        f_sel, b_sel = best_feat[l].long(), best_bin[l]
        col = sparse_column(sb, f_sel, n)
        member = node == l
        if has_cat:
            is_cat = cat_mask[f_sel] > 0
            row = leaf_feature_hist(sb, f_sel, ghc, member)
            if lay is not None:
                all_reduce(row, lay, "sum", ("data",))
            in_set = left_set(row, is_cat, b_sel, cfg)
            go_left = torch.where(is_cat, in_set[col.long()], col <= b_sel)
        else:
            is_cat, in_set, go_left = not_cat, None, col <= b_sel
        node = torch.where(member & ~go_left & ok, s + 1, node)
        side = torch.where(member & ok, torch.where(go_left, 0, 1), 2).to(torch.int32)
        k_out, k_kept = (s + 1) % 2, s % 2
        out, kept, totals = bufs[k_out], bufs[k_kept], tots[k_out]
        hit = (l == carry_ids[0]) | (l == carry_ids[1])
        if voting:  # local histograms: both sides summed, nothing to subtract from
            ctrl[0:1].zero_()
            sparse_hist(sb, panel, side, out, totals, ctrl)
        elif lay is not None:
            # the half side from the GLOBAL member counts; G sums it with no
            # subtraction, and the sibling follows the all-reduce
            cnt = all_reduce(torch.stack([(side == 0).sum(), (side == 1).sum()]).to(
                torch.int32), lay, "sum", ("data",))
            ctrl.copy_(torch.cat([hit.to(torch.int32), (l != carry_ids[0]).to(torch.int32),
                                  torch.where(hit, (cnt[1:] <= cnt[:1]).to(torch.int32), -1)]))
            sparse_hist_mesh(sb, panel, side, out, totals, ctrl)
            all_reduce(flat[k_out], lay, "sum", ("data",))  # both slots and the totals
            # the sibling: the kept global parent minus the summed side
            summed = ctrl[2:].clamp(min=0).long()
            other = 1 - summed
            sib = kept.index_select(0, ctrl[1:2].long()) - out.index_select(0, summed)
            out.index_copy_(0, other, torch.where(hit, sib, out.index_select(0, other)))
        else:
            ctrl[:2] = torch.cat([hit, l != carry_ids[0]]).to(torch.int32)
            sparse_hist(sb, panel, side, out, totals, ctrl, kept)
        c_gain, c_feat, c_bin = children(out, flat[k_out])
        carry_ids = torch.where(ok, torch.cat([l, torch.full_like(l, s + 1)]), carry_ids)

        def upd(a, v0, v1):
            b = a.clone()
            b[l] = v0
            b[s + 1] = v1
            return torch.where(ok, b, a)

        best_gain = upd(best_gain, c_gain[0], c_gain[1])
        best_feat = upd(best_feat, c_feat[0], c_feat[1])
        best_bin = upd(best_bin, c_bin[0], c_bin[1])
        G_leaf = upd(G_leaf, totals[0, 0], totals[1, 0])
        H_leaf = upd(H_leaf, totals[0, 1], totals[1, 1])
        parent[s] = torch.where(ok, l, -1)
        feat[s] = f_sel
        bin_[s] = torch.where(is_cat, -1, b_sel)
        gains[s] = torch.where(ok, g_best, 0.0)
        if has_cat:
            cat_sets[s] = (in_set & is_cat & ok).to(torch.int8)
        child_depth = torch.where(ok, depth[l] + 1, depth[l])
        depth = upd(depth, child_depth, child_depth)
    return (GrownTree(parent, feat, bin_, gains, _leaf_values(G_leaf, H_leaf, cfg), H_leaf,
                      cat_sets if has_cat else None), node)


def finish_tree(hists: torch.Tensor, rec, cfg: TreeConfig) -> GrownTree:
    """The grown tree from the final (L, d, B, 3) histograms and kernel E's
    record: each leaf's value from its totals."""
    # leaf totals: the bins of any one feature cover every row exactly once
    G_leaf = hists[:, 0, :, 0].sum(-1)
    H_leaf = hists[:, 0, :, 1].sum(-1)
    return GrownTree(rec.parent, rec.feature, rec.bin, rec.gain,
                     _leaf_values(G_leaf, H_leaf, cfg), H_leaf, rec.cat_set)


def predict_binned(tree: GrownTree, binned) -> torch.Tensor:
    """Replay the splits over a binned matrix -> leaf index per row (n,) int32.

    ``binned``: (n, d) int bins, or a :class:`~.sparse.SparseBinned`, whose
    columns come from :func:`~.sparse.sparse_column` (the tree's bins are in
    its compact space).

    With ``tree.cat_set``, a split with ``bin < 0`` is categorical: a row goes
    left when ``cat_set[s, col] > 0``, indexed as the reference's
    ``jnp.take`` does (a negative ``col`` counts from the end; one outside
    ``[-B, B)`` is in no set). An inert step (parent -1) moves no row, since
    every row's node is >= 0. Reads nothing back to the host."""
    sparse = isinstance(binned, SparseBinned)
    n = binned.n if sparse else binned.shape[0]
    node = torch.zeros(n, dtype=torch.int32, device=binned.device)
    feats = tree.feature.long()
    for s in range(tree.parent.shape[0]):
        col = (sparse_column(binned, feats[s:s + 1], n) if sparse
               else torch.index_select(binned, 1, feats[s:s + 1])[:, 0])
        go_right = col > tree.bin[s]
        if tree.cat_set is not None:
            B = tree.cat_set.shape[-1]
            col = col.to(torch.int64)
            idx = torch.where(col < 0, col + B, col)
            inside = (idx >= 0) & (idx < B)
            in_set = inside & (tree.cat_set[s][idx.clamp(0, B - 1)] > 0)
            go_right = torch.where(tree.bin[s] < 0, ~in_set, go_right)
        node = torch.where((node == tree.parent[s]) & go_right, s + 1, node)
    return node
