"""Leaf-wise tree growth — port of the dense branch of ``synapseml_tpu/gbdt/grow.py``.

Single device, dense (n, d) bins, numeric and categorical splits (no voting,
no leaf-local gathers). The algorithm is the reference's:

- ``num_leaves`` leaf slots and ``num_leaves - 1`` split steps; a step whose
  best gain is not above ``min_gain_to_split`` is inert and records parent -1;
- the tree is a replay list of splits (parent leaf, feature, bin): split ``s``
  turns leaf ``parent[s]`` into (``parent[s]``, ``s + 1``), rows with
  ``bin > bin[s]`` going right; a categorical split has ``bin == -1`` and
  sends left the rows whose bin is in its category set ``cat_set[s]``;
- leaf-wise: each step splits the best-gain leaf anywhere in the tree;
- parent subtraction: each step builds ONE histogram (the new right child,
  kernel A through :func:`~.histogram.histogram`) and derives the left side
  as parent minus child;
- the search for each leaf's best split is kernel E
  (:func:`~.split_search.split_search`) on the GPU.

The step loop never reads a value back to the host, so on the GPU a whole
tree is queued without a synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .histogram import histogram
from .split_search import _thresh_l1, category_key, split_search

__all__ = ["TreeConfig", "GrownTree", "grow_tree", "left_set", "predict_binned"]


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


def left_set(row: torch.Tensor, is_cat, b, cfg: TreeConfig) -> torch.Tensor:
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


def grow_tree(binned: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              row_weight: torch.Tensor, feature_mask: torch.Tensor, cfg: TreeConfig,
              cat_mask: Optional[torch.Tensor] = None):
    """Grow one tree. Returns (GrownTree, node_of_row (n,) int32).

    ``binned`` (n, d) int8/int16/int32; ``grad``/``hess``/``row_weight`` (n,)
    f32; ``feature_mask`` (d,) f32 in {0, 1}; ``cat_mask`` (d,) f32 in {0, 1}
    marks the categorical features (None: all numeric), and then the tree
    carries ``cat_set``. All on one device."""
    n, d = binned.shape
    L, B = cfg.num_leaves, cfg.n_bins
    l1, l2 = cfg.lambda_l1, cfg.lambda_l2
    dev = binned.device
    has_cat = cat_mask is not None
    pos = torch.arange(B, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)

    def hist_of(weight):
        return histogram(binned, grad, hess, weight, B)

    def split_detail(hists, l, f_sel, b_sel):
        """(B,) left membership of the chosen split and its categorical flag."""
        if not has_cat:
            return pos <= b_sel, torch.zeros((), dtype=torch.bool, device=dev)
        is_cat = cat_mask[f_sel] > 0
        return left_set(hists[l, f_sel], is_cat, b_sel, cfg), is_cat

    root = hist_of(row_weight)
    hists = torch.zeros((L, d, B, 3), dtype=torch.float32, device=dev)
    hists[0] = root
    node = torch.zeros(n, dtype=torch.int32, device=dev)
    parent = torch.full((L - 1,), -1, dtype=torch.int32, device=dev)
    feat = torch.zeros(L - 1, dtype=torch.int32, device=dev)
    bin_ = torch.zeros(L - 1, dtype=torch.int32, device=dev)
    gains = torch.zeros(L - 1, dtype=torch.float32, device=dev)
    cat_sets = torch.zeros((L - 1, B), dtype=torch.int8, device=dev) if has_cat else None
    depth = torch.zeros(L, dtype=torch.int32, device=dev)
    min_gain = max(cfg.min_gain_to_split, 0.0)

    for s in range(L - 1):
        leaf_gain, leaf_f, leaf_b = split_search(hists, feature_mask, cat_mask, s + 1, cfg)
        if cfg.max_depth > 0:
            leaf_gain = torch.where(depth < cfg.max_depth, leaf_gain, neg_inf)
        l = torch.argmax(leaf_gain)
        g_best = leaf_gain[l]
        ok = g_best > min_gain
        f_sel = leaf_f[l].to(torch.int64)
        b_sel = leaf_b[l].to(torch.int64)
        in_set, is_cat = split_detail(hists, l, f_sel, b_sel)
        col = torch.index_select(binned, 1, f_sel.reshape(1))[:, 0]
        go_left = in_set[col.to(torch.int64)]
        went_right = (node == l) & ~go_left & ok
        node = torch.where(went_right, torch.tensor(s + 1, dtype=torch.int32, device=dev),
                           node)
        child = hist_of(row_weight * went_right.to(torch.float32))
        updated = hists.clone()
        updated[s + 1] = child
        updated.index_add_(0, l.reshape(1), -child[None])
        hists = torch.where(ok, updated, hists)
        parent[s] = torch.where(ok, l, -1).to(torch.int32)
        feat[s] = f_sel.to(torch.int32)
        bin_[s] = torch.where(is_cat, -1, b_sel).to(torch.int32)
        gains[s] = torch.where(ok, g_best, 0.0).to(torch.float32)
        if has_cat:
            cat_sets[s] = (in_set & is_cat & ok).to(torch.int8)
        child_depth = torch.where(ok, depth[l] + 1, depth[l]).to(torch.int32)
        new_depth = depth.clone()
        new_depth[s + 1] = child_depth
        new_depth.index_copy_(0, l.reshape(1), child_depth.reshape(1))
        depth = torch.where(ok, new_depth, depth)

    # leaf totals: the bins of any one feature cover every row exactly once
    G_leaf = hists[:, 0, :, 0].sum(-1)
    H_leaf = hists[:, 0, :, 1].sum(-1)
    leaf_value = -_thresh_l1(G_leaf, l1) / (H_leaf + l2)
    leaf_value = torch.where(H_leaf > 0, leaf_value, 0.0)
    if cfg.max_delta_step > 0:
        leaf_value = torch.clamp(leaf_value, -cfg.max_delta_step, cfg.max_delta_step)
    return GrownTree(parent, feat, bin_, gains, leaf_value, H_leaf, cat_sets), node


def predict_binned(tree: GrownTree, binned: torch.Tensor) -> torch.Tensor:
    """Replay the splits over a binned matrix -> leaf index per row (n,) int32.

    With ``tree.cat_set``, a split with ``bin < 0`` is categorical: a row goes
    left when ``cat_set[s, col] > 0``, indexed as the reference's
    ``jnp.take`` does (a negative ``col`` counts from the end; one outside
    ``[-B, B)`` is in no set)."""
    n = binned.shape[0]
    node = torch.zeros(n, dtype=torch.int32, device=binned.device)
    for s in range(tree.parent.shape[0]):
        p = tree.parent[s]
        col = torch.index_select(binned, 1, tree.feature[s].reshape(1).long())[:, 0]
        col = col.to(torch.int64)
        go_left = col <= tree.bin[s]
        if tree.cat_set is not None:
            B = tree.cat_set.shape[-1]
            idx = torch.where(col < 0, col + B, col)
            inside = (idx >= 0) & (idx < B)
            in_set = inside & (tree.cat_set[s][idx.clamp(0, B - 1)] > 0)
            go_left = torch.where(tree.bin[s] < 0, in_set, go_left)
        go_right = (node == p) & ~go_left & (p >= 0)
        node = torch.where(go_right, s + 1, node).to(torch.int32)
    return node
