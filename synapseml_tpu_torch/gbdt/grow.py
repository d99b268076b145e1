"""Leaf-wise tree growth — port of the dense branch of ``synapseml_tpu/gbdt/grow.py``.

Single device, dense (n, d) bins, numeric splits only (no categorical sets,
no voting, no leaf-local gathers). The algorithm is the reference's:

- ``num_leaves`` leaf slots and ``num_leaves - 1`` split steps; a step whose
  best gain is not above ``min_gain_to_split`` is inert and records parent -1;
- the tree is a replay list of splits (parent leaf, feature, bin): split ``s``
  turns leaf ``parent[s]`` into (``parent[s]``, ``s + 1``), rows with
  ``bin > bin[s]`` going right;
- leaf-wise: each step splits the best-gain leaf anywhere in the tree;
- parent subtraction: each step builds ONE histogram (the new right child,
  kernel A through :func:`~.histogram.histogram`) and derives the left side
  as parent minus child.

Split selection stays in plain PyTorch ops (``cumsum`` over bins, then
``argmax``). The step loop never reads a value back to the host, so on the
GPU a whole tree is queued without a synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .histogram import histogram

__all__ = ["TreeConfig", "GrownTree", "grow_tree", "predict_binned"]


class TreeConfig(NamedTuple):
    """Growth hyperparameters (the reference's ``TreeConfig``, dense subset)."""

    n_bins: int
    num_leaves: int = 31
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: float = 20.0
    min_sum_hessian: float = 1e-3
    min_gain_to_split: float = 0.0
    max_depth: int = -1          # <= 0: unlimited
    max_delta_step: float = 0.0  # > 0: clamp leaf outputs


class GrownTree(NamedTuple):
    """Replay-list tree: split ``s`` turns leaf ``parent[s]`` into (parent[s], s+1)."""

    parent: torch.Tensor      # (L-1,) int32; -1 = inert step
    feature: torch.Tensor     # (L-1,) int32
    bin: torch.Tensor         # (L-1,) int32; numeric split 'bin <= b goes left'
    gain: torch.Tensor        # (L-1,) f32
    leaf_value: torch.Tensor  # (L,) f32 (unshrunk)
    leaf_hess: torch.Tensor   # (L,) f32


def _thresh_l1(g, l1: float):
    return torch.sign(g) * torch.clamp(g.abs() - l1, min=0.0)


def grow_tree(binned: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              row_weight: torch.Tensor, feature_mask: torch.Tensor, cfg: TreeConfig):
    """Grow one tree. Returns (GrownTree, node_of_row (n,) int32).

    ``binned`` (n, d) int8/int16/int32; ``grad``/``hess``/``row_weight`` (n,)
    f32; ``feature_mask`` (d,) f32 in {0, 1}. All on one device."""
    n, d = binned.shape
    L, B = cfg.num_leaves, cfg.n_bins
    l1, l2 = cfg.lambda_l1, cfg.lambda_l2
    dev = binned.device
    pos = torch.arange(B, device=dev)
    leaf_ids = torch.arange(L, device=dev)
    neg_inf = torch.tensor(float("-inf"), device=dev)

    def hist_of(weight):
        return histogram(binned, grad, hess, weight, B)

    def gain_term(G, H):
        return _thresh_l1(G, l1) ** 2 / (H + l2)

    def gain_table(hists):
        """(L, d, B, 3) histograms -> (L, d, B) gains of the 'bin <= b' splits."""
        G, H, C = hists[..., 0], hists[..., 1], hists[..., 2]
        GT = G.sum(-1, keepdim=True)
        HT = H.sum(-1, keepdim=True)
        CT = C.sum(-1, keepdim=True)
        cum = torch.cumsum(hists, dim=-2)
        GL, HL, CL = cum[..., 0], cum[..., 1], cum[..., 2]
        GR, HR, CR = GT - GL, HT - HL, CT - CL
        g = gain_term(GL, HL) + gain_term(GR, HR) - gain_term(GT, HT)
        valid = ((pos < B - 1)
                 & (CL >= cfg.min_data_in_leaf) & (CR >= cfg.min_data_in_leaf)
                 & (HL >= cfg.min_sum_hessian) & (HR >= cfg.min_sum_hessian)
                 & (feature_mask[:, None] > 0))
        return torch.where(valid, g, neg_inf)

    def best_splits(hists, n_active: int):
        """Best (gain, feature, bin) per leaf, (L,) each."""
        flat = gain_table(hists).reshape(L, d * B)
        # torch.argmax and jnp.argmax both pick the FIRST maximal index
        idx = torch.argmax(flat, dim=-1)
        best_gain = flat.gather(1, idx[:, None])[:, 0]
        best_gain = torch.where(leaf_ids < n_active, best_gain, neg_inf)
        return best_gain, torch.div(idx, B, rounding_mode="floor"), idx % B

    root = hist_of(row_weight)
    hists = torch.zeros((L, d, B, 3), dtype=torch.float32, device=dev)
    hists[0] = root
    node = torch.zeros(n, dtype=torch.int32, device=dev)
    parent = torch.full((L - 1,), -1, dtype=torch.int32, device=dev)
    feat = torch.zeros(L - 1, dtype=torch.int32, device=dev)
    bin_ = torch.zeros(L - 1, dtype=torch.int32, device=dev)
    gains = torch.zeros(L - 1, dtype=torch.float32, device=dev)
    depth = torch.zeros(L, dtype=torch.int32, device=dev)
    min_gain = max(cfg.min_gain_to_split, 0.0)

    for s in range(L - 1):
        leaf_gain, leaf_f, leaf_b = best_splits(hists, s + 1)
        if cfg.max_depth > 0:
            leaf_gain = torch.where(depth < cfg.max_depth, leaf_gain, neg_inf)
        l = torch.argmax(leaf_gain)
        g_best = leaf_gain[l]
        ok = g_best > min_gain
        f_sel = leaf_f[l]
        b_sel = leaf_b[l]
        col = torch.index_select(binned, 1, f_sel.reshape(1))[:, 0]
        go_left = col.to(torch.int64) <= b_sel
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
        bin_[s] = b_sel.to(torch.int32)
        gains[s] = torch.where(ok, g_best, 0.0).to(torch.float32)
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
    return GrownTree(parent, feat, bin_, gains, leaf_value, H_leaf), node


def predict_binned(tree: GrownTree, binned: torch.Tensor) -> torch.Tensor:
    """Replay the splits over a binned matrix -> leaf index per row (n,) int32."""
    n = binned.shape[0]
    node = torch.zeros(n, dtype=torch.int32, device=binned.device)
    for s in range(tree.parent.shape[0]):
        p = tree.parent[s]
        col = torch.index_select(binned, 1, tree.feature[s].reshape(1).long())[:, 0]
        go_right = (node == p) & (col.to(torch.int64) > tree.bin[s]) & (p >= 0)
        node = torch.where(go_right, s + 1, node).to(torch.int32)
    return node
