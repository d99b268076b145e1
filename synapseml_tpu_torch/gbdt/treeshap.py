"""Exact TreeSHAP feature contributions (a copy of
``synapseml_tpu/gbdt/treeshap.py``, which is numpy only).

Reference: the C++ TreeSHAP behind ``LGBM_BoosterPredictForMat`` with
``C_API_PREDICT_CONTRIB`` (surfaced at ``LightGBMBooster.scala:510,529`` as
``featuresShap``). This is Lundberg & Lee's polynomial-time path algorithm
(Algorithm 2 of the TreeSHAP paper), vectorized across instances: the tree is
walked once, path state arrays carry a batch dimension, and every EXTEND /
UNWIND is a numpy vector op over all rows.

Covers (the p(S) weights) use the training hessian mass per leaf
(``leaf_hess``), the same weighting the engine's leaf values are computed with.
Split decisions replay on BINNED features, identical to prediction (the
booster bins the rows on its device, kernel D on a GPU, and hands the bins to
this module on the host).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

__all__ = ["tree_shap", "build_explicit_tree"]


class _Node:
    __slots__ = ("feature", "bin", "cat", "left", "right", "cover", "value", "leaf")

    def __init__(self):
        self.feature = -1
        self.bin = -1
        self.cat: Optional[np.ndarray] = None
        self.left: Optional["_Node"] = None
        self.right: Optional["_Node"] = None
        self.cover = 0.0
        self.value = 0.0
        self.leaf = -1


def build_explicit_tree(parent: np.ndarray, feature: np.ndarray, bins: np.ndarray,
                        leaf_value: np.ndarray, leaf_hess: np.ndarray,
                        cat_set: Optional[np.ndarray] = None) -> _Node:
    """Replay-list arrays (one tree) -> explicit binary tree with covers.

    Split ``s`` converts current leaf ``parent[s]`` into an internal node whose
    left child keeps leaf id ``parent[s]`` and right child is leaf id ``s+1``.
    """
    root = _Node()
    root.leaf = 0
    cur = {0: root}
    for s in range(parent.shape[0]):
        p = int(parent[s])
        if p < 0:
            continue
        node = cur[p]
        node.leaf = -1
        node.feature = int(feature[s])
        node.bin = int(bins[s])
        if node.bin < 0 and cat_set is not None:
            node.cat = cat_set[s]
        left, right = _Node(), _Node()
        left.leaf, right.leaf = p, s + 1
        node.left, node.right = left, right
        cur[p], cur[s + 1] = left, right

    def finish(n: "_Node") -> float:
        if n.left is None:
            n.value = float(leaf_value[n.leaf])
            n.cover = max(float(leaf_hess[n.leaf]), 1e-12)
        else:
            n.cover = finish(n.left) + finish(n.right)
        return n.cover

    finish(root)
    return root


def _extend(pw: np.ndarray, zf: List[float], of: List[np.ndarray],
            pz: float, po: np.ndarray, depth: int) -> np.ndarray:
    """EXTEND: grow the path-weight table by one fraction pair.

    ``pw`` (n, depth) -> (n, depth+1); ``zf``/``of`` are appended by the caller.
    """
    n = pw.shape[0]
    out = np.zeros((n, depth + 1), dtype=np.float64)
    out[:, 1:] = pw * po[:, None] * (np.arange(1, depth + 1) / (depth + 1))
    out[:, :-1] += pw * pz * ((depth - np.arange(depth)) / (depth + 1))
    if depth == 0:
        out[:, 0] = 1.0
    return out


def _unwound_sum(pw: np.ndarray, zf: List[float], of: List[np.ndarray],
                 i: int) -> np.ndarray:
    """Sum of the path weights with entry ``i`` unwound (UNWIND + sum), (n,)."""
    n, depth1 = pw.shape
    depth = depth1 - 1
    o, z = of[i], zf[i]
    total = np.zeros(n)
    nxt = pw[:, depth].copy()
    o_safe = np.where(o == 0.0, 1.0, o)
    for j in range(depth - 1, -1, -1):
        # where o != 0: tmp = nxt*(depth+1)/((j+1)*o); total += tmp; nxt = pw[j] - tmp*z*(depth-j)/(depth+1)
        tmp = nxt * (depth + 1) / ((j + 1) * o_safe)
        with_o = tmp
        without_o = pw[:, j] * (depth + 1) / (z * (depth - j)) if z * (depth - j) != 0 \
            else np.zeros(n)
        use_o = o != 0.0
        contrib = np.where(use_o, with_o, without_o)
        total += contrib
        nxt = np.where(use_o, pw[:, j] - tmp * z * (depth - j) / (depth + 1), nxt)
    return total


def tree_shap(root: _Node, binned: np.ndarray, n_features: int) -> np.ndarray:
    """phi (n, n_features); sum(phi) + E[f] == f(x) per row (additivity)."""
    n = binned.shape[0]
    phi = np.zeros((n, n_features), dtype=np.float64)

    def go_left_mask(node: "_Node") -> np.ndarray:
        col = binned[:, node.feature]
        if node.bin < 0:
            return node.cat[col] > 0
        return col <= node.bin

    def recurse(node: "_Node", pw: np.ndarray, zf: List[float],
                of: List[np.ndarray], feats: List[int]):
        depth = len(zf)
        if node.left is None:
            # leaf: attribute to every feature on the path
            for i in range(1, depth):
                w = _unwound_sum(pw, zf, of, i)
                phi[:, feats[i]] += w * (of[i] - zf[i]) * node.value
            return

        hot_left = go_left_mask(node)
        hot, cold = node.left, node.right
        # per-row hot child differs; process both children, with one_fraction
        # masked per row. zero fraction = child cover / node cover.
        try:
            i_dup = feats.index(node.feature, 1)
        except ValueError:
            i_dup = -1

        for child, is_left in ((node.left, True), (node.right, False)):
            iz = child.cover / node.cover
            io = hot_left.astype(np.float64) if is_left else (~hot_left).astype(np.float64)
            cpw, czf, cof, cfeats = pw, list(zf), list(of), list(feats)
            if i_dup >= 0:
                # feature already on path: unwind it, fold its fractions in
                iz = iz * czf[i_dup]
                io = io * cof[i_dup]
                cpw = _unwind(cpw, czf, cof, i_dup)
                del czf[i_dup], cof[i_dup], cfeats[i_dup]
            d = len(czf)
            npw = _extend(cpw, czf, cof, iz, io, d)
            czf.append(iz)
            cof.append(io)
            cfeats.append(node.feature)
            recurse(child, npw, czf, cof, cfeats)

    def _unwind(pw: np.ndarray, zf: List[float], of: List[np.ndarray],
                i: int) -> np.ndarray:
        n_, depth1 = pw.shape
        depth = depth1 - 1
        o, z = of[i], zf[i]
        out = np.zeros((n_, depth), dtype=np.float64)
        nxt = pw[:, depth].copy()
        o_safe = np.where(o == 0.0, 1.0, o)
        use_o = o != 0.0
        for j in range(depth - 1, -1, -1):
            tmp = nxt * (depth + 1) / ((j + 1) * o_safe)
            with_o = tmp
            nxt_with = pw[:, j] - tmp * z * (depth - j) / (depth + 1)
            if z * (depth - j) != 0:
                without_o = pw[:, j] * (depth + 1) / (z * (depth - j))
            else:
                without_o = np.zeros(n_)
            out[:, j] = np.where(use_o, with_o, without_o)
            nxt = np.where(use_o, nxt_with, nxt)
        return out

    # root: path starts with the sentinel (1, 1) entry
    pw0 = np.ones((n, 1), dtype=np.float64)
    recurse(root, pw0, [1.0], [np.ones(n)], [-1])
    return phi


def expected_value(root: _Node) -> float:
    """Cover-weighted mean prediction E[f] (the SHAP base value)."""
    if root.left is None:
        return root.value
    wl = root.left.cover / root.cover
    return wl * expected_value(root.left) + (1 - wl) * expected_value(root.right)
