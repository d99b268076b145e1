"""Isolation forest: host-built random trees, scored on the card by kernel B.

Port of ``synapseml_tpu/isolationforest/forest.py`` (reference: LinkedIn's
isolation forest as wrapped by ``IsolationForest.scala``): params
``num_estimators``, ``max_samples``, ``max_features``, ``contamination``,
``bootstrap``, ``random_seed``; outputs ``outlierScore``
(2^(-E[h(x)]/c(m))) and ``predictedLabel``. Trees are built on the host by
the reference's code with the same ``np.random.default_rng(random_seed)``
draws, so they are bit-equal to the reference's heap arrays.

Scoring goes through kernel B (``csrc/tree_score.cu``, GBDT tree scoring)
with its own launch count (:data:`IFOREST_KERNEL`):

- each feature's distinct split thresholds ``u`` (sorted, f32) re-bin a row
  exactly: its bin is the count of ``u < x``, so ``x > u_j`` (the
  reference's "go right") holds exactly when ``bin > j``; NaN goes to bin 0
  (the reference sends it left: ``NaN > t`` is False); bins are int16 while
  every feature has fewer than 32,768 thresholds, else int32;
- each heap tree (children ``2i+1``, ``2i+2``) becomes B's replay list: the
  internal nodes in heap order, split ``s`` turning leaf ``parent[s]`` into
  (``parent[s]``, ``s + 1``); each leaf's value is the heap's ``path_len``;
- B sums the leaves over the trees in tree order at scale 1; the sum times
  f32(1 / T) (XLA's ``mean``) gives E, and ``2^(-E / c_norm)`` the score.

On a CPU tensor the path lengths come from :func:`path_lengths_plain`, the
reference's fixed-depth heap descent in torch ops, summed in the same tree
order.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import ComplexParam, Estimator, Model, Param, Table
from ..core.params import ParamValidators
from ..core.table import features_matrix
from ..gbdt.device_predict import (SCORE_KERNEL, PackedTrees, device_raw_scores,
                                   pack_trees)
from ..kernels.build import CudaKernel
from ..runtime.device import resolve_device

__all__ = ["IsolationForest", "IsolationForestModel", "IFOREST_KERNEL", "ForestPlan",
           "forest_plan", "rebin", "heap_to_replay", "path_lengths_plain",
           "scores_from_total"]

IFOREST_KERNEL = CudaKernel(
    name="iforest_tree_score", source="tree_score", symbol="smt_tree_score",
    argtypes=list(SCORE_KERNEL.argtypes),
    replaces="synapseml_tpu/isolationforest/forest.py:80 (_score_fn, :80-100)")

_EULER = 0.5772156649015329
_I16_BINS = 1 << 15


def _avg_path_length(n) -> float:
    """c(n): expected unsuccessful-search path length in a BST of n points."""
    if n <= 1:
        return 0.0
    if n == 2:
        return 1.0
    h = math.log(n - 1.0) + _EULER
    return 2.0 * h - 2.0 * (n - 1.0) / n


def _build_tree(x: np.ndarray, feat_subset: np.ndarray, depth_limit: int,
                rng) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One isolation tree over subsample ``x`` as heap arrays (the
    reference's code and draws).

    Returns (feature, threshold, path_len) each sized 2^(depth_limit+1)-1.
    Internal nodes: feature >= 0, route by value > threshold. Leaves:
    feature = -1 and path_len = depth + c(n_node)."""
    n_nodes = 2 ** (depth_limit + 1) - 1
    feature = np.full(n_nodes, -1, dtype=np.int32)
    threshold = np.zeros(n_nodes, dtype=np.float32)
    path_len = np.zeros(n_nodes, dtype=np.float32)

    work = [(0, np.arange(len(x)), 0)]
    while work:
        node, idx, depth = work.pop()
        rows = x[idx]
        if depth >= depth_limit or len(idx) <= 1:
            path_len[node] = depth + _avg_path_length(len(idx))
            continue
        spread = rows[:, feat_subset].max(0) - rows[:, feat_subset].min(0)
        candidates = feat_subset[spread > 0]
        if len(candidates) == 0:
            path_len[node] = depth + _avg_path_length(len(idx))
            continue
        f = int(candidates[rng.integers(len(candidates))])
        lo, hi = rows[:, f].min(), rows[:, f].max()
        t = float(rng.uniform(lo, hi))
        go_right = rows[:, f] > t
        feature[node] = f
        threshold[node] = t
        work.append((2 * node + 1, idx[~go_right], depth + 1))
        work.append((2 * node + 2, idx[go_right], depth + 1))
    return feature, threshold, path_len


def heap_to_replay(feature: np.ndarray, threshold: np.ndarray, path_len: np.ndarray):
    """(T, nodes) heap trees -> B's replay lists, each (T, 1, S) with S =
    (nodes - 1) // 2: ``parent``, ``feature`` and the split threshold (f32;
    :func:`forest_plan` turns it into a bin), and ``leaf_value`` (T, 1, S + 1)
    f32. Internal nodes become splits in heap order; an unused split has
    ``parent = -1``."""
    feature = np.asarray(feature)
    T, nodes = feature.shape
    S = (nodes - 1) // 2
    parent = np.full((T, 1, S), -1, np.int64)
    feat = np.zeros((T, 1, S), np.int64)
    thr = np.zeros((T, 1, S), np.float32)
    leaf = np.zeros((T, 1, S + 1), np.float32)
    for t in range(T):
        leaf_of = np.full(nodes, -1, np.int64)
        leaf_of[0] = 0
        s = 0
        for i in range(nodes):
            if leaf_of[i] < 0:
                continue                       # below a leaf: never reached
            if feature[t, i] >= 0:
                parent[t, 0, s] = leaf_of[i]
                feat[t, 0, s] = feature[t, i]
                thr[t, 0, s] = threshold[t, i]
                leaf_of[2 * i + 1] = leaf_of[i]
                leaf_of[2 * i + 2] = s + 1
                s += 1
            else:
                leaf[t, 0, leaf_of[i]] = path_len[t, i]
    return parent, feat, thr, leaf


class ForestPlan(NamedTuple):
    """What scoring a forest on one device needs, made once a model and device."""

    uniq: torch.Tensor         # (d, U) f32 each feature's sorted thresholds, +inf padded
    bin_dtype: torch.dtype     # int16 or int32
    parent: np.ndarray         # (T, 1, S)
    feature: np.ndarray        # (T, 1, S)
    bins: np.ndarray           # (T, 1, S): the split's threshold index in uniq[feature]
    leaf_value: np.ndarray     # (T, 1, S + 1) f32 path lengths
    packed: Optional[PackedTrees]


def forest_plan(feature, threshold, path_len, d: int, device) -> ForestPlan:
    """Re-binning table and replay lists of a heap forest, on ``device``."""
    dev = torch.device(device)
    parent, feat, thr, leaf = heap_to_replay(feature, threshold, path_len)
    live = parent >= 0
    uniq = [np.unique(thr[live & (feat == f)]) for f in range(d)]
    width = max(1, max(len(u) for u in uniq))
    table = np.full((d, width), np.inf, np.float32)
    bins = np.zeros(feat.shape, np.int64)
    for f, u in enumerate(uniq):
        table[f, :len(u)] = u
        at = live & (feat == f)
        bins[at] = np.searchsorted(u, thr[at])
    bin_dtype = torch.int16 if width < _I16_BINS else torch.int32
    packed = pack_trees(parent, feat, bins, device=dev) if dev.type == "cuda" else None
    return ForestPlan(torch.from_numpy(table).to(dev), bin_dtype, parent, feat, bins, leaf,
                      packed)


def rebin(x: torch.Tensor, plan: ForestPlan) -> torch.Tensor:
    """(n, d) f32 rows -> (n, d) bins: the count of a feature's thresholds
    below the value, 0 for NaN."""
    xt = x.to(torch.float32).t().contiguous()                        # (d, n)
    b = torch.searchsorted(plan.uniq, xt, side="left")
    b = torch.where(torch.isnan(xt), torch.zeros_like(b), b)
    return b.t().to(plan.bin_dtype).contiguous()


def path_lengths_plain(x: torch.Tensor, feature, threshold, path_len,
                       depth_limit: int) -> torch.Tensor:
    """Plain PyTorch version: the reference's heap descent (``depth_limit``
    steps of every tree at once) -> (n,) path lengths summed over the trees
    in tree order (not yet divided by T)."""
    dev = x.device
    feat = torch.as_tensor(np.asarray(feature), dtype=torch.int64, device=dev)   # (T, nodes)
    thr = torch.as_tensor(np.asarray(threshold), dtype=torch.float32, device=dev)
    pl = torch.as_tensor(np.asarray(path_len), dtype=torch.float32, device=dev)
    x = x.to(torch.float32)
    T = feat.shape[0]
    idx = torch.zeros(T, x.shape[0], dtype=torch.int64, device=dev)
    for _ in range(depth_limit):
        f = torch.gather(feat, 1, idx)
        xv = torch.gather(x, 1, f.clamp(min=0).t()).t()                 # (T, n)
        go = (xv > torch.gather(thr, 1, idx)).to(torch.int64)
        idx = torch.where(f < 0, idx, 2 * idx + 1 + go)
    lens = torch.gather(pl, 1, idx)
    acc = torch.zeros(x.shape[0], dtype=torch.float32, device=dev)
    for t in range(T):
        acc = acc + lens[t]
    return acc


def scores_from_total(total: torch.Tensor, T: int, c_norm: float) -> torch.Tensor:
    """Summed path lengths -> 2^(-E / c_norm), E the mean over the ``T``
    trees taken as XLA takes ``mean``: the sum times f32(1 / T)."""
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=total.device)
    mean = total * f32(np.float32(1.0) / np.float32(T))
    return torch.pow(f32(2.0), -mean / f32(c_norm))


_DEVICE_DOC = "'cuda[:i]' (default: the GPU) or 'cpu'"
_STATE = ("features_col", "prediction_col", "score_col", "contamination", "depth_limit",
          "c_norm", "score_threshold", "tree_features", "tree_thresholds", "tree_path_lens")


class IsolationForest(Estimator):
    """Reference param surface (LinkedIn ``IsolationForestParams``), snake_cased."""

    features_col = Param("features column (vector)", str, default="features")
    prediction_col = Param("0/1 outlier prediction column", str, default="predictedLabel")
    score_col = Param("outlier score column", str, default="outlierScore")
    num_estimators = Param("number of isolation trees", int, default=100,
                           validator=ParamValidators.gt(0))
    max_samples = Param("subsample size per tree", int, default=256,
                        validator=ParamValidators.gt(1))
    max_features = Param("fraction of features per tree", float, default=1.0,
                         validator=ParamValidators.in_range(0.0, 1.0, low_inclusive=False))
    contamination = Param("expected outlier fraction; 0 disables the prediction threshold",
                          float, default=0.0, validator=ParamValidators.in_range(0.0, 0.5))
    bootstrap = Param("sample with replacement", bool, default=False)
    random_seed = Param("seed", int, default=1)
    device = Param(_DEVICE_DOC, str, default=None)

    def _fit(self, table: Table) -> "IsolationForestModel":
        self._validate_input(table, self.features_col)
        x = features_matrix(table[self.features_col])
        n, d = x.shape
        m = min(self.max_samples, n)
        depth_limit = max(1, int(math.ceil(math.log2(max(m, 2)))))
        n_feat = max(1, int(round(self.max_features * d)))
        rng = np.random.default_rng(self.random_seed)

        feats, thrs, pls = [], [], []
        for _ in range(self.num_estimators):
            idx = (rng.integers(0, n, size=m) if self.bootstrap
                   else rng.permutation(n)[:m])
            feat_subset = rng.permutation(d)[:n_feat]
            f, t, p = _build_tree(x[idx], feat_subset, depth_limit, rng)
            feats.append(f)
            thrs.append(t)
            pls.append(p)

        model = IsolationForestModel(
            features_col=self.features_col, prediction_col=self.prediction_col,
            score_col=self.score_col, contamination=self.contamination,
            depth_limit=depth_limit, c_norm=float(_avg_path_length(m)),
            tree_features=np.stack(feats), tree_thresholds=np.stack(thrs),
            tree_path_lens=np.stack(pls), score_threshold=2.0, device=self.device)
        if self.contamination > 0:
            scores = model._scores(x)
            model.set_params(score_threshold=float(
                np.quantile(scores, 1.0 - self.contamination)))
        return model


class IsolationForestModel(Model):
    features_col = Param("features column", str, default="features")
    prediction_col = Param("0/1 outlier prediction column", str, default="predictedLabel")
    score_col = Param("outlier score column", str, default="outlierScore")
    contamination = Param("outlier fraction used at fit", float, default=0.0)
    depth_limit = Param("tree depth limit", int, default=8)
    c_norm = Param("c(max_samples) score normalizer", float, default=1.0)
    score_threshold = Param("score >= threshold -> outlier (2.0 = never, "
                            "used when contamination = 0)", float, default=2.0)
    tree_features = ComplexParam("(T, nodes) split features", object, default=None)
    tree_thresholds = ComplexParam("(T, nodes) split thresholds", object, default=None)
    tree_path_lens = ComplexParam("(T, nodes) leaf path lengths", object, default=None)
    device = Param(_DEVICE_DOC, str, default=None)

    def state_dict(self) -> Dict[str, object]:
        """The model as the reference's ``IsolationForestModel`` params (the
        heap arrays as numpy): ``RefModel(**model.state_dict())`` carries it
        across, and :meth:`from_state` takes such a dict back."""
        return {k: (np.asarray(self.get(k)) if k.startswith("tree_") else self.get(k))
                for k in _STATE}

    @classmethod
    def from_state(cls, state: Dict[str, object], device: Optional[str] = None
                   ) -> "IsolationForestModel":
        """A port model from the reference model's params (:meth:`state_dict`'s
        keys)."""
        params = {k: (np.asarray(state[k]) if k.startswith("tree_") else state[k])
                  for k in _STATE if k in state}
        return cls(device=device, **params)

    def _plan(self, d: int, dev: torch.device) -> ForestPlan:
        return self._cached("plan", (d, str(dev)),
                            ("tree_features", "tree_thresholds", "tree_path_lens"),
                            lambda: forest_plan(self.tree_features, self.tree_thresholds,
                                                self.tree_path_lens, d, dev))

    def score_tensor(self, x: torch.Tensor) -> torch.Tensor:
        """(n, d) rows on a device -> (n,) f32 outlier scores there: kernel B
        on a CUDA tensor, :func:`path_lengths_plain` on a CPU tensor."""
        T = int(np.shape(self.tree_features)[0])
        if x.device.type == "cpu":
            total = path_lengths_plain(x, self.tree_features, self.tree_thresholds,
                                       self.tree_path_lens, self.depth_limit)
        else:
            plan = self._plan(x.shape[1], x.device)
            total = device_raw_scores(rebin(x, plan), plan.parent, plan.feature, plan.bins,
                                      plan.leaf_value, np.ones(T, np.float32),
                                      packed=plan.packed, kernel=IFOREST_KERNEL)[:, 0]
        return scores_from_total(total, T, self.c_norm)

    def _scores(self, x: np.ndarray) -> np.ndarray:
        dev = resolve_device(self.device)
        xt = torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev)
        return self.score_tensor(xt).cpu().numpy()

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.features_col)
        x = features_matrix(table[self.features_col])
        scores = self._scores(x)
        pred = (scores >= self.score_threshold).astype(np.float64)
        return (table.with_column(self.score_col, scores.astype(np.float64))
                .with_column(self.prediction_col, pred))
