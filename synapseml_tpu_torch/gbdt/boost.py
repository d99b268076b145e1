"""Boosting loop, objectives and the serializable booster.

Port of ``synapseml_tpu/gbdt/boost.py`` on one device: ``gbdt``, ``goss``,
``dart`` and ``rf`` boosting with bagging (plain and class-aware) and
feature fraction, eval sets with early stopping, the objectives ``binary``,
``multiclass`` (softmax, one tree per class and iteration), ``regression``
(l2), ``l1``, ``huber``, ``poisson``, ``quantile``, ``tweedie`` (``l1``
and ``quantile`` renew their leaf values as residual percentiles) and
``lambdarank`` (over contiguous query groups, its gradient kernel F of
:mod:`.lambdarank`, evaluated by NDCG@k on the host), numeric and
categorical features. The booster explains (``predict_contrib``: exact
TreeSHAP or Saabas), ranks its features (``feature_importance``) and reads
and writes LightGBM's text model (:mod:`.native_model`) and the reference's
JSON model string. The reference
runs the loop as one ``lax.scan`` program; here it is a Python loop over
iterations whose body (objective gradients -> pre-rounding -> tree growth ->
score update) queues on the device without reading anything back, so the
trees come to the host once, after the last iteration. The random masks are
the reference's own streams (:mod:`.sampling`), so sampled fits grow its
trees too; eval metrics run on the device (:mod:`.metrics`) and their panel
is read back once per chunk of at most 32 iterations. DART draws its drops
from the host's numpy generator, as the reference does, and replays dropped
trees on the device.

Gradients are pre-rounded to a summation-exact grid (:func:`_preround`, the
reference's ``boost.py:1148``), so every histogram cell is exact in any
summation order: the GPU kernels reproduce the reference's trees, and the
growth over a row partition (smaller-child histograms, the reference's
``leaf_local``) grows its full pass's trees wherever the row weights keep
the products on that grid (see :mod:`.grow`).

``train`` also takes a custom objective (``fobj``), a fitted ``mapper``,
continued training from an ``init_booster`` and per-iteration
``callbacks``, as the reference's does. Sparse (CSR) features (a
:class:`~.sparse.CSRMatrix` or a scipy sparse matrix) train through the
sparse grower (:func:`~.grow.grow_tree_sparse`, kernel G) in the mapper's
compact bin space, and the booster scores CSR rows through the features its
trees use (kernel B). A :class:`~.dataset.GBDTDataset` is binned once
and fits many times.

``train(..., mesh=layout)`` trains over a ``torch.distributed`` mesh (a
:class:`~synapseml_tpu_torch.runtime.layout.SpecLayout` or a raw
``DeviceMesh``; the reference's ``boost.py:1517-1552``): every rank passes
the same whole input and takes its own block of rows (:class:`_MeshRows`),
padded by wrapping to equal blocks with weight -0.0 (a padding row counts
0, a user's zero weight still counts); the rounding bound comes from the
global padded row count and ``_preround``'s max is all-reduced, so the
histograms, all-reduced, are exact and the trees are the single-device
ones (:mod:`.grow`: data-, feature- and voting-parallel growth). Bagging
and GOSS draw per shard (the key folded with the data rank), eval sets
replicate (every rank scores all of them, so metrics and early stopping
agree with no collective), lambdarank shards whole queries
(:func:`make_lambdarank_mesh`), and continued training and DART replays
run over each rank's rows. Every rank returns the same booster.
"""

from __future__ import annotations

import json
import warnings
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.serialization import register_state_class
from ..runtime.collectives import all_reduce
from ..runtime.device import resolve_device
from ..runtime.layout import SpecLayout, as_layout
from .binning import BinMapper, torch_bin_dtype
from .dataset import GBDTDataset
from .grow import (GrownTree, TreeConfig, TreeMesh, grow_tree, grow_tree_sparse,
                   predict_binned)
from .lambdarank import QueryGroups, group_aligned_layout, lambda_grads
from .partition import RowPartition
from .metrics import DEFAULT_METRIC, METRICS, device_metric, metric_ndcg
from .sampling import Sampler
from .sparse import (CSRMatrix, as_csr, build_sparse_binned, is_sparse_input,
                     shard_sparse_binned)
from .split_search import SplitWorkspace

__all__ = ["GBDTBooster", "train", "OBJECTIVES", "make_lambdarank", "make_lambdarank_mesh"]


def _sigmoid(z):
    return 1.0 / (1.0 + torch.exp(-z))


def _obj_binary():
    def init(y, w):
        p = np.clip(np.average(y, weights=w), 1e-8, 1 - 1e-8)
        return float(np.log(p / (1 - p)))

    def grads(score, y, w):
        p = _sigmoid(score)
        return (p - y) * w, p * (1 - p) * w

    return init, grads


def _obj_l2():
    def init(y, w):
        return float(np.average(y, weights=w))

    def grads(score, y, w):
        return (score - y) * w, w

    return init, grads


def _obj_l1():
    def init(y, w):
        return float(np.median(y))

    def grads(score, y, w):
        return torch.sign(score - y) * w, w

    return init, grads


def _obj_huber(alpha=0.9):
    def init(y, w):
        return float(np.average(y, weights=w))

    def grads(score, y, w):
        return torch.clamp(score - y, -alpha, alpha) * w, w

    return init, grads


def _obj_poisson():
    def init(y, w):
        return float(np.log(max(np.average(y, weights=w), 1e-8)))

    def grads(score, y, w):
        mu = torch.exp(score)
        return (mu - y) * w, mu * w

    return init, grads


def _obj_quantile(alpha=0.5):
    def init(y, w):
        return float(np.quantile(y, alpha))

    def grads(score, y, w):
        g = torch.where(score - y >= 0, 1.0 - alpha, -alpha)
        return g * w, w

    return init, grads


def _obj_tweedie(rho=1.5):
    def init(y, w):
        return float(np.log(max(np.average(y, weights=w), 1e-8)))

    def grads(score, y, w):
        e1, e2 = torch.exp((1 - rho) * score), torch.exp((2 - rho) * score)
        g = -y * e1 + e2
        h = -y * (1 - rho) * e1 + (2 - rho) * e2
        return g * w, torch.clamp(h, min=1e-16) * w

    return init, grads


def _obj_multiclass(num_class):
    def init(y, w):
        # per-class log prior (boost_from_average for softmax)
        pri = np.array([max(float(np.average(y == c, weights=w)), 1e-8)
                        for c in range(num_class)])
        return np.log(pri / pri.sum())

    def grads(score, y, w):
        # score (n, C); y (n,) class indices
        p = torch.exp(score - torch.max(score, dim=1, keepdim=True).values)
        p = p / p.sum(dim=1, keepdim=True)
        onehot = (y[:, None] == torch.arange(score.shape[1], device=score.device)
                  ).to(p.dtype)
        g = (p - onehot) * w[:, None]
        h = p * (1 - p) * 2.0 * w[:, None]  # LightGBM doubles the softmax hessian
        return g, h

    return init, grads


def make_lambdarank(group_sizes, label, truncation: int = 30, sigma: float = 1.0,
                    device="cpu"):
    """(init, grads) of the LambdaRank objective over contiguous query groups
    (the reference's ``make_lambdarank``, ``boost.py:214``): init 0, grads
    kernel F's (:func:`.lambdarank.lambda_grads`). The rows' ``label`` comes
    with the groups because the gains and ideal DCGs are built once, here,
    on ``device``."""
    groups = QueryGroups(group_sizes, label, truncation, device)

    def init(y, w):
        return 0.0

    def grads(score, y, w):
        return lambda_grads(score, y, w, groups, sigma)

    return init, grads


def make_lambdarank_mesh(group_sizes, label, n_shards: int, rank: int, truncation: int = 30,
                         sigma: float = 1.0, device="cpu"):
    """Distributed LambdaRank by group-aligned sharding (the reference's
    ``make_lambdarank_mesh``, ``boost.py:237``): whole queries a shard
    (:func:`~.lambdarank.group_aligned_layout`), so the lambdas stay local.
    Returns ``(init, grads, order, w_mask, local)``: ``order`` and
    ``w_mask`` over every shard's block of ``local`` slots, and ``grads``
    over rank ``rank``'s block (its queries' rows, then its padding, whose
    gradients are 0): kernel F over the rank's own :class:`QueryGroups`."""
    order, w_mask, local, per_shard = group_aligned_layout(group_sizes, n_shards)
    sizes = np.asarray(group_sizes, dtype=np.int64).reshape(-1)[per_shard[rank]]
    real = int(sizes.sum())
    groups = QueryGroups(sizes, np.asarray(label)[order[rank * local:rank * local + real]],
                         truncation, device)

    def init(y, w):
        return 0.0

    def grads(score, y, w):
        g, h = lambda_grads(score[:real], y[:real], w[:real], groups, sigma)
        pad = torch.zeros(local - real, dtype=torch.float32, device=score.device)
        return torch.cat([g, pad]), torch.cat([h, pad])

    return init, grads, order, w_mask, local


class _MeshRows:
    """This rank's rows of an ``n``-row input on ``layout``'s data axis:
    ``rows`` (local,) int64 input rows (a padding slot repeats an earlier
    row), ``pad`` (local,) bool the padding slots, ``local`` the rows a
    rank, ``n_global`` the padded rows of every rank. Without
    ``lambdarank``, equal contiguous blocks of the rows padded by wrapping
    (the reference's ``boost.py:1899-2005``); with it (what
    :func:`make_lambdarank_mesh` returned), whole queries a rank, by its
    ``order`` and ``w_mask``."""

    def __init__(self, layout: SpecLayout, n: int, lambdarank=None):
        shards, r = layout.data_size, layout.data_rank
        if lambdarank is None:
            local = (n + (-n) % shards) // shards
            slots = np.arange(r * local, (r + 1) * local)
            self.rows, self.pad = slots % n, slots >= n
        else:
            _, _, order, w_mask, local = lambdarank
            block = slice(r * local, (r + 1) * local)
            self.rows, self.pad = order[block], w_mask[block] == 0
        self.lambdarank = lambdarank is not None
        self.local, self.n_global = int(local), int(local) * shards

    def weights(self, w_np: np.ndarray) -> np.ndarray:
        """The rank's sample weights: -0.0 on the padding slots."""
        return np.where(self.pad, -0.0, w_np[self.rows])


# the reference's table (``boost.py:323-336``), plus two l2 aliases
OBJECTIVES = {"binary": _obj_binary, "regression": _obj_l2, "l2": _obj_l2,
              "mean_squared_error": _obj_l2, "mse": _obj_l2, "regression_l2": _obj_l2,
              "l1": _obj_l1, "mae": _obj_l1, "huber": _obj_huber,
              "poisson": _obj_poisson, "quantile": _obj_quantile,
              "tweedie": _obj_tweedie, "multiclass": _obj_multiclass,
              "softmax": _obj_multiclass}
_MULTICLASS = ("multiclass", "softmax")

_DEFAULTS = dict(
    objective="regression", num_iterations=100, learning_rate=0.1, num_leaves=31,
    max_bin=255, lambda_l1=0.0, lambda_l2=0.0, min_data_in_leaf=20,
    min_sum_hessian_in_leaf=1e-3, min_gain_to_split=0.0, feature_fraction=1.0,
    bagging_fraction=1.0, bagging_freq=0, boosting="gbdt",
    max_depth=-1, max_delta_step=0.0, boost_from_average=True,
    pos_bagging_fraction=1.0, neg_bagging_fraction=1.0,
    bin_sample_count=200_000, max_bin_by_feature=None,
    top_rate=0.2, other_rate=0.1,
    drop_rate=0.1, max_drop=50, skip_drop=0.5,
    uniform_drop=False, xgboost_dart_mode=False,
    categorical_feature=None, cat_smooth=10.0, max_cat_threshold=32,
    parallelism="data_parallel", top_k=20,
    num_class=1, seed=0, bagging_seed=3, metric=None, early_stopping_round=0,
    early_stopping_min_delta=0.0, hist_method="auto", hist_chunk=1 << 20,
    leaf_local=False,
    alpha=0.9, tweedie_variance_power=1.5, verbose=0,
    lambdarank_truncation_level=30, sigmoid=1.0, ndcg_at=10,
)

# LightGBM parameter aliases (config.h alias table, the commonly used rows)
_ALIASES = {
    "num_iterations": ("num_iteration", "num_tree", "num_trees", "num_round",
                       "num_rounds", "num_boost_round", "n_estimators",
                       "nrounds", "n_iter"),
    "learning_rate": ("shrinkage_rate", "eta"),
    "num_leaves": ("num_leaf", "max_leaves", "max_leaf", "max_leaf_nodes"),
    "min_data_in_leaf": ("min_data_per_leaf", "min_data",
                         "min_child_samples", "min_samples_leaf"),
    "min_sum_hessian_in_leaf": ("min_sum_hessian_per_leaf",
                                "min_sum_hessian", "min_hessian",
                                "min_child_weight"),
    "bagging_fraction": ("sub_row", "subsample", "bagging"),
    "bagging_freq": ("subsample_freq",),
    "feature_fraction": ("sub_feature", "colsample_bytree"),
    "lambda_l1": ("reg_alpha", "l1_regularization"),
    "lambda_l2": ("reg_lambda", "lambda", "l2_regularization"),
    "min_gain_to_split": ("min_split_gain",),
    "early_stopping_round": ("early_stopping_rounds", "early_stopping",
                             "n_iter_no_change"),
    "boosting": ("boosting_type", "boost"),
    "max_bin": ("max_bins",),
    "seed": ("random_state", "random_seed"),
    "bin_sample_count": ("bin_construct_sample_cnt", "subsample_for_bin"),
    "categorical_feature": ("cat_feature", "categorical_column", "cat_column"),
    "verbose": ("verbosity", "verbose_eval"),
    "objective": ("objective_type", "app", "application", "loss"),
}
_ALIAS_OF = {a: k for k, al in _ALIASES.items() for a in al}
_INERT_PARAMS = frozenset({
    "num_threads", "num_thread", "n_jobs", "nthread", "nthreads",
    "device_type", "gpu_device_id", "gpu_platform_id",
    "force_row_wise", "force_col_wise", "two_round", "is_enable_sparse",
    "enable_sparse", "sparse", "importance_type",
})


def _canonicalize_params(params):
    """Resolve LightGBM aliases and warn on unknown keys (the reference's rule)."""
    params = dict(params or {})
    out = {}
    unknown = []
    for k, v in params.items():
        kc = _ALIAS_OF.get(k, k)
        if kc in _INERT_PARAMS:
            continue
        if kc not in _DEFAULTS:
            unknown.append(k)
            continue
        if kc != k and kc in params:
            continue  # an explicit canonical key wins over its alias
        if kc in out and out[kc] != v:
            warnings.warn(f"parameter {kc!r} set via multiple aliases with different "
                          f"values; {v!r} overrides {out[kc]!r}", stacklevel=3)
        out[kc] = v
    if unknown:
        warnings.warn(f"unknown train() parameters ignored: {sorted(unknown)} — check "
                      "for typos", stacklevel=3)
    return out


def _preround(x: torch.Tensor, n_bound: int,
              layout: Optional[SpecLayout] = None) -> torch.Tensor:
    """Round gradients to a summation-exact f32 grid (the reference's
    ``_preround``): every value becomes a multiple of ``ulp(factor)`` with
    ``factor >= max|x| * n_bound``, so every partial sum of up to ``n_bound``
    terms is exactly representable and ANY summation order gives the same
    bits. Per-element error is at most ``max|x| * n_bound * 2**-24``. On a
    mesh (``layout``) the max is all-reduced over the data axis, so every
    rank rounds on the single-device grid."""
    m = torch.max(torch.abs(x), dim=0).values
    if layout is not None:
        all_reduce(m, layout, "max", ("data",))
    delta = m * torch.tensor(float(n_bound), dtype=torch.float32, device=x.device)
    factor = torch.exp2(torch.ceil(torch.log2(torch.clamp(delta, min=1e-35))))
    return (x + factor) - factor


def _resolve_objective(p):
    """(init, grads) of the objective named in ``p`` (the reference's
    ``_resolve_objective``, ``boost.py:1097-1109``)."""
    name = p["objective"]
    if name not in OBJECTIVES:
        raise NotImplementedError(f"objective {name!r} is not ported yet "
                                  f"(ported: {sorted(OBJECTIVES)})")
    if name in _MULTICLASS:
        return OBJECTIVES[name](int(p["num_class"]))
    if name in ("huber", "quantile"):
        return OBJECTIVES[name](float(p["alpha"]))
    if name == "tweedie":
        return OBJECTIVES[name](float(p["tweedie_variance_power"]))
    return OBJECTIVES[name]()


def _renewed_leaf_values(node, yv, raw_col, weight, alpha: float, L: int):
    """Leaf outputs as the weighted ``alpha``-percentile of the leaf's
    residuals (LightGBM's ``RenewTreeOutput`` for quantile and L1; the
    reference's ``_renewed_leaf_values``, ``boost.py:1112-1146``): rows
    grouped by (leaf, residual) with two stable sorts, then each leaf's
    percentile position by ``searchsorted`` over the cumulative weight."""
    r = yv - raw_col
    order1 = torch.argsort(r, stable=True)
    order2 = torch.argsort(node[order1], stable=True)
    perm = order1[order2]                    # leaf-major, residual ascending
    node_s, r_s = node[perm].contiguous(), r[perm]
    cw = torch.cumsum(weight[perm], dim=0)
    leaves = torch.arange(L, dtype=node_s.dtype, device=node.device)
    starts = torch.searchsorted(node_s, leaves, side="left")
    ends = torch.searchsorted(node_s, leaves, side="right")
    offset = torch.where(starts > 0, cw[(starts - 1).clamp(min=0)], 0.0)
    total = torch.where(ends > 0, cw[(ends - 1).clamp(min=0)], 0.0) - offset
    target = offset + alpha * total
    pos = torch.searchsorted(cw, target, side="left")
    pos = torch.minimum(torch.maximum(pos, starts), torch.maximum(ends - 1, starts))
    vals = r_s[pos.clamp(0, r_s.shape[0] - 1)]
    return torch.where(total > 0, vals, 0.0).to(torch.float32)


# ---------------------------------------------------------------------------------
# Booster
# ---------------------------------------------------------------------------------

@register_state_class
class GBDTBooster:
    """Trained model: stacked tree arrays (T, C, ...) + bin mapper + metadata.

    The arrays live on the host as numpy, in the reference's layout; scoring
    bins rows and runs the trees on a device (kernel B on a GPU, over the
    trees packed top-down once per device and tree count)."""

    def __init__(self, mapper: BinMapper, objective: str, num_class: int,
                 base_score, parent, feature, threshold, bin_, gain, leaf_value,
                 leaf_hess, tree_scale, boosting: str = "gbdt",
                 best_iteration: Optional[int] = None,
                 feature_names: Optional[List[str]] = None,
                 cat_set: Optional[np.ndarray] = None):
        self.mapper = mapper
        self.objective = objective
        self.num_class = num_class
        self.base_score = np.atleast_1d(np.asarray(base_score, dtype=np.float64))
        self.parent = parent          # (T, C, L-1) int32
        self.feature = feature        # (T, C, L-1) int32
        self.threshold = threshold    # (T, C, L-1) f64 raw-value thresholds
        self.bin = bin_               # (T, C, L-1) int32
        self.gain = gain              # (T, C, L-1) f32
        self.leaf_value = leaf_value  # (T, C, L) f32 (unscaled)
        self.leaf_hess = leaf_hess    # (T, C, L) f32
        self.tree_scale = tree_scale  # (T,) f64
        self.boosting = boosting
        self.best_iteration = best_iteration
        self.feature_names = feature_names
        self.cat_set = cat_set        # (T, C, L-1, B) int8 or None: category sets
        # set by train: a record per iteration of the eval sets' metrics, and
        # the rows with non-zero bagging/GOSS weight per iteration (or None)
        self.evals_result: List[Dict[str, Any]] = []
        self.sampled_rows: Optional[np.ndarray] = None
        self._device_trees: Dict[Any, tuple] = {}

    @property
    def num_trees(self) -> int:
        return self.parent.shape[0]

    def _used_trees(self, num_iteration: Optional[int]) -> int:
        t = self.best_iteration if num_iteration is None else num_iteration
        if t is None or t <= 0 or t > self.num_trees:
            t = self.num_trees
        return t

    def _trees_on(self, T: int, dev: torch.device) -> tuple:
        """(packed trees, leaf values, f32 scales) of the first ``T`` trees on
        ``dev``, built at the first call and kept."""
        from .device_predict import pack_trees

        key = (T, str(dev))
        if key not in self._device_trees:
            self._device_trees[key] = (
                pack_trees(self.parent[:T], self.feature[:T], self.bin[:T],
                           self._cat_sets(T), device=dev),
                torch.as_tensor(self.leaf_value[:T], dtype=torch.float32, device=dev),
                torch.as_tensor(self.tree_scale[:T].astype(np.float32), device=dev))
        return self._device_trees[key]

    def _cat_sets(self, T: int):
        return None if self.cat_set is None else self.cat_set[:T]

    def _binned_on(self, x, device):
        dev = resolve_device(device)
        xt = torch.as_tensor(x)
        return dev, self.mapper.transform_torch(xt.to(dev))

    def _csr_used(self, csr: CSRMatrix, T: int, dev: torch.device):
        """The features the first ``T`` trees use, of a CSR matrix (the
        reference's ``_csr_used_sub`` / ``_csr_used_binned``, ``boost.py:511-548``;
        at hashed width the full (n, d) matrix cannot be built, but the
        trees touch at most T * (L - 1) features). Returns (bins (n, |F|) on
        ``dev``: each stored entry's bin, the zero bin elsewhere, as the
        mapper bins the densified columns; the used features F ascending;
        the trees' features remapped to columns of F; the rows, columns in
        F and values of the stored entries of F)."""
        n, d = csr.shape
        if d != self.mapper.n_features:
            raise ValueError(f"expected {self.mapper.n_features} features, got {d}")
        F = np.unique(self.feature[:T]) if T else np.zeros(1, np.int64)
        lut = np.full(d, -1, np.int64)
        lut[F] = np.arange(len(F))
        k = lut[csr.indices]
        keep = k >= 0
        rows, k, vals = csr.row_ids()[keep].astype(np.int64), k[keep], csr.values[keep]
        bins = self.mapper.transform_csr_torch(torch.from_numpy(F[k]).to(dev),
                                               torch.from_numpy(vals).to(dev))
        zb = torch.from_numpy(self.mapper.zero_bins()[F]).to(dev)
        sub = zb.to(torch_bin_dtype(self.mapper.n_bins)).expand(n, len(F)).clone()
        sub[torch.from_numpy(rows).to(dev), torch.from_numpy(k).to(dev)] = bins.to(sub.dtype)
        feats = np.searchsorted(F, self.feature[:T]).astype(np.int32)
        return sub, F, feats, (rows, k, vals)

    def _raw_of_csr(self, csr: CSRMatrix, dev: torch.device) -> torch.Tensor:
        """(n, C) f64 margins of every used tree over CSR rows, on ``dev``."""
        T = self._used_trees(None)
        if T == 0:
            return self._raw_of_binned(torch.zeros(csr.shape[0], 1, device=dev), 0)
        sub, _, feats, _ = self._csr_used(csr, T, dev)
        return self._raw_of_binned(sub, T, feats)

    def _binned_rows(self, x, T: int, device):
        """(device, bins, remapped tree features or None) of dense or CSR rows."""
        if is_sparse_input(x):
            dev = resolve_device(device)
            sub, _, feats, _ = self._csr_used(as_csr(x), T, dev)
            return dev, sub, feats
        return (*self._binned_on(x, device), None)

    def raw_predict(self, x, num_iteration: Optional[int] = None,
                    device=None) -> np.ndarray:
        """Raw margin, shape (n,) or (n, C): bins ``x`` and scores the trees on
        ``device`` (default: the GPU, through kernel B), then adds the base
        score; an rf model averages its trees."""
        T = self._used_trees(num_iteration)
        if T == 0:
            resolve_device(device)
            out = np.tile(self.base_score, (x.shape[0], 1)).astype(np.float64)
        else:
            dev, binned, feats = self._binned_rows(x, T, device)
            out = self._raw_of_binned(binned, T, feats).cpu().numpy()
        return out[:, 0] if self.num_class == 1 else out

    def _raw_of_binned(self, binned: torch.Tensor, T: int,
                       feature: Optional[np.ndarray] = None) -> torch.Tensor:
        """(n, C) f64 raw margins of the first ``T`` trees over rows binned by
        this booster's mapper, on their device: the trees' f32 scores (kernel
        B on a GPU) plus the base score in f64, as :meth:`raw_predict` gives
        them. ``feature``: the trees' features remapped to the columns of
        ``binned`` (CSR rows' used features); None: the booster's own."""
        from .device_predict import device_raw_scores

        dev = binned.device
        base = torch.as_tensor(self.base_score, dtype=torch.float64, device=dev)[None, :]
        if T == 0:
            return base.expand(binned.shape[0], -1).clone()
        if dev.type == "cuda" and feature is None:
            packed, leaf_value, scale = self._trees_on(T, dev)
        else:
            packed, leaf_value, scale = None, self.leaf_value[:T], self.tree_scale[:T]
        scores = device_raw_scores(binned, self.parent[:T],
                                   self.feature[:T] if feature is None else feature,
                                   self.bin[:T], leaf_value, scale, self._cat_sets(T),
                                   packed=packed)
        out = base + scores.to(torch.float64)
        if self.boosting == "rf":  # rf averages its trees
            out = base + (out - base) / T
        return out

    def predict_leaf(self, x, num_iteration: Optional[int] = None,
                     device=None) -> np.ndarray:
        """Leaf index of every row in every tree, (n, T*C) int32, column
        ``t*C + c`` for tree ``t`` and class ``c`` (the reference's
        ``predict_leaf`` for dense input); on ``device`` as ``raw_predict``."""
        from .device_predict import device_leaf_indices

        T = self._used_trees(num_iteration)
        n = x.shape[0]
        if T == 0:
            resolve_device(device)
            return np.zeros((n, 0), dtype=np.int32)
        dev, binned, feats = self._binned_rows(x, T, device)
        packed = (self._trees_on(T, dev)[0] if dev.type == "cuda" and feats is None
                  else None)
        leaves = device_leaf_indices(binned, self.parent[:T],
                                     self.feature[:T] if feats is None else feats,
                                     self.bin[:T], self._cat_sets(T), packed=packed)
        return leaves.permute(2, 0, 1).reshape(n, T * self.num_class).cpu().numpy()

    def predict(self, x, num_iteration: Optional[int] = None, device=None) -> np.ndarray:
        """Probability for binary and multiclass, value for regression."""
        return self.activate(self.raw_predict(x, num_iteration, device=device))

    def activate(self, raw: np.ndarray) -> np.ndarray:
        """The objective's link function over a raw margin."""
        if self.objective == "binary":
            return np.where(raw >= 0, 1 / (1 + np.exp(-np.abs(raw))),
                            np.exp(-np.abs(raw)) / (1 + np.exp(-np.abs(raw))))
        if self.objective in _MULTICLASS:
            p = np.exp(raw - raw.max(axis=1, keepdims=True))
            return p / p.sum(axis=1, keepdims=True)
        if self.objective in ("poisson", "tweedie"):
            return np.exp(raw)
        return raw

    # -- explanation ---------------------------------------------------------------

    def predict_contrib(self, x, num_iteration: Optional[int] = None,
                        approximate: bool = False, device=None) -> np.ndarray:
        """Per-feature contributions plus the expected value (last column):
        (n, d+1), or (C, n, d+1) for multiclass; each row sums to
        ``raw_predict``. Exact TreeSHAP by default (the reference's
        ``featuresShap``), ``approximate=True`` for Saabas path attribution.

        The rows are binned on ``device`` (kernel D on a GPU) and the bins
        brought to the host, where the tree walks run in numpy. Saabas
        departs from the reference twice (ROADMAP queue 3): a split with
        ``bin < 0`` routes by its set's membership of the row's bin, as the
        exact path does (the reference compares the raw value with the
        threshold, which misroutes imported ``zero_as_missing`` splits), and
        the refusal of categorical splits looks at the first ``T`` trees
        only, the ones it walks.

        CSR rows (the reference's ``_predict_contrib_sparse``, ``boost.py:759``)
        give a :class:`~.sparse.CSRMatrix` of shape (n, d+1), or a list of C
        of them, storing the trees' used features and the expected value
        (column d) of every row: a feature no tree uses contributes 0."""
        if is_sparse_input(x):
            return self._predict_contrib_sparse(as_csr(x), num_iteration, approximate, device)
        xv = torch.as_tensor(x)
        n, d = xv.shape
        binned = self._binned_on(xv, device)[1].cpu().numpy().astype(np.int32)
        if not approximate:
            out = self._contrib_shap_panel(binned, n, d, num_iteration)
        else:
            out = self._contrib_saabas_panel(xv.cpu().numpy().astype(np.float64), binned,
                                             n, d, num_iteration)
        out[:, :, d] += self.base_score[:, None]
        return out[0] if self.num_class == 1 else out

    def _predict_contrib_sparse(self, csr: CSRMatrix, num_iteration, approximate: bool,
                                device):
        T = self._used_trees(num_iteration)
        n, d = csr.shape
        sub, F, feats, (rows, k, vals) = self._csr_used(csr, T, resolve_device(device))
        binned = sub.cpu().numpy().astype(np.int32)
        dF = len(F)
        if not approximate:
            out = self._contrib_shap_panel(binned, n, dF, num_iteration, feats)
        else:
            raw = np.zeros((n, dF))
            raw[rows, k] = vals
            out = self._contrib_saabas_panel(raw, binned, n, dF, num_iteration, feats)
        out[:, :, dF] += self.base_score[:, None]
        cols = np.concatenate([F.astype(np.int64), [d]])
        indptr = np.arange(0, n * (dF + 1) + 1, dF + 1, dtype=np.int64)
        mats = [CSRMatrix(indptr, np.tile(cols, n).astype(np.int32), out[c].reshape(-1),
                          (n, d + 1)) for c in range(self.num_class)]
        return mats[0] if self.num_class == 1 else mats

    def _contrib_saabas_panel(self, xv: np.ndarray, binned: np.ndarray, n: int, d: int,
                              num_iteration, feature: Optional[np.ndarray] = None
                              ) -> np.ndarray:
        """Saabas attributions, (C, n, d+1) without the base score (the
        reference's ``_contrib_saabas_panel``, ``boost.py:782``, with the two
        departures of :meth:`predict_contrib`); ``feature`` remaps the trees'
        features to the columns of ``xv`` and ``binned``."""
        T = self._used_trees(num_iteration)
        if self.cat_set is not None and bool(
                ((self.bin[:T] < 0) & ~np.isfinite(self.threshold[:T])
                 & (self.parent[:T] >= 0)).any()):
            raise ValueError("approximate (Saabas) contributions don't support "
                             "categorical splits; use approximate=False")
        C = self.num_class
        out = np.zeros((C, n, d + 1), dtype=np.float64)
        for t in range(T):
            sc = self.tree_scale[t] * (1.0 / T if self.boosting == "rf" else 1.0)
            for c in range(C):
                par = self.parent[t, c]
                feat = (self.feature if feature is None else feature)[t, c]
                thr = self.threshold[t, c]
                V = self.leaf_value[t, c].astype(np.float64).copy()
                Hs = np.maximum(self.leaf_hess[t, c].astype(np.float64), 1e-12).copy()
                L1 = par.shape[0]
                left_val = np.zeros(L1)
                right_val = np.zeros(L1)
                for s in range(L1 - 1, -1, -1):
                    p = par[s]
                    if p < 0:
                        continue
                    left_val[s], right_val[s] = V[p], V[s + 1]
                    tot = Hs[p] + Hs[s + 1]
                    V[p] = (V[p] * Hs[p] + V[s + 1] * Hs[s + 1]) / tot
                    Hs[p] = tot
                node = np.zeros(n, dtype=np.int32)
                cur = np.full(n, V[0])
                out[c, :, d] += V[0] * sc
                for s in range(L1):
                    p = par[s]
                    if p < 0:
                        continue
                    col = xv[:, feat[s]]
                    at_p = node == p
                    if self.bin[t, c, s] < 0:  # a set split: left = the bin is in the set
                        go_right = at_p & ~(self.cat_set[t, c, s][binned[:, feat[s]]] > 0)
                    else:
                        with np.errstate(invalid="ignore"):
                            go_right = at_p & (np.isnan(col) | (col > thr[s]))
                    go_left = at_p & ~go_right
                    new = np.where(go_right, right_val[s], np.where(go_left, left_val[s], cur))
                    out[c, at_p, feat[s]] += (new[at_p] - cur[at_p]) * sc
                    node[go_right] = s + 1
                    cur = new
        return out

    def _contrib_shap_panel(self, binned: np.ndarray, n: int, d: int,
                            num_iteration, feature: Optional[np.ndarray] = None
                            ) -> np.ndarray:
        """Exact TreeSHAP, (C, n, d+1) without the base score; each row sums,
        with the base, to ``raw_predict``; ``feature`` as in
        :meth:`_contrib_saabas_panel`."""
        from .treeshap import build_explicit_tree, expected_value, tree_shap

        T = self._used_trees(num_iteration)
        C = self.num_class
        out = np.zeros((C, n, d + 1), dtype=np.float64)
        for t in range(T):
            sc = self.tree_scale[t] * (1.0 / T if self.boosting == "rf" else 1.0)
            for c in range(C):
                root = build_explicit_tree(
                    self.parent[t, c], (self.feature if feature is None else feature)[t, c],
                    self.bin[t, c],
                    self.leaf_value[t, c], self.leaf_hess[t, c],
                    self.cat_set[t, c] if self.cat_set is not None else None)
                out[c, :, :d] += sc * tree_shap(root, binned, d)
                out[c, :, d] += sc * expected_value(root)
        return out

    def feature_importance(self, importance_type: str = "split",
                           num_iteration: Optional[int] = None) -> np.ndarray:
        """Per feature, the count of splits on it ('split') or the sum of
        their gains ('gain'), over the first ``num_iteration`` trees."""
        T = self._used_trees(num_iteration)
        out = np.zeros(self.mapper.n_features)
        used = self.parent[:T] >= 0
        feats = self.feature[:T][used]
        if importance_type == "split":
            np.add.at(out, feats, 1.0)
        elif importance_type == "gain":
            np.add.at(out, feats, self.gain[:T][used].astype(np.float64))
        else:
            raise ValueError(f"importance_type must be 'split'|'gain', got {importance_type!r}")
        return out

    # -- persistence ---------------------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        """The reference booster's persistence dictionary (``boost.py:880``)."""
        return {
            "parent": self.parent, "feature": self.feature,
            "threshold": self.threshold, "bin": self.bin, "gain": self.gain,
            "leaf_value": self.leaf_value, "leaf_hess": self.leaf_hess,
            "tree_scale": self.tree_scale, "base_score": self.base_score,
            "objective": self.objective, "num_class": self.num_class,
            "boosting": self.boosting, "best_iteration": self.best_iteration,
            "feature_names": self.feature_names, "mapper": self.mapper.to_dict(),
            "cat_set": self.cat_set,
        }

    @staticmethod
    def from_state_dict(d: Dict[str, Any]) -> "GBDTBooster":
        """Build a booster from a ``state_dict`` — this port's or the reference's
        (any objective: scoring reads it only for the link function)."""
        boosting = str(d.get("boosting", "gbdt"))
        if boosting not in ("gbdt", "goss", "dart", "rf"):
            raise NotImplementedError(f"boosting {boosting!r} is not ported yet")
        mapper = d["mapper"]
        if not isinstance(mapper, dict):  # JSON round-trip may hand back a string
            mapper = json.loads(str(mapper))
        return GBDTBooster(
            mapper=BinMapper.from_dict(mapper),
            objective=str(d["objective"]), num_class=int(d["num_class"]),
            base_score=np.asarray(d["base_score"]),
            parent=np.asarray(d["parent"], dtype=np.int32),
            feature=np.asarray(d["feature"], dtype=np.int32),
            threshold=np.asarray(d["threshold"], dtype=np.float64),
            bin_=np.asarray(d["bin"], dtype=np.int32),
            gain=np.asarray(d["gain"], dtype=np.float32),
            leaf_value=np.asarray(d["leaf_value"], dtype=np.float32),
            leaf_hess=np.asarray(d["leaf_hess"], dtype=np.float32),
            tree_scale=np.asarray(d["tree_scale"], dtype=np.float64),
            boosting=boosting,
            best_iteration=d.get("best_iteration"),
            feature_names=list(d["feature_names"]) if d.get("feature_names") else None,
            cat_set=(np.asarray(d["cat_set"], dtype=np.int8)
                     if d.get("cat_set") is not None else None),
        )


    def save_native_model(self) -> str:
        """LightGBM's text model (a stock LightGBM loads it; the reference's
        ``save_native_model``, byte for byte)."""
        from .native_model import booster_to_native

        return booster_to_native(self)

    @staticmethod
    def from_native_model(model_str: str) -> "GBDTBooster":
        """A booster from LightGBM's text model: its mapper's edges are the
        model's own thresholds, so binned scoring (kernels D and B on a GPU)
        takes the model's decisions."""
        from .native_model import booster_from_native

        return booster_from_native(model_str)

    def to_json(self) -> str:
        """The reference's JSON model string (``synapseml_tpu.gbdt.v1``), which
        either package reads."""
        return json.dumps({
            "format": "synapseml_tpu.gbdt.v1",
            "objective": self.objective,
            "num_class": self.num_class,
            "boosting": self.boosting,
            "base_score": self.base_score.tolist(),
            "best_iteration": self.best_iteration,
            "feature_names": self.feature_names,
            "mapper": self.mapper.to_dict(),
            "tree_scale": self.tree_scale.tolist(),
            "arrays": {k: getattr(self, k).tolist()
                       for k in ("parent", "feature", "threshold", "bin", "gain",
                                 "leaf_value", "leaf_hess")},
            "cat_set": self.cat_set.tolist() if self.cat_set is not None else None,
        })

    @staticmethod
    def from_json(s: str) -> "GBDTBooster":
        d = json.loads(s)
        if d.get("format") != "synapseml_tpu.gbdt.v1":
            raise ValueError(f"not a gbdt model string (format={d.get('format')!r})")
        return GBDTBooster.from_state_dict(dict(d["arrays"], **{
            k: d.get(k) for k in ("objective", "num_class", "boosting", "base_score",
                                  "best_iteration", "feature_names", "mapper",
                                  "tree_scale", "cat_set")}))

    @staticmethod
    def from_model_string(s: str) -> "GBDTBooster":
        """A booster from either model string, told apart by its first
        character: the JSON one or LightGBM's text."""
        if s.lstrip()[:1] == "{":
            return GBDTBooster.from_json(s)
        return GBDTBooster.from_native_model(s)


def _categorical_indices(cats, feature_names) -> List[int]:
    """``categorical_feature`` as sorted column indices: indices, or names
    looked up in ``feature_names`` (the reference's rule, ``boost.py:1659-1665``)."""
    cat_raw = list(cats or [])
    if any(not isinstance(c, (int, np.integer)) for c in cat_raw):
        if not feature_names:
            raise ValueError("categorical_feature names require feature_names")
        cat_raw = [list(feature_names).index(c) if isinstance(c, str) else int(c)
                   for c in cat_raw]
    return sorted({int(c) for c in cat_raw})


def _check_boosting(p: Dict[str, Any], obj_name: str) -> str:
    """The reference's checks of the boosting type and its sampling
    parameters (``boost.py:1755-1780``)."""
    boosting = p["boosting"]
    if boosting not in ("gbdt", "goss", "dart", "rf"):
        raise ValueError(f"boosting must be gbdt|goss|dart|rf, got {boosting!r}")
    if boosting == "dart" and int(p["early_stopping_round"]) > 0:
        # DART rescales earlier trees after the best iteration, so a model cut
        # at best_iteration cannot reproduce the margins that were evaluated
        warnings.warn("early_stopping_round is ignored with boosting='dart': "
                      "DART rescales earlier trees after the best iteration, so "
                      "truncating at best_iteration is not reproducible", stacklevel=3)
    class_bagging = (float(p["pos_bagging_fraction"]) < 1.0
                     or float(p["neg_bagging_fraction"]) < 1.0)
    if class_bagging and obj_name != "binary":
        raise ValueError("pos/neg_bagging_fraction require objective='binary'")
    if boosting == "rf" and not ((float(p["bagging_fraction"]) < 1.0 or class_bagging)
                                 and int(p["bagging_freq"]) > 0):
        # without bagging every rf tree sees the same gradients
        raise ValueError("boosting='rf' requires bagging_fraction < 1.0 (or "
                         "class-aware pos/neg fractions) and bagging_freq > 0")
    return boosting


class _EvalSet:
    """One eval set on the device: its bins, labels, unit weights and margins
    (f32; f64 under DART, whose margins the reference keeps in numpy f64).
    ``n_bins``: the compact bin count of a sparse fit (CSR rows become a
    :class:`~.sparse.SparseBinned`, dense rows have the missing bin moved
    down to it); None for a dense fit, which takes no CSR rows."""

    def __init__(self, mapper: BinMapper, x, y, base: np.ndarray, dev, dtype,
                 init_booster: Optional["GBDTBooster"] = None,
                 n_bins: Optional[int] = None):
        if is_sparse_input(x):
            if n_bins is None:
                # compact eval bins against dense-space trees would misroute
                # missing values (the reference's rule, boost.py:2098-2102)
                raise ValueError("sparse eval_set requires sparse training features")
            csr = as_csr(x)
            self.binned = build_sparse_binned(csr, mapper, dev)
            prior = (None if init_booster is None else
                     init_booster._raw_of_csr(csr, dev))
        else:
            xt = torch.as_tensor(x).to(dev)
            self.binned = mapper.transform_torch(xt)
            prior = (None if init_booster is None else
                     _init_margins(init_booster, mapper, self.binned, xt, dev))
            if n_bins is not None:
                self.binned = torch.clamp(self.binned, max=n_bins - 1)
        self.y_np = np.asarray(y, dtype=np.float64)
        self.y = torch.as_tensor(self.y_np, dtype=torch.float32, device=dev)
        self.w = torch.ones(len(self.y_np), dtype=torch.float32, device=dev)
        if prior is None:
            self.raw = torch.zeros(len(self.y_np), len(base), dtype=dtype, device=dev) + \
                torch.as_tensor(base, dtype=dtype, device=dev)
        else:  # continued training: the prior trees' margins
            self.raw = prior.to(dtype)

    def leaf_values(self, tree: GrownTree) -> torch.Tensor:
        """The tree's (unscaled) leaf value for every row: one routing pass."""
        return tree.leaf_value[predict_binned(tree, self.binned).long()]


def _init_margins(init_booster: "GBDTBooster", mapper: BinMapper, binned: torch.Tensor,
                  x: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """(n, C) f64 margins of ``init_booster`` over the rows ``x`` (``binned``
    by ``mapper`` on ``dev``), scored on ``dev``: the reference's
    ``init_booster.raw_predict(x)``, without bringing ``x`` to the host. The
    rows move to ``dev`` only when the booster bins them otherwise."""
    if init_booster.mapper is not mapper:
        binned = init_booster.mapper.transform_torch(x.to(dev))
    return init_booster._raw_of_binned(binned, init_booster._used_trees(None))


def _warn_binning_ignored(dataset: "GBDTDataset", params_c: Dict[str, Any],
                          cat_features: List[int]) -> None:
    """The dataset's binning wins over the fit's parameters: warn where a
    parameter the caller set (under any alias) disagrees with it (the
    reference's checks, ``boost.py:1669-1699``)."""
    mapper = dataset.mapper
    if "max_bin" in params_c and int(params_c["max_bin"]) != dataset.max_bin:
        warnings.warn(f"max_bin={params_c['max_bin']} ignored: the GBDTDataset was "
                      f"binned with max_bin={dataset.max_bin}", stacklevel=3)
    for k, current in (("max_bin_by_feature", mapper.max_bin_by_feature),
                       ("bin_sample_count", mapper.sample_cnt)):
        requested = params_c.get(k)
        # only a real mismatch: the estimators pass their defaults
        if requested is not None and (requested or None) != (current or None):
            warnings.warn(f"{k}={requested} ignored: the GBDTDataset owns binning "
                          "(pass binning params to GBDTDataset instead)", stacklevel=3)
    if params_c.get("categorical_feature") and \
            sorted(cat_features) != sorted(mapper.categorical_features):
        warnings.warn(f"categorical_feature={cat_features} conflicts with the "
                      f"GBDTDataset's {sorted(mapper.categorical_features)}; the "
                      "dataset's binning wins (pass categorical_features to "
                      "GBDTDataset instead)", stacklevel=3)


def _rank_block(mrows: _MeshRows, layout: SpecLayout, dataset: Optional[GBDTDataset],
                mapper: BinMapper, xt: Optional[torch.Tensor], csr: Optional[CSRMatrix],
                dev: torch.device, need_csr: bool):
    """(bins, rows, CSR rows) of this rank's block on ``dev``: dense rows are
    binned there (kernel D over the block), a dataset's cached bins are
    taken by row without binning again (on their device for a
    device-resident dataset), CSR rows are binned and laid out a block
    (:func:`~.sparse.shard_sparse_binned`). The rows (dense) and CSR rows
    are the block's, for continued training's margins (CSR only with
    ``need_csr``)."""
    rows = torch.from_numpy(mrows.rows)
    if csr is not None:
        if mrows.lambdarank:  # whole queries a rank: no wrapped padding
            local = csr.take_rows(mrows.rows)
            return build_sparse_binned(local, mapper, dev), None, local
        binned, _ = shard_sparse_binned(csr, mapper, layout.data_size,
                                        mrows.n_global - csr.shape[0], layout.data_rank, dev)
        return binned, None, csr.take_rows(mrows.rows) if need_csr else None
    if xt is not None:
        xt = xt.index_select(0, rows.to(xt.device))
    if dataset is not None and mapper is dataset.mapper:
        if dataset.is_device:
            full = dataset.device_binned()
            return full.index_select(0, rows.to(full.device)), xt, None
        return torch.from_numpy(dataset.binned_np[mrows.rows].astype(
            dataset.bin_dtype)).to(dev), xt, None
    return mapper.transform_torch(xt.to(dev)), xt, None


def _merge_boosters(a: GBDTBooster, b: GBDTBooster) -> GBDTBooster:
    """``a``'s trees followed by ``b``'s, under ``b``'s mapper and ``a``'s base
    score (the reference's ``_merge_boosters``, ``boost.py:2479``)."""
    if a.num_class != b.num_class or a.objective != b.objective:
        raise ValueError("cannot merge boosters with different objective/num_class")
    merged = GBDTBooster(
        mapper=b.mapper, objective=b.objective, num_class=b.num_class,
        base_score=a.base_score,
        parent=np.concatenate([a.parent, b.parent]),
        feature=np.concatenate([a.feature, b.feature]),
        threshold=np.concatenate([a.threshold, b.threshold]),
        bin_=np.concatenate([a.bin, b.bin]),
        gain=np.concatenate([a.gain, b.gain]),
        leaf_value=np.concatenate([a.leaf_value, b.leaf_value]),
        leaf_hess=np.concatenate([a.leaf_hess, b.leaf_hess]),
        tree_scale=np.concatenate([a.tree_scale, b.tree_scale]),
        boosting=b.boosting, best_iteration=None, feature_names=b.feature_names,
        cat_set=_merge_cat_sets(a, b))
    merged.evals_result = b.evals_result
    if a.sampled_rows is not None and b.sampled_rows is not None:
        merged.sampled_rows = np.concatenate([a.sampled_rows, b.sampled_rows])
    return merged


def _merge_cat_sets(a: GBDTBooster, b: GBDTBooster) -> Optional[np.ndarray]:
    """The category sets of the merged trees; a booster without sets gets
    empty rows of the other's width."""
    if a.cat_set is None and b.cat_set is None:
        return None

    def expand(x: GBDTBooster, other: GBDTBooster) -> np.ndarray:
        if x.cat_set is not None:
            return x.cat_set
        return np.zeros((x.parent.shape[0],) + other.cat_set.shape[1:], dtype=np.int8)

    return np.concatenate([expand(a, b), expand(b, a)])


def train(params: Dict[str, Any], x, y=None, weight: Optional[np.ndarray] = None,
          device=None, feature_names: Optional[List[str]] = None,
          eval_set: Optional[Sequence[Tuple[Any, Any]]] = None,
          group: Optional[np.ndarray] = None,
          eval_group: Optional[Sequence[np.ndarray]] = None,
          fobj: Optional[Callable] = None, mapper: Optional[BinMapper] = None,
          init_booster: Optional[GBDTBooster] = None,
          callbacks: Optional[Sequence[Callable]] = None,
          mesh=None, axis: str = "data") -> GBDTBooster:
    """Train a booster on ``device`` (default: the GPU; ``"cpu"`` runs the
    plain PyTorch versions of the kernels).

    ``x`` is an (n, d) float matrix (numpy or tensor), a sparse one (a
    :class:`~.sparse.CSRMatrix` or scipy sparse: fitted by
    ``BinMapper.fit_csr``, binned into the compact space of
    ``realized_n_bins``, grown by :func:`~.grow.grow_tree_sparse`; its eval
    sets may be CSR too) or a :class:`~.dataset.GBDTDataset`, ``y`` and
    ``weight`` (n,) arrays (``y`` holds class indices for multiclass; numpy
    or a tensor).

    A :class:`~.dataset.GBDTDataset` owns its binning: the fit takes its
    mapper (unless ``mapper`` or ``init_booster`` brings another) and its
    cached bins on its device, and bins and uploads nothing; ``y=None``
    takes its label, ``device=None`` its device, and a ``max_bin``,
    ``max_bin_by_feature``, ``bin_sample_count`` or ``categorical_feature``
    that disagrees with it warns and is ignored. A device-resident dataset
    (built from a tensor) refuses a ``mapper`` of its own; continued
    training from it scores the init booster over the cached bins, on the
    device. Eval sets may be datasets too (their rows are used).
    ``eval_set``: ``(x, y)`` pairs scored after every iteration with
    ``metric``; the first one drives early stopping. The booster's
    ``evals_result`` holds a record per iteration
    (``{"iteration": i, "eval0_<metric>": value, ...}``).
    ``objective="lambdarank"`` takes ``group``, the query sizes of the rows,
    which are contiguous by query, and ``eval_group``, one such array per
    eval set; its metric is ``ndcg@<ndcg_at>``.

    ``fobj(score, y, w) -> (grad, hess)`` is a custom objective (the
    reference's hook): it gets the fit's device tensors, ``score`` (n,) f32
    for one class or (n, C), and its output is cast to f32, shaped (n, C)
    and pre-rounded like a built-in objective's; the named ``objective``
    still sets the base score and the metric. ``mapper``: a fitted
    :class:`~.binning.BinMapper` to bin with (its edges and categorical
    features win over the binning parameters). ``init_booster`` continues
    training: its mapper (unless ``mapper`` is given) and base score are
    reused, the fit starts from its margins (scored on ``device``), the eval
    sets' margins start from its trees, and the result holds its trees
    followed by the new ones (``best_iteration`` None); a different
    objective or ``num_class`` raises ``ValueError``. ``callbacks``: each is
    called after an iteration's eval with ``{"iteration": it, "evals": the
    iteration's eval record or None}``; a truthy return stops training after
    that iteration, keeping its trees (eval sets are then scored on the host
    each iteration, as the reference's host loop does).

    Every dense tree grows over a row partition on the device, histogramming
    only the smaller child of each split, and every sparse tree sums only
    the smaller child of a split whose parent's histograms it kept
    (:mod:`.grow`). ``leaf_local`` has no effect, like ``hist_method`` and
    ``hist_chunk``: they choose between the reference's XLA formulations
    (its full pass or its leaf-local half pass; gather, scatter or one-hot
    histograms), and the port has one growth path for each input kind and
    one histogram kernel for each.

    ``mesh``: a :class:`~synapseml_tpu_torch.runtime.layout.SpecLayout` (or
    a raw ``DeviceMesh``, whose ``axis`` names the rows) over an initialised
    process group: every rank calls ``train`` with the same arguments and
    fits its block of the rows (module docstring). ``parallelism``
    ``"data_parallel"`` all-reduces every histogram; a model axis of size >
    1 then splits each histogram's columns over it (dense input);
    ``"voting_parallel"`` (with ``top_k``) keeps histograms local and
    all-reduces only the voted candidates (the model axis replicates, as
    for sparse input). Quantile and L1 leaves are not renewed on a mesh
    (the percentile would need a global sort), as in the reference. The
    mesh's device type must be ``device``'s."""
    dataset = x if isinstance(x, GBDTDataset) else None
    y_d = None
    if dataset is not None:
        if device is not None and resolve_device(device) != dataset.device:
            raise ValueError(f"the GBDTDataset lives on {dataset.device}; "
                             f"train(device={device!r}) cannot use it")
        device, x = dataset.device, dataset.x
        if feature_names is None:
            feature_names = dataset.feature_names
        if y is None:
            if dataset.label_np is None:
                raise ValueError("y is required unless the GBDTDataset carries a "
                                 "label (GBDTDataset(x, label=y))")
            y, y_d = dataset.label_np, dataset.label_device()
        if (dataset.is_device and mapper is not None
                and mapper is not dataset.mapper):
            raise ValueError("a device-resident GBDTDataset owns its binning; "
                             "an overriding mapper would need the raw matrix "
                             "on the host")
    elif y is None:
        raise ValueError("y is required unless x is a GBDTDataset with a label")
    dev = resolve_device(device)
    layout = None
    if mesh is not None:
        layout = as_layout(mesh, data_axis=axis)
        if layout.device_type != dev.type:
            raise ValueError(f"the mesh is on {layout.device_type!r} devices and the fit on "
                             f"{dev}: pass device= to match the mesh")
    params_c = _canonicalize_params(params)
    p = dict(_DEFAULTS)
    p.update(params_c)
    obj_name = p["objective"]
    sparse_in = is_sparse_input(x)
    if sparse_in:
        csr, xt = as_csr(x), None
        n, d = csr.shape
    else:
        csr, xt = None, torch.as_tensor(x)
        n, d = xt.shape
    if isinstance(y, torch.Tensor):
        y_d = y.to(dev, torch.float32)
        y = y.detach().cpu().numpy()
    y = np.asarray(y, dtype=np.float64)
    w_np = np.ones(n) if weight is None else np.asarray(weight, dtype=np.float64) + 0.0

    ndcg_fn = lr_mesh = None
    if obj_name == "lambdarank":  # the reference's checks, boost.py:1631-1652, :2076-2082
        if group is None:
            raise ValueError("objective='lambdarank' requires group (query sizes, "
                             "rows ordered by query)")
        if int(np.sum(group)) != n:
            raise ValueError(f"group sizes sum to {int(np.sum(group))}, expected {n}")
        if eval_set and (eval_group is None or len(eval_group) != len(eval_set)):
            raise ValueError("lambdarank eval_set requires matching eval_group")
        if layout is None:
            init_fn, grad_fn = make_lambdarank(group, y, int(p["lambdarank_truncation_level"]),
                                               float(p["sigmoid"]), dev)
        else:
            lr_mesh = make_lambdarank_mesh(group, y, layout.data_size, layout.data_rank,
                                           int(p["lambdarank_truncation_level"]),
                                           float(p["sigmoid"]), dev)
            init_fn, grad_fn = lr_mesh[:2]
        metric_name = f"ndcg@{int(p['ndcg_at'])}"
        ndcg_fn, metric_fn, higher_better = metric_ndcg(int(p["ndcg_at"])), None, True
    else:
        init_fn, grad_fn = _resolve_objective(p)
        metric_name = p["metric"] or DEFAULT_METRIC.get(obj_name, "l2")
        if metric_name not in METRICS:
            raise ValueError(f"unknown metric {metric_name!r}; available: {sorted(METRICS)}")
        metric_fn, higher_better = METRICS[metric_name]
    C = int(p["num_class"]) if obj_name in _MULTICLASS else 1
    boosting = _check_boosting(p, obj_name)
    parallelism = str(p["parallelism"])
    if parallelism not in ("data_parallel", "data", "voting_parallel", "voting"):
        raise ValueError(f"parallelism must be data_parallel|voting_parallel, "
                         f"got {parallelism!r}")
    if init_booster is not None and (init_booster.num_class != C or (
            init_booster.num_trees and init_booster.objective != obj_name)):
        raise ValueError("cannot merge boosters with different objective/num_class")

    if mapper is None and init_booster is not None:
        mapper = init_booster.mapper
    if mapper is None and dataset is not None:
        mapper = dataset.mapper
        _warn_binning_ignored(dataset, params_c, _categorical_indices(
            p["categorical_feature"], feature_names))
    if mapper is None:
        cat_features = _categorical_indices(p["categorical_feature"], feature_names)
        mapper = BinMapper(max_bin=int(p["max_bin"]), seed=int(p["seed"]),
                           sample_cnt=int(p["bin_sample_count"]),
                           max_bin_by_feature=p["max_bin_by_feature"],
                           categorical_features=cat_features)
        if sparse_in:
            mapper.fit_csr(csr)
        else:
            mapper.fit(xt.numpy() if xt.device.type == "cpu" else xt.cpu().numpy())
    # the base score over every row, before a mesh takes this rank's
    base_y, base_w = y, w_np
    n_glob = n
    if layout is not None:  # this rank's block of the rows
        mrows = _MeshRows(layout, n, lr_mesh)
        binned, xt, csr = _rank_block(mrows, layout, dataset, mapper, xt, csr, dev,
                                      need_csr=init_booster is not None)
        y, w_np = y[mrows.rows], mrows.weights(w_np)
        if y_d is not None:
            y_d = y_d.index_select(0, torch.from_numpy(mrows.rows).to(y_d.device))
        n, n_glob = mrows.local, mrows.n_global
    elif dataset is not None and mapper is dataset.mapper:
        binned = dataset.device_binned()  # binned and moved once a dataset
    elif sparse_in:
        binned = build_sparse_binned(csr, mapper, dev)
    else:
        binned = mapper.transform_torch(xt.to(dev))  # kernel D where exact
    has_cat = bool(mapper.categorical_features)
    cat_mask = None
    if has_cat:
        cat_mask = torch.zeros(d, dtype=torch.float32, device=dev)
        cat_mask[mapper.categorical_features] = 1.0

    if init_booster is not None:
        base = init_booster.base_score.copy()
    else:
        base = np.atleast_1d(np.asarray(init_fn(base_y, base_w), dtype=np.float64))
        if not p["boost_from_average"]:
            base = np.zeros_like(base)
    # rf averages trees that each fit the base score's residual
    lr = float(p["learning_rate"]) if boosting != "rf" else 1.0
    cfg = TreeConfig(
        # sparse fits grow in the compact bin space (the bins the data realise)
        n_bins=mapper.realized_n_bins if sparse_in else mapper.n_bins,
        num_leaves=int(p["num_leaves"]),
        lambda_l1=float(p["lambda_l1"]), lambda_l2=float(p["lambda_l2"]),
        min_data_in_leaf=float(p["min_data_in_leaf"]),
        min_sum_hessian=float(p["min_sum_hessian_in_leaf"]),
        min_gain_to_split=float(p["min_gain_to_split"]),
        cat_smooth=float(p["cat_smooth"]), max_cat_threshold=int(p["max_cat_threshold"]),
        max_depth=int(p["max_depth"]), max_delta_step=float(p["max_delta_step"]))
    L = cfg.num_leaves
    # summation-exact rounding bound: the next power of two over the (global,
    # padded) row count
    n_bound = 1 << max(int(n_glob) - 1, 1).bit_length()
    # percentile leaf renewal: quantile at its alpha, l1 at the median (not
    # on a mesh, as in the reference)
    renew_alpha = (None if fobj is not None or layout is not None
                   else {"quantile": float(p["alpha"]), "l1": 0.5, "mae": 0.5}.get(obj_name))

    if y_d is None:
        y_d = torch.as_tensor(y, dtype=torch.float32, device=dev)
    w_d = torch.as_tensor(w_np, dtype=torch.float32, device=dev)
    if init_booster is not None:  # the prior trees' margins, scored on the device
        raw = (init_booster._raw_of_csr(csr, dev) if sparse_in else
               _init_margins(init_booster, mapper, binned, xt, dev)).to(torch.float32)
    else:
        raw = torch.zeros(n, C, dtype=torch.float32, device=dev) + torch.as_tensor(
            base, dtype=torch.float32, device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    tmesh = live = None
    if layout is not None:
        # the padding slots (weight -0.0) count 0 in every histogram
        live = ~(torch.signbit(w_d) & (w_d == 0))
        ones = live.to(torch.float32)
        voting = parallelism.startswith("voting")
        block = (layout.feature_block(d) if layout.model_size > 1 and not sparse_in
                 and not voting else None)
        tmesh = TreeMesh(layout, voting, int(p["top_k"]), block,
                         None if block is None else binned[:, block[0]:block[1]].contiguous())
    fmask = torch.ones(d, dtype=torch.float32, device=dev)
    if not sparse_in:  # every tree of the fit; kernel E reads fmask through its pointer
        workspace = SplitWorkspace(d, fmask, cat_mask, cfg, dev)
        partition = RowPartition(n, L, dev)
    sampler = Sampler(p, y_d, d, goss=boosting == "goss",
                      shard=None if layout is None else layout.data_rank)

    dart = boosting == "dart"
    # DART (f64 margins), ndcg (query groups) and callbacks (a record each
    # iteration) take the reference's host metric: numpy over f64 margins
    host_eval = dart or ndcg_fn is not None or bool(callbacks)
    evals_in = [_EvalSet(mapper, ex.x if isinstance(ex, GBDTDataset) else ex, ey, base,
                         dev, torch.float64 if host_eval else torch.float32,
                         init_booster, cfg.n_bins if sparse_in else None)
                for ex, ey in (eval_set or ())]
    dev_metric = None if host_eval else device_metric(metric_name)
    base_d = torch.as_tensor(base, dtype=torch.float32, device=dev)[None, :]
    patience = 0 if dart else int(p["early_stopping_round"])
    min_delta = float(p["early_stopping_min_delta"])
    num_iter = int(p["num_iterations"])
    # device eval: the metric panel is read back once per chunk of iterations
    chunk = num_iter if patience == 0 else min(num_iter, 32)
    best_metric = -np.inf if higher_better else np.inf
    best_iter = 0
    rng = np.random.default_rng(int(p["seed"]))  # DART's drops, as the reference draws them

    def replay(tree: GrownTree) -> torch.Tensor:
        """A stored tree's leaf value for every training row (DART)."""
        return tree.leaf_value[predict_binned(tree, binned).long()]

    trees: List[List[GrownTree]] = []  # per iteration, C trees
    tree_scales: List[float] = []
    sampled: List[torch.Tensor] = []   # rows with non-zero weight, per iteration
    evals: List[Dict[str, Any]] = []
    pending: List[torch.Tensor] = []   # metric rows not yet read back
    for it in range(num_iter):
        k1, k2 = sampler.keys(it)
        dropped: List[int] = []
        if dart and trees and rng.random() >= float(p["skip_drop"]):
            u = rng.random(len(trees))
            if bool(p["uniform_drop"]):
                mask = u < float(p["drop_rate"])
            else:  # drop chance proportional to the tree's weight (dart.cpp)
                ts = np.asarray(tree_scales, np.float64)
                mask = u < float(p["drop_rate"]) * ts * (len(ts) / max(ts.sum(), 1e-12))
            dropped = list(np.nonzero(mask)[0][:int(p["max_drop"])])
            # the reference's f32 roundings: the Python-float scale rounds to
            # f32 once, then one f32 product and one f32 difference
            for t in dropped:
                for c in range(C):
                    raw[:, c] = raw[:, c] - (lr * tree_scales[t]) * replay(trees[t][c])

        g, h = (fobj or grad_fn)(raw[:, 0] if C == 1 else raw, y_d, w_d)
        g = torch.as_tensor(g, device=dev).to(torch.float32).reshape(n, C)
        h = torch.as_tensor(h, device=dev).to(torch.float32).reshape(n, C)
        if layout is None:
            g, h = _preround(g, n_bound), _preround(h, n_bound)
        else:  # the max all-reduced: every rank on the single-device grid
            g, h = _preround(g, n_bound, layout), _preround(h, n_bound, layout)
        fm = sampler.feature_mask(k2)
        if fm is not None:  # kernel E reads fmask through its packed pointer
            fmask.copy_(fm.pin_memory() if dev.type == "cuda" else fm, non_blocking=True)
        bw = sampler.row_weights(k1, it, g)
        if bw is None:
            bw = ones
        else:
            if live is not None:
                bw = torch.where(live, bw, 0.0)
            sampled.append(torch.count_nonzero(bw))
        grown = []
        for c in range(C):
            if sparse_in:
                tree, node = grow_tree_sparse(binned, g[:, c].contiguous(),
                                              h[:, c].contiguous(), bw, fmask, cfg,
                                              cat_mask=cat_mask, mesh=tmesh)
            else:
                tree, node = grow_tree(binned, g[:, c].contiguous(), h[:, c].contiguous(),
                                       bw, fmask, cfg, cat_mask=cat_mask,
                                       workspace=workspace, partition=partition,
                                       mesh=tmesh)
            if renew_alpha is not None and C == 1:
                tree = tree._replace(leaf_value=_renewed_leaf_values(
                    node, y_d, raw[:, 0], w_d * bw, renew_alpha, L))
            grown.append((tree, tree.leaf_value[node.long()]))
        # every class's tree grows from the same margins; then all update
        if boosting != "rf":
            for c, (_, delta) in enumerate(grown):
                raw[:, c] = raw[:, c] + lr * delta
        new_trees = [tree for tree, _ in grown]

        scale = 1.0
        if dropped:
            k = len(dropped)
            if bool(p["xgboost_dart_mode"]):  # new tree lr/(k+lr), dropped k/(k+lr)
                scale, factor = 1.0 / (k + lr), k / (k + lr)
            else:
                scale, factor = 1.0 / (k + 1), k / (k + 1.0)
            for c, (_, delta) in enumerate(grown):
                raw[:, c] = raw[:, c] - ((1.0 - scale) * lr) * delta
            for t in dropped:
                old = tree_scales[t]
                tree_scales[t] = old * factor
                for c in range(C):
                    raw[:, c] = raw[:, c] + (lr * old * factor) * replay(trees[t][c])
                    for e in evals_in:
                        e.raw[:, c] += ((lr * old * (factor - 1.0))
                                        * e.leaf_values(trees[t][c])).double()
        tree_scales.append(scale)
        trees.append(new_trees)

        stop = False
        records: List[Dict[str, Any]] = []
        if evals_in and host_eval:
            # the reference's host metric: f64 margins, numpy metric each iteration
            rec = {"iteration": it}
            for ei, e in enumerate(evals_in):
                for c, tree in enumerate(new_trees):
                    e.raw[:, c] += ((lr * scale) * e.leaf_values(tree)).double()
                score = e.raw.cpu().numpy()
                if boosting == "rf":  # rf averages its trees
                    score = base[None, :] + (score - base[None, :]) / (it + 1)
                score = score[:, 0] if C == 1 else score
                ones_e = np.ones(len(e.y_np))
                rec[f"eval{ei}_{metric_name}"] = (
                    metric_fn(e.y_np, score, ones_e) if ndcg_fn is None
                    else ndcg_fn(e.y_np, score, ones_e, eval_group[ei]))
            records = [rec]
        elif evals_in:
            row = []
            for e in evals_in:
                for c, tree in enumerate(new_trees):
                    e.raw[:, c] = e.raw[:, c] + lr * e.leaf_values(tree)
                score = e.raw
                if boosting == "rf":  # rf averages its trees
                    score = base_d + (score - base_d) / torch.full((), it + 1.0, device=dev)
                row.append(dev_metric(e.y, score[:, 0] if C == 1 else score, e.w))
            pending.append(torch.stack(row))
            if len(pending) == chunk or it == num_iter - 1:
                it0 = it + 1 - len(pending)
                panel = torch.stack(pending).cpu().numpy()  # the chunk's one read-back
                pending = []
                records = [dict({"iteration": it0 + j},
                                **{f"eval{ei}_{metric_name}": float(m)
                                   for ei, m in enumerate(ms)})
                           for j, ms in enumerate(panel)]
        for rec in records:
            evals.append(rec)
            m, done = rec[f"eval0_{metric_name}"], rec["iteration"] + 1
            if (m > best_metric + min_delta) if higher_better else (m < best_metric - min_delta):
                best_metric, best_iter = m, done
            elif patience and done - best_iter >= patience:
                stop = True  # drop a chunk's overshoot: the reference's stop point
                del trees[done:], tree_scales[done:]
                break
        if callbacks:
            # a truthy return stops training after this iteration, keeping
            # its trees (the reference's rule, boost.py:2402-2411)
            asks = [bool(cb({"iteration": it, "evals": evals[-1] if evals else None}))
                    for cb in callbacks]
            stop = stop or any(asks)
        if stop:
            break

    T = len(trees)

    def stack(field, shape_tail, dtype):
        if not T:
            return np.zeros((0, C) + shape_tail, dtype)
        return torch.stack([torch.stack([getattr(t, field) for t in it])
                            for it in trees]).cpu().numpy().astype(dtype)

    parent = stack("parent", (L - 1,), np.int32)
    feature = stack("feature", (L - 1,), np.int32)
    bins = stack("bin", (L - 1,), np.int32)
    gain = stack("gain", (L - 1,), np.float32)
    leaf_value = stack("leaf_value", (L,), np.float32)
    leaf_hess = stack("leaf_hess", (L,), np.float32)
    cat_set = stack("cat_set", (L - 1, cfg.n_bins), np.int8) if has_cat else None
    if cat_set is not None and cfg.n_bins < mapper.n_bins:
        # sparse trees' sets are over the compact bins, the booster scores
        # full-space bins: category codes are the same in both, only the
        # missing bin moves (the reference's padding, boost.py:2428-2438)
        full = np.zeros(cat_set.shape[:-1] + (mapper.n_bins,), np.int8)
        full[..., :cfg.n_bins - 1] = cat_set[..., :cfg.n_bins - 1]
        full[..., mapper.missing_bin] = cat_set[..., cfg.n_bins - 1]
        cat_set = full
    threshold = np.zeros(parent.shape, dtype=np.float64)
    for t, c, s in zip(*np.nonzero(parent >= 0)):
        threshold[t, c, s] = mapper.bin_upper_value(int(feature[t, c, s]), bins[t, c, s])
    booster = GBDTBooster(
        mapper=mapper, objective=obj_name, num_class=C, base_score=base,
        parent=parent, feature=feature, threshold=threshold, bin_=bins, gain=gain,
        leaf_value=leaf_value, leaf_hess=leaf_hess,
        tree_scale=np.asarray(tree_scales, dtype=np.float64) * lr, boosting=boosting,
        best_iteration=best_iter if (patience and evals_in) else None,
        feature_names=list(feature_names) if feature_names else None, cat_set=cat_set)
    booster.evals_result = evals
    if sampled:
        sampled = torch.stack(sampled[:T])
        if layout is not None:  # every rank's rows (a data coordinate's ranks share them)
            sampled = all_reduce(sampled.contiguous(), layout, "sum", ("data",))
        booster.sampled_rows = sampled.cpu().numpy()
    if init_booster is not None and init_booster.num_trees:
        booster = _merge_boosters(init_booster, booster)
    return booster
