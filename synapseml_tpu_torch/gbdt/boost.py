"""Boosting loop, objectives and the serializable booster.

Port of ``synapseml_tpu/gbdt/boost.py`` for the main path: objectives
``binary`` and ``regression`` (l2), plain ``gbdt`` boosting, one device. The
reference runs the loop as one ``lax.scan`` program; here it is a Python loop
over iterations whose body (objective gradients -> pre-rounding -> tree growth
-> score update) queues on the device without reading anything back, so the
trees come to the host once, after the last iteration.

Gradients are pre-rounded to a summation-exact grid (:func:`_preround`, the
reference's ``boost.py:1148``), so every histogram cell is exact in any
summation order: the GPU kernel's atomics reproduce the reference's trees.

Not ported yet, and refused with ``NotImplementedError`` when set away from
their defaults: bagging, feature_fraction, GOSS, dart, rf, categorical
features, eval sets and early stopping, and the other objectives.
"""

from __future__ import annotations

import json
import warnings
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..core.serialization import register_state_class
from ..runtime.device import resolve_device
from .binning import BinMapper
from .grow import TreeConfig, grow_tree

__all__ = ["GBDTBooster", "train", "OBJECTIVES"]


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


OBJECTIVES = {"binary": _obj_binary, "regression": _obj_l2, "l2": _obj_l2,
              "mse": _obj_l2, "regression_l2": _obj_l2}

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
    early_stopping_min_delta=0.0,
    alpha=0.9, tweedie_variance_power=1.5, verbose=0,
)

# parameters of the reference that change training and are not ported yet:
# training refuses them unless they hold their default
_NOT_PORTED = ("feature_fraction", "bagging_fraction", "bagging_freq", "boosting",
               "pos_bagging_fraction", "neg_bagging_fraction", "max_bin_by_feature",
               "categorical_feature", "early_stopping_round", "num_class")

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


def _preround(x: torch.Tensor, n_bound: int) -> torch.Tensor:
    """Round gradients to a summation-exact f32 grid (the reference's
    ``_preround``): every value becomes a multiple of ``ulp(factor)`` with
    ``factor >= max|x| * n_bound``, so every partial sum of up to ``n_bound``
    terms is exactly representable and ANY summation order gives the same
    bits. Per-element error is at most ``max|x| * n_bound * 2**-24``."""
    m = torch.max(torch.abs(x), dim=0).values
    delta = m * torch.tensor(float(n_bound), dtype=torch.float32, device=x.device)
    factor = torch.exp2(torch.ceil(torch.log2(torch.clamp(delta, min=1e-35))))
    return (x + factor) - factor


# ---------------------------------------------------------------------------------
# Booster
# ---------------------------------------------------------------------------------

@register_state_class
class GBDTBooster:
    """Trained model: stacked tree arrays (T, C, ...) + bin mapper + metadata.

    The arrays live on the host as numpy, in the reference's layout; scoring
    bins rows and replays the trees on a device (kernel B on a GPU)."""

    def __init__(self, mapper: BinMapper, objective: str, num_class: int,
                 base_score, parent, feature, threshold, bin_, gain, leaf_value,
                 leaf_hess, tree_scale, boosting: str = "gbdt",
                 best_iteration: Optional[int] = None,
                 feature_names: Optional[List[str]] = None):
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

    @property
    def num_trees(self) -> int:
        return self.parent.shape[0]

    def _used_trees(self, num_iteration: Optional[int]) -> int:
        t = self.best_iteration if num_iteration is None else num_iteration
        if t is None or t <= 0 or t > self.num_trees:
            t = self.num_trees
        return t

    def raw_predict(self, x, num_iteration: Optional[int] = None,
                    device=None) -> np.ndarray:
        """Raw margin, shape (n,) or (n, C): bins ``x`` and replays the trees on
        ``device`` (default: the GPU, through kernel B), then adds the base score."""
        from .device_predict import device_raw_scores

        dev = resolve_device(device)
        T = self._used_trees(num_iteration)
        xt = torch.as_tensor(x)
        n = xt.shape[0]
        base = np.tile(self.base_score, (n, 1)).astype(np.float64)
        if T == 0:
            out = base
        else:
            binned = self.mapper.transform_torch(xt.to(dev))
            scores = device_raw_scores(
                binned, self.parent[:T], self.feature[:T], self.bin[:T],
                self.leaf_value[:T], self.tree_scale[:T])
            out = base + scores.cpu().numpy().astype(np.float64)
        return out[:, 0] if self.num_class == 1 else out

    def predict(self, x, num_iteration: Optional[int] = None, device=None) -> np.ndarray:
        """Probability for binary, value for regression."""
        return self.activate(self.raw_predict(x, num_iteration, device=device))

    def activate(self, raw: np.ndarray) -> np.ndarray:
        """The objective's link function over a raw margin."""
        if self.objective == "binary":
            return np.where(raw >= 0, 1 / (1 + np.exp(-np.abs(raw))),
                            np.exp(-np.abs(raw)) / (1 + np.exp(-np.abs(raw))))
        return raw

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
            "cat_set": None,
        }

    @staticmethod
    def from_state_dict(d: Dict[str, Any]) -> "GBDTBooster":
        """Build a booster from a ``state_dict`` — this port's or the reference's."""
        if d.get("cat_set") is not None:
            raise NotImplementedError("categorical (cat_set) splits are not ported yet")
        if d["objective"] not in OBJECTIVES:
            raise NotImplementedError(f"objective {d['objective']!r} is not ported yet")
        if d.get("boosting", "gbdt") != "gbdt":
            raise NotImplementedError(f"boosting {d['boosting']!r} is not ported yet")
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
            boosting="gbdt",
            best_iteration=d.get("best_iteration"),
            feature_names=list(d["feature_names"]) if d.get("feature_names") else None,
        )


def train(params: Dict[str, Any], x, y, weight: Optional[np.ndarray] = None,
          device=None, feature_names: Optional[List[str]] = None) -> GBDTBooster:
    """Train a booster on ``device`` (default: the GPU; ``"cpu"`` runs the
    plain PyTorch versions of the kernels).

    ``x`` is an (n, d) float matrix (numpy or tensor), ``y`` and ``weight``
    (n,) numpy arrays."""
    dev = resolve_device(device)
    p = dict(_DEFAULTS)
    params_c = _canonicalize_params(params)
    p.update(params_c)
    for k in _NOT_PORTED:
        if p[k] != _DEFAULTS[k] and not (k == "categorical_feature" and not p[k]):
            raise NotImplementedError(f"parameter {k}={p[k]!r} is not ported yet")
    obj_name = p["objective"]
    if obj_name not in OBJECTIVES:
        raise NotImplementedError(f"objective {obj_name!r} is not ported yet "
                                  f"(ported: {sorted(OBJECTIVES)})")
    init_fn, grad_fn = OBJECTIVES[obj_name]()

    xt = torch.as_tensor(x)
    n, d = xt.shape
    y = np.asarray(y, dtype=np.float64)
    w_np = np.ones(n) if weight is None else np.asarray(weight, dtype=np.float64) + 0.0

    mapper = BinMapper(max_bin=int(p["max_bin"]), seed=int(p["seed"]),
                       sample_cnt=int(p["bin_sample_count"]))
    mapper.fit(xt.numpy() if xt.device.type == "cpu" else xt.cpu().numpy())
    binned = mapper.transform_torch(xt.to(dev))  # int8/int16 per bin_dtype

    base = np.atleast_1d(np.asarray(init_fn(y, w_np), dtype=np.float64))
    if not p["boost_from_average"]:
        base = np.zeros_like(base)
    lr = float(p["learning_rate"])
    cfg = TreeConfig(
        n_bins=mapper.n_bins, num_leaves=int(p["num_leaves"]),
        lambda_l1=float(p["lambda_l1"]), lambda_l2=float(p["lambda_l2"]),
        min_data_in_leaf=float(p["min_data_in_leaf"]),
        min_sum_hessian=float(p["min_sum_hessian_in_leaf"]),
        min_gain_to_split=float(p["min_gain_to_split"]),
        max_depth=int(p["max_depth"]), max_delta_step=float(p["max_delta_step"]))
    L = cfg.num_leaves
    # summation-exact rounding bound: the next power of two over the row count
    n_bound = 1 << max(int(n) - 1, 1).bit_length()

    y_d = torch.as_tensor(y, dtype=torch.float32, device=dev)
    w_d = torch.as_tensor(w_np, dtype=torch.float32, device=dev)
    raw = torch.zeros(n, dtype=torch.float32, device=dev) + torch.as_tensor(
        base, dtype=torch.float32, device=dev)
    ones = torch.ones(n, dtype=torch.float32, device=dev)
    fmask = torch.ones(d, dtype=torch.float32, device=dev)

    trees = []
    for _ in range(int(p["num_iterations"])):
        g, h = grad_fn(raw, y_d, w_d)
        g = _preround(g.to(torch.float32)[:, None], n_bound)[:, 0]
        h = _preround(h.to(torch.float32)[:, None], n_bound)[:, 0]
        tree, node = grow_tree(binned, g, h, ones, fmask, cfg)
        trees.append(tree)
        raw = raw + lr * tree.leaf_value[node.long()]

    T = len(trees)

    def stack(field, shape_tail, dtype):
        if not T:
            return np.zeros((0, 1) + shape_tail, dtype)
        return torch.stack([getattr(t, field) for t in trees])[:, None].cpu().numpy()

    parent = stack("parent", (L - 1,), np.int32)
    feature = stack("feature", (L - 1,), np.int32)
    bins = stack("bin", (L - 1,), np.int32)
    gain = stack("gain", (L - 1,), np.float32)
    leaf_value = stack("leaf_value", (L,), np.float32)
    leaf_hess = stack("leaf_hess", (L,), np.float32)
    threshold = np.zeros(parent.shape, dtype=np.float64)
    for t, c, s in zip(*np.nonzero(parent >= 0)):
        threshold[t, c, s] = mapper.bin_upper_value(int(feature[t, c, s]), bins[t, c, s])
    return GBDTBooster(
        mapper=mapper, objective=obj_name, num_class=1, base_score=base,
        parent=parent, feature=feature, threshold=threshold, bin_=bins, gain=gain,
        leaf_value=leaf_value, leaf_hess=leaf_hess,
        tree_scale=np.full(T, lr, dtype=np.float64), boosting="gbdt",
        feature_names=list(feature_names) if feature_names else None)
