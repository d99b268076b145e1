"""Eval metrics for eval sets and early stopping.

Port of ``METRICS``, ``_DEFAULT_METRIC`` and ``_dev_metric`` of
``synapseml_tpu/gbdt/boost.py:343-457``. :data:`METRICS` holds the numpy
versions (``name -> (fn, higher_better)``), which DART's host-side eval and
the tests use; :func:`device_metric` returns each one's torch twin, which
the boosting loop runs on the eval margins where they live (the GPU), so a
metric panel is read back once per chunk of iterations. :func:`metric_ndcg`
(the reference's ``_metric_ndcg``, ``boost.py:304``) needs the query groups
and has no device twin: lambdarank evaluates it on the host, as the
reference does.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

__all__ = ["METRICS", "DEFAULT_METRIC", "device_metric", "metric_ndcg"]


def _metric_auc(y, score, w):
    order = np.argsort(score, kind="stable")
    y_s, w_s = y[order], w[order]
    ranks = np.cumsum(w_s) - w_s / 2.0  # midrank approximation for weighted AUC
    pos = y_s > 0
    sw_pos, sw_neg = w_s[pos].sum(), w_s[~pos].sum()
    if sw_pos == 0 or sw_neg == 0:
        return 0.5
    r_pos = (ranks[pos] * w_s[pos]).sum() / sw_pos
    r_neg = (ranks[~pos] * w_s[~pos]).sum() / sw_neg
    return float(0.5 + (r_pos - r_neg) / w_s.sum())


def _metric_binary_logloss(y, score, w):
    p = np.clip(1 / (1 + np.exp(-score)), 1e-15, 1 - 1e-15)
    return float(np.average(-(y * np.log(p) + (1 - y) * np.log(1 - p)), weights=w))


def _metric_l2(y, score, w):
    return float(np.average((y - score) ** 2, weights=w))


def _metric_rmse(y, score, w):
    return float(np.sqrt(_metric_l2(y, score, w)))


def _metric_l1(y, score, w):
    return float(np.average(np.abs(y - score), weights=w))


def _metric_multi_logloss(y, score, w):
    z = score - score.max(axis=1, keepdims=True)
    p = np.exp(z)
    p = p / p.sum(axis=1, keepdims=True)
    pi = np.clip(p[np.arange(len(y)), y.astype(int)], 1e-15, None)
    return float(np.average(-np.log(pi), weights=w))


def _metric_multi_error(y, score, w):
    return float(np.average(score.argmax(1) != y, weights=w))


METRICS: Dict[str, Tuple[Callable, bool]] = {
    "auc": (_metric_auc, True),
    "binary_logloss": (_metric_binary_logloss, False),
    "l2": (_metric_l2, False),
    "mse": (_metric_l2, False),
    "rmse": (_metric_rmse, False),
    "l1": (_metric_l1, False),
    "mae": (_metric_l1, False),
    "multi_logloss": (_metric_multi_logloss, False),
    "multi_error": (_metric_multi_error, False),
}

# the objective's metric when ``metric`` is unset (else l2)
DEFAULT_METRIC = {"binary": "binary_logloss", "multiclass": "multi_logloss",
                  "softmax": "multi_logloss", "l1": "l1", "mae": "l1", "quantile": "l1"}


def metric_ndcg(k: int = 10) -> Callable:
    """Mean NDCG@k over contiguous query groups: ``fn(y, score, w,
    group_sizes)`` (``w`` is unused, as in the reference); a query whose
    ideal DCG is 0 counts 0. Higher is better."""
    def fn(y, score, w, group_sizes):
        total, start = 0.0, 0
        cnt = 0
        for sz in group_sizes:
            ys = y[start:start + sz]
            ss = score[start:start + sz]
            order = np.argsort(-ss, kind="stable")[:k]
            dcg = ((2.0 ** ys[order] - 1) / np.log2(2 + np.arange(len(order)))).sum()
            ideal = np.sort(ys)[::-1][:k]
            idcg = ((2.0 ** ideal - 1) / np.log2(2 + np.arange(len(ideal)))).sum()
            total += dcg / idcg if idcg > 0 else 0.0
            cnt += 1
            start += sz
        return total / max(cnt, 1)

    return fn


def _wavg(v, w):
    return torch.sum(v * w) / torch.clamp(torch.sum(w), min=1e-12)


def _auc(y, score, w):
    order = torch.argsort(score, stable=True)
    y_s, w_s = y[order], w[order]
    # weights normalised so every rank quantity is O(1): f32 ranks lose
    # integer resolution past 2**24 rows
    wn = w_s / torch.clamp(torch.sum(w_s), min=1e-12)
    ranks = torch.cumsum(wn, 0) - wn / 2.0
    pos = (y_s > 0).to(wn.dtype)
    sw_pos = torch.sum(wn * pos)
    sw_neg = torch.sum(wn * (1 - pos))
    r_pos = torch.sum(ranks * wn * pos) / torch.clamp(sw_pos, min=1e-12)
    r_neg = torch.sum(ranks * wn * (1 - pos)) / torch.clamp(sw_neg, min=1e-12)
    return torch.where((sw_pos == 0) | (sw_neg == 0), 0.5, 0.5 + (r_pos - r_neg))


def _binary_logloss(y, score, w):
    p = torch.clamp(1 / (1 + torch.exp(-score)), 1e-15, 1 - 1e-15)
    return _wavg(-(y * torch.log(p) + (1 - y) * torch.log(1 - p)), w)


def _multi_logloss(y, score, w):
    z = score - score.max(dim=1, keepdim=True).values
    p = torch.exp(z)
    p = p / p.sum(dim=1, keepdim=True)
    rows = torch.arange(score.shape[0], device=score.device)
    return _wavg(-torch.log(torch.clamp(p[rows, y.long()], min=1e-15)), w)


_DEVICE = {
    "auc": _auc,
    "binary_logloss": _binary_logloss,
    "l2": lambda y, s, w: _wavg((y - s) ** 2, w),
    "rmse": lambda y, s, w: torch.sqrt(_wavg((y - s) ** 2, w)),
    "l1": lambda y, s, w: _wavg(torch.abs(y - s), w),
    "multi_logloss": _multi_logloss,
    "multi_error": lambda y, s, w: _wavg((s.argmax(1) != y.long()).to(torch.float32), w),
}
_DEVICE["mse"], _DEVICE["mae"] = _DEVICE["l2"], _DEVICE["l1"]


def device_metric(name: str) -> Callable:
    """The torch twin of ``METRICS[name]``: ``fn(y, score, w)`` over f32
    tensors on one device, returning a 0-d f32 tensor there (no host read)."""
    return _DEVICE[name]
