"""State/coalition generators for LIME and KernelSHAP.

Copy of ``synapseml_tpu/explainers/samplers.py``: host-side numpy with the
same seeded draws, so the same generator gives bit-equal states, coalitions
and kernel weights; all outputs are batched arrays shaped for
``regression.fit_regression_batch``.

Reference behavior matched:
- LIME on/off masks: Bernoulli(keep) per feature, distance
  ``||1 - s||_2 / sqrt(k)`` (``LIMESampler.scala`` ``LIMEOnOffSampler`` /
  ``getDistance``);
- KernelSHAP coalitions: paired subset-size enumeration with the Shapley
  kernel weight per size level; full levels are enumerated exhaustively, the
  remaining budget is sampled; the empty and full coalitions carry
  ``inf_weight`` (``KernelSHAPSampler.scala:129-162`` ``generateCoalitions``,
  ``KernelSHAPBase.getEffectiveNumSamples``). We use the exact Shapley kernel
  ``(m-1)/(C(m,k)·k·(m-k))`` for fully-enumerated levels (the reference's
  ``kernelFunc`` substitutes ``numSamples`` for ``m`` here; the standard kernel
  is kept deliberately — it is the correct Shapley weighting) and weight 1 for
  budget-sampled coalitions, mirroring ``allocateRemainingSamples``.
"""

from __future__ import annotations

from itertools import combinations
from math import comb
from typing import Tuple

import numpy as np

__all__ = ["lime_onoff_states", "onoff_distances", "kernel_shap_coalitions",
           "effective_num_samples"]


def lime_onoff_states(rng: np.random.Generator, n_rows: int, n_samples: int,
                      feature_size: int, sampling_fraction: float) -> np.ndarray:
    """(n_rows, n_samples, feature_size) 0/1 keep masks."""
    return (rng.random((n_rows, n_samples, feature_size))
            <= sampling_fraction).astype(np.float64)


def onoff_distances(states: np.ndarray) -> np.ndarray:
    """||1 - s||_2 / sqrt(k) over the trailing axis."""
    k = states.shape[-1]
    return np.linalg.norm(1.0 - states, axis=-1) / np.sqrt(max(k, 1))


def effective_num_samples(num_samples, num_features: int) -> int:
    """Clamp to [m+2, 2^m]; default ``2m + 2048``
    (``KernelSHAPBase.getEffectiveNumSamples``, following the shap package)."""
    m = int(num_features)
    lo = m + 2
    hi = 2 ** m if m < 31 else 2 ** 31
    v = int(num_samples) if num_samples else 2 * m + 2048
    return int(min(max(v, lo), hi))


def kernel_shap_coalitions(rng: np.random.Generator, feature_size: int,
                           num_samples: int, inf_weight: float = 1e8
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """Generate ``num_samples`` coalitions -> (S (num_samples, m) 0/1, w (num_samples,)).

    First two rows are the empty and full coalitions at ``inf_weight``; then
    size levels k=1, m-1, 2, m-2, ... are filled: a level whose full
    enumeration fits the remaining budget contributes all C(m,k) subsets, each
    at the Shapley kernel weight for that size; leftover budget is filled with
    uniformly random subsets (weight 1) of the next sizes.
    """
    m = int(feature_size)
    n = int(num_samples)
    assert m > 0 and n >= 2
    rows = [np.zeros(m), np.ones(m)]
    weights = [float(inf_weight), float(inf_weight)]

    def kernel_w(k: int) -> float:
        return (m - 1) / (comb(m, k) * k * (m - k))

    # paired size order: 1, m-1, 2, m-2, ... (skip duplicates when k == m-k)
    sizes = []
    for k in range(1, m // 2 + 1):
        sizes.append(k)
        if k != m - k:
            sizes.append(m - k)

    budget = n - 2
    remaining_sizes: list = []
    for i, k in enumerate(sizes):
        if budget <= 0:
            break
        c = comb(m, k)
        if c > budget:
            # budget no longer covers a full level: everything from here on
            # (this size AND all later ones) goes to the sampled fallback
            remaining_sizes = sizes[i:]
            break
        w = kernel_w(k)
        for sub in combinations(range(m), k):
            v = np.zeros(m)
            v[list(sub)] = 1.0
            rows.append(v)
            weights.append(w)
        budget -= c
    # Sampled fallback: draw each subset's SIZE uniformly from the
    # not-yet-enumerated sizes so leftover budget spreads across all of them
    # (matching the reference's allocateRemainingSamples allocation), with
    # weight 1 (the reference assigns 1.0 to the overflow samples).
    if not remaining_sizes:
        remaining_sizes = list(range(1, m))  # deep levels of large m
    while budget > 0:
        k = int(remaining_sizes[int(rng.integers(len(remaining_sizes)))])
        sub = rng.choice(m, size=k, replace=False)
        v = np.zeros(m)
        v[sub] = 1.0
        rows.append(v)
        weights.append(1.0)
        budget -= 1
    return np.stack(rows), np.asarray(weights)
