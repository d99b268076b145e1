"""Per-feature sampling statistics for tabular/vector LIME.

Reference: ``explainers/FeatureStats.scala`` (``ContinuousFeatureStats``
stddev-scaled Gaussian perturbation + normalized distance;
``DiscreteFeatureStats`` frequency-CDF sampling with 0/1 match distance).
Stats are computed from a background Table, batched in numpy (a copy of
``synapseml_tpu/explainers/stats.py``: the same draws from the same generator).
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np

__all__ = ["ContinuousFeatureStats", "DiscreteFeatureStats", "collect_feature_stats"]


class ContinuousFeatureStats:
    """Gaussian perturbation around the instance value, scaled by stddev."""

    def __init__(self, stddev: float):
        self.stddev = float(stddev)

    def sample_states(self, rng: np.random.Generator, values: np.ndarray,
                      n_samples: int) -> np.ndarray:
        """(n,) instance values -> (n, n_samples) sampled values (= states)."""
        return rng.normal(values[:, None], self.stddev, size=(len(values), n_samples))

    def distance(self, values: np.ndarray, sampled: np.ndarray) -> np.ndarray:
        if self.stddev == 0.0:
            return np.zeros_like(sampled)
        return np.abs(sampled - values[:, None]) / self.stddev

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": "continuous", "stddev": self.stddev}


class DiscreteFeatureStats:
    """Frequency-CDF sampling over observed category values."""

    def __init__(self, freq: Dict[Any, float]):
        self.values = list(freq.keys())
        self.weights = np.asarray([freq[v] for v in self.values], dtype=np.float64)
        total = self.weights.sum()
        self.probs = self.weights / total if total > 0 else np.full(len(self.values),
                                                                   1 / max(len(self.values), 1))

    def sample_values(self, rng: np.random.Generator, n: int, n_samples: int) -> np.ndarray:
        idx = rng.choice(len(self.values), size=(n, n_samples), p=self.probs)
        out = np.empty((n, n_samples), dtype=object)
        for k, v in enumerate(self.values):
            out[idx == k] = v
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {"kind": "discrete",
                "freq": {str(v): float(w) for v, w in zip(self.values, self.weights)}}


def collect_feature_stats(background, cols: Sequence[str],
                          categorical_cols: Sequence[str]) -> List[object]:
    """Build per-column stats from a background Table (reference ``TabularLIME.fit``
    computes stddev / frequency maps over the background dataset)."""
    stats: List[object] = []
    for c in cols:
        col = background[c]
        if c in categorical_cols or col.dtype == object or col.dtype.kind in "US":
            vals, counts = np.unique(col.astype(object), return_counts=True)
            stats.append(DiscreteFeatureStats(dict(zip(vals.tolist(), counts.astype(float)))))
        else:
            stats.append(ContinuousFeatureStats(float(np.std(np.asarray(col, np.float64)))))
    return stats
