"""The distributed engine's dry run.

Port of ``synapseml_tpu/gbdt/engine.py``: :func:`dryrun_train_step` runs a
small distributed boosting fit (gradients, row-sharded histograms summed
over the data axis, growth, score update) over a layout's data axis on
synthetic rows, the check that a mesh compiles and runs end to end. Every
rank of the process group calls it with the same layout.
"""

from __future__ import annotations

import numpy as np

from .boost import train

__all__ = ["dryrun_train_step"]


def dryrun_train_step(mesh, n: int = 512, d: int = 16, device=None):
    """Two boosting iterations over ``mesh`` (a :class:`SpecLayout` or a raw
    DeviceMesh) on ``n`` seeded rows of ``d`` features; raises if the
    predictions are not finite. Returns the booster."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d))
    y = (x[:, 0] + 0.5 * x[:, 1] > 0).astype(np.float64)
    booster = train({"objective": "binary", "num_iterations": 2, "num_leaves": 7,
                     "min_data_in_leaf": 2, "max_bin": 31}, x, y, mesh=mesh, device=device)
    p = booster.predict(x[:8], device=device)
    if not np.all(np.isfinite(p)):
        raise AssertionError("non-finite GBDT dryrun predictions")
    return booster
