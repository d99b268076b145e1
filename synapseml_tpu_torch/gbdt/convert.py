"""Carry a trained model across from the JAX package.

The reference booster's ``state_dict()`` (``synapseml_tpu/gbdt/boost.py:880``)
is plain numpy arrays plus the bin mapper's dictionary, so a model trained
there can be scored here without retraining: :func:`booster_from_state` builds
the port's :class:`~.boost.GBDTBooster`, :func:`model_from_state` the fitted
stage around it. This module takes the dictionary; it never imports the JAX
package (the caller obtains the dictionary there).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

from .boost import GBDTBooster
from .estimators import LightGBMClassificationModel, LightGBMRegressionModel

__all__ = ["booster_from_state", "model_from_state"]


def booster_from_state(state: Dict[str, Any]) -> GBDTBooster:
    """Port booster from a reference ``GBDTBooster.state_dict()``.

    Raises ``NotImplementedError`` for what the port does not score yet
    (categorical splits, multiclass, objectives other than binary/l2, boosting
    other than gbdt)."""
    if int(state["num_class"]) != 1:
        raise NotImplementedError("multiclass boosters are not ported yet")
    return GBDTBooster.from_state_dict(dict(state))


def model_from_state(state: Dict[str, Any], labels: Optional[Sequence] = None,
                     device: Optional[str] = None, **params):
    """Fitted port stage from a reference booster's ``state_dict()``: a
    :class:`LightGBMClassificationModel` for ``binary`` (``labels``: the class
    values in index order, as the reference model keeps them) or a
    :class:`LightGBMRegressionModel` otherwise."""
    booster = booster_from_state(state)
    if booster.objective == "binary":
        return LightGBMClassificationModel(
            booster=booster, device=device,
            labels=None if labels is None else np.asarray(labels), **params)
    return LightGBMRegressionModel(booster=booster, device=device, **params)
