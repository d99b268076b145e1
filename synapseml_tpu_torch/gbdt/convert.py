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
from .estimators import (LightGBMClassificationModel, LightGBMRankerModel,
                         LightGBMRegressionModel)

__all__ = ["booster_from_state", "model_from_state"]


def booster_from_state(state: Dict[str, Any]) -> GBDTBooster:
    """Port booster from a reference ``GBDTBooster.state_dict()``.

    Takes numeric and categorical (``cat_set``) splits, any class count and
    objective (lambdarank included) and gbdt, goss, dart and rf models (rf
    averages its trees); raises ``NotImplementedError`` for another
    boosting type."""
    return GBDTBooster.from_state_dict(dict(state))


def model_from_state(state: Dict[str, Any], labels: Optional[Sequence] = None,
                     device: Optional[str] = None, **params):
    """Fitted port stage from a reference booster's ``state_dict()``: a
    :class:`LightGBMClassificationModel` for ``binary``, ``multiclass`` and
    ``softmax`` (``labels``: the class values in index order, as the
    reference model keeps them), a :class:`LightGBMRankerModel` for
    ``lambdarank`` or a :class:`LightGBMRegressionModel` otherwise."""
    booster = booster_from_state(state)
    if booster.objective in ("binary", "multiclass", "softmax"):
        return LightGBMClassificationModel(
            booster=booster, device=device,
            labels=None if labels is None else np.asarray(labels), **params)
    if booster.objective == "lambdarank":
        return LightGBMRankerModel(booster=booster, device=device, **params)
    return LightGBMRegressionModel(booster=booster, device=device, **params)
