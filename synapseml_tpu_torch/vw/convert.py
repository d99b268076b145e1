"""The port's fitted VW models from states trained by the JAX package.

:func:`model_from_state` takes a reference ``LinearLearnerState.state_dict()``
(numpy arrays: raw-space weights, adagrad accumulators, bias, bias
accumulator, scales) and builds the port's model of that kind, which scores
on the host as the reference's model does: the same bits.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np

from .estimators import (VowpalWabbitClassificationModel, VowpalWabbitContextualBanditModel,
                         VowpalWabbitRegressionModel)
from .learner import LinearLearnerState

__all__ = ["model_from_state", "MODEL_KINDS"]

MODEL_KINDS = {"classifier": VowpalWabbitClassificationModel,
               "regressor": VowpalWabbitRegressionModel,
               "contextual_bandit": VowpalWabbitContextualBanditModel}


def model_from_state(kind: str, state, labels: Optional[np.ndarray] = None, **params):
    """The port's model of ``kind`` (``"classifier"``, ``"regressor"`` or
    ``"contextual_bandit"``) over ``state``: a state dict of numpy arrays
    (``w``, ``g2``, ``bias``, ``bias_g2``, ``scale``) or a
    :class:`~.learner.LinearLearnerState`. ``labels``: the classifier's two
    class values in index order (required for it); ``params``: the model's
    other params (columns, ``epsilon``). ``num_bits`` is read from the
    state's length."""
    if kind not in MODEL_KINDS:
        raise ValueError(f"kind must be one of {sorted(MODEL_KINDS)}, got {kind!r}")
    if isinstance(state, Mapping):
        state = LinearLearnerState.from_state_dict(state)
    state = LinearLearnerState(*(np.asarray(a) for a in state))
    dim = len(state.w)
    if dim < 2 or dim & (dim - 1):
        raise ValueError(f"the state's {dim} weights are not 2^b for a b >= 1")
    if kind == "classifier":
        if labels is None or len(labels) != 2:
            raise ValueError("a classifier needs its two class values (labels=)")
        params["labels"] = np.asarray(labels)
    elif labels is not None:
        raise ValueError(f"a {kind} takes no labels")
    return MODEL_KINDS[kind](state=state, num_bits=dim.bit_length() - 1, **params)
