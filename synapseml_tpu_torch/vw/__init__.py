"""The online linear engine (the Vowpal Wabbit equivalent) in PyTorch.

Port of ``synapseml_tpu/vw``: murmur feature hashing into namespaces
(``featurizer.py``), the minibatched AdaGrad learner over a dense 2^b weight
vector with its batch step as hand kernel V (``learner.py``,
``csrc/vw_step.cu``), the estimator stages (``estimators.py``) and the
models of states trained by the JAX package (``convert.py``). Over a mesh
each data rank passes over its rows and the state is averaged at pass
boundaries (VW's AllReduce semantics).

Lazy: importing the package binds nothing; each name loads its module on
first access.
"""

from __future__ import annotations

import importlib

_LAZY = {
    "VowpalWabbitClassificationModel": "estimators",
    "VowpalWabbitClassifier": "estimators",
    "VowpalWabbitContextualBandit": "estimators",
    "VowpalWabbitContextualBanditModel": "estimators",
    "VowpalWabbitRegressionModel": "estimators",
    "VowpalWabbitRegressor": "estimators",
    "VectorZipper": "featurizer",
    "VowpalWabbitFeaturizer": "featurizer",
    "VowpalWabbitInteractions": "featurizer",
    "LinearLearnerState": "learner",
    "train_linear": "learner",
    "model_from_state": "convert",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
