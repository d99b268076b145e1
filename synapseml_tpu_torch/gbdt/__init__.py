"""Histogram GBDT (LightGBM-style) in PyTorch: the port's main path.

Lazy: importing the package binds nothing; each name loads its module on
first access.
"""

from __future__ import annotations

import importlib

_LAZY = {
    "LightGBMClassifier": "estimators",
    "LightGBMClassificationModel": "estimators",
    "LightGBMRegressor": "estimators",
    "LightGBMRegressionModel": "estimators",
    "GBDTBooster": "boost",
    "train": "boost",
    "BinMapper": "binning",
    "booster_from_state": "convert",
    "model_from_state": "convert",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
