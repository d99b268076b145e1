"""Model-agnostic local explainers (LIME, KernelSHAP, ICE) and superpixels
(port of ``synapseml_tpu/explainers``).

Samples are drawn on the host in numpy with the reference's seeded draws;
the wrapped model scores one table of every sample; every (row, target)
regression is solved in one batch on the explainer's device
(``regression.fit_regression_batch``; the lasso through hand kernel L).
Submodules load on first attribute access.
"""

from __future__ import annotations

import importlib

_LAZY = {
    "base": ["KernelSHAPBase", "LIMEBase", "LocalExplainer"],
    "ice": ["ICECategoricalFeature", "ICENumericFeature", "ICETransformer"],
    "lime": ["ImageLIME", "TabularLIME", "TextLIME", "VectorLIME"],
    "regression": ["RegressionResult", "fit_regression", "fit_regression_batch"],
    "samplers": ["effective_num_samples", "kernel_shap_coalitions"],
    "shap": ["ImageSHAP", "TabularSHAP", "TextSHAP", "VectorSHAP"],
    "stats": ["ContinuousFeatureStats", "DiscreteFeatureStats", "collect_feature_stats"],
    "superpixel": ["SuperpixelData", "SuperpixelTransformer", "mask_image",
                   "slic_superpixels"],
}
_OWNER = {name: mod for mod, names in _LAZY.items() for name in names}

__all__ = sorted(_OWNER)


def __getattr__(name):
    if name in _LAZY:
        return importlib.import_module(f"{__name__}.{name}")
    mod = _OWNER.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
