"""Image ops and stages (port of ``synapseml_tpu/image``).

Submodules load on first attribute access, so ``onnx/ops.py`` can import
``image.resample`` without loading the stages."""

from __future__ import annotations

import importlib

_LAZY = {name: "stages" for name in ("ImageSetAugmenter", "ImageTransformer",
                                     "ResizeImageTransformer", "UnrollBinaryImage",
                                     "UnrollImage")}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name in ("ops", "stages", "resample"):
        return importlib.import_module(f"{__name__}.{name}")
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
