"""synapseml_tpu_torch — the PyTorch / CUDA port of synapseml_tpu.

A second package beside the JAX one: the same stages and algorithms, written in
PyTorch, with the hot loops as kernels written by hand for NVIDIA Hopper
(``csrc/*.cu``, built with ``nvcc`` for ``sm_90a`` at first use). It imports
nothing of the JAX package; the parity tests hold each module against it.

Entry points run on the GPU unless the caller passes ``device="cpu"``; with no
CUDA device and no CPU request they raise
:class:`~synapseml_tpu_torch.runtime.device.DeviceUnavailableError`.

Importing the package is cheap: submodules load on first attribute access.
"""

from __future__ import annotations

import importlib

__version__ = "0.1.0"

_LAZY = {
    "Table": "synapseml_tpu_torch.core.table",
    "concat_tables": "synapseml_tpu_torch.core.table",
    "Pipeline": "synapseml_tpu_torch.core.stage",
    "PipelineModel": "synapseml_tpu_torch.core.stage",
    "load_stage": "synapseml_tpu_torch.core.serialization",
    "save_stage": "synapseml_tpu_torch.core.serialization",
    "resolve_device": "synapseml_tpu_torch.runtime.device",
    "DeviceUnavailableError": "synapseml_tpu_torch.runtime.device",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module 'synapseml_tpu_torch' has no attribute {name!r}")
    return getattr(importlib.import_module(mod), name)
