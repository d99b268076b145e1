"""ONNX engine on PyTorch: wire codec, builder, executor (``OnnxFunction``) and
the ``ONNXModel`` stage.

Port of ``synapseml_tpu/onnx``. The graph runs op by op in PyTorch on the card
(``ops.py``), with integer GEMM/conv as hand kernel Q (``qgemm.py``,
``csrc/qgemm.cu``) and the LSTM/GRU recurrence as hand kernel R (``rnn.py``,
``csrc/rnn_step.cu``).

Lazy: importing the package binds nothing; each name loads its module on
first access.
"""

from __future__ import annotations

import importlib

_LAZY = {
    "constant_node": "builder", "make_graph": "builder", "make_model": "builder",
    "node": "builder", "save_model": "builder", "value_info": "builder",
    "OnnxFunction": "importer", "load_model": "importer", "model_io_specs": "importer",
    "ONNXModel": "model",
    "DataType": "wire", "ModelProto": "wire", "parse_model": "wire",
    "serialize_model": "wire", "tensor_to_numpy": "wire",
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)
