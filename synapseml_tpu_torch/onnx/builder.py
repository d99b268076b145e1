"""Programmatic ONNX graph construction (copy of ``synapseml_tpu/onnx/builder.py``).

Test/bench-side counterpart of the wire codec: build ``ModelProto`` structures in python
(nodes, initializers, value infos) and serialize them to real ``.onnx`` bytes. Used by
the unit tests (which cross-check the importer against torch reference outputs) and by
the model zoo (``synapseml_tpu_torch.models``) to materialize ResNet/BERT-class graphs without
network access. API shape is deliberately close to ``onnx.helper`` so models written
against it port trivially.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from .wire import (
    AttributeProto,
    DataType,
    GraphProto,
    ModelProto,
    NodeProto,
    TensorProto,
    ValueInfo,
    numpy_to_tensor,
    serialize_model,
)

__all__ = ["node", "make_graph", "make_model", "value_info", "constant_node", "save_model"]


def _attr(name: str, v: Any) -> AttributeProto:
    a = AttributeProto(name=name)
    if isinstance(v, TensorProto):
        a.type, a.t = 4, v
    elif isinstance(v, GraphProto):
        a.type, a.g = 5, v
    elif isinstance(v, bool):
        a.type, a.i = 2, int(v)
    elif isinstance(v, (int, np.integer)):
        a.type, a.i = 2, int(v)
    elif isinstance(v, (float, np.floating)):
        a.type, a.f = 1, float(v)
    elif isinstance(v, str):
        a.type, a.s = 3, v.encode("utf-8")
    elif isinstance(v, (list, tuple, np.ndarray)):
        seq = list(v)
        if all(isinstance(x, (int, np.integer)) for x in seq):
            a.type, a.ints = 7, [int(x) for x in seq]
        elif all(isinstance(x, (float, np.floating, int, np.integer)) for x in seq):
            a.type, a.floats = 6, [float(x) for x in seq]
        elif all(isinstance(x, str) for x in seq):
            a.type, a.strings = 8, [x.encode("utf-8") for x in seq]
        else:
            raise TypeError(f"attribute {name}: unsupported sequence {seq[:3]}")
    else:
        raise TypeError(f"attribute {name}: unsupported type {type(v)}")
    return a


def node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
         name: str = "", **attrs) -> NodeProto:
    return NodeProto(
        op_type=op_type,
        name=name or f"{op_type}_{outputs[0] if outputs else ''}",
        input=list(inputs),
        output=list(outputs),
        attribute=[_attr(k, v) for k, v in attrs.items() if v is not None],
    )


def value_info(name: str, dtype=np.float32, shape: Optional[Sequence[Any]] = None) -> ValueInfo:
    return ValueInfo(name=name, elem_type=DataType.from_numpy(dtype),
                     shape=list(shape) if shape is not None else None)


def constant_node(output: str, arr: np.ndarray) -> NodeProto:
    return node("Constant", [], [output], value=numpy_to_tensor(output, np.asarray(arr)))


def make_graph(nodes: Sequence[NodeProto], name: str,
               inputs: Sequence[ValueInfo], outputs: Sequence[ValueInfo],
               initializers: Optional[Dict[str, np.ndarray]] = None) -> GraphProto:
    return GraphProto(
        name=name,
        node=list(nodes),
        input=list(inputs),
        output=list(outputs),
        initializer=[numpy_to_tensor(k, np.asarray(v)) for k, v in (initializers or {}).items()],
    )


def make_model(graph: GraphProto, opset: int = 17, producer: str = "synapseml_tpu") -> ModelProto:
    return ModelProto(ir_version=8, producer_name=producer, graph=graph,
                      opset_imports={"": opset})


def save_model(model: ModelProto, path: str) -> None:
    with open(path, "wb") as f:
        f.write(serialize_model(model))
