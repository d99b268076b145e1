"""ONNX graphs for the tests and ``chip_smoke.py``, built in the repository.

Neither a quantized model nor a recurrent one can be downloaded here, so the
ONNX executor's quantized and recurrent paths run on graphs built from the
model zoo and the builder:

- :func:`quantize_dynamic_graph` rewrites a float model into the form that
  onnxruntime's ``quantize_dynamic`` emits (IntegerOps format): every
  ``MatMul`` and ``Conv`` whose weight is an initializer becomes
  ``DynamicQuantizeLinear`` on the activation (uint8; one per activation,
  shared by its consumers), the weight as an int8 initializer (symmetric per
  tensor, zero point 0), ``MatMulInteger`` / ``ConvInteger``, ``Cast`` to
  f32, ``Mul`` by ``x_scale * w_scale``, then the conv's bias ``Add``;
- :func:`recurrent_graph` builds a single-layer forward ``LSTM`` or ``GRU``
  graph with seeded weights.

Both packages run these graphs (the JAX package's tests use them too); they
add no feature to either.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..onnx.builder import make_graph, make_model, node, value_info
from ..onnx.wire import DataType, ModelProto, numpy_to_tensor, tensor_to_numpy

__all__ = ["quantize_dynamic_graph", "recurrent_graph", "quantized_node_counts"]


def _int8_symmetric(w: np.ndarray):
    """onnxruntime's symmetric int8 weight: scale max|w| / 127, zero point 0."""
    amax = float(np.max(np.abs(w))) if w.size else 0.0
    scale = np.float32(amax / 127.0 if amax > 0 else 1.0)
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def quantize_dynamic_graph(model: ModelProto) -> ModelProto:
    """The model with every ``MatMul`` / ``Conv`` whose weight (input 1) is a
    float initializer rewritten into the IntegerOps form (module doc). The
    rewritten node's output keeps its name, so the rest of the graph is
    unchanged."""
    model = copy.deepcopy(model)
    g = model.graph
    inits = {t.name: t for t in g.initializer}
    float_w = {name for name, t in inits.items() if t.data_type == DataType.FLOAT}
    nodes: List = []
    quantized: Dict[str, tuple] = {}   # activation -> (q, scale, zp) names
    new_inits: Dict[str, np.ndarray] = {}
    for n in g.node:
        w_name = n.input[1] if len(n.input) > 1 else ""
        rank = len(inits[w_name].dims) if w_name in inits else 0
        if not (w_name in float_w and ((n.op_type == "MatMul" and rank == 2)
                                       or (n.op_type == "Conv" and rank == 4))):
            nodes.append(n)
            continue
        x = n.input[0]
        if x not in quantized:
            quantized[x] = (f"{x}_quantized", f"{x}_scale", f"{x}_zero_point")
            nodes.append(node("DynamicQuantizeLinear", [x], list(quantized[x]),
                              name=f"{x}_QuantizeLinear"))
        xq, xs, xz = quantized[x]
        wq, ws = _int8_symmetric(tensor_to_numpy(inits[w_name]))
        new_inits[f"{w_name}_quantized"] = wq
        new_inits[f"{w_name}_scale"] = np.asarray(ws, np.float32)
        new_inits[f"{w_name}_zero_point"] = np.asarray(0, np.int8)
        out = n.output[0]
        q_ins = [xq, f"{w_name}_quantized", xz, f"{w_name}_zero_point"]
        if n.op_type == "MatMul":
            nodes.append(node("MatMulInteger", q_ins, [f"{out}_int"], name=f"{n.name}_quant"))
        else:
            attrs = {a.name: a.value() for a in n.attribute}
            nodes.append(node("ConvInteger", q_ins, [f"{out}_int"], name=f"{n.name}_quant",
                              **attrs))
        nodes.append(node("Cast", [f"{out}_int"], [f"{out}_cast"], to=DataType.FLOAT))
        nodes.append(node("Mul", [xs, f"{w_name}_scale"], [f"{out}_scales"]))
        has_bias = n.op_type == "Conv" and len(n.input) > 2 and n.input[2]
        scaled = f"{out}_scaled" if has_bias else out
        nodes.append(node("Mul", [f"{out}_cast", f"{out}_scales"], [scaled]))
        if has_bias:
            b = tensor_to_numpy(inits[n.input[2]]).reshape(1, -1, 1, 1)
            new_inits[f"{n.input[2]}_reshaped"] = b
            nodes.append(node("Add", [scaled, f"{n.input[2]}_reshaped"], [out]))
    used = {i for n in nodes for i in n.input}
    g.node = nodes
    g.initializer = [t for t in g.initializer if t.name in used] + \
        [numpy_to_tensor(k, v) for k, v in new_inits.items()]
    return model


def quantized_node_counts(model: ModelProto) -> Dict[str, int]:
    """Nodes by op type (what the rewrite made: MatMulInteger, ConvInteger)."""
    out: Dict[str, int] = {}
    for n in model.graph.node:
        out[n.op_type] = out.get(n.op_type, 0) + 1
    return out


def recurrent_graph(kind: str, seq: int, batch: int, input_size: int, hidden: int,
                    seed: int = 0, peepholes: bool = False, clip: Optional[float] = None,
                    activations: Optional[Sequence[str]] = None,
                    linear_before_reset: int = 0, initial_state: bool = False,
                    bias: bool = True) -> ModelProto:
    """A single-layer forward ``LSTM`` or ``GRU`` graph over ``x`` (seq,
    batch, input_size) f32, weights N(0, 1/hidden) from ``seed``. Outputs
    ``y`` (seq, 1, batch, hidden), ``y_h`` (and ``y_c`` for the LSTM)."""
    if kind not in ("LSTM", "GRU"):
        raise ValueError(f"kind must be LSTM or GRU, got {kind!r}")
    gates = 4 if kind == "LSTM" else 3
    rng = np.random.default_rng(seed)
    s = np.float32(1.0 / np.sqrt(hidden))
    inits = {"W": (rng.normal(size=(1, gates * hidden, input_size)) * s).astype(np.float32),
             "R": (rng.normal(size=(1, gates * hidden, hidden)) * s).astype(np.float32)}
    ins = ["x", "W", "R", "", "", "", "", ""]
    if bias:
        inits["B"] = (rng.normal(size=(1, 2 * gates * hidden)) * 0.1).astype(np.float32)
        ins[3] = "B"
    if initial_state:
        inits["h0"] = rng.normal(size=(1, batch, hidden)).astype(np.float32) * 0.5
        ins[5] = "h0"
        if kind == "LSTM":
            inits["c0"] = rng.normal(size=(1, batch, hidden)).astype(np.float32) * 0.5
            ins[6] = "c0"
    if peepholes:
        if kind != "LSTM":
            raise ValueError("peepholes are an LSTM input")
        inits["P"] = (rng.normal(size=(1, 3 * hidden)) * 0.1).astype(np.float32)
        ins[7] = "P"
    while ins and not ins[-1]:
        ins.pop()
    outs = ["y", "y_h"] + (["y_c"] if kind == "LSTM" else [])
    attrs = dict(hidden_size=hidden, clip=clip, activations=list(activations)
                 if activations else None)
    if kind == "GRU":
        attrs["linear_before_reset"] = linear_before_reset
    g = make_graph([node(kind, ins, outs, **attrs)], f"{kind.lower()}_h{hidden}",
                   [value_info("x", np.float32, [seq, batch, input_size])],
                   [value_info(o, np.float32, None) for o in outs], inits)
    return make_model(g, opset=17)
