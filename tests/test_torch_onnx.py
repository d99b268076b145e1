"""The port's ONNX executor against the JAX package's, on the CPU.

Every test of ``tests/test_onnx.py`` but the six tensor-parallel / fsdp ones
(ROADMAP item 6), and the golden tests of ``tests/test_onnx_thirdparty.py``
(hand-encoded protobuf, ``torch.onnx.export`` graphs, external data,
function protos), each held to the reference's outputs on the same inputs
and to its own golden values. The promotion table of ``ops.result_type`` is
held to ``jnp.result_type``, and the op registries to each other.
"""

import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synapseml_tpu.onnx import importer as ref_importer
from synapseml_tpu.onnx import wire as ref_wire
from synapseml_tpu.onnx.ops import OPS as REF_OPS
from synapseml_tpu_torch.core import Table
from synapseml_tpu_torch.onnx import (ONNXModel, OnnxFunction, make_graph, make_model, node,
                                      parse_model, serialize_model, value_info)
from synapseml_tpu_torch.onnx.ops import OPS, result_type
from synapseml_tpu_torch.onnx.wire import numpy_to_tensor, tensor_to_numpy
import test_onnx_thirdparty as third
from torch_onnx import (T, assert_bf16, assert_exact, assert_f32, assert_outputs,
                        op_both, run_both)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def graph_bytes(nodes, inputs, outputs, inits=None, opset=17):
    return serialize_model(make_model(make_graph(nodes, "test", inputs, outputs, inits),
                                      opset=opset))


def both(nodes, inputs, outputs, feeds, inits=None, opset=17, **kw):
    return run_both(graph_bytes(nodes, inputs, outputs, inits, opset), feeds, **kw)


def test_op_registry_matches_the_reference():
    assert set(OPS) == set(REF_OPS)
    assert len(OPS) == 132


# -- promotion ---------------------------------------------------------------------------

_STRONG = {np.dtype(np.bool_): torch.bool, np.dtype(np.uint8): torch.uint8,
           np.dtype(np.uint16): torch.uint16, np.dtype(np.uint32): torch.uint32,
           np.dtype(np.uint64): torch.uint64, np.dtype(np.int8): torch.int8,
           np.dtype(np.int16): torch.int16, np.dtype(np.int32): torch.int32,
           np.dtype(np.int64): torch.int64, jnp.dtype(jnp.bfloat16): torch.bfloat16,
           np.dtype(np.float16): torch.float16, np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64}
_WEAK = [True, 3, 2.5]
_CANON = {torch.int64: torch.int32, torch.uint64: torch.uint32, torch.float64: torch.float32}


def _to_torch(jdt) -> torch.dtype:
    return {np.dtype(k): v for k, v in _STRONG.items()}[np.dtype(jdt)]


@pytest.mark.parametrize("a,b", list(itertools.product(list(_STRONG) + _WEAK, repeat=2)),
                         ids=lambda v: str(v))
def test_result_type_follows_jax_promotion(a, b):
    """``result_type`` over every pair of the dtypes ONNX graphs carry and
    Python scalars (weak): as ``jnp.result_type`` up to its x64 truncation,
    and exactly ``jnp.promote_types`` for two strong dtypes."""
    pa = _STRONG[a] if not isinstance(a, (bool, int, float)) else a
    pb = _STRONG[b] if not isinstance(b, (bool, int, float)) else b
    ja = a if isinstance(a, (bool, int, float)) else jnp.zeros((), a)
    jb = b if isinstance(b, (bool, int, float)) else jnp.zeros((), b)
    # jnp.result_type truncates 64-bit inputs and results (x64 off): hold the
    # port's result over the truncated inputs to it
    canon = lambda v: _CANON.get(v, v) if isinstance(v, torch.dtype) else v
    got = result_type(canon(pa), canon(pb))
    assert canon(got) == _to_torch(jnp.result_type(ja, jb))
    if not isinstance(a, (bool, int, float)) and not isinstance(b, (bool, int, float)):
        assert result_type(pa, pb) == _to_torch(jnp.promote_types(a, b))


# -- wire ----------------------------------------------------------------------------------

def test_wire_roundtrip():
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    g = make_graph([node("MatMul", ["x", "w"], ["y"]), node("Relu", ["y"], ["z"])], "rt",
                   [value_info("x", np.float32, ["N", 4])],
                   [value_info("z", np.float32, ["N", 3])], {"w": w})
    data = serialize_model(make_model(g, opset=15))
    back = parse_model(data)
    assert back.opset_version == 15
    assert [n.op_type for n in back.graph.node] == ["MatMul", "Relu"]
    np.testing.assert_allclose(tensor_to_numpy(back.graph.initializer[0]), w)
    assert back.graph.input[0].shape == ["N", 4]
    # the copy writes the reference's bytes
    from synapseml_tpu.onnx import builder as rb

    rg = rb.make_graph([rb.node("MatMul", ["x", "w"], ["y"]), rb.node("Relu", ["y"], ["z"])],
                       "rt", [rb.value_info("x", np.float32, ["N", 4])],
                       [rb.value_info("z", np.float32, ["N", 3])], {"w": w})
    assert ref_wire.serialize_model(rb.make_model(rg, opset=15)) == data


def test_tensor_dtypes_roundtrip():
    for dtype in [np.float32, np.int64, np.int32, np.uint8, np.bool_, np.float16]:
        arr = (np.arange(6).reshape(2, 3) % 2).astype(dtype)
        back = tensor_to_numpy(numpy_to_tensor("t", arr))
        np.testing.assert_array_equal(back, arr)
        np.testing.assert_array_equal(ref_wire.tensor_to_numpy(numpy_to_tensor("t", arr)), arr)


def test_bfloat16_initializer_roundtrips_both_packages_bit_for_bit():
    """A bf16 tensor written by the reference (ml_dtypes) reads in the port as a
    ``torch.bfloat16`` tensor with the same bits, and back."""
    bits = np.array([0x3F80, 0xC049, 0x7F80, 0x0001, 0x8000, 0x7FC0, 0x4B00], np.uint16)
    ref_arr = bits.view(jnp.bfloat16.dtype)
    t = ref_wire.numpy_to_tensor("w", ref_arr)
    port = tensor_to_numpy(ref_wire.parse_model(ref_wire.serialize_model(
        ref_wire.ModelProto(graph=ref_wire.GraphProto(initializer=[t])))).graph.initializer[0])
    assert port.dtype == torch.bfloat16
    np.testing.assert_array_equal(port.view(torch.int16).numpy().view(np.uint16), bits)
    back = ref_wire.tensor_to_numpy(numpy_to_tensor("w", port))
    np.testing.assert_array_equal(np.asarray(back).view(np.uint16), bits)


# -- executor against the reference -------------------------------------------------------

def test_matmul_relu_exec():
    w = np.array([[1.0, -1.0], [2.0, 0.5]], dtype=np.float32)
    x = np.array([[1.0, 2.0]], dtype=np.float32)
    port, ref = both([node("MatMul", ["x", "w"], ["y"]), node("Relu", ["y"], ["z"])],
                     [value_info("x", np.float32, [None, 2])],
                     [value_info("z", np.float32, [None, 2])], {"x": x}, {"w": w})
    np.testing.assert_allclose(port["z"], np.maximum(x @ w, 0))
    assert_outputs(port, ref)


@pytest.mark.parametrize("stride,pad", [(1, 0), (2, 1), (1, 2)])
def test_conv_matches_torch(stride, pad):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 16, 16)).astype(np.float32)
    w = rng.normal(size=(5, 3, 3, 3)).astype(np.float32)
    b = rng.normal(size=(5,)).astype(np.float32)
    truth = torch.nn.functional.conv2d(torch.tensor(x), torch.tensor(w), torch.tensor(b),
                                       stride=stride, padding=pad).numpy()
    port, ref = both([node("Conv", ["x", "w", "b"], ["y"], kernel_shape=[3, 3],
                           strides=[stride, stride], pads=[pad, pad, pad, pad])],
                     [value_info("x", np.float32, list(x.shape))],
                     [value_info("y", np.float32, None)], {"x": x}, {"w": w, "b": b})
    np.testing.assert_allclose(port["y"], truth, rtol=1e-4, atol=1e-4)
    assert_outputs(port, ref)


def test_grouped_conv_matches_torch():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 4, 8, 8)).astype(np.float32)
    w = rng.normal(size=(8, 2, 3, 3)).astype(np.float32)  # groups=2
    truth = torch.nn.functional.conv2d(torch.tensor(x), torch.tensor(w), groups=2,
                                       padding=1).numpy()
    port, ref = both([node("Conv", ["x", "w"], ["y"], kernel_shape=[3, 3], pads=[1, 1, 1, 1],
                           group=2)],
                     [value_info("x", np.float32, list(x.shape))],
                     [value_info("y", np.float32, None)], {"x": x}, {"w": w})
    np.testing.assert_allclose(port["y"], truth, rtol=1e-4, atol=1e-4)
    assert_outputs(port, ref)


def test_maxpool_avgpool_match_torch():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 3, 9, 9)).astype(np.float32)
    tx = torch.tensor(x)
    port, ref = both(
        [node("MaxPool", ["x"], ["m"], kernel_shape=[3, 3], strides=[2, 2], pads=[1, 1, 1, 1]),
         node("AveragePool", ["x"], ["a"], kernel_shape=[2, 2], strides=[2, 2]),
         node("AveragePool", ["x"], ["c"], kernel_shape=[3, 3], strides=[2, 2],
              pads=[1, 1, 1, 1], ceil_mode=1)],
        [value_info("x", np.float32, list(x.shape))],
        [value_info("m", np.float32, None), value_info("a", np.float32, None),
         value_info("c", np.float32, None)], {"x": x})
    np.testing.assert_allclose(port["m"], torch.nn.functional.max_pool2d(
        tx, 3, stride=2, padding=1).numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port["a"], torch.nn.functional.avg_pool2d(
        tx, 2, stride=2).numpy(), rtol=1e-5, atol=1e-5)
    assert_outputs(port, ref)


def test_batchnorm_gemm_match_torch():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(4, 6, 5, 5)).astype(np.float32)
    scale, bias, mean = (rng.normal(size=6).astype(np.float32) for _ in range(3))
    var = rng.uniform(0.5, 2.0, size=6).astype(np.float32)
    truth = torch.nn.functional.batch_norm(
        torch.tensor(x), torch.tensor(mean), torch.tensor(var), torch.tensor(scale),
        torch.tensor(bias), eps=1e-5).numpy()
    port, ref = both([node("BatchNormalization", ["x", "s", "b", "m", "v"], ["y"],
                           epsilon=1e-5)],
                     [value_info("x", np.float32, list(x.shape))],
                     [value_info("y", np.float32, None)], {"x": x},
                     {"s": scale, "b": bias, "m": mean, "v": var})
    np.testing.assert_allclose(port["y"], truth, rtol=1e-3, atol=1e-4)
    assert_outputs(port, ref)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    w = rng.normal(size=(5, 4)).astype(np.float32)
    c = rng.normal(size=(5,)).astype(np.float32)
    port, ref = both([node("Gemm", ["a", "w", "c"], ["y"], transB=1, alpha=1.0, beta=1.0)],
                     [value_info("a", np.float32, [3, 4])],
                     [value_info("y", np.float32, None)], {"a": a}, {"w": w, "c": c})
    np.testing.assert_allclose(port["y"], a @ w.T + c, rtol=1e-4, atol=1e-5)
    assert_outputs(port, ref)


def test_layernorm_softmax_match_torch():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 8)).astype(np.float32)
    g, b = rng.normal(size=8).astype(np.float32), rng.normal(size=8).astype(np.float32)
    truth = torch.nn.functional.layer_norm(torch.tensor(x), (8,), torch.tensor(g),
                                           torch.tensor(b), eps=1e-5).numpy()
    port, ref = both([node("LayerNormalization", ["x", "g", "b"], ["y"], axis=-1, epsilon=1e-5),
                      node("Softmax", ["y"], ["p"], axis=-1)],
                     [value_info("x", np.float32, list(x.shape))],
                     [value_info("y", np.float32, None), value_info("p", np.float32, None)],
                     {"x": x}, {"g": g, "b": b})
    np.testing.assert_allclose(port["y"], truth, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(port["p"], torch.softmax(torch.tensor(truth), -1).numpy(),
                               rtol=1e-3, atol=1e-5)
    assert_outputs(port, ref)


def test_dynamic_shape_chain_constant_folds():
    """BERT-style Shape->Gather->Concat->Reshape chain folds on the host: the
    second call replays only the Reshape."""
    mb = graph_bytes(
        [node("Shape", ["x"], ["shp"]), node("Gather", ["shp", "zero"], ["batch"], axis=0),
         node("Gather", ["shp", "one"], ["seq"], axis=0),
         node("Unsqueeze", ["batch", "ax0"], ["b1"]), node("Unsqueeze", ["seq", "ax0"], ["s1"]),
         node("Concat", ["b1", "s1", "negone"], ["newshape"], axis=0),
         node("Reshape", ["x", "newshape"], ["y"])],
        [value_info("x", np.float32, [None, None, 2, 3])], [value_info("y", np.float32, None)],
        {"zero": np.array(0, dtype=np.int64), "one": np.array(1, dtype=np.int64),
         "ax0": np.array([0], dtype=np.int64), "negone": np.array([-1], dtype=np.int64)})
    x = np.arange(2 * 5 * 2 * 3, dtype=np.float32).reshape(2, 5, 2, 3)
    port, ref = run_both(mb, {"x": x})
    assert port["y"].shape == (2, 5, 6)
    np.testing.assert_allclose(port["y"], x.reshape(2, 5, 6))
    assert_outputs(port, ref)
    fn = OnnxFunction(mb, device="cpu")
    fn({"x": x})
    (plan,) = fn._plans.values()
    assert sorted(plan.folded) == [(i,) for i in range(6)]   # all but the Reshape
    np.testing.assert_allclose(fn({"x": x})["y"].numpy(), x.reshape(2, 5, 6))
    x2 = np.ones((3, 4, 2, 3), np.float32)   # a second signature: a second plan
    assert fn({"x": x2})["y"].shape == (3, 4, 6) and len(fn._plans) == 2


def test_slice_split_transpose_ops():
    x = np.arange(24, dtype=np.float32).reshape(4, 6)
    port, ref = both(
        [node("Transpose", ["x"], ["t"], perm=[1, 0]),
         node("Slice", ["x", "starts", "ends", "axes"], ["s"]),
         node("Slice", ["x", "ends", "starts", "axes", "neg"], ["r"]),
         node("Split", ["x"], ["a", "b"], axis=1, num_outputs=2)],
        [value_info("x", np.float32, [4, 6])],
        [value_info(n, np.float32, None) for n in ("t", "s", "r", "a", "b")], {"x": x},
        {"starts": np.array([1], dtype=np.int64), "ends": np.array([3], dtype=np.int64),
         "axes": np.array([0], dtype=np.int64), "neg": np.array([-1], dtype=np.int64)},
        opset=13)
    np.testing.assert_allclose(port["t"], x.T)
    np.testing.assert_allclose(port["s"], x[1:3])
    np.testing.assert_allclose(port["r"], x[3:1:-1])
    np.testing.assert_allclose(port["a"], x[:, :3])
    np.testing.assert_allclose(port["b"], x[:, 3:])
    assert_outputs(port, ref, check=assert_exact)


def test_squeeze_axes_attr_pre13_and_input_post13():
    x = np.zeros((1, 3, 1), dtype=np.float32)
    port, ref = both([node("Squeeze", ["x"], ["y"], axes=[0])],
                     [value_info("x", np.float32, [1, 3, 1])],
                     [value_info("y", np.float32, None)], {"x": x}, opset=11)
    assert port["y"].shape == (3, 1) == ref["y"].shape
    port, ref = both([node("Squeeze", ["x", "axes"], ["y"])],
                     [value_info("x", np.float32, [1, 3, 1])],
                     [value_info("y", np.float32, None)], {"x": x},
                     {"axes": np.array([2], dtype=np.int64)}, opset=13)
    assert port["y"].shape == (1, 3) == ref["y"].shape


def test_reduce_erf_where_cast():
    import scipy.special

    x = np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)
    port, ref = both(
        [node("ReduceMean", ["x"], ["m"], axes=[1], keepdims=1), node("Erf", ["x"], ["e"]),
         node("Cast", ["x"], ["i"], to=7), node("Greater", ["x", "m"], ["g"]),
         node("Where", ["g", "x", "m"], ["w"])],
        [value_info("x", np.float32, [3, 4])],
        [value_info(n, np.float32, None) for n in ["m", "e", "i", "g", "w"]], {"x": x},
        opset=13)
    np.testing.assert_allclose(port["m"], x.mean(1, keepdims=True), rtol=1e-5)
    np.testing.assert_allclose(port["e"], scipy.special.erf(x), rtol=1e-4)
    assert port["i"].dtype == np.int64   # ONNX's int64 (the reference's x64-less int32)
    for k in ("i", "g"):
        assert_exact(port[k], ref[k])
    for k in ("m", "e", "w"):
        assert_f32(port[k], ref[k])


def test_unsupported_op_reported():
    mb = graph_bytes([node("NotARealOp", ["x"], ["y"])], [value_info("x", np.float32, [1])],
                     [value_info("y", np.float32, None)])
    with pytest.raises(NotImplementedError, match="NotARealOp"):
        OnnxFunction(mb, device="cpu")


def test_bfloat16_policy_small_cnn():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3, 8, 8)).astype(np.float32)
    w = rng.normal(size=(4, 3, 3, 3)).astype(np.float32) * 0.1
    nodes = [node("Conv", ["x", "w"], ["c"], kernel_shape=[3, 3], pads=[1, 1, 1, 1]),
             node("Relu", ["c"], ["r"]), node("GlobalAveragePool", ["r"], ["g"]),
             node("Flatten", ["g"], ["y"])]
    ins, outs = [value_info("x", np.float32, list(x.shape))], [value_info("y", np.float32, None)]
    f32, _ = both(nodes, ins, outs, {"x": x}, {"w": w})
    port, ref = both(nodes, ins, outs, {"x": x}, {"w": w}, dtype_policy="bfloat16")
    assert port["y"].dtype == np.float32  # policy casts outputs back
    np.testing.assert_allclose(f32["y"], port["y"], rtol=0.05, atol=0.02)
    assert_outputs(port, ref, check=assert_bf16)


def test_bfloat16_policy_matmul_returns_f32_and_promotes():
    """Under the bf16 policy ``MatMul`` returns f32 (the reference's
    ``preferred_element_type``), and bf16 meeting f32 computes in f32."""
    rng = np.random.default_rng(17)
    x = rng.normal(size=(3, 8)).astype(np.float32)
    w, v = rng.normal(size=(8, 8)).astype(np.float32), rng.normal(size=(8, 4)).astype(np.float32)
    nodes = [node("MatMul", ["x", "w"], ["h"]), node("Add", ["h", "x"], ["s"]),
             node("MatMul", ["s", "v"], ["y"]), node("Gemm", ["x", "w"], ["gm"])]
    mb = graph_bytes(nodes, [value_info("x", np.float32, [3, 8])],
                     [value_info(n, np.float32, None) for n in ("h", "y", "gm")],
                     {"w": w, "v": v})
    fn = OnnxFunction(mb, dtype_policy="bfloat16", device="cpu")
    env_out = fn({"x": x})
    port, ref = run_both(mb, {"x": x}, dtype_policy="bfloat16")
    assert all(t.dtype == torch.float32 for t in env_out.values())
    assert_outputs(port, ref, check=assert_bf16)


def test_onnx_model_transformer_end_to_end():
    """Pipeline-level: ONNXModel with feed/fetch/softmax/argmax over a Table."""
    from synapseml_tpu.core import Table as RefTable
    from synapseml_tpu.onnx import ONNXModel as RefModel

    rng = np.random.default_rng(8)
    w = rng.normal(size=(4, 3)).astype(np.float32)
    mb = graph_bytes([node("MatMul", ["features", "w"], ["logits"])],
                     [value_info("features", np.float32, [None, 4])],
                     [value_info("logits", np.float32, [None, 3])], {"w": w})
    feat = rng.normal(size=(10, 4)).astype(np.float32)
    params = dict(feed_dict={"features": "feat"}, fetch_dict={"rawPrediction": "logits"},
                  softmax_dict={"rawPrediction": "probability"},
                  argmax_dict={"rawPrediction": "prediction"},
                  batch_size=4)  # forces pad-to-bucket on the final batch of 2
    out = ONNXModel(device="cpu", **params).set_model(mb).transform(Table({"feat": feat}))
    want = RefModel(**params).set_model(mb).transform(RefTable({"feat": feat}))
    logits = feat @ w
    np.testing.assert_allclose(out["rawPrediction"], logits, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out["probability"].sum(axis=1), np.ones(10), rtol=1e-5)
    np.testing.assert_array_equal(out["prediction"], logits.argmax(1))
    assert out["prediction"].dtype == np.int64 and out["probability"].dtype == np.float32
    for col in ("rawPrediction", "probability"):
        assert_f32(out[col], want[col])
    assert_exact(out["prediction"], want["prediction"])


def test_onnx_model_save_load(tmp_path):
    from synapseml_tpu_torch.core import STAGE_REGISTRY, load_stage

    assert STAGE_REGISTRY["ONNXModel"] is ONNXModel
    rng = np.random.default_rng(9)
    w = rng.normal(size=(2, 2)).astype(np.float32)
    mb = graph_bytes([node("MatMul", ["x", "w"], ["y"])], [value_info("x", np.float32, [None, 2])],
                     [value_info("y", np.float32, None)], {"w": w})
    m = ONNXModel(feed_dict={"x": "c"}, fetch_dict={"out": "y"}, device="cpu").set_model(mb)
    t = Table({"c": rng.normal(size=(3, 2)).astype(np.float32)})
    expected = m.transform(t)["out"]
    p = str(tmp_path / "onnxstage")
    m.save(p)
    m2 = load_stage(p)
    assert isinstance(m2, ONNXModel) and m2.device == "cpu" and m2.model_bytes == mb
    np.testing.assert_allclose(m2.transform(t)["out"], expected, rtol=1e-6)


def test_onnx_model_schema_and_default_device():
    """``transform_schema`` from the graph's value_info (parsing only); with no
    card the stage's default device raises DeviceUnavailableError on use."""
    from synapseml_tpu_torch.core.schema import SchemaError, TableSchema
    from synapseml_tpu_torch.runtime.device import DeviceUnavailableError

    mb = graph_bytes([node("MatMul", ["x", "w"], ["y"])], [value_info("x", np.float32, ["N", 2])],
                     [value_info("y", np.float32, ["N", 2])], {"w": np.eye(2, dtype=np.float32)})
    m = ONNXModel(feed_dict={"x": "c"}, fetch_dict={"out": "y"},
                  argmax_dict={"out": "pred"}).set_model(mb)
    schema = TableSchema.from_table(Table({"c": np.zeros((2, 2), np.float32)}))
    out = m.transform_schema(schema)
    assert out["out"].role == "vector" and out["pred"].dtype_class == "int"
    with pytest.raises(SchemaError):
        ONNXModel(feed_dict={"nope": "c"}, fetch_dict={"out": "y"}).set_model(
            mb).transform_schema(schema)
    if not torch.cuda.is_available():
        with pytest.raises(DeviceUnavailableError):
            m.transform(Table({"c": np.zeros((2, 2), np.float32)}))
        with pytest.raises(DeviceUnavailableError):
            OnnxFunction(mb)


def test_flatten_softmax_onehot_edge_cases():
    """Regression: negative axes and out-of-range indices (ONNX spec corners)."""
    p, r = op_both("Flatten", [T(np.zeros((2, 3, 4), np.float32))], {"axis": -1}, opset=13)
    assert p.shape == (6, 4) == r.shape
    p, r = op_both("Softmax", [T(np.ones((2, 3, 4), np.float32))], {"axis": -1}, opset=11)
    np.testing.assert_allclose(p.sum(-1), 1.0, rtol=1e-6)
    assert_f32(p, r)
    # OneHot: -1 wraps to depth-1; 5 is out of [-3, 2] -> all-off row
    p, r = op_both("OneHot", [np.array([5, -1, 2]), np.array(3), np.array([0.0, 1.0])], {},
                   opset=13)
    np.testing.assert_allclose(p, [[0, 0, 0], [0, 0, 1], [0, 0, 1]])
    assert_exact(p, r)


def test_quantize_linear_golden():
    """ONNX spec golden values: saturation at both ends and round-half-to-even."""
    x = np.array([0.0, 2.0, 3.0, 1000.0, -254.0, -1000.0], np.float32)
    p, r = op_both("QuantizeLinear", [T(x), np.float32(2.0), np.uint8(128)], opset=13)
    assert p.dtype == np.uint8
    np.testing.assert_array_equal(p, [128, 129, 130, 255, 1, 0])
    assert_exact(p, r)
    p, r = op_both("QuantizeLinear", [T(x), np.float32(2.0), np.int8(0)], opset=13)
    assert p.dtype == np.int8
    np.testing.assert_array_equal(p, [0, 1, 2, 127, -127, -128])
    assert_exact(p, r)


def test_quantize_linear_per_axis():
    x = np.array([[-1.5, 0.5, 3.4], [2.0, -5.0, 6.0]], np.float32)
    p, r = op_both("QuantizeLinear", [T(x), np.array([1.0, 2.0], np.float32),
                                      np.array([0, 10], np.int8)], {"axis": 0}, opset=13)
    np.testing.assert_array_equal(p, [[-2, 0, 3], [11, 8, 13]])
    assert_exact(p, r)


def test_dequantize_linear_golden():
    p, r = op_both("DequantizeLinear", [T(np.array([0, 3, 128, 255], np.uint8)),
                                        np.float32(2.0), np.uint8(128)], opset=13)
    assert p.dtype == np.float32
    np.testing.assert_allclose(p, [-256.0, -250.0, 0.0, 254.0])
    assert_exact(p, r)
    p, r = op_both("DequantizeLinear", [T(np.array([[0, 1, 2], [3, 4, 5]], np.int8)),
                                        np.array([2.0, 4.0], np.float32),
                                        np.array([0, 1], np.int8)], {"axis": 0}, opset=13)
    np.testing.assert_allclose(p, [[0, 2, 4], [8, 12, 16]])
    assert_exact(p, r)


def test_dynamic_quantize_linear_golden():
    x = np.array([-1.0, 0.0, 1.0, 3.0], np.float32)
    (y, scale, zp), ref = op_both("DynamicQuantizeLinear", [T(x)], opset=13)
    np.testing.assert_allclose(float(scale), 4.0 / 255.0, rtol=1e-6)
    assert int(zp) == 64 and zp.dtype == np.uint8
    np.testing.assert_array_equal(y, [0, 64, 128, 255])
    for a, b in zip((y, scale, zp), ref):
        assert_exact(a, b)
    (y, scale, zp), ref = op_both("DynamicQuantizeLinear", [T(np.zeros(4, np.float32))],
                                  opset=13)
    assert float(scale) == 0.0 and int(zp) == 0
    np.testing.assert_array_equal(y, [0, 0, 0, 0])
    for a, b in zip((y, scale, zp), ref):
        assert_exact(a, b)


def test_matmul_integer_golden():
    a = np.array([[11, 7, 3], [10, 6, 2], [9, 5, 1], [8, 4, 0]], np.uint8)
    b = np.array([[1, 4], [2, 5], [3, 6]], np.uint8)
    y, r = op_both("MatMulInteger", [T(a), T(b), np.uint8(12), np.uint8(0)], opset=13)
    assert y.dtype == np.int32
    np.testing.assert_array_equal(y, [[-38, -83], [-44, -98], [-50, -113], [-56, -128]])
    assert_exact(y, r)
    y2, r2 = op_both("MatMulInteger", [T(a), T(b), np.uint8(12), np.array([0, 1], np.uint8)],
                     opset=13)
    np.testing.assert_array_equal(y2[:, 1], y[:, 1] - (a.astype(np.int32) - 12).sum(1))
    assert_exact(y2, r2)


def test_conv_integer_golden():
    x = np.arange(2, 11, dtype=np.uint8).reshape(1, 1, 3, 3)
    w = np.ones((1, 1, 2, 2), np.uint8)
    y, r = op_both("ConvInteger", [T(x), T(w), np.uint8(1)], opset=13)
    assert y.dtype == np.int32
    np.testing.assert_array_equal(y.reshape(2, 2), [[12, 16], [24, 28]])
    assert_exact(y, r)
    yp, rp = op_both("ConvInteger", [T(x), T(w), np.uint8(1)], {"pads": [1, 1, 1, 1]}, opset=13)
    assert yp.shape == (1, 1, 4, 4)
    np.testing.assert_array_equal(yp[0, 0, 1:3, 1:3], [[12, 16], [24, 28]])
    assert int(yp[0, 0, 0, 0]) == 1  # lone corner pixel: 2-1
    assert_exact(yp, rp)


def test_qlinear_matmul_golden():
    a = np.array([[208, 236, 0, 238], [3, 214, 255, 29]], np.uint8)
    b = np.array([[152, 51, 244], [60, 26, 255], [0, 127, 246], [127, 254, 247]], np.uint8)
    y, r = op_both("QLinearMatMul", [T(a), np.float32(0.0066), np.uint8(113), T(b),
                                     np.float32(0.00705), np.uint8(114), np.float32(0.0107),
                                     np.uint8(118)], opset=13)
    assert y.dtype == np.uint8
    np.testing.assert_array_equal(y, [[168, 115, 255], [1, 66, 151]])
    assert_exact(y, r)


def test_qlinear_conv_golden():
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, size=(1, 1, 7, 7), dtype=np.uint8)
    x_scale, x_zp = np.float32(0.00369204697), np.uint8(132)
    w = np.array([0], np.uint8).reshape(1, 1, 1, 1)
    w_scale, w_zp = np.array([0.00172794575], np.float32), np.array([255], np.uint8)
    y_scale, y_zp = np.float32(0.00162681262), np.uint8(123)
    y, r = op_both("QLinearConv", [T(x), x_scale, x_zp, T(w), w_scale, w_zp, y_scale, y_zp],
                   opset=13)
    assert y.dtype == np.uint8
    acc = (x.astype(np.int32) - 132) * (0 - 255)
    want = np.clip(np.round(acc.astype(np.float32) * np.float32(
        float(x_scale) * float(w_scale[0]) / float(y_scale))) + 123, 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(y, want)
    assert_exact(y, r)


def test_qlinear_conv_graph_bias_padding_per_channel():
    rng = np.random.default_rng(6)
    x = rng.integers(0, 256, size=(1, 2, 5, 5), dtype=np.uint8)
    w = rng.integers(0, 256, size=(2, 2, 3, 3), dtype=np.uint8)
    bias = np.array([700, -1300], np.int32)
    x_scale, x_zp = np.float32(0.02), np.uint8(120)
    w_scale, w_zp = np.array([0.015, 0.03], np.float32), np.array([110, 140], np.uint8)
    y_scale, y_zp = np.float32(0.05), np.uint8(128)
    port, ref = both([node("QLinearConv", ["x", "xs", "xz", "w", "ws", "wz", "ys", "yz", "b"],
                           ["y"], pads=[1, 1, 1, 1])],
                     [value_info("x", np.uint8, [None, 2, 5, 5])],
                     [value_info("y", np.uint8, None)], {"x": x},
                     {"xs": x_scale, "xz": x_zp, "w": w, "ws": w_scale, "wz": w_zp,
                      "ys": y_scale, "yz": y_zp, "b": bias})
    y = port["y"]
    assert y.shape == (1, 2, 5, 5) and y.dtype == np.uint8
    xc = x.astype(np.int32) - int(x_zp)
    xp = np.zeros((1, 2, 7, 7), np.int32)
    xp[:, :, 1:6, 1:6] = xc
    want = np.empty((1, 2, 5, 5), np.uint8)
    for o in range(2):
        wc = w[o].astype(np.int32) - int(w_zp[o])
        scale = np.float32(float(x_scale) * float(w_scale[o]) / float(y_scale))
        for i in range(5):
            for j in range(5):
                acc = int((xp[0, :, i:i + 3, j:j + 3] * wc).sum()) + int(bias[o])
                want[0, o, i, j] = np.uint8(np.clip(np.round(np.float32(acc) * scale)
                                                    + int(y_zp), 0, 255))
    np.testing.assert_array_equal(y, want)
    assert_exact(y, ref["y"])


def test_matmul_integer_graph_matches_dequant_path():
    rng = np.random.default_rng(11)
    a = rng.integers(0, 255, size=(6, 16), dtype=np.uint8)
    w = rng.integers(0, 255, size=(16, 5), dtype=np.uint8)
    port, ref = both([node("MatMulInteger", ["a", "w", "az", "wz"], ["y"])],
                     [value_info("a", np.uint8, [None, 16])], [value_info("y", np.int32, None)],
                     {"a": a}, {"w": w, "az": np.uint8(121), "wz": np.uint8(130)})
    want = (a.astype(np.int32) - 121) @ (w.astype(np.int32) - 130)
    np.testing.assert_array_equal(port["y"], want)
    assert_exact(port["y"], ref["y"])


def test_quantize_dequantize_roundtrip_graph():
    rng = np.random.default_rng(7)
    x = rng.uniform(-4, 4, size=(5, 8)).astype(np.float32)
    port, ref = both([node("QuantizeLinear", ["x", "s", "z"], ["q"]),
                      node("DequantizeLinear", ["q", "s", "z"], ["y"])],
                     [value_info("x", np.float32, [None, 8])],
                     [value_info("y", np.float32, [None, 8])], {"x": x},
                     {"s": np.float32(8.0 / 255.0), "z": np.uint8(128)})
    np.testing.assert_allclose(port["y"], x, atol=8.0 / 255.0 / 2 + 1e-6)
    assert_exact(port["y"], ref["y"])


def test_onnx_model_empty_table():
    rng = np.random.default_rng(0)
    mb = graph_bytes([node("MatMul", ["x", "w"], ["y"])], [value_info("x", np.float32, ["N", 4])],
                     [value_info("y", np.float32, None)],
                     {"w": rng.normal(size=(4, 3)).astype(np.float32)})
    m = ONNXModel(feed_dict={"x": "c"}, fetch_dict={"out": "y"}, device="cpu").set_model(mb)
    out = m.transform(Table({"c": np.zeros((0, 4), np.float32)}))
    assert out["out"].shape == (0, 3)


# -- recurrent ops (the reference's numpy goldens) -----------------------------------------

def _np_sig(v):
    return 1.0 / (1.0 + np.exp(-v))


def test_lstm_matches_numpy_reference():
    rng = np.random.default_rng(3)
    s, b, i, h = 5, 2, 3, 4
    x = rng.normal(size=(s, b, i)).astype(np.float32)
    w = rng.normal(size=(1, 4 * h, i)).astype(np.float32)
    r = rng.normal(size=(1, 4 * h, h)).astype(np.float32)
    bias = rng.normal(size=(1, 8 * h)).astype(np.float32)
    h0 = rng.normal(size=(1, b, h)).astype(np.float32)
    c0 = rng.normal(size=(1, b, h)).astype(np.float32)
    p = rng.normal(size=(1, 3 * h)).astype(np.float32)
    (y, y_h, y_c), ref = op_both("LSTM", [T(x), w, r, bias, None, h0, c0, p],
                                 {"hidden_size": h})
    assert y.shape == (s, 1, b, h) and y_h.shape == (1, b, h)
    hc, cc = h0[0].astype(np.float64), c0[0].astype(np.float64)
    pi, po, pf = np.split(p[0].astype(np.float64), 3)
    cb = (bias[0, :4 * h] + bias[0, 4 * h:]).astype(np.float64)
    ys = []
    for t in range(s):
        zi, zo, zf, zc = np.split(x[t] @ w[0].T + hc @ r[0].T + cb, 4, axis=-1)
        gi, gf = _np_sig(zi + pi * cc), _np_sig(zf + pf * cc)
        cc = gf * cc + gi * np.tanh(zc)
        hc = _np_sig(zo + po * cc) * np.tanh(cc)
        ys.append(hc)
    np.testing.assert_allclose(y[:, 0], np.stack(ys), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(y_h[0], hc, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(y_c[0], cc, rtol=2e-5, atol=2e-5)
    for a, b_ in zip((y, y_h, y_c), ref):
        assert_f32(a, b_)


def test_lstm_defaults_zero_state():
    rng = np.random.default_rng(4)
    s, b, i, h = 3, 1, 2, 2
    x = rng.normal(size=(s, b, i)).astype(np.float32)
    w = rng.normal(size=(1, 4 * h, i)).astype(np.float32)
    r = rng.normal(size=(1, 4 * h, h)).astype(np.float32)
    (y1, _, c1), _ = op_both("LSTM", [T(x), w, r], {"hidden_size": h})
    (y2, _, c2), _ = op_both("LSTM", [T(x), w, r, np.zeros((1, 8 * h), np.float32), None,
                                      np.zeros((1, b, h), np.float32),
                                      np.zeros((1, b, h), np.float32)], {"hidden_size": h})
    np.testing.assert_allclose(y1, y2, rtol=1e-6)
    np.testing.assert_allclose(c1, c2, rtol=1e-6)


@pytest.mark.parametrize("lbr", [0, 1])
def test_gru_matches_numpy_reference(lbr):
    rng = np.random.default_rng(7 + lbr)
    s, b, i, h = 4, 3, 2, 5
    x = rng.normal(size=(s, b, i)).astype(np.float32)
    w = rng.normal(size=(1, 3 * h, i)).astype(np.float32)
    r = rng.normal(size=(1, 3 * h, h)).astype(np.float32)
    bias = rng.normal(size=(1, 6 * h)).astype(np.float32)
    h0 = rng.normal(size=(1, b, h)).astype(np.float32)
    (y, y_h), ref = op_both("GRU", [T(x), w, r, bias, None, h0],
                            {"hidden_size": h, "linear_before_reset": lbr})
    assert y.shape == (s, 1, b, h)
    hc = h0[0].astype(np.float64)
    wb, rb = bias[0, :3 * h].astype(np.float64), bias[0, 3 * h:].astype(np.float64)
    wz, wr, wh = np.split(w[0].astype(np.float64), 3)
    rz, rr, rh = np.split(r[0].astype(np.float64), 3)
    wbz, wbr, wbh = np.split(wb, 3)
    rbz, rbr, rbh = np.split(rb, 3)
    ys = []
    for t in range(s):
        z = _np_sig(x[t] @ wz.T + hc @ rz.T + wbz + rbz)
        rg = _np_sig(x[t] @ wr.T + hc @ rr.T + wbr + rbr)
        if lbr:
            hh = np.tanh(x[t] @ wh.T + rg * (hc @ rh.T + rbh) + wbh)
        else:
            hh = np.tanh(x[t] @ wh.T + (rg * hc) @ rh.T + wbh + rbh)
        hc = (1.0 - z) * hh + z * hc
        ys.append(hc)
    np.testing.assert_allclose(y[:, 0], np.stack(ys), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(y_h[0], hc, rtol=2e-5, atol=2e-5)
    for a, b_ in zip((y, y_h), ref):
        assert_f32(a, b_)


def test_lstm_graph_end_to_end():
    rng = np.random.default_rng(11)
    s, b, i, h = 4, 2, 3, 3
    w = rng.normal(size=(1, 4 * h, i)).astype(np.float32)
    r = rng.normal(size=(1, 4 * h, h)).astype(np.float32)
    x = rng.normal(size=(s, b, i)).astype(np.float32)
    port, ref = both([node("LSTM", ["x", "w", "r"], ["y", "y_h", "y_c"], hidden_size=h),
                      node("Relu", ["y_h"], ["z"])],
                     [value_info("x", np.float32, [s, b, i])],
                     [value_info("y", np.float32, None), value_info("z", np.float32, None)],
                     {"x": x}, {"w": w, "r": r})
    (direct, _, _), _ = op_both("LSTM", [T(x), w, r], {"hidden_size": h})
    np.testing.assert_allclose(port["y"], direct, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(port["z"], np.maximum(direct[-1], 0), rtol=1e-5, atol=1e-5)
    assert_outputs(port, ref)


# -- third-party producers (tests/test_onnx_thirdparty.py's graphs) ------------------------

@pytest.mark.parametrize("use_raw", [True, False], ids=["raw_data", "float_data"])
def test_handmade_onnx_parses_and_runs(use_raw):
    data = third._handmade_model(use_raw)
    model = parse_model(data)
    assert model.graph.name == "handmade"
    assert [n.op_type for n in model.graph.node] == ["MatMul", "Add", "Relu"]
    x = np.array([[1.0, 2.0, 3.0], [-1.0, 0.5, 2.0]], dtype=np.float32)
    port, ref = run_both(data, {"X": x})
    w = np.array([[1.0, -1.0], [0.5, 2.0], [-0.25, 0.0]], dtype=np.float32)
    b = np.array([0.1, -0.2], dtype=np.float32)
    np.testing.assert_allclose(port["Y"], np.maximum(x @ w + b, 0.0), rtol=1e-6)
    assert_outputs(port, ref)


def test_handmade_attrs_and_unknown_fields():
    graph = third._ld(1, third._node("ReduceSum", ["X"], ["Y"],
                                     attrs=third._attr_ints("axes", [1]))
                      + third._ld(29, b"unknown-node-field"))
    graph += third._ld(2, b"g2") + third._ld(11, third._value_info("X", [2, 3]))
    graph += third._ld(12, third._value_info("Y", [2, 1]))
    model = third._vi(1, 8) + third._ld(8, third._vi(2, 11)) + third._ld(7, graph)
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    port, ref = run_both(bytes(model), {"X": x})
    np.testing.assert_allclose(port["Y"], x.sum(axis=1, keepdims=True))
    assert_outputs(port, ref)


def test_torch_export_cnn():
    nn = torch.nn
    torch.manual_seed(0)

    class M(nn.Module):
        def __init__(self):
            super().__init__()
            self.c = nn.Conv2d(3, 8, 3, padding=1)
            self.b = nn.BatchNorm2d(8)
            self.l = nn.Linear(8 * 4 * 4, 5)

        def forward(self, x):
            h = torch.relu(self.b(self.c(x)))
            h = torch.nn.functional.max_pool2d(h, 2)
            return self.l(h.flatten(1))

    m = M()
    m.b.running_mean.normal_()
    m.b.running_var.uniform_(0.5, 2.0)
    xin = torch.randn(2, 3, 8, 8)
    port, ref = run_both(third._torch_export(m, xin), {"x": xin.numpy()})
    np.testing.assert_allclose(port["y"], m.eval()(xin).detach().numpy(), rtol=1e-4, atol=1e-5)
    assert_outputs(port, ref)


def test_torch_export_transformer_block():
    nn = torch.nn
    torch.manual_seed(1)

    class Block(nn.Module):
        def __init__(self, d=32, h=4):
            super().__init__()
            self.attn = nn.MultiheadAttention(d, h, batch_first=True)
            self.ln1, self.ln2 = nn.LayerNorm(d), nn.LayerNorm(d)
            self.ff = nn.Sequential(nn.Linear(d, 64), nn.GELU(), nn.Linear(64, d))

        def forward(self, x):
            a, _ = self.attn(x, x, x, need_weights=False)
            x = self.ln1(x + a)
            return self.ln2(x + self.ff(x))

    blk = Block()
    xb = torch.randn(2, 10, 32)
    port, ref = run_both(third._torch_export(blk, xb, opset=14), {"x": xb.numpy()})
    np.testing.assert_allclose(port["y"], blk.eval()(xb).detach().numpy(), rtol=1e-4, atol=1e-5)
    assert_outputs(port, ref)


def test_external_data_tensor(tmp_path):
    from synapseml_tpu_torch.onnx.importer import load_model

    w = np.array([[1.0, -1.0], [0.5, 2.0], [-0.25, 0.0]], dtype=np.float32)
    pad = b"\x00" * 16  # nonzero offset: tensors share one side file
    (tmp_path / "weights.bin").write_bytes(pad + w.tobytes())
    model = third._external_model("weights.bin", len(pad), w.nbytes)
    (tmp_path / "model.onnx").write_bytes(model)
    x = np.array([[1.0, 2.0, 3.0], [-1.0, 0.5, 2.0]], dtype=np.float32)
    out = load_model(str(tmp_path / "model.onnx"), device="cpu")({"X": x})["Y"].numpy()
    np.testing.assert_allclose(out, x @ w, rtol=1e-6)
    want = np.asarray(ref_importer.load_model(str(tmp_path / "model.onnx"))({"X": x})["Y"])
    assert_f32(out, want)
    with pytest.raises(ValueError, match="external"):
        OnnxFunction(model, device="cpu")
    port, ref = run_both(model, {"X": x}, external_data_dir=str(tmp_path))
    assert_outputs(port, ref)


def test_external_data_path_traversal_rejected(tmp_path):
    from synapseml_tpu_torch.onnx.importer import load_model

    sub = tmp_path / "model"
    sub.mkdir()
    (tmp_path / "secret.bin").write_bytes(np.zeros(6, np.float32).tobytes())
    (sub / "model.onnx").write_bytes(third._external_model("../secret.bin", 0, 24))
    with pytest.raises(ValueError, match="escapes"):
        load_model(str(sub / "model.onnx"), device="cpu")


def test_external_data_survives_reserialization(tmp_path):
    w = np.arange(6, dtype=np.float32).reshape(3, 2)
    (tmp_path / "w.bin").write_bytes(w.tobytes())
    rt = serialize_model(parse_model(third._external_model("w.bin", 0, w.nbytes)))
    x = np.ones((2, 3), dtype=np.float32)
    port, ref = run_both(rt, {"X": x}, external_data_dir=str(tmp_path))
    np.testing.assert_allclose(port["Y"], x @ w, rtol=1e-6)
    assert_outputs(port, ref)


def test_function_proto_expansion():
    x = np.array([[1.0, -2.0], [0.0, 4.0]], dtype=np.float32)
    port, ref = run_both(third._function_model(), {"X": x})
    np.testing.assert_allclose(port["Y"], (x * 2.0 + 0.5) * 3.0 + 0.5, rtol=1e-6)
    assert_outputs(port, ref)


def test_function_proto_unsupported_body_op_reported():
    model = bytearray(third._function_model())
    idx = bytes(model).find(b"Mul")
    model[idx:idx + 3] = b"Mux"
    with pytest.raises(NotImplementedError, match="Mux"):
        OnnxFunction(bytes(model), device="cpu")


def test_function_custom_domain_builtin_name_collision():
    fbody = third._ld(7, third._node("Mul", ["A", "A"], ["sq"]))
    fbody += third._ld(7, third._node("Add", ["sq", "B"], ["FY"]))
    func = third._ld(1, b"Add") + third._ld(10, b"com.example")
    func += third._ld(4, b"A") + third._ld(4, b"B") + third._ld(5, b"FY") + fbody
    call = third._node("Add", ["X", "X"], ["Y"]) + third._ld(7, b"com.example")
    graph = third._ld(1, call) + third._ld(2, b"coll")
    graph += third._ld(11, third._value_info("X", [2, 2]))
    graph += third._ld(12, third._value_info("Y", [2, 2]))
    model = third._vi(1, 8) + third._ld(8, third._vi(2, 13))
    model += third._ld(8, third._ld(1, b"com.example") + third._vi(2, 1))
    model += third._ld(7, graph) + third._ld(25, func)
    x = np.array([[1.0, 2.0], [3.0, -1.0]], dtype=np.float32)
    port, ref = run_both(bytes(model), {"X": x})
    np.testing.assert_allclose(port["Y"], x * x + x, rtol=1e-6)  # NOT x + x
    assert_outputs(port, ref)


# -- If, layouts ----------------------------------------------------------------------------

@pytest.mark.parametrize("cond", [True, False])
def test_if_with_constant_condition(cond):
    """``If`` with a constant condition runs one branch, whose nodes see the
    outer scope (the reference folds the choice at trace time)."""
    then_g = make_graph([node("Add", ["x", "one"], ["t"])], "then", [],
                        [value_info("t", np.float32, None)])
    else_g = make_graph([node("Mul", ["x", "two"], ["e"])], "else", [],
                        [value_info("e", np.float32, None)])
    x = np.arange(4, dtype=np.float32)
    port, ref = both([node("If", ["c"], ["y"], then_branch=then_g, else_branch=else_g)],
                     [value_info("x", np.float32, [4])], [value_info("y", np.float32, None)],
                     {"x": x}, {"c": np.array(cond), "one": np.float32(1), "two": np.float32(2)})
    np.testing.assert_allclose(port["y"], x + 1 if cond else x * 2)
    assert_outputs(port, ref)


def test_populated_layout_raises_and_placement_plan_matches_reference():
    """A populated layout that is not a SpecLayout raises (tensor-parallel
    execution itself runs in tests/test_torch_onnx_tp.py); the placement
    analysis gives the reference's decisions for the trained CNN under
    (data=4, model=2) and (data=2, fsdp=2, model=2)."""
    from synapseml_tpu.runtime.layout import SpecLayout
    from synapseml_tpu_torch.onnx.importer import placement_plan

    art = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts")
    model = open(os.path.join(art, "digits_cnn.onnx"), "rb").read()

    class _Layout:
        model_size, fsdp_size = 2, 1

    with pytest.raises(TypeError, match="SpecLayout"):
        OnnxFunction(model, layout=_Layout(), device="cpu")
    for (data, fsdp, m) in ((4, 1, 2), (2, 2, 2)):
        lay = SpecLayout.build(data=data, model=m, fsdp=fsdp) if fsdp > 1 else \
            SpecLayout.build(data=data, model=m)
        want = ref_importer.OnnxFunction(model, layout=lay).placement_report()
        got = placement_plan(model, model_size=m, fsdp_size=fsdp)
        assert [(r["tensor"], r["decision"], r["reason"], r["nbytes"]) for r in got] == \
            [(r["tensor"], r["decision"], r["reason"], r["nbytes"]) for r in want]


# -- the seven op faults of ROADMAP queue 3, held to the reference's values ----------------

def test_sign_keeps_nan_and_signed_zero():
    x = np.array([np.nan, -0.0, 0.0, 2.0, -3.0, np.inf, -np.inf], np.float32)
    port, ref = op_both("Sign", [T(x)])
    assert_exact(port, ref)
    np.testing.assert_array_equal(np.signbit(port), np.signbit(ref))
    port, ref = op_both("Sign", [T(np.array([-4, 0, 9], np.int32))])
    assert_exact(port, ref)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_gelu_exact_form_of_infinities_and_nan(dtype):
    x = np.array([np.nan, np.inf, -np.inf, 0.0, 1.0, -2.5, 30.0, -30.0], dtype)
    port, ref = op_both("Gelu", [T(x)], opset=20)
    np.testing.assert_array_equal(np.isnan(port), np.isnan(ref))
    np.testing.assert_array_equal(np.isinf(port), np.isinf(ref))
    keep = np.isfinite(ref)
    np.testing.assert_array_equal(port[~keep & ~np.isnan(ref)], ref[~keep & ~np.isnan(ref)])
    assert_f32(port[keep], ref[keep], tol=1e-3 if dtype == np.float16 else 1e-6)
    assert port[1] == np.inf and np.isnan(port[2])


@pytest.mark.parametrize("form", ["sizes", "scales"])
def test_resize_shorter_than_rank_raises_as_the_reference(form):
    x = T(np.ones((1, 1, 2, 2), np.float32))
    inputs = ([x, None, None, np.array([4, 4], np.int64)] if form == "sizes"
              else [x, None, np.array([2.0, 2.0], np.float32)])
    for registry in (OPS, REF_OPS):
        with pytest.raises(ValueError):
            vals = [jnp.asarray(v.a) if (registry is REF_OPS and isinstance(v, T)) else
                    torch.from_numpy(v.a) if isinstance(v, T) else v for v in inputs]
            registry["Resize"](vals, {"mode": "nearest"}, {"op_type": "Resize", "opset": 18})


_CAST_CASES = {
    "int32": (6, [1e10, -1e10, np.nan, np.inf, -np.inf, 3e9, -2.7, 2147483520.0]),
    "uint8": (2, [-1.7, 300.0, np.nan, 254.9, -np.inf, 0.99]),
    "int8": (3, [-1.7, 300.0, np.nan, -200.0, 127.9, -128.9]),
    "uint16": (4, [-1.7, 3e5, np.nan, 65535.5, np.inf]),
    "int16": (5, [-1.7, 3e5, np.nan, -4e4, 32767.9]),
}


@pytest.mark.parametrize("target", sorted(_CAST_CASES))
@pytest.mark.parametrize("src", [np.float32, np.float64, np.float16])
def test_cast_saturates_and_sends_nan_to_zero(target, src):
    to, vals = _CAST_CASES[target]
    x = np.array(vals, np.float64).astype(src)
    port, ref = op_both("Cast", [T(x)], {"to": to})
    assert_exact(port, ref)


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.int8, np.uint8])
def test_integer_mod_by_zero_gives_zero(dtype):
    lo = 0 if dtype == np.uint8 else -7
    a = np.array([5, lo, 7, lo, 0, 9], dtype)
    b = np.array([0, 0, 3, 3, 0, 4], dtype)
    port, ref = op_both("Mod", [T(a), T(b)])
    assert_exact(port, ref)


@pytest.mark.parametrize("axis", [-1, 0])
def test_onehot_compares_float_indices_as_they_are(axis):
    idx = np.array([1.7, -1.2, 2.5, 1.0, -1.0, 0.0, 3.0, -3.0], np.float32)
    port, ref = op_both("OneHot", [T(idx), np.array(3), np.array([-2.0, 5.0], np.float32)],
                        {"axis": axis})
    assert_exact(port, ref)
    # 1.7, -1.2 and 2.5 set no column (the spec would truncate them)
    assert (port.reshape(-1) == 5.0).sum() == 4


_CONV3D = {"plain": dict(strides=(1, 1, 1), pads=((0, 0), (0, 0), (0, 0)), dilations=(1, 1, 1)),
           "padded": dict(strides=(1, 1, 1), pads=((1, 1), (1, 1), (1, 1)), dilations=(1, 1, 1)),
           "strided": dict(strides=(2, 1, 2), pads=((1, 2), (0, 1), (1, 0)), dilations=(1, 1, 1)),
           "dilated": dict(strides=(1, 2, 1), pads=((2, 0), (1, 1), (0, 0)), dilations=(2, 1, 2))}


@pytest.mark.parametrize("case", sorted(_CONV3D))
@pytest.mark.parametrize("requant", [False, True])
def test_qconv_3d_by_depth_taps_equals_plain(case, requant):
    """Kernel Q's 3-D route (a 2-D conv a depth tap, depth padded with the x
    zero point, sums added, requantized after), run here over the 2-D plain
    version, equals the 3-D plain version bit for bit."""
    from synapseml_tpu_torch.onnx import qgemm

    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.integers(0, 256, (2, 6, 5, 7, 6)).astype(np.uint8))
    w = torch.from_numpy(rng.integers(-128, 128, (8, 3, 3, 2, 3)).astype(np.int8))
    x_zp = torch.tensor(131, dtype=torch.uint8)
    w_zp = torch.from_numpy(rng.integers(-3, 4, 8).astype(np.int8))
    rq = None
    if requant:
        rq = qgemm.Requant(torch.from_numpy(rng.uniform(1e-4, 1e-3, 8).astype(np.float32)),
                           torch.tensor(7, dtype=torch.uint8),
                           torch.from_numpy(rng.integers(-500, 500, 8).astype(np.int32)))
    geo = _CONV3D[case]
    want = qgemm.qconv_plain(x, w, x_zp, w_zp, geo["strides"], geo["pads"], geo["dilations"],
                             2, rq)
    got = qgemm._qconv3d(x, w, x_zp, w_zp, geo["strides"], geo["pads"], geo["dilations"], 2,
                         rq, None)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_conv_integer_3d_matches_the_reference():
    rng = np.random.default_rng(32)
    x = rng.integers(0, 256, (1, 4, 5, 6, 6)).astype(np.uint8)
    w = rng.integers(0, 256, (6, 4, 2, 3, 3)).astype(np.uint8)
    port, ref = op_both("ConvInteger", [T(x), w, np.uint8(120), np.uint8(128)],
                        {"pads": [1, 1, 0, 1, 1, 0], "strides": [1, 2, 1]})
    assert_exact(port, ref)
