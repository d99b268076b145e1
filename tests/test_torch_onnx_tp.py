"""The port's tensor-parallel and fsdp ONNX serving on the CPU, over gloo
worlds (``tests/torch_mesh.py``), held to the JAX package's.

Carried over: the six tests of ``tests/test_onnx.py:649-792`` and
``tests/test_onnx_real_model.py:72`` / ``:91``. Every rank of a world
builds the port's ``OnnxFunction`` (or ``ONNXModel(sharding_layout=)``)
over a ``SpecLayout`` of the reference test's shape, (data=2, model=4) and
(4, 2) on 8 ranks, (1, fsdp=2, 2) on 4, (1, fsdp=2, 1) on 2, (1, 1) on one,
and runs the same feeds:
- its ``_const_specs`` equal the reference's ``PartitionSpec`` entry for
  entry, and its ``placement_report()`` the reference's;
- each rank holds exactly 1/(fsdp x model) of an fsdp-stored weight;
- its outputs match the reference's single-device run at rtol 1e-5 / atol
  1e-6 (f32), 2e-2 (the bf16 policy), and the (1, 1) layout the port's own
  single-device run bit for bit;
- the trained CNN (``tests/artifacts/digits_cnn.onnx``, its Conv kernels
  sharded over output channels) gives the golden classes, with logits
  within the reference test's 1e-4.
"""

import os

import numpy as np
import pytest

from synapseml_tpu.onnx.importer import OnnxFunction as RefFunction
from synapseml_tpu.runtime.layout import SpecLayout as RefLayout

from synapseml_tpu_torch.onnx import (OnnxFunction, make_graph, make_model, node,
                                      serialize_model, value_info)
from tests.torch_mesh import MeshWorld
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

_ART = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts")


class _Worlds:
    """One gloo world at a time, of the size a test asks for (the tests
    run grouped by size, so each size is spawned once)."""

    def __init__(self):
        self.world = None

    def __call__(self, size: int) -> MeshWorld:
        if self.world is None or self.world.size != size:
            self.close()
            self.world = MeshWorld(size)
        return self.world

    def close(self):
        if self.world is not None:
            self.world.close()
            self.world = None


@pytest.fixture(scope="module")
def worlds():
    w = _Worlds()
    yield w
    w.close()


def _tp_mlp_bytes(rng, d=32, h=64, out=8):
    w1 = (rng.normal(size=(d, h)) / np.sqrt(d)).astype(np.float32)
    b1 = rng.normal(size=(h,)).astype(np.float32)
    w2 = (rng.normal(size=(h, out)) / np.sqrt(h)).astype(np.float32)
    g = make_graph([node("MatMul", ["x", "w1"], ["h0"]), node("Add", ["h0", "b1"], ["h1"]),
                    node("Relu", ["h1"], ["h2"]), node("MatMul", ["h2", "w2"], ["y"])],
                   "tp_mlp", [value_info("x", np.float32, [None, d])],
                   [value_info("y", np.float32, [None, out])],
                   {"w1": w1, "b1": b1, "w2": w2})
    return serialize_model(make_model(g))


def _same_specs(port: dict, ref: dict):
    assert set(port) == set(ref)
    for name, spec in ref.items():
        assert port[name] == tuple(spec), (name, port[name], spec)


def _same_report(port, ref):
    key = lambda r: (r["tensor"], tuple(r["shape"]), r["nbytes"], r["decision"], r["reason"])
    assert [key(r) for r in port] == [key(r) for r in ref]


def _ref_tp(mb, shape, **kw):
    lay = RefLayout.build(data=shape[0], fsdp=shape[1], model=shape[2]) if len(shape) == 3 \
        else RefLayout.build(data=shape[0], model=shape[1])
    return RefFunction(mb, layout=lay, **kw)


# -- 8 ranks ---------------------------------------------------------------------------------

def test_tp_sharded_matmul_weights_match_single_device(worlds):
    rng = np.random.default_rng(7)
    mb = _tp_mlp_bytes(rng)
    x = rng.normal(size=(16, 32)).astype(np.float32)
    ref = np.asarray(RefFunction(mb)({"x": x})["y"])
    res = worlds(8).run("onnx", layout=("build", 2, 4), model=mb, feeds={"x": x})
    ref_tp = _ref_tp(mb, (2, 4))
    for r in res:
        _same_specs(r["specs"], ref_tp._const_specs)
        assert r["specs"]["w1"] == (None, "model")
        _same_report(r["report"], ref_tp.placement_report())
        np.testing.assert_allclose(r["outputs"]["y"], ref, rtol=1e-5, atol=1e-6)
        assert r["held_bytes"]["w1"] == 32 * 64 * 4 // 4
        assert r["collectives"] == {"gather:model": 2}


def test_tp_sharding_respects_gemm_transb_and_indivisible_dims(worlds):
    rng = np.random.default_rng(9)
    wt = (rng.normal(size=(6, 16)) / 4).astype(np.float32)   # (N=6, K=16)
    bias = np.zeros(6, np.float32)
    w_odd = rng.normal(size=(16, 5)).astype(np.float32)     # 5 columns: replicated
    g = make_graph([node("Gemm", ["x", "wt", "bias"], ["h"], transB=1),
                    node("MatMul", ["x", "w_odd"], ["z"])], "gemm_tp",
                   [value_info("x", np.float32, [None, 16])],
                   [value_info("h", np.float32, [None, 6]), value_info("z", np.float32, [None, 5])],
                   {"wt": wt, "bias": bias, "w_odd": w_odd})
    mb = serialize_model(make_model(g))
    x = rng.normal(size=(8, 16)).astype(np.float32)
    ref = RefFunction(mb)({"x": x})
    res = worlds(8).run("onnx", layout=("build", 4, 2), model=mb, feeds={"x": x})
    for r in res:
        _same_specs(r["specs"], _ref_tp(mb, (4, 2))._const_specs)
        assert r["specs"] == {"wt": ("model", None)}
        for k in ("h", "z"):
            np.testing.assert_allclose(r["outputs"][k], np.asarray(ref[k]), rtol=1e-5,
                                       atol=1e-6)


def test_tp_sharding_bf16_policy(worlds):
    rng = np.random.default_rng(10)
    mb = _tp_mlp_bytes(rng)
    x = rng.normal(size=(8, 32)).astype(np.float32)
    ref = np.asarray(RefFunction(mb, dtype_policy="bfloat16")({"x": x})["y"])
    res = worlds(8).run("onnx", layout=("build", 2, 4), model=mb, feeds={"x": x},
                        dtype_policy="bfloat16")
    for r in res:
        np.testing.assert_allclose(r["outputs"]["y"], ref, rtol=2e-2, atol=2e-2)
        # cast to bf16 before the slice: the block is bf16, 1/4 of the bf16 bytes
        assert r["held_bytes"]["w1"] == 32 * 64 * 2 // 4


@pytest.fixture(scope="module")
def artifact():
    model = open(os.path.join(_ART, "digits_cnn.onnx"), "rb").read()
    golden = np.load(os.path.join(_ART, "digits_cnn_golden.npz"))
    return model, golden


def test_real_model_tensor_parallel_parity(worlds, artifact):
    model, g = artifact
    ref = np.asarray(RefFunction(model)({"image": g["x"]})["logits"])
    ref_tp = _ref_tp(model, (4, 2))
    res = worlds(8).run("onnx", layout=("build", 4, 2), model=model, feeds={"image": g["x"]})
    for r in res:
        assert len(r["specs"]) >= 2, r["specs"]
        assert any(len(s) == 4 and s[0] == "model" for s in r["specs"].values())  # a Conv
        _same_specs(r["specs"], ref_tp._const_specs)
        _same_report(r["report"], ref_tp.placement_report())
        out = r["outputs"]["logits"]
        np.testing.assert_array_equal(out.argmax(1), g["logits"].argmax(1))
        np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_real_model_tp_through_onnx_stage(worlds, artifact):
    model, g = artifact
    stage = {"feed_dict": {"image": "features"}, "fetch_dict": {"logits": "logits"},
             "argmax_dict": {"logits": "prediction"}}
    res = worlds(8).run("onnx", layout=("build", None, 2), model=model, feeds=list(g["x"]),
                        stage=stage)
    for r in res:
        np.testing.assert_array_equal(np.asarray(r["prediction"], np.int64),
                                      g["logits"].argmax(1))


# -- 4 ranks: (data=1, fsdp=2, model=2) ---------------------------------------------------------

def test_fsdp_planner_stores_weights_and_matches_reference(worlds):
    rng = np.random.default_rng(21)
    mb = _tp_mlp_bytes(rng)
    x = rng.normal(size=(16, 32)).astype(np.float32)
    ref = np.asarray(RefFunction(mb)({"x": x})["y"])
    ref_tp = _ref_tp(mb, (1, 2, 2))
    res = worlds(4).run("onnx", layout=("fsdp", 1, 2, 2), model=mb, feeds={"x": x})
    for r in res:
        _same_specs(r["specs"], ref_tp._const_specs)
        assert r["specs"]["w1"] == ("fsdp", "model") and r["specs"]["w2"] == ("fsdp", "model")
        by_name = {row["tensor"]: row for row in r["report"]}
        assert by_name["w1"]["decision"] == "fsdp" and "all-gather" in by_name["w1"]["reason"]
        assert by_name["b1"]["decision"] == "replicated"
        _same_report(r["report"], ref_tp.placement_report())
        # at rest each rank holds exactly 1 / (fsdp * model) of the weight
        assert r["held_bytes"]["w1"] == 32 * 64 * 4 // 4
        np.testing.assert_allclose(r["outputs"]["y"], ref, rtol=1e-5, atol=1e-6)
        assert r["collectives"] == {"gather:fsdp": 2, "gather:model": 2}


# -- 2 ranks: (data=1, fsdp=2, model=1) ---------------------------------------------------------

def test_fsdp_only_layout_stores_without_model_axis(worlds):
    rng = np.random.default_rng(22)
    mb = _tp_mlp_bytes(rng)
    x = rng.normal(size=(8, 32)).astype(np.float32)
    ref = np.asarray(RefFunction(mb)({"x": x})["y"])
    ref_tp = _ref_tp(mb, (1, 2, 1))
    res = worlds(2).run("onnx", layout=("fsdp", 1, 2, 1), model=mb, feeds={"x": x})
    for r in res:
        _same_specs(r["specs"], ref_tp._const_specs)
        assert r["specs"]["w1"] == ("fsdp", None)
        assert {row["tensor"] for row in r["report"] if row["decision"] == "fsdp"} == \
            {"w1", "w2"}
        assert r["held_bytes"]["w1"] == 32 * 64 * 4 // 2
        np.testing.assert_allclose(r["outputs"]["y"], ref, rtol=1e-5, atol=1e-6)
        assert r["collectives"] == {"gather:fsdp": 2}


def test_tp_grouped_convs_shard_by_group(worlds):
    """Output channels over model=2 for grouped convolutions: a rank's
    channels cover whole groups (group 2: the rank convolves its groups'
    input channels, its bias cut to them), or straddle them (group 3: the
    kernel is gathered whole)."""
    rng = np.random.default_rng(23)
    w1 = rng.normal(size=(4, 3, 3, 3)).astype(np.float32)
    b1 = rng.normal(size=(4,)).astype(np.float32)
    w2 = rng.normal(size=(6, 2, 3, 3)).astype(np.float32)
    g = make_graph([node("Conv", ["x", "w1", "b1"], ["y1"], group=2, pads=[1, 1, 1, 1]),
                    node("Conv", ["x", "w2"], ["y2"], group=3)], "grouped",
                   [value_info("x", np.float32, [None, 6, 5, 5])],
                   [value_info("y1", np.float32, None), value_info("y2", np.float32, None)],
                   {"w1": w1, "b1": b1, "w2": w2})
    mb = serialize_model(make_model(g))
    x = rng.normal(size=(2, 6, 5, 5)).astype(np.float32)
    ref = RefFunction(mb)({"x": x})
    res = worlds(2).run("onnx", layout=("build", 1, 2), model=mb, feeds={"x": x})
    for r in res:
        _same_specs(r["specs"], _ref_tp(mb, (1, 2))._const_specs)
        assert r["specs"] == {"w1": ("model", None, None, None),
                              "w2": ("model", None, None, None)}
        for k in ("y1", "y2"):
            np.testing.assert_allclose(r["outputs"][k], np.asarray(ref[k]), rtol=1e-5,
                                       atol=1e-5)
        # y1's output columns, w2's whole kernel
        assert r["collectives"] == {"gather:model": 2}


# -- 1 rank: (1, 1) ---------------------------------------------------------------------------

def test_tp_sharding_degrades_to_single_chip(worlds):
    rng = np.random.default_rng(8)
    mb = _tp_mlp_bytes(rng)
    x = rng.normal(size=(4, 32)).astype(np.float32)
    single = OnnxFunction(mb, device="cpu")({"x": x})["y"].numpy()
    res = worlds(1).run("onnx", layout=("build", 1, 1), model=mb, feeds={"x": x})
    assert res[0]["specs"] == {} and res[0]["report"] == []
    np.testing.assert_array_equal(res[0]["outputs"]["y"], single)
    np.testing.assert_allclose(single, np.asarray(RefFunction(mb)({"x": x})["y"]), rtol=1e-5,
                               atol=1e-6)
