"""Whole models through the port's ONNX executor, against the JAX package's
and against real-weights goldens, on the CPU.

- ``tests/artifacts/digits_cnn.onnx`` (a CNN trained on sklearn's digits):
  the golden argmax exactly and the accuracy of ``tests/test_onnx_real_model.py``,
  through ``OnnxFunction`` and the ``ONNXModel`` stage, batch-invariant;
- the zoo's ResNet-18 and ResNet-50 at 64x64, batch 2, BERTTiny and a 2-layer
  ViT at 32x32, under both dtype policies, within the f32 / bf16 tolerances
  (``tests/torch_onnx.py``);
- the opt-in channels-last run, and ``ONNXModel`` over a zoo model: save /
  load and the empty table.
"""

import os

import numpy as np
import pytest

from synapseml_tpu_torch.core import Table, load_stage
from synapseml_tpu_torch.models import build_model_bytes
from synapseml_tpu_torch.models.zoo import vit
from synapseml_tpu_torch.onnx import ONNXModel, OnnxFunction
from synapseml_tpu_torch.onnx.wire import serialize_model
from torch_onnx import assert_bf16, assert_f32, assert_outputs, run_both
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

_ART = os.path.join(os.path.dirname(os.path.abspath(__file__)), "artifacts")


@pytest.fixture(scope="module")
def digits():
    model = open(os.path.join(_ART, "digits_cnn.onnx"), "rb").read()
    return model, np.load(os.path.join(_ART, "digits_cnn_golden.npz"))


def test_digits_cnn_golden_argmax_and_accuracy(digits):
    model, g = digits
    out = OnnxFunction(model, device="cpu")({"image": g["x"]})["logits"].numpy()
    np.testing.assert_array_equal(out.argmax(1), g["logits"].argmax(1))
    np.testing.assert_allclose(out, g["logits"], rtol=1e-3, atol=1e-3)
    assert (out.argmax(1) == g["labels"]).mean() >= 0.95
    port, ref = run_both(model, {"image": g["x"]})
    assert_outputs(port, ref)


def test_digits_cnn_through_onnx_stage(digits):
    model, g = digits
    stage = ONNXModel(model_bytes=model, feed_dict={"image": "features"},
                      fetch_dict={"logits": "logits"}, argmax_dict={"logits": "prediction"},
                      batch_size=24, device="cpu")
    out = stage.transform(Table({"features": list(g["x"])}))
    np.testing.assert_array_equal(np.asarray(out["prediction"], np.int64),
                                  g["logits"].argmax(1))


def test_digits_cnn_batch_invariance(digits):
    model, g = digits
    fn = OnnxFunction(model, device="cpu")
    full = fn({"image": g["x"][:8]})["logits"].numpy()
    singles = np.concatenate([fn({"image": g["x"][i:i + 1]})["logits"].numpy()
                              for i in range(8)])
    np.testing.assert_allclose(singles, full, rtol=1e-5, atol=1e-5)


_IMAGES = np.random.default_rng(4).normal(size=(2, 3, 64, 64)).astype(np.float32)


@pytest.mark.parametrize("name", ["ResNet18", "ResNet50"])
@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_zoo_resnet_matches_reference(name, policy):
    mb = build_model_bytes(name, num_classes=10)
    port, ref = run_both(mb, {"data": _IMAGES}, dtype_policy=policy)
    assert port["logits"].shape == (2, 10)
    assert port["features"].shape == (2, 512 if name == "ResNet18" else 2048)
    assert_outputs(port, ref, check=assert_f32 if policy == "float32" else assert_bf16)


@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_zoo_bert_tiny_matches_reference(policy):
    mb = build_model_bytes("BERTTiny", num_classes=3)
    ids = np.random.default_rng(5).integers(0, 1000, size=(2, 16)).astype(np.int64)
    port, ref = run_both(mb, {"input_ids": ids}, dtype_policy=policy)
    assert port["logits"].shape == (2, 3) and port["sequence"].shape == (2, 16, 128)
    assert_outputs(port, ref, check=assert_f32 if policy == "float32" else assert_bf16)


def test_zoo_vit_two_layers_matches_reference():
    mb = serialize_model(vit(patch=8, image_size=32, layers=2, hidden=64, heads=4,
                             num_classes=10))
    x = np.random.default_rng(6).normal(size=(2, 3, 32, 32)).astype(np.float32)
    port, ref = run_both(mb, {"data": x})
    assert port["logits"].shape == (2, 10) and port["features"].shape == (2, 64)
    assert_outputs(port, ref)


def test_channels_last_matches_nchw_and_reference():
    """The opt-in channels-last run (torch's memory format) equals the default
    NCHW run, and the reference's NHWC pass."""
    mb = build_model_bytes("ResNet18", num_classes=10)
    nchw = OnnxFunction(mb, device="cpu")({"data": _IMAGES})
    port, ref = run_both(mb, {"data": _IMAGES}, channels_last=True)
    for k in ("logits", "features"):
        np.testing.assert_allclose(port[k], nchw[k].numpy(), rtol=2e-4, atol=2e-4)
    assert_outputs(port, ref)


def test_onnx_model_zoo_save_load_and_empty_table(tmp_path):
    mb = build_model_bytes("ResNet18", num_classes=10)
    stage = ONNXModel(model_bytes=mb, feed_dict={"data": "image"},
                      fetch_dict={"features": "features"}, softmax_dict={},
                      batch_size=2, device="cpu")
    t = Table({"image": list(_IMAGES[:, :, :32, :32]) + [_IMAGES[0, :, :32, :32]]})
    out = stage.transform(t)
    assert out["features"].shape == (3, 512)
    path = str(tmp_path / "resnet_stage")
    stage.save(path)
    back = load_stage(path)
    np.testing.assert_array_equal(back.transform(t)["features"], out["features"])
    empty = back.transform(Table({"image": np.zeros((0, 3, 32, 32), np.float32)}))
    assert empty["features"].shape == (0, 512)
