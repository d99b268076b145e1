"""The port's model repository and ``ImageFeaturizer`` against the JAX
package's, on the CPU.

- the downloader: the zoo's bytes and schemas equal the reference zoo's (the
  same sha256), the cache layout, a corrupt cache refused by its hash, and
  ``RemoteRepository`` over a loopback HTTP server (hash refusal, no retry
  on a 404);
- ``ImageFeaturizer`` over ResNet18 at a small input, headless and logits,
  f32 and bf16, against the reference's: within ``torch_onnx``'s F32_TOL of
  each output's max-abs (f32) and BF16_TOL of a row's norm (bf16), the
  tolerances of the executor the two run (ROADMAP queue 3); the
  preprocessing itself (resize, BGR -> RGB, scale, normalize) equals the
  reference's numpy within ``test_torch_image.ATOL`` scaled to [0, 1].
"""

import hashlib
import json
import os
import threading
from functools import partial
from http.server import SimpleHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from synapseml_tpu.core import Table as RefTable
from synapseml_tpu.dl import ImageFeaturizer as RefFeaturizer
from synapseml_tpu.dl import ModelDownloader as RefDownloader
from synapseml_tpu.models.zoo import build_model_bytes as ref_model_bytes
from synapseml_tpu_torch.core import Table, load_stage
from synapseml_tpu_torch.dl import (ImageFeaturizer, LocalRepository, ModelDownloader,
                                    ModelSchema, RemoteRepository, ZooRepository)
from synapseml_tpu_torch.io.http import HTTPRequestData, send_with_retries
from synapseml_tpu_torch.models.zoo import build_model_bytes
from torch_onnx import assert_bf16, assert_f32
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_zoo_repository_lists_the_references_schemas_and_bytes():
    port = list(ZooRepository().list_schemas())
    ref = RefDownloader("/nonexistent").remote_models()
    assert [s.to_json() for s in port] == [s.to_json() for s in ref]
    assert ZooRepository().read_bytes(ZooRepository().get_schema("BERTTiny")) == \
        ref_model_bytes("BERTTiny")
    with pytest.raises(KeyError, match="not found"):
        ZooRepository().get_schema("AlexNet")


def test_downloader_cache_layout_and_hash_refusal(tmp_path):
    dl = ModelDownloader(str(tmp_path / "models"))
    schema = dl.download_by_name("BERTTiny")
    ref_schema = RefDownloader(str(tmp_path / "ref")).download_by_name("BERTTiny")
    assert schema.sha256 == ref_schema.sha256 and schema.size == ref_schema.size
    assert sorted(os.listdir(tmp_path / "models")) == ["BERTTiny.json", "BERTTiny.onnx"]
    assert dl.download_by_name("BERTTiny").sha256 == schema.sha256   # from the cache
    assert [s.name for s in dl.local_models()] == ["BERTTiny"]
    assert dl.read_bytes("BERTTiny") == ref_model_bytes("BERTTiny")
    # the reference's cache serves the port, and the other way round
    assert ModelDownloader(str(tmp_path / "ref")).read_bytes("BERTTiny") == \
        dl.local.read_bytes(schema)
    p = os.path.join(dl.local.base_dir, schema.path)
    with open(p, "r+b") as f:
        f.write(b"corrupt!")
    with pytest.raises(IOError, match="hash mismatch"):
        dl.local.read_bytes(schema)
    # a corrupt cache is fetched again
    again = dl.download_by_name("BERTTiny")
    assert dl.local.read_bytes(again) == ref_model_bytes("BERTTiny")
    assert ModelSchema.from_json(again.to_json()) == again


def test_local_repository_roundtrip(tmp_path):
    repo = LocalRepository(str(tmp_path / "r"))
    assert list(repo.list_schemas()) == []
    s = repo.add(ModelSchema(name="M", input_name="x"), b"payload")
    assert s.sha256 == hashlib.sha256(b"payload").hexdigest() and s.size == 7
    assert repo.read_bytes(repo.get_schema("M")) == b"payload"


class _Server:
    """A static file server on 127.0.0.1 over ``directory``."""

    def __init__(self, directory):
        self.httpd = ThreadingHTTPServer(
            ("127.0.0.1", 0), partial(SimpleHTTPRequestHandler, directory=str(directory)))
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()
        self.base = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def test_remote_repository_over_loopback(tmp_path):
    repo_dir = tmp_path / "repo"
    repo_dir.mkdir()
    payload = build_model_bytes("BERTTiny")
    (repo_dir / "berttiny.onnx").write_bytes(payload)
    good = {"name": "BERTTiny", "path": "berttiny.onnx",
            "sha256": hashlib.sha256(payload).hexdigest(), "size": len(payload),
            "input_name": "input_ids"}
    bad = dict(good, name="Corrupt", sha256="0" * 64)
    (repo_dir / "index.json").write_text(json.dumps([good, bad]))
    server = _Server(repo_dir)
    try:
        remote = RemoteRepository(server.base, backoffs_ms=())
        assert [s.name for s in remote.list_schemas()] == ["BERTTiny", "Corrupt"]
        dl = ModelDownloader(str(tmp_path / "cache"), remote=remote)
        schema = dl.download_by_name("BERTTiny")
        assert dl.local.read_bytes(schema) == payload
        with pytest.raises(IOError, match="hash mismatch"):
            remote.read_bytes(remote.get_schema("Corrupt"))
        with pytest.raises(IOError, match="404"):
            remote.read_bytes(ModelSchema(name="Gone", path="gone.onnx"))
        server.close()
        server = None
        assert dl.local.read_bytes(dl.download_by_name("BERTTiny")) == payload  # cached
    finally:
        if server is not None:
            server.close()


def test_send_with_retries_retries_only_transient_statuses(tmp_path, monkeypatch):
    from synapseml_tpu_torch.io import http

    calls = []

    def fake(req, timeout):
        calls.append(req.url)
        return http.HTTPResponseData(status_code=503 if len(calls) < 3 else 200)

    monkeypatch.setattr(http, "send_request", fake)
    monkeypatch.setattr(http.time, "sleep", lambda s: None)
    assert send_with_retries(HTTPRequestData(url="u"), backoffs_ms=(1, 1, 1)).status_code == 200
    assert len(calls) == 3
    calls.clear()
    monkeypatch.setattr(http, "send_request",
                        lambda req, timeout: calls.append(1) or
                        http.HTTPResponseData(status_code=404))
    assert send_with_retries(HTTPRequestData(url="u"), backoffs_ms=(1, 1)).status_code == 404
    assert len(calls) == 1


def test_connection_error_is_status_zero():
    server = _Server(".")
    base = server.base
    server.close()
    resp = send_with_retries(HTTPRequestData(url=base + "/x"), timeout=2, backoffs_ms=())
    assert resp.status_code == 0 and "connection error" in resp.reason


_IMGS = np.random.default_rng(6).integers(0, 255, size=(3, 40, 36, 3)).astype(np.uint8)
_RAGGED = np.empty(2, dtype=object)
_RAGGED[:] = [_IMGS[0], _IMGS[1, :31, :29]]


@pytest.mark.parametrize("cut", [1, 0])
@pytest.mark.parametrize("policy", ["float32", "bfloat16"])
def test_image_featurizer_matches_reference(cut, policy):
    mb = build_model_bytes("ResNet18", num_classes=7)
    kw = dict(image_height=48, image_width=48, batch_size=2, cut_output_layers=cut,
              dtype_policy=policy)
    ref = RefFeaturizer(model_bytes=mb, **kw).transform(
        RefTable({"image": _IMGS, "label": np.arange(3)}))
    port = ImageFeaturizer(model_bytes=mb, device="cpu", **kw).transform(
        Table({"image": _IMGS, "label": np.arange(3)}))
    assert port.column_names == ref.column_names
    assert port["features"].shape == (3, 512 if cut else 7)
    check = assert_f32 if policy == "float32" else assert_bf16
    check(port["features"], np.asarray(ref["features"]))


def test_image_featurizer_ragged_rgb_and_save_load(tmp_path):
    mb = build_model_bytes("ResNet18", num_classes=5)
    kw = dict(image_height=32, image_width=32, channel_order="rgb", scale=1.0 / 128,
              mean=[0.5, 0.4, 0.3], std=[0.2, 0.3, 0.4])
    ref = RefFeaturizer(model_bytes=mb, **kw).transform(RefTable({"image": _RAGGED}))
    stage = ImageFeaturizer(model_bytes=mb, device="cpu", **kw)
    port = stage.transform(Table({"image": _RAGGED}))
    assert_f32(port["features"], np.asarray(ref["features"]))
    stage.save(str(tmp_path / "f"))
    loaded = load_stage(str(tmp_path / "f"))
    assert loaded.model_bytes == mb                   # the ONNX bytes carried across
    np.testing.assert_array_equal(loaded.transform(Table({"image": _RAGGED}))["features"],
                                  port["features"])


def test_image_featurizer_preprocessing_is_the_references():
    from synapseml_tpu.image.stages import ResizeImageTransformer as RefResize

    stage = ImageFeaturizer(device="cpu", image_height=20, image_width=24)
    got = stage.preprocess(_IMGS).numpy()
    r = RefResize(height=20, width=24, output_col="r").transform(RefTable({"image": _IMGS}))
    x = np.asarray(r["r"], np.float32)[..., ::-1] * stage.scale
    x = (x - np.asarray(stage.mean, np.float32)) / np.asarray(stage.std, np.float32)
    np.testing.assert_allclose(got, np.transpose(x, (0, 3, 1, 2)), rtol=0, atol=2e-4 / 255 / 0.2)


def test_image_featurizer_through_the_zoo_downloader(tmp_path):
    stage = ImageFeaturizer(model_name="ResNet18", model_dir=str(tmp_path / "cache"),
                            image_height=32, image_width=32, device="cpu")
    out = stage.transform(Table({"image": _IMGS[:2]}))
    assert out["features"].shape == (2, 512) and np.isfinite(out["features"]).all()
    assert sorted(os.listdir(tmp_path / "cache")) == ["ResNet18.json", "ResNet18.onnx"]
