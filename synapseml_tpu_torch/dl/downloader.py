"""Model repository / downloader.

Port of ``synapseml_tpu/dl/downloader.py``: a ``Repository`` abstraction with
schema metadata and sha256 verification, a local directory repository (the
cache: ``<name>.onnx`` beside ``<name>.json``), a zoo-backed default
repository (``synapseml_tpu_torch.models.zoo``, whose bytes equal the JAX
package's zoo, so the same schema hashes verify) and an HTTP repository
(``io/http.py``: retries only transient statuses).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Iterator, List, Optional

__all__ = ["ModelSchema", "Repository", "LocalRepository", "ZooRepository",
           "RemoteRepository", "ModelDownloader"]


@dataclasses.dataclass
class ModelSchema:
    """Reference: ``Schema.scala`` (name, uri, hash, size, inputNode, numLayers...)."""

    name: str
    path: str = ""
    sha256: str = ""
    size: int = 0
    input_name: str = "data"
    feature_output: str = "features"
    logits_output: str = "logits"
    input_shape: Optional[List[int]] = None
    extra: Dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "ModelSchema":
        return ModelSchema(**json.loads(s))


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class Repository:
    """Abstract model repository (reference ``Repository[S]`` trait)."""

    def list_schemas(self) -> Iterator[ModelSchema]:  # pragma: no cover - interface
        raise NotImplementedError

    def read_bytes(self, schema: ModelSchema) -> bytes:  # pragma: no cover - interface
        raise NotImplementedError

    def get_schema(self, name: str) -> ModelSchema:
        for s in self.list_schemas():
            if s.name == name:
                return s
        raise KeyError(f"model {name!r} not found in {type(self).__name__}")


class LocalRepository(Repository):
    """Directory of ``<name>.json`` schemas + model payload files
    (reference ``LocalRepo``). Verifies sha256 on read."""

    def __init__(self, base_dir: str):
        self.base_dir = base_dir

    def list_schemas(self) -> Iterator[ModelSchema]:
        if not os.path.isdir(self.base_dir):
            return
        for fn in sorted(os.listdir(self.base_dir)):
            if fn.endswith(".json"):
                with open(os.path.join(self.base_dir, fn)) as f:
                    yield ModelSchema.from_json(f.read())

    def read_bytes(self, schema: ModelSchema) -> bytes:
        path = schema.path
        if not os.path.isabs(path):
            path = os.path.join(self.base_dir, path)
        with open(path, "rb") as f:
            data = f.read()
        if schema.sha256 and _sha256(data) != schema.sha256:
            raise IOError(
                f"hash mismatch for model {schema.name}: expected {schema.sha256[:12]}..., "
                f"got {_sha256(data)[:12]}... (corrupt download?)"
            )
        return data

    def add(self, schema: ModelSchema, data: bytes) -> ModelSchema:
        os.makedirs(self.base_dir, exist_ok=True)
        payload = f"{schema.name}.onnx"
        with open(os.path.join(self.base_dir, payload), "wb") as f:
            f.write(data)
        schema = dataclasses.replace(schema, path=payload, sha256=_sha256(data), size=len(data))
        with open(os.path.join(self.base_dir, f"{schema.name}.json"), "w") as f:
            f.write(schema.to_json())
        return schema


class ZooRepository(Repository):
    """Default 'remote' repo backed by the builder zoo (reference ``DefaultModelRepo``)."""

    _INPUT_SHAPES = {
        "ResNet18": [1, 3, 224, 224],
        "ResNet50": [1, 3, 224, 224],
        "ResNet101": [1, 3, 224, 224],
        "ViTB16": [1, 3, 224, 224],
        "BERTBase": None,
        "BERTTiny": None,
    }

    def list_schemas(self) -> Iterator[ModelSchema]:
        from ..models.zoo import MODEL_BUILDERS

        for name in sorted(MODEL_BUILDERS):
            input_name = "input_ids" if name.startswith("BERT") else "data"
            feature = "pooled" if name.startswith("BERT") else "features"
            yield ModelSchema(name=name, input_name=input_name, feature_output=feature,
                              input_shape=self._INPUT_SHAPES.get(name))

    def read_bytes(self, schema: ModelSchema) -> bytes:
        from ..models.zoo import build_model_bytes

        return build_model_bytes(schema.name)


class RemoteRepository(Repository):
    """HTTP(S) model repository with hash verification (reference
    ``ModelDownloader.scala:26-263`` — the Azure-blob default repo's
    contract over any static file host).

    Layout: ``<base_url>/index.json`` is a JSON LIST of model schemas
    (:class:`ModelSchema` dicts); each schema's ``path`` is resolved
    relative to ``base_url``. ``read_bytes`` verifies the schema's sha256
    against the fetched payload — the reference's corrupt-download guard.
    Retries ride :func:`synapseml_tpu_torch.io.http.send_with_retries`, which
    retries ONLY transient statuses (429/5xx/connection errors) — a 404
    fails fast instead of backing off toward an outcome that cannot change.
    """

    def __init__(self, base_url: str, timeout: float = 60.0,
                 backoffs_ms=(200, 400, 800)):
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.backoffs_ms = tuple(backoffs_ms)
        self._index: Optional[List[ModelSchema]] = None

    def _fetch(self, url: str) -> bytes:
        from ..io.http import HTTPRequestData, send_with_retries

        resp = send_with_retries(HTTPRequestData(url=url, method="GET"),
                                 timeout=self.timeout,
                                 backoffs_ms=self.backoffs_ms)
        if resp.status_code != 200:
            raise IOError(f"GET {url} -> {resp.status_code} {resp.reason}")
        return resp.entity or b""

    def list_schemas(self) -> Iterator[ModelSchema]:
        if self._index is None:
            raw = json.loads(self._fetch(self.base_url + "/index.json"))
            self._index = [ModelSchema(**d) for d in raw]
        return iter(self._index)

    def read_bytes(self, schema: ModelSchema) -> bytes:
        url = (schema.path if schema.path.startswith(("http://", "https://"))
               else f"{self.base_url}/{schema.path}")
        data = self._fetch(url)
        if schema.sha256 and _sha256(data) != schema.sha256:
            raise IOError(
                f"hash mismatch for model {schema.name} from {url}: expected "
                f"{schema.sha256[:12]}..., got {_sha256(data)[:12]}... "
                "(corrupt download?)")
        return data


class ModelDownloader:
    """Fetch models from a remote repo into a local one, with caching
    (reference ``ModelDownloader.downloadModel`` / ``downloadByName``)."""

    def __init__(self, local_path: str, remote: Optional[Repository] = None):
        self.local = LocalRepository(local_path)
        self.remote = remote if remote is not None else ZooRepository()

    def remote_models(self) -> List[ModelSchema]:
        return list(self.remote.list_schemas())

    def local_models(self) -> List[ModelSchema]:
        return list(self.local.list_schemas())

    def download_model(self, schema: ModelSchema, always_download: bool = False) -> ModelSchema:
        if not always_download:
            try:
                cached = self.local.get_schema(schema.name)
                self.local.read_bytes(cached)  # hash check
                return cached
            except (KeyError, IOError):
                pass
        data = self.remote.read_bytes(schema)
        return self.local.add(schema, data)

    def download_by_name(self, name: str, always_download: bool = False) -> ModelSchema:
        return self.download_model(self.remote.get_schema(name), always_download)

    def read_bytes(self, name: str) -> bytes:
        try:  # cached: single read + hash check
            return self.local.read_bytes(self.local.get_schema(name))
        except (KeyError, IOError):
            pass
        schema = self.remote.get_schema(name)
        data = self.remote.read_bytes(schema)
        self.local.add(schema, data)
        return data
