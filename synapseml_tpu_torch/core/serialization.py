"""Stage / pipeline persistence for port stages.

The port's counterpart of the JAX package's ``core/serialization.py``, with
the same on-disk layout: a stage saves to a directory holding
``metadata.json`` (class name, module, uid, simple params) plus one entry per
set complex param — nested stages recurse, arrays and tensors become ``.npy``
(tensors are stored as numpy, whatever device they were on), and objects
exposing ``state_dict()`` / ``from_state_dict()`` get a typed JSON + npz pair.
Classes resolve through the port's OWN registries, never the reference's.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict

import numpy as np

from .params import Params
from .params import _json_default as _jsonable

__all__ = ["save_stage", "load_stage", "register_state_class", "STATE_REGISTRY",
           "BUILD_VERSION"]

BUILD_VERSION = "0.1.0"

# Classes implementing state_dict()/from_state_dict(), keyed by class name.
STATE_REGISTRY: Dict[str, type] = {}


def register_state_class(cls):
    """Class decorator registering a ``state_dict``-protocol type for persistence."""
    STATE_REGISTRY[cls.__name__] = cls
    return cls


def _as_numpy(value):
    import torch

    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def _arrayish(v) -> bool:
    import torch

    return isinstance(v, (np.ndarray, torch.Tensor))


def _save_value(value, path: str) -> Dict[str, Any]:
    """Persist one complex value under ``path`` (a prefix, no extension)."""
    from .stage import PipelineStage

    if isinstance(value, PipelineStage):
        save_stage(value, path + ".stage")
        return {"kind": "stage"}
    if _arrayish(value):
        value = _as_numpy(value)
        np.save(path + ".npy", value, allow_pickle=value.dtype == object)
        return {"kind": "ndarray", "pickled": bool(value.dtype == object)}
    if isinstance(value, (list, tuple)) and value and all(
            isinstance(v, PipelineStage) for v in value):
        os.makedirs(path + ".stages", exist_ok=True)
        for i, st in enumerate(value):
            save_stage(st, os.path.join(path + ".stages", f"{i:04d}"))
        return {"kind": "stages", "n": len(value), "tuple": isinstance(value, tuple)}
    if type(value).__name__ in STATE_REGISTRY and hasattr(value, "state_dict"):
        state = value.state_dict()
        arrays = {k: _as_numpy(v) for k, v in state.items() if _arrayish(v)}
        scalars = {k: v for k, v in state.items() if not _arrayish(v)}
        np.savez(path + ".state.npz", **arrays)
        with open(path + ".state.json", "w") as f:
            json.dump({"class": type(value).__name__, "scalars": scalars}, f,
                      default=_jsonable)
        return {"kind": "state"}
    try:
        with open(path + ".json", "w") as f:
            json.dump(value, f, default=_jsonable)
        return {"kind": "json"}
    except TypeError:
        raise TypeError(
            f"Cannot serialize complex param value of type {type(value).__name__} "
            f"at {path}. Implement state_dict()/from_state_dict() and "
            f"@register_state_class it.") from None


def _load_value(desc: Dict[str, Any], path: str):
    kind = desc["kind"]
    if kind == "stage":
        return load_stage(path + ".stage")
    if kind == "ndarray":
        return np.load(path + ".npy", allow_pickle=desc.get("pickled", False))
    if kind == "stages":
        out = [load_stage(os.path.join(path + ".stages", f"{i:04d}"))
               for i in range(desc["n"])]
        return tuple(out) if desc.get("tuple") else out
    if kind == "state":
        with open(path + ".state.json") as f:
            head = json.load(f)
        cls = STATE_REGISTRY[head["class"]]
        with np.load(path + ".state.npz", allow_pickle=False) as z:
            arrays = dict(z)
        return cls.from_state_dict({**head["scalars"], **arrays})
    if kind == "json":
        with open(path + ".json") as f:
            return json.load(f)
    raise ValueError(f"Unknown complex value kind {kind!r}")


def save_stage(stage: Params, path: str) -> None:
    if os.path.exists(path):
        if not os.path.isdir(path):
            raise ValueError(f"save path {path!r} exists and is not a directory")
        # only clobber directories we wrote (metadata.json) or empty ones
        if not (os.path.exists(os.path.join(path, "metadata.json"))
                or not os.listdir(path)):
            raise ValueError(f"save path {path!r} exists and does not look like "
                             "a saved stage; refusing to overwrite")
    # write to a sibling temp dir and swap in only on success
    tmp = path.rstrip("/") + ".saving.tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        complex_descs = {}
        for name, value in stage.complex_param_values().items():
            if value is None:
                complex_descs[name] = {"kind": "none"}
                continue
            complex_descs[name] = _save_value(value, os.path.join(tmp, name))
        meta = {
            "class": type(stage).__name__,
            "module": type(stage).__module__,
            "uid": stage.uid,
            "buildVersion": BUILD_VERSION,
            "params": stage.simple_param_values(),
            "complexParams": complex_descs,
        }
        with open(os.path.join(tmp, "metadata.json"), "w") as f:
            json.dump(meta, f, indent=2, sort_keys=True, default=_jsonable)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def load_stage(path: str):
    from .stage import stage_class

    with open(os.path.join(path, "metadata.json")) as f:
        meta = json.load(f)
    module = meta.get("module") or ""
    if not module.startswith("synapseml_tpu_torch"):
        raise ValueError(f"{path!r} holds a {meta['class']} saved by {module!r}, "
                         "not a synapseml_tpu_torch stage")
    try:
        cls = stage_class(meta["class"])
    except KeyError:
        import importlib

        importlib.import_module(module)  # registers the stage class
        cls = stage_class(meta["class"])
    stage = cls.__new__(cls)
    object.__setattr__(stage, "_param_values", {})
    stage.uid = meta["uid"]
    for k, v in meta["params"].items():
        param = cls.get_param(k)
        if param.dtype is tuple and isinstance(v, list):
            v = tuple(v)
        stage.set(k, v)
    for name, desc in meta["complexParams"].items():
        if desc["kind"] == "none":
            stage.set(name, None)
        else:
            stage.set(name, _load_value(desc, os.path.join(path, name)))
    return stage
