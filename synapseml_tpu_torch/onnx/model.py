"""``ONNXModel`` — generic ONNX inference transformer.

Port of ``synapseml_tpu/onnx/model.py``: feed/fetch dicts, minibatch->tensor
coercion, post-processing (softmax/argmax), over :class:`OnnxFunction` on the
card (``device``; ``"cpu"`` for the plain path).

Batching: rows are processed in fixed-size buckets (``batch_size``); the final
partial batch is padded to the bucket and the padding sliced off after — so
exactly one input-shape signature, one executor plan, serves the whole table.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..core import (ColumnSpec, ComplexParam, Param, Table, TableSchema,
                    Transformer)
from ..core.params import ParamValidators
from .importer import OnnxFunction, model_io_specs

__all__ = ["ONNXModel"]


def _pad_rows(v, pad: int):
    """``v`` with its last row repeated ``pad`` times (numpy or torch)."""
    if isinstance(v, torch.Tensor):
        return torch.cat([v, v[-1:].expand(pad, *v.shape[1:])])
    return np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])


class ONNXModel(Transformer):
    """Run an ONNX graph over table columns.

    - ``feed_dict``: onnx input name -> table column name
      (reference ``setFeedDict``, ``ONNXModel.scala:122``)
    - ``fetch_dict``: output column name -> onnx output name (``setFetchDict``)
    - ``softmax_dict`` / ``argmax_dict``: output col -> new col post-ops
      (``softMaxDict``/``argMaxDict``, ``ONNXModel.scala:516-562``)
    """

    model_bytes = ComplexParam("serialized ONNX ModelProto", bytes, default=None)
    feed_dict = Param("onnx input name -> table column", dict, default={})
    fetch_dict = Param("output column -> onnx output name", dict, default={})
    batch_size = Param("inference bucket size (pad-to-bucket)", int, default=64,
                       validator=ParamValidators.gt(0))
    dtype_policy = Param("float32 | bfloat16 (bf16 compute, f32 outputs)", str, default="float32",
                         validator=ParamValidators.in_list(["float32", "bfloat16"]))
    softmax_dict = Param("col -> softmax(col) output col", dict, default={})
    argmax_dict = Param("col -> argmax(col) output col", dict, default={})
    sharding_layout = ComplexParam(
        "optional runtime.layout.SpecLayout: with a model or fsdp axis over more than one "
        "rank, weights shard over it (tensor-parallel / fsdp serving; every rank transforms "
        "the same table)", object, default=None)
    device = Param("'cuda[:i]' (default: the GPU) or 'cpu'", str, default=None)

    def __init__(self, uid=None, **kw):
        super().__init__(uid=uid, **kw)
        self._fn: Optional[OnnxFunction] = None
        self._io_specs_cache = None

    def set_model(self, model_bytes: bytes) -> "ONNXModel":
        self.set("model_bytes", bytes(model_bytes))
        self._fn = None
        self._io_specs_cache = None
        return self

    @property
    def fn(self) -> OnnxFunction:
        # a loaded stage has no _fn yet (load_stage does not run __init__)
        if getattr(self, "_fn", None) is None:
            if self.model_bytes is None:
                raise ValueError(f"ONNXModel({self.uid}): model_bytes not set")
            self._fn = OnnxFunction(self.model_bytes,
                                    dtype_policy=self.dtype_policy,
                                    layout=self.sharding_layout, device=self.device)
        return self._fn

    # -- static schema (derived from the graph's value_info) ------------------------

    def _io_specs(self):
        """Graph input/output specs via :func:`model_io_specs` — protobuf
        parsing only (``Pipeline.validate`` runs nothing), cached:
        real models carry hundreds of MB of initializers and must not be
        re-parsed per validate() call. The cache is keyed on the current
        ``model_bytes`` OBJECT, so replacing the model through the generic
        ``Params.set`` path (not just :meth:`set_model`) invalidates it."""
        mb = self.model_bytes
        if mb is None:
            raise ValueError(f"ONNXModel({self.uid}): model_bytes not set")
        cache = getattr(self, "_io_specs_cache", None)
        if cache is None or cache[0] is not mb:
            self._io_specs_cache = cache = (mb, model_io_specs(mb))
        return cache[1]

    def _input_schema_from(self, ins) -> TableSchema:
        cols = {}
        for onnx_in, col in self.feed_dict.items():
            dc, role = ins.get(onnx_in, ("any", "any"))
            # a rank-k graph tensor feeds from a per-row rank-(k-1) column,
            # which may also arrive as an object column of arrays — keep
            # the dtype class, relax the role (stacking is _gather_feed's
            # job, the static contract is "this column exists & is dc")
            cols[col] = ColumnSpec(dc, "any" if role == "tensor" else role)
        return TableSchema(cols)

    def input_schema(self) -> "TableSchema | None":
        if not self.feed_dict or self.model_bytes is None:
            return None
        return self._input_schema_from(self._io_specs()[0])

    def transform_schema(self, schema: TableSchema) -> "TableSchema | None":
        # mis-wiring raises SchemaError so Pipeline.validate wraps it into
        # its documented PipelineSchemaError (naming this stage) instead
        # of letting a bare ValueError escape the plan-time gate
        from ..core.schema import SchemaError

        if self.model_bytes is None or not self.feed_dict \
                or not self.fetch_dict:
            raise SchemaError(
                f"ONNXModel({self.uid}): model_bytes, feed_dict and "
                f"fetch_dict must be set")
        ins, outs = self._io_specs()
        unknown = [k for k in self.feed_dict if k not in ins]
        if unknown:
            raise SchemaError(
                f"ONNXModel({self.uid}): feed_dict keys {unknown} are not "
                f"graph inputs; graph expects {sorted(ins)}")
        missing_out = [n for n in self.fetch_dict.values() if n not in outs]
        if missing_out:
            raise SchemaError(
                f"ONNXModel({self.uid}): fetch_dict outputs {missing_out} "
                f"are not graph outputs; graph produces {sorted(outs)}")
        self._check_schema(schema, self._input_schema_from(ins))
        out = schema
        for col, onnx_name in self.fetch_dict.items():
            dc, role = outs.get(onnx_name, ("any", "any"))
            out = out.with_column(col, ColumnSpec(dc, role))
        for src, dst in self.softmax_dict.items():
            out = out.with_column(dst, ColumnSpec(
                "float", out[src].role if src in out else "any"))
        for src, dst in self.argmax_dict.items():
            out = out.with_column(dst, ColumnSpec("int", "any"))
        return out

    # -- helpers -------------------------------------------------------------------

    def _gather_feed(self, table: Table, col: str) -> np.ndarray:
        arr = table[col]
        if arr.dtype == object:  # ragged/list column -> stack (must be uniform)
            if len(arr) == 0:
                return np.zeros((0,), dtype=np.float32)
            try:
                arr = np.stack([np.asarray(v) for v in arr])
            except ValueError as e:
                raise ValueError(
                    f"ONNXModel({self.uid}): column {col!r} has non-uniform shapes; "
                    f"resize/pad upstream (e.g. ResizeImageTransformer)"
                ) from e
        return arr

    def transform_arrays(self, feeds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Batched execution with pad-to-bucket; returns full-length outputs.
        A feed may be a torch tensor (on the model's device, it is sliced
        there and never goes through the host)."""
        fn = self.fn
        n = len(next(iter(feeds.values())))
        if n == 0:  # empty partitions are normal in a partitioned pipeline
            dummy = {}
            shapes = fn.input_shapes()
            for k, v in feeds.items():
                shp = v.shape[1:]
                if not shp and shapes.get(k) and len(shapes[k]) > 1:
                    shp = tuple(s if isinstance(s, int) else 1 for s in shapes[k][1:])
                dt = v.dtype if v.dtype != object else np.float32
                dummy[k] = np.zeros((1,) + tuple(shp), dtype=dt)
            result = fn(dummy)
            out0 = {}
            for col, name in self.fetch_dict.items():
                if name not in result:  # same error as the non-empty path
                    raise ValueError(
                        f"ONNXModel({self.uid}): graph has no output {name!r}; "
                        f"outputs: {list(result)}"
                    )
                out0[col] = result[name].cpu().numpy()[:0]
            return out0
        b = min(self.batch_size, max(1, n))
        out_parts: Dict[str, List[np.ndarray]] = {k: [] for k in self.fetch_dict}
        for lo in range(0, n, b):
            hi = min(lo + b, n)
            batch = {k: v[lo:hi] for k, v in feeds.items()}
            pad = b - (hi - lo)
            if pad:
                batch = {k: _pad_rows(v, pad) for k, v in batch.items()}
            result = fn(batch)
            for out_col, onnx_name in self.fetch_dict.items():
                if onnx_name not in result:
                    raise ValueError(
                        f"ONNXModel({self.uid}): graph has no output {onnx_name!r}; "
                        f"outputs: {list(result)}"
                    )
                r = result[onnx_name].cpu().numpy()
                out_parts[out_col].append(r[: hi - lo] if pad else r)
        return {k: np.concatenate(v, axis=0) for k, v in out_parts.items()}

    # -- transform -----------------------------------------------------------------

    def _transform(self, table: Table) -> Table:
        if not self.feed_dict or not self.fetch_dict:
            raise ValueError(f"ONNXModel({self.uid}): feed_dict and fetch_dict must be set")
        unknown = [k for k in self.feed_dict if k not in self.fn.input_names]
        if unknown:
            raise ValueError(
                f"ONNXModel({self.uid}): feed_dict keys {unknown} are not graph inputs; "
                f"graph expects {self.fn.input_names}"
            )
        for onnx_in, col in self.feed_dict.items():
            self._validate_input(table, col)
        feeds = {onnx_in: self._gather_feed(table, col) for onnx_in, col in self.feed_dict.items()}
        outputs = self.transform_arrays(feeds)
        out = table
        for col, arr in outputs.items():
            out = out.with_column(col, arr)
        for src, dst in self.softmax_dict.items():
            x = np.asarray(out[src], dtype=np.float64)
            x = x - x.max(axis=-1, keepdims=True)
            e = np.exp(x)
            out = out.with_column(dst, (e / e.sum(axis=-1, keepdims=True)).astype(np.float32))
        for src, dst in self.argmax_dict.items():
            out = out.with_column(dst, np.argmax(np.asarray(out[src]), axis=-1).astype(np.int64))
        return out
