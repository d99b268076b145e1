"""ONNX graph -> PyTorch execution on the card.

Port of ``synapseml_tpu/onnx/importer.py``. The reference traces the graph
once per input-shape signature under ``jax.jit`` and folds every node whose
inputs are all constants (:656-684). The port keeps a *plan* per input-shape
signature, as jit keeps its cache: the first call of a signature runs the
graph op by op, folding on the host every node whose inputs are all graph
constants (shape arithmetic: ``Shape -> Gather -> Concat -> Reshape``) and
keeping the folded values; later calls of the signature replay the remaining
nodes eagerly on the device, with the folded values in place. The
initializers are uploaded to the function's device once, at construction,
and a folded value the first time a device op takes it
(:class:`~synapseml_tpu_torch.onnx.ops.ConstStore`).

``dtype_policy='bfloat16'`` keeps the reference's order: floating constants
are cast to bf16 *before* folding, floating feeds on entry, matmul/conv
accumulate in f32 (``MatMul`` returns f32, ``Gemm`` and ``Conv`` cast back),
and bf16 outputs return f32. Under the f32 policy the run keeps TF32 off
(cuDNN's convolutions would take it by default); under the bf16 policy TF32
is on (its f32 products then lose nothing on bf16 operands).

``channels_last=True`` (opt-in, as in the reference) runs the graph with
4-D floating feeds and convolution weights in torch's channels-last memory
format, which convolutions and elementwise ops carry through; values keep
their logical NCHW shape, so every other op is unchanged.

Tensor-parallel and fsdp serving (``layout=`` a
:class:`~synapseml_tpu_torch.runtime.layout.SpecLayout` with a model or fsdp
axis over more than one rank; every rank of the process group builds the
function and calls it with the same feeds): the reference's placement plan
(:func:`placement_plan`, ``_plan_const_specs`` at importer.py:196-363)
gives each weight initializer a spec (``_const_specs``), and each rank
uploads only its block of it (under the bf16 policy cast first, as the
reference does at :147-154). A ``MatMul`` / ``Gemm`` weight sharded over
``model`` (``transB`` respected) computes the rank's output columns, which
are all-gathered over ``model`` along the last dim; a ``Conv`` kernel
sharded over output channels gathers along dim 1 (its bias cut to the
rank's channels). A weight stored over ``fsdp`` is all-gathered over
``fsdp`` at each use and dropped after. The plan covers no
``MatMulInteger`` / ``QLinearMatMul`` weight (the reference's roles are
MatMul, Gemm and Conv only), so kernel Q's packing is untouched. A layout
whose model and fsdp axes are 1 runs the single-device executor.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..runtime.device import resolve_device
from ..runtime.layout import SpecLayout
from .ops import OPS, ConstStore, _STORE, _host_tensor, _t as _t_dev, is_const
from .wire import (DataType, GraphProto, ModelProto, ValueInfo, parse_model,
                   tensor_to_numpy)

__all__ = ["OnnxFunction", "load_model", "model_io_specs", "placement_plan"]

def _value_info_spec(vi: ValueInfo):
    """(dtype_class, shape_role) of a graph ``value_info`` entry, in
    :mod:`synapseml_tpu_torch.core.schema` vocabulary. The leading dim is the
    batch axis, so a rank-2 graph tensor is a per-row *vector* column, a
    rank-3+ one a *tensor* column, rank-0/1 a *scalar* column. Unknown
    element types / shapes degrade to ``any``."""
    np_dtype = DataType._TO_NUMPY.get(vi.elem_type)
    if np_dtype is None:
        dtype_class = "any"
    else:
        from ..core.schema import dtype_class_of

        dtype_class = dtype_class_of(np_dtype)
    if vi.shape is None:
        role = "any"
    elif len(vi.shape) <= 1:
        role = "scalar"
    elif len(vi.shape) == 2:
        role = "vector"
    else:
        role = "tensor"
    return (dtype_class, role)


def model_io_specs(model: "ModelProto | bytes"):
    """Static (input specs, output specs) of an ONNX model, derived from the
    graph's ``value_info`` -- ``{name: (dtype_class, shape_role)}`` per side,
    initializers excluded from inputs. Parses the protobuf only: what
    ``ONNXModel.transform_schema`` runs at plan time."""
    if isinstance(model, (bytes, bytearray, memoryview)):
        model = parse_model(bytes(model))
    graph = model.graph
    init_names = {t.name for t in graph.initializer}
    inputs = {vi.name: _value_info_spec(vi) for vi in graph.input
              if vi.name not in init_names}
    outputs = {vi.name: _value_info_spec(vi) for vi in graph.output}
    return inputs, outputs


# -- placement planning (pure graph analysis) -----------------------------------------------

_PLAN_KEYS = ("tensor", "shape", "nbytes", "decision", "reason")


def placement_plan(model: "ModelProto | bytes", model_size: int, fsdp_size: int = 1,
                   external_data_dir: Optional[str] = None) -> List[Dict[str, Any]]:
    """The reference's per-initializer residency decisions under a layout
    with ``model_size`` / ``fsdp_size`` (``_plan_const_specs`` /
    ``placement_report``, importer.py:196-363), as pure graph analysis:
    rows ``{tensor, shape, nbytes, decision, reason}`` (decision
    ``sharded`` / ``fsdp`` / ``replicated``), largest tensor first."""
    if isinstance(model, (bytes, bytearray, memoryview)):
        model = parse_model(bytes(model))
    constants = {t.name: tensor_to_numpy(t, external_dir=external_data_dir)
                 for t in model.graph.initializer}
    rows = _plan_rows(model.graph, list(getattr(model, "functions", [])), constants,
                      model_size, fsdp_size)
    return [{k: r[k] for k in _PLAN_KEYS} for r in rows]


def _plan_rows(graph, functions, constants, model_size: int, fsdp_size: int):
    """:func:`placement_plan`'s rows, each with the planner's ``use`` (the
    role ``(kind, dim)`` a model-sharded weight keeps at its consumers, or
    None) and ``store`` (the dim stored over fsdp, or None)."""
    roles: Dict[str, set] = {}

    def scan(graph):
        for node in graph.node:
            attrs = node.attrs()
            for slot, name in enumerate(node.input):
                if not name or name not in constants:
                    continue
                nd = len(constants[name].shape)
                role = None
                if slot == 1 and node.op_type == "MatMul" and nd == 2:
                    role = ("col", 1)
                elif slot == 1 and node.op_type == "Gemm" and nd == 2:
                    role = ("col", 0 if int(attrs.get("transB", 0)) else 1)
                elif slot == 1 and node.op_type == "Conv" and nd == 4:
                    role = ("conv", 0)
                roles.setdefault(name, set()).add(role)
            for a in node.attribute:
                if a.g is not None:
                    scan(a.g)
                for g in a.graphs:
                    scan(g)

    scan(graph)
    for fn in functions:
        scan(fn)
    m, f = model_size, fsdp_size
    plan: List[Dict[str, Any]] = []

    def shape_of(c):
        return tuple(c.shape)

    def nbytes(c):
        return int(c.numel() * c.element_size()) if isinstance(c, torch.Tensor) \
            else int(c.nbytes)

    def floating(c):
        return c.dtype.is_floating_point if isinstance(c, torch.Tensor) \
            else bool(np.issubdtype(c.dtype, np.floating))

    def record(name: str, decision: str, reason: str, use=None, store=None) -> None:
        const = constants[name]
        plan.append({"tensor": name, "shape": shape_of(const), "nbytes": nbytes(const),
                     "decision": decision, "reason": reason, "use": use, "store": store})

    def fsdp_store_dim(const, avoid: Optional[int]) -> Optional[int]:
        # first dim (skipping any model-sharded one) whose size splits over
        # the fsdp axis: the row dim the weight is STORED over
        if f <= 1:
            return None
        for sd, size in enumerate(shape_of(const)):
            if sd != avoid and size % f == 0:
                return sd
        return None

    for name, rs in roles.items():
        const = constants[name]
        is_float = floating(const)
        if len(rs) != 1 or None in rs:
            kinds = sorted(str(r) for r in rs)
            conflict = (f"consumer-role conflict ({', '.join(kinds)}) — "
                        f"no single shardable role; tied/multi-use weight")
            sd = fsdp_store_dim(const, None) if is_float and rs != {None} else None
            if sd is None:
                record(name, "replicated", conflict)
                continue
            record(name, "fsdp", f"stored over fsdp={f} on dim {sd}, all-gathered at "
                                 f"each consumer — resolves {conflict}", store=sd)
            continue
        kind, dim = next(iter(rs))
        if not is_float:
            record(name, "replicated", f"non-float dtype {const.dtype} (shape operand / "
                                       f"index table)")
            continue
        if m > 1 and shape_of(const)[dim] % m == 0:
            sd = fsdp_store_dim(const, avoid=dim)
            if sd is None:
                record(name, "sharded", f"{kind} weight: dim {dim} over model={m}",
                       use=(kind, dim))
            else:
                record(name, "fsdp", f"{kind} weight: dim {dim} over model={m}, stored over "
                                     f"fsdp={f} on dim {sd}; fsdp axis all-gathered on use",
                       use=(kind, dim), store=sd)
            continue
        if m > 1:
            record(name, "replicated", f"{kind} dim {dim} size {shape_of(const)[dim]} not "
                                       f"divisible by model={m}")
            continue
        sd = fsdp_store_dim(const, None)
        if sd is None:
            record(name, "replicated", f"{kind} weight: no dim divisible by fsdp={f}")
            continue
        record(name, "fsdp", f"{kind} weight: stored over fsdp={f} on dim {sd}, "
                             f"all-gathered on use", store=sd)
    for name in constants:
        if name not in roles:
            record(name, "replicated", "no weight-role consumer (bias / norm param / "
                                       "unconsumed initializer)")
    return sorted(plan, key=lambda r: (-r["nbytes"], r["tensor"]))


# -- the executor ---------------------------------------------------------------------------

class _Plan:
    """What the first call of one input-shape signature learned: the folded
    outputs of every constant node, by its position (scope path + index)."""

    def __init__(self):
        self.folded: Dict[tuple, tuple] = {}


class OnnxFunction:
    """Callable wrapper: ``fn(feeds: dict[str, array]) -> dict[str, tensor]``.

    One plan per input-shape signature (see the module's doc); outputs are
    tensors on the function's device (bf16 ones as f32)."""

    def __init__(self, model: "ModelProto | bytes", dtype_policy: str = "float32",
                 channels_last: bool = False, external_data_dir: "str | None" = None,
                 layout=None, device=None):
        if isinstance(model, (bytes, bytearray, memoryview)):
            model = parse_model(bytes(model))
        self.model = model
        self.graph = model.graph
        self.opset = model.opset_version
        if dtype_policy not in ("float32", "bfloat16"):
            raise ValueError(f"unknown dtype_policy {dtype_policy!r}")
        self.dtype_policy = dtype_policy
        self.channels_last = bool(channels_last)
        self._external_dir = external_data_dir
        # model-local functions: nodes whose (domain, op_type) matches expand
        # to the function body (real exporters emit e.g. LayerNormalization
        # or custom ops this way from IR 8 on)
        self.functions = {(f.domain, f.name): f for f in getattr(model, "functions", [])}
        self.constants: Dict[str, Any] = {
            t.name: tensor_to_numpy(t, external_dir=external_data_dir)
            for t in self.graph.initializer}
        init_names = set(self.constants)
        # Graph inputs that are not initializers are the real feeds.
        self.input_infos: List[ValueInfo] = [
            vi for vi in self.graph.input if vi.name not in init_names]
        self.input_names: List[str] = [vi.name for vi in self.input_infos]
        self.output_names: List[str] = [vi.name for vi in self.graph.output]
        self._validate_ops(self.graph)
        self.layout = layout
        self.device = resolve_device(device)
        # tensor-parallel / fsdp placement: the reference's plan, made on the
        # host constants (their f32 bytes), before the bf16 cast
        self._const_plan: List[Dict[str, Any]] = []
        self._const_specs: Dict[str, tuple] = {}
        self._use_specs: Dict[str, tuple] = {}
        self._sharded_use: Dict[str, tuple] = {}   # name -> (kind, dim, full size)
        if layout is not None and (getattr(layout, "model_size", 1) > 1
                                   or getattr(layout, "fsdp_size", 1) > 1):
            if not isinstance(layout, SpecLayout):
                raise TypeError(f"a populated layout must be a runtime.layout.SpecLayout, "
                                f"got {type(layout).__name__}")
            self._plan_placement(layout)
        if dtype_policy == "bfloat16":
            # cast BEFORE folding (reference :387-396): every floating
            # constant is a bf16 value from the start
            for name, const in self.constants.items():
                if isinstance(const, np.ndarray) and np.issubdtype(const.dtype, np.floating):
                    self.constants[name] = torch.from_numpy(
                        np.array(const, dtype=np.float32)).to(torch.bfloat16)
        for name, spec in self._const_specs.items():   # this rank's block only
            self.constants[name] = self._block(self.constants[name], spec)
        self._store = ConstStore()
        for const in self.constants.values():   # uploaded once, here
            self._store.add(const, self.device)
        if self.channels_last:
            self._store.channels_last(self.device)
        self._plans: Dict[tuple, _Plan] = {}

    # -- public ------------------------------------------------------------------

    def __call__(self, feeds: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        missing = [n for n in self.input_names if n not in feeds]
        if missing:
            raise ValueError(f"missing feeds {missing}; expected {self.input_names}")
        args = [self._feed(feeds[vi.name], vi) for vi in self.input_infos]
        sig = tuple((tuple(a.shape), a.dtype) for a in args)
        plan = self._plans.get(sig)
        fresh = plan is None
        if fresh:
            plan = _Plan()
        env: Dict[str, Any] = {"": None, **self.constants}
        env.update(zip(self.input_names, args))
        token = _STORE.set(self._store)
        try:
            with self._precision():
                self._run_graph(self.graph, env, plan, ())
        finally:
            _STORE.reset(token)
        if fresh:
            self._plans[sig] = plan
        return {name: self._output(env[name]) for name in self.output_names}

    def input_shapes(self) -> Dict[str, Optional[List[Any]]]:
        return {vi.name: vi.shape for vi in self.input_infos}

    def placement_report(self) -> List[Dict[str, Any]]:
        """The placement plan's rows under the layout (:func:`placement_plan`),
        largest tensor first; empty without a model or fsdp axis over more
        than one rank."""
        return [{k: r[k] for k in _PLAN_KEYS} for r in self._const_plan]

    def at_rest_bytes(self) -> int:
        """The bytes of the initializers this rank holds on its device (its
        blocks of the planned weights, the rest whole)."""
        held = (self._store.tensor(c, self.device) for c in self.constants.values())
        return sum(t.numel() * t.element_size() for t in held)

    # -- tensor-parallel / fsdp placement ------------------------------------------

    def _plan_placement(self, layout: SpecLayout) -> None:
        rows = _plan_rows(self.graph, list(self.functions.values()), self.constants,
                          layout.model_size, layout.fsdp_size)
        self._const_plan = rows
        for r in rows:
            if r["decision"] == "replicated":
                continue
            rank = len(r["shape"])
            use = ()
            if r["use"] is not None:
                kind, dim = r["use"]
                use = (layout.conv_weight(rank=rank) if kind == "conv"
                       else layout.col_weight(rank=rank, dim=dim))
                self._sharded_use[r["tensor"]] = (kind, dim, r["shape"][dim])
            spec = use if r["store"] is None else \
                layout.fsdp_weight(rank=rank, dim=r["store"], use_spec=use or None)
            self._const_specs[r["tensor"]] = spec
            self._use_specs[r["tensor"]] = layout.use_spec(spec)

    def _block(self, const, spec):
        """This rank's block of a host constant under ``spec`` (a copy, so
        the whole tensor is not kept)."""
        t = self.layout.shard(_host_tensor(const), spec).contiguous().clone()
        return t if isinstance(const, torch.Tensor) else t.numpy()

    def _use_form(self, name: str, value) -> torch.Tensor:
        """A planned weight as its consumer takes it: the stored block
        all-gathered over fsdp (a transient), or the block itself."""
        spec = self._const_specs[name]
        if self._use_specs[name] == tuple(spec):
            return value
        return self.layout.gather_for_use(self._store.tensor(value, self.device), spec)

    def _run_sharded(self, node, fn, inputs, attrs, ctx):
        """A MatMul / Gemm / Conv whose weight (input 1) is sharded over
        ``model``: this rank's output columns (channels), all-gathered over
        ``model``."""
        from ..runtime.collectives import all_gather

        layout = self.layout
        kind, dim, full = self._sharded_use[node.input[1]]
        m, r = layout.model_size, layout.model_rank
        lo, hi = r * full // m, (r + 1) * full // m
        inputs = list(inputs)
        inputs[1] = self._use_form(node.input[1], inputs[1])

        def cut(v, axis):   # a bias / C operand's rank block along ``axis``
            if v is None:
                return v
            t = _t_dev(v, self.device)
            if t.dim() == 0 or t.shape[axis] != full or full == 1:
                return t
            return t.narrow(axis % t.dim(), lo, hi - lo)

        if node.op_type == "Conv":
            groups = int(attrs.get("group", 1))
            if groups > 1 and groups % m:
                # the rank's channels straddle groups: the whole kernel here
                inputs[1] = all_gather(_t_dev(inputs[1], self.device), layout, "model", dim=0)
                return fn(inputs, attrs, ctx)
            if groups > 1:
                x = _t_dev(inputs[0], self.device)
                cg = x.shape[1] // groups
                gl = groups // m
                inputs[0] = x.narrow(1, r * gl * cg, gl * cg)
                attrs = dict(attrs, group=gl)
            if len(inputs) > 2:
                inputs[2] = cut(inputs[2], 0)
            return all_gather(fn(inputs, attrs, ctx), layout, "model", dim=1)
        if node.op_type == "Gemm" and len(inputs) > 2:
            inputs[2] = cut(inputs[2], -1)
        return all_gather(fn(inputs, attrs, ctx), layout, "model", dim=-1)

    # -- feeds, outputs, precision -------------------------------------------------

    def _feed(self, value, vi: ValueInfo) -> torch.Tensor:
        t = value if isinstance(value, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(np.asarray(value)))
        t = t.to(self.device)
        declared = DataType._TO_NUMPY.get(vi.elem_type)
        if declared is not None and t.dtype.is_floating_point:
            want = torch.from_numpy(np.zeros(0, declared)).dtype
            if want.is_floating_point and want != t.dtype:
                t = t.to(want)   # as the reference's f32 run takes an f64 feed
        if self.dtype_policy == "bfloat16" and t.dtype.is_floating_point:
            t = t.to(torch.bfloat16)
        if self.channels_last and t.dim() == 4 and t.dtype.is_floating_point:
            t = t.contiguous(memory_format=torch.channels_last)
        return t

    def _output(self, v) -> torch.Tensor:
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
        t = t.to(self.device)
        if self.dtype_policy == "bfloat16" and t.dtype == torch.bfloat16:
            t = t.to(torch.float32)
        return t.contiguous()

    @contextlib.contextmanager
    def _precision(self):
        tf32 = self.dtype_policy == "bfloat16"
        prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev

    # -- execution ---------------------------------------------------------------

    def _validate_ops(self, graph: GraphProto) -> None:
        missing = sorted({n.op_type for n in graph.node
                          if n.op_type not in OPS
                          and (n.domain, n.op_type) not in self.functions})
        for f in self.functions.values():
            missing += [n.op_type for n in f.node
                        if n.op_type not in OPS
                        and (n.domain, n.op_type) not in self.functions]
        if missing:
            raise NotImplementedError(
                f"ONNX ops not supported by the importer: {sorted(set(missing))}. "
                f"Supported: {len(OPS)} ops; extend synapseml_tpu_torch/onnx/ops.py.")

    def _run_function(self, fdef, call, env: Dict[str, Any], plan: _Plan, key: tuple) -> None:
        """Inline-expand a model-local function call: bind formal inputs,
        substitute ``ref_attr_name`` attributes from the call site (falling
        back to ``attribute_proto`` defaults, recursing into subgraph
        attributes), run the body in a private scope under the function's
        own opset, and export the formal outputs."""
        call_attrs = {a.name: a for a in call.attribute}
        for a in fdef.attribute_proto:  # declared params with defaults
            call_attrs.setdefault(a.name, a)

        def resolve_node(node):
            changed = False
            resolved = []
            for a in node.attribute:
                if a.ref_attr_name:
                    src = call_attrs.get(a.ref_attr_name)
                    if src is not None:
                        resolved.append(dataclasses.replace(src, name=a.name))
                    # absent optional attr: drop (ONNX function semantics)
                    changed = True
                elif a.g is not None or a.graphs:
                    # refs are legal inside If/Loop bodies of the function
                    a2 = dataclasses.replace(
                        a, g=resolve_graph(a.g) if a.g is not None else None,
                        graphs=[resolve_graph(g) for g in a.graphs])
                    resolved.append(a2)
                    changed = True
                else:
                    resolved.append(a)
            return dataclasses.replace(node, attribute=resolved) if changed else node

        def resolve_graph(g):
            return dataclasses.replace(g, node=[resolve_node(n) for n in g.node])

        fenv: Dict[str, Any] = {"": None}
        for formal in fdef.input:  # trailing optionals may be uncalled
            fenv[formal] = None
        for formal, actual in zip(fdef.input, call.input):
            fenv[formal] = env[actual] if actual else None
        body = GraphProto(node=[resolve_node(n) for n in fdef.node],
                          output=[ValueInfo(name=o) for o in fdef.output])
        # the body executes under ITS opset (pre-13 bodies keep e.g.
        # attribute-form Unsqueeze even inside an opset-13+ model)
        self._run_graph(body, fenv, plan, key, opset=fdef.opset_imports.get("") or None)
        for formal, actual in zip(fdef.output, call.output):
            if actual:
                env[actual] = fenv[formal]

    def _run_graph(self, graph: GraphProto, env: Dict[str, Any], plan: _Plan, scope: tuple,
                   opset: "int | None" = None) -> None:
        opset = self.opset if opset is None else opset
        accum = torch.float32 if self.dtype_policy == "bfloat16" else None
        for i, node in enumerate(graph.node):
            key = scope + (i,)
            folded = plan.folded.get(key)
            if folded is not None:
                for name, val in zip(node.output, folded):
                    if name:
                        env[name] = val
                continue
            fdef = self.functions.get((node.domain, node.op_type))
            # builtins win only in the standard domains; a custom-domain
            # function whose name collides with a builtin must still expand
            if fdef is not None and (node.domain not in ("", "ai.onnx")
                                     or node.op_type not in OPS):
                self._run_function(fdef, node, env, plan, key)
                continue
            try:
                fn = OPS[node.op_type]
            except KeyError:
                raise NotImplementedError(f"unsupported ONNX op {node.op_type}") from None
            inputs = [env[name] if name else None for name in node.input]
            sharded = len(node.input) > 1 and node.input[1] in self._sharded_use and \
                node.op_type in ("MatMul", "Gemm", "Conv")
            if self._const_specs and not sharded:
                inputs = [self._use_form(name, v) if name in self._const_specs else v
                          for name, v in zip(node.input, inputs)]
            branches = itertools.count()

            def subgraph_runner(sub: GraphProto, key=key, env=env, branches=branches):
                branch = key + (next(branches),)

                def run():
                    sub_env = dict(env)
                    self._run_graph(sub, sub_env, plan, branch, opset=opset)
                    vals = [sub_env[o.name] for o in sub.output]
                    return vals[0] if len(vals) == 1 else tuple(vals)

                return run

            ctx = {"op_type": node.op_type, "opset": opset, "n_outputs": len(node.output),
                   "accum_dtype": accum, "subgraph_runner": subgraph_runner,
                   "external_dir": self._external_dir}
            # Constant folding: all-constant inputs => evaluate on the host
            # and pin the outputs (numpy; a bf16 one as a CPU tensor), so
            # shape chains (Shape -> Gather/Mod/Add -> Reshape -> Slice.ends)
            # stay static, and keep them in the plan; a shape is one of the
            # signature's, so Shape and Size keep theirs too
            const_in = not sharded and (node.op_type in ("Shape", "Size") or (
                all(v is None or is_const(v) for v in inputs)
                and node.op_type not in ("Dropout", "If")))
            try:
                out = self._run_sharded(node, fn, inputs, node.attrs(), ctx) if sharded \
                    else fn(inputs, node.attrs(), ctx)
            except Exception as e:
                raise type(e)(
                    f"while executing node {node.name or '?'} ({node.op_type}) "
                    f"inputs={node.input}: {e}") from e
            outs = out if isinstance(out, tuple) else (out,)
            if const_in:
                outs = tuple(self._pin(o) for o in outs)
                plan.folded[key] = outs
            for name, val in zip(node.output, outs):
                if name:
                    env[name] = val

    def _pin(self, v):
        """A folded value as the plan keeps it: numpy, or (bf16, which numpy
        lacks) a CPU tensor registered as a constant."""
        if isinstance(v, torch.Tensor):
            v = v.cpu()
            if v.dtype != torch.bfloat16:
                v = v.numpy()
        if isinstance(v, (np.ndarray, torch.Tensor)):
            self._store.add(v)
        return v


def load_model(path_or_bytes, dtype_policy: str = "float32", device=None) -> OnnxFunction:
    """Load an ``.onnx`` file (path or bytes) into an executable function.

    Loading by PATH resolves external-data tensors (``data_location=EXTERNAL``,
    the real-exporter format past protobuf's 2GB limit) relative to the
    model's directory; from raw bytes pass ``external_data_dir`` to
    :class:`OnnxFunction` directly."""
    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        data = bytes(path_or_bytes)
        ext_dir = None
    else:
        import os

        with open(path_or_bytes, "rb") as f:
            data = f.read()
        ext_dir = os.path.dirname(os.path.abspath(path_or_bytes))
    return OnnxFunction(data, dtype_policy=dtype_policy, external_data_dir=ext_dir,
                        device=device)
