"""A persistent gloo world for the port's mesh tests, and the cases its ranks run.

:class:`MeshWorld` spawns ``size`` processes (``torch.multiprocessing``'s
spawn context), each of which joins one gloo process group through a
``FileStore`` in a temporary directory (no TCP port, so test workers that
run at once never meet) with one torch thread, then waits for cases:
``world.run(name, **kwargs)`` sends every rank the same case of
:data:`CASES` and returns the ranks' results in rank order (a rank's
exception comes back as its traceback and fails the call). A test module
keeps one world in a module-scoped fixture, so the spawn (a few seconds)
is paid once.

The rank side is this module: it imports torch, numpy and the port, never
jax or the JAX package (the ranks must not load ``tests/conftest.py``'s
JAX), which ``tests/test_torch_hygiene.py`` checks. Layouts are built
once per rank and shape (``init_device_mesh`` is collective: every rank
builds the same ones in the same order, which the cases do).
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import traceback
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

__all__ = ["MeshWorld", "CASES", "booster_of"]

CASE_TIMEOUT_S = 600


class MeshWorld:
    """``size`` ranks in one gloo world on the CPU, kept until :meth:`close`."""

    def __init__(self, size: int = 8):
        ctx = mp.get_context("spawn")
        self.size = size
        self._dir = tempfile.mkdtemp(prefix="smt_mesh_")
        store = os.path.join(self._dir, "store")
        self._in = [ctx.Queue() for _ in range(size)]
        self._out = ctx.Queue()
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(r, size, store, self._in[r], self._out), daemon=True)
                       for r in range(size)]
        for p in self._procs:
            p.start()

    def run(self, case: str, **kwargs) -> List[Any]:
        """Every rank's result of ``CASES[case](**kwargs)``, in rank order."""
        for q in self._in:
            q.put((case, kwargs))
        got: Dict[int, Any] = {}
        errors = []
        for _ in range(self.size):
            try:
                rank, ok, out = self._out.get(timeout=CASE_TIMEOUT_S)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"mesh case {case!r}: a rank gave no result in "
                                   f"{CASE_TIMEOUT_S} s (the world is closed)")
            (got.__setitem__(rank, out) if ok else errors.append(f"rank {rank}:\n{out}"))
        if errors:
            raise RuntimeError(f"mesh case {case!r} failed\n" + "\n".join(errors))
        return [got[r] for r in range(self.size)]

    def close(self) -> None:
        for q in self._in:
            q.put(None)
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        shutil.rmtree(self._dir, ignore_errors=True)


def _rank_main(rank: int, size: int, store: str, inbox, outbox) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, size), rank=rank,
                            world_size=size, timeout=datetime.timedelta(seconds=300))
    import synapseml_tpu_torch.gbdt.boost  # noqa: F401  (imported before the first case)
    state: Dict[Any, Any] = {}
    try:
        while True:
            msg = inbox.get()
            if msg is None:
                break
            case, kwargs = msg
            try:
                outbox.put((rank, True, CASES[case](state, **kwargs)))
            except Exception:  # the traceback goes back to the test
                outbox.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------------

def _layout(state, spec):
    """The layout of ``spec`` (built once a rank): ``("build", data, model)``
    a :class:`SpecLayout`, ``("fsdp", data, fsdp, model)`` one with an fsdp
    axis, ``("raw", shape, names)`` a raw DeviceMesh, None no mesh."""
    if spec is None:
        return None
    key = ("layout",) + tuple(spec)
    if key not in state:
        from torch.distributed.device_mesh import init_device_mesh

        from synapseml_tpu_torch.runtime.layout import SpecLayout

        if spec[0] == "build":
            state[key] = SpecLayout.build(data=spec[1], model=spec[2], device_type="cpu")
        elif spec[0] == "fsdp":
            state[key] = SpecLayout.build(data=spec[1], fsdp=spec[2], model=spec[3],
                                          device_type="cpu")
        elif spec[0] == "raw":
            state[key] = init_device_mesh("cpu", tuple(spec[1]), mesh_dim_names=tuple(spec[2]))
        else:
            raise ValueError(f"unknown layout spec {spec}")
    return state[key]


def booster_of(booster) -> dict:
    """What a rank sends back of a booster: its state, its eval records and
    sampled rows."""
    out = dict(booster.state_dict())
    out["evals_result"] = booster.evals_result
    out["sampled_rows"] = booster.sampled_rows
    return out


def case_fit(state, layout=None, params=None, x=None, y=None, dataset=None,
             dataset_kw=None, continue_with=None, mapper_of=None, **train_kw) -> dict:
    """``train(params, x, y, mesh=layout, device="cpu", **train_kw)``.
    ``dataset``: ``"host"`` or ``"device"`` trains over a
    :class:`GBDTDataset` of ``x`` (a numpy or a tensor one, with ``y`` as
    its label); ``continue_with``: params of a second fit continued from
    the first (``init_booster``); ``mapper_of``: rows whose device-resident
    dataset's mapper the fit bins with. Returns the booster, the
    collectives counted and the plain P / pick / G-mesh calls of the
    (last) fit."""
    from synapseml_tpu_torch.gbdt import GBDTDataset
    from synapseml_tpu_torch.gbdt.boost import train
    from synapseml_tpu_torch.runtime import collectives

    lay = _layout(state, layout)
    data = x
    if dataset is not None:
        xv = torch.as_tensor(np.asarray(x, np.float32)) if dataset == "device" else x
        data = GBDTDataset(xv, label=y, device="cpu", **(dataset_kw or {}))
        y = None
    if mapper_of is not None:
        train_kw["mapper"] = GBDTDataset(torch.as_tensor(np.asarray(mapper_of, np.float32)),
                                         device="cpu").mapper
    calls = _CallCounter()
    with calls:
        collectives.reset_counts()
        b = train(params, data, y, mesh=lay, device="cpu", **train_kw)
        if continue_with is not None:
            collectives.reset_counts()
            calls.reset()
            b = train(continue_with, data, y, mesh=lay, device="cpu", init_booster=b,
                      **train_kw)
    return dict(booster=booster_of(b), collectives=collectives.counts(), calls=calls.counts)


def case_estimator(state, layout=None, cls="LightGBMClassifier", params=None, x=None, y=None,
                   group=None) -> dict:
    """An estimator's fit over ``layout`` (its ``mesh`` Param) on the CPU."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.gbdt import estimators

    cols = {"features": x, "label": y}
    if group is not None:
        cols["group"] = group
    est = getattr(estimators, cls)(device="cpu", mesh=_layout(state, layout), **params)
    return booster_of(est.fit(Table(cols)).booster)


class _CallCounter:
    """Counts the plain versions' calls of kernel P's two entries and G's
    mesh use on the CPU (the kernels' own counters count card launches)."""

    _TARGETS = (("partition", "partition_plain", "split"),
                ("partition", "pick_plain", "pick"),
                ("sparse", "sparse_hist_plain", "g"))

    def __init__(self):
        self.counts: Dict[str, int] = {}
        self._saved = []

    def reset(self) -> None:
        self.counts.clear()

    def __enter__(self):
        from synapseml_tpu_torch.gbdt import grow, partition, sparse

        mods = {"partition": partition, "sparse": sparse}
        for mod_name, fn_name, key in self._TARGETS:
            mod = mods[mod_name]
            fn = getattr(mod, fn_name)

            def wrapped(*a, _fn=fn, _key=key, **kw):
                mesh = kw.get("mesh", a[7] if _key == "split" and len(a) > 7 else False)
                k = f"{_key}_mesh" if mesh else _key
                self.counts[k] = self.counts.get(k, 0) + 1
                return _fn(*a, **kw)

            self._saved.append((mod, fn_name, fn))
            setattr(mod, fn_name, wrapped)
        # G's mesh use reaches sparse_hist_plain through sparse_hist_mesh
        orig = sparse.sparse_hist_mesh

        def mesh_g(*a, _orig=orig, **kw):
            self.counts["g_mesh"] = self.counts.get("g_mesh", 0) + 1
            return _orig(*a, **kw)

        self._saved.append((grow, "sparse_hist_mesh", grow.sparse_hist_mesh))
        grow.sparse_hist_mesh = mesh_g
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()


def case_vw_fit(state, layout=None, idx=None, val=None, y=None, **kw) -> dict:
    """``vw.learner.train_linear(idx, val, y, mesh=layout, device="cpu",
    **kw)``: the state, the collectives counted and the fit's record."""
    from synapseml_tpu_torch.runtime import collectives
    from synapseml_tpu_torch.vw.learner import train_linear

    lay = _layout(state, layout)
    collectives.reset_counts()
    rec: Dict[str, Any] = {}
    st = train_linear(idx, val, y, mesh=lay, device="cpu", stats=rec, **kw)
    return dict(state=st._asdict(), collectives=collectives.counts(), stats=rec)


def case_vw_estimator(state, layout=None, col=None, y=None, **params) -> dict:
    """``VowpalWabbitRegressor(mesh=layout, device="cpu", **params)`` fit on a
    table of the sparse column ``col`` and labels ``y``: the model's state."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.vw.estimators import VowpalWabbitRegressor

    est = VowpalWabbitRegressor(mesh=_layout(state, layout), device="cpu", **params)
    return est.fit(Table({"features": col, "label": y})).state._asdict()


def case_attention(state, layout=None, q=None, k=None, v=None, strategy="ring", causal=False,
                   local="dense", bf16=False, axis="seq") -> dict:
    """``parallel.ring.sequence_sharded_attention`` over ``layout`` of the
    global ``q``, ``k``, ``v`` (numpy f32; cast to bf16 when asked): the
    output (f32 numpy), the key-block lengths the plain attention was
    called with on this rank, the collectives counted; or the error a
    ``ValueError`` raised."""
    from synapseml_tpu_torch.parallel import flash
    from synapseml_tpu_torch.parallel.ring import sequence_sharded_attention
    from synapseml_tpu_torch.runtime import collectives

    dt = torch.bfloat16 if bf16 else torch.float32
    qt, kt, vt = (torch.from_numpy(np.asarray(a, np.float32)).to(dt) for a in (q, k, v))
    seen: List[int] = []
    plain = flash.dense_attention

    def recording(q_, k_, v_, *a, **kw):
        seen.append(int(k_.shape[1]))
        return plain(q_, k_, v_, *a, **kw)

    flash.dense_attention = recording
    collectives.reset_counts()
    try:
        out = sequence_sharded_attention(qt, kt, vt, _layout(state, layout), strategy=strategy,
                                         causal=causal, local=local, axis=axis)
    except ValueError as e:
        return {"error": str(e)}
    finally:
        flash.dense_attention = plain
    return {"out": out.float().numpy(), "key_blocks": seen,
            "collectives": collectives.counts(), "dtype": str(out.dtype)}


def case_topology(state, axes=("data", "model"), shape=(4, 2)) -> dict:
    """``runtime.topology`` on this rank: ``cluster_info``, the backend
    check, meshes of ``make_mesh`` (default and ``shape``), a too-large
    shape's error."""
    from synapseml_tpu_torch.runtime import topology

    info = topology.cluster_info()
    out = {"info": info, "kind": topology.device_kind(),
           "require_cpu_ok": topology.require_backend(allow_cpu=True).platform}
    try:
        topology.require_backend()
    except RuntimeError as e:
        out["refusal"] = str(e)
    m1 = topology.make_mesh((axes[0],), device_type="cpu")
    m2 = topology.make_mesh(axes, shape=shape, device_type="cpu")
    out["default_1d"] = dict(zip(m1.mesh_dim_names, m1.mesh.shape))
    out["mesh_2d"] = dict(zip(m2.mesh_dim_names, m2.mesh.shape))
    try:
        topology.make_mesh((axes[0],), shape=(1000,), device_type="cpu")
    except ValueError as e:
        out["too_big"] = str(e)
    return out


def case_layout_specs(state, layout=None, w=None, x=None, saved=None) -> dict:
    """The layout's parameter specs, ``shard`` / ``gather_for_use`` of ``w``
    under the fsdp-stored column spec and ``x @`` the gathered block
    (all-gathered over model), and its ``state_dict`` round trip (and the
    rebuild of ``saved`` when given)."""
    from synapseml_tpu_torch.runtime import collectives

    lay = _layout(state, layout)
    out = {"describe": lay.describe(), "batch": lay.batch(), "batch41": lay.batch(rank=4, dim=1),
           "replicated": lay.replicated(), "col": lay.col_weight(),
           "col20": lay.col_weight(rank=2, dim=0), "conv": lay.conv_weight(),
           "fsdp1": lay.fsdp_weight(rank=1),
           "fsdp_col": lay.fsdp_weight(rank=2, dim=0, use_spec=lay.col_weight(rank=2)),
           "fsdp_joint": lay.fsdp_weight(rank=2, dim=1, use_spec=(None, "model")),
           "embed": lay.embed_weight(), "n_devices": lay.n_devices,
           "state_dict": lay.state_dict()}
    out["use"] = {k: lay.use_spec(out[k]) for k in ("fsdp_col", "fsdp_joint", "fsdp1")}
    if w is not None:
        wt = torch.from_numpy(np.asarray(w, np.float32))
        collectives.reset_counts()
        for key in ("fsdp_col", "fsdp_joint", "embed"):
            stored = out[key]
            local = lay.shard(wt, stored).contiguous()
            used = lay.gather_for_use(local, stored)
            out[f"{key}_local_bytes"] = local.numel() * local.element_size()
            out[f"{key}_used"] = used.numpy()
            out[f"{key}_want"] = lay.shard(wt, lay.use_spec(stored)).numpy()
        stored = out["fsdp_col"]
        cols = torch.from_numpy(np.asarray(x, np.float32)) @ lay.gather_for_use(
            lay.shard(wt, stored).contiguous(), stored)
        out["product"] = collectives.all_gather(cols, lay, "model", dim=-1).numpy() \
            if lay.model_size > 1 else cols.numpy()
        out["collectives"] = collectives.counts()
    back = type(lay).from_state_dict(lay.state_dict(), device_type="cpu")
    out["round_trip_equal"] = back == lay
    if saved is not None:
        out["rebuilt"] = type(lay).from_state_dict(saved, device_type="cpu").describe()
    return out


def case_dryrun(state, layout=None) -> dict:
    """``gbdt.engine.dryrun_train_step`` over ``layout`` on the CPU."""
    from synapseml_tpu_torch.gbdt.engine import dryrun_train_step
    from synapseml_tpu_torch.runtime import collectives

    collectives.reset_counts()
    b = dryrun_train_step(_layout(state, layout), device="cpu")
    return {"booster": booster_of(b), "collectives": collectives.counts()}


def case_onnx(state, layout=None, model=None, feeds=None, dtype_policy="float32",
              stage=None) -> dict:
    """The port's ONNX executor over ``layout`` on the CPU: through
    ``OnnxFunction`` (the outputs, ``_const_specs``, ``placement_report()``,
    each planned weight's bytes on this rank, the collectives), or with
    ``stage`` (the ``ONNXModel`` keyword arguments, its input column's
    rows as ``feeds``) the stage's output columns."""
    from synapseml_tpu_torch.core import Table
    from synapseml_tpu_torch.onnx import ONNXModel, OnnxFunction
    from synapseml_tpu_torch.runtime import collectives

    lay = _layout(state, layout)
    collectives.reset_counts()
    if stage is not None:
        st = ONNXModel(model_bytes=model, sharding_layout=lay, device="cpu", **stage)
        col = next(iter(stage["feed_dict"].values()))
        out = st.transform(Table({col: list(feeds)}))
        return {c: np.asarray(out[c]) for c in out.column_names if c != col}
    fn = OnnxFunction(model, dtype_policy=dtype_policy, layout=lay, device="cpu")
    res = fn(feeds)
    held = {n: int(np.asarray(fn.constants[n]).nbytes) if not isinstance(fn.constants[n],
                                                                          torch.Tensor)
            else fn.constants[n].numel() * fn.constants[n].element_size()
            for n in fn._const_specs}
    return {"outputs": {k: v.float().numpy() for k, v in res.items()},
            "specs": dict(fn._const_specs), "report": fn.placement_report(),
            "held_bytes": held, "at_rest_bytes": fn.at_rest_bytes(),
            "collectives": collectives.counts()}


CASES = {"fit": case_fit, "estimator": case_estimator, "vw_fit": case_vw_fit,
         "vw_estimator": case_vw_estimator, "attention": case_attention,
         "topology": case_topology, "layout_specs": case_layout_specs, "dryrun": case_dryrun,
         "onnx": case_onnx}
