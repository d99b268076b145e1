"""The port's named mesh: rows over ``data``, feature blocks over ``model``,
parameter storage over ``fsdp``.

Port of ``synapseml_tpu/runtime/layout.py``'s mesh (``SpecLayout``,
``:53-200``, ``feature_blocks`` ``:234`` and ``as_layout`` ``:451``) over a
``torch.distributed`` :class:`DeviceMesh`. A layout is built by every rank
of an initialised process group, in the same order (``init_device_mesh`` is
collective): ``SpecLayout.build(data=4, model=2)`` is a (4, 2) mesh named
``("data", "model")``; ``model`` unset leaves the model axis at 1. With
``fsdp=f`` a third axis sits between them, a (data, fsdp, model) mesh, over
which an engine stores its parameters row-sharded between uses and
all-gathers them at the point of use (``collectives.all_gather``; the VW
learner's state): rows still shard over ``data`` only (the reference's
``batch()``, ``:203-211``), so the ranks of one fsdp group see the same
rows. The mesh spans the whole world in row-major order of its axes (rank
``r`` at ``(r // model, r % model)`` on a 2-D mesh). It is built on
``"cuda"`` by default and on ``"cpu"`` when asked (the tests' gloo worlds).
A raw 1-D ``DeviceMesh`` (:func:`as_layout`) is data-parallel only.

There is no silent mesh of one: with no process group initialised,
:meth:`SpecLayout.build` and :func:`as_layout` raise
:class:`MeshUnavailableError`.

The reference layout's parameter specs (``:203-369``) are here as plain
tuples, one entry a dim, each ``None``, an axis name or a tuple of axis
names (the dim split over them jointly, the first the major one), entry for
entry the reference's ``PartitionSpec``: :meth:`batch`, :meth:`replicated`,
:meth:`col_weight`, :meth:`conv_weight`, :meth:`fsdp_weight`,
:meth:`embed_weight`, :meth:`use_spec`. A spec places a tensor by
:meth:`shard` (this rank's block of the global tensor) and
:meth:`gather_for_use` (the all-gather over ``fsdp`` at the point of use
that turns a stored block into the use spec's block); :meth:`state_dict` /
:meth:`from_state_dict` save and rebuild the mesh's shape. The reference's
``feature_blocks()`` spec is not kept: :meth:`feature_blocks` here gives the
model axis's column blocks, which the GBDT engine uses.
"""

from __future__ import annotations

import logging
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["SpecLayout", "as_layout", "MeshUnavailableError", "require_process_group"]

_UNSET = object()


class MeshUnavailableError(RuntimeError):
    """A mesh was asked for and no ``torch.distributed`` process group is
    initialised."""


def require_process_group() -> None:
    """Raise :class:`MeshUnavailableError` unless a process group is
    initialised (``torch.distributed.init_process_group``)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise MeshUnavailableError(
            "no torch.distributed process group is initialised: call "
            "torch.distributed.init_process_group(backend, init_method=..., "
            "world_size=..., rank=...) on every rank before building a mesh")


class SpecLayout:
    """A named :class:`DeviceMesh` and this rank's place in it.

    ``data_axis`` names the row axis; ``model_axis`` the feature axis, or
    None for a 1-D mesh (data-parallel only); ``fsdp_axis`` the storage
    axis, or None (a 2-D or 1-D mesh). Groups are the mesh's own:
    :meth:`group` gives the process group over one axis or over several."""

    def __init__(self, mesh, data_axis: str = "data", model_axis: Optional[str] = "model",
                 fsdp_axis: Optional[str] = None):
        names = tuple(mesh.mesh_dim_names or ())
        if data_axis not in names:
            raise ValueError(f"mesh axes {names} have no {data_axis!r} axis")
        if model_axis is not None and model_axis not in names:
            raise ValueError(f"mesh axes {names} have no {model_axis!r} axis")
        if fsdp_axis is not None and fsdp_axis not in names:
            raise ValueError(f"mesh axes {names} have no {fsdp_axis!r} axis")
        if mesh.size() != dist.get_world_size():
            raise ValueError(f"the mesh holds {mesh.size()} ranks, the process group "
                             f"{dist.get_world_size()}: a layout spans the whole world")
        self.mesh = mesh
        self.data_axis = data_axis
        self.model_axis = model_axis
        self.fsdp_axis = fsdp_axis
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
        self._coord = dict(zip(names, (int(c) for c in coord)))

    # -- constructors ------------------------------------------------------------------

    @classmethod
    def build(cls, data: Optional[int] = None, model: Optional[int] = None, *,
              fsdp: Optional[int] = None, device_type: str = "cuda") -> "SpecLayout":
        """A (data, model) mesh over every rank of the process group, or with
        ``fsdp`` a (data, fsdp, model) one.

        ``model=m`` puts ``m`` ranks on the model axis and the rest on data
        (``world // (m * fsdp)``); ``data`` alone leaves the model axis at
        1; neither: every rank not on fsdp on data. ``data * fsdp * model``
        must be the world size; ``fsdp`` unset keeps the 2-D mesh."""
        from torch.distributed.device_mesh import init_device_mesh

        require_process_group()
        world = dist.get_world_size()
        f2 = int(fsdp) if fsdp else 1
        if f2 < 1 or world % f2:
            raise ValueError(f"fsdp axis size {fsdp} must divide the world size {world}")
        if model is None:
            d2, m2 = (int(data) if data else world // f2), 1
        elif data is None:
            m2 = int(model)
            if m2 < 1 or world % (m2 * f2):
                raise ValueError(f"model x fsdp axis sizes {model} x {f2} must divide the "
                                 f"world size {world}")
            d2 = world // (m2 * f2)
        else:
            d2, m2 = int(data), int(model)
        if min(d2, m2) < 1 or d2 * f2 * m2 != world:
            shape = (d2, f2, m2) if fsdp else (d2, m2)
            raise ValueError(f"mesh shape {shape} holds {d2 * f2 * m2} ranks; the process "
                             f"group has {world}")
        if fsdp:
            return cls(init_device_mesh(device_type, (d2, f2, m2),
                                        mesh_dim_names=("data", "fsdp", "model")),
                       fsdp_axis="fsdp")
        return cls(init_device_mesh(device_type, (d2, m2), mesh_dim_names=("data", "model")))

    @classmethod
    def from_mesh(cls, mesh, data_axis: Optional[str] = None,
                  model_axis=_UNSET) -> "SpecLayout":
        """Wrap a :class:`DeviceMesh`. ``data_axis`` defaults to ``"data"``
        when the mesh has it, else its first axis; ``model_axis`` to
        ``"model"`` when present (else None: a 1-D mesh is data-only)."""
        require_process_group()
        names = tuple(mesh.mesh_dim_names or ())
        if not names:
            raise ValueError("the DeviceMesh needs mesh_dim_names (e.g. ('data',))")
        if data_axis is None:
            data_axis = "data" if "data" in names else names[0]
        if model_axis is _UNSET:
            model_axis = "model" if ("model" in names and data_axis != "model") else None
        fsdp_axis = "fsdp" if ("fsdp" in names and "fsdp" not in (data_axis, model_axis)) \
            else None
        return cls(mesh, data_axis, model_axis, fsdp_axis)

    # -- sizes and coordinates ---------------------------------------------------------

    @property
    def device_type(self) -> str:
        return self.mesh.device_type

    def _size(self, axis: str) -> int:
        return int(self.mesh.size(self.mesh.mesh_dim_names.index(axis)))

    @property
    def data_size(self) -> int:
        return self._size(self.data_axis)

    @property
    def model_size(self) -> int:
        return 1 if self.model_axis is None else self._size(self.model_axis)

    @property
    def fsdp_size(self) -> int:
        return 1 if self.fsdp_axis is None else self._size(self.fsdp_axis)

    @property
    def data_rank(self) -> int:
        """This rank's coordinate on the data axis (its row block)."""
        return self._coord[self.data_axis]

    @property
    def model_rank(self) -> int:
        """This rank's coordinate on the model axis (its feature block)."""
        return 0 if self.model_axis is None else self._coord[self.model_axis]

    @property
    def fsdp_rank(self) -> int:
        """This rank's coordinate on the fsdp axis (its slice of a stored
        parameter)."""
        return 0 if self.fsdp_axis is None else self._coord[self.fsdp_axis]

    @property
    def coordinate(self) -> Tuple[int, int]:
        return self.data_rank, self.model_rank

    def describe(self) -> dict:
        out = {self.data_axis: self.data_size}
        if self.fsdp_axis is not None:
            out[self.fsdp_axis] = self.fsdp_size
        if self.model_axis is not None:
            out[self.model_axis] = self.model_size
        return out

    # -- groups -----------------------------------------------------------------------

    def group(self, axes: Tuple[str, ...] = ("data",)):
        """The process group over ``axes``: ``("data",)``, ``("model",)``,
        ``("fsdp",)``, or every axis of the mesh (the world; data and model
        together on a mesh whose fsdp axis is 1 or absent)."""
        axes = tuple(axes)
        if len(axes) == 1:
            name = {"data": self.data_axis, "model": self.model_axis,
                    "fsdp": self.fsdp_axis}.get(axes[0])
            if name is None:
                raise ValueError(f"this layout has no {axes[0]!r} axis")
            return self.mesh.get_group(name)
        if set(axes) in ({"data", "model"}, {"data", "fsdp", "model"}):
            if "fsdp" not in axes and self.fsdp_size > 1:
                raise ValueError("data and model together are not the world on a layout "
                                 "with an fsdp axis over more than one rank")
            return dist.group.WORLD
        raise ValueError(f"axes must be one axis or every axis, got {axes}")

    # -- feature blocks ----------------------------------------------------------------

    def feature_blocks(self, d: int) -> List[Tuple[int, int]]:
        """The model axis's (start, stop) column blocks of ``d`` features
        (the reference's ``ceil(d / m)`` blocks; the last may be short or
        empty)."""
        m = self.model_size
        blk = -(-int(d) // m)
        return [(min(j * blk, d), min((j + 1) * blk, d)) for j in range(m)]

    def feature_block(self, d: int) -> Tuple[int, int]:
        """This rank's (start, stop) column block of ``d`` features."""
        return self.feature_blocks(d)[self.model_rank]

    def __repr__(self) -> str:
        return (f"SpecLayout({self.describe()}, device_type={self.device_type!r}, "
                f"coordinate={self.coordinate})")

    def _key(self):
        return (self.device_type, tuple(self.mesh.mesh_dim_names), self.mesh.mesh.tolist(),
                self.data_axis, self.model_axis, self.fsdp_axis)

    def __eq__(self, other) -> bool:
        return isinstance(other, SpecLayout) and self._key() == other._key()

    def __hash__(self) -> int:
        return hash(repr(self._key()))

    @property
    def n_devices(self) -> int:
        return self.data_size * self.fsdp_size * self.model_size

    # -- parameter specs (the reference's PartitionSpecs, as tuples) ----------------

    def batch(self, rank: int = 1, dim: int = 0) -> tuple:
        """Rows over ``data`` at ``dim`` of a rank-``rank`` tensor."""
        axes: list = [None] * rank
        axes[dim] = self.data_axis
        return tuple(axes)

    def replicated(self) -> tuple:
        return ()

    def col_weight(self, rank: int = 2, dim: Optional[int] = None) -> tuple:
        """A column-sharded weight: the output-feature dim (default the
        last) over ``model``; replicated on a layout without a model axis."""
        axes: list = [None] * rank
        if self.model_axis is not None:
            axes[rank - 1 if dim is None else dim] = self.model_axis
        return tuple(axes)

    def conv_weight(self, rank: int = 4) -> tuple:
        """A convolution kernel (OIHW): output channels over ``model``."""
        return self.col_weight(rank=rank, dim=0)

    def fsdp_weight(self, rank: int = 1, dim: int = 0, use_spec=None) -> tuple:
        """The STORAGE spec of a parameter row-sharded over ``fsdp`` at
        ``dim``, stacked on ``use_spec`` (default replicated): a dim already
        over ``model`` stores over ``(fsdp, model)``. ``use_spec`` itself on a
        layout without an fsdp axis."""
        base: list = list(use_spec) if use_spec is not None else []
        base += [None] * (rank - len(base))
        if self.fsdp_axis is not None:
            cur = base[dim]
            if cur is None:
                base[dim] = self.fsdp_axis
            elif isinstance(cur, tuple):
                base[dim] = (self.fsdp_axis,) + cur
            else:
                base[dim] = (self.fsdp_axis, cur)
        return tuple(base)

    def embed_weight(self, rank: int = 2) -> tuple:
        """An embedding table's storage: rows over ``fsdp x model`` jointly."""
        row = tuple(a for a in (self.fsdp_axis, self.model_axis) if a is not None)
        axes: list = [None] * rank
        if row:
            axes[0] = row if len(row) > 1 else row[0]
        return tuple(axes)

    def use_spec(self, stored_spec) -> tuple:
        """The point-of-use spec of a stored-over-fsdp tensor: the storage spec
        with the fsdp axis stripped."""
        if self.fsdp_axis is None:
            return tuple(stored_spec)

        def strip(entry):
            if entry == self.fsdp_axis:
                return None
            if isinstance(entry, tuple):
                kept = tuple(a for a in entry if a != self.fsdp_axis)
                return kept if len(kept) > 1 else (kept[0] if kept else None)
            return entry

        return tuple(strip(e) for e in stored_spec)

    # -- placement -------------------------------------------------------------------

    def _axes_of(self, entry) -> Tuple[str, ...]:
        return () if entry is None else (entry if isinstance(entry, tuple) else (entry,))

    def _role(self, name: str) -> str:
        return {self.data_axis: "data", self.model_axis: "model",
                self.fsdp_axis: "fsdp"}[name]

    def _block(self, t: torch.Tensor, dim: int, entry) -> torch.Tensor:
        """This rank's block of ``t`` along ``dim`` under one spec entry."""
        axes = self._axes_of(entry)
        if not axes:
            return t
        n, idx = 1, 0
        for a in axes:   # row-major over the axes, the first the major one
            size = self._size(a)
            idx, n = idx * size + self._coord[a], n * size
        if t.shape[dim] % n:
            raise ValueError(f"dim {dim} of size {t.shape[dim]} does not split over {axes} "
                             f"({n} blocks)")
        blk = t.shape[dim] // n
        return t.narrow(dim, idx * blk, blk)

    def shard(self, t: torch.Tensor, spec) -> torch.Tensor:
        """This rank's block of the global tensor ``t`` under ``spec`` (a
        view; every sharded dim must split evenly)."""
        spec = tuple(spec)
        if len(spec) > t.dim():
            raise ValueError(f"spec {spec} has more entries than {t.dim()} dims")
        for d, entry in enumerate(spec):
            t = self._block(t, d, entry)
        return t

    def gather_for_use(self, t: torch.Tensor, stored_spec) -> torch.Tensor:
        """This rank's stored block ``t`` -> its block under
        :meth:`use_spec` (a new tensor; the stored block stays as it is):
        all-gathered over ``fsdp`` along each dim the fsdp axis shards. A dim
        stored over ``(fsdp, model)`` is gathered over both, then cut to its
        ``model`` block. ``t`` itself on a layout without an fsdp axis."""
        from .collectives import all_gather

        if self.fsdp_axis is None:
            return t
        use = self.use_spec(stored_spec)
        for d, entry in enumerate(tuple(stored_spec)):
            if entry == use[d]:
                continue
            axes = self._axes_of(entry)
            for a in reversed(axes):   # innermost first: each gather a whole super-block
                t = all_gather(t, self, self._role(a), dim=d)
            t = self._block(t, d, use[d])
        return t

    # -- persistence -----------------------------------------------------------------

    def state_dict(self) -> dict:
        """Axis names and sizes (a mesh is bound to live ranks; the loading
        world rebuilds it). The fsdp keys only for a layout with an fsdp axis."""
        out = {"data_axis": self.data_axis, "model_axis": self.model_axis or "",
               "data": self.data_size, "model": self.model_size}
        if self.fsdp_axis is not None:
            out["fsdp_axis"] = self.fsdp_axis
            out["fsdp"] = self.fsdp_size
        return out

    @staticmethod
    def from_state_dict(d: dict, device_type: Optional[str] = None) -> "SpecLayout":
        """Rebuild a saved layout over this world (collective: every rank
        calls it). A layout never changes results, so a saved shape larger
        than the world degrades to what fits, collapsing ``fsdp`` first, then
        ``model``, then ``data`` (with a warning, as the reference); a smaller
        one puts the ranks left over on ``data``. ``device_type`` defaults to
        ``"cuda"`` with a card, else ``"cpu"``."""
        require_process_group()
        if device_type is None:
            device_type = "cuda" if torch.cuda.is_available() else "cpu"
        n = dist.get_world_size()
        data_axis = str(d["data_axis"])
        model_axis = str(d.get("model_axis") or "") or None
        fsdp_axis = str(d.get("fsdp_axis") or "") or None
        want_data, want_model = int(d["data"]), int(d.get("model", 1))
        want_fsdp = int(d.get("fsdp", 1)) if fsdp_axis else 1
        if model_axis is None:
            from torch.distributed.device_mesh import init_device_mesh

            return SpecLayout(init_device_mesh(device_type, (n,),
                                               mesh_dim_names=(data_axis,)),
                              data_axis=data_axis, model_axis=None)
        if want_data * want_fsdp * want_model > n:
            saved = f"{data_axis}={want_data}"
            if fsdp_axis:
                saved += f", {fsdp_axis}={want_fsdp}"
            saved += f", {model_axis}={want_model}"
            logging.getLogger("synapseml_tpu_torch.layout").warning(
                "saved layout (%s) needs %d ranks, have %d; degrading", saved,
                want_data * want_fsdp * want_model, n)
            want_model = max(1, min(want_model, n))
            while n % want_model:
                want_model -= 1
            want_fsdp = max(1, min(want_fsdp, n // want_model))
            while (n // want_model) % want_fsdp:
                want_fsdp -= 1
        want_data = n // (want_fsdp * want_model)
        if want_fsdp * want_model * want_data != n:
            raise ValueError(f"saved layout's model x fsdp {want_model} x {want_fsdp} does "
                             f"not divide the world of {n} ranks")
        if fsdp_axis and want_fsdp > 1:
            return SpecLayout.build(data=want_data, model=want_model, fsdp=want_fsdp,
                                    device_type=device_type)
        return SpecLayout.build(data=want_data, model=want_model, device_type=device_type)


def as_layout(mesh_or_layout, data_axis: str = "data") -> SpecLayout:
    """A layout from an engine's ``mesh=`` argument: a :class:`SpecLayout`
    as it is, or a raw :class:`DeviceMesh` (``data_axis`` is honoured when
    the mesh has it; a 1-D mesh is data-only)."""
    if isinstance(mesh_or_layout, SpecLayout):
        return mesh_or_layout
    require_process_group()
    names = tuple(getattr(mesh_or_layout, "mesh_dim_names", None) or ())
    return SpecLayout.from_mesh(mesh_or_layout,
                                data_axis=data_axis if data_axis in names else None)
