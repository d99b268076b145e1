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
:class:`MeshUnavailableError`. The parameter specs of the JAX package's
layout (``col_weight``, ``batch``, ``fsdp_weight``) have no counterpart
here: placement is the engine's own.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

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
