"""The port's named mesh: rows over ``data``, feature blocks over ``model``.

Port of the GBDT half of ``synapseml_tpu/runtime/layout.py``
(``SpecLayout``, ``:53-200``, ``feature_blocks`` ``:234`` and ``as_layout``
``:451``) over a ``torch.distributed`` :class:`DeviceMesh`. A layout is
built by every rank of an initialised process group, in the same order
(``init_device_mesh`` is collective): ``SpecLayout.build(data=4, model=2)``
is a (4, 2) mesh named ``("data", "model")``; ``model`` unset leaves the
model axis at 1. The mesh spans the whole world, rank ``r`` at coordinate
``(r // model, r % model)``. It is built on ``"cuda"`` by default and on
``"cpu"`` when asked (the tests' gloo worlds). A raw 1-D ``DeviceMesh``
(:func:`as_layout`) is data-parallel only.

There is no silent mesh of one: with no process group initialised,
:meth:`SpecLayout.build` and :func:`as_layout` raise
:class:`MeshUnavailableError`. The parameter specs of the JAX package's
layout (``fsdp``, ``col_weight``, ``batch``) have no counterpart here.
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
    None for a 1-D mesh (data-parallel only). Groups are the mesh's own:
    :meth:`group` gives the process group over one axis or over both."""

    def __init__(self, mesh, data_axis: str = "data", model_axis: Optional[str] = "model"):
        names = tuple(mesh.mesh_dim_names or ())
        if data_axis not in names:
            raise ValueError(f"mesh axes {names} have no {data_axis!r} axis")
        if model_axis is not None and model_axis not in names:
            raise ValueError(f"mesh axes {names} have no {model_axis!r} axis")
        if mesh.size() != dist.get_world_size():
            raise ValueError(f"the mesh holds {mesh.size()} ranks, the process group "
                             f"{dist.get_world_size()}: a layout spans the whole world")
        self.mesh = mesh
        self.data_axis = data_axis
        self.model_axis = model_axis
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError(f"rank {dist.get_rank()} is not in the mesh")
        self._coord = dict(zip(names, (int(c) for c in coord)))

    # -- constructors ------------------------------------------------------------------

    @classmethod
    def build(cls, data: Optional[int] = None, model: Optional[int] = None, *,
              device_type: str = "cuda") -> "SpecLayout":
        """A (data, model) mesh over every rank of the process group.

        ``model=m`` puts ``m`` ranks on the model axis and the rest on data
        (``world // m``); ``data`` alone leaves the model axis at 1;
        neither: every rank on data. ``data * model`` must be the world
        size."""
        from torch.distributed.device_mesh import init_device_mesh

        require_process_group()
        world = dist.get_world_size()
        if model is None:
            d2, m2 = (int(data) if data else world), 1
        elif data is None:
            m2 = int(model)
            if m2 < 1 or world % m2:
                raise ValueError(f"model axis size {model} must divide the world size {world}")
            d2 = world // m2
        else:
            d2, m2 = int(data), int(model)
        if min(d2, m2) < 1 or d2 * m2 != world:
            raise ValueError(f"mesh shape ({d2}, {m2}) holds {d2 * m2} ranks; the process "
                             f"group has {world}")
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
        return cls(mesh, data_axis, model_axis)

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
    def data_rank(self) -> int:
        """This rank's coordinate on the data axis (its row block)."""
        return self._coord[self.data_axis]

    @property
    def model_rank(self) -> int:
        """This rank's coordinate on the model axis (its feature block)."""
        return 0 if self.model_axis is None else self._coord[self.model_axis]

    @property
    def coordinate(self) -> Tuple[int, int]:
        return self.data_rank, self.model_rank

    def describe(self) -> dict:
        out = {self.data_axis: self.data_size}
        if self.model_axis is not None:
            out[self.model_axis] = self.model_size
        return out

    # -- groups -----------------------------------------------------------------------

    def group(self, axes: Tuple[str, ...] = ("data",)):
        """The process group over ``axes``: ``("data",)``, ``("model",)`` or
        both (the whole mesh, which is the world)."""
        axes = tuple(axes)
        if axes == ("data",):
            return self.mesh.get_group(self.data_axis)
        if axes == ("model",):
            if self.model_axis is None:
                raise ValueError("a 1-D layout has no model axis")
            return self.mesh.get_group(self.model_axis)
        if set(axes) == {"data", "model"}:
            return dist.group.WORLD
        raise ValueError(f"axes must be ('data',), ('model',) or both, got {axes}")

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
