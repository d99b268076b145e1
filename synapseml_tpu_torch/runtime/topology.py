"""Device and host topology: the port's ``runtime/topology.py``.

Port of ``synapseml_tpu/runtime/topology.py`` over ``torch.distributed``
and CUDA. :func:`cluster_info` snapshots the world (its size, the local
CUDA devices, the hosts, this rank, the platform ``"gpu"`` or ``"cpu"``,
the device names); :func:`require_backend` refuses the CPU loudly, with a
diagnostic naming what was found; :func:`best_mesh_shape` is the
reference's (numpy only); :func:`make_mesh` builds a named
:class:`DeviceMesh` over the world; :func:`initialize_distributed` is the
multi-host rendezvous, ``torch.distributed.init_process_group`` under
:func:`~..core.fault.retry_with_backoff`, and does nothing on one host
without a coordinator.

Nothing on a machine tells a program of its cluster: the coordinator's
address, the world size and the rank are given (or read from the
``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` variables that
``torchrun`` sets). The reference's ``is_tpu`` and ``shard_map_compat``
have no counterpart: there is no TPU here, and the port's collectives are
explicit calls over a :class:`~.layout.SpecLayout`, not a ``shard_map``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import socket
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["ClusterInfo", "cluster_info", "device_kind", "require_backend", "best_mesh_shape",
           "make_mesh", "initialize_distributed"]

_logger = logging.getLogger("synapseml_tpu_torch.topology")


@dataclasses.dataclass(frozen=True)
class ClusterInfo:
    """A snapshot of the world: ``num_devices`` ranks (one device a rank),
    ``local_num_devices`` CUDA devices this host sees (0 without a card),
    ``num_hosts`` hosts, this host's ``host_index``, ``platform`` ``"gpu"``
    or ``"cpu"``, and the device names."""

    num_devices: int
    local_num_devices: int
    num_hosts: int
    host_index: int
    platform: str
    device_kinds: Tuple[str, ...]
    rank: int = 0

    @property
    def devices_per_host(self) -> int:
        return self.local_num_devices


def _hosts() -> Tuple[int, int]:
    """(hosts, this host's index) of the world: the distinct host names of
    the ranks, gathered once (one host without a process group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    names: List[Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(names, socket.gethostname())
    order = sorted(set(names))
    return len(order), order.index(socket.gethostname())


def cluster_info() -> ClusterInfo:
    """The world's :class:`ClusterInfo`. With a process group initialised it
    is collective (the ranks' host names are gathered): every rank calls it."""
    gpu = torch.cuda.is_available()
    local = torch.cuda.device_count() if gpu else 0
    kinds = tuple(sorted({torch.cuda.get_device_name(i) for i in range(local)})) if gpu \
        else ("cpu",)
    ranked = dist.is_available() and dist.is_initialized()
    hosts, host = _hosts()
    return ClusterInfo(
        num_devices=dist.get_world_size() if ranked else max(local, 1),
        local_num_devices=local, num_hosts=hosts, host_index=host,
        platform="gpu" if gpu else "cpu", device_kinds=kinds,
        rank=dist.get_rank() if ranked else 0)


def device_kind() -> str:
    """The name of the first CUDA device (``"cpu"`` without one)."""
    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"


def require_backend(want: Optional[str] = None, *, allow_cpu: bool = False) -> ClusterInfo:
    """Refuse to run on the CPU, loudly: a missing or hidden card raises with
    a diagnostic naming what was found and what selects the device, instead
    of measuring the wrong machine. ``want`` pins a platform (``"gpu"``);
    ``allow_cpu=True`` passes through (the explicit opt-in: tests, laptops).
    Returns the :class:`ClusterInfo`."""
    info = cluster_info()
    if allow_cpu:
        return info
    plat = info.platform
    if plat == "cpu" or (want is not None and plat != want):
        wanted = want or "an accelerator (gpu)"
        raise RuntimeError(
            f"resolved torch device platform is {plat!r} "
            f"(kinds={list(info.device_kinds)}, devices={info.num_devices}) but {wanted} is "
            f"required.\n"
            f"  CUDA_VISIBLE_DEVICES={os.environ.get('CUDA_VISIBLE_DEVICES', '<unset>')}\n"
            f"  torch {torch.__version__}, built for CUDA {torch.version.cuda}\n"
            f"likely causes: no card in this machine, a CPU-only torch build, or "
            f"CUDA_VISIBLE_DEVICES hiding the card. Probe with `nvidia-smi` and "
            f"`python -c 'import torch; print(torch.cuda.is_available())'`; pass "
            f"allow_cpu=True only to deliberately run on the host.")
    return info


def best_mesh_shape(n_devices: int, n_axes: int) -> Tuple[int, ...]:
    """Factor ``n_devices`` into ``n_axes`` balanced axes, sorted largest
    first: prime factors, largest first, each to the axis of the smallest
    product so far (12 over 3 axes -> (3, 2, 2), 8 over 3 -> (2, 2, 2))."""
    factors: List[int] = []
    rem = n_devices
    d = 2
    while d * d <= rem:
        while rem % d == 0:
            factors.append(d)
            rem //= d
        d += 1
    if rem > 1:
        factors.append(rem)
    shape = [1] * n_axes
    for f in sorted(factors, reverse=True):
        shape[int(np.argmin(shape))] *= f
    return tuple(sorted(shape, reverse=True))


def make_mesh(axis_names: Sequence[str] = ("data",), shape: Optional[Sequence[int]] = None,
              device_type: str = "cuda"):
    """A named :class:`DeviceMesh` over the world (an initialised process
    group; :class:`~.layout.MeshUnavailableError` without one). ``shape=None``
    puts every rank on the first axis and 1 on the rest; a shape larger
    than the world raises ``ValueError``."""
    from torch.distributed.device_mesh import init_device_mesh

    from .layout import require_process_group

    axis_names = tuple(axis_names)
    if shape is not None:
        shape = tuple(int(s) for s in shape)
        world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
        if int(np.prod(shape)) > world:
            raise ValueError(f"mesh shape {shape} needs {int(np.prod(shape))} devices, have "
                             f"{world}")
    require_process_group()
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} holds {int(np.prod(shape))} ranks; the process "
                         f"group has {world} (a mesh spans the whole world)")
    return init_device_mesh(device_type, shape, mesh_dim_names=axis_names)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, retries: int = 5,
                           backend: Optional[str] = None) -> None:
    """Multi-host rendezvous: ``torch.distributed.init_process_group`` at
    ``tcp://<coordinator_address>`` with the world size and rank given,
    retried with exponential backoff. Does nothing on one host without a
    coordinator (neither ``coordinator_address`` nor ``MASTER_ADDR``) and at
    most one process. ``backend`` defaults to NCCL with a card, gloo
    without."""
    from ..core.fault import retry_with_backoff

    if coordinator_address is None and "MASTER_ADDR" not in os.environ:
        if num_processes in (None, 1):
            _logger.debug("single host: skipping torch.distributed.init_process_group")
            return
    if coordinator_address is None:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    world = int(num_processes if num_processes is not None else os.environ["WORLD_SIZE"])
    rank = int(process_id if process_id is not None else os.environ["RANK"])
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"

    def _init():
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=world, rank=rank)

    retry_with_backoff(_init, retries=retries, initial_delay_s=1.0, max_delay_s=30.0,
                       sleep=lambda s: time.sleep(s))
