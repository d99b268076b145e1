"""The layout's collectives, counted by kind.

The port's ``lax.psum`` / ``lax.pmax`` / ``all_gather`` / ``all_to_all`` /
``ppermute``, through the process groups of a
:class:`~.layout.SpecLayout`, one axis (or every axis) at a time:

- :func:`all_reduce` reduces a tensor in place (sum or max) over the data
  axis, the model axis or both;
- :func:`all_gather` concatenates every rank's tensor of one axis's group
  along ``dim``, in the order of the ranks' coordinates (the fsdp storage
  axis's gather-on-use; a column-sharded product's columns over ``model``);
- :func:`all_to_all` splits a tensor along one dim over an axis's ranks and
  concatenates what it receives along another (``lax.all_to_all(...,
  tiled=True)``: Ulysses attention's re-shard);
- :func:`ring_shift` sends tensors to the next rank of an axis and receives
  the previous rank's (``lax.ppermute`` by +1: ring attention's K/V
  rotation). It returns at once with a handle; :meth:`Shift.wait` gives the
  received tensors, so the caller computes while the transfer runs. On NCCL
  the transfer runs on the process group's own stream, and ``wait`` only
  makes the caller's stream wait for it.

The backend is the process group's (NCCL on the card, gloo for the CPU tests
and for two ranks that share one card); a failed collective raises, and
nothing picks another backend. Gloo's send / recv take no CUDA tensor (on an
H100 machine with torch 2.11 a send of one failed, "writev: Bad address",
or ended the process: ``tools/gloo_cuda_probe.py``), so on a gloo group a
CUDA tensor of
:func:`ring_shift` is staged through host memory (copied to the host, sent
there, copied back): the same backend, a host transport (:func:`transport`
names the one a shift takes). Gloo's all-to-all, reductions and gathers take
CUDA tensors as they are. On NCCL every call runs on the tensor's current
stream, so nothing waits for the host.

``COUNTS`` counts the calls by kind, ``"<op>:<axes>"`` (``"sum:data"``,
``"max:data"``, ``"sum:data+model"``, ``"gather:fsdp"``, ``"gather:model"``,
``"all_to_all:data"``, ``"shift:data"``), so a run can show how many
collectives a step made (:func:`reset_counts`, :func:`counts`).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, Sequence, Tuple

import torch
import torch.distributed as dist

from .layout import SpecLayout

__all__ = ["all_reduce", "all_gather", "all_to_all", "ring_shift", "Shift", "transport",
           "COUNTS", "reset_counts", "counts"]

COUNTS: Counter = Counter()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce(t: torch.Tensor, layout: SpecLayout, op: str = "sum",
               axes: Tuple[str, ...] = ("data",)) -> torch.Tensor:
    """Reduce ``t`` in place over ``axes`` of ``layout`` (``op`` ``"sum"`` or
    ``"max"``) and return it. ``t`` must be contiguous."""
    if op not in _OPS:
        raise ValueError(f"op must be one of {sorted(_OPS)}, got {op!r}")
    if not t.is_contiguous():
        raise ValueError("all_reduce needs a contiguous tensor (it reduces in place)")
    dist.all_reduce(t, op=_OPS[op], group=layout.group(tuple(axes)))
    COUNTS[f"{op}:{'+'.join(axes)}"] += 1
    return t


def all_gather(t: torch.Tensor, layout: SpecLayout, axis: str = "fsdp",
               dim: int = 0) -> torch.Tensor:
    """Every rank of ``axis``'s group's ``t`` (the same shape on each),
    concatenated along ``dim`` in the order of their coordinates on it."""
    group = layout.group((axis,))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    COUNTS[f"gather:{axis}"] += 1
    return torch.cat(parts, dim=dim)


def transport(t: torch.Tensor, layout: SpecLayout, axis: str = "data") -> str:
    """How :func:`ring_shift` moves ``t`` over ``axis``: ``"device"`` (NCCL,
    or a CPU tensor on gloo) or ``"host"`` (a CUDA tensor on a gloo group,
    staged through host memory)."""
    backend = dist.get_backend(layout.group((axis,)))
    return "host" if (t.is_cuda and backend == "gloo") else "device"


def all_to_all(t: torch.Tensor, layout: SpecLayout, split_dim: int, concat_dim: int,
               axis: str = "data") -> torch.Tensor:
    """``t`` cut into n equal blocks along ``split_dim`` (n ranks on
    ``axis``), block j sent to the axis's rank j; the blocks received
    concatenated along ``concat_dim`` in the senders' order."""
    group = layout.group((axis,))
    n = dist.get_world_size(group)
    split_dim, concat_dim = split_dim % t.dim(), concat_dim % t.dim()
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)} does not split "
                         f"over {n} ranks")
    x = t.movedim(split_dim, 0).contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    COUNTS[f"all_to_all:{axis}"] += 1
    rest = list(x.shape[1:])
    c = x.shape[0] // n
    pos = concat_dim if concat_dim < split_dim else concat_dim - 1   # in rest
    y = out.reshape(n, c, *rest).movedim(0, pos + 1)   # (c, rest[:pos], n, rest[pos:])
    shape = [c] + rest
    shape[pos + 1] *= n
    return y.reshape(shape).movedim(0, split_dim)


class Shift:
    """A ring shift in flight (:func:`ring_shift`)."""

    def __init__(self, works, received: List[torch.Tensor], device: torch.device, keep):
        # ``keep``: the send buffers, alive until the transfer ends
        self._works, self._received, self._device, self._keep = works, received, device, keep

    def wait(self) -> Tuple[torch.Tensor, ...]:
        """The previous rank's tensors, on the senders' device."""
        for w in self._works:
            w.wait()
        return tuple(r.to(self._device) for r in self._received)


def ring_shift(tensors: Sequence[torch.Tensor], layout: SpecLayout,
               axis: str = "data") -> Shift:
    """Send ``tensors`` to the next rank of ``axis`` (coordinate + 1, mod n)
    and receive the previous rank's, without waiting (:class:`Shift`)."""
    group = layout.group((axis,))
    ranks = dist.get_process_group_ranks(group)
    n = len(ranks)
    me = ranks.index(dist.get_rank())
    nxt, prv = ranks[(me + 1) % n], ranks[(me - 1) % n]
    dev = tensors[0].device
    staged = transport(tensors[0], layout, axis) == "host"
    ops, received, sent = [], [], []
    for t in tensors:
        src = t.detach().cpu() if staged else t.contiguous()
        buf = torch.empty_like(src)
        ops += [dist.P2POp(dist.isend, src, nxt, group), dist.P2POp(dist.irecv, buf, prv, group)]
        received.append(buf)
        sent.append(src)
    works = dist.batch_isend_irecv(ops)
    COUNTS[f"shift:{axis}"] += 1
    return Shift(works, received, dev, sent)


def reset_counts() -> None:
    COUNTS.clear()


def counts() -> Dict[str, int]:
    return dict(COUNTS)
