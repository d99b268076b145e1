"""Sum and max all-reduces and an all-gather over a layout's axes, counted by kind.

The port's ``lax.psum`` / ``lax.pmax``: :func:`all_reduce` reduces a
tensor in place over the data axis, the model axis or both, through the
process groups of a :class:`~.layout.SpecLayout`; :func:`all_gather`
concatenates every rank's tensor of one axis's group in the order of the
ranks' coordinates (the fsdp storage axis's gather-on-use). The backend is the
process group's (NCCL on the card, gloo for the CPU tests and for two
ranks that share one card); a failed collective raises, and nothing picks
another backend. The call runs on the tensor's current stream, so on NCCL
nothing waits for the host.

``COUNTS`` counts the calls by kind, ``"<op>:<axes>"`` (``"sum:data"``,
``"max:data"``, ``"sum:data+model"``, ``"gather:fsdp"``), so a run can show how many
collectives a growth step made (:func:`reset_counts`, :func:`counts`).
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Tuple

import torch
import torch.distributed as dist

from .layout import SpecLayout

__all__ = ["all_reduce", "all_gather", "COUNTS", "reset_counts", "counts"]

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


def all_gather(t: torch.Tensor, layout: SpecLayout, axis: str = "fsdp") -> torch.Tensor:
    """Every rank of ``axis``'s group's ``t`` (the same shape on each),
    concatenated along dim 0 in the order of their coordinates on it."""
    group = layout.group((axis,))
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    COUNTS[f"gather:{axis}"] += 1
    return torch.cat(parts)


def reset_counts() -> None:
    COUNTS.clear()


def counts() -> Dict[str, int]:
    return dict(COUNTS)
