"""Ring and Ulysses (all-to-all) sequence-parallel attention.

Port of ``synapseml_tpu/parallel/ring.py`` over a ``torch.distributed``
mesh: the sequence is sharded over a :class:`SpecLayout`'s data axis (a raw
1-D ``DeviceMesh`` works too, through :func:`as_layout`), and the
collectives are the layout's (:mod:`..runtime.collectives`). Every
function runs on every rank of the process group. Tensors are (batch, seq,
heads, head_dim).

- :func:`ring_attention`: each rank keeps its query block and passes K/V
  blocks around the ring (:func:`~..runtime.collectives.ring_shift`, the
  next block in flight while this one is scored). Each block is scored by
  kernel C (:func:`~.flash.flash_attention` with ``return_lse``), which
  returns the block's output and each row's log-sum-exp; the blocks are
  merged into a running f32 (output, log-sum-exp) by the standard
  log-sum-exp rule. Grouped (GQA) K/V heads ride the ring and reach the
  kernel as they are (it maps query heads to their group), never expanded.
  Causal: the rank at coordinate ``my`` holds queries ``[my*s, (my+1)*s)``;
  a block from a rank before it is scored unmasked, its own block causal
  (the kernel's end-aligned diagonal is the start-aligned one when the two
  blocks have one length), and a block from a rank after it is skipped (the
  reference masks it to zero weight). Peak memory a rank is one K/V block.
- :func:`ulysses_attention`: an all-to-all re-shards the sequence-sharded
  blocks into head-sharded full sequences, local attention runs per head
  group, and a second all-to-all re-shards back. Heads that do not divide
  the axis are zero-padded through the collectives; GQA re-shards the
  grouped heads when both head counts divide the axis, else expands first.
  ``local="flash"`` scores the gathered sequence with kernel C (grouped K/V
  as they are), ``"dense"`` with the plain attention
  (:func:`~.flash.dense_attention`).
- :func:`sequence_sharded_attention`: the entry over GLOBAL (B, S, H, D)
  tensors given on every rank; each rank takes its sequence block, and the
  output is all-gathered over the axis, so every rank returns the global
  output.

The reference's ``interpret``, ``block_q`` and ``block_k`` knobs and its
dense fallback for sub-tile flash blocks are TPU-only and are gone: kernel
C takes any sequence length (``flash.py``), so ``local="flash"`` always
runs the kernel. The results are the reference's.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..runtime import collectives
from ..runtime.layout import SpecLayout, as_layout
from . import flash

__all__ = ["ring_attention", "ulysses_attention", "sequence_sharded_attention",
           "merge_lse"]


def _check_groups(h: int, h_kv: int) -> None:
    if h % h_kv:
        raise ValueError(f"query heads {h} must be a multiple of kv heads "
                         f"{h_kv} (GQA groups)")


def _expand_gqa(q, k, v):
    """Grouped-query attention: each K/V head repeated over its query-head
    group; unchanged when the head counts match."""
    h, h_kv = q.shape[2], k.shape[2]
    if h_kv == h:
        return k, v
    _check_groups(h, h_kv)
    rep = h // h_kv
    return k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)


def merge_lse(out: torch.Tensor, lse: torch.Tensor, out_i: torch.Tensor,
              lse_i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two attentions of the same queries over disjoint key sets, as one:
    ``out`` f32 (B, S, H, D) and ``lse`` (B, H, S) the running pair, ``out_i``
    / ``lse_i`` a block's (``out_i`` in any float dtype). Returns the merged
    f32 pair."""
    new = torch.logaddexp(lse, lse_i)
    w = torch.exp(lse - new).transpose(1, 2).unsqueeze(-1)
    w_i = torch.exp(lse_i - new).transpose(1, 2).unsqueeze(-1)
    return out * w + out_i.float() * w_i, new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, layout,
                   causal: bool = False) -> torch.Tensor:
    """Ring attention over this rank's local blocks (B, s_local, H, D) of a
    sequence sharded over the layout's data axis (K/V may carry fewer,
    grouped heads); returns the local output block in ``q``'s dtype."""
    layout = as_layout(layout)
    _check_groups(q.shape[2], k.shape[2])
    n, my = layout.data_size, layout.data_rank
    out = lse = None
    k_blk, v_blk = k, v
    for i in range(n):
        src = (my - i) % n
        shift = collectives.ring_shift((k_blk, v_blk), layout) if i < n - 1 else None
        if not (causal and src > my):
            o_i, lse_i = flash.flash_attention(q, k_blk, v_blk, causal=causal and src == my,
                                               return_lse=True)
            if out is None:
                out, lse = o_i.float(), lse_i
            else:
                out, lse = merge_lse(out, lse, o_i, lse_i)
        if shift is not None:
            k_blk, v_blk = shift.wait()
    return out.to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, layout,
                      causal: bool = False, local: str = "dense") -> torch.Tensor:
    """All-to-all sequence parallelism (DeepSpeed-Ulysses style) over the
    local blocks (B, s_local, H, D); returns the local output block in
    ``q``'s dtype. ``local``: ``"flash"`` (kernel C over the gathered
    sequence) or ``"dense"`` (the plain attention)."""
    if local not in ("dense", "flash"):
        raise ValueError(f"unknown local attention {local!r}")
    layout = as_layout(layout)
    n = layout.data_size
    b, s_local, h, d = q.shape
    h_kv = k.shape[2]
    if h_kv != h:
        _check_groups(h, h_kv)
        if not (h % n == 0 and h_kv % n == 0):
            # grouped heads do not split over the axis: expand first
            k, v = _expand_gqa(q, k, v)
    pad_h = (-h) % n
    if pad_h:
        def zpad(x):
            return torch.cat([x, x.new_zeros((b, s_local, pad_h, d))], dim=2)

        q, k, v = zpad(q), zpad(k), zpad(v)
    to_heads = lambda x: collectives.all_to_all(x, layout, split_dim=2, concat_dim=1)
    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)   # (B, S, H_pad / n, D)
    if local == "flash":
        out = flash.flash_attention(qh, kh, vh, causal=causal)
    else:
        out = flash.dense_attention(qh, kh, vh, causal=causal)
    out = collectives.all_to_all(out.to(q.dtype), layout, split_dim=1, concat_dim=2)
    return out[:, :, :h] if pad_h else out


def sequence_sharded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, layout,
                               strategy: str = "ring", causal: bool = False,
                               local: str = "dense", axis: str = "seq") -> torch.Tensor:
    """GLOBAL (B, S, H, D) q and (B, S, H_kv, D) k / v, the same on every
    rank -> the global attention output on every rank, the sequence sharded
    over the layout's data axis (a raw mesh's ``axis`` when it has one) and
    the strategy's collectives over it."""
    if strategy not in ("ring", "ulysses"):
        raise ValueError(f"unknown strategy {strategy!r}")
    layout = layout if isinstance(layout, SpecLayout) else as_layout(layout, data_axis=axis)
    n = layout.data_size
    S = q.shape[1]
    if S % n:
        raise ValueError(f"sequence length {S} must be divisible by the "
                         f"{layout.data_axis!r} axis size {n}")
    if local not in ("dense", "flash"):
        raise ValueError(f"unknown local attention {local!r}")
    _check_groups(q.shape[2], k.shape[2])
    s = S // n
    blk = slice(layout.data_rank * s, (layout.data_rank + 1) * s)
    ql, kl, vl = (t[:, blk].contiguous() for t in (q, k, v))
    if strategy == "ring":
        out = ring_attention(ql, kl, vl, layout, causal=causal)
    else:
        out = ulysses_attention(ql, kl, vl, layout, causal=causal, local=local)
    return collectives.all_gather(out, layout, "data", dim=1)
