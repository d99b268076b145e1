"""``jax.image.resize`` in torch ops, shared by the image ops and the ONNX
``Resize`` op.

Half-pixel centres; linear and cubic (Keys, a = -0.5) are antialiased when
downsampling (the kernel widens by the scale); a dimension whose size does
not change is left alone. Each resized dimension is one contraction with
jax.image's weight matrix (``compute_weight_mat``), dimensions in order.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

__all__ = ["resize_array", "weight_mat"]


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x):
    return torch.clamp(1 - torch.abs(x), min=0)


def weight_mat(n_in: int, n_out: int, kernel, device) -> torch.Tensor:
    """jax.image's ``compute_weight_mat`` (antialiased, no translation), f32,
    (n_in, n_out)."""
    scale = torch.tensor(n_out / n_in if n_out else 1.0, dtype=torch.float32)
    inv = 1.0 / scale
    kscale = torch.clamp(inv, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv - 0.5
    x = torch.abs(sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]) / kscale
    w = kernel(x)
    total = torch.sum(w, dim=0, keepdim=True)
    w = torch.where(torch.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    keep = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(keep[None, :], w, torch.zeros_like(w)).to(device)


def resize_array(x: torch.Tensor, sizes: Sequence[int], method: str) -> torch.Tensor:
    """jax.image.resize of ``x`` to ``sizes`` (one per dimension) by
    ``"nearest"``, ``"linear"`` or ``"cubic"``; integer input is cast to f32
    first, as jnp promotes it."""
    if method == "nearest":
        for d, (m, n) in enumerate(zip(x.shape, sizes)):
            if m != n:
                off = torch.floor((torch.arange(n, dtype=torch.float32) + 0.5) * m / n)
                x = torch.index_select(x, d, off.to(torch.int64).to(x.device))
        return x
    if not x.dtype.is_floating_point:
        x = x.to(torch.float32)
    kernel = {"linear": _triangle, "cubic": _keys_cubic}[method]
    for d, (m, n) in enumerate(zip(x.shape, sizes)):
        if m != n:
            w = weight_mat(m, n, kernel, x.device).to(x.dtype)
            x = torch.movedim(torch.tensordot(torch.movedim(x, d, -1), w, dims=1), -1, d)
    return x
