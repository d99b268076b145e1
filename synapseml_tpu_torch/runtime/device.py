"""Device resolution — the port's counterpart of ``runtime/topology.py::require_backend``.

Rule: an entry point runs on the CUDA device unless its caller asks for the
CPU (``device="cpu"``, as the tests do). A missing card is an error with a
name, never a silent fall back to the CPU.
"""

from __future__ import annotations

import contextlib
import subprocess
from typing import Optional, Union

import torch

__all__ = ["DeviceUnavailableError", "resolve_device", "card_info", "full_f32"]


class DeviceUnavailableError(RuntimeError):
    """No CUDA device is visible and the caller did not ask for the CPU."""


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` or ``"cuda[:i]"`` -> that CUDA device (raising
    :class:`DeviceUnavailableError` when none is visible); ``"cpu"`` -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"device must be 'cuda[:i]' or 'cpu', got {device!r}")
    if not torch.cuda.is_available():
        raise DeviceUnavailableError(
            "no CUDA device is visible (torch.cuda.is_available() is False); "
            "pass device='cpu' to run the plain PyTorch path on the CPU")
    return dev


def card_info() -> str:
    """``name, power.limit`` of every visible card, as ``nvidia-smi`` reports it
    (the power limit bounds the card's clocks, so every measurement carries it)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


@contextlib.contextmanager
def full_f32():
    """f32 matmuls and convolutions in full f32 inside the block, whatever the
    global TF32 switches say (cuDNN's is on by default, and TF32 rounds the
    operands to 10 mantissa bits: ~1e-3 relative); restored on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
