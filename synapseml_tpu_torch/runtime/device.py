"""Device resolution — the port's counterpart of ``runtime/topology.py::require_backend``.

Rule: an entry point runs on the CUDA device unless its caller asks for the
CPU (``device="cpu"``, as the tests do). A missing card is an error with a
name, never a silent fall back to the CPU.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch

__all__ = ["DeviceUnavailableError", "resolve_device", "card_info"]


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
