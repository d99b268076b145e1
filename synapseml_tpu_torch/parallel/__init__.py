"""Attention kernels of the port (flash attention, kernel C)."""

from .flash import dense_attention, flash_attention  # noqa: F401
