"""Attention of the port: flash attention (kernel C) and sequence-parallel
ring / Ulysses attention over a mesh."""

from .flash import dense_attention, flash_attention  # noqa: F401
from .ring import ring_attention, sequence_sharded_attention, ulysses_attention  # noqa: F401
