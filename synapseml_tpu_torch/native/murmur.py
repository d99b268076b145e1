"""MurmurHash3 x86/32 over numpy, vectorised across strings.

The port's copy of the JAX package's murmur3 entry points (``murmur3_32``,
``murmur3_32_batch``), bit-equal to them. The JAX package hashes through a
ctypes library built from C++ when a toolchain is present and a pure-Python
loop otherwise; the port builds no host library: it hashes a whole batch at
once, one numpy pass for each 4-byte block position (the mixing of block j
depends on block j - 1, so only the strings are processed in parallel).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["murmur3_32", "murmur3_32_batch"]

_M32 = np.uint64(0xFFFFFFFF)
_C1, _C2 = np.uint64(0xCC9E2D51), np.uint64(0x1B873593)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & _M32


def _mix_k(k: np.ndarray) -> np.ndarray:
    k = (k * _C1) & _M32
    k = _rotl(k, 15)
    return (k * _C2) & _M32


def _encode(s) -> bytes:
    return s if isinstance(s, bytes) else str(s).encode("utf-8")


def murmur3_32_batch(strings: Sequence, seeds=0) -> np.ndarray:
    """Hash a sequence of strings (UTF-8) or bytes -> uint32 array.
    ``seeds``: one seed, or one a string."""
    enc = [_encode(s) for s in strings]
    n = len(enc)
    lens = np.fromiter((len(b) for b in enc), dtype=np.int64, count=n)
    starts = np.zeros(n, dtype=np.int64)
    np.cumsum(lens[:-1], out=starts[1:])
    # 3 bytes of padding: a tail's reads never run past the buffer
    buf = np.frombuffer(b"".join(enc) + b"\0\0\0", dtype=np.uint8).astype(np.uint64)
    h = (np.broadcast_to(np.asarray(seeds, dtype=np.int64), (n,)).astype(np.uint64)
         & _M32).copy()
    blocks = lens // 4
    for j in range(int(blocks.max()) if n else 0):
        live = np.nonzero(blocks > j)[0]
        at = starts[live] + 4 * j
        k = (buf[at] | (buf[at + 1] << np.uint64(8)) | (buf[at + 2] << np.uint64(16))
             | (buf[at + 3] << np.uint64(24)))
        hv = h[live] ^ _mix_k(k)
        hv = _rotl(hv, 13)
        h[live] = (hv * np.uint64(5) + np.uint64(0xE6546B64)) & _M32
    tail = lens & 3
    at = starts + 4 * blocks
    k = np.zeros(n, dtype=np.uint64)
    for t, shift in ((3, 16), (2, 8), (1, 0)):
        k ^= np.where(tail >= t, buf[at + (t - 1)] << np.uint64(shift), np.uint64(0))
    h ^= np.where(tail >= 1, _mix_k(k), np.uint64(0))
    h ^= lens.astype(np.uint64)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & _M32
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & _M32
    h ^= h >> np.uint64(16)
    return h.astype(np.uint32)


def murmur3_32(data, seed: int = 0) -> int:
    """Hash one string (UTF-8) or bytes value."""
    return int(murmur3_32_batch([data], seed)[0])
