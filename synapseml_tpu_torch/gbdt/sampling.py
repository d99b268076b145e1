"""The reference's random streams and its row and feature sampling masks.

Port of the random parts of ``synapseml_tpu/gbdt/boost.py``: the key schedule
of ``train`` (``:1297-1302``, host loop ``:2316-2321``), the bagging and GOSS
row weights of ``_build_step.make_weights`` (``:1209-1229``) and the feature
mask (``:1250-1253``).

The reference draws its masks with ``jax.random``: threefry-2x32 (20
rounds) over counters, in the "partitionable" layout that is JAX's default.
This module computes the same function without JAX, so a sampled fit here
grows the reference's trees. Keys are pairs of Python ints, and their
arithmetic (:func:`prng_key`, :func:`split`, :func:`fold_in`) runs on the
host: a few threefry calls on scalars, which never read the device.
:func:`uniform` runs threefry over ``n`` counters as int64 torch ops masked
to 32 bits (torch's uint32 lacks the arithmetic) on the device it is given.
The generator is counter-based and stateless, so the GPU and the CPU draw
the same bits; a ``torch.Generator`` would give neither that nor JAX's
stream.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["Key", "prng_key", "split", "fold_in", "threefry2x32", "uniform",
           "goss_cut", "Sampler"]

Key = Tuple[int, int]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(key: Key, x0, x1):
    """Threefry-2x32 with 20 rounds (``jax._src.prng._threefry2x32_lowering``)
    of the counter pair (``x0``, ``x1``) under ``key``.

    The counters are Python ints or int64 tensors holding values in
    [0, 2**32). ``x0`` is only ever added to and xor-ed into ``x1``, so it
    is masked once at the end; ``x1`` is masked before every rotation."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & _M32
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & _M32
    return x0 & _M32, x1


def prng_key(seed: int) -> Key:
    """``jax.random.PRNGKey(seed)`` for a 32-bit seed (JAX's default
    integer width): the pair (0, seed mod 2**32)."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed {seed} does not fit in 32 bits (jax.random.PRNGKey)")
    return 0, seed & _M32


def split(key: Key) -> Tuple[Key, Key]:
    """``jax.random.split(key)``: the keys hashed from counters 0 and 1."""
    return threefry2x32(key, 0, 0), threefry2x32(key, 0, 1)


def fold_in(key: Key, data: int) -> Key:
    """``jax.random.fold_in(key, data)``: the key hashed from (0, data)."""
    return threefry2x32(key, 0, int(data) & _M32)


def uniform(key: Key, n: int, device) -> torch.Tensor:
    """``jax.random.uniform(key, (n,))`` as an (n,) f32 tensor on ``device``:
    the xor of threefry's two words over the counters 0..n-1, its top 23
    bits as the mantissa of a float in [1, 2), minus 1."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    hi = (i >> 32) if n > 2 ** 32 else 0
    b0, b1 = threefry2x32(key, hi, i & _M32)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def goss_cut(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(a, q)`` (linear method) of a 1-D f32 tensor, as a 0-d
    f32 tensor on ``a``'s device, rounded as the reference rounds it: the
    position ``q * (n - 1)`` in f32 (on the host), the two order statistics
    around it, and ``low * (1 - w) + high * w`` with the second product
    and the sum fused, as the reference's compiled CPU program contracts
    them into an FMA (here: the product exact in f64, one rounding of the
    f64 sum to f32)."""
    n = a.shape[0]
    pos = np.float32(q) * (np.float32(n) - np.float32(1))
    low, high = np.floor(pos), np.ceil(pos)
    w_high = pos - low
    w_low = np.float32(1) - w_high
    last = np.float32(n - 1)
    lo = int(min(max(low, np.float32(0)), last))
    hi = int(min(max(high, np.float32(0)), last))
    # one sort, not kthvalue: at 4M rows on an H100 a kthvalue took 21 ms
    ordered = torch.sort(a).values
    v_lo, v_hi = ordered[lo], ordered[hi]
    return ((v_lo * float(w_low)).double() + v_hi.double() * float(w_high)).float()


class Sampler:
    """A fit's row weights and feature masks, drawn from the reference's key
    schedule.

    ``key = prng_key(seed)`` and ``bkey = prng_key(bagging_seed)``; each
    iteration splits ``key`` into the next key and ``k2``, and folds the
    bagging period into ``bkey`` for ``k1`` (GOSS: the iteration; otherwise
    ``it // max(bagging_freq, 1)``). The row weights come from ``k1``, the
    feature mask from ``k2``. Made once a fit, called once an iteration, in
    order. ``shard``: on a mesh, the rank's data coordinate, folded into
    ``k1`` when a row mask draws (the reference's ``bag_rng_live``,
    ``boost.py:1202``, ``:1300-1302``), so each shard draws its own rows."""

    def __init__(self, p: dict, y: torch.Tensor, n_features: int, goss: bool,
                 shard: Optional[int] = None):
        self.key = prng_key(p["seed"])
        self.bkey = prng_key(p["bagging_seed"])
        self.y = y
        self.d = int(n_features)
        self.goss = goss
        self.ff = float(p["feature_fraction"])
        self.bfreq = int(p["bagging_freq"])
        self.top_rate, self.other_rate = float(p["top_rate"]), float(p["other_rate"])
        bf = float(p["bagging_fraction"])
        pos_bf, neg_bf = float(p["pos_bagging_fraction"]), float(p["neg_bagging_fraction"])
        # (positive rows' fraction, negative rows' fraction), or None
        self.fractions = None
        if self.bfreq > 0 and (pos_bf < 1.0 or neg_bf < 1.0):
            self.fractions = (pos_bf, neg_bf)   # class-aware bagging wins
        elif self.bfreq > 0 and bf < 1.0:
            self.fractions = (bf, bf)
        self._bag = (None, None)  # (period, weights) of the last bag drawn
        self.shard = shard if (goss or self.fractions is not None) else None

    def keys(self, it: int) -> Tuple[Key, Key]:
        """(k1, k2) of iteration ``it``; advances the key."""
        self.key, k2 = split(self.key)
        period = it if self.goss else it // max(self.bfreq, 1)
        k1 = fold_in(self.bkey, period)
        return (k1 if self.shard is None else fold_in(k1, self.shard)), k2

    def feature_mask(self, k2: Key) -> Optional[torch.Tensor]:
        """(d,) f32 host tensor of 0/1, ``u(k2, d) < feature_fraction`` (all
        ones when none survives); None when ``feature_fraction >= 1``."""
        if self.ff >= 1.0:
            return None
        m = (uniform(k2, self.d, "cpu") < _f32(self.ff)).to(torch.float32)
        return m if bool(m.any()) else torch.ones(self.d)

    def row_weights(self, k1: Key, it: int, g: torch.Tensor) -> Optional[torch.Tensor]:
        """(n,) f32 row weights on ``g``'s device for iteration ``it`` (``g``:
        the (n, C) pre-rounded gradients), or None without row sampling.

        GOSS: rows whose ``|g|`` summed over classes is at least the
        ``1 - top_rate`` quantile keep weight 1; the others are kept with
        probability ``other_rate / (1 - top_rate)`` at weight
        ``(1 - top_rate) / other_rate``. Bagging: a row is kept (weight 1)
        when ``u < fraction``, the fraction of its class under class-aware
        bagging; a bag is drawn once a period and reused within it."""
        if self.goss:
            grad_abs = g.abs().sum(1)
            is_top = grad_abs >= goss_cut(grad_abs, 1.0 - self.top_rate)
            keep = uniform(k1, g.shape[0], g.device) < _f32(
                self.other_rate / max(1e-12, 1.0 - self.top_rate))
            amp = _f32((1.0 - self.top_rate) / max(self.other_rate, 1e-12))
            return torch.where(is_top, 1.0, torch.where(keep, amp, 0.0))
        if self.fractions is None:
            return None
        period = it // max(self.bfreq, 1)
        if self._bag[0] != period:
            u = uniform(k1, g.shape[0], g.device)
            pos, neg = (_f32(f) for f in self.fractions)
            keep = u < pos if pos == neg else u < torch.where(self.y > 0, pos, neg)
            self._bag = (period, keep.to(torch.float32))
        return self._bag[1]


def _f32(v: float) -> float:
    """``v`` rounded to f32 (the reference compares f32 draws with its Python
    floats as f32), as a Python float that holds it exactly."""
    return float(np.float32(v))
