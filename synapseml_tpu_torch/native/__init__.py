"""Host-side hashing shared by the featurizers (the JAX package's ``native/``
without its C++ library: the port's copy is numpy, vectorised over a batch)."""

from .murmur import murmur3_32, murmur3_32_batch

__all__ = ["murmur3_32", "murmur3_32_batch"]
