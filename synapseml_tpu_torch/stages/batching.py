"""Minibatching stages — the bridge between row-oriented tables and tensor-oriented
engines.

Rebuild of ``core/.../stages/MiniBatchTransformer.scala`` (``FixedMiniBatchTransformer``
:151, ``DynamicMiniBatchTransformer``:53, ``TimeIntervalMiniBatchTransformer``:77,
``FlattenBatch``:187) and ``PartitionConsolidator.scala:21-48``. In the reference these
convert row streams into rows-of-arrays so native engines see contiguous buffers
(``ONNXModel.transform`` inserts a FixedMiniBatchTransformer before inference,
``ONNXModel.scala:499``). Here a *batched* table is one whose columns are object arrays
holding per-batch numpy arrays; ``FlattenBatch`` inverts losslessly.

The port's copy of the JAX package's ``stages/batching.py``.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core import Param, Table, Transformer
from ..core.params import ParamValidators

__all__ = [
    "FixedMiniBatchTransformer",
    "DynamicMiniBatchTransformer",
    "TimeIntervalMiniBatchTransformer",
    "FlattenBatch",
    "PartitionConsolidator",
]


def _batch_table(table: Table, bounds: List[tuple]) -> Table:
    cols = {}
    for name in table.column_names:
        src = table[name]
        out = np.empty(len(bounds), dtype=object)
        for i, (lo, hi) in enumerate(bounds):
            out[i] = src[lo:hi]
        cols[name] = out
    return Table(cols, npartitions=min(table.npartitions, max(1, len(bounds))), meta=table.meta)


class FixedMiniBatchTransformer(Transformer):
    """Group consecutive rows into fixed-size batches
    (``MiniBatchTransformer.scala:151``). Batching is per-partition, so batches never
    straddle a partition boundary (a Spark task == a partition here)."""

    batch_size = Param("rows per batch", int, default=32, validator=ParamValidators.gt(0))
    max_buffer_size = Param("buffering bound (API parity; eager substrate ignores)", int, default=2147483647)

    def _transform(self, table: Table) -> Table:
        def per_part(part: Table, _i: int) -> Table:
            b = self.batch_size
            bounds = [(lo, min(lo + b, part.num_rows)) for lo in range(0, part.num_rows, b)]
            return _batch_table(part, bounds)

        return table.map_partitions(per_part)


class DynamicMiniBatchTransformer(Transformer):
    """Batch whatever is available, capped at ``max_batch_size``
    (``MiniBatchTransformer.scala:53``). In the eager substrate the whole partition is
    'available', so this emits one batch per partition (or several when capped)."""

    max_batch_size = Param("max rows per batch", int, default=2147483647,
                           validator=ParamValidators.gt(0))

    def _transform(self, table: Table) -> Table:
        def per_part(part: Table, _i: int) -> Table:
            b = min(self.max_batch_size, max(1, part.num_rows))
            bounds = [(lo, min(lo + b, part.num_rows)) for lo in range(0, part.num_rows, b)]
            return _batch_table(part, bounds)

        return table.map_partitions(per_part)


class TimeIntervalMiniBatchTransformer(DynamicMiniBatchTransformer):
    """Time-window batching (``MiniBatchTransformer.scala:77``). Meaningful for
    streaming sources (serving); over an eager table it degenerates to dynamic
    batching — the interval param is kept for API parity and used by the serving layer."""

    millis_to_wait = Param("batch window in milliseconds", int, default=1000,
                           validator=ParamValidators.gt(0))


class FlattenBatch(Transformer):
    """Invert minibatching: explode every batched column in lockstep
    (``MiniBatchTransformer.scala:187``)."""

    def _transform(self, table: Table) -> Table:
        if table.num_rows == 0:
            return table
        names = table.column_names
        first = table[names[0]]
        lengths = np.array([len(v) for v in first], dtype=np.int64)
        cols = {}
        for name in names:
            src = table[name]
            parts = []
            for i, v in enumerate(src):
                arr = np.asarray(v)
                if len(arr) != lengths[i]:
                    raise ValueError(
                        f"FlattenBatch: column {name!r} batch {i} has {len(arr)} rows, "
                        f"expected {lengths[i]}"
                    )
                parts.append(arr)
            if any(p.dtype == object for p in parts):
                total = int(lengths.sum())
                out = np.empty(total, dtype=object)
                k = 0
                for p in parts:
                    out[k : k + len(p)] = p
                    k += len(p)
                cols[name] = out
            else:
                cols[name] = np.concatenate(parts, axis=0)
        return Table(cols, npartitions=table.npartitions, meta=table.meta)


class PartitionConsolidator(Transformer):
    """Funnel all rows into one partition per host
    (``PartitionConsolidator.scala:21-48``; reference funnels an executor's rows to one
    task so rate-limited HTTP clients share a single connection pool). Here: coalesce the
    table to a single logical partition."""

    def _transform(self, table: Table) -> Table:
        return table.repartition(1)
