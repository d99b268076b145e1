"""Complement-set sampling (reference ``cyber/anomaly/complement_access.py``).

For each observed row, draw ``complementset_factor`` uniform random tuples
from the per-partition index ranges, then anti-join the observed tuples —
yielding a sample of access patterns that did NOT occur.
"""

from __future__ import annotations

import numpy as np

from ..core import Param, Table, Transformer
from .scalers import _partition_values

__all__ = ["ComplementAccessTransformer"]


class ComplementAccessTransformer(Transformer):
    partition_key = Param("partition column (None = global)", str, default=None)
    indexed_col_names = Param("indexed columns to sample over", list,
                              default=[])
    complementset_factor = Param("candidate draws per observed row", int,
                                 default=2)
    seed = Param("sampling seed", int, default=0)

    def _transform(self, table: Table) -> Table:
        cols = list(self.indexed_col_names)
        if not cols:
            raise ValueError(f"{type(self).__name__}({self.uid}): "
                             "indexed_col_names must be set")
        self._validate_input(table, *cols)
        factor = self.complementset_factor
        pk = self.partition_key
        if factor == 0:
            empty = {c: np.array([], dtype=np.int64) for c in cols}
            if pk is not None:
                empty[pk] = np.array([], dtype=object)
            return Table(empty)
        if pk is not None:
            self._validate_input(table, pk)
        parts = _partition_values(table, pk, table.num_rows)
        rng = np.random.default_rng(self.seed)
        vals = {c: np.asarray(table[c], dtype=np.int64) for c in cols}

        out_parts, out_vals = [], {c: [] for c in cols}
        for p in np.unique(parts):
            m = parts == p
            seen = set(zip(*[vals[c][m] for c in cols]))
            lims = [(int(vals[c][m].min()), int(vals[c][m].max()))
                    for c in cols]
            n_draw = int(m.sum()) * factor
            cand = np.stack([rng.integers(lo, hi + 1, size=n_draw)
                             for lo, hi in lims], axis=1)
            cand = np.unique(cand, axis=0)
            keep = [tuple(row) not in seen for row in cand]
            cand = cand[np.asarray(keep, dtype=bool)] if len(cand) else cand
            out_parts.extend([p] * len(cand))
            for j, c in enumerate(cols):
                out_vals[c].extend(cand[:, j].tolist())

        data = {c: np.array(out_vals[c], dtype=np.int64) for c in cols}
        if pk is not None:
            data[pk] = np.array(out_parts, dtype=object)
        return Table(data)
