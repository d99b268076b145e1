"""Per-partition id indexers (reference ``cyber/feature/indexers.py``).

``IdIndexer``: (partition, value) -> consecutive index from 1; unseen values
map to 0 at transform (reference ``IdIndexerModel._transform:31-43``).
``reset_per_partition=True`` restarts 1..n within each partition.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..core import ComplexParam, Estimator, Model, Param, Table

__all__ = ["IdIndexer", "IdIndexerModel", "MultiIndexer", "MultiIndexerModel"]


class IdIndexer(Estimator):
    input_col = Param("column to index", str, default="input")
    output_col = Param("index output column", str, default="output")
    partition_key = Param("partition column", str, default="tenant")
    reset_per_partition = Param("restart numbering per partition", bool,
                                default=False)

    def _fit(self, table: Table) -> "IdIndexerModel":
        self._validate_input(table, self.input_col, self.partition_key)
        pairs = sorted({(str(table[self.partition_key][i]),
                         str(table[self.input_col][i]))
                        for i in range(table.num_rows)})
        vocab: Dict[str, Dict[str, int]] = {}
        if self.reset_per_partition:
            for part, val in pairs:
                d = vocab.setdefault(part, {})
                d[val] = len(d) + 1
        else:
            for i, (part, val) in enumerate(pairs):
                vocab.setdefault(part, {})[val] = i + 1
        return IdIndexerModel(
            input_col=self.input_col, output_col=self.output_col,
            partition_key=self.partition_key, vocab=vocab)


class IdIndexerModel(Model):
    input_col = Param("column to index", str, default="input")
    output_col = Param("index output column", str, default="output")
    partition_key = Param("partition column", str, default="tenant")
    vocab = ComplexParam("partition -> {value -> index from 1}", dict,
                         default=None)

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col, self.partition_key)
        out = np.empty(table.num_rows, dtype=np.int64)
        for i in range(table.num_rows):
            part = str(table[self.partition_key][i])
            out[i] = self.vocab.get(part, {}).get(
                str(table[self.input_col][i]), 0)  # unseen -> 0
        return table.with_column(self.output_col, out)

    def undo_map(self) -> Dict[Tuple[str, int], str]:
        """(partition, index) -> original value (reference ``undo_transform``)."""
        return {(part, idx): val
                for part, d in self.vocab.items() for val, idx in d.items()}


class MultiIndexer(Estimator):
    """Fits several IdIndexers on one pass (reference ``MultiIndexer:130``)."""

    indexers = ComplexParam("list of IdIndexer stages", list, default=[])

    def _fit(self, table: Table) -> "MultiIndexerModel":
        return MultiIndexerModel(
            models=[ix.fit(table) for ix in self.indexers])


class MultiIndexerModel(Model):
    models = ComplexParam("list of fitted IdIndexerModels", list, default=[])

    def get_model_by_input_col(self, input_col: str):
        for m in self.models:
            if m.input_col == input_col:
                return m
        return None

    def get_model_by_output_col(self, output_col: str):
        for m in self.models:
            if m.output_col == output_col:
                return m
        return None

    def _transform(self, table: Table) -> Table:
        for m in self.models:
            table = m.transform(table)
        return table
