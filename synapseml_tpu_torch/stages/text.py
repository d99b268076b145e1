"""Text utility stages.

Rebuilds of ``core/.../stages/TextPreprocessor.scala`` (trie-driven find/replace with
case normalization), ``UnicodeNormalize.scala`` and ``MultiColumnAdapter.scala``.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Optional

import numpy as np

from ..core import ComplexParam, Param, Pipeline, PipelineModel, Table, Transformer, Estimator
from ..core.params import ParamValidators

__all__ = ["TextPreprocessor", "UnicodeNormalize", "MultiColumnAdapter"]


class _Trie:
    """Longest-match replacement trie (reference builds the same structure,
    ``TextPreprocessor.scala``)."""

    __slots__ = ("children", "value")

    def __init__(self):
        self.children: Dict[str, "_Trie"] = {}
        self.value: Optional[str] = None

    def put(self, key: str, value: str) -> None:
        node = self
        for ch in key:
            node = node.children.setdefault(ch, _Trie())
        node.value = value

    def longest_match(self, s: str, start: int):
        node, best = self, None
        i = start
        while i < len(s) and s[i] in node.children:
            node = node.children[s[i]]
            i += 1
            if node.value is not None:
                best = (i, node.value)
        return best


class TextPreprocessor(Transformer):
    """Map-driven text normalization: longest-match substring replacement via a trie,
    with optional case normalization before matching."""

    input_col = Param("input text column", str, default="text")
    output_col = Param("output column", str, default="processed")
    map = Param("substring -> replacement map", dict, default={})
    normalize_case = Param("lowercase before matching", bool, default=True)

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        trie = _Trie()
        for k, v in self.map.items():
            trie.put(k.lower() if self.normalize_case else k, v)
        out = []
        for s in table[self.input_col]:
            s = str(s)
            if self.normalize_case:
                s = s.lower()
            parts, i = [], 0
            while i < len(s):
                m = trie.longest_match(s, i)
                if m is None:
                    parts.append(s[i])
                    i += 1
                else:
                    parts.append(m[1])
                    i = m[0]
            out.append("".join(parts))
        return table.with_column(self.output_col, out)


class UnicodeNormalize(Transformer):
    """Unicode normalization (``UnicodeNormalize.scala``): NFC/NFD/NFKC/NFKD + optional
    lowercasing."""

    input_col = Param("input text column", str, default="text")
    output_col = Param("output column", str, default="normalized")
    form = Param("normalization form", str, default="NFKD",
                 validator=ParamValidators.in_list(["NFC", "NFD", "NFKC", "NFKD"]))
    lower = Param("lowercase output", bool, default=True)

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        out = []
        for s in table[self.input_col]:
            t = unicodedata.normalize(self.form, str(s))
            out.append(t.lower() if self.lower else t)
        return table.with_column(self.output_col, out)


class MultiColumnAdapter(Estimator):
    """Apply a single-column stage to many columns (``MultiColumnAdapter.scala``):
    clones ``base_stage`` per (input, output) pair and chains them into a pipeline."""

    base_stage = ComplexParam("unary stage to replicate (uses input_col/output_col params)",
                              object, default=None)
    input_cols = Param("input columns", list, validator=ParamValidators.non_empty())
    output_cols = Param("output columns", list, validator=ParamValidators.non_empty())

    def _chain(self):
        if len(self.input_cols) != len(self.output_cols):
            raise ValueError("input_cols and output_cols must have equal length")
        stages = []
        for i, o in zip(self.input_cols, self.output_cols):
            clone = self.base_stage.copy({"input_col": i, "output_col": o})
            clone.uid = f"{self.base_stage.uid}_{i}"
            stages.append(clone)
        return stages

    def _fit(self, table: Table) -> PipelineModel:
        return Pipeline(stages=self._chain()).fit(table)
