"""Text featurization stages (the port's copy of the JAX package's
``featurize/text.py``; a batch's tokens are hashed in one call).

Reference: ``core/.../featurize/text/`` — ``TextFeaturizer.scala`` (tokenize ->
n-grams -> hashing TF -> IDF pipeline), ``MultiNGram.scala`` (concatenated
n-gram bags), ``PageSplitter.scala`` (split long documents into page-sized
character chunks).
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

from ..core import ComplexParam, Estimator, Model, Param, Table, Transformer
from ..core.params import ParamValidators
from ..native import murmur3_32_batch

__all__ = ["TextFeaturizer", "TextFeaturizerModel", "MultiNGram", "PageSplitter"]

_TOKEN_RE = re.compile(r"[A-Za-z0-9_]+")


def _tokenize(s: str, lower: bool = True) -> List[str]:
    toks = _TOKEN_RE.findall(s)
    return [t.lower() for t in toks] if lower else toks


def _ngrams(tokens: List[str], n: int) -> List[str]:
    if n <= 1:
        return list(tokens)
    return [" ".join(tokens[i:i + n]) for i in range(len(tokens) - n + 1)]


class TextFeaturizer(Estimator):
    """Tokenize -> n-grams -> hashing TF -> IDF vector
    (reference ``TextFeaturizer.scala``)."""

    input_col = Param("text column", str, default="text")
    output_col = Param("tf-idf vector column", str, default="features")
    num_features = Param("hash space size", int, default=4096,
                         validator=ParamValidators.gt(0))
    n_gram_length = Param("n-gram size", int, default=1)
    to_lowercase = Param("lowercase tokens", bool, default=True)
    use_idf = Param("apply inverse-document-frequency scaling", bool, default=True)
    binary = Param("binary term counts", bool, default=False)

    def _tf(self, texts) -> np.ndarray:
        dim = self.num_features
        out = np.zeros((len(texts), dim), np.float64)
        rows, toks = [], []
        for r, s in enumerate(texts):
            if s is None:
                continue
            t = _ngrams(_tokenize(str(s), self.to_lowercase), self.n_gram_length)
            rows.extend([r] * len(t))
            toks.extend(t)
        slots = murmur3_32_batch(toks).astype(np.int64) % dim
        np.add.at(out, (np.asarray(rows, np.int64), slots), 1.0)
        if self.binary:
            out = (out > 0).astype(np.float64)
        return out

    def _fit(self, table: Table) -> "TextFeaturizerModel":
        self._validate_input(table, self.input_col)
        tf = self._tf(table[self.input_col].tolist())
        n = len(tf)
        df = (tf > 0).sum(axis=0)
        idf = (np.log((n + 1.0) / (df + 1.0)) + 1.0 if self.use_idf
               else np.ones(tf.shape[1]))
        return TextFeaturizerModel(
            input_col=self.input_col, output_col=self.output_col,
            num_features=self.num_features, n_gram_length=self.n_gram_length,
            to_lowercase=self.to_lowercase, binary=self.binary, idf=idf)


class TextFeaturizerModel(Model):
    input_col = Param("text column", str, default="text")
    output_col = Param("tf-idf vector column", str, default="features")
    num_features = Param("hash space size", int, default=4096)
    n_gram_length = Param("n-gram size", int, default=1)
    to_lowercase = Param("lowercase tokens", bool, default=True)
    binary = Param("binary term counts", bool, default=False)
    idf = ComplexParam("idf weights", object, default=None)

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        tf = TextFeaturizer._tf(self, table[self.input_col].tolist())
        return table.with_column(self.output_col, tf * np.asarray(self.idf))


class MultiNGram(Transformer):
    """Concatenated bags of n-grams for several lengths
    (reference ``MultiNGram.scala``)."""

    input_col = Param("text or token column", str, default="text")
    output_col = Param("n-gram bag column", str, default="ngrams")
    lengths = Param("n-gram lengths", list, default=[1, 2, 3])

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        col = table[self.input_col]
        out = np.empty(len(col), dtype=object)
        for r, v in enumerate(col.tolist()):
            if v is None:
                out[r] = []
                continue
            toks = v if isinstance(v, (list, tuple)) else _tokenize(str(v))
            bag: List[str] = []
            for n in self.lengths:
                bag.extend(_ngrams(list(toks), int(n)))
            out[r] = bag
        return table.with_column(self.output_col, out)


class PageSplitter(Transformer):
    """Split documents into page-sized character chunks on whitespace boundaries
    (reference ``PageSplitter.scala``; min/max page length)."""

    input_col = Param("text column", str, default="text")
    output_col = Param("pages column (list per row)", str, default="pages")
    maximum_page_length = Param("max chars per page", int, default=5000)
    minimum_page_length = Param("min chars before a break is taken", int,
                                default=4500)
    boundary_regex = Param("boundary pattern", str, default=r"\s")

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        lo, hi = self.minimum_page_length, self.maximum_page_length
        if lo > hi:
            raise ValueError(f"PageSplitter({self.uid}): min {lo} > max {hi}")
        bound = re.compile(self.boundary_regex)
        col = table[self.input_col]
        out = np.empty(len(col), dtype=object)
        for r, v in enumerate(col.tolist()):
            if v is None:
                out[r] = []
                continue
            s = str(v)
            pages: List[str] = []
            while len(s) > hi:
                cut = hi
                for m in bound.finditer(s, lo, hi):
                    cut = m.start()  # last boundary in window wins
                pages.append(s[:cut])
                s = s[cut:]
            pages.append(s)
            out[r] = pages
        return table.with_column(self.output_col, out)
