"""VW-style murmur-hash featurization of Table columns.

Port of ``synapseml_tpu/vw/featurizer.py`` over the port's numpy murmur3
(``native/murmur.py``), output bit-equal to the reference's. Reference: ``VowpalWabbitFeaturizer`` + the 11 featurizer classes under
``vw/src/main/scala/.../vw/featurizer/`` (NumberFeaturizer, StringFeaturizer,
MapFeaturizer, SeqFeaturizer, VectorFeaturizer, StringSplitFeaturizer, ...), and
``VowpalWabbitInteractions.scala`` (quadratic namespace crosses).

Each input column is a namespace: its name hashes (seeded by ``hash_seed``) to the
namespace seed, and features hash within it — matching VW's two-level scheme. The
output column holds one ``(indices uint32, values f32)`` pair per row (sparse);
``mask_bits`` truncates indices to the learner's 2^b weight space at train time, so
the featurized column is learner-size-agnostic like a VW example.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ..core import Param, Table, Transformer
from ..core.params import ParamValidators
from ..native import murmur3_32, murmur3_32_batch

__all__ = ["VowpalWabbitFeaturizer", "VowpalWabbitInteractions", "sparse_meta"]


def sparse_meta() -> dict:
    return {"type": "vw_sparse"}


class VowpalWabbitFeaturizer(Transformer):
    """Hash arbitrary columns into one sparse feature column.

    Column handling (reference featurizer dispatch,
    ``VowpalWabbitFeaturizer.getFeaturizer``):
    - numeric column  -> one feature ``h(col)`` with the numeric value;
    - string column   -> one feature ``h(col + '=' + s)`` with value 1
                         (``string_split_cols`` instead tokenizes on whitespace,
                         one value-1 feature per token);
    - tensor column   -> features ``h(col + '_' + i)`` with the vector entries;
    - object column of dict -> per key: numeric value feature ``h(col + '.' + k)``
                         or string feature ``h(col + '.' + k + '=' + v)``;
    - object column of (indices, values) -> passed through (already sparse).
    """

    input_cols = Param("columns to featurize", list, default=[])
    output_col = Param("output sparse-features column", str, default="features")
    string_split_cols = Param("string columns to whitespace-tokenize", list, default=[])
    hash_seed = Param("murmur seed", int, default=0)
    sum_collisions = Param("sum values on index collision (else last wins); the "
                           "learner scatter-adds either way", bool, default=True)

    def _ns_seed(self, col: str) -> int:
        return murmur3_32(col, self.hash_seed)

    def _featurize_column(self, name: str, arr: np.ndarray, n: int):
        """-> (list of index-arrays, list of value-arrays) aligned to rows."""
        seed = self._ns_seed(name)
        if arr.dtype != object and np.issubdtype(arr.dtype, np.number) and arr.ndim == 1:
            idx = np.uint32(murmur3_32(name, seed))
            return ([np.array([idx], np.uint32)] * n,
                    [np.array([v], np.float32) for v in arr])
        if arr.dtype != object and arr.ndim > 1:
            d = int(np.prod(arr.shape[1:]))
            idxs = murmur3_32_batch([f"{name}_{i}" for i in range(d)], seed)
            flat = arr.reshape(n, d).astype(np.float32)
            return ([idxs] * n, [flat[i] for i in range(n)])
        # object / string-ish columns: per-row dispatch
        out_i: List[np.ndarray] = []
        out_v: List[np.ndarray] = []
        split = name in self.string_split_cols
        for i in range(n):
            v = arr[i]
            if v is None:
                out_i.append(np.empty(0, np.uint32))
                out_v.append(np.empty(0, np.float32))
            elif isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], np.ndarray):
                out_i.append(v[0].astype(np.uint32))
                out_v.append(np.asarray(v[1], np.float32))
            elif isinstance(v, str):
                toks = v.split() if split else [v]
                out_i.append(murmur3_32_batch(
                    [f"{name}={t}" for t in toks], seed))
                out_v.append(np.ones(len(toks), np.float32))
            elif isinstance(v, dict):
                keys, vals = [], []
                for k, kv in v.items():
                    if isinstance(kv, str):
                        keys.append(f"{name}.{k}={kv}")
                        vals.append(1.0)
                    else:
                        keys.append(f"{name}.{k}")
                        vals.append(float(kv))
                out_i.append(murmur3_32_batch(keys, seed) if keys
                             else np.empty(0, np.uint32))
                out_v.append(np.asarray(vals, np.float32))
            elif isinstance(v, (list, np.ndarray)):
                vec = np.asarray(v, dtype=np.float32).ravel()
                out_i.append(murmur3_32_batch(
                    [f"{name}_{j}" for j in range(len(vec))], seed))
                out_v.append(vec)
            else:  # scalar numeric in an object column
                out_i.append(np.array([murmur3_32(name, seed)], np.uint32))
                out_v.append(np.array([float(v)], np.float32))
        return out_i, out_v

    def _transform(self, table: Table) -> Table:
        cols = self.input_cols
        if not cols:
            raise ValueError(f"{type(self).__name__}({self.uid}): input_cols is empty")
        self._validate_input(table, *cols)
        n = table.num_rows
        all_i = [[] for _ in range(n)]
        all_v = [[] for _ in range(n)]
        for c in cols:
            ci, cv = self._featurize_column(c, table[c], n)
            for r in range(n):
                all_i[r].append(ci[r])
                all_v[r].append(cv[r])
        out = np.empty(n, dtype=object)
        dedupe = not self.sum_collisions
        for r in range(n):
            ri = np.concatenate(all_i[r]).astype(np.uint32)
            rv = np.concatenate(all_v[r]).astype(np.float32)
            if dedupe and len(ri):
                # last wins: keep the final occurrence of each index
                _, last = np.unique(ri[::-1], return_index=True)
                keep = np.sort(len(ri) - 1 - last)
                ri, rv = ri[keep], rv[keep]
            out[r] = (ri, rv)
        return table.with_column(self.output_col, out, meta=sparse_meta())


class VowpalWabbitInteractions(Transformer):
    """Quadratic feature crosses between sparse columns
    (reference ``VowpalWabbitInteractions.scala``; VW ``-q``/``--interactions``).

    Cross indices combine the paired feature hashes with VW's FNV-1 scheme
    ``(h1 * 16777619) ^ h2`` (reference ``VowpalWabbitInteractions.scala``
    ``fnvPrime``), masked to ``2^num_bits``; values multiply. With
    ``sum_collisions`` (reference ``sumCollisions``) colliding cross indices are
    merged by summing their values."""

    input_cols = Param("sparse columns to cross (2+)", list, default=[])
    output_col = Param("output sparse column", str, default="interactions")
    num_bits = Param("mask cross indices into 2^b space (reference numBits)", int,
                     default=30, validator=ParamValidators.in_range(1, 32))
    sum_collisions = Param("sum values of colliding cross indices "
                           "(reference sumCollisions)", bool, default=True)

    _FNV_PRIME = np.uint64(16777619)

    def _transform(self, table: Table) -> Table:
        cols = self.input_cols
        if len(cols) < 2:
            raise ValueError(f"{type(self).__name__}({self.uid}): need >= 2 input_cols")
        self._validate_input(table, *cols)
        n = table.num_rows
        mask = np.uint64((1 << self.num_bits) - 1)
        out = np.empty(n, dtype=object)
        for r in range(n):
            idx, val = None, None
            for c in cols:
                ci, cv = table[c][r]
                if idx is None:
                    idx, val = ci.astype(np.uint64), cv.astype(np.float32)
                else:
                    # FNV-1: h = (h1 * prime) ^ h2, matching the reference
                    cross = ((idx[:, None] * self._FNV_PRIME)
                             ^ ci[None, :].astype(np.uint64))
                    idx = (cross & np.uint64(0xFFFFFFFF)).ravel()
                    val = (val[:, None] * cv[None, :]).ravel()
            idx = idx & mask
            if self.sum_collisions and len(idx):
                uniq, inv = np.unique(idx, return_inverse=True)
                sums = np.zeros(len(uniq), np.float32)
                np.add.at(sums, inv, val)
                idx, val = uniq, sums
            out[r] = (idx.astype(np.uint32), val.astype(np.float32))
        return table.with_column(self.output_col, out, meta=sparse_meta())


class VectorZipper(Transformer):
    """Combine one or more input columns into a per-row sequence column.

    Reference ``vw/.../VectorZipper.scala:21-41``: ``array(inputCols...)`` —
    used to build the per-action feature sequences the contextual bandit
    consumes. All input columns must share a kind (the reference asserts
    matching DataTypes)."""

    input_cols = Param("columns to zip (1+)", list, default=[])
    output_col = Param("output sequence column", str, default="output")

    def _transform(self, table: Table) -> Table:
        if not self.input_cols:
            raise ValueError(f"VectorZipper({self.uid}): input_cols is empty")
        self._validate_input(table, *self.input_cols)
        cols = [table[c] for c in self.input_cols]
        kinds = {(c.dtype == object, c.ndim) for c in cols}
        if len(kinds) > 1:
            raise ValueError(
                f"VectorZipper({self.uid}): input columns must share a type; "
                f"got {[str(table[c].dtype) for c in self.input_cols]}")
        n = table.num_rows
        out = np.empty(n, dtype=object)
        for r in range(n):
            out[r] = [c[r] for c in cols]
        return table.with_column(self.output_col, out)


__all__.append("VectorZipper")
