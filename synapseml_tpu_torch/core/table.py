"""Columnar, partitioned dataset substrate — the framework's DataFrame equivalent.

A copy of the JAX package's module of the same name (which imports no JAX
either); the port keeps its own copy so that it imports nothing of that package.


The reference operates on Spark DataFrames (row-oriented, partitioned, lazily planned).
A TPU-native framework wants *columnar, fixed-shape, batch-oriented* data so that stages
hand XLA large dense arrays instead of row streams (SURVEY.md §7 "Design stance": Arrow-
backed columnar batches). ``Table`` is that substrate:

- columns are numpy arrays: 1-D for scalars, N-D for fixed-shape tensor columns
  (vectors/images), ``object`` dtype for strings / ragged values;
- a table carries a logical partition count (``npartitions``); partition *i* is a
  contiguous row range. A "task" in the reference (one Spark partition) maps to one
  partition here — estimator/transformer code that is partition-parallel iterates
  ``partitions()`` (reference analogue: ``df.rdd.mapPartitions``);
- ``map_partitions`` is the execution primitive, mirroring the reference's ubiquitous
  ``mapPartitions`` (e.g. ``ONNXModel.scala:499-508``, ``VowpalWabbitBase.scala:337``).

Interop: ``from_pandas``/``to_pandas``, ``from_arrow``/``to_arrow`` when pyarrow is
available.
"""

from __future__ import annotations

import numpy as np
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple

__all__ = ["Table", "concat_tables"]


def _as_column(v) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v
    if hasattr(v, "__array__") and not isinstance(v, (list, tuple)):
        return np.asarray(v)
    arr = None
    if isinstance(v, (list, tuple)):
        first = v[0] if len(v) else None
        if isinstance(first, str) or first is None or isinstance(first, (dict, bytes)):
            arr = np.empty(len(v), dtype=object)
            arr[:] = v
        elif isinstance(first, (list, tuple, np.ndarray)):
            # Try to stack into a fixed-shape tensor column; fall back to ragged object.
            try:
                arr = np.asarray(v)
                if arr.dtype == object:
                    raise ValueError
            except ValueError:
                arr = np.empty(len(v), dtype=object)
                for i, x in enumerate(v):
                    arr[i] = np.asarray(x)
        else:
            arr = np.asarray(v)
    else:
        arr = np.asarray(v)
    return arr


class Table:
    """Immutable columnar table with logical partitioning."""

    def __init__(
        self,
        columns: Mapping[str, Any],
        npartitions: int = 1,
        meta: Optional[Dict[str, Dict[str, Any]]] = None,
    ):
        cols: Dict[str, np.ndarray] = {}
        n = None
        for k, v in columns.items():
            arr = _as_column(v)
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError(
                    f"Column {k!r} has length {len(arr)}, expected {n}"
                )
            cols[k] = arr
        self._columns = cols
        self._num_rows = 0 if n is None else int(n)
        self.npartitions = max(1, min(int(npartitions), max(1, self._num_rows)))
        # Per-column metadata (semantic types: 'image', 'vector', ... + arbitrary keys).
        self.meta: Dict[str, Dict[str, Any]] = dict(meta or {})

    # -- construction ------------------------------------------------------------

    @staticmethod
    def from_pandas(df, npartitions: int = 1) -> "Table":
        cols = {}
        for c in df.columns:
            s = df[c]
            if s.dtype == object:
                arr = np.empty(len(s), dtype=object)
                arr[:] = list(s)
            else:
                arr = s.to_numpy()
            cols[str(c)] = arr
        return Table(cols, npartitions=npartitions)

    @staticmethod
    def from_rows(rows: Sequence[Mapping[str, Any]], npartitions: int = 1) -> "Table":
        if not rows:
            return Table({}, npartitions=npartitions)
        keys = list(rows[0].keys())
        return Table({k: [r[k] for r in rows] for k in keys}, npartitions=npartitions)

    def to_pandas(self):
        import pandas as pd

        data = {}
        for k, v in self._columns.items():
            if v.ndim > 1:
                col = np.empty(len(v), dtype=object)
                for i in range(len(v)):
                    col[i] = v[i]
                data[k] = col
            else:
                data[k] = v
        return pd.DataFrame(data)

    @staticmethod
    def from_arrow(tbl, npartitions: int = 1) -> "Table":
        return Table.from_pandas(tbl.to_pandas(), npartitions=npartitions)

    def to_arrow(self):
        import pyarrow as pa

        return pa.Table.from_pandas(self.to_pandas())

    # -- basic accessors ---------------------------------------------------------

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def __len__(self) -> int:
        return self._num_rows

    @property
    def column_names(self) -> List[str]:
        return list(self._columns.keys())

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def column(self, name: str) -> np.ndarray:
        try:
            return self._columns[name]
        except KeyError:
            raise KeyError(
                f"No column {name!r}; available: {self.column_names}"
            ) from None

    __getitem__ = column

    def schema(self) -> Dict[str, str]:
        out = {}
        for k, v in self._columns.items():
            sem = self.meta.get(k, {}).get("type")
            if sem:
                out[k] = sem
            elif v.dtype == object:
                out[k] = "object"
            elif v.ndim > 1:
                out[k] = f"tensor{list(v.shape[1:])}:{v.dtype.name}"
            else:
                out[k] = v.dtype.name
        return out

    def row(self, i: int) -> Dict[str, Any]:
        return {k: v[i] for k, v in self._columns.items()}

    def rows(self) -> Iterator[Dict[str, Any]]:
        for i in range(self._num_rows):
            yield self.row(i)

    # -- column ops (all return new Tables) --------------------------------------

    def _like(self, columns: Mapping[str, Any], meta: Optional[Dict] = None) -> "Table":
        return Table(columns, npartitions=self.npartitions,
                     meta=meta if meta is not None else self.meta)

    def select(self, *names: str) -> "Table":
        return self._like({n: self.column(n) for n in names},
                          meta={k: v for k, v in self.meta.items() if k in names})

    def drop(self, *names: str) -> "Table":
        keep = [c for c in self.column_names if c not in names]
        return self.select(*keep)

    def with_column(self, name: str, values, meta: Optional[Dict[str, Any]] = None) -> "Table":
        cols = dict(self._columns)
        cols[name] = values
        m = dict(self.meta)
        if meta is not None:
            m[name] = meta
        t = self._like(cols, meta=m)
        return t

    def with_columns(self, new: Mapping[str, Any]) -> "Table":
        cols = dict(self._columns)
        cols.update(new)
        return self._like(cols)

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        cols = {mapping.get(k, k): v for k, v in self._columns.items()}
        meta = {mapping.get(k, k): v for k, v in self.meta.items()}
        return self._like(cols, meta=meta)

    # -- row ops -----------------------------------------------------------------

    def slice(self, start: int, stop: int) -> "Table":
        cols = {k: v[start:stop] for k, v in self._columns.items()}
        return Table(cols, npartitions=1, meta=self.meta)

    def take(self, indices) -> "Table":
        idx = np.asarray(indices)
        cols = {k: v[idx] for k, v in self._columns.items()}
        return Table(cols, npartitions=self.npartitions, meta=self.meta)

    # -- fluent API (reference ``core/.../core/spark/FluentAPI.scala:14-20``:
    # ``df.mlTransform(stage, ...)`` / ``df.mlFit(estimator)``) ------------------

    def ml_transform(self, *stages) -> "Table":
        """Apply one or more transformers in sequence."""
        out = self
        for st in stages:
            out = st.transform(out)
        return out

    def ml_fit(self, estimator):
        """Fit an estimator on this table, returning its model."""
        return estimator.fit(self)

    def filter(self, mask) -> "Table":
        mask = np.asarray(mask, dtype=bool)
        return self.take(np.nonzero(mask)[0])

    def sample(self, frac: float, seed: int = 0, replace: bool = False) -> "Table":
        rng = np.random.default_rng(seed)
        k = int(round(frac * self._num_rows))
        idx = rng.choice(self._num_rows, size=k, replace=replace)
        return self.take(np.sort(idx))

    def shuffle(self, seed: int = 0) -> "Table":
        rng = np.random.default_rng(seed)
        return self.take(rng.permutation(self._num_rows))

    def random_split(self, fractions: Sequence[float], seed: int = 0) -> List["Table"]:
        """Reference analogue: ``df.randomSplit`` (used by TrainValidationSplit etc.)."""
        fracs = np.asarray(fractions, dtype=float)
        fracs = fracs / fracs.sum()
        rng = np.random.default_rng(seed)
        perm = rng.permutation(self._num_rows)
        bounds = np.floor(np.cumsum(fracs) * self._num_rows).astype(int)
        bounds[-1] = self._num_rows  # cumsum can float to <1.0; never drop tail rows
        out, start = [], 0
        for b in bounds:
            out.append(self.take(np.sort(perm[start:b])))
            start = b
        return out

    # -- partitioning ------------------------------------------------------------

    def repartition(self, n: int) -> "Table":
        t = Table(self._columns, npartitions=n, meta=self.meta)
        return t

    def partition_bounds(self) -> List[Tuple[int, int]]:
        """Even contiguous split of rows into ``npartitions`` ranges."""
        n, p = self._num_rows, self.npartitions
        cuts = [round(i * n / p) for i in range(p + 1)]
        return [(cuts[i], cuts[i + 1]) for i in range(p)]

    def partitions(self) -> Iterator["Table"]:
        for lo, hi in self.partition_bounds():
            yield self.slice(lo, hi)

    def map_partitions(
        self,
        fn: Callable[["Table", int], "Table"],
        parallel: bool = False,
        max_workers: Optional[int] = None,
    ) -> "Table":
        """Apply ``fn(partition_table, partition_index) -> Table`` per partition and
        concatenate results, preserving partition count. The reference's
        ``mapPartitions``; ``parallel=True`` runs partitions on a thread pool (native /
        IO-bound stages release the GIL; XLA stages should instead batch whole-table).
        """
        parts = list(self.partitions())
        if parallel and len(parts) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=max_workers or len(parts)) as ex:
                results = list(ex.map(lambda t: fn(t[1], t[0]), enumerate(parts)))
        else:
            results = [fn(p, i) for i, p in enumerate(parts)]
        out = concat_tables(results)
        return Table(out._columns, npartitions=self.npartitions, meta={**self.meta, **out.meta})

    # -- misc --------------------------------------------------------------------

    def cache(self) -> "Table":
        return self  # eager substrate: no-op, kept for API parity (``Cacher`` stage)

    def __repr__(self):
        schema = ", ".join(f"{k}: {t}" for k, t in self.schema().items())
        return f"Table[{self._num_rows} rows x {len(self._columns)} cols, {self.npartitions} parts]({schema})"


def jsonable_value(v):
    """Coerce a table cell to a plain-JSON value (shared by the PowerBI and
    AzureSearch writers and any row-to-JSON path)."""
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def features_matrix(col: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Coerce a features column (dense 2-D or object array of vectors) to an
    (n, d) float matrix — the one shared conversion every vector-consuming
    stage uses (GBDT/KNN/isolation forest/...)."""
    if col.dtype == object:
        return np.stack([np.asarray(v, dtype=dtype) for v in col])
    return np.asarray(col, dtype=dtype)


def concat_tables(tables: Sequence[Table]) -> Table:
    tables = [t for t in tables if t.num_rows > 0 or t.column_names]
    if not tables:
        return Table({})
    names = tables[0].column_names
    for i, t in enumerate(tables[1:], 1):
        if set(t.column_names) != set(names):
            raise ValueError(
                f"concat_tables: table {i} columns {sorted(t.column_names)} != "
                f"table 0 columns {sorted(names)}"
            )
    cols = {}
    for n in names:
        parts = [t.column(n) for t in tables]
        if any(p.dtype == object for p in parts):
            total = sum(len(p) for p in parts)
            arr = np.empty(total, dtype=object)
            i = 0
            for p in parts:
                arr[i : i + len(p)] = p
                i += len(p)
            cols[n] = arr
        else:
            cols[n] = np.concatenate(parts, axis=0)
    meta = {}
    for t in tables:
        meta.update(t.meta)
    return Table(cols, npartitions=max(t.npartitions for t in tables), meta=meta)
