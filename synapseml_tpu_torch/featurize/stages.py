"""Auto-featurization stages (the port's copy of the JAX package's
``featurize/stages.py``; ``FeaturizeModel`` one-hot encodes and hashes a
column at a time instead of a row at a time, with the same output).

Reference: ``core/.../featurize/`` (1566 LoC) — ``CleanMissingData.scala``,
``ValueIndexer.scala``, ``IndexToValue.scala``, ``DataConversion.scala``,
``CountSelector.scala``, and the ``Featurize.scala:37`` pipeline assembler that
imputes, indexes categoricals, hashes text, and assembles a single vector column.
"""

from __future__ import annotations

from itertools import repeat
from typing import Any, Dict, List

import numpy as np

from ..core import (ColumnSpec, ComplexParam, Estimator, Model, Param, Table,
                    TableSchema, Transformer)
from ..core.params import ParamValidators
from ..native import murmur3_32_batch

__all__ = [
    "CleanMissingData", "CleanMissingDataModel",
    "ValueIndexer", "ValueIndexerModel", "IndexToValue",
    "DataConversion", "CountSelector", "CountSelectorModel",
    "Featurize", "FeaturizeModel",
]


def _clean_missing_schema(stage, schema: TableSchema) -> TableSchema:
    """Shared CleanMissingData(+Model) schema map. Inputs accept ANY
    scalar column — the stage's documented job is cleaning dirty data,
    including object columns holding None (np.asarray maps them to nan);
    a float-only input spec would statically reject exactly the input the
    stage exists to clean. Outputs are always float64 scalars."""
    stage._check_schema(schema, {c: ColumnSpec("any", "scalar")
                                 for c in stage.input_cols})
    outs = list(stage.output_cols) or list(stage.input_cols)
    return schema.with_columns({o: ColumnSpec("float", "scalar")
                                for o in outs})


class CleanMissingData(Estimator):
    """Impute NaN/None in numeric columns (reference ``CleanMissingData.scala``;
    modes Mean | Median | Custom)."""

    input_cols = Param("columns to clean", list, default=[])
    output_cols = Param("output columns (defaults to input_cols)", list, default=[])
    cleaning_mode = Param("Mean | Median | Custom", str, default="Mean",
                          validator=ParamValidators.in_list(["Mean", "Median", "Custom"]))
    custom_value = Param("fill value for Custom mode", float, default=0.0)

    def input_schema(self):
        # "any": dirty object columns (None/NaN mixes) are this stage's job
        return TableSchema({c: ColumnSpec("any", "scalar")
                            for c in self.input_cols})

    def transform_schema(self, schema):
        return _clean_missing_schema(self, schema)

    def _fit(self, table: Table) -> "CleanMissingDataModel":
        self._validate_input(table, *self.input_cols)
        fills: Dict[str, float] = {}
        for c in self.input_cols:
            col = np.asarray(table[c], dtype=np.float64)
            finite = col[np.isfinite(col)]
            if self.cleaning_mode == "Mean":
                fills[c] = float(finite.mean()) if len(finite) else 0.0
            elif self.cleaning_mode == "Median":
                fills[c] = float(np.median(finite)) if len(finite) else 0.0
            else:
                fills[c] = float(self.custom_value)
        return CleanMissingDataModel(
            input_cols=list(self.input_cols),
            output_cols=list(self.output_cols) or list(self.input_cols),
            fill_values=fills)


class CleanMissingDataModel(Model):
    input_cols = Param("columns to clean", list, default=[])
    output_cols = Param("output columns", list, default=[])
    fill_values = ComplexParam("column -> fill value", dict, default={})

    def input_schema(self):
        # "any": dirty object columns (None/NaN mixes) are this stage's job
        return TableSchema({c: ColumnSpec("any", "scalar")
                            for c in self.input_cols})

    def transform_schema(self, schema):
        return _clean_missing_schema(self, schema)

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, *self.input_cols)
        out = table
        for c, o in zip(self.input_cols, self.output_cols):
            col = np.asarray(table[c], dtype=np.float64).copy()
            col[~np.isfinite(col)] = self.fill_values[c]
            out = out.with_column(o, col)
        return out


class ValueIndexer(Estimator):
    """Categorical value -> dense index (reference ``ValueIndexer.scala``)."""

    input_col = Param("column to index", str, default="input")
    output_col = Param("indexed output column", str, default="output")

    def input_schema(self):
        return TableSchema({self.input_col: ColumnSpec("any", "scalar")})

    def transform_schema(self, schema):
        self._check_schema(schema, self.input_schema())
        return schema.with_column(self.output_col,
                                  ColumnSpec("int", "scalar"))

    def _fit(self, table: Table) -> "ValueIndexerModel":
        self._validate_input(table, self.input_col)
        vals = table[self.input_col]
        levels = sorted({v for v in vals.tolist() if v is not None},
                        key=lambda v: (str(type(v)), v))
        return ValueIndexerModel(
            input_col=self.input_col, output_col=self.output_col,
            levels=np.array(levels, dtype=object))


class ValueIndexerModel(Model):
    input_col = Param("column to index", str, default="input")
    output_col = Param("indexed output column", str, default="output")
    levels = ComplexParam("index -> value array", object, default=None)

    def input_schema(self):
        return TableSchema({self.input_col: ColumnSpec("any", "scalar")})

    def transform_schema(self, schema):
        self._check_schema(schema, self.input_schema())
        return schema.with_column(self.output_col,
                                  ColumnSpec("int", "scalar"))

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        lut = {v: i for i, v in enumerate(self.levels)}
        col = table[self.input_col]
        out = np.array([lut.get(v, -1) for v in col.tolist()], dtype=np.int64)
        return table.with_column(self.output_col, out,
                                 meta={"type": "categorical",
                                       "num_levels": len(self.levels)})


class IndexToValue(Transformer):
    """Inverse of ValueIndexer given its levels (reference ``IndexToValue.scala``)."""

    input_col = Param("indexed column", str, default="input")
    output_col = Param("value output column", str, default="output")
    levels = ComplexParam("index -> value array", object, default=None)

    def input_schema(self):
        return TableSchema({self.input_col: ColumnSpec("int", "scalar")})

    def transform_schema(self, schema):
        self._check_schema(schema, self.input_schema())
        return schema.with_column(self.output_col,
                                  ColumnSpec("object", "scalar"))

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        if self.levels is None:
            raise ValueError(f"IndexToValue({self.uid}): levels not set")
        levels = np.asarray(self.levels, dtype=object)
        idx = np.asarray(table[self.input_col], dtype=np.int64)
        out = np.empty(len(idx), dtype=object)
        ok = (idx >= 0) & (idx < len(levels))
        out[ok] = levels[idx[ok]]
        out[~ok] = None
        return table.with_column(self.output_col, out)


class DataConversion(Transformer):
    """Column dtype conversion (reference ``DataConversion.scala``; convertTo
    boolean|byte|short|integer|long|float|double|string|date)."""

    cols = Param("columns to convert", list, default=[])
    convert_to = Param("target type name", str, default="double",
                       validator=ParamValidators.in_list(
                           ["boolean", "byte", "short", "integer", "long",
                            "float", "double", "string"]))

    _DTYPES = {"boolean": np.bool_, "byte": np.int8, "short": np.int16,
               "integer": np.int32, "long": np.int64, "float": np.float32,
               "double": np.float64}
    _DTYPE_CLASSES = {"boolean": "bool", "byte": "int", "short": "int",
                      "integer": "int", "long": "int", "float": "float",
                      "double": "float", "string": "object"}

    def input_schema(self):
        return TableSchema({c: ColumnSpec("any", "scalar")
                            for c in self.cols})

    def transform_schema(self, schema):
        self._check_schema(schema, self.input_schema())
        target = ColumnSpec(self._DTYPE_CLASSES[self.convert_to], "scalar")
        return schema.with_columns({c: target for c in self.cols})

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, *self.cols)
        out = table
        for c in self.cols:
            col = table[c]
            if self.convert_to == "string":
                conv = np.array([None if v is None else str(v)
                                 for v in col.tolist()], dtype=object)
            else:
                conv = np.asarray(col).astype(self._DTYPES[self.convert_to])
            out = out.with_column(c, conv)
        return out


class CountSelector(Estimator):
    """Drop all-zero / constant vector slots (reference ``CountSelector.scala``
    removes features with no nonzero values)."""

    input_col = Param("vector column", str, default="features")
    output_col = Param("selected output column", str, default="features")

    def input_schema(self):
        return TableSchema({self.input_col: ColumnSpec("float", "vector")})

    def transform_schema(self, schema):
        self._check_schema(schema, self.input_schema())
        return schema.with_column(self.output_col,
                                  ColumnSpec("float", "vector"))

    def _fit(self, table: Table) -> "CountSelectorModel":
        self._validate_input(table, self.input_col)
        x = np.asarray(table[self.input_col], dtype=np.float64)
        keep = np.nonzero((x != 0).any(axis=0))[0]
        return CountSelectorModel(input_col=self.input_col,
                                  output_col=self.output_col, indices=keep)


class CountSelectorModel(Model):
    input_col = Param("vector column", str, default="features")
    output_col = Param("selected output column", str, default="features")
    indices = ComplexParam("kept slot indices", object, default=None)

    def input_schema(self):
        return TableSchema({self.input_col: ColumnSpec("float", "vector")})

    def transform_schema(self, schema):
        self._check_schema(schema, self.input_schema())
        return schema.with_column(self.output_col,
                                  ColumnSpec("float", "vector"))

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        x = np.asarray(table[self.input_col], dtype=np.float64)
        return table.with_column(self.output_col, x[:, np.asarray(self.indices)])


class Featurize(Estimator):
    """Auto-featurize arbitrary columns into one numeric vector
    (reference ``Featurize.scala:37``): numeric -> impute; categorical/string ->
    one-hot (when few levels) or hash; text -> token hashing; assembles a single
    ``output_col`` vector. The engine behind TrainClassifier/TrainRegressor."""

    input_cols = Param("columns to featurize", list, default=[])
    output_col = Param("assembled vector column", str, default="features")
    one_hot_encode_categoricals = Param("one-hot categoricals", bool, default=True)
    num_features = Param("hash space for text/high-cardinality columns", int,
                         default=262144)
    max_one_hot = Param("max levels for one-hot before hashing", int, default=64)

    def input_schema(self):
        return TableSchema({c: ColumnSpec() for c in self.input_cols})

    def transform_schema(self, schema):
        self._check_schema(schema, self.input_schema())
        return schema.with_column(self.output_col,
                                  ColumnSpec("float", "vector"))

    def _fit(self, table: Table) -> "FeaturizeModel":
        self._validate_input(table, *self.input_cols)
        plan: List[Dict[str, Any]] = []
        for c in self.input_cols:
            col = table[c]
            if col.dtype != object and col.ndim > 1:
                plan.append({"col": c, "kind": "vector", "dim": int(np.prod(col.shape[1:]))})
            elif col.dtype != object and np.issubdtype(col.dtype, np.number):
                finite = np.asarray(col, np.float64)
                finite = finite[np.isfinite(finite)]
                plan.append({"col": c, "kind": "numeric",
                             "fill": float(finite.mean()) if len(finite) else 0.0})
            else:
                vals = [v for v in col.tolist() if v is not None]
                uniq = sorted({str(v) for v in vals})
                if (self.one_hot_encode_categoricals
                        and len(uniq) <= self.max_one_hot):
                    plan.append({"col": c, "kind": "onehot", "levels": uniq})
                else:
                    plan.append({"col": c, "kind": "hash",
                                 "bits": int(np.log2(self.num_features))})
        return FeaturizeModel(input_cols=list(self.input_cols),
                              output_col=self.output_col, plan=plan)


class FeaturizeModel(Model):
    input_cols = Param("columns to featurize", list, default=[])
    output_col = Param("assembled vector column", str, default="features")
    plan = ComplexParam("per-column featurization plan", list, default=[])

    def input_schema(self):
        return TableSchema({c: ColumnSpec() for c in self.input_cols})

    def transform_schema(self, schema):
        self._check_schema(schema, self.input_schema())
        return schema.with_column(self.output_col,
                                  ColumnSpec("float", "vector"))

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, *self.input_cols)
        n = table.num_rows
        parts: List[np.ndarray] = []
        for spec in self.plan:
            col = table[spec["col"]]
            kind = spec["kind"]
            if kind == "vector":
                parts.append(np.asarray(col, np.float64).reshape(n, -1))
            elif kind == "numeric":
                v = np.asarray(col, np.float64).reshape(n, 1).copy()
                v[~np.isfinite(v)] = spec["fill"]
                parts.append(v)
            elif kind == "onehot":
                out = np.zeros((n, len(spec["levels"])), np.float64)
                rows, slots = _level_codes(col, spec["levels"])
                out[rows, slots] = 1.0
                parts.append(out)
            else:  # hash: token-hash strings into a fixed space
                dim = 1 << spec["bits"]
                if dim > 4096:
                    import warnings
                    warnings.warn(
                        f"hash space 2^{spec['bits']} exceeds the dense-assembly "
                        "cap of 4096; indices are folded into 4096 dims (higher "
                        "collision rate). Use VowpalWabbitFeaturizer for a true "
                        "sparse space.", stacklevel=2)
                    dim = 4096
                out = np.zeros((n, dim), np.float64)
                rows, toks = [], []
                for r, v in enumerate(col.tolist()):
                    if v is not None:
                        t = str(v).split()
                        rows.extend([r] * len(t))
                        toks.extend(t)
                slots = murmur3_32_batch(toks).astype(np.int64) % dim
                np.add.at(out, (np.asarray(rows, np.int64), slots), 1.0)
                parts.append(out)
        return table.with_column(self.output_col, np.concatenate(parts, axis=1))


def _level_codes(col: np.ndarray, levels: List[str]):
    """(rows, slots) of the values of ``col`` whose ``str`` is one of
    ``levels`` (None matches nothing): the one-hot cells, by one dict lookup
    a value (a value that is not a string and misses is looked up again as
    its ``str``)."""
    get = {lv: i for i, lv in enumerate(levels)}.get
    values = np.asarray(col, dtype=object).tolist()
    code = np.fromiter(map(get, values, repeat(-1)), np.int64, len(values))
    for i in np.nonzero(code < 0)[0].tolist():
        v = values[i]
        if v is not None and not isinstance(v, str):
            code[i] = get(str(v), -1)
    rows = np.nonzero(code >= 0)[0]
    return rows, code[rows]


class FastVectorAssembler(Transformer):
    """Assemble numeric/vector columns into one vector, categoricals first.

    Reference ``org/apache/spark/ml/feature/FastVectorAssembler.scala:23``:
    categorical columns must precede all others (downstream learners map
    categorical slots by index), and only categorical slot metadata is
    propagated — spurious numeric attributes are dropped for speed. Here a
    column is categorical when its Table metadata carries ``categorical:
    True``; the output column's ``slot_names`` lists the categorical slots."""

    input_cols = Param("columns to assemble", list, default=[])
    output_col = Param("assembled vector column", str, default="features")

    def input_schema(self):
        # numeric scalars or vectors; float accepts int/bool columns
        return TableSchema({c: ColumnSpec("float", "any")
                            for c in self.input_cols})

    def transform_schema(self, schema):
        self._check_schema(schema, self.input_schema())
        return schema.with_column(self.output_col,
                                  ColumnSpec("float", "vector"))

    def _transform(self, table: Table) -> Table:
        if not self.input_cols:
            raise ValueError(
                f"FastVectorAssembler({self.uid}): input_cols is empty")
        self._validate_input(table, *self.input_cols)
        parts: List[np.ndarray] = []
        slot_names: List[str] = []
        seen_numeric = False
        for c in self.input_cols:
            col = table[c]
            if col.dtype == object:
                raise ValueError(
                    f"FastVectorAssembler({self.uid}): column {c!r} is not "
                    "numeric/vector (featurize or index it first)")
            block = (np.asarray(col, np.float64).reshape(table.num_rows, -1))
            is_cat = bool(table.meta.get(c, {}).get("categorical"))
            if is_cat:
                if seen_numeric:
                    raise ValueError(
                        "Categorical columns must precede all others, "
                        f"column out of order: {c}")
                names = table.meta.get(c, {}).get("slot_names")
                if names is None:
                    names = ([c] if block.shape[1] == 1 else
                             [f"{c}_{i}" for i in range(block.shape[1])])
                slot_names.extend(names)
            else:
                seen_numeric = True
            parts.append(block)
        out = np.concatenate(parts, axis=1)
        meta = {"slot_names": slot_names + [""] * (out.shape[1] - len(slot_names)),
                "num_categorical": len(slot_names)} if slot_names else None
        return table.with_column(self.output_col, out, meta=meta)


__all__.append("FastVectorAssembler")
