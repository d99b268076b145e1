"""Static table schemas — the plan-time type system for pipelines.

A copy of the JAX package's module of the same name (which imports no JAX
either); the port keeps its own copy so that it imports nothing of that package.


The reference's stage contract is built on SparkML's ``transformSchema``:
every ``Estimator``/``Transformer`` statically declares how it maps an
input schema to an output schema (``PipelineStage.transformSchema``, used
by ``Pipeline.fit`` before any executor work is scheduled), so a mis-wired
pipeline fails in milliseconds at plan time. The rebuild's eager
``transform`` lost that: a missing or mistyped column only surfaced when
``_validate_input`` threw mid-``transform``, after upstream stages had
already burned device time.

This module restores the static half, deliberately coarser than numpy
dtypes (schemas must survive JSON, serving payloads, and "float32 vs
float64" irrelevancies):

- :class:`ColumnSpec` — a column's **dtype class** (``float`` / ``int`` /
  ``bool`` / ``object`` / ``any``) and **shape role** (``scalar`` — a 1-D
  column; ``vector`` — one vector per row; ``tensor`` — higher-rank per
  row; ``image`` — a tensor column carrying image semantics; ``any``).
- :class:`TableSchema` — ordered name -> :class:`ColumnSpec` mapping,
  derivable from a live :class:`~synapseml_tpu_torch.core.table.Table`
  (:meth:`TableSchema.from_table`), JSON round-trippable (serving
  admission sends the expected schema back in 400 replies).
- :class:`SchemaError` — reports **all** missing columns at once with
  nearest-name suggestions (difflib), not just the first.

Stages declare their contract via ``input_schema()`` /
``transform_schema()`` / ``fit_schema()`` on ``PipelineStage``
(``core/stage.py``); ``Pipeline.validate`` threads a schema through every
stage **statically** — numpy only, no device work.
"""

from __future__ import annotations

import difflib
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "ColumnSpec",
    "TableSchema",
    "SchemaError",
    "PipelineSchemaError",
    "dtype_class_of",
    "nearest_name",
]

DTYPE_CLASSES = ("float", "int", "bool", "object", "any")
SHAPE_ROLES = ("scalar", "vector", "tensor", "image", "any")


def dtype_class_of(dtype) -> str:
    """Coarse class of a numpy dtype: float / int / bool / object."""
    kind = np.dtype(dtype).kind
    if kind == "f":
        return "float"
    if kind in ("i", "u"):
        return "int"
    if kind == "b":
        return "bool"
    return "object"  # O, U, S, V, M, ...


def nearest_name(name: str, candidates: Iterable[str]) -> Optional[str]:
    """Closest candidate to ``name`` (difflib), or None when nothing is
    plausibly a typo — the "did you mean" half of schema errors."""
    matches = difflib.get_close_matches(name, list(candidates), n=1,
                                        cutoff=0.6)
    return matches[0] if matches else None


class SchemaError(ValueError):
    """A static schema violation. ``missing`` lists every absent column
    (all at once, with suggestions already baked into the message);
    ``mismatched`` lists ``(column, expected, actual)`` spec conflicts."""

    def __init__(self, message: str,
                 missing: Sequence[str] = (),
                 mismatched: Sequence[Tuple[str, "ColumnSpec",
                                            "ColumnSpec"]] = ()):
        super().__init__(message)
        self.missing = list(missing)
        self.mismatched = list(mismatched)


class PipelineSchemaError(SchemaError):
    """A :class:`SchemaError` localized to one pipeline stage: carries the
    stage index and the offending stage so callers can report "stage 2
    (ValueIndexer...) ..." without re-parsing the message."""

    def __init__(self, message: str, stage_index: int, stage: Any,
                 cause: Optional[SchemaError] = None):
        super().__init__(message,
                         missing=cause.missing if cause else (),
                         mismatched=cause.mismatched if cause else ())
        self.stage_index = stage_index
        self.stage = stage


class ColumnSpec:
    """One column's (dtype class, shape role). ``any`` wildcards either
    axis; :meth:`accepts` is the compatibility relation consumers use
    (``float`` accepts ``int``/``bool`` inputs — upcast is lossless;
    ``tensor`` accepts ``image``/``vector`` — images and vectors *are*
    tensors)."""

    __slots__ = ("dtype_class", "role")

    def __init__(self, dtype_class: str = "any", role: str = "any"):
        if dtype_class not in DTYPE_CLASSES:
            raise ValueError(f"unknown dtype class {dtype_class!r}; "
                             f"one of {DTYPE_CLASSES}")
        if role not in SHAPE_ROLES:
            raise ValueError(f"unknown shape role {role!r}; "
                             f"one of {SHAPE_ROLES}")
        self.dtype_class = dtype_class
        self.role = role

    # -- construction ------------------------------------------------------

    @classmethod
    def parse(cls, spec: Union["ColumnSpec", str, Tuple[str, str]]
              ) -> "ColumnSpec":
        """Coerce ``"float"`` / ``"float:vector"`` / ``("float", "vector")``
        / a ColumnSpec into a ColumnSpec."""
        if isinstance(spec, ColumnSpec):
            return spec
        if isinstance(spec, tuple):
            return cls(*spec)
        if isinstance(spec, str):
            if ":" in spec:
                dc, _, role = spec.partition(":")
                return cls(dc, role)
            return cls(spec, "any")
        raise TypeError(f"cannot parse column spec from {spec!r}")

    @classmethod
    def from_column(cls, arr: np.ndarray,
                    meta: Optional[Dict[str, Any]] = None) -> "ColumnSpec":
        """Derive a spec from a live column array (+ its Table meta)."""
        sem = (meta or {}).get("type")
        if arr.dtype == object:
            first = next((v for v in arr if v is not None), None)
            if isinstance(first, np.ndarray):
                role = ("image" if sem == "image"
                        else "vector" if first.ndim == 1 else "tensor")
                return cls(dtype_class_of(first.dtype), role)
            if isinstance(first, tuple):  # sparse (indices, values) pairs
                return cls("object", "vector")
            return cls("object", "scalar")
        if arr.ndim > 1:
            role = ("image" if sem == "image"
                    else "vector" if arr.ndim == 2 else "tensor")
            return cls(dtype_class_of(arr.dtype), role)
        return cls(dtype_class_of(arr.dtype), "scalar")

    # -- relations ---------------------------------------------------------

    def accepts(self, other: "ColumnSpec") -> bool:
        """Would a consumer declaring ``self`` accept a column shaped like
        ``other``?"""
        dc_ok = (self.dtype_class == "any" or other.dtype_class == "any"
                 or self.dtype_class == other.dtype_class
                 or (self.dtype_class == "float"
                     and other.dtype_class in ("int", "bool")))
        role_ok = (self.role == "any" or other.role == "any"
                   or self.role == other.role
                   or (self.role == "tensor"
                       and other.role in ("image", "vector"))
                   or (self.role == "image" and other.role == "tensor"))
        return dc_ok and role_ok

    def __eq__(self, other) -> bool:
        return (isinstance(other, ColumnSpec)
                and self.dtype_class == other.dtype_class
                and self.role == other.role)

    def __hash__(self) -> int:
        return hash((self.dtype_class, self.role))

    def __repr__(self) -> str:
        return f"{self.dtype_class}:{self.role}"

    # -- JSON-value check (serving admission) ------------------------------

    def accepts_json_value(self, v: Any) -> bool:
        """Does a JSON-decoded value fit this spec? The serving admission
        check — a 400 at the front door instead of a worker 500. For
        vector/tensor/image roles the dtype class applies to the (nested)
        list's leaf elements."""
        if self.role in ("vector", "tensor", "image"):
            if not isinstance(v, list):
                return False
            leaves = v
            while leaves and isinstance(leaves[0], list):
                leaves = leaves[0]
            return all(self._leaf_ok(x) for x in leaves[:64])
        if self.role == "scalar" and isinstance(v, list):
            return False
        if self.role == "any" and isinstance(v, list):
            return True  # structure unknown: admit, the stage decides
        return self._leaf_ok(v)

    def _leaf_ok(self, v: Any) -> bool:
        if self.dtype_class == "bool":
            return isinstance(v, bool)
        if self.dtype_class == "int":
            return isinstance(v, int) and not isinstance(v, bool)
        if self.dtype_class == "float":
            return isinstance(v, (int, float)) and not isinstance(v, bool)
        return True  # object / any


class TableSchema:
    """Ordered name -> :class:`ColumnSpec` mapping.

    ``open=True`` marks a schema with **unknown additional columns** (the
    output of an undeclared stage): :meth:`require` then only checks the
    columns it knows about and never reports missing ones — static
    validation degrades gracefully instead of false-positive failing."""

    def __init__(self, columns: Mapping[str, Union[ColumnSpec, str,
                                                   Tuple[str, str]]] = (),
                 open: bool = False):
        self._cols: Dict[str, ColumnSpec] = {
            str(k): ColumnSpec.parse(v) for k, v in dict(columns).items()}
        self.open = bool(open)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_table(cls, table) -> "TableSchema":
        """Derive the schema of a live Table (numpy only)."""
        return cls({name: ColumnSpec.from_column(table.column(name),
                                                 table.meta.get(name))
                    for name in table.column_names})

    @classmethod
    def open_schema(cls) -> "TableSchema":
        """The anything-goes schema an undeclared stage outputs."""
        return cls({}, open=True)

    @classmethod
    def from_dict(cls, d: Mapping[str, str]) -> "TableSchema":
        return cls({k: ColumnSpec.parse(v) for k, v in d.items()})

    def to_dict(self) -> Dict[str, str]:
        """JSON-ready ``{name: "dtype_class:role"}`` — what serving 400
        replies embed so the client sees the expected contract."""
        return {k: repr(v) for k, v in self._cols.items()}

    # -- accessors ---------------------------------------------------------

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> ColumnSpec:
        return self._cols[name]

    def get(self, name: str,
            default: Optional[ColumnSpec] = None) -> Optional[ColumnSpec]:
        return self._cols.get(name, default)

    def __eq__(self, other) -> bool:
        return (isinstance(other, TableSchema) and self.open == other.open
                and self._cols == other._cols)

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}: {v!r}" for k, v in self._cols.items())
        return f"TableSchema({{{inner}}}{', open' if self.open else ''})"

    def describe(self) -> str:
        """Compact human form for error messages: ``{a: float:scalar, ...}``."""
        return "{" + ", ".join(f"{k}: {v!r}" for k, v in self._cols.items()) \
            + ("*" if self.open else "") + "}"

    # -- functional updates ------------------------------------------------

    def with_column(self, name: str,
                    spec: Union[ColumnSpec, str, Tuple[str, str]]
                    ) -> "TableSchema":
        cols = dict(self._cols)
        cols[name] = ColumnSpec.parse(spec)
        return TableSchema(cols, open=self.open)

    def with_columns(self, new: Mapping[str, Any]) -> "TableSchema":
        out = self
        for k, v in new.items():
            out = out.with_column(k, v)
        return out

    def drop(self, *names: str) -> "TableSchema":
        return TableSchema({k: v for k, v in self._cols.items()
                            if k not in names}, open=self.open)

    def select(self, *names: str) -> "TableSchema":
        return TableSchema({n: self._cols[n] for n in names if n in
                            self._cols}, open=self.open)

    def rename(self, mapping: Mapping[str, str]) -> "TableSchema":
        return TableSchema({mapping.get(k, k): v
                            for k, v in self._cols.items()}, open=self.open)

    # -- validation --------------------------------------------------------

    def require(self, needed: Union["TableSchema", Mapping[str, Any],
                                    Sequence[str]],
                stage: Optional[str] = None) -> None:
        """Check this schema satisfies ``needed`` (a TableSchema, a
        name->spec mapping, or just column names). Raises ONE
        :class:`SchemaError` naming **every** missing column (with a
        nearest-name suggestion each) and every dtype/role mismatch.
        Missing columns are not reported when this schema is ``open``."""
        if isinstance(needed, TableSchema):
            need = dict(needed._cols)
        elif isinstance(needed, Mapping):
            need = {k: ColumnSpec.parse(v) for k, v in needed.items()}
        else:
            need = {str(c): ColumnSpec() for c in needed}
        missing: List[str] = []
        mismatched: List[Tuple[str, ColumnSpec, ColumnSpec]] = []
        for name, want in need.items():
            have = self._cols.get(name)
            if have is None:
                if not self.open:
                    missing.append(name)
            elif not want.accepts(have):
                mismatched.append((name, want, have))
        if not missing and not mismatched:
            return
        parts: List[str] = []
        if missing:
            descr = []
            for name in missing:
                sug = nearest_name(name, self._cols)
                descr.append(f"{name!r}"
                             + (f" (did you mean {sug!r}?)" if sug else ""))
            parts.append(f"missing column{'s' if len(missing) > 1 else ''} "
                         + ", ".join(descr)
                         + f"; available: {self.columns}")
        for name, want, have in mismatched:
            parts.append(f"column {name!r} has type {have!r}, "
                         f"expected {want!r}")
        prefix = f"{stage}: " if stage else ""
        raise SchemaError(prefix + "; ".join(parts),
                          missing=missing, mismatched=mismatched)

    def validate_json_payload(self, payload: Any,
                              max_errors: int = 16) -> List[str]:
        """Validate a JSON-decoded request body against this schema —
        the serving admission check. ``payload`` may be one row (object)
        or a list of rows. Returns human-readable error strings (empty =
        admitted); unknown extra fields are allowed."""
        rows = payload if isinstance(payload, list) else [payload]
        errors: List[str] = []
        for i, row in enumerate(rows):
            where = f"row {i}: " if isinstance(payload, list) else ""
            if not isinstance(row, Mapping):
                errors.append(f"{where}expected a JSON object with fields "
                              f"{self.columns}, got {type(row).__name__}")
            else:
                for name, spec in self._cols.items():
                    if name not in row:
                        sug = nearest_name(name, row)
                        errors.append(
                            f"{where}missing field {name!r} ({spec!r})"
                            + (f" — did you mean {sug!r}?" if sug else ""))
                    elif not spec.accepts_json_value(row[name]):
                        errors.append(
                            f"{where}field {name!r} should be {spec!r}, "
                            f"got {type(row[name]).__name__}")
            if len(errors) >= max_errors:
                errors.append("... (further errors truncated)")
                break
        return errors
