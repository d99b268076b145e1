"""Pipeline stage abstractions: Transformer / Estimator / Model / Pipeline.

The port's counterpart of the JAX package's ``core/stage.py``: the same
SparkML stage contract over :class:`~synapseml_tpu_torch.core.table.Table`,
with a stage registry of its OWN. The reference registry keys on the bare
class name, so a port class named ``LightGBMClassifier`` registered there
would shadow the reference class in save/load; keeping two registries means
the two packages can live in one process (the parity tests do exactly that).

Left out on purpose: the reference's stage spans and telemetry hooks
(observability is ported in a later slice).
"""

from __future__ import annotations

import inspect
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .params import ComplexParam, Param, Params
from .schema import ColumnSpec, PipelineSchemaError, SchemaError, TableSchema
from .table import Table

__all__ = [
    "PipelineStage",
    "Transformer",
    "Estimator",
    "Model",
    "Pipeline",
    "PipelineModel",
    "UnaryTransformer",
    "STAGE_REGISTRY",
    "STAGE_NAME_COLLISIONS",
    "register_stage",
    "stage_class",
]

# name -> class, for save/load.
STAGE_REGISTRY: Dict[str, type] = {}

# name -> module list, recorded whenever two modules register the same class
# name (load_stage resolves by NAME, so the later registration shadows).
STAGE_NAME_COLLISIONS: Dict[str, List[str]] = {}


def register_stage(cls):
    prev = STAGE_REGISTRY.get(cls.__name__)
    if prev is not None and prev.__module__ != cls.__module__:
        mods = STAGE_NAME_COLLISIONS.setdefault(cls.__name__, [prev.__module__])
        if cls.__module__ not in mods:
            mods.append(cls.__module__)
        logging.getLogger("synapseml_tpu_torch").warning(
            "stage name collision: %s defined in both %s and %s; later wins "
            "for load_stage", cls.__name__, prev.__module__, cls.__module__)
    STAGE_REGISTRY[cls.__name__] = cls
    return cls


def stage_class(name: str) -> type:
    try:
        return STAGE_REGISTRY[name]
    except KeyError:
        raise KeyError(f"Unknown stage class {name!r}. Registered: "
                       f"{sorted(STAGE_REGISTRY)}") from None


class PipelineStage(Params):
    """Common base: params + uid + save/load.

    Framework bases opt out of registration with ``_abstract_stage = True``
    in their own class body.
    """

    _abstract_stage = True

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        is_abstract = cls.__dict__.get("_abstract_stage", False) or inspect.isabstract(cls)
        if not is_abstract and not cls.__name__.startswith("_"):
            register_stage(cls)

    def save(self, path: str) -> None:
        from .serialization import save_stage

        save_stage(self, path)

    @staticmethod
    def load(path: str) -> "PipelineStage":
        from .serialization import load_stage

        return load_stage(path)

    # -- static schema contract (SparkML transformSchema analogue) ----------

    def input_schema(self) -> Optional[TableSchema]:
        """The minimal input schema ``transform``/``fit`` needs, or None."""
        return None

    def transform_schema(self, schema: TableSchema) -> Optional[TableSchema]:
        """Statically map an input schema to the output schema; raises
        :class:`SchemaError` when ``schema`` cannot feed this stage."""
        ins = self.input_schema()
        if ins is not None:
            self._check_schema(schema, ins)
        return None

    def fit_schema(self, schema: TableSchema) -> Optional[TableSchema]:
        return self.transform_schema(schema)

    def _check_schema(self, schema: TableSchema, needed) -> None:
        schema.require(needed, stage=f"{type(self).__name__}({self.uid})")

    def _validate_input(self, table: Table, *needed_cols: str) -> None:
        missing = [c for c in needed_cols if c not in table]
        if not missing:
            return
        from .schema import nearest_name

        parts = []
        for c in missing:
            sug = nearest_name(c, table.column_names)
            parts.append(f"{c!r}" + (f" (did you mean {sug!r}?)" if sug else ""))
        msg = (f"{type(self).__name__}({self.uid}): input is missing "
               f"column{'s' if len(missing) > 1 else ''} "
               + ", ".join(parts)
               + f"; available: {table.column_names}")
        ins = self.input_schema()
        if ins is not None:
            msg += f"; declared input schema: {ins.describe()}"
        raise ValueError(msg)


class Transformer(PipelineStage):
    """Maps a Table to a Table (reference: SparkML ``Transformer``)."""

    _abstract_stage = True

    def transform(self, table: Table) -> Table:
        return self._transform(table)

    def _transform(self, table: Table) -> Table:  # pragma: no cover - abstract
        raise NotImplementedError

    def __call__(self, table: Table) -> Table:
        return self.transform(table)


class Estimator(PipelineStage):
    """Fits a Table, producing a :class:`Model` (reference: SparkML ``Estimator``)."""

    _abstract_stage = True

    def fit(self, table: Table) -> "Model":
        model = self._fit(table)
        model.parent = self
        return model

    def _fit(self, table: Table) -> "Model":  # pragma: no cover - abstract
        raise NotImplementedError


class Model(Transformer):
    """A fitted transformer. ``parent`` points back at the estimator."""

    _abstract_stage = True
    parent: Optional[Estimator] = None

    def _cached(self, slot: str, tag: Any, params: Sequence[str],
                build: Callable[[], Any]) -> Any:
        """``build()``'s result (say, params uploaded to a device), kept under
        ``slot`` for ``tag`` (say, the device) and the current objects of
        ``params``: another tag, or a param set to another object, builds it
        anew. The cache holds the param objects and compares them by
        identity, so a new array never passes for a freed one whose ``id``
        it reuses."""
        objs = tuple(self.get_or_default(p) for p in params)
        cache = self.__dict__.setdefault("_cache", {})
        hit = cache.get(slot)
        if hit is None or hit[0] != tag or any(a is not b for a, b in zip(hit[1], objs)):
            hit = cache[slot] = (tag, objs, build())
        return hit[2]


class CarriedModel(Model):
    """A fitted model whose state is its ``_STATE`` params, named as the
    reference model's: :meth:`state_dict` gives them, so ``RefModel(**
    model.state_dict())`` carries the state across, and :meth:`from_state`
    takes the reference model's params back."""

    _abstract_stage = True
    _STATE: Tuple[str, ...] = ()

    def state_dict(self) -> Dict[str, Any]:
        return {k: self.get_or_default(k) for k in self._STATE}

    @classmethod
    def from_state(cls, state: Dict[str, Any], device: Optional[str] = None):
        """A model on ``device`` from ``state`` (the keys of :attr:`_STATE`
        it has; the others keep their defaults)."""
        return cls(device=device, **{k: state[k] for k in cls._STATE if k in state})


class UnaryTransformer(Transformer):
    """Input column -> output column transformers (schema derived)."""

    _abstract_stage = True

    input_col = Param("input column name", str, default="input")
    output_col = Param("output column name", str, default="output")

    output_spec: Any = None

    def input_schema(self) -> Optional[TableSchema]:
        return TableSchema({self.input_col: ColumnSpec()})

    def transform_schema(self, schema: TableSchema) -> Optional[TableSchema]:
        self._check_schema(schema, self.input_schema())
        spec = (ColumnSpec.parse(self.output_spec) if self.output_spec is not None
                else ColumnSpec())
        return schema.with_column(self.output_col, spec)

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.input_col)
        out = self._transform_column(table.column(self.input_col), table)
        return table.with_column(self.output_col, out)

    def _transform_column(self, col, table: Table):  # pragma: no cover - abstract
        raise NotImplementedError


def _validate_stage_chain(owner, stages: Sequence[PipelineStage],
                          schema_or_table, fitting: bool) -> TableSchema:
    """Thread a schema through ``stages`` statically; raises one
    :class:`PipelineSchemaError` naming the first broken stage."""
    if isinstance(schema_or_table, Table):
        schema = TableSchema.from_table(schema_or_table)
    elif isinstance(schema_or_table, TableSchema):
        schema = schema_or_table
    else:
        schema = TableSchema(schema_or_table)
    for i, st in enumerate(stages):
        mapper = (st.fit_schema if fitting and isinstance(st, Estimator)
                  else st.transform_schema)
        try:
            out = mapper(schema)
        except SchemaError as e:
            raise PipelineSchemaError(
                f"{type(owner).__name__}({owner.uid}) is statically invalid "
                f"at stage {i} ({type(st).__name__}({st.uid})): {e}",
                stage_index=i, stage=st, cause=e) from None
        schema = out if out is not None else TableSchema.open_schema()
    return schema


class Pipeline(Estimator):
    """Sequential composition of stages (reference: SparkML ``Pipeline``)."""

    stages = ComplexParam("list of pipeline stages", list, default=[])

    def __init__(self, stages: Optional[Sequence[PipelineStage]] = None, uid=None, **kw):
        super().__init__(uid=uid, **kw)
        if stages is not None:
            self.set("stages", list(stages))

    def input_schema(self) -> Optional[TableSchema]:
        st = list(self.stages)
        return st[0].input_schema() if st else None

    def validate(self, schema_or_table) -> TableSchema:
        return _validate_stage_chain(self, list(self.stages), schema_or_table,
                                     fitting=True)

    def fit_schema(self, schema: TableSchema) -> Optional[TableSchema]:
        return _validate_stage_chain(self, list(self.stages), schema, fitting=True)

    def _fit(self, table: Table) -> "PipelineModel":
        stages = list(self.stages)
        fitted: List[Transformer] = []
        cur = table
        for i, st in enumerate(stages):
            is_last = i == len(stages) - 1
            if isinstance(st, Estimator):
                m = st.fit(cur)
                if not is_last:
                    cur = m.transform(cur)
                fitted.append(m)
            elif isinstance(st, Transformer):
                if not is_last:
                    cur = st.transform(cur)
                fitted.append(st)
            else:
                raise TypeError(f"Pipeline stage {st!r} is neither Estimator nor Transformer")
        return PipelineModel(stages=fitted)


class PipelineModel(Model):
    """Fitted pipeline: applies each fitted stage in order."""

    stages = ComplexParam("list of fitted transformer stages", list, default=[])

    def __init__(self, stages: Optional[Sequence[Transformer]] = None, uid=None, **kw):
        super().__init__(uid=uid, **kw)
        if stages is not None:
            self.set("stages", list(stages))

    def input_schema(self) -> Optional[TableSchema]:
        st = list(self.stages)
        return st[0].input_schema() if st else None

    def validate(self, schema_or_table) -> TableSchema:
        return _validate_stage_chain(self, list(self.stages), schema_or_table,
                                     fitting=False)

    def transform_schema(self, schema: TableSchema) -> Optional[TableSchema]:
        return _validate_stage_chain(self, list(self.stages), schema, fitting=False)

    def _transform(self, table: Table) -> Table:
        cur = table
        for st in self.stages:
            cur = st.transform(cur)
        return cur
