"""Core substrate of the port: params, schemas, tables, stages, persistence."""

from .params import ComplexParam, Param, Params, ParamValidators  # noqa: F401
from .schema import ColumnSpec, SchemaError, TableSchema  # noqa: F401
from .serialization import load_stage, save_stage  # noqa: F401
from .stage import (  # noqa: F401
    STAGE_NAME_COLLISIONS,
    STAGE_REGISTRY,
    Estimator,
    Model,
    Pipeline,
    PipelineModel,
    PipelineStage,
    Transformer,
    UnaryTransformer,
)
from .table import Table, concat_tables  # noqa: F401
