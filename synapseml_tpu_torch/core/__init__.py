"""Core substrate of the port: params, schemas, tables, stages, persistence,
timing and retry helpers."""

from .clock import StopWatch, buffered_map  # noqa: F401
from .fault import retry_with_backoff, retry_with_timeout, using, using_many  # noqa: F401
from .params import ComplexParam, Param, Params, ParamValidators  # noqa: F401
from .schema import ColumnSpec, SchemaError, TableSchema  # noqa: F401
from .serialization import load_stage, save_stage  # noqa: F401
from .stage import (  # noqa: F401
    STAGE_NAME_COLLISIONS,
    STAGE_REGISTRY,
    CarriedModel,
    Estimator,
    Model,
    Pipeline,
    PipelineModel,
    PipelineStage,
    Transformer,
    UnaryTransformer,
)
from .table import Table, concat_tables  # noqa: F401
