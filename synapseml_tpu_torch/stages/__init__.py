"""Utility pipeline stages (reference: ``core/src/main/scala/.../stages/``)."""

from .basic import (
    Cacher,
    DropColumns,
    Explode,
    Lambda,
    RenameColumn,
    Repartition,
    SelectColumns,
    Timer,
    TimerModel,
    UDFTransformer,
)
from .batching import (
    DynamicMiniBatchTransformer,
    FixedMiniBatchTransformer,
    FlattenBatch,
    PartitionConsolidator,
    TimeIntervalMiniBatchTransformer,
)
from .grouping import (
    ClassBalancer,
    ClassBalancerModel,
    EnsembleByKey,
    StratifiedRepartition,
    SummarizeData,
)
from .text import MultiColumnAdapter, TextPreprocessor, UnicodeNormalize

__all__ = [
    "Cacher",
    "DropColumns",
    "Explode",
    "Lambda",
    "RenameColumn",
    "Repartition",
    "SelectColumns",
    "Timer",
    "TimerModel",
    "UDFTransformer",
    "DynamicMiniBatchTransformer",
    "FixedMiniBatchTransformer",
    "FlattenBatch",
    "PartitionConsolidator",
    "TimeIntervalMiniBatchTransformer",
    "ClassBalancer",
    "ClassBalancerModel",
    "EnsembleByKey",
    "StratifiedRepartition",
    "SummarizeData",
    "MultiColumnAdapter",
    "TextPreprocessor",
    "UnicodeNormalize",
]
