"""Train helpers (reference ``core/.../train/``, SURVEY.md §2.3)."""

from .stages import (
    ComputeModelStatistics, ComputePerInstanceStatistics, TrainClassifier,
    TrainRegressor, TrainedClassifierModel, TrainedRegressorModel,
)

__all__ = [
    "TrainClassifier", "TrainedClassifierModel", "TrainRegressor",
    "TrainedRegressorModel", "ComputeModelStatistics",
    "ComputePerInstanceStatistics",
]
