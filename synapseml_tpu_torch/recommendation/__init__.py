"""Recommendation (port of ``synapseml_tpu/recommendation``): SAR on the card,
ranked by hand kernel K, and the ranking stack's adapters, evaluator,
train/validation split and id indexer (numpy on the host)."""

from .ranking import (AdvancedRankingMetrics, RankingAdapter, RankingAdapterModel,  # noqa: F401
                      RankingEvaluator, RankingTrainValidationSplit,
                      RankingTrainValidationSplitModel, RecommendationIndexer,
                      RecommendationIndexerModel)
from .sar import SAR, SARModel  # noqa: F401

__all__ = ["SAR", "SARModel", "AdvancedRankingMetrics", "RankingAdapter",
           "RankingAdapterModel", "RankingEvaluator", "RankingTrainValidationSplit",
           "RankingTrainValidationSplitModel", "RecommendationIndexer",
           "RecommendationIndexerModel"]
