"""Auto-featurization (reference ``core/.../featurize/``, SURVEY.md §2.3)."""

from .stages import (
    CleanMissingData, FastVectorAssembler, CleanMissingDataModel, CountSelector, CountSelectorModel,
    DataConversion, Featurize, FeaturizeModel, IndexToValue, ValueIndexer,
    ValueIndexerModel,
)
from .text import MultiNGram, PageSplitter, TextFeaturizer, TextFeaturizerModel

__all__ = [
    "CleanMissingData", "CleanMissingDataModel", "ValueIndexer",
    "ValueIndexerModel", "IndexToValue", "DataConversion", "CountSelector",
    "CountSelectorModel", "Featurize", "FeaturizeModel", "FastVectorAssembler",
    "TextFeaturizer", "TextFeaturizerModel", "MultiNGram", "PageSplitter",
]
