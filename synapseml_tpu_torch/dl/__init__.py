"""Deep-learning stages: ONNX-backed image featurization and the model
repository (port of ``synapseml_tpu/dl``)."""

from .downloader import (LocalRepository, ModelDownloader, ModelSchema,  # noqa: F401
                         RemoteRepository, Repository, ZooRepository)
from .featurizer import ImageFeaturizer  # noqa: F401

__all__ = ["ImageFeaturizer", "ModelDownloader", "RemoteRepository", "ModelSchema",
           "Repository", "LocalRepository", "ZooRepository"]
