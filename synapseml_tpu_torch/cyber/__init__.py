"""CyberML: access-anomaly detection by collaborative filtering (ALS on the
card), and its feature stages: per-partition indexers and scalers, and
complement-access sampling (the port's copies of the JAX package's
``cyber/indexers.py``, ``scalers.py`` and ``complement.py``).

Reference package: ``core/src/main/python/synapse/ml/cyber/`` —
``anomaly/collaborative_filtering.py``, ``anomaly/complement_access.py``, ``feature/indexers.py``,
``feature/scalers.py``.
"""

from .anomaly import AccessAnomaly, AccessAnomalyModel, ConnectedComponents
from .complement import ComplementAccessTransformer
from .indexers import IdIndexer, IdIndexerModel, MultiIndexer, MultiIndexerModel
from .scalers import (LinearScalarScaler, LinearScalarScalerModel, StandardScalarScaler,
                      StandardScalarScalerModel)

__all__ = [
    "AccessAnomaly", "AccessAnomalyModel", "ConnectedComponents",
    "ComplementAccessTransformer",
    "IdIndexer", "IdIndexerModel", "MultiIndexer", "MultiIndexerModel",
    "LinearScalarScaler", "LinearScalarScalerModel",
    "StandardScalarScaler", "StandardScalarScalerModel",
]
