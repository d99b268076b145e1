"""CyberML's feature stages: per-partition indexers and scalers, and
complement-access sampling (the port's copies of the JAX package's
``cyber/indexers.py``, ``scalers.py`` and ``complement.py``).

Reference package: ``core/src/main/python/synapse/ml/cyber/`` —
``anomaly/complement_access.py``, ``feature/indexers.py``,
``feature/scalers.py``.
"""

from .complement import ComplementAccessTransformer
from .indexers import IdIndexer, IdIndexerModel, MultiIndexer, MultiIndexerModel
from .scalers import (LinearScalarScaler, LinearScalarScalerModel, StandardScalarScaler,
                      StandardScalarScalerModel)

__all__ = [
    "ComplementAccessTransformer",
    "IdIndexer", "IdIndexerModel", "MultiIndexer", "MultiIndexerModel",
    "LinearScalarScaler", "LinearScalarScalerModel",
    "StandardScalarScaler", "StandardScalarScalerModel",
]
