"""Data balance analysis (fairness measures).

Reference package: ``core/src/main/scala/.../exploratory/`` (~712 LoC —
``FeatureBalanceMeasure.scala``, ``DistributionBalanceMeasure.scala``,
``AggregateBalanceMeasure.scala``, ``DataBalanceParams.scala``).
"""

from .balance import (
    AggregateBalanceMeasure,
    DistributionBalanceMeasure,
    FeatureBalanceMeasure,
)

__all__ = ["FeatureBalanceMeasure", "DistributionBalanceMeasure",
           "AggregateBalanceMeasure"]
