"""Nearest neighbours on the card (port of ``synapseml_tpu/nn``): exact KNN and
label-filtered ConditionalKNN by maximum inner product, ranked by hand kernel
K (``topk.topk_select``, the reference's ``lax.top_k`` order)."""

from .knn import KNN, ConditionalKNN, ConditionalKNNModel, KNNModel  # noqa: F401
from .topk import topk_select, topk_select_plain  # noqa: F401

__all__ = ["KNN", "KNNModel", "ConditionalKNN", "ConditionalKNNModel", "topk_select",
           "topk_select_plain"]
