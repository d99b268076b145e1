"""Isolation forest anomaly detection (port of ``synapseml_tpu/isolationforest``):
trees built on the host, scored on the card through kernel B."""

from .forest import IsolationForest, IsolationForestModel  # noqa: F401

__all__ = ["IsolationForest", "IsolationForestModel"]
