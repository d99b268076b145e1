"""Exact (conditional) KNN by maximum inner product, on the card.

Port of ``synapseml_tpu/nn/knn.py`` (reference: ``nn/KNN.scala:48``,
``ConditionalKNN.scala:31``): the same Params and outputs. The index is the
raw (N, d) f32 key matrix, uploaded once a model and device. Queries go in
chunks sized so that a chunk's (rows, N) scores fit :data:`SCORE_BUDGET`;
a chunk is one full-f32 ``torch.matmul`` against the keys, ConditionalKNN
masks the keys whose label the query does not admit with -inf (the (rows, L)
admissible matrix gathered by the keys' label codes on the card, never an
(nq, N) mask on the host), and kernel K (:func:`~.topk.topk_select`) takes
the k best in ``lax.top_k``'s order. ``k`` is cut to N as in the reference;
KNN keeps non-finite scores, ConditionalKNN drops them.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..core import CarriedModel, ComplexParam, Estimator, Param, Table
from ..core.params import ParamValidators
from ..core.table import features_matrix as _matrix
from ..runtime.device import full_f32, resolve_device
from .topk import topk_select

__all__ = ["KNN", "KNNModel", "ConditionalKNN", "ConditionalKNNModel", "SCORE_BUDGET",
           "chunk_rows", "top_k_products"]

_DEVICE_DOC = "'cuda[:i]' (default: the GPU) or 'cpu'"
# bytes of f32 scores a query chunk may hold on the device
SCORE_BUDGET = 2 << 30


def chunk_rows(n_cols: int) -> int:
    """Rows of a (rows, n_cols) f32 chunk that fit :data:`SCORE_BUDGET`
    bytes (at least 1)."""
    return max(1, SCORE_BUDGET // (4 * max(1, n_cols)))


def top_k_products(left: torch.Tensor, right: torch.Tensor, k: int,
                   keep: Optional[Callable[[int, int], torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices), each (rows, min(k, n)), of the k largest entries of
    every row of ``left @ right`` (n columns) in ``lax.top_k``'s order, on
    their device: full-f32 products of row chunks whose (rows, n) scores fit
    :data:`SCORE_BUDGET`, each ranked by kernel K. ``keep(start, stop)``
    gives the chunk's bool mask: False entries score -inf."""
    n = right.shape[1]
    k = min(k, n)
    rows = chunk_rows(n)
    vals, idx = [], []
    with full_f32():
        for s in range(0, left.shape[0], rows):
            scores = torch.matmul(left[s:s + rows], right)
            if keep is not None:
                scores = torch.where(keep(s, s + rows), scores,
                                     torch.tensor(-np.inf, device=scores.device))
            v, i = topk_select(scores, k)
            del scores
            vals.append(v)
            idx.append(i)
    if not vals:
        empty = torch.empty((0, k), device=left.device)
        return empty, empty.long()
    return torch.cat(vals), torch.cat(idx)


class KNN(Estimator):
    """Reference ``KNN.scala:48``: indexes (features, values); queries return
    the k best matches as ``[{value, distance}]`` where distance is the inner
    product (the reference's ``BestMatch``)."""

    features_col = Param("key vector column", str, default="features")
    values_col = Param("payload column returned for matches", str, default="values")
    output_col = Param("output column of match lists", str, default="output")
    k = Param("number of matches", int, default=5, validator=ParamValidators.gt(0))
    leaf_size = Param("accepted for reference API parity (the index has no tree leaves)",
                      int, default=50)
    device = Param(_DEVICE_DOC, str, default=None)

    def _fit(self, table: Table) -> "KNNModel":
        self._validate_input(table, self.features_col, self.values_col)
        return KNNModel(
            features_col=self.features_col, values_col=self.values_col,
            output_col=self.output_col, k=self.k,
            keys=_matrix(table[self.features_col], np.float32),
            values=np.asarray(table[self.values_col], dtype=object), device=self.device)


class _IndexModel(CarriedModel):
    """The key matrix on the device, uploaded once a model and device."""

    _abstract_stage = True

    def _device_keys(self, dev: torch.device) -> torch.Tensor:
        return self._cached("keys", str(dev), ("keys",), lambda: torch.from_numpy(
            np.ascontiguousarray(np.asarray(self.keys), dtype=np.float32)).to(dev))

    def _search(self, queries: np.ndarray, allowed: Optional[np.ndarray] = None,
                codes: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
        dev = resolve_device(self.device)
        keys = self._device_keys(dev)
        q = torch.from_numpy(np.ascontiguousarray(queries, dtype=np.float32)).to(dev)
        keep = None
        if allowed is not None:
            allowed = torch.from_numpy(allowed).to(dev)
            codes = torch.from_numpy(np.asarray(codes, np.int64)).to(dev)
            keep = lambda s, e: allowed[s:e].index_select(1, codes)
        vals, idx = top_k_products(q, keys.T, self.k, keep)
        return vals.cpu().numpy(), idx.cpu().numpy()


class KNNModel(_IndexModel):
    features_col = Param("query vector column", str, default="features")
    values_col = Param("payload column", str, default="values")
    output_col = Param("output column", str, default="output")
    k = Param("number of matches", int, default=5)
    keys = ComplexParam("(N, d) indexed key matrix", object, default=None)
    values = ComplexParam("(N,) payload array", object, default=None)
    device = Param(_DEVICE_DOC, str, default=None)

    _STATE = ("features_col", "values_col", "output_col", "k", "keys", "values")

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.features_col)
        vals, idx = self._search(_matrix(table[self.features_col], np.float32))
        found = np.asarray(self.values, dtype=object)[idx]
        out = np.empty(len(idx), dtype=object)
        for r in range(len(idx)):
            out[r] = [{"value": v, "distance": float(d)} for v, d in zip(found[r], vals[r])]
        return table.with_column(self.output_col, out)


class ConditionalKNN(Estimator):
    """Reference ``ConditionalKNN.scala:31``: like KNN but each query carries
    a conditioner set; only keys whose label is in the set may match."""

    features_col = Param("key vector column", str, default="features")
    values_col = Param("payload column returned for matches", str, default="values")
    label_col = Param("per-key label used for conditioning", str, default="labels")
    conditioner_col = Param("per-query collection of admissible labels", str,
                            default="conditioner")
    output_col = Param("output column of match lists", str, default="output")
    k = Param("number of matches", int, default=5, validator=ParamValidators.gt(0))
    leaf_size = Param("accepted for reference API parity", int, default=50)
    device = Param(_DEVICE_DOC, str, default=None)

    def _fit(self, table: Table) -> "ConditionalKNNModel":
        self._validate_input(table, self.features_col, self.values_col, self.label_col)
        labels = np.asarray(table[self.label_col], dtype=object)
        levels = sorted({l for l in labels.tolist()}, key=repr)
        lut = {l: i for i, l in enumerate(levels)}
        codes = np.array([lut[l] for l in labels.tolist()], dtype=np.int32)
        return ConditionalKNNModel(
            features_col=self.features_col, values_col=self.values_col,
            label_col=self.label_col, conditioner_col=self.conditioner_col,
            output_col=self.output_col, k=self.k,
            keys=_matrix(table[self.features_col], np.float32),
            values=np.asarray(table[self.values_col], dtype=object),
            labels=labels, label_codes=codes, label_levels=np.array(levels, dtype=object),
            device=self.device)


class ConditionalKNNModel(_IndexModel):
    features_col = Param("query vector column", str, default="features")
    values_col = Param("payload column", str, default="values")
    label_col = Param("per-key label column", str, default="labels")
    conditioner_col = Param("per-query admissible-label collection", str,
                            default="conditioner")
    output_col = Param("output column", str, default="output")
    k = Param("number of matches", int, default=5)
    keys = ComplexParam("(N, d) indexed key matrix", object, default=None)
    values = ComplexParam("(N,) payload array", object, default=None)
    labels = ComplexParam("(N,) label array", object, default=None)
    label_codes = ComplexParam("(N,) int codes of labels", object, default=None)
    label_levels = ComplexParam("code -> label", object, default=None)
    device = Param(_DEVICE_DOC, str, default=None)

    _STATE = ("features_col", "values_col", "label_col", "conditioner_col", "output_col",
              "k", "keys", "values", "labels", "label_codes", "label_levels")

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.features_col, self.conditioner_col)
        queries = _matrix(table[self.features_col], np.float32)
        lut = {l: i for i, l in enumerate(self.label_levels)}
        # (nq, L) admissible matrix; labels unseen at fit time admit nothing
        allowed = np.zeros((len(queries), len(lut)), dtype=bool)
        for r, cond in enumerate(table[self.conditioner_col]):
            for l in (cond if isinstance(cond, (list, tuple, set, np.ndarray)) else [cond]):
                i = lut.get(l)
                if i is not None:
                    allowed[r, i] = True
        vals, idx = self._search(queries, allowed, self.label_codes)
        values = np.asarray(self.values, dtype=object)[idx]
        labels = np.asarray(self.labels, dtype=object)[idx]
        finite = np.isfinite(vals)
        out = np.empty(len(idx), dtype=object)
        for r in range(len(idx)):
            # drop -inf entries (fewer than k admissible keys)
            out[r] = [{"value": v, "distance": float(d), "label": l}
                      for v, d, l, ok in zip(values[r], vals[r], labels[r], finite[r]) if ok]
        return table.with_column(self.output_col, out)
