"""SAR — Smart Adaptive Recommendations, on the card.

Port of ``synapseml_tpu/recommendation/sar.py`` (reference:
``recommendation/SAR.scala:36``, ``SARModel.scala:22``). SAR fits two
matrices:

- **user affinity** (U, I): per (user, item), the time-decayed event weights
  ``2^(-(t_ref - t) / (timeDecayCoeff days))`` blended with the rating when
  both exist, summed with the reference's arithmetic: f64 weights rounded to
  f32 and added in row order (``np.add.at``), on the host;
- **item-item similarity** (I, I): co-occurrence = the number of users in
  whom items i and j appear together, one matrix product of the 0/1
  occurrence matrix built on the card (its 0/1 products and integer sums
  below 2^24 are exact in f32), normalized to jaccard (default) or lift in
  f32 and zeroed under ``support_threshold``: bit for bit the reference's.

Scoring is ``affinity @ similarity`` in full f32 (``torch.matmul``), in
chunks of users whose (rows, I) scores fit ``nn.knn.SCORE_BUDGET``, ranked
by kernel K (``nn.topk.topk_select``, ``lax.top_k``'s order). ``k`` is cut
to the item count as in the reference, and non-finite scores (the seen items
that ``remove_seen`` masks with -inf) are dropped from the lists.
"""

from __future__ import annotations

from datetime import datetime, timezone
from typing import Optional, Tuple

import numpy as np
import torch

from ..core import CarriedModel, ComplexParam, Estimator, Param, Table
from ..core.params import ParamValidators
from ..nn.knn import chunk_rows, top_k_products
from ..runtime.device import resolve_device

__all__ = ["SAR", "SARModel", "cooccurrence", "item_similarity"]

_DEVICE_DOC = "'cuda[:i]' (default: the GPU) or 'cpu'"
# Java SimpleDateFormat defaults from the reference (SAR.scala:257-259),
# expressed as strptime patterns.
_ACTIVITY_FMT = "%Y/%m/%dT%H:%M:%S"        # "yyyy/MM/dd'T'h:mm:ss"
# "EEE MMM dd HH:mm:ss Z yyyy" — Java's Z is a numeric offset (+0000): %z
_START_FMT = "%a %b %d %H:%M:%S %z %Y"


def _parse_times(col: np.ndarray, fmt: str) -> np.ndarray:
    """Activity times -> epoch seconds. Numeric columns pass through."""
    if np.issubdtype(np.asarray(col).dtype, np.number):
        return np.asarray(col, dtype=np.float64)
    out = np.empty(len(col), dtype=np.float64)
    for i, v in enumerate(col):
        dt = datetime.strptime(str(v), fmt)
        if dt.tzinfo is None:
            dt = dt.replace(tzinfo=timezone.utc)
        out[i] = dt.timestamp()
    return out


def cooccurrence(users: np.ndarray, items: np.ndarray, n_users: int, n_items: int,
                 device) -> torch.Tensor:
    """(I, I) f32 counts on ``device``: the users in whom items i and j both
    appear (the diagonal: each item's users), ``occ.T @ occ`` of the 0/1
    occurrence matrix built there. On a card the product runs on the tensor
    cores in TF32 with f32 accumulation, and is exact all the same: 0 and 1
    lose nothing in TF32's 10 mantissa bits, and the integer sums stay below
    2^24 (fewer than 2^24 users)."""
    occ = torch.zeros((n_users, n_items), dtype=torch.float32, device=device)
    occ[torch.from_numpy(users).to(device), torch.from_numpy(items).to(device)] = 1.0
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.matmul(occ.T, occ)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def item_similarity(c: torch.Tensor, fn: str, support_threshold: int) -> torch.Tensor:
    """The reference's normalization of counts ``c`` in f32 (jaccard:
    c / (n_i + n_j - c); lift: c / (n_i n_j); cooccurrence: c), 0 where the
    denominator is not positive or the count is under ``support_threshold``."""
    counts = torch.diagonal(c).clone()
    zero = torch.zeros((), dtype=c.dtype, device=c.device)
    if fn == "jaccard":
        denom = counts[:, None] + counts[None, :] - c
        sim = torch.where(denom > 0, c / denom, zero)
    elif fn == "lift":
        denom = counts[:, None] * counts[None, :]
        sim = torch.where(denom > 0, c / denom, zero)
    else:
        sim = c
    return torch.where(c < support_threshold, zero, sim)


class SAR(Estimator):
    """Reference ``SAR.scala:36``. Ids must be non-negative integers (use
    :class:`RecommendationIndexer` for raw string/sparse ids, as the reference
    does)."""

    user_col = Param("user id column", str, default="user")
    item_col = Param("item id column", str, default="item")
    rating_col = Param("rating column (optional in the data)", str, default="rating")
    time_col = Param("activity time column (optional in the data)", str, default="time")
    similarity_function = Param(
        "jaccard (compromise, default) | lift (serendipity) | cooccurrence "
        "(predictability) — reference SAR.scala:217-220", str, default="jaccard",
        validator=ParamValidators.in_list(["jaccard", "lift", "cooccurrence"]))
    support_threshold = Param("min co-occurrence count for a nonzero similarity", int,
                              default=4, validator=ParamValidators.gt_eq(0))
    time_decay_coeff = Param("half-life of event weight, in days", int, default=30,
                             validator=ParamValidators.gt(0))
    start_time = Param("reference 'now' for time decay (epoch seconds or "
                       "start_time_format string; default: max activity time)",
                       str, default=None)
    start_time_format = Param("strptime format for start_time", str, default=_START_FMT)
    activity_time_format = Param("strptime format for the time column", str,
                                 default=_ACTIVITY_FMT)
    device = Param(_DEVICE_DOC, str, default=None)

    def _fit(self, table: Table) -> "SARModel":
        self._validate_input(table, self.user_col, self.item_col)
        users = np.asarray(table[self.user_col], dtype=np.int64)
        items = np.asarray(table[self.item_col], dtype=np.int64)
        if users.min(initial=0) < 0 or items.min(initial=0) < 0:
            raise ValueError("SAR requires non-negative integer user/item ids; "
                             "run RecommendationIndexer first")
        n_users = int(users.max()) + 1 if len(users) else 0
        n_items = int(items.max()) + 1 if len(items) else 0
        dev = resolve_device(self.device)

        affinity = self._user_item_affinity(table, users, items, n_users, n_items)
        sim = item_similarity(cooccurrence(users, items, n_users, n_items, dev),
                              self.similarity_function, self.support_threshold)
        model = SARModel(
            user_col=self.user_col, item_col=self.item_col, rating_col=self.rating_col,
            support_threshold=self.support_threshold, user_affinity=affinity,
            item_similarity=sim.cpu().numpy(), device=self.device)
        model._keep_on_device(dev, sim=sim)
        return model

    # -- affinity (reference calculateUserItemAffinities, SAR.scala:86-121) --

    def _user_item_affinity(self, table, users, items, n_users, n_items):
        n = len(users)
        has_time = self.time_col in table
        has_rating = self.rating_col in table
        if has_time:
            t = _parse_times(table[self.time_col], self.activity_time_format)
            if self.start_time is not None:
                try:
                    t_ref = float(self.start_time)
                except ValueError:
                    t_ref = _parse_times(np.array([self.start_time]),
                                         self.start_time_format)[0]
            else:
                t_ref = float(t.max()) if n else 0.0
            # 2^(-(minutes since event) / (coeff days in minutes))
            dt_min = (t_ref - t) / 60.0
            decay = np.power(2.0, -dt_min / (self.time_decay_coeff * 24 * 60))
            w = decay * np.asarray(table[self.rating_col], np.float64) \
                if has_rating else decay
        elif has_rating:
            w = np.asarray(table[self.rating_col], dtype=np.float64)
        else:
            w = np.ones(n)
        aff = np.zeros((n_users, n_items), dtype=np.float32)
        np.add.at(aff, (users, items), w.astype(np.float32))
        return aff


class SARModel(CarriedModel):
    """Reference ``SARModel.scala:22``. Holds the two fitted matrices (numpy,
    as the reference's params), uploaded once a model and device; scoring is
    ``affinity @ similarity`` (``recommendForAll``, ``SARModel.scala:99-134``)
    and kernel K."""

    user_col = Param("user id column", str, default="user")
    item_col = Param("item id column", str, default="item")
    rating_col = Param("rating column", str, default="rating")
    prediction_col = Param("score output column", str, default="prediction")
    support_threshold = Param("min co-occurrence (carried from fit)", int, default=4)
    user_affinity = ComplexParam("(n_users, n_items) float32 affinity matrix", object,
                                 default=None)
    item_similarity = ComplexParam("(n_items, n_items) float32 similarity", object,
                                   default=None)
    device = Param(_DEVICE_DOC, str, default=None)

    _STATE = ("user_col", "item_col", "rating_col", "prediction_col", "support_threshold",
              "user_affinity", "item_similarity")

    # -- the matrices on the device -------------------------------------------------

    def _keep_on_device(self, dev: torch.device, sim: Optional[torch.Tensor] = None):
        """(affinity, similarity) on ``dev``, uploaded once a model and device
        (``sim``: a similarity already there)."""
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
        return self._cached(
            "mats", str(dev), ("user_affinity", "item_similarity"),
            lambda: (up(self.user_affinity), up(self.item_similarity) if sim is None else sim))

    def _device_mats(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._keep_on_device(resolve_device(self.device))

    # -- scoring ------------------------------------------------------------------

    def _transform(self, table: Table) -> Table:
        """Per-row (user, item) score, cold-start rows dropped (the reference
        transform delegates to an ALS-shaped model with
        coldStartStrategy='drop', ``RecommendationHelper.scala:37-46``)."""
        self._validate_input(table, self.user_col, self.item_col)
        users = np.asarray(table[self.user_col], dtype=np.int64)
        items = np.asarray(table[self.item_col], dtype=np.int64)
        aff, sim = self._device_mats()
        ok = (users >= 0) & (users < aff.shape[0]) & (items >= 0) & (items < sim.shape[0])
        kept = table.filter(ok)
        u = torch.from_numpy(users[ok]).to(aff.device)
        it = torch.from_numpy(items[ok]).to(aff.device)
        sim_t = sim.T.contiguous()
        # row-gather then batched dot: score[r] = aff[u_r] . sim[:, i_r]
        rows = chunk_rows(2 * sim.shape[0])
        scores = torch.cat([(aff[u[s:s + rows]] * sim_t[it[s:s + rows]]).sum(1)
                            for s in range(0, len(u), rows)]) if len(u) else aff.new_empty(0)
        return kept.with_column(self.prediction_col,
                                scores.cpu().numpy().astype(np.float64))

    # -- recommend top-k ------------------------------------------------------------

    @staticmethod
    def _top_k(a: torch.Tensor, s: torch.Tensor, k: int, remove_seen: bool
               ) -> Tuple[np.ndarray, np.ndarray]:
        """The k best columns of ``a @ s`` a row, ``a > 0`` masked with -inf
        when ``remove_seen``."""
        keep = (lambda st, e: ~(a[st:e] > 0)) if remove_seen else None
        vals, idx = top_k_products(a, s, k, keep)
        return vals.cpu().numpy(), idx.cpu().numpy()

    @staticmethod
    def _recs_table(vals: np.ndarray, idx: np.ndarray, key_col: str,
                    keys: Optional[np.ndarray] = None) -> Table:
        n = len(vals)
        keys = np.arange(n, dtype=np.int64) if keys is None else keys
        recs = np.empty(n, dtype=object)
        finite = np.isfinite(vals).tolist()
        for r, (ir, vr, fr) in enumerate(zip(idx.tolist(), vals.tolist(), finite)):
            # -inf entries are masked-out (seen) items when the user has fewer
            # than k candidates — they are not recommendations, drop them
            recs[r] = [(i, v) for i, v, ok in zip(ir, vr, fr) if ok]
        return Table({key_col: keys, "recommendations": recs})

    def recommend_for_all_users(self, num_items: int, remove_seen: bool = False) -> Table:
        """Top ``num_items`` per user (reference ``recommendForAllUsers``).
        ``remove_seen`` masks items the user already interacted with."""
        aff, sim = self._device_mats()
        vals, idx = self._top_k(aff, sim, num_items, remove_seen)
        return self._recs_table(vals, idx, self.user_col)

    def recommend_for_user_subset(self, table: Table, num_items: int,
                                  remove_seen: bool = False) -> Table:
        """Reference ``recommendForUserSubset`` (unique ids only)."""
        self._validate_input(table, self.user_col)
        users = np.unique(np.asarray(table[self.user_col], dtype=np.int64))
        aff, sim = self._device_mats()
        users = users[(users >= 0) & (users < aff.shape[0])]
        a = aff[torch.from_numpy(users).to(aff.device)]
        vals, idx = self._top_k(a, sim, num_items, remove_seen)
        return self._recs_table(vals, idx, self.user_col, keys=users)

    def recommend_for_all_items(self, num_users: int) -> Table:
        """Reference ``recommendForAllItems``: similar users per item via the
        transposed product."""
        aff, sim = self._device_mats()
        vals, idx = self._top_k(sim, aff.T, num_users, False)
        return self._recs_table(vals, idx, self.item_col)
