"""Ranking stack: adapter, evaluator, train/validation split, id indexer.

The port's copy of ``synapseml_tpu/recommendation/ranking.py`` (numpy on the
host; the wrapped recommender, the port's :class:`~.sar.SAR`, scores on its
own device). Reference files (``core/src/main/scala/.../recommendation/``):
``RankingAdapter.scala:69-161``, ``RankingEvaluator.scala:17-155``
(``AdvancedRankingMetrics``), ``RankingTrainValidationSplit.scala:25-354``,
``RecommendationIndexer.scala:18-175``.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ..core import ComplexParam, Estimator, Model, Param, Table, Transformer
from ..core.params import ParamValidators
from .sar import SARModel

__all__ = [
    "AdvancedRankingMetrics",
    "RankingAdapter", "RankingAdapterModel",
    "RankingEvaluator",
    "RankingTrainValidationSplit", "RankingTrainValidationSplitModel",
    "RecommendationIndexer", "RecommendationIndexerModel",
]


def _per_user_top_items(table: Table, user_col: str, item_col: str,
                        rating_col: Optional[str], k: int) -> Dict[int, List[int]]:
    """Per user: items ordered by rating desc (ties: item asc), truncated to k.
    The reference's Window.partitionBy(user).orderBy(rating desc, item)
    (``RankingAdapter.scala:128-135``)."""
    users = np.asarray(table[user_col], dtype=np.int64)
    items = np.asarray(table[item_col], dtype=np.int64)
    if rating_col and rating_col in table:
        ratings = np.asarray(table[rating_col], dtype=np.float64)
    else:
        ratings = np.ones(len(users))
    order = np.lexsort((items, -ratings, users))  # user asc, rating desc, item asc
    out: Dict[int, List[int]] = {}
    for i in order:
        lst = out.setdefault(int(users[i]), [])
        if len(lst) < k:
            lst.append(int(items[i]))
    return out


def _filter_min_ratings(table: Table, user_col: str, item_col: str,
                        min_u: int, min_i: int) -> Table:
    """Drop items THEN users with too few ratings — sequentially, so user
    counts are taken after the item filter (reference ``filterRatings``,
    ``RankingTrainValidationSplit.scala:150-169``)."""
    items = np.asarray(table[item_col], dtype=np.int64)
    _, item_inv, item_counts = np.unique(items, return_inverse=True,
                                         return_counts=True)
    table = table.filter(item_counts[item_inv] >= min_i)
    users = np.asarray(table[user_col], dtype=np.int64)
    _, user_inv, user_counts = np.unique(users, return_inverse=True,
                                         return_counts=True)
    return table.filter(user_counts[user_inv] >= min_u)


def _join_recs_with_actual(recs: Table, rec_user_col: str,
                           actual: Dict[int, List[int]],
                           label_col: str = "label") -> Table:
    """(prediction, label) rows for users present in both recommendation
    output and the actual-items map (reference ``prepareTestData`` /
    ``RankingAdapterModel.transform`` join)."""
    rec_users = np.asarray(recs[rec_user_col], dtype=np.int64)
    rec_lists = recs["recommendations"]
    preds, labels = [], []
    for r, u in enumerate(rec_users):
        if int(u) not in actual:
            continue
        preds.append([item for item, _ in rec_lists[r]])
        labels.append(actual[int(u)])
    pred_col = np.empty(len(preds), dtype=object)
    pred_col[:] = preds
    lab_col = np.empty(len(labels), dtype=object)
    lab_col[:] = labels
    return Table({"prediction": pred_col, label_col: lab_col})


class RankingAdapter(Estimator):
    """Wraps a recommender estimator so classic evaluators see
    (prediction, label) ranking columns (reference ``RankingAdapter.scala:69``)."""

    mode = Param("allUsers (recommendForAllUsers) | normal (transform+flatten)",
                 str, default="allUsers",
                 validator=ParamValidators.in_list(["allUsers", "normal"]))
    k = Param("ranking depth", int, default=10, validator=ParamValidators.gt(0))
    label_col = Param("output column of per-user actual items", str,
                      default="label")
    recommender = ComplexParam("wrapped recommender estimator", object,
                               default=None)
    min_ratings_per_user = Param("min ratings for users", int, default=1,
                                 validator=ParamValidators.gt_eq(0))
    min_ratings_per_item = Param("min ratings for items", int, default=1,
                                 validator=ParamValidators.gt_eq(0))

    def _fit(self, table: Table) -> "RankingAdapterModel":
        if self.recommender is None:
            raise ValueError(f"RankingAdapter({self.uid}): recommender not set")
        table = _filter_min_ratings(table, self.recommender.user_col,
                                    self.recommender.item_col,
                                    self.min_ratings_per_user,
                                    self.min_ratings_per_item)
        model = self.recommender.fit(table)
        return RankingAdapterModel(
            recommender_model=model, mode=self.mode, k=self.k,
            label_col=self.label_col,
            user_col=self.recommender.user_col,
            item_col=self.recommender.item_col,
            rating_col=self.recommender.rating_col)


class RankingAdapterModel(Model):
    """Reference ``RankingAdapterModel`` (``RankingAdapter.scala:111-159``)."""

    mode = Param("allUsers | normal", str, default="allUsers")
    k = Param("ranking depth", int, default=10)
    user_col = Param("user id column", str, default="user")
    item_col = Param("item id column", str, default="item")
    rating_col = Param("rating column", str, default="rating")
    label_col = Param("per-user actual items output column", str, default="label")
    recommender_model = ComplexParam("fitted recommender model", object,
                                     default=None)

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.user_col, self.item_col)
        actual = _per_user_top_items(table, self.user_col, self.item_col,
                                     self.rating_col, self.k)
        model: SARModel = self.recommender_model
        if self.mode == "allUsers":
            recs = model.recommend_for_all_users(self.k)
        else:
            # 'normal': rank only the (user, item) pairs present in the input,
            # by predicted score — the reference's transform + SparkHelpers
            # .flatten path (``RankingAdapter.scala:143``,
            # ``RecommendationHelper.scala:154``).
            scored = model.transform(table)
            recs = self._flatten(scored, model)
        return _join_recs_with_actual(recs, model.user_col, actual,
                                      self.label_col)

    def _flatten(self, scored: Table, model) -> Table:
        users = np.asarray(scored[model.user_col], dtype=np.int64)
        items = np.asarray(scored[model.item_col], dtype=np.int64)
        preds = np.asarray(scored[model.prediction_col], dtype=np.float64)
        order = np.lexsort((items, -preds, users))
        per_user: Dict[int, List] = {}
        for i in order:
            lst = per_user.setdefault(int(users[i]), [])
            if len(lst) < self.k:
                lst.append((int(items[i]), float(preds[i])))
        keys = np.array(sorted(per_user), dtype=np.int64)
        recs = np.empty(len(keys), dtype=object)
        for r, u in enumerate(keys):
            recs[r] = per_user[int(u)]
        return Table({model.user_col: keys, "recommendations": recs})

    def recommend_for_all_users(self, k: int) -> Table:
        return self.recommender_model.recommend_for_all_users(k)


class AdvancedRankingMetrics:
    """All-at-once ranking metrics over (prediction, label) list pairs
    (reference ``RankingEvaluator.scala:17-98``)."""

    def __init__(self, preds: Sequence[Sequence], labels: Sequence[Sequence],
                 k: int, n_items: int):
        self.preds = [list(p) for p in preds]
        self.labels = [list(l) for l in labels]
        self.k = k
        self.n_items = n_items

    def _mean(self, fn) -> float:
        vals = [fn(p, l) for p, l in zip(self.preds, self.labels)]
        return float(np.mean(vals)) if vals else 0.0

    def map(self) -> float:
        def ap(pred, lab):
            lab_set = set(lab)
            if not lab_set:
                return 0.0
            hits, s = 0, 0.0
            for i, p in enumerate(pred):
                if p in lab_set:
                    hits += 1
                    s += hits / (i + 1.0)
            return s / len(lab_set)
        return self._mean(ap)

    def ndcg_at(self) -> float:
        k = self.k

        def ndcg(pred, lab):
            lab_set = set(lab)
            if not lab_set:
                return 0.0
            n = min(max(len(pred), len(lab_set)), k)
            dcg = sum(1.0 / np.log2(i + 2)
                      for i in range(min(len(pred), n)) if pred[i] in lab_set)
            idcg = sum(1.0 / np.log2(i + 2)
                       for i in range(min(len(lab_set), n)))
            return dcg / idcg if idcg > 0 else 0.0
        return self._mean(ndcg)

    def precision_at_k(self) -> float:
        k = self.k

        def prec(pred, lab):
            lab_set = set(lab)
            return sum(1 for p in pred[:k] if p in lab_set) / float(k)
        return self._mean(prec)

    def recall_at_k(self) -> float:
        # reference: |distinct(pred) ∩ distinct(label)| / |pred|
        def rec(pred, lab):
            if not pred:
                return 0.0
            return len(set(pred) & set(lab)) / float(len(pred))
        return self._mean(rec)

    def diversity_at_k(self) -> float:
        uniq = set()
        for p in self.preds:
            uniq.update(p)
        return len(uniq) / float(self.n_items) if self.n_items > 0 else 0.0

    def max_diversity(self) -> float:
        uniq = set()
        for p in self.preds:
            uniq.update(p)
        for l in self.labels:
            uniq.update(l)
        return len(uniq) / float(self.n_items) if self.n_items > 0 else 0.0

    def mrr(self) -> float:
        def rr(pred, lab):
            lab_set = set(lab)
            for i, p in enumerate(pred):
                if p in lab_set:
                    return 1.0 / (i + 1)
            return 0.0
        return self._mean(rr)

    def fcp(self) -> float:
        # reference fractionConcordantPairs: positional agreement pred[i]==label[i]
        def f(pred, lab):
            nc = sum(1 for i, p in enumerate(pred) if i < len(lab) and p == lab[i])
            nd = sum(1 for i, p in enumerate(pred) if i < len(lab) and p != lab[i])
            return nc / (nc + nd) if (nc + nd) > 0 else 0.0
        return self._mean(f)

    def match_metric(self, name: str) -> float:
        fns = {"map": self.map, "ndcgAt": self.ndcg_at,
               "precisionAtk": self.precision_at_k,
               "recallAtK": self.recall_at_k,
               "diversityAtK": self.diversity_at_k,
               "maxDiversity": self.max_diversity,
               "mrr": self.mrr, "fcp": self.fcp}
        return fns[name]()

    def all_metrics(self) -> Dict[str, float]:
        return {"map": self.map(), "ndcgAt": self.ndcg_at(),
                "precisionAtk": self.precision_at_k(),
                "recallAtK": self.recall_at_k(),
                "diversityAtK": self.diversity_at_k(),
                "maxDiversity": self.max_diversity(),
                "mrr": self.mrr(), "fcp": self.fcp()}


class RankingEvaluator(Transformer):
    """Evaluate (prediction, label) ranking columns
    (reference ``RankingEvaluator.scala:100-155``). ``transform`` appends
    nothing — use :meth:`evaluate` / :meth:`get_metrics_map`; it exists so the
    evaluator is a persistable registered stage."""

    metric_name = Param("ndcgAt|map|precisionAtk|recallAtK|diversityAtK|"
                        "maxDiversity|mrr|fcp", str, default="ndcgAt",
                        validator=ParamValidators.in_list(
                            ["ndcgAt", "map", "precisionAtk", "recallAtK",
                             "diversityAtK", "maxDiversity", "mrr", "fcp"]))
    k = Param("ranking depth", int, default=10, validator=ParamValidators.gt(0))
    n_items = Param("total distinct items (-1: infer from data)", int,
                    default=-1)
    prediction_col = Param("prediction list column", str, default="prediction")
    label_col = Param("label list column", str, default="label")

    # larger is better for every supported metric (reference isLargerBetter)
    is_larger_better = True

    def get_metrics(self, table: Table) -> AdvancedRankingMetrics:
        self._validate_input(table, self.prediction_col, self.label_col)
        preds = list(table[self.prediction_col])
        labels = list(table[self.label_col])
        n_items = self.n_items
        if n_items < 0:
            uniq = set()
            for p in preds:
                uniq.update(p)
            for l in labels:
                uniq.update(l)
            n_items = len(uniq)
        return AdvancedRankingMetrics(preds, labels, self.k, n_items)

    def get_metrics_map(self, table: Table) -> Dict[str, float]:
        return self.get_metrics(table).all_metrics()

    def evaluate(self, table: Table) -> float:
        return self.get_metrics(table).match_metric(self.metric_name)

    def _transform(self, table: Table) -> Table:
        return table


class RecommendationIndexer(Estimator):
    """Raw user/item ids (strings or sparse ints) -> dense indices
    (reference ``RecommendationIndexer.scala:18``)."""

    user_input_col = Param("raw user column", str, default="user")
    user_output_col = Param("indexed user column", str, default="user_idx")
    item_input_col = Param("raw item column", str, default="item")
    item_output_col = Param("indexed item column", str, default="item_idx")
    rating_col = Param("rating column (carried through)", str, default="rating")

    def _fit(self, table: Table) -> "RecommendationIndexerModel":
        self._validate_input(table, self.user_input_col, self.item_input_col)
        users = sorted({str(v) for v in table[self.user_input_col].tolist()})
        items = sorted({str(v) for v in table[self.item_input_col].tolist()})
        return RecommendationIndexerModel(
            user_input_col=self.user_input_col,
            user_output_col=self.user_output_col,
            item_input_col=self.item_input_col,
            item_output_col=self.item_output_col,
            rating_col=self.rating_col,
            user_levels=np.array(users, dtype=object),
            item_levels=np.array(items, dtype=object))


class RecommendationIndexerModel(Model):
    user_input_col = Param("raw user column", str, default="user")
    user_output_col = Param("indexed user column", str, default="user_idx")
    item_input_col = Param("raw item column", str, default="item")
    item_output_col = Param("indexed item column", str, default="item_idx")
    rating_col = Param("rating column", str, default="rating")
    user_levels = ComplexParam("index -> user id", object, default=None)
    item_levels = ComplexParam("index -> item id", object, default=None)

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.user_input_col, self.item_input_col)
        ulut = {v: i for i, v in enumerate(self.user_levels)}
        ilut = {v: i for i, v in enumerate(self.item_levels)}
        u = np.array([ulut.get(str(v), -1)
                      for v in table[self.user_input_col].tolist()], np.int64)
        it = np.array([ilut.get(str(v), -1)
                       for v in table[self.item_input_col].tolist()], np.int64)
        return (table.with_column(self.user_output_col, u)
                .with_column(self.item_output_col, it))

    def recover_user(self, idx: int) -> str:
        """index -> raw user id ('-1' if unknown; reference ``recoverUser``)."""
        levels = self.user_levels
        return str(levels[idx]) if 0 <= idx < len(levels) else "-1"

    def recover_item(self, idx: int) -> str:
        levels = self.item_levels
        return str(levels[idx]) if 0 <= idx < len(levels) else "-1"


class RankingTrainValidationSplit(Estimator):
    """Per-user stratified train/validation split + param-map search over a
    recommender (reference ``RankingTrainValidationSplit.scala:25-288``)."""

    user_col = Param("user id column", str, default="user")
    item_col = Param("item id column", str, default="item")
    rating_col = Param("rating column", str, default="rating")
    train_ratio = Param("per-user fraction of events in the train split",
                        float, default=0.75,
                        validator=ParamValidators.in_range(0.0, 1.0))
    min_ratings_u = Param("min ratings per user", int, default=1,
                          validator=ParamValidators.gt_eq(0))
    min_ratings_i = Param("min ratings per item", int, default=1,
                          validator=ParamValidators.gt_eq(0))
    parallelism = Param("threads for param-map evaluation", int, default=1,
                        validator=ParamValidators.gt_eq(1))
    seed = Param("shuffle seed", int, default=0)
    estimator = ComplexParam("recommender estimator", object, default=None)
    estimator_param_maps = ComplexParam("list of param dicts to search", list,
                                        default=None)
    evaluator = ComplexParam("RankingEvaluator", object, default=None)

    def _filter_ratings(self, table: Table) -> Table:
        return _filter_min_ratings(table, self.user_col, self.item_col,
                                   self.min_ratings_u, self.min_ratings_i)

    def _split(self, table: Table):
        """Per-user shuffled split at train_ratio (reference ``splitDF``)."""
        rng = np.random.default_rng(self.seed)
        users = np.asarray(table[self.user_col], dtype=np.int64)
        perm = rng.permutation(len(users))
        order = perm[np.argsort(users[perm], kind="stable")]  # shuffled within user
        counts = np.bincount(users[order] - users.min()) if len(users) else []
        is_train = np.zeros(len(users), dtype=bool)
        pos = 0
        for c in np.asarray(counts):
            if c == 0:
                continue
            n_train = int(round(c * self.train_ratio))
            is_train[order[pos:pos + n_train]] = True
            pos += c
        return table.filter(is_train), table.filter(~is_train)

    def _fit(self, table: Table) -> "RankingTrainValidationSplitModel":
        if self.estimator is None or self.evaluator is None:
            raise ValueError(f"{type(self).__name__}({self.uid}): estimator "
                             "and evaluator must be set")
        param_maps = self.estimator_param_maps or [{}]
        ev: RankingEvaluator = self.evaluator
        if ev.n_items < 0:
            ev = ev.copy()
            ev.set_params(n_items=len(np.unique(np.asarray(table[self.item_col]))))
        filtered = self._filter_ratings(table)
        train, val = self._split(filtered)

        def eval_one(pm: Dict[str, Any]) -> float:
            est = self.estimator.copy()
            est.set_params(**pm)
            model = est.fit(train)
            recs = model.recommend_for_all_users(ev.k)
            prepared = self._prepare_test_data(val, recs, ev.k, model.user_col)
            return ev.evaluate(prepared)

        if self.parallelism > 1:
            with ThreadPoolExecutor(max_workers=self.parallelism) as pool:
                metrics = list(pool.map(eval_one, param_maps))
        else:
            metrics = [eval_one(pm) for pm in param_maps]
        best_idx = int(np.argmax(metrics) if ev.is_larger_better
                       else np.argmin(metrics))
        best_est = self.estimator.copy()
        best_est.set_params(**param_maps[best_idx])
        return RankingTrainValidationSplitModel(
            best_model=best_est.fit(table),
            validation_metrics=[float(m) for m in metrics])

    def _prepare_test_data(self, val: Table, recs: Table, k: int,
                           user_col: str) -> Table:
        """Join per-user recommendations with per-user actual items
        (reference ``prepareTestData``, ``RankingTrainValidationSplit.scala:242-287``)."""
        actual = _per_user_top_items(val, self.user_col, self.item_col,
                                     self.rating_col, k)
        return _join_recs_with_actual(recs, user_col, actual)


class RankingTrainValidationSplitModel(Model):
    """Reference ``RankingTrainValidationSplitModel``
    (``RankingTrainValidationSplit.scala:292-352``)."""

    best_model = ComplexParam("best fitted recommender", object, default=None)
    validation_metrics = ComplexParam("metric per param map", list, default=None)

    def _transform(self, table: Table) -> Table:
        return self.best_model.transform(table)

    def recommend_for_all_users(self, k: int) -> Table:
        return self.best_model.recommend_for_all_users(k)

    def recommend_for_all_items(self, k: int) -> Table:
        return self.best_model.recommend_for_all_items(k)
