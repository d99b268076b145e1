"""LightGBM-style estimator stages over Tables.

Port of ``synapseml_tpu/gbdt/estimators.py``: ``LightGBMClassifier`` /
``LightGBMClassificationModel`` (binary or multiclass, from the label count),
``LightGBMRegressor`` / ``LightGBMRegressionModel`` (l2, l1, huber,
poisson, quantile, tweedie) and ``LightGBMRanker`` / ``LightGBMRankerModel``
(lambdarank over ``group_col``), dense feature columns or sparse ones (an
object column of ``(indices, values)`` pairs, the VW featurizer's output,
hashed into ``2**sparse_num_bits`` columns), categorical slots by index or
by slot name; gbdt, goss, dart and rf boosting with bagging and
feature fraction; validation rows (``validation_indicator_col``) scored with
``metric`` (the ranker: NDCG@``ndcg_at``) after every iteration, with early
stopping. The models write per-feature contributions
(``features_shap_col``; for a sparse column each row's ``(indices,
values)`` pair over the trees' used features and the expected value),
save and load LightGBM's text model
(``save_native_model`` / ``load_native_model``) and report feature
importances. ``num_batches`` trains on consecutive row slices, each batch's
booster continuing the last (``train``'s ``init_booster``); the classifier's
``is_unbalance`` weights binary positives by the negative-to-positive ratio.
Params keep the reference's names and defaults; ``init_score_col`` is
admitted in the input schema and not read, and ``verbosity`` and
``use_barrier_execution_mode`` are accepted for API parity, as in the
reference. ``mesh`` (a :class:`~synapseml_tpu_torch.runtime.layout.SpecLayout`
or a ``DeviceMesh`` over an initialised process group) trains every fit
over the mesh's ranks (``train(..., mesh=)``), each rank calling ``fit``
on the same table; ``parallelism`` (``data_parallel`` | ``voting_parallel``)
and ``top_k`` choose how, with the reference's names and defaults.

``device`` picks where fit and transform run: the GPU by default, ``"cpu"``
for the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core import ColumnSpec, ComplexParam, Estimator, Model, Param, Table, TableSchema
from ..core.params import ParamValidators
from ..core.table import features_matrix
from .boost import GBDTBooster, train
from .sparse import CSRMatrix

__all__ = [
    "LightGBMClassifier", "LightGBMClassificationModel",
    "LightGBMRegressor", "LightGBMRegressionModel",
    "LightGBMRanker", "LightGBMRankerModel",
]

_FEATURES_SPEC = ColumnSpec("any", "vector")


def _features(table: Table, col: str, num_bits: int = 18):
    """The (n, d) feature matrix of ``col``, or a :class:`~.sparse.CSRMatrix`
    when the column holds ``(indices, values)`` pairs (``vw_sparse`` meta, or
    pairs of arrays; the reference's ``_features_matrix``,
    ``estimators.py:39-57``): sparse rows stay sparse into the fit."""
    arr = table.column(col)
    if arr.dtype in (np.float32, np.float64):
        return arr  # binning compares in f64; keep f32 input as it is
    if arr.dtype == object:
        first = next((v for v in arr if v is not None), None)
        if table.meta.get(col, {}).get("type") == "vw_sparse" or (
                isinstance(first, tuple) and len(first) == 2
                and isinstance(first[0], np.ndarray)):
            return CSRMatrix.from_pairs(arr, num_bits=num_bits)
    return features_matrix(arr)


class _LightGBMBase(Estimator):
    """Shared params (reference ``LightGBMParams.scala``) and fit plumbing."""

    _abstract_stage = True

    features_col = Param("features column (vector)", str, default="features")
    label_col = Param("label column", str, default="label")
    prediction_col = Param("prediction output column", str, default="prediction")
    weight_col = Param("optional sample-weight column", str, default=None)
    validation_indicator_col = Param(
        "optional bool column marking validation rows (reference "
        "validationIndicatorCol)", str, default=None)
    init_score_col = Param("optional initial raw-score column (admitted in the input "
                           "schema, not read: the reference's rule)", str, default=None)
    leaf_prediction_col = Param("optional leaf-index output column", str, default=None)
    features_shap_col = Param("optional per-feature contribution output column",
                              str, default=None)
    device = Param("'cuda[:i]' (default: the GPU) or 'cpu'", str, default=None)
    sparse_num_bits = Param("hash-mask bits for sparse (indices, values) feature columns "
                            "(the VW featurizer's output): d = 2^b", int, default=18)

    boosting_type = Param("gbdt | rf | dart | goss", str, default="gbdt",
                          validator=ParamValidators.in_list(["gbdt", "rf", "dart", "goss"]))
    num_iterations = Param("boosting iterations", int, default=100,
                           validator=ParamValidators.gt_eq(0))
    learning_rate = Param("shrinkage rate", float, default=0.1,
                          validator=ParamValidators.gt(0))
    num_leaves = Param("max leaves per tree", int, default=31,
                       validator=ParamValidators.gt(1))
    max_depth = Param("max tree depth, <= 0 unlimited", int, default=-1)
    max_delta_step = Param("clamp leaf outputs, 0 = off", float, default=0.0)
    boost_from_average = Param("start from the label average", bool, default=True)
    max_bin = Param("max histogram bins per feature", int, default=255,
                    validator=ParamValidators.gt(1))
    max_bin_by_feature = Param("per-feature max_bin overrides (reference "
                               "maxBinByFeature; empty = max_bin)", list, default=[])
    bin_sample_count = Param("rows sampled for bin-edge estimation", int,
                             default=200_000, validator=ParamValidators.gt(0))
    bagging_fraction = Param("row subsample fraction", float, default=1.0)
    pos_bagging_fraction = Param("positive-row subsample fraction (reference "
                                 "posBaggingFraction)", float, default=1.0)
    neg_bagging_fraction = Param("negative-row subsample fraction (reference "
                                 "negBaggingFraction)", float, default=1.0)
    bagging_freq = Param("bag every k iterations (0 = off)", int, default=0)
    bagging_seed = Param("bagging seed", int, default=3)
    feature_fraction = Param("feature subsample fraction per tree", float, default=1.0)
    lambda_l1 = Param("L1 regularization", float, default=0.0)
    lambda_l2 = Param("L2 regularization", float, default=0.0)
    min_sum_hessian_in_leaf = Param("min hessian mass per leaf", float, default=1e-3)
    min_data_in_leaf = Param("min rows per leaf", int, default=20)
    min_gain_to_split = Param("min split gain", float, default=0.0)
    early_stopping_round = Param("stop after k rounds without improvement (0 = off)",
                                 int, default=0)
    improvement_tolerance = Param("min metric delta counted as improvement "
                                  "(reference improvementTolerance)", float, default=0.0)
    top_rate = Param("goss: top-gradient keep fraction", float, default=0.2)
    other_rate = Param("goss: small-gradient sample fraction", float, default=0.1)
    drop_rate = Param("dart: tree dropout rate", float, default=0.1)
    max_drop = Param("dart: max trees dropped per iteration", int, default=50)
    skip_drop = Param("dart: probability of skipping dropout", float, default=0.5)
    uniform_drop = Param("dart: drop uniformly instead of weight-proportional "
                         "(reference uniformDrop)", bool, default=False)
    xgboost_dart_mode = Param("dart: xgboost normalization lr/(k+lr) "
                              "(reference xgboostDartMode)", bool, default=False)
    metric = Param("eval metric name ('' = objective default)", str, default="")
    seed = Param("random seed (bin sampling, feature fraction, DART drops)", int,
                 default=0)
    categorical_slot_names = Param("feature names treated as categorical "
                                   "(reference categoricalSlotNames)", list, default=[])
    categorical_slot_indexes = Param("feature indices treated as categorical "
                                     "(reference categoricalSlotIndexes)", list, default=[])
    cat_smooth = Param("categorical split smoothing (reference catSmooth)", float,
                       default=10.0)
    max_cat_threshold = Param("max categories in the left set of a categorical split "
                              "(reference maxCatThreshold)", int, default=32)
    use_barrier_execution_mode = Param("accepted for API parity (gang scheduling is "
                                       "implicit in SPMD)", bool, default=False)
    num_batches = Param("split training into k sequential batches with model "
                        "continuation (reference numBatches)", int, default=0)
    verbosity = Param("verbosity", int, default=-1)
    parallelism = Param("data_parallel (full histogram allreduce) | "
                        "voting_parallel (PV-tree: top-k feature vote + "
                        "candidate-only reduce)", str, default="data_parallel",
                        validator=ParamValidators.in_list(
                            ["data_parallel", "voting_parallel"]))
    top_k = Param("voting_parallel: local vote size (global select 2k; "
                  "reference topK)", int, default=20,
                  validator=ParamValidators.gt(0))
    mesh = ComplexParam("optional SpecLayout or DeviceMesh for distributed training",
                        object, default=None)

    objective = Param("training objective", str, default="regression")

    def input_schema(self) -> TableSchema:
        cols = {self.features_col: _FEATURES_SPEC,
                self.label_col: ColumnSpec("float", "scalar")}
        if self.weight_col:
            cols[self.weight_col] = ColumnSpec("float", "scalar")
        if self.validation_indicator_col:
            cols[self.validation_indicator_col] = ColumnSpec("any", "scalar")
        if self.init_score_col:
            cols[self.init_score_col] = ColumnSpec("float", "any")
        return TableSchema(cols)

    def transform_schema(self, schema: TableSchema) -> TableSchema:
        """The fitted model's output columns, after this estimator's own
        input check: what a pipeline position holding the estimator adds."""
        self._check_schema(schema, self.input_schema())
        return self._unfitted_model().transform_schema(schema)

    def _unfitted_model(self) -> "_LightGBMModelBase":
        """A model of the fitted model's class and output params, no booster."""
        return LightGBMRegressionModel(**self._model_params())

    def _model_params(self) -> dict:
        """The output params every fitted model takes from its estimator."""
        return dict(features_col=self.features_col, prediction_col=self.prediction_col,
                    leaf_prediction_col=self.leaf_prediction_col,
                    features_shap_col=self.features_shap_col, device=self.device,
                    sparse_num_bits=self.sparse_num_bits)

    def _train_params(self) -> dict:
        return {
            "objective": self.objective, "boosting": self.boosting_type,
            "num_iterations": self.num_iterations, "learning_rate": self.learning_rate,
            "num_leaves": self.num_leaves, "max_depth": self.max_depth,
            "max_delta_step": self.max_delta_step,
            "boost_from_average": self.boost_from_average, "max_bin": self.max_bin,
            "max_bin_by_feature": list(self.max_bin_by_feature) or None,
            "bin_sample_count": self.bin_sample_count,
            "bagging_fraction": self.bagging_fraction,
            "pos_bagging_fraction": self.pos_bagging_fraction,
            "neg_bagging_fraction": self.neg_bagging_fraction,
            "bagging_freq": self.bagging_freq, "bagging_seed": self.bagging_seed,
            "feature_fraction": self.feature_fraction,
            "lambda_l1": self.lambda_l1, "lambda_l2": self.lambda_l2,
            "min_sum_hessian_in_leaf": self.min_sum_hessian_in_leaf,
            "min_data_in_leaf": self.min_data_in_leaf,
            "min_gain_to_split": self.min_gain_to_split,
            "early_stopping_round": self.early_stopping_round,
            "early_stopping_min_delta": self.improvement_tolerance,
            "top_rate": self.top_rate, "other_rate": self.other_rate,
            "drop_rate": self.drop_rate, "max_drop": self.max_drop,
            "skip_drop": self.skip_drop, "uniform_drop": self.uniform_drop,
            "xgboost_dart_mode": self.xgboost_dart_mode, "metric": self.metric or None,
            "seed": self.seed,
            "categorical_feature": (list(self.categorical_slot_indexes)
                                    + list(self.categorical_slot_names)) or None,
            "cat_smooth": self.cat_smooth, "max_cat_threshold": self.max_cat_threshold,
            "parallelism": self.parallelism, "top_k": self.top_k,
        }

    def _split_validation(self, table: Table):
        """(training rows, validation rows or None) by ``validation_indicator_col``."""
        vcol = self.validation_indicator_col
        if vcol:
            self._validate_input(table, vcol)
            mask = np.asarray(table[vcol], dtype=bool)
            return table.filter(~mask), table.filter(mask)
        return table, None

    def _fit_booster(self, table: Table, extra_params: Optional[dict] = None,
                     group_sizes=None, weight_col: Optional[str] = None) -> GBDTBooster:
        """Train on ``table``'s rows; ``group_sizes(rows)`` gives the query
        sizes of the training rows and of the validation rows (lambdarank);
        ``weight_col`` names the weight column in place of ``self.weight_col``."""
        self._validate_input(table, self.features_col, self.label_col)
        tr, val = self._split_validation(table)
        x = _features(tr, self.features_col, self.sparse_num_bits)
        y = np.asarray(tr[self.label_col], dtype=np.float64)
        weight_col = weight_col or self.weight_col
        w = np.asarray(tr[weight_col], dtype=np.float64) if weight_col else None
        params = self._train_params()
        params.update(extra_params or {})
        eval_set = None
        kw = {}
        if val is not None and val.num_rows:
            eval_set = [(_features(val, self.features_col, self.sparse_num_bits),
                         np.asarray(val[self.label_col], dtype=np.float64))]
            if group_sizes is not None:
                kw["eval_group"] = [group_sizes(val)]
        if group_sizes is not None:
            kw["group"] = group_sizes(tr)
        # categorical_slot_names resolve against the features column's
        # slot-name metadata, as in the reference
        slot_names = table.meta.get(self.features_col, {}).get("slot_names")
        if slot_names is None and self.categorical_slot_names:
            raise ValueError(
                "categorical_slot_names requires slot-name metadata on the features "
                f"column: Table(meta={{{self.features_col!r}: {{'slot_names': [...]}}}})")
        kw.update(device=self.device, eval_set=eval_set, mesh=self.mesh,
                  feature_names=list(slot_names) if slot_names is not None else None)
        n_batches = int(self.num_batches)
        if n_batches > 1 and group_sizes is not None:
            raise NotImplementedError(
                "num_batches > 1 is not supported for the ranker: row-slice "
                "batches would split query groups")
        if n_batches <= 1:
            return train(params, x, y, weight=w, **kw)
        # the reference's batch training: batch k's booster seeds batch k + 1
        # (LightGBMBase.scala:46-61); the iterations are split as evenly as
        # divmod splits them, and a batch of 0 iterations is skipped
        base_per, rem = divmod(int(params["num_iterations"]), n_batches)
        booster = None
        for b in range(n_batches):
            per = base_per + (1 if b < rem else 0)
            if per == 0:
                continue
            lo, hi = b * x.shape[0] // n_batches, (b + 1) * x.shape[0] // n_batches
            booster = train(dict(params, num_iterations=per), x[lo:hi], y[lo:hi],
                            weight=None if w is None else w[lo:hi], init_booster=booster,
                            **kw)
        return booster


class _LightGBMModelBase(Model):
    """Shared model params and transform plumbing."""

    _abstract_stage = True

    features_col = Param("features column", str, default="features")
    prediction_col = Param("prediction output column", str, default="prediction")
    leaf_prediction_col = Param("optional leaf-index output column", str, default=None)
    features_shap_col = Param("optional per-feature contribution output column",
                              str, default=None)
    device = Param("'cuda[:i]' (default: the GPU) or 'cpu'", str, default=None)
    sparse_num_bits = Param("hash-mask bits for sparse feature columns", int, default=18)
    booster = ComplexParam("trained GBDTBooster", object, default=None)

    def input_schema(self) -> TableSchema:
        return TableSchema({self.features_col: _FEATURES_SPEC})

    def _extra_schema(self, schema: TableSchema) -> TableSchema:
        if self.leaf_prediction_col:
            schema = schema.with_column(self.leaf_prediction_col,
                                        ColumnSpec("float", "vector"))
        if self.features_shap_col:
            schema = schema.with_column(self.features_shap_col, ColumnSpec("any", "any"))
        return schema

    def _extra_outputs(self, out: Table, x) -> Table:
        """The leaf index of every row in every tree, (n, T*C) float64, and
        each row's contributions, (n, d+1) or, multiclass, (n, C*(d+1)) class
        after class (the reference's layout). For CSR rows the contributions
        are a column of ``(indices, values)`` pairs, class ``c``'s indices
        offset by ``c * (d+1)`` (the reference's sparse layout)."""
        if self.leaf_prediction_col:
            out = out.with_column(self.leaf_prediction_col,
                                  self.booster.predict_leaf(x, device=self.device)
                                  .astype(np.float64))
        if self.features_shap_col:
            contrib = self.booster.predict_contrib(x, device=self.device)
            if isinstance(contrib, (CSRMatrix, list)):
                mats = contrib if isinstance(contrib, list) else [contrib]
                col = np.empty(mats[0].shape[0], dtype=object)
                for i in range(len(col)):
                    parts = [(m.indices[m.indptr[i]:m.indptr[i + 1]].astype(np.int64)
                              + c * m.shape[1], m.values[m.indptr[i]:m.indptr[i + 1]])
                             for c, m in enumerate(mats)]
                    col[i] = (np.concatenate([p[0] for p in parts]),
                              np.concatenate([p[1] for p in parts]))
                return out.with_column(self.features_shap_col, col)
            if contrib.ndim == 3:
                contrib = np.concatenate(list(contrib), axis=1)
            out = out.with_column(self.features_shap_col, contrib)
        return out

    def save_native_model(self, path: str, fmt: str = "lightgbm") -> None:
        """Write the booster to ``path``: LightGBM's text model (``fmt='lightgbm'``,
        which a stock LightGBM loads) or the JSON model string (``'json'``)."""
        if fmt not in ("lightgbm", "json"):
            raise ValueError(f"fmt must be lightgbm|json, got {fmt!r}")
        with open(path, "w") as f:
            f.write(self.booster.save_native_model() if fmt == "lightgbm"
                    else self.booster.to_json())

    @classmethod
    def load_native_model(cls, path: str, **params):
        """A model stage around the booster in ``path``, in either format."""
        with open(path) as f:
            text = f.read()
        return cls(booster=GBDTBooster.from_model_string(text), **params)

    def get_feature_importances(self, importance_type: str = "split") -> np.ndarray:
        return self.booster.feature_importance(importance_type)


class LightGBMClassifier(_LightGBMBase):
    """Classifier (reference ``LightGBMClassifier.scala:26``): binary for two
    labels, multiclass for more; labels may be any values, predictions carry
    them back."""

    objective = Param("binary | multiclass (auto from labels if unset)", str, default="")
    probability_col = Param("probability output column", str, default="probability")
    raw_prediction_col = Param("raw margin output column", str, default="rawPrediction")
    is_unbalance = Param("rescale grad of minority class (reference isUnbalance)",
                         bool, default=False)

    def input_schema(self) -> TableSchema:
        return super().input_schema().with_column(self.label_col,
                                                  ColumnSpec("any", "scalar"))

    def _unfitted_model(self) -> "LightGBMClassificationModel":
        return LightGBMClassificationModel(probability_col=self.probability_col,
                                           raw_prediction_col=self.raw_prediction_col,
                                           **self._model_params())

    def _fit(self, table: Table) -> "LightGBMClassificationModel":
        self._validate_input(table, self.features_col, self.label_col)
        classes, y_idx = np.unique(np.asarray(table[self.label_col]), return_inverse=True)
        n_class = len(classes)
        if n_class < 2:
            raise ValueError(f"need >= 2 classes, label column has {n_class}")
        obj = self.objective or ("binary" if n_class == 2 else "multiclass")
        extra = {"objective": obj}
        if obj in ("multiclass", "softmax"):
            extra["num_class"] = n_class
        tbl = table.with_column(self.label_col, y_idx.astype(np.float64))
        weight_col = None
        if self.is_unbalance and n_class == 2 and not self.weight_col:
            # positives weighted by the negative-to-positive ratio (the
            # reference's isUnbalance, estimators.py:462-472)
            pos = max(int((y_idx == 1).sum()), 1)
            neg = int((y_idx == 0).sum())
            weight_col = "__unbalance_weight__"
            tbl = tbl.with_column(weight_col, np.where(y_idx == 1, neg / pos, 1.0))
        booster = self._fit_booster(tbl, extra, weight_col=weight_col)
        model = self._unfitted_model()
        model.set("booster", booster)
        model.set("labels", classes.astype(np.float64)
                  if np.issubdtype(classes.dtype, np.number) else classes)
        return model


class LightGBMClassificationModel(_LightGBMModelBase):
    probability_col = Param("probability output column", str, default="probability")
    raw_prediction_col = Param("raw margin output column", str, default="rawPrediction")
    labels = ComplexParam("class label values in index order", object, default=None)

    def transform_schema(self, schema: TableSchema) -> TableSchema:
        self._check_schema(schema, self.input_schema())
        return self._extra_schema(
            schema.with_column(self.prediction_col, ColumnSpec("any", "scalar"))
            .with_column(self.raw_prediction_col, ColumnSpec("float", "vector"))
            .with_column(self.probability_col, ColumnSpec("float", "vector")))

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.features_col)
        x = _features(table, self.features_col, self.sparse_num_bits)
        b: GBDTBooster = self.booster
        raw = b.raw_predict(x, device=self.device)
        prob = b.activate(raw)  # one scoring pass feeds both output columns
        if b.num_class == 1:  # binary: 2-class vectors, as the reference emits
            raw2 = np.stack([-raw, raw], axis=1)
            prob2 = np.stack([1 - prob, prob], axis=1)
            idx = (prob >= 0.5).astype(np.int64)
        else:
            raw2, prob2 = raw, prob
            idx = prob.argmax(axis=1)
        labels = self.labels
        pred = np.asarray(labels)[idx] if labels is not None else idx.astype(np.float64)
        out = table.with_column(self.raw_prediction_col, raw2.astype(np.float32))
        out = out.with_column(self.probability_col, prob2.astype(np.float32))
        return self._extra_outputs(out.with_column(self.prediction_col, pred), x)


class LightGBMRegressor(_LightGBMBase):
    """Regressor (reference ``LightGBMRegressor.scala:38``; objectives
    regression/l1/huber/quantile/poisson/tweedie)."""

    objective = Param("regression objective", str, default="regression")
    alpha = Param("huber/quantile alpha", float, default=0.9)
    tweedie_variance_power = Param("tweedie variance power in [1, 2)", float, default=1.5)

    def _fit(self, table: Table) -> "LightGBMRegressionModel":
        booster = self._fit_booster(table, {
            "alpha": self.alpha, "tweedie_variance_power": self.tweedie_variance_power})
        return LightGBMRegressionModel(booster=booster, **self._model_params())


class LightGBMRegressionModel(_LightGBMModelBase):
    def transform_schema(self, schema: TableSchema) -> TableSchema:
        self._check_schema(schema, self.input_schema())
        return self._extra_schema(
            schema.with_column(self.prediction_col, ColumnSpec("float", "scalar")))

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.features_col)
        x = _features(table, self.features_col, self.sparse_num_bits)
        out = table.with_column(self.prediction_col,
                                self.booster.predict(x, device=self.device)
                                .astype(np.float64))
        return self._extra_outputs(out, x)


class LightGBMRanker(_LightGBMBase):
    """Ranker (reference ``LightGBMRanker.scala:25``): lambdarank over the
    queries of ``group_col``. Rows are stable-sorted by group id, so a
    query's rows are contiguous; the training and validation rows' query
    sizes are the ``np.unique`` counts of their group ids."""

    objective = Param("ranking objective", str, default="lambdarank")
    group_col = Param("query/group id column", str, default="group")
    ndcg_at = Param("NDCG truncation for eval", int, default=10)
    lambdarank_truncation_level = Param("pairs beyond this rank are ignored", int,
                                        default=30)
    max_position = Param("accepted for API parity (maxPosition)", int, default=20)

    def input_schema(self) -> TableSchema:
        return super().input_schema().with_column(self.group_col, ColumnSpec("any", "scalar"))

    def _fit(self, table: Table) -> "LightGBMRankerModel":
        self._validate_input(table, self.group_col)
        order = np.argsort(np.asarray(table[self.group_col]), kind="stable")

        def sizes_of(t: Table) -> np.ndarray:
            # np.unique sorts, and the rows are sorted by group: counts align
            return np.unique(np.asarray(t[self.group_col]), return_counts=True)[1]

        booster = self._fit_booster(
            table.take(order),
            {"lambdarank_truncation_level": self.lambdarank_truncation_level,
             "ndcg_at": self.ndcg_at},
            group_sizes=sizes_of)
        return LightGBMRankerModel(booster=booster, **self._model_params())


class LightGBMRankerModel(LightGBMRegressionModel):
    """Fitted ranker: scores rows as the regression model does (the raw
    margin in ``prediction_col``)."""
