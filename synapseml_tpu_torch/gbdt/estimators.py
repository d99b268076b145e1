"""LightGBM-style estimator stages over Tables — the port's dense subset.

Port of ``synapseml_tpu/gbdt/estimators.py``: ``LightGBMClassifier`` /
``LightGBMClassificationModel`` (binary) and ``LightGBMRegressor`` /
``LightGBMRegressionModel`` (l2), dense feature columns. Params keep the
reference's names and defaults; those whose behaviour is not ported yet
(bagging, feature fraction, goss/dart/rf, categorical slots, early stopping,
validation columns, batches) are refused by ``train`` or here when set away
from their defaults.

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

__all__ = [
    "LightGBMClassifier", "LightGBMClassificationModel",
    "LightGBMRegressor", "LightGBMRegressionModel",
]

_FEATURES_SPEC = ColumnSpec("any", "vector")


def _features(table: Table, col: str) -> np.ndarray:
    arr = table.column(col)
    if arr.dtype in (np.float32, np.float64):
        return arr  # binning compares in f64; keep f32 input as it is
    return features_matrix(arr)


class _LightGBMBase(Estimator):
    """Shared params (reference ``LightGBMParams.scala``) and fit plumbing."""

    _abstract_stage = True

    features_col = Param("features column (vector)", str, default="features")
    label_col = Param("label column", str, default="label")
    prediction_col = Param("prediction output column", str, default="prediction")
    weight_col = Param("optional sample-weight column", str, default=None)
    device = Param("'cuda[:i]' (default: the GPU) or 'cpu'", str, default=None)

    boosting_type = Param("gbdt (rf | dart | goss not ported yet)", str, default="gbdt",
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
    bin_sample_count = Param("rows sampled for bin-edge estimation", int,
                             default=200_000, validator=ParamValidators.gt(0))
    bagging_fraction = Param("row subsample fraction (not ported yet)", float, default=1.0)
    bagging_freq = Param("bag every k iterations (not ported yet)", int, default=0)
    feature_fraction = Param("feature subsample fraction (not ported yet)", float,
                             default=1.0)
    lambda_l1 = Param("L1 regularization", float, default=0.0)
    lambda_l2 = Param("L2 regularization", float, default=0.0)
    min_sum_hessian_in_leaf = Param("min hessian mass per leaf", float, default=1e-3)
    min_data_in_leaf = Param("min rows per leaf", int, default=20)
    min_gain_to_split = Param("min split gain", float, default=0.0)
    early_stopping_round = Param("early stopping rounds (not ported yet)", int, default=0)
    seed = Param("random seed (bin sampling)", int, default=0)

    objective = Param("training objective", str, default="regression")

    def input_schema(self) -> TableSchema:
        cols = {self.features_col: _FEATURES_SPEC,
                self.label_col: ColumnSpec("float", "scalar")}
        if self.weight_col:
            cols[self.weight_col] = ColumnSpec("float", "scalar")
        return TableSchema(cols)

    def _train_params(self) -> dict:
        return {
            "objective": self.objective, "boosting": self.boosting_type,
            "num_iterations": self.num_iterations, "learning_rate": self.learning_rate,
            "num_leaves": self.num_leaves, "max_depth": self.max_depth,
            "max_delta_step": self.max_delta_step,
            "boost_from_average": self.boost_from_average, "max_bin": self.max_bin,
            "bin_sample_count": self.bin_sample_count,
            "bagging_fraction": self.bagging_fraction, "bagging_freq": self.bagging_freq,
            "feature_fraction": self.feature_fraction,
            "lambda_l1": self.lambda_l1, "lambda_l2": self.lambda_l2,
            "min_sum_hessian_in_leaf": self.min_sum_hessian_in_leaf,
            "min_data_in_leaf": self.min_data_in_leaf,
            "min_gain_to_split": self.min_gain_to_split,
            "early_stopping_round": self.early_stopping_round, "seed": self.seed,
        }

    def _fit_booster(self, table: Table, extra_params: Optional[dict] = None
                     ) -> GBDTBooster:
        self._validate_input(table, self.features_col, self.label_col)
        x = _features(table, self.features_col)
        y = np.asarray(table[self.label_col], dtype=np.float64)
        w = (np.asarray(table[self.weight_col], dtype=np.float64)
             if self.weight_col else None)
        params = self._train_params()
        params.update(extra_params or {})
        slot_names = table.meta.get(self.features_col, {}).get("slot_names")
        return train(params, x, y, weight=w, device=self.device,
                     feature_names=list(slot_names) if slot_names is not None else None)


class _LightGBMModelBase(Model):
    """Shared model params and transform plumbing."""

    _abstract_stage = True

    features_col = Param("features column", str, default="features")
    prediction_col = Param("prediction output column", str, default="prediction")
    device = Param("'cuda[:i]' (default: the GPU) or 'cpu'", str, default=None)
    booster = ComplexParam("trained GBDTBooster", object, default=None)

    def input_schema(self) -> TableSchema:
        return TableSchema({self.features_col: _FEATURES_SPEC})


class LightGBMClassifier(_LightGBMBase):
    """Binary classifier (reference ``LightGBMClassifier.scala:26``); labels may
    be any two values, predictions carry them back."""

    objective = Param("binary (auto from labels if unset)", str, default="")
    probability_col = Param("probability output column", str, default="probability")
    raw_prediction_col = Param("raw margin output column", str, default="rawPrediction")

    def input_schema(self) -> TableSchema:
        return super().input_schema().with_column(self.label_col,
                                                  ColumnSpec("any", "scalar"))

    def _fit(self, table: Table) -> "LightGBMClassificationModel":
        self._validate_input(table, self.features_col, self.label_col)
        classes, y_idx = np.unique(np.asarray(table[self.label_col]), return_inverse=True)
        if len(classes) != 2:
            raise NotImplementedError(
                f"label column has {len(classes)} classes; only binary "
                "classification is ported yet")
        obj = self.objective or "binary"
        tbl = table.with_column(self.label_col, y_idx.astype(np.float64))
        booster = self._fit_booster(tbl, {"objective": obj})
        return LightGBMClassificationModel(
            booster=booster, labels=classes.astype(np.float64)
            if np.issubdtype(classes.dtype, np.number) else classes,
            features_col=self.features_col, prediction_col=self.prediction_col,
            probability_col=self.probability_col,
            raw_prediction_col=self.raw_prediction_col, device=self.device)


class LightGBMClassificationModel(_LightGBMModelBase):
    probability_col = Param("probability output column", str, default="probability")
    raw_prediction_col = Param("raw margin output column", str, default="rawPrediction")
    labels = ComplexParam("class label values in index order", object, default=None)

    def transform_schema(self, schema: TableSchema) -> TableSchema:
        self._check_schema(schema, self.input_schema())
        return (schema.with_column(self.prediction_col, ColumnSpec("any", "scalar"))
                .with_column(self.raw_prediction_col, ColumnSpec("float", "vector"))
                .with_column(self.probability_col, ColumnSpec("float", "vector")))

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.features_col)
        x = _features(table, self.features_col)
        b: GBDTBooster = self.booster
        raw = b.raw_predict(x, device=self.device)
        prob = b.activate(raw)
        raw2 = np.stack([-raw, raw], axis=1)
        prob2 = np.stack([1 - prob, prob], axis=1)
        idx = (prob >= 0.5).astype(np.int64)
        labels = self.labels
        pred = np.asarray(labels)[idx] if labels is not None else idx.astype(np.float64)
        out = table.with_column(self.raw_prediction_col, raw2.astype(np.float32))
        out = out.with_column(self.probability_col, prob2.astype(np.float32))
        return out.with_column(self.prediction_col, pred)


class LightGBMRegressor(_LightGBMBase):
    """l2 regressor (reference ``LightGBMRegressor.scala:38``)."""

    objective = Param("regression objective (l2 only so far)", str, default="regression")

    def _fit(self, table: Table) -> "LightGBMRegressionModel":
        booster = self._fit_booster(table)
        return LightGBMRegressionModel(booster=booster, features_col=self.features_col,
                                       prediction_col=self.prediction_col,
                                       device=self.device)


class LightGBMRegressionModel(_LightGBMModelBase):
    def transform_schema(self, schema: TableSchema) -> TableSchema:
        self._check_schema(schema, self.input_schema())
        return schema.with_column(self.prediction_col, ColumnSpec("float", "scalar"))

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.features_col)
        x = _features(table, self.features_col)
        return table.with_column(self.prediction_col,
                                 self.booster.predict(x, device=self.device)
                                 .astype(np.float64))
