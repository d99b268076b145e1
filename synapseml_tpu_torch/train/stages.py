"""Train helpers: auto-featurizing wrappers + model statistics.

Reference: ``core/.../train/`` (1270 LoC) — ``TrainClassifier.scala:50`` /
``TrainRegressor`` (auto-featurize any columns, index labels, fit the wrapped
learner), ``ComputeModelStatistics.scala:59`` (confusion matrix, accuracy,
precision/recall/AUC for classifiers; MSE/RMSE/R2/MAE for regressors),
``ComputePerInstanceStatistics`` (per-row L1/L2 loss or log-loss).

The port's copy of the JAX package's ``train/stages.py``, over the port's
LightGBM estimators and metrics.
"""

from __future__ import annotations

import numpy as np

from ..core import ComplexParam, Estimator, Model, Param, Table, Transformer
from ..featurize.stages import Featurize
from ..gbdt.metrics import METRICS

__all__ = [
    "TrainClassifier", "TrainedClassifierModel",
    "TrainRegressor", "TrainedRegressorModel",
    "ComputeModelStatistics", "ComputePerInstanceStatistics",
]


class _TrainBase(Estimator):
    _abstract_stage = True

    model = ComplexParam("the learner estimator to train", object, default=None)
    label_col = Param("label column", str, default="label")
    features_col = Param("assembled features column", str, default="features")
    input_cols = Param("columns to featurize ([] = all non-label)", list, default=[])
    number_of_features = Param("hash space for high-cardinality columns", int,
                               default=262144)

    def _featurizer(self, table: Table) -> "Model":
        cols = list(self.input_cols) or [
            c for c in table.column_names if c != self.label_col
        ]
        return Featurize(input_cols=cols, output_col=self.features_col,
                         num_features=self.number_of_features).fit(table)


class TrainClassifier(_TrainBase):
    """Featurize + index labels + fit (reference ``TrainClassifier.scala:50``).
    Default learner: the port's LightGBMClassifier, on the GPU (pass
    ``model=LightGBMClassifier(device="cpu")`` to train on the CPU)."""

    def _fit(self, table: Table) -> "TrainedClassifierModel":
        self._validate_input(table, self.label_col)
        feat = self._featurizer(table)
        featurized = feat.transform(table)
        learner = self.model
        if learner is None:
            from ..gbdt import LightGBMClassifier

            learner = LightGBMClassifier()
        learner.set("features_col", self.features_col)
        learner.set("label_col", self.label_col)
        fitted = learner.fit(featurized)
        return TrainedClassifierModel(
            featurizer=feat, inner_model=fitted, label_col=self.label_col,
            features_col=self.features_col)


class TrainedClassifierModel(Model):
    featurizer = ComplexParam("fitted featurizer", object, default=None)
    inner_model = ComplexParam("fitted learner model", object, default=None)
    label_col = Param("label column", str, default="label")
    features_col = Param("features column", str, default="features")

    def _transform(self, table: Table) -> Table:
        return self.inner_model.transform(self.featurizer.transform(table))


class TrainRegressor(_TrainBase):
    """Reference ``TrainRegressor``. Default learner: the port's
    LightGBMRegressor, on the GPU."""

    def _fit(self, table: Table) -> "TrainedRegressorModel":
        self._validate_input(table, self.label_col)
        feat = self._featurizer(table)
        featurized = feat.transform(table)
        learner = self.model
        if learner is None:
            from ..gbdt import LightGBMRegressor

            learner = LightGBMRegressor()
        learner.set("features_col", self.features_col)
        learner.set("label_col", self.label_col)
        fitted = learner.fit(featurized)
        return TrainedRegressorModel(
            featurizer=feat, inner_model=fitted, label_col=self.label_col,
            features_col=self.features_col)


class TrainedRegressorModel(Model):
    featurizer = ComplexParam("fitted featurizer", object, default=None)
    inner_model = ComplexParam("fitted learner model", object, default=None)
    label_col = Param("label column", str, default="label")
    features_col = Param("features column", str, default="features")

    def _transform(self, table: Table) -> Table:
        return self.inner_model.transform(self.featurizer.transform(table))


class ComputeModelStatistics(Transformer):
    """Scored table -> one-row metrics table
    (reference ``ComputeModelStatistics.scala:59``).

    ``evaluation_metric``: 'classification' | 'regression' | 'auto'."""

    label_col = Param("label column", str, default="label")
    scores_col = Param("prediction column", str, default="prediction")
    scored_labels_col = Param("alias of scores_col (reference name)", str,
                              default=None)
    probability_col = Param("probability column for AUC (classification)",
                            str, default="probability")
    evaluation_metric = Param("classification | regression | auto", str,
                              default="auto")

    def _transform(self, table: Table) -> Table:
        pred_col = self.scored_labels_col or self.scores_col
        self._validate_input(table, self.label_col, pred_col)
        y = table[self.label_col]
        pred = table[pred_col]
        mode = self.evaluation_metric
        if mode == "auto":
            numeric = (np.asarray(y).dtype != object
                       and len(np.unique(np.asarray(y))) > 10)
            mode = "regression" if numeric else "classification"
        if mode == "regression":
            yv = np.asarray(y, np.float64)
            pv = np.asarray(pred, np.float64)
            mse = float(np.mean((yv - pv) ** 2))
            ss_tot = float(np.sum((yv - yv.mean()) ** 2))
            stats = {
                "mean_squared_error": mse,
                "root_mean_squared_error": float(np.sqrt(mse)),
                "mean_absolute_error": float(np.mean(np.abs(yv - pv))),
                "R^2": 1.0 - float(np.sum((yv - pv) ** 2)) / ss_tot if ss_tot else 0.0,
            }
            return Table({k: np.array([v]) for k, v in stats.items()})
        # classification
        y_list = y.tolist()
        p_list = pred.tolist()
        classes = sorted({*y_list, *p_list}, key=str)
        lut = {c: i for i, c in enumerate(classes)}
        k = len(classes)
        cm = np.zeros((k, k), np.int64)
        for a, b in zip(y_list, p_list):
            cm[lut[a], lut[b]] += 1
        total = cm.sum()
        acc = float(np.trace(cm)) / total if total else 0.0
        with np.errstate(invalid="ignore", divide="ignore"):
            prec = np.diag(cm) / np.maximum(cm.sum(axis=0), 1)
            rec = np.diag(cm) / np.maximum(cm.sum(axis=1), 1)
        stats = {
            "accuracy": acc,
            "precision": float(np.mean(prec)),
            "recall": float(np.mean(rec)),
        }
        if k == 2 and self.probability_col in table:
            prob = np.asarray(table[self.probability_col])
            score = prob[:, 1] if prob.ndim == 2 else prob
            y_bin = np.array([lut[v] for v in y_list], np.float64)
            stats["AUC"] = METRICS["auc"][0](y_bin, score.astype(np.float64),
                                             np.ones(len(y_bin)))
        out = Table({k2: np.array([v]) for k2, v in stats.items()})
        out.meta["confusion_matrix"] = {"matrix": cm, "classes": classes}
        return out


class ComputePerInstanceStatistics(Transformer):
    """Per-row loss columns (reference ``ComputePerInstanceStatistics``)."""

    label_col = Param("label column", str, default="label")
    scores_col = Param("prediction column", str, default="prediction")
    probability_col = Param("probability column (classification)", str,
                            default="probability")
    evaluation_metric = Param("classification | regression | auto", str,
                              default="auto")

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.label_col, self.scores_col)
        y = table[self.label_col]
        pred = table[self.scores_col]
        mode = self.evaluation_metric
        if mode == "auto":
            numeric = (np.asarray(y).dtype != object
                       and len(np.unique(np.asarray(y))) > 10)
            mode = "regression" if numeric else "classification"
        if mode == "regression":
            yv = np.asarray(y, np.float64)
            pv = np.asarray(pred, np.float64)
            return (table.with_column("L1_loss", np.abs(yv - pv))
                    .with_column("L2_loss", (yv - pv) ** 2))
        if self.probability_col in table:
            prob = np.asarray(table[self.probability_col], np.float64)
            classes = sorted({*y.tolist()}, key=str)
            lut = {c: i for i, c in enumerate(classes)}
            idx = np.array([lut.get(v, 0) for v in y.tolist()])
            if prob.ndim == 2 and prob.shape[1] >= len(classes):
                p_true = prob[np.arange(len(idx)), idx]
            else:
                p1 = prob if prob.ndim == 1 else prob[:, -1]
                p_true = np.where(idx == 1, p1, 1 - p1)
            ll = -np.log(np.clip(p_true, 1e-15, None))
            return table.with_column("log_loss", ll)
        correct = np.array([a == b for a, b in zip(y.tolist(), pred.tolist())],
                           np.float64)
        return table.with_column("0_1_loss", 1.0 - correct)
