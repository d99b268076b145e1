"""VW estimator stages.

Reference: ``VowpalWabbitClassifier`` / ``VowpalWabbitRegressor`` /
``VowpalWabbitContextualBandit`` over ``VowpalWabbitBase``
(``vw/src/main/scala/.../vw/VowpalWabbitBase.scala``): args building
(``buildCommandLineArguments:235-256``), row training (``trainRow:259-290``),
distributed AllReduce (``trainInternalDistributed:432-460``), per-phase timing
diagnostics (``getPerformanceStatistics``).

A ``pass_through_args`` string accepts the common VW flags (``--loss_function``,
``-b/--bit_precision``, ``--passes``, ``-l/--learning_rate``, ``--l1``, ``--l2``,
``--quantile_tau``) so reference configs port over.

Port of ``synapseml_tpu/vw/estimators.py``. ``device`` picks where a fit
runs: the GPU by default (kernel V a batch), ``"cpu"`` for the plain
PyTorch step. ``mesh`` (a :class:`~synapseml_tpu_torch.runtime.layout.SpecLayout`
or a ``DeviceMesh`` over an initialised process group) trains over the
mesh's data ranks with pass-boundary averaging (``train_linear(...,
mesh=)``), each rank calling ``fit`` on the same table. The models score on
the host in numpy, as the reference's do, so a state trained anywhere
scores the same bits. A fitted model's ``performance_statistics`` holds the
fit's record: rows, passes, batches a pass, the seconds of ``pad_examples``
and of learning (and learning's parts: ``learn_seconds``), and kernel V's
launches.
"""

from __future__ import annotations

import shlex
import time
from typing import Dict

import numpy as np

from ..core import ComplexParam, Estimator, Model, Param, Table
from .learner import LinearLearnerState, pad_examples, predict_linear, train_linear

__all__ = [
    "VowpalWabbitClassifier", "VowpalWabbitClassificationModel",
    "VowpalWabbitRegressor", "VowpalWabbitRegressionModel",
    "VowpalWabbitContextualBandit", "VowpalWabbitContextualBanditModel",
]

_ARG_MAP = {
    "--loss_function": ("loss_function", str),
    "-b": ("num_bits", int), "--bit_precision": ("num_bits", int),
    "--passes": ("num_passes", int),
    "-l": ("learning_rate", float), "--learning_rate": ("learning_rate", float),
    "--l1": ("l1", float), "--l2": ("l2", float),
    "--power_t": ("power_t", float),
    "--quantile_tau": ("quantile_tau", float),
    "--hash_seed": ("hash_seed", int),
}


def parse_vw_args(args: str) -> Dict[str, object]:
    """Parse the supported subset of a VW command line (reference passThroughArgs)."""
    out: Dict[str, object] = {}
    toks = shlex.split(args or "")
    i = 0
    while i < len(toks):
        t = toks[i]
        if t in _ARG_MAP:
            name, cast = _ARG_MAP[t]
            if i + 1 >= len(toks):
                raise ValueError(f"VW arg {t} expects a value")
            out[name] = cast(toks[i + 1])
            i += 2
        else:
            i += 1  # unknown flags are ignored (reference passes them to VW)
    return out



def _merge_sparse(table: Table, cols) -> np.ndarray:
    """Concatenate sparse (idx, val) columns row-wise into one example column."""
    base = table[cols[0]]
    if len(cols) == 1:
        return base
    merged = np.empty(len(base), dtype=object)
    for r in range(len(base)):
        parts = [table[c][r] for c in cols]
        merged[r] = (np.concatenate([p[0] for p in parts]),
                     np.concatenate([p[1] for p in parts]))
    return merged


class _VWBase(Estimator):
    _abstract_stage = True

    features_col = Param("sparse features column (from VowpalWabbitFeaturizer)", str,
                         default="features")
    additional_features = Param("extra sparse columns appended to the example "
                                "(reference additionalFeatures)", list, default=[])
    label_col = Param("label column", str, default="label")
    weight_col = Param("optional importance-weight column", str, default=None)
    prediction_col = Param("prediction output column", str, default="prediction")
    num_bits = Param("weight-space bits (reference numBits, VW -b)", int, default=18)
    num_passes = Param("passes over the data (reference numPasses)", int, default=1)
    learning_rate = Param("VW -l", float, default=0.5)
    power_t = Param("VW --power_t (API parity; adagrad supersedes)", float, default=0.5)
    l1 = Param("VW --l1", float, default=0.0)
    l2 = Param("VW --l2", float, default=0.0)
    batch_size = Param("minibatch size of the learner's step", int, default=256)
    pass_through_args = Param("VW-style args string (supported subset parsed)", str,
                              default="")
    use_barrier_execution_mode = Param("API parity (SPMD is implicitly gang-scheduled)",
                                       bool, default=False)
    hash_seed = Param("hash seed (API parity with featurizer)", int, default=0)
    mesh = ComplexParam("optional SpecLayout or DeviceMesh: per-pass weight averaging "
                        "over its data axis", object, default=None)
    device = Param("'cuda[:i]' (default: the GPU) or 'cpu'", str, default=None)

    def _hyper(self) -> Dict[str, object]:
        h = dict(
            num_bits=self.num_bits, num_passes=self.num_passes,
            learning_rate=self.learning_rate, power_t=self.power_t,
            l1=self.l1, l2=self.l2, batch_size=self.batch_size,
        )
        h.update(parse_vw_args(self.pass_through_args))
        h.pop("hash_seed", None)  # featurizer concern; train_linear has no such arg
        return h

    def _gather(self, table: Table):
        cols = [self.features_col, *self.additional_features]
        self._validate_input(table, *cols, self.label_col)
        h = self._hyper()
        col = _merge_sparse(table, cols)
        t0 = time.perf_counter()
        idx, val = pad_examples(col, int(h["num_bits"]))
        pad_s = time.perf_counter() - t0
        w = (np.asarray(table[self.weight_col], np.float32)
             if self.weight_col else None)
        return idx, val, w, h, pad_s

    def _learn(self, idx, val, y, pad_s: float, **kw):
        """``train_linear`` on this stage's device and mesh; (state, the fit's
        performance statistics)."""
        rec: Dict = {}
        t0 = time.perf_counter()
        state = train_linear(idx, val, y, mesh=self.mesh, device=self.device, stats=rec, **kw)
        stats = {"rows": len(y), "passes": int(kw["num_passes"]),
                 "learn_time_s": time.perf_counter() - t0, "pad_examples_s": pad_s,
                 "batches_a_pass": rec["batches_a_pass"], "device": rec["device"],
                 "kernel_launches": rec["kernel_launches"], "learn_seconds": rec["seconds"]}
        return state, stats


class VowpalWabbitClassifier(_VWBase):
    """Binary classifier (reference ``VowpalWabbitClassifier``; VW logistic loss,
    labels mapped to -1/+1)."""

    loss_function = Param("logistic | hinge", str, default="logistic")
    probability_col = Param("probability output column", str, default="probability")
    raw_prediction_col = Param("raw margin output column", str, default="rawPrediction")

    def _fit(self, table: Table) -> "VowpalWabbitClassificationModel":
        idx, val, w, h, pad_s = self._gather(table)
        y_raw = np.asarray(table[self.label_col])
        classes = np.unique(y_raw)
        if len(classes) != 2:
            raise ValueError(f"binary classifier needs 2 classes, got {len(classes)}")
        y = np.where(y_raw == classes[1], 1.0, -1.0).astype(np.float32)
        loss = h.pop("loss_function", self.loss_function)
        state, stats = self._learn(idx, val, y, pad_s, loss=loss, weight=w, **h)
        m = VowpalWabbitClassificationModel(
            state=state, labels=classes, num_bits=int(h["num_bits"]),
            additional_features=list(self.additional_features),
            features_col=self.features_col, prediction_col=self.prediction_col,
            probability_col=self.probability_col,
            raw_prediction_col=self.raw_prediction_col,
        )
        m.performance_statistics = stats
        return m


class VowpalWabbitClassificationModel(Model):
    features_col = Param("sparse features column", str, default="features")
    additional_features = Param("extra sparse columns", list, default=[])
    prediction_col = Param("prediction output column", str, default="prediction")
    probability_col = Param("probability output column", str, default="probability")
    raw_prediction_col = Param("raw margin output column", str, default="rawPrediction")
    num_bits = Param("weight-space bits", int, default=18)
    state = ComplexParam("LinearLearnerState", object, default=None)
    labels = ComplexParam("class values (index order)", object, default=None)

    def _post_load(self):
        if isinstance(self.state, dict):
            self.set("state", LinearLearnerState(**self.state))

    def _transform(self, table: Table) -> Table:
        cols = [self.features_col, *self.additional_features]
        self._validate_input(table, *cols)
        idx, val = pad_examples(_merge_sparse(table, cols), self.num_bits)
        st = self.state
        if not isinstance(st, LinearLearnerState):
            st = LinearLearnerState(*st)
        raw = predict_linear(st, idx, val)
        prob = np.where(raw >= 0, 1 / (1 + np.exp(-np.abs(raw))),
                        np.exp(-np.abs(raw)) / (1 + np.exp(-np.abs(raw))))
        pick = (prob >= 0.5).astype(int)
        labels = np.asarray(self.labels)
        out = table.with_column(self.raw_prediction_col,
                                np.stack([-raw, raw], 1).astype(np.float32))
        out = out.with_column(self.probability_col,
                              np.stack([1 - prob, prob], 1).astype(np.float32))
        return out.with_column(self.prediction_col, labels[pick])


class VowpalWabbitRegressor(_VWBase):
    """Reference ``VowpalWabbitRegressor`` (squared / quantile loss)."""

    loss_function = Param("squared | quantile", str, default="squared")
    quantile_tau = Param("quantile loss tau", float, default=0.5)

    def _fit(self, table: Table) -> "VowpalWabbitRegressionModel":
        idx, val, w, h, pad_s = self._gather(table)
        y = np.asarray(table[self.label_col], np.float32)
        loss = h.pop("loss_function", self.loss_function)
        tau = h.pop("quantile_tau", self.quantile_tau)
        state, stats = self._learn(idx, val, y, pad_s, loss=loss, weight=w,
                                   quantile_tau=tau, **h)
        m = VowpalWabbitRegressionModel(
            state=state, num_bits=int(h["num_bits"]),
            additional_features=list(self.additional_features),
            features_col=self.features_col, prediction_col=self.prediction_col,
        )
        m.performance_statistics = stats
        return m


class VowpalWabbitRegressionModel(Model):
    features_col = Param("sparse features column", str, default="features")
    additional_features = Param("extra sparse columns", list, default=[])
    prediction_col = Param("prediction output column", str, default="prediction")
    num_bits = Param("weight-space bits", int, default=18)
    state = ComplexParam("LinearLearnerState", object, default=None)

    def _post_load(self):
        if isinstance(self.state, dict):
            self.set("state", LinearLearnerState(**self.state))

    def _transform(self, table: Table) -> Table:
        cols = [self.features_col, *self.additional_features]
        self._validate_input(table, *cols)
        idx, val = pad_examples(_merge_sparse(table, cols), self.num_bits)
        st = self.state
        if not isinstance(st, LinearLearnerState):
            st = LinearLearnerState(*st)
        return table.with_column(self.prediction_col,
                                 predict_linear(st, idx, val).astype(np.float64))


class VowpalWabbitContextualBandit(_VWBase):
    """Contextual bandit with per-action features (reference
    ``VowpalWabbitContextualBandit``; VW ``--cb_adf`` style).

    Input columns: ``shared_col`` (sparse shared/context features),
    ``features_col`` (object column: list of per-action sparse features),
    ``chosen_action_col`` (1-based chosen index, like VW), ``label_col`` (cost of
    the chosen action), ``probability_col`` (logging propensity). Training fits the
    cost regressor on (shared + chosen-action) features with IPS weights 1/p."""

    shared_col = Param("shared/context sparse column", str, default="shared")
    chosen_action_col = Param("1-based chosen action column", str, default="chosenAction")
    probability_col = Param("logging propensity column", str, default="probability")
    epsilon = Param("epsilon for predicted exploration distribution", float, default=0.05)

    def _fit(self, table: Table) -> "VowpalWabbitContextualBanditModel":
        self._validate_input(table, self.shared_col, self.features_col,
                             self.chosen_action_col, self.label_col,
                             self.probability_col)
        h = self._hyper()
        h.pop("loss_function", None)
        n = table.num_rows
        merged = np.empty(n, dtype=object)
        actions_col = table[self.features_col]
        shared_col = table[self.shared_col]
        chosen = np.asarray(table[self.chosen_action_col], dtype=int)
        for r in range(n):
            acts = actions_col[r]
            a = chosen[r] - 1  # VW is 1-based
            if not 0 <= a < len(acts):
                raise ValueError(f"row {r}: chosenAction {chosen[r]} out of range "
                                 f"1..{len(acts)}")
            si, sv = shared_col[r]
            ai, av = acts[a]
            merged[r] = (np.concatenate([si, ai]), np.concatenate([sv, av]))
        t0 = time.perf_counter()
        idx, val = pad_examples(merged, int(h["num_bits"]))
        pad_s = time.perf_counter() - t0
        cost = np.asarray(table[self.label_col], np.float32)
        prob = np.clip(np.asarray(table[self.probability_col], np.float64), 1e-6, 1.0)
        ips_w = (1.0 / prob).astype(np.float32)
        if self.weight_col:
            ips_w = ips_w * np.asarray(table[self.weight_col], np.float32)
        state, stats = self._learn(idx, val, cost, pad_s, loss="squared", weight=ips_w, **h)
        m = VowpalWabbitContextualBanditModel(
            state=state, num_bits=int(h["num_bits"]),
            shared_col=self.shared_col, features_col=self.features_col,
            prediction_col=self.prediction_col, epsilon=self.epsilon,
        )
        m.performance_statistics = stats
        return m


class VowpalWabbitContextualBanditModel(Model):
    shared_col = Param("shared/context sparse column", str, default="shared")
    features_col = Param("per-action features column", str, default="features")
    prediction_col = Param("output column: per-action exploration probabilities",
                           str, default="prediction")
    num_bits = Param("weight-space bits", int, default=18)
    epsilon = Param("epsilon-greedy mass", float, default=0.05)
    state = ComplexParam("LinearLearnerState", object, default=None)

    def _post_load(self):
        if isinstance(self.state, dict):
            self.set("state", LinearLearnerState(**self.state))

    def _transform(self, table: Table) -> Table:
        self._validate_input(table, self.shared_col, self.features_col)
        st = self.state
        if not isinstance(st, LinearLearnerState):
            st = LinearLearnerState(*st)
        n = table.num_rows
        actions_col = table[self.features_col]
        shared_col = table[self.shared_col]
        out = np.empty(n, dtype=object)
        eps = float(self.epsilon)
        for r in range(n):
            si, sv = shared_col[r]
            acts = actions_col[r]
            merged = np.empty(len(acts), dtype=object)
            for a, (ai, av) in enumerate(acts):
                merged[a] = (np.concatenate([si, ai]), np.concatenate([sv, av]))
            idx, val = pad_examples(merged, self.num_bits)
            costs = predict_linear(st, idx, val)
            k = len(acts)
            probs = np.full(k, eps / k)
            probs[int(np.argmin(costs))] += 1.0 - eps
            out[r] = probs.astype(np.float32)
        return table.with_column(self.prediction_col, out)
