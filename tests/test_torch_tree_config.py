"""Port parity under the growth settings: the port's CPU estimators against
the JAX package's on ``tests/test_torch_gbdt.py::_data``'s fixture (n=3000,
d=8, 5 iterations, 15 leaves, 63 bins), for binary and l2, with each of the
settings kernel E's step entry and the booster read: depth cap, leaf clamp,
l1/l2, a min_gain_to_split that leaves inert steps, hessian and row minima,
no boost from average, another learning rate, NaN features, and sample
weights with zeros.

Trees must be identical. Binary leaf values must be equal; l2 leaf values
agree to 1e-4, the stated cause of ``test_regressor_fit_transform_matches_
reference`` (the reference's CPU program computes ``_preround``'s exp2
inexactly, so a few l2 gradients land on a neighbouring grid point)."""

import numpy as np
import pytest

from synapseml_tpu import Table as RefTable
from synapseml_tpu.gbdt import LightGBMClassifier as RefClassifier
from synapseml_tpu.gbdt import LightGBMRegressor as RefRegressor
from synapseml_tpu_torch.core import Table
from synapseml_tpu_torch.gbdt.estimators import LightGBMClassifier, LightGBMRegressor

PARAMS = dict(num_iterations=5, num_leaves=15, max_bin=63)
LEAF_ATOL = {"binary": 0.0, "l2": 1e-4}
SETTINGS = {
    "max_depth": dict(max_depth=3),
    "max_delta_step": dict(max_delta_step=0.05),
    "lambda_l1_l2": dict(lambda_l1=2.0, lambda_l2=5.0),
    # about the median split gain of each objective's trees on this fixture
    "min_gain_to_split": {"binary": dict(min_gain_to_split=20.0),
                          "l2": dict(min_gain_to_split=100.0)},
    "min_sum_hessian": dict(min_sum_hessian_in_leaf=30.0),
    "min_data_in_leaf": dict(min_data_in_leaf=200),
    "no_boost_from_average": dict(boost_from_average=False),
    "learning_rate": dict(learning_rate=0.3),
    "nan_features": {},
    "zero_weights": dict(weight_col="w"),
}


def _data(seed=0, n=3000, d=8):
    """``tests/test_torch_gbdt.py::_data``'s fixture."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    y_cls = (x[:, 0] + 0.4 * x[:, 5] + 0.2 * rng.normal(size=n) > 0).astype(np.float64)
    y_reg = 2 * x[:, 0] + np.sin(x[:, 1]) + 0.1 * rng.normal(size=n)
    return x, y_cls, y_reg


@pytest.mark.parametrize("objective", ["binary", "l2"])
@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_growth_setting_matches_reference(objective, setting):
    x, y_cls, y_reg = _data(0 if objective == "binary" else 1)
    y = y_cls if objective == "binary" else y_reg
    cols = {"features": x, "label": y}
    if setting == "nan_features":
        rng = np.random.default_rng(7)
        x = x.copy()
        x[rng.random(x.shape) < 0.05] = np.nan
        x[:, 3] = np.where(x[:, 0] > 0.5, np.nan, x[:, 3])  # missingness that matters
        cols["features"] = x
    if setting == "zero_weights":
        rng = np.random.default_rng(8)
        w = rng.uniform(0.5, 2.0, size=len(y))
        w[rng.random(len(y)) < 0.3] = 0.0
        cols["w"] = w
    setting_params = SETTINGS[setting]
    params = dict(PARAMS, **setting_params.get(objective, setting_params))
    ref_cls, port_cls = ((RefClassifier, LightGBMClassifier) if objective == "binary"
                         else (RefRegressor, LightGBMRegressor))
    ref = RefTable(cols).ml_fit(ref_cls(**params)).booster
    port = Table(cols).ml_fit(port_cls(device="cpu", **params)).booster
    for field in ("parent", "feature", "bin"):
        np.testing.assert_array_equal(getattr(port, field), getattr(ref, field),
                                      err_msg=field)
    np.testing.assert_allclose(port.threshold, ref.threshold)
    np.testing.assert_allclose(port.base_score, ref.base_score)
    np.testing.assert_allclose(port.leaf_value, ref.leaf_value, rtol=0,
                               atol=LEAF_ATOL[objective])
    if setting in ("min_gain_to_split", "max_depth"):  # both inert and taken steps
        assert (port.parent < 0).any() and (port.parent >= 0).any()
