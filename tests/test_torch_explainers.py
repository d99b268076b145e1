"""The port's explainers against the JAX package's, on the CPU.

- ``tests/test_explainers.py``'s cases run through the port
  (``device="cpu"``: the regressions' plain path);
- ``fit_regression_batch`` against the reference: least squares (padded
  all-zero columns exactly 0) and the lasso (``kernel_cases.lasso_case``,
  whose |rho| stays clear of lam), within ``REG_TOL`` relative to the
  coefficients' scale: the two sum the same products in another order
  (batched matmuls and reductions against XLA's; the descent's dots), a few
  ulps a step;
- samplers, feature statistics, superpixels and masks bit-equal from the
  same seed;
- every explainer's output from the same seed and model: the samples are
  the same numpy draws, so only the regression's rounding differs
  (``REG_TOL``).
"""

import numpy as np
import pytest

import synapseml_tpu.core as ref_core
import synapseml_tpu.explainers as R
import synapseml_tpu_torch.core as port_core
import synapseml_tpu_torch.explainers as P
from synapseml_tpu_torch.core import Table
from synapseml_tpu_torch.explainers import (ICETransformer, TabularLIME, effective_num_samples,
                                            fit_regression, fit_regression_batch,
                                            kernel_shap_coalitions, mask_image,
                                            slic_superpixels)
from synapseml_tpu_torch.explainers import samplers as port_samplers
from synapseml_tpu_torch.explainers import stats as port_stats
from synapseml_tpu_torch.tools.kernel_cases import lasso_case
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REG_TOL = 1e-4
CPU = dict(device="cpu")


def _models(core):
    """The test models, defined on one package's ``Transformer``."""

    class LinearVec(core.Transformer):
        input_col = core.Param("in", str, default="features")
        beta = core.Param("coefficients", list, default=[])
        bias = core.Param("bias", float, default=0.0)

        def _transform(self, t):
            x = np.asarray(t[self.input_col], np.float64)
            return t.with_column("probability", x @ np.asarray(self.beta) + self.bias)

    class LinearCols(core.Transformer):
        input_cols = core.Param("in", list, default=[])
        beta = core.Param("coefficients", list, default=[])

        def _transform(self, t):
            y = sum(b * np.asarray(t[c], np.float64) for c, b in zip(self.input_cols, self.beta))
            return t.with_column("probability", np.asarray(y))

    class TokenScore(core.Transformer):
        def _transform(self, t):
            y = np.asarray([3.0 * ("good" in v) - 2.0 * ("bad" in v) for v in t["tokens"]])
            return t.with_column("probability", y)

    class BrightRegion(core.Transformer):
        def _transform(self, t):
            y = np.asarray([float(np.mean(img[:8, :8])) for img in t["image"]])
            return t.with_column("probability", y)

    class TwoClass(core.Transformer):
        """probability (n, 2) of a nonlinear score of columns a, c."""

        def _transform(self, t):
            bonus = (t["c"].astype(object) == "x").astype(np.float64)
            s = np.tanh(np.asarray(t["a"], np.float64)) + 0.7 * bonus
            return t.with_column("probability", np.stack([1 - s / 3, s / 3], axis=1))

    return dict(LinearVec=LinearVec, LinearCols=LinearCols, TokenScore=TokenScore,
                BrightRegion=BrightRegion, TwoClass=TwoClass)


REF_M, PORT_M = _models(ref_core), _models(port_core)


def _close(port, ref, tol=REG_TOL):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    assert port.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(port, ref, rtol=0, atol=tol * scale)


def _close_cols(port_col, ref_col, tol=REG_TOL):
    assert len(port_col) == len(ref_col)
    for a, b in zip(port_col, ref_col):
        _close(a, b, tol)


# -- regression core -------------------------------------------------------------------

def test_weighted_least_squares_exact():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 4))
    beta = np.array([1.5, -2.0, 0.5, 3.0])
    res = fit_regression(X, X @ beta + 0.7, alpha=0.0, **CPU)
    np.testing.assert_allclose(res.coefficients, beta, atol=1e-3)
    np.testing.assert_allclose(res.intercept, 0.7, atol=1e-3)
    assert res.r_squared > 0.999


def test_weights_downweight_outliers():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(100, 2))
    y = X @ np.array([1.0, 2.0])
    y[:10] += 50.0
    w = np.ones(100)
    w[:10] = 1e-8
    np.testing.assert_allclose(fit_regression(X, y, w, **CPU).coefficients, [1.0, 2.0],
                               atol=1e-3)


def test_lasso_shrinks_irrelevant():
    rng = np.random.default_rng(2)
    X = rng.normal(size=(300, 6))
    res = fit_regression(X, 2.0 * X[:, 0] - 1.0 * X[:, 1], alpha=0.05, **CPU)
    assert abs(res.coefficients[0]) > 1.0
    assert np.all(np.abs(res.coefficients[2:]) < 0.05)


@pytest.mark.parametrize("alpha", [0.0, 0.01])
def test_zero_variance_column_zero_coef(alpha):
    rng = np.random.default_rng(3)
    X = rng.normal(size=(50, 3))
    X[:, 1] = 0.0
    assert fit_regression(X, X[:, 0], alpha=alpha, **CPU).coefficients[1] == 0.0


def test_batch_matches_single():
    rng = np.random.default_rng(4)
    X, Y, w = rng.normal(size=(3, 80, 4)), rng.normal(size=(3, 80, 2)), rng.random((3, 80)) + .5
    batch = fit_regression_batch(X, Y, w, alpha=0.0, **CPU)
    for i in range(3):
        for t in range(2):
            single = fit_regression(X[i], Y[i, :, t], w[i], alpha=0.0, **CPU)
            np.testing.assert_allclose(batch.coefficients[i, t], single.coefficients, atol=1e-4)
            np.testing.assert_allclose(batch.r_squared[i, t], single.r_squared, atol=1e-4)


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("pad", [0, 3])
def test_least_squares_batch_matches_reference(fit_intercept, pad):
    X, Y, w = lasso_case(5, 4, 120, 9, 3)
    if pad:
        X[:, :, -pad:] = 0.0
        X[1, :, 2:] = 0.0                       # an instance with fewer features
    w[0, :5] = 0.0
    w[2, 7] = -1.0                              # clamped to 0, as the reference does
    ref = R.fit_regression_batch(X, Y, w, alpha=0.0, fit_intercept=fit_intercept)
    port = fit_regression_batch(X, Y, w, alpha=0.0, fit_intercept=fit_intercept, **CPU)
    for f in port._fields:
        _close(getattr(port, f), getattr(ref, f))
    if pad:
        assert (port.coefficients[:, :, -pad:] == 0).all()
        assert (port.coefficients[1, :, 2:] == 0).all()


def test_least_squares_underdetermined_is_minimum_norm():
    rng = np.random.default_rng(6)
    X = (rng.random((2, 10, 30)) < 0.7).astype(np.float64)   # m < k: rank-deficient
    X[:, :, 25:] = 0.0
    Y, w = rng.normal(size=(2, 10, 1)), rng.random((2, 10)) + 0.5
    ref = R.fit_regression_batch(X, Y, w)
    port = fit_regression_batch(X, Y, w, **CPU)
    _close(port.coefficients, ref.coefficients)
    assert (port.coefficients[:, :, 25:] == 0).all()


@pytest.mark.parametrize("k,t,max_iter", [(6, 2, 100), (20, 1, 30), (33, 3, 100)])
def test_lasso_batch_matches_reference(k, t, max_iter):
    X, Y, w = lasso_case(7 + k, 3, 500, k, t)
    ref = R.fit_regression_batch(X, Y, w, alpha=0.01, max_iter=max_iter)
    port = fit_regression_batch(X, Y, w, alpha=0.01, max_iter=max_iter, **CPU)
    for f in port._fields:
        _close(getattr(port, f), getattr(ref, f))
    assert ((port.coefficients == 0) == (ref.coefficients == 0)).all()


@pytest.mark.parametrize("alpha", [0.0, 0.02])
def test_lasso_without_intercept_and_constant_target(alpha):
    """A constant target (a model whose output no perturbation moves) has a
    total sum of squares of exactly 0: r2 is 1 where the fit is exact (with
    an intercept) and -inf where it is not (without one). The port takes the
    weighted means about the first sample, so it gets these exactly; the
    reference's f32 sums leave a residue there, which makes r2 1 or a huge
    negative number in place of -inf."""
    X, Y, w = lasso_case(9, 2, 200, 5, 2)
    Y[1] = 2.5
    for fi in (True, False):
        ref = R.fit_regression_batch(X, Y, w, alpha=alpha, fit_intercept=fi)
        port = fit_regression_batch(X, Y, w, alpha=alpha, fit_intercept=fi, **CPU)
        _close(port.coefficients, ref.coefficients)
        _close(port.r_squared[0], ref.r_squared[0])
        if fi:
            assert (port.r_squared[1] == 1.0).all() and (port.loss[1] == 0.0).all()
            assert (port.coefficients[1] == 0.0).all()
            np.testing.assert_array_equal(ref.r_squared[1], 1.0)
        else:
            assert np.isneginf(port.r_squared[1]).all()
            assert (ref.r_squared[1] < -1e6).all()


def test_fit_regression_defaults_to_the_gpu():
    import torch

    from synapseml_tpu_torch.runtime.device import DeviceUnavailableError

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(DeviceUnavailableError):
        fit_regression(np.ones((4, 2)), np.ones(4))


# -- samplers, statistics, superpixels: bit-equal ---------------------------------------

@pytest.mark.parametrize("k,m", [(6, 40), (12, 100), (3, 8), (40, 60)])
def test_coalitions_bit_equal(k, m):
    a = kernel_shap_coalitions(np.random.default_rng(k), k, m, inf_weight=1e8)
    b = R.kernel_shap_coalitions(np.random.default_rng(k), k, m, inf_weight=1e8)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_effective_num_samples_and_onoff_states_bit_equal():
    for ns, k in ((None, 5), (3, 8), (None, 100), (5000, 12), (10, 40)):
        assert effective_num_samples(ns, k) == R.effective_num_samples(ns, k)
    from synapseml_tpu.explainers import samplers as ref_samplers

    a = port_samplers.lime_onoff_states(np.random.default_rng(1), 3, 50, 7, 0.7)
    b = ref_samplers.lime_onoff_states(np.random.default_rng(1), 3, 50, 7, 0.7)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port_samplers.onoff_distances(a),
                                  ref_samplers.onoff_distances(b))


def test_feature_stats_draws_bit_equal():
    from synapseml_tpu.explainers import stats as ref_stats

    rng = np.random.default_rng(2)
    bg_cols = {"a": rng.normal(size=50),
               "c": np.array(["x", "y", "z", "x", "x"] * 10, dtype=object)}
    ps = port_stats.collect_feature_stats(Table(bg_cols), ["a", "c"], ["c"])
    rs = ref_stats.collect_feature_stats(ref_core.Table(bg_cols), ["a", "c"], ["c"])
    assert [s.to_dict() for s in ps] == [s.to_dict() for s in rs]
    vals = rng.normal(size=4)
    np.testing.assert_array_equal(ps[0].sample_states(np.random.default_rng(3), vals, 9),
                                  rs[0].sample_states(np.random.default_rng(3), vals, 9))
    np.testing.assert_array_equal(ps[1].sample_values(np.random.default_rng(4), 4, 9),
                                  rs[1].sample_values(np.random.default_rng(4), 4, 9))


@pytest.mark.parametrize("shape,cell", [((32, 32, 3), 8.0), ((20, 27, 1), 6.0),
                                        ((24, 16), 5.0)])
def test_superpixels_and_masks_bit_equal(shape, cell):
    rng = np.random.default_rng(9)
    img = rng.random(shape)
    spd = slic_superpixels(img, cell_size=cell)
    ref = R.slic_superpixels(img, cell_size=cell)
    assert spd.shape == ref.shape and len(spd) == len(ref)
    for a, b in zip(spd.clusters, ref.clusters):
        np.testing.assert_array_equal(a, b)
    assert sum(len(c) for c in spd.clusters) == shape[0] * shape[1]
    states = rng.random(len(spd)) < 0.5
    np.testing.assert_array_equal(mask_image(img, spd, states, 0.25),
                                  R.mask_image(img, ref, states, 0.25))
    assert P.SuperpixelData.from_dict(spd.to_dict()).to_dict() == ref.to_dict()


def test_superpixel_transformer_matches_reference():
    rng = np.random.default_rng(10)
    col = np.empty(2, dtype=object)
    col[:] = [rng.random((16, 16, 3)), rng.random((12, 20, 3))]
    port = P.SuperpixelTransformer(cell_size=6.0).transform(Table({"image": col}))
    ref = R.SuperpixelTransformer(cell_size=6.0).transform(ref_core.Table({"image": col}))
    for a, b in zip(port["superpixels"], ref["superpixels"]):
        assert a.to_dict() == b.to_dict()


# -- every explainer from the same seed --------------------------------------------------

def _run(make, table_cols, **kw):
    """(port output, reference output) of ``make(namespace, models)`` over
    the same columns."""
    port = make(P, PORT_M, **kw).transform(Table(table_cols))
    ref = make(R, REF_M, **kw).transform(ref_core.Table(table_cols))
    assert port.column_names == ref.column_names
    return port, ref


def _port_kw(ns):
    return CPU if ns is P else {}


def test_vector_lime_and_shap_match_reference():
    rng = np.random.default_rng(5)
    X = rng.normal(size=(5, 4))
    bg = rng.normal(size=(12, 4))
    for alpha in (0.0, 0.001):
        port, ref = _run(lambda ns, M: ns.VectorLIME(
            model=M["LinearVec"](beta=[2.0, -3.0, 0.0, 1.0], bias=0.5), num_samples=200,
            regularization=alpha, seed=1, **_port_kw(ns)), {"features": X})
        _close_cols(port["explanation"], ref["explanation"])
        _close_cols(port["r2"], ref["r2"])
    Tab = {"P": Table, "R": ref_core.Table}
    port, ref = _run(lambda ns, M: ns.VectorSHAP(
        model=M["LinearVec"](beta=[1.0, -2.0, 3.0, 0.5], bias=0.25),
        background_data=Tab["P" if ns is P else "R"]({"features": bg}), seed=2,
        **_port_kw(ns)), {"features": X})
    _close_cols(port["explanation"], ref["explanation"])


@pytest.mark.parametrize("alpha", [0.0, 0.005])
def test_tabular_lime_two_targets_match_reference(alpha):
    rng = np.random.default_rng(7)
    cols = {"a": rng.normal(size=6), "c": np.array(["x", "y", "z"] * 2, dtype=object)}
    bg = {"a": rng.normal(size=60), "c": np.array(["x", "y", "z", "x"] * 15, dtype=object)}
    Tab = {P: Table, R: ref_core.Table}
    port, ref = _run(lambda ns, M: ns.TabularLIME(
        model=M["TwoClass"](), input_cols=["a", "c"], categorical_cols=["c"],
        background_data=Tab[ns](bg), target_classes=[0, 1], num_samples=300,
        regularization=alpha, seed=3, **_port_kw(ns)), cols)
    _close_cols(port["explanation"], ref["explanation"])
    _close_cols(port["r2"], ref["r2"])
    assert port["explanation"][0].shape == (2, 2)


def test_tabular_shap_matches_reference_and_adds_up():
    rng = np.random.default_rng(8)
    names = ["f0", "f1", "f2"]
    X = {c: rng.normal(size=5) for c in names}
    bg = {c: rng.normal(size=12) for c in names}
    Tab = {P: Table, R: ref_core.Table}
    port, ref = _run(lambda ns, M: ns.TabularSHAP(
        model=M["LinearCols"](input_cols=names, beta=[1.0, 2.0, -1.5]), input_cols=names,
        background_data=Tab[ns](bg), output_col="shap", seed=4, **_port_kw(ns)), X)
    _close_cols(port["shap"], ref["shap"])
    for i in range(5):
        row = port["shap"][i][0]
        fx = sum(b * X[c][i] for c, b in zip(names, [1.0, 2.0, -1.5]))
        np.testing.assert_allclose(row[0] + row[1:].sum(), fx, atol=1e-3)


def test_text_lime_and_shap_match_reference():
    toks = np.array([["the", "good", "movie"], ["a", "bad", "plot", "twist"],
                     ["good"]], dtype=object)
    port, ref = _run(lambda ns, M: ns.TextLIME(model=M["TokenScore"](), num_samples=200,
                                               seed=5, **_port_kw(ns)), {"tokens": toks})
    _close_cols(port["explanation"], ref["explanation"])
    assert np.argmax(port["explanation"][0][0]) == 1
    port, ref = _run(lambda ns, M: ns.TextSHAP(model=M["TokenScore"](), seed=6,
                                               **_port_kw(ns)), {"tokens": toks})
    _close_cols(port["explanation"], ref["explanation"])
    row = port["explanation"][1][0]
    np.testing.assert_allclose(row[0] + row[1:].sum(), -2.0, atol=1e-3)


def test_image_lime_and_shap_match_reference():
    img = np.zeros((16, 16, 3))
    img[:8, :8] = 1.0
    img2 = np.random.default_rng(11).random((16, 24, 3))
    col = np.empty(2, dtype=object)
    col[:] = [img, img2]
    port, ref = _run(lambda ns, M: ns.ImageLIME(model=M["BrightRegion"](), cell_size=8.0,
                                                num_samples=150, seed=7, **_port_kw(ns)),
                     {"image": col})
    _close_cols(port["explanation"], ref["explanation"])
    spd = slic_superpixels(img, 8.0)
    coefs = port["explanation"][0][0]
    covers = np.array([np.any((c[:, 0] < 8) & (c[:, 1] < 8)) for c in spd.clusters])
    assert coefs[covers].max() > 5 * max(np.abs(coefs[~covers]).max(), 1e-9)
    port, ref = _run(lambda ns, M: ns.ImageSHAP(model=M["BrightRegion"](), cell_size=8.0,
                                                seed=8, **_port_kw(ns)), {"image": col})
    _close_cols(port["explanation"], ref["explanation"])
    row = port["explanation"][0][0]
    np.testing.assert_allclose(row[0] + row[1:].sum(), 1.0, atol=1e-3)


@pytest.mark.parametrize("kind", ["individual", "average"])
def test_ice_matches_reference(kind):
    cols = {"a": np.array([0.0, 1.0, 2.0, 3.0]), "b": np.array([1.0, -1.0, 0.5, 2.0]),
            "c": np.array(["u", "u", "v", "w"], dtype=object)}
    port, ref = _run(lambda ns, M: ns.ICETransformer(
        model=M["TwoClass"](), target_classes=[1], kind=kind,
        categorical_features=[{"name": "c", "num_top_values": 2}],
        numeric_features=[{"name": "a", "num_splits": 4, "range_min": 0.0, "range_max": 1.0},
                          "b"], **_port_kw(ns)), cols)
    for name in ("a_dependence", "b_dependence", "c_dependence"):
        for p_map, r_map in zip(port[name], ref[name]):
            assert list(p_map) == list(r_map)
            for key in p_map:
                np.testing.assert_array_equal(p_map[key], r_map[key])


def test_ice_num_samples_and_errors():
    cols = {"a": np.arange(10, dtype=np.float64), "c": np.array(["u", "v"] * 5, dtype=object)}
    port, ref = _run(lambda ns, M: ns.ICETransformer(
        model=M["TwoClass"](), numeric_features=["a"], num_samples=4, seed=2,
        target_classes=[0], **_port_kw(ns)), cols)
    np.testing.assert_array_equal(port["a"], ref["a"])
    with pytest.raises(ValueError, match="no features"):
        ICETransformer(model=PORT_M["TwoClass"]()).transform(Table(cols))
    with pytest.raises(ValueError, match="model is not set"):
        TabularLIME(input_cols=["a"], **CPU).transform(Table(cols))


def test_lime_on_a_gbdt_model_matches_reference():
    from synapseml_tpu.gbdt import LightGBMClassifier as RefClassifier
    from synapseml_tpu_torch.gbdt.convert import model_from_state

    rng = np.random.default_rng(11)
    X = rng.normal(size=(400, 4))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(int)
    ref_model = RefClassifier(num_iterations=20, num_leaves=7).fit(
        ref_core.Table({"features": X, "label": y}))
    port_model = model_from_state(ref_model.booster.state_dict(), labels=ref_model.labels,
                                  device="cpu")
    inst = {"features": X[:4]}
    models = {P: port_model, R: ref_model}
    Tab = {P: Table, R: ref_core.Table}
    for alpha in (0.0, 0.002):
        port, ref = _run(lambda ns, M: ns.VectorLIME(
            model=models[ns], target_classes=[1], num_samples=300, regularization=alpha,
            seed=12, **_port_kw(ns)), inst)
        _close_cols(port["explanation"], ref["explanation"])
    port, ref = _run(lambda ns, M: ns.VectorSHAP(
        model=models[ns], target_classes=[1], background_data=Tab[ns]({"features": X[:24]}),
        seed=12, **_port_kw(ns)), inst)
    _close_cols(port["explanation"], ref["explanation"], 1e-3)
    probs = port_model.transform(Table(inst))["probability"]
    phis = np.stack([port["explanation"][i][0][1:] for i in range(4)])
    assert np.abs(phis[:, :2]).mean() > 3 * np.abs(phis[:, 2:]).mean()
    for i in range(4):
        np.testing.assert_allclose(port["explanation"][i][0].sum(), probs[i][1], atol=0.05)


@pytest.mark.parametrize("name", ["TabularLIME", "VectorSHAP", "ImageLIME", "TextSHAP",
                                  "ICETransformer", "SuperpixelTransformer"])
def test_explainers_registered_and_save_load(name, tmp_path):
    from synapseml_tpu_torch.core import STAGE_REGISTRY, load_stage

    assert STAGE_REGISTRY[name] is getattr(P, name)
    stage = getattr(P, name)(seed=3, device="cpu") if name != "SuperpixelTransformer" \
        else P.SuperpixelTransformer(cell_size=5.0)
    stage.save(str(tmp_path / "s"))
    loaded = load_stage(str(tmp_path / "s"))
    assert type(loaded) is type(stage)
    want = {k: v for k, v in stage.extract_param_map().items() if k != "model"}
    assert {k: v for k, v in loaded.extract_param_map().items() if k != "model"} == want
