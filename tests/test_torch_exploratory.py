"""The port's data balance measures (``synapseml_tpu_torch.exploratory``)
against the JAX package's: every case of ``tests/test_exploratory.py``, run
through both packages on the same tables, the port's measure tables equal
to the reference's besides the reference test's own assertions."""

import math

import numpy as np
import pytest

from torch_parity import PORT, REF, assert_same, both


def _df(m):
    # gender: 4 M (3 positive), 4 F (1 positive)
    return m.Table({
        "gender": np.array(["M", "M", "M", "M", "F", "F", "F", "F"], dtype=object),
        "label": np.array([1, 1, 1, 0, 1, 0, 0, 0], dtype=np.float64),
    })


def test_feature_balance_demographic_parity_gap():
    ref, out = both(lambda m: m.FeatureBalanceMeasure(
        sensitive_cols=["gender"], label_col="label").transform(_df(m)))
    assert_same(ref, out)
    assert out.num_rows == 1
    assert out["ClassA"][0] == "M" and out["ClassB"][0] == "F"
    m = out["measures" if "measures" in out else "FeatureBalanceMeasure"][0]
    np.testing.assert_allclose(m["dp"], 3 / 4 - 1 / 4)
    np.testing.assert_allclose(m["pmi"], math.log(0.75) - math.log(0.25))
    assert set(m) >= {"dp", "sdc", "ji", "llr", "pmi", "n_pmi_y", "n_pmi_xy",
                      "s_pmi", "krc", "t_test"}


def test_feature_balance_equal_values_gap_zero():
    ref, out = both(lambda m: m.FeatureBalanceMeasure(sensitive_cols=["g"]).transform(
        m.Table({"g": np.array(["A", "A", "B", "B"], dtype=object),
                 "label": np.array([1, 0, 1, 0], dtype=np.float64)})))
    assert_same(ref, out)
    for metric in ("dp", "pmi", "ji"):
        assert out["FeatureBalanceMeasure"][0][metric] == 0.0


def test_feature_balance_all_positive_labels_no_crash():
    ref, out = both(lambda m: m.FeatureBalanceMeasure(sensitive_cols=["g"]).transform(
        m.Table({"g": np.array(["A", "A", "B", "B"], dtype=object),
                 "label": np.ones(4)})))
    assert_same(ref, out)
    assert out["FeatureBalanceMeasure"][0]["dp"] == 0.0


def test_feature_balance_verbose_adds_probabilities():
    ref, out = both(lambda m: m.FeatureBalanceMeasure(
        sensitive_cols=["gender"], verbose=True).transform(_df(m)))
    assert_same(ref, out)
    m = out["FeatureBalanceMeasure"][0]
    np.testing.assert_allclose(m["prA"], 0.75)
    np.testing.assert_allclose(m["prB"], 0.25)


def test_distribution_balance_uniform_is_zero():
    ref, out = both(lambda m: m.DistributionBalanceMeasure(sensitive_cols=["g"]).transform(
        m.Table({"g": np.array(["A", "B", "C", "A", "B", "C"], dtype=object)})))
    assert_same(ref, out)
    m = out["DistributionBalanceMeasure"][0]
    np.testing.assert_allclose(m["kl_divergence"], 0.0, atol=1e-12)
    np.testing.assert_allclose(m["js_dist"], 0.0, atol=1e-7)
    np.testing.assert_allclose(m["total_variation_dist"], 0.0, atol=1e-12)
    np.testing.assert_allclose(m["chi_sq_stat"], 0.0, atol=1e-12)
    np.testing.assert_allclose(m["chi_sq_p_value"], 1.0, atol=1e-9)


def test_distribution_balance_skew_measures():
    ref, out = both(lambda m: m.DistributionBalanceMeasure(sensitive_cols=["g"]).transform(
        m.Table({"g": np.array(["A"] * 6 + ["B"] * 2, dtype=object)})))
    assert_same(ref, out)
    m = out["DistributionBalanceMeasure"][0]
    np.testing.assert_allclose(m["inf_norm_dist"], 0.25)
    np.testing.assert_allclose(m["total_variation_dist"], 0.25)
    np.testing.assert_allclose(m["wasserstein_dist"], 0.25)
    kl = 0.25 * math.log(0.5) + 0.75 * math.log(1.5)
    np.testing.assert_allclose(m["kl_divergence"], kl, rtol=1e-9)
    np.testing.assert_allclose(m["chi_sq_stat"], (6 - 4) ** 2 / 4 * 2)
    assert 0 < m["chi_sq_p_value"] < 1


def test_chi_sq_p_value_matches_known_table():
    from synapseml_tpu.exploratory.balance import _chi2_sf as ref_sf
    from synapseml_tpu_torch.exploratory.balance import _chi2_sf

    for x, k in [(3.841459, 1), (5.991465, 2), (0.0, 3), (7.3, 5), (40.0, 17), (0.2, 1)]:
        assert _chi2_sf(x, k) == ref_sf(x, k)
    np.testing.assert_allclose(_chi2_sf(3.841459, 1), 0.05, atol=1e-4)
    np.testing.assert_allclose(_chi2_sf(5.991465, 2), 0.05, atol=1e-4)
    np.testing.assert_allclose(_chi2_sf(0.0, 3), 1.0)


def test_aggregate_balance_perfectly_balanced():
    ref, out = both(lambda m: m.AggregateBalanceMeasure(sensitive_cols=["g"]).transform(
        m.Table({"g": np.array(["A", "B"] * 5, dtype=object)})))
    assert_same(ref, out)
    m = out["AggregateBalanceMeasure"][0]
    np.testing.assert_allclose(m["atkinson_index"], 0.0, atol=1e-9)
    np.testing.assert_allclose(m["theil_l_index"], 0.0, atol=1e-12)
    np.testing.assert_allclose(m["theil_t_index"], 0.0, atol=1e-12)


def test_aggregate_balance_joint_distribution():
    ref, out = both(lambda m: m.AggregateBalanceMeasure(sensitive_cols=["g", "r"]).transform(
        m.Table({"g": np.array(["A", "A", "A", "B"], dtype=object),
                 "r": np.array(["x", "x", "y", "y"], dtype=object)})))
    assert_same(ref, out)
    m = out["AggregateBalanceMeasure"][0]
    assert m["theil_l_index"] > 0 and m["theil_t_index"] > 0
    assert 0 < m["atkinson_index"] < 1


def test_missing_sensitive_cols_raises():
    for m in (REF, PORT):
        with pytest.raises(ValueError, match="sensitive_cols"):
            m.FeatureBalanceMeasure().transform(_df(m))
