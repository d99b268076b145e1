"""The port's CyberML feature stages (``synapseml_tpu_torch.cyber``: the
per-partition scalers and indexers and complement-access sampling) against
the JAX package's: the cases of ``tests/test_cyber.py`` that cover them, run
through both packages on the same tables, the port's output equal to the
reference's besides the reference test's own assertions. The anomaly model
(``AccessAnomaly``, ``ConnectedComponents``) is not ported yet."""

import numpy as np

from torch_parity import PORT, REF, assert_same, both


# -- scalers -------------------------------------------------------------------------

def test_standard_scaler_per_partition():
    def run(m):
        t = m.Table({"tenant": np.array(["a"] * 4 + ["b"] * 4, dtype=object),
                     "x": np.array([1.0, 2, 3, 4, 10, 20, 30, 40])})
        return m.StandardScalarScaler(input_col="x", output_col="z",
                                      partition_key="tenant").fit(t).transform(t)
    ref, out = both(run)
    assert_same(ref, out)
    z = np.asarray(out["z"])
    for sl in (slice(0, 4), slice(4, 8)):
        np.testing.assert_allclose(z[sl].mean(), 0.0, atol=1e-12)
        np.testing.assert_allclose(z[sl].std(), 1.0, atol=1e-12)


def test_standard_scaler_zero_std_falls_back_to_centering():
    def run(m):
        t = m.Table({"x": np.array([3.0, 3.0, 3.0])})
        return m.StandardScalarScaler(input_col="x", output_col="z").fit(t).transform(t)
    ref, out = both(run)
    assert_same(ref, out)
    np.testing.assert_allclose(np.asarray(out["z"]), 0.0)


def test_linear_scaler_maps_to_range():
    def run(m):
        t = m.Table({"x": np.array([0.0, 5.0, 10.0])})
        return m.LinearScalarScaler(input_col="x", output_col="z", min_required_value=5.0,
                                    max_required_value=10.0).fit(t).transform(t)
    ref, out = both(run)
    assert_same(ref, out)
    np.testing.assert_allclose(np.asarray(out["z"]), [5.0, 7.5, 10.0])


def test_linear_scaler_degenerate_maps_to_midpoint():
    def run(m):
        t = m.Table({"x": np.array([7.0, 7.0])})
        return m.LinearScalarScaler(input_col="x", output_col="z", min_required_value=5.0,
                                    max_required_value=10.0).fit(t).transform(t)
    ref, out = both(run)
    assert_same(ref, out)
    np.testing.assert_allclose(np.asarray(out["z"]), 7.5)


# -- indexers ------------------------------------------------------------------------

def test_id_indexer_from_one_and_unseen_zero():
    def run(m):
        t = m.Table({"tenant": np.array(["a", "a", "b"], dtype=object),
                     "u": np.array(["x", "y", "x"], dtype=object)})
        model = m.IdIndexer(input_col="u", partition_key="tenant", output_col="idx",
                            reset_per_partition=True).fit(t)
        unseen = model.transform(m.Table({"tenant": np.array(["a"], dtype=object),
                                          "u": np.array(["zzz"], dtype=object)}))
        return model.transform(t), unseen
    ref, out = both(run)
    assert_same(ref[0], out[0])
    assert_same(ref[1], out[1])
    idx = np.asarray(out[0]["idx"])
    assert idx[0] == 1 and idx[1] == 2 and idx[2] == 1
    assert np.asarray(out[1]["idx"])[0] == 0


def test_id_indexer_global_numbering():
    def run(m):
        t = m.Table({"tenant": np.array(["a", "a", "b"], dtype=object),
                     "u": np.array(["x", "y", "x"], dtype=object)})
        return m.IdIndexer(input_col="u", partition_key="tenant", output_col="idx",
                           reset_per_partition=False).fit(t).transform(t)
    ref, out = both(run)
    assert_same(ref, out)
    assert sorted(np.asarray(out["idx"]).tolist()) == [1, 2, 3]


def test_multi_indexer():
    def run(m):
        t = m.Table({"tenant": np.array(["a", "a"], dtype=object),
                     "u": np.array(["x", "y"], dtype=object),
                     "r": np.array(["p", "q"], dtype=object)})
        mi = m.MultiIndexer(indexers=[
            m.IdIndexer(input_col="u", partition_key="tenant", output_col="ui"),
            m.IdIndexer(input_col="r", partition_key="tenant", output_col="ri"),
        ]).fit(t)
        return mi.transform(t), mi
    (ref, _), (out, mi) = both(run)
    assert_same(ref, out)
    assert "ui" in out and "ri" in out
    assert mi.get_model_by_input_col("u").output_col == "ui"
    assert mi.get_model_by_output_col("ri").input_col == "r"


# -- complement sampling -------------------------------------------------------------

def test_complement_access_excludes_observed():
    rng = np.random.default_rng(0)
    u = rng.integers(0, 10, 60)
    r = rng.integers(0, 10, 60)
    ref, comp = both(lambda m: m.ComplementAccessTransformer(
        indexed_col_names=["u", "r"], complementset_factor=3).transform(
            m.Table({"u": u, "r": r})))
    assert_same(ref, comp)
    seen = set(zip(u.tolist(), r.tolist()))
    assert comp.num_rows > 0
    for i in range(comp.num_rows):
        assert (int(comp["u"][i]), int(comp["r"][i])) not in seen


def test_complement_factor_zero_empty():
    ref, comp = both(lambda m: m.ComplementAccessTransformer(
        indexed_col_names=["u", "r"], complementset_factor=0).transform(
            m.Table({"u": np.arange(5), "r": np.arange(5)})))
    assert_same(ref, comp)
    assert comp.num_rows == 0


def test_cyber_stages_save_and_load(tmp_path):
    """Fitted scalers and indexers come back from ``save_stage`` /
    ``load_stage`` through the port's registry with the same output."""
    from synapseml_tpu_torch.core import STAGE_REGISTRY

    t = PORT.Table({"tenant": np.array(["a", "a", "b", "b"], dtype=object),
                    "u": np.array(["x", "y", "x", "z"], dtype=object),
                    "x": np.array([1.0, 3.0, 10.0, 30.0])})
    fitted = [
        PORT.StandardScalarScaler(input_col="x", output_col="z",
                                  partition_key="tenant").fit(t),
        PORT.LinearScalarScaler(input_col="x", output_col="z", partition_key="tenant",
                                min_required_value=1.0, max_required_value=2.0).fit(t),
        PORT.MultiIndexer(indexers=[PORT.IdIndexer(input_col="u", partition_key="tenant",
                                                   output_col="ui")]).fit(t),
    ]
    for i, st in enumerate(fitted):
        assert STAGE_REGISTRY[type(st).__name__] is type(st)
        st.save(str(tmp_path / str(i)))
        back = PORT.load_stage(str(tmp_path / str(i)))
        assert type(back) is type(st)
        assert_same(st.transform(t), back.transform(t))
    assert REF.StandardScalarScaler is not PORT.StandardScalarScaler
