"""The port's utility stages (``synapseml_tpu_torch.stages``) against the JAX
package's: every case of ``tests/test_stages.py``, run through both packages
on the same inputs, the port's output held to the reference's (equal
columns, values, partitions and metadata) besides the reference test's own
assertions. ``TimerModel.profile_dir`` writes a ``torch.profiler`` trace in
the port (the reference writes a ``jax.profiler`` one)."""

import glob
import json
import os

import numpy as np
import pytest

from torch_parity import PORT, REF, assert_same, both


def _t(m):
    return m.Table(
        {
            "a": np.arange(8, dtype=np.float64),
            "b": np.arange(8, dtype=np.float64) * 10,
            "label": np.array([0, 0, 0, 0, 0, 0, 1, 1]),
            "text": [f"The Cat {i}" for i in range(8)],
        },
        npartitions=2,
    )


def test_column_ops():
    def run(m):
        t = _t(m)
        return (m.DropColumns(cols=["a"]).transform(t),
                m.SelectColumns(cols=["a", "b"]).transform(t),
                m.RenameColumn(input_col="a", output_col="z").transform(t),
                m.Repartition(n=4).transform(t),
                m.PartitionConsolidator().transform(t))
    ref, port = both(run)
    for r, p in zip(ref, port):
        assert_same(r, p)
    assert "a" not in port[0] and port[1].column_names == ["a", "b"] and "z" in port[2]
    assert port[3].npartitions == 4 and port[4].npartitions == 1


def test_lambda_and_udf():
    def run(m):
        t = _t(m)
        return (m.Lambda(transform_func=lambda x: x.with_column("c", x["a"] + 1)).transform(t),
                m.UDFTransformer(input_col="a", output_col="sq",
                                 udf=lambda v: v * v).transform(t),
                m.UDFTransformer(input_cols=["a", "b"], output_col="s",
                                 udf=lambda x, y: x + y, vectorized=True).transform(t))
    ref, port = both(run)
    for r, p in zip(ref, port):
        assert_same(r, p)
    t = _t(PORT)
    np.testing.assert_allclose(port[0]["c"], t["a"] + 1)
    assert port[1]["sq"][3] == 9.0
    np.testing.assert_allclose(port[2]["s"], t["a"] + t["b"])


def test_explode():
    ref, port = both(lambda m: m.Explode(input_col="seq").transform(
        m.Table({"k": [1, 2], "seq": [[10, 20], [30]]})))
    assert_same(ref, port)
    assert port["seq"].tolist() == [10, 20, 30] and port["k"].tolist() == [1, 1, 2]


def test_minibatch_roundtrip():
    def run(m):
        batched = m.FixedMiniBatchTransformer(batch_size=3).transform(_t(m))
        return batched, m.FlattenBatch().transform(batched)
    (rb, rf), (pb, pf) = both(run)
    assert_same(rb, pb)
    assert_same(rf, pf)
    assert pb.num_rows == 4 and len(pb["a"][0]) == 3
    np.testing.assert_allclose(np.sort(pf["a"]), np.arange(8.0))
    assert pf["text"].tolist()[:2] == ["The Cat 0", "The Cat 1"]


def test_dynamic_minibatch():
    def run(m):
        batched = m.DynamicMiniBatchTransformer().transform(_t(m))
        return batched, m.FlattenBatch().transform(batched)
    (rb, rf), (pb, pf) = both(run)
    assert_same(rb, pb)
    assert_same(rf, pf)
    assert pb.num_rows == 2 and pf.num_rows == 8


def test_flatten_mismatch_raises():
    for m in (REF, PORT):
        bad = m.Table({"x": [np.array([1, 2])], "y": [np.array([1, 2, 3])]})
        with pytest.raises(ValueError, match="FlattenBatch"):
            m.FlattenBatch().transform(bad)


def test_stratified_repartition_each_partition_sees_each_label():
    ref, port = both(lambda m: m.StratifiedRepartition(
        label_col="label", mode="equal", seed=1).transform(_t(m)))
    assert_same(ref, port)
    for p in port.partitions():
        assert set(np.unique(p["label"])) == {0, 1}


def test_stratified_original_keeps_rows():
    ref, port = both(lambda m: m.StratifiedRepartition(
        label_col="label", mode="original", seed=1).transform(_t(m)))
    assert_same(ref, port)
    assert port.num_rows == 8


def test_ensemble_by_key():
    def run(m):
        t = m.Table({"k": [0, 0, 1, 1], "score": [1.0, 3.0, 10.0, 20.0]})
        return (m.EnsembleByKey(keys=["k"], cols=["score"]).transform(t),
                m.EnsembleByKey(keys=["k"], cols=["score"], collapse_group=False).transform(t))
    ref, port = both(run)
    for r, p in zip(ref, port):
        assert_same(r, p)
    assert port[0].num_rows == 2
    np.testing.assert_allclose(sorted(port[0]["mean(score)"]), [2.0, 15.0])
    np.testing.assert_allclose(port[1]["mean(score)"], [2.0, 2.0, 15.0, 15.0])


def test_ensemble_by_key_vector():
    ref, port = both(lambda m: m.EnsembleByKey(keys=["k"], cols=["v"]).transform(
        m.Table({"k": [0, 0], "v": np.array([[1.0, 2.0], [3.0, 4.0]])})))
    assert_same(ref, port)
    np.testing.assert_allclose(port["mean(v)"][0], [2.0, 3.0])


def test_class_balancer():
    def run(m):
        t = _t(m)
        return m.ClassBalancer(input_col="label").fit(t).transform(t)
    ref, port = both(run)
    assert_same(ref, port)
    assert port["weight"][0] == 1.0 and port["weight"][7] == 3.0


def test_summarize_data():
    ref, port = both(lambda m: m.SummarizeData().transform(_t(m)))
    assert_same(ref, port)
    feats = port["Feature"].tolist()
    assert "a" in feats and "text" not in feats
    i = feats.index("a")
    assert port["Mean"][i] == pytest.approx(3.5)
    assert port["Count"][i] == 8
    assert port["P50"][i] == pytest.approx(3.5)


def test_text_preprocessor():
    ref, port = both(lambda m: m.TextPreprocessor(
        map={"quick": "slow", "fox": "dog"}, output_col="o").transform(
            m.Table({"text": ["The quick brown Fox"]})))
    assert_same(ref, port)
    assert port["o"][0] == "the slow brown dog"


def test_unicode_normalize():
    ref, port = both(lambda m: m.UnicodeNormalize(form="NFKD", lower=True,
                                                  output_col="o").transform(
        m.Table({"text": ["Café", "Ｆｕｌｌ ｗｉｄｔｈ"]})))
    assert_same(ref, port)
    assert port["o"][0].startswith("caf")


def test_multi_column_adapter():
    def run(m):
        t = _t(m)
        base = m.UDFTransformer(udf=lambda v: v + 1, vectorized=True)
        return m.MultiColumnAdapter(base_stage=base, input_cols=["a", "b"],
                                    output_cols=["a2", "b2"]).fit(t).transform(t)
    ref, port = both(run)
    assert_same(ref, port)
    np.testing.assert_allclose(port["a2"], np.arange(8.0) + 1)
    np.testing.assert_allclose(port["b2"], np.arange(8.0) * 10 + 1)


def test_timer():
    def run(m):
        t = _t(m)
        inner = m.UDFTransformer(input_col="a", output_col="o", udf=lambda v: v,
                                 vectorized=True)
        model = m.Timer(stage=inner).fit(t)
        return model.transform(t), model
    (ref, _), (port, model) = both(run)
    assert_same(ref, port)
    assert "o" in port and model._last_elapsed_s >= 0


def test_timer_profile_trace(tmp_path):
    """``TimerModel(profile_dir=...)`` writes a ``torch.profiler`` trace of the
    wrapped transform: a Chrome trace file whose events include the stage's
    torch work."""
    def run(m):
        t = _t(m)
        inner = m.UDFTransformer(input_col="a", output_col="o",
                                 udf=lambda v: v * 2, vectorized=True)
        model = m.Timer(stage=inner).fit(t)
        model.profile_dir = str(tmp_path / m.name)
        return model.transform(t)
    ref, port = both(run)
    assert_same(ref, port)
    assert glob.glob(str(tmp_path / "ref" / "**" / "*"), recursive=True)
    traces = glob.glob(os.path.join(str(tmp_path / "port"), "*.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        trace = json.load(f)
    assert isinstance(trace.get("traceEvents"), list)

    import torch

    def torch_udf(v):
        return torch.as_tensor(v).mul(2).numpy()

    t = _t(PORT)
    m = PORT.Timer(stage=PORT.UDFTransformer(input_col="a", output_col="o",
                                             udf=torch_udf, vectorized=True)).fit(t)
    m.profile_dir = str(tmp_path / "torch_work")
    np.testing.assert_array_equal(m.transform(t)["o"], t["a"] * 2)
    (path,) = glob.glob(os.path.join(str(tmp_path / "torch_work"), "*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::mul" in names


def test_stratified_repartition_rare_label_reaches_all_partitions():
    for seed in range(5):
        ref, port = both(lambda m: m.StratifiedRepartition(
            label_col="label", mode="original", seed=seed).transform(
                m.Table({"x": np.arange(8.0), "label": np.array([0] * 6 + [1] * 2)},
                        npartitions=2)))
        assert_same(ref, port)
        for p in port.partitions():
            assert 1 in p["label"], f"seed {seed}: partition missing rare label"


def test_ensemble_by_key_name_length_mismatch():
    for m in (REF, PORT):
        t = m.Table({"k": [0, 0], "s1": [1.0, 2.0], "s2": [3.0, 4.0]})
        with pytest.raises(ValueError, match="new_col_names"):
            m.EnsembleByKey(keys=["k"], cols=["s1", "s2"],
                            new_col_names=["only_one"]).transform(t)


def test_class_balancer_unseen_label_message():
    for m in (REF, PORT):
        model = m.ClassBalancer(input_col="label").fit(_t(m))
        with pytest.raises(ValueError, match="not seen during fit"):
            model.transform(m.Table({"label": np.array([0, 99])}))


def test_lambda_save_load_drops_callable(tmp_path):
    def run(m):
        t = m.Table({"x": np.arange(3.0)})
        lam = m.Lambda(transform_func=lambda x: x.with_column("y", x["x"] * 2))
        path = str(tmp_path / m.name)
        lam.save(path)  # must not raise
        return m.load_stage(path).transform(t)  # warns, passes through
    ref, port = both(run)
    assert_same(ref, port)
    assert "y" not in port


def test_fast_vector_assembler():
    def run(m):
        t = m.Table({"cat": np.array([0.0, 1.0, 2.0]), "num": np.array([0.5, 1.5, 2.5]),
                     "vec": np.arange(6, dtype=np.float64).reshape(3, 2)})
        t = t.with_column("cat", t["cat"], meta={"categorical": True, "slot_names": ["cat"]})
        out = m.FastVectorAssembler(input_cols=["cat", "num", "vec"],
                                    output_col="f").transform(t)
        t2 = t.with_column("late", t["cat"], meta={"categorical": True})
        with pytest.raises(ValueError, match="out of order"):
            m.FastVectorAssembler(input_cols=["num", "late"]).transform(t2)
        return out
    ref, port = both(run)
    assert_same(ref, port)
    np.testing.assert_allclose(port["f"][1], [1.0, 1.5, 2.0, 3.0])
    assert port.meta["f"]["num_categorical"] == 1 and port.meta["f"]["slot_names"][0] == "cat"


@pytest.mark.parametrize("stage_name", ["DropColumns", "SelectColumns", "RenameColumn",
                                        "Repartition", "Cacher", "Explode",
                                        "FixedMiniBatchTransformer", "UnicodeNormalize",
                                        "TextPreprocessor", "StratifiedRepartition",
                                        "EnsembleByKey", "SummarizeData"])
def test_stage_save_load_round_trip(stage_name, tmp_path):
    """Every utility stage registers in the port's ``STAGE_REGISTRY`` and
    comes back from ``save_stage`` / ``load_stage`` with the same params and
    the same output."""
    from synapseml_tpu_torch.core import STAGE_REGISTRY, load_stage

    kwargs = {"DropColumns": dict(cols=["b"]), "SelectColumns": dict(cols=["a"]),
              "RenameColumn": dict(input_col="a", output_col="z"),
              "Repartition": dict(n=3), "Cacher": {}, "Explode": dict(input_col="seq"),
              "FixedMiniBatchTransformer": dict(batch_size=3),
              "UnicodeNormalize": dict(input_col="text", output_col="u"),
              "TextPreprocessor": dict(input_col="text", output_col="o",
                                       map={"cat": "dog"}),
              "StratifiedRepartition": dict(label_col="label", seed=2),
              "EnsembleByKey": dict(keys=["label"], cols=["a"]),
              "SummarizeData": {}}[stage_name]
    cls = getattr(PORT, stage_name)
    assert STAGE_REGISTRY[stage_name] is cls
    t = _t(PORT)
    if stage_name == "Explode":
        t = t.with_column("seq", [[i, i + 1] for i in range(8)])
    st = cls(**kwargs)
    st.save(str(tmp_path / "s"))
    back = load_stage(str(tmp_path / "s"))
    assert type(back) is cls and back.extract_param_map() == st.extract_param_map()
    assert_same(st.transform(t), back.transform(t))
