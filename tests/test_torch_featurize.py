"""The port's featurizers (``synapseml_tpu_torch.featurize``), its murmur3
hash (``synapseml_tpu_torch.native``) and its timing and retry helpers
(``core/clock.py``, ``core/fault.py``) against the JAX package's, on the
CPU.

- Featurize and friends: the same tables through both packages give the
  same columns bit for bit (the port one-hot encodes and hashes a column at
  a time, the reference a row at a time).
- The featurize cases of ``tests/test_schema.py``: ``_validate_input``'s
  message, ``Pipeline.validate`` (static, in a fresh process that imports
  neither JAX nor the JAX package), and the schema conformance of every
  featurize stage.
- murmur3: bit-equal to the reference's pure-Python hash and to its batch
  entry point on random ASCII, non-ASCII and empty strings, several seeds.
"""

import os
import subprocess
import sys
import threading
import time
import warnings

import numpy as np
import pytest

from synapseml_tpu.native import murmur3_32_batch as ref_murmur_batch
from synapseml_tpu.native.loader import _murmur3_32_py
from synapseml_tpu_torch.native import murmur3_32, murmur3_32_batch
from torch_parity import PORT, REF, assert_same, both

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- murmur3 ------------------------------------------------------------------------

def _strings(seed):
    rng = np.random.default_rng(seed)
    ascii_ = ["".join(chr(c) for c in rng.integers(32, 127, rng.integers(0, 41)))
              for _ in range(300)]
    wide = ["".join(chr(c) for c in rng.integers(0xA0, 0x3000, rng.integers(1, 12)))
            for _ in range(100)]
    return ascii_ + wide + ["", "", "a", "ab", "abc", "abcd", "abcde", "\x00", "日本語",
                            "Café", "\U0001F600 emoji"]


@pytest.mark.parametrize("seed", [0, 1, 42, 0x9747B28C, 0xFFFFFFFF])
def test_murmur3_bit_equal_to_reference(seed):
    strings = _strings(seed % 1000)
    want = np.array([_murmur3_32_py(s.encode("utf-8"), seed) for s in strings], np.uint32)
    got = murmur3_32_batch(strings, seed)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref_murmur_batch(strings, seed))
    assert [murmur3_32(s, seed) for s in strings[-11:]] == want[-11:].tolist()


def test_murmur3_per_string_seeds_and_bytes():
    strings = _strings(7)
    seeds = np.random.default_rng(3).integers(0, 2**32, len(strings))
    np.testing.assert_array_equal(murmur3_32_batch(strings, seeds),
                                  ref_murmur_batch(strings, seeds))
    raw = [s.encode("utf-8") for s in strings]
    np.testing.assert_array_equal(murmur3_32_batch(raw), ref_murmur_batch(raw))
    # the published test vectors the reference checks
    assert murmur3_32(b"", 0) == 0 and murmur3_32(b"", 1) == 0x514E28B7
    assert murmur3_32(b"hello", 0) == 0x248BFA47
    assert murmur3_32("hello, world", 0) == 0x149BBB7F
    assert murmur3_32_batch([]).shape == (0,)


# -- featurize stages ----------------------------------------------------------------

def _mixed(m, n=60, seed=0):
    rng = np.random.default_rng(seed)
    num = rng.normal(size=n)
    num[::7] = np.nan
    city = np.array([["paris", "rome", "oslo", None][i % 4] for i in range(n)], dtype=object)
    code = np.array([f"id{rng.integers(0, 90)}" for _ in range(n)], dtype=object)
    text = np.array([None if i % 9 == 0 else f"the cat {i % 5} sat on mat {i % 3}"
                     for i in range(n)], dtype=object)
    return m.Table({"num": num, "int": rng.integers(0, 5, n), "city": city, "code": code,
                    "text": text, "vec": rng.normal(size=(n, 3)),
                    "flag": rng.random(n) > 0.5,
                    "label": (rng.random(n) > 0.5).astype(np.float64)})


@pytest.mark.parametrize("kw", [
    {},
    {"max_one_hot": 8},
    {"one_hot_encode_categoricals": False, "num_features": 1024},
    {"num_features": 1 << 14},
])
def test_featurize_matches_reference_bit_for_bit(kw):
    cols = ["num", "int", "city", "code", "text", "vec", "flag"]

    def run(m):
        t = _mixed(m)
        with warnings.catch_warnings(record=True) as got:
            warnings.simplefilter("always")
            model = m.Featurize(input_cols=cols, **kw).fit(t)
            out = model.transform(t)
        return out, model.plan, sorted(str(w.message) for w in got)
    (ref, ref_plan, ref_warned), (port, plan, warned) = both(run)
    assert plan == ref_plan and warned == ref_warned
    assert_same(ref, port)
    assert port["features"].dtype == np.float64


def test_clean_missing_value_indexer_and_friends_match_reference():
    def run(m):
        t = _mixed(m)
        out = []
        for mode in ("Mean", "Median", "Custom"):
            out.append(m.CleanMissingData(input_cols=["num"], output_cols=["num_c"],
                                          cleaning_mode=mode, custom_value=-1.0)
                       .fit(t).transform(t))
        vi = m.ValueIndexer(input_col="city", output_col="city_i").fit(t)
        indexed = vi.transform(t)
        out.append(indexed)
        out.append(m.IndexToValue(input_col="city_i", output_col="city_v",
                                  levels=vi.levels).transform(indexed))
        for to in ("boolean", "integer", "float", "string"):
            out.append(m.DataConversion(cols=["int"], convert_to=to).transform(t))
        sel_in = t.with_column("wide", np.concatenate(
            [np.asarray(t["vec"]), np.zeros((t.num_rows, 2))], axis=1))
        out.append(m.CountSelector(input_col="wide", output_col="sel").fit(sel_in)
                   .transform(sel_in))
        return out
    ref, port = both(run)
    for r, p in zip(ref, port):
        assert_same(r, p)
    assert port[-1]["sel"].shape[1] == 3


def test_text_featurizers_match_reference():
    docs = np.array(["The quick brown fox jumps", None, "über café naïve words, words!",
                     "a b c d e f g", "", "Numbers 12 and 345 too"] * 3, dtype=object)

    def run(m):
        t = m.Table({"text": docs})
        out = [m.TextFeaturizer(num_features=64, **kw).fit(t).transform(t)
               for kw in ({}, {"n_gram_length": 2}, {"binary": True, "use_idf": False},
                          {"to_lowercase": False})]
        out.append(m.MultiNGram(lengths=[1, 2, 3]).transform(t))
        long = m.Table({"text": np.array(["word " * 300, "x" * 50, None], dtype=object)})
        out.append(m.PageSplitter(maximum_page_length=100, minimum_page_length=80)
                   .transform(long))
        return out
    ref, port = both(run)
    for r, p in zip(ref, port):
        assert_same(r, p)


def test_featurize_pipeline_save_load_round_trip(tmp_path):
    """A fitted pipeline that holds Featurize comes back with the same
    output (port registry, port layout)."""
    t = _mixed(PORT)
    pipe = PORT.Pipeline(stages=[
        PORT.CleanMissingData(input_cols=["num"]),
        PORT.ValueIndexer(input_col="city", output_col="city_i"),
        PORT.Featurize(input_cols=["num", "city", "code", "vec"], max_one_hot=32),
        PORT.TextFeaturizer(input_col="text", output_col="tf", num_features=32),
    ]).fit(t)
    pipe.save(str(tmp_path / "p"))
    back = PORT.load_stage(str(tmp_path / "p"))
    assert_same(pipe.transform(t), back.transform(t))


# -- the featurize cases of tests/test_schema.py -----------------------------------

def test_validate_input_lists_all_missing_and_schema():
    for m in (REF, PORT):
        t = m.Table({"features": np.ones((3, 2)), "label": np.arange(3.0)})
        with pytest.raises(ValueError) as ei:
            m.CleanMissingData(input_cols=["featurs", "lable"]).fit(t)
        msg = str(ei.value)
        assert "'featurs'" in msg and "'lable'" in msg
        assert "did you mean 'features'" in msg and "did you mean 'label'" in msg
        assert "declared input schema" in msg


def _seeded_pipeline_source(kind: str) -> str:
    return f"""\
import sys
from synapseml_tpu_torch.core import Pipeline, TableSchema
from synapseml_tpu_torch.core.schema import PipelineSchemaError
from synapseml_tpu_torch.featurize.stages import Featurize, IndexToValue
from synapseml_tpu_torch.gbdt.estimators import LightGBMClassifier

schema = TableSchema({{"age": "float:scalar", "city": "object:scalar",
                      "label": "int:scalar"}})
if {(kind == "missing")!r}:
    p = Pipeline([Featurize(input_cols=["age", "town"]),
                  LightGBMClassifier(label_col="label")])
else:
    p = Pipeline([IndexToValue(input_col="city", output_col="cityname"),
                  Featurize(input_cols=["age", "city"]),
                  LightGBMClassifier(label_col="label")])
try:
    p.validate(schema)
except PipelineSchemaError as e:
    assert e.stage_index == 0, e.stage_index
    print("CAUGHT", type(e).__name__)
else:
    raise SystemExit("validate() did not raise")
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "synapseml_tpu" or m.startswith("synapseml_tpu.")]
assert not bad, f"imported during static validation: {{bad[:3]}}"
print("NOJAX")
"""


@pytest.mark.parametrize("kind", ["missing", "dtype"])
def test_pipeline_validate_catches_seeded_mismatch_without_jax(kind):
    proc = subprocess.run([sys.executable, "-c", _seeded_pipeline_source(kind)],
                          capture_output=True, text=True, timeout=120, cwd=REPO_ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "CAUGHT PipelineSchemaError" in proc.stdout
    assert "NOJAX" in proc.stdout


def test_pipeline_validate_happy_path_returns_output_schema():
    from synapseml_tpu.gbdt.estimators import LightGBMRegressor as RefRegressor
    from synapseml_tpu_torch.gbdt.estimators import LightGBMRegressor

    for m, reg in ((REF, RefRegressor), (PORT, LightGBMRegressor)):
        p = m.Pipeline([m.Featurize(input_cols=["age", "city"]), reg(label_col="label")])
        out = p.validate(m.TableSchema({"age": "float:scalar", "city": "object:scalar",
                                        "label": "float:scalar"}))
        assert out["features"] == m.ColumnSpec("float", "vector")
        assert out["prediction"] == m.ColumnSpec("float", "scalar")


def test_pipeline_validate_undeclared_stage_degrades_to_open():
    for m in (REF, PORT):
        p = m.Pipeline([m.Lambda(transform_func=lambda t: t),
                        m.Featurize(input_cols=["whatever"])])
        out = p.validate(m.TableSchema({"a": "float:scalar"}))
        assert out["features"] == m.ColumnSpec("float", "vector")


def test_clean_missing_accepts_dirty_object_column_statically():
    def run(m):
        t = m.Table({"a": np.array([1.0, None, 3.0], dtype=object)})
        p = m.Pipeline([m.CleanMissingData(input_cols=["a"])])
        assert p.validate(t)["a"] == m.ColumnSpec("float", "scalar")
        return p.fit(t).transform(t)
    ref, port = both(run)
    assert_same(ref, port)
    assert float(np.asarray(port["a"])[1]) == 2.0


def _numeric_table(m):
    rng = np.random.default_rng(0)
    return m.Table({"features": rng.normal(size=(32, 4)),
                    "label": (rng.random(32) > 0.5).astype(np.float64),
                    "num": rng.normal(size=32),
                    "cat": np.array(list("abcd") * 8, dtype=object),
                    "group": np.repeat(np.arange(8), 4)})


CONFORMANCE = {
    "CleanMissingData": lambda m: m.CleanMissingData(input_cols=["num"]),
    "ValueIndexer": lambda m: m.ValueIndexer(input_col="cat", output_col="cat_idx"),
    "IndexToValue": lambda m: m.IndexToValue(
        input_col="group", output_col="val", levels=np.array(list("abcdefgh"), dtype=object)),
    "DataConversion": lambda m: m.DataConversion(cols=["num"], convert_to="integer"),
    "CountSelector": lambda m: m.CountSelector(input_col="features", output_col="sel"),
    "Featurize": lambda m: m.Featurize(input_cols=["num", "cat"]),
    "FastVectorAssembler": lambda m: m.FastVectorAssembler(input_cols=["num", "features"]),
}


@pytest.mark.parametrize("name", sorted(CONFORMANCE))
def test_featurize_schema_conformance(name):
    """The stage produces exactly the columns it declares, with specs the
    declaration accepts, and the same table as the reference's stage."""
    from synapseml_tpu_torch.core.stage import Estimator

    def run(m):
        stage, table = CONFORMANCE[name](m), _numeric_table(m)
        derived = m.TableSchema.from_table(table)
        if isinstance(stage, (Estimator,)) or hasattr(stage, "_fit"):
            return stage.fit_schema(derived), stage.fit(table).transform(table)
        return stage.transform_schema(derived), stage.transform(table)
    (_, ref_out), (declared, out) = both(run)
    assert_same(ref_out, out)
    actual = PORT.TableSchema.from_table(out)
    assert sorted(declared.columns) == sorted(actual.columns)
    for col in actual.columns:
        assert declared[col].accepts(actual[col]), (col, declared[col], actual[col])


# -- core/clock.py and core/fault.py ----------------------------------------------

def test_stopwatch_and_buffered_map_match_reference():
    from synapseml_tpu.core.clock import buffered_map as ref_map
    from synapseml_tpu_torch.core import StopWatch, buffered_map

    sw = StopWatch()
    with sw.measure():
        time.sleep(0.01)
    first = sw.elapsed_ns
    assert first >= 10_000_000
    with sw.measure():
        pass
    assert sw.elapsed_ns >= first and sw.elapsed_s == sw.elapsed_ns / 1e9
    with pytest.raises(RuntimeError):
        StopWatch().stop()

    def slow_square(i):
        time.sleep(0.001 * (i % 3))
        return i * i

    assert list(buffered_map(slow_square, range(20), concurrency=4)) == \
        list(ref_map(slow_square, range(20), concurrency=4))


def test_retry_helpers_match_reference():
    from synapseml_tpu.core import fault as ref_fault
    from synapseml_tpu_torch.core import fault

    for mod in (ref_fault, fault):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise ConnectionError("down")
            return "up"

        assert mod.retry_with_backoff(flaky, retries=5, initial_delay_s=0.001) == "up"
        assert len(calls) == 3
        with pytest.raises(ConnectionError):
            mod.retry_with_backoff(lambda: (_ for _ in ()).throw(ConnectionError("x")),
                                   retries=2, initial_delay_s=0.001)
        with pytest.raises(TimeoutError):
            mod.run_with_timeout(lambda: threading.Event().wait(5), 0.05)
        assert mod.run_with_timeout(lambda: 7, 1.0) == 7

        closed = []

        class Res:
            def close(self):
                closed.append(1)

        with mod.using(Res()):
            pass
        with mod.using_many([Res(), Res()]):
            pass
        assert len(closed) == 3
