"""The port's ``GBDTDataset`` against the JAX package's, on the CPU.

The single-device cases of ``tests/test_gbdt.py`` (dataset reuse, the
device-resident construction with and without categorical features,
continued training from a device-resident dataset, the alias-passed
``max_bin`` warning) and of ``tests/test_gbdt_sparse.py`` (CSR datasets)
run here on the same seeded inputs. The reference's "device" datasets are
``jax.Array``s on the CPU, the port's are tensors with ``device="cpu"``.
Edges and binned matrices must be equal, trees identical, and leaves within
the tolerances ROADMAP queue 3 states (binary 1e-3: XLA's ``exp``; l2 1e-4:
XLA's ``exp2`` in ``_preround``). On the CPU kernel D is its plain version,
``device_bin_cat_plain``: a fit that reuses a dataset must call it 0 times.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapseml_tpu.gbdt import GBDTDataset as RefDataset
from synapseml_tpu.gbdt.boost import train as ref_train
from synapseml_tpu_torch.gbdt import GBDTDataset
from synapseml_tpu_torch.gbdt import device_predict
from synapseml_tpu_torch.gbdt.binning import BinMapper
from synapseml_tpu_torch.gbdt.boost import train
from synapseml_tpu_torch.gbdt.sparse import SparseBinned
from synapseml_tpu_torch.runtime.device import DeviceUnavailableError
from test_torch_sparse import _auc, _cat_sparse_data, _same_trees, _sparse_data
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"
BINARY_LEAF_TOL = 1e-3  # XLA's exp against torch.exp
L2_LEAF_TOL = 1e-4      # the reference's pre-rounding grid (XLA's exp2)
PARAMS = {"objective": "binary", "num_iterations": 10, "num_leaves": 15,
          "min_data_in_leaf": 5, "max_bin": 63}


@pytest.fixture(scope="module")
def data():
    """``tests/test_gbdt.py``'s ``data`` fixture."""
    rng = np.random.default_rng(0)
    n, d = 3000, 8
    x = rng.normal(size=(n, d))
    logit = 2 * x[:, 0] - 1.5 * x[:, 1] + x[:, 2] * x[:, 3]
    y = (logit + rng.normal(scale=0.5, size=n) > 0).astype(float)
    yr = logit + rng.normal(scale=0.3, size=n)
    return x, y, yr


class _CountD:
    """Counts calls of kernel D's plain version (the CPU's kernel D)."""

    def __init__(self, monkeypatch):
        self.calls = 0
        plain = device_predict.device_bin_cat_plain

        def counted(*a, **k):
            self.calls += 1
            return plain(*a, **k)

        monkeypatch.setattr(device_predict, "device_bin_cat_plain", counted)


def _same_edges(pm, rm):
    assert sorted(pm.cat_values) == sorted(rm.cat_values)
    for j in pm.cat_values:
        np.testing.assert_array_equal(pm.cat_values[j], rm.cat_values[j])
    for ep, er in zip(pm.upper_edges, rm.upper_edges):
        np.testing.assert_array_equal(ep, er)


# -- host dense -------------------------------------------------------------------

def test_dataset_reuse_matches_reference(data, monkeypatch):
    """``test_gbdt.py:290``: bin and move once, identical models across fits,
    the device buffer shared, and the dataset's binning wins."""
    x, y, _ = data
    ds = GBDTDataset(x[:2400], max_bin=63, device=CPU)
    ref_ds = RefDataset(x[:2400], max_bin=63)
    _same_edges(ds.mapper, ref_ds.mapper)
    np.testing.assert_array_equal(ds.binned_np, ref_ds.binned_np)
    b_raw = train(PARAMS, x[:2400], y[:2400], device=CPU)
    count = _CountD(monkeypatch)
    b_ds = train(PARAMS, ds, y[:2400])
    _same_trees(b_ds, b_raw, 0.0)
    _same_trees(b_ds, ref_train(PARAMS, ref_ds, y[:2400]), BINARY_LEAF_TOL)
    dev1 = ds.device_binned()
    train({**PARAMS, "num_leaves": 7}, ds, y[:2400])
    assert ds.device_binned() is dev1
    with pytest.warns(UserWarning, match="max_bin=255 ignored"):
        b_conflict = train({**PARAMS, "max_bin": 255}, ds, y[:2400])
    _same_trees(b_conflict, b_ds, 0.0)
    assert count.calls == 0  # the fits over the dataset bin nothing


def test_dataset_regression_and_label_matches_reference(data):
    x, _, yr = data
    params = {"objective": "regression", "num_iterations": 6, "num_leaves": 15,
              "max_bin": 63}
    ds = GBDTDataset(x[:2000], label=yr[:2000], max_bin=63, device=CPU)
    ref = ref_train(params, RefDataset(x[:2000], label=yr[:2000], max_bin=63))
    _same_trees(train(params, ds), ref, L2_LEAF_TOL)
    assert ds.label_device().dtype == torch.float32
    assert ds.label_device() is ds.label_device()


def test_from_binned_matches_host_dataset(data):
    """The tuning transport: bins and a mapper made elsewhere."""
    x, y, _ = data
    host = GBDTDataset(x[:2000], label=y[:2000], max_bin=63, device=CPU)
    ds = GBDTDataset.from_binned(host.binned_np, host.mapper, x=x[:2000], label=y[:2000],
                                 device=CPU)
    ref_host = RefDataset(x[:2000], label=y[:2000], max_bin=63)
    ref = ref_train(PARAMS, RefDataset.from_binned(ref_host.binned_np, ref_host.mapper,
                                                   x=x[:2000], label=y[:2000]))
    b = train(PARAMS, ds)
    _same_trees(b, train(PARAMS, host), 0.0)
    _same_trees(b, ref, BINARY_LEAF_TOL)
    with pytest.raises(ValueError, match="binned shape"):
        GBDTDataset.from_binned(host.binned_np[:10], host.mapper, x=x[:2000], device=CPU)


# -- device-resident ----------------------------------------------------------------

def test_dataset_device_resident_matches_reference(data, monkeypatch):
    """``test_gbdt.py:314``: kernel D bins the tensor once, the fit matches the
    host path (n < sample_cnt, so both fit edges on the same rows), and an
    overriding mapper is refused."""
    x, y, _ = data
    count = _CountD(monkeypatch)
    ds = GBDTDataset(torch.as_tensor(x[:2400], dtype=torch.float32), max_bin=63, device=CPU)
    assert ds.is_device and ds.binned_np is None and count.calls == 1
    ref_ds = RefDataset(jnp.asarray(x[:2400], jnp.float32), max_bin=63)
    _same_edges(ds.mapper, ref_ds.mapper)
    np.testing.assert_array_equal(ds.device_binned().numpy().astype(np.int32),
                                  np.asarray(ref_ds.device_binned(), np.int32))
    np.testing.assert_array_equal(ds.device_binned().numpy().astype(np.int32),
                                  ds.mapper.transform(x[:2400].astype(np.float32)))
    b_dev = train(PARAMS, ds, torch.as_tensor(y[:2400], dtype=torch.float32))
    assert count.calls == 1  # the fit bins nothing
    b_host = train(PARAMS, x[:2400].astype(np.float32), y[:2400], device=CPU)
    _same_trees(b_dev, b_host, 0.0)
    ref = ref_train(PARAMS, ref_ds, jnp.asarray(y[:2400], jnp.float32))
    _same_trees(b_dev, ref, BINARY_LEAF_TOL)
    np.testing.assert_allclose(b_dev.predict(x[:2400], device=CPU), ref.predict(x[:2400]),
                               rtol=0, atol=BINARY_LEAF_TOL)
    with pytest.raises(ValueError, match="owns its binning"):
        train(PARAMS, ds, y[:2400], mapper=BinMapper(max_bin=63).fit(x[:2400]))


def test_dataset_device_resident_categorical_matches_reference():
    """``test_gbdt.py:345``: categorical codes fit on the pulled sample; the
    device bins equal the host dataset's, and both fits the reference's."""
    rng = np.random.default_rng(3)
    n = 2000
    xh = np.column_stack([rng.normal(size=n), rng.integers(0, 6, n).astype(float),
                          rng.normal(size=n)]).astype(np.float64)
    yv = ((xh[:, 1] % 2 == 0) ^ (xh[:, 0] > 0)).astype(np.float64)
    ds_dev = GBDTDataset(torch.as_tensor(xh, dtype=torch.float32),
                         label=torch.as_tensor(yv, dtype=torch.float32),
                         categorical_features=[1], max_bin=63, device=CPU)
    ds_host = GBDTDataset(xh, label=yv, categorical_features=[1], max_bin=63, device=CPU)
    np.testing.assert_array_equal(ds_dev.device_binned().numpy().astype(np.int32),
                                  ds_host.binned_np)
    ref_dev = RefDataset(jnp.asarray(xh, jnp.float32), label=jnp.asarray(yv, jnp.float32),
                         categorical_features=[1], max_bin=63)
    _same_edges(ds_dev.mapper, ref_dev.mapper)
    params = dict(PARAMS, num_iterations=8, categorical_feature=[1])
    b_dev, b_host = train(params, ds_dev), train(params, ds_host)
    _same_trees(b_dev, b_host, 0.0)
    ref = ref_train(params, ref_dev)
    _same_trees(b_dev, ref, BINARY_LEAF_TOL)
    assert float(np.mean((b_dev.predict(xh, device=CPU) > 0.5) == yv)) > 0.95


def test_dataset_sampled_edges_match_reference():
    """Past ``bin_sample_count`` rows the device-resident dataset pulls only
    the sample (sorted) and fits the same edges as the host dataset and the
    reference's device dataset."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3000, 4)).astype(np.float32)
    x[:, 3] = rng.integers(0, 9, 3000)
    kw = dict(max_bin=31, bin_sample_count=700, seed=4, categorical_features=[3])
    ds_dev = GBDTDataset(torch.as_tensor(x), device=CPU, **kw)
    ds_host = GBDTDataset(x, device=CPU, **kw)
    ref = RefDataset(jnp.asarray(x), **kw)
    _same_edges(ds_dev.mapper, ds_host.mapper)
    _same_edges(ds_dev.mapper, ref.mapper)
    np.testing.assert_array_equal(ds_dev.device_binned().numpy().astype(np.int32),
                                  np.asarray(ref.device_binned(), np.int32))


def test_continued_training_device_dataset_matches_reference(monkeypatch):
    """``test_gbdt.py:1057``: continuation from a device-resident dataset
    scores the init booster over the cached bins (kernel D not called) and
    equals the continuation from the raw matrix with the same binning."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(2000, 10)).astype(np.float32)
    y = (x[:, 0] - 0.5 * x[:, 4] > 0).astype(np.float32)
    params = {"objective": "binary", "num_iterations": 5, "num_leaves": 7,
              "min_data_in_leaf": 5, "max_bin": 63}
    ds = GBDTDataset(torch.as_tensor(x), label=torch.as_tensor(y), max_bin=63, device=CPU)
    count = _CountD(monkeypatch)
    b1 = train(params, ds)
    b2 = train(params, ds, init_booster=b1)
    assert b2.num_trees == 10 and count.calls == 0
    b1n = train(params, x.astype(np.float64), y.astype(np.float64), device=CPU,
                mapper=ds.mapper)
    b2n = train(params, x.astype(np.float64), y.astype(np.float64), device=CPU,
                init_booster=b1n, mapper=ds.mapper)
    _same_trees(b2, b2n, 0.0)
    ref_ds = RefDataset(jnp.asarray(x), label=jnp.asarray(y), max_bin=63)
    rb2 = ref_train(params, ref_ds, init_booster=ref_train(params, ref_ds))
    _same_trees(b2, rb2, BINARY_LEAF_TOL)


def test_device_resident_dataset_wants_a_card_by_default(monkeypatch):
    """A CPU tensor with ``device=None`` moves to the GPU: with none visible
    the dataset raises; a fit cannot move the dataset elsewhere."""
    x = torch.zeros(10, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailableError):
        GBDTDataset(x)
    with pytest.raises(DeviceUnavailableError):
        GBDTDataset(x.numpy())
    ds = GBDTDataset(torch.rand(50, 2), label=np.arange(50) % 2, device=CPU)
    with pytest.raises(DeviceUnavailableError):
        train(PARAMS, ds, device="cuda")
    with pytest.raises(ValueError, match="y is required"):
        train(PARAMS, GBDTDataset(x, device=CPU))


# -- the binning warnings ---------------------------------------------------------------

def test_alias_passed_binning_param_warns_as_reference():
    """``test_gbdt.py:1243-1251``: an alias of ``max_bin`` still warns."""
    rng = np.random.default_rng(42)
    x = rng.normal(size=(300, 5))
    y = (x[:, 0] > 0).astype(np.float64)
    ds = GBDTDataset(x, label=y, max_bin=63, device=CPU)
    with pytest.warns(UserWarning, match="max_bin=31 ignored"):
        train({"objective": "binary", "num_iterations": 2, "max_bins": 31}, ds)
    with pytest.warns(UserWarning, match="max_bin=31 ignored"):
        ref_train({"objective": "binary", "num_iterations": 2, "max_bins": 31},
                  RefDataset(x, label=y, max_bin=63))


@pytest.mark.parametrize("params, match", [
    ({"max_bin": 63, "bin_sample_count": 200_000, "max_bin_by_feature": None}, None),
    ({"bin_sample_count": 100}, "bin_sample_count=100 ignored"),
    ({"max_bin_by_feature": [4, 4, 4, 4, 4]}, "max_bin_by_feature"),
    ({"categorical_feature": [2]}, "conflicts with the GBDTDataset"),
    ({"cat_feature": [2]}, "conflicts with the GBDTDataset"),
])
def test_binning_warnings_only_on_a_real_mismatch(params, match):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(300, 5))
    x[:, 2] = rng.integers(0, 3, 300)
    y = (x[:, 0] > 0).astype(np.float64)
    full = dict({"objective": "binary", "num_iterations": 2}, **params)
    ds = GBDTDataset(x, label=y, max_bin=63, device=CPU)
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        train(full, ds)
    with warnings.catch_warnings(record=True) as ref_got:
        warnings.simplefilter("always")
        ref_train(full, RefDataset(x, label=y, max_bin=63))
    mine = [str(w.message) for w in got if "GBDTDataset" in str(w.message)]
    theirs = [str(w.message) for w in ref_got if "GBDTDataset" in str(w.message)]
    assert len(mine) == len(theirs) == (0 if match is None else 1)
    if match is not None:
        assert match in mine[0] and match in theirs[0]


# -- CSR ----------------------------------------------------------------------------------

def test_sparse_dataset_reuse_matches_reference():
    """``test_gbdt_sparse.py:370``: the SparseBinned is built once across fits."""
    X, y = _sparse_data(600, 100)
    ds = GBDTDataset(X, label=y, device=CPU)
    assert ds.is_sparse and ds.num_rows == 600 and ds.num_features == 100
    params = {"objective": "binary", "num_iterations": 8, "num_leaves": 7,
              "min_data_in_leaf": 5}
    b1 = train(params, ds)
    sb = ds.device_binned()
    assert isinstance(sb, SparseBinned)
    b1b = train(dict(params, num_leaves=5), ds)
    assert ds.device_binned() is sb and b1b.num_trees == 8
    b2 = train(params, X, y, device=CPU)
    _same_trees(b1, b2, 0.0)
    _same_trees(b1, ref_train(params, RefDataset(X, label=y)), BINARY_LEAF_TOL)
    np.testing.assert_allclose(b1.predict(X, device=CPU), b2.predict(X, device=CPU),
                               rtol=0, atol=0)


def test_sparse_dataset_with_categorical_matches_reference():
    """``test_gbdt_sparse.py:361``."""
    X, dense, y = _cat_sparse_data(n=500)
    params = {"objective": "binary", "num_iterations": 6, "num_leaves": 7,
              "min_data_in_leaf": 5}
    b = train(params, GBDTDataset(X, label=y, categorical_features=[0], device=CPU))
    assert (b.bin == -1).any()
    np.testing.assert_allclose(b.predict(X, device=CPU), b.predict(dense, device=CPU),
                               rtol=1e-6)
    ref = ref_train(params, RefDataset(X, label=y, categorical_features=[0]))
    _same_trees(b, ref, BINARY_LEAF_TOL)


def test_sparse_dataset_eval_set_and_continuation():
    """A dataset as an eval set, and continued training over a CSR dataset."""
    X, y = _sparse_data(800, 120)
    params = {"objective": "binary", "num_iterations": 5, "num_leaves": 7,
              "min_data_in_leaf": 5, "metric": "auc"}
    tr = GBDTDataset(X[:600], label=y[:600], device=CPU)
    ev = GBDTDataset(X[600:], label=y[600:], device=CPU)
    b1 = train(params, tr, eval_set=[(ev, y[600:])])
    raw = train(params, X[:600], y[:600], device=CPU, eval_set=[(X[600:], y[600:])])
    assert [r["eval0_auc"] for r in b1.evals_result] == \
        [r["eval0_auc"] for r in raw.evals_result]
    b2 = train(params, tr, init_booster=b1)
    assert b2.num_trees == 10
    assert _auc(y[:600], b2.predict(X[:600], device=CPU)) >= \
        _auc(y[:600], b1.predict(X[:600], device=CPU)) - 1e-6
