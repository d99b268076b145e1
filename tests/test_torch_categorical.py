"""Port parity, categorical features: binning (kernel D's plain version), the
categorical split search (kernel E's plain version), growth, training and
carried-across boosters against the JAX package on the same numpy inputs,
on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from synapseml_tpu.gbdt.binning import BinMapper as RefBinMapper
from synapseml_tpu.gbdt.boost import train as ref_train
from synapseml_tpu.gbdt.device_predict import device_bin_cat as ref_device_bin_cat
from synapseml_tpu.gbdt.device_predict import pack_feature_table as ref_pack_feature_table
from synapseml_tpu.gbdt.grow import TreeConfig as RefTreeConfig
from synapseml_tpu.gbdt.grow import grow_tree as ref_grow_tree
from synapseml_tpu_torch.gbdt.binning import BinMapper
from synapseml_tpu_torch.gbdt.boost import GBDTBooster, _preround, train
from synapseml_tpu_torch.gbdt.convert import booster_from_state
from synapseml_tpu_torch.gbdt.device_predict import (cats_f32_representable,
                                                     device_bin_cat, device_bin_cat_plain,
                                                     pack_feature_table)
from synapseml_tpu_torch.gbdt.grow import TreeConfig, grow_tree
from synapseml_tpu_torch.gbdt.split_search import split_search
from synapseml_tpu_torch.tools.kernel_cases import (bin_edge_case, check_left_sets,
                                                    split_cases)
from synapseml_tpu_torch.tools.schema_data import (ADULT_CARDINALITY, ADULT_COLUMNS,
                                                   adult_rows, adult_unseen_codes,
                                                   covertype_rows)

PARAMS = dict(num_iterations=5, num_leaves=15, max_bin=63)
CATS = [1, 4]


def _cat_data(seed=0, n=3000, d=6):
    """Two categorical columns (30 and 5 codes, some NaN), a label that
    depends on a set of column 1's codes and on column 0."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    x[:, 1] = rng.integers(0, 30, size=n)
    x[:, 4] = rng.integers(0, 5, size=n)
    x[::11, 1] = np.nan
    effect = rng.normal(size=30)
    z = effect[np.nan_to_num(x[:, 1]).astype(int)] + x[:, 0]
    y = (z + 0.3 * rng.normal(size=n) > 0).astype(np.float64)
    return x, y


def _mapper_cases():
    rng = np.random.default_rng(7)
    n = 4000
    x = rng.normal(size=(n, 5))
    x[:, 1] = rng.integers(0, 300, size=n)        # more categories than max_bin
    x[:, 2] = rng.integers(-3, 9, size=n)
    x[:, 3] = rng.choice([0.5, 1.25, 7.0], size=n)
    x[::13, 1] = np.nan
    x[::17, 2] = np.inf
    unseen = x.copy()
    unseen[:9, 1] = 1000.0                          # codes never seen in the fit
    unseen[9:12, 2] = -0.0                          # negative zero matches category 0
    unseen[12:15, 3] = np.nan
    return {
        "plain": (dict(max_bin=63, categorical_features=[1, 2]), x, unseen),
        "by_feature": (dict(max_bin=63, categorical_features=[1, 2, 3],
                            max_bin_by_feature=[0, 100, 4, 0, 8]), x, unseen),
        "sampled": (dict(max_bin=31, sample_cnt=1000, seed=3, categorical_features=[1]),
                    x, unseen),
    }


@pytest.mark.parametrize("case", ["plain", "by_feature", "sampled"])
def test_categorical_mapper_matches_reference(case):
    kw, x, probe = _mapper_cases()[case]
    ref = RefBinMapper(**kw).fit(x)
    port = BinMapper(**kw).fit(x)
    assert port.to_dict() == ref.to_dict()
    assert port.n_bins == ref.n_bins and port.realized_n_bins == ref.realized_n_bins
    for j in range(x.shape[1]):
        np.testing.assert_array_equal(port.bin_upper_value(j, np.arange(3)),
                                      ref.bin_upper_value(j, np.arange(3)))
    want = ref.transform(probe)
    np.testing.assert_array_equal(port.transform(probe), want)
    # f64 values that are not all f32 take the f64 path; f32 values kernel D's
    for xin in (probe, probe.astype(np.float32)):
        got = port.transform_torch(torch.from_numpy(xin))
        assert got.dtype == (torch.int8 if port.n_bins <= 127 else torch.int16)
        np.testing.assert_array_equal(got.numpy(), ref.transform(xin))
    # each package loads the other's mapper
    np.testing.assert_array_equal(BinMapper.from_dict(ref.to_dict()).transform(probe), want)
    np.testing.assert_array_equal(RefBinMapper.from_dict(port.to_dict()).transform(probe),
                                  want)


def test_device_binning_gate():
    x, _ = _cat_data(1, n=500)
    m = BinMapper(max_bin=63, categorical_features=CATS).fit(x)
    assert m.device_binnable(torch.from_numpy(x))
    assert m.device_binnable(torch.from_numpy(x.astype(np.float64)))   # exactly f32
    assert not m.device_binnable(torch.from_numpy(x.astype(np.float64) + 1e-9))
    m.cat_values[1] = m.cat_values[1] + 0.1        # not f32-representable categories
    assert not cats_f32_representable(m) and not m.device_binnable(torch.from_numpy(x))


@pytest.mark.parametrize("out_dtype", [torch.int8, torch.int16, torch.int32])
def test_device_bin_cat_plain_matches_reference(out_dtype):
    m, probe = bin_edge_case()
    e0 = np.asarray(m.upper_edges[0])
    assert (e0[:-1].astype(np.float32).astype(np.float64) > e0[:-1]).any()  # rounds up
    rm = RefBinMapper.from_dict(m.to_dict())
    table, lens, flags = pack_feature_table(m)
    r_table, r_lens, r_flags = ref_pack_feature_table(rm)
    np.testing.assert_array_equal(table, r_table)
    np.testing.assert_array_equal(lens, r_lens)
    np.testing.assert_array_equal(flags, r_flags)
    want = np.asarray(ref_device_bin_cat(probe, r_table, r_lens, r_flags, rm.missing_bin))
    args = [torch.from_numpy(a) for a in (probe, table, lens, flags)]
    got = device_bin_cat(*args, m.missing_bin, out_dtype)
    assert got.dtype == out_dtype
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(device_bin_cat_plain(*args, m.missing_bin).numpy(), want)
    np.testing.assert_array_equal(want, rm.transform(probe))    # host binning, too


def _grow_inputs(seed=1, n=3000, d=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    x[:, 1] = rng.integers(0, 40, size=n)
    x[:, 4] = rng.integers(0, 7, size=n)
    mapper = RefBinMapper(max_bin=63, categorical_features=[1, 4]).fit(x)
    binned = mapper.transform(x).astype(np.int8)
    effect = rng.normal(size=40)
    y = (effect[x[:, 1].astype(int)] + x[:, 0] + 0.3 * rng.normal(size=n) > 0)
    g = _preround(torch.tensor(0.5 - y + 0.1 * x[:, 2], dtype=torch.float32)[:, None],
                  4096)[:, 0]
    h = _preround(torch.tensor(0.2 + 0.05 * np.abs(x[:, 3]), dtype=torch.float32)[:, None],
                  4096)[:, 0]
    cat_mask = np.zeros(d, np.float32)
    cat_mask[[1, 4]] = 1.0
    return binned, g, h, np.ones(n, np.float32), np.ones(d, np.float32), cat_mask


@pytest.mark.parametrize("cfg", [dict(), dict(max_cat_threshold=3),
                                 dict(cat_smooth=1.0, lambda_l1=0.5, lambda_l2=2.0),
                                 dict(max_depth=3, min_data_in_leaf=50)],
                         ids=["default", "max_cat_threshold", "smooth_l1_l2", "depth"])
def test_grow_categorical_matches_reference(cfg):
    """Identical parent / feature / bin / cat_set, leaf values within rtol 1e-6."""
    binned, g, h, w, fm, cm = _grow_inputs()
    cfg = dict(n_bins=64, num_leaves=15, **cfg)
    ref, ref_node = ref_grow_tree(jnp.asarray(binned), jnp.asarray(g.numpy()),
                                  jnp.asarray(h.numpy()), jnp.asarray(w), jnp.asarray(fm),
                                  RefTreeConfig(**cfg), cat_mask=jnp.asarray(cm))
    tree, node = grow_tree(torch.from_numpy(binned), g, h, torch.from_numpy(w),
                           torch.from_numpy(fm), TreeConfig(**cfg),
                           cat_mask=torch.from_numpy(cm))
    for field in ("parent", "feature", "bin", "cat_set"):
        np.testing.assert_array_equal(getattr(tree, field).numpy(),
                                      np.asarray(getattr(ref, field)), err_msg=field)
    assert (tree.bin.numpy() < 0).any()                 # categorical splits were taken
    np.testing.assert_allclose(tree.leaf_value.numpy(), np.asarray(ref.leaf_value),
                               rtol=1e-6)
    np.testing.assert_array_equal(node.numpy(), np.asarray(ref_node))


@pytest.mark.parametrize("case", ["numeric", "mixed_cat", "max_cat_threshold",
                                  "empty_bins", "ties", "cat_ties", "nan_gain",
                                  "masked_l1_l2", "largest_B"])
def test_split_cases_plain(case):
    """Kernel E's card cases through the plain version: inactive leaves get
    -inf, ties go to the first feature, 0/0 gains win as NaN, and the left
    set growth rebuilds has the gain the search reports."""
    hists, fm, cm, n_active, cfg = split_cases()[case]
    args = [None if a is None else torch.from_numpy(a) for a in (hists, fm, cm)]
    got = split_search(*args, n_active, cfg)
    assert (got[0][n_active:] == float("-inf")).all()
    if case in ("ties", "cat_ties"):
        assert (got[1] == (2 if case == "ties" else 1)).all()
    if case == "nan_gain":
        assert got[0].isnan().any()
    if case == "max_cat_threshold":
        assert (got[2] <= 1).all()
    if case == "masked_l1_l2":
        assert not ((got[1] == 1) | (got[1] == 4)).any()
    assert check_left_sets(args[0], args[2], n_active, cfg, got) > 0 or case == "nan_gain"


@pytest.fixture(scope="module")
def cat_boosters():
    """Reference and port boosters, trained once with categorical columns by
    index and by name."""
    x, y = _cat_data()
    names = [f"c{i}" for i in range(x.shape[1])]
    out = {}
    for kind, cats in (("index", CATS), ("name", ["c1", "c4"])):
        params = dict(PARAMS, objective="binary", categorical_feature=cats)
        out[kind] = (ref_train(params, x, y, feature_names=names),
                     train(params, x, y, device="cpu", feature_names=names))
    return x, out


@pytest.mark.parametrize("kind", ["index", "name"])
def test_train_categorical_matches_reference(cat_boosters, kind):
    x, boosters = cat_boosters
    ref, port = boosters[kind]
    for field in ("parent", "feature", "bin", "cat_set"):
        np.testing.assert_array_equal(getattr(port, field), getattr(ref, field),
                                      err_msg=field)
    assert (port.bin < 0).any() and port.cat_set.shape == (5, 1, 14, 64)
    np.testing.assert_allclose(port.threshold, ref.threshold)   # NaN where categorical
    np.testing.assert_allclose(port.leaf_value, ref.leaf_value, rtol=0, atol=1e-6)
    probe = x.copy()
    probe[:20, 1] = 99.0                                      # unseen codes go right
    np.testing.assert_allclose(port.predict(probe, device="cpu"), ref.predict(probe),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(port.predict_leaf(probe, device="cpu"),
                                  ref.predict_leaf(probe))


def test_reference_categorical_booster_carried_across(cat_boosters):
    """A reference booster with cat_set scores the same through the port;
    the port's own state dict round-trips."""
    x, boosters = cat_boosters
    ref, port = boosters["index"]
    carried = booster_from_state(ref.state_dict())
    assert carried.cat_set is not None
    np.testing.assert_allclose(carried.raw_predict(x, device="cpu"), ref.raw_predict(x),
                               rtol=0, atol=1e-6)
    again = GBDTBooster.from_state_dict(port.state_dict())
    np.testing.assert_array_equal(again.cat_set, port.cat_set)
    np.testing.assert_array_equal(again.raw_predict(x, device="cpu"),
                                  port.raw_predict(x, device="cpu"))


def test_schema_rows_hold_the_published_schemas():
    """chip_smoke's Adult and Covertype rows: column counts, categorical
    cardinalities, NaN only where Adult's files hold '?', unseen codes only
    where asked, 7 Covertype classes."""
    x, y, p = adult_rows(0, 20_000)
    assert x.shape == (20_000, 14) and x.dtype == np.float32 and set(np.unique(y)) == {0, 1}
    for name, k in ADULT_CARDINALITY.items():
        col = x[:, ADULT_COLUMNS.index(name)]
        codes = col[~np.isnan(col)]
        assert codes.min() >= 0 and codes.max() <= k - 1 and len(np.unique(codes)) == k
        assert np.isnan(col).any() == (name in ("workclass", "occupation", "native-country"))
    unseen = adult_unseen_codes(x, 1, 0.01)
    occ = ADULT_COLUMNS.index("occupation")
    assert (unseen[:, occ] >= ADULT_CARDINALITY["occupation"]).any()
    np.testing.assert_array_equal(np.delete(unseen, [occ, 13], 1), np.delete(x, [occ, 13], 1))
    x, y, logits = covertype_rows(0, 20_000)
    assert x.shape == (20_000, 12) and logits.shape == (20_000, 7)
    assert set(np.unique(y)) == set(range(7))
    assert set(np.unique(x[:, 10])) == set(range(4)) and np.unique(x[:, 11]).size == 40
