"""The port's sparse (CSR) GBDT on a mesh, on the CPU, over a gloo world.

The reference's sparse mesh tests (``tests/test_gbdt_sparse.py`` ``:286``,
``:317``, ``:404``, ``:440``, ``:471``, ``:530``) carried over as
``tests/test_torch_mesh.py`` carries the dense ones: one persistent 8-rank
gloo world (``tests/torch_mesh.py``), every rank's booster the same, the
mesh trees bit-identical to the port's single-device fit (pre-rounded
sums are exact in any order; the half side comes from the all-reduced
member counts, and the sibling is the kept global parent minus the
all-reduced side), and within the binary tolerance of ROADMAP queue 3
(XLA's ``exp``) of the reference's mesh fit. Each split step launches
kernel G's mesh use once (its plain version here).
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax
from jax.sharding import Mesh

from synapseml_tpu.gbdt.boost import train as ref_train

from synapseml_tpu_torch.gbdt.binning import BinMapper
from synapseml_tpu_torch.gbdt.boost import GBDTBooster, train
from synapseml_tpu_torch.gbdt.metrics import METRICS
from synapseml_tpu_torch.gbdt.sparse import CSRMatrix, shard_sparse_binned
from tests.torch_mesh import MeshWorld
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

BINARY_TOL = 1e-3  # XLA's exp in the reference's sigmoid (ROADMAP queue 3)
EIGHT = ("raw", (8,), ("data",))
FOUR_TWO = ("build", 4, 2)
TREE_FIELDS = ("parent", "feature", "bin", "cat_set", "leaf_value")


@pytest.fixture(scope="module")
def world():
    w = MeshWorld(8)
    yield w
    w.close()


def _sparse_data(n=1500, d=400, density=0.05, seed=0):
    rng = np.random.default_rng(seed)
    X = sp.random(n, d, density=density, random_state=seed,
                  data_rvs=lambda k: rng.integers(1, 4, k).astype(float)).tocsr()
    w = rng.normal(size=d) * (rng.random(d) < 0.2)
    y = ((X @ w) + 0.1 * rng.normal(size=n) > 0).astype(float)
    return X, y


def _cat_sparse_data(n=800, d=60, seed=0):
    """Sparse matrix whose column 0 is an informative categorical."""
    rng = np.random.default_rng(seed)
    dense = np.zeros((n, d))
    for i in range(n):
        cols = rng.choice(np.arange(1, d), size=6, replace=False)
        dense[i, cols] = rng.integers(1, 4, size=6)
    cats = rng.integers(0, 6, size=n).astype(np.float64)
    dense[:, 0] = cats
    y = (np.isin(cats, [1, 4]).astype(np.float64) * 2
         + dense[:, 3] - dense[:, 7]
         + 0.1 * rng.normal(size=n) > 1).astype(np.float64)
    return sp.csr_matrix(dense), dense, y


def _ref_mesh(shape):
    devs = np.asarray(jax.devices()[:8]).reshape(shape)
    return Mesh(devs, ("data",) if len(shape) == 1 else ("data", "model"))


def _booster(state):
    return GBDTBooster.from_state_dict(state)


def _same_fields(a, b, fields=TREE_FIELDS):
    for f in fields:
        va, vb = getattr(a, f), getattr(b, f)
        if va is None or vb is None:
            assert va is None and vb is None, f
        else:
            np.testing.assert_array_equal(va, vb, err_msg=f)


def mesh_fit(world, layout, params, x, y, **kw):
    """(rank 0's booster, collectives, G / P calls) of one fit on every
    rank, after checking that every rank returned the same booster."""
    res = world.run("fit", layout=layout, params=params, x=x, y=y, **kw)
    first = _booster(res[0]["booster"])
    for r in res[1:]:
        _same_fields(_booster(r["booster"]), first, TREE_FIELDS + ("leaf_hess", "tree_scale"))
    return first, res[0]["collectives"], res[0]["calls"]


def close_to_reference(port, ref, tol=BINARY_TOL):
    assert port.num_trees == ref.num_trees
    for f in ("parent", "feature", "bin"):
        np.testing.assert_array_equal(getattr(port, f), np.asarray(getattr(ref, f)), err_msg=f)
    if ref.cat_set is not None or port.cat_set is not None:
        np.testing.assert_array_equal(port.cat_set, np.asarray(ref.cat_set))
    np.testing.assert_allclose(port.leaf_value, np.asarray(ref.leaf_value), rtol=0, atol=tol)


def _auc(y, p):
    return METRICS["auc"][0](y, p, np.ones(len(y)))


def _steps(params):
    return params["num_iterations"] * (params["num_leaves"] - 1)


def test_sparse_dart_mesh_matches_single_device(world):
    """``:286``: DART over CSR rows on the mesh: the drops drawn on the
    host, the replays over each rank's block; the single device's trees and
    predictions exactly."""
    X, y = _sparse_data(300, 50)
    params = {"objective": "binary", "boosting": "dart", "num_iterations": 5,
              "num_leaves": 7, "min_data_in_leaf": 5, "drop_rate": 0.5, "seed": 3}
    b8, _, _ = mesh_fit(world, EIGHT, params, X, y)
    b1 = train(dict(params), X, y, device="cpu")
    _same_fields(b8, b1, TREE_FIELDS + ("tree_scale",))
    np.testing.assert_array_equal(b1.predict(X, device="cpu"), b8.predict(X, device="cpu"))
    close_to_reference(b8, ref_train(dict(params), X, y, mesh=_ref_mesh((4, 2))))


def test_sparse_categorical_mesh_matches_single(world):
    """``:317``: a categorical split's left set from the leaf's all-reduced
    row of the feature: the single device's trees and category sets."""
    X, _, y = _cat_sparse_data(n=640)
    params = {"objective": "binary", "num_iterations": 6, "num_leaves": 7,
              "min_data_in_leaf": 5, "categorical_feature": [0]}
    b_mesh, coll, _ = mesh_fit(world, FOUR_TWO, params, X, y)
    b_one = train(params, X, y, device="cpu")
    _same_fields(b_mesh, b_one)
    assert (b_mesh.bin == -1).any()
    np.testing.assert_array_equal(b_mesh.predict(X, device="cpu"), b_one.predict(X, device="cpu"))
    # the model axis replicates for sparse input: every collective is over data
    assert set(coll) == {"sum:data", "max:data"}
    close_to_reference(b_mesh, ref_train(params, X, y, mesh=_ref_mesh((4, 2))))


def test_sparse_mesh_matches_single_device(world):
    """``:404``: 997 rows over 8 shards (wrapped padding of weight -0.0):
    the single device's trees; G's mesh use once a split step, its root
    call once a tree, and two all-reduces a step (the member counts; both
    slots with the totals)."""
    X, y = _sparse_data(997, 150)
    params = {"objective": "binary", "num_iterations": 8, "num_leaves": 15,
              "min_data_in_leaf": 5}
    b8, coll, calls = mesh_fit(world, EIGHT, params, X, y)
    b1 = train(params, X, y, device="cpu")
    _same_fields(b8, b1)
    steps = _steps(params)
    assert calls["g_mesh"] == steps
    assert calls["g"] == steps + params["num_iterations"]  # the roots: G's own entry
    assert coll == {"sum:data": params["num_iterations"] + 2 * steps,
                    "max:data": 2 * params["num_iterations"]}
    close_to_reference(b8, ref_train(params, X, y, mesh=_ref_mesh((8,))))


def test_sparse_leaf_local_mesh_matches_single_device(world):
    """``:440``: the half pass on the mesh (the port's only sparse path;
    ``leaf_local`` is inert): the side from the global counts, the summed
    side all-reduced and subtracted from the kept global parent; the single
    device's trees bit for bit."""
    X, y = _sparse_data(997, 120, density=0.08, seed=6)
    params = {"objective": "binary", "num_iterations": 6, "num_leaves": 15,
              "min_data_in_leaf": 5, "leaf_local": True}
    b8, _, _ = mesh_fit(world, EIGHT, dict(params), X, y)
    b1 = train(dict(params), X, y, device="cpu")
    _same_fields(b8, b1)
    np.testing.assert_array_equal(b8.predict(X, device="cpu"), b1.predict(X, device="cpu"))
    close_to_reference(b8, ref_train(dict(params), X, y, mesh=_ref_mesh((4, 2))))


def test_sparse_voting_parallel(world):
    """``:471``: PV-tree voting over CSR rows: local two-sided histograms,
    votes and candidates all-reduced; AUC above 0.85, as in the
    reference, and the reference's voting trees."""
    X, y = _sparse_data(800, 150)
    params = {"objective": "binary", "num_iterations": 8, "num_leaves": 15,
              "min_data_in_leaf": 5, "parallelism": "voting_parallel", "top_k": 30}
    b, coll, calls = mesh_fit(world, EIGHT, params, X, y)
    assert _auc(y, b.predict(X, device="cpu")) > 0.85
    assert "g_mesh" not in calls  # local histograms: G's own both-sides entry
    close_to_reference(b, ref_train(params, X, y, mesh=_ref_mesh((8,))))


def test_sparse_dataset_on_mesh(world):
    """A CSR ``GBDTDataset`` on the mesh: each rank bins and lays out its
    block of the dataset's rows with the dataset's mapper; the trees of the
    single-device fit over the dataset."""
    from synapseml_tpu_torch.gbdt import GBDTDataset

    X, y = _sparse_data(600, 100)
    params = {"objective": "binary", "num_iterations": 5, "num_leaves": 7,
              "min_data_in_leaf": 5}
    b8, _, calls = mesh_fit(world, FOUR_TWO, params, X, y, dataset="host")
    _same_fields(b8, train(params, GBDTDataset(X, label=y, device="cpu")))
    assert calls["g_mesh"] == _steps(params)


def test_shard_sparse_fewer_rows_than_shards_raises():
    """``:530``: fewer rows than shards is a named error, not an IndexError;
    5 rows over 8 shards (3 padding rows) still shard, one row a rank."""
    X, _ = _sparse_data(5, 20)
    csr = CSRMatrix.from_scipy(X)
    m = BinMapper(max_bin=15).fit_csr(csr)
    with pytest.raises(ValueError, match="rows for"):
        shard_sparse_binned(csr, m, 16, row_pad=11, rank=0)
    for rank in range(8):
        sb, local = shard_sparse_binned(csr, m, 8, row_pad=3, rank=rank)
        assert local == 1 and sb.n == 1
        row = rank % 5
        assert sb.nnz == int(csr.indptr[row + 1] - csr.indptr[row])
