"""The port's VW learner over a mesh on the CPU: ``train_linear(..., mesh=)``
in a gloo world (``tests/torch_mesh.py``).

Each data rank passes over its block of rows and the state is averaged at
every pass end (an all-reduce sum of ``w``, ``g2``, ``b``, ``bg2`` over the
data axis, divided by its size, and an all-reduce max of the scales), so:
- ``tests/test_vw.py``'s ``test_linear_learner_distributed`` (8 ranks, 40
  passes, R^2 above 0.85) holds for the port;
- a raw 1-D ``DeviceMesh`` and ``SpecLayout.build(data=8, model=1)`` give
  the same state bit for bit, and every rank holds rank 0's state;
- a (1, 1) layout in a one-rank world gives the meshless fit bit for bit;
- the state is the reference's 8-device fit within ``MESH_TOL``: the
  single-device causes (``test_torch_vw.py``), and the order of the
  all-reduce's sum of eight states (gloo's ring against XLA's);
- with an fsdp axis, ``(data=4, fsdp=2)`` gives the replicated ``(data=4,
  model=2)`` fit bit for bit, with one all-gather over fsdp a pass, and
  between passes a rank holds at most ``1 / fsdp`` of the 2^b vectors plus
  the padding of the last slice and the bias pair.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from synapseml_tpu.vw import learner as ref

from synapseml_tpu_torch.tools.kernel_cases import vw_state_differs
from synapseml_tpu_torch.vw.learner import LinearLearnerState, predict_linear, train_linear
from tests.torch_mesh import MeshWorld
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)

EIGHT = ("build", 8, 1)
RAW_EIGHT = ("raw", (8,), ("data",))
FSDP = ("fsdp", 4, 2, 1)
REPLICATED = ("build", 4, 2)
# relative to max(1, |reference|); on these inputs the largest is 4.2e-7
MESH_TOL = 1e-5


@pytest.fixture(scope="module")
def world():
    w = MeshWorld(8)
    yield w
    w.close()


def _rows(seed, n, K=4, bits=10, pad=False):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 1 << bits, size=(n, K)).astype(np.int32)
    val = rng.normal(size=(n, K)).astype(np.float32)
    if pad:
        past = np.arange(K)[None, :] >= rng.integers(1, K + 1, size=n)[:, None]
        idx[past], val[past] = 0, 0.0
    w_true = rng.normal(size=1 << bits).astype(np.float32)
    return idx, val, (np.take(w_true, idx) * val).sum(1)


def _state(d) -> LinearLearnerState:
    return LinearLearnerState(**{k: np.asarray(v) for k, v in d.items()})


def _fit(world, layout, idx, val, y, **kw):
    """Rank 0's (state, collectives, record), after checking that every rank
    holds the same state."""
    res = world.run("vw_fit", layout=layout, idx=idx, val=val, y=y, **kw)
    first = _state(res[0]["state"])
    for r in res[1:]:
        assert not vw_state_differs(_state(r["state"]), first)
    return first, res[0]["collectives"], res[0]["stats"]


def test_linear_learner_distributed(world):
    """``tests/test_vw.py:129``: parameter averaging over 8 ranks still fits."""
    idx, val, y = _rows(3, 2048)
    st, coll, _ = _fit(world, RAW_EIGHT, idx, val, y, num_bits=10, num_passes=40,
                       batch_size=64)
    p = predict_linear(st, idx, val)
    assert 1 - np.var(y - p) / np.var(y) > 0.85
    assert coll == {"sum:data": 40, "max:data": 40}


@pytest.mark.parametrize("loss,l2", [("squared", 0.0), ("logistic", 1e-2)])
def test_layout_matches_raw_mesh_and_reference(world, loss, l2):
    """``tests/test_vw.py:147``: a raw 1-D DeviceMesh and the layout give the
    same state bit for bit (every rank alike); both are the reference's
    8-device fit within MESH_TOL."""
    idx, val, y = _rows(4, 1100, K=5, pad=True)
    if loss == "logistic":
        y = np.where(y > 0, 1.0, -1.0)
    kw = dict(num_bits=10, num_passes=3, loss=loss, l2=l2)
    st_raw, _, _ = _fit(world, RAW_EIGHT, idx, val, y, **kw)
    st_lay, coll, rec = _fit(world, EIGHT, idx, val, y, **kw)
    assert not vw_state_differs(st_lay, st_raw)
    assert coll == {"sum:data": 3, "max:data": 3}
    assert rec["batches_a_pass"] == 1   # ceil(1100 / 8) = 138 rows a rank
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))
    want = ref.train_linear(idx, val, y, mesh=mesh, **kw)
    for f, a, b in zip(st_lay._fields, want, st_lay):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        err = float((np.abs(a - b) / np.maximum(1.0, np.abs(a))).max())
        assert err <= MESH_TOL, (f, err)


def test_single_rank_layout_matches_no_mesh():
    """``tests/test_vw.py:167``: a (1, 1) layout in a one-rank world gives the
    meshless state bit for bit."""
    idx, val, y = _rows(5, 512)
    w = MeshWorld(1)
    try:
        st, coll, _ = _fit(w, ("build", 1, 1), idx, val, y, num_bits=10, num_passes=2)
    finally:
        w.close()
    assert not vw_state_differs(st, train_linear(idx, val, y, num_bits=10, num_passes=2,
                                                 device="cpu"))
    assert coll == {"sum:data": 2, "max:data": 2}


@pytest.mark.parametrize("l1", [0.0, 1e-3])
def test_fsdp_storage_matches_replicated(world, l1):
    """(data=4, fsdp=2) against (data=4, model=2): the same state bit for bit,
    one all-gather over fsdp a pass, and at rest between passes at most
    1/fsdp of the three 2^b vectors (plus the last slice's padding and the
    bias pair) on a rank."""
    bits = 11
    idx, val, y = _rows(6, 1500, K=5, bits=bits, pad=True)
    kw = dict(num_bits=bits, num_passes=3, l1=l1)
    st_f, coll_f, rec_f = _fit(world, FSDP, idx, val, y, **kw)
    st_r, coll_r, rec_r = _fit(world, REPLICATED, idx, val, y, **kw)
    assert not vw_state_differs(st_f, st_r)
    assert coll_f == {"gather:fsdp": 3, "sum:data": 3, "max:data": 3}
    assert coll_r == {"sum:data": 3, "max:data": 3}
    full = 3 * (1 << bits) * 4
    assert rec_r["at_rest_bytes"] == [full + 8] * 3
    assert all(b <= full / 2 + 8 for b in rec_f["at_rest_bytes"])


def test_estimator_passes_mesh(world):
    """The estimators take ``mesh`` (a layout or a raw DeviceMesh) through to
    the learner: the regressor's state on the mesh is train_linear's."""
    idx, val, y = _rows(7, 900)
    col = np.empty(len(y), dtype=object)
    for r in range(len(y)):
        col[r] = (idx[r].astype(np.uint32), val[r])
    res = world.run("vw_estimator", layout=RAW_EIGHT, col=col, y=y, num_bits=10,
                    num_passes=2)
    for r in res[1:]:
        assert not vw_state_differs(_state(r), _state(res[0]))
    st, _, _ = _fit(world, EIGHT, idx, val, y, num_bits=10, num_passes=2)
    assert not vw_state_differs(_state(res[0]), st)
