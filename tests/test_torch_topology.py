"""The port's topology module, the layout's parameter specs and the mesh dry
run, on the CPU, held to the JAX package's.

Carried over: ``tests/test_topology_scale.py:24-47`` and ``:115-139``
(``best_mesh_shape`` at pod scale and equal to the reference's for every n
up to 64 over 1-3 axes, ``make_mesh`` refusing a shape larger than the
world, ``cluster_info``, ``initialize_distributed`` doing nothing on one
host, retrying and exhausting with ``torch.distributed.init_process_group``
patched); ``tests/test_runtime.py:16-38``, ``:90`` and ``:408-427``
(``cluster_info`` and ``make_mesh`` over an 8-rank gloo world, the
reference's 8-device mesh; ``require_backend``); the layout's specs against
``tests/test_runtime.py:155``, ``:246``, ``:277`` and ``:328`` (each spec
entry for entry with the reference's ``PartitionSpec`` on the same mesh
shape; storage over fsdp and the gather on use giving the use block bit for
bit, at 1/(fsdp x model) of the bytes at rest; the ``state_dict`` round
trip and its degradation); and ``gbdt/engine.py::dryrun_train_step`` on a
2-rank world. The ranks run ``tests/torch_mesh.py``'s cases.
"""

import numpy as np
import pytest
import torch

from synapseml_tpu.runtime import topology as ref_topology
from synapseml_tpu.runtime.layout import SpecLayout as RefLayout

from synapseml_tpu_torch.runtime import topology
from tests.torch_mesh import MeshWorld
from tests.torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def world():
    w = MeshWorld(8)
    yield w
    w.close()


@pytest.fixture(scope="module")
def world2():
    w = MeshWorld(2)
    yield w
    w.close()


# -- best_mesh_shape, make_mesh, cluster_info ----------------------------------------------

def test_best_mesh_shape_pod_scales():
    assert topology.best_mesh_shape(64, 2) == (8, 8)
    assert topology.best_mesh_shape(256, 2) == (16, 16)
    assert topology.best_mesh_shape(256, 3) == (8, 8, 4)
    assert topology.best_mesh_shape(64, 3) == (4, 4, 4)
    assert topology.best_mesh_shape(12, 3) == (3, 2, 2)
    assert topology.best_mesh_shape(13, 2) == (13, 1)
    assert topology.best_mesh_shape(1, 2) == (1, 1)
    assert topology.best_mesh_shape(8, 3) == (2, 2, 2)
    assert topology.best_mesh_shape(7, 2) == (7, 1)


@pytest.mark.parametrize("axes", [1, 2, 3])
def test_best_mesh_shape_equals_the_reference(axes):
    for n in range(1, 65):
        shape = topology.best_mesh_shape(n, axes)
        assert shape == ref_topology.best_mesh_shape(n, axes), n
        assert int(np.prod(shape)) == n and shape == tuple(sorted(shape, reverse=True))


def test_make_mesh_too_many_devices_raises():
    with pytest.raises(ValueError, match="needs"):
        topology.make_mesh(("data",), shape=(10 ** 6,))


def test_cluster_info_without_a_process_group():
    info = topology.cluster_info()
    assert info.num_devices >= 1 and info.num_hosts == 1 and info.host_index == 0
    assert info.platform == "cpu" and info.local_num_devices == 0
    assert topology.device_kind() == "cpu"


def test_cluster_info_and_meshes_over_the_world(world):
    res = world.run("topology")
    for r, got in enumerate(res):
        info = got["info"]
        assert info.num_devices == 8 and info.num_hosts == 1 and info.host_index == 0
        assert info.platform == "cpu" and info.rank == r
        assert got["default_1d"] == {"data": 8}
        assert got["mesh_2d"] == {"data": 4, "model": 2}
        assert "needs 1000 devices, have 8" in got["too_big"]
        assert got["require_cpu_ok"] == "cpu" and "'cpu'" in got["refusal"]


# -- require_backend -----------------------------------------------------------------------

def test_require_backend_allow_cpu_passes_through():
    info = topology.require_backend(allow_cpu=True)
    assert info.platform == "cpu" and info.num_devices >= 1


def test_require_backend_refuses_cpu_with_diagnostic():
    with pytest.raises(RuntimeError) as ei:
        topology.require_backend()
    msg = str(ei.value)
    assert "'cpu'" in msg
    assert "CUDA_VISIBLE_DEVICES" in msg and "nvidia-smi" in msg and "allow_cpu" in msg


def test_require_backend_want_pins_platform():
    with pytest.raises(RuntimeError, match="gpu"):
        topology.require_backend(want="gpu")


# -- initialize_distributed ----------------------------------------------------------------

def test_initialize_distributed_single_host_noop(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: pytest.fail("must not rendezvous"))
    topology.initialize_distributed()


def test_initialize_distributed_retries(monkeypatch):
    calls = []

    def flaky_init(backend, init_method=None, world_size=None, rank=None):
        calls.append((backend, init_method, world_size, rank))
        if len(calls) < 3:
            raise RuntimeError("coordinator not up yet")

    monkeypatch.setattr(torch.distributed, "init_process_group", flaky_init)
    monkeypatch.setattr("time.sleep", lambda s: None)
    topology.initialize_distributed(coordinator_address="10.0.0.1:1234", num_processes=2,
                                    process_id=0, retries=5)
    assert len(calls) == 3   # failed twice, succeeded the third time
    assert calls[-1] == ("gloo", "tcp://10.0.0.1:1234", 2, 0)


def test_initialize_distributed_exhausts_retries(monkeypatch):
    def always_fail(*a, **kw):
        raise RuntimeError("unreachable coordinator")

    monkeypatch.setattr(torch.distributed, "init_process_group", always_fail)
    monkeypatch.setattr("time.sleep", lambda s: None)
    with pytest.raises(RuntimeError, match="unreachable"):
        topology.initialize_distributed(coordinator_address="10.0.0.1:1", num_processes=2,
                                        process_id=0, retries=2)


# -- the layout's parameter specs ------------------------------------------------------------

def _ref_layout(shape):
    if len(shape) == 3:
        return RefLayout.build(data=shape[0], fsdp=shape[1], model=shape[2])
    return RefLayout.build(data=shape[0], model=shape[1])


_SPEC_KEYS = {"batch": lambda L: L.batch(), "batch41": lambda L: L.batch(rank=4, dim=1),
              "replicated": lambda L: L.replicated(), "col": lambda L: L.col_weight(),
              "col20": lambda L: L.col_weight(rank=2, dim=0),
              "conv": lambda L: L.conv_weight(), "fsdp1": lambda L: L.fsdp_weight(rank=1),
              "fsdp_col": lambda L: L.fsdp_weight(rank=2, dim=0,
                                                  use_spec=L.col_weight(rank=2)),
              "embed": lambda L: L.embed_weight()}


@pytest.mark.parametrize("shape", [(4, 2), (2, 2, 2), (8, 1)])
def test_layout_specs_equal_the_reference(world, shape):
    from jax.sharding import PartitionSpec as P

    spec = ("fsdp",) + shape if len(shape) == 3 else ("build",) + shape
    got = world.run("layout_specs", layout=spec)
    ref = _ref_layout(shape)
    for r in got:
        for key, fn in _SPEC_KEYS.items():
            assert r[key] == tuple(fn(ref)), key
        assert r["fsdp_joint"] == tuple(ref.fsdp_weight(rank=2, dim=1,
                                                        use_spec=P(None, "model")))
        for key, use in r["use"].items():
            assert use == tuple(ref.use_spec(P(*r[key]))), key
        assert r["describe"] == ref.describe() and r["n_devices"] == ref.n_devices
        assert r["state_dict"] == ref.state_dict()
        assert r["round_trip_equal"]


def test_fsdp_storage_and_gather_for_use(world):
    """Stored row-sharded over fsdp (1/(fsdp x model) of the bytes at rest),
    gathered on use to each rank's use block bit for bit, and the product
    with the gathered columns is the replicated product."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(8, 8)).astype(np.float32)
    x = rng.normal(size=(4, 8)).astype(np.float32)
    res = world.run("layout_specs", layout=("fsdp", 2, 2, 2), w=w, x=x)
    for r in res:
        for key in ("fsdp_col", "fsdp_joint", "embed"):
            np.testing.assert_array_equal(r[f"{key}_used"], r[f"{key}_want"])
            assert r[f"{key}_local_bytes"] == w.nbytes // 4
        np.testing.assert_allclose(r["product"], x @ w, rtol=1e-6, atol=1e-6)
    # fsdp_col, fsdp_joint (fsdp and model), embed (fsdp and model), the product
    assert res[0]["collectives"] == {"gather:fsdp": 4, "gather:model": 3}


def test_layout_from_state_dict_degrades(world):
    res = world.run("layout_specs", layout=("fsdp", 2, 2, 2),
                    saved={"data_axis": "data", "model_axis": "model", "data": 4, "model": 2,
                           "fsdp_axis": "fsdp", "fsdp": 2})
    assert all(r["rebuilt"] == {"data": 2, "fsdp": 2, "model": 2} for r in res)
    res = world.run("layout_specs", layout=("build", 4, 2),
                    saved={"data_axis": "data", "model_axis": "model", "data": 16,
                           "model": 4})
    assert all(r["rebuilt"] == {"data": 2, "model": 4} for r in res)


# -- the mesh dry run -------------------------------------------------------------------------

def test_dryrun_train_step_two_ranks(world2):
    res = world2.run("dryrun", layout=("build", 2, 1))
    b0 = res[0]["booster"]
    for r in res[1:]:
        for key in ("parent", "feature", "bin", "leaf_value"):
            np.testing.assert_array_equal(r["booster"][key], b0[key])
    assert res[0]["collectives"].get("sum:data", 0) > 0
