"""Port parity, `singa_tpu_torch.distributed` (tests/test_distributed.py):
the process queries, `global_mesh`, `global_batch` and `init`'s
environment fallbacks, in this process without a process group (rank 0
of 1, as the JAX package's single process) and across gloo ranks in
fresh interpreters (`torch_dist_worker.run_job`): `topology`,
`host_label`, `resume_mesh` and the meshes' groups over a 4-rank job,
`init` from SINGA_COORDINATOR / SINGA_NPROCS / SINGA_PROC_ID over a free
TCP port in a 2-rank job. No process group is initialized in this
process.

Known differences: `global_batch` returns the whole batch on the rank's
device (JAX's assembles a sharded global array), and the mesh and batch
checks raise ValueError where JAX asserts."""

import socket

import numpy as np
import pytest
import torch

import jax

from singa_tpu import distributed as jdistributed
from singa_tpu_torch import distributed
from torch_dist_worker import run_job

WORLD = 4


def test_process_queries_single_process():
    assert distributed.process_index() == jdistributed.process_index() == 0
    assert distributed.process_count() == jdistributed.process_count() == 1
    assert not torch.distributed.is_initialized()
    assert distributed.topology() == {"n_devices": 1, "n_processes": 1,
                                      "process_index": 0}
    assert distributed.host_label() == jdistributed.host_label() == "host0"


def test_global_mesh_default_and_shaped():
    mesh = distributed.global_mesh()
    assert dict(mesh.shape) == {"data": 1} and mesh.size == 1
    assert mesh.device_mesh is None and mesh.group("data") is None
    assert dict(distributed.global_mesh({"data": 1, "model": 1}).shape) \
        == {"data": 1, "model": 1}
    # the JAX package's mesh spans its 8 virtual devices instead
    assert jdistributed.global_mesh().shape["data"] == len(jax.devices())


def test_global_mesh_bad_size_raises():
    with pytest.raises(ValueError, match="mesh wants 3 devices, slice has 1"):
        distributed.global_mesh({"data": 3})
    with pytest.raises(AssertionError, match="devices"):
        jdistributed.global_mesh({"data": 3})


def test_global_batch_sharding():
    mesh = distributed.global_mesh()
    host = np.arange(8 * 2, dtype=np.float32).reshape(8, 2)
    arr = distributed.global_batch(host, mesh)
    assert torch.is_tensor(arr) and arr.device.type == "cpu"
    np.testing.assert_array_equal(arr.numpy(), host)
    jarr = jdistributed.global_batch(host, jdistributed.global_mesh())
    np.testing.assert_array_equal(np.asarray(jarr), arr.numpy())


def test_global_batch_indivisible_raises():
    """The axis size must divide the batch, with JAX's message."""
    mesh = distributed.global_mesh()

    class Four:     # a mesh whose data axis is 4 (the check reads shape)
        shape = {"data": 4}
        device = mesh.device

    bad = np.zeros((4 * 4 + 1, 2), np.float32)
    with pytest.raises(ValueError, match="they must divide the global "
                                         "batch of 17"):
        distributed.global_batch(bad, Four())


def test_init_without_card_or_cpu_raises():
    """NCCL needs the card: no quiet fallback to gloo."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed.init(coordinator_address="127.0.0.1:1",
                         num_processes=1, process_id=0)
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="device="):
        distributed.init(device="tpu")


@pytest.fixture(scope="module")
def topo(tmp_path_factory):
    return run_job("topo", WORLD, tmp_path_factory.mktemp("topo"))


@pytest.mark.parametrize("rank", range(WORLD))
def test_topology_and_host_label(topo, rank):
    r = topo[rank]
    assert int(r["index"]) == rank and int(r["count"]) == WORLD
    assert r["topology"].tolist() == [WORLD, WORLD, rank]
    assert str(r["host"]) == f"host{rank}"


def test_global_mesh_over_ranks(topo):
    for rank, r in enumerate(topo):
        assert r["gm"].tolist() == [WORLD, WORLD]
        assert r["gm2_names"].tolist() == ["data", "model"]
        assert r["gm2_sizes"].tolist() == [2, 2]
        # the last axis innermost: ranks (0, 1) share a "model" group
        assert r["gm2_coord"].tolist() == [rank // 2, rank % 2]
        assert r["gm2_model_sum"].tolist() == [4 * (rank // 2) + 1]
        assert r["gm2_both_sum"].tolist() == [6.0]
        assert int(r["gm2_both_rank"]) == rank
        assert "mesh wants 3 devices, slice has 4" in str(r["bad"])


def test_global_batch_over_ranks(topo):
    host = np.arange(WORLD * 4 * 2, dtype=np.float32).reshape(WORLD * 4, 2)
    for r in topo:
        np.testing.assert_array_equal(r["batch"], host)
        assert "4 shards; they must divide the global batch of 17" in \
            str(r["bad_batch"])


def test_resume_mesh(topo):
    """The first n ranks, a subgroup every rank created."""
    for rank, r in enumerate(topo):
        assert bool(r["resume_member"]) == (rank < 2)
        assert r["resume_shape"].tolist() == [2]
        if rank < 2:
            assert r["resume_sum"].tolist() == [3.0]
        assert f"resume_mesh wants {WORLD + 1} devices, only {WORLD}" in \
            str(r["resume_bad"])


def test_init_env_fallbacks(tmp_path):
    """init() reads SINGA_COORDINATOR, SINGA_NPROCS and SINGA_PROC_ID
    (a free localhost port: the one job here that does not rendezvous
    through a file), and is idempotent."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    got = run_job("env", 2, tmp_path, store="env",
                  env={"SINGA_COORDINATOR": f"127.0.0.1:{port}",
                       "SINGA_NPROCS": 2, "SINGA_PROC_ID": lambda r: r})
    for rank, r in enumerate(got):
        assert int(r["index"]) == rank and int(r["count"]) == 2
        assert str(r["backend"]) == "gloo"
        assert r["sum"].tolist() == [3.0]
