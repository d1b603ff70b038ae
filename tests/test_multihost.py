"""parallel/multihost.py coverage:
initialize() env parsing incl. the single-process fallback, global_mesh
shape, and local_batch_to_global's single-process sharded device put."""

import numpy as np
import jax
import pytest
from jax.sharding import PartitionSpec as P

from kinectdepthmapenhancement_tpu.parallel import multihost

requires_8 = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)


def test_initialize_no_env_is_single_process(monkeypatch):
    for var in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False


def test_initialize_num_processes_one_is_single_process(monkeypatch):
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.setenv("JAX_PROCESS_ID", "0")
    assert multihost.initialize() is False


def test_initialize_env_parsed_and_forwarded(monkeypatch):
    calls = {}

    def fake_init(coordinator_address, num_processes, process_id):
        calls.update(
            addr=coordinator_address, n=num_processes, pid=process_id
        )

    monkeypatch.setattr(jax.distributed, "initialize", fake_init)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "10.0.0.1:8476")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "4")
    monkeypatch.setenv("JAX_PROCESS_ID", "2")
    assert multihost.initialize() is True
    assert calls == {"addr": "10.0.0.1:8476", "n": 4, "pid": 2}


def test_initialize_args_override_env(monkeypatch):
    calls = {}

    def fake_init(coordinator_address, num_processes, process_id):
        calls.update(
            addr=coordinator_address, n=num_processes, pid=process_id
        )

    monkeypatch.setattr(jax.distributed, "initialize", fake_init)
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "ignored:1")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "8")
    monkeypatch.setenv("JAX_PROCESS_ID", "7")
    assert multihost.initialize("10.1.1.1:9", 2, 1) is True
    assert calls == {"addr": "10.1.1.1:9", "n": 2, "pid": 1}


@requires_8
def test_global_mesh_shape():
    mesh = multihost.global_mesh(spatial=2)
    assert mesh.axis_names == ("data", "x")
    assert mesh.devices.shape == (jax.device_count() // 2, 2)


@requires_8
def test_local_batch_to_global_single_process():
    mesh = multihost.global_mesh()
    frames = [np.full((6, 8), float(i), np.float32) for i in range(8)]
    arr = multihost.local_batch_to_global(mesh, frames)
    assert arr.shape == (8, 6, 8)
    assert arr.sharding.spec == P("data", None, None)
    # each device holds exactly one frame of the batch
    assert {s.data.shape for s in arr.addressable_shards} == {(1, 6, 8)}
    np.testing.assert_array_equal(
        np.asarray(arr), np.stack(frames)
    )


def test_two_process_distributed_run():
    """An ACTUAL multi-process run — two subprocesses, a real
    coordinator, gloo CPU collectives, a cross-process mean — not a
    monkeypatched initialize.  See tests/multihost_worker.py."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:  # free port for the coordinator
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "multihost_worker.py")
    env = dict(os.environ)
    # the workers pick their own platform/device config in-process
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(port), str(pid), "2"],
            cwd=root,
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} ok: processes=2" in out, out
