"""Worker process for the REAL 2-process jax.distributed test.

Launched by tests/test_multihost.py::test_two_process_distributed_run as
`python tests/multihost_worker.py <port> <process_id> <num_processes>`.
Each process initialises the distributed runtime against a real coordinator
(process 0 hosts it), forms the global ('data', 'x') mesh over both
processes' CPU devices, contributes one locally-distinct frame via
local_batch_to_global, and computes a globally-reduced metric — the first
code path in this repo where jax.distributed.initialize and a cross-process
collective actually execute (SURVEY.md §5 distributed row; the rest of the
suite runs single-process on a virtual device mesh).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    port, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

    import jax

    jax.config.update("jax_platforms", "cpu")
    # cross-process CPU collectives need the gloo transport
    jax.config.update("jax_cpu_collectives_implementation", "gloo")

    import numpy as np

    from kinectdepthmapenhancement_tpu.parallel import multihost

    ok = multihost.initialize(f"127.0.0.1:{port}", nproc, pid)
    assert ok, "multihost.initialize took the single-process fallback"
    assert jax.process_count() == nproc, jax.process_count()

    mesh = multihost.global_mesh()
    frame = np.full((8, 16), float(pid + 1), np.float32)
    batch = multihost.local_batch_to_global(mesh, [frame])
    assert batch.shape == (nproc, 8, 16), batch.shape

    import jax.numpy as jnp

    # mean over the globally-sharded batch: GSPMD inserts the cross-process
    # all-reduce; the result is replicated to every process
    mean = jax.jit(jnp.mean, out_shardings=None)(batch)
    want = sum(range(1, nproc + 1)) / nproc
    np.testing.assert_allclose(np.asarray(mean), want, rtol=1e-6)
    print(
        f"proc {pid} ok: processes={jax.process_count()} "
        f"global_devices={len(jax.devices())} mean={float(mean):.3f}",
        flush=True,
    )


if __name__ == "__main__":
    main()
