"""Multi-host execution: process initialisation + data-parallel streaming.

The reference is single-process/single-GPU (SURVEY.md §2); the scaling
story (SURVEY.md §5 distributed row) is:

  * within a host: spatial tiling + replicated cluster tables —
    parallel/sharding.py, parallel/stencil_shard.py;
  * across hosts: frames are embarrassingly parallel, so the batch
    axis spans processes.  Each process feeds its local shard of every
    global batch; collectives only materialise for metrics reductions.

`initialize()` wires jax.distributed from standard env vars; `global_mesh()`
builds the ('data', 'x') mesh over ALL devices (local + remote);
`local_batch_to_global` forms a globally-sharded batch from per-host arrays
(jax.make_array_from_process_local_data), which is the multi-host analog of
models/streaming.py's per-chunk device put.

All of it degrades gracefully to a single process (the only thing this
repo's CI can execute — a real multi-host run needs N processes launched with
coordinator env vars, which the test suite fakes with the 8-virtual-device
CPU mesh).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kinectdepthmapenhancement_tpu.parallel.mesh import make_mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """jax.distributed.initialize from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).  Returns
    True if a multi-process runtime was initialised, False for the
    single-process fallback (no env, no args)."""
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if not coordinator_address or num_processes in (None, 1):
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def global_mesh(spatial: int = 1) -> Mesh:
    """('data', 'x') mesh over every device in the job (all processes)."""
    return make_mesh(len(jax.devices()), spatial=spatial)


def local_batch_to_global(
    mesh: Mesh, arrays: Sequence[np.ndarray], extra_dims: int = 0
):
    """Assemble per-process frame stacks into one globally data-sharded
    array.  `arrays` is this process's local list of [H, W, ...] frames; the
    global batch is num_processes * len(arrays).  Single-process: a plain
    device_put with the batch sharding."""
    local = np.stack(arrays)
    spec = P("data", *([None] * (local.ndim - 1)))
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(local, sharding)
    return jax.make_array_from_process_local_data(sharding, local)
