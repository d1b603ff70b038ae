"""Data-parallel scaling-efficiency benchmark of batched KDE (BASELINE.md
north star: >=80% multi-host scaling).

Measures batched KDE throughput over meshes of 1, 2, 4, ... N devices (batch
axis 'data'; one frame per device per dispatch) with unique inputs per timed
call, and reports efficiency vs the 1-device rate.

Usage: python scripts/scaling_bench.py             # 640x480 on the GPUs
       python scripts/scaling_bench.py --small [--cpu N]
       python scripts/scaling_bench.py --pod [--ref-fps R] [--small]

Without --small it needs GPUs and runs 640x480.  --small runs 96x128 with a
3x4 grid; with --cpu N on N virtual CPU devices (default 8), which share one
socket, so the numbers check partitioning and collective placement only.

--pod: the multi-process aggregate-throughput mode.  Every host runs the
same command with JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES /
JAX_PROCESS_ID set (parallel/multihost.py); process 0 prints one line with
aggregate fps, per-GPU fps and efficiency vs the per-GPU reference rate R
(default: the north star's 125 fps per GPU).  Works single-process too (the
CPU-mesh dry run: `--pod --cpu 8 --small`).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

N = 8
if "--cpu" in sys.argv:
    i = sys.argv.index("--cpu")
    if i + 1 < len(sys.argv) and sys.argv[i + 1].isdigit():
        N = int(sys.argv[i + 1])
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={N}"
        ).strip()

import jax

from kinectdepthmapenhancement_tpu.core import device

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")
SMALL = "--small" in sys.argv

import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics
from kinectdepthmapenhancement_tpu.core.config import GridParams, KDEConfig
from kinectdepthmapenhancement_tpu.models.pipelines import kde_pipeline
from kinectdepthmapenhancement_tpu.parallel import multihost
from kinectdepthmapenhancement_tpu.parallel.mesh import make_mesh


def _setup() -> bool:
    """The multi-process runtime first (it must precede any device use),
    then the GPU check (unless --small) and the compile cache.  Returns
    whether a multi-process runtime was initialised."""
    dist = multihost.initialize()
    if not SMALL:
        device.require_gpu()
    device.enable_compile_cache()
    return dist


def pod_main() -> None:
    """--pod: one aggregate-throughput measurement over ALL devices of a
    multi-process job.  Every host runs this same command; process 0 prints
    the BASELINE-comparable line.

    Efficiency is aggregate fps / (n_devices * per-GPU reference rate); pass
    the measured single-GPU device rate via --ref-fps (e.g. the bench.py
    headline), else the north star's 125 fps per GPU pro-rata target is used.
    """
    dist = _setup()
    mesh = multihost.global_mesh(spatial=1)
    n_dev = len(jax.devices())
    n_local = len(jax.local_devices())
    h, w = (96, 128) if SMALL else (480, 640)
    intr = default_kinect_intrinsics(w, h)
    cfg = KDEConfig(grid=GridParams(rows=3, cols=4)) if SMALL else KDEConfig()
    ref_fps = (
        float(sys.argv[sys.argv.index("--ref-fps") + 1])
        if "--ref-fps" in sys.argv
        else 125.0
    )
    pid = jax.process_index()
    if pid == 0:
        print(
            f"pod run: backend={jax.default_backend()} processes="
            f"{jax.process_count()} devices={n_dev} (local {n_local}) "
            f"frame={h}x{w} distributed={dist}",
            flush=True,
        )

    sh_c = NamedSharding(mesh, P("data", None, None, None))
    rng = np.random.default_rng(1234 + pid)
    color = multihost.local_batch_to_global(
        mesh,
        [
            rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
            for _ in range(n_local)
        ],
    )

    # replicated scalar out: consuming it synchronises every process without
    # gathering the [N, H, W, 3] output (which is not fully addressable here)
    step = jax.jit(
        lambda d, c: jnp.sum(
            jax.vmap(lambda dd, cc: kde_pipeline(dd, cc, intr, cfg).optimized_points)(
                d, c
            )
        )
        * 1e-30,
        in_shardings=(NamedSharding(mesh, P("data", None, None)), sh_c),
        out_shardings=NamedSharding(mesh, P()),
    )

    def batch(i):
        r = np.random.default_rng(100 * i + pid)
        return multihost.local_batch_to_global(
            mesh,
            [
                r.uniform(500.0, 4000.0, (h, w)).astype(np.float32)
                for _ in range(n_local)
            ],
        )

    float(step(batch(0), color))  # compile + warm (collective-synchronised)
    times = []
    for i in range(1, 6):
        d = jax.block_until_ready(batch(i))
        t0 = time.perf_counter()
        float(step(d, color))
        times.append(time.perf_counter() - t0)
    dt = float(np.median(times))
    fps = n_dev / dt
    eff = fps / (ref_fps * n_dev)
    if pid == 0:
        print(
            f"devices={n_dev:4d}  batch_time={dt*1e3:8.2f} ms  "
            f"aggregate_fps={fps:9.2f}  per_gpu={fps/n_dev:7.2f}  "
            f"efficiency_vs_{ref_fps:.0f}fps_gpu={eff*100:6.1f}%",
            flush=True,
        )


def main() -> None:
    _setup()
    n_dev = len(jax.devices())
    h, w = (96, 128) if SMALL else (480, 640)
    intr = default_kinect_intrinsics(w, h)
    cfg = (
        KDEConfig(grid=GridParams(rows=3, cols=4)) if SMALL else KDEConfig()
    )
    print(f"backend={jax.default_backend()} devices={n_dev} frame={h}x{w}", flush=True)

    rng = np.random.default_rng(0)
    base_fps = None
    widths = [x for x in (1, 2, 4, 8, 16, 32) if x <= n_dev]
    for n in widths:
        mesh = make_mesh(n, spatial=1)
        sh_d = NamedSharding(mesh, P("data", None, None))
        sh_c = NamedSharding(mesh, P("data", None, None, None))

        step = jax.jit(
            jax.vmap(lambda d, c: kde_pipeline(d, c, intr, cfg).optimized_points),
            in_shardings=(sh_d, sh_c),
            out_shardings=NamedSharding(mesh, P("data", None, None, None)),
        )

        color = jax.device_put(
            rng.integers(0, 255, (n, h, w, 3), dtype=np.uint8), sh_c
        )

        def batch(_):
            return jax.device_put(
                rng.uniform(500.0, 4000.0, (n, h, w)).astype(np.float32), sh_d
            )

        out = step(batch(0), color)  # compile + warm
        jax.block_until_ready(out)
        times = []
        for i in range(5):
            d = jax.block_until_ready(batch(i))
            t0 = time.perf_counter()
            r = step(d, color)
            float(jnp.sum(r))  # readback forces completion
            times.append(time.perf_counter() - t0)
        dt = float(np.median(times))
        fps = n / dt
        if base_fps is None:
            base_fps = fps
        eff = fps / (base_fps * n)
        print(
            f"data={n:3d}  batch_time={dt*1e3:8.2f} ms  fps={fps:8.2f}  "
            f"efficiency={eff*100:6.1f}%",
            flush=True,
        )


if __name__ == "__main__":
    if "--pod" in sys.argv:
        pod_main()
    else:
        main()
