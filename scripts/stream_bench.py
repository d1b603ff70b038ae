"""Sustained streaming throughput on a GPU: push a couple hundred sensor-model
frames through models/streaming.py::run_stream in chunked dispatches and
record end-to-end wall-clock fps — the serving number that includes host to
device uploads, per-dispatch host overhead, the temporal-buffer fold, and the
per-chunk metric readback (vs the device-only rate of scripts/measure_kde.py).

Usage: python scripts/stream_bench.py [--frames 200] [--batch 8] [--kde-only]
       [--prestage]

--kde-only measures the pure serving path (no capture fold / pseudo-GT
metric): every frame is enhanced and consumed on device, one ~8 B checksum
readback per chunk.

--prestage uploads every chunk to the device BEFORE the timed loop and then
runs the same pipelined chunk executable + deferred-readback protocol as
run_stream, so the two numbers separate the upload cost from the serving
loop's own.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from kinectdepthmapenhancement_tpu.core import device

device.require_gpu()
device.enable_compile_cache()

import numpy as np


def main() -> None:
    n_frames = (
        int(sys.argv[sys.argv.index("--frames") + 1])
        if "--frames" in sys.argv
        else 200
    )
    batch = (
        int(sys.argv[sys.argv.index("--batch") + 1]) if "--batch" in sys.argv else 8
    )

    from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics
    from kinectdepthmapenhancement_tpu.core.datasets import kinect_v1_sensor_model
    from kinectdepthmapenhancement_tpu.core.testdata import make_far_scene
    from kinectdepthmapenhancement_tpu.models import streaming

    n_frames -= n_frames % batch  # a tail chunk would compile mid-benchmark
    h, w = 480, 640
    intr = default_kinect_intrinsics(w, h)
    color, gt = make_far_scene(h, w, intr, seed=0)
    rng = np.random.default_rng(0)
    # pre-generate every frame: the bench times the PIPELINE, not the host
    # sensor simulator; each frame is distinct (fresh noise)
    frames = [kinect_v1_sensor_model(gt, rng) for _ in range(n_frames)]

    kde_only = "--kde-only" in sys.argv

    if "--prestage" in sys.argv:
        import jax
        import jax.numpy as jnp

        from kinectdepthmapenhancement_tpu.core import buffer2d
        from kinectdepthmapenhancement_tpu.core.config import KDEConfig

        h, w = color.shape[:2]
        step = streaming._chunk_step(intr, KDEConfig(), kde_only)
        c = jnp.asarray(color)
        chunks = [
            jax.block_until_ready(jnp.asarray(np.stack(frames[i : i + batch])))
            for i in range(0, n_frames, batch)
        ]
        buf = buffer2d.init(h, w)
        buf, _, s, n = step(buf, chunks[0], c)  # compile + warm
        float(s)

        buf = buffer2d.init(h, w)
        inflight = []
        t0 = time.perf_counter()
        for ch in chunks:
            buf, _, s, n = step(buf, ch, c)
            inflight.append(s)
            while len(inflight) > 1:
                float(inflight.pop(0))
        while inflight:
            float(inflight.pop(0))
        dt = time.perf_counter() - t0
        tag = "kde-only" if kde_only else "capture-protocol"
        print(
            f"streamed {n_frames} frames in {dt:.2f}s "
            f"(batch={batch}, {tag}, prestaged): "
            f"{n_frames/dt:.1f} fps sustained"
        )
        return

    # warm-up chunk compiles outside the timed window
    streaming.run_stream(
        iter(frames[: batch * 2]), color, intr, batch=batch, kde_only=kde_only
    )

    t0 = time.perf_counter()
    state = streaming.run_stream(
        iter(frames), color, intr, batch=batch, kde_only=kde_only
    )
    dt = time.perf_counter() - t0
    fps = n_frames / dt
    tag = "kde-only" if kde_only else "capture-protocol"
    extra = (
        ""
        if kde_only
        else f"; mean kde error {streaming.mean_metric(state, 'kde_error_mm'):.3f} mm"
    )
    print(
        f"streamed {state.frame_index} frames in {dt:.2f}s "
        f"(batch={batch}, {tag}): {fps:.1f} fps sustained{extra}"
    )


if __name__ == "__main__":
    main()
