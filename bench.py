"""KDE ("PROPOSED") pipeline benchmark at 640x480 on one GPU; prints ONE JSON line.

Usage: python bench.py [--quick]

Headline value = steady-state device time per frame, measured by chaining K
data-dependent pipeline iterations inside ONE executable and differencing two
K values, so per-dispatch host overhead and input uploads cancel.  Every
chained iteration consumes a perturbation of the previous output, so nothing
can be cached or folded away.  Dispatch-inclusive batched throughput
(batches {1, 4, 16, 32}, or 1 alone with --quick) and single-dispatch latency
are secondary fields.  The flop and byte counts are XLA's cost model of the
single-frame executable, divided by the card's published peaks (PEAKS).

Every program is compiled up front, concurrently in threads (each XLA GPU
compile of the unrolled pipeline takes minutes); `compile_s` reports each.
The line names the device (platform, kind, count) and the card's name and
power limit from nvidia-smi.  Any device but a GPU is refused.
"""

import concurrent.futures
import json
import sys
import time

H, W = 480, 640

# device_kind -> (bf16 dense FLOP/s, f32 non-tensor-core FLOP/s, HBM bytes/s)
PEAKS = {
    # NVIDIA H100 SXM data sheet, dense rates without sparsity at 700 W
    "NVIDIA H100 80GB HBM3": (989e12, 67e12, 3.35e12),
}


def peak_rates(kind: str):
    """Published peaks of a device kind; an unknown kind is an error."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for device kind {kind!r}")
    return PEAKS[kind]


def _compile(jitted, *args):
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    return compiled, time.perf_counter() - t0


def main() -> None:
    from kinectdepthmapenhancement_tpu.core import device

    dev = device.require_gpu()
    _, peak_f32, peak_bytes = peak_rates(dev.device_kind)
    device.enable_compile_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np

    from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics
    from kinectdepthmapenhancement_tpu.core.config import KDEConfig
    from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu.models.pipelines import kde_pipeline
    from kinectdepthmapenhancement_tpu.utils.timing import time_pipeline

    h, w = H, W
    intr = default_kinect_intrinsics(w, h)
    color, depth, _ = make_noisy_scene(h, w, intr, seed=0)
    cfg = KDEConfig()
    c = jnp.asarray(color)
    d0 = jnp.asarray(depth)

    def points(d, c_):
        return kde_pipeline(d, c_, intr, cfg).optimized_points

    # steady-state device time: chain k data-dependent pipeline applications
    # inside one executable (k is a runtime argument, so one program serves
    # both chain lengths); per frame = (t_hi - t_lo) / (hi - lo)
    def chained(d, k):
        def body(_, dd):
            s = jnp.sum(points(dd, c).astype(jnp.float32)) * 1e-30
            return d0 + s.astype(d0.dtype)  # fresh, data-dependent next frame

        return jnp.sum(jax.lax.fori_loop(0, k, body, d))

    widths = (1,) if "--quick" in sys.argv else (1, 4, 16, 32)
    programs = {
        "frame": (jax.jit(points), (d0, c)),
        "chain": (jax.jit(chained), (d0, 3)),
    }
    for b in widths:
        programs[f"batch{b}"] = (
            jax.jit(lambda d, c_: jnp.sum(jax.vmap(lambda dd: points(dd, c_))(d))),
            (jnp.zeros((b, h, w), jnp.float32), c),
        )
    with concurrent.futures.ThreadPoolExecutor(len(programs)) as pool:
        futures = {
            name: pool.submit(_compile, fn, *args)
            for name, (fn, args) in programs.items()
        }
        compiled = {name: f.result()[0] for name, f in futures.items()}
        compile_s = {name: f.result()[1] for name, f in futures.items()}

    # dispatch-inclusive throughput: a batch of distinct frames per dispatch
    def batched_fps(batch: int, iters: int = 5) -> float:
        def make_args(i):
            rng = np.random.default_rng(1000 + i)
            d = depth[None] + rng.normal(0, 4.0, (batch, h, w)).astype(np.float32)
            return (jnp.asarray(d), c)

        stats = time_pipeline(compiled[f"batch{batch}"], make_args, iters=iters)
        return batch / stats["median_s"]

    batch_sweep = {b: batched_fps(b) for b in widths}

    chain = compiled["chain"]
    lo_k, hi_k = 3, 9
    float(chain(d0, lo_k)), float(chain(d0, hi_k))  # warm
    spans = []
    for _ in range(3):
        t0 = time.perf_counter(); float(chain(d0, lo_k)); t_lo = time.perf_counter() - t0
        t0 = time.perf_counter(); float(chain(d0, hi_k)); t_hi = time.perf_counter() - t0
        spans.append((t_hi - t_lo) / (hi_k - lo_k))
    per_frame = float(np.median(spans))

    def make_args1(i):
        rng = np.random.default_rng(2000 + i)
        d = depth + rng.normal(0, 4.0, (h, w)).astype(np.float32)
        return (jnp.asarray(d), c)

    frame = compiled["frame"]
    lat = time_pipeline(lambda d, c_: jnp.sum(frame(d, c_)), make_args1, iters=5)

    ca = frame.cost_analysis()
    if isinstance(ca, list):
        ca = ca[0]
    flops = float(ca["flops"])
    cost_bytes = float(ca["bytes accessed"])

    print(
        json.dumps(
            {
                "metric": "kde_pipeline_fps_640x480",
                "value": 1.0 / per_frame,
                "unit": "frames/s",
                "device": device.device_info(),
                "gpu_name_power_limit": device.gpu_name_and_power_limit(),
                "device_frame_ms": per_frame * 1e3,
                "dispatch_inclusive_fps_by_batch": batch_sweep,
                "single_dispatch_latency_ms": lat["median_s"] * 1e3,
                "compile_s": compile_s,
                "cost_model_gflops_per_frame": flops / 1e9,
                "cost_model_f32_peak_share": flops / per_frame / peak_f32,
                # XLA's logical operand bytes: an upper bound on device-memory
                # traffic (fusion keeps much of it on chip), so above 1 it
                # bounds nothing
                "cost_model_bytes_hbm_peak_share": (
                    cost_bytes / per_frame / peak_bytes
                ),
            }
        )
    )


if __name__ == "__main__":
    main()
