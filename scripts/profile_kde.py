"""Per-stage device-time profile of the KDE pipeline on a GPU.

Each stage is timed by chaining K data-dependent iterations of the stage
inside ONE jitted executable and differencing the wall time of two K values —
per-iteration device time = (t_hi - t_lo)/(hi-lo) — so per-dispatch host
overhead cancels.
Data dependence between iterations is forced by nudging a float input with
1e-30 * sum(previous output) (numerically a no-op, but un-foldable).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from kinectdepthmapenhancement_tpu.core import device

device.require_gpu()
device.enable_compile_cache()

from kinectdepthmapenhancement_tpu.core.camera import (
    default_kinect_intrinsics,
    normalized_rays,
    projective_to_real,
)
from kinectdepthmapenhancement_tpu.core.config import KDEConfig
from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu.models.pipelines import kde_pipeline
from kinectdepthmapenhancement_tpu.ops import bilateral, ccl, normals, plane, slic

H, W = 480, 640
LO, HI = 3, 9


def chained_time(stage, inputs, perturb_idx=0, reps=3):
    """stage(*inputs) -> array.  Chains K iterations inside one executable."""

    def runner(k_static):
        def body(i, carry):
            args = list(carry)
            out = stage(*args)
            s = jnp.sum(out.astype(jnp.float32)) * 1e-30
            args[perturb_idx] = args[perturb_idx] + s.astype(args[perturb_idx].dtype)
            return tuple(args)

        def fn(*args):
            final = jax.lax.fori_loop(0, k_static, body, tuple(args))
            return jnp.sum(final[perturb_idx].astype(jnp.float32))

        return jax.jit(fn)

    f_lo, f_hi = runner(LO), runner(HI)
    float(f_lo(*inputs)); float(f_hi(*inputs))  # compile+warm
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter(); float(f_lo(*inputs)); t_lo = time.perf_counter() - t0
        t0 = time.perf_counter(); float(f_hi(*inputs)); t_hi = time.perf_counter() - t0
        ts.append((t_hi - t_lo) / (HI - LO))
    return float(np.median(ts))


def main():
    print("backend:", jax.default_backend(), flush=True)
    intr = default_kinect_intrinsics(W, H)
    color_np, depth_np, _ = make_noisy_scene(H, W, intr, seed=0)
    cfg = KDEConfig()
    rng = np.random.default_rng(7)

    depth = jnp.asarray(depth_np + rng.normal(0, 1, (H, W)).astype(np.float32))
    color = jnp.asarray(color_np)
    color_f = color.astype(jnp.float32)
    rays = normalized_rays(intr, H, W)

    # materialize intermediates once for stage inputs
    jbf_d = bilateral.joint_bilateral_filter(depth, color, cfg.jbf)
    points = projective_to_real(jbf_d, intr)
    nmap = normals.generate_normal_map(points, cfg.normals)
    nasp = slic.segment(color, points, nmap, grid=cfg.grid, params=cfg.nasp, variant="nasp")
    merged = ccl.merge_normals(nasp.labels, nasp.clusters.normal, nasp.clusters.center, cfg.ccl)
    fitted = plane.set_pseudo_depth_map(points, rays, merged.nd_map, merged.labels, merged.variance)
    jax.block_until_ready((fitted, nasp.labels))

    stages = []

    stages.append(("jbf", lambda d: bilateral.joint_bilateral_filter(d, color, cfg.jbf), (depth,)))
    stages.append(("proj_to_real", lambda d: projective_to_real(d, intr), (jbf_d,)))
    stages.append(("normals_cm", lambda p: normals.generate_normal_map(p, cfg.normals), (points,)))

    def nasp_grad(p, n):
        return slic._nasp_gradient(color_f, n)
    stages.append(("nasp_seed_gradient", nasp_grad, (points, nmap), 0))

    def nasp_full(p, n):
        return slic.segment(color, p, n, grid=cfg.grid, params=cfg.nasp, variant="nasp").labels
    stages.append(("nasp_full", nasp_full, (points, nmap), 0))

    def ccl_stage(nrm, ctr):
        m = ccl.merge_normals(nasp.labels, nrm, ctr, cfg.ccl)
        return m.nd_map
    stages.append(("ccl_merge", ccl_stage, (nasp.clusters.normal, nasp.clusters.center), 0))

    def plane_stage(p):
        f = plane.set_pseudo_depth_map(p, rays, merged.nd_map, merged.labels, merged.variance)
        o = plane.variance_optimization(
            p, f, merged.labels, merged.variance, merged.sizes,
            min_cluster_size=cfg.min_cluster_size,
            agree_tight=cfg.agree_tight, agree_loose=cfg.agree_loose)
        return plane.depth_bilateral(o, rays, cfg.projection)
    stages.append(("plane_proj+opt+bilat", plane_stage, (points,), 0))

    def full(d):
        return kde_pipeline(d, color, intr, cfg).optimized_points
    stages.append(("FULL kde", full, (depth,), 0))

    total = 0.0
    for name, fn, inputs, *rest in stages:
        pi = rest[0] if rest else 0
        t = chained_time(fn, inputs, perturb_idx=pi)
        if name != "FULL kde":
            total += t if name != "nasp_seed_gradient" else 0.0
        print(f"{name:24s} {t*1000:8.3f} ms", flush=True)
    print(f"{'sum of stages':24s} {total*1000:8.3f} ms (seed gradient counted inside nasp_full)")


if __name__ == "__main__":
    main()
