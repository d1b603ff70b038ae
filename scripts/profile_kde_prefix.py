"""Cumulative-prefix device times of the KDE pipeline (chained method).

profile_kde.py times stages in ISOLATION; the composed pipeline is slower
than the sum (PERF.md round-2 table).  Timing cumulative prefixes
(jbf -> +normals -> +nasp -> +ccl -> +projection) localises where the
composition overhead lives: prefix[k] - prefix[k-1] is the marginal cost of
stage k IN CONTEXT.
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
from kinectdepthmapenhancement_tpu.ops import bilateral, ccl, normals, plane, slic

H, W = 480, 640
LO, HI = 3, 9


def chained_time(stage, inputs, reps=3):
    def runner(k_static):
        def body(i, carry):
            args = list(carry)
            out = stage(*args)
            s = jnp.sum(out.astype(jnp.float32)) * 1e-30
            args[0] = args[0] + s.astype(args[0].dtype)
            return tuple(args)

        def fn(*args):
            final = jax.lax.fori_loop(0, k_static, body, tuple(args))
            return jnp.sum(final[0].astype(jnp.float32))

        return jax.jit(fn)

    f_lo, f_hi = runner(LO), runner(HI)
    float(f_lo(*inputs)); float(f_hi(*inputs))
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
    depth = jnp.asarray(depth_np)
    color = jnp.asarray(color_np)
    rays = normalized_rays(intr, H, W)
    jax.block_until_ready((depth, color))

    def upto(stage_n):
        def fn(d):
            jbf_depth = bilateral.joint_bilateral_filter(d, color, cfg.jbf)
            points = projective_to_real(jbf_depth, intr)
            if stage_n == 0:
                return points
            nmap = normals.generate_normal_map(points, cfg.normals)
            if stage_n == 1:
                return nmap
            nasp = slic.segment(
                color, points, nmap, grid=cfg.grid, params=cfg.nasp, variant="nasp"
            )
            if stage_n == 2:
                return nasp.clusters.normal
            nasp_cell = slic.cell_index(nasp.labels, cfg.grid, neighborhood=8)
            merged = ccl.merge_normals(
                nasp.labels, nasp.clusters.normal, nasp.clusters.center, cfg.ccl,
                index=nasp_cell,
            )
            if stage_n == 3:
                return merged.nd_map
            plane_fitted = plane.set_pseudo_depth_map(
                points, rays, merged.nd_map, merged.labels, merged.variance
            )
            optimized = plane.variance_optimization(
                points, plane_fitted, merged.labels, merged.variance, merged.sizes,
                min_cluster_size=cfg.min_cluster_size,
                agree_tight=cfg.agree_tight,
                agree_loose=cfg.agree_loose,
            )
            return plane.depth_bilateral(optimized, rays, cfg.projection)

        return fn

    names = ["jbf+proj", "+normals", "+nasp", "+ccl", "+projection(full)"]
    prev = 0.0
    for n, name in enumerate(names):
        t = chained_time(upto(n), (depth,))
        print(f"{name:22s} {t*1000:8.3f} ms   (marginal {1000*(t-prev):+.3f})", flush=True)
        prev = t


if __name__ == "__main__":
    main()
