"""Per-pipeline device frame time (chained-iteration method, PERF.md).

Usage: python scripts/measure_pipelines.py [jbf mrf rgbf kde kde_pm spdsp tof]
Prints one `name device_frame_ms fps` line per requested pipeline (default:
all six).  Two compiles per pipeline; the chained fori_loop isolates device
time from per-dispatch host overhead exactly like measure_kde.py.  Needs a
GPU.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

from kinectdepthmapenhancement_tpu.core import device

device.require_gpu()
device.enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from kinectdepthmapenhancement_tpu.core.camera import (
    default_kinect_intrinsics,
    projective_to_real,
)
from kinectdepthmapenhancement_tpu.core.config import (
    KDEConfig,
    RGBFConfig,
    SPDSPConfig,
    TOFConfig,
)
from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu.models import pipelines

h, w = 480, 640
intr = default_kinect_intrinsics(w, h)
color, depth, _ = make_noisy_scene(h, w, intr, seed=0)
c = jnp.asarray(color)
d0 = jnp.asarray(depth)


def run_one(name: str) -> None:
    kde_cfg = KDEConfig()

    def frame(dd):
        if name == "jbf":
            return pipelines.jbf_pipeline(dd, c, kde_cfg)
        if name == "mrf":
            return pipelines.mrf_pipeline(dd, c, kde_cfg)
        if name == "kde":
            return pipelines.kde_pipeline(dd, c, intr, kde_cfg).optimized_points
        if name == "kde_pm":
            import dataclasses

            pm_cfg = dataclasses.replace(kde_cfg, plane_merge=True)
            return pipelines.kde_pipeline(dd, c, intr, pm_cfg).optimized_points
        pts = projective_to_real(dd, intr)
        if name == "rgbf":
            return pipelines.rgbf_pipeline(dd, pts, c, RGBFConfig()).refined_depth
        if name == "spdsp":
            return pipelines.spdsp_pipeline(
                dd, pts, c, intr, SPDSPConfig()
            ).optimized_points
        if name == "tof":
            return pipelines.tof_pipeline(
                dd, pts, c, intr, TOFConfig()
            ).plane_fitted
        raise ValueError(name)

    def chained(k_static):
        def body(_, dd):
            out = frame(dd)
            s = jnp.sum(out.astype(jnp.float32)) * 1e-30
            return d0 + s.astype(d0.dtype)

        return jax.jit(lambda d: jnp.sum(jax.lax.fori_loop(0, k_static, body, d)))

    lo_k, hi_k = 3, 9
    f_lo, f_hi = chained(lo_k), chained(hi_k)
    float(f_lo(d0)); float(f_hi(d0))
    spans = []
    for _ in range(3):
        t0 = time.perf_counter(); float(f_lo(d0)); t_lo = time.perf_counter() - t0
        t0 = time.perf_counter(); float(f_hi(d0)); t_hi = time.perf_counter() - t0
        spans.append((t_hi - t_lo) / (hi_k - lo_k))
    ms = float(np.median(spans)) * 1e3
    print(f"{name} device_frame_ms={ms:.3f}  fps={1000.0/ms:.2f}", flush=True)


names = sys.argv[1:] or ["jbf", "mrf", "rgbf", "kde", "spdsp", "tof"]
for n in names:
    run_one(n)
