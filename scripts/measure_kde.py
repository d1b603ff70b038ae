"""Minimal chained-iteration measurement of the composed KDE frame time
(2 compiles only; PERF.md methodology)."""

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

from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics
from kinectdepthmapenhancement_tpu.core.config import KDEConfig
from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu.models.pipelines import kde_pipeline

h, w = 480, 640
intr = default_kinect_intrinsics(w, h)
color, depth, _ = make_noisy_scene(h, w, intr, seed=0)
cfg = KDEConfig()
c = jnp.asarray(color)
d0 = jnp.asarray(depth)


def chained(k_static):
    def body(_, dd):
        out = kde_pipeline(dd, color=c, intr=intr, cfg=cfg).optimized_points
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
print(f"device_frame_ms={ms:.3f}  fps={1000.0/ms:.2f}")
