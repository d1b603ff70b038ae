"""Sub-stage device-time profile of generate_normal_map (CM path) on a GPU.

Same chained-iteration methodology as profile_kde.py.
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
    projective_to_real,
)
from kinectdepthmapenhancement_tpu.core.config import KDEConfig
from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu.ops import bilateral, normals

H, W = 480, 640
LO, HI = 3, 9


def chained_time(stage, inputs, perturb_idx=0, reps=3):
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
    p = cfg.normals

    depth = jnp.asarray(depth_np)
    color = jnp.asarray(color_np)
    jbf_d = bilateral.joint_bilateral_filter(depth, color, cfg.jbf)
    points = projective_to_real(jbf_d, intr)
    vm = points / 1000.0
    smooth = normals.smoothing_map(vm, p)
    dci = normals.dci_map(vm, p.max_depth_change_factor)
    jax.block_until_ready((vm, smooth, dci))
    border = int(p.normal_smoothing_size)

    stages = [
        ("dci_map", lambda v: normals.dci_map(v, p.max_depth_change_factor), (vm,)),
        ("distance_transform", lambda d: normals.distance_transform(d.astype(jnp.int32), p.dt_iterations), (dci.astype(jnp.float32),)),
        ("smoothing_map", lambda v: normals.smoothing_map(v, p), (vm,)),
        ("cm_normals", lambda v: normals.cm_normals(v, smooth, border), (vm,)),
        ("cm_normals+smooth", lambda v: normals.cm_normals(v, normals.smoothing_map(v, p), border), (vm,)),
        ("rest_normals", lambda v: normals._rest_normals(normals.cm_normals(v, smooth, border), v) - normals.cm_normals(v, smooth, border), (vm,)),
        ("sdc_normals", lambda v: normals.sdc_normals(v, smooth, border), (vm,)),
        ("FULL generate(cm)", lambda pts: normals.generate_normal_map(pts, p), (points,)),
    ]
    for name, fn, inputs in stages:
        t = chained_time(fn, inputs)
        print(f"{name:24s} {t*1000:8.3f} ms", flush=True)


if __name__ == "__main__":
    main()
