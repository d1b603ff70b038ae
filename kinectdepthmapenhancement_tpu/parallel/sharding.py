"""Sharded execution of the pipelines over a ('data', 'x') mesh.

Strategy (SURVEY.md §5/§7): frames are data-parallel over 'data'; the image
plane is tiled over 'x' (width axis).  The pipelines are pure jnp programs
with static shapes, so XLA GSPMD partitions them from input shardings alone —
stencil pads become halo exchanges, segment-sums over the 300-cluster tables
become partial sums + AllReduce between devices, and the tiny cluster-table
fixpoints replicate.  A hand-written shard_map halo-exchange path exists for
the production JBF stencil (parallel/stencil_shard.py, built on
parallel/halo.py) — bitwise-equal to the unsharded op.

`dryrun(n)` builds an n-device mesh, jits the FULL batched KDE step with
real input shardings and runs one step on tiny shapes.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kinectdepthmapenhancement_tpu.core.camera import Intrinsics, default_kinect_intrinsics
from kinectdepthmapenhancement_tpu.core.config import GridParams, KDEConfig
from kinectdepthmapenhancement_tpu.models.pipelines import kde_pipeline
from kinectdepthmapenhancement_tpu.parallel.mesh import make_mesh


def _keep_tiling(mesh: Mesh, result):
    """Constrains every output of the spatial route: image maps ([B, H, W,
    ...]) keep the input's (batch, width) tiling, the [B, K] cluster tables
    shard the batch only."""

    def constrain(a):
        spec = P("data", None, "x") if a.ndim >= 3 else P("data")
        return jax.lax.with_sharding_constraint(a, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(constrain, result)


def sharded_kde_step(mesh: Mesh, intr: Intrinsics, cfg: KDEConfig):
    """Returns a jitted batched KDE step [B,H,W] x [B,H,W,3] -> KDEResult
    (every field batched over B) with batch sharded over 'data' and image
    width over 'x'.

    Two regimes:
      * spatial tiling ('x' > 1): GSPMD partitions the jnp pipeline from the
        input shardings.
      * pure data parallelism ('x' == 1): shard_map over 'data' — each
        device runs the complete pipeline on its local frames, with zero
        cross-device collectives."""

    def step(depth_b, color_b):
        return jax.vmap(lambda d, c: kde_pipeline(d, c, intr, cfg))(
            depth_b, color_b
        )

    if mesh.shape.get("x", 1) > 1:
        return jax.jit(
            lambda depth_b, color_b: _keep_tiling(mesh, step(depth_b, color_b)),
            in_shardings=(
                NamedSharding(mesh, P("data", None, "x")),
                NamedSharding(mesh, P("data", None, "x", None)),
            ),
        )
    return jax.jit(
        shard_map(
            step,
            mesh=mesh,
            in_specs=(P("data", None, None), P("data", None, None, None)),
            out_specs=P("data"),
        )
    )


def dryrun(n_devices: int) -> None:
    """Compile + execute one sharded KDE step on tiny shapes (driver hook)."""
    spatial = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh(n_devices, spatial=spatial)
    batch = mesh.shape["data"]

    h, w = 96, 128  # tiny but > 2*border so normals have a valid interior
    intr = default_kinect_intrinsics(w, h)
    cfg = dataclasses.replace(KDEConfig(), grid=GridParams(rows=3, cols=4))

    rng = np.random.default_rng(0)
    depth = jnp.asarray(
        rng.uniform(500.0, 4000.0, size=(batch, h, w)).astype(np.float32)
    )
    color = jnp.asarray(rng.integers(0, 255, size=(batch, h, w, 3), dtype=np.uint8))

    step = sharded_kde_step(mesh, intr, cfg)
    out = jax.block_until_ready(step(depth, color).optimized_points)
    assert out.shape == (batch, h, w, 3)

    # output parity vs an unsharded single-device run (same inputs): GSPMD
    # partitioning must not change results beyond reduction reordering
    single = jax.jit(
        jax.vmap(lambda d, c: kde_pipeline(d, c, intr, cfg).optimized_points)
    )
    want = single(
        jax.device_put(depth, jax.devices()[0]),
        jax.device_put(color, jax.devices()[0]),
    )
    np.testing.assert_allclose(
        np.asarray(out), np.asarray(want), rtol=1e-4, atol=0.5
    )
    print(
        f"dryrun_multichip ok: mesh={dict(mesh.shape)} out={out.shape} "
        f"sharding={out.sharding} parity=ok"
    )
