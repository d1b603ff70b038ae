"""Production stencils under explicit shard_map halo exchange.

GSPMD partitions the jnp pipelines automatically (parallel/sharding.py), but
an explicitly shard_mapped stencil gives control over WHAT crosses between
devices: one ppermute of boundary strips per input instead of whatever the
partitioner infers.

`jbf_sharded` is the production route for the joint bilateral filter at
spatial > 1 (JointBilateralFilter.cu:4-83 semantics, identical to
ops.bilateral.joint_bilateral_filter):

  * colour halo = guide radius + filter radius, with a reflect-101 fixup at
    the GLOBAL image edges (the guide pre-smoothing's border mode,
    cv::gpu::bilateralFilter / ops.bilateral.guide_bilateral);
  * depth halo = filter radius, zeros at global edges (the JBF's pad2d
    convention — out-of-image taps are invalid anyway since z=0 <= 50mm);
  * the guide is computed on the haloed colour block, so its values are
    exact wherever they can influence an in-image output pixel.

Output is bitwise-equal to the unsharded op (tests/test_parallel.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from kinectdepthmapenhancement_tpu.core.config import JBFParams
from kinectdepthmapenhancement_tpu.ops import bilateral
from kinectdepthmapenhancement_tpu.parallel import halo


def _jbf_local(depth_blk, color_blk, p: JBFParams, axis: str):
    """Per-shard JBF body: exchange halos, filter, slice the core."""
    rg = p.guide_diameter // 2
    rj = p.window // 2
    ws = depth_blk.shape[1]

    cpad = halo.exchange_width(color_blk, rg + rj, axis)
    cpad = halo.reflect101_at_global_edges(cpad, rg + rj, axis)
    # guide values for columns [-rj, ws+rj) of this shard; the outer rg
    # columns of the block output depend on guide_bilateral's own reflect
    # pad of the BLOCK and are discarded here
    guide = bilateral.guide_bilateral(cpad, p).astype(jnp.float32)
    guide = jax.lax.slice_in_dim(guide, rg, rg + ws + 2 * rj, axis=1)

    dpad = halo.exchange_width(depth_blk, rj, axis)  # zeros at global edges
    out = bilateral._jbf_core(
        dpad,
        guide,
        window=p.window,
        spatial_sigma=p.spatial_sigma,
        color_sigma=p.color_sigma,
        depth_sigma=p.depth_sigma,
    )
    return jax.lax.slice_in_dim(out, rj, rj + ws, axis=1)


def jbf_sharded(
    depth: jnp.ndarray,
    color: jnp.ndarray,
    mesh: Mesh,
    p: JBFParams = JBFParams(),
    *,
    axis: str = "x",
):
    """Joint bilateral filter with the image width tiled over mesh axis
    `axis`.  depth [H, W] f32 mm, color [H, W, 3] u8; W must divide by the
    axis size."""
    body = functools.partial(_jbf_local, p=p, axis=axis)
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(P(None, axis), P(None, axis, None)),
        out_specs=P(None, axis),
    )
    return fn(depth, color)
