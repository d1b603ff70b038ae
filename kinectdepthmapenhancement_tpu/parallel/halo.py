"""Manual halo exchange for spatially tiled stencil ops (shard_map path).

The reference's stencils read up to 3 px past the thread block; on a device
mesh the analog is exchanging boundary strips between neighbouring shards
with jax.lax.ppermute before running the stencil locally (SURVEY.md §5).

`exchange_width` pads a [H, W_shard, ...] block with `radius` columns from
the neighbouring shards (zeros at the global image edges, matching the
stencil modules' zero-padding convention), so a local window op over the
padded block is bitwise-equal to the unsharded op.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def exchange_width(x: jnp.ndarray, radius: int, axis_name: str) -> jnp.ndarray:
    """Return x padded to [H, W_shard + 2*radius, ...] with neighbour halos.

    Must be called inside shard_map with `axis_name` mapping the width axis.
    """
    idx = lax.axis_index(axis_name)
    n = lax.axis_size(axis_name)
    left_strip = x[:, :radius]
    right_strip = x[:, -radius:]
    # send my right strip to my right neighbour (it becomes their left halo)
    from_left = lax.ppermute(
        right_strip, axis_name, [(i, (i + 1) % n) for i in range(n)]
    )
    # send my left strip to my left neighbour (their right halo)
    from_right = lax.ppermute(
        left_strip, axis_name, [(i, (i - 1) % n) for i in range(n)]
    )
    zeros = jnp.zeros_like(left_strip)
    from_left = jnp.where(idx == 0, zeros, from_left)
    from_right = jnp.where(idx == n - 1, zeros, from_right)
    return jnp.concatenate([from_left, x, from_right], axis=1)


def reflect101_at_global_edges(
    padded: jnp.ndarray, radius: int, axis_name: str
) -> jnp.ndarray:
    """Rewrite the zero halos that `exchange_width` leaves at the global
    image edges with reflect-101 values (col -k := col k, col W-1+k :=
    col W-1-k) — the border mode of the colour-guide pre-smoothing
    (ops/bilateral.py guide_bilateral).  Interior halos are untouched.

    padded: [H, radius + ws + radius, ...] as returned by exchange_width.
    """
    idx = lax.axis_index(axis_name)
    n = lax.axis_size(axis_name)
    ws = padded.shape[1] - 2 * radius
    # left halo position p in [0, radius) holds global col -(radius - p);
    # reflect-101 -> core col (radius - p) -> padded col 2*radius - p
    left_ref = jnp.flip(
        jax.lax.slice_in_dim(padded, radius + 1, 2 * radius + 1, axis=1), axis=1
    )
    # right halo position q in [0, radius) holds global col ws-1+(q+1);
    # reflect-101 -> core col ws-1-(q+1) -> padded col radius + ws - 2 - q
    right_ref = jnp.flip(
        jax.lax.slice_in_dim(padded, ws - 1, radius + ws - 1, axis=1), axis=1
    )
    left = jax.lax.slice_in_dim(padded, 0, radius, axis=1)
    right = jax.lax.slice_in_dim(padded, radius + ws, 2 * radius + ws, axis=1)
    core = jax.lax.slice_in_dim(padded, radius, radius + ws, axis=1)
    left = jnp.where(idx == 0, left_ref, left)
    right = jnp.where(idx == n - 1, right_ref, right)
    return jnp.concatenate([left, core, right], axis=1)
