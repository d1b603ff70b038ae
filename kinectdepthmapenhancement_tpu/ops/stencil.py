"""Shared helpers for window-stencil ops.

The reference implements every stencil (JBF, MRF, ERS enhancement, projection
bilateral, mrf_optimization) as a per-thread loop over a small window with an
in-bounds check (e.g. JointBilateralFilter.cu:17-21).  Here the equivalent
is a statically unrolled sum of shifted copies of a padded image: XLA fuses
the whole window into one loop, and the pad value doubles as the
out-of-bounds sentinel (invalid depth 0 is rejected by the z > 50 test, so
padding with 0 reproduces the bounds check exactly).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import jax.numpy as jnp
from jax import lax


def offsets(window: int) -> Iterator[Tuple[int, int]]:
    """(dy, dx) pairs covering the reference loop
    `for i in -w/2..w/2: for j in -w/2..w/2` in the same order."""
    r = window // 2
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            yield dy, dx


def pad2d(x: jnp.ndarray, radius: int, fill: float = 0.0) -> jnp.ndarray:
    """Pad the two leading spatial dims of [H, W, ...] by `radius` with `fill`."""
    pads = [(radius, radius), (radius, radius)] + [(0, 0)] * (x.ndim - 2)
    return jnp.pad(x, pads, constant_values=fill)


def shift(padded: jnp.ndarray, dy: int, dx: int, radius: int, shape) -> jnp.ndarray:
    """View of the padded array displaced by (dy, dx); shape = original (H, W)."""
    h, w = shape
    start = [radius + dy, radius + dx] + [0] * (padded.ndim - 2)
    sizes = [h, w] + list(padded.shape[2:])
    return lax.slice(
        padded, start, [s + z for s, z in zip(start, sizes)]
    )


def in_bounds_mask(h: int, w: int, dy: int, dx: int) -> jnp.ndarray:
    """Mask [H, W] of pixels whose (dy, dx) neighbour is inside the image."""
    v = jnp.arange(h)[:, None]
    u = jnp.arange(w)[None, :]
    return ((v + dy >= 0) & (v + dy < h)) & ((u + dx >= 0) & (u + dx < w))


def gaussian_spatial_filter(window: int, sigma: float) -> jnp.ndarray:
    """exp(-(dx^2+dy^2) / (2 sigma^2)) over the window
    (calcSpatialFilter, JointBilateralFilter.cpp:33-43)."""
    r = window // 2
    d = jnp.arange(-r, r + 1, dtype=jnp.float32)
    g = jnp.exp(-(d[:, None] ** 2 + d[None, :] ** 2) / (2.0 * sigma**2))
    return g
