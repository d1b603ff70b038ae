"""Evaluation metrics.

Replaces main.cpp's evaluation loop (main.cpp:217-309: per-method mean 3-D
Euclidean error vs. the temporally averaged buffer, over pixels where both
depths lie in (50, 15000) mm) — on device, jittable.  For timing use
utils/timing.py, which feeds every timed call fresh inputs.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

VALID_MIN = 50.0
VALID_MAX = 15000.0


def mean_3d_error(
    points: jnp.ndarray, reference_points: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Mean ||p - p_ref|| over pixels where BOTH z's are in (50, 15000) mm
    (main.cpp:302-309).  Returns (mean_error_mm, count)."""
    z = points[..., 2]
    zr = reference_points[..., 2]
    valid = (z > VALID_MIN) & (z < VALID_MAX) & (zr > VALID_MIN) & (zr < VALID_MAX)
    err = jnp.sqrt(jnp.sum(jnp.square(points - reference_points), axis=-1))
    count = jnp.sum(valid)
    total = jnp.sum(jnp.where(valid, err, 0.0))
    return total / jnp.maximum(count, 1), count


def depth_rmse(depth: jnp.ndarray, reference: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel depth RMSE (mm) over jointly valid pixels."""
    valid = (
        (depth > VALID_MIN)
        & (depth < VALID_MAX)
        & (reference > VALID_MIN)
        & (reference < VALID_MAX)
    )
    se = jnp.where(valid, jnp.square(depth - reference), 0.0)
    return jnp.sqrt(jnp.sum(se) / jnp.maximum(jnp.sum(valid), 1))
