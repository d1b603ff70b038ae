"""Depth->color viewpoint registration + intrinsics from sensor calibration.

The reference gets both from OpenNI: registration is delegated to the
hardware (`AlternativeViewPointCapability::SetViewPoint(Image_Generator)`,
Kinect/Kinect.cpp:70-75) and the intrinsic matrix is derived from the
depth generator's ZPD/ZPPS properties as fx = fy = F / (2 * pixel_size),
cx = W/2, cy = H/2 (Kinect/Kinect.cpp:89-95).

Without OpenNI, this module provides device-side
equivalents so unregistered RGB-D datasets (NYU-v2 raw / TUM) can feed the
pipelines:

  * `intrinsics_from_zpd_zpps` — the exact Kinect.cpp:89-95 formula;
  * `register_depth_to_color` — forward-warp z-buffer splat: unproject every
    depth pixel (the framework's y-flipped convention, camera.py), rigid
    transform into the colour camera frame, project with the colour
    intrinsics, scatter-MIN z per target pixel (the near surface wins, which
    is what the hardware viewpoint mapping does).  Pure jnp; jittable.

Scatter-min uses atomics, but registration runs once per frame at most
(usually once per dataset) — it is a pre-processing op, not a pipeline stage.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
from jax import lax

from kinectdepthmapenhancement_tpu.core.camera import Intrinsics


def intrinsics_from_zpd_zpps(
    zpd_mm: float, zpps_mm: float, width: int = 640, height: int = 480
) -> Intrinsics:
    """fx = fy = ZPD / (2 * ZPPS), cx = W/2, cy = H/2 (Kinect.cpp:89-95).

    ZPD is the zero-plane distance (focal length, mm) and ZPPS the zero-plane
    pixel size (mm/px at ZPD, for the 1280-wide sensor mode — hence the
    factor 2 at 640x480).
    """
    f = float(zpd_mm) / (2.0 * float(zpps_mm))
    return Intrinsics(fx=f, fy=f, cx=width / 2.0, cy=height / 2.0)


class Extrinsics(NamedTuple):
    """Rigid transform depth-camera -> colour-camera: p_c = R @ p_d + t.

    Arrays so a calibration can be a traced value; `identity()` for
    pre-registered streams.
    """

    rotation: jnp.ndarray     # [3, 3]
    translation: jnp.ndarray  # [3] mm

    @staticmethod
    def identity() -> "Extrinsics":
        return Extrinsics(jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32))


def register_depth_to_color(
    depth: jnp.ndarray,
    depth_intr: Intrinsics,
    color_intr: Intrinsics,
    extr: Extrinsics,
    out_shape: tuple[int, int] | None = None,
) -> jnp.ndarray:
    """Warp a depth map from the depth camera into the colour camera's frame.

    depth: [H, W] f32 mm (z <= 0 invalid).  Returns [Ho, Wo] f32 mm in the
    colour camera's pixel grid, 0 where no depth pixel lands.  Nearest-pixel
    splat with z-buffering (min z wins on collision).
    """
    h, w = depth.shape
    ho, wo = out_shape or (h, w)

    u = jnp.arange(w, dtype=jnp.float32)[None, :]
    v = jnp.arange(h, dtype=jnp.float32)[:, None]
    z = depth
    # unproject with the y-flipped convention (camera.py / DimensionConvertor.h:36-43)
    x = (u - depth_intr.cx) / depth_intr.fx * z
    y = (depth_intr.cy - v) / depth_intr.fy * z
    pts = jnp.stack([x, y, z], axis=-1).reshape(-1, 3)

    pc = (
        jnp.matmul(pts, extr.rotation.T, precision=lax.Precision.HIGHEST)
        + extr.translation
    )
    zc = pc[:, 2]
    valid = (depth.reshape(-1) > 0.0) & (zc > 1.0)
    safe_z = jnp.where(valid, zc, 1.0)
    uc = pc[:, 0] / safe_z * color_intr.fx + color_intr.cx
    vc = color_intr.cy - pc[:, 1] / safe_z * color_intr.fy
    ui = jnp.round(uc).astype(jnp.int32)
    vi = jnp.round(vc).astype(jnp.int32)

    inside = valid & (ui >= 0) & (ui < wo) & (vi >= 0) & (vi < ho)
    # route out-of-range splats to a dropped index
    ui = jnp.where(inside, ui, 0)
    vi = jnp.where(inside, vi, 0)
    zsplat = jnp.where(inside, zc, jnp.inf)

    out = jnp.full((ho, wo), jnp.inf, jnp.float32)
    out = out.at[vi, ui].min(zsplat, mode="drop")
    return jnp.where(jnp.isfinite(out), out, 0.0)
