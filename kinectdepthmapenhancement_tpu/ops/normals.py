"""Normal-map generation: SAMG smoothing-area map + SDC/CM/BILATERAL normals.

JAX re-design of NormalEstimation/{SmoothingAreaMapGenerator,
NormalMapGenerator}.  Vertices are in METRES here (the reference divides the
mm point map by 1000 on entry, NormalMapGenerator.cu:505-511).

SAMG (SmoothingAreaMapGenerator.cu):
  * depth-change indication map (computeDCIMapGPU:12-31): the scatter-to-
    neighbour writes become a deterministic gather — dci[p] = 0 iff p's own
    horizontal/vertical change test fires, or the left neighbour's horizontal
    test, or the up neighbour's vertical test.  The x = w-1 read of the next
    row (linear-index wrap) is FIXED to a clamped read.
  * chamfer distance transform (computeDTMap:40-92): the reference round-trips
    to the host for two sequential passes; here it is a bounded min-plus
    relaxation over the 3x3 chamfer mask (1 / 1.4) run `dt_iterations` times
    on device.  The fixpoint equals the exact chamfer DT; the reference's two
    passes never update pixels (0, w-1) and (h-1, 0) (loop bounds), so those
    two pixels are restored to their init value for exact parity.
  * final map = min(DT, normal_smoothing_size + z/10)  (cu:95-122).

NMG (NormalMapGenerator.cu):
  * SDC (cu:29-120): average-gradient of z via integral images; the stale
    `normal[acs] != bad_point` read in the flip test (previous launch's
    buffer) is FIXED to an unconditional cos-theta flip.
  * CM (cu:244-302): covariance smallest-eigenvector via the closed-form
    cubic eigensolver (cu:135-242), vectorised.
  * BILATERAL (cu:355-395): one-pixel cross product.
  * computeRestNormal (cu:304-354) fills invalid pixels with a gated cross
    product and applies the final (-x, y, -z) sign flip to every valid pixel.
  * invalid sentinel: exactly (-1, -1, -1).
Border reads one past the image edge (linear-index wrap in the reference) are
clamped; affected pixels sit inside the invalid border for SDC/CM anyway.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from kinectdepthmapenhancement_tpu.core.config import NormalParams
from kinectdepthmapenhancement_tpu.ops import integral

BAD = -1.0
FLT_EPSILON = 1.19209290e-07


# ------------------------------------------------------------------- SAMG


def dci_map(vertices_m: jnp.ndarray, max_depth_change: float) -> jnp.ndarray:
    """Depth-change indication map: 0 at discontinuities, 255 elsewhere."""
    z = vertices_m[..., 2]
    h, w = z.shape
    z_r = jnp.concatenate([z[:, 1:], z[:, -1:]], axis=1)
    z_d = jnp.concatenate([z[1:, :], z[-1:, :]], axis=0)
    thr = max_depth_change * (jnp.abs(z) + 1.0) * 2.0
    horiz = (jnp.abs(z - z_r) > thr) | (z == 0.0) | (z_r == 0.0)
    vert = (jnp.abs(z - z_d) > thr) | (z == 0.0) | (z_d == 0.0)
    # left neighbour's horizontal test also zeroes p; up neighbour's vertical
    horiz_from_left = jnp.concatenate(
        [jnp.zeros((h, 1), bool), horiz[:, :-1]], axis=1
    )
    vert_from_up = jnp.concatenate([jnp.zeros((1, w), bool), vert[:-1, :]], axis=0)
    zero = horiz | vert | horiz_from_left | vert_from_up
    return jnp.where(zero, 0, 255).astype(jnp.int32)


def distance_transform(dci: jnp.ndarray, iterations: int) -> jnp.ndarray:
    """Chamfer (3x3, weights 1/1.4) distance to the nearest dci==0 pixel,
    via iterated min-plus relaxation to the fixpoint (replaces the reference's
    HOST two-pass chamfer; its single sweep under-relaxes the first row/col
    band, which lies inside the invalid normal border — documented spec:
    exact chamfer DT everywhere, capped by the iteration horizon, which
    exceeds every reachable smoothing radius)."""
    h, w = dci.shape
    init = jnp.where(dci == 0, 0.0, float(w + h)).astype(jnp.float32)

    weights = {
        (-1, -1): 1.4, (-1, 0): 1.0, (-1, 1): 1.4,
        (0, -1): 1.0, (0, 1): 1.0,
        (1, -1): 1.4, (1, 0): 1.0, (1, 1): 1.4,
    }

    def relax(dt):
        best = dt
        pad = jnp.pad(dt, 1, constant_values=jnp.inf)
        for (dy, dx), cost in weights.items():
            nb = lax.slice(pad, (1 + dy, 1 + dx), (1 + dy + h, 1 + dx + w))
            best = jnp.minimum(best, nb + cost)
        return best

    # unroll 4 relaxations per loop body: each body is a handful of cheap
    # shifted-min kernels, so per-iteration loop overhead dominated the stage
    group = 4
    dt = lax.fori_loop(
        0,
        iterations // group,
        lambda _, d: relax(relax(relax(relax(d)))),
        init,
    )
    for _ in range(iterations % group):
        dt = relax(dt)
    return dt


def smoothing_map(vertices_m: jnp.ndarray, p: NormalParams) -> jnp.ndarray:
    """Final smoothing-area map = min(DT, size + z/10)  [pixels]."""
    dci = dci_map(vertices_m, p.max_depth_change_factor)
    dt = distance_transform(dci, p.dt_iterations)
    ddsa = p.normal_smoothing_size + vertices_m[..., 2] / 10.0
    return jnp.minimum(dt, ddsa)


# -------------------------------------------------------------- eigensolver


def _compute_roots(m00, m01, m02, m11, m12, m22):
    """Eigenvalues of the symmetric 3x3, ascending; computeRoots
    (NormalMapGenerator.cu:145-191) vectorised.  Returns (r0, r1, r2)."""
    c0 = (
        m00 * m11 * m22
        + 2.0 * m01 * m02 * m12
        - m00 * m12 * m12
        - m11 * m02 * m02
        - m22 * m01 * m01
    )
    c1 = (
        m00 * m11 - m01 * m01 + m00 * m22 - m02 * m02 + m11 * m22 - m12 * m12
    )
    c2 = m00 + m11 + m22

    # quadratic fallback (computeRoots2): roots (0, (c2-sd)/2, (c2+sd)/2)
    d = jnp.maximum(c2 * c2 - 4.0 * c1, 0.0)
    sd = jnp.sqrt(d)
    q0 = jnp.zeros_like(c2)
    q1 = 0.5 * (c2 - sd)
    q2 = 0.5 * (c2 + sd)

    s_inv3 = 1.0 / 3.0
    s_sqrt3 = jnp.sqrt(3.0).astype(c2.dtype) if hasattr(c2, "dtype") else 3.0**0.5
    c2_over_3 = c2 * s_inv3
    a_over_3 = jnp.minimum((c1 - c2 * c2_over_3) * s_inv3, 0.0)
    half_b = 0.5 * (c0 + c2_over_3 * (2.0 * c2_over_3 * c2_over_3 - c1))
    q = jnp.minimum(half_b * half_b + a_over_3 * a_over_3 * a_over_3, 0.0)
    rho = jnp.sqrt(-a_over_3)
    theta = jnp.arctan2(jnp.sqrt(-q), half_b) * s_inv3
    cos_t = jnp.cos(theta)
    sin_t = jnp.sin(theta)
    e0 = c2_over_3 + 2.0 * rho * cos_t
    e1 = c2_over_3 - rho * (cos_t + s_sqrt3 * sin_t)
    e2 = c2_over_3 - rho * (cos_t - s_sqrt3 * sin_t)
    # the reference's swap sequence sorts ascending
    lo = jnp.minimum(jnp.minimum(e0, e1), e2)
    hi = jnp.maximum(jnp.maximum(e0, e1), e2)
    mid = e0 + e1 + e2 - lo - hi

    use_quad = (jnp.abs(c0) < FLT_EPSILON) | (lo <= 0.0)
    r0 = jnp.where(use_quad, q0, lo)
    r1 = jnp.where(use_quad, q1, mid)
    r2 = jnp.where(use_quad, q2, hi)
    return r0, r1, r2


def smallest_eigenvector(cov: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(eigenvalue, eigenvector) of the smallest eigenvalue of symmetric 3x3
    covariances cov[..., 3, 3]; computeEigenValueAndVector
    (NormalMapGenerator.cu:193-242) vectorised: scale by max |entry|, solve the
    cubic, take the longest cross-product of rows of (M - lambda I)."""
    m00 = cov[..., 0, 0]
    m01 = cov[..., 0, 1]
    m02 = cov[..., 0, 2]
    m11 = cov[..., 1, 1]
    m12 = cov[..., 1, 2]
    m22 = cov[..., 2, 2]
    scale = jnp.max(
        jnp.stack(
            [jnp.abs(m00), jnp.abs(m01), jnp.abs(m02), jnp.abs(m11),
             jnp.abs(m12), jnp.abs(m22)], axis=-1
        ),
        axis=-1,
    )
    scale = jnp.where(scale <= 1e-300 if scale.dtype == jnp.float64 else scale <= 1e-37,
                      1.0, scale)
    s00, s01, s02 = m00 / scale, m01 / scale, m02 / scale
    s11, s12, s22 = m11 / scale, m12 / scale, m22 / scale

    r0, _, _ = _compute_roots(s00, s01, s02, s11, s12, s22)
    eigenvalue = r0 * scale

    a00 = s00 - r0
    a11 = s11 - r0
    a22 = s22 - r0
    # rows of (M - lambda I): (a00, s01, s02), (s01, a11, s12), (s02, s12, a22)
    v1 = jnp.stack(
        [s01 * s12 - s02 * a11, s02 * s01 - a00 * s12, a00 * a11 - s01 * s01],
        axis=-1,
    )
    v2 = jnp.stack(
        [s01 * a22 - s02 * s12, s02 * s02 - a00 * a22, a00 * s12 - s01 * s02],
        axis=-1,
    )
    v3 = jnp.stack(
        [a11 * a22 - s12 * s12, s12 * s02 - s01 * a22, s01 * s12 - a11 * s02],
        axis=-1,
    )
    l1 = jnp.sum(v1 * v1, axis=-1)
    l2 = jnp.sum(v2 * v2, axis=-1)
    l3 = jnp.sum(v3 * v3, axis=-1)
    use1 = (l1 >= l2) & (l1 >= l3)
    use2 = (~use1) & (l2 >= l3)
    vec = jnp.where(
        use1[..., None], v1, jnp.where(use2[..., None], v2, v3)
    )
    ln = jnp.sqrt(jnp.where(use1, l1, jnp.where(use2, l2, l3)))
    vec = vec / jnp.maximum(ln, 1e-30)[..., None]
    return eigenvalue, vec


# ------------------------------------------------------------------ normals


def _cross_product_normal(vertices_m: jnp.ndarray):
    """Shared 1-pixel cross-product core of BILATERAL / computeRestNormal.

    Returns (n_raw [H,W,3] normalised by -|n| where |n|>0 else raw cross,
    d_h, d_v, center_z, right-or-left step direction handled per reference).

    The data-dependent +-1 neighbour step is a select between the two
    edge-clamped shifted images (no per-pixel gather).
    """
    h, w = vertices_m.shape[:2]
    vpad = jnp.pad(vertices_m, [(1, 1), (1, 1), (0, 0)], mode="edge")
    p_r = lax.slice(vpad, (1, 2, 0), (1 + h, 2 + w, 3))
    p_l = lax.slice(vpad, (1, 0, 0), (1 + h, w, 3))
    p_d = lax.slice(vpad, (2, 1, 0), (2 + h, 1 + w, 3))
    p_u = lax.slice(vpad, (0, 1, 0), (h, 1 + w, 3))
    z_right = p_r[..., 2]
    step_neg = (z_right == 0.0)[..., None]
    ph01 = jnp.where(step_neg, p_l, p_r)
    pv01 = jnp.where(step_neg, p_u, p_d)
    p0 = vertices_m
    v_h = ph01 - p0
    v_v = pv01 - p0
    nx = v_h[..., 2] * v_v[..., 1] - v_h[..., 1] * v_v[..., 2]
    ny = -(v_h[..., 0] * v_v[..., 2] - v_h[..., 2] * v_v[..., 0])
    nz = v_h[..., 1] * v_v[..., 0] - v_h[..., 0] * v_v[..., 1]
    n = jnp.stack([nx, ny, nz], axis=-1)
    norm = jnp.sqrt(jnp.sum(n * n, axis=-1))
    n = jnp.where((norm > 0.0)[..., None], n / jnp.where(norm > 0, -norm, 1.0)[..., None], n)
    d_h = jnp.sqrt(jnp.sum(jnp.square(ph01 - p0), axis=-1))
    d_v = jnp.sqrt(jnp.sum(jnp.square(pv01 - p0), axis=-1))
    return n, d_h, d_v


def _final_flip(normal: jnp.ndarray) -> jnp.ndarray:
    """(-x, y, -z) for every pixel with any component != -1
    (computeRestNormal tail, NormalMapGenerator.cu:347-353)."""
    valid = jnp.any(normal != BAD, axis=-1)
    flipped = normal * jnp.array([-1.0, 1.0, -1.0], normal.dtype)
    return jnp.where(valid[..., None], flipped, normal)


def bilateral_normals(vertices_m: jnp.ndarray) -> jnp.ndarray:
    """computeNormalBilateralGPU (NormalMapGenerator.cu:355-395)."""
    n, _, _ = _cross_product_normal(vertices_m)
    flip = n * jnp.array([-1.0, 1.0, -1.0], n.dtype)
    bad = vertices_m[..., 2] == 0.0
    return jnp.where(bad[..., None], BAD, flip)


def _rest_normals(normal: jnp.ndarray, vertices_m: jnp.ndarray) -> jnp.ndarray:
    """computeRestNormal fill-in for pixels that are exactly (-1,-1,-1),
    then the final sign flip for all valid pixels."""
    n, d_h, d_v = _cross_product_normal(vertices_m)
    z = vertices_m[..., 2]
    take = (
        (z != 0.0) & (d_h < z * 0.01) & (d_v < z * 0.01)
    )
    is_bad = jnp.all(normal == BAD, axis=-1)
    filled = jnp.where((is_bad & take)[..., None], n, normal)
    return _final_flip(filled)


def _box_channels(vertices_m: jnp.ndarray, method: str) -> integral.CenteredIntegral:
    valid = vertices_m[..., 2] != 0.0
    if method == "sdc":
        chans = vertices_m[..., 2:3]
    else:
        x, y, z = vertices_m[..., 0], vertices_m[..., 1], vertices_m[..., 2]
        chans = jnp.stack(
            [x, y, z, x * x, x * y, x * z, y * y, y * z, z * z], axis=-1
        )
    return integral.build(chans, valid)


MAX_RECT = 21  # ddsa = 20 + z/10 with z <= ~15 m caps the window at 21 px


def _per_size(rect: jnp.ndarray, sizes, compute):
    """Evaluate `compute(s)` (a pytree of [H, W, ...] arrays) for each static
    window size s and select per pixel where rect == s (>= for the largest —
    a documented clamp for depths beyond the Kinect range).  Gather-free: the
    per-pixel dynamic window of the reference becomes a handful of
    fixed-offset slice expressions."""
    out = None
    for s in sizes:
        val = compute(s)
        sel = (rect >= s) if s == sizes[-1] else (rect == s)
        if out is None:
            out = jax.tree_util.tree_map(jnp.zeros_like, val)
        out = jax.tree_util.tree_map(
            lambda o, v: jnp.where(
                sel[(...,) + (None,) * (v.ndim - sel.ndim)], v, o
            ),
            out, val,
        )
    return out


def _edge_shift(padded, dy, dx, r, h, w):
    start = [r + dy, r + dx] + [0] * (padded.ndim - 2)
    sizes = [h, w] + list(padded.shape[2:])
    return lax.slice(padded, start, [s + z for s, z in zip(start, sizes)])


def sdc_normals(
    vertices_m: jnp.ndarray, smoothing: jnp.ndarray, border: int
) -> jnp.ndarray:
    """computeNormalSDC_GPU (NormalMapGenerator.cu:29-120), stale-flip FIXED."""
    h, w = smoothing.shape
    ci = _box_channels(vertices_m, "sdc")
    pi = integral.pad_tables(ci, MAX_RECT + 3, h, w)
    v = jnp.broadcast_to(jnp.arange(h)[:, None], (h, w))
    u = jnp.broadcast_to(jnp.arange(w)[None, :], (h, w))
    in_border = (u < border) | (u > w - border) | (v < border) | (v > h - border)

    rect = smoothing.astype(jnp.int32)
    vpad = jnp.pad(vertices_m, [(8, 8), (8, 8), (0, 0)], mode="edge")

    def boxes(s):
        r2, r4 = s >> 1, s >> 2
        cont = integral.fixed_box_count(pi, -r2 - 1, -r2 - 1, s, s)
        cL = integral.fixed_box_count(pi, -r2 - 1, -r4 - 1, r2, r2)
        cR = integral.fixed_box_count(pi, 0, -r4 - 1, r2, r2)
        cU = integral.fixed_box_count(pi, -r4 - 1, -r2 - 1, r2, r2)
        cD = integral.fixed_box_count(pi, -r4 - 1, 0, r2, r2)
        sL = integral.fixed_box_sum(pi, 0, -r2 - 1, -r4 - 1, r2, r2)
        sR = integral.fixed_box_sum(pi, 0, 0, -r4 - 1, r2, r2)
        sU = integral.fixed_box_sum(pi, 0, -r4 - 1, -r2 - 1, r2, r2)
        sD = integral.fixed_box_sum(pi, 0, -r4 - 1, 0, r2, r2)
        pL = _edge_shift(vpad, 0, -r4 - 1, 8, h, w)
        pR = _edge_shift(vpad, 0, r4 + 1, 8, h, w)
        pU = _edge_shift(vpad, -r4, -1, 8, h, w)  # reference: -r4*width - 1
        pD = _edge_shift(vpad, r4, 1, 8, h, w)
        return (cont, cL, cR, cU, cD, sL, sR, sU, sD, pL, pR, pU, pD)

    (cont, cL, cR, cU, cD, sL, sR, sU, sD, pL, pR, pU, pD) = _per_size(
        rect, list(range(2, MAX_RECT + 1)), boxes
    )
    mL = sL / jnp.maximum(cL, 1.0)
    mR = sR / jnp.maximum(cR, 1.0)
    mU = sU / jnp.maximum(cU, 1.0)
    mD = sD / jnp.maximum(cD, 1.0)

    mean_x_z = mR - mL
    mean_y_z = mD - mU
    mean_x_x = pR[..., 0] - pL[..., 0]
    mean_x_y = pR[..., 1] - pL[..., 1]
    mean_y_x = pD[..., 0] - pU[..., 0]
    mean_y_y = pD[..., 1] - pU[..., 1]

    nx = mean_x_z * mean_y_y - mean_x_y * mean_y_z
    ny = -(mean_x_x * mean_y_z - mean_x_z * mean_y_x)
    nz = mean_x_y * mean_y_x - mean_x_x * mean_y_y
    nlen2 = nx * nx + ny * ny + nz * nz

    cos_theta = -(
        vertices_m[..., 0] * nx + vertices_m[..., 1] * ny + vertices_m[..., 2] * nz
    )
    flip = cos_theta <= 0.0
    sgn = jnp.where(flip, -1.0, 1.0)
    scale = sgn / jnp.sqrt(jnp.maximum(nlen2, 1e-30))
    n = jnp.stack([nx, ny, nz], axis=-1) * scale[..., None]

    bad = (
        in_border
        | (smoothing <= 2.0)
        | (cont == 0)
        | (cL == 0) | (cR == 0) | (cU == 0) | (cD == 0)
        | (nlen2 == 0.0)
    )
    return jnp.where(bad[..., None], BAD, n)


def cm_normals(
    vertices_m: jnp.ndarray,
    smoothing: jnp.ndarray,
    border: int,
) -> jnp.ndarray:
    """computeNormalCM_GPU (NormalMapGenerator.cu:244-302)."""
    h, w = smoothing.shape
    v = jnp.broadcast_to(jnp.arange(h)[:, None], (h, w))
    u = jnp.broadcast_to(jnp.arange(w)[None, :], (h, w))
    in_border = (u <= border) | (u >= w - border) | (v <= border) | (v >= h - border)

    rect = smoothing.astype(jnp.int32)

    # Mathematically the reference computes cov = Sab - Sa*Sb/n over the
    # VALID pixels of the box, in f64.  f32 summed-area tables lose ~1e-5
    # absolute on the box sums, which swamps the ~1e-4 covariances of SMALL
    # windows (the means are metres, the extents centimetres).  Strategy:
    #   * accumulate the box DIRECTLY from per-query-pixel centred residuals
    #     (every term is O(extent^2), so f32 matches the f64 oracle to ~1e-7).
    #     The incremental nested-window sweep visits each of the 21^2 taps
    #     exactly once for ALL sizes, so this costs ~441 fused taps.
    #   * the re-referenced integral path (integral_cov below) is kept for
    #     documentation but NOT used: at 640x480 the f32 global summed-area
    #     tables carry ~0.1 absolute error, the same order as the window
    #     covariances themselves (measured 7 deg mean normal error on a clean
    #     plane); per-query direct accumulation restores <0.1 deg.
    DIRECT_MAX = MAX_RECT
    a3 = vertices_m  # per-query reference point (the pixel's own vertex)
    valid_f = (vertices_m[..., 2] != 0.0).astype(jnp.float32)
    vpad2 = jnp.pad(
        vertices_m, [(MAX_RECT, MAX_RECT), (MAX_RECT, MAX_RECT), (0, 0)]
    )
    mpad = jnp.pad(valid_f, MAX_RECT)

    def direct_cov_all():
        """Incremental direct accumulation: the reference windows are nested
        (window(s) contains window(s-1)), so all direct sizes share ONE pass
        over the largest window — each tap is accumulated exactly once and a
        (cnt, cov) snapshot is taken at every size (64 taps total instead of
        sum(s^2) = 203)."""
        cnt = jnp.zeros((h, w), jnp.float32)
        s1 = jnp.zeros((h, w, 3), jnp.float32)
        s2 = jnp.zeros((h, w, 6), jnp.float32)
        snaps = {}
        prev: set = set()
        for s in range(2, DIRECT_MAX + 1):
            r2 = s >> 1
            taps = {
                (dy, dx)
                for dy in range(-r2, -r2 + s)
                for dx in range(-r2, -r2 + s)
            }
            for dy, dx in sorted(taps - prev):
                pv = _edge_shift(vpad2, dy, dx, MAX_RECT, h, w)
                m = _edge_shift(mpad, dy, dx, MAX_RECT, h, w)
                res = (pv - a3) * m[..., None]
                rx, ry, rz = res[..., 0], res[..., 1], res[..., 2]
                cnt = cnt + m
                s1 = s1 + res
                s2 = s2 + jnp.stack(
                    [rx * rx, rx * ry, rx * rz, ry * ry, ry * rz, rz * rz], -1
                )
            prev = taps
            n_s = jnp.maximum(cnt, 1.0)
            outer = jnp.stack(
                [
                    s1[..., 0] * s1[..., 0], s1[..., 0] * s1[..., 1],
                    s1[..., 0] * s1[..., 2], s1[..., 1] * s1[..., 1],
                    s1[..., 1] * s1[..., 2], s1[..., 2] * s1[..., 2],
                ],
                -1,
            )
            snaps[s] = (cnt, s2 - outer / n_s[..., None])
        return snaps

    # (An O(1)-per-size alternative — global summed-area tables re-referenced
    # at each query vertex — would replace the direct sweep for rects far
    # beyond MAX_RECT; see integral.py.  Removed from this path: all sizes
    # here are direct, and f32 global SATs alone lose ~7 deg on clean planes.)
    direct_snaps = direct_cov_all()
    cont, ent = _per_size(
        rect, list(range(2, MAX_RECT + 1)), lambda s: direct_snaps[s]
    )
    c_xx, c_xy, c_xz = ent[..., 0], ent[..., 1], ent[..., 2]
    c_yy, c_yz, c_zz = ent[..., 3], ent[..., 4], ent[..., 5]
    cov = jnp.stack(
        [
            jnp.stack([c_xx, c_xy, c_xz], -1),
            jnp.stack([c_xy, c_yy, c_yz], -1),
            jnp.stack([c_xz, c_yz, c_zz], -1),
        ],
        axis=-2,
    )
    _, vec = smallest_eigenvector(cov)
    ez_neg = vec[..., 2] < 0.0
    stored = jnp.where(
        ez_neg[..., None],
        vec * jnp.array([1.0, -1.0, 1.0], vec.dtype),
        vec * jnp.array([-1.0, 1.0, -1.0], vec.dtype),
    )
    bad = in_border | (smoothing <= 2.0) | (cont == 0)
    return jnp.where(bad[..., None], BAD, stored)


def generate_normal_map(
    points_mm: jnp.ndarray, p: NormalParams = NormalParams()
) -> jnp.ndarray:
    """Full NormalMapGenerator::generateNormalMap (cu:513-524): mm -> m,
    integral images, smoothing map, normals by method, fill + flip.

    points_mm: [H, W, 3] real-world points in millimetres.
    Returns normals [H, W, 3] with (-1,-1,-1) invalid sentinel.
    """
    vm = points_mm / 1000.0
    border = int(p.normal_smoothing_size)
    if p.method == "bilateral":
        return bilateral_normals(vm)
    smooth = smoothing_map(vm, p)
    if p.method == "sdc":
        raw = sdc_normals(vm, smooth, border)
    elif p.method == "cm":
        raw = cm_normals(vm, smooth, border)
    else:
        raise ValueError(f"unknown normal method {p.method!r}")
    return _rest_normals(raw, vm)
