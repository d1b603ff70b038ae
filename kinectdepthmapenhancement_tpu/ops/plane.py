"""Plane fitting, projection and optimisation.

JAX re-design of Projection_GPU / Projection_PCA / the host PCA stage:

  * set_pseudo_depth_* — project each pixel onto its cluster's plane along
    the precomputed unit ray (setPsuedoDepth overloads,
    Projection_GPU.cu:20-115, Projection_PCA.cu:20-48);
  * variance_optimization — blend toward the plane for big coherent clusters
    (Projection_GPU.cu:174-196);
  * mrf_optimization — 20 Jacobi sweeps of a 5x5 Perona-Malik-weighted
    smoother gated on plane-agreement (Projection_GPU.cu:139-172), iterated
    with lax.fori_loop;
  * depth_bilateral — 7x7 depth-Gaussian cleanup (Projection_GPU.cu:198-227);
  * eigenvalue_optimization — the PCA-variant blend (present but disabled in
    the reference, Projection_PCA.cu:76-108 / call site commented out);
  * pca_planes — batched per-cluster plane fit replacing the reference's
    HOST cv::PCA stage (SPDepthSuperResolution.cpp:82-142): per-cluster
    covariance via segment sums (centred for f32 stability) + closed-form
    smallest eigenvector, entirely on device.

Depths here are in millimetres (unlike normal estimation).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from kinectdepthmapenhancement_tpu.core.buffer2d import VALID_DEPTH_MM
from kinectdepthmapenhancement_tpu.core.camera import Intrinsics, normalized_rays
from kinectdepthmapenhancement_tpu.core.config import ProjectionParams
from kinectdepthmapenhancement_tpu.ops import stencil, tables
from kinectdepthmapenhancement_tpu.ops.normals import smallest_eigenvector

PI_8 = 3.141592653 / 8.0
import math
COS_PI_8 = math.cos(PI_8)


def _project(nd: jnp.ndarray, rays: jnp.ndarray) -> jnp.ndarray:
    """z = |d / (a*rx + b*ry + c)| along the unit-z ray; returns [H, W, 3]."""
    a, b, c, d = nd[..., 0], nd[..., 1], nd[..., 2], nd[..., 3]
    denom = a * rays[..., 0] + b * rays[..., 1] + c
    z = jnp.abs(d / jnp.where(denom == 0.0, 1e-30, denom))
    return rays * z[..., None]


def set_pseudo_depth_map(
    points: jnp.ndarray,
    rays: jnp.ndarray,
    nd_map: jnp.ndarray,
    labels: jnp.ndarray,
    variance: jnp.ndarray,
    *,
    index=None,
    rep: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Per-pixel nd map + variance gate (first overload, Projection_GPU.cu:20-48;
    used by KDE with the CCL-merged outputs): plane-project where label > -1
    and acos(variance[label]) < pi/8, else pass through the input points.

    index/rep: optional cell-local gather route (see variance_optimization)."""
    # acos(v) < pi/8  <=>  v > cos(pi/8).  The reference's acos(v) is NaN
    # (-> reject) for v > 1, but coherence lands at 1 +- ulp for perfectly
    # planar clusters (it is a unit normal's self-dot), so whether a cluster
    # is accepted is f32 summation-order luck there.  FIXED (documented):
    # v > 1 is clamped to 1, deterministically accepting fully coherent
    # clusters — the obviously intended behaviour.
    if index is not None and rep is not None:
        var_map = index.gather(tables.gather(variance, rep)[:, None])[..., 0]
    else:
        var_map = tables.gather(variance, labels)
    var = jnp.minimum(var_map, 1.0)
    gate = (labels > -1) & (var > COS_PI_8)
    proj = _project(nd_map, rays)
    return jnp.where(gate[..., None], proj, points)


def set_pseudo_depth_cluster(
    points: jnp.ndarray,
    rays: jnp.ndarray,
    cluster_nd: jnp.ndarray,
    labels: jnp.ndarray,
    *,
    strict: bool = False,
    index=None,
) -> jnp.ndarray:
    """Per-cluster nd table (second overload, Projection_GPU.cu:50-77; SPDSP):
    project where label > -1 and |nd.x| < 1 (invalid sentinel 5.0).
    strict=True uses <= 1.0 (the PCA variant, Projection_PCA.cu:20-48).

    index: optional cell-local label index over `labels` (slic.cell_index;
    gathers 0 for label -1, exactly like the one-hot route — the `labels >
    -1` gate masks those pixels either way)."""
    nd = index.gather(cluster_nd) if index is not None else tables.gather(
        cluster_nd, labels
    )
    ok = jnp.abs(nd[..., 0]) <= 1.0 if strict else jnp.abs(nd[..., 0]) < 1.0
    gate = (labels > -1) & ok
    proj = _project(nd, rays)
    return jnp.where(gate[..., None], proj, points)


def set_pseudo_depth_normals(
    points: jnp.ndarray,
    rays: jnp.ndarray,
    cluster_normals: jnp.ndarray,
    cluster_centers: jnp.ndarray,
    labels: jnp.ndarray,
    variance: jnp.ndarray,
) -> jnp.ndarray:
    """Normals+centers overload (Projection_GPU.cu:79-115): d = |n.center|,
    gate on acos(variance[label]) < pi/8."""
    g = tables.gather(
        jnp.concatenate(
            [cluster_normals, cluster_centers, variance[:, None]], axis=-1
        ),
        labels,
    )
    n, c, var = g[..., 0:3], g[..., 3:6], jnp.minimum(g[..., 6], 1.0)
    d = jnp.abs(jnp.sum(n * c, axis=-1))
    nd = jnp.concatenate([n, d[..., None]], axis=-1)
    # var > 1 clamped (see set_pseudo_depth_map)
    gate = (labels > -1) & (var > COS_PI_8)
    proj = _project(nd, rays)
    return jnp.where(gate[..., None], proj, points)


def plane_fit_residual(
    points: jnp.ndarray,
    plane_fitted: jnp.ndarray,
    labels: jnp.ndarray,
    k: int,
    *,
    index=None,
    rep: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Per-cluster relative RMS plane-fit residual: how well each cluster's
    plane explains the cluster's OWN depths.

    resid[c] = sqrt(mean over member pixels of ((z_plane - z)/z)^2), over
    pixels with label c and valid depth.  A well-merged planar cluster lands
    at the post-filter noise level (~0.05-0.2% of z); a cluster whose merge
    spanned multiple surfaces (mean normal tilted / offset averaged across
    planes) lands at >= 1%.  Used as a plane-confidence gate by
    variance_optimization — a deliberate extension over the reference
    (Projection_GPU.cu:174-196 trusts every coherent-normal plane, which on
    textured scenes snaps 60% of pixels onto mis-fit planes; see the
    real-frame gate in tests/test_oracle_pipeline.py).

    When `index` (a slic label index over the ORIGINAL superpixel labels)
    and `rep` (the [K] merge representative from ccl) are given, the pixel
    sums are keyed by the original labels (reusing the cell-local one-hot
    XLA already built for SLIC/CCL) and folded K-side by `rep` — no extra
    [H*W, K] one-hot.  `labels` must then be the MERGED labels of the same
    frame; both paths produce the same residuals for valid clusters.
    """
    z = points[..., 2]
    zp = plane_fitted[..., 2]
    if index is not None and rep is not None:
        ok = (z > VALID_DEPTH_MM) & (index.labels >= 0)
        rel2 = jnp.where(ok, jnp.square((zp - z) / jnp.maximum(z, 1.0)), 0.0)
        feats = jnp.stack([rel2, ok.astype(jnp.float32)], -1)
        s_orig = index.segment_sum(feats, index.labels >= 0)   # [K, 2]
        sums = tables.segment_sum(s_orig, rep, k)              # tiny fold
    else:
        ok = (z > VALID_DEPTH_MM) & (labels >= 0)
        rel2 = jnp.where(ok, jnp.square((zp - z) / jnp.maximum(z, 1.0)), 0.0)
        feats = jnp.stack(
            [rel2.reshape(-1), ok.reshape(-1).astype(jnp.float32)], -1
        )
        sums = tables.segment_sum(feats, labels.reshape(-1), k)
    return jnp.sqrt(sums[:, 0] / jnp.maximum(sums[:, 1], 1.0))


def variance_optimization(
    optimized: jnp.ndarray,
    plane_fitted: jnp.ndarray,
    labels: jnp.ndarray,
    variance: jnp.ndarray,
    sizes: jnp.ndarray,
    *,
    min_cluster_size: int = 1300,
    agree_tight: float = 0.01,
    agree_loose: float = 0.03,
    fit_residual: jnp.ndarray | None = None,
    max_fit_residual: float = 0.0,
    index=None,
    rep: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """variance_optimization (Projection_GPU.cu:174-196): where the plane fit
    agrees with the current depth within 3%, a big (>1300 px) coherent
    cluster snaps (within 1%) or blends (by variance) toward the plane.
    Only z (and x, y via later ray multiplication) of gated pixels change.

    fit_residual (optional, [K] from plane_fit_residual): plane-confidence
    gate — clusters whose plane mis-fits their own depths by more than
    max_fit_residual (relative RMS) are left untouched.  The reference has
    no such gate; without it, planes averaged across multiple surfaces drag
    every pixel they pass within 3% of onto themselves (documented spec
    extension; None preserves reference behaviour exactly).

    index/rep (optional, see plane_fit_residual): when the merged `labels`
    are rep[original] of a cell-local SLIC labelling, per-merged-cluster
    tables gather as (table[rep])[original] through the cell-local one-hot —
    the direct pixel-level gather by merged labels costs a full [H*W, K]
    one-hot matmul (~0.6 ms/frame at 640x480)."""
    zo = optimized[..., 2]
    zp = plane_fitted[..., 2]
    diff = jnp.abs(zo - zp)
    tbl = jnp.concatenate(
        [variance[:, None], sizes.astype(jnp.float32)[:, None]], axis=-1
    )
    if fit_residual is not None:
        tbl = jnp.concatenate([tbl, fit_residual[:, None]], axis=-1)
    if index is not None and rep is not None:
        g = index.gather(tables.gather(tbl, rep))
    else:
        g = tables.gather(tbl, labels)
    # var > 1 clamped (see set_pseudo_depth_map); the clamped value also
    # feeds the blend below, keeping it a convex combination
    var, size = jnp.minimum(g[..., 0], 1.0), g[..., 1]
    gate = (
        (zp > VALID_DEPTH_MM)
        & (diff < zo * agree_loose)
        & (labels > -1)
        & (var > COS_PI_8)
        & (size > min_cluster_size)
    )
    if fit_residual is not None:
        gate = gate & (g[..., 2] < max_fit_residual)
    snap = diff < zo * agree_tight
    blended = zp * var + zo * (1.0 - var)
    new_z = jnp.where(gate, jnp.where(snap, zp, blended), zo)
    return optimized.at[..., 2].set(new_z)


def mrf_optimization(
    optimized: jnp.ndarray,
    plane_fitted: jnp.ndarray,
    rays: jnp.ndarray,
    p: ProjectionParams = ProjectionParams(),
    *,
    gate_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """mrf_optimization x iterations (Projection_GPU.cu:139-172, call sites
    cu:296-301): Jacobi sweeps of z' = (z_plane + sum w z_n)/(1 + sum w),
    w = smooth_sigma * K/(1 + dz^2), applied only where the plane fit is
    valid and agrees with the current depth within 1%.

    gate_mask (optional [H, W] bool): plane-confidence gate — pixels outside
    it are never pulled toward their plane (spec extension over the
    reference, same rationale as variance_optimization's fit_residual gate;
    None preserves reference behaviour exactly)."""
    h, w = optimized.shape[:2]
    r = p.mrf_window // 2

    def sweep(_, opt):
        z = opt[..., 2]
        zp = plane_fitted[..., 2]
        gate = (zp > VALID_DEPTH_MM) & (jnp.abs(z - zp) < z * 0.01)
        if gate_mask is not None:
            gate = gate & gate_mask
        zpad = stencil.pad2d(z, r, 0.0)
        num = zp
        den = jnp.ones((h, w), jnp.float32)
        for dy, dx in stencil.offsets(p.mrf_window):
            nz = stencil.shift(zpad, dy, dx, r, (h, w))
            ok = nz > VALID_DEPTH_MM
            dfil = p.mrf_k / (1.0 + jnp.square(jnp.abs(z - nz)))
            filt = jnp.where(ok, p.mrf_smooth_sigma * dfil, 0.0)
            num = num + nz * filt
            den = den + filt
        upd = gate & (den != 0.0)
        new_z = jnp.where(upd, num / den, z)
        return jnp.where(upd[..., None], rays * new_z[..., None], opt)

    return lax.fori_loop(0, p.mrf_iterations, sweep, optimized)


def eigenvalue_optimization(
    optimized: jnp.ndarray,
    plane_fitted: jnp.ndarray,
    rays: jnp.ndarray,
    eigen_map: jnp.ndarray,
    labels: jnp.ndarray,
    eigenvalue_sigma: float,
) -> jnp.ndarray:
    """eigenvalues_optimizationPCA (Projection_PCA.cu:76-108).  Present for
    completeness; the reference's call site is commented out (cu:118-125)."""
    zo = optimized[..., 2]
    zp = plane_fitted[..., 2]
    gate = (zp > VALID_DEPTH_MM) & (jnp.abs(zo - zp) < zo * 0.01) & (labels > -1)
    wgt = jnp.exp(-eigenvalue_sigma / (2.0 * jnp.square(jnp.maximum(eigen_map, 1e-30))))
    new_z = wgt * zo + (1.0 - wgt) * zp
    return jnp.where(gate[..., None], rays * new_z[..., None], optimized)


def plane_hole_fill(
    optimized: jnp.ndarray,
    rays: jnp.ndarray,
    labels: jnp.ndarray,
    nd_map: jnp.ndarray,
    trust: jnp.ndarray,
    invalid: jnp.ndarray,
    steps: int,
) -> jnp.ndarray:
    """Label-consistent plane hole-fill (spec extension, KDEConfig.fill_holes;
    the reference has no equivalent — its TOF-interpolation use case
    (TOFDepthInterpolation.cpp) relies on setPsuedoDepth's plane projection,
    Projection_GPU.cu:21-122, which is undefined at label-less hole pixels).

    Sensor dropouts (z <= 50 mm) inside a coherent, gated cluster have a
    well-defined depth: the cluster's merged plane along the pixel's ray.
    This pass dilates (label, plane) from TRUSTED pixels (cluster passed the
    variance/size/residual gates of variance_optimization) into `invalid`
    pixels `steps` times; a pixel fills only while its trusted 4-neighbours
    AGREE on one cluster, so fills never cross cluster boundaries and
    hole pixels straddling two surfaces stay unfilled.  Deterministic:
    candidate priority is (up, down, left, right).
    """
    h, w = labels.shape
    lab0 = jnp.where(trust, labels, -1)
    nd0 = jnp.where(trust[..., None], nd_map, 0.0)

    def shift(x, dy, dx, fill):
        pad = jnp.pad(
            x,
            ((1, 1), (1, 1)) + ((0, 0),) * (x.ndim - 2),
            constant_values=fill,
        )
        return lax.slice(
            pad,
            (1 + dy, 1 + dx) + (0,) * (x.ndim - 2),
            (1 + dy + h, 1 + dx + w) + x.shape[2:],
        )

    def step(_, st):
        lab, nd = st
        cand_l = jnp.full((h, w), -1, jnp.int32)
        cand_nd = jnp.zeros((h, w, 4), jnp.float32)
        consistent = jnp.ones((h, w), bool)
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            l2 = shift(lab, dy, dx, -1)
            n2 = shift(nd, dy, dx, 0.0)
            take = (cand_l < 0) & (l2 >= 0)
            cand_l = jnp.where(take, l2, cand_l)
            cand_nd = jnp.where(take[..., None], n2, cand_nd)
            consistent = consistent & ((l2 < 0) | (l2 == cand_l))
        fill = (lab < 0) & invalid & (cand_l >= 0) & consistent
        lab = jnp.where(fill, cand_l, lab)
        nd = jnp.where(fill[..., None], cand_nd, nd)
        return lab, nd

    lab, nd = lax.fori_loop(0, steps, step, (lab0, nd0))
    filled = (lab >= 0) & (lab0 < 0) & invalid
    proj = _project(nd, rays)
    return jnp.where(filled[..., None], proj, optimized)


def depth_bilateral(
    optimized: jnp.ndarray,
    rays: jnp.ndarray,
    p: ProjectionParams = ProjectionParams(),
) -> jnp.ndarray:
    """bilateralfilter (Projection_GPU.cu:198-227): 7x7 spatial x depth
    Gaussian on z; x, y recomputed from the rays; 0 where no valid support."""
    h, w = optimized.shape[:2]
    r = p.window // 2
    spatial = stencil.gaussian_spatial_filter(p.window, p.spatial_sigma)
    z = optimized[..., 2]
    zpad = stencil.pad2d(z, r, 0.0)
    num = jnp.zeros((h, w), jnp.float32)
    den = jnp.zeros((h, w), jnp.float32)
    for dy, dx in stencil.offsets(p.window):
        nz = stencil.shift(zpad, dy, dx, r, (h, w))
        ok = nz > VALID_DEPTH_MM
        filt = jnp.exp(-jnp.square(nz - z) / (2.0 * p.depth_sigma**2))
        filt = filt * spatial[dy + r, dx + r]
        filt = jnp.where(ok, filt, 0.0)
        num = num + nz * filt
        den = den + filt
    new_z = jnp.where(den == 0.0, 0.0, num / jnp.where(den == 0.0, 1.0, den))
    return rays * new_z[..., None]


# --------------------------------------------------------------- PCA planes


class PCAPlanes(NamedTuple):
    nd: jnp.ndarray           # [K, 4] plane (n, d); invalid sentinel 5.0
    centers: jnp.ndarray      # [K, 3] cluster centroids
    eigenvalues: jnp.ndarray  # [K] smallest eigenvalue
    count: jnp.ndarray        # [K] i32 point count


def pca_planes(
    points: jnp.ndarray, labels: jnp.ndarray, k: int, *, index=None
) -> PCAPlanes:
    """Per-cluster plane fit on device (replaces the host loop + cv::PCA of
    SPDepthSuperResolution.cpp:66-142 / TOFDepthInterpolation.cpp:69-146).

    All pixels with label != -1 contribute (matching the reference, which
    pushes every labelled point, valid or not).  Clusters with < 3 points get
    the invalid sentinel (5, 5, 5) and d = 0.  The normal is the smallest-
    eigenvalue eigenvector, sign-flipped so that d = n . centroid >= 0.

    Covariance is computed from centred second moments: two segment-sum
    passes (sums, then squared residuals about the cluster mean) keep f32
    precision where the reference needed f64.

    index: optional cell-local label index over `labels` (slic.cell_index) —
    routes both segment-sum passes and the mean gather through the cell-
    local one-hot instead of a [H*W, K] one (same sums up to f32 order).
    """
    h, w = points.shape[:2]
    hw = h * w
    flat_pts = points.reshape(-1, 3)
    flat_lab = labels.reshape(-1)
    if index is not None:
        mask = labels >= 0
        ones = jnp.ones((h, w, 1), jnp.float32)
        sums = index.segment_sum(
            jnp.concatenate([points, ones], axis=-1), mask
        )
        count = sums[:, 3]
        mean = sums[:, 0:3] / jnp.maximum(count, 1.0)[:, None]
        centered = points - index.gather(mean)
        centered = jnp.where(mask[..., None], centered, 0.0)
        cx, cy, cz = centered[..., 0], centered[..., 1], centered[..., 2]
        sq = jnp.stack(
            [cx * cx, cx * cy, cx * cz, cy * cy, cy * cz, cz * cz], axis=-1
        )
        m = index.segment_sum(sq, mask)
    else:
        onehot = tables.one_hot(flat_lab, k) if tables.use_onehot() else None

        ones = jnp.ones((hw, 1), jnp.float32)
        sums = tables.segment_sum(
            jnp.concatenate([flat_pts, ones], axis=-1), flat_lab, k, onehot=onehot
        )
        count = sums[:, 3]
        mean = sums[:, 0:3] / jnp.maximum(count, 1.0)[:, None]

        centered = flat_pts - tables.gather(mean, flat_lab, onehot=onehot)
        centered = jnp.where((flat_lab >= 0)[:, None], centered, 0.0)
        cx, cy, cz = centered[:, 0], centered[:, 1], centered[:, 2]
        sq = jnp.stack([cx * cx, cx * cy, cx * cz, cy * cy, cy * cz, cz * cz], axis=-1)
        m = tables.segment_sum(sq, flat_lab, k, onehot=onehot)
    n_safe = jnp.maximum(count, 1.0)
    # cv::PCA uses the scatter matrix scaled by 1/N (CV_COVAR_SCALE with rows)
    cov = jnp.stack(
        [
            jnp.stack([m[:, 0], m[:, 1], m[:, 2]], -1),
            jnp.stack([m[:, 1], m[:, 3], m[:, 4]], -1),
            jnp.stack([m[:, 2], m[:, 4], m[:, 5]], -1),
        ],
        axis=-2,
    ) / n_safe[:, None, None]

    eigval, vec = smallest_eigenvector(cov)
    d_signed = jnp.sum(vec * mean, axis=-1)
    vec = jnp.where((d_signed < 0)[:, None], -vec, vec)
    d = jnp.abs(d_signed)

    valid = count >= 3
    nd = jnp.concatenate([vec, d[:, None]], axis=-1)
    nd = jnp.where(valid[:, None], nd, jnp.array([5.0, 5.0, 5.0, 0.0]))
    centers = jnp.where(valid[:, None], mean, 0.0)
    eigenvalues = jnp.where(valid, eigval, 0.0)
    return PCAPlanes(
        nd=nd, centers=centers, eigenvalues=eigenvalues, count=count.astype(jnp.int32)
    )
