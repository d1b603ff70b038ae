"""The enhancement pipelines: JBF, MRF, RGBF, KDE ("PROPOSED"), SPDSP, TOF.

Each reference pipeline class (ctor allocates buffers, Process() chains
kernel launches with D2H copies in between) becomes a pure jittable function
over arrays; intermediates that the reference exposes through getters are
returned in a NamedTuple.  No host round-trips: the reference's per-stage
label downloads, cv::imwrite dumps (KinectDepthEnhancement.cpp:69,77) and
host PCA (SPDepthSuperResolution.cpp:66-142) all stay on device.

Call-site parameter sets are preserved exactly (see core/config.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core.camera import (
    Intrinsics,
    normalized_rays,
    projective_to_real,
)
from kinectdepthmapenhancement_tpu.core.config import (
    KDEConfig,
    RGBFConfig,
    SPDSPConfig,
    TOFConfig,
)
from kinectdepthmapenhancement_tpu.ops import (
    bilateral,
    ccl,
    ers,
    normals,
    plane,
    slic,
    tables,
)


class RGBFResult(NamedTuple):
    refined_depth: jnp.ndarray
    refined_labels: jnp.ndarray
    color_labels: jnp.ndarray
    depth_labels: jnp.ndarray


class KDEResult(NamedTuple):
    optimized_points: jnp.ndarray   # [H, W, 3] mm — the PROPOSED output
    plane_fitted: jnp.ndarray
    jbf_depth: jnp.ndarray
    normals: jnp.ndarray
    nasp_labels: jnp.ndarray
    merged_labels: jnp.ndarray
    merged_variance: jnp.ndarray
    merged_sizes: jnp.ndarray


class SPDSPResult(NamedTuple):
    optimized_points: jnp.ndarray
    plane_fitted: jnp.ndarray
    refined_depth: jnp.ndarray
    refined_labels: jnp.ndarray
    planes_nd: jnp.ndarray


class TOFResult(NamedTuple):
    optimized_points: jnp.ndarray   # == input points (optimisation disabled
                                    # in the reference, Projection_PCA.cu:118-125)
    plane_fitted: jnp.ndarray
    refined_depth: jnp.ndarray
    refined_labels: jnp.ndarray
    merged_labels: jnp.ndarray
    merged_eigenvalues: jnp.ndarray


def jbf_pipeline(depth, color, cfg: KDEConfig = KDEConfig()):
    """Standalone JBF baseline (main.cpp:179)."""
    return bilateral.joint_bilateral_filter(depth, color, cfg.jbf)


def mrf_pipeline(depth, color, cfg: KDEConfig = KDEConfig()):
    """Standalone MRF baseline (main.cpp:186)."""
    return bilateral.markov_random_field(depth, color, cfg.mrf)


def rgbf_pipeline(
    depth: jnp.ndarray,
    points: jnp.ndarray,
    color: jnp.ndarray,
    cfg: RGBFConfig = RGBFConfig(),
) -> RGBFResult:
    """RegionGrowingBilateralFilter::Process (RegionGrowingBilateralFilter.cpp:27-38):
    colour-SLIC + depth-SLIC -> edge-refined superpixel filter."""
    with jax.named_scope("rgbf.color_slic"):
        sp = slic.segment(color, points, grid=cfg.grid, params=cfg.color_slic, variant="dasp")
    with jax.named_scope("rgbf.depth_slic"):
        dasp = slic.segment(color, points, grid=cfg.grid, params=cfg.depth_slic, variant="dasp")
    with jax.named_scope("rgbf.ers"):
        refined = ers.edge_refined_superpixel(sp.labels, dasp.labels, depth, color, cfg.ers)
    return RGBFResult(
        refined_depth=refined.depth,
        refined_labels=refined.labels,
        color_labels=sp.labels,
        depth_labels=dasp.labels,
    )


def kde_pipeline(
    depth: jnp.ndarray,
    color: jnp.ndarray,
    intr: Intrinsics,
    cfg: KDEConfig = KDEConfig(),
) -> KDEResult:
    """KinectDepthEnhancement::Process — the PROPOSED method
    (KinectDepthEnhancement.cpp:56-81): JBF -> projective-to-real -> CM
    normals -> NASP -> CCL merge -> plane projection with
    variance_optimization + depth bilateral."""
    h, w = depth.shape
    rays = normalized_rays(intr, h, w)

    # jax.named_scope labels each stage in jax.profiler traces (SURVEY.md §5
    # tracing row); zero runtime cost, pure trace metadata.
    with jax.named_scope("kde.jbf"):
        jbf_depth = bilateral.joint_bilateral_filter(depth, color, cfg.jbf)
        points = projective_to_real(jbf_depth, intr)
    with jax.named_scope("kde.normals"):
        nmap = normals.generate_normal_map(points, cfg.normals)
    with jax.named_scope("kde.nasp"):
        nasp = slic.segment(
            color, points, nmap, grid=cfg.grid, params=cfg.nasp, variant="nasp"
        )
    # single-iteration NASP labels are cell-local, so CCL can reuse the
    # cell-local index (XLA CSEs its one-hot with the SLIC-internal one)
    nasp_cell = (
        slic.cell_index(nasp.labels, cfg.grid, neighborhood=8)
        if cfg.nasp.iterations == 1
        else None
    )
    with jax.named_scope("kde.ccl_merge"):
        if cfg.plane_merge:
            # plane-consistency merge (spec extension; see config.py and
            # ops/ccl.py::merge_planes) — same MergeResult keying, so the
            # whole projection / gate / fill block below is unchanged
            merged = ccl.merge_planes(
                points, nasp.labels, cfg.grid.num_clusters,
                index=nasp_cell, tau=cfg.pm_tau,
            )
        else:
            merged = ccl.merge_normals(
                nasp.labels, nasp.clusters.normal, nasp.clusters.center,
                cfg.ccl, index=nasp_cell,
            )
    with jax.named_scope("kde.projection"):
        # cell-local gather route for all per-merged-cluster tables (the
        # direct route costs a [H*W, K] one-hot matmul per gather)
        rep = merged.rep if nasp_cell is not None else None
        plane_fitted = plane.set_pseudo_depth_map(
            points, rays, merged.nd_map, merged.labels, merged.variance,
            index=nasp_cell, rep=rep,
        )
        # inf disables the plane-confidence gate STATICALLY (and skips the
        # residual computation) — exact reference behaviour
        if math.isinf(cfg.max_plane_residual):
            resid = None
        else:
            resid = plane.plane_fit_residual(
                points, plane_fitted, merged.labels, cfg.grid.num_clusters,
                index=nasp_cell, rep=rep,
            )
        optimized = plane.variance_optimization(
            points,
            plane_fitted,
            merged.labels,
            merged.variance,
            merged.sizes,
            min_cluster_size=cfg.min_cluster_size,
            agree_tight=cfg.agree_tight,
            agree_loose=cfg.agree_loose,
            fit_residual=resid,
            max_fit_residual=cfg.max_plane_residual,
            index=nasp_cell,
            rep=rep,
        )
        if cfg.fill_holes > 0:
            # per-pixel cluster-trust map: the same gates (and the same
            # gathers — XLA CSEs them) as variance_optimization
            tbl = jnp.concatenate(
                [
                    merged.variance[:, None],
                    merged.sizes.astype(jnp.float32)[:, None],
                ]
                + ([resid[:, None]] if resid is not None else []),
                axis=-1,
            )
            if nasp_cell is not None:
                g = nasp_cell.gather(tables.gather(tbl, merged.rep))
            else:
                g = tables.gather(tbl, merged.labels)
            trust = (
                (merged.labels > -1)
                & (jnp.minimum(g[..., 0], 1.0) > plane.COS_PI_8)
                & (g[..., 1] > cfg.min_cluster_size)
            )
            if resid is not None:
                trust = trust & (g[..., 2] < cfg.max_plane_residual)
            optimized = plane.plane_hole_fill(
                optimized, rays, merged.labels, merged.nd_map, trust,
                points[..., 2] <= plane.VALID_DEPTH_MM, cfg.fill_holes,
            )
        optimized = plane.depth_bilateral(optimized, rays, cfg.projection)
    return KDEResult(
        optimized_points=optimized,
        plane_fitted=plane_fitted,
        jbf_depth=jbf_depth,
        normals=nmap,
        nasp_labels=nasp.labels,
        merged_labels=merged.labels,
        merged_variance=merged.variance,
        merged_sizes=merged.sizes,
    )


_LOCAL_CAP = 4  # cell-locality cap for ERS-refined labels (runtime-checked)


def _with_local_index(fn, labels, grid, *, locality="auto"):
    """Run fn(index) with a cell-local label index over `labels` when the
    [-cap, cap-1]^2 locality invariant holds, falling back to fn(None) (the
    global [H*W, K]-one-hot route) via lax.cond otherwise — exact either way.

    ERS-refined labels inherit the SLIC labels' cell locality (the edge
    refinement only swaps labels within a 7 px window), so the cell route
    runs in practice; the runtime check guards the worst case.  locality
    mirrors SLICParams.locality: "cell" skips the check (vmapped serving —
    a batched cond executes both branches), "global" disables the index.
    """
    h, w = labels.shape
    idx = (
        slic.cell_index(labels, grid, neighborhood=2 * _LOCAL_CAP)
        if locality != "global"
        else None
    )
    if idx is None:
        return fn(None)
    if locality == "cell":
        return fn(idx)
    return jax.lax.cond(
        slic.labels_within_cap(labels, grid, _LOCAL_CAP, h, w),
        lambda _: fn(idx),
        lambda _: fn(None),
        None,
    )


def spdsp_pipeline(
    depth: jnp.ndarray,
    points: jnp.ndarray,
    color: jnp.ndarray,
    intr: Intrinsics,
    cfg: SPDSPConfig = SPDSPConfig(),
) -> SPDSPResult:
    """SPDepthSuperResolution::Process (SPDepthSuperResolution.cpp:57-191):
    SP + DASP (5 iters) -> ERS -> per-cluster PCA planes (on device here) ->
    plane projection with 20 MRF sweeps."""
    h, w = depth.shape
    rays = normalized_rays(intr, h, w)
    k = cfg.grid.num_clusters

    sp = slic.segment(color, points, grid=cfg.grid, params=cfg.color_slic, variant="dasp")
    dasp = slic.segment(color, points, grid=cfg.grid, params=cfg.depth_slic, variant="dasp")
    refined = ers.edge_refined_superpixel(sp.labels, dasp.labels, depth, color, cfg.ers)
    rpoints = projective_to_real(refined.depth, intr)

    # plane-confidence gate (spec extension; see SPDSPConfig): trust a
    # cluster's plane only when its PCA fit thickness sqrt(lambda_min) is
    # below max_plane_residual of the cluster centroid depth.  Normalising by
    # centroid z (not plane offset |d|, which shrinks for oblique planes and
    # would disable the gate exactly where planes graze the view direction).
    # inf disables the gate STATICALLY — exact reference behaviour
    # (Projection_GPU.cu:274-294 has no gate), tested end to end.
    def fit_and_project(index):
        planes = plane.pca_planes(rpoints, refined.labels, k, index=index)
        plane_fitted = plane.set_pseudo_depth_cluster(
            rpoints, rays, planes.nd, refined.labels, strict=False, index=index
        )
        if math.isinf(cfg.max_plane_residual):
            return planes, plane_fitted, ()
        resid_rel = jnp.sqrt(
            jnp.maximum(planes.eigenvalues, 0.0)
        ) / jnp.maximum(jnp.abs(planes.centers[:, 2]), 1.0)
        okf = (resid_rel < cfg.max_plane_residual).astype(jnp.float32)
        ok_map = (
            index.gather(okf[:, None])[..., 0]
            if index is not None
            else tables.gather(okf, refined.labels)
        )
        return planes, plane_fitted, (ok_map > 0.0,)

    planes, plane_fitted, gate = _with_local_index(
        fit_and_project, refined.labels, cfg.grid,
        locality=cfg.depth_slic.locality,
    )
    plane_ok = gate[0] if gate else None
    optimized = plane.mrf_optimization(
        rpoints, plane_fitted, rays, cfg.projection, gate_mask=plane_ok
    )
    return SPDSPResult(
        optimized_points=optimized,
        plane_fitted=plane_fitted,
        refined_depth=refined.depth,
        refined_labels=refined.labels,
        planes_nd=planes.nd,
    )


def tof_pipeline(
    depth: jnp.ndarray,
    points: jnp.ndarray,
    color: jnp.ndarray,
    intr: Intrinsics,
    cfg: TOFConfig = TOFConfig(),
) -> TOFResult:
    """TOFDepthInterpolation::Process (TOFDepthInterpolation.cpp:60-195):
    like SPDSP but keeps the smallest eigenvalue, merges with the PCA
    predicate, and projects WITHOUT iterative optimisation (the reference's
    optimisation kernels are commented out, so optimized == input points)."""
    h, w = depth.shape
    rays = normalized_rays(intr, h, w)
    k = cfg.grid.num_clusters

    sp = slic.segment(color, points, grid=cfg.grid, params=cfg.color_slic, variant="dasp")
    dasp = slic.segment(color, points, grid=cfg.grid, params=cfg.depth_slic, variant="dasp")
    refined = ers.edge_refined_superpixel(sp.labels, dasp.labels, depth, color, cfg.ers)
    rpoints = projective_to_real(refined.depth, intr)

    def fit_merge_project(index):
        planes = plane.pca_planes(rpoints, refined.labels, k, index=index)
        merged = ccl.merge_pca(
            refined.labels, planes.nd, planes.centers, planes.eigenvalues,
            cfg.ccl_pca, index=index,
        )
        plane_fitted = plane.set_pseudo_depth_cluster(
            rpoints, rays, planes.nd, refined.labels, strict=True, index=index
        )
        return planes, merged, plane_fitted

    planes, merged, plane_fitted = _with_local_index(
        fit_merge_project, refined.labels, cfg.grid,
        locality=cfg.depth_slic.locality,
    )
    return TOFResult(
        optimized_points=rpoints,
        plane_fitted=plane_fitted,
        refined_depth=refined.depth,
        refined_labels=refined.labels,
        merged_labels=merged.labels,
        merged_eigenvalues=merged.eigenvalues,
    )
