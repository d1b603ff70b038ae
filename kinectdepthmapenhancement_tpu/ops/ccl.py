"""Superpixel merging via connected components over the cluster graph.

JAX re-design of LabelEquivalenceSeg(+PCA) (reference
LabelEquivalenceSeg/*.cu).  The reference runs a Hawick/Kalentev-style
label-equivalence loop over the full PIXEL grid: 10 rounds of per-pixel
neighbour scans with atomicMin into a union-find table + pointer jumping,
then atomicAdd accumulation of merged-cluster stats.

Observation: the merge predicate (compNormal) depends only on the two
pixels' ORIGINAL cluster ids — so the pixel-level fixpoint equals connected
components over the ~300-node cluster adjacency graph.  We therefore
  1. build the cluster adjacency matrix from 4-neighbour pixel pairs
     (one scatter-max over cluster-id pairs),
  2. apply the predicate on the [K, K] matrix,
  3. run min-label propagation + path compression on a length-K vector to
     convergence (lax.while_loop),
  4. compute merged stats with segment-sums.

Fidelity notes:
  * the reference runs a FIXED 10 scan/analysis rounds, which under-merges
    components whose cluster-graph eccentricity exceeds ~10 hops; we run to
    convergence (documented deviation — strictly more merged, normally equal).
  * compNormal requires acos(n1.n2) > 0, so two clusters with exactly equal
    normals do NOT merge (dot == 1 fails); the PCA variant has no such term
    and does merge them.  Both replicated.
  * the scan kernel's edge clamp uses `width`/`height` instead of w-1/h-1
    (reads one past the row/buffer); FIXED to a proper clamp, which makes the
    border neighbour self-comparisons no-ops as intended.
  * pixels whose cluster label is -1 index cluster_normals[-1] in the
    reference (out-of-bounds read); their merged label is forced to -1 on
    every path regardless, which is what we produce directly.
"""

from __future__ import annotations

from typing import NamedTuple

import math

import jax
import jax.numpy as jnp
from jax import lax

from kinectdepthmapenhancement_tpu.core.config import CCLParams, CCLPCAParams
from kinectdepthmapenhancement_tpu.ops import tables
from kinectdepthmapenhancement_tpu.ops import slic as slic_mod

INVALID_ND = 5.0


class MergeResult(NamedTuple):
    labels: jnp.ndarray       # [H, W] i32: merged cluster id (component min) or -1
    nd_map: jnp.ndarray       # [H, W, 4] f32: per-pixel merged plane (n, d)
    variance: jnp.ndarray     # [K] f32: per merged-cluster normal coherence
    sizes: jnp.ndarray        # [K] i32: per merged-cluster pixel count
    cluster_nd: jnp.ndarray   # [K, 4] f32: per merged-cluster plane
    eigenvalues: jnp.ndarray  # [K] f32 (PCA variant; zeros otherwise)
    eigen_map: jnp.ndarray    # [H, W] f32 (PCA variant; zeros otherwise)
    rep: jnp.ndarray          # [K] i32: component representative per ORIGINAL id


def _adjacency(idx) -> jnp.ndarray:
    """[K, K] bool: cluster pairs adjacent via a 4-neighbour pixel pair,
    counted through the label index (cell-local pair matrices when the
    labels are single-iteration SLIC output, one-hot products otherwise)."""
    labels = idx.labels
    h, w = labels.shape
    right = jnp.concatenate(
        [labels[:, 1:], jnp.full((h, 1), -1, labels.dtype)], axis=1
    )
    down = jnp.concatenate(
        [labels[1:, :], jnp.full((1, w), -1, labels.dtype)], axis=0
    )
    counts = idx.pair_counts(right) + idx.pair_counts(down)
    return (counts + counts.T) > 0.0


def _components(mergeable: jnp.ndarray, valid: jnp.ndarray) -> jnp.ndarray:
    """Min-label connected components over [K, K] bool adjacency.
    Returns rep [K] i32 (component minimum id); invalid nodes keep own id
    (they have no mergeable edges, so reachability leaves them alone).

    Computed as transitive closure by boolean matrix squaring:
    ceil(log2(K)) rounds of R <- (R @ R > 0) cover every path (bf16 0/1
    operands, f32 accumulation — counts < 2^24, exact), then rep = min
    reachable id.  Replaces the data-dependent while_loop of rounds of
    min-propagation + pointer jumping, whose serial [K]-vector chain is a
    long sequence of tiny dependent kernels."""
    k = mergeable.shape[0]
    del valid  # invalid nodes are isolated in `mergeable` by construction
    ids = jnp.arange(k, dtype=jnp.int32)
    reach = (mergeable | jnp.eye(k, dtype=bool)).astype(jnp.bfloat16)
    for _ in range(max(1, math.ceil(math.log2(k)))):
        sq = lax.dot_general(
            reach, reach,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        reach = (sq > 0.0).astype(jnp.bfloat16)
    return jnp.min(
        jnp.where(reach > 0.0, ids[None, :], k), axis=1
    ).astype(jnp.int32)


def _merge(
    labels: jnp.ndarray,
    cluster_nd: jnp.ndarray,      # [K, 4]
    cluster_valid: jnp.ndarray,   # [K] bool
    cluster_centers: jnp.ndarray, # [K, 3]
    predicate,
    eigenvalues: jnp.ndarray | None,
    index=None,
) -> MergeResult:
    """index: optional cell-local label index (slic.cell_index) when `labels`
    are single-iteration SLIC output; falls back to the global index.

    Every per-pixel quantity of the reference's count/calc_nd kernels is a
    pure function of the pixel's ORIGINAL cluster id, so all stats collapse
    to K-side table algebra: one per-label pixel histogram + [K]-vector
    segment sums keyed by the component representative + ONE final per-pixel
    gather for the output maps.  (Mathematically identical to the pixel-level
    accumulation; f32 grouping differs only by summation order.)"""
    h, w = labels.shape
    k = cluster_nd.shape[0]
    idx = index if index is not None else slic_mod._GlobalIndex(labels, k)

    adj = _adjacency(idx)
    na = cluster_nd[:, None, :3]
    nb = cluster_nd[None, :, :3]
    dot = jnp.sum(na * nb, axis=-1)
    dd = jnp.abs(cluster_nd[:, None, 3] - cluster_nd[None, :, 3])
    pred = predicate(dot, dd)
    mergeable = adj & pred & cluster_valid[:, None] & cluster_valid[None, :]

    rep = _components(mergeable, cluster_valid)

    # ---- stats (countKernel / calculate_nd), K-side
    counts = idx.counts()                       # [K] pixels per original id
    valid_f = cluster_valid.astype(jnp.float32)
    cnt_v = counts * valid_f                    # pix_valid pixels per id
    feats_k = jnp.concatenate(
        [
            cluster_nd[:, :3] * cnt_v[:, None],
            cluster_centers * cnt_v[:, None],
            cnt_v[:, None],
        ]
        + ([eigenvalues[:, None] * cnt_v[:, None]] if eigenvalues is not None else []),
        axis=-1,
    )
    sums = tables.segment_sum(feats_k, rep, k)  # [K(merged), F] — tiny
    sizes = sums[:, 6]
    safe = jnp.maximum(sizes, 1.0)
    mean_n = sums[:, 0:3] / safe[:, None]
    mean_c = sums[:, 3:6] / safe[:, None]
    mdist = jnp.abs(jnp.sum(mean_n * mean_c, axis=-1))
    merged_nd_k = jnp.concatenate([mean_n, mdist[:, None]], axis=-1)

    # variance: mean over member pixels of dot(original nd, merged mean
    # normal) == dot(sum of member nd3, mean normal) / size
    var_sum = jnp.sum(sums[:, 0:3] * mean_n, axis=-1) / safe
    eig_k = (
        sums[:, 7] / safe if eigenvalues is not None else jnp.zeros((k,), jnp.float32)
    )

    # ---- per-pixel maps: K-side composition + ONE gather by original labels
    by_rep = jnp.concatenate(
        [merged_nd_k] + ([eig_k[:, None]] if eigenvalues is not None else []),
        axis=-1,
    )
    by_k = tables.gather(by_rep, rep)           # [K, 4(+1)] — tiny
    tbl = jnp.concatenate(
        [
            rep.astype(jnp.float32)[:, None],
            valid_f[:, None],
            by_k,
        ],
        axis=-1,
    )
    g = idx.gather(tbl)
    pix_valid = (labels >= 0) & (g[..., 1] > 0.0)
    merged = jnp.where(pix_valid, g[..., 0].astype(jnp.int32), -1)
    nd_map = jnp.where((merged >= 0)[..., None], g[..., 2:6], 0.0)
    if eigenvalues is not None:
        eig_map = jnp.where(merged >= 0, g[..., 6], 0.0)
    else:
        eig_map = jnp.zeros((h, w), jnp.float32)

    return MergeResult(
        labels=merged,
        nd_map=nd_map,
        variance=var_sum,
        sizes=sizes.astype(jnp.int32),
        cluster_nd=merged_nd_k,
        eigenvalues=eig_k,
        eigen_map=eig_map,
        rep=rep,
    )


def merge_normals(
    labels: jnp.ndarray,
    cluster_normals: jnp.ndarray,  # [K, 3], -1 sentinel
    cluster_centers: jnp.ndarray,  # [K, 3]
    p: CCLParams = CCLParams(),
    index=None,
) -> MergeResult:
    """LabelEquivalenceSeg::labelImage (LabelEquivalenceSeg.cu:228-282).

    Per-cluster plane: n = cluster normal, d = |n . center| (initLabel,
    cu:8-35); merge when 0 < acos(n1.n2) < pi/8 and |d1-d2| < offset max.
    """
    valid = jnp.any(cluster_normals != -1.0, axis=-1)
    d = jnp.abs(jnp.sum(cluster_normals * cluster_centers, axis=-1))
    nd = jnp.concatenate([cluster_normals, d[:, None]], axis=-1)
    nd = jnp.where(valid[:, None], nd, INVALID_ND)
    cos_max = math.cos(p.normal_angle_max)

    def predicate(dot, dd):
        # acos(dot) > 0  <=>  dot < 1;  acos(dot) < max  <=>  dot > cos(max);
        # dot > 1 -> acos is NaN -> both comparisons false in the reference.
        return (dot < 1.0) & (dot > cos_max) & (dd < p.plane_offset_max)

    return _merge(labels, nd, valid, cluster_centers, predicate, None, index=index)


def merge_pca(
    labels: jnp.ndarray,
    cluster_nd: jnp.ndarray,       # [K, 4] host-PCA planes; invalid = 5.0s
    cluster_centers: jnp.ndarray,  # [K, 3]
    eigenvalues: jnp.ndarray,      # [K]
    p: CCLPCAParams = CCLPCAParams(),
    index=None,
) -> MergeResult:
    """LabelEquivalenceSegPCA::labelImage (LabelEquivalenceSegPCA.cu:219-299).

    Validity test |nd.x| < 1.1 (invalid sentinel 5.0); predicate
    |acos(n1.n2)| < pi/8 (equal normals DO merge) and |d1-d2| < 700.
    """
    valid = jnp.abs(cluster_nd[:, 0]) < 1.1
    cos_max = math.cos(p.normal_angle_max)

    def predicate(dot, dd):
        return (dot <= 1.0) & (dot > cos_max) & (dd < p.plane_offset_max)

    return _merge(
        labels, cluster_nd, valid, cluster_centers, predicate, eigenvalues,
        index=index,
    )


def merge_planes(
    points: jnp.ndarray,
    labels: jnp.ndarray,
    k: int,
    *,
    index=None,
    tau: float = 0.0035,
    min_points: int = 100,
) -> MergeResult:
    """Plane-consistency CCL merge (spec extension, round 5; no reference
    equivalent — LabelEquivalenceSeg.cu:228-282 merges by per-cluster NORMAL
    similarity, which over-merges on far-range banded depth where the
    per-pixel normals are quantization-biased: measured on the EVAL_FAR
    scene, every normal-merged cluster spans multiple true surfaces and no
    plane fits one better than 0.77% relative RMS, so the plane-confidence
    gate disables the projection stage entirely and the PROPOSED method
    degenerates to its bilateral passes).

    This merge instead fits a least-squares plane per ORIGINAL superpixel
    (valid-depth members only) and merges adjacent clusters whose planes
    mutually explain each other's members:

        cross(p -> q) = RMS over q's members x of (z_plane_p(x) - z(x)) / z

    evaluated in closed form from per-cluster moments: with w = n/d the
    inverse-depth plane coefficient (1/z_plane = w . u along the unit-z ray
    u = x/z, so the relative z error at x is 1 - w . x to first order),

        cross^2(p -> q) = (1 - w_p . mean_q)^2 + w_p^T C_q w_p

    where mean_q / C_q are the mean and covariance of q's member vertices —
    both already computed for the fits; no per-pixel work per pair.  Merged
    components are refit from recombined moments (parallel-axis, f32-safe)
    so each component's plane is the LSQ fit of ALL its members.  On the
    far-range scene this recovers the true surfaces to < 1 mm where the
    normal merge left 5-20% misfits (EVAL_FAR.md round 5).

    Returns a MergeResult keyed exactly like merge_normals, so the whole
    downstream projection / residual-gate / hole-fill machinery is reused
    unchanged (variance = member-plane coherence vs the component plane,
    which keeps set_pseudo_depth_map's acos(variance) < pi/8 gate
    meaningful)."""
    from kinectdepthmapenhancement_tpu.core.buffer2d import VALID_DEPTH_MM

    h, w = points.shape[:2]
    z = points[..., 2]
    idx = index if index is not None else slic_mod._GlobalIndex(labels, k)
    mask = (labels >= 0) & (z > VALID_DEPTH_MM)

    ones = jnp.ones((h, w, 1), jnp.float32)
    sums = idx.segment_sum(jnp.concatenate([points, ones], axis=-1), mask)
    cnt = sums[:, 3]
    safe = jnp.maximum(cnt, 1.0)
    mean = sums[:, :3] / safe[:, None]
    centered = jnp.where(mask[..., None], points - idx.gather(mean), 0.0)
    cx, cy, cz = centered[..., 0], centered[..., 1], centered[..., 2]
    sq = jnp.stack([cx * cx, cx * cy, cx * cz, cy * cy, cy * cz, cz * cz], -1)
    scat = idx.segment_sum(sq, mask)  # [K, 6] centred scatter

    def cov3(scat6, n):
        n = jnp.maximum(n, 1.0)[:, None, None]
        return jnp.stack(
            [
                jnp.stack([scat6[:, 0], scat6[:, 1], scat6[:, 2]], -1),
                jnp.stack([scat6[:, 1], scat6[:, 3], scat6[:, 4]], -1),
                jnp.stack([scat6[:, 2], scat6[:, 4], scat6[:, 5]], -1),
            ],
            axis=1,
        ) / n

    def regress(scat6, mean_, n_):
        """z-regression plane z = a x + b y + c from centred moments: a 2x2
        solve, far better conditioned in f32 than the total-LSQ eigenproblem
        (smallest eigenvalue ~ noise^2 under a matrix norm ~ extent^2; the
        closed-form cubic there loses enough precision to tilt the normal by
        ~1e-3 rad, ~3 mm of depth across a component — measured round 5).
        It also minimises exactly the z-residual that plane_fit_residual
        gates on, and matches the sensor's z-only noise model."""
        sxx, sxy, sxz = scat6[:, 0], scat6[:, 1], scat6[:, 2]
        syy, syz = scat6[:, 3], scat6[:, 4]
        det = sxx * syy - sxy * sxy
        solvable = det > 1e-6
        det_s = jnp.where(solvable, det, 1.0)
        a = (sxz * syy - syz * sxy) / det_s
        b = (sxx * syz - sxy * sxz) / det_s
        # plane n . x = d with n ~ (-a, -b, 1) normalised, d = n . mean
        nv = jnp.stack([-a, -b, jnp.ones_like(a)], axis=-1)
        nv = nv / jnp.linalg.norm(nv, axis=-1, keepdims=True)
        dv = jnp.sum(nv * mean_, axis=-1)
        sgn = jnp.where(dv < 0.0, -1.0, 1.0)
        return nv * sgn[:, None], dv * sgn, solvable & (n_ >= 3.0)

    cov = cov3(scat, cnt)
    nvec, d, fit_ok = regress(scat, mean, cnt)
    valid_c = fit_ok & (cnt >= float(min_points)) & (d > 1e-3)

    w_vec = nvec / jnp.maximum(d, 1e-6)[:, None]  # [K, 3] inverse-depth coeff
    # HIGHEST precision is load-bearing: an f32 product without it may run
    # in bf16 or TF32, and (1 - a) must resolve ~1e-3 while a ~ 1.0 — at
    # bf16's ~3e-3 the merge test is noise (components fragment 85 -> 160)
    hi = lax.Precision.HIGHEST
    a = jnp.einsum("pi,qi->pq", w_vec, mean, precision=hi)
    b = jnp.einsum("pi,qij,pj->pq", w_vec, cov, w_vec, precision=hi)
    cross2 = jnp.square(1.0 - a) + b
    ok = cross2 < tau * tau
    mergeable = (
        _adjacency(idx) & ok & ok.T & valid_c[:, None] & valid_c[None, :]
    )
    rep = _components(mergeable, valid_c)

    # ---- component refit from recombined moments (parallel-axis, f32-safe:
    # the correction terms are (cluster mean - component mean) deltas, not
    # raw coordinate moments)
    sums_c = tables.segment_sum(sums, rep, k)  # [K, 4] keyed by rep id
    cnt_c = sums_c[:, 3]
    mean_c = sums_c[:, :3] / jnp.maximum(cnt_c, 1.0)[:, None]
    delta = mean - jnp.take(mean_c, rep, axis=0)
    ex, ey, ez = delta[:, 0], delta[:, 1], delta[:, 2]
    corr = (
        jnp.stack([ex * ex, ex * ey, ex * ez, ey * ey, ey * ez, ez * ez], -1)
        * cnt[:, None]
    )
    scat_c = tables.segment_sum(scat + corr, rep, k)
    nc, dc, _ = regress(scat_c, mean_c, cnt_c)
    cluster_nd = jnp.concatenate([nc, dc[:, None]], axis=-1)  # keyed by rep

    # variance := coherence of member-cluster planes with the component
    # plane (weighted mean of |n_member . n_component|), so the existing
    # acos(variance) < pi/8 gates stay meaningful
    coh = jnp.abs(jnp.sum(nvec * jnp.take(nc, rep, axis=0), axis=-1))
    var_sum = tables.segment_sum(
        (coh * cnt * valid_c.astype(jnp.float32))[:, None], rep, k
    )[:, 0]
    variance = var_sum / jnp.maximum(cnt_c, 1.0)

    # ---- per-pixel maps: K-side composition + ONE gather (as in _merge)
    by_k = tables.gather(cluster_nd, rep)  # [K, 4]
    tbl = jnp.concatenate(
        [
            rep.astype(jnp.float32)[:, None],
            valid_c.astype(jnp.float32)[:, None],
            by_k,
        ],
        axis=-1,
    )
    g = idx.gather(tbl)
    pix_valid = (labels >= 0) & (g[..., 1] > 0.0)
    merged = jnp.where(pix_valid, g[..., 0].astype(jnp.int32), -1)
    nd_map = jnp.where((merged >= 0)[..., None], g[..., 2:6], 0.0)

    return MergeResult(
        labels=merged,
        nd_map=nd_map,
        variance=variance,
        sizes=cnt_c.astype(jnp.int32),
        cluster_nd=cluster_nd,
        eigenvalues=jnp.zeros((k,), jnp.float32),
        eigen_map=jnp.zeros((h, w), jnp.float32),
        rep=rep,
    )
