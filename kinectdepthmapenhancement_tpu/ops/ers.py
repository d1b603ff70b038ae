"""Edge-refined superpixels: boundary snapping + label-constrained bilateral.

JAX re-design of EdgeRefinedSuperpixel (reference
EdgeRefinedSuperpixel/EdgeRefinedSuperpixel.cu).

edge_refining (cu:4-102) snaps depth-superpixel boundaries to colour-
superpixel boundaries: at each depth-label discontinuity it scans up to
window/2 px (left-before-right / up-before-down, nearest first) for a colour-
label change, relabels the in-between run to the far side's depth label, and
zeroes depth where the step exceeds 10% of depth.  The CUDA version mutates
labels/depth in place from many threads and tolerates the races (SURVEY.md
§2 bug e).  Deterministic spec used here (documented):
  * boundary detection, relabel sources and zeroing tests all read the
    PRE-PASS labels/depth (horizontal pass), and the horizontal pass's output
    (vertical pass), matching the reference's intended two-phase order;
  * when several boundary commands cover the same pixel, the command from the
    NEAREST boundary wins; ties go to the left/up boundary;
  * depth zeroing is applied by the winning command only.

depthmap_enhancement (cu:104-205) is a three-pass 7x7 bilateral:
label-constrained weighted mean, label-constrained mean absolute deviation,
then an adaptive-colour-sigma bilateral.  The reference reassigns
`color_sigma` INSIDE the tap loop (sigma_{k+1} = adaptive if adaptive >
0.3*sigma_k else 0.3*sigma_k), collapsing sigma geometrically wherever the
local deviation is small; only its value-guard quirk (underflowed terms
skipped) keeps the filter functional.  FIXED (documented spec, see the
pass-3 comment): sigma = max(adaptive, 0.3*sigma_0) once per pixel.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core.buffer2d import VALID_DEPTH_MM
from kinectdepthmapenhancement_tpu.core.config import ERSParams
from kinectdepthmapenhancement_tpu.ops import stencil


class ERSResult(NamedTuple):
    labels: jnp.ndarray  # [H, W] i32 refined depth labels
    depth: jnp.ndarray   # [H, W] f32 refined depth


def _row_pass(
    color_labels: jnp.ndarray,
    labels: jnp.ndarray,
    depth: jnp.ndarray,
    half: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One horizontal snapping pass along rows (vectorised over all rows)."""
    h, w = labels.shape

    def sh(a, d, fill):
        """a shifted so that out[x] = a[x+d], filled out of range."""
        if d == 0:
            return a
        pad = jnp.full((h, abs(d)), fill, a.dtype)
        if d > 0:
            return jnp.concatenate([a[:, d:], pad], axis=1)
        return jnp.concatenate([pad, a[:, :d]], axis=1)

    # boundary at p: labels[p] != labels[p+1] (x+1 < w)
    lab_r = sh(labels, 1, -999999)
    boundary = (labels != lab_r) & (
        jnp.arange(w)[None, :] + 1 < w
    )

    # first colour-change distance & side per boundary pixel, d = 1..half,
    # left checked before right at each d (reference loop order)
    col = color_labels
    hit_d = jnp.full((h, w), half + 1, jnp.int32)
    hit_left = jnp.zeros((h, w), jnp.bool_)
    for d in range(1, half + 1):
        in_l = jnp.arange(w)[None, :] - d >= 0
        in_r = jnp.arange(w)[None, :] + d < w
        diff_l = in_l & (sh(col, -d, -1) != col)
        diff_r = in_r & (sh(col, d, -1) != col)
        unhit = hit_d > half
        hit_left = jnp.where(unhit & diff_l, True, hit_left)
        hit_d = jnp.where(unhit & (diff_l | diff_r), d, hit_d)
    has_hit = boundary & (hit_d <= half)
    left_cmd = has_hit & hit_left
    right_cmd = has_hit & ~hit_left

    # relabel targets: left hit -> labels[p+1]; right hit -> labels[p]
    lab_left_src = lab_r      # labels[x_p + 1]
    lab_right_src = labels    # labels[x_p]

    # depth-step zero tests (on pre-pass depth):
    # left-hit run compares depth[q] with depth[q+1]; right-hit with depth[q-1]
    dep_r = sh(depth, 1, 0.0)
    dep_l = sh(depth, -1, 0.0)
    zero_l = jnp.abs(depth - dep_r) > depth * 0.1
    zero_r = jnp.abs(depth - dep_l) > depth * 0.1

    new_labels = labels
    new_depth = depth
    decided = jnp.zeros((h, w), jnp.bool_)
    # candidates in priority order (nearest boundary, left/up first):
    # (j, side): (0, L@q), (1, R@q-1), (1, L@q+1), (2, R@q-2), (2, L@q+2)
    cands = []
    for j in range(0, half):
        if j > 0:
            cands.append((j, "right"))
        cands.append((j, "left"))
    for j, side in cands:
        if side == "left":
            # p = q + j is a left-hit boundary whose run [p-d+1, p] covers q
            cmd = sh(left_cmd, j, False) & (sh(hit_d, j, 0) >= j + 1)
            newl = sh(lab_left_src, j, -1)
            zero = zero_l
        else:
            # p = q - j is a right-hit boundary, run [p+1, p+d-1] covers q
            cmd = sh(right_cmd, -j, False) & (sh(hit_d, -j, 0) >= j + 1)
            newl = sh(lab_right_src, -j, -1)
            zero = zero_r
        take = cmd & ~decided
        new_labels = jnp.where(take, newl, new_labels)
        new_depth = jnp.where(take & zero, 0.0, new_depth)
        decided = decided | take
    return new_labels, new_depth


def edge_refine(
    color_labels: jnp.ndarray,
    depth_labels: jnp.ndarray,
    depth: jnp.ndarray,
    p: ERSParams = ERSParams(),
) -> ERSResult:
    """edge_refining (cu:4-102): horizontal pass, then vertical pass on its
    output."""
    half = p.window // 2
    lab1, dep1 = _row_pass(color_labels, depth_labels, depth, half)
    lab2t, dep2t = _row_pass(color_labels.T, lab1.T, dep1.T, half)
    return ERSResult(labels=lab2t.T, depth=dep2t.T)


def depth_enhance(
    refined: ERSResult,
    color: jnp.ndarray,
    p: ERSParams = ERSParams(),
) -> jnp.ndarray:
    """depthmap_enhancement (cu:104-205): 3-pass adaptive bilateral."""
    depth, labels = refined.depth, refined.labels
    h, w = depth.shape
    r = p.window // 2
    cf = color.astype(jnp.float32)
    spatial = stencil.gaussian_spatial_filter(p.window, p.spatial_sigma)
    dpad = stencil.pad2d(depth, r, 0.0)
    cpad = stencil.pad2d(cf, r, 0.0)
    lpad = stencil.pad2d(labels, r, -999999)

    # terms are gated on their SIGMA, not their value (the reference's
    # `if (term != 0)` guards are a computed-or-not proxy that misfires on
    # f32 underflow — fixed; see ops/bilateral.py docstring)

    # pass 1: label-constrained weighted mean
    wsum = jnp.zeros((h, w), jnp.float32)
    dsum = jnp.zeros((h, w), jnp.float32)
    for dy, dx in stencil.offsets(p.window):
        nd = stencil.shift(dpad, dy, dx, r, (h, w))
        ng = stencil.shift(cpad, dy, dx, r, (h, w))
        nl = stencil.shift(lpad, dy, dx, r, (h, w))
        ok = (nd > VALID_DEPTH_MM) & (nl == labels)
        filt = jnp.broadcast_to(spatial[dy + r, dx + r], (h, w))
        if p.color_sigma:
            cdiff = jnp.sum(jnp.square(cf - ng), axis=-1)
            filt = filt * jnp.exp(-cdiff / (2.0 * p.color_sigma**2))
        filt = jnp.where(ok, filt, 0.0)
        dsum = dsum + nd * filt
        wsum = wsum + filt
    w_avg = dsum / jnp.where(wsum > 0, wsum, 1.0)

    # pass 2: label-constrained mean absolute deviation
    cnt = jnp.zeros((h, w), jnp.float32)
    dev = jnp.zeros((h, w), jnp.float32)
    for dy, dx in stencil.offsets(p.window):
        nd = stencil.shift(dpad, dy, dx, r, (h, w))
        nl = stencil.shift(lpad, dy, dx, r, (h, w))
        ok = (nd > VALID_DEPTH_MM) & (nl == labels)
        dev = dev + jnp.where(ok, jnp.abs(nd - w_avg), 0.0)
        cnt = cnt + ok
    dev = dev / jnp.where(cnt > 0, cnt, 1.0)

    # pass 3: adaptive-sigma bilateral (NOT label-constrained).
    #
    # Bug-fidelity decision (cu:170-179): the reference reassigns color_sigma
    # INSIDE the tap loop — `sigma = adaptive if adaptive > 0.3*sigma else
    # 0.3*sigma` per valid tap — so wherever adaptive is small the sigma
    # COLLAPSES geometrically (50 -> 50*0.3^k), the colour Gaussian underflows
    # to 0 for every tap, and only the value-guard quirk (terms skipped when
    # exactly 0) keeps the filter functional by silently dropping the colour
    # term.  The obvious intent of the clamp is a per-pixel floor, not a
    # recurrence.  FIXED (documented spec): sigma_eff = max(adaptive,
    # 0.3 * sigma_0) computed ONCE per pixel; terms are sigma-gated (see
    # ops/bilateral.py on the fixed value-guard quirk).  oracle_ers.py matches.
    adaptive = 5.0 * dev / jnp.square(jnp.where(w_avg != 0.0, w_avg, 1.0))
    sigma = jnp.maximum(adaptive, p.color_sigma * 0.3)
    num = jnp.zeros((h, w), jnp.float32)
    den = jnp.zeros((h, w), jnp.float32)
    for dy, dx in stencil.offsets(p.window):
        nd = stencil.shift(dpad, dy, dx, r, (h, w))
        ng = stencil.shift(cpad, dy, dx, r, (h, w))
        ok = nd > VALID_DEPTH_MM
        filt = jnp.broadcast_to(spatial[dy + r, dx + r], (h, w))
        if p.color_sigma:
            cdiff = jnp.sum(jnp.square(cf - ng), axis=-1)
            filt = filt * jnp.exp(
                -cdiff / (2.0 * jnp.square(jnp.maximum(sigma, 1e-30)))
            )
        if p.depth_sigma:
            filt = filt * jnp.exp(-jnp.square(nd - w_avg) / (2.0 * p.depth_sigma**2))
        filt = jnp.where(ok, filt, 0.0)
        num = num + nd * filt
        den = den + filt
    out = jnp.where(den != 0.0, num / jnp.where(den != 0.0, den, 1.0), 0.0)
    return jnp.where(wsum > 0.0, out, 0.0)


def edge_refined_superpixel(
    color_labels: jnp.ndarray,
    depth_labels: jnp.ndarray,
    depth: jnp.ndarray,
    color: jnp.ndarray,
    p: ERSParams = ERSParams(),
) -> ERSResult:
    """EdgeRefinedSuperpixel::EdgeRefining (cu:208-223): snap + enhance."""
    refined = edge_refine(color_labels, depth_labels, depth, p)
    enhanced = depth_enhance(refined, color, p)
    return ERSResult(labels=refined.labels, depth=enhanced)
