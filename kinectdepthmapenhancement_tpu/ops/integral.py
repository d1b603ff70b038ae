"""Integral images (summed-area tables) for normal estimation.

Replaces the reference's 574-line Blelloch row/column scan machinery
(NormalEstimation/IntegralImageGenerator.cu) with two `jnp.cumsum`s.  The
reference scans are exclusive prescans over zero-padded buffers, giving the
exclusive 2-D prefix  I[v, u] = sum_{r < v, c < u};  box sums are read as
I[v+vv, u+uu] + I[v, u] - I[v+vv, u] - I[v, u+uu]
(getSumFromIntegralImageD, NormalMapGenerator.cu:20-27) — i.e. the sum over
rows [v, v+vv) x cols [u, u+uu).  We reproduce that layout exactly with an
(H+1, W+1) exclusive prefix.

Precision: the reference accumulates in double.  The pipelines run in f32, so
we use a mean-centering decomposition instead of f64 emulation: for channel c,
store the prefix of (c - mu_c) * valid plus an exact integer count prefix
(counts < 2^24 are exact in f32); a box sum is then
    box(c) = box(c - mu_c) + mu_c * box(count_all)
where the centred prefix stays ~sqrt(N) * sigma instead of N * mean, removing
the catastrophic cancellation of differencing large corner values.
Here mu is taken over all pixels and invalid vertices are exactly (0,0,0)
(projective_to_real of z=0), so summing all pixels equals summing valid ones,
matching the reference which sums every pixel unconditionally
(copy_*_NormalToMaxD) while counting only z != 0 (checkValidVertex,
IntegralImageGenerator.cu:102-110).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class CenteredIntegral(NamedTuple):
    """Exclusive 2-D prefix of mean-centred channels + exact pixel count."""

    centered: jnp.ndarray  # [H+1, W+1, C] f32 prefix of (c - mu)
    count: jnp.ndarray     # [H+1, W+1] f32 prefix of all-ones (exact ints)
    valid: jnp.ndarray     # [H+1, W+1] f32 prefix of (z != 0) (exact ints)
    mu: jnp.ndarray        # [C] f32 channel means (over all pixels)


def _ex_prefix(x: jnp.ndarray) -> jnp.ndarray:
    """Exclusive 2-D prefix sum: out[v, u] = sum_{r<v, c<u} x[r, c]."""
    s = jnp.cumsum(jnp.cumsum(x, axis=0, dtype=jnp.float32), axis=1, dtype=jnp.float32)
    pads = [(1, 0), (1, 0)] + [(0, 0)] * (x.ndim - 2)
    return jnp.pad(s, pads)


def build(channels: jnp.ndarray, valid: jnp.ndarray) -> CenteredIntegral:
    """channels: [H, W, C] f32 (invalid pixels must already be zeroed);
    valid: [H, W] bool."""
    h, w, _ = channels.shape
    n = float(h * w)
    mu = jnp.sum(channels, axis=(0, 1)) / n
    centered = _ex_prefix(channels - mu[None, None, :])
    count = _ex_prefix(jnp.ones((h, w), jnp.float32))
    vcount = _ex_prefix(valid.astype(jnp.float32))
    return CenteredIntegral(centered=centered, count=count, valid=vcount, mu=mu)


def _corners(ii: jnp.ndarray, u, v, uu, vv):
    """I_incl[v+vv, u+uu] + I_incl[v, u] - I_incl[v+vv, u] - I_incl[v, u+uu].

    The reference integrals are INCLUSIVE scans (the Blelloch prescan adds the
    input back, IntegralImageGenerator.cu:44-46), so this is the sum over rows
    (v, v+vv] x cols (u, u+uu].  Our table is the exclusive (H+1, W+1) prefix,
    where I_incl[v, u] == ex[v+1, u+1]; indices shift by +1 accordingly.
    u, v may be per-pixel arrays (per-pixel smoothing radii); indices are
    clipped to the table, matching in-bounds reference behaviour for interior
    pixels (border pixels are masked invalid by the callers).
    """
    hmax = ii.shape[0] - 1
    wmax = ii.shape[1] - 1
    v0 = jnp.clip(v + 1, 0, hmax)
    u0 = jnp.clip(u + 1, 0, wmax)
    v1 = jnp.clip(v + vv + 1, 0, hmax)
    u1 = jnp.clip(u + uu + 1, 0, wmax)
    return ii[v1, u1] + ii[v0, u0] - ii[v1, u0] - ii[v0, u1]


def box_count(ci: CenteredIntegral, u, v, uu, vv) -> jnp.ndarray:
    """Valid-pixel count over the box (getFiniteElementsCount)."""
    return _corners(ci.valid, u, v, uu, vv)


class PaddedIntegral(NamedTuple):
    """Zero-padded prefix tables for gather-free fixed-offset box sums.

    Per-pixel window SIZES would need per-pixel gathers; instead callers
    loop over the (few, discrete) sizes and read boxes at FIXED offsets via
    slices of these padded tables, selecting per pixel afterwards."""

    centered: jnp.ndarray  # [H+1+2P, W+1+2P, C]
    count: jnp.ndarray     # [H+1+2P, W+1+2P]
    valid: jnp.ndarray
    mu: jnp.ndarray
    pad: int
    shape: tuple  # (H, W)


def pad_tables(ci: CenteredIntegral, pad: int, h: int, w: int) -> PaddedIntegral:
    def p2(x):
        pads = [(pad, pad), (pad, pad)] + [(0, 0)] * (x.ndim - 2)
        return jnp.pad(x, pads)

    return PaddedIntegral(
        centered=p2(ci.centered), count=p2(ci.count), valid=p2(ci.valid),
        mu=ci.mu, pad=pad, shape=(h, w),
    )


def _corner_slice(tbl: jnp.ndarray, pi: PaddedIntegral, dv: int, du: int):
    """tbl view so out[y, x] = tbl_unpadded[y + dv, x + du] (zero out of range)."""
    h, w = pi.shape
    start = [pi.pad + dv, pi.pad + du] + [0] * (tbl.ndim - 2)
    sizes = [h, w] + list(tbl.shape[2:])
    from jax import lax

    return lax.slice(tbl, start, [s + z for s, z in zip(start, sizes)])


def _fixed_corners(tbl, pi: PaddedIntegral, u_off: int, v_off: int, uu: int, vv: int):
    """Box sum over rows (y+v_off, y+v_off+vv] x cols (x+u_off, x+u_off+uu]
    for every pixel, with STATIC offsets (inclusive-integral convention:
    table index +1, see _corners)."""
    v0, u0 = v_off + 1, u_off + 1
    return (
        _corner_slice(tbl, pi, v0 + vv, u0 + uu)
        + _corner_slice(tbl, pi, v0, u0)
        - _corner_slice(tbl, pi, v0 + vv, u0)
        - _corner_slice(tbl, pi, v0, u0 + uu)
    )


def fixed_box_count(pi: PaddedIntegral, u_off: int, v_off: int, uu: int, vv: int):
    return _fixed_corners(pi.valid, pi, u_off, v_off, uu, vv)


def fixed_box_sum_all(pi: PaddedIntegral, u_off: int, v_off: int, uu: int, vv: int):
    c = _fixed_corners(pi.centered, pi, u_off, v_off, uu, vv)
    n = _fixed_corners(pi.count, pi, u_off, v_off, uu, vv)
    return c + pi.mu * n[..., None]


def fixed_box_sum(pi: PaddedIntegral, channel: int, u_off: int, v_off: int, uu: int, vv: int):
    c = _fixed_corners(pi.centered[..., channel], pi, u_off, v_off, uu, vv)
    n = _fixed_corners(pi.count, pi, u_off, v_off, uu, vv)
    return c + pi.mu[channel] * n


def box_sum(ci: CenteredIntegral, channel: int, u, v, uu, vv) -> jnp.ndarray:
    """Sum of `channel` over the box, de-centred."""
    c = _corners(ci.centered[..., channel], u, v, uu, vv)
    n = _corners(ci.count, u, v, uu, vv)
    return c + ci.mu[channel] * n


def box_sum_all(ci: CenteredIntegral, u, v, uu, vv) -> jnp.ndarray:
    """All channels at once -> [..., C]."""
    c = _corners(ci.centered, u, v, uu, vv)
    n = _corners(ci.count, u, v, uu, vv)
    return c + ci.mu * n[..., None]
