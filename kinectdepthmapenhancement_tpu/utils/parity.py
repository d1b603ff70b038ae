"""Parity assertions of the composed pipelines against their NumPy oracles.

Shared by the oracle-parity tests (tests/test_oracle_pipeline.py) and the
on-card smoke run (chip_smoke.py), so both hold the device to the same
contract.  `want` maps the oracle's output names to arrays.

Labels are integer handoffs and must agree except at argmin ties flipped by
f32-vs-f64 input drift; depths accumulate f32-vs-f64 differences through 4+
filter stages, so values use a small mm tolerance plus agreement fractions
at the few pixels where a gate flips on an f32 boundary.
"""

from __future__ import annotations

from typing import Mapping

import jax
import numpy as np

from kinectdepthmapenhancement_tpu.models import pipelines

# one jitted program per configuration, shared by every caller in a process
kde = jax.jit(pipelines.kde_pipeline, static_argnums=(2, 3))
rgbf = jax.jit(pipelines.rgbf_pipeline, static_argnums=(3,))


def assert_kde_matches(res, want: Mapping[str, np.ndarray]) -> None:
    """res: a KDEResult; want: keys jbf, normals, nasp_labels,
    merged_labels, optimized_points."""
    # stage 1: JBF depth — pure filter arithmetic, f32 vs f64 only
    np.testing.assert_allclose(
        np.asarray(res.jbf_depth), want["jbf"], rtol=2e-4, atol=0.25
    )

    # stage 2: normals agree in direction almost everywhere (the covariance
    # eigenvector is ill-conditioned exactly at depth edges)
    got_n = np.asarray(res.normals)
    wn = want["normals"]
    both_valid = (got_n != -1.0).any(-1) & (wn != -1.0).any(-1)
    dots = np.abs(np.sum(got_n * wn, axis=-1))
    valid_flags_match = (got_n != -1.0).any(-1) == (wn != -1.0).any(-1)
    assert valid_flags_match.mean() > 0.995
    # pixels where BOTH sides degenerate to the zero vector (rest-normal
    # cross products with no valid neighbour) agree by construction
    both_zero = (np.linalg.norm(got_n, axis=-1) < 1e-6) & (
        np.linalg.norm(wn, axis=-1) < 1e-6
    )
    ok = both_zero | (dots > 0.999)
    assert ok[both_valid].mean() > 0.995

    # stage 3: NASP labels — the integer handoff must agree except at argmin
    # ties flipped by accumulated f32-vs-f64 input differences
    got_l = np.asarray(res.nasp_labels)
    assert (got_l == want["nasp_labels"]).mean() > 0.995

    # stage 4: merged labels — compare the PARTITION up to representative
    # naming, over pixels whose NASP labels agreed
    got_m = np.asarray(res.merged_labels)
    want_m = want["merged_labels"]
    stable = got_l == want["nasp_labels"]
    assert ((got_m < 0) == (want_m < 0))[stable].mean() > 0.995
    pairs = {}
    ok_pairs = total = 0
    for g, w_ in zip(got_m[stable].ravel(), want_m[stable].ravel()):
        if g >= 0 and w_ >= 0:
            total += 1
            ok_pairs += pairs.setdefault(g, w_) == w_
    assert total > 0 and ok_pairs / total > 0.995

    # stage 5: final optimized points
    assert_points_match(res.optimized_points, want["optimized_points"])


def assert_points_match(got, want) -> None:
    """mm-level agreement of [..., 3] point maps.  Variance/size gates
    compare f32 vs f64 sums, so a boundary-straddling pixel can take a
    different branch (worst case a 3%-of-z blend flip): 99% of pixels within
    1 mm and a bounded 99.9th percentile."""
    diff = np.abs(np.asarray(got) - np.asarray(want)).max(-1)
    assert (diff < 1.0).mean() > 0.99
    assert float(np.quantile(diff, 0.999)) < 120.0  # 3% of max scene depth


def assert_rgbf_matches(res, want: Mapping[str, np.ndarray]) -> None:
    """res: an RGBFResult; want: keys color_labels, depth_labels,
    refined_labels, refined_depth."""
    # colour-SLIC sees bit-identical inputs (sd=0: no depth term) -> exact;
    # depth-SLIC sees f32-vs-f64 points -> allow argmin-tie flips
    np.testing.assert_array_equal(
        np.asarray(res.color_labels), want["color_labels"]
    )
    assert (np.asarray(res.depth_labels) == want["depth_labels"]).mean() > 0.995
    assert (
        np.asarray(res.refined_labels) == want["refined_labels"]
    ).mean() > 0.99
    dd = np.abs(np.asarray(res.refined_depth) - want["refined_depth"])
    assert (dd < 0.5).mean() > 0.99           # f32-vs-f64 filter arithmetic
    assert float(np.quantile(dd, 0.999)) < 400.0  # zeroing-command flips
