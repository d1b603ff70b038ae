"""Composed-pipeline oracle parity (SURVEY.md §4c) + real-frame fixture.

The per-op oracles are composed into full CPU KDE / RGBF pipelines
(oracle_pipeline.py) and compared end-to-end against the jitted device
pipelines, covering the inter-stage contracts (units, sentinels, label
handoffs).  The tolerances live in utils/parity.py, shared with the on-card
smoke run (chip_smoke.py).

The real-frame test drives the KDE pipeline with the reference's only
bundled real data (/root/reference/input/color.jpg, main.cpp:146-163), with
depth synthesized by the reference's own noise model (main.cpp:127-130) —
so at least one end-to-end run sees real image statistics."""

import dataclasses
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import golden
from kinectdepthmapenhancement_tpu.core.camera import (
    default_kinect_intrinsics,
    projective_to_real,
)
from kinectdepthmapenhancement_tpu.core.config import GridParams, KDEConfig, RGBFConfig
from kinectdepthmapenhancement_tpu.core.io import imread_rgb
from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu.models import pipelines
from kinectdepthmapenhancement_tpu.utils import parity

REF_COLOR = "/root/reference/input/color.jpg"


def _scene(h=96, w=128, seed=0):
    intr = default_kinect_intrinsics(w, h)
    color, noisy, gt = make_noisy_scene(h, w, intr, seed=seed)
    return intr, color, noisy, gt, GridParams(rows=3, cols=4)


@pytest.mark.full
def test_kde_composed_oracle_parity():
    intr, color, noisy, gt, grid = _scene()
    cfg = dataclasses.replace(KDEConfig(), grid=grid)
    want = golden.kde_oracle("kde_oracle_96x128_seed0", noisy, color, intr, grid)
    res = parity.kde(jnp.asarray(noisy), jnp.asarray(color), intr, cfg)
    parity.assert_kde_matches(res, want)


@pytest.mark.full
def test_chip_smoke_oracle_parity_phase_on_cpu():
    """chip_smoke.py's phase 3 (fixture loading + shared assertions) passes
    on the CPU, so a failure on the card is the card's numerics."""
    import chip_smoke

    chip_smoke.oracle_parity()


@pytest.mark.parametrize(
    "name, extra",
    [
        ("kde_oracle_96x128_seed0", {"max_fit_residual": 0.0025}),
        ("rgbf_oracle_96x128_seed0", {}),
    ],
)
def test_chip_smoke_fixtures_match_current_oracles(name, extra):
    """chip_smoke.py loads the committed fixtures without recomputing them;
    each must carry the key of the current oracle code and the phase-3
    scene, or it would hold the card to a stale oracle."""
    import chip_smoke

    intr, color, noisy, _, grid = _scene()
    key = golden._input_digest(
        golden._oracle_inputs(noisy, color, intr, grid, **extra)
    )
    path = os.path.join(os.path.dirname(chip_smoke.__file__), "tests", "golden",
                        f"{name}.npz")
    with np.load(path, allow_pickle=False) as z:
        assert str(z["__key__"]) == key
    assert set(chip_smoke.oracle_fixture(name)) == set(z.files) - {"__key__"}


@pytest.mark.full
def test_kde_composed_oracle_parity_reference_exact():
    """The documented claim that max_plane_residual=inf
    restores exact reference behaviour (Projection_GPU.cu:174-196 has no
    plane-confidence gate), tested END TO END: the composed pipeline and the
    composed oracle both run in reference mode and must still agree."""
    intr, color, noisy, gt, grid = _scene()
    cfg = dataclasses.replace(
        KDEConfig(), grid=grid, max_plane_residual=float("inf")
    )
    want = golden.kde_oracle(
        "kde_oracle_96x128_seed0_refexact", noisy, color, intr, grid,
        max_fit_residual=float("inf"),
    )
    res = parity.kde(jnp.asarray(noisy), jnp.asarray(color), intr, cfg)

    got_l = np.asarray(res.nasp_labels)
    assert (got_l == want["nasp_labels"]).mean() > 0.995
    parity.assert_points_match(res.optimized_points, want["optimized_points"])


@pytest.mark.full
def test_spdsp_reference_exact_mode_disables_gate():
    """SPDSPConfig.max_plane_residual=inf must reproduce the ungated
    reference path (every cluster plane trusted in the 20-sweep MRF stage):
    inf == an explicit all-true gate, pixel for pixel."""
    from kinectdepthmapenhancement_tpu.core.config import SPDSPConfig
    from kinectdepthmapenhancement_tpu.core.camera import normalized_rays
    from kinectdepthmapenhancement_tpu.ops import ers, plane, slic

    intr, color, noisy, gt, grid = _scene()
    cfg = dataclasses.replace(
        SPDSPConfig(), grid=grid, max_plane_residual=float("inf")
    )
    pts = projective_to_real(jnp.asarray(noisy), intr)
    res = jax.jit(
        lambda d, p, c: pipelines.spdsp_pipeline(d, p, c, intr, cfg)
    )(jnp.asarray(noisy), pts, jnp.asarray(color))

    # the ungated reference composition, from the same refined stages
    h, w = noisy.shape
    rays = normalized_rays(intr, h, w)
    rpoints = projective_to_real(res.refined_depth, intr)
    fitted = plane.set_pseudo_depth_cluster(
        rpoints, rays, res.planes_nd, res.refined_labels, strict=False
    )
    want = jax.jit(
        lambda rp, pf: plane.mrf_optimization(
            rp, pf, rays, cfg.projection, gate_mask=None
        )
    )(rpoints, fitted)
    # separate jit programs fuse differently -> last-ulp drift only
    np.testing.assert_allclose(
        np.asarray(res.optimized_points), np.asarray(want), rtol=0, atol=0.01
    )


@pytest.mark.full
def test_rgbf_composed_oracle_parity():
    intr, color, noisy, gt, grid = _scene()
    cfg = dataclasses.replace(RGBFConfig(), grid=grid)
    want = golden.rgbf_oracle("rgbf_oracle_96x128_seed0", noisy, color, intr, grid)
    d = jnp.asarray(noisy)
    res = parity.rgbf(d, projective_to_real(d, intr), jnp.asarray(color), cfg)
    parity.assert_rgbf_matches(res, want)


@pytest.mark.full
def test_kde_beats_jbf_on_far_range_banding():
    """The comparison the reference exists to win.  On
    far-range (3-5.5 m) Kinect-v1 data the quantization bands are many
    pixels wide, so per-pixel filtering (JBF) cannot see across a band to
    recover the true surface.  Gate: KDE RMSE < 90% of JBF RMSE (measured:
    ~5.7 vs ~8.2 mm; EVAL_FAR.md).

    Round-5 attribution correction: with the DEFAULT config the margin
    comes from KDE's final depth bilateral, NOT the plane projection — the
    normal-similarity merge over-merges here (quantization-biased normals)
    and the plane-confidence gate correctly disables the projection for
    every cluster (output is bitwise-identical with the gate forced shut;
    EVAL_FAR.md round 5).  The projection only fires with the round-5
    plane-consistency merge (cfg.plane_merge), gated below: it must beat
    the default-config KDE, and the dominant component's interior must land
    within ~1 mm-scale of the true plane where the input is banded at
    ~8 mm RMSE."""
    import dataclasses

    from kinectdepthmapenhancement_tpu.core.testdata import make_banded_scene

    h, w = 480, 640
    intr = default_kinect_intrinsics(w, h)
    color, sensor, gt = make_banded_scene(h, w, intr, seed=0)
    d, c = jnp.asarray(sensor), jnp.asarray(color)

    jbf = np.asarray(jax.jit(lambda a, b: pipelines.jbf_pipeline(a, b))(d, c))
    res = jax.jit(
        lambda a, b: pipelines.kde_pipeline(a, b, intr, KDEConfig())
    )(d, c)
    zk = np.asarray(res.optimized_points[..., 2])

    vj = jbf > 50.0
    vk = zk > 50.0
    rm_jbf = float(np.sqrt(np.mean((jbf[vj] - gt[vj]) ** 2)))
    rm_kde = float(np.sqrt(np.mean((zk[vk] - gt[vk]) ** 2)))
    assert vk.mean() > 0.99 and vj.mean() > 0.99
    assert rm_kde < rm_jbf * 0.9, (rm_kde, rm_jbf)

    # ---- plane-consistency merge: the projection stage actually fires
    pm_cfg = dataclasses.replace(KDEConfig(), plane_merge=True)
    res_pm = jax.jit(
        lambda a, b: pipelines.kde_pipeline(a, b, intr, pm_cfg)
    )(d, c)
    zp = np.asarray(res_pm.optimized_points[..., 2])
    vp = zp > 50.0
    rm_pm = float(np.sqrt(np.mean((zp[vp] - gt[vp]) ** 2)))
    assert rm_pm < rm_kde * 0.98, (rm_pm, rm_kde)  # measured ~5.33 vs 5.67
    # dominant merged component (the back wall) must be recovered to the
    # sub-band level on its interior
    lab = np.asarray(res_pm.merged_labels)
    sizes = np.bincount(lab[lab >= 0], minlength=KDEConfig().grid.num_clusters)
    big = int(np.argmax(sizes))
    mwall = (lab == big) & vp
    assert sizes[big] > 100_000
    rm_wall = float(np.sqrt(np.mean((zp[mwall] - gt[mwall]) ** 2)))
    assert rm_wall < 1.5, rm_wall  # measured 0.58 mm vs ~8 mm banded input


@pytest.mark.full
@pytest.mark.skipif(not os.path.exists(REF_COLOR), reason="reference frame absent")
def test_kde_on_reference_frame():
    """KDE over the bundled real colour frame (main.cpp:146-163) at its
    native 640x480, with depth synthesized by the reference noise model
    (main.cpp:127-130) over the procedural geometry: real image statistics
    must not break the pipeline, and it must still reduce depth error.
    (Runs at full res because the pipeline constants — min cluster 1300 px,
    sigma sets — are tuned for 640x480; small crops over-merge by design.)"""
    color = imread_rgb(REF_COLOR)  # 480x640 RGB
    h, w = color.shape[:2]
    intr = default_kinect_intrinsics(w, h)
    # depth ground truth: piecewise fronto-parallel planes whose boundaries
    # follow the REAL image's contours (quantized smoothed luminance), so the
    # guided stages see consistent colour/depth edges like a registered
    # Kinect frame would; noise per the reference model (main.cpp:127-130)
    lum = np.asarray(color, np.float32).mean(-1)
    k = np.ones((9, 9), np.float32) / 81.0
    lum_s = np.asarray(
        jax.scipy.signal.convolve2d(jnp.asarray(lum), jnp.asarray(k), mode="same")
    )
    bands = np.digitize(lum_s, np.quantile(lum_s, [0.2, 0.4, 0.6, 0.8]))
    gt = np.take(
        np.array([1500.0, 1900.0, 2400.0, 3000.0, 3600.0], np.float32), bands
    )
    rng = np.random.default_rng(11)
    variance = 0.45 * 2.85 * np.square(gt / 10.0) / 1.0e4
    noisy = (gt + rng.uniform(-1.0, 1.0, gt.shape) * variance).astype(np.float32)
    cfg = KDEConfig()
    res = jax.jit(lambda d, c: pipelines.kde_pipeline(d, c, intr, cfg))(
        jnp.asarray(noisy), jnp.asarray(color)
    )
    assert np.isfinite(np.asarray(res.optimized_points)).all()
    lab = np.asarray(res.nasp_labels)
    assert lab.min() >= -1 and lab.max() < cfg.grid.num_clusters

    # quality contract on real statistics: away from GT depth edges the
    # pipeline must denoise (the luminance-quantile fixture necessarily puts
    # some depth edges in LOW-contrast image regions — mid-gradient level
    # sets — where no cross-bilateral filter can localise the edge, so edge
    # bands are excluded; a real registered frame has no such pixels)
    gy, gx = np.gradient(gt)
    edge = (np.abs(gy) + np.abs(gx)) > 1.0
    interior = ~edge
    for _ in range(3):  # dilate the edge band by 3 px
        e = interior
        interior = (
            e
            & np.roll(e, 1, 0) & np.roll(e, -1, 0)
            & np.roll(e, 1, 1) & np.roll(e, -1, 1)
        )
    zo = np.asarray(res.optimized_points[..., 2])
    rm_in = np.sqrt(np.mean((noisy - gt)[interior] ** 2))
    rm_out = np.sqrt(np.mean((zo - gt)[interior] ** 2))
    assert interior.mean() > 0.5
    assert rm_out < rm_in * 0.6  # >=40% interior noise reduction
