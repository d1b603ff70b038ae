"""Single-frame evaluation harness mirroring the reference's main().

Runs INPUT / JBF / MRF / RGBF / KDE (+ optionally SPDSP, TOF) on one frame,
times each method and computes the mean 3-D error against a ground-truth
depth, writing an `evaluation.txt` in the same spirit as main.cpp:158-309.

Usage:
    python -m kinectdepthmapenhancement_tpu.utils.evaluate [out.txt]
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from kinectdepthmapenhancement_tpu.core.camera import (
    Intrinsics,
    default_kinect_intrinsics,
    projective_to_real,
)
from kinectdepthmapenhancement_tpu.core.config import (
    GridParams,
    KDEConfig,
    RGBFConfig,
    SPDSPConfig,
    TOFConfig,
)
from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
from kinectdepthmapenhancement_tpu.models import pipelines
from kinectdepthmapenhancement_tpu.utils import metrics, visualize
from kinectdepthmapenhancement_tpu.utils.timing import time_pipeline


def evaluate(
    depth: np.ndarray,
    color: np.ndarray,
    gt_depth: np.ndarray,
    *,
    include_sp_methods: bool = True,
    intr: Optional[Intrinsics] = None,
    grid: Optional[GridParams] = None,
    timing_iters: int = 5,
    methods: Optional[list] = None,
    figure_path: Optional[str] = None,
    fill_steps: int = 0,
    plane_merge: bool = False,
) -> Dict[str, Dict[str, float]]:
    """fill_steps > 0 adds a "kde_fill" row: KDE with the label-consistent
    plane hole-fill (KDEConfig.fill_holes — the sparse/TOF-dropout regime,
    EVAL_FAR.md sparse variant).  plane_merge adds a "kde_pm" row (the
    plane-consistency merge, ops/ccl.py::merge_planes); combined with
    fill_steps it also adds "kde_pm_fill" (the two extensions compose —
    the fill only fires when cluster planes pass the confidence gates,
    which on far-range banded depth requires the plane merge)."""
    h, w = depth.shape
    if intr is None:
        intr = default_kinect_intrinsics(w, h)
    kde_cfg = KDEConfig() if grid is None else dataclasses.replace(KDEConfig(), grid=grid)
    rgbf_cfg = RGBFConfig() if grid is None else dataclasses.replace(RGBFConfig(), grid=grid)
    spdsp_cfg = SPDSPConfig() if grid is None else dataclasses.replace(SPDSPConfig(), grid=grid)
    tof_cfg = TOFConfig() if grid is None else dataclasses.replace(TOFConfig(), grid=grid)
    d = jnp.asarray(depth)
    c = jnp.asarray(color)
    gt_pts = projective_to_real(jnp.asarray(gt_depth), intr)
    in_pts = projective_to_real(d, intr)

    # each run takes (depth, color) so the timing harness can feed fresh,
    # unique inputs per timed call (utils/timing.py), and no timed call can
    # reuse an earlier call's result
    runs = {
        "input": lambda dd, cc: projective_to_real(dd, intr),
        "jbf": lambda dd, cc: projective_to_real(
            pipelines.jbf_pipeline(dd, cc), intr
        ),
        "mrf": lambda dd, cc: projective_to_real(
            pipelines.mrf_pipeline(dd, cc), intr
        ),
        "rgbf": lambda dd, cc: projective_to_real(
            pipelines.rgbf_pipeline(
                dd, projective_to_real(dd, intr), cc, rgbf_cfg
            ).refined_depth,
            intr,
        ),
        "kde": lambda dd, cc: pipelines.kde_pipeline(
            dd, cc, intr, kde_cfg
        ).optimized_points,
    }
    if fill_steps > 0:
        fill_cfg = dataclasses.replace(kde_cfg, fill_holes=fill_steps)
        runs["kde_fill"] = lambda dd, cc: pipelines.kde_pipeline(
            dd, cc, intr, fill_cfg
        ).optimized_points
    if plane_merge:
        pm_cfg = dataclasses.replace(kde_cfg, plane_merge=True)
        runs["kde_pm"] = lambda dd, cc: pipelines.kde_pipeline(
            dd, cc, intr, pm_cfg
        ).optimized_points
        if fill_steps > 0:
            pmf_cfg = dataclasses.replace(
                kde_cfg, plane_merge=True, fill_holes=fill_steps
            )
            runs["kde_pm_fill"] = lambda dd, cc: pipelines.kde_pipeline(
                dd, cc, intr, pmf_cfg
            ).optimized_points
    if include_sp_methods:
        runs["spdsp"] = lambda dd, cc: pipelines.spdsp_pipeline(
            dd, projective_to_real(dd, intr), cc, intr, spdsp_cfg
        ).optimized_points
        runs["tof"] = lambda dd, cc: pipelines.tof_pipeline(
            dd, projective_to_real(dd, intr), cc, intr, tof_cfg
        ).plane_fitted

    if methods is not None:
        unknown = set(methods) - set(runs)
        if unknown:
            raise ValueError(f"unknown methods {sorted(unknown)} (have {list(runs)})")
        runs = {k: v for k, v in runs.items() if k in methods}

    rng = np.random.default_rng(12345)

    def make_args(_i):
        jitter = rng.normal(0.0, 1e-3, depth.shape).astype(np.float32)
        return (jnp.asarray(depth + jitter), c)

    out: Dict[str, Dict[str, float]] = {}
    depth_renders = {}
    for name, fn in runs.items():
        red = jax.jit(lambda dd, cc, fn=fn: jnp.sum(fn(dd, cc)))
        stats = time_pipeline(red, make_args, iters=timing_iters)
        pts = jax.block_until_ready(jax.jit(fn)(d, c))
        err, n = metrics.mean_3d_error(pts, gt_pts)
        rmse = metrics.depth_rmse(pts[..., 2], jnp.asarray(gt_depth))
        out[name] = {
            "time_ms": stats["median_s"] * 1e3,
            "mean_3d_error_mm": float(err),
            "rmse_mm": float(rmse),
            "valid_px": int(n),
        }
        if figure_path:
            depth_renders[name] = np.asarray(
                visualize.depth_rgb(pts[..., 2])
            )

    if figure_path:
        # the PCL 6-viewport comparison (main.cpp:362-413): input + GT +
        # every evaluated method, one captioned montage
        panels = {"input": depth_renders.get("input")}
        panels["ground truth"] = np.asarray(
            visualize.depth_rgb(jnp.asarray(gt_depth))
        )
        for name, img in depth_renders.items():
            if name != "input":
                panels[name] = img
        panels = {k: v for k, v in panels.items() if v is not None}
        visualize.save_png(figure_path, visualize.comparison_figure(panels))
    return out


def evaluate_tum(
    root: str,
    *,
    frames: int = 30,
    eval_index: Optional[int] = None,
    include_sp_methods: bool = False,
    grid: Optional[GridParams] = None,
    timing_iters: int = 5,
    methods: Optional[list] = None,
    figure_path: Optional[str] = None,
) -> Dict[str, Dict[str, float]]:
    """Evaluate on a REAL RGB-D sequence (TUM layout) using the reference's
    own capture protocol (main.cpp:86-116): fold the sequence's depth frames
    through the Buffer2D gated weighted average to form a temporally-averaged
    pseudo-ground-truth, then run every method on one frame against it."""
    from kinectdepthmapenhancement_tpu.core import buffer2d
    from kinectdepthmapenhancement_tpu.core.datasets import TUMSequence

    seq = TUMSequence(root)
    if len(seq) == 0:
        raise ValueError(f"{root}: no associated rgb/depth pairs")
    n = min(frames, len(seq))
    first = seq[0]
    h, w = first.depth.shape
    buf = buffer2d.init(h, w)
    step = jax.jit(buffer2d.update)
    for i in range(n):
        buf = step(buf, jnp.asarray(seq[i].depth))
    gt = np.asarray(buf.depth)
    fr = seq[eval_index if eval_index is not None else n // 2]
    return evaluate(
        fr.depth,
        fr.color,
        gt,
        include_sp_methods=include_sp_methods,
        intr=seq.intrinsics,
        grid=grid,
        timing_iters=timing_iters,
        methods=methods,
        figure_path=figure_path,
    )


def write_report(path: str, results: Dict[str, Dict[str, float]]) -> str:
    lines = ["runtime"]
    for name, r in results.items():
        lines.append(f"{name}: {r['time_ms']:.3f} ms")
    lines.append("error")
    for name, r in results.items():
        lines.append(
            f"{name} {r['mean_3d_error_mm']:.6f}  (rmse {r['rmse_mm']:.3f} mm, "
            f"n={r['valid_px']})"
        )
    text = "\n".join(lines) + "\n"
    with open(path, "w") as f:
        f.write(text)
    return text


def main(
    path: str | None = None,
    include_sp_methods: bool = False,
    *,
    grid: Optional[GridParams] = None,
    timing_iters: int = 5,
    methods: Optional[list] = None,
    figure_path: Optional[str] = None,
) -> None:
    if path is None:
        path = sys.argv[1] if len(sys.argv) > 1 else "evaluation.txt"
    color, noisy, gt = make_noisy_scene(480, 640, default_kinect_intrinsics(), seed=0)
    results = evaluate(
        noisy,
        color,
        gt,
        include_sp_methods=include_sp_methods,
        grid=grid,
        timing_iters=timing_iters,
        methods=methods,
        figure_path=figure_path,
    )
    print(write_report(path, results))


if __name__ == "__main__":
    main()
