"""Smoke run of every pipeline on an NVIDIA GPU, through the normal entry points.

Usage:
    python chip_smoke.py          # one card: phases 1-6
    python chip_smoke.py --four   # four cards: the data-parallel KDE step only

One card:
  1. device: JAX's first device must be a GPU; prints its kind, the JAX
     version, XLA_FLAGS and nvidia-smi's name and power limit;
  2. KDE at 640x480 through `__graft_entry__.entry()`: compile seconds,
     the executable's memory analysis and the peak device memory;
  3. oracle parity: KDE and RGBF at 96x128 (grid 3x4) against the committed
     NumPy-oracle fixtures in tests/golden (utils/parity.py assertions);
  4. all six pipelines at 640x480 on `make_noisy_scene(480, 640, seed=0)`:
     finite outputs, labels in [-1, K), KDE and JBF closer to the ground truth
     than the input; KDE on the GPU against the same program on the host CPU;
  5. table exactness: one-hot gathers bit-exact, segment sums within the f32
     rounding bound of a float64 sum;
  6. served path: `run_stream` in serving mode (3 chunks of 8) and in capture
     mode (1 chunk) against per-frame KDE.

`--four`: `sharded_kde_step` at 640x480, batch 8, on mesh data=4,x=1
(shard_map) and data=2,x=2 (GSPMD spatial), each against one device.

Every program is compiled up front, concurrently in threads (XLA's GPU
compiles of these heavily unrolled programs take minutes each); each phase
waits for the programs it runs.  Nothing is caught: a failed phase raises
and the process exits non-zero.  The last line of stdout is the JSON result.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W = 480, 640


def log(msg: str) -> None:
    print(msg, flush=True)


def _compile(jitted, *args):
    t0 = time.perf_counter()
    compiled = jitted.lower(*args).compile()
    return compiled, time.perf_counter() - t0


def _compiled(futures, name, phase):
    """Wait for a precompiled program; logs its (concurrent) compile time."""
    compiled, secs = futures[name].result()
    log(f"[{phase}] {name} compile_s={secs:.1f} (concurrent)")
    return compiled


def _peak_bytes(dev) -> int:
    return dev.memory_stats()["peak_bytes_in_use"]


def phase_device():
    import jax

    from kinectdepthmapenhancement_tpu.core import device

    dev = device.require_gpu()
    log(f"[1] device_kind={dev.device_kind} jax={jax.__version__}")
    log(f"[1] XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log("[1] nvidia-smi name, power.limit:")
    log(device.gpu_name_and_power_limit())
    return dev


def phase_kde_entry(dev, futures, args):
    """Phase 2: the flagship step exactly as the entry point builds it."""
    import jax

    compiled = _compiled(futures, "kde_entry", 2)
    log(f"[2] memory_analysis: {compiled.memory_analysis()}")
    out = jax.block_until_ready(compiled(*args))
    assert out.shape == (H, W, 3) and bool(np.isfinite(np.asarray(out)).all())
    log(f"[2] peak_bytes_in_use={_peak_bytes(dev)}")
    return compiled


def _oracle_programs():
    """The phase-3 programs and their arguments: KDE and RGBF at 96x128
    (grid 3x4) on the committed oracle scene."""
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.core.camera import (
        default_kinect_intrinsics,
        projective_to_real,
    )
    from kinectdepthmapenhancement_tpu.core.config import (
        GridParams,
        KDEConfig,
        RGBFConfig,
    )
    from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu.utils import parity

    h, w = 96, 128
    intr = default_kinect_intrinsics(w, h)
    color, noisy, _ = make_noisy_scene(h, w, intr, seed=0)
    grid = GridParams(rows=3, cols=4)
    d, c = jnp.asarray(noisy), jnp.asarray(color)
    return {
        "oracle_kde": (
            parity.kde, (d, c, intr, dataclasses.replace(KDEConfig(), grid=grid))
        ),
        "oracle_rgbf": (
            parity.rgbf,
            (
                d, projective_to_real(d, intr), c,
                dataclasses.replace(RGBFConfig(), grid=grid),
            ),
        ),
    }


def oracle_fixture(name: str) -> dict:
    """A committed NumPy-oracle fixture, tests/golden/{name}.npz, as a dict
    of arrays (its cache key left out)."""
    path = os.path.join(ROOT, "tests", "golden", f"{name}.npz")
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files if k != "__key__"}


def oracle_parity() -> None:
    """Phase 3: KDE and RGBF at 96x128 (grid 3x4) on JAX's default device
    against the composed NumPy-oracle fixtures."""
    from kinectdepthmapenhancement_tpu.utils import parity

    programs = _oracle_programs()
    fn, args = programs["oracle_kde"]
    parity.assert_kde_matches(fn(*args), oracle_fixture("kde_oracle_96x128_seed0"))
    fn, args = programs["oracle_rgbf"]
    parity.assert_rgbf_matches(fn(*args), oracle_fixture("rgbf_oracle_96x128_seed0"))
    log("[3] oracle parity ok: kde, rgbf at 96x128")


def _kde_on_cpu(depth, color, intr):
    """KDE at 640x480 compiled for and run on the host CPU backend."""
    import jax

    from kinectdepthmapenhancement_tpu.core.config import KDEConfig
    from kinectdepthmapenhancement_tpu.utils import parity

    cpu = jax.devices("cpu")[0]
    t0 = time.perf_counter()
    res = parity.kde(
        jax.device_put(depth, cpu), jax.device_put(color, cpu), intr,
        KDEConfig(),
    )
    res = jax.block_until_ready(res)
    return res, time.perf_counter() - t0


def _pipeline_programs(noisy, color, intr):
    """The phase-4 programs: the six pipelines at 640x480 (KDE twice:
    default and plane_merge)."""
    import jax
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.core.camera import projective_to_real
    from kinectdepthmapenhancement_tpu.core.config import (
        KDEConfig,
        RGBFConfig,
        SPDSPConfig,
        TOFConfig,
    )
    from kinectdepthmapenhancement_tpu.models import pipelines
    from kinectdepthmapenhancement_tpu.utils import parity

    d, c = jnp.asarray(noisy), jnp.asarray(color)
    pts = projective_to_real(d, intr)
    kde_pm = dataclasses.replace(KDEConfig(), plane_merge=True)
    return {
        "jbf": (jax.jit(pipelines.jbf_pipeline), (d, c)),
        "mrf": (jax.jit(pipelines.mrf_pipeline), (d, c)),
        "rgbf": (
            jax.jit(lambda a, p, b: pipelines.rgbf_pipeline(a, p, b, RGBFConfig())),
            (d, pts, c),
        ),
        "kde": (jax.jit(lambda a, b: parity.kde(a, b, intr, KDEConfig())), (d, c)),
        "kde_plane_merge": (
            jax.jit(lambda a, b: pipelines.kde_pipeline(a, b, intr, kde_pm)),
            (d, c),
        ),
        "spdsp": (
            jax.jit(
                lambda a, p, b: pipelines.spdsp_pipeline(a, p, b, intr, SPDSPConfig())
            ),
            (d, pts, c),
        ),
        "tof": (
            jax.jit(
                lambda a, p, b: pipelines.tof_pipeline(a, p, b, intr, TOFConfig())
            ),
            (d, pts, c),
        ),
    }


def phase_pipelines(futures, programs, cpu_kde, noisy, gt):
    """Phase 4: run the six pipelines' programs, check their outputs, then
    KDE on the GPU against KDE on the host CPU."""
    import jax
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.core.config import GridParams
    from kinectdepthmapenhancement_tpu.utils import metrics, parity

    k = GridParams().num_clusters
    rmse_in = float(metrics.depth_rmse(jnp.asarray(noisy), jnp.asarray(gt)))
    results = {}
    for name, (_, args) in programs.items():
        compiled = _compiled(futures, name, 4)
        t0 = time.perf_counter()
        res = jax.block_until_ready(compiled(*args))
        log(f"[4] {name} first_run_s={time.perf_counter() - t0:.3f}")
        for leaf in jax.tree_util.tree_leaves(res):
            assert bool(jnp.all(jnp.isfinite(leaf))), name
        results[name] = res

    def labels_ok(lab):
        lab = np.asarray(lab)
        assert lab.min() >= -1 and lab.max() < k, (lab.min(), lab.max())

    r = results["rgbf"]
    for lab in (r.color_labels, r.depth_labels, r.refined_labels):
        labels_ok(lab)
    for name in ("kde", "kde_plane_merge"):
        labels_ok(results[name].nasp_labels)
        labels_ok(results[name].merged_labels)
    labels_ok(results["spdsp"].refined_labels)
    labels_ok(results["tof"].refined_labels)
    labels_ok(results["tof"].merged_labels)

    rmse = {
        "jbf": float(metrics.depth_rmse(results["jbf"], jnp.asarray(gt))),
        "kde": float(
            metrics.depth_rmse(
                results["kde"].optimized_points[..., 2], jnp.asarray(gt)
            )
        ),
    }
    log(f"[4] depth rmse mm: input={rmse_in:.3f} jbf={rmse['jbf']:.3f} "
        f"kde={rmse['kde']:.3f}")
    assert rmse["jbf"] < rmse_in and rmse["kde"] < rmse_in

    cpu_res, cpu_s = cpu_kde.result()
    log(f"[4] kde on host cpu: compile+run_s={cpu_s:.1f}")
    want = {
        "jbf": cpu_res.jbf_depth,
        "normals": cpu_res.normals,
        "nasp_labels": cpu_res.nasp_labels,
        "merged_labels": cpu_res.merged_labels,
        "optimized_points": cpu_res.optimized_points,
    }
    parity.assert_kde_matches(
        results["kde"], {k_: np.asarray(v) for k_, v in want.items()}
    )
    log("[4] kde gpu vs cpu parity ok")


def phase_tables():
    """Phase 5: one-hot table algebra on the card at 640x480 x 300 clusters."""
    import jax
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.ops import tables

    rng = np.random.default_rng(0)
    n, k = H * W, 300
    lab = rng.integers(-9, k, n).astype(np.int32)
    for f in (4, 14):
        tbl = (rng.random((k, f)) * 5e6).astype(np.float32)
        got = np.asarray(jax.jit(tables.gather)(jnp.asarray(tbl), jnp.asarray(lab)))
        want = np.asarray(
            jnp.where(
                (jnp.asarray(lab) >= 0)[:, None],
                jnp.take(jnp.asarray(tbl), jnp.clip(jnp.asarray(lab), 0, k - 1), axis=0),
                0.0,
            )
        )
        gather_abs = float(np.abs(got - want).max())
        assert gather_abs == 0.0, gather_abs

        feats = (rng.random((n, f)) * 5e6).astype(np.float32)
        got = np.asarray(
            jax.jit(lambda x, l: tables.segment_sum(x, l, k))(
                jnp.asarray(feats), jnp.asarray(lab)
            )
        )
        ok = lab >= 0
        truth = np.zeros((k, f))
        np.add.at(truth, lab[ok], feats[ok].astype(np.float64))
        abs_sum = np.zeros((k, f))
        np.add.at(abs_sum, lab[ok], np.abs(feats[ok]).astype(np.float64))
        count = np.bincount(lab[ok], minlength=k)[:, None]
        # worst-case f32 summation error of `count` terms
        bound = count * 2.0**-24 * abs_sum
        err = np.abs(got - truth)
        assert (err <= bound).all(), float((err / bound).max())
        log(
            f"[5] tables F={f}: gather max_abs={gather_abs} segment_sum "
            f"max_rel={float((err / np.maximum(np.abs(truth), 1.0)).max()):.3e}"
        )


def _stream_frames(gt):
    """24 sensor-noise frames of the phase-4 scene."""
    rng = np.random.default_rng(7)
    var = 0.45 * 2.85 * np.square(gt / 10.0) / 1.0e4
    return [
        np.where(gt == 0.0, 0.0, gt + rng.uniform(-1, 1, gt.shape) * var)
        .astype(np.float32)
        for _ in range(24)
    ]


def _stream_programs(frames, color, intr):
    """run_stream's chunk executables (batch 8), serving and capture mode,
    with the arguments run_stream gives them."""
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.core import buffer2d
    from kinectdepthmapenhancement_tpu.core.config import KDEConfig
    from kinectdepthmapenhancement_tpu.models import streaming

    args = (buffer2d.init(H, W), jnp.asarray(np.stack(frames[:8])), jnp.asarray(color))
    return {
        f"stream_{mode}": (streaming._chunk_step(intr, KDEConfig(), kde_only), args)
        for mode, kde_only in (("serve", True), ("capture", False))
    }


def phase_stream(futures, kde_step, frames, color, intr):
    """Phase 6: the served path against per-frame KDE (kde_step: the
    phase-2 executable, depth [H, W] x colour -> points).  run_stream's own
    compile finds the precompiled chunk executables in the compile cache."""
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.core.config import KDEConfig
    from kinectdepthmapenhancement_tpu.models import streaming
    from kinectdepthmapenhancement_tpu.utils import parity

    for name in ("stream_serve", "stream_capture"):
        log(f"[6] {name} memory_analysis: "
            f"{_compiled(futures, name, 6).memory_analysis()}")
    c = jnp.asarray(color)
    for kde_only, n in ((True, 24), (False, 8)):
        outs = []
        t0 = time.perf_counter()
        state = streaming.run_stream(
            iter(frames[:n]), color, intr, cfg=KDEConfig(), batch=8,
            kde_only=kde_only,
            on_outputs=lambda start, pts: outs.append((start, pts)),
        )
        secs = time.perf_counter() - t0
        assert state.frame_index == n
        for start, pts in outs:
            for j in range(pts.shape[0]):
                want = kde_step(jnp.asarray(frames[start + j]), c)
                parity.assert_points_match(pts[j], want)
        metric = "kde_checksum" if kde_only else "kde_error_mm"
        value = streaming.mean_metric(state, metric)
        assert np.isfinite(value)
        log(
            f"[6] run_stream kde_only={kde_only} frames={n} chunks={len(outs)} "
            f"wall_s={secs:.1f} {metric}={value:.6g} parity ok"
        )


def four_card_parity(h: int, w: int, grid, batch: int = 8) -> None:
    """`sharded_kde_step` on 4 devices, mesh data=4,x=1 (shard_map) and
    data=2,x=2 (GSPMD spatial), each against one device on the same batch."""
    import jax
    import jax.numpy as jnp

    from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics
    from kinectdepthmapenhancement_tpu.core.config import KDEConfig
    from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu.parallel.mesh import make_mesh
    from kinectdepthmapenhancement_tpu.parallel.sharding import sharded_kde_step
    from kinectdepthmapenhancement_tpu.utils import parity

    intr = default_kinect_intrinsics(w, h)
    cfg = dataclasses.replace(KDEConfig(), grid=grid)
    scenes = [make_noisy_scene(h, w, intr, seed=i) for i in range(batch)]
    color = jnp.asarray(np.stack([s[0] for s in scenes]))
    depth = jnp.asarray(np.stack([s[1] for s in scenes]))

    # one device, frame by frame: the phase-4 KDE program
    programs = {
        "single": (
            jax.jit(lambda a, b: parity.kde(a, b, intr, cfg)), (depth[0], color[0])
        )
    }
    for data, x in ((4, 1), (2, 2)):
        mesh = make_mesh(4, spatial=x)
        assert dict(mesh.shape) == {"data": data, "x": x}
        programs[f"data={data},x={x}"] = (
            sharded_kde_step(mesh, intr, cfg), (depth, color)
        )
    with concurrent.futures.ThreadPoolExecutor(len(programs)) as pool:
        futures = {
            name: pool.submit(_compile, fn, *args)
            for name, (fn, args) in programs.items()
        }
        compiled = {name: _compiled(futures, name, "four") for name in programs}

    single = compiled.pop("single")
    want = [single(depth[i], color[i]) for i in range(batch)]
    want_pts = np.stack([np.asarray(r.optimized_points) for r in want])
    want_lab = np.stack([np.asarray(r.merged_labels) for r in want])
    for name, step in compiled.items():
        t0 = time.perf_counter()
        got = jax.block_until_ready(step(depth, color))
        secs = time.perf_counter() - t0
        np.testing.assert_allclose(
            np.asarray(got.optimized_points), want_pts, rtol=1e-4, atol=0.5
        )
        agree = float((np.asarray(got.merged_labels) == want_lab).mean())
        assert agree > 0.995, agree
        log(
            f"[four] mesh {name} batch={batch} {h}x{w}: "
            f"points parity ok, label agreement={agree:.6f}, "
            f"first call s={secs:.1f}"
        )


def one_card(dev) -> None:
    """Phases 2-6, with every program compiled concurrently up front."""
    import jax

    import __graft_entry__
    from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics
    from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene

    t0 = time.perf_counter()
    intr = default_kinect_intrinsics(W, H)
    color, noisy, gt = make_noisy_scene(H, W, intr, seed=0)
    frames = _stream_frames(gt)
    fn, entry_args = __graft_entry__.entry()
    oracle = _oracle_programs()
    pipes = _pipeline_programs(noisy, color, intr)
    programs = {"kde_entry": (jax.jit(fn), entry_args)}
    programs.update(oracle)
    programs.update(pipes)
    programs.update(_stream_programs(frames, color, intr))
    with concurrent.futures.ThreadPoolExecutor(len(programs) + 1) as pool:
        cpu_kde = pool.submit(_kde_on_cpu, noisy, color, intr)
        futures = {
            name: pool.submit(_compile, fn, *args)
            for name, (fn, args) in programs.items()
        }
        kde_step = phase_kde_entry(dev, futures, entry_args)
        for name in oracle:
            _compiled(futures, name, 3)
        oracle_parity()
        phase_pipelines(futures, pipes, cpu_kde, noisy, gt)
        phase_tables()
        phase_stream(futures, kde_step, frames, color, intr)
    log(f"[end] peak_bytes_in_use={_peak_bytes(dev)} "
        f"wall_s={time.perf_counter() - t0:.1f}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    from kinectdepthmapenhancement_tpu.core import device

    dev = phase_device()
    device.enable_compile_cache()
    import jax

    if "--four" in argv:
        if len(jax.devices()) != 4:
            raise RuntimeError(f"--four needs 4 GPUs, found {len(jax.devices())}")
        from kinectdepthmapenhancement_tpu.core.config import GridParams

        four_card_parity(H, W, GridParams())
    else:
        one_card(dev)
    print(json.dumps({"ok": True, "device": device.device_info()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
