"""Streaming sequence runner: frames -> pipeline -> metrics, resumable.

The reference's only multi-frame mode is the 1000-frame ground-truth capture
loop (main.cpp:86-116).  This runner generalises it for production use:
  * pulls frames from any iterator (e.g. the native C++ FrameSource),
  * runs the KDE pipeline on BATCHES of frames per dispatch (one vmapped
    executable per chunk amortises the per-dispatch host overhead),
  * maintains the temporal DepthBuffer accumulation (sequential by nature,
    folded over the chunk with lax.scan inside the same executable),
  * accumulates mean-3D-error metrics ON DEVICE per chunk — the host reads
    back two scalars once per chunk, never per frame,
  * checkpoints cursor + buffer + metrics at chunk boundaries every
    `checkpoint_every` frames so a killed run resumes where it left off
    (utils/checkpoint.py).
"""

from __future__ import annotations

import functools
from typing import Callable, Iterator, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from kinectdepthmapenhancement_tpu.core import buffer2d
from kinectdepthmapenhancement_tpu.core.camera import Intrinsics, projective_to_real
from kinectdepthmapenhancement_tpu.core.config import KDEConfig
from kinectdepthmapenhancement_tpu.models.pipelines import kde_pipeline
from kinectdepthmapenhancement_tpu.utils import checkpoint, metrics


@functools.lru_cache(maxsize=16)
def _chunk_step(intr: Intrinsics, cfg: KDEConfig, kde_only: bool):
    """Jitted chunk executable, cached at module level so successive
    run_stream calls in one process reuse the trace + executable (a fresh
    jit wrapper per call cost a full retrace and, cold, a multi-minute
    XLA compile of the combined program).  Colour is a traced argument.

    The DepthBuffer is not donated: donation is untested on the GPU, and
    it would only save a 2.4 MB allocation per chunk.
    """

    @jax.jit
    def step(buf: buffer2d.DepthBuffer, depths: jnp.ndarray, c: jnp.ndarray):
        """depths: [B, H, W].  KDE runs vmapped (frames are independent);
        the temporal buffer + metric fold is a scan in the same executable."""
        pts = jax.vmap(
            lambda d: kde_pipeline(d, c, intr, cfg).optimized_points
        )(depths)

        if kde_only:
            # serving mode: no pseudo-GT capture fold; the chunk result is
            # consumed on device (checksum forces completion, ~8 B readback)
            return buf, pts, jnp.sum(pts) * 1e-30, jnp.zeros((), jnp.int32)

        def body(b, xs):
            depth, p = xs
            b = buffer2d.update(b, depth)
            ref_pts = projective_to_real(b.depth, intr)
            err, n = metrics.mean_3d_error(p, ref_pts)
            return b, (err * n.astype(jnp.float32), n)

        buf, (errs, ns) = jax.lax.scan(body, buf, (depths, pts))
        return buf, pts, jnp.sum(errs), jnp.sum(ns)

    return step


def run_stream(
    frames: Iterator[np.ndarray],
    color: np.ndarray,
    intr: Intrinsics,
    *,
    cfg: KDEConfig = KDEConfig(),
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 50,
    max_frames: Optional[int] = None,
    batch: int = 8,
    kde_only: bool = False,
    on_outputs: Optional[Callable[[int, jnp.ndarray], None]] = None,
) -> checkpoint.StreamState:
    """Process a depth-frame stream with a fixed colour image (file-replay
    style).  Returns the final StreamState with accumulated metrics.

    `batch` frames are processed per device dispatch; the stream's tail runs
    as one smaller chunk (one extra compile per distinct tail size).

    Dispatch is PIPELINED one chunk deep: chunk N's two-scalar metric
    readback is deferred until chunk N+1 has been staged and enqueued, so
    the host's upload and dispatch of the next chunk overlap the device
    compute of the current one (a synchronous readback per chunk leaves the
    device idle between chunks).

    kde_only=True skips the temporal-buffer capture fold and the pseudo-GT
    metric — the pure serving path; accumulates a "kde_checksum" metric
    (device-consumed result, ~8 B readback per chunk) instead.

    on_outputs, when given, receives (start_frame_index, pts) per chunk with
    pts the [B, H, W, 3] refined points still ON DEVICE — fetch or chain as
    needed (fetching copies ~29 MB per chunk of 8 frames to the host).
    """
    h, w = color.shape[:2]
    state = checkpoint.load(checkpoint_path) if checkpoint_path else None
    if state is None:
        state = checkpoint.StreamState(
            frame_index=0,
            buffer=buffer2d.init(h, w),
            metric_sums={"kde_error_mm": 0.0},
            metric_counts={"kde_error_mm": 0},
        )
    metric = "kde_checksum" if kde_only else "kde_error_mm"
    state.metric_sums.setdefault(metric, 0.0)
    state.metric_counts.setdefault(metric, 0)

    c = jnp.asarray(color)
    chunk_step = _chunk_step(intr, cfg, kde_only)

    inflight: List[tuple] = []  # <=1 dispatched chunk awaiting readback

    def dispatch(chunk: List[np.ndarray]) -> None:
        if not chunk:
            return
        depths = jnp.asarray(np.stack(chunk))  # async H2D
        start = state.frame_index + sum(e[2] for e in inflight)
        buf, pts, err_sum, n_sum = chunk_step(state.buffer, depths, c)
        state.buffer = buf  # device future; the buffer thread stays on device
        if on_outputs is not None:
            on_outputs(start, pts)
        inflight.append((err_sum, n_sum, len(chunk)))
        chunk.clear()

    def drain() -> None:
        """Account the oldest in-flight chunk (blocks until it is done)."""
        if not inflight:
            return
        err_sum, n_sum, k = inflight.pop(0)
        state.metric_sums[metric] += float(err_sum)
        state.metric_counts[metric] += int(n_sum) if not kde_only else k
        state.frame_index += k

    pending: List[np.ndarray] = []
    last_ckpt = state.frame_index
    for i, frame in enumerate(frames):
        if i < state.frame_index:
            continue  # fast-forward after resume
        if max_frames is not None and i >= max_frames:
            break
        pending.append(np.asarray(frame))
        if len(pending) == batch:
            dispatch(pending)
            while len(inflight) > 1:  # keep exactly one chunk in flight
                drain()
            dispatched = state.frame_index + sum(e[2] for e in inflight)
            if checkpoint_path and dispatched - last_ckpt >= checkpoint_every:
                while inflight:  # frame_index must match the saved buffer
                    drain()
                checkpoint.save(checkpoint_path, state)
                last_ckpt = state.frame_index
    dispatch(pending)
    while inflight:
        drain()

    if checkpoint_path:
        checkpoint.save(checkpoint_path, state)
    return state


def mean_metric(state: checkpoint.StreamState, name: str) -> float:
    n = state.metric_counts.get(name, 0)
    return state.metric_sums.get(name, 0.0) / n if n else float("nan")
