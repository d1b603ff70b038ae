"""Dispatch-inclusive wall-clock timing of a compiled pipeline.

`time_pipeline` warms once, then times each call from dispatch to the host
read of the scalar the program returns, so the time covers the whole device
computation.  Every timed call gets inputs with fresh contents from
`make_args(i)`, so no call can reuse an earlier call's result.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Sequence

import jax
import numpy as np


def time_pipeline(
    red: Callable,
    make_args: Callable[[int], Sequence],
    *,
    iters: int = 5,
) -> Dict[str, float]:
    """red(*args) -> scalar (a jitted or compiled reduction of the pipeline's
    output).  make_args(i) must return freshly uniquified device inputs for
    iteration i (i == -1 for warmup)."""
    float(red(*make_args(-1)))  # warm
    times = []
    for i in range(iters):
        args = make_args(i)
        for a in args:
            jax.block_until_ready(a)
        t0 = time.perf_counter()
        float(red(*args))  # scalar readback forces real completion
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    return {
        "median_s": med,
        "min_s": float(np.min(times)),
        "fps": 1.0 / med if med > 0 else float("inf"),
    }
