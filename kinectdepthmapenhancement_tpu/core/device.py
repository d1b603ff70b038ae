"""The one module that knows which device the program runs on.

* `require_gpu()` — measurement and smoke entry points refuse any device but
  an NVIDIA GPU; they never fall back to the CPU.
* `enable_compile_cache()` — JAX's persistent compile cache.  It lives where
  `JAX_COMPILATION_CACHE_DIR` says (JAX reads that variable itself), and
  otherwise at the fixed `.jax_cache/` in the checkout root.  The path is
  part of the cache key, so it never comes from a temp name, a pid or a time.
* `device_info()` — platform, device kind and count, for every result line.
* `gpu_name_and_power_limit()` — what `nvidia-smi` reports for the card.
* `onehot_tables()` — the only backend branch: cluster-table gathers and
  segment sums run as one-hot matrix products off the CPU (exact at f32
  `Precision.HIGHEST`, deterministic), and as `jnp.take` /
  `jax.ops.segment_sum` on the CPU.
"""

from __future__ import annotations

import os
import subprocess
from pathlib import Path
from typing import Optional

import jax

CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


def require_gpu() -> jax.Device:
    """JAX's first device, which must be a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            f"a GPU is required; JAX's first device is {dev.platform} "
            f"({dev.device_kind})"
        )
    return dev


def device_info() -> dict:
    devs = jax.devices()
    return {
        "platform": devs[0].platform,
        "kind": devs[0].device_kind,
        "count": len(devs),
    }


def gpu_name_and_power_limit() -> str:
    """`name, power.limit` of every card, one line each, from nvidia-smi."""
    return subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        check=True,
        capture_output=True,
        text=True,
        timeout=60,
    ).stdout.strip()


def onehot_tables(backend: Optional[str] = None) -> bool:
    """Whether cluster tables are gathered and summed by one-hot products on
    `backend` (default: JAX's default backend)."""
    return (backend or jax.default_backend()) != "cpu"
