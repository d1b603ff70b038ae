"""Capture a jax.profiler device trace of the KDE pipeline at 640x480 on a GPU.

Writes the trace to --out (default: traces/kde in the checkout) together with
the optimized HLO of the traced executable (hlo.txt), which
scripts/trace_aggregate.py uses to map each kernel to its jax.named_scope
stage (models/pipelines.py).  The step is `__graft_entry__.entry()`,
compiled without command buffers so that every kernel is its own event.

Usage: python scripts/trace_kde.py [--out DIR] [--runs 3]
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# one trace event per kernel: with XLA's command buffers (CUDA graphs) the
# whole executable shows as a single event
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
).strip()

import jax

from kinectdepthmapenhancement_tpu.core import device

device.require_gpu()
device.enable_compile_cache()

import jax.numpy as jnp

import __graft_entry__


def main() -> None:
    out = os.path.join(ROOT, "traces", "kde")
    if "--out" in sys.argv:
        out = sys.argv[sys.argv.index("--out") + 1]
    runs = int(sys.argv[sys.argv.index("--runs") + 1]) if "--runs" in sys.argv else 3

    fn, (depth, color) = __graft_entry__.entry()
    compiled = jax.jit(fn).lower(depth, color).compile()
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "hlo.txt"), "w") as f:
        f.write(compiled.as_text())
    jax.block_until_ready(compiled(depth, color))  # warm outside the trace

    with jax.profiler.trace(out):
        for i in range(runs):
            jax.block_until_ready(compiled(depth + jnp.float32(i) * 1e-3, color))
    print(f"trace of {runs} runs written to {out}")


if __name__ == "__main__":
    main()
