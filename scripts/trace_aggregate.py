"""Reduce a jax.profiler trace (scripts/trace_kde.py output) to per-stage
device time, kernel counts and the device's busy share.

Every event on a device plane ("/device:...") is one kernel or copy.  Its
HLO instruction (the event's `hlo_op` stat, else its name) is mapped to the
first jax.named_scope component of that instruction's op_name in the traced
executable's optimized HLO (hlo.txt beside the trace).  Busy time is the
union of all device event intervals; idle share = 1 - busy / window, where
the window runs from the first device event to the last.

Usage:
    python scripts/trace_kde.py --out DIR
    python scripts/trace_aggregate.py DIR [--runs 3] [--top 30]
"""

import collections
import glob
import os
import re
import sys

_INSTR = re.compile(
    r'^\s*(?:ROOT\s+)?%?([\w.\-]+) = .*?metadata=\{[^}]*op_name="([^"]*)"'
)


def scope_of(op_name: str) -> str:
    """First named-scope component of an op_name path ('kde.normals')."""
    for part in op_name.split("/"):
        if "." in part and "(" not in part:
            return part
    return "(unscoped)"


def load_scopes(hlo_path: str) -> dict:
    scopes = {}
    with open(hlo_path) as f:
        for line in f:
            m = _INSTR.match(line)
            if m:
                scopes[m.group(1)] = scope_of(m.group(2))
    return scopes


def device_events(trace_dir: str):
    """(hlo_op, start_ns, duration_ns) of every device-plane event."""
    from jax.profiler import ProfileData

    paths = sorted(glob.glob(f"{trace_dir}/plugins/profile/*/*.xplane.pb"))
    if not paths:
        raise SystemExit(f"no *.xplane.pb under {trace_dir}/plugins/profile/")
    for plane in ProfileData.from_file(paths[-1]).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for e in line.events:
                stats = dict(e.stats)
                yield str(stats.get("hlo_op", e.name)), e.start_ns, e.duration_ns


def busy_ns(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> None:
    trace_dir = sys.argv[1]
    runs = int(sys.argv[sys.argv.index("--runs") + 1]) if "--runs" in sys.argv else 3
    top = int(sys.argv[sys.argv.index("--top") + 1]) if "--top" in sys.argv else 30
    scopes = load_scopes(os.path.join(trace_dir, "hlo.txt"))

    by_scope = collections.Counter()
    launches = collections.Counter()
    kernels = collections.defaultdict(set)
    by_op = collections.Counter()
    intervals = []
    for op, start, dur in device_events(trace_dir):
        scope = scopes.get(op, "(not in hlo.txt)")
        by_scope[scope] += dur
        launches[scope] += 1
        kernels[scope].add(op)
        by_op[op] += dur
        intervals.append((start, start + dur))
    if not intervals:
        raise SystemExit("no device events in the trace")

    total = sum(by_scope.values())
    window = max(e for _, e in intervals) - min(s for s, _ in intervals)
    busy = busy_ns(intervals)
    print(f"device events: {sum(launches.values())} over {runs} runs")
    print(f"summed device time: {total / 1e6 / runs:.4f} ms/run")
    print(
        f"window {window / 1e6:.4f} ms, busy {busy / 1e6:.4f} ms, "
        f"idle share {1.0 - busy / window:.4f}\n"
    )
    print("== by named scope: ms/run, launches/run, distinct kernels ==")
    for s, ns in by_scope.most_common(top):
        print(
            f"{ns / 1e6 / runs:9.4f}  {launches[s] / runs:7.1f}  "
            f"{len(kernels[s]):5d}  {s}"
        )
    print("\n== by HLO instruction (ms/run) ==")
    for s, ns in by_op.most_common(top):
        print(f"{ns / 1e6 / runs:9.4f}  {scopes.get(s, '?'):20s}  {s}")


if __name__ == "__main__":
    main()
