"""Committed golden-fixture cache for expensive NumPy oracle outputs.

The per-op/composed oracles (oracle*.py) are deliberate loop
transliterations of the reference CUDA (SURVEY.md §4) — correct, slow.  On a
cold machine they dominate the fast tier's wall clock together with XLA CPU
compiles.  This cache commits their OUTPUTS to tests/golden/*.npz, keyed by

  * a digest of every oracle_*.py source file (any oracle edit invalidates
    every fixture), and
  * a digest of the exact inputs (array bytes + dtypes/shapes + repr of
    scalars),

so a fixture is used only when it provably corresponds to the current oracle
code and the current inputs; on any mismatch the oracle is recomputed and
the fixture rewritten (self-healing regen — there is no way to consume a
stale fixture).  Regenerate everything with:

    rm -rf tests/golden && python -m pytest tests/ -q

and commit the refreshed .npz files.
"""

from __future__ import annotations

import glob
import hashlib
import os
from typing import Callable, Dict, Mapping

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


def _code_digest() -> str:
    h = hashlib.sha256()
    root = os.path.dirname(os.path.abspath(__file__))
    for path in sorted(glob.glob(os.path.join(root, "oracle*.py"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    return h.hexdigest()


_CODE_DIGEST = _code_digest()


def _input_digest(inputs: Mapping[str, object]) -> str:
    h = hashlib.sha256(_CODE_DIGEST.encode())
    for name in sorted(inputs):
        v = inputs[name]
        h.update(name.encode())
        if isinstance(v, np.ndarray):
            a = np.ascontiguousarray(v)
            h.update(str(a.dtype).encode())
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        else:
            h.update(repr(v).encode())
    return h.hexdigest()


def cached(
    name: str,
    inputs: Mapping[str, object],
    compute: Callable[[], Dict[str, np.ndarray]],
) -> Dict[str, np.ndarray]:
    """Return `compute()`'s dict-of-arrays, memoised in tests/golden/{name}.npz.

    `inputs` must contain every value the oracle result depends on (arrays
    and hashable scalars); the fixture is keyed by their digest + the oracle
    source digest and recomputed on any mismatch.
    """
    key = _input_digest(inputs)
    path = os.path.join(_DIR, f"{name}.npz")
    if os.path.exists(path):
        try:
            with np.load(path, allow_pickle=False) as z:
                if str(z["__key__"]) == key:
                    return {k: z[k] for k in z.files if k != "__key__"}
        except Exception:
            pass  # corrupt/foreign file: fall through and rewrite
    out = compute()
    assert all(isinstance(v, np.ndarray) for v in out.values()), (
        "golden.cached compute() must return a dict of numpy arrays"
    )
    os.makedirs(_DIR, exist_ok=True)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, __key__=np.asarray(key), **out)
    os.replace(tmp, path)
    return out


def _oracle_inputs(noisy, color, intr, grid, **extra):
    return dict(
        depth=noisy.astype(np.float64), color=color, fx=intr.fx, fy=intr.fy,
        cx=intr.cx, cy=intr.cy, rows=grid.rows, cols=grid.cols, **extra,
    )


def kde_oracle(name, noisy, color, intr, grid, max_fit_residual=0.0025):
    """Composed KDE oracle outputs (oracle_pipeline.kde_oracle), cached."""

    def compute():
        import oracle_pipeline

        return {
            k: np.asarray(v)
            for k, v in oracle_pipeline.kde_oracle(
                noisy.astype(np.float64), color, intr.fx, intr.fy, intr.cx,
                intr.cy, rows=grid.rows, cols=grid.cols,
                max_fit_residual=max_fit_residual,
            ).items()
        }

    return cached(
        name,
        _oracle_inputs(
            noisy, color, intr, grid, max_fit_residual=max_fit_residual
        ),
        compute,
    )


def rgbf_oracle(name, noisy, color, intr, grid):
    """Composed RGBF oracle outputs (oracle_pipeline.rgbf_oracle), cached."""

    def compute():
        import oracle_pipeline

        return {
            k: np.asarray(v)
            for k, v in oracle_pipeline.rgbf_oracle(
                noisy.astype(np.float64), color, intr.fx, intr.fy, intr.cx,
                intr.cy, rows=grid.rows, cols=grid.cols,
            ).items()
        }

    return cached(name, _oracle_inputs(noisy, color, intr, grid), compute)
