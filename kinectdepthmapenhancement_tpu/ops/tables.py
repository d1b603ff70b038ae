"""Cluster-table access primitives: gathers and segment sums as one-hot products.

The framework constantly moves data between the image plane [H, W] and the
~300-row cluster tables [K, F]: per-pixel gathers (table[labels]) and
per-cluster reductions (segment sums).  A one-hot label matrix P [N, K]
(exact 0/1 rows, all-zero for invalid labels) turns

    gather:       table[labels]  ==  P @ table
    segment sum:  sum per label  ==  P.T @ feats

into matrix products.  With float32 operands at Precision.HIGHEST the
products are true f32: since every P row has at most a single 1, a gathered
value equals the table value to the last bit, and a sum is an f32 sum whose
order does not change from run to run (native scatter-adds use atomics on
the GPU, whose order does).

`core/device.py::onehot_tables` picks this route off the CPU; on the CPU
(tests/oracle parity) the primitives use jnp.take / jax.ops.segment_sum,
which are exact and fast there.  `force_mode` lets tests pin either route.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from kinectdepthmapenhancement_tpu.core import device

_FORCE: Optional[str] = None  # None | "onehot" | "reference"


def force_mode(mode: Optional[str]) -> None:
    global _FORCE
    assert mode in (None, "onehot", "reference")
    _FORCE = mode


def use_onehot() -> bool:
    if _FORCE is not None:
        return _FORCE == "onehot"
    return device.onehot_tables()


def one_hot(labels: jnp.ndarray, k: int) -> jnp.ndarray:
    """[N, K] bf16 one-hot of flattened labels; invalid (<0 or >=k) rows are
    all zero.  0/1 are exact in bf16 and the matrix is the framework's
    single biggest intermediate, so halving its bytes matters."""
    flat = labels.reshape(-1)
    return (flat[:, None] == jnp.arange(k, dtype=flat.dtype)[None, :]).astype(
        jnp.bfloat16
    )


def _dot(p: jnp.ndarray, t: jnp.ndarray, contract_p: int) -> jnp.ndarray:
    """Exact one-hot product: p (0/1) x t (f32) -> f32 with no precision loss
    beyond f32 accumulation.  contract_p: which axis of p contracts (1 for
    gather, 0 for segment sum).

    One f32 x f32 dot at Precision.HIGHEST.  Do not split t into bf16 parts
    and sum several bf16 dots: XLA may fuse the parts back together at bf16,
    silently rounding every gathered value to 8 mantissa bits, and the CPU
    backend does not reproduce that.  `chip_smoke.py` checks gathers for
    exactness and sums against a float64 reference on the card."""
    dn = (((contract_p,), (0,)), ((), ()))
    return jax.lax.dot_general(
        p.astype(jnp.float32),
        t.astype(jnp.float32),
        dimension_numbers=dn,
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )


def gather(table: jnp.ndarray, labels: jnp.ndarray, *, onehot: Optional[jnp.ndarray] = None):
    """table[labels] with 0 for invalid labels.  table: [K] or [K, F];
    labels: any shape.  Pass a precomputed `onehot` to amortise it."""
    shape = labels.shape
    squeeze = table.ndim == 1
    t2 = table[:, None] if squeeze else table
    if use_onehot():
        p = one_hot(labels, t2.shape[0]) if onehot is None else onehot
        out = _dot(p, t2.astype(jnp.float32), contract_p=1)
        out = out.reshape(shape + (t2.shape[1],))
    else:
        idx = jnp.clip(labels, 0, t2.shape[0] - 1)
        out = jnp.take(t2, idx, axis=0)
        out = jnp.where((labels >= 0)[..., None], out, 0.0)
    return out[..., 0] if squeeze else out


def segment_sum(feats: jnp.ndarray, labels: jnp.ndarray, k: int, *, onehot=None):
    """Per-cluster sums of feats [..., F] grouped by labels [...] -> [K, F].
    Invalid labels (<0) are dropped.

    One-hot route: P.T x feats as one f32 x f32 dot at Precision.HIGHEST
    (see _dot) — equal to the reference route up to f32 summation order."""
    f = feats.reshape(-1, feats.shape[-1]).astype(jnp.float32)
    if use_onehot():
        p = one_hot(labels, k) if onehot is None else onehot
        return _dot(p, f, contract_p=0)
    flat = jnp.where(labels.reshape(-1) >= 0, labels.reshape(-1), k)
    return jax.ops.segment_sum(f, flat, num_segments=k + 1)[:k]
