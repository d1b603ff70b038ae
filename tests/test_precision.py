"""Precision audit: every matrix product on the GPU route states its precision.

An f32 x f32 dot_general without a precision may run as TF32 (or bf16
passes) on an accelerator, which silently rounds the table gathers and sums
the plane gates compare.  Each pipeline is traced (nothing is compiled) on
the one-hot table route the GPU takes, and every dot_general in the jaxpr,
nested ones included, must have bf16 or integer operands or
Precision.HIGHEST.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import lax

from kinectdepthmapenhancement_tpu.core import registration
from kinectdepthmapenhancement_tpu.core.camera import (
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
from kinectdepthmapenhancement_tpu.ops import tables

H, W = 96, 128
GRID = GridParams(rows=3, cols=4)
INTR = default_kinect_intrinsics(W, H)


def _sub_jaxprs(value):
    if hasattr(value, "eqns"):
        yield value
    elif hasattr(value, "jaxpr") and hasattr(value.jaxpr, "eqns"):
        yield value.jaxpr
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for v in eqn.params.values():
            for sub in _sub_jaxprs(v):
                yield from _dots(sub)


def _stated(eqn) -> bool:
    dtypes = {np.dtype(v.aval.dtype) for v in eqn.invars}
    if dtypes <= {np.dtype(jnp.bfloat16)}:
        return True
    if all(np.issubdtype(d, np.integer) or d == np.bool_ for d in dtypes):
        return True
    prec = eqn.params.get("precision")
    precs = prec if isinstance(prec, tuple) else (prec,)
    return all(p == lax.Precision.HIGHEST for p in precs)


def _scene():
    color, noisy, _ = make_noisy_scene(H, W, INTR, seed=0)
    d = jnp.asarray(noisy)
    return d, projective_to_real(d, INTR), jnp.asarray(color)


CASES = {
    "jbf": lambda d, p, c: pipelines.jbf_pipeline(d, c),
    "mrf": lambda d, p, c: pipelines.mrf_pipeline(d, c),
    "rgbf": lambda d, p, c: pipelines.rgbf_pipeline(
        d, p, c, dataclasses.replace(RGBFConfig(), grid=GRID)
    ),
    "kde": lambda d, p, c: pipelines.kde_pipeline(
        d, c, INTR, dataclasses.replace(KDEConfig(), grid=GRID)
    ),
    "kde_plane_merge": lambda d, p, c: pipelines.kde_pipeline(
        d, c, INTR, dataclasses.replace(KDEConfig(), grid=GRID, plane_merge=True)
    ),
    "spdsp": lambda d, p, c: pipelines.spdsp_pipeline(
        d, p, c, INTR, dataclasses.replace(SPDSPConfig(), grid=GRID)
    ),
    "tof": lambda d, p, c: pipelines.tof_pipeline(
        d, p, c, INTR, dataclasses.replace(TOFConfig(), grid=GRID)
    ),
    "register_depth_to_color": lambda d, p, c: registration.register_depth_to_color(
        d, INTR, INTR,
        registration.Extrinsics(
            jnp.asarray(np.eye(3, dtype=np.float32)[::-1].copy()),
            jnp.asarray([25.0, 0.0, 0.0], jnp.float32),
        ),
    ),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_product_states_its_precision(name):
    d, p, c = _scene()
    tables.force_mode("onehot")
    try:
        jaxpr = jax.make_jaxpr(CASES[name])(d, p, c).jaxpr
    finally:
        tables.force_mode(None)
    dots = list(_dots(jaxpr))
    bad = [
        (str(e.params.get("precision")), [str(v.aval) for v in e.invars])
        for e in dots if not _stated(e)
    ]
    assert not bad, bad
    if name not in ("jbf", "mrf"):
        assert dots, "expected matrix products on the one-hot route"
