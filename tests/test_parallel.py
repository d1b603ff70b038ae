import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax import shard_map
from jax.sharding import PartitionSpec as P

from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics
from kinectdepthmapenhancement_tpu.core.config import GridParams, KDEConfig
from kinectdepthmapenhancement_tpu.models.pipelines import kde_pipeline
from kinectdepthmapenhancement_tpu.parallel import halo
from kinectdepthmapenhancement_tpu.parallel.mesh import make_mesh
from kinectdepthmapenhancement_tpu.parallel.sharding import sharded_kde_step


requires_8 = pytest.mark.skipif(
    jax.device_count() < 8, reason="needs 8 virtual devices"
)


def _box5(x):
    """5x5 zero-padded box sum, the stencil shape of JBF/MRF."""
    p = jnp.pad(x, 2)
    out = jnp.zeros_like(x)
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            out = out + jax.lax.slice(
                p, (2 + dy, 2 + dx), (2 + dy + x.shape[0], 2 + dx + x.shape[1])
            )
    return out


@requires_8
def test_halo_exchange_box_sum_bitwise_equal():
    mesh = make_mesh(8, spatial=8)
    h, w = 32, 64
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(h, w)).astype(np.float32))

    def local(xs):
        padded = halo.exchange_width(xs, 2, "x")  # [H, ws+4]
        padded = jnp.pad(padded, ((2, 2), (0, 0)))
        out = jnp.zeros_like(xs)
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                out = out + jax.lax.slice(
                    padded, (2 + dy, 2 + dx), (2 + dy + xs.shape[0], 2 + dx + xs.shape[1])
                )
        return out

    f = shard_map(local, mesh=mesh, in_specs=P(None, "x"), out_specs=P(None, "x"))
    got = np.asarray(jax.jit(f)(x))
    want = np.asarray(_box5(x))
    np.testing.assert_array_equal(got, want)


@requires_8
def test_sharded_kde_matches_single_device():
    mesh = make_mesh(8, spatial=2)
    h, w = 96, 128
    intr = default_kinect_intrinsics(w, h)
    cfg = dataclasses.replace(KDEConfig(), grid=GridParams(rows=3, cols=4))
    rng = np.random.default_rng(0)
    batch = mesh.shape["data"]
    depth = jnp.asarray(rng.uniform(500, 4000, (batch, h, w)).astype(np.float32))
    color = jnp.asarray(rng.integers(0, 255, (batch, h, w, 3), dtype=np.uint8))

    step = sharded_kde_step(mesh, intr, cfg)
    res = step(depth, color)
    got = np.asarray(res.optimized_points)

    # image maps keep the (batch, width) tiling; cluster tables shard the batch
    for leaf in jax.tree_util.tree_leaves(res):
        want_spec = P("data", None, "x") if leaf.ndim >= 3 else P("data")
        assert leaf.sharding.is_equivalent_to(
            jax.sharding.NamedSharding(mesh, want_spec), leaf.ndim
        ), (leaf.shape, leaf.sharding)

    single = jax.jit(
        jax.vmap(lambda d, c: kde_pipeline(d, c, intr, cfg).optimized_points)
    )
    want = np.asarray(single(depth, color))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=0.5)


@requires_8
def test_jbf_sharded_bitwise_small():
    """Halo-routed production JBF (parallel/stencil_shard.py) == unsharded op
    bitwise, at spatial=8 so every shard is skinny and edge fixups matter."""
    from kinectdepthmapenhancement_tpu.ops import bilateral
    from kinectdepthmapenhancement_tpu.parallel.stencil_shard import jbf_sharded

    mesh = make_mesh(8, spatial=8)
    h, w = 48, 64
    rng = np.random.default_rng(5)
    depth = rng.uniform(400.0, 4000.0, (h, w)).astype(np.float32)
    depth[rng.random((h, w)) < 0.1] = 0.0  # invalid holes
    color = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
    d, c = jnp.asarray(depth), jnp.asarray(color)

    got = np.asarray(jax.jit(lambda a, b: jbf_sharded(a, b, mesh))(d, c))
    want = np.asarray(jax.jit(bilateral.joint_bilateral_filter)(d, c))
    np.testing.assert_array_equal(got, want)


@requires_8
@pytest.mark.full
def test_jbf_sharded_bitwise_full_res():
    """Full 640x480 at spatial=4 through the halo path."""
    from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu.ops import bilateral
    from kinectdepthmapenhancement_tpu.parallel.stencil_shard import jbf_sharded

    mesh = make_mesh(4, spatial=4)
    intr = default_kinect_intrinsics()
    color, noisy, _ = make_noisy_scene(480, 640, intr, seed=2)
    d, c = jnp.asarray(noisy), jnp.asarray(color)

    got = np.asarray(jax.jit(lambda a, b: jbf_sharded(a, b, mesh))(d, c))
    want = np.asarray(jax.jit(bilateral.joint_bilateral_filter)(d, c))
    np.testing.assert_array_equal(got, want)


@requires_8
def test_sharded_kde_data_parallel_matches_single_device():
    """Pure data parallelism ('x' == 1) routes through shard_map: each
    device runs the whole pipeline on its own frames, so every output field
    matches the unsharded batch."""
    mesh = make_mesh(8, spatial=1)
    h, w = 96, 128
    intr = default_kinect_intrinsics(w, h)
    cfg = dataclasses.replace(KDEConfig(), grid=GridParams(rows=3, cols=4))
    rng = np.random.default_rng(4)
    batch = mesh.shape["data"]
    depth = jnp.asarray(rng.uniform(500, 4000, (batch, h, w)).astype(np.float32))
    color = jnp.asarray(rng.integers(0, 255, (batch, h, w, 3), dtype=np.uint8))

    got = sharded_kde_step(mesh, intr, cfg)(depth, color)
    want = jax.jit(jax.vmap(lambda d, c: kde_pipeline(d, c, intr, cfg)))(
        depth, color
    )
    np.testing.assert_allclose(
        np.asarray(got.optimized_points), np.asarray(want.optimized_points),
        rtol=1e-4, atol=0.5,
    )
    agree = np.asarray(got.merged_labels) == np.asarray(want.merged_labels)
    assert agree.mean() > 0.995


@requires_8
def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


@requires_8
@pytest.mark.full
def test_sharded_kde_matches_single_device_full_res():
    """The FULL KDE pipeline at the reference's native
    640x480 through GSPMD spatial sharding (spatial=2), value-parity vs the
    unsharded run.  (Whether spatial sharding is a speedup needs >= 2 real
    chips; this proves it is CORRECT at full resolution.)"""
    from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene

    mesh = make_mesh(2, spatial=2)
    intr = default_kinect_intrinsics()
    color_np, noisy_np, _ = make_noisy_scene(480, 640, intr, seed=1)
    depth = jnp.asarray(noisy_np)[None]
    color = jnp.asarray(color_np)[None]

    step = sharded_kde_step(mesh, intr, KDEConfig())
    got = np.asarray(step(depth, color).optimized_points)

    single = jax.jit(
        jax.vmap(
            lambda d, c: kde_pipeline(d, c, intr, KDEConfig()).optimized_points
        )
    )
    want = np.asarray(single(depth, color))
    # scripts/analyze_sharded_gates.py
    # found ZERO diverging pixels at 640x480 on this mesh — GSPMD's spatial
    # partition preserves every reduction grouping that feeds a gate (cells
    # never straddle the x=2 shard cut at 640/2, and the K-side folds are
    # replicated).  The old 150 mm q99.99 allowance was defensive; gate the
    # strong property: NO pixel moves by more than 0.5 mm.  If a future
    # XLA/partitioner regroups a knife-edge f32 gate this fails loudly —
    # rerun the analysis script for the per-gate census before relaxing.
    diff = np.abs(got - want).max(-1)
    assert float(diff.max()) < 0.5
