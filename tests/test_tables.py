"""One-hot product route vs reference gather/segment-sum: must agree."""

import numpy as np
import jax.numpy as jnp
import pytest

from kinectdepthmapenhancement_tpu.ops import tables


@pytest.fixture(autouse=True)
def _reset_mode():
    yield
    tables.force_mode(None)


def _data(seed=0, n=999, k=37, f=5):
    rng = np.random.default_rng(seed)
    table = rng.normal(scale=100.0, size=(k, f)).astype(np.float32)
    labels = rng.integers(-1, k, size=(n,)).astype(np.int32)
    feats = rng.normal(scale=10.0, size=(n, f)).astype(np.float32)
    return jnp.asarray(table), jnp.asarray(labels), jnp.asarray(feats), k


def test_gather_modes_agree():
    table, labels, _, k = _data()
    tables.force_mode("reference")
    ref = np.asarray(tables.gather(table, labels))
    tables.force_mode("onehot")
    onehot = np.asarray(tables.gather(table, labels))
    # one-hot rows have a single 1: the matmul IS the table value
    np.testing.assert_allclose(onehot, ref, rtol=0, atol=1e-5)
    # and exactly zero for invalid labels
    assert np.all(onehot[np.asarray(labels) < 0] == 0.0)


def test_gather_1d_table():
    rng = np.random.default_rng(1)
    t = jnp.asarray(rng.uniform(0, 1, 29).astype(np.float32))
    labels = jnp.asarray(rng.integers(-1, 29, size=(64,)).astype(np.int32))
    tables.force_mode("reference")
    ref = np.asarray(tables.gather(t, labels))
    tables.force_mode("onehot")
    onehot = np.asarray(tables.gather(t, labels))
    np.testing.assert_allclose(onehot, ref, atol=1e-7)


def test_gather_exact_sentinels():
    """-1.0 sentinel values must survive the matmul exactly (validity tests
    downstream compare with == -1.0)."""
    t = jnp.asarray(np.array([[-1.0, -1.0, -1.0], [0.5, -1.0, 2.0]], np.float32))
    labels = jnp.asarray(np.array([0, 1, 0], np.int32))
    tables.force_mode("onehot")
    out = np.asarray(tables.gather(t, labels))
    assert np.all(out[0] == -1.0) and out[1, 1] == -1.0


def test_segment_sum_modes_agree():
    table, labels, feats, k = _data(2)
    tables.force_mode("reference")
    ref = np.asarray(tables.segment_sum(feats, labels, k))
    tables.force_mode("onehot")
    onehot = np.asarray(tables.segment_sum(feats, labels, k))
    np.testing.assert_allclose(onehot, ref, rtol=1e-6, atol=1e-3)


def test_segment_sum_counts_exact():
    """Sums of ones (cluster sizes) must be exact integers on both paths."""
    _, labels, _, k = _data(3, n=5000)
    ones = jnp.ones((5000, 1), jnp.float32)
    tables.force_mode("onehot")
    onehot = np.asarray(tables.segment_sum(ones, labels, k))[:, 0]
    tables.force_mode("reference")
    ref = np.asarray(tables.segment_sum(ones, labels, k))[:, 0]
    np.testing.assert_array_equal(onehot, ref)
    assert np.all(onehot == np.round(onehot))


def test_ccl_merge_same_under_both_modes():
    """End-to-end CCL parity between the two table paths."""
    from kinectdepthmapenhancement_tpu.ops import ccl

    rng = np.random.default_rng(4)
    k = 12
    labels = np.repeat(np.repeat(rng.integers(0, k, (4, 4)), 6, 0), 8, 1)
    normals = rng.normal(size=(k, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    centers = rng.uniform(500, 3000, size=(k, 3)).astype(np.float32)
    args = (
        jnp.asarray(labels, jnp.int32),
        jnp.asarray(normals, jnp.float32),
        jnp.asarray(centers),
    )
    tables.force_mode("reference")
    ref = ccl.merge_normals(*args)
    tables.force_mode("onehot")
    onehot = ccl.merge_normals(*args)
    np.testing.assert_array_equal(np.asarray(ref.labels), np.asarray(onehot.labels))
    np.testing.assert_allclose(
        np.asarray(ref.nd_map), np.asarray(onehot.nd_map), rtol=1e-4, atol=1e-2
    )
    np.testing.assert_array_equal(np.asarray(ref.sizes), np.asarray(onehot.sizes))


def test_slic_same_under_both_modes(small_scene):
    from kinectdepthmapenhancement_tpu.core.camera import projective_to_real
    from kinectdepthmapenhancement_tpu.core.config import GridParams, SLICParams
    from kinectdepthmapenhancement_tpu.ops import slic

    color = small_scene["color"][:48, :64]
    depth = small_scene["depth"][:48, :64]
    pts = projective_to_real(jnp.asarray(depth), small_scene["intr"])
    grid = GridParams(3, 4)
    p = SLICParams(100.0, 20.0, 200.0, 0.0, 2)
    tables.force_mode("reference")
    ref = slic.segment(jnp.asarray(color), pts, grid=grid, params=p, variant="dasp")
    tables.force_mode("onehot")
    onehot = slic.segment(jnp.asarray(color), pts, grid=grid, params=p, variant="dasp")
    np.testing.assert_array_equal(np.asarray(ref.labels), np.asarray(onehot.labels))
    np.testing.assert_allclose(
        np.asarray(ref.clusters.center), np.asarray(onehot.clusters.center),
        rtol=1e-5, atol=1e-2,
    )


@pytest.mark.parametrize("r", [1, 2, 4])
def test_cell_index_matches_reference_tables(r):
    """The cell-local index (the GPU route of every single-iteration SLIC
    and its downstream CCL/plane gathers) against the reference gather and
    segment sum, for labels anywhere in each cell's [-r, r-1]^2
    neighbourhood (and -1)."""
    from kinectdepthmapenhancement_tpu.core.config import GridParams
    from kinectdepthmapenhancement_tpu.ops import slic

    grid = GridParams(rows=6, cols=8)
    h, w, k, f = 96, 128, grid.num_clusters, 6
    rng = np.random.default_rng(r)
    cy = (np.arange(h) // (h // grid.rows))[:, None]
    cx = (np.arange(w) // (w // grid.cols))[None, :]
    ny = np.clip(cy + rng.integers(-r, r, (h, w)), 0, grid.rows - 1)
    nx = np.clip(cx + rng.integers(-r, r, (h, w)), 0, grid.cols - 1)
    lab = np.where(rng.random((h, w)) < 0.1, -1, ny * grid.cols + nx)
    labels = jnp.asarray(lab.astype(np.int32))
    table = jnp.asarray(rng.normal(scale=1e3, size=(k, f)).astype(np.float32))
    feats = jnp.asarray(rng.normal(scale=10.0, size=(h, w, f)).astype(np.float32))
    mask = jnp.asarray(rng.random((h, w)) < 0.8)

    tables.force_mode("onehot")
    idx = slic._CellIndex(labels, grid, r, h, w)
    got_g = np.asarray(idx.gather(table))
    got_s = np.asarray(idx.segment_sum(feats, mask))
    got_c = np.asarray(idx.counts())

    tables.force_mode("reference")
    want_g = np.asarray(tables.gather(table, labels))
    want_s = np.asarray(
        tables.segment_sum(feats, jnp.where(mask, labels, -1), k)
    )
    np.testing.assert_array_equal(got_g, want_g)
    np.testing.assert_allclose(got_s, want_s, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got_c, np.bincount(lab[lab >= 0], minlength=k))
