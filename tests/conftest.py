"""Test configuration: CPU with 8 virtual devices unless JAX_PLATFORMS says
otherwise (the on-card tests, marked `gpu`, run with JAX_PLATFORMS=cuda).

The 8 virtual CPU devices give sharding/collective correctness without a
multi-card host (SURVEY.md §4).  XLA compiles of the composed pipelines
dominate the tier, so the persistent compile cache is on
(core/device.py::enable_compile_cache).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pytest

from kinectdepthmapenhancement_tpu.core import device

device.enable_compile_cache()


@pytest.fixture
def gpu():
    """The first GPU; skips the test when JAX has none."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX_PLATFORMS=cuda); found {dev.platform}")
    return dev


@pytest.fixture(scope="session")
def small_scene():
    """Small procedural RGB-D scene for op-level golden tests."""
    from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics

    h, w = 96, 128
    intr = default_kinect_intrinsics(w, h)
    color, noisy, gt = make_noisy_scene(h, w, intr, seed=3)
    return {"color": color, "depth": noisy, "gt": gt, "intr": intr}


@pytest.fixture(scope="session")
def full_scene():
    """Full 640x480 scene for end-to-end pipeline tests."""
    from kinectdepthmapenhancement_tpu.core.testdata import make_noisy_scene
    from kinectdepthmapenhancement_tpu.core.camera import default_kinect_intrinsics

    intr = default_kinect_intrinsics()
    color, noisy, gt = make_noisy_scene(480, 640, intr, seed=0)
    return {"color": color, "depth": noisy, "gt": gt, "intr": intr}
