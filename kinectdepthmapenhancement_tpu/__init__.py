"""kinectdepthmapenhancement_tpu — an RGB-D depth-map enhancement framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the reference CUDA
codebase stevesuyao/KinectDepthMapEnhancement (see SURVEY.md).  The reference's
OO "component owns device buffers + launches kernels" architecture becomes pure
functions over pytrees here; pipelines are end-to-end jittable compositions with
no host round-trips, batchable with vmap and shardable over a device mesh.

Layout
------
core/      camera model, frame/config types, temporal depth buffer, IO,
           the device choice (core/device.py)
ops/       the device ops: bilateral filters, SLIC superpixels, edge refine,
           connected-component merging, integral images, normal estimation,
           plane fitting/projection/optimisation
models/    the six enhancement pipelines (JBF, MRF, RGBF, KDE, SPDSP, TOF)
parallel/  mesh construction, spatial tiling + halo exchange, batch sharding
utils/     eval metrics, timing harness, misc helpers
native/    C++ host runtime (frame decode/streaming); optional, ctypes-bound
"""

from kinectdepthmapenhancement_tpu.core.camera import (
    Intrinsics,
    default_kinect_intrinsics,
    normalized_rays,
    projective_to_real,
    real_to_projective,
)
from kinectdepthmapenhancement_tpu.core.config import (
    KDEConfig,
    RGBFConfig,
    SPDSPConfig,
    SLICParams,
    PipelineConfig,
)

__version__ = "0.1.0"
