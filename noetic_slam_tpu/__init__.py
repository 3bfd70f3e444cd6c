"""noetic_slam_tpu — LiDAR-inertial SLAM + TSDF mapping framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
`noetic-slam` reference stack (DLIO odometry + mapping + dataset ingest):

- ``ops``      — device kernels: IMU integration, motion deskew, voxel
                 downsampling, nearest-neighbor search, GICP linearization,
                 TSDF scatter (jnp + Pallas variants).
- ``models``   — the SLAM "model families": odometry (DLIO-style), TSDF
                 fusion backend, keyframe pose-graph optimization.
- ``parallel`` — jax.sharding mesh utilities, sharded NN/registration,
                 distributed bundle adjustment via collectives.
- ``io``       — dataset ingest (MulRan, Ouster packet format), map export
                 (PLY/PCD), trajectory export, replay clock.
- ``runtime``  — host-side pipeline drivers (the replacement for the
                 reference's ROS node graph), ring buffers, prefetch.
- ``utils``    — SE(3)/SO(3)/quaternion math, masking helpers, profiling.
- ``config``   — the full typed parameter surface of the reference
                 (cfg/dlio.yaml + cfg/params.yaml equivalents).

The reference's per-process ROS topic graph is replaced with in-program
function composition over explicit state pytrees; every hot loop is a
jit-compiled, statically-shaped computation.
"""

__version__ = "0.1.0"

from noetic_slam_tpu.config.params import DlioConfig  # noqa: F401
