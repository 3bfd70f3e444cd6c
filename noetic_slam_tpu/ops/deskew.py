"""Motion deskew: per-point SE(3) transform into the world frame.

Re-expresses the reference's OpenMP deskew loop (odom.cc:690-701): each point
is transformed by the interpolated baselink pose of its (unique) timestamp
composed with the baselink<-lidar extrinsic:

    p_world = R_frame @ (R_ext @ p + t_ext) + p_frame

This is a pure gather + fused elementwise computation over the whole
padded scan — XLA runs it in one pass; no kernel is needed because it is
memory-bound and fully fuses with neighboring ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from noetic_slam_tpu.ops.pointcloud import SENTINEL, PreparedScan
from noetic_slam_tpu.utils.geometry import quat_rotate

Array = jax.Array


def deskew_points(scan: PreparedScan, frames_q: Array, frames_p: Array,
                  R_ext: Array, t_ext: Array) -> Array:
    """Transform each point by its frame pose (odom.cc:690-701).

    Args:
      scan: prepared (time-sorted) scan with per-point frame indices.
      frames_q/frames_p: (F, 4)/(F, 3) interpolated baselink poses at the
        scan's unique timestamps (from ops.imu.integrate_imu).
      R_ext/t_ext: baselink<-lidar extrinsic (3,3)/(3,).

    Returns:
      (N, 3) world-frame points; invalid slots keep the sentinel position.
    """
    q = frames_q[scan.frame_idx]
    p = frames_p[scan.frame_idx]
    # HIGHEST precision: a default-precision f32 matmul may round its
    # operands (bf16 keeps 8 mantissa bits, TF32 on the GPU 11) — a 30 m
    # coordinate then quantizes to centimeters or worse, which silently
    # degrades registration on weakly-constrained scenes (platform-
    # divergent drift: the SAME scenario tracked on CPU and ran away on
    # an accelerator)
    local = jnp.dot(scan.xyz, R_ext.T,
                    precision=jax.lax.Precision.HIGHEST) + t_ext
    world = quat_rotate(q, local) + p
    return jnp.where(scan.valid[:, None], world, SENTINEL)


def transform_cloud(xyz: Array, valid: Array, T: Array) -> Array:
    """Rigid transform of a masked cloud by a single 4x4 (sentinel preserved)."""
    out = jnp.dot(xyz, T[:3, :3].T,
                  precision=jax.lax.Precision.HIGHEST) + T[:3, 3]
    return jnp.where(valid[:, None], out, SENTINEL)
