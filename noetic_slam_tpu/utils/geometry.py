"""SO(3)/SE(3)/quaternion math used throughout the framework.

Conventions (chosen to match the reference's Eigen semantics so trajectories
are numerically comparable):

- Quaternions are ``(..., 4)`` arrays ordered ``(w, x, y, z)`` (Hamilton).
- Poses are either (q, p) pairs or 4x4 homogeneous matrices ``T``.
- ``quat_step`` is the reference's first-order quaternion integration
  ``q <- normalize(q + 0.5*dt * q ⊗ (0, ω))``
  (cf. reference src/dlio/src/dlio/odom.cc:1171-1178 and odom.cc:1322-1327).
- ``so3_exp`` matches reference src/dlio/include/nano_gicp/lsq_registration.h:82-101.

Everything here is shape-polymorphic over leading batch dims and jit-safe.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def quat_identity(dtype=jnp.float32) -> Array:
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat_mul(q1: Array, q2: Array) -> Array:
    """Hamilton product q1 ⊗ q2, both (..., 4) wxyz."""
    w1, x1, y1, z1 = jnp.moveaxis(q1, -1, 0)
    w2, x2, y2, z2 = jnp.moveaxis(q2, -1, 0)
    return jnp.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        axis=-1,
    )


def quat_conj(q: Array) -> Array:
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_normalize(q: Array, eps: float = 1e-12) -> Array:
    n = jnp.linalg.norm(q, axis=-1, keepdims=True)
    return q / jnp.maximum(n, eps)


def quat_rotate(q: Array, v: Array) -> Array:
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4).

    Uses the expanded form v' = v + 2*qw*(u x v) + 2*u x (u x v), u = q.vec.
    """
    u = q[..., 1:]
    w = q[..., :1]
    uv = jnp.cross(u, v)
    return v + 2.0 * (w * uv + jnp.cross(u, uv))


def quat_step(q: Array, omega: Array, dt) -> Array:
    """First-order quaternion integration (reference odom.cc:1171-1178).

    q <- normalize(q + 0.5*dt * q ⊗ (0, omega))
    """
    dq = quat_mul(q, jnp.concatenate([jnp.zeros_like(omega[..., :1]), omega], axis=-1))
    return quat_normalize(q + 0.5 * dt * dq)


def quat_to_mat(q: Array) -> Array:
    """Quaternion (..., 4) wxyz -> rotation matrix (..., 3, 3)."""
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_to_mat_np(q) -> "np.ndarray":
    """Host-side numpy quat->matrix (same math as quat_to_mat). For
    host-rate callers (keyframe archiving, descriptors): a device dispatch
    + fetch per call costs a host round trip each — thousands over a long
    run."""
    import numpy as np

    w, x, y, z = np.asarray(q, np.float64)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float32)


def make_se3_np(q, p) -> "np.ndarray":
    """Host-side numpy (q, p) -> homogeneous 4x4 (see quat_to_mat_np for
    why host-rate callers must avoid per-call device round trips)."""
    import numpy as np

    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = quat_to_mat_np(q)
    T[:3, 3] = np.asarray(p, np.float32)
    return T


def mat_to_quat_np(m) -> "np.ndarray":
    """Host-side numpy rotation matrix -> quaternion wxyz (same candidate
    selection as mat_to_quat; w >= 0 canonical)."""
    import numpy as np

    m = np.asarray(m, np.float64)
    m00, m01, m02 = m[0, 0], m[0, 1], m[0, 2]
    m10, m11, m12 = m[1, 0], m[1, 1], m[1, 2]
    m20, m21, m22 = m[2, 0], m[2, 1], m[2, 2]
    tr = m00 + m11 + m22
    cand = np.array([
        [1.0 + tr, m21 - m12, m02 - m20, m10 - m01],
        [m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20],
        [m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21],
        [m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22]])
    scores = np.array([1.0 + tr, 1.0 + m00 - m11 - m22,
                       1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22])
    q = cand[int(np.argmax(scores))]
    q = q / np.linalg.norm(q)
    if q[0] < 0:
        q = -q
    return q.astype(np.float32)


def mat_to_quat(m: Array) -> Array:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4) wxyz.

    Branch-free Shepperd-style construction (jit-safe): compute all four
    candidate quaternions and select the best-conditioned one.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidates, each scaled by 4*q_k^2 (k = w, x, y, z).
    qw = jnp.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], axis=-1)
    qx = jnp.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], axis=-1)
    qy = jnp.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], axis=-1)
    qz = jnp.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], axis=-1)

    scores = jnp.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                        1.0 - m00 - m11 + m22], axis=-1)
    idx = jnp.argmax(scores, axis=-1)
    cand = jnp.stack([qw, qx, qy, qz], axis=-2)  # (..., 4cand, 4)
    q = jnp.take_along_axis(cand, idx[..., None, None].astype(jnp.int32),
                            axis=-2)[..., 0, :]
    q = quat_normalize(q)
    # Canonicalize sign (w >= 0).
    return q * jnp.where(q[..., :1] < 0, -1.0, 1.0)


def so3_exp_quat(omega: Array) -> Array:
    """Rotation-vector exponential map -> quaternion (..., 4) wxyz.

    Matches reference lsq_registration.h:82-101 including the small-angle
    Taylor branch (selected via jnp.where, jit-safe).
    """
    theta_sq = jnp.sum(omega * omega, axis=-1, keepdims=True)
    theta_quad = theta_sq * theta_sq
    small = theta_sq < 1e-10
    # Guard sqrt for the small branch to keep gradients finite.
    theta = jnp.sqrt(jnp.where(small, 1.0, theta_sq))
    half = 0.5 * theta
    imag = jnp.where(small, 0.5 - theta_sq / 48.0 + theta_quad / 3840.0,
                     jnp.sin(half) / theta)
    real = jnp.where(small, 1.0 - theta_sq / 8.0 + theta_quad / 384.0,
                     jnp.cos(half))
    return jnp.concatenate([real, imag * omega], axis=-1)


def so3_log_quat(q: Array) -> Array:
    """Quaternion (..., 4) wxyz -> rotation vector (..., 3).

    Inverse of so3_exp_quat, with the small-angle Taylor branch and
    hemisphere canonicalization (w >= 0)."""
    q = q * jnp.where(q[..., :1] < 0, -1.0, 1.0)
    w = jnp.clip(q[..., :1], -1.0, 1.0)
    vn = jnp.linalg.norm(q[..., 1:], axis=-1, keepdims=True)
    theta = 2.0 * jnp.arctan2(vn, w)
    small = vn < 1e-8
    scale = jnp.where(small, 2.0 / jnp.maximum(w, 1e-8),
                      theta / jnp.maximum(vn, 1e-20))
    return q[..., 1:] * scale


def skew(v: Array) -> Array:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix (lsq_registration.h:70-80)."""
    x, y, z = jnp.moveaxis(v, -1, 0)
    zero = jnp.zeros_like(x)
    m = jnp.stack([zero, -z, y, z, zero, -x, -y, x, zero], axis=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def make_se3(q: Array, p: Array) -> Array:
    """(q (...,4), p (...,3)) -> homogeneous (..., 4, 4)."""
    R = quat_to_mat(q)
    batch = jnp.broadcast_shapes(R.shape[:-2], p.shape[:-1])
    T = jnp.zeros(batch + (4, 4), dtype=R.dtype)
    T = T.at[..., :3, :3].set(R)
    T = T.at[..., :3, 3].set(p)
    T = T.at[..., 3, 3].set(1.0)
    return T


def se3_q_p(T: Array) -> tuple[Array, Array]:
    """Homogeneous (..., 4, 4) -> (q, p)."""
    return mat_to_quat(T[..., :3, :3]), T[..., :3, 3]


def transform_points(T: Array, pts: Array) -> Array:
    """Apply SE(3) (4,4) (or batched (...,4,4)) to points (..., N, 3)."""
    return pts @ jnp.swapaxes(T[..., :3, :3], -1, -2) + T[..., None, :3, 3]


def quat_angle_deg(q1: Array, q2: Array) -> Array:
    """Rotation angle between two quaternions in degrees.

    Matches the reference's keyframe rotation test (odom.cc:1560-1568):
    dq = q1 * flip(q2)^-1 with hemisphere alignment, angle = 2*atan2(|vec|, w).
    """
    dot = jnp.sum(q1 * q2, axis=-1, keepdims=True)
    q2a = jnp.where(dot < 0, -q2, q2)
    dq = quat_mul(q1, quat_conj(q2a))  # unit quaternion: inverse == conjugate
    theta = 2.0 * jnp.arctan2(jnp.linalg.norm(dq[..., 1:], axis=-1),
                              jnp.abs(dq[..., 0]))
    return theta * (180.0 / jnp.pi)
