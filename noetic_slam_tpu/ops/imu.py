"""Continuous-time analytic IMU integration.

Re-derivation of the reference's hot IMU path
(``integrateImu`` / ``integrateImuInternal``, reference
src/dlio/src/dlio/odom.cc:1056-1228) as a statically-shaped JAX computation:

- the per-sample sequential loop becomes a PARALLEL PREFIX computation:
  per-interval delta quaternions compose by an associative Hamilton
  product (``lax.associative_scan``, log-depth on the VPU instead of a
  128-step serial ``lax.scan``), after which world accelerations are a
  batched rotation and velocity/position are cumulative sums — the exact
  same recurrence, reordered (a ``lax.scan`` reference implementation is
  kept for parity tests);
- pose queries at arbitrary sorted timestamps become a vmapped closed-form
  interpolation over gathered bracketing intervals (instead of the reference's
  interleaved two-pointer walk).

Numerical model per interval [s_i, s_{i+1}] (dt = t_{i+1} - t_i):
  angular accel   alpha = (w_{i+1} - w_i) / dt          (odom.cc:1160-1162)
  avg ang. vel    omega = w_i + 0.5*(w_{i+1} - w_i)     (odom.cc:1165)
  orientation     q_{i+1} = normalize(q_i + 0.5*dt * q_i ⊗ (0, omega))
  world accel     a_i = R(q_i) f_i - g e_z              (odom.cc:1182-1184)
  jerk            j = (a_{i+1} - a_i) / dt              (odom.cc:1187-1188)
  position        p_{i+1} = p_i + v_i dt + 0.5 a_i dt^2 + (1/6) j dt^3
  velocity        v_{i+1} = v_i + a_i dt + 0.5 (a_{i+1}-a_i) dt

Query interpolation for t in (s_i, s_{i+1}], idt = t - s_i:
  omega_q = w_i + 0.5*alpha*idt
  q(t)    = normalize(q_{i+1} + 0.5*idt * q_{i+1} ⊗ (0, omega_q))
  p(t)    = p_i + v_i idt + 0.5 a_i idt^2 + (1/6) j idt^3

NOTE the orientation interpolation steps forward from q_{i+1} (the *end* of
the interval), not q_i — this mirrors the reference exactly (odom.cc:1203-1210
runs after q has been advanced at odom.cc:1168-1178); we preserve it for
trajectory parity.

The backward extrapolation from ``start_time`` to the first IMU sample
(odom.cc:1112-1155) is reproduced in ``integrate_imu``'s prologue.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from noetic_slam_tpu.utils.geometry import (
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_step,
)

Array = jax.Array


class ImuWindow(NamedTuple):
    """A fixed-size window of bias-corrected, baselink-frame IMU samples.

    ``stamps`` must be sorted ascending over the valid prefix; entries at or
    beyond ``count`` are padding and must satisfy stamp[k] >= stamp[count-1]
    (use ``pad_window`` / ``slice_imu_window`` to construct safely).
    """

    stamps: Array     # (M,) float64-ish times [s] (float32 ok for rel. time)
    ang_vel: Array    # (M, 3) rad/s
    lin_accel: Array  # (M, 3) m/s^2
    count: Array      # () int32 number of valid samples


def pad_window(stamps, ang_vel, lin_accel, count, capacity: int) -> ImuWindow:
    """Pad/trim host arrays into an ImuWindow with sane padding values."""
    m = stamps.shape[0]
    if m < capacity:
        pad = capacity - m
        last = stamps[-1] if m else 0.0
        stamps = jnp.concatenate(
            [stamps, last + 1.0 + jnp.arange(pad, dtype=stamps.dtype)])
        ang_vel = jnp.concatenate([ang_vel, jnp.zeros((pad, 3), ang_vel.dtype)])
        lin_accel = jnp.concatenate(
            [lin_accel, jnp.zeros((pad, 3), lin_accel.dtype)])
    return ImuWindow(stamps[:capacity], ang_vel[:capacity], lin_accel[:capacity],
                     jnp.asarray(count, jnp.int32))


def slice_imu_window(buf_stamps: Array, buf_ang_vel: Array, buf_accel: Array,
                     buf_count: Array, start_time: Array, end_time: Array,
                     capacity: int) -> ImuWindow:
    """Select the integration window from a chronologically sorted IMU buffer.

    Matches reference ``imuMeasFromTimeRange`` (odom.cc:1020-1054): the window
    starts at the newest sample with stamp < start_time and must extend through
    the oldest sample with stamp >= end_time. Device-side, fixed ``capacity``.
    """
    n = buf_stamps.shape[0]
    if n < capacity:  # short buffers: pad so the fixed-size slice stays legal
        pad = capacity - n
        last = buf_stamps[n - 1]
        buf_stamps = jnp.concatenate(
            [buf_stamps, last + 1.0 + jnp.arange(pad, dtype=buf_stamps.dtype)])
        buf_ang_vel = jnp.concatenate(
            [buf_ang_vel, jnp.zeros((pad, 3), buf_ang_vel.dtype)])
        buf_accel = jnp.concatenate(
            [buf_accel, jnp.zeros((pad, 3), buf_accel.dtype)])
        n = capacity
    # Index of newest sample with stamp < start_time, clamped to the range
    # where a full fixed-size slice is legal (dynamic_slice clamps the start
    # the same way; computing `lo` identically keeps `count` consistent).
    lo = jnp.searchsorted(buf_stamps, start_time, side="left") - 1
    lo = jnp.clip(lo, 0, n - capacity)
    stamps = jax.lax.dynamic_slice_in_dim(buf_stamps, lo, capacity)
    ang = jax.lax.dynamic_slice_in_dim(buf_ang_vel, lo, capacity)
    acc = jax.lax.dynamic_slice_in_dim(buf_accel, lo, capacity)
    # Valid samples: those within the buffer's valid region, up through the
    # first sample at/after end_time.
    hi = jnp.searchsorted(buf_stamps, end_time, side="left")  # first >= end
    count = jnp.clip(jnp.minimum(hi + 1, buf_count) - lo, 0, capacity)
    return ImuWindow(stamps, ang, acc, count.astype(jnp.int32))


class _IntervalData(NamedTuple):
    q_end: Array   # (M-1, 4) orientation at interval end s_{i+1}
    p0: Array      # (M-1, 3) position at s_i
    v0: Array      # (M-1, 3) velocity at s_i
    a0: Array      # (M-1, 3) world accel (gravity-subtracted) at s_i
    jerk: Array    # (M-1, 3)
    alpha: Array   # (M-1, 3) angular accel
    w0: Array      # (M-1, 3) body ang vel at s_i
    t0: Array      # (M-1,) stamp of s_i


def quat_prefix(q0: Array, omegas: Array, dts: Array) -> Array:
    """Orientations q_k at every sample from first-order quaternion steps.

    q_{k+1} = normalize(q_k + 0.5*dt_k * q_k ⊗ (0, omega_k))
            = normalize(q_k ⊗ (1, 0.5*dt_k*omega_k))

    The per-interval delta quaternions compose by the (associative)
    Hamilton product, so the K-step serial recurrence becomes a log-depth
    ``lax.associative_scan``; normalization commutes with the product
    (|a ⊗ b| = |a||b|) and is applied once at the end, replacing K
    serial lax.scan steps with log2(K) levels.

    Args: q0 (4,), omegas (K, 3), dts (K,). Returns (K+1, 4) normalized.
    """
    half = 0.5 * dts[:, None] * omegas
    deltas = jnp.concatenate([jnp.ones_like(half[:, :1]), half], axis=-1)
    prods = jax.lax.associative_scan(quat_mul, deltas)       # (K, 4)
    q_all = jnp.concatenate([q0[None], quat_mul(q0[None], prods)], axis=0)
    return quat_normalize(q_all)


def _scan_intervals(window: ImuWindow, q0: Array, p0: Array, v0: Array,
                    gravity: float) -> _IntervalData:
    """Propagation over IMU samples (odom.cc:1157-1222), parallel form.

    Identical recurrence to ``_scan_intervals_seq`` reordered into
    (1) orientation prefix products, (2) batched accel rotation,
    (3) velocity/position cumulative sums.
    """
    g = jnp.asarray([0.0, 0.0, gravity], dtype=p0.dtype)
    stamps, w, f = window.stamps, window.ang_vel, window.lin_accel
    dts = jnp.maximum(stamps[1:] - stamps[:-1], 1e-8)

    omega = w[:-1] + 0.5 * (w[1:] - w[:-1])
    q_all = quat_prefix(q0, omega, dts)                       # (M, 4)
    a_all = quat_rotate(q_all, f) - g                         # (M, 3)

    a0, a1 = a_all[:-1], a_all[1:]
    jerk = (a1 - a0) / dts[:, None]
    dv = 0.5 * (a0 + a1) * dts[:, None]
    v_all = v0[None] + jnp.concatenate(
        [jnp.zeros((1, 3), dv.dtype), jnp.cumsum(dv, axis=0)], axis=0)
    dp = (v_all[:-1] * dts[:, None] + 0.5 * a0 * (dts ** 2)[:, None]
          + (1.0 / 6.0) * jerk * (dts ** 3)[:, None])
    p_all = p0[None] + jnp.concatenate(
        [jnp.zeros((1, 3), dp.dtype), jnp.cumsum(dp, axis=0)], axis=0)

    alpha = (w[1:] - w[:-1]) / dts[:, None]
    return _IntervalData(q_end=q_all[1:], p0=p_all[:-1], v0=v_all[:-1],
                         a0=a0, jerk=jerk, alpha=alpha, w0=w[:-1],
                         t0=stamps[:-1])


def _scan_intervals_seq(window: ImuWindow, q0: Array, p0: Array, v0: Array,
                        gravity: float) -> _IntervalData:
    """Sequential reference implementation (lax.scan) — kept for parity
    tests of the parallel-prefix form above."""
    g = jnp.asarray([0.0, 0.0, gravity], dtype=p0.dtype)
    stamps, w, f = window.stamps, window.ang_vel, window.lin_accel
    a_first = quat_rotate(q0, f[0]) - g

    dts = jnp.maximum(stamps[1:] - stamps[:-1], 1e-8)

    def step(carry, xs):
        q, p, v, a = carry
        dt, w0, w1, f1, = xs
        alpha = (w1 - w0) / dt
        omega = w0 + 0.5 * (w1 - w0)
        q_new = quat_step(q, omega, dt)
        a_new = quat_rotate(q_new, f1) - g
        j = (a_new - a) / dt
        p_new = p + v * dt + 0.5 * a * dt * dt + (1.0 / 6.0) * j * dt ** 3
        v_new = v + a * dt + 0.5 * (a_new - a) * dt
        out = _IntervalData(q_new, p, v, a, j, alpha, w0, jnp.float32(0.0))
        return (q_new, p_new, v_new, a_new), out

    xs = (dts, w[:-1], w[1:], f[1:])
    _, ys = jax.lax.scan(step, (q0, p0, v0, a_first), xs)
    return ys._replace(t0=stamps[:-1])


def integrate_imu(window: ImuWindow, start_time: Array, q_init: Array,
                  p_init: Array, v_init: Array, query_times: Array,
                  gravity: float = 9.80665):
    """Integrate IMU over ``window`` and interpolate poses at ``query_times``.

    Args:
      window: IMU window whose first sample is the newest sample strictly
        before ``start_time`` (reference begin_imu_it, odom.cc:1088-1091).
      start_time: time at which (q_init, p_init, v_init) hold.
      query_times: (Q,) sorted ascending; entries beyond the caller's own
        valid count may be arbitrary — outputs there are garbage-but-finite.

    Returns:
      (q (Q,4), p (Q,3), ok ()): poses at each query time and a validity flag
      replicating the reference's failure conditions (odom.cc:1063-1076):
      queries non-empty, start_time after first window sample, and the window
      covering the last query.
    """
    stamps = window.stamps
    w = window.ang_vel
    f = window.lin_accel

    # ---- Backward extrapolation start_time -> first sample (odom.cc:1112-1155)
    dt01 = jnp.maximum(stamps[1] - stamps[0], 1e-8)
    idt = start_time - stamps[0]
    alpha01 = (w[1] - w[0]) / dt01
    omega_bwd = -(w[0] + 0.5 * alpha01 * idt)
    q0 = quat_step(q_init, omega_bwd, idt)
    # Orientation at second sample, to estimate jerk over [s0, s1].
    q1 = quat_step(q0, w[0] + 0.5 * (w[1] - w[0]), dt01)
    g = jnp.asarray([0.0, 0.0, gravity], dtype=p_init.dtype)
    a0 = quat_rotate(q0, f[0]) - g
    a1 = quat_rotate(q1, f[1]) - g
    j01 = (a1 - a0) / dt01
    v0 = v_init - (a0 * idt + 0.5 * j01 * idt * idt)
    p0 = p_init - (v0 * idt + 0.5 * a0 * idt * idt + (1.0 / 6.0) * j01 * idt ** 3)

    # ---- Forward scan over all intervals ------------------------------------
    iv = _scan_intervals(window, q0, p0, v0, gravity)

    # ---- Interpolate each query in its bracketing interval ------------------
    # t in (s_i, s_{i+1}]  =>  i = searchsorted(stamps, t, 'left') - 1.
    idx = jnp.clip(jnp.searchsorted(stamps, query_times, side="left") - 1,
                   0, stamps.shape[0] - 2)

    def interp(i, t):
        it = t - iv.t0[i]
        omega_q = iv.w0[i] + 0.5 * iv.alpha[i] * it
        q_t = quat_step(iv.q_end[i], omega_q, it)
        p_t = (iv.p0[i] + iv.v0[i] * it + 0.5 * iv.a0[i] * it * it
               + (1.0 / 6.0) * iv.jerk[i] * it ** 3)
        return q_t, p_t

    q_out, p_out = jax.vmap(interp)(idx, query_times)

    last_q = query_times[-1]
    covered = stamps[jnp.minimum(window.count - 1, stamps.shape[0] - 1)] >= last_q
    ok = (start_time >= stamps[0]) & (window.count >= 2) & covered
    return quat_normalize(q_out), p_out, ok


def propagate_state_batch(q: Array, p: Array, v: Array, window: ImuWindow,
                          count: Array, gravity: float = 9.80665,
                          start_exclusive: Array | None = None):
    """Geometric-observer IMU-rate prediction over a batch of samples.

    Replicates reference ``propagateState`` (odom.cc:1248-1284) applied
    sequentially to ``count`` samples of the window (dt taken from stamp
    diffs; the window's sample 0 is the previous boundary sample whose dt is
    not applied). Returns the propagated (q, p, v).

    ``start_exclusive``: additionally skip intervals ENDING at or before
    this stamp (+0.1 ms tolerance for f32 rebasing noise). The per-scan
    caller needs this because slice_imu_window starts windows at the newest
    sample *before* the boundary — without the mask, the interval that
    closed the previous scan's propagation would be applied twice (the
    reference applies each IMU sample exactly once, odom.cc:968-981).
    """
    g = jnp.asarray([0.0, 0.0, gravity], dtype=p.dtype)
    stamps, wv, f = window.stamps, window.ang_vel, window.lin_accel
    ks = jnp.arange(stamps.shape[0] - 1, dtype=jnp.int32)
    dts = jnp.maximum(stamps[1:] - stamps[:-1], 0.0)
    dts = jnp.where(ks < count - 1, dts, 0.0)   # masked steps are no-ops
    if start_exclusive is not None:
        dts = jnp.where(stamps[1:] > start_exclusive + 1e-4, dts, 0.0)

    # Parallel-prefix form of the serial recurrence (see quat_prefix):
    # orientations first, then accelerations batched, then v/p cumsums.
    q_all = quat_prefix(q, wv[1:], dts)                       # (M, 4)
    acc_w = quat_rotate(q_all[:-1], f[1:]) - g                # (M-1, 3)
    dv = acc_w * dts[:, None]
    v_pre = v[None] + jnp.concatenate(
        [jnp.zeros((1, 3), dv.dtype), jnp.cumsum(dv[:-1], axis=0)], axis=0)
    pf = p + jnp.sum(v_pre * dts[:, None] + 0.5 * (dts ** 2)[:, None] * acc_w,
                     axis=0)
    vf = v + jnp.sum(dv, axis=0)
    return q_all[-1], pf, vf
