"""Golden test: dual-rate observer interleaving.

The reference interleaves IMU-rate ``propagateState`` (on every IMU
callback, odom.cc:1248-1284) and scan-rate ``updateState`` (when GICP
completes, odom.cc:1286-1344) by WALL CLOCK under geo.mtx. The device step
reorders this into: batch-propagate the scan's IMU window through the
sweep-end boundary sample, then apply the scan-rate update
(models/odometry.py step). This file pins that reordering against a
sequential NumPy model that replays the true wall-clock event order:

- latency = 0 IMU samples (update fires the moment IMU coverage reaches
  the sweep end — exactly the batched boundary): the two must agree to
  float tolerance;
- latency = k samples (GICP compute time lets k more IMU samples be
  propagated before the update lands — the reference's real timing): the
  divergence must stay bounded and small.

Also the regression test for exactly-once IMU interval application across
scan boundaries (each propagateState call in the reference consumes each
sample once; the batched windows overlap by one boundary sample which must
not be re-applied).
"""

import jax.numpy as jnp
import numpy as np

from noetic_slam_tpu.config.params import DlioConfig
from noetic_slam_tpu.models.odometry import geo_update, init_state
from noetic_slam_tpu.ops import imu as imu_ops

CFG = DlioConfig()
G = CFG.gravity


# --------------------------------------------------------------------------
# Sequential reference model (float64, literal transcription of the
# equations at odom.cc:1248-1344)
# --------------------------------------------------------------------------

def _qmul(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _qrot(q, v):
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    return R @ v


class SeqObserver:
    """propagateState / updateState applied in arrival order."""

    def __init__(self, cfg: DlioConfig):
        self.g = cfg.geo
        self.gravity = cfg.gravity
        self.q = np.array([1.0, 0, 0, 0])
        self.p = np.zeros(3)
        self.v = np.zeros(3)
        self.ba = np.zeros(3)
        self.bg = np.zeros(3)

    def propagate(self, w_raw, f_raw, dt):
        # bias correction happens at the callback (odom.cc:960-966)
        w = w_raw - self.bg
        f = f_raw - self.ba
        acc_w = _qrot(self.q, f)
        acc_w[2] -= self.gravity
        self.p = self.p + self.v * dt + 0.5 * dt * dt * acc_w
        self.v = self.v + acc_w * dt
        self.q = self.q + 0.5 * dt * _qmul(self.q, np.r_[0.0, w])
        self.q /= np.linalg.norm(self.q)

    def update(self, q_in, p_in, dt):
        g = self.g
        qe = _qmul(np.r_[self.q[0], -self.q[1:]], q_in)
        sgn = -1.0 if qe[0] < 0 else 1.0
        qcorr = _qmul(self.q, np.r_[1.0 - abs(qe[0]), sgn * qe[1:]])
        err = p_in - self.p
        err_body = _qrot(np.r_[self.q[0], -self.q[1:]], err)
        self.ba = np.clip(self.ba - dt * g.Kab * err_body,
                          -g.abias_max, g.abias_max)
        self.bg = np.clip(self.bg - dt * g.Kgb * qe[0] * qe[1:],
                          -g.gbias_max, g.gbias_max)
        self.p = self.p + dt * g.Kp * err
        self.v = self.v + dt * g.Kv * err
        self.q = self.q + dt * g.Kq * qcorr
        self.q /= np.linalg.norm(self.q)


# --------------------------------------------------------------------------
# Shared trace: smooth IMU + per-scan lidar pose measurements
# --------------------------------------------------------------------------

def _make_trace(n_scans=15, imu_hz=100.0, scan_hz=10.0, seed=0):
    rng = np.random.default_rng(seed)
    T = n_scans / scan_hz + 0.3
    t = np.arange(0.0, T, 1.0 / imu_hz)
    w = 0.3 * np.stack([np.sin(1.1 * t), np.cos(0.7 * t),
                        0.5 * np.sin(0.4 * t)], -1)
    f = np.stack([0.4 * np.sin(0.9 * t), 0.3 * np.cos(1.3 * t),
                  G + 0.2 * np.sin(0.5 * t)], -1)
    scan_stamps = (np.arange(n_scans) + 1.0) / scan_hz
    sweep_ends = scan_stamps + 0.5 / scan_hz
    # lidar pose measurements: a smooth trajectory + noise
    meas_p = np.stack([0.5 * scan_stamps, 0.2 * np.sin(scan_stamps),
                       0.05 * scan_stamps], -1)
    meas_p += rng.normal(scale=0.01, size=meas_p.shape)
    ang = 0.1 * np.sin(scan_stamps)
    meas_q = np.stack([np.cos(ang / 2), np.zeros_like(ang),
                       np.zeros_like(ang), np.sin(ang / 2)], -1)
    return t, w, f, scan_stamps, sweep_ends, meas_q, meas_p


def _run_sequential(trace, latency_samples=0):
    t, w, f, scan_stamps, sweep_ends, meas_q, meas_p = trace
    obs = SeqObserver(CFG)
    # wall-clock event schedule: update j fires right after the
    # (first IMU sample >= sweep_end_j) + latency more samples
    upd_after = np.searchsorted(t, sweep_ends) + latency_samples
    states = []
    prev_stamp = 0.0
    j = 0
    for i in range(1, len(t)):
        obs.propagate(w[i], f[i], t[i] - t[i - 1])
        while j < len(scan_stamps) and i == upd_after[j]:
            obs.update(meas_q[j], meas_p[j], scan_stamps[j] - prev_stamp)
            prev_stamp = scan_stamps[j]
            j += 1
            states.append(np.r_[obs.q, obs.p, obs.v, obs.ba, obs.bg])
    return np.array(states[: len(scan_stamps)])


def _run_batched(trace):
    """The device ordering: per scan, slice [prop_off, sweep_end], batch
    propagate (start-exclusive boundary mask), then scan-rate update —
    exactly the calls models/odometry.make_odometry_step makes."""
    t, w, f, scan_stamps, sweep_ends, meas_q, meas_p = trace
    cap = 64
    st = init_state(CFG)
    ts = jnp.asarray(t, jnp.float32)
    wj = jnp.asarray(w, jnp.float32)
    fj = jnp.asarray(f, jnp.float32)
    prop_off = jnp.float32(0.0)
    prev_stamp = 0.0
    states = []
    for j, (stamp, send) in enumerate(zip(scan_stamps, sweep_ends)):
        # bias correction with scan-entry biases (condition_imu's role for
        # identity extrinsics)
        wc = wj - st.bg[None, :]
        fc = fj - st.ba[None, :]
        win = imu_ops.slice_imu_window(ts, wc, fc, len(t), prop_off,
                                       jnp.float32(send), cap)
        q, p, v = imu_ops.propagate_state_batch(
            st.q, st.p, st.v, win, win.count, G, start_exclusive=prop_off)
        last = jnp.clip(win.count - 1, 0, cap - 1)
        prop_off = jnp.maximum(win.stamps[last], prop_off)
        st = st._replace(q=q, p=p, v=v,
                         lidar_q=jnp.asarray(meas_q[j], jnp.float32),
                         lidar_p=jnp.asarray(meas_p[j], jnp.float32))
        st = geo_update(CFG, st, jnp.float32(stamp - prev_stamp))
        prev_stamp = stamp
        states.append(np.r_[np.asarray(st.q), np.asarray(st.p),
                            np.asarray(st.v), np.asarray(st.ba),
                            np.asarray(st.bg)])
    return np.array(states)


def test_batched_matches_sequential_at_zero_latency():
    """With the update at the IMU-coverage boundary (latency 0), the
    batched reordering IS the wall-clock order: agreement to f32 noise."""
    trace = _make_trace()
    seq = _run_sequential(trace, latency_samples=0)
    bat = _run_batched(trace)
    # Bounds = a few x the measured f32-vs-f64 arithmetic noise (~2e-3 m on
    # a ~7 m trajectory); the observer's correction terms keep it bounded
    # (contraction), so any ORDERING error would blow well past these.
    dp = np.linalg.norm(seq[:, 4:7] - bat[:, 4:7], axis=-1)
    dq = np.linalg.norm(seq[:, :4] - bat[:, :4], axis=-1)
    dv = np.linalg.norm(seq[:, 7:10] - bat[:, 7:10], axis=-1)
    assert dp.max() < 5e-3, f"pos diverges {dp.max():.5f} m"
    assert dq.max() < 1e-3, f"quat diverges {dq.max():.6f}"
    assert dv.max() < 1e-2, f"vel diverges {dv.max():.5f}"


def test_divergence_bounded_under_compute_latency():
    """The reference's update really lands a few IMU samples late (GICP
    compute). The batched boundary must stay within a small bound of those
    orderings — the observer is a contraction, so the orderings differ by
    O(latency * correction), not unboundedly."""
    trace = _make_trace()
    bat = _run_batched(trace)
    for latency in (1, 3, 5):
        seq = _run_sequential(trace, latency_samples=latency)
        n = min(len(seq), len(bat))
        dp = np.linalg.norm(seq[:n, 4:7] - bat[:n, 4:7], axis=-1)
        assert dp.max() < 0.02 * latency + 0.01, \
            f"latency {latency}: pos diverges {dp.max():.4f} m"


def test_intervals_applied_exactly_once():
    """Constant acceleration, no updates: after N scans the batched
    propagation must hold v = a * t_boundary EXACTLY (each IMU interval
    applied once — the double-application regression)."""
    t = np.arange(0, 1.0, 0.01)
    w = np.zeros((len(t), 3))
    f = np.zeros((len(t), 3))
    f[:, 0] = 1.0
    f[:, 2] = G                       # cancel gravity
    ts, wj, fj = (jnp.asarray(x, jnp.float32) for x in (t, w, f))
    st = init_state(CFG)
    prop_off = jnp.float32(0.0)
    cap = 32
    for send in (0.095, 0.23, 0.31, 0.52, 0.78):
        win = imu_ops.slice_imu_window(ts, wj, fj, len(t), prop_off,
                                       jnp.float32(send), cap)
        q, p, v = imu_ops.propagate_state_batch(
            st.q, st.p, st.v, win, win.count, G, start_exclusive=prop_off)
        st = st._replace(q=q, p=p, v=v)
        last = jnp.clip(win.count - 1, 0, cap - 1)
        prop_off = jnp.maximum(win.stamps[last], prop_off)
    # boundary after the last window = first sample >= 0.78 -> t = 0.78
    np.testing.assert_allclose(float(st.v[0]), float(prop_off), rtol=1e-5)
    np.testing.assert_allclose(float(prop_off), 0.78, atol=1e-6)
