"""DLIO-style LiDAR-inertial odometry as one jittable state transition.

This is the accelerator re-design of the reference's OdomNode scan pipeline
(reference src/dlio/src/dlio/odom.cc:737-837 ``callbackPointCloud`` and
everything it calls). The reference is a multi-threaded ROS callback graph
mutating shared state under mutexes; here the entire per-scan computation is
a *pure function* ``(OdomState, StepInput) -> (OdomState, StepOutput)``
compiled once with ``jax.jit`` (state donated), with the reference's
cross-thread synchronization replaced by deterministic dataflow:

- IMU-rate ``propagateState`` (odom.cc:1248-1284) + scan-rate ``updateState``
  (odom.cc:1286-1344) dual-rate observer -> batch-propagate the IMU samples
  of the inter-scan interval, then apply the scan-rate update (the reference
  interleaves them by wall clock; the boundary chosen here — propagate
  through the sweep end, then update — matches its steady-state ordering).
- async submap rebuild with cv-yielding (odom.cc:1782-1785) -> submap
  re-gather every step. The reference's expensive piece was the kd-tree
  rebuild; the brute-force NN engine has no index to build, so
  "rebuild" is a cheap masked gather from the keyframe store.
- dynamic containers -> fixed-capacity arrays with validity masks
  (config.CapacityConfig).

Time convention: all times in StepInput/state are float32 seconds relative
to the current scan's header stamp (the host runtime rebases; absolute
float64 bookkeeping stays on the host — see runtime/pipeline.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from noetic_slam_tpu.config.params import DlioConfig
from noetic_slam_tpu.ops import gicp as gicp_ops
from noetic_slam_tpu.ops import gridnn
from noetic_slam_tpu.ops import imu as imu_ops
from noetic_slam_tpu.ops.deskew import deskew_points, transform_cloud
from noetic_slam_tpu.ops.pointcloud import (
    SENTINEL,
    PreparedScan,
    Scan,
    crop_box,
    morton_sort_key,
    prepare_scan,
    voxel_downsample,
)
from noetic_slam_tpu.utils.geometry import (
    make_se3,
    quat_angle_deg,
    quat_conj,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_to_mat,
    se3_q_p,
)

Array = jax.Array


class OdomState(NamedTuple):
    """The full odometry state pytree (device-resident, fixed shapes)."""

    # Geometric-observer state (reference State struct, odom.h:190-210).
    q: Array            # (4,) orientation wxyz
    p: Array            # (3,) position
    v: Array            # (3,) world-frame linear velocity
    ba: Array           # (3,) accel bias
    bg: Array           # (3,) gyro bias
    # GICP-fused pose + stored velocity (lidarPose / geo.prev_vel).
    lidar_q: Array      # (4,)
    lidar_p: Array      # (3,)
    prev_vel: Array     # (3,)
    T: Array            # (4, 4) current pose as SE(3)
    T_prior: Array      # (4, 4)
    T_corr: Array       # (4, 4)
    first_opt_done: Array   # () bool
    # Keyframe store (odom.h keyframes/keyframe_normals/keyframe_transformations;
    # clouds+covariances stored world-corrected, i.e. post buildKeyframesAndSubmap).
    kf_pos: Array       # (K, 3)
    kf_quat: Array      # (K, 4)
    kf_xyz: Array       # (K, Nk, 3)
    kf_valid: Array     # (K, Nk) bool
    kf_cov: Array       # (K, Nk, 6)
    kf_count: Array     # () int32 — resident keyframes (saturates at K)
    kf_seq: Array       # (K,) int32 — insertion sequence number per slot
                        # (0 = never written; slot order stops being age
                        # order once eviction starts)
    kf_total: Array     # () int32 — keyframes ever created (monotone)
    # Keyframe OUTBOX: a device-side FIFO ring every push_keyframe also
    # writes, independent of store eviction. The host drains it at sync
    # time (runtime.slam.SlamSystem.sync_graph), so a resident slot being
    # overwritten twice between syncs no longer loses the intermediate
    # keyframe from the pose graph / archive / descriptor store (the
    # reference accumulates keyframes unboundedly, odom.cc:1517-1598; the
    # km soak lost keyframes by the hundred without this ring).
    # Lossless as long as the host syncs at least once per
    # capacity.outbox_slots new keyframes.
    ob_q: Array         # (Q, 4) creation pose per outboxed keyframe
    ob_p: Array         # (Q, 3)
    ob_seq: Array       # (Q,) int32 — insertion sequence (kf_total at push)
    ob_slot: Array      # (Q,) int32 — resident store slot it was written to
    ob_xyz: Array       # (Q, Nk, 3) world-frame cloud at creation
                        # (invalid rows at the 1e6 SENTINEL — validity is
                        # derived, not stored)
    # Submap target buffers (concat of selected keyframes).
    submap_xyz: Array   # (S, 3)
    submap_valid: Array # (S,)
    submap_cov: Array   # (S, 6)
    submap_mask: Array  # (K,) bool — current keyframe selection
    submap_count: Array # () int32 — valid points (compacted to the front)
    submap_overflow: Array  # () int32 — cumulative selected-but-dropped
                            # keyframes (capacity max_submap_kf exceeded)
    # Grid-NN index over the submap (ops.gridnn), rebuilt on submap swap.
    grid_xyz: Array     # (S, 3) submap points sorted by cell key
    grid_keys: Array    # (S,) sorted cell keys
    grid_order: Array   # (S,) original submap index per sorted point
    grid_origin: Array  # (3,)
    # Adaptive-parameter LPF states (odom.cc:1398-1437).
    spaciousness: Array # ()
    density: Array      # ()
    source_density: Array  # () density of last GICP source cloud
    keyframe_thresh_dist: Array  # () adaptive threshD
    # Device-side time bookkeeping (offsets relative to the LAST header
    # stamp seen; the host only ever sends header-to-header deltas, so no
    # per-scan device->host stamp fetch is needed).
    prev_stamp_off: Array   # () rel. time of previous scan stamp
    prop_off: Array         # () propagation boundary offset
    # Trajectory ring buffer — flushed to host in bulk (runtime.flush()),
    # replacing the reference's per-scan publishToROS (odom.cc:315-488).
    traj: Array             # (Tcap, 12): step_idx, stamp, p(3), q(4),
                            #             is_kf, n_corr, iters
    # Bookkeeping
    num_scans: Array    # () int32 processed scans
    total_steps: Array  # () int32 step invocations (incl. skipped)
    reg_rejected: Array # () int32 scans where the GICP correction failed
                        # the max_correction sanity gate (prior-only)


_QSENT = 32767          # int16 sentinel marking invalid/padded rows
_QMAX = 32766.0         # quantization range (+-)


class StepInput(NamedTuple):
    """One scan + its IMU context, packed into few host->device transfers
    (each small transfer has a fixed cost, so leaves are minimized — and
    the upload sits on the per-scan critical path, so bytes are minimized
    too).

    Two wire formats, distinguished by dtype at trace time:
    - float32 ``points`` (N, 4) = x, y, z, t; invalid/padded rows at the
      1e6 sentinel (validity derived on device; NaN fails the range test).
    - QUANTIZED (the pipeline default): int16 ``points`` (N, 3) holding
      round((xyz - offset) / scale) with per-scan adaptive scale/offset in
      ``scalars[3:7]`` (worst case ~2 mm at 130 m range — an order below
      LiDAR noise), plus float16 per-point times ``pt``; invalid rows at
      the _QSENT sentinel. 8 bytes/point instead of 20.

    times are seconds relative to THIS scan's header stamp."""

    points: Array       # (N, 4) f32 [x,y,z,t]  OR  (N, 3) int16 quantized
    imu: Array          # (M, 7): stamp, wx, wy, wz, fx, fy, fz (raw)
    scalars: Array      # (4,) or (8,): header_delta, deskew flag,
                        #   imu_count, [scale, off_x, off_y, off_z, pad]
    pt: Array | None = None   # (N,) f16 rel times (quantized wire only)

    @property
    def xyz(self):
        if self.points.dtype == jnp.int16:
            scale = self.scalars[3]
            off = self.scalars[4:7]
            dec = self.points.astype(jnp.float32) * scale + off
            return jnp.where(self.valid[:, None], dec, 1e6)
        return self.points[:, :3]

    @property
    def t(self):
        if self.pt is not None:
            return self.pt.astype(jnp.float32)
        return self.points[:, 3]

    @property
    def valid(self):
        if self.points.dtype == jnp.int16:
            return self.points[:, 0] != _QSENT
        # in-range AND finite (NaN fails every comparison)
        return jnp.all(jnp.abs(self.points[:, :3]) < 1e5, axis=-1)

    @property
    def imu_stamps(self):
        return self.imu[:, 0]

    @property
    def imu_ang(self):
        return self.imu[:, 1:4]

    @property
    def imu_acc(self):
        return self.imu[:, 4:7]

    @property
    def header_delta(self):
        return self.scalars[0]

    @property
    def deskew(self):
        return self.scalars[1] > 0.5

    @property
    def imu_count(self):
        return self.scalars[2].astype(jnp.int32)


class StepOutput(NamedTuple):
    pose_q: Array        # (4,) fused state orientation
    pose_p: Array        # (3,)
    lidar_q: Array       # (4,) GICP pose (trajectory output)
    lidar_p: Array       # (3,)
    world_xyz: Array     # (N, 3) deskewed, corrected world-frame cloud
    world_valid: Array   # (N,)
    scan_stamp: Array    # () rel. time of this scan (median point time)
    sweep_end: Array     # () rel. time of last point (next prop boundary)
    is_keyframe: Array   # () bool
    processed: Array     # () bool (False: scan skipped / bootstrap wait)
    deskew_ok: Array     # () bool
    gicp_iterations: Array
    gicp_error: Array
    num_corr: Array


def init_state(cfg: DlioConfig, q0=None, ba0=None, bg0=None) -> OdomState:
    """Fresh state; q0/ba0/bg0 from host-side IMU calibration
    (odom.cc:863-948)."""
    cap = cfg.capacity
    K, Nk = cap.max_keyframes, cap.max_ds_points
    S = cap.max_submap_kf * Nk
    f32 = jnp.float32
    q0 = jnp.asarray([1.0, 0, 0, 0], f32) if q0 is None else jnp.asarray(q0, f32)
    eye = jnp.eye(4, dtype=f32).at[:3, :3].set(quat_to_mat(q0))
    return OdomState(
        q=q0, p=jnp.zeros(3, f32), v=jnp.zeros(3, f32),
        ba=jnp.zeros(3, f32) if ba0 is None else jnp.asarray(ba0, f32),
        bg=jnp.zeros(3, f32) if bg0 is None else jnp.asarray(bg0, f32),
        # .copy(): donated states must not alias buffers across fields.
        lidar_q=q0.copy(), lidar_p=jnp.zeros(3, f32),
        prev_vel=jnp.zeros(3, f32),
        T=eye, T_prior=eye.copy(), T_corr=jnp.eye(4, dtype=f32),
        first_opt_done=jnp.array(False),
        kf_pos=jnp.zeros((K, 3), f32), kf_quat=jnp.zeros((K, 4), f32),
        kf_xyz=jnp.full((K, Nk, 3), SENTINEL, f32),
        kf_valid=jnp.zeros((K, Nk), bool),
        kf_cov=jnp.zeros((K, Nk, 6), f32), kf_count=jnp.int32(0),
        kf_seq=jnp.zeros((K,), jnp.int32), kf_total=jnp.int32(0),
        ob_q=jnp.zeros((cap.outbox_slots, 4), f32),
        ob_p=jnp.zeros((cap.outbox_slots, 3), f32),
        ob_seq=jnp.zeros((cap.outbox_slots,), jnp.int32),
        ob_slot=jnp.zeros((cap.outbox_slots,), jnp.int32),
        ob_xyz=jnp.full((cap.outbox_slots, Nk, 3), SENTINEL, f32),
        submap_xyz=jnp.full((S, 3), SENTINEL, f32),
        submap_valid=jnp.zeros((S,), bool),
        submap_cov=jnp.zeros((S, 6), f32),
        submap_mask=jnp.zeros((K,), bool),
        submap_count=jnp.int32(0),
        submap_overflow=jnp.int32(0),
        grid_xyz=jnp.full((S, 3), SENTINEL, f32),
        grid_keys=jnp.full((S,), jnp.iinfo(jnp.int32).max, jnp.int32),
        grid_order=jnp.zeros((S,), jnp.int32),
        grid_origin=jnp.zeros((3,), f32),
        spaciousness=jnp.asarray(0.0, f32), density=jnp.asarray(0.0, f32),
        source_density=jnp.asarray(0.0, f32),
        keyframe_thresh_dist=jnp.asarray(cfg.keyframe.thresh_dist, f32),
        prev_stamp_off=jnp.asarray(0.0, f32),
        prop_off=jnp.asarray(0.0, f32),
        traj=jnp.zeros((cap.max_trajectory, 12), f32),
        num_scans=jnp.int32(0),
        total_steps=jnp.int32(0),
        reg_rejected=jnp.int32(0),
    )


# ---------------------------------------------------------------------------
# IMU sample conditioning (transformImu, odom.cc:1346-1391 + bias correction,
# odom.cc:955-966)
# ---------------------------------------------------------------------------

def condition_imu(cfg: DlioConfig, stamps: Array, ang: Array, acc: Array,
                  ba: Array, bg: Array):
    """Extrinsic rotation + lever-arm compensation + bias/scale correction.

    The reference applies transformImu per sample using the previous sample's
    angular velocity for the Euler (angular-acceleration) term; here the
    previous sample is the window predecessor (first sample reuses itself,
    zeroing its Euler term — negligible, it predates the integration start).
    """
    R = jnp.asarray(cfg.extrinsics.baselink2imu_R, jnp.float32).reshape(3, 3)
    t = jnp.asarray(cfg.extrinsics.baselink2imu_t, jnp.float32)
    sm = jnp.asarray(cfg.imu.accel_sm, jnp.float32).reshape(3, 3)

    # HIGHEST: bf16-default matmul would add ~1% multiplicative noise to
    # every conditioned IMU sample — a synthetic per-sample bias/scale
    # error the observer then has to track
    w_cg = jnp.dot(ang, R.T, precision=jax.lax.Precision.HIGHEST)
    a_cg = jnp.dot(acc, R.T, precision=jax.lax.Precision.HIGHEST)
    dts = jnp.maximum(jnp.diff(stamps, prepend=stamps[:1]), 1e-8)
    w_prev = jnp.concatenate([w_cg[:1], w_cg[:-1]], axis=0)
    wdot = (w_cg - w_prev) / dts[:, None]
    a_cg = (a_cg + jnp.cross(wdot, -t[None, :])
            + jnp.cross(w_cg, jnp.cross(w_cg, -t[None, :])))
    # Bias/scale correction (odom.cc:960-966): accel scale matrix applies to
    # the extrinsically-rotated sample, then biases subtract.
    a_corr = jnp.dot(a_cg, sm.T, precision=jax.lax.Precision.HIGHEST) - ba
    w_corr = w_cg - bg
    return w_corr, a_corr


# ---------------------------------------------------------------------------
# Metrics + adaptive parameters (odom.cc:1393-1437, 1600-1624)
# ---------------------------------------------------------------------------

# Upper clip of the adaptive keyframe distance threshD [m] (odom.cc
# setAdaptiveParams: spaciousness clipped to [0.5, 5.0]).
ADAPTIVE_KF_DIST_MAX = 5.0


def _masked_median(x: Array, valid: Array) -> Array:
    """Median over valid entries (reference nth_element semantics: element
    at index n_valid//2 of the sorted sequence)."""
    xs = jnp.sort(jnp.where(valid, x, jnp.inf))
    n = valid.sum()
    return xs[jnp.clip(n // 2, 0, x.shape[0] - 1)]


def compute_adaptive(cfg: DlioConfig, state: OdomState, scan: Scan):
    """Spaciousness/density LPFs -> (threshD, max_corr_dist, new LPF states).

    Replicates computeSpaciousness (median 2D range, LPF 0.95/0.05),
    computeDensity (LPF of last source density) and setAdaptiveParams
    including its boundary quirk (sp == 5.0 keeps the clipped density).
    """
    r2d = jnp.sqrt(scan.xyz[:, 0] ** 2 + scan.xyz[:, 1] ** 2)
    med = _masked_median(r2d, scan.valid)
    sp_lpf = jnp.where(state.num_scans == 0, med,
                       0.95 * state.spaciousness + 0.05 * med)

    den_now = jnp.where(state.first_opt_done, state.source_density, 0.0)
    den_lpf = jnp.where(state.num_scans == 0, den_now,
                        0.95 * state.density + 0.05 * den_now)

    sp = jnp.clip(sp_lpf, 0.5, ADAPTIVE_KF_DIST_MAX)
    mcd = cfg.gicp.max_corr_dist
    den = jnp.clip(den_lpf, 0.5 * mcd, 2.0 * mcd)
    den = jnp.where(sp_lpf < 5.0, 0.5 * mcd, den)
    den = jnp.where(sp_lpf > 5.0, 2.0 * mcd, den)
    if not cfg.adaptive:
        return (jnp.asarray(cfg.keyframe.thresh_dist, jnp.float32),
                jnp.asarray(mcd, jnp.float32), sp_lpf, den_lpf)
    return sp, den, sp_lpf, den_lpf


# ---------------------------------------------------------------------------
# Geometric observer scan-rate update (updateState, odom.cc:1286-1344)
# ---------------------------------------------------------------------------

def geo_update(cfg: DlioConfig, state: OdomState, dt: Array) -> OdomState:
    g = cfg.geo
    qhat, pin, qin = state.q, state.lidar_p, state.lidar_q

    qe = quat_mul(quat_conj(qhat), qin)
    sgn = jnp.where(qe[0] < 0, -1.0, 1.0)
    qcorr = jnp.concatenate([(1.0 - jnp.abs(qe[0]))[None], sgn * qe[1:]])
    qcorr = quat_mul(qhat, qcorr)

    err = pin - state.p
    err_body = quat_rotate(quat_conj(qhat), err)

    ba = jnp.clip(state.ba - dt * g.Kab * err_body, -g.abias_max, g.abias_max)
    bg = jnp.clip(state.bg - dt * g.Kgb * qe[0] * qe[1:],
                  -g.gbias_max, g.gbias_max)

    p = state.p + dt * g.Kp * err
    v = state.v + dt * g.Kv * err
    q = quat_normalize(state.q + dt * g.Kq * qcorr)
    return state._replace(q=q, p=p, v=v, ba=ba, bg=bg, prev_vel=v)


# ---------------------------------------------------------------------------
# Keyframing (updateKeyframes, odom.cc:1517-1598)
# ---------------------------------------------------------------------------

def keyframe_decision(state: OdomState, thresh_dist: Array,
                      thresh_rot: float):
    slots = jnp.arange(state.kf_pos.shape[0])
    active = slots < state.kf_count
    d = jnp.linalg.norm(state.kf_pos - state.p[None, :], axis=-1)
    d = jnp.where(active, d, jnp.inf)
    num_nearby = jnp.sum((d <= thresh_dist * 1.5) & active)
    closest = jnp.argmin(d)
    dd = d[closest]
    theta = quat_angle_deg(state.q, state.kf_quat[closest])
    # odom.cc:1573-1585 collapses to: dd > threshD OR
    # (theta > threshR AND num_nearby <= 1).
    return (dd > thresh_dist) | ((theta > thresh_rot) & (num_nearby <= 1))


_KF_PROTECT_RECENT = 4   # newest keyframes never evicted (submap continuity)


def select_eviction_victim(state: OdomState) -> Array:
    """Slot to overwrite when the keyframe store is full: the most
    spatially REDUNDANT keyframe — the one with the smallest distance to
    its nearest other keyframe (densest cluster, typically a revisit),
    excluding the ``_KF_PROTECT_RECENT`` newest. Evicting there preserves
    trajectory coverage, so submap selection (distance + hull kNN) keeps
    working at long range.

    The reference has no equivalent — its store grows unboundedly
    (odom.cc:1517-1598); a bounded device store needs an explicit policy
    (see tests/test_keyframe_eviction.py for the saturation behavior)."""
    K = state.kf_pos.shape[0]
    active = jnp.arange(K) < state.kf_count
    d2 = jnp.sum(
        (state.kf_pos[:, None, :] - state.kf_pos[None, :, :]) ** 2, -1)
    pair_ok = active[:, None] & active[None, :] & ~jnp.eye(K, dtype=bool)
    nnd = jnp.min(jnp.where(pair_ok, d2, jnp.inf), axis=1)
    recent = state.kf_seq > state.kf_total - _KF_PROTECT_RECENT
    return jnp.argmin(jnp.where(active & ~recent, nnd, jnp.inf))


def push_keyframe(state: OdomState, cloud_xyz: Array, cloud_valid: Array,
                  cloud_cov: Array, enabled: Array) -> OdomState:
    """Insert a keyframe (cloud already corrected to world by T_corr) when
    ``enabled``; single-slot masked write (no full-store copy).

    While the store has free slots the keyframe appends; once full, the
    most redundant resident keyframe is EVICTED and overwritten
    (select_eviction_victim) — the reference grows unboundedly
    (odom.cc:1517-1598), a fixed-capacity store must keep covering the
    trajectory. kf_seq/kf_total let the host reconstruct insertion order
    for pose-graph bookkeeping (runtime.slam.SlamSystem.sync_graph).

    Every push ALSO writes the outbox ring (slot kf_total % Q): the
    lossless device->host hand-off path — eviction can overwrite the
    resident slot, but the outbox entry survives until Q newer keyframes
    have been created."""
    K = state.kf_pos.shape[0]
    Q = state.ob_seq.shape[0]
    full = state.kf_count >= K
    i = jnp.where(full, select_eviction_victim(state),
                  jnp.minimum(state.kf_count, K - 1))
    o = jnp.mod(state.kf_total, Q)
    ok = enabled
    sel = lambda new, old: jnp.where(ok, new, old)
    return state._replace(
        ob_q=state.ob_q.at[o].set(sel(state.lidar_q, state.ob_q[o])),
        ob_p=state.ob_p.at[o].set(sel(state.lidar_p, state.ob_p[o])),
        ob_seq=state.ob_seq.at[o].set(
            jnp.where(ok, state.kf_total + 1, state.ob_seq[o])),
        ob_slot=state.ob_slot.at[o].set(
            jnp.where(ok, i.astype(jnp.int32), state.ob_slot[o])),
        ob_xyz=state.ob_xyz.at[o].set(
            jnp.where(ok, cloud_xyz, state.ob_xyz[o])),
        kf_pos=state.kf_pos.at[i].set(sel(state.lidar_p, state.kf_pos[i])),
        kf_quat=state.kf_quat.at[i].set(sel(state.lidar_q, state.kf_quat[i])),
        kf_xyz=state.kf_xyz.at[i].set(
            jnp.where(ok, cloud_xyz, state.kf_xyz[i])),
        kf_valid=state.kf_valid.at[i].set(
            jnp.where(ok, cloud_valid, state.kf_valid[i])),
        kf_cov=state.kf_cov.at[i].set(
            jnp.where(ok, cloud_cov, state.kf_cov[i])),
        kf_count=jnp.minimum(state.kf_count + ok.astype(jnp.int32), K),
        kf_seq=state.kf_seq.at[i].set(
            jnp.where(ok, state.kf_total + 1, state.kf_seq[i])),
        kf_total=state.kf_total + ok.astype(jnp.int32),
    )


# ---------------------------------------------------------------------------
# Submap selection + gather (buildSubmap, odom.cc:1654-1742)
# ---------------------------------------------------------------------------

def _support_directions(n: int = 42):
    """Quasi-uniform unit directions (Fibonacci sphere) for hull support."""
    import numpy as np

    i = np.arange(n) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5 ** 0.5) * i
    d = np.stack([np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi),
                  np.cos(phi)], axis=-1)
    return np.asarray(d, "float32")


# numpy constants: safe to close over inside jit traces. Convex support
# uses a dense set (one (K,3)x(3,D) matmul — cheap); the alpha-ball test
# uses the coarse set (its cost is a (K*D, K) distance matrix).
_SUPPORT_DIRS = _support_directions()
_CONVEX_DIRS = _support_directions(256)


def convex_hull_mask(kf_pos: Array, active: Array,
                     dirs: Array = None) -> Array:
    """Approximate convex-hull-vertex membership by *support points*: every
    convex-hull vertex is the argmax of some direction; a fixed
    Fibonacci-sphere direction set recovers the vertices that matter at
    DLIO's keyframe counts (golden-tested against scipy.spatial.ConvexHull
    in tests/test_submap_hulls.py). Matches computeConvexHull
    (odom.cc:1439-1477: pcl::ConvexHull vertex indices)."""
    dirs = _CONVEX_DIRS if dirs is None else dirs
    # Data-adaptive directions: the centroid->keyframe ray per keyframe. A
    # pointy hull vertex missed by every fixed direction (tiny support
    # cone, e.g. near-collinear trajectories) is usually the argmax along
    # its own ray; any argmax is still a true hull vertex.
    n_act = jnp.maximum(active.sum(), 1)
    centroid = jnp.sum(jnp.where(active[:, None], kf_pos, 0.0), 0) / n_act
    rays = kf_pos - centroid[None, :]
    rays = rays / jnp.maximum(jnp.linalg.norm(rays, axis=-1, keepdims=True),
                              1e-9)
    all_dirs = jnp.concatenate([jnp.asarray(dirs), rays], axis=0)
    proj = kf_pos @ all_dirs.T                      # (K, D + K)
    proj = jnp.where(active[:, None], proj, -jnp.inf)
    hull_idx = jnp.argmax(proj, axis=0)             # (D + K,)
    return jnp.zeros(kf_pos.shape[:1], bool).at[hull_idx].set(True) & active


def alpha_boundary_mask(kf_pos: Array, active: Array, alpha: Array,
                        dirs: Array = None) -> Array:
    """Alpha-shape boundary membership, by its geometric definition: point i
    is on the boundary iff some OPEN ball of radius ``alpha`` touching i is
    empty of other points. Ball centers are discretized as p_i + alpha*d
    over the Fibonacci direction set; one (K*D, K) squared-distance matmul
    decides emptiness (dense array math, no host hull library).

    This is the reference's concave hull: pcl::ConcaveHull(alpha =
    keyframe_thresh_dist, adaptive — odom.cc:86,1622, computeConcaveHull
    odom.cc:1478-1515). Golden-tested against a Delaunay-circumradius alpha
    shape in tests/test_submap_hulls.py.
    """
    dirs = _SUPPORT_DIRS if dirs is None else dirs
    K, D = kf_pos.shape[0], dirs.shape[0]
    centers = (kf_pos[:, None, :] + alpha * dirs[None, :, :]).reshape(-1, 3)
    # d2[i*D+j, k] = ||p_k - c_ij||^2
    d2 = (jnp.sum(centers ** 2, -1)[:, None]
          - 2.0 * jnp.dot(centers, kf_pos.T,
                          precision=jax.lax.Precision.HIGHEST)
          + jnp.sum(kf_pos ** 2, -1)[None, :])
    d2 = jnp.where(active[None, :], d2, jnp.inf)
    # Open-ball emptiness with tolerance: a point at exactly alpha (incl.
    # point i itself) sits ON the sphere, not inside it.
    empty = jnp.all(d2 >= (alpha * alpha) * (1.0 - 1e-3), axis=-1)
    return jnp.any(empty.reshape(K, D), axis=-1) & active


def _knn_of(mask: Array, d: Array, k: int) -> Array:
    """kNN-by-distance restricted to ``mask`` (pushSubmapIndices role,
    odom.cc:1600-1624 comparator form): k smallest of d among mask."""
    dm = jnp.where(mask, d, jnp.inf)
    _, idx = jax.lax.top_k(-dm, min(k, d.shape[0]))
    return jnp.zeros(d.shape, bool).at[idx].set(True) & mask


def select_submap_keyframes(cfg: DlioConfig, state: OdomState,
                            alpha: Array = None) -> Array:
    """Keyframe selection mask: distance-kNN ∪ convex-hull kNN ∪
    concave-hull kNN, deduped (buildSubmap, odom.cc:1654-1705).

    ``alpha`` is the concave-hull alpha = the *adaptive* keyframe distance
    threshold (the reference re-sets setAlpha each scan, odom.cc:1622);
    defaults to the current state's adaptive threshold.
    """
    K = state.kf_pos.shape[0]
    slots = jnp.arange(K)
    active = slots < state.kf_count
    d = jnp.linalg.norm(state.kf_pos - state.p[None, :], axis=-1)
    d = jnp.where(active, d, jnp.inf)
    if alpha is None:
        alpha = state.keyframe_thresh_dist

    mask = _knn_of(active, d, cfg.submap.knn)

    # Convex hull term (>= 4 keyframes, odom.cc:1442-1445).
    cv = convex_hull_mask(state.kf_pos, active)
    mask = mask | jnp.where(state.kf_count >= 4,
                            _knn_of(cv, d, cfg.submap.kcv), False)

    # Concave hull term (>= 5 keyframes, odom.cc:1481-1484).
    if cfg.submap.kcc > 0:
        cc = alpha_boundary_mask(state.kf_pos, active, alpha)
        mask = mask | jnp.where(state.kf_count >= 5,
                                _knn_of(cc, d, cfg.submap.kcc), False)
    return mask & active


def gather_submap(cfg: DlioConfig, state: OdomState, mask: Array):
    """Concatenate selected keyframe clouds into the fixed submap buffers.

    Returns (xyz, valid, cov, count, overflow): ``overflow`` counts selected
    keyframes beyond the max_submap_kf capacity — those are DROPPED from the
    registration target (the reference concatenates all selected keyframes,
    odom.cc:1719-1729, so any overflow is a fidelity loss the caller must
    surface; state.submap_overflow accumulates it)."""
    K, Nk = state.kf_xyz.shape[0], state.kf_xyz.shape[1]
    Smax_kf = cfg.capacity.max_submap_kf
    overflow = jnp.maximum(
        mask.sum().astype(jnp.int32) - jnp.int32(Smax_kf), 0)
    # Indices of selected keyframes, padded with K (drop slot).
    sel_rank = jnp.cumsum(mask.astype(jnp.int32)) - 1
    kf_slots = jnp.full((Smax_kf,), K, jnp.int32)
    kf_slots = kf_slots.at[jnp.where(mask, sel_rank, Smax_kf)].set(
        jnp.arange(K, dtype=jnp.int32), mode="drop")

    safe = jnp.minimum(kf_slots, K - 1)
    used = kf_slots < K
    xyz = jnp.where(used[:, None, None], state.kf_xyz[safe],
                    SENTINEL)                       # (Smax_kf, Nk, 3)
    valid = state.kf_valid[safe] & used[:, None]
    cov = jnp.where(used[:, None, None], state.kf_cov[safe], 0.0)
    xyz = xyz.reshape(Smax_kf * Nk, 3)
    valid = valid.reshape(-1)
    cov = cov.reshape(Smax_kf * Nk, 6)
    # Morton-sort the merged submap: compacts valid points to the front
    # (invalid keys -> INT32_MAX) so the NN engines skip padded capacity,
    # AND gives target tiles compact bounding boxes for the fused NN
    # kernel's branch-and-bound tile pruning (ops/pallas/nn_kernel.py).
    # Cell = 1 m: fine enough to localize tiles, coarse enough that the
    # 1024-cell reach covers km-scale submaps.
    key = morton_sort_key(xyz, valid, cell=1.0)
    order = jnp.argsort(key, stable=True)
    return (xyz[order], valid[order], cov[order],
            valid.sum().astype(jnp.int32), overflow)


# ---------------------------------------------------------------------------
# The per-scan step
# ---------------------------------------------------------------------------

def make_odometry_step(cfg: DlioConfig, align_fn=None):
    """Build the jittable odometry step closed over the static config.

    ``align_fn(src_xyz, src_valid, src_cov, tgt_xyz, tgt_cov, cfg,
    max_corr_dist) -> AlignResult`` defaults to the single-device GICP; the
    distributed path passes parallel.registration.sharded_gicp_align bound
    to a mesh (target buffers then shard along the map axis).
    """
    if align_fn is None:
        align_fn = gicp_ops.gicp_align

    # Grid cell must cover the largest adaptive correspondence radius
    # (setAdaptiveParams caps it at 2 * max_corr_dist, odom.cc:1612-1621).
    grid_cell = 2.0 * cfg.gicp.max_corr_dist
    use_grid = cfg.gicp.nn_engine == "grid"

    cap = cfg.capacity
    ext_R = jnp.asarray(cfg.extrinsics.baselink2lidar_R,
                        jnp.float32).reshape(3, 3)
    ext_t = jnp.asarray(cfg.extrinsics.baselink2lidar_t, jnp.float32)
    T_ext = jnp.eye(4, dtype=jnp.float32).at[:3, :3].set(ext_R).at[:3, 3].set(
        ext_t)

    def step(state: OdomState, inp: StepInput):
        # ---- intake: crop + mask (getScanFromROS, odom.cc:490-526) --------
        scan = Scan(inp.xyz, inp.t, inp.valid,
                    inp.valid.sum().astype(jnp.int32))
        scan = crop_box(scan, cfg.preproc.crop_size)

        # ---- adaptive metrics (odom.cc:770-779) ---------------------------
        threshD, max_corr, sp_lpf, den_lpf = compute_adaptive(cfg, state, scan)

        # ---- IMU conditioning ---------------------------------------------
        w_corr, a_corr = condition_imu(cfg, inp.imu_stamps, inp.imu_ang,
                                       inp.imu_acc, state.ba, state.bg)

        # ---- deskew / prior (preprocessPoints, odom.cc:528-706) -----------
        prep = prepare_scan(scan, cap.max_deskew_frames)
        scan_stamp = jnp.where(inp.deskew, prep.scan_stamp,
                               jnp.asarray(0.0, jnp.float32))
        sweep_end = jnp.where(
            inp.deskew,
            prep.unique_t[jnp.clip(prep.unique_count - 1, 0,
                                   cap.max_deskew_frames - 1)],
            scan_stamp)
        sweep_end = jnp.maximum(sweep_end, scan_stamp)

        prev_stamp = state.prev_stamp_off - inp.header_delta
        prop_start = state.prop_off - inp.header_delta

        window = imu_ops.slice_imu_window(
            inp.imu_stamps, w_corr, a_corr, inp.imu_count,
            prev_stamp, sweep_end, cap.max_imu_window)

        frames_q, frames_p, imu_ok = imu_ops.integrate_imu(
            window, prev_stamp, state.lidar_q, state.lidar_p,
            state.prev_vel, prep.unique_t, cfg.gravity)

        first_scan = state.kf_count == 0
        # T_prior: pose at the median point time when the IMU covers the
        # sweep; first scan / failed integration falls back to the previous
        # pose (odom.cc:538-575, 664-686). The IMU prior applies from the
        # second scan on (first_valid_scan gating, odom.cc:655-663).
        med = jnp.clip(prep.median_idx, 0, cap.max_deskew_frames - 1)
        T_imu = make_se3(frames_q[med], frames_p[med])
        use_imu = imu_ok & ~first_scan
        T_prior = jnp.where(use_imu, T_imu, state.T)
        deskew_ok = inp.deskew & use_imu

        # Per-point world transform: either per-frame poses (deskew) or the
        # single prior (rigid).
        world_deskewed = deskew_points(prep, frames_q, frames_p, ext_R, ext_t)
        world_rigid = transform_cloud(prep.xyz, prep.valid, T_prior @ T_ext)
        world_pts = jnp.where(deskew_ok, world_deskewed, world_rigid)
        world_pts = jnp.where(prep.valid[:, None], world_pts, SENTINEL)

        # ---- voxel filter (odom.cc:576-586) -------------------------------
        if cfg.preproc.voxelize:
            ds_xyz, ds_valid, _ = voxel_downsample(
                world_pts, prep.valid, cfg.preproc.voxel_res,
                cap.max_ds_points)
        else:
            ds_xyz = world_pts[: cap.max_ds_points]
            ds_valid = prep.valid[: cap.max_ds_points]

        enough_points = ds_valid.sum() > cfg.gicp.min_num_points

        # ---- source covariances (setInputSource, odom.cc:720-723) ---------
        if cfg.gicp.cov_engine == "radius":
            src_cov, src_density = gicp_ops.radius_covariances(
                ds_xyz, ds_valid, cfg.gicp.cov_radius)
        else:
            src_cov, src_density = gicp_ops.plane_covariances(
                ds_xyz, ds_valid, cfg.gicp.k_correspondences,
                use_grid=use_grid, cell=4.0 * cfg.preproc.voxel_res)

        # ---- observer IMU-rate propagation over the inter-scan interval ---
        # (propagateState per IMU sample, odom.cc:1248-1284; gated on
        # first_opt_done as in odom.cc:976-979.)
        prop_window = imu_ops.slice_imu_window(
            inp.imu_stamps, w_corr, a_corr, inp.imu_count,
            prop_start, sweep_end, cap.max_imu_window)
        q_prop, p_prop, v_prop = imu_ops.propagate_state_batch(
            state.q, state.p, state.v, prop_window, prop_window.count,
            cfg.gravity, start_exclusive=prop_start)
        if cfg.geo.max_velocity > 0:
            # bound the velocity runaway when registration feedback is
            # lost (see GeoConfig.max_velocity)
            vn = jnp.linalg.norm(v_prop)
            v_prop = jnp.where(vn > cfg.geo.max_velocity,
                               v_prop * (cfg.geo.max_velocity
                                         / jnp.maximum(vn, 1e-9)),
                               v_prop)
        # Propagation boundary = stamp of the LAST sample actually applied
        # (the first sample at/past the sweep end — already propagated when
        # the reference's updateState runs). Tracking the sample stamp, not
        # sweep_end itself, is what makes the next scan's start_exclusive
        # mask line up so every IMU interval is applied exactly once.
        last_idx = jnp.clip(prop_window.count - 1, 0,
                            cap.max_imu_window - 1)
        prop_boundary = jnp.where(
            prop_window.count > 0,
            jnp.maximum(prop_window.stamps[last_idx], prop_start),
            jnp.maximum(sweep_end, prop_start))
        fod = state.first_opt_done
        state = state._replace(
            q=jnp.where(fod, q_prop, state.q),
            p=jnp.where(fod, p_prop, state.p),
            v=jnp.where(fod, v_prop, state.v))

        zero_diag = (jnp.int32(0), jnp.asarray(0.0, jnp.float32),
                     jnp.int32(0))

        # ---- branch: first scan bootstraps the keyframe store -------------
        def bootstrap(state):
            st = push_keyframe(state, ds_xyz, ds_valid, src_cov,
                               jnp.array(True))
            mask = select_submap_keyframes(cfg, st, alpha=threshD)
            sm_xyz, sm_valid, sm_cov, sm_count, sm_over = gather_submap(
                cfg, st, mask)
            st = st._replace(
                submap_xyz=sm_xyz, submap_valid=sm_valid, submap_cov=sm_cov,
                submap_mask=mask, submap_count=sm_count,
                submap_overflow=st.submap_overflow + sm_over,
                T_prior=T_prior)
            if use_grid:
                grid = gridnn.build_grid(sm_xyz, sm_valid, grid_cell)
                st = st._replace(
                    grid_xyz=grid.xyz, grid_keys=grid.keys,
                    grid_order=grid.order, grid_origin=grid.origin)
            return st, (jnp.array(True), zero_diag)

        # ---- branch: full registration step (getNextPose, odom.cc:984) ----
        def register(state):
            grid = (gridnn.Grid(state.grid_xyz, state.grid_keys,
                                state.grid_order, state.grid_origin,
                                jnp.asarray(grid_cell, jnp.float32))
                    if use_grid else None)
            res = align_fn(
                ds_xyz, ds_valid, src_cov, state.submap_xyz,
                state.submap_cov, cfg.gicp, max_corr_dist=max_corr,
                target_grid=grid, target_count=state.submap_count)
            # Degenerate-registration gate (cfg.gicp.max_correction): on
            # feature-poor geometry the GICP cost is flat along the
            # unconstrained direction and the solver can slide meters in
            # one solve; accepting that walks the observer's velocity
            # into a runaway (measured: 13-40 m/s jumps -> NaN). A
            # correction beyond any physically plausible prior error is
            # REJECTED and the scan falls back to the IMU prior — the
            # reference's degraded prior-only mode (odom.cc:677-685).
            if cfg.gicp.max_correction > 0:
                reg_ok = (jnp.linalg.norm(res.T[:3, 3])
                          < cfg.gicp.max_correction)
            else:
                reg_ok = jnp.array(True)
            T_corr = jnp.where(reg_ok, res.T, jnp.eye(4, dtype=res.T.dtype))
            T_new = T_corr @ T_prior
            lq, lp = se3_q_p(T_new)       # propagateGICP, odom.cc:1230-1246
            st = state._replace(T=T_new, T_corr=T_corr, T_prior=T_prior,
                                lidar_q=lq, lidar_p=lp,
                                reg_rejected=state.reg_rejected
                                + (1 - reg_ok.astype(jnp.int32)))
            st = geo_update(cfg, st, scan_stamp - prev_stamp)

            is_kf = keyframe_decision(st, threshD, cfg.keyframe.thresh_rot)
            kf_cloud = transform_cloud(ds_xyz, ds_valid, T_corr)
            kf_cov = gicp_ops.rotate_sym6(src_cov, T_corr[:3, :3])
            st = push_keyframe(st, kf_cloud, ds_valid, kf_cov, is_kf)

            mask = select_submap_keyframes(cfg, st, alpha=threshD)
            changed = jnp.any(mask != st.submap_mask)

            # Rebuild the registration target ONLY when the selection
            # changed (the reference's "if submap has changed" gate,
            # odom.cc:1719-1729). Under lax.cond the untaken branch does
            # not execute, so steady-state scans (selection stable between
            # keyframe pushes / kNN rank swaps) skip the 10 MB keyframe
            # gather + the payload-carrying Morton sort of the merged
            # submap — the dominant non-GICP cost of the step.
            def do_gather(s):
                sm_xyz, sm_valid, sm_cov, sm_count, sm_over = gather_submap(
                    cfg, s, mask)
                s = s._replace(
                    submap_xyz=sm_xyz, submap_valid=sm_valid,
                    submap_cov=sm_cov, submap_mask=mask,
                    submap_count=sm_count,
                    submap_overflow=s.submap_overflow + sm_over)
                if use_grid:
                    new_grid = gridnn.build_grid(sm_xyz, sm_valid, grid_cell)
                    s = s._replace(
                        grid_xyz=new_grid.xyz, grid_keys=new_grid.keys,
                        grid_order=new_grid.order,
                        grid_origin=new_grid.origin)
                return s

            st = jax.lax.cond(changed, do_gather, lambda s: s, st)
            st = st._replace(first_opt_done=jnp.array(True))
            return st, (is_kf, (res.iterations, res.error, res.num_corr))

        def process(state):
            st, (is_kf, diag) = jax.lax.cond(
                first_scan, bootstrap, register, state)
            row = jnp.concatenate([
                st.total_steps.astype(jnp.float32)[None], scan_stamp[None],
                st.lidar_p, st.lidar_q,
                is_kf.astype(jnp.float32)[None],
                diag[2].astype(jnp.float32)[None],
                diag[0].astype(jnp.float32)[None]])
            ti = jnp.minimum(st.num_scans, cap.max_trajectory - 1)
            st = st._replace(
                spaciousness=sp_lpf, density=den_lpf,
                source_density=src_density, keyframe_thresh_dist=threshD,
                prev_stamp_off=scan_stamp,
                traj=st.traj.at[ti].set(row),
                num_scans=st.num_scans + 1)
            return st, (is_kf, diag)

        def skip(state):
            # Low point count: drop the scan (odom.cc:764-767). The observer
            # propagation above still applies (IMU-rate path runs regardless),
            # so the propagation boundary advances either way; prev_stamp
            # keeps pointing at the last processed scan.
            return state._replace(
                prev_stamp_off=prev_stamp), (jnp.array(False), zero_diag)

        new_state, (is_kf, diag) = jax.lax.cond(
            enough_points, process, skip, state)
        new_state = new_state._replace(
            prop_off=prop_boundary,
            total_steps=new_state.total_steps + 1)

        # Output world cloud: deskewed cloud corrected by T_corr
        # (publishToROS, odom.cc:434-451).
        out_cloud = transform_cloud(world_pts, prep.valid, new_state.T_corr)
        out = StepOutput(
            pose_q=new_state.q, pose_p=new_state.p,
            lidar_q=new_state.lidar_q, lidar_p=new_state.lidar_p,
            world_xyz=out_cloud, world_valid=prep.valid,
            scan_stamp=scan_stamp, sweep_end=sweep_end,
            is_keyframe=is_kf, processed=enough_points,
            deskew_ok=deskew_ok,
            gicp_iterations=diag[0], gicp_error=diag[1], num_corr=diag[2],
        )
        return new_state, out

    return step


def make_slam_step(cfg: DlioConfig, align_fn=None):
    """Odometry + dense-map fusion as ONE jitted program.

    Fusing matters beyond elegance: the runtime loads one executable per
    scan (one dispatch instead of two), and the registered world cloud
    flows straight into the map scatter without leaving the device.

    The map backend follows ``cfg.map_backend`` ("tsdf" or "occupancy" —
    the reference README's MAP_BACKEND_IDX role, README.md:30-40).

    step((odom_state, map_state), inp) -> ((odom_state, map_state), out)
    """
    odo = make_odometry_step(cfg, align_fn=align_fn)

    # Skipped scans are gated by zeroing sample weights/deltas instead of a
    # lax.cond: a cond output cannot alias its input buffers, which would
    # force XLA to copy the (hundreds of MB) map payload every step; gating
    # keeps the donated in-place scatter.
    if cfg.map_backend == "occupancy":
        from noetic_slam_tpu.models import occupancy as occ_mod

        def fuse(map_state, out):
            pos, delta = occ_mod._beam_samples(
                cfg.occupancy, out.world_xyz, out.world_valid, out.lidar_p)
            delta = delta * out.processed.astype(delta.dtype)
            return occ_mod._integrate_deltas(cfg.occupancy, map_state,
                                             pos, delta)
    else:
        from noetic_slam_tpu.models import tsdf as tsdf_mod

        def fuse(map_state, out):
            pos, sdf, w = tsdf_mod._ray_samples(
                cfg.tsdf, out.world_xyz, out.world_valid, out.lidar_p)
            w = w * out.processed.astype(w.dtype)
            return tsdf_mod._integrate_samples(cfg.tsdf, map_state,
                                               pos, sdf, w)

    def step(carry, inp: StepInput):
        odom_state, map_state = carry
        odom_state, out = odo(odom_state, inp)
        return (odom_state, fuse(map_state, out)), out

    return step
