"""Independent NumPy implementations of the reference equations.

These are golden models for the device ops: straightforward, sequential,
float64 NumPy code implementing the same math as the reference C++
(cited per function), written directly from the equations. Device ops are
tested against these on synthetic data.
"""

from __future__ import annotations

import numpy as np


def quat_mul(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def quat_step(q, omega, dt):
    """q + 0.5*dt*q⊗(0,w), normalized (reference odom.cc:1171-1178)."""
    dq = quat_mul(q, np.concatenate([[0.0], omega]))
    out = q + 0.5 * dt * dq
    return out / np.linalg.norm(out)


def quat_rotate(q, v):
    u, w = q[1:], q[0]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def quat_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def integrate_imu_ref(stamps, ang_vel, lin_accel, start_time, q_init, p_init,
                      v_init, query_times, gravity=9.80665):
    """Sequential golden model of reference integrateImu/integrateImuInternal
    (odom.cc:1056-1228), including the backward extrapolation prologue and
    the end-of-interval orientation quirk in query interpolation."""
    g = np.array([0.0, 0.0, gravity])
    q = np.asarray(q_init, float).copy()
    p = np.asarray(p_init, float).copy()
    v = np.asarray(v_init, float).copy()

    # Backward extrapolation start_time -> stamps[0] (odom.cc:1112-1155).
    dt = stamps[1] - stamps[0]
    idt = start_time - stamps[0]
    alpha = (ang_vel[1] - ang_vel[0]) / dt
    omega_i = -(ang_vel[0] + 0.5 * alpha * idt)
    q = quat_step(q, omega_i, idt)
    omega = ang_vel[0] + 0.5 * (ang_vel[1] - ang_vel[0])
    q2 = quat_step(q, omega, dt)
    a1 = quat_rotate(q, lin_accel[0]) - g
    a2 = quat_rotate(q2, lin_accel[1]) - g
    j = (a2 - a1) / dt
    v = v - (a1 * idt + 0.5 * j * idt * idt)
    p = p - (v * idt + 0.5 * a1 * idt * idt + (1 / 6.0) * j * idt ** 3)

    # Forward integration with interleaved query interpolation
    # (odom.cc:1157-1228).
    out_q, out_p = [], []
    a = quat_rotate(q, lin_accel[0]) - g
    qi = 0
    for i in range(len(stamps) - 1):
        f0_t, f_t = stamps[i], stamps[i + 1]
        w0, w1 = ang_vel[i], ang_vel[i + 1]
        dt = f_t - f0_t
        alpha = (w1 - w0) / dt
        omega = w0 + 0.5 * (w1 - w0)
        q = quat_step(q, omega, dt)
        a0 = a
        a = quat_rotate(q, lin_accel[i + 1]) - g
        jdt = a - a0
        j = jdt / dt
        while qi < len(query_times) and query_times[qi] <= f_t:
            it = query_times[qi] - f0_t
            omega_q = w0 + 0.5 * alpha * it
            out_q.append(quat_step(q, omega_q, it))  # NOTE: q already at f
            out_p.append(p + v * it + 0.5 * a0 * it * it
                         + (1 / 6.0) * j * it ** 3)
            qi += 1
        p = p + v * dt + 0.5 * a0 * dt * dt + (1 / 6.0) * jdt * dt * dt
        v = v + a0 * dt + 0.5 * jdt * dt
    return np.array(out_q), np.array(out_p)


def propagate_state_ref(q, p, v, stamps, ang_vel, lin_accel, gravity=9.80665):
    """Golden model of propagateState applied per sample (odom.cc:1248-1284).

    Sample 0 is the boundary sample (not applied); samples 1.. are applied
    with dt = stamp diff.
    """
    g = np.array([0.0, 0.0, gravity])
    q, p, v = np.array(q, float), np.array(p, float), np.array(v, float)
    for k in range(1, len(stamps)):
        dt = stamps[k] - stamps[k - 1]
        acc_w = quat_rotate(q, lin_accel[k]) - g
        p = p + v * dt + 0.5 * dt * dt * acc_w
        v = v + acc_w * dt
        q = quat_step(q, ang_vel[k], dt)
    return q, p, v


def geo_update_ref(state, lidar_p, lidar_q, dt, geo):
    """Golden model of updateState (odom.cc:1286-1344).

    state: dict with q, p, v, ba, bg (numpy). geo: GeoConfig-like object.
    Returns updated dict.
    """
    q = state["q"].copy()
    p = state["p"].copy()
    v = state["v"].copy()
    ba = state["ba"].copy()
    bg = state["bg"].copy()

    qhat = q
    qe = quat_mul(np.array([qhat[0], -qhat[1], -qhat[2], -qhat[3]]), lidar_q)
    sgn = -1.0 if qe[0] < 0 else 1.0
    qcorr = np.array([1.0 - abs(qe[0]), sgn * qe[1], sgn * qe[2], sgn * qe[3]])
    qcorr = quat_mul(qhat, qcorr)

    err = lidar_p - p
    err_body = quat_rotate(np.array([qhat[0], -qhat[1], -qhat[2], -qhat[3]]),
                           err)

    ba = ba - dt * geo.Kab * err_body
    ba = np.clip(ba, -geo.abias_max, geo.abias_max)
    bg = bg - dt * geo.Kgb * qe[0] * qe[1:]
    bg = np.clip(bg, -geo.gbias_max, geo.gbias_max)

    p = p + dt * geo.Kp * err
    v = v + dt * geo.Kv * err
    q = q + dt * geo.Kq * qcorr
    q = q / np.linalg.norm(q)
    return {"q": q, "p": p, "v": v, "ba": ba, "bg": bg}


# ---------------------------------------------------------------------------
# Block-hashed dense maps (models/tsdf.py, models/occupancy.py)
# ---------------------------------------------------------------------------

def _block_keys_ref(b):
    """(S, 3) int block coords -> (packed keys as int32 values, in-range
    mask). 11+11+10 bits, the models/tsdf._block_key layout, which wraps
    into the sign bit; sorting follows the int32 order."""
    bx, by, bz = b[:, 0], b[:, 1], b[:, 2]
    ok = ((bx >= -1024) & (bx < 1024) & (by >= -1024) & (by < 1024)
          & (bz >= -512) & (bz < 512))
    key = ((bz + 512) << 22) | ((by + 1024) << 11) | (bx + 1024)
    return (key + 2 ** 31) % 2 ** 32 - 2 ** 31, ok


def route_blocks_ref(directory, vx, active, scan_block_cap, max_blocks):
    """Per-scan block gating shared by both dense maps.

    ``directory``: dict block key -> payload slot, updated in place. The
    scan's distinct blocks are taken in key order; only the first
    ``scan_block_cap`` are kept, and unseen ones get the next free slot
    while the directory has room. Returns (mask of samples that land in a
    kept, allocated block; number of blocks dropped this scan)."""
    keys, ok = _block_keys_ref(vx >> 3)
    live = active & ok
    uniq = np.unique(keys[live])
    kept = uniq[:scan_block_cap]
    dropped = len(uniq) - len(kept)
    for k in kept.tolist():
        if k not in directory:
            if len(directory) < max_blocks:
                directory[k] = len(directory)
            else:
                dropped += 1
    landed = np.asarray([k in directory for k in kept.tolist()], bool)
    keep = live & np.isin(keys, kept[landed])
    return keep, dropped


def _voxel_sums(vx, keep, *vals):
    """Per-voxel sums of ``vals`` over the kept samples:
    (voxel tuples, [sums per val])."""
    v = vx[keep]
    uniq, inv = np.unique(v, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    sums = [np.bincount(inv, weights=np.asarray(x, np.float64)[keep],
                        minlength=len(uniq)) for x in vals]
    return [tuple(u) for u in uniq.tolist()], sums


def tsdf_fuse_ref(voxels, directory, pos, sdf, w, voxel_size, truncation,
                  max_weight, scan_block_cap, max_blocks):
    """One scan of projective TSDF fusion, clamped weighted mean per voxel:
    d' = (W d + sum w sdf) / (W + sum w), W' = min(W + sum w, max_weight).
    ``voxels``: dict voxel (ix, iy, iz) -> (W, d), updated in place.
    Returns the number of blocks dropped."""
    vx = np.floor(pos / np.float32(voxel_size)).astype(np.int64)
    keep, dropped = route_blocks_ref(directory, vx, w != 0,
                                     scan_block_cap, max_blocks)
    sdf_c = np.clip(sdf, -truncation, truncation)
    keys, (sw, swd) = _voxel_sums(vx, keep, w, w * sdf_c)
    for k, a, b in zip(keys, sw, swd):
        W, d = voxels.get(k, (0.0, 0.0))
        d = (W * d + b) / (W + a)
        voxels[k] = (min(W + a, max_weight), d)
    return dropped


def occupancy_fuse_ref(logodds, directory, pos, delta, voxel_size, l_min,
                       l_max, scan_block_cap, max_blocks):
    """One scan of additive log-odds fusion clamped at scan granularity:
    L' = clip(L + sum delta, l_min, l_max). ``logodds``: dict voxel ->
    L, updated in place. Returns the number of blocks dropped."""
    vx = np.floor(pos / np.float32(voxel_size)).astype(np.int64)
    keep, dropped = route_blocks_ref(directory, vx, delta != 0,
                                     scan_block_cap, max_blocks)
    keys, (sd,) = _voxel_sums(vx, keep, delta)
    for k, s in zip(keys, sd):
        logodds[k] = float(np.clip(logodds.get(k, 0.0) + s, l_min, l_max))
    return dropped


def dense_map_voxels(dir_keys, dir_slots, payload):
    """Host view of a block-hashed map state: dict voxel (ix, iy, iz) ->
    payload row entries, for every voxel of every allocated block.
    ``payload``: tuple of (C, 512) arrays."""
    out = {}
    pad = np.iinfo(np.int32).max
    iv = np.arange(512)
    intra = np.stack([iv & 7, (iv >> 3) & 7, (iv >> 6) & 7], -1)
    for key, slot in zip(np.asarray(dir_keys).tolist(),
                         np.asarray(dir_slots).tolist()):
        if key == pad:
            continue
        b = np.array([(key & 0x7FF) - 1024, ((key >> 11) & 0x7FF) - 1024,
                      ((key >> 22) & 0x3FF) - 512])
        vox = b * 8 + intra
        rows = [np.asarray(p)[slot] for p in payload]
        for j in range(512):
            out[tuple(vox[j].tolist())] = tuple(r[j] for r in rows)
    return out
