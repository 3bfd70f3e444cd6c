#!/usr/bin/env python3
"""Bring-up check of the SLAM + TSDF main path on NVIDIA GPUs.

    python chip_smoke.py                # one card
    python chip_smoke.py --four-cards   # the multi-card paths, four cards

One card, in order (each phase raises on failure):

  nn         the fused NN kernel (ops.neighbors.nn1) against a float64
             brute force on the host, 8192 queries x 65536 targets
  integrate  TSDF integrate and occupancy deltas at the default config,
             three scans, against the CPU
  archive    exact de-fusion of the keyframe-archive volume on the card
  gicp       gicp_align 8192 -> 65536 points and a 256-node pose-graph
             optimize, against the CPU
  slam       `cli slam --mulran --warmup` with the default config over a
             generated 32,768-point/scan two-lap spiral (see SLAM_SPIRAL)

Four cards: the map-sharded fused slam step, `cli batch` over four
generated sequences, the sharded TSDF and the edge-sharded CG solve, each
against the same computation on one card.

A failed phase ends the script with a non-zero code and no result. So does
a machine where JAX finds no GPU. Otherwise the card's
``nvidia-smi`` name and power limit come on a line before the last, and
the last line is one JSON object naming the devices.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 7

# Tolerances, each with its reason:
# - NN, against a float64 brute force of the same float32 points: the
#   kernel's float32 direct differences of near points are exact
#   (Sterbenz), so its squared distance is within a few ulp (< 1e-6
#   relative) of the float64 one. Its pick is never farther than the
#   float64 nearest by more than that, and it is the float64 nearest
#   wherever nearest and second nearest differ by more than 1e-6 m^2.
NN_SQD_RTOL = 1e-6
NN_GAP = 1e-6
# - integrate: scatter-adds are atomic on the GPU and sum in another order
#   than the CPU; directory keys, slots and counts are integers and exact.
PAYLOAD_TOL = 1e-5
#   The whole `integrate` also draws its ray samples on each side; the
#   GPU contracts the sample-position arithmetic into fused multiply-adds,
#   which moves a few samples that sit on a voxel face into the
#   neighbouring voxel. At most this share of the touched voxels may
#   differ for that reason.
SAMPLE_MOVE_FRAC = 1e-4
# - archive: add then subtract of one cloud cancels to rounding of the
#   accumulated mass (tests/test_archive.py bound).
DEFUSE_REL = 1e-5
# - gicp / posegraph: half the solver's own stopping threshold (GicpConfig
#   transformation/rotation epsilon 0.01 m / 0.01 rad) for GICP; for the
#   256-node graph on a 10 m circle, 1 mm and 1e-3 rad, far above float32
#   rounding of the solve and far below what a TF32 product (~1e-3
#   relative, ~1 cm at 10 m) would give.
GICP_TOL_T, GICP_TOL_R = 5e-3, 5e-3
GRAPH_TOL_T, GRAPH_TOL_R = 1e-3, 1e-3
# - slam: the closed-loop bound of tests/test_mulran_e2e.py.
ATE_BOUND = 0.5

# The slam phase's drive: two laps of a spiral whose second lap runs one
# lane (5.5 m) outside the first, not a closed loop that retraces itself.
# With the default adaptive keyframing a new keyframe is made only beyond
# ~5 m of every old one, so a retraced lap makes no keyframe and cannot
# close; the offset lap makes new ones 5-7.5 m from old places. The
# default proximity radius (3 m) is below that distance, so the run passes
# `--loop-radius` 1.5 x the 5 m keyframe distance (DLIO's own "nearby"
# radius in its keyframe test).
SLAM_DRIVE_S = 45.0
SLAM_SPIRAL = dict(period=20.0, r0=5.0, dr=5.5)
SLAM_LOOP_RADIUS = 7.5
# - four cards against one: a few fused steps agree within the GICP
#   tolerance above. Whole trajectories agree within 0.1 m, the fixture's
#   ATE bound: GICP stops once an update is below its 0.01 m epsilon, so
#   two programs whose float32 rounding differs (the batched step compiles
#   for B=4 on one card and B=1 on each of four) can stop an iteration
#   apart and differ by up to ~1 cm per scan, which wanders at the
#   trajectory's own error scale.
MULTI_TRAJ_TOL = 0.1


def log(*a):
    print(*a, flush=True)


def check(cond, detail=None):
    """Fail the phase when ``cond`` is false (an assert that survives
    ``python -O``)."""
    if not cond:
        raise AssertionError(detail)


def _cpu():
    import jax

    return jax.devices("cpu")[0]


def _on(dev, fn, *args):
    """Run ``fn(*args)`` with every array committed to ``dev``."""
    import jax

    with jax.default_device(dev):
        args = jax.device_put(args, dev)
        return jax.device_get(fn(*args))


# ---------------------------------------------------------------------------
# One card
# ---------------------------------------------------------------------------

def _nn_f64(qry, tgt, chunk=128):
    """Float64 brute-force 1-NN on the host: (index, nearest, second
    nearest squared distance) per query."""
    q, t = qry.astype(np.float64), tgt.astype(np.float64)
    idx = np.empty(len(q), np.int64)
    d1, d2 = np.empty(len(q)), np.empty(len(q))
    rows = np.arange(chunk)
    for s in range(0, len(q), chunk):
        qc = q[s:s + chunk]
        d = sum((qc[:, k, None] - t[None, :, k]) ** 2 for k in range(3))
        r = rows[:len(qc)]
        i = np.argmin(d, axis=1)
        idx[s:s + chunk], d1[s:s + chunk] = i, d[r, i]
        d[r, i] = np.inf
        d2[s:s + chunk] = d.min(axis=1)
    return idx, d1, d2


def _check_nn(name, qry, tgt, i_g, d_g, ref, sel):
    """Hold the kernel's answer for the queries ``sel`` to the float64
    reference ``ref``; returns the number of picks that differ (all
    float32-resolution ties)."""
    i_r, d1, d2 = (a[sel] for a in ref)
    i_g, d_g = i_g[sel], d_g[sel]
    e_g = np.sum((qry[sel].astype(np.float64) - tgt[i_g]) ** 2, axis=1)
    np.testing.assert_allclose(d_g, e_g, rtol=NN_SQD_RTOL,
                               err_msg=f"{name}: sqd of the kernel's pick")
    check(np.all(e_g <= d1 * (1 + NN_SQD_RTOL)),
          f"{name}: a pick farther than the float64 nearest")
    clear = d2 - d1 > NN_GAP
    check(np.all(i_g[clear] == i_r[clear]),
          f"{name}: index differs where the nearest is clear")
    return int(np.sum(i_g != i_r))


def phase_nn(rng):
    import jax

    from noetic_slam_tpu.ops import neighbors
    from noetic_slam_tpu.utils.synthetic import surface_cloud

    tgt = surface_cloud(rng, 65536)
    qry = tgt[np.sort(rng.choice(len(tgt), 8192, replace=False))]
    qry = (qry + rng.normal(scale=0.1, size=qry.shape)).astype(np.float32)
    nn = jax.jit(neighbors.nn1)
    i_g, d_g = jax.device_get(nn(qry, tgt))
    ref = _nn_f64(qry, tgt)
    n_tie = _check_nn("nn", qry, tgt, i_g, d_g, ref, slice(None))
    # Capped at the GICP correspondence radius (sqd 0.25): a query whose
    # float64 nearest is inside returns it; one outside returns the cap.
    i_k, d_k = jax.device_get(nn(qry, tgt, None, 0.5))
    d1 = ref[1]
    found = d1 < 0.25 * (1 - NN_SQD_RTOL)
    out = d1 > 0.25 * (1 + NN_SQD_RTOL)
    check(found.mean() > 0.9)
    n_tie_k = _check_nn("nn capped", qry, tgt, i_k, d_k, ref, found)
    check(np.all(d_k[out] >= 0.25 * (1 - NN_SQD_RTOL)))
    log(f"nn: 8192x65536 kernel vs float64 brute force: max |dsqd| "
        f"{np.abs(d_g - ref[1]).max():.3g} m^2, {n_tie} picks differ (ties "
        f"at float32 resolution), {int(np.sum(ref[2] - ref[1] <= NN_GAP))} "
        f"queries with nearest and second within {NN_GAP} m^2; capped "
        f"0.5 m: {found.mean():.4f} found, {n_tie_k} picks differ")


def _scan_clouds(rng, n=32768, k=3, extent=30.0):
    """``k`` world-frame scans of a surface scene and their origins."""
    from noetic_slam_tpu.utils.synthetic import surface_cloud

    base = surface_cloud(rng, 4 * n, extent=extent)
    out = []
    for i in range(k):
        o = np.array([0.5 * i, 0.2 * i, 1.0], np.float32)
        pick = base[rng.choice(len(base), n, replace=False)]
        out.append((pick, o))
    return out


def _cmp_map(name, a, b, fields):
    for f in ("dir_keys", "dir_slots", "num_blocks", "dropped"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{name}.{f}")
    worst = 0.0
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        np.testing.assert_allclose(x, y, rtol=PAYLOAD_TOL, atol=PAYLOAD_TOL,
                                   err_msg=f"{name}.{f}")
        worst = max(worst, float(np.abs(x - y).max()))
    return worst


def phase_integrate(rng):
    import jax
    import jax.numpy as jnp

    from noetic_slam_tpu.config.params import DlioConfig
    from noetic_slam_tpu.models import occupancy, tsdf

    cfg = DlioConfig()
    scans = _scan_clouds(rng)
    ones = jnp.ones((scans[0][0].shape[0],), bool)
    acc_t = jax.jit(tsdf._integrate_samples, static_argnums=0)
    acc_o = jax.jit(occupancy._integrate_deltas, static_argnums=0)

    # The accumulate (sort, directory, scatter-adds, clamp) on identical
    # samples, drawn once on the CPU.
    t_samples = [_on(_cpu(), functools.partial(tsdf._ray_samples, cfg.tsdf),
                     p, ones, o) for p, o in scans]
    o_samples = [_on(_cpu(), functools.partial(occupancy._beam_samples,
                                               cfg.occupancy), p, ones, o)
                 for p, o in scans]

    def run_acc(acc, st, mcfg, samples):
        for smp in samples:
            st = acc(mcfg, st, *smp)
        return st

    t_init, o_init = tsdf.init_tsdf(cfg.tsdf), occupancy.init_occupancy(
        cfg.occupancy)
    gpu = jax.device_get(run_acc(acc_t, t_init, cfg.tsdf, t_samples))
    cpu = _on(_cpu(), lambda: run_acc(acc_t, tsdf.init_tsdf(cfg.tsdf),
                                      cfg.tsdf, t_samples))
    check(int(gpu.num_blocks) > 100)
    w_t = _cmp_map("tsdf", gpu, cpu, ("weight", "wsum"))
    n_blocks, n_dropped = int(gpu.num_blocks), int(gpu.dropped)
    gpu = jax.device_get(run_acc(acc_o, o_init, cfg.occupancy, o_samples))
    cpu = _on(_cpu(), lambda: run_acc(
        acc_o, occupancy.init_occupancy(cfg.occupancy), cfg.occupancy,
        o_samples))
    w_o = _cmp_map("occupancy", gpu, cpu, ("logodds",))

    # The whole `integrate`, samples drawn on each side.
    def run_tsdf(*flat):
        st = tsdf.init_tsdf(cfg.tsdf)
        for pts, o in zip(flat[::2], flat[1::2]):
            st = tsdf.integrate(cfg.tsdf, st, pts, ones, o)
        return st

    flat = [a for s in scans for a in s]
    gpu = jax.device_get(run_tsdf(*flat))
    cpu = _on(_cpu(), run_tsdf, *flat)
    np.testing.assert_array_equal(gpu.dir_keys, cpu.dir_keys)
    off = ~np.isclose(gpu.weight, cpu.weight, rtol=PAYLOAD_TOL,
                      atol=PAYLOAD_TOL)
    touched = int(np.count_nonzero(cpu.weight))
    check(off.sum() <= SAMPLE_MOVE_FRAC * touched, (off.sum(), touched))
    log(f"integrate: tsdf {n_blocks} blocks, {n_dropped} blocks dropped; "
        f"occupancy {int(cpu.num_blocks)} blocks; accumulate on identical "
        f"samples: max |d| tsdf {w_t:.3g}, occupancy {w_o:.3g} (tol "
        f"{PAYLOAD_TOL}); whole integrate: {int(off.sum())} of {touched} "
        f"voxels differ")


def phase_archive(rng):
    import dataclasses

    import jax
    import jax.numpy as jnp

    from noetic_slam_tpu.config.params import DlioConfig
    from noetic_slam_tpu.models import tsdf

    cfg = dataclasses.replace(DlioConfig().tsdf, max_weight=tsdf.NO_CLAMP)
    (pts, o), (pts2, o2) = _scan_clouds(rng, k=2)
    valid = jnp.ones((pts.shape[0],), bool)
    vol = tsdf.init_tsdf(cfg)
    vol = tsdf.integrate_signed(cfg, vol, pts2, valid, o2, jnp.float32(1.0))
    vol = tsdf.integrate_signed(cfg, vol, pts, valid, o, jnp.float32(1.0))
    w_both = jax.device_get(vol.weight)
    vol = tsdf.integrate_signed(cfg, vol, pts, valid, o, jnp.float32(-1.0))
    vol = tsdf.integrate_signed(cfg, vol, pts2, valid, o2, jnp.float32(-1.0))
    peak = float(np.abs(w_both).max())
    res_w = float(jnp.max(jnp.abs(vol.weight)))
    res_ws = float(jnp.max(jnp.abs(vol.wsum)))
    check(peak > 1.0)
    check(res_w < DEFUSE_REL * peak, (res_w, peak))
    check(res_ws < DEFUSE_REL * peak, (res_ws, peak))
    log(f"archive: add/subtract of two 32768-point scans leaves "
        f"|weight| {res_w:.3g}, |wsum| {res_ws:.3g} of peak {peak:.1f} "
        f"(bound {DEFUSE_REL} x peak)")


def _quat_angle(qa, qb):
    """Largest rotation angle between two (K, 4) wxyz quaternion sets,
    computed in float64."""
    qa, qb = np.asarray(qa, np.float64), np.asarray(qb, np.float64)
    w = np.sum(qa * qb, -1)
    v = (qa[:, :1] * qb[:, 1:] - qb[:, :1] * qa[:, 1:]
         - np.cross(qa[:, 1:], qb[:, 1:]))
    return float(np.max(2.0 * np.arctan2(np.linalg.norm(v, axis=-1),
                                         np.abs(w))))


def _rot_angle(Ra, Rb):
    """Rotation angle between two 3x3 rotations, computed in float64."""
    R = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    s = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]]) / 2.0
    return float(np.arctan2(s, (np.trace(R) - 1.0) / 2.0))


def phase_gicp(rng):
    import jax
    import jax.numpy as jnp

    from noetic_slam_tpu.config.params import GicpConfig
    from noetic_slam_tpu.models import posegraph as pg
    from noetic_slam_tpu.ops import gicp
    from noetic_slam_tpu.utils.synthetic import surface_cloud

    tgt = surface_cloud(rng, 65536, extent=30.0)
    src = tgt[np.sort(rng.choice(len(tgt), 8192, replace=False))]
    ang = 0.03
    R = np.array([[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang),
                                                    0], [0, 0, 1]])
    src = ((src - [0.2, -0.15, 0.05]) @ R).astype(np.float32)
    sv, tv = jnp.ones((8192,), bool), jnp.ones((65536,), bool)
    src_cov, _ = gicp.radius_covariances(jnp.asarray(src), sv)
    tgt_cov, _ = gicp.radius_covariances(jnp.asarray(tgt), tv)
    src_cov, tgt_cov = jax.device_get((src_cov, tgt_cov))
    cfg = GicpConfig()
    align = jax.jit(functools.partial(gicp.gicp_align, cfg=cfg))
    g = jax.device_get(align(src, np.ones(8192, bool), src_cov, tgt,
                             tgt_cov))
    c = _on(_cpu(), align, src, np.ones(8192, bool), src_cov, tgt, tgt_cov)
    dt = float(np.abs(g.T[:3, 3] - c.T[:3, 3]).max())
    dr = _rot_angle(g.T[:3, :3], c.T[:3, :3])
    check(bool(g.converged) and bool(c.converged))
    check(dt < GICP_TOL_T and dr < GICP_TOL_R, (dt, dr))
    # The same on the card with every matmul at full float32: what the
    # unpinned products' TF32 contributes.
    with jax.default_matmul_precision("highest"):
        h = jax.device_get(jax.jit(functools.partial(
            gicp.gicp_align, cfg=cfg))(src, np.ones(8192, bool), src_cov,
                                       tgt, tgt_cov))
    log(f"gicp: 8192->65536 card vs cpu: |dt| {dt:.3g} m, |dR| {dr:.3g} "
        f"rad, iterations {int(g.iterations)}/{int(c.iterations)}, "
        f"corr {int(g.num_corr)}/{int(c.num_corr)}; card at highest "
        f"precision vs cpu: |dt| "
        f"{float(np.abs(h.T[:3, 3] - c.T[:3, 3]).max()):.3g} m, |dR| "
        f"{_rot_angle(h.T[:3, :3], c.T[:3, :3]):.3g} rad")

    K, E = 256, 512
    th = np.linspace(0, 2 * np.pi, K).astype(np.float32)
    est_p = np.stack([10 * np.cos(th), 10 * np.sin(th), 0 * th], -1)
    est_p = (est_p + rng.normal(scale=0.05, size=est_p.shape)
             ).astype(np.float32)
    qs = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (K, 1))
    graph = pg.init_graph(K, E)
    graph = pg.add_nodes_chain(graph, qs, est_p, K)
    dq, dp = pg.relative_pose(jnp.asarray(qs[0]), jnp.asarray(est_p[0]),
                              jnp.asarray(qs[K - 1]),
                              jnp.asarray(est_p[K - 1] + [0.5, 0.3, 0.0]))
    graph = pg.add_edge(graph, jnp.int32(0), jnp.int32(K - 1), dq, dp,
                        w_rot=2.0, w_trans=2.0)
    graph = jax.device_get(graph)
    opt = jax.jit(pg.optimize)
    g = jax.device_get(opt(graph))
    c = _on(_cpu(), opt, graph)
    moved = float(np.abs(c.node_p - graph.node_p).max())
    dt = float(np.abs(g.node_p - c.node_p).max())
    dr = _quat_angle(g.node_q, c.node_q)
    check(moved > 0.01 and np.isfinite(g.node_p).all())
    check(dt < GRAPH_TOL_T and dr < GRAPH_TOL_R, (dt, dr))
    with jax.default_matmul_precision("highest"):
        h = jax.device_get(jax.jit(pg.optimize)(graph))
    log(f"posegraph: 256 nodes card vs cpu: |dp| {dt:.3g} m, |dq| "
        f"{dr:.3g} rad (nodes moved up to {moved:.3f} m); card at highest "
        f"precision vs cpu: |dp| "
        f"{float(np.abs(h.node_p - c.node_p).max()):.3g} m")


def phase_slam(out_dir, scratch):
    import jax

    from noetic_slam_tpu import cli
    from noetic_slam_tpu.utils import synthetic

    sys.path.insert(0, ROOT)
    from scripts.make_mulran_fixture import write_fixture

    seq = os.path.join(scratch, "mulran_loop")
    t0 = time.perf_counter()
    meta = write_fixture(
        seq, duration=SLAM_DRIVE_S, hold=3.5, n_points=32768, seed=SEED,
        radar=False, pose_fn=functools.partial(synthetic.spiral_pose_of,
                                               **SLAM_SPIRAL))
    log(f"slam: generated {meta['n_scans']} scans x {meta['n_points']} "
        f"points in {time.perf_counter() - t0:.1f} s")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["slam", "--mulran", seq, "--out",
                       os.path.join(out_dir, "slam"), "--warmup",
                       "--loop-radius", str(SLAM_LOOP_RADIUS)])
    text = buf.getvalue()
    sys.stdout.write(text)
    check(rc == 0, rc)
    run = json.loads(text.strip().splitlines()[-1])
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    check(run["ate_rmse_m"] < ATE_BOUND, run["ate_rmse_m"])
    check(run["loop_closures"] >= 1, run["loop_closures"])
    check(run["lost_keyframes"] == 0, run["lost_keyframes"])
    check(run["surface_points"] > 0)
    log(f"slam: ATE {run['ate_rmse_m']} m, closures "
        f"{run['loop_closures']}, lost keyframes {run['lost_keyframes']}, "
        f"surface points {run['surface_points']}")
    log(f"slam: {run['scans']} scans, {run['scans_per_s']} scans/s "
        f"overall, {run.get('scans_per_s_after_warmup')} scans/s after "
        f"warmup, warmup {run['warmup_s']} s, peak_bytes_in_use {peak}")


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------

def _traj_diff(a, b):
    check(a.shape == b.shape, (a.shape, b.shape))
    return float(np.abs(a[:, 1:4] - b[:, 1:4]).max())


def four_fused_step(cfg):
    """Map-sharded fused slam step (odometry + TSDF, one program) on four
    cards against the single-card step."""
    sys.path.insert(0, ROOT)
    from __graft_entry__ import _example_input, run_fused_slam_steps
    from noetic_slam_tpu.parallel.mesh import make_mesh

    inputs = [_example_input(cfg, seed=s, header=0.1 * s) for s in range(3)]
    one = run_fused_slam_steps(cfg, inputs, mesh=None)
    four = run_fused_slam_steps(cfg, inputs, mesh=make_mesh(4, axis="map"))
    d = max(float(np.abs(a.lidar_p - b.lidar_p).max())
            for a, b in zip(one, four))
    check(all(bool(o.processed) for o in four))
    check(d < GICP_TOL_T, d)
    log(f"four: map-sharded fused slam step x3, "
        f"{cfg.capacity.max_points} points: "
        f"|dp| vs one card {d:.3g} m, corr {int(four[-1].num_corr)}")


def four_batch(out_dir, scratch, n_points=32768, config=None):
    """`cli batch` over four generated sequences on four cards against the
    same command on one card."""
    from noetic_slam_tpu import cli

    sys.path.insert(0, ROOT)
    from scripts.make_mulran_fixture import write_fixture

    dirs = []
    for b in range(4):
        d = os.path.join(scratch, f"seq{b}")
        write_fixture(d, duration=6.0, hold=3.5, n_points=n_points,
                      seed=SEED + b, radar=False)
        dirs.append(d)
    runs = {}
    for devices in (1, 4):
        out = os.path.join(out_dir, f"batch{devices}")
        args = ["batch", "--out", out, "--devices", str(devices)]
        if config:
            args += ["--config", config]
        for d in dirs:
            args += ["--mulran", d]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            check(cli.main(args) == 0)
        sys.stdout.write(buf.getvalue())
        res = json.loads(buf.getvalue().strip().splitlines()[-1])
        check(res["devices"] == devices, res)
        runs[devices] = [np.loadtxt(os.path.join(out, f"{s['name']}.tum"))
                         for s in res["sequences"]]
        runs[f"res{devices}"] = res
    d = max(_traj_diff(a, b) for a, b in zip(runs[1], runs[4]))
    check(d < MULTI_TRAJ_TOL, d)
    ate = [s.get("ate_rmse_m") for s in runs["res4"]["sequences"]]
    log(f"four: cli batch 4 sequences: trajectories vs one card |dp| "
        f"{d:.3g} m, ATE {ate}, {runs['res4']['scans_per_sec']} scans/s "
        f"on 4 cards vs {runs['res1']['scans_per_sec']} on 1")


def four_tsdf(cfg, n=32768):
    """Sharded TSDF fusion on four cards against tsdf.integrate on one:
    the same voxels with the same distances and weights."""
    import jax
    import jax.numpy as jnp

    from noetic_slam_tpu.models import tsdf
    from noetic_slam_tpu.parallel.mesh import make_mesh
    from noetic_slam_tpu.parallel.tsdf import (gather_sharded_state,
                                               init_sharded_tsdf,
                                               make_sharded_integrate)

    mesh = make_mesh(4, axis="map")
    rng = np.random.default_rng(3)
    # A room-sized scene, so that no scan overflows the per-scan block cap
    # (a per-card cap, which four cards hold four times over).
    scans = _scan_clouds(rng, n=n, extent=8.0)
    one = tsdf.init_tsdf(cfg)
    four = init_sharded_tsdf(cfg, mesh)
    integ = make_sharded_integrate(cfg, mesh)
    for pts, o in scans:
        valid = jnp.ones((pts.shape[0],), bool)
        one = tsdf.integrate(cfg, one, jnp.asarray(pts), valid,
                             jnp.asarray(o))
        four = integ(four, jnp.asarray(pts), valid, jnp.asarray(o))

    def voxels(st):
        st = jax.device_get(st)
        keys, slots = np.asarray(st.dir_keys), np.asarray(st.dir_slots)
        ok = keys != np.iinfo(np.int32).max
        w = np.asarray(st.weight).reshape(-1, 512)
        ws = np.asarray(st.wsum).reshape(-1, 512)
        return dict(zip(keys[ok].tolist(),
                        zip(w[slots[ok]], ws[slots[ok]])))

    check(int(one.dropped) == 0 and int(four.dropped) == 0)
    a, b = voxels(one), voxels(gather_sharded_state(cfg, four, mesh))
    check(a.keys() == b.keys(), (len(a), len(b)))
    worst = 0.0
    for k, (w, ws) in a.items():
        w2, ws2 = b[k]
        np.testing.assert_allclose(w2, w, rtol=PAYLOAD_TOL, atol=PAYLOAD_TOL)
        np.testing.assert_allclose(ws2, ws, rtol=PAYLOAD_TOL,
                                   atol=PAYLOAD_TOL)
        worst = max(worst, float(np.abs(w2 - w).max()))
    log(f"four: sharded TSDF x3 scans: {len(a)} blocks, same keys, max "
        f"|dweight| {worst:.3g}")


def four_cg():
    """Edge-sharded matrix-free CG pose-graph solve on four cards against
    the single-card CG solve."""
    import jax
    import jax.numpy as jnp

    from noetic_slam_tpu.models import posegraph as pg
    from noetic_slam_tpu.parallel.bundle_adjustment import sharded_optimize
    from noetic_slam_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(5)
    K, E = 1024, 2048
    th = np.linspace(0, 4 * np.pi, K).astype(np.float32)
    est_p = np.stack([20 * np.cos(th), 20 * np.sin(th), 0.1 * th], -1)
    est_p = (est_p + rng.normal(scale=0.05, size=est_p.shape)
             ).astype(np.float32)
    qs = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (K, 1))
    g = pg.init_graph(K, E)
    g = pg.add_nodes_chain(g, qs, est_p, K)
    for i in range(0, K // 2, 64):
        j = i + K // 2
        dq, dp = pg.relative_pose(jnp.asarray(qs[i]), jnp.asarray(est_p[i]),
                                  jnp.asarray(qs[j]),
                                  jnp.asarray(est_p[j] + [0.2, 0.1, 0.0]))
        g = pg.add_edge(g, jnp.int32(i), jnp.int32(j), dq, dp, w_rot=2.0,
                        w_trans=2.0)
    one = jax.device_get(pg.optimize(g, iters=3, method="cg", cg_iters=100))
    four = jax.device_get(sharded_optimize(make_mesh(4, axis="map"), g,
                                           iters=3, method="cg",
                                           cg_iters=100))
    d = float(np.abs(one.node_p - four.node_p).max())
    check(np.isfinite(four.node_p).all())
    check(d < GRAPH_TOL_T, d)
    log(f"four: edge-sharded CG, {K} nodes: |dp| vs one card {d:.3g} m")


# ---------------------------------------------------------------------------

def _nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card paths, on four cards")
    ap.add_argument("--out", default=os.path.join(ROOT, "out",
                                                  "chip_smoke"),
                    help="directory for the outputs of `cli slam`/`batch`")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devices[0].platform}); "
              "nothing run", file=sys.stderr)
        return 1
    want = 4 if args.four_cards else 1
    if len(devices) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 1

    from noetic_slam_tpu.runtime import compile_cache

    compile_cache.enable()
    log(f"devices: {len(devices)} x {devices[0].device_kind}")
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(os.path.join(ROOT, ".scratch"), exist_ok=True)
    scratch = tempfile.mkdtemp(dir=os.path.join(ROOT, ".scratch"))
    rng = np.random.default_rng(SEED)
    t_all = time.perf_counter()
    try:
        if args.four_cards:
            from noetic_slam_tpu.config.params import DlioConfig

            four_fused_step(DlioConfig())
            four_batch(args.out, scratch)
            four_tsdf(DlioConfig().tsdf)
            four_cg()
        else:
            for name, run in (
                    ("nn", lambda: phase_nn(rng)),
                    ("integrate", lambda: phase_integrate(rng)),
                    ("archive", lambda: phase_archive(rng)),
                    ("gicp", lambda: phase_gicp(rng)),
                    ("slam", lambda: phase_slam(args.out, scratch))):
                t = time.perf_counter()
                run()
                log(f"phase {name}: {time.perf_counter() - t:.1f} s")
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    log(f"total: {time.perf_counter() - t_all:.1f} s")
    log(_nvidia_smi())
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
