"""Long-soak SLAM run: the BASELINE "full sequence / long outdoor
loop-closure sequence" measurement config on synthetic multi-loop data.

Drives the full `cli slam` path (SlamSystem: odometry + fused dense map +
pose graph + loop closure + keyframe archive) through >= SOAK_SCANS scans
of a repeated-loop trajectory and records one JSON artifact
(SOAK_r{N}.json) proving the long-run properties VERDICT r2 called
unproven:

- keyframe eviction active (kf_total >> resident capacity);
- pose-graph growth past the initial node capacity (no silent
  saturation), optimizer on the CG path (> 192 nodes);
- >= 3 loop closures applied, each corrected INCREMENTALLY through the
  keyframe archive (closure cost = O(moved keyframes), logged per
  closure);
- post-closure map coverage monotone (allocated archive blocks never
  shrink — evicted geometry survives in the archive volume);
- sustained scans/s over successive windows (no degradation);
- one mid-run checkpoint + resume with BITWISE-identical odometry
  continuation.

Run on the chip:   python scripts/soak.py            (~2000 scans)
CPU regression:    SOAK_TINY=1 python scripts/soak.py (tests/test_soak.py)
Knobs: SOAK_SCANS, SOAK_OUT (artifact path), SOAK_BATCH (default 8).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_cfg(tiny: bool):
    from noetic_slam_tpu.config.params import (CapacityConfig, DlioConfig,
                                               GicpConfig, KeyframeConfig,
                                               TsdfConfig)

    if tiny:
        cap = CapacityConfig(
            max_points=2048, max_ds_points=1024, max_deskew_frames=512,
            max_imu_window=64, max_keyframes=24, max_submap_kf=8,
            max_trajectory=4096)
        tsdf = TsdfConfig(voxel_size=0.25, truncation=0.75, max_blocks=4096,
                          space_carving=False, scan_block_cap=1024)
    else:
        cap = CapacityConfig(
            max_points=8192, max_ds_points=4096, max_deskew_frames=1024,
            max_imu_window=128, max_keyframes=128, max_submap_kf=16,
            max_trajectory=16384)
        tsdf = TsdfConfig(voxel_size=0.2, truncation=0.6, max_blocks=16384,
                          space_carving=False, scan_block_cap=2048)
    # full GICP solver budget: the soak proves long-run correctness at the
    # production operating point, not under an artificially starved solver
    return DlioConfig(capacity=cap, adaptive=False,
                      keyframe=KeyframeConfig(thresh_dist=0.5,
                                              thresh_rot=45.0),
                      gicp=GicpConfig(),
                      tsdf=tsdf)


def main():
    tiny = os.environ.get("SOAK_TINY") == "1"
    n_scans = int(os.environ.get("SOAK_SCANS", "150" if tiny else "2000"))
    out_path = os.environ.get(
        "SOAK_OUT", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "SOAK_r04.json"))
    K = int(os.environ.get("SOAK_BATCH", "8"))

    import jax
    import jax.numpy as jnp

    from noetic_slam_tpu.models import posegraph as pg
    from noetic_slam_tpu.runtime.slam import SlamSystem
    from noetic_slam_tpu.utils import synthetic
    from noetic_slam_tpu.utils.synthetic import loop_pose_of, spiral_pose_of

    cfg = build_cfg(tiny)
    # 10 Hz scans: the odometry's designed operating point (the prior is
    # accurate over 0.1 s; 5 Hz replay measurably diverges on this
    # trajectory). Tiny mode shrinks the LAP (period/radius), not the
    # rate, so one CI run still covers a full loop + closure.
    scan_hz = 10.0
    import functools

    # Tiny: one small closed lap (fast CI). Full: an expanding SPIRAL of
    # laps — a repeated identical circle stops creating keyframes after
    # lap 1 (revisits inside thresh_dist), which starves eviction/growth;
    # the spiral keeps covering new ground at ~0.6 m/lap offset while each
    # lap stays in closure range of the previous one.
    pose_fn = (functools.partial(loop_pose_of, period=12.0, radius=5.0)
               if tiny else spiral_pose_of)
    dur = n_scans / scan_hz + 0.4
    n_pts = 2048 if tiny else 8192
    print(f"soak: {n_scans} scans, {dur:.0f} s sim, "
          f"backend={jax.default_backend()}", file=sys.stderr)
    sim = synthetic.make_sim(duration=dur, scan_hz=scan_hz, n_points=n_pts,
                             calib_time=3.1, seed=17, pose_fn=pose_fn,
                             imu_noise=0.0005)

    # Persistent compilation cache: cold first run compiles, warm reruns
    # load executables from disk (cold/warm warmup_seconds both recorded).
    from noetic_slam_tpu.runtime import compile_cache

    cache_dir = compile_cache.enable()

    # pipelined=True: the real-time sync protocol (sync_pipelined /
    # device seq guards / fresh resync before closure application) —
    # a blocking per-batch drain stalls the host on every batch.
    # Tiny mode applies EVERY verified closure (floor 0): its healthy lap
    # drifts only mm, and the CI twin must exercise the apply/archive
    # path, not just the verify gates.
    slam = SlamSystem(cfg, enable_tsdf=True, enable_loop_closure=True,
                      loop_radius=4.0, loop_min_gap=15, pipelined=True,
                      min_closure_correction=0.0 if tiny else None)
    if tiny:
        # force growth in the tiny regression too
        slam.graph = pg.init_graph(16, 16)
        slam.max_graph_nodes = 16
    else:
        # start BELOW the expected keyframe total so growth-past-saturation
        # is exercised at production scale (~1200 keyframes over the run)
        slam.graph = pg.init_graph(256, 512)
        slam.max_graph_nodes = 256

    imu_i = 0

    def feed(sys_, through):
        nonlocal imu_i
        while (imu_i < len(sim.imu_stamps)
               and sim.imu_stamps[imu_i] <= through):
            sys_.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                          sim.imu_acc[imu_i])
            imu_i += 1

    # Closure attempts every 2 batches (the r3 cadence of 25 scans +
    # 100-scan cooldown existed because closures cost 15-34 s each through
    # the per-keyframe archive dispatches; with the batched archive +
    # warmup they cost <~1 s, and attempting often catches drift while
    # corrections are still small — the r3 km run let drift reach 2.2 m
    # between closures).
    closure_every = 10 if tiny else 2 * K
    cooldown = 20 if tiny else 30
    ckpt_at = (n_scans * 3) // 5 // K * K
    cmp_scans = 2 * K                     # bitwise continuation window
    ckpt_path = os.path.join("/tmp", "soak_ckpt.nst.npz")

    window = max(4 * K, (40 if tiny else 200) // K * K)
    windows = []
    blocks_log = []                       # archive volume blocks per closure
    last_closure_scan = -10**9
    resume_ok = None

    def fetch_sync(sys_):
        return float(jnp.sum(sys_.odometry.state.lidar_p))

    def submit(sys_, lo, hi, closures=True):
        nonlocal last_closure_scan
        for b0 in range(lo, hi, K):
            chunk = [scans[i] for i in range(b0, min(b0 + K, hi))]
            feed(sys_, max(h + pt.max() for h, _, pt in chunk) + 0.02)
            sys_.process_scans([(h, x, p) for h, x, p in chunk])
            if closures and (b0 // K) % 2 == 1:
                # PIPELINED sync every 2nd batch, UNCONDITIONALLY — the
                # sync cadence must not ride the closure-attempt cadence:
                # closure cooldowns (30 scans) stacked with attempt gaps
                # let the un-drained span exceed the outbox ring in the
                # first r5 km soak (40 lost keyframes, ATE blown to 50 m).
                # Two batches = ~10 new keyframes, well inside the gather
                # window; the one-cadence staleness overlaps the fetch
                # with device work.
                sys_.sync_pipelined()
            if closures and (b0 - last_closure_scan >= cooldown) \
                    and (b0 % closure_every < K):
                if sys_.maybe_close_loop():
                    last_closure_scan = b0
                    blocks_log.append({
                        "scan": b0,
                        "archive_blocks": int(jax.device_get(
                            sys_.archive.volume.num_blocks)),
                        **sys_.closure_log[-1]})

    scans = []
    t_gen = time.perf_counter()
    for i in range(min(n_scans, len(sim.scan_stamps))):
        scans.append(sim.scan(i))
    print(f"scan gen: {time.perf_counter() - t_gen:.1f} s", file=sys.stderr)
    n_scans = len(scans)

    t_warm = time.perf_counter()
    slam.warmup()        # closure-stack compiles up front (not mid-run)
    warmup_s = time.perf_counter() - t_warm
    print(f"warmup: {warmup_s:.1f} s", file=sys.stderr)
    from noetic_slam_tpu.runtime.profiling import StageTimer

    slam.stages = StageTimer()     # stage table = post-warmup steady state

    t_start = time.perf_counter()
    done = 0
    while done < n_scans:
        hi = min(done + window, n_scans)
        snap0 = slam.stages.snapshot()
        n_clo0, cap0 = len(slam.closure_log), slam.graph.node_q.shape[0]
        t0 = time.perf_counter()
        submit(slam, done, hi)
        fetch_sync(slam)
        t1 = time.perf_counter()
        # Per-window attribution, so that a spread in the window rates has
        # a named cause: stage-delta + event markers.
        w = {"scans": hi - done,
             "scans_per_sec": round((hi - done) / (t1 - t0), 2),
             "stages": type(slam.stages).delta(snap0,
                                               slam.stages.snapshot()),
             "closures": len(slam.closure_log) - n_clo0}
        if slam.graph.node_q.shape[0] != cap0:
            w["graph_grew"] = [cap0, slam.graph.node_q.shape[0]]
        if not windows:
            w["note"] = "first window absorbs the fused-step batch compile"
        windows.append(w)
        done = hi

        if ckpt_at and done >= ckpt_at and resume_ok is None:
            # ---- checkpoint + bitwise-resume check ----
            slam.flush()
            slam.save(ckpt_path)
            slam2 = SlamSystem(cfg, enable_tsdf=True,
                               enable_loop_closure=True,
                               loop_radius=4.0, loop_min_gap=15)
            slam2.load(ckpt_path)
            end = min(done + cmp_scans, n_scans)
            # run BOTH for the comparison window (no closures: archive
            # replay reconstructs the volume to ulp, not bitwise, so a
            # post-resume closure could diverge in the last float bit; the
            # odometry state itself restores exactly)
            imu_i0 = imu_i
            submit(slam, done, end, closures=False)
            imu_saved = imu_i
            imu_i = imu_i0            # re-feed the same IMU span to slam2
            submit(slam2, done, end, closures=False)
            imu_i = imu_saved
            a = jax.device_get(slam.odometry.state)
            b = jax.device_get(slam2.odometry.state)
            diffs = [f for f, x, y in zip(a._fields, a, b)
                     if not np.array_equal(np.asarray(x), np.asarray(y))]
            resume_ok = not diffs
            print(f"resume bitwise: {resume_ok} (diff fields: {diffs})",
                  file=sys.stderr)
            del slam2
            done = end

    wall = time.perf_counter() - t_start
    slam.sync_graph()        # exact final drain (pipelined leaves a tail)

    # label every slow window (< 0.5x median) with its dominant cause
    rates = [w["scans_per_sec"] for w in windows[1:]] or \
            [w["scans_per_sec"] for w in windows]
    med_rate = float(np.median(rates))
    for i, w in enumerate(windows):
        if w["scans_per_sec"] >= 0.5 * med_rate:
            continue
        causes = []
        if i == 0:
            causes.append("fused-step batch compile")
        if w.get("graph_grew"):
            causes.append(f"graph growth {w['graph_grew']}")
        if w.get("closures"):
            causes.append(f"{w['closures']} closures applied")
        st_d = w.get("stages", {})
        if st_d:
            top = max(st_d, key=lambda k: st_d[k]["total_s"])
            causes.append(f"top stage {top} {st_d[top]['total_s']}s")
        w["slow_cause"] = "; ".join(causes) or "unattributed"

    traj = slam.flush()
    ate = synthetic.ate_rmse(traj[:, 0], traj[:, 1:4], sim.gt_stamps,
                             sim.gt_pos)

    # ---- descriptor place-recognition recall/precision vs ground truth --
    # Node n <-> n-th keyframe in trajectory order (hand-off is lossless:
    # sync_lost_keyframes == 0 is asserted below). A query is a POSITIVE
    # when a >= min_gap-older keyframe truly lies within 3 m (gt); a HIT
    # when the returned candidate is truly within 5 m at score >= thresh.
    gt_of = lambda t: np.stack(
        [np.interp(t, sim.gt_stamps, sim.gt_pos[:, k]) for k in range(3)],
        -1)
    kf_stamps = np.asarray([e.stamp for e in slam.odometry.trajectory
                            if e.is_keyframe])
    node_gt = gt_of(kf_stamps)
    n_nodes_h = int(jax.device_get(slam.graph.n_nodes))
    positives = hits = matches = true_matches = 0
    min_gap = 15
    for qrec in slam.desc_log:
        n, cand, score = qrec["node"], qrec["cand"], qrec["score"]
        if n >= len(node_gt):
            continue
        old = node_gt[: max(n - min_gap + 1, 0)]
        is_pos = len(old) and (np.linalg.norm(
            old - node_gt[n], axis=-1).min() < 3.0)
        matched = (cand >= 0 and score >= slam.desc_min_score
                   and cand < len(node_gt))
        is_true = matched and (np.linalg.norm(
            node_gt[cand] - node_gt[n]) < 5.0)
        positives += bool(is_pos)
        hits += bool(is_pos and is_true)
        matches += bool(matched)
        true_matches += bool(is_true)
    # ROC sweep over the logged best-candidate scores: what recall /
    # precision each threshold would yield on THIS run (the km-scale
    # drifted data VERDICT r3 asked the threshold to be calibrated on).
    labeled = []
    for qrec in slam.desc_log:
        n, cand, score = qrec["node"], qrec["cand"], qrec["score"]
        if n >= len(node_gt) or cand < 0 or cand >= len(node_gt):
            continue
        old = node_gt[: max(n - min_gap + 1, 0)]
        is_pos = len(old) and (np.linalg.norm(
            old - node_gt[n], axis=-1).min() < 3.0)
        is_true = np.linalg.norm(node_gt[cand] - node_gt[n]) < 5.0
        labeled.append((score, bool(is_pos), bool(is_true)))
    roc = {}
    for t in (0.45, 0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8):
        n_pos_t = sum(1 for _, p, _ in labeled if p)
        rec_t = (sum(1 for s, p, tr in labeled if p and tr and s >= t)
                 / n_pos_t) if n_pos_t else None
        n_m = sum(1 for s, _, _ in labeled if s >= t)
        prec_t = (sum(1 for s, _, tr in labeled if s >= t and tr)
                  / n_m) if n_m else None
        roc[str(t)] = [None if rec_t is None else round(rec_t, 3),
                       None if prec_t is None else round(prec_t, 3)]
    desc_stats = {
        "descriptor_queries": len(slam.desc_log),
        "descriptor_positives": positives,
        "descriptor_recall": round(hits / positives, 3) if positives
        else None,
        "descriptor_precision": round(true_matches / matches, 3) if matches
        else None,
        "descriptor_score_roc": roc,
        "descriptor_min_score": slam.desc_min_score,
    }
    # per-decile aligned error profile (locates divergence in time)
    gt_i = np.stack([np.interp(traj[:, 0], sim.gt_stamps, sim.gt_pos[:, k])
                     for k in range(3)], -1)
    est, gtc = traj[:, 1:4], gt_i
    mu_e, mu_g = est.mean(0), gtc.mean(0)
    H = (est - mu_e).T @ (gtc - mu_g)
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    al = ((Vt.T @ S @ U.T) @ (est - mu_e).T).T + mu_g
    seg_err = np.linalg.norm(al - gtc, axis=-1)
    dec = max(1, len(seg_err) // 10)
    ate_profile = [round(float(seg_err[i:i + dec].mean()), 3)
                   for i in range(0, len(seg_err), dec)][:10]
    np.savez(os.environ.get("SOAK_TRAJ", "/tmp/soak_traj.npz"),
             traj=traj, gt_stamps=sim.gt_stamps, gt_pos=sim.gt_pos)
    st = slam.odometry.state
    surf = slam.surface_points(min_weight=0.5)
    span = (surf[:, :2].max(0) - surf[:, :2].min(0)).tolist() if len(surf) \
        else [0.0, 0.0]

    steady = [w["scans_per_sec"] for w in windows[1:]] or \
             [w["scans_per_sec"] for w in windows]
    archive_blocks = [b["archive_blocks"] for b in blocks_log]
    closure_secs = sorted(c["seconds"] for c in blocks_log) or [0.0]
    closure_p95 = closure_secs[min(int(0.95 * len(closure_secs)),
                                   len(closure_secs) - 1)]
    result = {
        "artifact": "long-soak SLAM run (scripts/soak.py)",
        "backend": jax.default_backend(),
        "scans": n_scans,
        "wall_seconds": round(wall, 1),
        "warmup_seconds": round(warmup_s, 1),
        "compile_cache_dir": cache_dir,
        "loop_raced": slam.loop_raced,
        "scans_per_sec_overall": round(n_scans / wall, 2),
        # steady state = median window after the first (the first window
        # absorbs the fused-step K-batch compile, ~40-60 s — warmup()
        # covers the closure stack, not the scan program itself)
        "scans_per_sec_steady": round(float(np.median(
            [w["scans_per_sec"] for w in windows[1:]] or
            [w["scans_per_sec"] for w in windows])), 2),
        "windows": windows,
        # Degradation = the TREND: median of the second-half windows vs
        # median of the first half (post-compile). Robust both to
        # single-window spikes (a window can absorb a growth compile or a
        # host stall) and to the max-statistic bias of comparing
        # against the luckiest windows.
        "sustained_no_degradation": bool(
            float(np.median(steady[len(steady) // 2:]))
            >= 0.7 * float(np.median(steady[: len(steady) // 2])))
        if len(steady) >= 4 else (bool(steady[-1] >= 0.7 * max(steady))
                                  if steady else None),
        "reg_rejected": int(jax.device_get(st.reg_rejected)),
        "kf_total": int(jax.device_get(st.kf_total)),
        "kf_resident_capacity": cfg.capacity.max_keyframes,
        "eviction_active": bool(int(jax.device_get(st.kf_total))
                                > cfg.capacity.max_keyframes),
        "graph_nodes": int(jax.device_get(slam.graph.n_nodes)),
        "graph_node_capacity": slam.graph.node_q.shape[0],
        "graph_edges": int(jax.device_get(slam.graph.n_edges)),
        "cg_path": int(jax.device_get(slam.graph.n_nodes)) > 192,
        "loop_closures_applied": slam.loop_closures,
        "loop_closures_descriptor": slam.loop_closures_descriptor,
        "loop_rejected_budget": slam.loop_rejected_budget,
        "loop_skipped_small": slam.loop_skipped_small,
        "closure_log": blocks_log,
        "closure_seconds_p95": round(closure_p95, 3),
        "archived_keyframes": len(slam.archive) if slam.archive else 0,
        "sync_lost_keyframes": slam.sync_lost_keyframes,
        "kf_total_minus_graph_nodes": int(jax.device_get(st.kf_total))
        - int(jax.device_get(slam.graph.n_nodes)),
        **desc_stats,
        "stage_table": {
            k: {"calls": slam.stages.counts[k],
                "total_s": round(slam.stages.totals[k], 2),
                "mean_ms": round(slam.stages.mean_ms(k), 1)}
            for k in sorted(slam.stages.totals,
                            key=lambda k: -slam.stages.totals[k])},
        "archive_blocks_monotone": bool(
            all(b2 >= b1 for b1, b2 in zip(archive_blocks,
                                           archive_blocks[1:]))),
        "checkpoint_resume_bitwise": resume_ok,
        "ate_rmse_m": round(ate, 4),
        "ate_profile_deciles": ate_profile,
        "surface_points": int(len(surf)),
        "surface_span_xy_m": [round(s, 1) for s in span],
    }
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if k not in ("windows", "closure_log")}, indent=1))
    ok = (result["eviction_active"]
          and result["graph_nodes"] > (16 if tiny else 192)
          and result["loop_closures_applied"] >= (1 if tiny else 3)
          and result["checkpoint_resume_bitwise"]
          and result["archive_blocks_monotone"]
          and result["sync_lost_keyframes"] == 0)
    print(f"SOAK {'OK' if ok else 'FAILED'}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
