"""Benchmark: odometry scans/sec on one chip (synthetic replay).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

``vs_baseline`` IS A REAL-TIME FACTOR (the key name is fixed by the driver
schema): the reference's operating point is online at the LiDAR sensor
rate, 10 Hz (src/ouster/launch/driver.launch:15-21; the repo publishes no
benchmark table — BASELINE.md), so vs_baseline = scans_per_sec / 10.
``extras.vs_baseline_semantics`` states this in-band.

Throughput numbers reported:
- ``value`` / K=8 replay: micro-batched throughput (one dispatch per 8
  scans) — the replay/batch operating point; adds ~K/rate of latency.
- ``extras.online_*``: K=1 per-scan submission — the reference's online
  node operating point (per-scan ms display, odom.cc:1966-1971) — with
  p50/p95 per-scan latency measured INCLUDING a per-scan dependent pose
  fetch (what a live consumer experiences).
- ``extras.slam_fused_scans_per_sec``: odometry + TSDF fusion in one
  jitted program (make_slam_step) — the device kernel ceiling of the
  `cli slam` step.
- ``extras.slam_system_scans_per_sec``: the COMPLETE SlamSystem — fused
  step + per-batch keyframe sync + archive fusion + descriptor
  extraction/matching + loop closures, overall wall clock. This is the
  number `cli slam` actually sustains end-to-end (>= 10 = real time at
  the sensor rate).

``extras.roofline``: achieved GFLOP/s / GB/s and %-of-peak for the NN and
TSDF kernels measured in-run (peaks: runtime/profiling.CHIP_PEAKS; an
unknown device is an error).

Env knobs: BENCH_TINY=1 (CPU smoke test), BENCH_SCANS=N (default 180),
BENCH_SKIP_ROOFLINE=1, BENCH_SKIP_ONLINE=1.
"""

import json
import os
import sys
import time

import numpy as np


def main():
    tiny = os.environ.get("BENCH_TINY") == "1"
    n_scans = int(os.environ.get("BENCH_SCANS", "20" if tiny else "180"))

    import jax

    from noetic_slam_tpu.config.params import CapacityConfig, DlioConfig
    from noetic_slam_tpu.runtime import compile_cache
    from noetic_slam_tpu.runtime.pipeline import OdometryPipeline

    compile_cache.enable()
    from noetic_slam_tpu.utils import synthetic

    if tiny:
        cap = CapacityConfig(
            max_points=2048, max_ds_points=1024, max_deskew_frames=512,
            max_imu_window=64, max_keyframes=32, max_submap_kf=8)
        n_pts = 2048
    else:
        # Production capacities: OS1-64-class scans (~65k raw points,
        # ~8k after 0.25 m voxel downsample). max_submap_kf=32 holds the
        # FULL reference-equivalent selection (knn+kcv+kcc = 30 distinct
        # keyframes max); bench asserts zero submap overflow below.
        cap = CapacityConfig(
            max_points=32768, max_ds_points=8192, max_deskew_frames=2048,
            max_imu_window=128, max_keyframes=128, max_submap_kf=32)
        n_pts = 32768
    # Fixed 0.5 m keyframe spacing: the submap reaches its full
    # max_submap_kf occupancy within the warmup so the steady state being
    # timed carries a production-shaped registration target.
    from noetic_slam_tpu.config.params import KeyframeConfig

    cfg = DlioConfig(capacity=cap, adaptive=False,
                     keyframe=KeyframeConfig(thresh_dist=0.5))

    dur = n_scans / 10.0 + 0.3
    sim = synthetic.make_sim(duration=dur, n_points=n_pts, calib_time=3.1,
                             seed=7)

    # Pre-generate all scans (host-side data prep excluded from timing).
    scans = [sim.scan(i) for i in range(min(n_scans, len(sim.scan_stamps)))]

    pipe = OdometryPipeline(cfg)
    imu_i = 0

    def feed_imu(through):
        nonlocal imu_i
        while (imu_i < len(sim.imu_stamps)
               and sim.imu_stamps[imu_i] <= through):
            pipe.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                          sim.imu_acc[imu_i])
            imu_i += 1

    # Timing: each window ends with a dependent scalar fetch, and the
    # steady-state rate comes from the SLOPE between a short and a long
    # window, which cancels the fixed fetch overhead.
    import jax.numpy as jnp

    K = min(int(os.environ.get("BENCH_BATCH", "8")), max(1, len(scans) // 16))

    def run_window(lo, hi):
        # micro-batched submission (one upload + one dispatch per K scans)
        for b0 in range(lo, hi, K):
            chunk = scans[b0: min(b0 + K, hi)]
            feed_imu(max(h + pt.max() for h, _, pt in chunk) + 0.02)
            pipe.process_scans([(h, xyz, pt) for h, xyz, pt in chunk])
        return float(jnp.sum(pipe.state.lidar_p))  # dependent fetch

    # Windows are whole K-multiples so every timed dispatch reuses the one
    # compiled K-batch program (warmup covers compile + bootstrap). THREE
    # consecutive windows (sizes a < b < c) give three pairwise slope
    # estimates whose MEDIAN survives a single host stall landing inside
    # one window.
    w0 = 2 * K
    rem = (len(scans) - w0) // K * K
    a = max(K, rem // 6 // K * K)
    b, c = 2 * a, 3 * a
    run_window(0, w0)                    # compile + bootstrap
    t0 = time.perf_counter()
    run_window(w0, w0 + a)
    t1 = time.perf_counter()
    run_window(w0 + a, w0 + a + b)
    t2 = time.perf_counter()
    run_window(w0 + a + b, w0 + a + b + c)
    t3 = time.perf_counter()
    Ta, Tb, Tc = t1 - t0, t2 - t1, t3 - t2
    n_timed = a + b + c
    slopes = [(Tb - Ta) / (b - a), (Tc - Tb) / (c - b),
              (Tc - Ta) / (c - a)]
    print(f"# k8 windows s: {Ta:.2f}/{a} {Tb:.2f}/{b} {Tc:.2f}/{c} "
          f"slopes ms: {[round(s * 1e3, 2) for s in slopes]}",
          file=sys.stderr)
    ms_per_scan = sorted(slopes)[1] * 1e3
    scans_per_sec = 1e3 / ms_per_scan

    traj = pipe.flush()
    ate = synthetic.ate_rmse(traj[:, 0], traj[:, 1:4], sim.gt_stamps,
                             sim.gt_pos)

    # TSDF fusion throughput (odometry output stream -> map), measured
    # separately on the same scans (slope method again).
    from noetic_slam_tpu.models import tsdf as tsdf_mod

    tcfg = cfg.tsdf

    # Pre-stage scans on device so the upload is not billed to the TSDF
    # rate: the timed quantity is the DEVICE integration rate
    # (profile_tsdf.py's basis); a per-call on-device perturbation keeps
    # every scan's data fresh.
    base_dev = [jnp.asarray(scans[i][1][: cap.max_points])
                for i in range(min(len(scans), 17))]
    ones_dev = jnp.ones((base_dev[0].shape[0],), bool)

    def run_tsdf(st, lo, hi):
        for i in range(lo, hi):
            pts = base_dev[i % len(base_dev)] + jnp.float32(0.001 * i)
            st = tsdf_mod.integrate(tcfg, st, pts, ones_dev,
                                    jnp.zeros(3))
        # close the window with a PAYLOAD-dependent fetch (num_blocks alone
        # depends only on the directory ops, not the voxel update).
        return st, float(jnp.sum(st.weight[:, 0]))

    tstate = tsdf_mod.init_tsdf(tcfg)
    tstate, _ = run_tsdf(tstate, 0, 2)
    t0 = time.perf_counter()
    tstate, _ = run_tsdf(tstate, 2, 7)
    t1 = time.perf_counter()
    tstate, _ = run_tsdf(tstate, 7, 17)
    t2 = time.perf_counter()
    tsdf_per_sec = 1.0 / max(((t2 - t1) - (t1 - t0)) / 5, 1e-9)

    # ---- Online (K=1) operating point + per-scan latency percentiles ----
    # The reference runs online at the sensor rate displaying per-scan ms
    # (odom.cc:1966-1971); this is that operating point: one submission per
    # scan. Rate comes from the slope method (fixed fetch overhead
    # cancelled); latency percentiles are measured with a dependent
    # per-scan pose fetch INCLUDED (what a live consumer of this transport
    # experiences end-to-end).
    online = {}
    if os.environ.get("BENCH_SKIP_ONLINE") != "1":
        n_on = 24 if tiny else 96
        sim2 = synthetic.make_sim(duration=n_on / 10.0 + 0.4,
                                  n_points=n_pts, calib_time=3.1, seed=11)
        scans2 = [sim2.scan(i)
                  for i in range(min(n_on, len(sim2.scan_stamps)))]
        pipe2 = OdometryPipeline(cfg)
        imu_j = 0

        def feed2(through):
            nonlocal imu_j
            while (imu_j < len(sim2.imu_stamps)
                   and sim2.imu_stamps[imu_j] <= through):
                pipe2.push_imu(sim2.imu_stamps[imu_j], sim2.imu_ang[imu_j],
                               sim2.imu_acc[imu_j])
                imu_j += 1

        feed2(1e9)

        def run_k1(lo, hi):
            for i in range(lo, hi):
                h, xyz, pt = scans2[i]
                pipe2.process_scan(h, xyz, pt)
            return float(jnp.sum(pipe2.state.lidar_p))

        ow0 = min(6, len(scans2) // 4)
        a1 = max(2, (len(scans2) - ow0) // 5)
        a2 = min(2 * a1, len(scans2) - ow0 - a1 - 8)
        run_k1(0, ow0)                      # compile + bootstrap
        t0 = time.perf_counter()
        run_k1(ow0, ow0 + a1)
        t1 = time.perf_counter()
        run_k1(ow0 + a1, ow0 + a1 + a2)
        t2 = time.perf_counter()
        k1_ms = ((t2 - t1) - (t1 - t0)) / max(a2 - a1, 1) * 1e3
        lat = []
        for i in range(ow0 + a1 + a2, len(scans2)):
            h, xyz, pt = scans2[i]
            t0 = time.perf_counter()
            out = pipe2.process_scan(h, xyz, pt)
            float(jnp.sum(out.lidar_p))     # dependent per-scan fetch
            lat.append(time.perf_counter() - t0)
        lat_a = np.asarray(lat[1:]) if len(lat) > 1 else np.asarray(lat)
        online = {
            "online_scans_per_sec_k1": round(1e3 / max(k1_ms, 1e-9), 2),
            "online_latency_ms_p50": round(
                float(np.percentile(lat_a, 50)) * 1e3, 2),
            "online_latency_ms_p95": round(
                float(np.percentile(lat_a, 95)) * 1e3, 2),
            "online_latency_includes_fetch": True,
        }

    # ---- Fused odometry+TSDF (make_slam_step) — the `cli slam` rate ----
    slam_fused = {}
    if os.environ.get("BENCH_SKIP_SLAM") != "1":
        pipe3 = OdometryPipeline(cfg, with_tsdf=True)
        imu_k = 0

        def feed3(through):
            nonlocal imu_k
            while (imu_k < len(sim.imu_stamps)
                   and sim.imu_stamps[imu_k] <= through):
                pipe3.push_imu(sim.imu_stamps[imu_k], sim.imu_ang[imu_k],
                               sim.imu_acc[imu_k])
                imu_k += 1

        def run_fused(lo, hi):
            for b0 in range(lo, hi, K):
                chunk = scans[b0: min(b0 + K, hi)]
                feed3(max(h + pt.max() for h, _, pt in chunk) + 0.02)
                pipe3.process_scans([(h, xyz, pt) for h, xyz, pt in chunk])
            return (float(jnp.sum(pipe3.state.lidar_p))
                    + float(jnp.sum(pipe3.tsdf_state.weight[:, 0])))

        # independent whole-K windows (the odometry section's names are
        # not reused — a shared mutable name cost r03 a compile landing
        # inside a timed window)
        fw0 = 2 * K
        fn1 = max(K, (len(scans) - fw0) // 4 // K * K)
        fn2 = max(K, min(3 * fn1, (len(scans) - fw0 - fn1) // K * K))
        run_fused(0, fw0)                   # compile + bootstrap
        t0 = time.perf_counter()
        run_fused(fw0, fw0 + fn1)
        t1 = time.perf_counter()
        run_fused(fw0 + fn1, fw0 + fn1 + fn2)
        t2 = time.perf_counter()
        fused_ms = ((t2 - t1) - (t1 - t0)) / (fn2 - fn1) * 1e3
        slam_fused = {"slam_fused_scans_per_sec": round(
            1e3 / max(fused_ms, 1e-9), 2)}

    # ---- WHOLE-SYSTEM rate: SlamSystem end-to-end ----
    # The number `cli slam` actually sustains: fused odometry+TSDF step
    # PLUS per-batch keyframe sync (outbox drain), archive fusion,
    # descriptor extraction+matching, and loop-closure attempts — ALL
    # keyframe-rate host work included (the kernel rates above exclude
    # it).
    # Overall wall over a steady multi-lap stretch, closures firing.
    slam_system = {}
    if os.environ.get("BENCH_SKIP_SYSTEM") != "1":
        from noetic_slam_tpu.config.params import (KeyframeConfig as KC,
                                                   TsdfConfig as TC)
        from noetic_slam_tpu.runtime.slam import SlamSystem
        from noetic_slam_tpu.utils.synthetic import spiral_pose_of

        n_sys = 48 if tiny else 240
        cap4 = CapacityConfig(
            max_points=2048 if tiny else 8192,
            max_ds_points=1024 if tiny else 4096,
            max_deskew_frames=512 if tiny else 1024,
            max_imu_window=64 if tiny else 128,
            max_keyframes=32 if tiny else 128,
            max_submap_kf=8 if tiny else 16, max_trajectory=4096)
        cfg4 = DlioConfig(
            capacity=cap4, adaptive=False,
            keyframe=KC(thresh_dist=0.5, thresh_rot=45.0),
            tsdf=TC(voxel_size=0.2, truncation=0.6,
                    max_blocks=4096 if tiny else 16384,
                    space_carving=False,
                    scan_block_cap=1024 if tiny else 2048))
        sim4 = synthetic.make_sim(
            duration=n_sys / 10.0 + 0.4, n_points=cap4.max_points,
            calib_time=3.1, seed=23, pose_fn=spiral_pose_of,
            imu_noise=0.0005)
        scans4 = [sim4.scan(i)
                  for i in range(min(n_sys, len(sim4.scan_stamps)))]
        slam4 = SlamSystem(cfg4, enable_tsdf=True, enable_loop_closure=True,
                           loop_radius=4.0, loop_min_gap=15, pipelined=True)
        imu_m = 0

        def feed4(through):
            nonlocal imu_m
            while (imu_m < len(sim4.imu_stamps)
                   and sim4.imu_stamps[imu_m] <= through):
                slam4.push_imu(sim4.imu_stamps[imu_m], sim4.imu_ang[imu_m],
                               sim4.imu_acc[imu_m])
                imu_m += 1

        def run_system(lo, hi):
            for b0 in range(lo, hi, K):
                chunk = scans4[b0: min(b0 + K, hi)]
                feed4(max(h + pt.max() for h, _, pt in chunk) + 0.02)
                slam4.process_scans([(h, xyz, pt) for h, xyz, pt in chunk])
                # sync rides maybe_close_loop's PIPELINED drain (3-batch
                # cadence = ~16 new keyframes, inside the 64-slot outbox
                # losslessness contract; the gather's D2H copy has 3
                # batches of device work to hide behind)
                if b0 % (3 * K) == 0 and b0 > 0:
                    slam4.maybe_close_loop()
            return float(jnp.sum(slam4.odometry.state.lidar_p))

        sw0 = 4 * K
        slam4.warmup()                      # closure-stack compiles
        run_system(0, sw0)                  # compile + bootstrap
        t0 = time.perf_counter()
        run_system(sw0, len(scans4))
        t1 = time.perf_counter()
        slam_system = {
            "slam_system_scans_per_sec": round(
                (len(scans4) - sw0) / (t1 - t0), 2),
            "slam_system_includes":
                "fused step + sync + archive + descriptors + closures",
            "slam_system_closures": slam4.loop_closures,
            "slam_system_lost_keyframes": slam4.sync_lost_keyframes,
            "slam_system_raced_attempts": slam4.loop_raced,
        }

    # ---- In-run roofline lines ----
    roofline = {}
    if os.environ.get("BENCH_SKIP_ROOFLINE") != "1" and not tiny:
        from noetic_slam_tpu.ops import neighbors
        from noetic_slam_tpu.ops.pointcloud import morton_sort_key
        from noetic_slam_tpu.runtime.profiling import chip_peaks, slope_timer

        peaks, chip = chip_peaks()
        rngr = np.random.default_rng(0)
        n_t, n_q = 65536, 8192
        planes = rngr.integers(0, 6, n_t)
        tpts = rngr.uniform(-30, 30, (n_t, 3)).astype(np.float32)
        for ax in range(3):
            tpts[planes == ax, ax] = -30.0
            tpts[planes == ax + 3, ax] = 30.0
        mk = morton_sort_key(jnp.asarray(tpts), jnp.ones((n_t,), bool), 1.0)
        tgt = jnp.asarray(tpts[np.argsort(np.asarray(mk), kind="stable")])

        def f_nn(c):
            q = tgt[:n_q] + c * 1e-4 + 0.02
            idx, sqd = neighbors.nn1(q, tgt, jnp.int32(n_t),
                                     max_dist=jnp.float32(0.5))
            return c + jnp.sum(sqd) * 1e-12 + idx[0] * 1e-12
        f_nn = jax.jit(f_nn)

        def run_nn(k):
            y = jnp.float32(0.0)
            for i in range(k):
                y = f_nn(y + np.float32(i) * np.float32(1e-6))
            return float(y)

        # long windows + median-of-3: the per-call time is small against
        # host timing jitter
        nn_sec = sorted(slope_timer(run_nn, n1=8, n2=32)
                        for _ in range(3))[1]
        nn_gflops = 8.0 * n_q * n_t / nn_sec / 1e9

        # TSDF integrate basis from the measurement above: lower-bound
        # traffic = 1R+1W of the 4-stream sample payload + touched rows.
        n_band = int(round(2.0 * tcfg.truncation / tcfg.voxel_size)) + 1
        S_samp = cap.max_points * (n_band + (tcfg.carving_samples
                                             if tcfg.space_carving else 0))
        nb = int(jax.device_get(tstate.num_blocks))
        tsdf_ms = 1e3 / max(tsdf_per_sec, 1e-9)
        tsdf_bytes = 2 * S_samp * 16 + nb * 512 * 4 * 2 * 2
        tsdf_gbps = tsdf_bytes / (tsdf_ms * 1e-3) / 1e9
        roofline = {
            "chip": chip,
            "peak_f32_tflops": peaks[1],
            "peak_hbm_gbps": peaks[2],
            "nn1_capped_8192x65536_ms": round(nn_sec * 1e3, 3),
            "nn1_dense_equiv_gflops": round(nn_gflops, 1),
            "nn1_pct_f32_peak": round(nn_gflops / (peaks[1] * 1e3) * 100, 2),
            "nn1_flops_basis": "dense-equivalent (kernel prunes; floor)",
            "tsdf_integrate_ms": round(tsdf_ms, 3),
            "tsdf_lower_bound_gbps": round(tsdf_gbps, 1),
            "tsdf_pct_hbm_peak": round(tsdf_gbps / peaks[2] * 100, 2),
            "tsdf_bytes_basis": "1R+1W sample streams + touched rows (floor)",
        }

    # Real-ingest ATE on the committed MulRan-format fixture (the BASELINE
    # primary accuracy metric, through the real CSV/bin parsers + replay).
    mulran_ate = None
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "mulran_mini")
    if os.path.isdir(fixture) and not tiny:
        from noetic_slam_tpu.config.params import CapacityConfig as CC
        from noetic_slam_tpu.config.params import DlioConfig as DC
        from noetic_slam_tpu.io.mulran import MulranDataset
        from noetic_slam_tpu.io.replay import replay_dataset

        ds = MulranDataset.load(fixture)
        mp = OdometryPipeline(DC(capacity=CC(
            max_points=2048, max_ds_points=1024, max_deskew_frames=128,
            max_imu_window=64, max_keyframes=64, max_submap_kf=32,
            max_trajectory=512)))
        replay_dataset(ds, mp, rate=0.0, batch=8)
        mtraj = mp.flush()
        mulran_ate = synthetic.ate_rmse(mtraj[:, 0], mtraj[:, 1:4],
                                        ds.gt_stamps, ds.gt_poses[:, :, 3])

    result = {
        "metric": "odometry_scans_per_sec_1chip",
        "value": round(scans_per_sec, 3),
        "unit": "scans/s",
        "vs_baseline": round(scans_per_sec / 10.0, 3),
        "extras": {
            "vs_baseline_semantics":
                "realtime_factor_vs_10hz_sensor_rate (driver.launch:15-21)",
            "tsdf_integrations_per_sec": round(tsdf_per_sec, 1),
            "ate_rmse_m_synthetic": round(ate, 4),
            "ate_rmse_m_mulran_fixture": (None if mulran_ate is None
                                          else round(mulran_ate, 4)),
            "submap_overflow": pipe.submap_overflow,
            **online,
            **slam_fused,
            **slam_system,
            **({"roofline": roofline} if roofline else {}),
        },
    }
    print(json.dumps(result))
    print(f"# ate_rmse_m={ate:.4f} n_timed={n_timed} "
          f"keyframes={int(pipe.state.kf_count)} "
          f"submap_overflow={pipe.submap_overflow} "
          f"tsdf_integrations_per_sec={tsdf_per_sec:.1f} "
          f"online={online} slam_fused={slam_fused} "
          f"slam_system={slam_system} "
          f"backend={jax.default_backend()}", file=sys.stderr)


if __name__ == "__main__":
    main()
