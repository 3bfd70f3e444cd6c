"""Per-stage device profiling of the odometry step at production shapes.

Each stage is wrapped as a chained scalar->scalar jitted function: a scalar
carry perturbs the stage inputs (fresh data every call, so nothing is
served from a cache) and the stage result folds back into the carry
(data dependency forces real sequential execution). slope_timer then yields
honest per-call milliseconds with fixed round-trip overhead cancelled.

Run on the real chip:  python scripts/profile_stages.py
Env: STAGES=nn,cov,... to restrict; N_LONG=9 window length.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from noetic_slam_tpu.config.params import CapacityConfig, DlioConfig, KeyframeConfig
from noetic_slam_tpu.ops import gicp as gicp_ops
from noetic_slam_tpu.ops import imu as imu_ops
from noetic_slam_tpu.ops import neighbors
from noetic_slam_tpu.ops.pointcloud import Scan, crop_box, prepare_scan, voxel_downsample
from noetic_slam_tpu.runtime.profiling import slope_timer

N_RAW = 32768
N_DS = 8192
N_TGT = 65536


def make_scene(seed=0):
    rng = np.random.default_rng(seed)
    # surface-like scene: points on a few planes + noise, ~30 m extent
    n = N_TGT
    planes = rng.integers(0, 6, n)
    pts = rng.uniform(-30, 30, (n, 3)).astype(np.float32)
    for ax in range(3):
        sel = planes == ax
        pts[sel, ax] = -30 + rng.normal(0, 0.02, sel.sum())
        sel = planes == ax + 3
        pts[sel, ax] = 30 + rng.normal(0, 0.02, sel.sum())
    return pts


def chain_time(name, f, x0, n1=3, n2=9):
    f = jax.jit(f)
    x = jnp.asarray(x0, jnp.float32)

    def run_window(k):
        y = x
        for i in range(k):
            y = f(y + np.float32(i) * np.float32(1e-6))
        return float(y)

    sec = slope_timer(run_window, n1=n1, n2=int(os.environ.get("N_LONG", n2)))
    print(f"{name:<34} {sec * 1e3:9.3f} ms")
    return sec


def main():
    print(f"backend={jax.default_backend()} devices={jax.devices()}")
    from noetic_slam_tpu.ops.pointcloud import morton_sort_key

    tgt_np = make_scene()
    key = morton_sort_key(jnp.asarray(tgt_np),
                          jnp.ones((N_TGT,), bool), 1.0)
    tgt = jnp.asarray(tgt_np[np.argsort(np.asarray(key), kind="stable")])
    tgt_cov = jnp.tile(jnp.asarray([1, 0, 0, 1, 0, 1e-3], jnp.float32),
                       (N_TGT, 1))
    # Morton-sort the source too: production sources come out of
    # voxel_downsample spatially ordered, and the NN kernel's tile pruning
    # depends on compact query-tile boxes.
    src_np = make_scene(1)[:N_DS]
    skey = morton_sort_key(jnp.asarray(src_np), jnp.ones((N_DS,), bool), 1.0)
    src_base = jnp.asarray(src_np[np.argsort(np.asarray(skey),
                                             kind="stable")])
    raw_base = jnp.asarray(make_scene(2)[:N_RAW])
    valid_ds = jnp.ones((N_DS,), bool)
    valid_raw = jnp.ones((N_RAW,), bool)
    stages = os.environ.get("STAGES", "").split(",") if os.environ.get("STAGES") else None

    def want(s):
        return stages is None or s in stages

    cfg = DlioConfig(capacity=CapacityConfig(
        max_points=N_RAW, max_ds_points=N_DS, max_deskew_frames=2048,
        max_imu_window=128, max_keyframes=128, max_submap_kf=8))

    from noetic_slam_tpu.runtime.profiling import roofline_report

    # Dense-equivalent FLOPs of a 1-NN search: every (query, target) pair
    # costs ~8 flops (3 sub + 3 mul + 2 add for the squared distance). The
    # fused kernel PRUNES tiles (branch-and-bound), so achieved/peak is an
    # UNDERestimate of hardware efficiency — pruned work counts as done.
    NN_DENSE_FLOPS = 8.0 * N_DS * N_TGT

    if want("nn"):
        def f_nn(c):
            q = src_base + c * 1e-4
            idx, sqd = neighbors.nn1(q, tgt, jnp.int32(N_TGT))
            return c + jnp.sum(sqd) * 1e-12 + idx[0] * 1e-12
        sec = chain_time("nn1_fused 8192x65536", f_nn, 0.0)
        print(roofline_report("  roofline (dense-equivalent)", sec,
                              flops=NN_DENSE_FLOPS))

    if want("nncap"):
        def f_nncap(c):
            # production case: queries near the target surface, 0.5 m cap
            q = tgt[:N_DS] + c * 1e-4 + 0.02
            idx, sqd = neighbors.nn1(q, tgt, jnp.int32(N_TGT),
                                     max_dist=jnp.float32(0.5))
            return c + jnp.sum(sqd) * 1e-12 + idx[0] * 1e-12
        sec = chain_time("nn1_fused capped 8192x65536", f_nncap, 0.0)
        print(roofline_report("  roofline (dense-equivalent)", sec,
                              flops=NN_DENSE_FLOPS))

    if want("nn32"):
        def f_nn32(c):
            q = src_base + c * 1e-4
            s = c
            for _ in range(8):
                idx, sqd = neighbors.nn1(q + s * 1e-9, tgt, jnp.int32(N_TGT))
                s = s + jnp.sum(sqd) * 1e-12
            return s
        chain_time("nn1_fused x8 (8 iters)", f_nn32, 0.0)

    if want("cov"):
        def f_cov(c):
            q = src_base + c * 1e-4
            cov, den = gicp_ops.radius_covariances(q, valid_ds, 0.5)
            return c + den * 1e-6 + jnp.sum(cov[0]) * 1e-9
        chain_time("radius_covariances 8192", f_cov, 0.0)

    if want("covknn"):
        def f_covk(c):
            q = src_base + c * 1e-4
            cov, den = gicp_ops.plane_covariances(q, valid_ds, 16)
            return c + den * 1e-6 + jnp.sum(cov[0]) * 1e-9
        chain_time("plane_covariances knn16 8192", f_covk, 0.0)

    if want("gicp"):
        def f_gicp(c):
            # small perturbation start: realistic converge-in-few-iters case
            q = src_base + c * 1e-4
            guess = jnp.eye(4).at[:3, 3].set(jnp.array([0.05, -0.03, 0.02]))
            res = gicp_ops.gicp_align(q, valid_ds, tgt_cov[:N_DS], tgt,
                                      tgt_cov, cfg.gicp, guess=guess,
                                      target_count=jnp.int32(N_TGT))
            return (c + res.error * 1e-9 + res.iterations.astype(jnp.float32)
                    * 1e-6)
        chain_time("gicp_align (converging scene)", f_gicp, 0.0)

        def f_gicp_it(c):
            q = src_base + c * 1e-4
            guess = jnp.eye(4).at[:3, 3].set(jnp.array([0.05, -0.03, 0.02]))
            res = gicp_ops.gicp_align(q, valid_ds, tgt_cov[:N_DS], tgt,
                                      tgt_cov, cfg.gicp, guess=guess,
                                      target_count=jnp.int32(N_TGT))
            return res.iterations.astype(jnp.float32) + c * 0
        it = float(jax.jit(f_gicp_it)(jnp.float32(0.0)))
        print(f"    (gicp outer iterations: {it:.0f})")

    if want("voxel"):
        def f_vox(c):
            q = raw_base + c * 1e-4
            xyz, v, cnt = voxel_downsample(q, valid_raw, 0.25, N_DS)
            return c + jnp.sum(xyz[0]) * 1e-9 + cnt * 1e-9
        chain_time("voxel_downsample 32768->8192", f_vox, 0.0)

    if want("prep"):
        def f_prep(c):
            t = (jnp.linspace(0, 0.1, N_RAW) + c * 1e-9).astype(jnp.float32)
            scan = Scan(raw_base + c * 1e-4, t, valid_raw, jnp.int32(N_RAW))
            scan = crop_box(scan, 1.0)
            prep = prepare_scan(scan, 2048)
            return c + prep.scan_stamp * 1e-6 + jnp.sum(prep.xyz[0]) * 1e-9
        chain_time("crop+prepare_scan 32768", f_prep, 0.0)

    if want("deskew"):
        from noetic_slam_tpu.ops import deskew as deskew_ops
        from noetic_slam_tpu.ops import imu as imu_ops2

        rng = np.random.default_rng(0)
        m = 128
        imu_arr = np.zeros((m, 7), np.float32)
        imu_arr[:, 0] = np.arange(m) * 0.01 - 0.12
        imu_arr[:, 6] = 9.80665
        imu_j = jnp.asarray(imu_arr)
        tq = jnp.asarray(np.sort(rng.random(2048).astype(np.float32)) * 0.1)

        win = imu_ops2.ImuWindow(
            stamps=imu_j[:, 0], ang_vel=imu_j[:, 1:4],
            lin_accel=imu_j[:, 4:7], count=jnp.int32(m))

        def f_imu(c):
            w2 = win._replace(stamps=win.stamps + c * 1e-9)
            q, p, ok = imu_ops2.integrate_imu(
                w2, jnp.float32(0.0), jnp.array([1.0, 0, 0, 0]),
                jnp.zeros(3), jnp.zeros(3), tq)
            return (c + jnp.sum(p[0]) * 1e-9 + jnp.sum(q[-1]) * 1e-9
                    + ok * 1e-9)
        chain_time("integrate_imu 128 -> 2048 frames", f_imu, 0.0)

        def f_deskew(c):
            t = (jnp.linspace(0, 0.1, N_RAW) + c * 1e-9).astype(jnp.float32)
            scan = Scan(raw_base + c * 1e-4, t, valid_raw, jnp.int32(N_RAW))
            prep = prepare_scan(scan, 2048)
            w2 = win._replace(stamps=win.stamps + c * 1e-9)
            q, p, ok = imu_ops2.integrate_imu(
                w2, jnp.float32(0.0), jnp.array([1.0, 0, 0, 0]),
                jnp.zeros(3), jnp.zeros(3), prep.unique_t)
            out = deskew_ops.deskew_points(prep, q, p, jnp.eye(3),
                                           jnp.zeros(3))
            return c + jnp.sum(out[0]) * 1e-9 + ok * 1e-9
        chain_time("prepare+integrate+deskew 32768", f_deskew, 0.0)

    if want("prop"):
        from noetic_slam_tpu.ops import imu as imu_ops3

        m = 128
        st_np = np.zeros((m, 7), np.float32)
        st_np[:, 0] = np.arange(m) * 0.01
        st_np[:, 6] = 9.80665
        stj = jnp.asarray(st_np)
        pwin = imu_ops3.ImuWindow(
            stamps=stj[:, 0], ang_vel=stj[:, 1:4], lin_accel=stj[:, 4:7],
            count=jnp.int32(m))

        def f_prop(c):
            w2 = pwin._replace(stamps=pwin.stamps + c * 1e-9)
            q, p, v = imu_ops3.propagate_state_batch(
                jnp.array([1.0, 0, 0, 0]), jnp.zeros(3), jnp.zeros(3),
                w2, w2.count, 9.80665)
            return c + jnp.sum(p) * 1e-9 + jnp.sum(q) * 1e-9
        chain_time("propagate_state_batch 128", f_prop, 0.0)

    if want("submap"):
        from noetic_slam_tpu.models import odometry as odom_mod

        c3 = DlioConfig(capacity=CapacityConfig(
            max_points=N_RAW, max_ds_points=N_DS, max_deskew_frames=2048,
            max_imu_window=128, max_keyframes=128, max_submap_kf=32))
        st0 = odom_mod.init_state(c3)
        rngs = np.random.default_rng(3)
        kf_xyz = rngs.uniform(-30, 30, (128, N_DS, 3)).astype(np.float32)
        st0 = st0._replace(
            kf_pos=jnp.asarray(rngs.uniform(-20, 20, (128, 3)), jnp.float32),
            kf_xyz=jnp.asarray(kf_xyz),
            kf_valid=jnp.ones((128, N_DS), bool),
            kf_count=jnp.int32(64))

        def f_submap(c):
            st = st0._replace(p=jnp.stack([c * 1e-4, c * 0, c * 0]))
            mask = odom_mod.select_submap_keyframes(c3, st)
            xyz, valid, cov, cnt, _ = odom_mod.gather_submap(c3, st, mask)
            return c + jnp.sum(xyz[0]) * 1e-9 + cnt * 1e-9
        chain_time("select+gather_submap 32x8192", f_submap, 0.0)

    if want("step"):
        from noetic_slam_tpu.runtime.pipeline import OdometryPipeline
        from noetic_slam_tpu.utils import synthetic

        c2 = DlioConfig(capacity=CapacityConfig(
            max_points=N_RAW, max_ds_points=N_DS, max_deskew_frames=2048,
            max_imu_window=128, max_keyframes=128, max_submap_kf=32),
            adaptive=False, keyframe=KeyframeConfig(thresh_dist=0.5))
        sim = synthetic.make_sim(duration=6.0, n_points=N_RAW,
                                 calib_time=3.1, seed=7)
        scans = [sim.scan(i) for i in range(len(sim.scan_stamps))]
        pipe = OdometryPipeline(c2)
        imu_i = 0

        def feed(through):
            nonlocal imu_i
            while (imu_i < len(sim.imu_stamps)
                   and sim.imu_stamps[imu_i] <= through):
                pipe.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                              sim.imu_acc[imu_i])
                imu_i += 1

        feed(1e9)
        i_scan = 0

        def run_window(k):
            nonlocal i_scan
            for _ in range(k):
                h, xyz, pt = scans[i_scan % len(scans)]
                pipe.process_scan(h + i_scan * 0.1, xyz, pt)
                i_scan += 1
            return float(jnp.sum(pipe.state.lidar_p))

        sec = slope_timer(run_window, n1=3, n2=9, warmup=4)
        print(f"{'full odometry step (unbatched)':<34} {sec * 1e3:9.3f} ms")


if __name__ == "__main__":
    main()
