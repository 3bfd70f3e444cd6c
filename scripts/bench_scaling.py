"""Multi-device scaling benchmark: batch-sharded odometry throughput.

BASELINE.md's scaling target (>= 70% frames/s efficiency at N >= 2) over
the data-parallel axis (parallel/batch: B independent sequences, batch axis
sharded over the mesh, no collectives). For each device count D in a
doubling ladder up to the available devices, runs B = D sequences and
slope-times the steady state, reporting total scans/s and the efficiency
vs the single-device rate.

On four GPUs this IS the scaling run; on the virtual CPU mesh
(XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu) it
validates the harness + shardings end-to-end (CPU "efficiency" is not a
device number — virtual devices share host cores).

Prints one JSON line per D plus a summary line.

Env: SCALE_TINY=1 (small capacities for CPU), SCALE_STEPS=N.
"""

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from noetic_slam_tpu.config.params import CapacityConfig, DlioConfig
from noetic_slam_tpu.models.odometry import StepInput
from noetic_slam_tpu.parallel import batch as pbatch
from noetic_slam_tpu.parallel.mesh import make_mesh
from noetic_slam_tpu.runtime.profiling import slope_timer


def make_inputs(cfg, B, seed=0):
    """Stacked (B, ...) StepInput with a surface-like scene per sequence."""
    rng = np.random.default_rng(seed)
    cap = cfg.capacity
    n = cap.max_points
    pts, imus, scs = [], [], []
    for b in range(B):
        ang = rng.uniform(0, 2 * np.pi, n)
        wall = rng.random(n) < 0.6
        r = np.where(wall, 8.0 + rng.normal(scale=0.02, size=n),
                     rng.uniform(2.0, 7.5, n))
        z = np.where(wall, rng.uniform(-0.5, 2.0, n),
                     -0.5 + rng.normal(scale=0.02, size=n))
        xyz = np.stack([r * np.cos(ang), r * np.sin(ang), z],
                       -1).astype(np.float32)
        t = np.sort((rng.integers(0, 128, n) * (0.1 / 128))
                    .astype(np.float32))
        p = np.zeros((n, 4), np.float32)
        p[:, :3] = xyz
        p[:, 3] = t
        m = cap.max_imu_window
        imu = np.zeros((m, 7), np.float32)
        imu[:, 0] = np.arange(m) * 0.01 - 0.12
        imu[:, 6] = 9.80665
        pts.append(p)
        imus.append(imu)
        scs.append(np.array([0.1, 1.0, m, 0.0], np.float32))
    return StepInput(points=jnp.asarray(np.stack(pts)),
                     imu=jnp.asarray(np.stack(imus)),
                     scalars=jnp.asarray(np.stack(scs)))


def run_at(cfg, devices, n_steps):
    D = len(devices)
    B = D
    mesh = make_mesh(D, axis="batch", devices=devices)
    step, _ = pbatch.make_batched_odometry_step(cfg, mesh=mesh,
                                                batch_axis="batch")
    state = pbatch.shard_batched(
        mesh, pbatch.init_batched_state(cfg, B), "batch")
    inp0 = pbatch.shard_batched(mesh, make_inputs(cfg, B), "batch")

    holder = {"state": state}

    def run_window(k):
        st = holder["state"]
        for j in range(k):
            inp = inp0._replace(
                points=inp0.points + np.float32(j * 1e-6),
                scalars=inp0.scalars)
            st, _out = step(st, inp)
        holder["state"] = st
        return float(jnp.sum(st.lidar_p))

    sec = slope_timer(run_window, n1=2, n2=max(4, n_steps))
    return {"devices": D, "sequences": B,
            "ms_per_step": round(sec * 1e3, 3),
            "total_scans_per_sec": round(B / sec, 2)}


def main():
    tiny = os.environ.get("SCALE_TINY") == "1" or jax.default_backend() == "cpu"
    n_steps = int(os.environ.get("SCALE_STEPS", "6"))
    if tiny:
        cap = CapacityConfig(max_points=2048, max_ds_points=1024,
                             max_deskew_frames=256, max_imu_window=64,
                             max_keyframes=32, max_submap_kf=4)
    else:
        cap = CapacityConfig(max_points=32768, max_ds_points=8192,
                             max_deskew_frames=2048, max_imu_window=128,
                             max_keyframes=128, max_submap_kf=8)
    cfg = DlioConfig(capacity=cap, adaptive=False)

    devs = jax.devices()
    ladder = []
    d = 1
    while d <= len(devs):
        ladder.append(d)
        d *= 2
    results = []
    for D in ladder:
        r = run_at(cfg, devs[:D], n_steps)
        results.append(r)
        print(json.dumps(r))
    base = results[0]["total_scans_per_sec"]
    for r in results[1:]:
        eff = r["total_scans_per_sec"] / (base * r["devices"])
        print(json.dumps({"devices": r["devices"],
                          "scaling_efficiency": round(eff, 3)}))

    # Communication budget of the map-sharded registration alternative at
    # these shapes (the batch axis above has no collectives): the per-align
    # all-REDUCE bytes the ICI must carry per device — FLAT in device
    # count since the r4 (pmin, pmin, masked-psum) winner reduction
    # (formula pinned vs compiled HLO in tests/test_parallel.py; the r3
    # all-gather design grew 1.3/3.9/9.2 MB per align at D = 2/4/8).
    from noetic_slam_tpu.parallel.registration import (
        collective_traffic_per_align)

    for D in ladder[1:]:
        t = collective_traffic_per_align(cfg.gicp, cap.max_ds_points, D)
        print(json.dumps({"devices": D, "map_sharded_gicp": {
            "per_relinearize_reduce_recv_MB":
                round(t["per_relinearize_reduce_recv_bytes"] / 1e6, 3),
            "per_align_recv_MB_max":
                round(t["per_align_recv_bytes_max"] / 1e6, 2),
            "flat_in_devices": t["flat_in_devices"]}}))


if __name__ == "__main__":
    main()
