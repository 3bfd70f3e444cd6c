"""Real-chip multi-sequence throughput ladder (VERDICT r4 item #7).

B = 1/2/4/8 synthetic sequences advance in LOCKSTEP through one vmapped
odometry+TSDF step on ONE chip (runtime/multi.MultiSequencePipeline —
the `cli batch` path). This is the throughput-scaling claim measurable
without multi-chip hardware: per-sequence cost amortizes because the
batched step gives the device B x the work per dispatch while the
host/dispatch overhead stays ~flat.

For each B: one compile pass (discarded), then a fresh pipeline re-run
measured warm. All sequences share the same generated scan data so the
ladder compares work, not content. Artifact: BATCH_r05.json with total
scans/s vs B and the amortization ratio.

Run on the chip: python scripts/bench_batch.py
Tiny CPU check:  BATCH_TINY=1 python scripts/bench_batch.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    tiny = os.environ.get("BATCH_TINY") == "1"
    out_path = os.environ.get(
        "BATCH_OUT", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "BATCH_r05.json"))

    import jax

    from noetic_slam_tpu.config.params import (CapacityConfig, DlioConfig,
                                               KeyframeConfig, TsdfConfig)
    from noetic_slam_tpu.runtime import compile_cache
    from noetic_slam_tpu.runtime.multi import (ArrayFeed,
                                               MultiSequencePipeline,
                                               run_lockstep)
    from noetic_slam_tpu.utils import synthetic

    compile_cache.enable()
    if tiny:
        cap = CapacityConfig(
            max_points=2048, max_ds_points=1024, max_deskew_frames=512,
            max_imu_window=64, max_keyframes=16, max_submap_kf=8,
            max_trajectory=2048)
        tsdf = TsdfConfig(voxel_size=0.25, truncation=0.75, max_blocks=2048,
                          space_carving=False, scan_block_cap=512)
        duration, n_pts, ladder = 2.0, 2048, (1, 2)
    else:
        cap = CapacityConfig(
            max_points=8192, max_ds_points=4096, max_deskew_frames=1024,
            max_imu_window=128, max_keyframes=64, max_submap_kf=16,
            max_trajectory=4096)
        tsdf = TsdfConfig(voxel_size=0.2, truncation=0.6, max_blocks=8192,
                          space_carving=False, scan_block_cap=2048)
        duration, n_pts, ladder = 12.0, 8192, (1, 2, 4, 8)
    cfg = DlioConfig(capacity=cap, adaptive=False,
                     keyframe=KeyframeConfig(thresh_dist=0.5,
                                             thresh_rot=45.0),
                     tsdf=tsdf)

    # ONE sim, shared by every sequence of every rung (identical work)
    sim = synthetic.make_sim(duration=duration, calib_time=3.1,
                             n_points=n_pts, seed=77)
    scans = [sim.scan(i) for i in range(len(sim.scan_stamps))]
    n_scans = len(scans)
    print(f"ladder {ladder}, {n_scans} scans/seq, "
          f"backend={jax.default_backend()}", file=sys.stderr)

    def feeds_of(B):
        return [ArrayFeed(sim.imu_stamps, sim.imu_ang, sim.imu_acc,
                          sim.scan_stamps, lambda i, sc=scans: sc[i])
                for _ in range(B)]

    rows = []
    for B in ladder:
        # compile pass (jit cache warms per-B vmapped step)
        mp = MultiSequencePipeline(cfg, n_seq=B)
        run_lockstep(mp, feeds_of(B))
        # warm measured pass on a fresh pipeline
        mp = MultiSequencePipeline(cfg, n_seq=B)
        t0 = time.perf_counter()
        trajs = run_lockstep(mp, feeds_of(B))
        wall = time.perf_counter() - t0
        total = sum(len(t) for t in trajs)
        ate = float(np.mean([synthetic.ate_rmse(
            t[:, 0], t[:, 1:4], sim.gt_stamps, sim.gt_pos)
            for t in trajs if len(t)]))
        rows.append({"B": B, "wall_s": round(wall, 2),
                     "total_scans": total,
                     "scans_per_sec": round(total / wall, 2),
                     "per_seq_scans_per_sec": round(total / wall / B, 2),
                     "mean_ate_m": round(ate, 4)})
        print(rows[-1], file=sys.stderr)

    base = rows[0]["scans_per_sec"]
    result = {
        "artifact": "one-chip multi-sequence lockstep ladder "
                    "(scripts/bench_batch.py; cli batch path)",
        "backend": jax.default_backend(),
        "device": str(jax.devices()[0]),
        "scans_per_seq": n_scans,
        "ladder": rows,
        "amortization_vs_B1": [
            round(r["scans_per_sec"] / base, 2) for r in rows],
    }
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
