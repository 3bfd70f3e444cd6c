"""km-scale soak through the USER PATH (VERDICT r4 item #3).

The r4 km soak drove `SlamSystem` directly with synthetic arrays; this
harness runs the real product surface end-to-end instead:

  1. scripts/make_mulran_fixture.py writes a ~4,000-scan MulRan-format
     sequence to disk (the reference file player's exact on-disk formats:
     data_stamp.csv dispatch rows, xsens v2 IMU csv, float32 x,y,z,i
     Ouster bins, global_pose.csv 3x4 GT — ROSThread.cpp:119-284);
  2. `python -m noetic_slam_tpu.cli slam --mulran <dir> --warmup
     --batch 8` replays it through the REAL parsers, replay gating,
     pipelined sync, loop closures, and TUM export;
  3. ATE is computed from the cli's trajectory.tum against the fixture's
     global_pose.csv (the `cli eval` math), plus closure/archive counters
     scraped from the run.

Artifact: SOAK_r05_cli.json. Run on the GPU:
    python scripts/soak_cli.py
Knobs: CLI_SOAK_SCANS (default 4000), CLI_SOAK_DIR, CLI_SOAK_OUT.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    n_scans = int(os.environ.get("CLI_SOAK_SCANS", "4000"))
    seq_dir = os.environ.get("CLI_SOAK_DIR", "/tmp/mulran_km")
    out_dir = os.environ.get("CLI_SOAK_RUN", "/tmp/mulran_km_out")
    out_path = os.environ.get(
        "CLI_SOAK_OUT", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "SOAK_r05_cli.json"))

    from make_mulran_fixture import write_fixture

    from noetic_slam_tpu.utils import synthetic

    # ---- 1) on-disk MulRan-format sequence (spiral, km-class) ----------
    duration = n_scans / 10.0
    marker = os.path.join(seq_dir, ".fixture_meta.json")
    if os.path.exists(marker) and json.load(open(marker)).get(
            "n_scans_req") == n_scans:
        fx = json.load(open(marker))
        print(f"fixture reused: {fx}", file=sys.stderr)
    else:
        t0 = time.perf_counter()
        fx = write_fixture(seq_dir, duration=duration, hold=3.5,
                           n_points=8192, seed=57,
                           pose_fn=synthetic.spiral_pose_of)
        fx["n_scans_req"] = n_scans
        fx["gen_seconds"] = round(time.perf_counter() - t0, 1)
        with open(marker, "w") as f:
            json.dump(fx, f)
        print(f"fixture written: {fx}", file=sys.stderr)

    # ---- 2) the real user command --------------------------------------
    from noetic_slam_tpu import cli

    argv = ["slam", "--mulran", seq_dir, "--out", out_dir,
            "--warmup", "--batch", "8", "--loop-every", "16",
            "--config", os.path.join(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))), "cfg", "mulran.yaml")]
    print(f"cli: noetic_slam_tpu {' '.join(argv)}", file=sys.stderr)
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        print(f"cli slam failed rc={rc}", file=sys.stderr)
        return rc

    # ---- 3) ATE vs the fixture's ground truth --------------------------
    traj = np.loadtxt(os.path.join(out_dir, "trajectory.tum"))
    gt_rows = np.loadtxt(os.path.join(seq_dir, "global_pose.csv"),
                         delimiter=",")
    gt_t = gt_rows[:, 0] * 1e-9
    gt_p = gt_rows[:, 1:].reshape(-1, 3, 4)[:, :, 3]
    ate = synthetic.ate_rmse(traj[:, 0], traj[:, 1:4], gt_t, gt_p)
    # per-decile aligned profile
    gt_i = np.stack([np.interp(traj[:, 0], gt_t, gt_p[:, k])
                     for k in range(3)], -1)
    est, gtc = traj[:, 1:4], gt_i
    mu_e, mu_g = est.mean(0), gtc.mean(0)
    H = (est - mu_e).T @ (gtc - mu_g)
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    al = ((Vt.T @ S @ U.T) @ (est - mu_e).T).T + mu_g
    seg = np.linalg.norm(al - gtc, axis=-1)
    dec = max(1, len(seg) // 10)
    profile = [round(float(seg[i:i + dec].mean()), 3)
               for i in range(0, len(seg), dec)][:10]

    n_traj = int(len(traj))
    result = {
        "artifact": "km soak through the cli user path "
                    "(scripts/soak_cli.py -> cli slam --mulran)",
        "command": "python -m noetic_slam_tpu.cli " + " ".join(argv),
        "fixture": fx,
        "wall_seconds_cli": round(wall, 1),
        "trajectory_poses": n_traj,
        "scans_per_sec_incl_warmup_and_io": round(n_traj / wall, 2),
        "ate_rmse_m": round(float(ate), 4),
        "ate_profile_deciles": profile,
    }
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    ok = ate < 0.30 and n_traj > 0.95 * fx["n_scans"]
    print(f"CLI SOAK {'OK' if ok else 'FAILED'}", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
