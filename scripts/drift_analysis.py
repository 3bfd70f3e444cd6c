"""Drift analysis of a soak trajectory.

Reads the trajectory artifact the soak harness saves (SOAK_TRAJ: est
trajectory + gt) plus the soak JSON (closure log,
descriptor log stats) and writes a markdown report locating WHERE error
enters the run:

- aligned error vs time (deciles + the worst 1% segments);
- drift RATE between consecutive closures (m error growth per 100 scans)
  — separates "odometry re-drifts fast" from "closures oscillate";
- per-closure correction magnitude vs the error immediately before it —
  a correction LARGER than the local error indicates closure overshoot /
  oscillation; smaller indicates under-correction;
- trajectory phase stats (spiral radius / speed per decile) to correlate
  error onset with the motion regime.

Usage:
    python scripts/drift_analysis.py SOAK_JSON TRAJ_NPZ OUT_MD
"""

from __future__ import annotations

import json
import sys

import numpy as np


def aligned_errors(traj, gt_stamps, gt_pos):
    """Umeyama-aligned (rotation+translation, no scale) per-sample error."""
    gt_i = np.stack([np.interp(traj[:, 0], gt_stamps, gt_pos[:, k])
                     for k in range(3)], -1)
    est = traj[:, 1:4]
    mu_e, mu_g = est.mean(0), gt_i.mean(0)
    H = (est - mu_e).T @ (gt_i - mu_g)
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    al = ((Vt.T @ S @ U.T) @ (est - mu_e).T).T + mu_g
    return np.linalg.norm(al - gt_i, axis=-1), gt_i


def main():
    if len(sys.argv) != 4:
        raise SystemExit("usage: drift_analysis.py SOAK_JSON TRAJ_NPZ OUT_MD")
    soak_json, traj_npz, out_md = sys.argv[1:4]

    with open(soak_json) as f:
        soak = json.load(f)
    d = np.load(traj_npz)
    traj, gt_stamps, gt_pos = d["traj"], d["gt_stamps"], d["gt_pos"]

    err, gt_i = aligned_errors(traj, gt_stamps, gt_pos)
    T = len(err)
    dec = max(1, T // 10)
    deciles = [round(float(err[i:i + dec].mean()), 3)
               for i in range(0, T, dec)][:10]

    # motion regime per decile
    speed = np.linalg.norm(np.diff(gt_i, axis=0), axis=-1) / np.maximum(
        np.diff(traj[:, 0]), 1e-6)
    # radius from the trajectory CENTROID (the spiral center), not the
    # first sample — distance-from-start conflates angular position with
    # radial growth
    radius = np.linalg.norm(gt_i[:, :2] - gt_i[:, :2].mean(0), axis=-1)
    regime = [(round(float(radius[i:i + dec].mean()), 1),
               round(float(np.median(speed[max(i - 1, 0):i + dec])), 2))
              for i in range(0, T, dec)][:10]

    # closure-relative analysis
    closures = soak.get("closure_log", [])
    rows = []
    for c in closures:
        scan = c["scan"]
        idx = min(max(scan, 0), T - 1)
        pre = float(err[max(idx - 5, 0): idx + 1].mean())
        post_hi = min(idx + 30, T)
        post = float(err[idx + 1: post_hi].mean()) if post_hi > idx + 1 \
            else pre
        rows.append((scan, c.get("source", "?"), c["correction_m"],
                     round(pre, 3), round(post, 3),
                     c.get("moved_keyframes"), round(c.get("seconds", 0), 2)))

    # drift rate between consecutive closures
    rates = []
    for (s0, *_), (s1, *_) in zip(rows, rows[1:]):
        i0, i1 = min(s0, T - 1), min(s1, T - 1)
        if i1 - i0 > 10:
            rates.append(round((float(err[i1]) - float(err[i0]))
                               / (i1 - i0) * 100, 3))

    lines = [
        f"# Drift analysis — {soak_json}",
        "",
        f"Scans {soak.get('scans')}, ATE {soak.get('ate_rmse_m')} m, "
        f"closures {soak.get('loop_closures_applied')} "
        f"({soak.get('loop_closures_descriptor', '?')} descriptor), "
        f"sync lost {soak.get('sync_lost_keyframes')}.",
        "",
        "## Aligned error by decile (with motion regime)",
        "",
        "| decile | mean err [m] | spiral radius [m] | speed [m/s] |",
        "|---|---|---|---|",
    ]
    for k, e in enumerate(deciles):
        r, v = regime[k] if k < len(regime) else ("?", "?")
        lines.append(f"| {k} | {e} | {r} | {v} |")
    lines += [
        "",
        f"Worst 1% of samples: mean "
        f"{round(float(np.sort(err)[-max(T // 100, 1):].mean()), 3)} m at "
        f"scans {np.argsort(err)[-5:][::-1].tolist()}.",
        "",
        "## Closures: correction vs local error",
        "",
        "A correction larger than the pre-closure local error means the",
        "closure moved the trajectory MORE than the locally-visible error",
        "(overshoot / oscillation); repeated same-magnitude corrections",
        "with no post-closure error drop mean the graph is not holding the",
        "correction.",
        "",
        "| scan | source | correction [m] | err before | err after "
        "| moved kf | s |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        lines.append("| " + " | ".join(str(x) for x in r) + " |")
    lines += [
        "",
        "## Drift rate between consecutive closures",
        "",
        f"m of aligned-error growth per 100 scans: {rates}",
        "",
        f"median {round(float(np.median(rates)), 3) if rates else '?'} "
        "m/100 scans.",
    ]
    with open(out_md, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out_md}")
    print("\n".join(lines[:20]))


if __name__ == "__main__":
    main()
