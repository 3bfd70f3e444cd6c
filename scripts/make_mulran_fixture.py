"""Generate a MulRan-format mini-sequence from the synthetic simulator.

Writes the EXACT on-disk formats the reference file player parses
(reference src/file_player_mulran/src/ROSThread.cpp):

- ``sensor_data/data_stamp.csv``      ``<stamp_ns>,<sensor>`` dispatch rows
  (tags "imu"/"ouster"/"gps"/"radar", ROSThread.cpp:133-147,342-357)
- ``sensor_data/xsens_imu.csv``       17-field v2 rows: stamp_ns, qx qy qz
  qw, ex ey ez, gx gy gz, ax ay az, mx my mz (gyro at cols 8-10, accel at
  11-13, ROSThread.cpp:172-249)
- ``sensor_data/Ouster/<stamp>.bin``  float32 x,y,z,intensity records
  (OS1-64 layout, no per-point time — ROSThread.cpp:498-524)
- ``global_pose.csv``                 stamp_ns + row-major 3x4 world pose
  (ROSThread.cpp:743-780)

The trajectory holds still for the calibration window (static IMU bias +
gravity alignment), then drives the synthetic world. Because the wire
format carries no per-point times, scans are still MOTION-DISTORTED like
the real sensor's (points sampled at their true firing poses) — the
pipeline must run with deskew disabled, exactly as on real MulRan.

Used to build the committed fixture ``tests/fixtures/mulran_mini`` (seed,
sizes pinned below); the e2e ATE regression is tests/test_mulran_e2e.py.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from noetic_slam_tpu.utils import synthetic  # noqa: E402

BASE_NS = 1_561_000_000_000_000_000  # realistic MulRan-era epoch


def still_then(pose_fn, hold: float, ramp: float = 1.0):
    """Trajectory wrapper: stationary at pose_fn(0) for ``hold`` seconds
    (the static-calibration window), then pose_fn over a C1 time warp
    (quadratic velocity ramp of ``ramp`` seconds — a hard kink would put an
    unphysical acceleration spike into the numerically-differentiated IMU)."""
    def fn(t):
        u = float(t) - hold
        if u <= 0.0:
            tau = 0.0
        elif u <= ramp:
            tau = u * u / (2.0 * ramp)
        else:
            tau = u - ramp / 2.0
        return pose_fn(tau)
    return fn


def write_fixture(out: str, duration: float = 8.0, hold: float = 3.5,
                  n_points: int = 2048, seed: int = 42,
                  imu_hz: float = 100.0, scan_hz: float = 10.0,
                  pose_fn=None, radar: bool = True) -> dict:
    """``pose_fn`` overrides the driving trajectory (e.g.
    synthetic.loop_pose_of for a closed loop); the stationary calibration
    hold is prepended either way. ``radar=False`` skips the radar PNGs
    (the only part that needs PIL)."""
    fn = still_then(pose_fn or synthetic._pose_of, hold)
    sim = synthetic.make_sim(duration=hold + duration, imu_hz=imu_hz,
                             scan_hz=scan_hz, n_points=n_points,
                             calib_time=0.0, seed=seed, pose_fn=fn)

    sd = os.path.join(out, "sensor_data")
    ouster_dir = os.path.join(sd, "Ouster")
    os.makedirs(ouster_dir, exist_ok=True)

    rng = np.random.default_rng(seed + 1)
    events = []

    # --- IMU: 17-field xsens v2 rows ------------------------------------
    with open(os.path.join(sd, "xsens_imu.csv"), "w") as f:
        for i, t in enumerate(sim.imu_stamps):
            ns = BASE_NS + int(round(t * 1e9))
            R, _ = sim.pose(t)
            q = synthetic._mat_to_quat(R)          # wxyz
            g = sim.imu_ang[i]
            a = sim.imu_acc[i]
            row = ([ns, q[1], q[2], q[3], q[0], 0.0, 0.0, 0.0,
                    g[0], g[1], g[2], a[0], a[1], a[2], 0.0, 0.0, 0.0])
            f.write(",".join(f"{v:.9g}" if k else str(v)
                             for k, v in enumerate(row)) + "\n")
            events.append((ns, "imu"))

    # --- Scans: float32 x,y,z,intensity bins ----------------------------
    n_scans = 0
    for i, t in enumerate(sim.scan_stamps):
        if t < hold - 0.5:        # park the sensor during calibration
            continue
        ns = BASE_NS + int(round(t * 1e9))
        _, xyz, _ = sim.scan(i)
        rec = np.empty((xyz.shape[0], 4), np.float32)
        rec[:, :3] = xyz
        rec[:, 3] = rng.uniform(0, 512, xyz.shape[0]).astype(np.float32)
        rec.tofile(os.path.join(ouster_dir, f"{ns}.bin"))
        events.append((ns, "ouster"))
        n_scans += 1

    # --- dispatch order --------------------------------------------------
    events.sort()
    with open(os.path.join(sd, "data_stamp.csv"), "w") as f:
        for ns, tag in events:
            f.write(f"{ns},{tag}\n")

    # --- ground truth: stamp_ns + row-major 3x4 -------------------------
    with open(os.path.join(out, "global_pose.csv"), "w") as f:
        for t in np.arange(0.0, hold + duration, 0.1):
            ns = BASE_NS + int(round(t * 1e9))
            R, p = sim.pose(t)
            T = np.concatenate([R, p[:, None]], axis=1)   # (3, 4)
            f.write(str(ns) + ","
                    + ",".join(f"{v:.9g}" for v in T.reshape(-1)) + "\n")

    # --- gps.csv: stamp_ns + lat/lon/alt + 9 covariance -----------------
    # (ROSThread.cpp:152-170 parse; lat/lon synthesized from the ground-
    # truth positions at ~1e-5 deg/m around a MulRan-plausible origin).
    n_gps = 0
    with open(os.path.join(sd, "gps.csv"), "w") as f:
        for t in np.arange(0.0, hold + duration, 0.25):
            ns = BASE_NS + int(round(t * 1e9))
            _, p = sim.pose(t)
            lat = 36.37 + p[1] * 9.0e-6
            lon = 127.36 + p[0] * 1.12e-5
            row = [ns, f"{lat:.9f}", f"{lon:.9f}", f"{p[2]:.4f}"] + \
                ["2.25", "0", "0", "0", "2.25", "0", "0", "0", "9.0"]
            f.write(",".join(str(v) for v in row) + "\n")
            n_gps += 1

    # --- radar/polar PNGs: <stamp_ns>.png mono8 -------------------------
    # (directory layout + name convention, ROSThread.cpp:262-284; content
    # is synthetic — the player only moves the images, it never parses
    # them).
    n_radar = 0
    if radar:
        n_radar = _write_radar(sd, seed, hold, duration)

    return {"out": out, "n_scans": n_scans, "n_imu": len(sim.imu_stamps),
            "n_gps": n_gps, "n_radar": n_radar,
            "duration_s": hold + duration, "n_points": n_points}


def _write_radar(sd: str, seed: int, hold: float, duration: float) -> int:
    from PIL import Image

    radar_dir = os.path.join(sd, "radar", "polar")
    os.makedirs(radar_dir, exist_ok=True)
    rng_r = np.random.default_rng(seed + 2)
    n_radar = 0
    for t in np.arange(hold, hold + duration, 0.25):
        ns = BASE_NS + int(round(t * 1e9))
        img = (rng_r.integers(0, 60, (64, 128))
               + np.linspace(0, 180, 128)[None, :]).astype(np.uint8)
        Image.fromarray(img, mode="L").save(
            os.path.join(radar_dir, f"{ns}.png"))
        n_radar += 1
    return n_radar


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("out", help="output sequence directory")
    ap.add_argument("--duration", type=float, default=8.0,
                    help="driving seconds after the calibration hold")
    ap.add_argument("--hold", type=float, default=3.5,
                    help="stationary seconds for IMU calibration")
    ap.add_argument("--n-points", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--pose", default="default",
                    choices=["default", "loop", "spiral"],
                    help="driving trajectory: gentle arc (default), a "
                         "closed 20 s/5 m loop, or the km-soak expanding "
                         "spiral (new ground every lap, each lap in "
                         "closure range of the previous)")
    args = ap.parse_args()
    import functools

    pose = {"default": None,
            "loop": functools.partial(synthetic.loop_pose_of,
                                      period=20.0, radius=5.0),
            "spiral": synthetic.spiral_pose_of}[args.pose]
    print(write_fixture(args.out, duration=args.duration, hold=args.hold,
                        n_points=args.n_points, seed=args.seed,
                        pose_fn=pose))


if __name__ == "__main__":
    main()
