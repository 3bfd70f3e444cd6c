"""End-to-end ATE regression on the committed MulRan-format fixture.

This exercises the REAL ingest path — MulranDataset CSV/bin parsing,
event-ordered replay with IMU-coverage gating, static calibration, the full
odometry step, TUM export — against ground truth from ``global_pose.csv``,
i.e. the BASELINE primary metric (ATE RMSE on a MulRan-format sequence)
measured through the same code path as ``cli slam --mulran``.

Fixture: tests/fixtures/mulran_mini (generated by
scripts/make_mulran_fixture.py, formats pinned to the reference parsers —
see that script's docstring; reference
src/file_player_mulran/src/ROSThread.cpp:119-284,743-780). MulRan carries
no per-point times, so the pipeline runs without deskew on
motion-distorted scans, exactly as on the real dataset.
"""

import os

import numpy as np
import pytest

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "mulran_mini")

pytestmark = pytest.mark.skipif(not os.path.isdir(FIXTURE),
                                reason="mulran_mini fixture not present")


def _small_caps():
    from noetic_slam_tpu.config.params import CapacityConfig, DlioConfig

    return DlioConfig(capacity=CapacityConfig(
        max_points=2048, max_ds_points=1024, max_deskew_frames=128,
        max_imu_window=64, max_keyframes=64, max_submap_kf=32,
        max_trajectory=512))


def test_fixture_loads_through_real_parsers():
    from noetic_slam_tpu.io.mulran import MulranDataset

    ds = MulranDataset.load(FIXTURE)
    assert ds.imu_version == 2
    assert len(ds.scan_stamps) >= 60
    assert len(ds.imu_stamps) >= 1000
    assert ds.gt_poses is not None and ds.gt_poses.shape[1:] == (3, 4)
    # binary record layout: float32 x,y,z,intensity
    scan = ds.read_scan(0)
    assert scan.shape == (2048, 4) and scan.dtype == np.float32
    assert np.abs(scan[:, :3]).max() < 100.0
    # stamps strictly increasing, ns-to-seconds conversion sane
    assert np.all(np.diff(ds.scan_stamps) > 0)
    assert 1.5e9 < ds.scan_stamps[0] < 1.7e9


def test_mulran_e2e_ate(tmp_path):
    """Full pipeline over the fixture; ATE RMSE must stay under 0.10 m
    (measured 0.022 m on CPU; ~4x headroom against backend jitter)."""
    from noetic_slam_tpu.io.export import write_tum_trajectory
    from noetic_slam_tpu.io.mulran import MulranDataset
    from noetic_slam_tpu.io.replay import replay_dataset
    from noetic_slam_tpu.runtime.pipeline import OdometryPipeline
    from noetic_slam_tpu.utils.synthetic import ate_rmse

    ds = MulranDataset.load(FIXTURE)
    pipe = OdometryPipeline(_small_caps())
    stats = replay_dataset(ds, pipe, rate=0.0)
    assert stats["n_scans"] >= 60

    traj = pipe.flush()
    assert len(traj) == stats["n_scans"]
    ate = ate_rmse(traj[:, 0], traj[:, 1:4], ds.gt_stamps,
                   ds.gt_poses[:, :, 3])
    assert ate < 0.10, f"real-ingest ATE RMSE {ate:.3f} m"

    # TUM export + the eval entry point parse the same files the user would.
    tum = tmp_path / "trajectory.tum"
    write_tum_trajectory(str(tum), traj)
    from noetic_slam_tpu import cli

    rc = cli.main(["eval", str(tum), os.path.join(FIXTURE,
                                                  "global_pose.csv")])
    assert rc == 0


def test_mulran_cli_slam(tmp_path, capsys):
    """The actual `cli slam --mulran` command over the fixture (the L5
    orchestration surface), with loop closure enabled."""
    import yaml

    from noetic_slam_tpu import cli

    cfg = tmp_path / "small.yaml"
    cfg.write_text(yaml.safe_dump({"capacity": {
        "max_points": 2048, "max_ds_points": 1024,
        "max_deskew_frames": 128, "max_imu_window": 64,
        "max_keyframes": 64, "max_submap_kf": 32,
        "max_trajectory": 512}}))
    out = tmp_path / "out"
    rc = cli.main(["slam", "--mulran", FIXTURE, "--out", str(out),
                   "--config", str(cfg), "--no-tsdf", "--max-scans", "30"])
    assert rc == 0
    stdout = capsys.readouterr().out
    assert "ATE RMSE vs ground truth" in stdout
    ate = float(stdout.split("ATE RMSE vs ground truth:")[1].split("m")[0])
    assert ate < 0.5
    assert (out / "trajectory.tum").exists()


def test_cli_slam_loop_radius(tmp_path, monkeypatch):
    """`cli slam` keeps SlamSystem's 3 m proximity radius unless
    `--loop-radius` sets another."""
    import inspect

    from noetic_slam_tpu import cli
    from noetic_slam_tpu.runtime import slam

    sig = inspect.signature(slam.SlamSystem)
    assert sig.parameters["loop_radius"].default == 3.0
    seen = []

    class Stop(Exception):
        pass

    def fake_system(cfg, **kw):
        seen.append(kw["loop_radius"])
        raise Stop

    monkeypatch.setattr(slam, "SlamSystem", fake_system)
    for extra in ([], ["--loop-radius", "7.5"]):
        with pytest.raises(Stop):
            cli.main(["slam", "--mulran", FIXTURE, "--out",
                      str(tmp_path / "out")] + extra)
    assert seen == [3.0, 7.5]


@pytest.mark.slow
def test_mulran_loop_closure_improves_ate(tmp_path):
    """Loop-closure end-to-end through the REAL MulRan ingest path: a
    closed-loop sequence (generated to MulRan format, no per-point times,
    no deskew) where enabling loop closure fires at least one closure and
    does not degrade the trajectory. Exercises detection, calibrated
    verification, drift budget, graph optimization and map deformation on
    CSV/bin-ingested data."""
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from scripts.make_mulran_fixture import write_fixture

    from noetic_slam_tpu.config.params import (CapacityConfig, DlioConfig,
                                               GicpConfig, KeyframeConfig)
    from noetic_slam_tpu.io.mulran import MulranDataset
    from noetic_slam_tpu.io.replay import replay_dataset
    from noetic_slam_tpu.runtime.slam import SlamSystem
    from noetic_slam_tpu.utils.synthetic import ate_rmse, loop_pose_of

    fx = str(tmp_path / "mulran_loop")
    meta = write_fixture(fx, duration=20.0, hold=3.5, n_points=2048,
                         seed=31, scan_hz=5.0, pose_fn=loop_pose_of)
    assert meta["n_scans"] >= 95
    ds = MulranDataset.load(fx)

    cfg = DlioConfig(
        capacity=CapacityConfig(
            max_points=2048, max_ds_points=1024, max_deskew_frames=128,
            max_imu_window=64, max_keyframes=64, max_submap_kf=32,
            max_trajectory=512),
        keyframe=KeyframeConfig(thresh_dist=1.0), adaptive=False,
        gicp=GicpConfig(max_iterations=8))
    slam = SlamSystem(cfg, enable_tsdf=False, enable_loop_closure=True,
                      loop_radius=5.0, loop_min_gap=15)
    n_since = {"n": 0}

    def on_scan(idx, out):
        n_since["n"] += 1
        if n_since["n"] % 10 == 0:
            slam.maybe_close_loop()

    replay_dataset(ds, slam, rate=0.0, on_scan=on_scan)
    slam.maybe_close_loop()
    traj = slam.flush()
    ate = ate_rmse(traj[:, 0], traj[:, 1:4], ds.gt_stamps,
                   ds.gt_poses[:, :, 3])
    assert slam.loop_closures >= 1, "no closure fired on the closed loop"
    assert ate < 0.5, f"closed-loop MulRan ATE {ate:.3f} m"


def test_gps_radar_streams_and_bag_export(tmp_path):
    """GPS/radar sidecar streams (file player's remaining publishers,
    ROSThread.cpp:562-631) through load, replay dispatch, and the
    SaveRosbag-parity bag export (ROSThread.cpp:704-784), round-tripped
    through this module's own bag reader."""
    from noetic_slam_tpu.io.export import export_mulran_bag
    from noetic_slam_tpu.io.mulran import MulranDataset
    from noetic_slam_tpu.io.replay import replay_dataset
    from noetic_slam_tpu.io.rosbag import (BagReader, parse_image,
                                           parse_odometry)
    from noetic_slam_tpu.runtime.pipeline import OdometryPipeline

    ds = MulranDataset.load(FIXTURE)
    assert ds.gps is not None and ds.gps.shape[1] == 13
    assert len(ds.radar_stamps) >= 10
    img0 = ds.read_radar(0)
    assert img0.dtype == np.uint8 and img0.shape == (64, 128)

    # replay dispatches gps/radar events in stamp order
    got = {"gps": [], "radar": []}
    pipe = OdometryPipeline(_small_caps())
    replay_dataset(ds, pipe, max_scans=3,
                   on_gps=lambda t, row: got["gps"].append(t),
                   on_radar=lambda t, i: got["radar"].append((t, i)))
    assert len(got["gps"]) > 5
    assert got["gps"] == sorted(got["gps"])
    assert [i for _, i in got["radar"]] == sorted(
        i for _, i in got["radar"])

    # bag export round-trip
    bag = str(tmp_path / "gt.bag")
    stats = export_mulran_bag(ds, bag)
    assert stats["gt"] == len(ds.gt_stamps)
    assert stats["radar"] == len(ds.radar_stamps)
    odoms, imgs = [], []
    for topic, mtype, _t, data in BagReader(bag).messages():
        if mtype == "nav_msgs/Odometry":
            odoms.append(parse_odometry(data))
        elif mtype == "sensor_msgs/Image":
            imgs.append(parse_image(data))
    assert len(odoms) == stats["gt"] and len(imgs) == stats["radar"]
    k = 7
    np.testing.assert_allclose(odoms[k]["p"], ds.gt_poses[k][:, 3],
                               atol=1e-9)
    from noetic_slam_tpu.utils.geometry import quat_to_mat

    R = np.asarray(quat_to_mat(np.asarray(odoms[k]["q"], np.float32)))
    np.testing.assert_allclose(R, ds.gt_poses[k][:, :3], atol=1e-5)
    np.testing.assert_array_equal(imgs[3]["img"], ds.read_radar(3))
