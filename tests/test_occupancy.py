"""Occupancy-grid backend (Octomap class): inverse sensor model, clamping,
free-space carving, loop-closure rebuild, and the fused SLAM-step path."""

import jax.numpy as jnp
import numpy as np
import pytest

from noetic_slam_tpu.config.params import OccupancyConfig
from noetic_slam_tpu.models import occupancy as occ


def small_cfg(**kw):
    base = dict(voxel_size=0.1, max_blocks=2048, miss_samples=16,
                max_range=30.0)
    base.update(kw)
    return OccupancyConfig(**base)


def _wall_scan(n=400, x=5.0, seed=0):
    rng = np.random.default_rng(seed)
    pts = np.c_[np.full(n, x), rng.uniform(-2, 2, n),
                rng.uniform(-1, 1, n)].astype(np.float32)
    return jnp.asarray(pts), jnp.ones((n,), bool)


def _logodds_at(cfg, st, xyz):
    """Log-odds of the voxel containing each point (host helper)."""
    from noetic_slam_tpu.models.tsdf import _block_key, _lookup

    vx = np.floor(np.asarray(xyz) / cfg.voxel_size).astype(np.int32)
    b = vx >> 3
    intra = vx - (b << 3)
    slots = np.asarray(_lookup(st, _block_key(jnp.asarray(b))))
    iv = intra[:, 0] + (intra[:, 1] << 3) + (intra[:, 2] << 6)
    L = np.asarray(st.logodds)
    out = np.full(len(vx), np.nan)
    ok = slots >= 0
    out[ok] = L[slots[ok], iv[ok]]
    return out


def test_hits_occupied_free_space_carved():
    cfg = small_cfg()
    st = occ.init_occupancy(cfg)
    pts, valid = _wall_scan()
    for _ in range(4):
        st = occ.integrate(cfg, st, pts, valid, jnp.zeros(3))

    # wall voxels: strongly occupied
    L_wall = _logodds_at(cfg, st, np.asarray(pts))
    assert np.nanmin(L_wall) > 0.8
    # free space along the rays: voxels at the miss-sample positions are
    # carved negative (carving is SUBSAMPLED — miss_samples per ray — so
    # only sampled voxels are touched, unlike Octomap's full ray tracing)
    pos, delta = occ._beam_samples(cfg, pts, valid, jnp.zeros(3))
    miss = np.asarray(pos)[np.asarray(delta) < 0]
    interior = miss[np.asarray(miss)[:, 0] < 4.0]     # clear of the wall
    L_mid = _logodds_at(cfg, st, interior[::7])
    assert np.nanmax(L_mid) < -0.3
    # occupancy probability consistent
    p = np.asarray(occ.occupancy_prob(st))
    assert p.max() <= 1.0 and p.min() >= 0.0


def test_logodds_clamped():
    cfg = small_cfg()
    st = occ.init_occupancy(cfg)
    pts, valid = _wall_scan(n=200)
    for _ in range(12):          # 12 * 0.85 = 10.2 >> l_max
        st = occ.integrate(cfg, st, pts, valid, jnp.zeros(3))
    L = np.asarray(st.logodds)
    assert L.max() <= cfg.l_max + 1e-5
    assert L.min() >= cfg.l_min - 1e-5


def test_extract_occupied_matches_wall():
    cfg = small_cfg()
    st = occ.init_occupancy(cfg)
    pts, valid = _wall_scan(n=600)
    st = occ.integrate(cfg, st, pts, valid, jnp.zeros(3))
    centers, L, mask = occ.extract_occupied(cfg, st)
    centers, mask = np.asarray(centers), np.asarray(mask)
    occ_pts = centers[mask]
    assert len(occ_pts) > 50
    # every occupied voxel center sits at the wall plane (x = 5 +- voxel)
    assert np.all(np.abs(occ_pts[:, 0] - 5.0) < 2 * cfg.voxel_size)


def test_rebuild_matches_incremental():
    cfg = small_cfg()
    K, Nk = 3, 300
    kf_xyz = np.full((K, Nk, 3), 1e6, np.float32)
    kf_valid = np.zeros((K, Nk), bool)
    kf_pos = np.zeros((K, 3), np.float32)
    st_inc = occ.init_occupancy(cfg)
    for k in range(2):
        pts, _ = _wall_scan(n=Nk, x=4.0 + k, seed=k)
        kf_xyz[k], kf_valid[k] = np.asarray(pts), True
        st_inc = occ.integrate(cfg, st_inc, pts, jnp.ones((Nk,), bool),
                               jnp.asarray(kf_pos[k]))
    st_rb = occ.rebuild_from_keyframes(
        cfg, jnp.asarray(kf_xyz), jnp.asarray(kf_valid),
        jnp.asarray(kf_pos), jnp.int32(2))
    assert int(st_rb.num_blocks) == int(st_inc.num_blocks)
    np.testing.assert_array_equal(np.asarray(st_rb.dir_keys),
                                  np.asarray(st_inc.dir_keys))
    nb = int(st_inc.num_blocks)
    si = np.asarray(st_inc.dir_slots)[:nb]
    sr = np.asarray(st_rb.dir_slots)[:nb]
    np.testing.assert_allclose(np.asarray(st_rb.logodds)[sr],
                               np.asarray(st_inc.logodds)[si],
                               rtol=1e-5, atol=1e-5)


def test_slam_system_with_occupancy_backend():
    """End-to-end: the fused odometry+occupancy step through SlamSystem
    (cfg.map_backend selection), occupied voxels near world surfaces."""
    from noetic_slam_tpu.config.params import (CapacityConfig, DlioConfig,
                                               KeyframeConfig)
    from noetic_slam_tpu.runtime.slam import SlamSystem
    from noetic_slam_tpu.utils import synthetic

    cfg = DlioConfig(
        capacity=CapacityConfig(
            max_points=2048, max_ds_points=1024, max_deskew_frames=512,
            max_imu_window=64, max_keyframes=32, max_submap_kf=16),
        keyframe=KeyframeConfig(thresh_dist=0.25),
        adaptive=False,
        map_backend="occupancy",
        occupancy=OccupancyConfig(voxel_size=0.2, max_blocks=8192,
                                  miss_samples=8))
    sim = synthetic.make_sim(duration=1.5, n_points=2048, calib_time=3.1,
                             seed=5)
    slam = SlamSystem(cfg, enable_tsdf=True, enable_loop_closure=False)
    imu_i = 0
    for s in range(len(sim.scan_stamps)):
        header, xyz, pt = sim.scan(s)
        sweep_end = header + pt.max()
        while (imu_i < len(sim.imu_stamps)
               and sim.imu_stamps[imu_i] <= sweep_end + 0.02):
            slam.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                          sim.imu_acc[imu_i])
            imu_i += 1
        slam.process_scan(header, xyz, pt)

    occ_pts = slam.surface_points()
    assert len(occ_pts) > 200
    sub = occ_pts[np.random.default_rng(0).choice(len(occ_pts),
                                                  min(200, len(occ_pts)))]
    d = np.min(np.linalg.norm(sub[:, None, :] - sim.world[None, :],
                              axis=-1), axis=1)
    assert np.median(d) < 0.5, np.median(d)

    # checkpoint roundtrip carries the occupancy payload
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        path = f"{td}/occ.nst.npz"
        slam.save(path)
        slam2 = SlamSystem(cfg, enable_tsdf=True, enable_loop_closure=False)
        slam2.load(path)
        assert type(slam2.tsdf).__name__ == "OccupancyState"
        np.testing.assert_array_equal(np.asarray(slam2.tsdf.logodds),
                                      np.asarray(slam.tsdf.logodds))


def _ring_scans():
    rng = np.random.default_rng(7)
    scans = []
    for i in range(3):
        ang = rng.uniform(0, 2 * np.pi, 96)
        r = 4.0 + rng.normal(scale=0.05, size=96)
        z = rng.uniform(-0.5, 1.0, 96)
        scans.append(np.stack([r * np.cos(ang), r * np.sin(ang), z],
                              -1).astype(np.float32) + 0.01 * i)
    # the same wall six more times: hits accumulate past l_max
    return scans + [scans[-1]] * 6


OCC_CASES = {
    "ring_with_clamp": (small_cfg(max_blocks=256, scan_block_cap=64),
                        _ring_scans()),
    "capacity_overflow": (
        small_cfg(max_blocks=64, scan_block_cap=8, miss_samples=2),
        [np.random.default_rng(11).uniform(-12, 12, (128, 3)).astype(
            np.float32)]),
}


@pytest.mark.parametrize("case", list(OCC_CASES))
def test_integrate_deltas_matches_numpy_reference(case):
    """occupancy._integrate_deltas (sort, block gating, scatter-add, clamp)
    against the independent NumPy log-odds reference."""
    from reference_math import dense_map_voxels, occupancy_fuse_ref

    cfg, scans = OCC_CASES[case]
    st = occ.init_occupancy(cfg)
    logodds, directory, dropped = {}, {}, 0
    for pts in scans:
        valid = jnp.ones((pts.shape[0],), bool)
        pos, delta = occ._beam_samples(cfg, jnp.asarray(pts), valid,
                                       jnp.zeros(3))
        st = occ._integrate_deltas(cfg, st, pos, delta)
        dropped += occupancy_fuse_ref(
            logodds, directory, np.asarray(pos), np.asarray(delta),
            cfg.voxel_size, cfg.l_min, cfg.l_max, cfg.scan_block_cap,
            cfg.max_blocks)

    assert int(st.num_blocks) == len(directory)
    assert int(st.dropped) == dropped
    got = dense_map_voxels(st.dir_keys, st.dir_slots, (st.logodds,))
    assert logodds.keys() <= got.keys()
    for k, (L,) in got.items():
        np.testing.assert_allclose(L, logodds.get(k, 0.0), rtol=1e-5,
                                   atol=1e-5)
    if case == "ring_with_clamp":
        assert max(logodds.values()) == cfg.l_max
    else:
        assert dropped > 0
