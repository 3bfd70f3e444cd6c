"""Keyframe-store capacity policy: spatial-redundancy eviction.

The reference's keyframe store grows without bound (odom.cc:1517-1598); the
device build's store is a fixed-capacity device array. Past saturation the old
behavior silently dropped NEW keyframes — odometry then degrades as the
vehicle leaves the mapped region. The policy now evicts the most spatially
redundant resident keyframe (smallest nearest-neighbor distance, newest few
protected) so trajectory coverage is preserved; the pose graph keeps every
keyframe ever created (host bookkeeping in SlamSystem.sync_graph).
"""

import jax.numpy as jnp
import numpy as np

from noetic_slam_tpu.config.params import (CapacityConfig, DlioConfig,
                                           KeyframeConfig)
from noetic_slam_tpu.models.odometry import (
    init_state,
    push_keyframe,
    select_eviction_victim,
)
from noetic_slam_tpu.utils import synthetic


def _tiny_cfg(max_kf):
    return DlioConfig(
        capacity=CapacityConfig(
            max_points=2048, max_ds_points=1024, max_deskew_frames=256,
            max_imu_window=64, max_keyframes=max_kf, max_submap_kf=16),
        keyframe=KeyframeConfig(thresh_dist=0.5, thresh_rot=45.0),
        adaptive=False)


def _state_with_positions(cfg, pos, seq=None):
    st = init_state(cfg)
    K = st.kf_pos.shape[0]
    kf_pos = np.zeros((K, 3), np.float32)
    kf_pos[: len(pos)] = pos
    n = len(pos)
    kf_seq = np.zeros((K,), np.int32)
    kf_seq[:n] = seq if seq is not None else np.arange(1, n + 1)
    return st._replace(kf_pos=jnp.asarray(kf_pos), kf_count=jnp.int32(n),
                       kf_seq=jnp.asarray(kf_seq),
                       kf_total=jnp.int32(int(kf_seq.max())))


def test_victim_is_densest_cluster_member():
    cfg = _tiny_cfg(8)
    # a spread line of keyframes + one redundant pair at x=2.05
    pos = np.array([[0, 0, 0], [1, 0, 0], [2, 0, 0], [2.05, 0, 0],
                    [3, 0, 0], [4, 0, 0], [5, 0, 0], [6, 0, 0]], np.float32)
    st = _state_with_positions(cfg, pos)
    v = int(select_eviction_victim(st))
    assert v in (2, 3), f"victim {v} not in the dense pair"


def test_victim_respects_recency_protection():
    cfg = _tiny_cfg(8)
    # densest pair (6.0/6.01) sits among the 4 NEWEST (protected);
    # a looser old pair at 2.0/2.2 is the evictable redundancy
    pos = np.array([[0, 0, 0], [2.0, 0, 0], [2.2, 0, 0], [4, 0, 0],
                    [5, 0, 0], [6.0, 0, 0], [6.01, 0, 0], [8, 0, 0]],
                   np.float32)
    st = _state_with_positions(cfg, pos)
    v = int(select_eviction_victim(st))
    assert v in (1, 2), \
        f"victim {v}: protected newest pair must not be evicted"


def test_push_keyframe_evicts_when_full():
    cfg = _tiny_cfg(8)
    pos = np.array([[0, 0, 0], [1, 0, 0], [1.05, 0, 0], [2, 0, 0],
                    [3, 0, 0], [4, 0, 0], [5, 0, 0], [6, 0, 0]], np.float32)
    st = _state_with_positions(cfg, pos)
    Nk = st.kf_xyz.shape[1]
    st = st._replace(lidar_p=jnp.asarray([7.0, 0, 0]),
                     lidar_q=jnp.asarray([1.0, 0, 0, 0]))
    st2 = push_keyframe(st, jnp.zeros((Nk, 3)), jnp.ones((Nk,), bool),
                        jnp.zeros((Nk, 6)), jnp.array(True))
    assert int(st2.kf_count) == 8                 # saturated
    assert int(st2.kf_total) == int(st.kf_total) + 1
    new_pos = np.asarray(st2.kf_pos)
    # the dense pair lost a member; the new keyframe is resident
    assert (np.linalg.norm(new_pos - np.array([7, 0, 0]), axis=-1)
            < 1e-5).any()
    assert int(st2.kf_seq[int(np.argmin(
        np.linalg.norm(new_pos - np.array([7, 0, 0]), axis=-1)))]) \
        == int(st2.kf_total)
    # disabled push changes nothing
    st3 = push_keyframe(st, jnp.zeros((Nk, 3)), jnp.ones((Nk,), bool),
                        jnp.zeros((Nk, 6)), jnp.array(False))
    np.testing.assert_array_equal(np.asarray(st3.kf_pos),
                                  np.asarray(st.kf_pos))
    assert int(st3.kf_total) == int(st.kf_total)


def _run(cfg, sim, n_scans=None):
    from noetic_slam_tpu.runtime.pipeline import OdometryPipeline

    pipe = OdometryPipeline(cfg)
    imu_i = 0
    n = n_scans or len(sim.scan_stamps)
    for s in range(n):
        header, xyz, pt = sim.scan(s)
        sweep_end = header + pt.max()
        while (imu_i < len(sim.imu_stamps)
               and sim.imu_stamps[imu_i] <= sweep_end + 0.02):
            pipe.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                          sim.imu_acc[imu_i])
            imu_i += 1
        pipe.process_scan(header, xyz, pt)
    traj = pipe.flush()
    ate = synthetic.ate_rmse(traj[:, 0], traj[:, 1:4], sim.gt_stamps,
                             sim.gt_pos)
    return pipe, ate


def test_ate_bounded_past_saturation():
    """A trajectory creating ~3x the store capacity in keyframes: ATE with
    the bounded store must stay within 2x of the unbounded-capacity run
    (pre-eviction behavior silently stopped keyframing, leaving the submap
    behind the vehicle)."""
    sim = synthetic.make_sim(duration=10.0, n_points=2048, calib_time=3.1,
                             seed=21)
    pipe_small, ate_small = _run(_tiny_cfg(6), sim)
    assert int(pipe_small.state.kf_total) > 12, "sim must oversubscribe"
    assert int(pipe_small.state.kf_count) == 6

    sim2 = synthetic.make_sim(duration=10.0, n_points=2048, calib_time=3.1,
                              seed=21)
    _, ate_big = _run(_tiny_cfg(64), sim2)

    assert ate_small < max(2.0 * ate_big, 0.08), \
        f"saturated ATE {ate_small:.3f} vs unbounded {ate_big:.3f}"


def test_graph_tracks_evicted_keyframes():
    """Pose-graph bookkeeping under eviction: every keyframe ever created
    gets a node (unless its slot was overwritten between syncs); slot->node
    mapping stays consistent."""
    from noetic_slam_tpu.runtime.slam import SlamSystem

    sim = synthetic.make_sim(duration=10.0, n_points=2048, calib_time=3.1,
                             seed=21)
    slam = SlamSystem(_tiny_cfg(6), enable_tsdf=False,
                      enable_loop_closure=True, loop_min_gap=1000)
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
        slam.sync_graph()        # sync every scan: no keyframe slips through

    st = slam.odometry.state
    total = int(st.kf_total)
    assert total > 6
    # synced every scan -> every keyframe became a node, chained by edges
    assert int(slam.graph.n_nodes) == total
    assert int(slam.graph.n_edges) == total - 1
    # resident slots all mapped, mappings point at distinct nodes
    assert len(slam._slot_node) >= int(st.kf_count)
    nodes = list(slam._slot_node.values())
    assert len(set(nodes)) == len(nodes)
    # each resident slot's node holds that keyframe's pose
    kf_pos = np.asarray(st.kf_pos)
    node_p = np.asarray(slam.graph.node_p)
    seq = np.asarray(st.kf_seq)
    for slot, node in slam._slot_node.items():
        if seq[slot] > 0 and slot < int(st.kf_count):
            np.testing.assert_allclose(node_p[node], kf_pos[slot],
                                       atol=1e-5)


def test_slam_system_checkpoint_roundtrip(tmp_path):
    """SlamSystem.save/load must preserve the slot->node bookkeeping: a
    resumed session syncing new keyframes must NOT duplicate graph nodes."""
    from noetic_slam_tpu.runtime.slam import SlamSystem

    sim = synthetic.make_sim(duration=4.0, n_points=2048, calib_time=3.1,
                             seed=22)
    slam = SlamSystem(_tiny_cfg(6), enable_tsdf=False,
                      enable_loop_closure=True, loop_min_gap=1000)
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
    slam.sync_graph()
    path = str(tmp_path / "slam.nst.npz")
    slam.save(path)

    slam2 = SlamSystem(_tiny_cfg(6), enable_tsdf=False,
                       enable_loop_closure=True, loop_min_gap=1000)
    slam2.load(path)
    assert slam2._slot_node == slam._slot_node
    assert slam2._synced_total == slam._synced_total
    assert int(slam2.graph.n_nodes) == int(slam.graph.n_nodes)
    # resumed sync is a no-op (nothing new since save)
    assert slam2.sync_graph() == 0
    assert int(slam2.graph.n_nodes) == int(slam.graph.n_nodes)


def test_outbox_lossless_handoff_under_delayed_sync():
    """VERDICT r3 #2: the device keyframe outbox must make device->host
    keyframe hand-off LOSSLESS even when the host syncs rarely (here: one
    sync per 32-scan stretch on a tiny 6-slot resident store that evicts
    constantly). Every keyframe ever created must land in the pose graph
    and the archive; sync_lost_keyframes must be 0."""
    import jax

    from noetic_slam_tpu.config.params import (CapacityConfig, DlioConfig,
                                               KeyframeConfig, TsdfConfig)
    from noetic_slam_tpu.runtime.slam import SlamSystem
    from noetic_slam_tpu.utils import synthetic

    cfg = DlioConfig(
        capacity=CapacityConfig(
            max_points=2048, max_ds_points=1024, max_deskew_frames=512,
            max_imu_window=64, max_keyframes=6, max_submap_kf=4,
            outbox_slots=32),
        keyframe=KeyframeConfig(thresh_dist=0.25, thresh_rot=45.0),
        adaptive=False,
        tsdf=TsdfConfig(voxel_size=0.25, truncation=0.75, max_blocks=4096,
                        space_carving=False, scan_block_cap=1024))
    sim = synthetic.make_sim(duration=16.0, scan_hz=5.0, n_points=1024,
                             calib_time=3.1, seed=21)
    slam = SlamSystem(cfg, enable_tsdf=True, enable_loop_closure=True,
                      use_descriptors=False)
    imu_i = 0
    n_scans = len(sim.scan_stamps)
    for s in range(n_scans):
        header, xyz, pt = sim.scan(s)
        sweep_end = header + pt.max()
        while (imu_i < len(sim.imu_stamps)
               and sim.imu_stamps[imu_i] <= sweep_end + 0.02):
            slam.push_imu(sim.imu_stamps[imu_i], sim.imu_ang[imu_i],
                          sim.imu_acc[imu_i])
            imu_i += 1
        slam.process_scan(header, xyz, pt)
        if s % 32 == 31:                 # deliberately delayed sync
            slam.sync_graph()
    slam.sync_graph()

    st = slam.odometry.state
    total = int(jax.device_get(st.kf_total))
    assert total > 3 * cfg.capacity.max_keyframes, \
        f"eviction not exercised (kf_total={total})"
    assert slam.sync_lost_keyframes == 0
    assert int(jax.device_get(slam.graph.n_nodes)) == total
    assert len(slam.archive) == total
