import numpy as np
import jax
import jax.numpy as jnp
import pytest
from scipy.spatial.transform import Rotation

from noetic_slam_tpu.config.params import GicpConfig
from noetic_slam_tpu.ops import gicp
from noetic_slam_tpu.parallel.mesh import make_mesh
from noetic_slam_tpu.parallel.registration import sharded_gicp_align
from tests.test_gicp import _surface_cloud


@pytest.fixture(scope="module")
def mesh8():
    assert jax.device_count() >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(8)


def test_sharded_gicp_matches_single_device(rng, mesh8):
    tgt = _surface_cloud(rng, n=1536)  # divides 8
    T_true = np.eye(4, dtype=np.float32)
    T_true[:3, :3] = Rotation.from_rotvec([0.015, -0.02, 0.03]).as_matrix()
    T_true[:3, 3] = [0.1, -0.07, 0.05]
    inv = np.linalg.inv(T_true)
    src = (tgt @ inv[:3, :3].T + inv[:3, 3]).astype(np.float32)[:1024]

    sv = jnp.ones((src.shape[0],), bool)
    tv = jnp.ones((tgt.shape[0],), bool)
    src_cov, _ = gicp.plane_covariances(jnp.asarray(src), sv, k=8)
    tgt_cov, _ = gicp.plane_covariances(jnp.asarray(tgt), tv, k=8)

    cfg = GicpConfig(max_corr_dist=1.0)
    ref = gicp.gicp_align(jnp.asarray(src), sv, src_cov, jnp.asarray(tgt),
                          tgt_cov, cfg)
    got = sharded_gicp_align(mesh8, jnp.asarray(src), sv, src_cov,
                             jnp.asarray(tgt), tgt_cov, cfg)
    assert bool(got.converged)
    np.testing.assert_allclose(np.asarray(got.T), np.asarray(ref.T),
                               atol=2e-4)
    # and it actually recovers the transform
    resid = np.linalg.inv(T_true) @ np.asarray(got.T)
    assert np.abs(resid[:3, 3]).max() < 2e-2


def test_sharded_posegraph_matches_single_device(rng, mesh8):
    from noetic_slam_tpu.models import posegraph as pg
    from noetic_slam_tpu.parallel.bundle_adjustment import sharded_optimize
    from tests.test_posegraph import _circle_graph

    gt_q, gt_p, est_q, est_p, edges = _circle_graph(rng=rng)
    g = pg.init_graph(16, 32)  # 32 edges divide 8 devices
    for k in range(len(gt_q)):
        g = pg.add_node(g, jnp.asarray(est_q[k], jnp.float32),
                        jnp.asarray(est_p[k], jnp.float32))
    for (i, j, dq, dp) in edges:
        g = pg.add_edge(g, jnp.int32(i), jnp.int32(j),
                        jnp.asarray(dq, jnp.float32),
                        jnp.asarray(dp, jnp.float32))

    ref = pg.optimize(g, iters=10)
    got = sharded_optimize(mesh8, g, iters=10)
    np.testing.assert_allclose(np.asarray(got.node_p),
                               np.asarray(ref.node_p), atol=1e-4)
    dots = np.abs(np.sum(np.asarray(got.node_q) * np.asarray(ref.node_q),
                         axis=-1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-6)


def test_sharded_cg_matches_single_device_large(rng, mesh8):
    """The distributed large-graph path (edge-sharded matrix-free PCG,
    psum-combined matvec) must match the single-device CG solver on a
    km-soak-scale graph (>1,000 nodes) — the regime where the dense
    sharded path would psum a replicated (6K)^2 matrix per GN step."""
    from noetic_slam_tpu.models import posegraph as pg
    from noetic_slam_tpu.parallel.bundle_adjustment import sharded_optimize

    K, E = 1200, 2048                      # 2048 edges divide 8 devices
    # noisy circle chain + a handful of loop-closure edges
    th = np.linspace(0, 4 * np.pi, K).astype(np.float32)
    gt_p = np.stack([30 * np.cos(th), 30 * np.sin(th),
                     0.1 * th], -1).astype(np.float32)
    est_p = gt_p + rng.normal(scale=0.15, size=(K, 3)).astype(np.float32)
    qs = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (K, 1))

    g = pg.init_graph(K, E)
    g = pg.add_nodes_chain(g, qs, est_p, K)
    # chain edges measure the noisy relative poses; add loop edges with the
    # TRUE relative translation so optimization actually moves nodes
    for (i, j) in [(0, 600), (100, 700), (200, 800), (50, 1150)]:
        dq, dp = pg.relative_pose(
            jnp.asarray(qs[i]), jnp.asarray(gt_p[i]),
            jnp.asarray(qs[j]), jnp.asarray(gt_p[j]))
        g = pg.add_edge(g, jnp.int32(i), jnp.int32(j), dq, dp,
                        w_rot=2.0, w_trans=2.0)

    ref = pg.optimize(g, iters=3, method="cg", cg_iters=60)
    got = sharded_optimize(mesh8, g, iters=3, method="cg", cg_iters=60)
    assert int(got.n_nodes) == K
    np.testing.assert_allclose(np.asarray(got.node_p),
                               np.asarray(ref.node_p), atol=1e-3)
    dots = np.abs(np.sum(np.asarray(got.node_q) * np.asarray(ref.node_q),
                         axis=-1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-5)
    # and the solve genuinely reduced the graph cost
    assert float(pg.graph_cost(got)) < 0.5 * float(pg.graph_cost(g))


def test_batched_odometry_matches_sequential(rng, mesh8):
    """4 independent sequences via vmap+batch sharding == 4 sequential
    runs."""
    from noetic_slam_tpu.config.params import CapacityConfig, DlioConfig
    from noetic_slam_tpu.models.odometry import init_state, make_odometry_step
    from noetic_slam_tpu.parallel import batch as pb
    from noetic_slam_tpu.parallel.mesh import make_mesh
    from __graft_entry__ import _example_input, _tiny_cfg

    cfg = _tiny_cfg()
    mesh = make_mesh(4, axis="batch")
    B = 4
    inputs = [[_example_input(cfg, seed=b * 10 + s, header=0.0 if s == 0
                              else 0.1) for s in range(3)] for b in range(B)]

    # sequential reference
    step = jax.jit(make_odometry_step(cfg))
    seq_p = []
    for b in range(B):
        st = init_state(cfg)
        for s in range(3):
            st, out = step(st, inputs[b][s])
        seq_p.append(np.asarray(out.lidar_p))

    # batched + sharded
    bstep = pb.make_batched_odometry_step(cfg)
    bst = pb.shard_batched(mesh, pb.init_batched_state(cfg, B))
    for s in range(3):
        binp = pb.shard_batched(mesh, jax.tree.map(
            lambda *xs: jnp.stack(xs), *[inputs[b][s] for b in range(B)]))
        bst, bout = bstep(bst, binp)
    got = np.asarray(bout.lidar_p)
    np.testing.assert_allclose(got, np.stack(seq_p), atol=1e-4)


def test_sharded_tsdf_matches_single_device(rng, mesh8):
    from noetic_slam_tpu.config.params import TsdfConfig
    from noetic_slam_tpu.models import tsdf as T
    from noetic_slam_tpu.parallel.tsdf import (gather_sharded_state,
                                               init_sharded_tsdf,
                                               make_sharded_integrate)

    cfg = TsdfConfig(voxel_size=0.1, truncation=0.3, max_blocks=4096,
                     space_carving=False, max_range=30.0)
    pts = np.c_[np.full(2000, 5.0), rng.uniform(-2, 2, 2000),
                rng.uniform(-2, 2, 2000)].astype(np.float32)
    valid = jnp.ones((2000,), bool)
    origin = jnp.zeros(3)

    ref = T.init_tsdf(cfg)
    for _ in range(2):
        ref = T.integrate(cfg, ref, jnp.asarray(pts), valid, origin)

    st = init_sharded_tsdf(cfg, mesh8)
    integ = make_sharded_integrate(cfg, mesh8)
    for _ in range(2):
        st = integ(st, jnp.asarray(pts), valid, origin)
    merged = gather_sharded_state(cfg, st, mesh8)

    assert int(merged.num_blocks) == int(ref.num_blocks)

    # compare per-voxel tsdf/weight via surface extraction on both
    c1, d1, m1 = T.extract_surface(cfg, ref)
    c2, d2, m2 = T.extract_surface(cfg, merged)
    s1 = np.asarray(c1)[np.asarray(m1)]
    s2 = np.asarray(c2)[np.asarray(m2)]
    # same surface voxel set
    set1 = {tuple(np.round(r, 4)) for r in s1}
    set2 = {tuple(np.round(r, 4)) for r in s2}
    assert set1 == set2


def test_sharded_tsdf_outgrows_one_shard(rng, mesh8):
    """A map larger than one shard's capacity (max_blocks / 8), built over
    two scans: each shard numbers payload slots from its own block count,
    so the counters stay sane and every voxel matches single-device
    integrate."""
    from noetic_slam_tpu.config.params import TsdfConfig
    from noetic_slam_tpu.models import tsdf as T
    from noetic_slam_tpu.parallel.tsdf import (gather_sharded_state,
                                               init_sharded_tsdf,
                                               make_sharded_integrate)

    cfg = TsdfConfig(voxel_size=0.1, truncation=0.3, max_blocks=4096,
                     space_carving=False, max_range=30.0)
    n = 12000
    origin = jnp.zeros(3)
    valid = jnp.ones((n,), bool)
    # a 24 x 24 m floor, its two halves seen by two scans (blocks shard
    # by x, so the floor spreads over every shard)
    scans = [np.c_[rng.uniform(lo, lo + 12, n), rng.uniform(-12, 12, n),
                   np.full(n, -1.5)].astype(np.float32)
             for lo in (-12.0, 0.0)]

    ref = T.init_tsdf(cfg)
    st = init_sharded_tsdf(cfg, mesh8)
    integ = make_sharded_integrate(cfg, mesh8)
    for pts in scans:
        ref = T.integrate(cfg, ref, jnp.asarray(pts), valid, origin)
        st = integ(st, jnp.asarray(pts), valid, origin)
    merged = gather_sharded_state(cfg, st, mesh8)

    assert int(ref.num_blocks) > 2 * cfg.max_blocks // 8
    assert int(ref.dropped) == 0 and int(merged.dropped) == 0
    assert int(merged.num_blocks) == int(ref.num_blocks)

    def voxels(s):
        keys, slots = np.asarray(s.dir_keys), np.asarray(s.dir_slots)
        ok = keys != np.iinfo(np.int32).max
        w = np.asarray(s.weight).reshape(-1, 512)
        ws = np.asarray(s.wsum).reshape(-1, 512)
        return {k: (w[i], ws[i]) for k, i in zip(keys[ok], slots[ok])}

    a, b = voxels(ref), voxels(merged)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k][0], a[k][0], rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(b[k][1], a[k][1], rtol=1e-5, atol=1e-5)


def _align_hlo_reduce_stats(ndev: int, nq: int, nt: int):
    """(all-gather count, total all-reduce elements) of the compiled
    sharded-align SPMD program."""
    import re

    from noetic_slam_tpu.parallel import registration as reg
    from noetic_slam_tpu.parallel.mesh import make_mesh

    cfg = GicpConfig()
    mesh = make_mesh(ndev, axis="map")
    args = (jnp.zeros((nq, 3)), jnp.ones((nq,), bool), jnp.zeros((nq, 6)),
            jnp.zeros((nt, 3)), jnp.zeros((nt, 6)))
    lowered = jax.jit(
        lambda *a: reg.sharded_gicp_align(mesh, *a, cfg)).lower(*args)
    hlo = lowered.compile().as_text()
    # HLO text puts the result shape BEFORE the op name:
    # `%x = f32[512]{0} all-reduce(` (tuple-shaped for fused reductions).
    gathers = re.findall(r"all-gather\(", hlo)
    reduces = re.findall(r"= ((?:\([^)]*\))|(?:[a-z0-9]+\[[0-9,]*\]))"
                         r"[^\n=]*? all-reduce(?:-start)?\(", hlo)
    total_elems = 0
    for shape in reduces:
        for dims in re.findall(r"\[([0-9,]*)\]", shape):
            total_elems += int(np.prod([int(x) for x in dims.split(",")]
                                       if dims else [1]))
    return len(gathers), total_elems


def test_collective_traffic_matches_hlo():
    """The O(1)-traffic contract, pinned against the compiled SPMD program:
    the NN winner selection must compile to all-REDUCES only (no
    all-gather — the r3 design's gather made per-device traffic O(ndev)),
    with a per-relinearize element count matching the analytical budget and
    INDEPENDENT of device count."""
    from noetic_slam_tpu.parallel import registration as reg

    cfg = GicpConfig()
    nq, nt = 512, 2048
    budget = reg.collective_traffic_per_align(cfg, nq, 8)

    gathers8, elems8 = _align_hlo_reduce_stats(8, nq, nt)
    assert gathers8 == 0, "NN winner selection must not all-gather"
    # d (nq) + win id (nq) + pt (3nq) + cv (6nq) + H/b/err/n (44) per
    # relinearize, plus a handful of scalar loop-control reductions.
    want = budget["per_relinearize_reduce_elements"]
    assert want <= elems8 <= want + 64, (elems8, want)

    # flat in device count: same reduce elements at D = 4
    gathers4, elems4 = _align_hlo_reduce_stats(4, nq, nt)
    assert gathers4 == 0
    assert elems4 == elems8, (elems4, elems8)
