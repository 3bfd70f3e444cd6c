"""Multi-process (multi-host stand-in) mesh simulation.

SURVEY §4(c) requires multi-host behavior be testable without a pod: this
script spawns N OS processes, each a `jax.distributed` participant with K
virtual CPU devices, forming an (N*K)-device GLOBAL mesh whose collectives
must cross a real process boundary — the DCN stand-in. It then executes:

1. the map-sharded odometry step (parallel.registration.sharded_gicp_align:
   (pmin, pmin, masked-psum) NN winner reduction + psum'd normal
   equations) over a 1-D "map" mesh spanning BOTH processes — every GICP
   collective crosses the process boundary;
2. the spatially-sharded TSDF integrate over the same mesh;
3. a 2-D ("batch","map") mesh psum sanity check (batch rides the process
   axis, as hosts/DCN would — parallel.mesh.make_mesh_2d convention);
4. the edge-sharded matrix-free PCG pose-graph solve
   (parallel.bundle_adjustment.sharded_optimize, method="cg") on a
   300-node graph, checked against the single-device CG result in every
   process — the km-scale closure-stack solver across the DCN stand-in.

Parent usage (spawns workers, checks their output):
    python scripts/multihost_sim.py            # 2 procs x 4 devices
    python scripts/multihost_sim.py --procs 2 --local-devices 4
Exit code 0 = every process ran all three phases and agreed on results.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(args) -> int:
    import jax

    jax.distributed.initialize(coordinator_address=args.coordinator,
                               num_processes=args.procs,
                               process_id=args.worker)
    import jax.numpy as jnp
    import numpy as np

    assert jax.device_count() == args.procs * args.local_devices
    assert jax.local_device_count() == args.local_devices

    sys.path.insert(0, REPO)
    from jax.sharding import NamedSharding, PartitionSpec as P

    import __graft_entry__ as ge
    from noetic_slam_tpu.models.odometry import init_state, make_odometry_step
    from noetic_slam_tpu.parallel.mesh import make_mesh, make_mesh_2d
    from noetic_slam_tpu.parallel.registration import sharded_gicp_align

    cfg = ge._tiny_cfg()
    n_dev = jax.device_count()
    mesh = make_mesh(n_dev, axis="map")   # spans BOTH processes

    def align(src_xyz, src_valid, src_cov, tgt_xyz, tgt_cov, gicp_cfg,
              max_corr_dist=None, target_grid=None, target_count=None):
        return sharded_gicp_align(mesh, src_xyz, src_valid, src_cov,
                                  tgt_xyz, tgt_cov, gicp_cfg,
                                  max_corr_dist=max_corr_dist)

    step = make_odometry_step(cfg, align_fn=align)
    state = init_state(cfg)
    shardings = type(state)(
        **{k: NamedSharding(mesh, P()) for k in state._fields})
    shardings = shardings._replace(
        submap_xyz=NamedSharding(mesh, P("map")),
        submap_valid=NamedSharding(mesh, P("map")),
        submap_cov=NamedSharding(mesh, P("map")))
    state = jax.device_put(state, shardings)
    jstep = jax.jit(step, in_shardings=(shardings, None),
                    out_shardings=(shardings, None), donate_argnums=(0,))

    # bootstrap, then a registration step whose NN search + 6x6 normal
    # equations psum over the cross-process map axis
    state, out1 = jstep(state, ge._example_input(cfg, seed=0, header=0.0))
    state, out2 = jstep(state, ge._example_input(cfg, seed=1, header=0.1))
    jax.block_until_ready((state, out2))
    assert bool(out1.processed) and bool(out2.processed)
    ncorr = int(out2.num_corr)      # replicated output
    assert ncorr > 64, f"registration found only {ncorr} correspondences"

    # sharded TSDF over the same cross-process mesh
    from noetic_slam_tpu.parallel.tsdf import (init_sharded_tsdf,
                                               make_sharded_integrate)

    tcfg = cfg.tsdf.__class__(voxel_size=0.2, truncation=0.6,
                              max_blocks=(1024 // n_dev) * n_dev,
                              space_carving=False)
    ts = init_sharded_tsdf(tcfg, mesh)
    integ = make_sharded_integrate(tcfg, mesh)
    inp = ge._example_input(cfg, seed=3)
    ts = integ(ts, inp.xyz, inp.valid, jnp.zeros(3))
    jax.block_until_ready(ts.weight)
    blocks = int(ts.num_blocks)
    assert blocks > 0

    # 2-D ("batch","map") mesh: batch = process axis (the DCN row). An
    # explicit shard_map psum over BOTH axes must cross the process
    # boundary and agree in every process.
    from jax.experimental.shard_map import shard_map

    mesh2 = make_mesh_2d(n_map=args.local_devices, n_batch=args.procs)
    x = jax.device_put(
        np.arange(n_dev, dtype=np.float32).reshape(args.procs,
                                                   args.local_devices),
        NamedSharding(mesh2, P("batch", "map")))
    psummed = jax.jit(shard_map(
        lambda v: jax.lax.psum(jax.lax.psum(jnp.sum(v), "map"), "batch"),
        mesh=mesh2, in_specs=P("batch", "map"), out_specs=P()))(x)
    s = float(psummed)
    assert s == n_dev * (n_dev - 1) / 2.0, s

    # edge-sharded matrix-free CG solve across the process boundary,
    # parity-checked against the single-device CG solver
    from noetic_slam_tpu.models import posegraph as pg
    from noetic_slam_tpu.parallel.bundle_adjustment import sharded_optimize

    K, E = 300, (512 // n_dev) * n_dev
    th = np.linspace(0, 2 * np.pi, K).astype(np.float32)
    est_p = np.stack([12 * np.cos(th), 12 * np.sin(th), 0 * th],
                     -1).astype(np.float32)
    est_p += np.random.default_rng(9).normal(
        scale=0.08, size=est_p.shape).astype(np.float32)
    qs = np.tile(np.asarray([1.0, 0, 0, 0], np.float32), (K, 1))
    g = pg.init_graph(K, E)
    g = pg.add_nodes_chain(g, qs, est_p, K)
    dq, dp = pg.relative_pose(
        jnp.asarray(qs[0]), jnp.asarray(est_p[0]),
        jnp.asarray(qs[K - 1]), jnp.asarray(est_p[K - 1]))
    g = pg.add_edge(g, jnp.int32(0), jnp.int32(K - 1), dq, dp,
                    w_rot=2.0, w_trans=2.0)
    ref = pg.optimize(g, iters=3, method="cg", cg_iters=50)
    got = sharded_optimize(mesh, g, iters=3, method="cg", cg_iters=50)
    dp_max = float(jnp.max(jnp.linalg.norm(
        got.node_p - ref.node_p, axis=-1)))
    assert dp_max < 1e-3, dp_max

    print(json.dumps({"proc": args.worker, "ncorr": ncorr,
                      "tsdf_blocks": blocks, "mesh2_sum": s,
                      "cg_parity_max_dp": round(dp_max, 6)}), flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--coordinator", default=None)
    args = ap.parse_args()

    if args.worker is not None:
        return worker(args)

    with socket.socket() as s:       # pick a free coordinator port
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    # Workers stay on the CPU: a JAX process reserves most of a GPU's
    # memory when it first uses it, so several workers cannot share one.
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          f" --xla_force_host_platform_device_count="
                          f"{args.local_devices}").strip())
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__),
         "--procs", str(args.procs),
         "--local-devices", str(args.local_devices),
         "--worker", str(i), "--coordinator", f"localhost:{port}"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(args.procs)]
    results = []
    rc = 0
    for i, p in enumerate(procs):
        try:
            out, err = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
            rc = 1
        if p.returncode != 0:
            rc = 1
            sys.stderr.write(f"worker {i} failed:\n{err[-3000:]}\n")
        for line in out.splitlines():
            if line.startswith("{"):
                results.append(json.loads(line))
    if rc == 0:
        # every process must report, and the replicated results must agree
        assert len(results) == args.procs, results
        assert len({r["ncorr"] for r in results}) == 1, results
        assert len({r["tsdf_blocks"] for r in results}) == 1, results
        print(json.dumps({"ok": True, "procs": args.procs,
                          "global_devices": args.procs * args.local_devices,
                          **{k: results[0][k]
                             for k in ("ncorr", "tsdf_blocks")}}))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
