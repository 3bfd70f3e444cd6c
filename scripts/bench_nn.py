"""Time the 1-NN engines on the GPU at the GICP shapes, then the odometry
end to end with each engine.

    python scripts/bench_nn.py [--json out/bench_nn.json]

Micro: 8192 queries against 65,536 and 262,144 Morton-sorted surface
targets (the submap of 32 keyframes x 8192 points), capped at the 0.5 m
correspondence radius and uncapped:

  kernel   ops.neighbors.nn1_kernel (Pallas through Triton), at several
           tile shapes
  xla      ops.neighbors._nn1_xla
  grid     ops.gridnn.grid_nn1 (the query; the index build is timed apart)

End to end: `cli slam` with the default config over chip_smoke's generated
32,768-point two-lap spiral (with its loop radius), per engine,
alternating; scans/s after the first scans (which compile). Then one
traced run of the default engine: device busy time, idle share and top
ops.

Times are host clock around calls that end in ``block_until_ready``;
median of the repeats. Needs a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from noetic_slam_tpu.ops import gridnn, neighbors  # noqa: E402
from noetic_slam_tpu.ops.pallas import nn_kernel  # noqa: E402
from noetic_slam_tpu.runtime.profiling import (device_busy,  # noqa: E402
                                               top_device_ops)

TILES = ((8, 512, 4), (16, 256, 4), (16, 512, 4), (16, 512, 8),
         (16, 1024, 4), (32, 512, 4))


def _time(fn, *args, reps=20):
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return float(np.median(ts)) * 1e3


def _clouds(rng, nt, nq=8192):
    from noetic_slam_tpu.utils.synthetic import surface_cloud

    tgt = surface_cloud(rng, nt, extent=30.0 * (nt / 65536) ** 0.5)
    qry = tgt[np.sort(rng.choice(nt, nq, replace=False))]
    qry = qry + rng.normal(scale=0.1, size=qry.shape)
    return jnp.asarray(qry, jnp.float32), jnp.asarray(tgt)


def micro(rng):
    rows = []
    for nt in (65536, 262144):
        q, t = _clouds(rng, nt)
        grid = gridnn.build_grid(t, jnp.ones((nt,), bool), 1.0)
        build = _time(jax.jit(lambda t: gridnn.build_grid(
            t, jnp.ones((nt,), bool), 1.0)), t)
        for cap in (0.5, None):
            md = None if cap is None else jnp.float32(cap)
            res = {"targets": nt, "cap_m": cap}
            res["xla_ms"] = _time(jax.jit(neighbors._nn1_xla), q, t)
            res["grid_ms"] = _time(jax.jit(gridnn.grid_nn1), q, grid)
            res["grid_build_ms"] = build
            for qt, tt, nw in TILES:
                f = jax.jit(functools.partial(nn_kernel.nn1_fused, q_tile=qt,
                                              t_tile=tt, num_warps=nw))
                try:
                    ms = _time(f, q, t, None, md)
                except jax.errors.JaxRuntimeError as e:   # refused tile
                    ms = f"failed: {str(e).splitlines()[0][:80]}"
                res[f"kernel_{qt}x{tt}w{nw}_ms"] = ms
            res["kernel_default_ms"] = _time(
                jax.jit(neighbors.nn1_kernel), q, t, None, md)
            rows.append(res)
            print(json.dumps(res), flush=True)
    return rows


def end_to_end(seed):
    """`cli slam --mulran --warmup` (the default config) over chip_smoke's
    two-lap spiral, per engine, in alternating order so that a drift
    in the card's state shows as asymmetry."""
    import contextlib
    import io

    from chip_smoke import SLAM_DRIVE_S, SLAM_LOOP_RADIUS, SLAM_SPIRAL
    from noetic_slam_tpu import cli
    from noetic_slam_tpu.config import params
    from noetic_slam_tpu.utils import synthetic
    from scripts.make_mulran_fixture import write_fixture

    os.makedirs(os.path.join(ROOT, ".scratch"), exist_ok=True)
    seq = tempfile.mkdtemp(dir=os.path.join(ROOT, ".scratch"))
    write_fixture(seq, duration=SLAM_DRIVE_S, hold=3.5, n_points=32768,
                  seed=seed, radar=False,
                  pose_fn=functools.partial(synthetic.spiral_pose_of,
                                            **SLAM_SPIRAL))
    xla = (lambda q, t, c=None, max_dist=None:
           neighbors._nn1_xla(q, t, c))
    grid_cfg = params.DlioConfig().replace(gicp=dataclasses.replace(
        params.DlioConfig().gicp, nn_engine="grid"))
    engines = {"kernel": (neighbors.nn1, params.load_config),
               "xla": (xla, params.load_config),
               "grid": (neighbors.nn1, lambda *a, **k: grid_cfg)}
    rows = []
    orig = neighbors.nn1, params.load_config
    try:
        # One untimed run per engine pays its compiles; then pairs in
        # alternating order.
        order = (["kernel", "grid", "xla"] + ["kernel", "grid", "grid",
                                              "kernel"] * 2 + ["xla"] * 2)
        for k, name in enumerate(order):
            neighbors.nn1, params.load_config = engines[name]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                cli.main(["slam", "--mulran", seq, "--warmup", "--out",
                          os.path.join(ROOT, ".scratch", "e2e_out"),
                          "--loop-radius", str(SLAM_LOOP_RADIUS)])
            run = json.loads(buf.getvalue().strip().splitlines()[-1])
            res = {"engine": name, "warm": k >= 3, **{
                key: run.get(key) for key in (
                "scans", "scans_per_s", "scans_per_s_after_warmup",
                "warmup_s", "loop_closures", "ate_rmse_m")}}
            rows.append(res)
            print(json.dumps(res), flush=True)
        # The default engine once more under the profiler: what the device
        # does during the whole-system run.
        neighbors.nn1, params.load_config = engines["kernel"]
        trace = os.path.join(ROOT, ".scratch", "trace_slam")
        with jax.profiler.trace(trace), \
                contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            cli.main(["slam", "--mulran", seq, "--warmup", "--out",
                      os.path.join(ROOT, ".scratch", "e2e_out"),
                      "--loop-radius", str(SLAM_LOOP_RADIUS)])
            wall = time.perf_counter() - t0
        busy, window = device_busy(trace)
        rows.append({"traced_wall_s": wall, "device_busy_s": busy / 1e9,
                     "device_window_s": window / 1e9,
                     "device_idle_share": 1.0 - busy / window,
                     "top_ops_ms": [(n[:60], ns / 1e6, c) for n, ns, c in
                                    top_device_ops(trace, 12)]})
        print(json.dumps(rows[-1]), flush=True)
    finally:
        neighbors.nn1, params.load_config = orig
        shutil.rmtree(seq, ignore_errors=True)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--json", default=os.path.join(ROOT, "out",
                                                   "bench_nn.json"))
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--skip-e2e", action="store_true")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench_nn: needs a GPU, found {dev.platform}")
    from noetic_slam_tpu.runtime import compile_cache

    compile_cache.enable()
    rng = np.random.default_rng(args.seed)
    out = {"device": dev.device_kind, "micro": micro(rng)}
    if not args.skip_e2e:
        out["end_to_end"] = end_to_end(args.seed)
    os.makedirs(os.path.dirname(args.json), exist_ok=True)
    with open(args.json, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
