"""Time TSDF integrate at the default config and list its top device ops.

    python scripts/profile_tsdf.py [--trace-dir out/trace_tsdf]

Integrates 32,768-point scans of a surface scene (0.1 m voxels, carving,
65,536 blocks) into a warm volume. Times ``integrate`` with the host clock
around calls that end in ``block_until_ready`` (median of the repeats),
then traces a few calls with ``jax.profiler`` and prints the device ops
that took the most time in the trace.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from noetic_slam_tpu.config.params import TsdfConfig  # noqa: E402
from noetic_slam_tpu.models import tsdf as T  # noqa: E402
from noetic_slam_tpu.runtime.profiling import top_device_ops  # noqa: E402
from noetic_slam_tpu.utils.synthetic import surface_cloud  # noqa: E402

N = 32768


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace-dir",
                    default=os.path.join(ROOT, "out", "trace_tsdf"))
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    cfg = TsdfConfig()
    rng = np.random.default_rng(0)
    base = surface_cloud(rng, 4 * N, extent=30.0)
    scans = [jnp.asarray(base[rng.choice(len(base), N, replace=False)])
             for _ in range(4)]
    valid = jnp.ones((N,), bool)
    origin = jnp.asarray([0.0, 0.0, 1.0])

    st = T.init_tsdf(cfg)
    for pts in scans:                      # warm: directory populated
        st = T.integrate(cfg, st, pts, valid, origin)
    jax.block_until_ready(st)
    print(f"device={jax.devices()[0].device_kind} "
          f"blocks={int(st.num_blocks)} dropped={int(st.dropped)}")

    ts = []
    for i in range(args.reps):
        t = time.perf_counter()
        st = T.integrate(cfg, st, scans[i % 4], valid, origin)
        jax.block_until_ready(st)
        ts.append(time.perf_counter() - t)
    print(f"integrate: median {np.median(ts) * 1e3:.3f} ms, min "
          f"{np.min(ts) * 1e3:.3f} ms over {args.reps} calls")

    with jax.profiler.trace(args.trace_dir):
        for i in range(5):
            st = T.integrate(cfg, st, scans[i % 4], valid, origin)
        jax.block_until_ready(st)
    for name, ns, count in top_device_ops(args.trace_dir, n=15):
        print(f"  {ns / 5e6:9.3f} ms/call  x{count // 5:<4d} {name}")


if __name__ == "__main__":
    main()
