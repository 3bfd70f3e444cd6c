"""Profiling/tracing utilities — the framework's measurement discipline.

The reference hand-rolls per-scan wall timing + /proc sampling into a
terminal dashboard (odom.cc:743,828,1831-1869; runtime/metrics.py provides
that role here). This module adds the device-side layer the reference never
needed:

- ``slope_timer``: per-op device time as the SLOPE between a short and a
  long window of chained fresh-data ops, each window ended by a dependent
  fetch, so compile time and the fixed fetch overhead cancel.
- ``device_trace``: context manager around ``jax.profiler`` producing a
  TensorBoard-loadable trace directory (XLA op-level timeline), with a
  guard for backends that cannot serve the profiler; ``top_device_ops``
  reduces such a trace to the ops that took the most device time.
- ``StageTimer``: named-stage wall aggregation for host-side pipelines
  (replay loop, packet parsing), printable as a table.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict

__all__ = ["slope_timer", "device_trace", "device_busy", "top_device_ops",
           "StageTimer"]


def slope_timer(run_window: Callable[[int], None], *, n1: int = 3,
                n2: int = 9, warmup: int = 1) -> float:
    """Measure true per-op seconds of ``run_window(k)`` (which must execute
    ``k`` chained fresh-data ops and end with a dependent fetch).

    Returns seconds/op = (t(n2) - t(n1)) / (n2 - n1); compile time and the
    fixed fetch/round-trip overhead cancel in the difference.
    """
    if n2 <= n1:
        raise ValueError("n2 must exceed n1")
    run_window(warmup)
    t0 = time.perf_counter()
    run_window(n1)
    t1 = time.perf_counter()
    run_window(n2)
    t2 = time.perf_counter()
    return ((t2 - t1) - (t1 - t0)) / (n2 - n1)


@contextlib.contextmanager
def device_trace(logdir: str):
    """``with device_trace("/tmp/trace"):`` — wraps jax.profiler.trace,
    tolerating backends without profiler support (yields a bool flag)."""
    import jax

    started = False
    try:
        jax.profiler.start_trace(logdir)
        started = True
    except Exception:
        pass
    try:
        yield started
    finally:
        if started:
            try:
                jax.profiler.stop_trace()
            except Exception:
                pass


def _device_events(logdir: str):
    """Kernel events [(name, start_ns, duration_ns)] of the GPU planes
    (``/device:GPU:*``, one line per stream) in the newest
    ``jax.profiler`` trace under ``logdir``."""
    import glob

    from jax.profiler import ProfileData

    paths = sorted(glob.glob(os.path.join(logdir, "plugins", "profile", "*",
                                          "*.xplane.pb")))
    if not paths:
        raise FileNotFoundError(f"no trace under {logdir}")
    data = ProfileData.from_file(paths[-1])
    return [(ev.name, ev.start_ns, ev.duration_ns)
            for plane in data.planes
            if plane.name.startswith("/device:GPU")
            for line in plane.lines for ev in line.events]


def device_busy(logdir: str):
    """(busy_ns, window_ns) of the newest trace under ``logdir``: busy is
    the union of the kernel intervals, the window runs from the first
    kernel's start to the last one's end. Idle share = 1 - busy/window."""
    spans = sorted((s, s + d) for _, s, d in _device_events(logdir))
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy, spans[-1][1] - spans[0][0] if spans else 0.0


def top_device_ops(logdir: str, n: int = 15):
    """The ``n`` ops with the most device time in the newest
    ``jax.profiler`` trace under ``logdir``: [(name, total_ns, count)].
    Kernels XLA splits one op into (``sort_3__7``) count under the op's
    name."""
    import re

    totals: Dict[str, list] = {}
    for name, _, dur in _device_events(logdir):
        t = totals.setdefault(re.sub(r"__\d+$", "", name), [0.0, 0])
        t[0] += dur
        t[1] += 1
    ranked = sorted(totals.items(), key=lambda kv: -kv[1][0])[:n]
    return [(k, v[0], v[1]) for k, v in ranked]


class StageTimer:
    """Accumulate named host-side stage durations; render as a table.

    >>> st = StageTimer()
    >>> with st("parse"):
    ...     ...
    >>> print(st.table())
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def mean_ms(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1) * 1e3

    def snapshot(self) -> dict:
        """Copy of the cumulative totals/counts — callers diff successive
        snapshots for per-window stage attribution (soak artifact)."""
        return {"totals": dict(self.totals), "counts": dict(self.counts)}

    @staticmethod
    def delta(before: dict, after: dict) -> dict:
        """Stage table covering the interval between two snapshots."""
        out = {}
        for k, v in after["totals"].items():
            dv = v - before["totals"].get(k, 0.0)
            dc = after["counts"][k] - before["counts"].get(k, 0)
            if dc or dv > 1e-9:
                out[k] = {"calls": dc, "total_s": round(dv, 3)}
        return out

    def table(self) -> str:
        rows = ["stage                     calls   total_s   mean_ms"]
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            rows.append(f"{k:<25} {self.counts[k]:>5} "
                        f"{self.totals[k]:>9.3f} {self.mean_ms(k):>9.2f}")
        return "\n".join(rows)


# ---------------------------------------------------------------------------
# Roofline accounting (BASELINE "speed of light" quantification)
# ---------------------------------------------------------------------------

# device_kind -> (bf16 dense tensor-core TFLOP/s, f32 non-tensor TFLOP/s,
# HBM GB/s). NVIDIA H100 SXM data sheet, dense rates without sparsity, at
# the full 700 W power limit.
CHIP_PEAKS = {
    "NVIDIA H100 80GB HBM3": (989.0, 67.0, 3350.0),
}


def chip_peaks():
    """((bf16_tflops, f32_tflops, hbm_gbps), device_kind) of the attached
    device. A device missing from CHIP_PEAKS is an error."""
    import jax

    kind = jax.devices()[0].device_kind
    if kind not in CHIP_PEAKS:
        raise KeyError(f"no peak table for device kind {kind!r}")
    return CHIP_PEAKS[kind], kind


def roofline_report(name: str, seconds: float, flops: float | None = None,
                    bytes_moved: float | None = None) -> str:
    """One line of absolute utilization: achieved GFLOP/s / GB/s and the
    percent of the card's bf16 tensor-core / HBM peak (the BASELINE.md
    requirement that "fast" be measured against the hardware ceiling, not
    a prior attempt).

    ``flops``/``bytes_moved`` are per call; the caller states the counting
    basis (e.g. dense-equivalent FLOPs for a pruned kernel) at the call
    site."""
    peaks, _ = chip_peaks()
    parts = [f"{name:<34}"]
    if flops is not None:
        gf = flops / seconds / 1e9
        parts.append(f"{gf:10.1f} GFLOP/s")
        parts.append(f"({gf / (peaks[0] * 1e3) * 100:5.1f}% of "
                     f"{peaks[0]:.0f}T bf16 tensor)")
    if bytes_moved is not None:
        gb = bytes_moved / seconds / 1e9
        parts.append(f"{gb:8.1f} GB/s")
        parts.append(f"({gb / peaks[2] * 100:5.1f}% of "
                     f"{peaks[2]:.0f}GB/s HBM)")
    return " ".join(parts)
