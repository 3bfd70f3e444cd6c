"""Short-duration regression of the live-ingest endurance harness
(scripts/endurance.py). The >= 60 s artifact (ENDURANCE_r{N}.json) is
produced standalone; this pins the same invariants in ~8 s per CI run:
zero scan corruption under injected loss/reorder/jitter, zero native-ring
drops at the 2048x20 packet rate, and missing columns bounded exactly by
the injected loss."""

import json
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_endurance_short(tmp_path):
    from noetic_slam_tpu.runtime import native

    if native.load() is None:
        pytest.skip("native toolchain unavailable")
    out = tmp_path / "endurance.json"
    # CPU-only child: one JAX process per GPU at most.
    env = dict(os.environ, ENDURANCE_SECS="8", ENDURANCE_OUT=str(out),
               ENDURANCE_PORT="47951", JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(_REPO, "scripts", "endurance.py")],
        env=env, cwd=_REPO, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, f"--- stdout:\n{r.stdout}\n--- stderr:\n{r.stderr}"
    d = json.loads(out.read_text())
    assert d["corrupt_pixels"] == 0
    assert d["native_ring_dropped"] == 0
    assert d["scans_assembled"] >= 8 * 20 - 3
    assert d["missing_columns"] <= d["missing_columns_bound"]
    assert d["packets_sent"] > 30000          # ~2048x20 rate sustained
