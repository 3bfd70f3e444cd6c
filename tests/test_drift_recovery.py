"""CPU-tiny regression of the descriptor-led drift-recovery soak
(scripts/soak_drift.py — VERDICT r4 item #2).

The full artifact (SOAK_r05_drift.json) is produced on the chip; this CI
twin pins the same capability at miniature scale: a sparse-geometry
excursion accumulates multi-meter REAL drift, proximity detection cannot
fire at the revisit (drift > loop_radius), and the FIRST applied closure
is descriptor-sourced with BOTH sides dequantized from the archive
(resident store long since evicted), passes the drift-budget gate, and
drops the trajectory error back to the healthy band with the archive
re-fusing the moved keyframes.
"""

import json
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_drift_recovery_tiny(tmp_path):
    out = tmp_path / "drift.json"
    # CPU-only child: one JAX process per GPU at most.
    env = dict(os.environ, DRIFT_TINY="1", DRIFT_OUT=str(out),
               JAX_PLATFORMS="cpu",
               NOETIC_SLAM_NO_CACHE="1")
    r = subprocess.run(
        [sys.executable, os.path.join(_REPO, "scripts", "soak_drift.py")],
        env=env, cwd=_REPO, capture_output=True, text=True, timeout=2200)
    assert r.returncode == 0, \
        f"--- stdout:\n{r.stdout[-4000:]}\n--- stderr:\n{r.stderr[-4000:]}"
    d = json.loads(out.read_text())
    assert all(d["checks"].values()), d["checks"]
    voxel = d["voxel_m"]
    recovery = next(c for c in d["closures"]
                    if c["correction_m"] >= 10 * voxel)
    assert recovery["source"] == "descriptor"
    assert recovery["cand_archived"]
    # the recovery re-fused a substantial slice of the archived history
    assert recovery["moved_keyframes"] >= 0.3 * d["archived_keyframes"]
    # drift genuinely exceeded what proximity detection could bridge
    assert d["peak_drift_m"] > 2.0
