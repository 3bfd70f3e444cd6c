"""CPU-tiny regression of the long-soak harness (scripts/soak.py).

The full artifact (SOAK_r{N}.json) is produced on the chip; this pins the
same long-run properties at miniature scale on every CI run: eviction
active, pose-graph growth past the initial capacity, closure(s) applied
through the keyframe archive, monotone archive coverage, and a
bitwise-identical checkpoint/resume continuation.
"""

import json
import os
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_soak_tiny_regression(tmp_path):
    out = tmp_path / "soak.json"
    # CPU-only child: one JAX process per GPU at most.
    env = dict(os.environ, SOAK_TINY="1", SOAK_OUT=str(out),
               JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, os.path.join(_REPO, "scripts", "soak.py")],
        env=env, cwd=_REPO, capture_output=True, text=True, timeout=1700)
    assert r.returncode == 0, f"--- stdout:\n{r.stdout}\n--- stderr:\n{r.stderr}"
    data = json.loads(out.read_text())
    assert data["eviction_active"]
    assert data["graph_nodes"] > 16          # grew past the shrunken init
    assert data["graph_node_capacity"] >= data["graph_nodes"]
    assert data["loop_closures_applied"] >= 1
    assert data["checkpoint_resume_bitwise"] is True
    assert data["archive_blocks_monotone"]
    assert data["archived_keyframes"] == data["graph_nodes"]
    assert data["ate_rmse_m"] < 0.5
    # km-failure-mode CI twins (VERDICT r3 #9): keyframe hand-off lossless
    # at the soak's sync cadence, and every keyframe ever created reached
    # the graph (the outbox contract)
    assert data["sync_lost_keyframes"] == 0
    assert data["kf_total_minus_graph_nodes"] == 0
