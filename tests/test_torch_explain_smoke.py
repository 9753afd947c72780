"""``scripts/torch_explain_smoke.sh`` on the CPU: the three steps of
``scripts/explain_smoke.sh`` on the port — the exploration ledger
complete on the fleet fixture, two identical explores of the 4-layer
1024-wide MLP over 8 devices diffing empty and ``HBM_GB=0.024`` flipping
the winner with a named driver, and ``tools/torch_perf_gate.py`` passing
on ``explore_report_ms``, tripping on a seeded 50% regression and on the
uncovered winner flip."""

import os
import re
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_explain_smoke_passes_on_the_cpu():
    env = dict(os.environ, SMOKE_DEVICE="cpu", OMP_NUM_THREADS="2",
               EXPLAIN_SMOKE_TIMEOUT="300")
    proc = subprocess.run(["bash", "scripts/torch_explain_smoke.sh"],
                          cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=700)
    out = proc.stdout
    assert proc.returncode == 0, out[-6000:] + proc.stderr[-6000:]
    assert "plan_explain check OK" in out, out
    assert "plan_diff check OK (no winner flip)" in out, out
    assert "plan_diff --expect-flip OK (driver: memory_feasible)" in out
    assert re.search(r"^explore_report_ms=[0-9.]+$", out, re.M), out
    assert "perf gate: FAILED on explore_report_ms" in out, out
    assert "perf gate: FAILED on plan_winner_flip" in out, out
    assert out.rstrip().endswith("explain smoke: PASS"), out
