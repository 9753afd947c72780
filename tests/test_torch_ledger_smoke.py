"""``scripts/torch_ledger_smoke.sh`` on the CPU: the four steps of
``scripts/ledger_smoke.sh`` on the port — the gap table and its
reconcile, the dumped trace's ledger section, ``tools/torch_perf_gate.py``
passing on the fleet step and tripping on a seeded 20% slowdown, and the
instruments' overhead gates GREEN with a seeded 20% ledger-overhead
regression tripping the gate."""

import os
import re
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_ledger_smoke_passes_on_the_cpu():
    env = dict(os.environ, SMOKE_DEVICE="cpu", OMP_NUM_THREADS="2",
               LEDGER_SMOKE_TIMEOUT="300")
    proc = subprocess.run(["bash", "scripts/torch_ledger_smoke.sh"],
                          cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=700)
    out = proc.stdout
    assert proc.returncode == 0, out[-6000:] + proc.stderr[-6000:]
    assert re.search(r"^two_worker_fleet_ms=[0-9.]+$", out, re.M), out
    assert "perf gate: FAILED on two_worker_fleet_ms" in out, out
    assert "overhead gates: all GREEN" in out, out
    assert "perf gate: FAILED on ledger_overhead_pct" in out, out
    assert out.rstrip().endswith("ledger smoke: PASS"), out
