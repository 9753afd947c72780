"""``scripts/torch_elastic_smoke.sh`` on the CPU: the two steps of
``scripts/elastic_smoke.sh`` on the port — a worker killed mid-run, one
live migration with the undisturbed trajectory and the migration alert
counted, ``migration_stall_ms=`` printed, and ``tools/torch_perf_gate.py``
passing on it and tripping on a seeded 50% stall regression."""

import os
import re
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_elastic_smoke_passes_on_the_cpu():
    env = dict(os.environ, SMOKE_DEVICE="cpu", OMP_NUM_THREADS="2",
               ELASTIC_SMOKE_TIMEOUT="300")
    proc = subprocess.run(["bash", "scripts/torch_elastic_smoke.sh"],
                          cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=700)
    out = proc.stdout
    assert proc.returncode == 0, out[-6000:] + proc.stderr[-6000:]
    assert re.search(r"migrations_started\s+1", out), out
    assert re.search(r"^migration_stall_ms=[0-9.]+$", out, re.M), out
    assert "perf gate: OK" in out
    assert "perf gate: FAILED on migration_stall_ms" in out, out
    assert out.rstrip().endswith("elastic smoke: PASS"), out
