"""``scripts/torch_controlplane_smoke.sh`` on the CPU: the four steps of
``scripts/controlplane_smoke.sh`` on the port — the master SIGKILLed and
its gRPC worker fleet re-adopted from the WAL with a bit-identical merged
trajectory (``master_recover_ms=``), the WAL's cost gate GREEN, and ``tools/torch_perf_gate.py``
passing on the recorded values and tripping on a seeded 50% recovery
regression. Step 2 (the port's epoch-fence and torn-WAL tests) is
skipped: the suite runs them."""

import os
import re
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_controlplane_smoke_passes_on_the_cpu():
    env = dict(os.environ, SMOKE_DEVICE="cpu", OMP_NUM_THREADS="2",
               SMOKE_SKIP_REPEATS="1",
               CONTROLPLANE_SMOKE_TIMEOUT="300")
    proc = subprocess.run(["bash", "scripts/torch_controlplane_smoke.sh"],
                          cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=700)
    out = proc.stdout
    assert proc.returncode == 0, out[-6000:] + proc.stderr[-6000:]
    assert re.search(r"^master_recover_ms=[0-9.]+$", out, re.M), out
    assert "skipped (SMOKE_SKIP_REPEATS): the test suite runs these tests" \
        in out, out
    assert "wal_overhead_pct" in out and "overhead gates: all GREEN" in out
    assert "perf gate: OK" in out
    assert "perf gate: FAILED on master_recover_ms" in out, out
    assert out.rstrip().endswith("controlplane smoke: PASS"), out
