"""``scripts/torch_watch_smoke.sh`` on the CPU: the four steps of
``scripts/watch_smoke.sh`` on the port — no alert on the clean baseline,
the straggler and the loss spike on the faulted demo, the NaN page, the
watchtower's overhead gate GREEN, and ``tools/torch_perf_gate.py``
tripping on a seeded 30% regression and naming the vanished key."""

import os
import re
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_watch_smoke_passes_on_the_cpu():
    env = dict(os.environ, SMOKE_DEVICE="cpu", OMP_NUM_THREADS="2",
               WATCH_SMOKE_TIMEOUT="300")
    proc = subprocess.run(["bash", "scripts/torch_watch_smoke.sh"],
                          cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=700)
    out = proc.stdout
    assert proc.returncode == 0, out[-6000:] + proc.stderr[-6000:]
    assert "CHECK OK: no alerts on clean baseline" in out, out
    assert ("CHECK OK: all expected alerts active: "
            "['loss_spike', 'straggler']") in out, out
    assert "CHECK OK: all expected alerts active: ['nan']" in out, out
    assert "overhead gates: all GREEN" in out, out
    assert "perf gate: FAILED on watch_overhead_pct" in out, out
    assert "missing_key:watch_overhead_pct named by the gate" in out
    assert out.rstrip().endswith("watch smoke: PASS"), out
