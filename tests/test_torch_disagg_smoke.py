"""``scripts/torch_disagg_smoke.sh`` on the CPU: the three steps of
``scripts/disagg_smoke.sh`` on the port — a 1-prefill/1-decode fleet's
greedy tokens bit-identical to ``sample()`` with exactly the live pages
moved and none left after draining, ``tools/torch_serve_load.py --disagg
1:1`` writing ``disagg_ttft_ms`` and ``kv_handoff_ms``, and
``tools/torch_perf_gate.py`` passing on them and tripping on a seeded 30%
handoff regression."""

import os
import re
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_disagg_smoke_passes_on_the_cpu():
    env = dict(os.environ, SMOKE_DEVICE="cpu", OMP_NUM_THREADS="2",
               DISAGG_SMOKE_TIMEOUT="300")
    proc = subprocess.run(["bash", "scripts/torch_disagg_smoke.sh"],
                          cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=700)
    out = proc.stdout
    assert proc.returncode == 0, out[-6000:] + proc.stderr[-6000:]
    assert "disagg smoke: bit-identical x3 on cpu" in out, out
    assert ", 0 leaked" in out, out
    m = re.search(r"^serve_load: disagg_ttft_ms=([0-9.]+) "
                  r"kv_handoff_ms=([0-9.]+) leaked=0$", out, re.M)
    assert m and float(m.group(1)) > 0 and float(m.group(2)) > 0, out
    assert "perf gate: OK" in out
    assert "perf gate: FAILED on kv_handoff_ms" in out, out
    assert out.rstrip().endswith("disagg smoke: PASS"), out
