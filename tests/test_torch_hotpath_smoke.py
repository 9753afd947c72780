"""``scripts/torch_hotpath_smoke.sh`` on the CPU: the two steps of
``scripts/hotpath_smoke.sh`` on the port — the ledger's gap table exact
under batched dispatch (its ``--check`` gates step 2), and
``tools/torch_perf_gate.py`` passing on the fleet step,
``rpc_orchestration_ms`` and ``serde_ms`` and tripping on a seeded 25%
orchestration regression."""

import os
import re
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_hotpath_smoke_passes_on_the_cpu():
    env = dict(os.environ, SMOKE_DEVICE="cpu", OMP_NUM_THREADS="2",
               HOTPATH_SMOKE_TIMEOUT="300")
    proc = subprocess.run(["bash", "scripts/torch_hotpath_smoke.sh"],
                          cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=700)
    out = proc.stdout
    assert proc.returncode == 0, out[-6000:] + proc.stderr[-6000:]
    assert "=== hotpath smoke 2/2: perf gate" in out, out
    assert re.search(r"^fleet_step_ms=[0-9.]+ rpc_orchestration_ms=[0-9.]+ "
                     r"serde_ms=[0-9.]+$", out, re.M), out
    assert "perf gate: OK" in out
    assert "perf gate: FAILED on rpc_orchestration_ms" in out, out
    assert out.rstrip().endswith("hotpath smoke: PASS"), out
