"""``scripts/torch_zero_smoke.sh`` on the CPU: the five steps of
``scripts/zero_smoke.sh`` on the port — the committed zero flip fixtures
flipping to an ``@zero`` winner driven by ``memory_feasible``, the
``opt_MB`` column and ``@zero`` rows of ``tools/torch_plan_explain.py``,
the optimizer-state bytes placed on rank 0 of two CPU ranks by the
unannotated plan shrinking under ZeRO from the reference's 524292 to its
262148 (2.000x, gate 1.8x), and
``tools/torch_perf_gate.py`` passing the covered flip, failing the
uncovered one and tripping on a seeded 30% regression. Step 3 (the port's
ZeRO tests) is skipped: the suite runs them."""

import os
import re
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_zero_smoke_passes_on_the_cpu():
    env = dict(os.environ, SMOKE_DEVICE="cpu", OMP_NUM_THREADS="2",
               SMOKE_SKIP_REPEATS="1",
               ZERO_SMOKE_TIMEOUT="300")
    proc = subprocess.run(["bash", "scripts/torch_zero_smoke.sh"],
                          cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=700)
    out = proc.stdout
    assert proc.returncode == 0, out[-6000:] + proc.stderr[-6000:]
    assert "WINNER FLIP — driver: memory_feasible" in out, out
    assert "opt_MB" in out and "plan_explain check OK" in out, out
    assert "skipped (SMOKE_SKIP_REPEATS): the test suite runs these tests" \
        in out, out
    m = re.search(r"^zero_opt_mem_x = ([0-9.]+) \(gate: >= 1.8\)$", out,
                  re.M)
    assert m and float(m.group(1)) >= 1.8, out
    assert ("rank 0 optimizer state: 524292 bytes plain, 262148 bytes "
            "ZeRO") in proc.stderr, proc.stderr[-3000:]
    assert "covered by bench improvement on zero_opt_mem_x" in out, out
    assert "perf gate: FAILED on zero_opt_mem_x" in out, out
    assert out.rstrip().endswith("zero smoke: PASS"), out
