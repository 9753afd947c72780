"""``scripts/torch_quant_smoke.sh`` on the CPU: the five steps of
``scripts/quant_smoke.sh`` on the port — the committed coll flip fixtures
flipping to an ``@int8`` winner driven by ``coll_s``, the exploration
ledger complete, the int8 wire ratio of
``encode_literal`` at or above 1.5x with an exact f32 round trip, and
``tools/torch_perf_gate.py`` passing the covered flip, failing the
uncovered one and tripping on a seeded 20% regression. Step 3 (the port's
compressed-path tests) is skipped: the suite runs them."""

import os
import re
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_quant_smoke_passes_on_the_cpu():
    env = dict(os.environ, SMOKE_DEVICE="cpu", OMP_NUM_THREADS="2",
               SMOKE_SKIP_REPEATS="1",
               QUANT_SMOKE_TIMEOUT="300")
    proc = subprocess.run(["bash", "scripts/torch_quant_smoke.sh"],
                          cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=700)
    out = proc.stdout
    assert proc.returncode == 0, out[-6000:] + proc.stderr[-6000:]
    assert "WINNER FLIP — driver: coll_s" in out, out
    assert "plan_explain check OK" in out, out
    assert "skipped (SMOKE_SKIP_REPEATS): the test suite runs these tests" \
        in out, out
    m = re.search(r"^quantized_ar_x = ([0-9.]+) \(gate: >= 1.5\)$", out,
                  re.M)
    assert m and float(m.group(1)) >= 1.5, out
    assert "covered by bench improvement on quantized_ar_x" in out, out
    assert "perf gate: FAILED on quantized_ar_x" in out, out
    assert out.rstrip().endswith("quant smoke: PASS"), out
