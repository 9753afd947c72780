"""``scripts/torch_paged_smoke.sh`` on the CPU: the port's paged serving
engine through the three gates of ``scripts/paged_smoke.sh`` (greedy
tokens equal sequential ``sample()`` with a prefix hit and no page left
after drain; a shared-prefix load of 16 requests on 2 workers all done
with prefix hits; no page used after it drains)."""

import os
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_paged_smoke_passes_on_the_cpu():
    env = dict(os.environ, SMOKE_DEVICE="cpu", OMP_NUM_THREADS="2",
               PAGED_SMOKE_TIMEOUT="300")
    proc = subprocess.run(["bash", "scripts/torch_paged_smoke.sh"],
                          cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=700)
    out = proc.stdout
    assert proc.returncode == 0, out + proc.stderr
    assert "bit-identity OK (4 requests on cpu" in out, out
    assert '"done": 16' in out, out
    assert out.rstrip().endswith("paged smoke: PASS"), out
