#!/usr/bin/env bash
# Disaggregated-serving smoke of the PyTorch port: the prefill/decode
# contract end to end, as scripts/disagg_smoke.sh runs it for the JAX
# package.
#
#   1. BIT-IDENTITY + ZERO LEAK: a 1-prefill/1-decode in-process fleet
#      (make_inproc_cluster, serving.FleetRouter) generates greedy tokens
#      bit-identical to single-device sample() through the
#      ExportPages/AdoptPages paged-KV handoff, only the live pages move
#      (counter-checked against pages_for), and after draining BOTH pools
#      zero pages remain allocated.
#   2. LOAD + METRICS: tools/torch_serve_load.py --disagg 1:1 completes a
#      request mix and writes disagg_ttft_ms / kv_handoff_ms to --out.
#   3. PERF GATE: both keys are recorded three times to build a rolling
#      baseline in a throwaway history, then tools/torch_perf_gate.py
#      --check must pass on the real values and MUST fail on a seeded
#      30% kv_handoff_ms regression.
#
# GPT-2 `test` (fp32) on SMOKE_DEVICE (cpu unless set; cuda on a card).
# Override the per-pass bound with DISAGG_SMOKE_TIMEOUT (seconds).
set -euo pipefail
cd "$(dirname "$0")/.."

TIMEOUT="${DISAGG_SMOKE_TIMEOUT:-600}"
export SMOKE_DEVICE="${SMOKE_DEVICE:-cpu}"
TMPDIR_SMOKE="$(mktemp -d)"
trap 'rm -rf "$TMPDIR_SMOKE"' EXIT

echo "=== disagg smoke 1/3: 1P/1D handoff bit-identity + zero leak ==="
timeout -k 10 "$TIMEOUT" env PYTHONPATH=. python - <<'PY'
import dataclasses
import os

import numpy as np
import torch

from tepdist_tpu_torch.models import gpt2
from tepdist_tpu_torch.models.sampling import sample
from tepdist_tpu_torch.rpc.client import TepdistClient
from tepdist_tpu_torch.rpc.inproc import (close_inproc_cluster,
                                          make_inproc_cluster)
from tepdist_tpu_torch.serving import FleetRouter, pages_for
from tepdist_tpu_torch.telemetry import metrics

device = os.environ["SMOKE_DEVICE"]
cfg = dataclasses.replace(gpt2.CONFIGS["test"], dtype=torch.float32)
params = gpt2.init_params(cfg, seed=0, device=device)
prompts = [np.random.RandomState(s).randint(
               1, cfg.vocab_size, size=t).astype(np.int32)
           for s, t in ((0, 5), (1, 17), (2, 33))]
cluster, servicers = make_inproc_cluster(2, [device])
router = FleetRouter([TepdistClient(w.address) for w in cluster.workers],
                     prefill=1, decode=1)
before = dict(metrics().snapshot()["counters"])
try:
    router.load(params, cfg, max_len=64, name="smoke")
    outs = router.generate(prompts, max_new_tokens=6, greedy=True)
    for p, o in zip(prompts, outs):
        ref = sample(params, torch.as_tensor(p)[None].long().to(device),
                     cfg, max_new_tokens=6, greedy=True)[0].cpu().numpy()
        assert np.array_equal(np.asarray(o), ref), \
            f"disagg output != sample(): {list(o)} != {list(ref)}"
    router.drain_all(wait_ms=5000.0)
    leaked = sum(int(e.stats().get("pages_used", 0))
                 for s in servicers for e in s.servables.values())
    assert leaked == 0, f"{leaked} pages leaked after drain"
finally:
    for s in servicers:
        s.close_servables()
    close_inproc_cluster(cluster)
d = dict(metrics().snapshot()["counters"])
live = sum(pages_for(len(p), router.page_size) for p in prompts)
moved = d.get("kv_pages_exported", 0) - before.get("kv_pages_exported", 0)
assert moved == live, f"shipped {moved} pages, live set is {live}"
print(f"disagg smoke: bit-identical x{len(prompts)} on {device}, "
      f"{moved} live pages moved, 0 leaked")
PY

echo "=== disagg smoke 2/3: torch_serve_load --disagg 1:1 ==="
SERVE="$TMPDIR_SMOKE/serve.json"
timeout -k 10 "$TIMEOUT" python tools/torch_serve_load.py \
    --disagg 1:1 --workers 2 --requests 8 --device "$SMOKE_DEVICE" \
    --out "$SERVE"
python - "$SERVE" <<'PY'
import json, sys
s = json.load(open(sys.argv[1]))
assert s["statuses"].get("done") == s["requests"], s["statuses"]
assert s["disagg_pages_leaked"] == 0, s["disagg_pages_leaked"]
for k in ("disagg_ttft_ms", "kv_handoff_ms"):
    assert isinstance(s[k], (int, float)), f"missing {k}"
print(f"serve_load: disagg_ttft_ms={s['disagg_ttft_ms']} "
      f"kv_handoff_ms={s['kv_handoff_ms']} leaked=0")
PY

echo "=== disagg smoke 3/3: perf gate on disagg_ttft_ms/kv_handoff_ms ==="
HIST="$TMPDIR_SMOKE/bench_history.jsonl"
for i in 1 2 3; do
    timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
        --history "$HIST" --serve-json "$SERVE" > /dev/null
done
timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py --history "$HIST" \
    --check --keys disagg_ttft_ms,kv_handoff_ms --serve-json "$SERVE"
if timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
    --history "$HIST" --check --keys disagg_ttft_ms,kv_handoff_ms \
    --serve-json "$SERVE" --seed-regression kv_handoff_ms:30; then
    echo "disagg smoke: FAIL (seeded 30% handoff regression did not trip)"
    exit 1
fi

echo "disagg smoke: PASS"
