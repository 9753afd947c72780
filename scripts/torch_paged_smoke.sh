#!/usr/bin/env bash
# Paged-KV smoke of the PyTorch port: a timeout-bounded in-process pass
# over the paged serving engine's three acceptance gates, as
# scripts/paged_smoke.sh runs them for the JAX package.
#
#   1. BIT-IDENTITY: a mixed greedy batch (a two-chunk prompt, a short
#      prompt, two prompts behind a 32-token system prompt) on the paged
#      engine must match sequential sample() token for token, with at
#      least one prefix hit; after drain, pages_used and page_refs are 0.
#   2. PREFIX CACHE: a shared_prefix=32 load of 16 requests on 2 workers
#      (tools/torch_serve_load.py's run_load) must finish all 16 and
#      record prefix_hit_rate > 0.
#   3. NO LEAKS: after that load drains, pages_used must be 0.
#
# GPT-2 `test` on SMOKE_DEVICE (cpu unless set; cuda on a card). Override
# the per-pass bound with PAGED_SMOKE_TIMEOUT (seconds).
set -euo pipefail
cd "$(dirname "$0")/.."

TIMEOUT="${PAGED_SMOKE_TIMEOUT:-600}"
export SMOKE_DEVICE="${SMOKE_DEVICE:-cpu}"

echo "=== paged smoke 1/2: greedy bit-identity vs sequential sample() ==="
timeout -k 10 "$TIMEOUT" env PYTHONPATH=. python - <<'EOF'
import os

import torch

from tepdist_tpu_torch.models import gpt2
from tepdist_tpu_torch.models.sampling import sample
from tepdist_tpu_torch.serving import ServingEngine
from tepdist_tpu_torch.telemetry import metrics

device = os.environ["SMOKE_DEVICE"]
cfg = gpt2.CONFIGS["test"]
params = gpt2.init_params(cfg, seed=0, device=device)
eng = ServingEngine(params, cfg, kv_mode="paged", slots=4, max_len=64,
                    name="paged-smoke", device=device)
V = cfg.vocab_size
system = (torch.arange(32) * 11 + 5) % V
prompts = [torch.arange(40) % V,                          # 2 chunks
           (torch.arange(7) * 3 + 1) % V,
           torch.cat([system, torch.tensor([3, 1, 4])]),
           torch.cat([system, torch.tensor([1, 5, 9])])]
mnts = [6, 5, 4, 4]
for i, (p, m) in enumerate(zip(prompts, mnts)):
    # Sequential: request 3 must hit request 2's committed prefix.
    assert eng.submit(f"r{i}", p.numpy(), max_new_tokens=m)["status"] \
        == "queued"
    eng.run_until_idle()
res = {r["request_id"]: r for r in eng.poll([f"r{i}" for i in range(4)])}
for i, (p, m) in enumerate(zip(prompts, mnts)):
    ref = sample(params, p[None].to(device), cfg, max_new_tokens=m,
                 greedy=True)[0, len(p):].cpu()
    got = torch.tensor(res[f"r{i}"]["tokens"], dtype=ref.dtype)
    assert torch.equal(got, ref), f"r{i}: {got.tolist()} != {ref.tolist()}"
hits = metrics().snapshot()["counters"].get("prefix_hits", 0)
assert hits >= 1, f"expected a prefix hit, got {hits}"
eng.drain(wait_ms=0)
st = eng.stats()
assert st["pages_used"] == 0, st
assert st["page_refs"] == 0, st
print(f"bit-identity OK (4 requests on {device}, prefix_hits={hits}, "
      f"pages_used={st['pages_used']} after drain)")
EOF

echo "=== paged smoke 2/2: shared-prefix load (hit rate + leak gate) ==="
timeout -k 10 "$TIMEOUT" env PYTHONPATH=. python - <<'EOF'
import json
import os
import sys

sys.path.insert(0, "tools")
from torch_serve_load import run_load

s = run_load(requests=16, workers=2, slots=4, max_len=64,
             shared_prefix=32, prompt_len=(3, 8), max_new=(2, 5),
             kv_mode="paged", device=os.environ["SMOKE_DEVICE"])
print(json.dumps({k: s[k] for k in
                  ("statuses", "prefix_hits", "prefix_hit_rate",
                   "prefix_hit_tokens", "prefill_chunks",
                   "pages_used_after_drain")}, indent=1))
assert s["statuses"].get("done") == 16, s["statuses"]
assert s["prefix_hit_rate"] > 0, "no prefix hits under shared prefix"
assert s["pages_used_after_drain"] == 0, "page leak after drain"
EOF

echo "paged smoke: PASS"
