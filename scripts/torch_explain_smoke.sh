#!/usr/bin/env bash
# Exploration-observatory smoke of the PyTorch port: the
# decision-forensics pipeline end to end, as scripts/explain_smoke.sh
# runs it for the JAX package.
#
#   1. LEDGER + SCOREBOARD: tools/torch_plan_explain.py --fixture runs the
#      two-worker in-process fleet, and --check fails unless every
#      enumerated proposal is accounted (priced candidate or typed prune)
#      AND the executed candidate's predicted cost terms join against the
#      measured fidelity attribution.
#   2. PLAN DIFF: two identical explores of a 4-layer 1024-wide MLP over 8
#      devices (the port's explore on meta tensors: no device) diff empty
#      (--check passes); a seeded cost-model perturbation (HBM_GB=0.024
#      makes the replicated data=8 winner memory-infeasible while a
#      sharded pipeline candidate still fits) MUST flip the winner with a
#      named driver (--expect-flip) and fail plan_diff --check.
#   3. PERF GATE: three recordings of the report-capture time build a
#      rolling baseline in a throwaway history; tools/torch_perf_gate.py
#      --check passes, a seeded 50% regression MUST trip, and --plan-diff
#      MUST fail the gate on a winner flip with no bench improvement
#      while passing on identical reports.
#
# The fleet runs on SMOKE_DEVICE (cpu unless set; cuda on a card).
# Override the per-pass bound with EXPLAIN_SMOKE_TIMEOUT (seconds).
set -euo pipefail
cd "$(dirname "$0")/.."

TIMEOUT="${EXPLAIN_SMOKE_TIMEOUT:-600}"
DEVICE="${SMOKE_DEVICE:-cpu}"
TMPDIR_SMOKE="$(mktemp -d)"
trap 'rm -rf "$TMPDIR_SMOKE"' EXIT

echo "=== explain smoke 1/3: candidate ledger + cost scoreboard ==="
timeout -k 10 "$TIMEOUT" python tools/torch_plan_explain.py --fixture \
    --check --device "$DEVICE"

echo "=== explain smoke 2/3: plan diff — identical empty, seeded flip ==="
timeout -k 10 "$TIMEOUT" env PYTHONPATH=. python - "$TMPDIR_SMOKE" <<'PY'
import json, os, sys

import torch

from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.parallel.exploration import explore

out = sys.argv[1]


def loss(params, x, y):
    h = x
    for i in range(4):
        h = torch.tanh(h @ params[f"w{i}"])
    return ((h - y) ** 2).mean()


params = {f"w{i}": torch.empty(1024, 1024, device="meta")
          for i in range(4)}
x = torch.empty(8, 1024, device="meta")
y = torch.empty(8, 1024, device="meta")


def report(**env):
    try:
        if env:
            ServiceEnv.reset(env)
        return explore(loss, params, x, y, n_devices=8,
                       num_micro_batches=2)["report"]
    finally:
        if env:
            ServiceEnv.reset()


# base / again: identical fixture twice (determinism contract);
# perturbed: tight HBM makes the replicated-state SPMD winners
# memory-infeasible while a sharded pipeline candidate still fits.
# 0.024 GB sits in the flip window as it does for the JAX package's
# evaluator (OPT_STATE_FACTOR x grad bytes of optimizer state per
# device); starving further (e.g. 0.005) kills EVERY candidate and
# nothing flips.
for name, rep in (("base", report()), ("again", report()),
                  ("perturbed", report(HBM_GB=0.024))):
    with open(os.path.join(out, f"{name}.json"), "w") as f:
        json.dump(rep, f)
PY

timeout -k 10 "$TIMEOUT" python tools/torch_plan_diff.py \
    "$TMPDIR_SMOKE/base.json" "$TMPDIR_SMOKE/again.json" --check
if timeout -k 10 "$TIMEOUT" python tools/torch_plan_diff.py \
    "$TMPDIR_SMOKE/base.json" "$TMPDIR_SMOKE/perturbed.json" --check \
    > /dev/null 2>&1; then
    echo "explain smoke: FAIL (seeded flip did not fail plan_diff --check)"
    exit 1
fi
timeout -k 10 "$TIMEOUT" python tools/torch_plan_diff.py \
    "$TMPDIR_SMOKE/base.json" "$TMPDIR_SMOKE/perturbed.json" --expect-flip

echo "=== explain smoke 3/3: perf gate — capture metric + flip gating ==="
HIST="$TMPDIR_SMOKE/bench_history.jsonl"
CAP_MS="$(python - "$TMPDIR_SMOKE/base.json" <<'PY'
import json, sys
print(json.load(open(sys.argv[1]))["capture_ms"])
PY
)"
echo "explore_report_ms=$CAP_MS"
for i in 1 2 3; do
    timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
        --history "$HIST" --record-value "explore_report_ms=$CAP_MS" \
        > /dev/null
done
timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py --history "$HIST" \
    --check --keys explore_report_ms \
    --record-value "explore_report_ms=$CAP_MS"
if timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
    --history "$HIST" --check --keys explore_report_ms \
    --record-value "explore_report_ms=$CAP_MS" \
    --seed-regression explore_report_ms:50; then
    echo "explain smoke: FAIL (seeded 50% regression did not trip the gate)"
    exit 1
fi
# A winner flip with no bench improvement is an unexplained plan change.
if timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
    --history "$HIST" --check --keys explore_report_ms \
    --record-value "explore_report_ms=$CAP_MS" \
    --plan-diff "$TMPDIR_SMOKE/base.json,$TMPDIR_SMOKE/perturbed.json"; then
    echo "explain smoke: FAIL (uncovered winner flip did not trip the gate)"
    exit 1
fi
# Identical reports carry no flip: the same gate passes.
timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py --history "$HIST" \
    --check --keys explore_report_ms \
    --record-value "explore_report_ms=$CAP_MS" \
    --plan-diff "$TMPDIR_SMOKE/base.json,$TMPDIR_SMOKE/again.json"

echo "explain smoke: PASS"
