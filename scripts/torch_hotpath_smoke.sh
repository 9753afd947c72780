#!/usr/bin/env bash
# Hot-path smoke of the PyTorch port: the RPC hot path end to end on a
# fresh two-worker in-process fleet fixture, as scripts/hotpath_smoke.sh
# runs it for the JAX package.
#
#   1. LEDGER EXACTNESS: tools/torch_ledger_report.py runs the fixture
#      with batched dispatch + send overlap at their defaults (ON);
#      --check fails unless the gap-table buckets sum to each step's wall
#      exactly, coverage holds, and the serde bucket reconciles with the
#      independent fidelity attribution — i.e. the coalesced
#      ExecuteStepSlice framing path stays byte-accounted.
#   2. PERF GATE, HOT-PATH KEYS: the report's rpc_orchestration_ms and
#      serde_ms buckets (plus the fleet step wall) are recorded three
#      times to build a rolling baseline in a throwaway history, then
#      tools/torch_perf_gate.py --check must pass on the real values and
#      MUST fail on a seeded 25% rpc_orchestration_ms slowdown.
#
# The fleet runs on SMOKE_DEVICE (cpu unless set; cuda on a card).
# Override the per-pass bound with HOTPATH_SMOKE_TIMEOUT (seconds).
set -euo pipefail
cd "$(dirname "$0")/.."

TIMEOUT="${HOTPATH_SMOKE_TIMEOUT:-600}"
DEVICE="${SMOKE_DEVICE:-cpu}"
TMPDIR_SMOKE="$(mktemp -d)"
trap 'rm -rf "$TMPDIR_SMOKE"' EXIT

echo "=== hotpath smoke 1/2: ledger byte-exactness under batched dispatch ==="
# The coverage floor is the JAX smoke's: a loaded host lands 93-95% on
# the tail of unattributed scheduler noise; the bucket-sum identity and
# the reconcile stay exact.
timeout -k 10 "$TIMEOUT" python tools/torch_ledger_report.py \
    --steps 6 --check --min-coverage 0.93 --device "$DEVICE" \
    --json > "$TMPDIR_SMOKE/ledger_report.json"

echo "=== hotpath smoke 2/2: perf gate on rpc_orchestration_ms + serde_ms ==="
HIST="$TMPDIR_SMOKE/bench_history.jsonl"
read -r FLEET_MS RPC_MS SERDE_MS <<<"$(python - \
    "$TMPDIR_SMOKE/ledger_report.json" <<'PY'
import json, sys
t = open(sys.argv[1]).read()
r = json.loads(t[t.index("{"):t.rindex("}") + 1])
b = r["gap_table"]["aggregate"]["buckets"]
print(r["fleet_step_ms"], b["rpc_orchestration_ms"], b["serde_ms"])
PY
)"
echo "fleet_step_ms=$FLEET_MS rpc_orchestration_ms=$RPC_MS serde_ms=$SERDE_MS"
for i in 1 2 3; do
    timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
        --history "$HIST" \
        --record-value "two_worker_fleet_ms=$FLEET_MS" \
        --record-value "rpc_orchestration_ms=$RPC_MS" \
        --record-value "serde_ms=$SERDE_MS" > /dev/null
done
timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py --history "$HIST" \
    --check --keys two_worker_fleet_ms,rpc_orchestration_ms,serde_ms \
    --record-value "two_worker_fleet_ms=$FLEET_MS" \
    --record-value "rpc_orchestration_ms=$RPC_MS" \
    --record-value "serde_ms=$SERDE_MS"
if timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
    --history "$HIST" --check --keys rpc_orchestration_ms \
    --record-value "rpc_orchestration_ms=$RPC_MS" \
    --seed-regression rpc_orchestration_ms:25; then
    echo "hotpath smoke: FAIL (seeded 25% rpc regression did not trip)"
    exit 1
fi

echo "hotpath smoke: PASS"
