#!/usr/bin/env bash
# Ledger + perf-gate smoke of the PyTorch port: the observability
# pipeline end to end on the two-worker in-process fleet fixture, as
# scripts/ledger_smoke.sh runs it for the JAX package.
#
#   1. GAP TABLE + RECONCILE: tools/torch_ledger_report.py runs the
#      fixture with the RPC ledger AND the tracer on; --check fails unless
#      the named buckets (serde / rpc-orchestration / dependency-idle /
#      compute) sum to each step's wall exactly, attribute >= the coverage
#      floor of the per-step gap, and the serde bucket + step wall
#      reconcile with the independent fidelity attribution.
#   2. TRACE SECTIONS: the dumped trace renders ledger + flight sections
#      through tools/torch_trace_summary.py (self-contained trace file).
#   3. PERF GATE: three recordings of the report's fleet step time build
#      a rolling baseline in a throwaway history;
#      tools/torch_perf_gate.py --check passes on the real value and MUST
#      fail on a seeded 20% slowdown.
#   4. OVERHEAD WATCHLIST: tools/torch_obs_overhead.py measures the
#      enabled-path cost of the instruments; --check fails unless every
#      gate is GREEN. Its records build a second rolling baseline and a
#      seeded 20% ledger-overhead regression MUST trip the gate.
#
# The fleet runs on SMOKE_DEVICE (cpu unless set; cuda on a card).
# Override the per-pass bound with LEDGER_SMOKE_TIMEOUT (seconds).
set -euo pipefail
cd "$(dirname "$0")/.."

TIMEOUT="${LEDGER_SMOKE_TIMEOUT:-600}"
DEVICE="${SMOKE_DEVICE:-cpu}"
TMPDIR_SMOKE="$(mktemp -d)"
trap 'rm -rf "$TMPDIR_SMOKE"' EXIT

echo "=== ledger smoke 1/4: gap table + fidelity reconcile ==="
# Coverage floor 0.93, as in the JAX smoke: a loaded host occasionally
# lands 93-95% on the tail of the unattributed scheduler noise; the
# bucket-sum identity and the reconcile stay exact.
timeout -k 10 "$TIMEOUT" python tools/torch_ledger_report.py \
    --steps 6 --check --min-coverage 0.93 --device "$DEVICE" \
    --dump-trace "$TMPDIR_SMOKE/fleet_trace.json" \
    --json > "$TMPDIR_SMOKE/ledger_report.json"

echo "=== ledger smoke 2/4: trace-file ledger + flight sections ==="
timeout -k 10 "$TIMEOUT" python tools/torch_trace_summary.py \
    "$TMPDIR_SMOKE/fleet_trace.json" > "$TMPDIR_SMOKE/summary.txt"
grep -q "rpc ledger" "$TMPDIR_SMOKE/summary.txt"

echo "=== ledger smoke 3/4: perf gate trips on a seeded regression ==="
HIST="$TMPDIR_SMOKE/bench_history.jsonl"
FLEET_MS="$(python - "$TMPDIR_SMOKE/ledger_report.json" <<'PY'
import json, sys
t = open(sys.argv[1]).read()
print(json.loads(t[t.index("{"):t.rindex("}") + 1])["fleet_step_ms"])
PY
)"
echo "two_worker_fleet_ms=$FLEET_MS"
for i in 1 2 3; do
    timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
        --history "$HIST" --record-value "two_worker_fleet_ms=$FLEET_MS" \
        > /dev/null
done
timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py --history "$HIST" \
    --check --keys two_worker_fleet_ms \
    --record-value "two_worker_fleet_ms=$FLEET_MS"
if timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
    --history "$HIST" --check --keys two_worker_fleet_ms \
    --record-value "two_worker_fleet_ms=$FLEET_MS" \
    --seed-regression two_worker_fleet_ms:20; then
    echo "ledger smoke: FAIL (seeded 20% regression did not trip the gate)"
    exit 1
fi

echo "=== ledger smoke 4/4: always-on overhead watchlist ==="
OBS="$TMPDIR_SMOKE/obs_overhead.json"
OBS_HIST="$TMPDIR_SMOKE/obs_history.jsonl"
OBS_KEYS="ledger_overhead_pct,trace_enabled_ns_per_span,flight_overhead_pct"
timeout -k 10 "$TIMEOUT" python tools/torch_obs_overhead.py \
    --skip-watch --skip-wal --check --device "$DEVICE" --out "$OBS"
for i in 1 2 3; do
    timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
        --history "$OBS_HIST" --record "$OBS" > /dev/null
done
timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
    --history "$OBS_HIST" --check --keys "$OBS_KEYS" --record "$OBS"
if timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
    --history "$OBS_HIST" --check --keys "$OBS_KEYS" --record "$OBS" \
    --seed-regression ledger_overhead_pct:20; then
    echo "ledger smoke: FAIL (seeded 20% ledger-overhead regression did" \
         "not trip the gate)"
    exit 1
fi

echo "ledger smoke: PASS"
