#!/usr/bin/env bash
# Watchtower smoke of the PyTorch port: the live-monitoring pipeline end
# to end on the two-worker in-process demo fleet, as
# scripts/watch_smoke.sh runs it for the JAX package.
#
#   1. NO-FLAP BASELINE: a clean run of the same length as the faulted
#      one must finish with ZERO active alerts (--check with no --expect
#      demands a quiet fleet).
#   2. INJECTED FAULTS: with an rpc_delay straggler on worker 1 and a
#      seeded loss spike, torch_watch.py --once --check --expect must see
#      BOTH typed alerts through real GetTelemetryDelta polls.
#   3. NAN SENTINEL: a seeded NaN raises the page-severity nan alert.
#   4. OVERHEAD GATE: tools/torch_obs_overhead.py measures
#      watch_overhead_pct (active watchtower vs none, null-calibrated);
#      --check fails unless its gate is GREEN, and three recordings build
#      a throwaway history so a seeded 30% regression MUST trip
#      tools/torch_perf_gate.py, as must deleting the key from the latest
#      record (missing_key detection).
#
# The demo fleet runs on SMOKE_DEVICE (cpu unless set; cuda on a card).
# Override the per-pass bound with WATCH_SMOKE_TIMEOUT (seconds).
set -euo pipefail
cd "$(dirname "$0")/.."

TIMEOUT="${WATCH_SMOKE_TIMEOUT:-600}"
DEVICE="${SMOKE_DEVICE:-cpu}"
TMPDIR_SMOKE="$(mktemp -d)"
trap 'rm -rf "$TMPDIR_SMOKE"' EXIT

echo "=== watch smoke 1/4: no-flap clean baseline ==="
timeout -k 10 "$TIMEOUT" python tools/torch_watch.py \
    --demo --steps 8 --slo slo.toml --once --check --device "$DEVICE"

echo "=== watch smoke 2/4: straggler + loss spike raise typed alerts ==="
timeout -k 10 "$TIMEOUT" python tools/torch_watch.py \
    --demo --steps 8 --fault rpc_delay:ms=80,ti=1 --seed-spike 6 \
    --slo slo.toml --once --check --expect straggler,loss_spike \
    --device "$DEVICE"

echo "=== watch smoke 3/4: NaN watchdog pages ==="
timeout -k 10 "$TIMEOUT" python tools/torch_watch.py \
    --demo --steps 6 --seed-nan 3 --once --check --expect nan \
    --device "$DEVICE"

echo "=== watch smoke 4/4: watch overhead gate + watchlist ==="
OBS="$TMPDIR_SMOKE/watch_overhead.json"
HIST="$TMPDIR_SMOKE/watch_history.jsonl"
timeout -k 10 "$TIMEOUT" python tools/torch_obs_overhead.py \
    --skip-ledger --skip-trace --skip-flight --skip-wal --check \
    --device "$DEVICE" --out "$OBS"
for i in 1 2 3; do
    timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
        --history "$HIST" --record "$OBS" > /dev/null
done
timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py --history "$HIST" \
    --check --keys watch_overhead_pct --record "$OBS"
if timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
    --history "$HIST" --check --keys watch_overhead_pct --record "$OBS" \
    --seed-regression watch_overhead_pct:30; then
    echo "watch smoke: FAIL (seeded 30% watch-overhead regression did" \
         "not trip the gate)"
    exit 1
fi
# missing_key: drop the gated key from the latest record — the gate must
# name it rather than silently passing on absence.
python - "$OBS" "$TMPDIR_SMOKE/watch_overhead_missing.json" <<'PY'
import json, sys
doc = json.load(open(sys.argv[1]))
doc["extra"] = [r for r in doc.get("extra", [])
                if r.get("metric") != "watch_overhead_pct"]
json.dump(doc, open(sys.argv[2], "w"), indent=1)
PY
if timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
    --history "$HIST" --check --keys watch_overhead_pct \
    --record "$TMPDIR_SMOKE/watch_overhead_missing.json" \
    > "$TMPDIR_SMOKE/missing_key.out" 2>&1; then
    cat "$TMPDIR_SMOKE/missing_key.out"
    echo "watch smoke: FAIL (vanished gated key did not trip the gate)"
    exit 1
fi
grep -q "missing_key:watch_overhead_pct" "$TMPDIR_SMOKE/missing_key.out"
echo "missing_key:watch_overhead_pct named by the gate"

echo "watch smoke: PASS"
