#!/usr/bin/env bash
# Elastic smoke of the PyTorch port: the live-migration contract end to
# end, as scripts/elastic_smoke.sh runs it for the JAX package.
#
#   1. KILL MID-RUN: tools/torch_chaos_run.py --kill-worker kills a
#      worker of the fleet mid-run (its servicer unregistered, as a dead
#      process looks to its peers); the session must complete on the
#      reshaped fleet via exactly ONE live migration (no checkpoint
#      rollback) with the loss trajectory matching the undisturbed
#      reference, the watchtower migration alert lifecycle must fire
#      (migrations_started counter), and the run prints the
#      machine-readable migration_stall_ms= line.
#   2. PERF GATE: migration_stall_ms is recorded three times to build a
#      rolling baseline in a throwaway history, then
#      tools/torch_perf_gate.py --check must pass on the real value and
#      MUST fail on a seeded 50% stall regression (the gate actually
#      trips on the key).
#
# The fleet runs on SMOKE_DEVICE (cpu unless set; cuda on a card).
# Override the per-pass bound with ELASTIC_SMOKE_TIMEOUT (seconds).
set -euo pipefail
cd "$(dirname "$0")/.."

TIMEOUT="${ELASTIC_SMOKE_TIMEOUT:-600}"
DEVICE="${SMOKE_DEVICE:-cpu}"
TMPDIR_SMOKE="$(mktemp -d)"
trap 'rm -rf "$TMPDIR_SMOKE"' EXIT

echo "=== elastic smoke 1/2: kill a worker mid-run, live-migrate ==="
OUT="$TMPDIR_SMOKE/chaos.log"
timeout -k 10 "$TIMEOUT" python tools/torch_chaos_run.py \
    --steps 6 --kill-worker 3 --device "$DEVICE" | tee "$OUT"

if ! grep -qE 'migrations_started\s+1' "$OUT"; then
    echo "elastic smoke: FAIL (watchtower migration alert never fired)"
    exit 1
fi
STALL="$(grep -oE 'migration_stall_ms=[0-9.]+' "$OUT" | cut -d= -f2)"
if [ -z "$STALL" ]; then
    echo "elastic smoke: FAIL (no migration_stall_ms line to record)"
    exit 1
fi

echo "=== elastic smoke 2/2: perf gate on migration_stall_ms ==="
HIST="$TMPDIR_SMOKE/bench_history.jsonl"
for i in 1 2 3; do
    timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
        --history "$HIST" --record-value "migration_stall_ms=$STALL" \
        > /dev/null
done
timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py --history "$HIST" \
    --check --keys migration_stall_ms \
    --record-value "migration_stall_ms=$STALL"
if timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
    --history "$HIST" --check --keys migration_stall_ms \
    --record-value "migration_stall_ms=$STALL" \
    --seed-regression migration_stall_ms:50; then
    echo "elastic smoke: FAIL (seeded 50% stall regression did not trip)"
    exit 1
fi

echo "elastic smoke: PASS"
