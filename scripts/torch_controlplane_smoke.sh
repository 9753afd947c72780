#!/usr/bin/env bash
# Control-plane smoke of the PyTorch port: the crash-safety contract end
# to end on real subprocesses, as scripts/controlplane_smoke.sh runs it
# for the JAX package.
#
#   1. KILL THE MASTER: tools/torch_chaos_run.py --kill-master SIGKILLs
#      the real master subprocess mid-run; a fresh master must readopt()
#      the still-live gRPC worker fleet from the durable WAL and finish
#      with the merged loss trajectory matching the undisturbed reference
#      (overlapping steps bit-identical: the exactly-once evidence),
#      exactly one takeover, no checkpoint rollback, and the
#      machine-readable master_recover_ms= line. This arm needs gRPC, so
#      it runs on the CPU whatever SMOKE_DEVICE says.
#   2. FENCE + TORN TAIL: the port's tests of the same contract — a
#      servicer refuses a stale master epoch before any effect, a WAL
#      torn mid-record replays to the last whole record (as the JAX
#      package's does, byte for byte), and a master re-adopting a live
#      fleet from the WAL resumes bit-exactly.
#   3. WAL COST: tools/torch_obs_overhead.py measures wal_overhead_pct on
#      the two-worker fleet step (null-calibrated A/B); its --check gate
#      must be GREEN — crash safety that taxes the step path is a
#      regression.
#   4. PERF GATE: master_recover_ms and wal_overhead_pct are recorded
#      three times to build a rolling baseline in a throwaway history,
#      then tools/torch_perf_gate.py --check must pass on the real values
#      and MUST fail on a seeded 50% recovery regression.
#
# The WAL-cost fleet runs on SMOKE_DEVICE (cpu unless set; cuda on a
# card). Override the per-pass bound with CONTROLPLANE_SMOKE_TIMEOUT
# (seconds).
# SMOKE_SKIP_REPEATS=1 skips step 2, which runs tests the test suite
# runs too (the suite's CPU test of this script sets it).
set -euo pipefail
cd "$(dirname "$0")/.."

TIMEOUT="${CONTROLPLANE_SMOKE_TIMEOUT:-600}"
DEVICE="${SMOKE_DEVICE:-cpu}"
TMPDIR_SMOKE="$(mktemp -d)"
trap 'rm -rf "$TMPDIR_SMOKE"' EXIT

echo "=== controlplane smoke 1/4: SIGKILL the master, readopt the fleet ==="
OUT="$TMPDIR_SMOKE/chaos.log"
timeout -k 10 "$TIMEOUT" python tools/torch_chaos_run.py \
    --steps 8 --kill-master 3 --device cpu | tee "$OUT"

RECOVER="$(grep -oE 'master_recover_ms=[0-9.]+' "$OUT" | tail -n 1 \
    | cut -d= -f2)"
if [ -z "$RECOVER" ]; then
    echo "controlplane smoke: FAIL (no master_recover_ms line to record)"
    exit 1
fi

echo "=== controlplane smoke 2/4: epoch fence + torn WAL tail ==="
if [ -n "${SMOKE_SKIP_REPEATS:-}" ]; then
    echo "skipped (SMOKE_SKIP_REPEATS): the test suite runs these tests"
else
    timeout -k 10 "$TIMEOUT" python -m pytest -q -p no:cacheprovider \
        tests/test_torch_rpc.py::test_servicer_verbs_and_fences_match_reference \
        tests/test_torch_fleet_state.py::test_controlplane_journal_bytes_and_replay_equal \
        tests/test_torch_fleet_state.py::test_readopt_resumes_live_fleet_bit_exact
fi

echo "=== controlplane smoke 3/4: WAL cost on the step path ==="
timeout -k 10 "$TIMEOUT" python tools/torch_obs_overhead.py \
    --skip-trace --skip-ledger --skip-flight --skip-watch --check \
    --device "$DEVICE" --out "$TMPDIR_SMOKE/wal_cost.json"
WALPCT="$(python -c "import json;
r=[x for x in json.load(open('$TMPDIR_SMOKE/wal_cost.json'))['extra']
   if x.get('metric')=='wal_overhead_pct'];
print(r[0]['value'] if r else '')")"

echo "=== controlplane smoke 4/4: perf gate on master_recover_ms ==="
HIST="$TMPDIR_SMOKE/bench_history.jsonl"
for i in 1 2 3; do
    timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
        --history "$HIST" \
        --record-value "master_recover_ms=$RECOVER" \
        --record-value "wal_overhead_pct=$WALPCT" > /dev/null
done
timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py --history "$HIST" \
    --check --keys master_recover_ms,wal_overhead_pct \
    --record-value "master_recover_ms=$RECOVER" \
    --record-value "wal_overhead_pct=$WALPCT"
if timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
    --history "$HIST" --check --keys master_recover_ms \
    --record-value "master_recover_ms=$RECOVER" \
    --seed-regression master_recover_ms:50; then
    echo "controlplane smoke: FAIL (seeded 50% recovery regression did" \
         "not trip)"
    exit 1
fi

echo "controlplane smoke: PASS"
