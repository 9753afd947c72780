#!/usr/bin/env bash
# Chaos smoke of the PyTorch port: a timeout-bounded in-process pass over
# the two recovery ladders, as scripts/chaos_smoke.sh runs them for the
# JAX package.
#
#   1. TRAINING: seeded server faults on ExecuteRemotePlan exhaust the
#      rpc retry budget and force same-step re-execution (_recover_step);
#      asserts the loss trajectory is bit-identical to the fault-free run
#      and prints fault_injected / rpc_retries / step_retries.
#   2. SERVING: a seeded engine_crash plus a serve_fault mid-decode kill
#      the engine; the ServingSupervisor rebuilds it and replays journaled
#      requests; asserts every request ends "done" with tokens
#      bit-identical to the fault-free run and prints engine_restarts /
#      requests_replayed.
#
# Both specs are seeded, so every run injects the same faults at the same
# points. The fleet runs on SMOKE_DEVICE (cpu unless set; cuda on a
# card). Override the per-pass bound with CHAOS_SMOKE_TIMEOUT (seconds).
set -euo pipefail
cd "$(dirname "$0")/.."

TIMEOUT="${CHAOS_SMOKE_TIMEOUT:-600}"
DEVICE="${SMOKE_DEVICE:-cpu}"

echo "=== chaos smoke 1/2: training step-retry ==="
timeout -k 10 "$TIMEOUT" python tools/torch_chaos_run.py \
    --steps 6 --spec 'server_fault:p=0.7,verb=ExecuteRemotePlan,seed=7' \
    --device "$DEVICE"

echo "=== chaos smoke 2/2: serving engine-crash recovery ==="
timeout -k 10 "$TIMEOUT" python tools/torch_chaos_run.py \
    --serve --requests 10 \
    --spec 'engine_crash:step=3,ti=0;serve_fault:op=decode,step=6,ti=1,seed=7' \
    --device "$DEVICE"

echo "chaos smoke: PASS"
