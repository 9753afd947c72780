#!/usr/bin/env bash
# Static-analysis smoke of the PyTorch port: both pre-dispatch gates, as
# scripts/analysis_smoke.sh runs them for the JAX package.
#
#   1. PLAN VERIFIER: tools/torch_verify_plan.py --check plans the MLP
#      pipeline fixture, runs every static check (acyclicity, SEND/RECV
#      pairing, wait-cycle deadlock, exactly-once writes, signature,
#      peak-HBM), then plants an orphaned SEND and fails unless the
#      verifier rejects it naming the planted defect.
#   2. LOCKDEP: tools/torch_lockdep.py --check lints every threading
#      module of the port for lock-order inversions, bare acquires, and
#      blocking calls under a lock, failing on any finding not justified
#      in tepdist_tpu_torch/analysis/lockdep_allow.toml (and on stale
#      entries).
#
# The fixture runs on SMOKE_DEVICE (cpu unless set; cuda on a card).
# Override the per-pass bound with ANALYSIS_SMOKE_TIMEOUT (seconds).
set -euo pipefail
cd "$(dirname "$0")/.."

TIMEOUT="${ANALYSIS_SMOKE_TIMEOUT:-600}"
DEVICE="${SMOKE_DEVICE:-cpu}"

echo "=== analysis smoke 1/2: plan verifier (fixture + planted defect) ==="
timeout -k 10 "$TIMEOUT" python tools/torch_verify_plan.py --check \
    --device "$DEVICE"

echo "=== analysis smoke 2/2: concurrency lockdep ==="
timeout -k 10 "$TIMEOUT" python tools/torch_lockdep.py --check

echo "analysis smoke: PASS"
