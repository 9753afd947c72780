#!/usr/bin/env bash
# Fidelity smoke of the PyTorch port: the predicted-vs-measured schedule
# fidelity report on the two-worker in-process fleet fixture, as
# scripts/fidelity_smoke.sh runs it for the JAX package.
#
#   1. REPORT + CHECK: tools/torch_fidelity_report.py runs the fixture
#      with tracing on, joins the simulator's predicted timeline with the
#      measured task spans, and --check fails unless 100% of predicted
#      tasks joined AND the fitted calibration profile strictly shrinks
#      the step-time prediction error.
#   2. PROFILE ROUND-TRIP: the fitted profile is saved and a second
#      (offline, trace-file) report is produced through
#      tools/torch_trace_summary.py's fidelity section, proving the
#      dumped trace is a self-contained fidelity input.
#
# The fixture runs on SMOKE_DEVICE (cpu unless set; cuda on a card).
# Override the per-pass bound with FIDELITY_SMOKE_TIMEOUT (seconds).
set -euo pipefail
cd "$(dirname "$0")/.."

TIMEOUT="${FIDELITY_SMOKE_TIMEOUT:-600}"
DEVICE="${SMOKE_DEVICE:-cpu}"
TMPDIR_SMOKE="$(mktemp -d)"
trap 'rm -rf "$TMPDIR_SMOKE"' EXIT

echo "=== fidelity smoke 1/2: report + calibration check ==="
timeout -k 10 "$TIMEOUT" python tools/torch_fidelity_report.py \
    --steps 4 --check --device "$DEVICE" \
    --save-profile "$TMPDIR_SMOKE/calib.json" \
    --dump-trace "$TMPDIR_SMOKE/fleet_trace.json"

echo "=== fidelity smoke 2/2: offline trace-file fidelity section ==="
timeout -k 10 "$TIMEOUT" python tools/torch_trace_summary.py \
    "$TMPDIR_SMOKE/fleet_trace.json" | grep -q "fidelity"

echo "fidelity smoke: PASS"
