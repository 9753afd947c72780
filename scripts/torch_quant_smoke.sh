#!/usr/bin/env bash
# Comm-dtype compression smoke of the PyTorch port: the compressed-
# collective candidates and the compressed wire end to end, as
# scripts/quant_smoke.sh runs them for the JAX package.
#
#   1. FLIP FIXTURE: the committed before/after ExplorationReports
#      (tests/fixtures/coll_flip_{before,after}.json: the GPT-2 graph at
#      healthy vs starved interconnect bandwidth) MUST flip the winner to
#      an @int8 mesh with coll_s as the named driver
#      (tools/torch_plan_diff.py --check fails, --expect-flip passes).
#   2. LEDGER: tools/torch_plan_explain.py --fixture --check still
#      accounts every proposal with compressed variants in the candidate
#      space.
#   3. NUMERICS: the port's tests of the compressed paths — the int8
#      wire against the reference within its error, bf16 and int8 comm
#      dtypes in the pipeline, the int8 fake-quant unbiased within one
#      scale, and the GA step's comm dtypes against the JAX package's.
#   4. WIRE: the quantized all-reduce byte ratio, f32 against int8 wire
#      bytes of the same five gradient tensors through
#      tepdist_tpu_torch/rpc/protocol.encode_literal
#      (tools/torch_quant_ratio.py), clears the 1.5x gate with an f32
#      round trip exactly 0.0 (tensors on SMOKE_DEVICE).
#   5. PERF GATE: the ratio records as a trend in a throwaway history; a
#      winner flip passes tools/torch_perf_gate.py --plan-diff only when
#      a gated key measurably improved; a seeded 20% regression on
#      quantized_ar_x MUST trip the gate.
#
# The fleet and the wire tensors are on SMOKE_DEVICE (cpu unless set;
# cuda on a card); step 3 runs the port's tests on the CPU. Override the
# per-pass bound with QUANT_SMOKE_TIMEOUT (seconds).
# SMOKE_SKIP_REPEATS=1 skips step 3, which runs tests the test suite
# runs too (the suite's CPU test of this script sets it).
set -euo pipefail
cd "$(dirname "$0")/.."

TIMEOUT="${QUANT_SMOKE_TIMEOUT:-600}"
export SMOKE_DEVICE="${SMOKE_DEVICE:-cpu}"
TMPDIR_SMOKE="$(mktemp -d)"
trap 'rm -rf "$TMPDIR_SMOKE"' EXIT

BEFORE="tests/fixtures/coll_flip_before.json"
AFTER="tests/fixtures/coll_flip_after.json"

echo "=== quant smoke 1/5: committed winner-flip fixtures (driver coll_s) ==="
if timeout -k 10 "$TIMEOUT" python tools/torch_plan_diff.py \
    "$BEFORE" "$AFTER" --check > /dev/null 2>&1; then
    echo "quant smoke: FAIL (fixture flip did not fail plan_diff --check)"
    exit 1
fi
timeout -k 10 "$TIMEOUT" python tools/torch_plan_diff.py \
    "$BEFORE" "$AFTER" --expect-flip | tee "$TMPDIR_SMOKE/flip.txt"
grep -q "driver: coll_s" "$TMPDIR_SMOKE/flip.txt" || {
    echo "quant smoke: FAIL (flip driver is not coll_s)"; exit 1; }
grep -q "@int8" "$TMPDIR_SMOKE/flip.txt" || {
    echo "quant smoke: FAIL (new winner is not a compressed candidate)"
    exit 1; }

echo "=== quant smoke 2/5: candidate ledger + scoreboard (plan_explain) ==="
timeout -k 10 "$TIMEOUT" python tools/torch_plan_explain.py --fixture \
    --check --device "$SMOKE_DEVICE"

echo "=== quant smoke 3/5: compressed-gradient numerics ==="
if [ -n "${SMOKE_SKIP_REPEATS:-}" ]; then
    echo "skipped (SMOKE_SKIP_REPEATS): the test suite runs these tests"
else
    timeout -k 10 "$TIMEOUT" python -m pytest -q -p no:cacheprovider \
        tests/test_torch_rpc_wire.py::test_int8_wire_equals_reference_within_its_error \
        tests/test_torch_pipeline.py::test_bf16_comm_dtype_matches_jax \
        tests/test_torch_pipeline.py::test_int8_comm_dtype_trains \
        tests/test_torch_spmd.py::test_int8_fake_quant_is_unbiased_within_one_scale \
        tests/test_torch_train.py::test_ga_step_matches_jax_build_ga_step
fi

echo "=== quant smoke 4/5: quantized AR wire ratio ==="
QAR_OUT="$(timeout -k 10 "$TIMEOUT" python tools/torch_quant_ratio.py \
    --device "$SMOKE_DEVICE" --check)" || {
    echo "$QAR_OUT"
    echo "quant smoke: FAIL (quantized_ar_x below 1.5x or an inexact f32" \
         "round trip)"
    exit 1; }
echo "$QAR_OUT"
QAR="$(echo "$QAR_OUT" | sed -n 's/^quantized_ar_x = \([0-9.]*\) .*/\1/p')"

echo "=== quant smoke 5/5: perf gate — flip coverage + seeded regression ==="
HIST_IMP="$TMPDIR_SMOKE/hist_improved.jsonl"
HIST_REG="$TMPDIR_SMOKE/hist_flat.jsonl"
BASE="$(python -c "print(float('$QAR') / 2)")"
for i in 1 2 3; do
    timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
        --history "$HIST_IMP" --record-value "quantized_ar_x=$BASE" \
        > /dev/null
    timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
        --history "$HIST_REG" --record-value "quantized_ar_x=$QAR" \
        > /dev/null
done
# The flip is covered: quantized_ar_x improved vs the pre-compression
# baseline, so the plan change pays for itself and the gate passes.
timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
    --history "$HIST_IMP" --check --keys quantized_ar_x \
    --record-value "quantized_ar_x=$QAR" --plan-diff "$BEFORE,$AFTER"
# The same flip with NO bench improvement is an unexplained plan change.
if timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
    --history "$HIST_REG" --check --keys quantized_ar_x \
    --record-value "quantized_ar_x=$QAR" \
    --plan-diff "$BEFORE,$AFTER" > /dev/null 2>&1; then
    echo "quant smoke: FAIL (uncovered winner flip did not trip the gate)"
    exit 1
fi
# A seeded 20% regression on the ratio MUST trip the gate.
if timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
    --history "$HIST_REG" --check --keys quantized_ar_x \
    --record-value "quantized_ar_x=$QAR" \
    --seed-regression quantized_ar_x:20; then
    echo "quant smoke: FAIL (seeded 20% regression did not trip the gate)"
    exit 1
fi

echo "quant smoke: PASS"
