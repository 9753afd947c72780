#!/usr/bin/env bash
# ZeRO weight-update sharding smoke of the PyTorch port: the
# optimizer-state-sharding modifier and the sharded update paths end to
# end, as scripts/zero_smoke.sh runs them for the JAX package.
#
#   1. FLIP FIXTURE: the committed before/after ExplorationReports
#      (tests/fixtures/zero_flip_{before,after}.json: the GPT-2 graph at
#      healthy vs starved HBM, healthy wire in BOTH) MUST flip the winner
#      to an @zero mesh with memory_feasible as the named driver
#      (tools/torch_plan_diff.py --check fails, --expect-flip passes).
#   2. LEDGER: tools/torch_plan_explain.py renders the fixture's
#      candidate table with the per-candidate opt_MB column and @zero
#      candidates, and --fixture --check accounts every proposal.
#   3. NUMERICS: the port's ZeRO tests, held to plain GA — ZeRO-1 in the
#      GA step and in the pipeline track the plain trajectory, the
#      planner's ZeRO plan (zero_invars) tracks plain data parallelism
#      with its optimizer state split over data, and the int8 plan runs
#      beside the fidelity plan.
#   4. MEMORY: the per-device optimizer-state bytes of a data=2 plan,
#      plain against ZeRO (auto_parallel zero_invars), each placed on two
#      CPU ranks through the plan's input placements and summed on rank 0
#      from the shards actually held, clear the 1.8x gate.
#   5. PERF GATE: the ratio records as a trend in a throwaway history;
#      the fixture flip passes tools/torch_perf_gate.py --plan-diff only
#      when a gated key measurably improved; a seeded 30% regression on
#      zero_opt_mem_x MUST trip the gate.
#
# The fleet of step 2 runs on SMOKE_DEVICE (cpu unless set; cuda on a
# card); steps 3 and 4 run on CPU ranks (gloo). Override the per-pass
# bound with ZERO_SMOKE_TIMEOUT (seconds).
# SMOKE_SKIP_REPEATS=1 skips step 3, which runs tests the test suite
# runs too (the suite's CPU test of this script sets it).
set -euo pipefail
cd "$(dirname "$0")/.."

TIMEOUT="${ZERO_SMOKE_TIMEOUT:-600}"
DEVICE="${SMOKE_DEVICE:-cpu}"
TMPDIR_SMOKE="$(mktemp -d)"
trap 'rm -rf "$TMPDIR_SMOKE"' EXIT

BEFORE="tests/fixtures/zero_flip_before.json"
AFTER="tests/fixtures/zero_flip_after.json"

echo "=== zero smoke 1/5: committed winner-flip fixtures (driver memory_feasible) ==="
if timeout -k 10 "$TIMEOUT" python tools/torch_plan_diff.py \
    "$BEFORE" "$AFTER" --check > /dev/null 2>&1; then
    echo "zero smoke: FAIL (fixture flip did not fail plan_diff --check)"
    exit 1
fi
timeout -k 10 "$TIMEOUT" python tools/torch_plan_diff.py \
    "$BEFORE" "$AFTER" --expect-flip | tee "$TMPDIR_SMOKE/flip.txt"
grep -q "driver: memory_feasible" "$TMPDIR_SMOKE/flip.txt" || {
    echo "zero smoke: FAIL (flip driver is not memory_feasible)"; exit 1; }
grep -q "@zero" "$TMPDIR_SMOKE/flip.txt" || {
    echo "zero smoke: FAIL (new winner is not a ZeRO candidate)"
    exit 1; }

echo "=== zero smoke 2/5: candidate ledger + opt_MB column (plan_explain) ==="
timeout -k 10 "$TIMEOUT" python tools/torch_plan_explain.py \
    "$AFTER" | tee "$TMPDIR_SMOKE/explain.txt"
grep -q "opt_MB" "$TMPDIR_SMOKE/explain.txt" || {
    echo "zero smoke: FAIL (plan_explain lacks the opt_MB column)"
    exit 1; }
grep -q "@zero" "$TMPDIR_SMOKE/explain.txt" || {
    echo "zero smoke: FAIL (plan_explain lacks @zero candidates)"
    exit 1; }
timeout -k 10 "$TIMEOUT" python tools/torch_plan_explain.py --fixture \
    --check --device "$DEVICE"

echo "=== zero smoke 3/5: ZeRO numerics held to plain GA + planner path ==="
if [ -n "${SMOKE_SKIP_REPEATS:-}" ]; then
    echo "skipped (SMOKE_SKIP_REPEATS): the test suite runs these tests"
else
    timeout -k 10 "$TIMEOUT" python -m pytest -q -p no:cacheprovider \
        tests/test_torch_pipeline_dist.py::test_build_ga_step_zero_tracks_plain_ga \
        tests/test_torch_pipeline_dist.py::test_zero_tracks_plain_pipeline \
        tests/test_torch_spmd_dist.py::test_zero_plan_tracks_plain_dp \
        tests/test_torch_spmd_dist.py::test_int8_plan_runs_beside_fidelity
fi

echo "=== zero smoke 4/5: measured per-device optimizer-state shrink ==="
cat > "$TMPDIR_SMOKE/zero_mem.py" <<'PY'
"""Optimizer-state bytes placed on rank 0 of a data=2 plan, plain DP
against ZeRO (auto_parallel zero_invars), the JAX package's probe model
and optimizer (a tanh MLP, adam), planned without annotations."""
import json
import socket
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def measure(zero):
    from torch.distributed.tensor import DTensor

    from tepdist_tpu_torch.core.mesh import MeshTopology
    from tepdist_tpu_torch.core.tree import tree_leaves
    from tepdist_tpu_torch.optim import adam
    from tepdist_tpu_torch.parallel.auto_parallel import auto_parallel
    from tepdist_tpu_torch.parallel.sync_free import build_ga_step
    from tepdist_tpu_torch.train import value_and_grad

    g = torch.Generator().manual_seed(0)
    params = {"w1": torch.randn(128, 256, generator=g) * 0.02,
              "w2": torch.randn(256, 128, generator=g) * 0.02}
    x, y = torch.randn(8, 128, generator=g), torch.randn(8, 128, generator=g)

    def loss_fn(p, x, y):
        return ((torch.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2).mean()

    opt = adam(1e-3)
    step = build_ga_step(value_and_grad(loss_fn),
                         lambda p, s, gr: (p, opt.apply(p, gr, s)), 1,
                         batch_argnums=(1, 2))
    state = opt.init(params)
    n_param = len(tree_leaves(params))
    flat = tree_leaves((params, state))
    n_state = len(flat)
    plan = auto_parallel(
        step, MeshTopology([("data", 2)]), params, state, x, y,
        state_alias={1 + i: i for i in range(n_state)},
        zero_invars=list(range(n_param, n_state)) if zero else None)
    exe = plan.executable("cpu")
    placed = [exe.distribute_input(i, v) for i, v in enumerate(flat)]
    total = 0
    for v in placed[n_param:]:
        local = v.to_local() if isinstance(v, DTensor) else v
        total += local.numel() * local.element_size()
    return total


def run(rank, port):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        out = {"fid": measure(False), "zero": measure(True)}
        if rank == 0:
            print(json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    sys.path.insert(0, ".")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(run, args=(port,), nprocs=2)
PY
ZMEM="$(timeout -k 10 "$TIMEOUT" env PYTHONPATH=. \
    python "$TMPDIR_SMOKE/zero_mem.py" | tail -n 1 | python -c "
import json, sys
d = json.loads(sys.stdin.read())
ratio = d['fid'] / d['zero']
print(f'rank 0 optimizer state: {d[\"fid\"]} bytes plain, '
      f'{d[\"zero\"]} bytes ZeRO', file=sys.stderr)
assert ratio >= 1.8, f'zero_opt_mem_x below 1.8x: {d}'
print(f'{ratio:.3f}')")"
echo "zero_opt_mem_x = $ZMEM (gate: >= 1.8)"

echo "=== zero smoke 5/5: perf gate — flip coverage + seeded regression ==="
HIST_IMP="$TMPDIR_SMOKE/hist_improved.jsonl"
HIST_REG="$TMPDIR_SMOKE/hist_flat.jsonl"
BASE="$(python -c "print(float('$ZMEM') / 2)")"
for i in 1 2 3; do
    timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
        --history "$HIST_IMP" --record-value "zero_opt_mem_x=$BASE" \
        > /dev/null
    timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
        --history "$HIST_REG" --record-value "zero_opt_mem_x=$ZMEM" \
        > /dev/null
done
# The flip is covered: zero_opt_mem_x improved vs the replicated-state
# baseline, so the plan change pays for itself and the gate passes.
timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
    --history "$HIST_IMP" --check --keys zero_opt_mem_x \
    --record-value "zero_opt_mem_x=$ZMEM" --plan-diff "$BEFORE,$AFTER"
# The same flip with NO bench improvement is an unexplained plan change.
if timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
    --history "$HIST_REG" --check --keys zero_opt_mem_x \
    --record-value "zero_opt_mem_x=$ZMEM" \
    --plan-diff "$BEFORE,$AFTER" > /dev/null 2>&1; then
    echo "zero smoke: FAIL (uncovered winner flip did not trip the gate)"
    exit 1
fi
# A seeded 30% regression on the ratio MUST trip the gate.
if timeout -k 10 "$TIMEOUT" python tools/torch_perf_gate.py \
    --history "$HIST_REG" --check --keys zero_opt_mem_x \
    --record-value "zero_opt_mem_x=$ZMEM" \
    --seed-regression zero_opt_mem_x:30; then
    echo "zero smoke: FAIL (seeded 30% regression did not trip the gate)"
    exit 1
fi

echo "zero smoke: PASS"
