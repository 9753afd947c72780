"""Per-step RPC ledger gap table of the port: where the fleet step time
goes. The counterpart of ``tools/ledger_report.py``, with its flags and
output, over ``tepdist_tpu_torch/telemetry/ledger.py`` and
``fidelity.py``.

Spins the two-worker in-process fleet fixture that
``tools/torch_fidelity_report.py`` uses (4-layer 16x16 MLP pipeline,
``plan_pipeline`` 2x2, on ``--device``: the card unless ``--device cpu``)
with the RPC ledger AND span tracing enabled, times a one-process eager
step of the identical training step, and reduces the ledger's recorded
intervals to the named-bucket decomposition of each fleet step:

    serde | rpc_orchestration | compute | dependency_idle | unattributed

The table is cross-checked (``ledger.reconcile``) against the fidelity
attribution computed from the very same run's spans: two independent
instruments measuring one step.

Modes:

* default — run the fixture live and report.
* ``--trace FILE`` — offline: read a merged trace dumped by
  ``session.dump_trace()`` (the fleet ledger rides in its metadata);
  pass ``--single-ms`` to split compute from dependency_idle.

``--check`` exits non-zero unless steady-state coverage >= ``--min-coverage``
(default 0.95) and the reconciliation agrees within ``--tolerance``
(default 10%). ``_model(device)`` is the fixture ``tools/torch_watch.py``
and ``tools/torch_obs_overhead.py`` share. ``main(argv)`` returns the
report beside what it printed (``tools/torch_cli.py``).

Run: python tools/torch_ledger_report.py [--device cpu] [--steps 6 --json
     --check]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, Optional

# The repository (the package) and this directory (the sibling tools).
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def _model(device: str = "cuda"):
    """(loss_fn, params, x, y): the fidelity fixture's MLP on ``device``."""
    from tepdist_tpu_torch.core.device import resolve_device
    from torch_fidelity_report import (_fixture_inputs,
                                             _fixture_loss)

    params, x, y = _fixture_inputs(resolve_device(device))
    return _fixture_loss, params, x, y


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def single_process_step_ms(repeats: int = 20,
                           device: str = "cuda") -> float:
    """Best-of-k wall time of the identical training step (gradients and
    the sgd update) run eagerly in this process: the compute floor the
    fleet gap is measured against."""
    from tepdist_tpu_torch.optim import sgd
    from tepdist_tpu_torch.train import value_and_grad

    loss_fn, params, x, y = _model(device)
    opt = sgd(1e-2)
    opt_state = opt.init(params)
    grad_fn = value_and_grad(loss_fn)

    def train_step(params, opt_state):
        loss, grads = grad_fn(params, x, y)
        return opt.apply(params, grads, opt_state), loss

    opt_state, loss = train_step(params, opt_state)      # warm up
    _sync(device)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        opt_state, loss = train_step(params, opt_state)
        float(loss)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def run_fixture(steps: int = 6, warmup: int = 2,
                dump_trace: Optional[str] = None,
                device: str = "cuda") -> Dict[str, Any]:
    """Two-worker in-proc fleet with ledger+trace on -> report dict.
    The first ``warmup`` steps (plan compile + caches) run with both
    instruments cleared afterwards, so every recorded step is steady
    state."""
    from tepdist_tpu_torch import telemetry
    from tepdist_tpu_torch.core.device import resolve_device
    from tepdist_tpu_torch.optim import sgd
    from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
    from tepdist_tpu_torch.rpc.inproc import (close_inproc_cluster,
                                              make_inproc_cluster)
    from tepdist_tpu_torch.runtime.distributed_executor import (
        DistributedPipelineSession)
    from tepdist_tpu_torch.telemetry import fidelity
    from tepdist_tpu_torch.telemetry import ledger as led

    telemetry.trace.configure(enabled=True)
    led.configure(enabled=True)

    single_ms = single_process_step_ms(device=device)

    loss_fn, params, x, y = _model(device)
    prog = plan_pipeline(loss_fn, 2, 2, params, x, y)
    cluster, _servicers = make_inproc_cluster(2, [resolve_device(device)])
    sess = DistributedPipelineSession(prog, cluster, optimizer=sgd(1e-2))
    walls = {}
    try:
        sess.load_variables(params)
        for _ in range(warmup):
            sess.step(x, y)
        telemetry.tracer().clear()
        led.ledger().clear()
        for _ in range(steps):
            s = sess._step
            t0 = time.perf_counter()
            sess.step(x, y)
            walls[s] = (time.perf_counter() - t0) * 1e3
        predicted = sess.schedule.predicted_timeline(sess.dag)
        # In-proc fleet: every worker thread records into this process's
        # ledger/tracer, so the local snapshots ARE the merged fleet view.
        events = telemetry.tracer().snapshot()
        snap = led.ledger().snapshot()
        trace_path = (sess.dump_trace(path=dump_trace)
                      if dump_trace else None)
    finally:
        sess.close()
        close_inproc_cluster(cluster)

    ordered = sorted(walls.values())
    fleet_ms = ordered[len(ordered) // 2]
    table = led.gap_table(snap, single_step_ms=single_ms)
    fid = fidelity.build_report(predicted, events)

    # Reconcile apples-to-apples: restrict the ledger to the very step the
    # fidelity report measured, and compare against this run's own timed
    # wall for that step.
    fid_step = fid["step"]
    win = (snap.get("windows") or {}).get(str(fid_step))
    snap_one = dict(snap, windows={str(fid_step): win}) if win else snap
    step_wall = walls.get(fid_step)
    rec = led.reconcile(
        led.gap_table(snap_one, single_step_ms=single_ms),
        fid["attribution"],
        measured_step_ms=round(step_wall, 3) if step_wall else None)
    return {
        "steps": steps,
        "fleet_step_ms": round(fleet_ms, 3),
        "single_step_ms": round(single_ms, 3),
        "gap_ms": round(fleet_ms - single_ms, 3),
        "gap_table": table,
        "reconcile": rec,
        "fidelity_attribution": fid["attribution"],
        "fidelity_step": fid_step,
        "trace": trace_path,
        "_snapshot": snap,
    }


def report_from_trace(path: str,
                      single_ms: Optional[float] = None) -> Dict[str, Any]:
    from tepdist_tpu_torch.telemetry import fidelity
    from tepdist_tpu_torch.telemetry import ledger as led

    with open(path) as f:
        trace = json.load(f)
    snap = (trace.get("metadata") or {}).get("ledger")
    if not snap:
        raise SystemExit(f"{path}: no ledger metadata — re-dump with "
                         "TEPDIST_LEDGER=1")
    table = led.gap_table(snap, single_step_ms=single_ms)
    out: Dict[str, Any] = {"trace": path, "gap_table": table,
                           "single_step_ms": single_ms}
    fid = fidelity.report_from_trace(trace)
    if fid:
        out["reconcile"] = led.reconcile(
            table, fid["attribution"],
            measured_step_ms=fid.get("measured_step_ms"))
        out["fidelity_attribution"] = fid["attribution"]
    return out


def print_report(rep: Dict[str, Any]) -> None:
    if "fleet_step_ms" in rep:
        print(f"fleet step {rep['fleet_step_ms']} ms vs single-process "
              f"{rep['single_step_ms']} ms -> gap {rep['gap_ms']} ms")
    table = rep["gap_table"]
    cols = ("serde_ms", "rpc_orchestration_ms", "compute_ms",
            "dependency_idle_ms", "unattributed_ms")
    print(f"  {'step':>5} {'wall_ms':>9} " +
          " ".join(f"{c[:-3]:>14}" for c in cols) + f" {'coverage':>9}")
    for row in table["steps"]:
        print(f"  {row['step']:>5} {row['wall_ms']:>9.3f} " +
              " ".join(f"{row['buckets'][c]:>14.3f}" for c in cols) +
              f" {row['coverage']:>9.2%}")
    agg = table.get("aggregate")
    if agg:
        print(f"  {'mean*':>5} {agg['wall_ms']:>9.3f} " +
              " ".join(f"{agg['buckets'][c]:>14.3f}" for c in cols) +
              f" {agg['coverage']:>9.2%}   (* steady state, "
              f"n={agg['n_steps']})")
    rec = rep.get("reconcile")
    if rec:
        s = rec["serde"]
        print(f"reconcile vs fidelity: serde ledger={s['ledger_ms']} ms "
              f"fidelity={s['fidelity_ms']} ms rel={s['rel']}")
        w = rec.get("step_wall")
        if w:
            print(f"  step wall ledger={w['ledger_ms']} ms "
                  f"measured={w['fidelity_ms']} ms rel={w['rel']}")
        print(f"  ok={rec['ok']} (tolerance {rec['tolerance']:.0%})")


def main(argv=None) -> Dict[str, Any]:
    """``{"rc", "text", "report"}``."""
    from torch_cli import tee_main

    return tee_main(_main, argv)


def _main(argv):
    ap = argparse.ArgumentParser("ledger_report")
    ap.add_argument("--trace", default=None,
                    help="offline: merged trace JSON with ledger metadata")
    ap.add_argument("--single-ms", type=float, default=None,
                    help="offline: single-process step ms (splits compute "
                         "from dependency_idle)")
    ap.add_argument("--steps", type=int, default=6,
                    help="fixture mode: training steps to run")
    ap.add_argument("--dump-trace", default=None,
                    help="fixture mode: also dump the merged trace here")
    ap.add_argument("--device", default="cuda",
                    help="fixture mode: the workers' device (cuda or cpu)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless coverage >= --min-coverage and "
                         "reconciliation is within --tolerance")
    ap.add_argument("--min-coverage", type=float, default=0.95)
    ap.add_argument("--tolerance", type=float, default=0.10)
    args = ap.parse_args(argv)

    if args.trace:
        rep = report_from_trace(args.trace, single_ms=args.single_ms)
    else:
        rep = run_fixture(steps=args.steps, dump_trace=args.dump_trace,
                          device=args.device)
    data = {"report": {k: v for k, v in rep.items()
                       if not k.startswith("_")}}

    if args.json:
        print(json.dumps({k: v for k, v in rep.items()
                          if not k.startswith("_")}, indent=1))
    else:
        print_report(rep)

    if args.check:
        agg = rep["gap_table"].get("aggregate") or {}
        cov = agg.get("coverage", 0.0)
        rec = rep.get("reconcile") or {}
        ok = cov >= args.min_coverage and rec.get("ok", False)
        # The buckets-sum identity is structural; check it anyway.
        for row in rep["gap_table"]["steps"]:
            s = sum(row["buckets"].values())
            if abs(s - row["wall_ms"]) > 0.01 * max(row["wall_ms"], 1.0):
                print(f"bucket sum {s} != wall {row['wall_ms']} "
                      f"(step {row['step']})", file=sys.stderr)
                ok = False
        if not ok:
            print(f"ledger check FAILED (coverage={cov}, "
                  f"reconcile_ok={rec.get('ok')})", file=sys.stderr)
            return 1, data
        # Keep --json stdout machine-parseable: verdict to stderr there.
        print("ledger check OK",
              file=sys.stderr if args.json else sys.stdout)
    return 0, data


if __name__ == "__main__":
    sys.exit(main()["rc"])
