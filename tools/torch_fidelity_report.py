"""Predicted-vs-measured schedule fidelity report for the PyTorch port
(the counterpart of ``tools/fidelity_report.py``).

Joins the cost-model simulator's predicted per-task timeline
(``ScheduleResult.predicted_timeline()``) with measured task spans and
prints: a per-kind drift table, the measured critical path (top-N
tasks), per-worker wall-time attribution (compute / collective /
transfer / host-serde / idle), and a fitted calibration profile
(telemetry/calibrate.py) with predicted step times before/after
calibration.

Two modes:

* default — spin the two-worker in-proc fleet fixture (the same MLP
  pipeline the JAX package's tool runs: 4 tanh layers of 16, batch 8, 2
  stages, 2 micro batches, sgd 1e-2), run ``--steps`` training steps
  with tracing on, and report on the last step. The workers run on the
  card unless ``--device cpu`` is given.
* ``--trace FILE`` — offline: read a merged trace dumped by the port's
  ``DistributedPipelineSession.dump_trace()`` (the predicted timeline
  rides in its metadata).

``--save-profile P`` persists the fitted constants as JSON; rerun
anything under ``TEPDIST_CALIB_PROFILE=P`` to plan with measured
constants. ``--check`` exits non-zero unless 100% of predicted tasks
joined AND calibration strictly reduced step-time error.

Run: python tools/torch_fidelity_report.py [--device cpu] [--steps 4
     --json --save-profile P] | [--trace FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _fixture_inputs(device):
    """The MLP pipeline's weights and batch: numpy draws from a seed,
    moved to ``device``."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    params = {f"w{i}": torch.tensor(
        rng.standard_normal((16, 16)).astype(np.float32) * 0.3,
        device=device) for i in range(4)}
    x = torch.tensor(rng.standard_normal((8, 16)).astype(np.float32),
                     device=device)
    y = torch.tensor(rng.standard_normal((8, 16)).astype(np.float32),
                     device=device)
    return params, x, y


def _fixture_loss(params, x, y):
    import torch

    h = x
    for i in range(4):
        h = torch.tanh(h @ params[f"w{i}"])
    return ((h - y) ** 2).mean()


def run_fixture(steps: int = 4, top_n: int = 10,
                step: Optional[int] = None,
                dump_trace: Optional[str] = None,
                device: str = "cuda") -> Dict[str, Any]:
    """Two-worker in-proc fleet fixture -> fidelity report dict (plus
    raw predicted timeline + measured events under private keys)."""
    from tepdist_tpu_torch import telemetry
    from tepdist_tpu_torch.core.device import resolve_device
    from tepdist_tpu_torch.optim import sgd
    from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
    from tepdist_tpu_torch.rpc.inproc import (close_inproc_cluster,
                                              make_inproc_cluster)
    from tepdist_tpu_torch.runtime.distributed_executor import (
        DistributedPipelineSession)
    from tepdist_tpu_torch.telemetry import fidelity

    telemetry.trace.configure(enabled=True)
    telemetry.tracer().clear()
    dev = resolve_device(device)
    params, x, y = _fixture_inputs(dev)
    prog = plan_pipeline(_fixture_loss, 2, 2, params, x, y)
    cluster, _servicers = make_inproc_cluster(2, [dev])
    sess = DistributedPipelineSession(prog, cluster, optimizer=sgd(1e-2))
    try:
        sess.load_variables(params)
        for _ in range(steps):
            sess.step(x, y)
        predicted = sess.schedule.predicted_timeline(sess.dag)
        # In-proc fleet: every worker thread records into this process's
        # tracer, so the local snapshot IS the merged fleet view.
        events = telemetry.tracer().snapshot()
        trace_path = (sess.dump_trace(path=dump_trace)
                      if dump_trace else None)
        report = fidelity.build_report(predicted, events, step=step,
                                       top_n=top_n)
        report["uncalibrated_makespan_ms"] = round(
            sess.schedule.makespan * 1e3, 3)
        report["_dag"] = sess.dag
        report["trace"] = trace_path
        return report
    finally:
        sess.close()
        close_inproc_cluster(cluster)


def replay_timeline(predicted, profile=None,
                    base_overhead_us: float = 0.0) -> float:
    """Makespan (ms) of the predicted timeline replayed in its own order:
    each task starts when its parents and every earlier task on one of
    its devices have finished. With ``profile`` each task's duration is
    re-priced the way the scheduler prices it under that profile (the
    fitted host floor plus the device time scaled by ``compute_scale`` or
    ``hbm_scale``, a transfer's bytes over ``transfer_bytes_per_s``, an
    all-reduce's ring bytes over ``ar_bytes_per_s``); without one each
    keeps its predicted duration. A dumped trace carries no task graph,
    so this is how ``--trace`` mode shows the step time before and after
    calibration."""
    from tepdist_tpu_torch.telemetry import calibrate

    def dur_us(t) -> float:
        if profile is None:
            return float(t["dur_us"])
        dev = max(float(t["dur_us"]) - base_overhead_us, 0.0)
        kind, nbytes = t["kind"], float(t.get("bytes") or 0.0)
        if kind in calibrate.COMPUTE_KINDS and profile.compute_scale > 0:
            dev *= profile.compute_scale
        elif kind in calibrate.HBM_KINDS and profile.hbm_scale > 0:
            dev *= profile.hbm_scale
        elif (kind in calibrate.TRANSFER_KINDS and nbytes > 0
              and profile.transfer_bytes_per_s > 0):
            dev = nbytes / profile.transfer_bytes_per_s * 1e6
        elif (kind in calibrate.AR_KINDS and nbytes > 0
              and profile.ar_bytes_per_s > 0):
            n = max(len(t.get("devices") or ()), 2)
            dev = 2.0 * nbytes * (n - 1) / n / profile.ar_bytes_per_s * 1e6
        host = (profile.task_overhead_us if profile.task_overhead_us > 0
                else base_overhead_us)
        return host + dev

    finish: Dict[int, float] = {}
    lane_free: Dict[Any, float] = {}
    for t in sorted(predicted, key=lambda r: (r["start_us"], r["task"])):
        lanes = [("dev", d) for d in (t.get("devices") or ())] or [
            ("worker", t.get("worker"))]
        start = max([finish.get(p, 0.0) for p in t.get("parents", ())]
                    + [lane_free.get(ln, 0.0) for ln in lanes] + [0.0])
        finish[t["task"]] = start + dur_us(t)
        for ln in lanes:
            lane_free[ln] = finish[t["task"]]
    return max(finish.values(), default=0.0) / 1e3


def calibrate_report(report: Dict[str, Any]) -> Dict[str, Any]:
    """Fit a profile from the join; re-simulate under the profile to show
    the calibrated step-time prediction next to the uncalibrated one: on
    the fixture's task graph when it is at hand, else by replaying the
    predicted timeline (``replay_timeline``)."""
    from tepdist_tpu_torch.core.service_env import ServiceEnv
    from tepdist_tpu_torch.telemetry import calibrate

    prof = calibrate.fit_profile(
        report["matched"],
        base_overhead_us=ServiceEnv.get().task_overhead_us)
    out: Dict[str, Any] = {"profile": json.loads(prof.to_json()),
                           "_profile_obj": prof}
    dag = report.get("_dag")
    measured_ms = report.get("measured_step_ms")
    uncal_ms = report.get("uncalibrated_makespan_ms")
    if dag is None and report.get("_predicted"):
        base = ServiceEnv.get().task_overhead_us
        uncal_ms = round(replay_timeline(report["_predicted"]), 3)
        cal_ms = replay_timeline(report["_predicted"], prof, base)
        report["uncalibrated_makespan_ms"] = uncal_ms
        out["replayed"] = True
        out["calibrated_makespan_ms"] = round(cal_ms, 3)
        if measured_ms is not None:
            out["uncalibrated_error_ms"] = round(
                abs(uncal_ms - measured_ms), 3)
            out["calibrated_error_ms"] = round(
                abs(cal_ms - measured_ms), 3)
    if dag is not None:
        from tepdist_tpu_torch.runtime.task_scheduler import TaskScheduler
        calibrate.set_active(prof)
        try:
            cal_ms = TaskScheduler(dag).schedule().makespan * 1e3
        finally:
            calibrate.clear_active()
        out["calibrated_makespan_ms"] = round(cal_ms, 3)
        if measured_ms is not None and uncal_ms is not None:
            out["uncalibrated_error_ms"] = round(
                abs(uncal_ms - measured_ms), 3)
            out["calibrated_error_ms"] = round(
                abs(cal_ms - measured_ms), 3)
    return out


def print_report(report: Dict[str, Any],
                 cal: Optional[Dict[str, Any]] = None) -> None:
    j = report["join"]
    print(f"fidelity report — step {report['step']} "
          f"(steps seen: {report['steps_seen']})")
    print(f"join: {j['matched']} predicted tasks matched "
          f"({j['fraction']:.1%}), "
          f"{len(j['orphan_predicted'])} predicted orphans, "
          f"{len(j['orphan_measured'])} measured orphans, "
          f"{j['skipped_bookkeeping']} bookkeeping skipped")
    print("per-kind drift (predicted vs measured):")
    print(f"  {'kind':<10} {'n':>4} {'pred_ms':>10} {'meas_ms':>10} "
          f"{'drift_ms':>10} {'ratio':>8}")
    for kind, a in sorted(report["per_kind"].items()):
        ratio = f"{a['ratio']:.2f}x" if a["ratio"] is not None else "-"
        print(f"  {kind:<10} {a['n']:>4} {a['predicted_ms']:>10.3f} "
              f"{a['measured_ms']:>10.3f} {a['drift_ms']:>10.3f} "
              f"{ratio:>8}")
    print(f"step time: predicted={report.get('predicted_step_ms')} ms "
          f"measured={report.get('measured_step_ms')} ms")
    print("attribution per worker (ms):")
    for lane, a in report["attribution"].items():
        print(f"  worker {lane}: window={a['window_ms']} "
              f"compute={a['compute_ms']} collective={a['collective_ms']} "
              f"transfer={a['transfer_ms']} serde={a['host_serde_ms']} "
              f"idle={a['idle_ms']}")
    top = report["top_critical_tasks"]
    if top:
        print(f"top {len(top)} measured critical-path tasks:")
        for t in top:
            print(f"  #{t['task']:<4} {t['name']:<24} {t['kind']:<8} "
                  f"{t['dur_ms']:>9.3f} ms")
    if cal:
        p = cal["profile"]
        print("calibration suggestion (tepdist_tpu_torch/telemetry/"
              "calibrate.py):")
        print(f"  task_overhead_us={p['task_overhead_us']:.1f} "
              f"compute_scale={p['compute_scale']:.3g} "
              f"hbm_scale={p['hbm_scale']:.3g}")
        print(f"  transfer_bytes_per_s={p['transfer_bytes_per_s']:.4g} "
              f"ar_bytes_per_s={p['ar_bytes_per_s']:.4g}")
        if "calibrated_makespan_ms" in cal:
            how = (" (replayed timeline)" if cal.get("replayed")
                   else "")
            print(f"  predicted step{how}: uncalibrated="
                  f"{report.get('uncalibrated_makespan_ms')} ms -> "
                  f"calibrated={cal['calibrated_makespan_ms']} ms "
                  f"(measured {report.get('measured_step_ms')} ms)")
        if "calibrated_error_ms" in cal:
            print(f"  abs step-time error: "
                  f"{cal['uncalibrated_error_ms']} ms -> "
                  f"{cal['calibrated_error_ms']} ms")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("torch_fidelity_report")
    ap.add_argument("--trace", default=None,
                    help="offline: merged trace JSON from "
                         "session.dump_trace() (metadata carries the "
                         "predicted timeline)")
    ap.add_argument("--steps", type=int, default=4,
                    help="fixture mode: training steps to run")
    ap.add_argument("--device", default="cuda",
                    help="fixture mode: the workers' device (cuda or cpu)")
    ap.add_argument("--step", type=int, default=None,
                    help="report on this step (default: last seen)")
    ap.add_argument("--top", type=int, default=10)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--save-profile", default=None,
                    help="write the fitted calibration profile JSON here")
    ap.add_argument("--dump-trace", default=None,
                    help="fixture mode: also dump the merged measured "
                         "trace here")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless the join is 100%% and "
                         "calibration strictly shrinks step-time error")
    args = ap.parse_args(argv)

    if args.trace:
        from tepdist_tpu_torch.telemetry import fidelity
        with open(args.trace) as f:
            trace = json.load(f)
        report = fidelity.report_from_trace(trace, step=args.step,
                                            top_n=args.top)
        if report is not None:
            report["_predicted"] = fidelity.predicted_from_trace(trace)
        if report is None:
            print(f"{args.trace}: no fidelity.predicted metadata — "
                  "re-dump with session.dump_trace()", file=sys.stderr)
            return 2
        dropped = (trace.get("metadata") or {}).get("spans_dropped")
        if dropped:
            print(f"WARNING: lossy trace (spans dropped: {dropped})",
                  file=sys.stderr)
    else:
        report = run_fixture(steps=args.steps, top_n=args.top,
                             step=args.step, dump_trace=args.dump_trace,
                             device=args.device)

    cal = calibrate_report(report)
    if args.save_profile:
        cal["_profile_obj"].save(args.save_profile)
        cal["saved"] = args.save_profile

    if args.json:
        clean = {k: v for k, v in report.items()
                 if not k.startswith("_") and k != "matched"}
        clean["calibration"] = {k: v for k, v in cal.items()
                                if not k.startswith("_")}
        print(json.dumps(clean, indent=1, default=str))
    else:
        print_report(report, cal)
        if args.save_profile:
            print(f"profile saved: {args.save_profile} "
                  f"(use TEPDIST_CALIB_PROFILE={args.save_profile})")

    if args.check:
        j = report["join"]
        ok = (j["fraction"] == 1.0 and not j["orphan_measured"])
        if "calibrated_error_ms" in cal:
            ok = ok and (cal["calibrated_error_ms"]
                         < cal["uncalibrated_error_ms"])
        if not ok:
            print("fidelity check FAILED "
                  f"(join={j['fraction']:.1%}, cal="
                  f"{cal.get('calibrated_error_ms')} vs "
                  f"uncal={cal.get('uncalibrated_error_ms')})",
                  file=sys.stderr)
            return 1
        print("fidelity check OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
