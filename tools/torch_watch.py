"""Live fleet dashboard over the port's watchtower: the counterpart of
``tools/watch.py``, with its flags and output, over
``tepdist_tpu_torch/telemetry/watchtower.py``.

Renders what the watchtower knows — per-worker fleet table, step-time
sparkline, SLO burn rates, active typed alerts — either attached to a
running fleet (``--connect``) or on a self-contained two-worker
in-process demo fleet (``--demo``, on ``--device``: the card unless
``--device cpu``) with optional injected faults, so the whole alert path
(delta poll -> digests -> scorer -> board -> render) runs without a
cluster:

    # live view against a fleet
    python tools/torch_watch.py --connect 10.0.0.1:2222,10.0.0.2:2222

    # one render + exit: demo fleet, straggler + seeded loss spike,
    # --check fails unless exactly the expected alert kinds are active
    python tools/torch_watch.py --demo --fault rpc_delay:ms=80,ti=1 \
        --seed-spike 6 --once --check --expect straggler,loss_spike

    # no-flap baseline: same length, no faults, --check demands ZERO alerts
    python tools/torch_watch.py --demo --once --check --device cpu

Alert seeding (``--seed-nan`` / ``--seed-spike``) feeds the poisoned
loss to the SAME TrainingSentinel instance the executor calls each step
— the production detector and board, not a parallel code path; only the
loss value is synthetic. Fault injection (``--fault``) uses the runtime
fault plan (``runtime/faults.py``), so an injected ``rpc_delay``
straggler is detected from genuinely slow RPCs, not a scripted verdict.
``main(argv)`` returns the final status beside what it printed
(``tools/torch_cli.py``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

# The repository (the package) and this directory (the sibling tools).
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(xs, width: int = 32) -> str:
    xs = list(xs)[-width:]
    if not xs:
        return ""
    lo, hi = min(xs), max(xs)
    span = (hi - lo) or 1.0
    return "".join(_SPARK[int((x - lo) / span * (len(_SPARK) - 1))]
                   for x in xs)


def render(status: dict) -> str:
    lines = []
    step_ms = status.get("step_ms") or []
    if step_ms:
        lines.append(f"step time  {sparkline(step_ms)}  "
                     f"last={step_ms[-1]:.1f} ms  "
                     f"min={min(step_ms):.1f}  max={max(step_ms):.1f}  "
                     f"(n={len(step_ms)})")
    lines.append(f"polls: {status.get('polls', 0)}")
    workers = status.get("workers") or {}
    if workers:
        lines.append(f"  {'worker':<8} {'alive':<6} {'rtt med':>9} "
                     f"{'step med':>10} {'over':>8} {'records':>8} "
                     f"{'dropped':>8} {'last step':>10}")
        for ti, w in sorted(workers.items()):
            over = max(w.get("rtt_ms_over", 0) or 0,
                       w.get("step_ms_over", 0) or 0)
            flag = " <- STRAGGLER" if over > 0 else ""
            lines.append(
                f"  {ti:<8} {str(w.get('alive', '?')):<6} "
                f"{_fmt(w.get('rtt_ms_med')):>9} "
                f"{_fmt(w.get('step_ms_med')):>10} "
                f"{_fmt(over):>8} {w.get('records', 0):>8} "
                f"{w.get('dropped', 0):>8} "
                f"{_fmt(w.get('last_step')):>10}{flag}")
    burns = status.get("burn_rates") or {}
    for name, rates in sorted(burns.items()):
        parts = ", ".join(f"{r}x@{w}s" if r is not None else f"-@{w}s"
                          for w, r in sorted(rates.items(),
                                             key=lambda kv: float(kv[0])))
        lines.append(f"  slo {name:<20} burn {parts}")
    alerts = status.get("alerts") or []
    if alerts:
        lines.append("ACTIVE ALERTS:")
        for a in alerts:
            who = (f" worker={a['worker']}"
                   if a.get("worker") is not None else "")
            lines.append(f"  [{a.get('severity', 'warn')}] "
                         f"{a.get('key')}:{who} {a.get('detail')} "
                         f"(x{a.get('count', 1)})")
    else:
        lines.append("no active alerts")
    return "\n".join(lines)


def _fmt(v) -> str:
    if v is None:
        return "-"
    if isinstance(v, float):
        return f"{v:.1f}"
    return str(v)


def check_alerts(status: dict, expect: str) -> int:
    """--check verdict: with --expect, every named kind must be active
    (extra kinds are reported but tolerated — an injected straggler may
    legitimately also burn an SLO); without, ZERO alerts may be active
    (the no-flap baseline). Returns the exit code and prints why."""
    kinds = {a.get("kind") for a in status.get("alerts") or ()}
    if expect:
        want = {k.strip() for k in expect.split(",") if k.strip()}
        missing = sorted(want - kinds)
        if missing:
            print(f"CHECK FAILED: expected alert kinds not active: "
                  f"{', '.join(missing)} (active: {sorted(kinds)})")
            return 1
        print(f"CHECK OK: all expected alerts active: {sorted(want)}")
        return 0
    if kinds:
        print(f"CHECK FAILED: expected a quiet fleet, but alerts are "
              f"active: {sorted(kinds)}")
        return 1
    print("CHECK OK: no alerts on clean baseline")
    return 0


def run_demo(args) -> int:
    """Self-contained two-worker in-proc fleet: one warm-up step, then
    ``--steps`` GA steps (numbered from 1), watchtower-polling after
    each, then render/check."""
    from tepdist_tpu_torch.core.device import resolve_device
    from tepdist_tpu_torch.optim import sgd
    from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
    from tepdist_tpu_torch.rpc.inproc import (close_inproc_cluster,
                                              make_inproc_cluster)
    from tepdist_tpu_torch.runtime import faults
    from tepdist_tpu_torch.runtime.distributed_executor import (
        DistributedPipelineSession)
    from tepdist_tpu_torch.telemetry import ledger as led
    from tepdist_tpu_torch.telemetry import watchtower
    from torch_ledger_report import _model

    led.configure(enabled=True)     # richer deltas for the poller
    if args.fault:
        faults.configure(args.fault)
    loss_fn, params, x, y = _model(args.device)
    prog = plan_pipeline(loss_fn, 2, 2, params, x, y)
    cluster, _servicers = make_inproc_cluster(
        2, [resolve_device(args.device)])
    sess = DistributedPipelineSession(prog, cluster, optimizer=sgd(1e-2))
    status = {}
    try:
        sess.load_variables(params)
        # One step before the watchtower attaches: the fleet's first step
        # pays one-time costs that are no health signal (on an H100 1.6 s
        # of device warm-up against 22-26 ms steps after it), and in a run
        # this short the step-time SLO's p95 is the slowest step. The
        # watchtower's cursors start after it, so neither that step nor
        # the records of earlier fleets in this process enter its
        # digests.
        sess.step(x, y)
        wt = watchtower.Watchtower(
            clients=[sess.clients[ti] for ti in sorted(sess.clients)],
            slo_path=args.slo or None)
        wt.sentinel = sess.sentinel  # seeds hit the production sentinel
        wt.skip_history()
        watchtower.set_active(wt)
        for i in range(args.steps):
            loss = sess.step(x, y)
            step = sess._step - 1
            if args.seed_nan is not None and step == args.seed_nan:
                sess.sentinel.observe(step, float("nan"))
            if args.seed_spike is not None and step == args.seed_spike:
                sess.sentinel.observe(step, abs(loss) * 50.0 + 10.0)
            status = wt.poll_once()
            if not args.once:
                print(f"-- step {step} (loss {loss:.4f}) " + "-" * 40)
                print(render(status))
    finally:
        watchtower.set_active(None)
        sess.close()
        close_inproc_cluster(cluster)
        if args.fault:
            faults.reset()
    if args.json:
        print(json.dumps(status, indent=1))
    elif args.once:
        print(render(status))
    if args.check:
        return check_alerts(status, args.expect), {"status": status}
    return 0, {"status": status}


def run_connect(args) -> int:
    from tepdist_tpu_torch.rpc.client import TepdistClient
    from tepdist_tpu_torch.telemetry import watchtower

    clients = [TepdistClient(a.strip())
               for a in args.connect.split(",") if a.strip()]
    wt = watchtower.Watchtower(clients=clients, slo_path=args.slo or None,
                               interval_s=args.interval)
    status = {}
    try:
        polls = args.polls if args.once else (args.polls or 1 << 30)
        for _ in range(max(polls, 1)):
            status = wt.poll_once()
            if not args.once:
                # Crude live view: reprint the frame each poll.
                print("\x1b[2J\x1b[H" if sys.stdout.isatty() else "")
                print(render(status))
                time.sleep(args.interval)
    except KeyboardInterrupt:
        pass
    finally:
        for c in clients:
            c.close()
    if args.json:
        print(json.dumps(status, indent=1))
    elif args.once:
        print(render(status))
    if args.check:
        return check_alerts(status, args.expect), {"status": status}
    return 0, {"status": status}


def main(argv=None) -> dict:
    """``{"rc", "text", "status"}``."""
    from torch_cli import tee_main

    return tee_main(_main, argv)


def _main(argv):
    ap = argparse.ArgumentParser(
        "watch", description="live fleet dashboard (watchtower)")
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--demo", action="store_true",
                      help="self-contained two-worker in-proc fleet")
    mode.add_argument("--connect",
                      help="comma-separated worker addresses to poll")
    ap.add_argument("--steps", type=int, default=8,
                    help="demo: GA steps to run (default 8)")
    ap.add_argument("--fault",
                    help="demo: fault spec (runtime/faults.py grammar), "
                         "e.g. rpc_delay:ms=80,ti=1")
    ap.add_argument("--seed-nan", type=int, metavar="STEP",
                    help="demo: feed a NaN loss to the sentinel at STEP")
    ap.add_argument("--seed-spike", type=int, metavar="STEP",
                    help="demo: feed a 50x loss spike at STEP (keep it "
                         ">= 5 so the MAD window is armed)")
    ap.add_argument("--slo", help="slo.toml path for the burn-rate engine")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="connect: poll interval seconds")
    ap.add_argument("--polls", type=int, default=0,
                    help="connect: stop after N polls (0 = forever; "
                         "--once implies 1)")
    ap.add_argument("--once", action="store_true",
                    help="render the final state once and exit (CI)")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless --expect kinds are all active "
                         "(or, without --expect, unless ZERO alerts are)")
    ap.add_argument("--expect", default="",
                    help="comma-separated alert kinds --check requires, "
                         "e.g. straggler,loss_spike")
    ap.add_argument("--json", action="store_true",
                    help="dump the final status dict as JSON")
    ap.add_argument("--device", default="cuda",
                    help="demo: the workers' device (cuda or cpu)")
    args = ap.parse_args(argv)
    if args.connect:
        return run_connect(args)
    return run_demo(args)


if __name__ == "__main__":
    sys.exit(main()["rc"])
