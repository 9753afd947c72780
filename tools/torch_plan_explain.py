"""Render an ExplorationReport of the port: ranked table, cost waterfall,
prune forensics, winner rationale, and the predicted-vs-measured
scoreboard. The counterpart of ``tools/plan_explain.py``, with its flags
and output, over ``tepdist_tpu_torch/telemetry/observatory.py``.

The report is the planner's decision record: every proposal the explorer
enumerated, as a priced candidate or a typed prune record, plus WHY the
argmin picked the winner. This tool answers "why did the planner choose
that?" offline, from any of:

* a report JSON (``TEPDIST_PLAN_REPORT=...`` or ``ExplorationReport
  .save``), passed positionally;
* ``--trace FILE`` — a merged trace dumped by ``session.dump_trace()``
  (the report rides in ``metadata.exploration``; when
  ``metadata.fidelity`` is present too, the scoreboard joins the
  executed candidate's predicted cost terms against the MEASURED
  per-worker attribution);
* ``--fixture`` — live: explore the standard two-worker MLP fixture,
  execute the pipeline candidate on the in-process fleet
  (``tools/torch_fidelity_report.py``'s fixture, on ``--device``: the
  card unless ``--device cpu``), and join.

``--check`` exits non-zero unless the ledger is complete (every
enumerated proposal accounted, exactly one winner) and, when a
scoreboard was attempted, the join succeeded. ``main(argv)`` returns the
report beside what it printed (``tools/torch_cli.py``).

Run:
    python tools/torch_plan_explain.py report.json
    python tools/torch_plan_explain.py --trace /tmp/trace.json
    python tools/torch_plan_explain.py --fixture --check --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, Optional, Tuple

# The repository (the package) and this directory (the sibling tools).
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

_BAR = 40  # waterfall width in characters


def _load_report(path: str) -> Optional[Dict[str, Any]]:
    """Accept either a bare report JSON or a merged trace file."""
    with open(path) as f:
        doc = json.load(f)
    if "candidates" in doc and "version" in doc:
        return doc
    return (doc.get("metadata") or {}).get("exploration")


def print_table(report: Dict[str, Any], top: int = 0) -> None:
    cands = report.get("candidates") or []
    counts = report.get("counts") or {}
    print(f"exploration report — entry_point={report.get('entry_point')} "
          f"n_devices={report.get('n_devices')} "
          f"(schema v{report.get('version')})")
    print(f"proposals: {counts.get('enumerated')} enumerated = "
          f"{counts.get('candidates')} priced candidates + "
          f"{counts.get('pruned')} pruned "
          f"(by kind: {counts.get('candidates_by_kind')})")
    if report.get("excluded_kinds"):
        print(f"excluded kinds: {report['excluded_kinds']}")
    print(f"  {'rank':>4} {'kind':>8} {'config':<34} {'total_s':>11} "
          f"{'compute_s':>11} {'coll_s':>10} {'bubble_s':>10} "
          f"{'opt_MB':>7} {'mem':>4}")
    rows = cands[:top] if top else cands
    for c in rows:
        t = c["cost"]
        mark = "  <== winner" if c.get("winner") else ""
        if c.get("involuntary_remats"):
            mark += f" [{c['involuntary_remats']} involuntary remat(s)]"
        # Per-device optimizer-state bytes; pre-ZeRO reports
        # lack the term — show a dash, not 0 (0 would read as measured).
        opt = t.get("opt_state_bytes_per_device")
        opt_s = "-" if opt is None else f"{opt / 1e6:.3f}"
        print(f"  {c['rank']:>4} {c['kind']:>8} {c['config']:<34} "
              f"{t['total_s']:>11.4e} {t['compute_s']:>11.4e} "
              f"{t['coll_s']:>10.3e} {t['bubble_s']:>10.3e} "
              f"{opt_s:>7} "
              f"{'ok' if t['memory_feasible'] else 'OOM':>4}{mark}")
    if top and len(cands) > top:
        print(f"  ... {len(cands) - top} more candidate(s)")


def print_waterfall(report: Dict[str, Any], n: int = 5) -> None:
    """Per-candidate cost waterfall: how each candidate's step time
    decomposes into compute / collective / bubble."""
    cands = (report.get("candidates") or [])[:n]
    if not cands:
        return
    ref = max(c["cost"]["total_s"] for c in cands) or 1.0
    print(f"cost waterfall (top {len(cands)}; bar = share of "
          f"{ref:.3e}s):")
    for c in cands:
        t = c["cost"]
        width = max(int(_BAR * t["total_s"] / ref), 1)
        parts = []
        for term, ch in (("compute_s", "#"), ("coll_s", "~"),
                         ("bubble_s", ".")):
            w = (int(round(width * t[term] / t["total_s"]))
                 if t["total_s"] else 0)
            parts.append(ch * w)
        bar = "".join(parts)[:width].ljust(width)
        print(f"  {c['config']:<34} |{bar}| "
              f"{t['total_s']:.3e}s"
              + ("  <== winner" if c.get("winner") else ""))
    print("  legend: # compute  ~ collective  . bubble")


def print_prunes(report: Dict[str, Any], verbose: bool = False) -> None:
    prunes = report.get("prunes") or []
    hist = report.get("prune_histogram") or {}
    if hist:
        print("prune histogram: "
              + "  ".join(f"{k}={v}" for k, v in sorted(hist.items())))
    suspicious = [p for p in prunes if p.get("suspect_bug")]
    if suspicious:
        print(f"  !! {len(suspicious)} prune(s) with planner-bug "
              "exception types:")
        for p in suspicious:
            print(f"     {p['kind']} {p['config']}: {p['exc_type']}: "
                  f"{p['message']}")
    if verbose and prunes:
        print("prunes:")
        for p in prunes:
            why = (f"{p['exc_type']}: {p['message']}"
                   if p.get("exc_type") else p.get("message", ""))
            print(f"  {p['kind']:>8} {p['config']:<24} "
                  f"{p['reason']:<20} {why}")
    for w in report.get("warnings") or []:
        print(f"  WARNING: {w}")


def print_rationale(report: Dict[str, Any]) -> None:
    r = report.get("rationale")
    w = report.get("winner")
    if not r or not w:
        print("no winner rationale (empty candidate set?)")
        return
    if r["deciding_term"] == "only_feasible_candidate":
        print(f"winner {w['config']}: the only feasible candidate")
        return
    if r["deciding_term"] == "tie":
        print(f"winner {w['config']}: exact cost tie with runner-up "
              f"{r.get('runner_up_config')} — argmin order decided")
        return
    print(f"winner {w['config']} beats runner-up "
          f"{r.get('runner_up_config')} by {r['delta_s']:.3e}s; "
          f"deciding term: {r['deciding_term']} "
          f"(per-term deltas: "
          + ", ".join(f"{t}={d:+.3e}s"
                      for t, d in (r.get("terms") or {}).items())
          + ")")
    remats = report.get("lowering_remats")
    if remats:
        print(f"  lowering post-check: {len(remats)} involuntary "
              f"remat(s) on the winner — the cost model did not price "
              "this recompute")
    elif remats is not None and isinstance(remats, list):
        print("  lowering post-check: clean (no involuntary remats)")


def print_scoreboard(sb: Dict[str, Any]) -> None:
    if not sb.get("ok"):
        print(f"scoreboard: not available ({sb.get('problems')})")
        return
    role = "winner" if sb.get("is_winner") else "executed candidate"
    print(f"predicted-vs-measured scoreboard ({role} "
          f"{sb['winner_kind']}:{sb['winner_config']}, "
          f"{sb['n_worker_lanes']} worker lane(s)):")
    print(f"  {'term':<12} {'predicted_ms':>13} {'measured_ms':>12} "
          f"{'drift_ms':>10} {'ratio':>8}")
    for term, row in sb["terms"].items():
        meas = ("-" if row["measured_ms"] is None
                else f"{row['measured_ms']:.3f}")
        drift = ("-" if row["drift_ms"] is None
                 else f"{row['drift_ms']:+.3f}")
        ratio = ("-" if row["ratio"] is None
                 else f"{row['ratio']:.2f}x")
        print(f"  {term:<12} {row['predicted_ms']:>13.3f} {meas:>12} "
              f"{drift:>10} {ratio:>8}")


def run_fixture(steps: int = 4, device: str = "cuda"
                ) -> Tuple[Dict[str, Any], Dict[str, Any], str]:
    """Standard two-worker fixture: explore the fidelity-fixture loss,
    then execute the S=2 M=2 pipeline candidate on the in-process fleet
    (tools/torch_fidelity_report.py's fixture) and join
    predicted-vs-measured. Returns (report, fidelity_report,
    executed_config)."""
    from tepdist_tpu_torch.core.device import resolve_device
    from tepdist_tpu_torch.parallel.exploration import explore
    from torch_fidelity_report import (_fixture_inputs,
                                             _fixture_loss)
    from torch_fidelity_report import run_fixture as fid_fixture

    params, x, y = _fixture_inputs(resolve_device(device))
    best = explore(_fixture_loss, params, x, y, n_devices=2,
                   num_micro_batches=2, entry_point="plan_explain")
    report = best["report"]
    fid = fid_fixture(steps=steps, device=device)
    return report, fid, "S=2 M=2"


def main(argv=None) -> Dict[str, Any]:
    """``{"rc", "text", "report", "completeness", "scoreboard"}``."""
    from torch_cli import tee_main

    return tee_main(_main, argv)


def _main(argv):
    ap = argparse.ArgumentParser("plan_explain")
    ap.add_argument("report", nargs="?", default=None,
                    help="ExplorationReport JSON (or a merged trace "
                         "file carrying metadata.exploration)")
    ap.add_argument("--trace", default=None,
                    help="merged trace from session.dump_trace(); "
                         "report from metadata.exploration, scoreboard "
                         "from metadata.fidelity when present")
    ap.add_argument("--fixture", action="store_true",
                    help="live: explore + execute the standard "
                         "two-worker fixture and join the scoreboard")
    ap.add_argument("--steps", type=int, default=4,
                    help="fixture mode: training steps")
    ap.add_argument("--device", default="cuda",
                    help="fixture mode: the workers' device (cuda or cpu)")
    ap.add_argument("--config", default=None,
                    help="scoreboard: join this candidate config "
                         "instead of the winner")
    ap.add_argument("--waterfall", type=int, default=5,
                    help="candidates in the cost waterfall (0: off)")
    ap.add_argument("--top", type=int, default=0,
                    help="limit the ranked table (0: all)")
    ap.add_argument("--prunes", action="store_true",
                    help="list every prune record")
    ap.add_argument("--check", action="store_true",
                    help="exit 1 unless the ledger is complete and the "
                         "scoreboard (when attempted) joined")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    from tepdist_tpu_torch.telemetry import observatory

    sb = None
    executed = args.config
    if args.fixture:
        report, fid, executed = run_fixture(steps=args.steps,
                                            device=args.device)
        executed = args.config or executed
        sb = observatory.scoreboard(report, fid, config=executed)
    elif args.trace:
        with open(args.trace) as f:
            trace = json.load(f)
        report = observatory.report_from_trace(trace)
        if report is None:
            print(f"{args.trace}: no metadata.exploration — re-dump "
                  "with session.dump_trace() after an explore-mode "
                  "compile", file=sys.stderr)
            return 2
        from tepdist_tpu_torch.telemetry import fidelity
        fid = fidelity.report_from_trace(trace)
        if fid is not None:
            sb = observatory.scoreboard(report, fid, config=executed)
    elif args.report:
        report = _load_report(args.report)
        if report is None:
            print(f"{args.report}: neither an ExplorationReport nor a "
                  "trace with metadata.exploration", file=sys.stderr)
            return 2
    else:
        ap.error("give a report file, --trace, or --fixture")

    comp = observatory.completeness(report)
    data = {"report": report, "completeness": comp, "scoreboard": sb}

    if args.json:
        out = {"report": {k: v for k, v in report.items()},
               "completeness": comp}
        if sb is not None:
            out["scoreboard"] = sb
        print(json.dumps(out, indent=1, default=str))
    else:
        print_table(report, top=args.top)
        if args.waterfall:
            print_waterfall(report, n=args.waterfall)
        print_prunes(report, verbose=args.prunes)
        print_rationale(report)
        if sb is not None:
            print_scoreboard(sb)
        status = ("complete" if comp["ok"]
                  else f"INCOMPLETE: {comp['problems']}")
        print(f"ledger: {comp['candidates']} candidates + "
              f"{comp['prunes']} prunes, {comp['unaccounted']} "
              f"unaccounted — {status}")

    if args.check:
        ok = comp["ok"] and (sb is None or sb.get("ok"))
        if not ok:
            print(f"plan_explain check FAILED (completeness="
                  f"{comp['problems']}, scoreboard="
                  f"{None if sb is None else sb.get('problems')})",
                  file=sys.stderr)
            return 1, data
        print("plan_explain check OK")
    return 0, data


if __name__ == "__main__":
    sys.exit(main()["rc"])
