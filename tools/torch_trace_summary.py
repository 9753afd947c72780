"""Summarize a merged trace of the port: where did the step time go?
The counterpart of ``tools/trace_summary.py``, with its flags and output.

Reads a Chrome-trace-event JSON file (the output of the port's
``session.dump_trace()`` / ``DistributedPipelineSession.dump_trace()``,
``tepdist_tpu_torch/telemetry/export.py``) and prints:

  * per-category time (compute / send / recv / ga / apply / rpc / planner),
  * per-worker busy fraction (union of task spans over the worker's
    active window — envelope spans like run_step/rpc don't count as busy),
  * a pipeline-bubble estimate per worker (1 - compute-busy / window),
  * the digests of what the trace's metadata carries: alerts, the
    fidelity join, the RPC ledger, the flight recorder, the exploration
    report.

It reads JSON only: no device. ``main(argv)`` returns the summary beside
what it printed (``tools/torch_cli.py``).

Run: python tools/torch_trace_summary.py TRACE.json [--json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Tuple

# The repository (the package) and this directory (the sibling tools).
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Envelope categories: they CONTAIN task spans, so counting them toward
# busy time would make every worker look 100% occupied.
ENVELOPE_CATS = {"step", "rpc"}


def load_trace(path: str) -> Dict[str, Any]:
    with open(path) as f:
        trace = json.load(f)
    if "traceEvents" not in trace:
        raise ValueError(f"{path}: not a trace-event JSON object")
    return trace


def _union_ms(intervals: List[Tuple[float, float]]) -> float:
    """Total covered time (ms) of possibly-overlapping [t0, t1) us spans."""
    total = 0.0
    end = None
    for t0, t1 in sorted(intervals):
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total / 1e3


def summarize(trace: Dict[str, Any]) -> Dict[str, Any]:
    events = [e for e in trace.get("traceEvents", ())
              if e.get("ph") == "X"]
    proc_names = {e["pid"]: e["args"]["name"]
                  for e in trace.get("traceEvents", ())
                  if e.get("ph") == "M"
                  and e.get("name") == "process_name"}

    by_cat: Dict[str, float] = {}
    per_pid: Dict[Any, Dict[str, List[Tuple[float, float]]]] = {}
    for e in events:
        cat = e.get("cat", "misc")
        dur = float(e.get("dur", 0.0))
        by_cat[cat] = by_cat.get(cat, 0.0) + dur / 1e3
        b = per_pid.setdefault(e["pid"], {"task": [], "compute": [],
                                          "all": []})
        iv = (float(e["ts"]), float(e["ts"]) + dur)
        b["all"].append(iv)
        if cat not in ENVELOPE_CATS:
            b["task"].append(iv)
        if cat == "compute":
            b["compute"].append(iv)

    workers = {}
    for pid, b in sorted(per_pid.items()):
        if not b["all"]:
            continue
        t_lo = min(t0 for t0, _ in b["all"])
        t_hi = max(t1 for _, t1 in b["all"])
        window_ms = (t_hi - t_lo) / 1e3
        busy_ms = _union_ms(b["task"])
        compute_ms = _union_ms(b["compute"])
        workers[str(pid)] = {
            "label": proc_names.get(pid, f"pid{pid}"),
            "window_ms": round(window_ms, 3),
            "busy_ms": round(busy_ms, 3),
            "busy_fraction": round(busy_ms / window_ms, 3)
            if window_ms else 0.0,
            "compute_ms": round(compute_ms, 3),
            "bubble_fraction": round(1.0 - compute_ms / window_ms, 3)
            if window_ms else None,
        }
    meta = trace.get("metadata", {}) or {}
    out = {
        "n_events": len(events),
        "category_ms": {k: round(v, 3)
                        for k, v in sorted(by_cat.items())},
        "workers": workers,
        "metrics": meta.get("metrics"),
    }
    for key in ("spans_dropped", "ledger_dropped", "flight_dropped",
                "flight_sampled_out"):
        if meta.get(key):
            out[key] = meta[key]
    # Watchtower alerts active when the trace was dumped
    # (telemetry/watchtower.py): a run that ended with a live
    # straggler/NaN/SLO-burn alert must say so in its post-hoc summary.
    if meta.get("alerts"):
        out["alerts"] = meta["alerts"]
    fid = _fidelity_section(trace)
    if fid is not None:
        out["fidelity"] = fid
    led = _ledger_section(trace)
    if led is not None:
        out["ledger"] = led
    fl = _flight_section(trace)
    if fl is not None:
        out["flight"] = fl
    ex = _exploration_section(trace)
    if ex is not None:
        out["exploration"] = ex
    return out


def _exploration_section(trace: Dict[str, Any]) -> Any:
    """Planner decision-record digest when the trace embeds an
    ExplorationReport (metadata.exploration, session.dump_trace):
    candidate count by kind, prune histogram by reason, winner +
    runner-up delta, and scoreboard drift against the fidelity
    attribution when that metadata is present too."""
    report = (trace.get("metadata") or {}).get("exploration")
    if not report:
        return None
    try:
        from tepdist_tpu_torch.telemetry import fidelity, observatory
    except ImportError:
        return {"error": "tepdist_tpu_torch not importable"}
    counts = report.get("counts") or {}
    winner = report.get("winner") or {}
    rationale = report.get("rationale") or {}
    out = {
        "entry_point": report.get("entry_point"),
        "candidates_by_kind": counts.get("candidates_by_kind"),
        "prune_histogram": report.get("prune_histogram"),
        "winner": (f"{winner.get('kind')}:{winner.get('config')}"
                   if winner else None),
        "runner_up_delta_s": rationale.get("delta_s"),
        "deciding_term": rationale.get("deciding_term"),
        "warnings": report.get("warnings") or [],
        "completeness": observatory.completeness(report),
    }
    if report.get("lowering_remats"):
        out["lowering_remats"] = len(report["lowering_remats"])
    fid = fidelity.report_from_trace(trace)
    if fid is not None:
        sb = observatory.scoreboard(report, fid)
        if sb.get("ok"):
            out["scoreboard_drift"] = {
                t: row["drift_ms"] for t, row in sb["terms"].items()}
    return out


def _ledger_section(trace: Dict[str, Any]) -> Any:
    """Per-verb wire/serde totals + the step gap table when the trace
    embeds a merged RPC ledger (metadata.ledger, TEPDIST_LEDGER=1)."""
    snap = (trace.get("metadata") or {}).get("ledger")
    if not snap:
        return None
    try:
        from tepdist_tpu_torch.telemetry import ledger
    except ImportError:
        return {"error": "tepdist_tpu_torch not importable"}
    verbs = {}
    for v, s in (snap.get("verbs") or {}).items():
        verbs[v] = {
            "calls": int(s.get("calls", 0)),
            "retries": int(s.get("retries", 0)),
            "tx_bytes": int(s.get("tx_header_bytes", 0)
                            + s.get("tx_blob_bytes", 0)),
            "rx_bytes": int(s.get("rx_header_bytes", 0)
                            + s.get("rx_blob_bytes", 0)),
            "encode_ms": round(s.get("encode_us", 0) / 1e3, 3),
            "decode_ms": round(s.get("decode_us", 0) / 1e3, 3),
            "client_ms": round(s.get("client_us", 0) / 1e3, 3),
            "server_ms": round(s.get("server_us", 0) / 1e3, 3),
        }
    return {"verbs": verbs,
            "gap_table": ledger.gap_table(snap),
            "intervals_dropped": snap.get("intervals_dropped")}


def _flight_section(trace: Dict[str, Any]) -> Any:
    """Per-request digest of the serving flight recorder
    (metadata.flight): event counts, terminal state, engine
    generations touched, and queue->deliver latency."""
    events = (trace.get("metadata") or {}).get("flight")
    if not events:
        return None
    TERMINAL = ("deliver", "finish", "fail", "cancel", "expire",
                "reject", "overload")
    reqs = {}
    for e in events:
        rid = e.get("rid", "?")
        r = reqs.setdefault(rid, {"events": 0, "first_ts": None,
                                  "last_ts": None, "gens": set(),
                                  "terminal": None, "by_ev": {}})
        r["events"] += 1
        ts = e.get("ts", 0)
        if r["first_ts"] is None:
            r["first_ts"] = ts
        r["last_ts"] = ts
        ev = e.get("ev", "?")
        r["by_ev"][ev] = r["by_ev"].get(ev, 0) + 1
        gen = (e.get("args") or {}).get("gen")
        if gen is not None:
            r["gens"].add(gen)
        if ev in TERMINAL:
            r["terminal"] = ev
    out = {}
    for rid, r in sorted(reqs.items()):
        out[rid] = {
            "events": r["events"],
            "gens": sorted(r["gens"]),
            "terminal": r["terminal"],
            "span_ms": round((r["last_ts"] - r["first_ts"]) / 1e3, 3),
            "by_ev": r["by_ev"],
        }
    return out


def _fidelity_section(trace: Dict[str, Any]) -> Any:
    """Predicted-vs-measured summary when the trace embeds the
    simulator's timeline (session.dump_trace metadata)."""
    if not ((trace.get("metadata") or {}).get("fidelity")
            or {}).get("predicted"):
        return None
    try:
        from tepdist_tpu_torch.telemetry import fidelity
    except ImportError:
        return {"error": "tepdist_tpu_torch not importable"}
    report = fidelity.report_from_trace(trace)
    if report is None:
        return None
    return {
        "step": report["step"],
        "join": report["join"],
        "per_kind": report["per_kind"],
        "predicted_step_ms": report["predicted_step_ms"],
        "measured_step_ms": report["measured_step_ms"],
        "attribution": report["attribution"],
    }


def _pctl(h: Dict[str, Any]) -> str:
    parts = []
    for k in ("p50", "p95", "p99"):
        v = h.get(k)
        if v is not None:
            parts.append(f"{k}={v:.3f}")
    return " ".join(parts)


def main(argv=None) -> Dict[str, Any]:
    """``{"rc", "text", "summary"}``."""
    from torch_cli import tee_main

    return tee_main(_main, argv)


def _main(argv):
    ap = argparse.ArgumentParser("trace_summary")
    ap.add_argument("trace", help="merged trace JSON (session.dump_trace)")
    ap.add_argument("--json", action="store_true",
                    help="print the summary as JSON instead of text")
    args = ap.parse_args(argv)
    s = summarize(load_trace(args.trace))
    if args.json:
        print(json.dumps(s, indent=1))
        return 0, {"summary": s}
    print(f"{s['n_events']} spans")
    for a in s.get("alerts") or ():
        who = (f" worker={a['worker']}" if a.get("worker") is not None
               else "")
        print(f"ALERT [{a.get('severity', 'warn')}] "
              f"{a.get('key', a.get('kind'))}:{who} {a.get('detail')} "
              f"(x{a.get('count', 1)})")
    if s.get("spans_dropped"):
        drops = ", ".join(f"{k}={v}"
                          for k, v in sorted(s["spans_dropped"].items()))
        print(f"WARNING: LOSSY trace — span ring overflowed ({drops}); "
              f"missing spans read as idle time "
              f"(raise TEPDIST_TRACE_CAPACITY)")
    if s.get("ledger_dropped"):
        drops = ", ".join(f"{k}={v}"
                          for k, v in sorted(s["ledger_dropped"].items()))
        print(f"WARNING: LOSSY ledger — ring overflowed ({drops} records); "
              f"gap-table sums undercount "
              f"(raise TEPDIST_LEDGER_RING)")
    if s.get("flight_dropped"):
        drops = ", ".join(f"{k}={v}"
                          for k, v in sorted(s["flight_dropped"].items()))
        print(f"WARNING: LOSSY flight recorder — ring overflowed ({drops} "
              f"events); request waterfalls have missing hops "
              f"(raise TEPDIST_FLIGHT_CAPACITY)")
    if s.get("flight_sampled_out"):
        drops = ", ".join(f"{k}={v}" for k, v in
                          sorted(s["flight_sampled_out"].items()))
        print(f"note: flight head-sampling active — {drops} events shed "
              f"by TEPDIST_FLIGHT_SAMPLE (counted, not lost)")
    print("per-category time:")
    for cat, ms in s["category_ms"].items():
        print(f"  {cat:<12} {ms:10.3f} ms")
    print("per-worker:")
    for pid, w in s["workers"].items():
        bubble = (f"  bubble={w['bubble_fraction']:.1%}"
                  if w["bubble_fraction"] is not None else "")
        print(f"  {w['label']:<10} (pid {pid}) window={w['window_ms']:.1f} "
              f"ms busy={w['busy_fraction']:.1%}{bubble}")
    counters = (s.get("metrics") or {}).get("counters") or {}
    fault = {k: v for k, v in counters.items()
             if k.split(":")[0] in (
                 "fault_injected", "rpc_retries", "step_retries",
                 "dedup_hits", "worker_revived", "elastic_redispatch",
                 "checkpoint_rollback_steps")}
    if fault:
        print("fault recovery:")
        for k, v in sorted(fault.items()):
            print(f"  {k:<28} {v}")
    # Heartbeat RTT percentiles, pooled and per worker: the monitor has
    # fed these histograms since the health PR, but only the last-sample
    # gauge was ever printed — the tail (the straggler signal) was
    # invisible post-hoc.
    all_hists = (s.get("metrics") or {}).get("histograms") or {}
    hb = {k: h for k, h in all_hists.items()
          if k == "heartbeat_rtt_ms" or k.startswith("heartbeat_rtt_ms:")}
    if hb:
        print("health (heartbeat rtt, ms):")
        for k, h in sorted(hb.items()):
            label = ("fleet" if k == "heartbeat_rtt_ms"
                     else f"worker {k.split(':', 1)[1]}")
            print(f"  {label:<28} {_pctl(h)} n={h['count']}")
    # Serving recovery/overload counters don't share the serve_ prefix
    # (engine_restarts etc. name the mechanism, not the plane).
    SERVING_EXTRA = ("engine_restarts", "requests_replayed",
                     "drain_handoffs")
    serving = {k: v for k, v in counters.items()
               if k.startswith("serve_") or k in SERVING_EXTRA}
    if serving:
        print("serving:")
        for k, v in sorted(serving.items()):
            print(f"  {k:<28} {v}")
        gauges = (s.get("metrics") or {}).get("gauges") or {}
        for k in ("serve_breaker_open", "serve_queue_depth",
                  "serve_slot_occupancy"):
            if k in gauges:
                print(f"  {k:<28} {gauges[k]} (gauge)")
        hists = (s.get("metrics") or {}).get("histograms") or {}
        for k in ("serve_ttft_ms", "serve_token_ms", "serve_request_ms",
                  "serve_batch_size"):
            h = hists.get(k)
            if h:
                # SLO percentiles (reservoir), not means — a mean hides
                # exactly the tail the SLO is about.
                print(f"  {k:<28} {_pctl(h)} mean={h['mean']:.3f} "
                      f"max={h['max']:.3f} n={h['count']}")
    # Paged-KV plane: page-pool occupancy and prefix-cache effectiveness
    # (absent entirely under the slot fallback — don't print zeros).
    PAGED_COUNTERS = ("prefill_chunks", "prefix_hits",
                      "prefix_hit_tokens", "prefix_evictions",
                      "pages_cow")
    paged = {k: counters[k] for k in PAGED_COUNTERS if k in counters}
    paged_gauges = {k: v for k, v in
                    (((s.get("metrics") or {}).get("gauges")
                      or {}).items())
                    if k in ("pages_used", "pages_free", "pages_cached")}
    if paged or paged_gauges:
        print("paged kv:")
        for k, v in sorted(paged.items()):
            print(f"  {k:<28} {v}")
        for k, v in sorted(paged_gauges.items()):
            print(f"  {k:<28} {v} (gauge)")
    rpc_hists = {k: h for k, h in
                 ((s.get("metrics") or {}).get("histograms")
                  or {}).items() if k.startswith("rpc_ms:")}
    if rpc_hists:
        print("rpc latency (ms):")
        for k, h in sorted(rpc_hists.items()):
            print(f"  {k:<28} {_pctl(h)} n={h['count']}")
    fid = s.get("fidelity")
    if fid:
        j = fid["join"]
        print("fidelity (predicted vs measured, "
              f"step {fid['step']}):")
        print(f"  join: {j['matched']} matched ({j['fraction']:.1%}), "
              f"{len(j['orphan_predicted'])}+{len(j['orphan_measured'])} "
              f"orphans")
        print(f"  step: predicted={fid['predicted_step_ms']} ms "
              f"measured={fid['measured_step_ms']} ms")
        for kind, a in sorted(fid["per_kind"].items()):
            ratio = (f"{a['ratio']:.2f}x" if a["ratio"] is not None
                     else "-")
            print(f"  {kind:<10} n={a['n']:<3} pred={a['predicted_ms']} "
                  f"meas={a['measured_ms']} ({ratio})")
        for lane, a in fid["attribution"].items():
            print(f"  worker {lane}: compute={a['compute_ms']} "
                  f"collective={a['collective_ms']} "
                  f"transfer={a['transfer_ms']} "
                  f"serde={a['host_serde_ms']} idle={a['idle_ms']} "
                  f"(window {a['window_ms']} ms)")
    ex = s.get("exploration")
    if ex and not ex.get("error"):
        print(f"exploration (entry_point={ex['entry_point']}; full "
              "report: tools/torch_plan_explain.py):")
        print(f"  candidates by kind: {ex['candidates_by_kind']}  "
              f"prunes: {ex['prune_histogram'] or '{}'}")
        delta = (f" (beats runner-up by {ex['runner_up_delta_s']:.3e}s, "
                 f"deciding term: {ex['deciding_term']})"
                 if ex.get("runner_up_delta_s") is not None else
                 f" (deciding term: {ex['deciding_term']})"
                 if ex.get("deciding_term") else "")
        print(f"  winner: {ex['winner']}{delta}")
        if ex.get("lowering_remats"):
            print(f"  lowering post-check: {ex['lowering_remats']} "
                  "involuntary remat(s)")
        comp = ex.get("completeness") or {}
        if not comp.get("ok", True):
            print(f"  LEDGER INCOMPLETE: {comp.get('problems')}")
        if ex.get("scoreboard_drift"):
            drifts = "  ".join(f"{t}={v:+.3f}" if v is not None
                               else f"{t}=-"
                               for t, v in ex["scoreboard_drift"].items())
            print(f"  scoreboard drift (measured-predicted, ms): "
                  f"{drifts}")
        for w in ex.get("warnings") or []:
            print(f"  WARNING: {w}")
    led = s.get("ledger")
    if led and not led.get("error"):
        print("rpc ledger (per verb):")
        print(f"  {'verb':<24} {'calls':>6} {'tx_bytes':>10} "
              f"{'rx_bytes':>10} {'enc_ms':>8} {'dec_ms':>8} "
              f"{'cli_ms':>9} {'srv_ms':>9}")
        for v, r in sorted(led["verbs"].items(),
                           key=lambda kv: -kv[1]["client_ms"]):
            print(f"  {v:<24} {r['calls']:>6} {r['tx_bytes']:>10} "
                  f"{r['rx_bytes']:>10} {r['encode_ms']:>8.3f} "
                  f"{r['decode_ms']:>8.3f} {r['client_ms']:>9.3f} "
                  f"{r['server_ms']:>9.3f}")
        agg = (led.get("gap_table") or {}).get("aggregate")
        if agg:
            b = agg["buckets"]
            print(f"  step gap table (mean over {agg['n_steps']} steady "
                  f"steps, wall {agg['wall_ms']} ms, coverage "
                  f"{agg['coverage']:.1%}):")
            print(f"    serde={b['serde_ms']} "
                  f"rpc_orchestration={b['rpc_orchestration_ms']} "
                  f"compute={b['compute_ms']} "
                  f"dependency_idle={b['dependency_idle_ms']} "
                  f"unattributed={b['unattributed_ms']} ms")
    fl = s.get("flight")
    if fl:
        print("flight recorder (per request; full waterfall: "
              "tools/torch_request_trace.py):")
        for rid, r in fl.items():
            gens = f" gens={r['gens']}" if r["gens"] else ""
            print(f"  {rid:<12} {r['events']:>3} events "
                  f"span={r['span_ms']:.1f} ms "
                  f"terminal={r['terminal']}{gens}")
    analysis = {k: v for k, v in counters.items()
                if k in ("plan_verified", "lockdep_runtime_edges")}
    if analysis:
        print("static analysis:")
        for k, v in sorted(analysis.items()):
            print(f"  {k:<28} {v}")
    rest = {k: v for k, v in counters.items()
            if k not in fault and k not in serving and k not in analysis}
    if rest:
        print("counters:")
        for k, v in sorted(rest.items()):
            print(f"  {k:<28} {v}")
    return 0, {"summary": s}


if __name__ == "__main__":
    sys.exit(main()["rc"])
