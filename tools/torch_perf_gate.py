"""Perf regression gate of the port over a rolling bench history: the
counterpart of ``tools/perf_gate.py``, with its flags, rows, history lines
and exit codes, over ``tools/torch_plan_diff.py`` and
``tepdist_tpu_torch/telemetry/observatory.py``.

The port's benches and tools (``tools/torch_serve_load.py``,
``torch_obs_overhead.py``, ``torch_chaos_run.py``, ``torch_ledger_report.py``)
emit point-in-time numbers; this tool makes them a TREND. Each
``--record`` appends one line to the history::

    {"ts": ..., "values": {"two_worker_fleet_ms": 103.2, ...}, "meta": ...}

flattened from bench_extra.json-shaped records: every record's ``value``
lands under its ``metric`` name, and nested numeric measurement fields
(``*_ms``/``*_us``/``*_x``/``*_pct``/``*tok_s``) are promoted under their
own names.

The default history is ``torch_bench_history.jsonl`` at the repository's
root, the port's own: the JAX package's ``bench_history.jsonl`` holds
numbers from other machines and is never read or written here.

``--check`` compares the current run against a rolling baseline per key:
the MEDIAN of the last k (default 5, minimum 3) prior recordings, with a
noise band of ``max(3 * 1.4826 * MAD, band_pct * median)`` — the MAD term
tracks each metric's own run-to-run jitter, the ``band_pct`` floor stops
a freakishly quiet history from flagging sub-noise wobble. Direction is
inferred from the key name (``tok_s``/``_x``/``_per_s``/``_rate`` higher
is better; everything else, e.g. ``_ms``, lower is better). A key with
insufficient history is reported but never fails the gate. Exit codes:
0 pass, 1 a regression, a vanished key or an uncovered winner flip, 2
nothing to check.

``--seed-regression KEY:PCT`` perturbs the current value by PCT in the
bad direction before checking, and never writes to the history — the
smoke scripts use it to prove the gate actually trips.

It reads and writes JSON only; ``--plan-diff`` alone imports the port's
package. ``main(argv)`` returns the verdict rows beside what it printed
(``tools/torch_cli.py``).

Run:
    python tools/torch_perf_gate.py --record bench_extra.json
    python tools/torch_perf_gate.py --record bench_extra.json --check
    python tools/torch_perf_gate.py --check \\
        --seed-regression two_worker_fleet_ms:20
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

# The repository (the package) and this directory (the sibling tools).
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

DEFAULT_HISTORY = os.path.join(HERE, "torch_bench_history.jsonl")

# The lines the gate watches by default, the JAX gate's own list. The
# port's smoke scripts record them: the fleet step and its hot-path
# buckets (scripts/torch_{ledger,hotpath}_smoke.sh, from the ledger gap
# table), the exploration report's capture time (torch_explain_smoke.sh),
# the int8 wire ratio and the ZeRO state ratio (torch_{quant,zero}_smoke.sh).
# --keys widens or narrows the watchlist; recording always keeps
# everything.
DEFAULT_KEYS = ("two_worker_fleet_ms", "two_worker_fleet_compressed_ms",
                "two_worker_fleet_zero_ms",
                "serving_tok_s", "paged_capacity_x", "plan_verify_ms",
                "rpc_orchestration_ms", "serde_ms",
                "explore_report_ms", "quantized_ar_x",
                "zero_opt_mem_x",
                "host_push_bytes_per_step",
                # The always-on instruments' own cost, self-gated like any
                # other perf line (tools/torch_obs_overhead.py records
                # them).
                "ledger_overhead_pct", "trace_enabled_ns_per_span",
                "flight_overhead_pct",
                # The watchtower's cost (sentinel observe + delta
                # polling) on the fleet step.
                "watch_overhead_pct",
                # Elastic live-migration stall, fence to resume
                # (scripts/torch_elastic_smoke.sh records it from the
                # chaos tool's kill-worker run).
                "migration_stall_ms",
                # Disaggregated prefill/decode serving: submit ->
                # decoding TTFT through the split pools and the
                # prefilled -> decoding KV-page handoff itself
                # (scripts/torch_disagg_smoke.sh records both from
                # torch_serve_load --disagg).
                "disagg_ttft_ms", "kv_handoff_ms",
                # Control-plane crash safety: the WAL's cost on the step
                # path (null-calibrated) and the master takeover wall
                # from WAL replay to fleet resumed
                # (scripts/torch_controlplane_smoke.sh records it from
                # torch_chaos_run --kill-master).
                "master_recover_ms", "wal_overhead_pct")

# Per-key relative noise-band floors overriding the global --band-pct
# when larger.  The overhead percentages are ratios of two noisy
# sub-millisecond timings (instrument cost / workload wall), which
# carries ~+/-10% run-to-run jitter even with min-based estimators —
# a 10% floor would flap.  15% still trips the smoke's seeded 20%
# regression, and the absolute budget is enforced independently by
# ``torch_obs_overhead --check``; this band only needs to catch drift.
BAND_FLOOR_PCT = {"ledger_overhead_pct": 0.15, "flight_overhead_pct": 0.15,
                  "watch_overhead_pct": 0.15,
                  # Migration stall is a one-shot wall time over process
                  # scheduling + checkpoint IO + RPC fan-out; local runs
                  # jitter well past the default band.  25% still trips
                  # the elastic smoke's seeded 50% regression.
                  "migration_stall_ms": 0.25,
                  # Disagg handoff/TTFT are small wall times over poll
                  # loops + nested RPC pulls; 20% absorbs scheduler
                  # jitter yet still trips the disagg smoke's seeded
                  # 30% regression on kv_handoff_ms.
                  "disagg_ttft_ms": 0.2, "kv_handoff_ms": 0.2,
                  # Master takeover is WAL replay + fleet ping + plan
                  # reconcile — one-shot wall over process scheduling and
                  # RPC fan-out, same jitter class as migration_stall_ms.
                  # 25% still trips the smoke's seeded 50% regression.
                  "master_recover_ms": 0.25,
                  # WAL overhead is a ratio of two noisy sub-ms timings,
                  # same class as the other *_overhead_pct lines.
                  "wal_overhead_pct": 0.15}

_HIGHER_BETTER_SUFFIXES = ("tok_s", "_x", "_per_s", "_rate", "_speedup")
_PROMOTE_SUFFIXES = ("_ms", "_us", "_x", "_pct", "tok_s", "_per_s",
                     "_rate", "_per_span")


def higher_is_better(key: str) -> bool:
    return key.endswith(_HIGHER_BETTER_SUFFIXES)


def _numeric(v: Any) -> Optional[float]:
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return None
    return float(v)


def flatten_records(records: List[Dict[str, Any]]) -> Dict[str, float]:
    """bench_extra.json lines -> flat {key: value}. ``value`` lands under
    the record's ``metric``; nested numeric measurement fields are
    promoted under their own (unprefixed) names."""
    out: Dict[str, float] = {}
    for rec in records:
        metric = rec.get("metric")
        v = _numeric(rec.get("value"))
        if metric and v is not None:
            out[metric] = v
        for k, nested in rec.items():
            if k in ("value", "metric"):
                continue
            nv = _numeric(nested)
            if nv is not None and k.endswith(_PROMOTE_SUFFIXES):
                out[k] = nv
    return out


def serve_json_values(summary: Dict[str, Any]) -> Dict[str, float]:
    """tools/torch_serve_load.py --out summary -> gate keys."""
    out: Dict[str, float] = {}
    tok = _numeric(summary.get("tokens_per_s"))
    if tok is not None:
        out["serving_tok_s"] = tok
    ttft = summary.get("ttft_ms") or {}
    for pct in ("p50", "p95"):
        v = _numeric(ttft.get(pct))
        if v is not None:
            out[f"serving_ttft_ms_{pct}"] = v
    # Disaggregated runs (serve_load --disagg) carry the handoff lines.
    for key in ("disagg_ttft_ms", "kv_handoff_ms"):
        v = _numeric(summary.get(key))
        if v is not None:
            out[key] = v
    return out


def read_history(path: str) -> List[Dict[str, Any]]:
    entries: List[Dict[str, Any]] = []
    if not os.path.exists(path):
        return entries
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                entries.append(json.loads(line))
            except json.JSONDecodeError:
                continue          # a torn append must not wedge the gate
    return entries


def append_history(path: str, values: Dict[str, float],
                   meta: Optional[Dict[str, Any]] = None) -> None:
    entry = {"ts": round(time.time(), 3), "values": values}
    if meta:
        entry["meta"] = meta
    with open(path, "a") as f:
        f.write(json.dumps(entry, separators=(",", ":")) + "\n")


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def baseline(history: List[Dict[str, Any]], key: str, k: int = 5,
             min_n: int = 3) -> Optional[Dict[str, float]]:
    """Rolling median-of-k baseline + MAD for one key over the most
    recent prior entries carrying it. None when history is too thin."""
    xs = [e["values"][key] for e in history
          if _numeric((e.get("values") or {}).get(key)) is not None]
    xs = xs[-k:]
    if len(xs) < min_n:
        return None
    med = _median(xs)
    mad = _median([abs(x - med) for x in xs])
    return {"median": med, "mad": mad, "n": len(xs)}


def check_values(values: Dict[str, float],
                 history: List[Dict[str, Any]],
                 keys: Tuple[str, ...] = DEFAULT_KEYS,
                 k: int = 5, band_pct: float = 0.10
                 ) -> List[Dict[str, Any]]:
    """Per-key verdicts: ok / regression / improved / no-baseline /
    missing / missing_key. 'regression' and 'missing_key' fail the
    gate: a gated key with history that the latest record no longer
    carries means its bench stopped reporting — silently passing that
    is exactly how a perf line dies unnoticed. A key with NO history
    either stays 'missing' (never benched here; common on fresh
    checkouts and narrowed --keys runs)."""
    rows: List[Dict[str, Any]] = []
    for key in keys:
        cur = values.get(key)
        row: Dict[str, Any] = {"key": key, "current": cur,
                               "higher_better": higher_is_better(key)}
        if cur is None:
            base = baseline(history, key, k=k)
            if base is not None:
                row["verdict"] = "missing_key"
                row.update(baseline_median=round(base["median"], 3),
                           n_baseline=base["n"])
            else:
                row["verdict"] = "missing"
            rows.append(row)
            continue
        base = baseline(history, key, k=k)
        if base is None:
            row["verdict"] = "no-baseline"
            rows.append(row)
            continue
        med, mad = base["median"], base["mad"]
        floor_pct = max(band_pct, BAND_FLOOR_PCT.get(key, 0.0))
        band = max(3.0 * 1.4826 * mad, floor_pct * abs(med))
        row.update(baseline_median=round(med, 3), band=round(band, 3),
                   n_baseline=base["n"])
        if higher_is_better(key):
            if cur < med - band:
                row["verdict"] = "regression"
            elif cur > med + band:
                row["verdict"] = "improved"
            else:
                row["verdict"] = "ok"
        else:
            if cur > med + band:
                row["verdict"] = "regression"
            elif cur < med - band:
                row["verdict"] = "improved"
            else:
                row["verdict"] = "ok"
        rows.append(row)
    return rows


def main(argv=None) -> Dict[str, Any]:
    """``{"rc", "text", "rows", "plan_flip"}`` (``rows`` and ``plan_flip``
    are None when nothing was checked or diffed)."""
    from torch_cli import tee_main

    return tee_main(_main, argv)


def _main(argv):
    ap = argparse.ArgumentParser("perf_gate")
    ap.add_argument("--history", default=DEFAULT_HISTORY,
                    help="history path (torch_bench_history.jsonl)")
    ap.add_argument("--record", default=None, metavar="BENCH_EXTRA",
                    help="flatten a bench_extra.json and append to history")
    ap.add_argument("--serve-json", default=None, metavar="SUMMARY",
                    help="also fold a serve_load.py --json summary in")
    ap.add_argument("--record-value", action="append", default=[],
                    metavar="KEY=VAL",
                    help="record an explicit value (repeatable)")
    ap.add_argument("--check", action="store_true",
                    help="compare current values against the rolling "
                         "baseline; exit 1 on any regression")
    ap.add_argument("--keys", default=",".join(DEFAULT_KEYS),
                    help="comma-separated keys --check gates on")
    ap.add_argument("--k", type=int, default=5,
                    help="baseline window (median of last k, min 3)")
    ap.add_argument("--band-pct", type=float, default=0.10,
                    help="relative noise-band floor")
    ap.add_argument("--seed-regression", default=None, metavar="KEY:PCT",
                    help="perturb KEY by PCT in the bad direction before "
                         "checking (gate self-test)")
    ap.add_argument("--plan-diff", default=None, metavar="OLD,NEW",
                    help="two ExplorationReport JSONs: an exploration "
                         "winner FLIP between them fails --check unless "
                         "some gated key measurably improved (a plan "
                         "change must pay for itself on the bench)")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)

    values: Dict[str, float] = {}
    if args.record:
        with open(args.record) as f:
            records = json.load(f)
        if isinstance(records, dict):
            # the bench envelope: {"extra": [lines], "headline": line}.
            headline = records.get("headline")
            records = list(records.get("extra") or []) + \
                ([headline] if isinstance(headline, dict) else [])
        if not isinstance(records, list):
            records = [records]
        values.update(flatten_records(records))
    if args.serve_json:
        with open(args.serve_json) as f:
            values.update(serve_json_values(json.load(f)))
    for kv in args.record_value:
        key, _, val = kv.partition("=")
        values[key.strip()] = float(val)

    history = read_history(args.history)

    if values and not args.seed_regression:
        # A seeded (perturbed) run must never pollute the real history.
        append_history(args.history, values,
                       meta={"source": args.record or args.serve_json
                             or "cli"})

    if not args.check:
        if args.json:
            print(json.dumps({"recorded": values,
                              "history_len": len(history) + bool(values)}))
        else:
            print(f"recorded {len(values)} value(s) -> {args.history} "
                  f"(history: {len(history) + bool(values)} entries)")
        return 0, {"rows": None, "plan_flip": None}

    # --check: current = this invocation's values, else the newest entry.
    prior = history
    if not values:
        if not history:
            print("perf gate: no history and no values to check",
                  file=sys.stderr)
            return 2, {"rows": None, "plan_flip": None}
        values = dict(history[-1].get("values") or {})
        prior = history[:-1]

    if args.seed_regression:
        key, _, pct = args.seed_regression.partition(":")
        pct = float(pct or 20.0)
        if key in values:
            sign = -1.0 if higher_is_better(key) else 1.0
            values[key] *= (1.0 + sign * pct / 100.0)

    keys = tuple(k for k in args.keys.split(",") if k)
    rows = check_values(values, prior, keys=keys, k=args.k,
                        band_pct=args.band_pct)
    bad = [r for r in rows
           if r["verdict"] in ("regression", "missing_key")]

    # --plan-diff: an exploration winner flip is only acceptable when
    # it bought a measurable bench improvement — otherwise the plan
    # change is an unexplained behavior change and the gate trips
    # (tools/torch_plan_diff.py names the driving cost term).
    plan_flip = None
    if args.plan_diff:
        from tepdist_tpu_torch.telemetry import observatory
        from torch_plan_diff import load_report
        old_p, _, new_p = args.plan_diff.partition(",")
        d = observatory.diff_reports(load_report(old_p.strip()),
                                     load_report(new_p.strip()))
        if d.get("flip"):
            improved = [r for r in rows if r["verdict"] == "improved"]
            plan_flip = {
                "old_winner": d.get("old_winner"),
                "new_winner": d.get("new_winner"),
                "driver": d.get("driver"),
                "bench_improved": [r["key"] for r in improved],
                "ok": bool(improved),
            }
            if not improved:
                bad.append({"key": "plan_winner_flip",
                            "verdict": "regression",
                            "current": None, "higher_better": False,
                            "detail": d.get("detail")})

    if args.json:
        out = {"rows": rows, "ok": not bad}
        if plan_flip is not None:
            out["plan_flip"] = plan_flip
        print(json.dumps(out, indent=1))
    else:
        for r in rows:
            cur = "-" if r["current"] is None else f"{r['current']:.3f}"
            base = (f"median {r['baseline_median']} +/- "
                    f"{r.get('band', '?')} (n={r['n_baseline']})"
                    if "baseline_median" in r else "no baseline")
            arrow = "^" if r["higher_better"] else "v"
            print(f"  {r['key']:<28} {cur:>12} vs {base:<34} "
                  f"[{arrow}] {r['verdict']}")
        if plan_flip is not None:
            verdict = ("covered by bench improvement on "
                       + ", ".join(plan_flip["bench_improved"])
                       if plan_flip["ok"] else
                       "NO bench improvement — unexplained plan change")
            print(f"  plan flip {plan_flip['old_winner']} -> "
                  f"{plan_flip['new_winner']} "
                  f"(driver: {plan_flip['driver']}): {verdict}")
        print("perf gate: " + ("FAILED on " +
                               ", ".join(
                                   (f"missing_key:{r['key']}"
                                    if r["verdict"] == "missing_key"
                                    else r["key"]) for r in bad)
                               if bad else "OK"))
    return (1 if bad else 0), {"rows": rows, "plan_flip": plan_flip}


if __name__ == "__main__":
    sys.exit(main()["rc"])
