"""Chrome-trace-event exporter + cross-worker merge.

Produces the JSON object format documented for ``chrome://tracing`` /
Perfetto: ``{"traceEvents": [...], "displayTimeUnit": "ms"}`` where each
complete span is a ``ph: "X"`` event with microsecond ``ts``/``dur``.
Mapping: ``pid`` = worker task_index (-1 = the client/master process),
``tid`` = recording thread, ``cat`` = task kind — so Perfetto's process
tracks line up with the fleet and its category filter slices by task type.

Cross-worker clock alignment: each worker's ``GetTelemetry`` response
carries ``now_us`` (its epoch clock when it answered). The caller brackets
the RPC with its own clock (t0, t1) and estimates
``offset_us = now_us - (t0 + t1) / 2`` — the classic NTP midpoint, accurate
to half the round-trip. Subtracting the offset from that worker's span
timestamps puts every process on the client's clock before merging.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Iterable, List, Optional

from tepdist_tpu_torch.telemetry import flight as _flight
from tepdist_tpu_torch.telemetry import ledger as _ledger
from tepdist_tpu_torch.telemetry.metrics import MetricsRegistry

log = logging.getLogger(__name__)

CLIENT_PID = -1


def to_chrome_events(spans: Iterable[Dict[str, Any]], pid: int,
                     offset_us: float = 0.0,
                     label: Optional[str] = None) -> List[Dict[str, Any]]:
    """Convert tracer snapshot records to trace events on a common clock."""
    tids: Dict[str, int] = {}
    events: List[Dict[str, Any]] = []
    if label:
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": label}})
    for sp in spans:
        tname = sp.get("tid", "main")
        tid = tids.get(tname)
        if tid is None:
            tid = len(tids)
            tids[tname] = tid
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": tname}})
        ev = {"name": sp["name"], "cat": sp.get("cat", "misc"), "ph": "X",
              "ts": sp["ts"] - offset_us, "dur": sp.get("dur", 0.0),
              "pid": pid, "tid": tid}
        if sp.get("args"):
            ev["args"] = sp["args"]
        events.append(ev)
    return events


def build_trace(payloads: Iterable[Dict[str, Any]],
                extra_metadata: Optional[Dict[str, Any]] = None
                ) -> Dict[str, Any]:
    """Merge per-process telemetry payloads into one trace object.

    Each payload: ``{"pid": int, "label": str, "spans": [...],
    "offset_us": float, "metrics": snapshot-or-None,
    "spans_dropped": int}``. ``extra_metadata`` entries land under the
    trace's ``metadata`` key (e.g. the simulator's predicted timeline so a
    trace file is a self-contained fidelity-report input).
    """
    events: List[Dict[str, Any]] = []
    snaps: List[Dict[str, Any]] = []
    ledgers: List[Dict[str, Any]] = []
    flights: List[List[Dict[str, Any]]] = []
    dropped: Dict[str, int] = {}
    ledger_dropped: Dict[str, int] = {}
    flight_dropped: Dict[str, int] = {}
    flight_sampled_out: Dict[str, int] = {}
    for p in payloads:
        off = p.get("offset_us", 0.0)
        proc = p.get("label") or str(p["pid"])
        events.extend(to_chrome_events(
            p.get("spans", ()), pid=p["pid"], offset_us=off,
            label=p.get("label")))
        if p.get("metrics"):
            snaps.append(p["metrics"])
        if p.get("ledger"):
            # Shift onto the merge clock so the fleet ledger's step
            # windows and intervals line up with the span timeline.
            ledgers.append(_ledger.shift(p["ledger"], off))
            lost = int(p["ledger"].get("records_dropped", 0))
            if lost:
                ledger_dropped[proc] = lost
        fl = p.get("flight") or {}
        if fl.get("events"):
            flights.append(_flight.shift(fl["events"], off, proc=proc))
        if fl.get("dropped"):
            flight_dropped[proc] = int(fl["dropped"])
        if fl.get("sampled_out"):
            flight_sampled_out[proc] = int(fl["sampled_out"])
        if p.get("spans_dropped"):
            dropped[proc] = int(p["spans_dropped"])
    trace: Dict[str, Any] = {"traceEvents": events, "displayTimeUnit": "ms"}
    meta: Dict[str, Any] = {}
    if snaps:
        meta["metrics"] = MetricsRegistry.merge(snaps)
    if ledgers:
        meta["ledger"] = _ledger.merge(ledgers)
    if flights:
        meta["flight"] = _flight.merge(flights)
    # Per-process ring-loss counters: a trace file must say it is lossy
    # (dropped records read as idle time / missing waterfall hops).
    if dropped:
        meta["spans_dropped"] = dropped
    if ledger_dropped:
        meta["ledger_dropped"] = ledger_dropped
    if flight_dropped:
        meta["flight_dropped"] = flight_dropped
    if flight_sampled_out:
        meta["flight_sampled_out"] = flight_sampled_out
    if extra_metadata:
        meta.update(extra_metadata)
    # Active watchtower alerts ride every merged trace: a post-hoc dump
    # of a run that ended with a live straggler/NaN/SLO-burn alert must
    # say so (tools/trace_summary.py prints the alerts section).
    from tepdist_tpu_torch.telemetry import watchtower as _watchtower
    alerts = _watchtower.active_alerts()
    if alerts:
        meta["alerts"] = alerts
    if meta:
        trace["metadata"] = meta
    return trace


def write_trace(trace: Dict[str, Any], path: Optional[str] = None,
                name: str = "trace") -> Optional[str]:
    """Write a trace object as JSON.

    With an explicit ``path`` the file is written there (parent dirs
    created). Otherwise it lands in ``$TEPDIST_DUMP_DIR`` via the
    core/debug_dump.py policy — same contract as every other dump: a
    failure to write never breaks the caller (returns None).
    """
    text = json.dumps(trace, separators=(",", ":"))
    if path is None:
        from tepdist_tpu_torch.core import debug_dump
        return debug_dump.write_dump(f"{name}.json", text)
    try:
        parent = os.path.dirname(os.path.abspath(path))
        os.makedirs(parent, exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
        return path
    except OSError:
        return None


def worker_payload(client, clear: bool = False) -> Dict[str, Any]:
    """One worker's GetTelemetry pull, shaped for ``build_trace``."""
    h = client.get_telemetry(clear=clear)
    ti = int(h.get("task_index", 0))
    return {"pid": ti, "label": f"worker{ti}",
            "spans": h.get("spans", ()),
            "offset_us": h.get("offset_us", 0.0),
            "metrics": h.get("metrics"),
            "ledger": h.get("ledger"),
            "flight": h.get("flight"),
            "spans_dropped": int(h.get("spans_dropped", 0))}


def local_payload(label: str = "client") -> Dict[str, Any]:
    """This process's own tracer/registry (the master/client timeline)."""
    from tepdist_tpu_torch.telemetry import metrics as _metrics
    from tepdist_tpu_torch.telemetry import trace as _trace
    t = _trace.tracer()
    return {"pid": CLIENT_PID, "label": label,
            "spans": t.snapshot(),
            "offset_us": 0.0,
            "metrics": _metrics().snapshot(),
            "ledger": _ledger.ledger().snapshot(),
            "flight": _flight.recorder().snapshot(),
            "spans_dropped": t.dropped}


def dump_merged_trace(clients, path: Optional[str] = None,
                      name: str = "trace", include_local: bool = True,
                      clear: bool = False,
                      extra_metadata: Optional[Dict[str, Any]] = None
                      ) -> Optional[str]:
    """Pull every worker's telemetry, clock-align, and write one merged
    Perfetto-loadable trace. An unreachable worker is skipped (its track
    is simply absent) — dumping diagnostics never breaks the session."""
    payloads: List[Dict[str, Any]] = []
    if include_local:
        payloads.append(local_payload())
    for c in clients:
        try:
            payloads.append(worker_payload(c, clear=clear))
        except Exception as e:  # noqa: BLE001 — best-effort per worker
            log.warning("GetTelemetry failed for %s: %r",
                        getattr(getattr(c, "stub", None), "address", "?"), e)
    lossy = {p.get("label") or str(p["pid"]): p["spans_dropped"]
             for p in payloads if p.get("spans_dropped")}
    if lossy:
        log.warning(
            "merged trace is LOSSY: span ring overflowed (%s dropped); "
            "missing spans read as idle time — raise "
            "TEPDIST_TRACE_CAPACITY or dump more often",
            ", ".join(f"{k}={v}" for k, v in sorted(lossy.items())))
    ledger_lossy = {p.get("label") or str(p["pid"]):
                    int((p.get("ledger") or {}).get("records_dropped", 0))
                    for p in payloads
                    if (p.get("ledger") or {}).get("records_dropped")}
    if ledger_lossy:
        log.warning(
            "merged trace is LOSSY: ledger ring overflowed (%s records "
            "dropped); gap-table sums undercount — raise "
            "TEPDIST_LEDGER_RING or snapshot more often",
            ", ".join(f"{k}={v}" for k, v in sorted(ledger_lossy.items())))
    flight_lossy = {p.get("label") or str(p["pid"]):
                    int((p.get("flight") or {}).get("dropped", 0))
                    for p in payloads
                    if (p.get("flight") or {}).get("dropped")}
    if flight_lossy:
        log.warning(
            "merged trace is LOSSY: flight ring overflowed (%s events "
            "dropped); request waterfalls have missing hops — raise "
            "TEPDIST_FLIGHT_CAPACITY or lower TEPDIST_FLIGHT_SAMPLE",
            ", ".join(f"{k}={v}" for k, v in sorted(flight_lossy.items())))
    return write_trace(build_trace(payloads, extra_metadata=extra_metadata),
                       path=path, name=name)


# -- Prometheus text format -------------------------------------------------

# ":" is excluded: legal in Prometheus names but reserved for recording
# rules — exporters are expected to sanitize it away.
_PROM_OK = set("abcdefghijklmnopqrstuvwxyz"
               "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_")


def _prom_name(name: str) -> str:
    out = "".join(ch if ch in _PROM_OK else "_" for ch in name)
    if not out or out[0].isdigit():
        out = "_" + out
    return "tepdist_" + out


def to_prometheus(snapshot: Dict[str, Any]) -> str:
    """Render a metrics snapshot (``MetricsRegistry.snapshot()`` or a
    ``merge()`` of many) in the Prometheus text exposition format, so the
    fleet can be scraped without Perfetto: counters as ``counter``,
    gauges as ``gauge``, histograms as summaries (reservoir p50/p95/p99
    quantiles + ``_sum``/``_count``)."""
    lines: List[str] = []
    for name, v in sorted((snapshot.get("counters") or {}).items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {v}")
    for name, v in sorted((snapshot.get("gauges") or {}).items()):
        if v is None:
            continue
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {v}")
    for name, h in sorted((snapshot.get("histograms") or {}).items()):
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} summary")
        for q in ("0.5", "0.95", "0.99"):
            key = {"0.5": "p50", "0.95": "p95", "0.99": "p99"}[q]
            val = h.get(key)
            if val is not None:
                lines.append(f'{pn}{{quantile="{q}"}} {val}')
        lines.append(f"{pn}_sum {h.get('sum', 0.0)}")
        lines.append(f"{pn}_count {h.get('count', 0)}")
    return "\n".join(lines) + ("\n" if lines else "")
