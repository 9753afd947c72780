"""The port's telemetry core (tepdist_tpu_torch.telemetry) held against the
JAX package's (tepdist_tpu.telemetry) on the same inputs.

The port's telemetry is a copy of framework-neutral code, so the contract
is equality of what each instrument exports: every comparison is of JSON
text (``json.dumps(..., sort_keys=True)``), byte for byte. Wall-clock
fields are the only thing normalised (span and flight timestamps, ledger
windows and interval starts, alert times); where a module takes a clock
(the SLO engine) both get the same fake one. The ledger's ``gap_table``
and ``reconcile`` reproduce ``tests/fixtures/ledger_parity.json`` byte for
byte, as ``tests/test_obs_parity.py`` requires of the JAX package. Both
ring paths are driven: the native rings (each package's own C extension:
the port's builds from its own ``_fastobs.c`` into
``tepdist_tpu_torch/_build/`` as ``_tepdist_torch_fastobs``) and the
pure-Python rings that ``TEPDIST_NO_FASTOBS=1`` selects.
"""

from __future__ import annotations

import importlib
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tepdist_tpu.telemetry import export as jexport
from tepdist_tpu.telemetry import fidelity as jfidelity
from tepdist_tpu.telemetry import calibrate as jcalibrate
from tepdist_tpu.telemetry import flight as jflight
from tepdist_tpu.telemetry import ledger as jledger
from tepdist_tpu.telemetry import observatory as jobservatory
from tepdist_tpu.telemetry import trace as jtrace
from tepdist_tpu.telemetry import watchtower as jwatch
from tepdist_tpu_torch.telemetry import _fastobs as tfastobs
from tepdist_tpu_torch.telemetry import export as texport
from tepdist_tpu_torch.telemetry import fidelity as tfidelity
from tepdist_tpu_torch.telemetry import calibrate as tcalibrate
from tepdist_tpu_torch.telemetry import flight as tflight
from tepdist_tpu_torch.telemetry import ledger as tledger
from tepdist_tpu_torch.telemetry import observatory as tobservatory
from tepdist_tpu_torch.telemetry import trace as ttrace
from tepdist_tpu_torch.telemetry import watchtower as twatch

torch.set_num_threads(2)

# The packages export a ``metrics()`` function under the module's name.
jmetrics = importlib.import_module("tepdist_tpu.telemetry.metrics")
tmetrics = importlib.import_module("tepdist_tpu_torch.telemetry.metrics")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "ledger_parity.json")


def _text(obj) -> str:
    return json.dumps(obj, sort_keys=True)


@pytest.fixture(params=["native", "python"])
def rings(request, monkeypatch):
    """Both packages on one ring path. ``python`` nulls each module's
    ``_fastobs`` hook, the path ``TEPDIST_NO_FASTOBS=1`` takes."""
    if request.param == "native":
        if jledger._fastobs.load() is None or tfastobs.load() is None:
            pytest.skip("no C compiler for the native rings")
    else:
        for mod in (jledger, jtrace, tledger, ttrace):
            monkeypatch.setattr(mod, "_fastobs", None)
    return request.param


# -- metrics ------------------------------------------------------------------

def _drive_metrics(mod):
    rng = np.random.default_rng(3)
    reg = mod.MetricsRegistry()
    for i in range(40):
        reg.counter(f"c{i % 3}").inc(int(rng.integers(1, 9)))
    reg.gauge("depth").set(7.5)
    reg.gauge("pages_used").set(304)
    for v in rng.exponential(20.0, 700):     # past the 256 reservoir
        reg.histogram("serve_ttft_ms").observe(float(v))
    for v in rng.normal(30.0, 4.0, 50):
        reg.histogram("serve_token_ms:interactive").observe(float(v))
    other = mod.MetricsRegistry()
    other.counter("c1").inc(5)
    other.histogram("serve_ttft_ms").observe(1.25)
    snap = reg.snapshot()
    merged = mod.MetricsRegistry.merge([snap, other.snapshot()])
    return snap, merged


def test_metrics_snapshot_merge_and_prometheus_match():
    jsnap, jmerged = _drive_metrics(jmetrics)
    tsnap, tmerged = _drive_metrics(tmetrics)
    assert _text(tsnap) == _text(jsnap)
    assert _text(tmerged) == _text(jmerged)
    assert texport.to_prometheus(tmerged) == jexport.to_prometheus(jmerged)


@pytest.mark.parametrize("n", [0, 1, 2, 7, 256])
def test_quantile_matches(n):
    vals = sorted(np.random.default_rng(n).normal(size=n).tolist())
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert tmetrics._quantile(vals, q) == jmetrics._quantile(vals, q)


# -- spans --------------------------------------------------------------------

def _record_spans(trace_mod):
    tr = trace_mod.Tracer(capacity=64, enabled=True)
    assert (tr._core is not None) == (trace_mod._fastobs is not None)
    for i in range(100):                      # past capacity: drops
        attrs = {"rid": f"r{i % 5}", "batch": i % 7}
        if tr._core is not None:
            sp = tr._core.span("serve:decode", "serve", attrs)
        else:
            sp = trace_mod.Span(tr, "serve:decode", "serve", attrs)
        with sp as s:
            s.set(chunk=i)
    return tr


def _normalised_spans(tr):
    spans = tr.snapshot()
    for i, s in enumerate(spans):
        s["ts"], s["dur"], s["tid"] = i, 1.0, "t"
    return spans, tr.dropped


def test_trace_ring_records_match(rings):
    jspans, jdrop = _normalised_spans(_record_spans(jtrace))
    tspans, tdrop = _normalised_spans(_record_spans(ttrace))
    assert tdrop == jdrop == 36
    assert _text(tspans) == _text(jspans)


def _synthetic_spans():
    return [{"name": f"t{i}", "cat": ("compute", "send", "serde")[i % 3],
             "ts": 1000.0 * i, "dur": 250.0 + i, "tid": f"w{i % 2}",
             "args": {"task": i, "step": i // 4, "worker": i % 2}}
            for i in range(12)]


def test_chrome_export_and_merged_trace_match(monkeypatch):
    monkeypatch.setattr(jwatch, "active_alerts", lambda: [])
    monkeypatch.setattr(twatch, "active_alerts", lambda: [])
    spans = _synthetic_spans()
    flight = {"events": [{"rid": "r0", "ev": "queue", "ts": 10},
                         {"rid": "r0", "ev": "finish", "ts": 900,
                          "args": {"n_tokens": 4}}], "dropped": 1}

    def payloads(mod):
        snap, _ = _drive_metrics(mod)
        return [{"pid": 0, "label": "worker0", "spans": spans,
                 "offset_us": 12.5, "metrics": snap, "flight": flight,
                 "spans_dropped": 3},
                {"pid": -1, "label": "client", "spans": spans[:3],
                 "offset_us": 0.0, "metrics": None}]

    for pid, off in ((0, 0.0), (3, -40.0)):
        assert (_text(texport.to_chrome_events(spans, pid, off, "w"))
                == _text(jexport.to_chrome_events(spans, pid, off, "w")))
    meta = {"predicted": [{"task": 1}]}
    assert (_text(texport.build_trace(payloads(tmetrics), meta))
            == _text(jexport.build_trace(payloads(jmetrics), meta)))


# -- flight records -----------------------------------------------------------

def _record_flight(mod):
    rec = mod.FlightRecorder(enabled=True, capacity=16)
    for i in range(40):                       # past capacity: drops
        rec.record(f"r{i % 4}", ("queue", "admit", "decode")[i % 3],
                   gen=i // 20, pos=i)
    rec.record("*", "restart", gen=1, reason="x")
    snap = rec.snapshot()
    for i, e in enumerate(snap["events"]):
        e["ts"] = 100 * i
    shifted = mod.shift(snap["events"], 25.0, proc="w1")
    merged = mod.merge([snap["events"], shifted])
    return snap, mod.by_request(merged), rec.dropped


def test_flight_records_match():
    jsnap, jby, jdrop = _record_flight(jflight)
    tsnap, tby, tdrop = _record_flight(tflight)
    assert tdrop == jdrop
    assert _text(tsnap) == _text(jsnap)
    assert _text(tby) == _text(jby)


# -- watchtower ---------------------------------------------------------------

def _series():
    """One synthetic run: a healthy decaying loss with noise, a spike, a
    ratchet and a NaN; per-worker step times with a straggler; and SLO
    samples that breach, then recover."""
    rng = np.random.default_rng(5)
    loss = [2.0 * math.exp(-i / 30.0) + float(rng.uniform(0, 0.05))
            for i in range(40)]
    loss[25] = 40.0
    loss[30:34] = [12.0, 14.0, 16.0, 18.0]
    loss[37] = float("nan")
    step_ms = {w: [50.0 + float(rng.normal(0, 1)) for _ in range(12)]
               for w in range(3)}
    step_ms[2] = [v + 60.0 for v in step_ms[2]]
    slo = [200.0] * 30 + [5.0] * 40
    return loss, step_ms, slo


def _alerts(wt):
    loss, step_ms, slo = _series()
    board = wt.AlertBoard()
    out = []
    sentinel = wt.TrainingSentinel(min_n=5, board_=board)
    for i, v in enumerate(loss):
        a = sentinel.observe(i, v)
        out.append(a.to_dict() if a is not None else None)
    scorer = wt.StragglerScorer(board_=board, persist_polls=2)
    for k in range(12):
        for w, vals in step_ms.items():
            scorer.add(w, "step_ms", vals[k])
        out.append([a.to_dict() for a in scorer.evaluate()])
    target = wt.SloTarget(name="step", metric="step_time_ms", target=50.0,
                          budget=0.10, windows_s=(5.0, 20.0),
                          burn_threshold=2.0, min_samples=2)
    clock = [0.0]
    engine = wt.SLOEngine([target], board_=board, clock=lambda: clock[0])
    for v in slo:
        clock[0] += 1.0
        engine.feed("step_time_ms", [v])
        engine.observe({})
        out.append([a.to_dict() for a in engine.evaluate()])
    out.append([a.to_dict() for a in board.active()])
    out.append(wt.parse_slo_toml(open(os.path.join(ROOT, "slo.toml")).read()))
    for d in _walk_dicts(out):
        if "first_us" in d:
            d["first_us"] = d["last_us"] = 0
    return out


def _walk_dicts(x):
    if isinstance(x, dict):
        yield x
        for v in x.values():
            yield from _walk_dicts(v)
    elif isinstance(x, list):
        for v in x:
            yield from _walk_dicts(v)


def test_watchtower_alerts_on_one_series_match():
    jout, tout = _alerts(jwatch), _alerts(twatch)
    assert any(a is not None for a in jout[:40])     # the series alerts
    assert _text(tout) == _text(jout)


# -- ledger -------------------------------------------------------------------

@pytest.fixture(scope="module")
def fx():
    with open(FIXTURE) as f:
        return json.load(f)


def test_gap_table_and_reconcile_reproduce_fixture(fx):
    table = tledger.gap_table(fx["snapshot"],
                              single_step_ms=fx["single_step_ms"])
    assert _text(table) == _text(fx["gap_table"])
    rec = tledger.reconcile(table, fx["fidelity_attribution"],
                            measured_step_ms=None)
    assert _text(rec) == _text(fx["reconcile"])
    assert _text(tledger.gap_table(tledger.shift(fx["snapshot"], 12345.0),
                                   single_step_ms=fx["single_step_ms"])) \
        == _text(table)
    assert (_text(tledger.merge([fx["snapshot"], fx["snapshot"]]))
            == _text(jledger.merge([fx["snapshot"], fx["snapshot"]])))


def _record_ledger(mod):
    led = mod.RpcLedger(enabled=True, ring_records=32)
    assert (led._core is not None) == (mod._fastobs is not None)
    t = 1_000_000
    for step in range(3):
        with mod._StepScope(led, step):
            for k in range(8):               # past the ring: drops
                with mod._VerbScope(led, f"Verb{k % 3}", "client", None):
                    led.record_pack(40 + k, 1000 * k, t, t + 5000)
                    led.record_unpack(24, 10 * k, t + 6000, t + 9000)
                    led.record_encode(t, t + 2000, k % 2)
                    led.record_decode(t + 6000, t + 7000)
                t += 20_000
        led.record_retry("Verb1", 0.125 * (step + 1))
    snap = led.snapshot()
    # Scope windows and handler/call intervals read the wall clock: keep
    # their counts, not their times.
    snap["windows"] = sorted(snap["windows"])
    snap["intervals"] = {c: len(v) for c, v in snap["intervals"].items()}
    for rows in [snap["verbs"], *snap["steps"].values()]:
        for row in rows.values():
            row["client_us"] = row["server_us"] = 0
    return snap


def test_ledger_ring_records_match(rings):
    jsnap, tsnap = _record_ledger(jledger), _record_ledger(tledger)
    assert jsnap["records_dropped"] > 0
    assert _text(tsnap) == _text(jsnap)


# -- fidelity and calibration -------------------------------------------------

def _predicted():
    out = []
    for i in range(12):
        kind = ("compute", "send", "allreduce")[i % 3]
        out.append({"task": i, "name": f"t{i}", "kind": kind, "stage": 0,
                    "micro": 0, "worker": i % 2,
                    "devices": [(i % 2, 0)] if kind == "compute"
                    else [(0, 0), (1, 0)],
                    "bytes": None if kind == "compute" else 4096 * (i + 1),
                    "parents": [i - 1] if i else [],
                    "start_us": 900.0 * i, "dur_us": 200.0 + 10 * i})
    out.append({"task": 99, "name": "split", "kind": "split", "stage": 0,
                "micro": 0, "worker": 0, "devices": [], "bytes": None,
                "parents": [], "start_us": 0.0, "dur_us": 0.0})
    return out


def _fidelity(fid, cal):
    events = [{"name": "run_step", "cat": "step", "ts": 0.0,
               "dur": 12_000.0, "tid": "w",
               "args": {"step": s, "worker": w}}
              for s in range(3) for w in range(2)] + _synthetic_spans()
    report = fid.build_report(_predicted(), events, step=None)
    join = fid.join_timelines(_predicted(), fid.measured_task_spans(events))
    profile = cal.fit_profile(join.matched, base_overhead_us=5.0)
    return report, fid.attribution(events, step=1), profile.to_json()


def test_fidelity_report_and_calibration_match():
    jrep, jatt, jprof = _fidelity(jfidelity, jcalibrate)
    trep, tatt, tprof = _fidelity(tfidelity, tcalibrate)
    assert _text(trep) == _text(jrep)
    assert _text(tatt) == _text(jatt)
    assert tprof == jprof


@pytest.mark.parametrize("cand", [
    {"kind": "spmd", "topology": [2, 4], "comm_dtype": "bfloat16"},
    {"kind": "spmd", "topology": [8], "zero": True},
    {"kind": "pipeline", "num_stages": 4, "num_micro_batches": 16,
     "intra_tp": 2, "comm_dtype": "int8", "placement": "interleaved",
     "interleave_groups": 2},
    {"kind": "pipeline", "num_stages": 2, "num_micro_batches": 8,
     "comm_dtype": "float32"},
])
def test_observatory_candidate_config_matches(cand):
    assert (tobservatory.candidate_config(cand)
            == jobservatory.candidate_config(cand))


# -- the native extension and the operator switch -----------------------------

def test_native_rings_are_the_ports_own_extension():
    tmod, jmod = tfastobs.load(), jledger._fastobs.load()
    if tmod is None or jmod is None:
        pytest.skip("no C compiler for the native rings")
    assert tmod.__name__ == "_tepdist_torch_fastobs"
    assert jmod.__name__ == "_tepdist_fastobs"
    assert tmod is not jmod
    assert os.path.dirname(tmod.__file__) == os.path.join(
        ROOT, "tepdist_tpu_torch", "_build")
    assert type(ttrace.Tracer(capacity=8, enabled=True)._core).__module__ \
        == "_tepdist_torch_fastobs"


_RING_PROBE = """
import json
from tepdist_tpu_torch.telemetry import _fastobs, trace
tr = trace.Tracer(capacity=16, enabled=True)
for i in range(20):
    sp = (tr._core.span("x", "c", {"i": i}) if tr._core is not None
          else trace.Span(tr, "x", "c", {"i": i}))
    with sp:
        pass
spans = tr.snapshot()
print(json.dumps({"native": _fastobs.available(),
                  "records": [[s["name"], s["cat"], s["args"]]
                              for s in spans],
                  "dropped": tr.dropped}))
"""


def test_no_fastobs_switch_gives_the_same_records():
    """``TEPDIST_NO_FASTOBS=1`` turns the port's native rings off in a
    fresh interpreter, and the Python rings record the same spans."""
    out = {}
    for flag in ("", "1"):
        env = {k: v for k, v in os.environ.items()
               if k not in ("PYTHONPATH", "TEPDIST_NO_FASTOBS")}
        if flag:
            env["TEPDIST_NO_FASTOBS"] = flag
        proc = subprocess.run([sys.executable, "-c", _RING_PROBE], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr
        out[flag] = json.loads(proc.stdout)
    assert out["1"]["native"] is False
    assert out[""]["records"] == out["1"]["records"]
    assert out[""]["dropped"] == out["1"]["dropped"] == 4
