"""The port's schedule fidelity and calibration
(``tepdist_tpu_torch/telemetry/{fidelity,calibrate}.py``) held to the
JAX package's on the same synthetic spans, and
``tools/torch_fidelity_report.py`` on its two-worker in-process fleet
fixture on the CPU.

Every function of the two modules is pure host code copied from the
reference, so the port's answer must EQUAL the reference's: the join and
its orphans, drift by kind, the critical path, attribution, the fitted
profile (recovering planted constants) and the profile's JSON, byte for
byte. The fixture gate is the reference's: 100% of the predicted tasks
join a measured span, and calibration strictly reduces the step-time
error, on the task graph and on the replayed timeline of a dumped trace.
"""

import json
import os
import sys

import pytest
import torch

from tepdist_tpu.telemetry import calibrate as jcal
from tepdist_tpu.telemetry import fidelity as jfid
from tepdist_tpu_torch.telemetry import calibrate, fidelity
from tepdist_tpu_torch.telemetry import trace as trace_mod

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pred(task, kind, start, dur, devices=((0, 0),), parents=(),
          worker=0, bytes_=None):
    return {"task": task, "name": f"t{task}", "kind": kind,
            "stage": 0, "micro": 0, "worker": worker,
            "devices": list(devices), "bytes": bytes_,
            "parents": list(parents), "start_us": float(start),
            "dur_us": float(dur)}


def _span(task, ts, dur, cat="compute", step=0, worker=0, **extra):
    args = {"task": task, "step": step, "worker": worker}
    args.update(extra)
    return {"name": f"t{task}", "cat": cat, "ts": float(ts),
            "dur": float(dur), "tid": "w", "args": args}


US = 1000.0

# (predicted timeline, measured events) pairs of tests/test_fidelity.py.
TIMELINES = {
    "join_orphans_skips": (
        [_pred(1, "compute", 0, 10), _pred(2, "send", 10, 5, bytes_=128),
         _pred(3, "split", 0, 0, devices=()), _pred(4, "compute", 15, 10)],
        [_span(1, 100, 30), _span(2, 130, 10, cat="send"),
         _span(9, 150, 1)]),
    "steps_and_bytes": (
        [_pred(1, "recv", 0, 4, bytes_=None)],
        [_span(1, 100, 10, cat="recv", step=0, bytes=256),
         _span(1, 500, 30, cat="recv", step=1, bytes=256)]),
    "latest_predecessor": (
        [_pred(1, "compute", 0, 10),
         _pred(2, "compute", 10, 5, parents=[1]),
         _pred(3, "send", 10, 30, parents=[1], devices=[(0, 1)]),
         _pred(4, "compute", 40, 10, parents=[2, 3])],
        [_span(1, 0, 12), _span(2, 12, 5), _span(3, 12, 40, cat="send"),
         _span(4, 52, 9)]),
    "device_serialization": (
        [_pred(1, "compute", 0, 50), _pred(2, "compute", 50, 10)],
        [_span(1, 0, 55), _span(2, 55, 11)]),
    "attribution": (
        [_pred(1, "compute", 0, 40 * US),
         _pred(2, "send", 40 * US, 20 * US, bytes_=1 << 20)],
        [{"name": "run_step", "cat": "step", "ts": 0.0, "dur": 100 * US,
          "tid": "w", "args": {"step": 0, "worker": 0}},
         _span(1, 0, 40 * US), _span(2, 40 * US, 20 * US, cat="send"),
         {"name": "serde:encode", "cat": "serde", "ts": 45 * US,
          "dur": 5 * US, "tid": "w", "args": {"worker": 0, "step": 0}},
         {"name": "serde:encode", "cat": "serde", "ts": 60 * US,
          "dur": 5 * US, "tid": "m", "args": {}},
         {"name": "serde:encode", "cat": "serde", "ts": 900 * US,
          "dur": 5 * US, "tid": "m", "args": {}}]),
}


@pytest.mark.parametrize("name", sorted(TIMELINES))
def test_report_equals_the_reference(name):
    """Join, orphans, drift by kind, critical paths, attribution and the
    whole report: equal, on every step present and on the default."""
    predicted, events = TIMELINES[name]
    assert fidelity.steps_present(events) == jfid.steps_present(events)
    for step in [None] + fidelity.steps_present(events):
        got = fidelity.measured_task_spans(events, step=step)
        assert got == jfid.measured_task_spans(events, step=step)
        j = fidelity.join_timelines(predicted, got)
        r = jfid.join_timelines(predicted, got)
        assert (j.matched, j.orphan_predicted, j.orphan_measured,
                j.skipped) == (r.matched, r.orphan_predicted,
                               r.orphan_measured, r.skipped)
        assert j.join_fraction == r.join_fraction
        assert (fidelity.drift_by_kind(j.matched)
                == jfid.drift_by_kind(r.matched))
        assert (fidelity.attribution(events, step=step)
                == jfid.attribution(events, step=step))
        assert (fidelity.build_report(predicted, events, step=step)
                == jfid.build_report(predicted, events, step=step))
    assert (fidelity.timeline_critical_path(predicted)
            == jfid.timeline_critical_path(predicted))
    trace = {"traceEvents": [dict(e, ph="X", pid=0) for e in events],
             "metadata": {"fidelity": {"predicted": predicted}}}
    assert fidelity.report_from_trace(trace) == jfid.report_from_trace(
        trace)


def test_reference_assertions_hold_on_the_port():
    """The reference test's pinned numbers, on the port's functions."""
    predicted, events = TIMELINES["join_orphans_skips"]
    j = fidelity.join_timelines(predicted,
                                fidelity.measured_task_spans(events))
    assert [r["task"] for r in j.matched] == [1, 2]
    assert (j.orphan_predicted, j.orphan_measured, j.skipped) == (
        [4], [9], [3])
    assert j.join_fraction == pytest.approx(2 / 3)
    assert j.matched[0]["ratio"] == pytest.approx(3.0)
    predicted, _ = TIMELINES["latest_predecessor"]
    assert fidelity.timeline_critical_path(predicted) == [1, 3, 4]
    predicted, _ = TIMELINES["device_serialization"]
    assert fidelity.timeline_critical_path(predicted) == [1, 2]
    _, events = TIMELINES["attribution"]
    att = fidelity.attribution(events, step=0)
    assert att["0"]["transfer_ms"] == pytest.approx(15.0)
    assert att["0"]["idle_ms"] == pytest.approx(40.0)
    assert att["None"]["host_serde_ms"] == pytest.approx(5.0)
    assert att["None"]["window_ms"] <= 100.0


def _cal_rows():
    # Measured = 100 us host floor + 3x predicted device time (compute),
    # 2x (ga/apply) and bytes / 1e8 B/s (transfers), 4e8 B/s ring bytes
    # (all-reduce). Six near-pure-dispatch rows pin the p10 at the floor.
    rows = [dict(_pred(90 + i, "input", 0, 50.0), measured_us=100.0)
            for i in range(6)]
    for i, dev_us in enumerate((1000.0, 2000.0, 4000.0)):
        rows.append(dict(_pred(i, "compute", 0, dev_us + 50.0),
                         measured_us=100.0 + 3.0 * dev_us))
        rows.append(dict(_pred(20 + i, "apply", 0, dev_us + 50.0),
                         measured_us=100.0 + 2.0 * dev_us))
    for i, nbytes in enumerate((1 << 20, 2 << 20)):
        rows.append(dict(_pred(10 + i, "send", 0, 500.0, bytes_=nbytes),
                         measured_us=100.0 + nbytes / 1e8 * 1e6))
        rows.append(dict(_pred(30 + i, "ar", 0, 500.0, bytes_=nbytes,
                               devices=[(0, 0), (0, 1)]),
                         measured_us=100.0 + nbytes / 4e8 * 1e6))
    return rows


def test_fit_profile_recovers_planted_constants_as_the_reference():
    prof = calibrate.fit_profile(_cal_rows(), base_overhead_us=50.0)
    ref = jcal.fit_profile(_cal_rows(), base_overhead_us=50.0)
    assert prof.to_json() == ref.to_json()
    assert prof.task_overhead_us == pytest.approx(100.0, rel=0.01)
    assert prof.compute_scale == pytest.approx(3.0, rel=0.02)
    assert prof.hbm_scale == pytest.approx(2.0, rel=0.02)
    assert prof.transfer_bytes_per_s == pytest.approx(1e8, rel=0.02)
    assert prof.ar_bytes_per_s == pytest.approx(4e8, rel=0.02)
    for rows in ([], [dict(_pred(1, "compute", 0, 0.0), measured_us=10.0)]):
        assert (calibrate.fit_profile(rows).to_json()
                == jcal.fit_profile(rows).to_json())


def test_profile_json_byte_for_byte(tmp_path):
    kw = dict(task_overhead_us=42.0, compute_scale=3.5,
              transfer_bytes_per_s=2.5e8, meta={"n_rows": 7})
    p = calibrate.CalibrationProfile(**kw).save(str(tmp_path / "t.json"))
    q = jcal.CalibrationProfile(**kw).save(str(tmp_path / "j.json"))
    assert open(p, "rb").read() == open(q, "rb").read()
    raw = json.load(open(p))
    raw["unknown_future_field"] = 1
    json.dump(raw, open(p, "w"))
    assert (calibrate.CalibrationProfile.load(p)
            == calibrate.CalibrationProfile(**kw))


def test_profile_sets_the_port_scheduler_floor(tmp_path, monkeypatch):
    from tepdist_tpu_torch.core.service_env import ServiceEnv
    from tepdist_tpu_torch.runtime.task_scheduler import TaskScheduler

    sched = TaskScheduler.__new__(TaskScheduler)
    base = sched._host_floor_s()
    prof = calibrate.CalibrationProfile(task_overhead_us=1e4)
    p = prof.save(str(tmp_path / "c.json"))
    try:
        calibrate.set_active(prof)
        assert sched._host_floor_s() == pytest.approx(1e-2)
        assert sched._host_floor_s() > base
        calibrate.set_active(None)
        monkeypatch.setenv("TEPDIST_CALIB_PROFILE", p)
        ServiceEnv.reset()
        calibrate.invalidate()
        assert calibrate.active_profile() is None
        calibrate.clear_active()
        assert calibrate.active_profile() == prof
    finally:
        calibrate.clear_active()
        monkeypatch.delenv("TEPDIST_CALIB_PROFILE", raising=False)
        ServiceEnv.reset()
        calibrate.invalidate()


@pytest.fixture(scope="module")
def tool():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import torch_fidelity_report
    finally:
        sys.path.pop(0)
    return torch_fidelity_report


def test_replay_of_a_timeline_reproduces_its_makespan(tool):
    predicted, _ = TIMELINES["latest_predecessor"]
    assert tool.replay_timeline(predicted) == pytest.approx(0.05)
    prof = calibrate.CalibrationProfile(task_overhead_us=1.0,
                                        compute_scale=2.0)
    # Compute doubles (1 us floor each); the send keeps its 30 us.
    assert tool.replay_timeline(predicted, prof) == pytest.approx(
        (21 + 31 + 21) / 1e3)


def test_fidelity_report_tool_checks_on_the_cpu(tool, tmp_path, capsys):
    """``--device cpu --check`` on the fixture, then ``--trace`` on the
    trace it dumped: 100% of the predicted tasks joined, no measured
    orphan, and calibration strictly reduces the step error both ways."""
    prev = trace_mod.tracer().enabled
    dump = str(tmp_path / "trace.json")
    prof = str(tmp_path / "prof.json")
    try:
        assert tool.main(["--device", "cpu", "--steps", "2", "--check",
                          "--save-profile", prof, "--dump-trace",
                          dump]) == 0
        assert "fidelity check OK" in capsys.readouterr().out
        assert tool.main(["--trace", dump, "--check", "--json"]) == 0
        out = capsys.readouterr().out
        rep = json.loads(out[:out.rindex("}") + 1])
    finally:
        trace_mod.configure(enabled=prev)
    assert rep["join"]["fraction"] == 1.0
    assert rep["join"]["orphan_measured"] == []
    assert {"compute", "send", "recv"} <= set(rep["per_kind"])
    cal = rep["calibration"]
    assert cal["replayed"]
    assert cal["calibrated_error_ms"] < cal["uncalibrated_error_ms"]
    assert calibrate.CalibrationProfile.load(prof).meta["n_rows"] > 0
