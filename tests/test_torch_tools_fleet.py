"""The port's read-only fleet tools (``tools/torch_ledger_report.py``,
``torch_watch.py``, ``torch_request_trace.py``, ``torch_metrics_dump.py``,
``torch_obs_overhead.py``) held to the JAX package's tools on the CPU.

Each pair runs its own package's fixture (the two-worker in-process MLP
fleet, a supervised GPT-2 ``test`` engine) on the CPU, so what is compared
is what does not depend on the host's clock: ``ledger_report`` the fields
of its report and of each step row, and both gates passing;
``watch --demo`` the alert kinds for an ``rpc_delay`` straggler with a
seeded loss spike, and none on the unfaulted baseline; ``request_trace
--demo`` each request's event names and engine generations, with exactly
one ``finish`` and one ``deliver``; ``metrics_dump`` the metric names a
servicer's registry holds after the same verbs; ``obs_overhead
--skip-flight --skip-watch --skip-wal`` the records' keys and methodology
stamps (values are host timings and not compared; the reference's
``vs_baseline_raw`` and ``verdict_note`` appear only on a flagged run, so
the comparison leaves them out, and the reference reads a copy of its
baseline file).
"""

import contextlib
import io
import json
import os
import shutil

import pytest
import torch

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name, argv):
    """(stdout, return value) of the JAX tool ``tools/<name>.py``'s
    ``main(argv)``."""
    import importlib

    mod = importlib.import_module(f"tools.{name}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mod.main(list(argv))
    return buf.getvalue(), rc


def _json(text):
    return json.loads(text[text.index("{"):text.rindex("}") + 1])


def test_ledger_report_fields_match_the_reference():
    from tools import torch_ledger_report

    jt, jrc = _jax_tool("ledger_report", ["--steps", "3", "--json",
                                          "--check"])
    out = torch_ledger_report.main(["--steps", "3", "--json", "--check",
                                    "--device", "cpu"])
    assert (out["rc"], jrc) == (0, 0)
    want, got = _json(jt), _json(out["text"])
    assert sorted(got) == sorted(want)
    assert sorted(got["gap_table"]) == sorted(want["gap_table"])
    assert [sorted(r) for r in got["gap_table"]["steps"]] == [
        sorted(r) for r in want["gap_table"]["steps"]]
    assert [sorted(r["buckets"]) for r in got["gap_table"]["steps"]] == [
        sorted(r["buckets"]) for r in want["gap_table"]["steps"]]
    assert sorted(got["reconcile"]) == sorted(want["reconcile"])
    assert sorted(got["fidelity_attribution"]) == sorted(
        want["fidelity_attribution"])


@pytest.mark.parametrize("faulted", [False, True],
                         ids=["baseline", "straggler_spike"])
def test_watch_demo_alerts_match_the_reference(faulted):
    from tepdist_tpu.runtime import faults as jfaults
    from tepdist_tpu_torch.runtime import faults
    from tools import torch_watch

    argv = ["--demo", "--steps", "7", "--once", "--check", "--json"]
    if faulted:
        argv += ["--fault", "rpc_delay:ms=80,ti=1", "--seed-spike", "6",
                 "--expect", "straggler,loss_spike"]
    try:
        jt, jrc = _jax_tool("watch", argv)
        out = torch_watch.main(argv + ["--device", "cpu"])
    finally:
        jfaults.reset()
        faults.reset()
    # Each side's exit code with its alerts' details, so a failure names
    # the demo that raised it and why.
    want_alerts = _json(jt)["alerts"]
    got_alerts = out["status"]["alerts"]
    assert jrc == 0, ("jax", jrc, want_alerts)
    assert out["rc"] == 0, ("torch", out["rc"], got_alerts,
                            out["status"]["workers"])
    want = {a["kind"] for a in want_alerts}
    got = {a["kind"] for a in got_alerts}
    assert got == want
    assert got == ({"straggler", "loss_spike"} if faulted else set())


def test_watch_demo_reads_only_its_own_records():
    """The port's demo attaches its watchtower after a warm-up step with
    its cursors at the rings' end: a second demo in the same process
    takes in no more records than the first (the rings are process-wide
    and still hold the first demo's), and the last heartbeats of earlier
    fleets in the process (the registry's ``heartbeat_rtt_ms:<ti>``
    gauges: a slow worker 1, a worker 3 this fleet lacks) raise no
    straggler. Both stale gauges failed the unfaulted demo of the JAX
    package (worker 3) and the port's (worker 1) in a whole ``-n 6``
    run."""
    from tepdist_tpu_torch.runtime import faults
    from tepdist_tpu_torch.telemetry import metrics, watchtower
    from tools import torch_watch

    argv = ["--demo", "--steps", "4", "--once", "--check", "--json",
            "--device", "cpu"]
    records = []
    watchtower.board().clear()    # the faulted demo's alerts stay active
    for ti, rtt_ms in ((1, 80.0), (3, 8.4)):
        metrics().gauge(f"heartbeat_rtt_ms:{ti}").set(rtt_ms)
        metrics().histogram(f"heartbeat_rtt_ms:{ti}").observe(rtt_ms)
    try:
        for _ in range(2):
            out = torch_watch.main(argv)
            assert out["rc"] == 0, out["status"]["alerts"]
            records.append({w: st["records"] for w, st in
                            out["status"]["workers"].items()})
    finally:
        faults.reset()
        watchtower.board().clear()
    first, second = records
    assert sorted(first) == sorted(second) == [0, 1]
    for w in first:
        assert 0 < second[w] <= first[w] * 1.25, records


def test_request_trace_demo_matches_the_reference():
    from tepdist_tpu_torch.telemetry import flight
    from tools import torch_request_trace

    jt, jrc = _jax_tool("request_trace", ["--demo", "--json"])
    out = torch_request_trace.main(["--demo", "--json", "--device", "cpu"])
    assert (out["rc"], jrc) == (0, 0)
    want = _json(jt)
    got = json.loads(json.dumps(flight.by_request(out["events"])))
    assert sorted(got) == sorted(want)
    assert {"r0", "r1", "r2"} <= set(got)

    def story(evs):
        return [(e["ev"], (e.get("args") or {}).get("gen")) for e in evs]

    for rid in want:
        assert story(got[rid]) == story(want[rid]), rid
    for rid in ("r0", "r1", "r2"):
        names = [e["ev"] for e in got[rid]]
        assert names.count("finish") == names.count("deliver") == 1


def _drive(client):
    client.wait_ready(10)
    for _ in range(3):
        client.ping()


def test_metrics_dump_names_match_the_reference():
    """Both servicers answer the same verbs on registries cleared first;
    the tools' Prometheus text names the same metrics."""
    from tepdist_tpu.rpc import inproc as jinproc
    from tepdist_tpu.rpc.client import TepdistClient as JClient
    from tepdist_tpu.rpc.server import TepdistServicer as JServicer
    from tepdist_tpu.telemetry.metrics import metrics as jmetrics
    from tepdist_tpu_torch.rpc import inproc
    from tepdist_tpu_torch.rpc.client import TepdistClient
    from tepdist_tpu_torch.rpc.server import TepdistServicer
    from tepdist_tpu_torch.telemetry.metrics import metrics
    from tools import torch_metrics_dump

    import jax

    jmetrics().reset()
    metrics().reset()
    jinproc.register_servicer("inproc:7461", JServicer(jax.devices()[:1]))
    inproc.register_servicer("inproc:7461", TepdistServicer(["cpu"]))
    try:
        _drive(JClient("inproc:7461"))
        _drive(TepdistClient("inproc:7461"))
        jt, jrc = _jax_tool("metrics_dump", ["inproc:7461", "--prometheus"])
        out = torch_metrics_dump.main(["inproc:7461", "--prometheus"])
    finally:
        jinproc.unregister_servicer("inproc:7461")
        inproc.unregister_servicer("inproc:7461")

    def names(text):
        return sorted({ln.split()[2] for ln in text.splitlines()
                       if ln.startswith("# TYPE")})

    assert (out["rc"], jrc) == (0, 0)
    assert names(out["text"]) and names(out["text"]) == names(jt)


def test_obs_overhead_keys_and_stamps_match_the_reference(tmp_path,
                                                          monkeypatch):
    import bench

    from tools import torch_obs_overhead

    base = tmp_path / "bench_baseline.json"
    shutil.copy(os.path.join(ROOT, "bench_baseline.json"), base)
    monkeypatch.setattr(bench, "BASELINE_FILE", str(base))
    argv = ["--skip-flight", "--skip-watch", "--skip-wal", "--json"]
    jt, jrc = _jax_tool("obs_overhead", argv)
    out = torch_obs_overhead.main(argv + ["--device", "cpu"])
    assert (out["rc"], jrc) == (0, 0)
    want = [json.loads(ln) for ln in jt.splitlines() if ln.startswith("{")]
    got = [json.loads(ln) for ln in out["text"].splitlines()
           if ln.startswith("{")]
    assert got == json.loads(json.dumps(out["records"]))
    flagged = {"vs_baseline_raw", "verdict_note"}
    assert [r["metric"] for r in got] == [r["metric"] for r in want] == [
        "trace_overhead", "ledger_overhead_pct", "metrics_hot_ns"]
    for g, w in zip(got, want):
        assert sorted(set(g) - flagged) == sorted(set(w) - flagged)
        stamp = lambda r: (r.get("methodology") or "").split(" (")[0]  # noqa
        assert stamp(g) in ("", "ab_paired_windows", "per_op_accounting")
        assert stamp(w) in ("", "ab_paired_windows", "per_op_accounting")
        assert bool(stamp(g)) == bool(stamp(w))
