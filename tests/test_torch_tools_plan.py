"""The port's read-only planner and trace tools (``tools/torch_trace_summary.py``,
``torch_plan_diff.py``, ``torch_verify_plan.py``, ``torch_plan_explain.py``,
``torch_run_fx.py``) held to the JAX package's tools on the CPU.

``trace_summary`` and ``plan_diff`` read JSON only, so both packages' tools
read the same files and print the same text, except that the port's
points at its own tools (``tools/torch_<name>.py``), which the comparison
maps back. The files are the port's: a fleet trace of the fidelity
fixture, with an exploration report, the fixture's ledger and a flight
recording merged into its metadata. ``verify_plan``: the same checks, task
and edge counts on the fixture, and the planted SEND rejected by both as
``orphan_send``. ``plan_explain --fixture``: the same proposal count, the
same winner and a complete ledger (a joined scoreboard in both).
``run_fx``: a step decoded from ``rpc/fx_serde.py``'s bytes equals the
captured graph run directly, bit for bit.
"""

import contextlib
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from tepdist_tpu_torch import convert

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name, argv, monkeypatch):
    """(stdout, return value) of the JAX tool ``tools/<name>.py``'s
    ``main``, given ``argv`` (through ``sys.argv`` for the tools whose
    ``main`` takes none)."""
    import importlib

    mod = importlib.import_module(f"tools.{name}")
    buf = io.StringIO()
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    with contextlib.redirect_stdout(buf):
        try:
            rc = mod.main(list(argv))
        except TypeError:
            rc = mod.main()
    return buf.getvalue(), rc


def _port_text(text):
    return text.replace("tools/torch_", "tools/")


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A fleet trace of the port's fidelity fixture with an exploration
    report, the fixture's ledger and a flight recording in its metadata,
    and two exploration reports of the fixture's loss (2 and 4
    devices)."""
    from tepdist_tpu_torch.parallel.exploration import explore
    from tepdist_tpu_torch.telemetry import ledger
    from tools import torch_fidelity_report as tfid
    from tools import torch_request_trace

    d = tmp_path_factory.mktemp("tools_plan")
    trace_path = str(d / "fleet_trace.json")
    ledger.configure(enabled=True)
    try:
        tfid.run_fixture(steps=3, dump_trace=trace_path, device="cpu")
    finally:
        ledger.configure(enabled=False)
    params, x, y = tfid._fixture_inputs(torch.device("cpu"))
    reports = {}
    for n in (2, 4):
        best = explore(tfid._fixture_loss, params, x, y, n_devices=n,
                       num_micro_batches=2, entry_point="plan_explain")
        reports[n] = str(d / f"report_{n}.json")
        with open(reports[n], "w") as f:
            json.dump(best["report"], f, default=str)
    with open(trace_path) as f:
        trace = json.load(f)
    with open(reports[2]) as f:
        trace["metadata"]["exploration"] = json.load(f)
    trace["metadata"]["flight"] = torch_request_trace.run_demo("cpu")
    with open(trace_path, "w") as f:
        json.dump(trace, f)
    return {"trace": trace_path, "reports": reports}


def test_trace_summary_prints_the_reference_text(artifacts, monkeypatch):
    from tools import torch_trace_summary

    for argv in ([artifacts["trace"]], [artifacts["trace"], "--json"]):
        want, _ = _jax_tool("trace_summary", argv, monkeypatch)
        got = torch_trace_summary.main(argv)
        assert got["rc"] == 0
        assert _port_text(got["text"]) == want
    text = got["text"]
    summary = json.loads(text)
    for section in ("fidelity", "ledger", "flight", "exploration"):
        assert summary.get(section), section


@pytest.mark.parametrize("flags", [[], ["--check"], ["--expect-flip"],
                                   ["--json"]])
def test_plan_diff_prints_the_reference_text(artifacts, flags,
                                             monkeypatch):
    from tools import torch_plan_diff

    r = artifacts["reports"]
    for pair in ((r[2], r[2]), (r[2], r[4])):
        argv = list(pair) + flags
        want, want_rc = _jax_tool("plan_diff", argv, monkeypatch)
        got = torch_plan_diff.main(argv)
        assert (_port_text(got["text"]), got["rc"]) == (want, want_rc)


def test_verify_plan_findings_match_the_reference(monkeypatch):
    from tepdist_tpu.analysis.plan_verify import verify_plan as jverify
    from tepdist_tpu_torch.analysis.plan_verify import verify_plan
    from tools import torch_verify_plan
    from tools import verify_plan as jtool

    jprog, jdag, jsched = jtool.build_fixture(2, 2, 8)
    want = jverify(jdag, schedule=jsched, prog=jprog)
    prog, dag, sched = torch_verify_plan.build_fixture(2, 2, 8, "cpu")
    got = verify_plan(dag, schedule=sched, prog=prog)
    assert (got.checks, got.n_tasks, got.n_edges) == (
        want.checks, want.n_tasks, want.n_edges)
    assert sorted(got.peak_bytes) == sorted(want.peak_bytes)

    jt, jrc = _jax_tool("verify_plan", ["--check"], monkeypatch)
    out = torch_verify_plan.main(["--check", "--device", "cpu"])
    assert (out["rc"], jrc) == (0, 0)
    assert out["planted"].kind == "orphan_send"
    assert "planted corruption rejected as expected" in jt
    assert ("[orphan_send]" in jt) and ("[orphan_send]" in out["text"])
    assert out["text"].splitlines()[0].split("] ")[1].split(",")[0] == (
        jt.splitlines()[0].split("] ")[1].split(",")[0])


def test_plan_explain_fixture_matches_the_reference(monkeypatch):
    """The same proposals, winner and complete ledger; the executed
    candidate's scoreboard joins in both."""
    from tools import torch_plan_explain

    jt, jrc = _jax_tool("plan_explain", ["--fixture", "--check", "--json"],
                        monkeypatch)
    out = torch_plan_explain.main(["--fixture", "--check", "--json",
                                   "--device", "cpu"])
    assert (out["rc"], jrc) == (0, 0)
    want = json.loads(jt[jt.index("{"):jt.rindex("}") + 1])
    got = out["report"]
    assert got["counts"]["enumerated"] == want["report"]["counts"][
        "enumerated"]
    assert got["counts"]["candidates_by_kind"] == want["report"]["counts"][
        "candidates_by_kind"]
    assert (got["winner"]["kind"], got["winner"]["config"]) == (
        want["report"]["winner"]["kind"], want["report"]["winner"]["config"])
    assert out["completeness"]["ok"] and want["completeness"]["ok"]
    assert out["completeness"]["unaccounted"] == 0
    assert out["scoreboard"]["ok"] and want["scoreboard"]["ok"]


def test_run_fx_equals_the_graph_run_directly(tmp_path):
    """A step shipped by ``rpc/fx_serde.py`` (the MLP's gradient step, as
    a session ships it) decoded and run by the tool equals the captured
    graph on the same inputs; ``--random`` prints one line an output."""
    from tepdist_tpu_torch.graph.fx_graph import trace_graph
    from tepdist_tpu_torch.rpc import fx_serde
    from tepdist_tpu_torch.train import value_and_grad
    from tools import torch_run_fx

    rng = np.random.default_rng(0)
    params = convert.to_torch(
        {"w0": rng.standard_normal((8, 16)).astype(np.float32),
         "w1": rng.standard_normal((16, 4)).astype(np.float32)},
        device="cpu")
    x = torch.tensor(rng.standard_normal((6, 8)).astype(np.float32))
    y = torch.tensor(rng.standard_normal((6, 4)).astype(np.float32))

    def loss(p, a, b):
        return ((torch.tanh(a @ p["w0"]) @ p["w1"] - b) ** 2).mean()

    graph, _, _ = trace_graph(value_and_grad(loss), params, x, y,
                              functional=True)
    blob = fx_serde.serialize_graph(graph.gm)
    inputs = [params["w0"], params["w1"], x, y]
    want = graph.gm(*inputs)
    got = torch_run_fx.run(blob, inputs, device="cpu")
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)

    path = tmp_path / "step.bin"
    path.write_bytes(blob)
    out = torch_run_fx.main([str(path), "--random", "--device", "cpu"])
    assert out["rc"] == 0
    gen = torch.Generator().manual_seed(0)
    draws = [torch.randn(t.shape, generator=gen) for t in inputs]
    for a, b in zip(out["outputs"], graph.gm(*draws)):
        assert torch.equal(a, b)
    lines = out["text"].splitlines()
    assert len(lines) == len(want)
    assert all("finite=True" in ln for ln in lines)
