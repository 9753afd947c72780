"""``tools/torch_perf_gate.py`` held to ``tools/perf_gate.py`` on the CPU.

Every case of ``tests/test_perf_gate.py`` runs once through each module
(``gate`` is the JAX package's gate or the port's): history recording, the
rolling median-of-k + MAD baseline, direction inference, the
seeded-regression self-test (which trips the gate without writing to the
history), the flatteners and the torn-line reader. Then the two modules
run the same command lines on twin histories and must print the same
verdict rows (band and ``n_baseline`` included), return the same exit
codes and write the same history lines (the timestamp aside); and
``--plan-diff`` on the committed winner-flip fixtures must give the same
``plan_flip`` on both. The port's gate keeps its own history: its default
is never the JAX package's ``bench_history.jsonl``.
"""

import contextlib
import io
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))

import perf_gate  # noqa: E402
import torch_perf_gate  # noqa: E402

FIXTURES = os.path.join(ROOT, "tests", "fixtures")


class _Gate:
    """One package's gate: its module and ``run(argv) -> (rc, stdout)``."""

    def __init__(self, pkg):
        self.pkg = pkg
        self.mod = torch_perf_gate if pkg == "torch" else perf_gate

    def run(self, argv):
        if self.pkg == "torch":
            with contextlib.redirect_stdout(io.StringIO()):
                out = self.mod.main(list(argv))
            return out["rc"], out["text"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = self.mod.main(list(argv))
        return rc, buf.getvalue()

    def main(self, argv):
        return self.run(argv)[0]

    def __getattr__(self, name):
        return getattr(self.mod, name)


@pytest.fixture(params=["jax", "torch"])
def gate(request):
    return _Gate(request.param)


@pytest.fixture()
def history(tmp_path):
    return str(tmp_path / "bench_history.jsonl")


def _seed(gate, history, values_list):
    for vals in values_list:
        gate.append_history(history, vals)


# ---------------------------------------------------------------------------
# The cases of tests/test_perf_gate.py, through each module


def test_flatten_records_promotes_nested_measurements(gate):
    records = [
        {"metric": "two_worker_overhead_x", "value": 1.4,
         "two_worker_fleet_ms": 103.2, "task_graph_ms": 71.9,
         "unit": "x", "note": "text stays out"},
        {"metric": "plan_verify_ms", "value": 3.1, "checks": 12},
        {"metric": "broken", "value": "n/a"},
    ]
    flat = gate.flatten_records(records)
    assert flat["two_worker_overhead_x"] == 1.4
    assert flat["two_worker_fleet_ms"] == 103.2       # promoted
    assert flat["task_graph_ms"] == 71.9
    assert flat["plan_verify_ms"] == 3.1
    assert "checks" not in flat                        # no suffix match
    assert "broken" not in flat                        # non-numeric value
    assert "unit" not in flat and "note" not in flat


def test_serve_json_values_reads_nested_ttft(gate):
    summary = {"tokens_per_s": 812.5,
               "ttft_ms": {"mean": 9.0, "p50": 8.1, "p95": 14.2},
               "requests": 64}
    vals = gate.serve_json_values(summary)
    assert vals == {"serving_tok_s": 812.5,
                    "serving_ttft_ms_p50": 8.1,
                    "serving_ttft_ms_p95": 14.2}
    # A disaggregated summary carries the handoff lines.
    vals = gate.serve_json_values({"disagg_ttft_ms": 41.0,
                                   "kv_handoff_ms": 2.5})
    assert vals == {"disagg_ttft_ms": 41.0, "kv_handoff_ms": 2.5}


def test_direction_inference(gate):
    assert gate.higher_is_better("serving_tok_s")
    assert gate.higher_is_better("paged_capacity_x")
    assert not gate.higher_is_better("two_worker_fleet_ms")
    assert not gate.higher_is_better("plan_verify_ms")


def test_check_passes_on_stable_history(gate, history):
    _seed(gate, history, [{"two_worker_fleet_ms": v}
                          for v in (100.0, 102.0, 98.0, 101.0, 99.0)])
    rc = gate.main(["--history", history, "--check",
                    "--keys", "two_worker_fleet_ms",
                    "--record-value", "two_worker_fleet_ms=103.0"])
    assert rc == 0


def test_check_fails_on_regression_and_improvement_passes(gate, history):
    _seed(gate, history, [{"two_worker_fleet_ms": v}
                          for v in (100.0, 102.0, 98.0, 101.0, 99.0)])
    rc = gate.main(["--history", history, "--check",
                    "--keys", "two_worker_fleet_ms",
                    "--record-value", "two_worker_fleet_ms=150.0"])
    assert rc == 1
    # A big IMPROVEMENT (lower ms) never fails a lower-is-better key.
    rc = gate.main(["--history", history, "--check",
                    "--keys", "two_worker_fleet_ms",
                    "--record-value", "two_worker_fleet_ms=50.0"])
    assert rc == 0


def test_higher_better_direction_flips_the_gate(gate, history):
    _seed(gate, history, [{"serving_tok_s": v}
                          for v in (800.0, 820.0, 790.0, 810.0)])
    assert gate.main(["--history", history, "--check",
                      "--keys", "serving_tok_s",
                      "--record-value", "serving_tok_s=500.0"]) == 1
    assert gate.main(["--history", history, "--check",
                      "--keys", "serving_tok_s",
                      "--record-value", "serving_tok_s=1000.0"]) == 0


def test_thin_history_never_fails(gate, history):
    _seed(gate, history, [{"two_worker_fleet_ms": 100.0}])   # n=1 < min 3
    rc = gate.main(["--history", history, "--check",
                    "--keys", "two_worker_fleet_ms,missing_key_ms",
                    "--record-value", "two_worker_fleet_ms=500.0"])
    assert rc == 0
    rows = gate.check_values(
        {"two_worker_fleet_ms": 500.0},
        gate.read_history(history)[:-1],
        keys=("two_worker_fleet_ms", "missing_key_ms"))
    assert rows[0]["verdict"] == "no-baseline"
    assert rows[1]["verdict"] == "missing"


def test_seeded_regression_trips_gate_without_polluting_history(
        gate, history):
    _seed(gate, history, [{"two_worker_fleet_ms": v}
                          for v in (100.0, 101.0, 99.0)])
    n_before = len(gate.read_history(history))
    rc = gate.main(["--history", history, "--check",
                    "--keys", "two_worker_fleet_ms",
                    "--record-value", "two_worker_fleet_ms=100.0",
                    "--seed-regression", "two_worker_fleet_ms:20"])
    assert rc == 1                                     # 120ms vs 100 +/- 10
    # The perturbed value must NOT have been appended.
    assert len(gate.read_history(history)) == n_before
    # Seeding a higher-is-better key perturbs DOWN.
    _seed(gate, history, [{"serving_tok_s": v}
                          for v in (800.0, 805.0, 795.0)])
    rc = gate.main(["--history", history, "--check",
                    "--keys", "serving_tok_s",
                    "--record-value", "serving_tok_s=800.0",
                    "--seed-regression", "serving_tok_s:20"])
    assert rc == 1


def test_mad_band_tolerates_noisy_metric(gate, history):
    # Noisy history (MAD ~ 10): a +25 excursion sits inside 3*1.4826*MAD
    # even though it exceeds the 10% floor.
    _seed(gate, history, [{"jitter_ms": v}
                          for v in (100.0, 120.0, 90.0, 110.0, 80.0)])
    rc = gate.main(["--history", history, "--check",
                    "--keys", "jitter_ms",
                    "--record-value", "jitter_ms=125.0"])
    assert rc == 0


def test_record_unwraps_bench_extra_envelope(gate, history, tmp_path):
    """A bench writes {"extra": [...], "headline": {...}}, not a bare
    list: --record must flatten both."""
    bench = tmp_path / "bench_extra.json"
    bench.write_text(json.dumps(
        {"extra": [{"metric": "runtime_protocol_ms_per_step",
                    "value": 14.3, "two_worker_fleet_ms": 5.1},
                   {"metric": "serving_tok_s", "value": 1300.0}],
         "headline": {"metric": "tok_s_per_chip_tok_s", "value": 32000.0},
         "headline_error": None}))
    assert gate.main(["--history", history, "--record", str(bench)]) == 0
    vals = gate.read_history(history)[-1]["values"]
    assert vals["two_worker_fleet_ms"] == 5.1
    assert vals["serving_tok_s"] == 1300.0
    assert vals["tok_s_per_chip_tok_s"] == 32000.0


def test_record_appends_and_check_uses_last_entry(gate, history, tmp_path):
    bench = tmp_path / "bench_extra.json"
    bench.write_text(json.dumps(
        [{"metric": "plan_verify_ms", "value": 3.0}]))
    for _ in range(4):
        assert gate.main(["--history", history, "--record",
                          str(bench)]) == 0
    # --check with no new values gates the newest entry vs the rest.
    assert gate.main(["--history", history, "--check",
                      "--keys", "plan_verify_ms"]) == 0
    entries = gate.read_history(history)
    assert len(entries) == 4
    assert all(e["values"]["plan_verify_ms"] == 3.0 for e in entries)


def test_read_history_skips_torn_lines(gate, history):
    _seed(gate, history, [{"a_ms": 1.0}])
    with open(history, "a") as f:
        f.write('{"ts": 1, "values": {"a_ms": 2.0')   # torn append
    entries = gate.read_history(history)
    assert len(entries) == 1


def test_missing_key_fails_and_empty_history_exits_2(gate, history):
    """A gated key with history that the latest record no longer carries
    fails the gate by name; nothing to check exits 2."""
    assert gate.main(["--history", history, "--check"]) == 2
    _seed(gate, history, [{"watch_overhead_pct": v}
                          for v in (0.4, 0.5, 0.45)])
    rc, text = gate.run(["--history", history, "--check",
                         "--keys", "watch_overhead_pct",
                         "--record-value", "other_ms=1.0"])
    assert rc == 1
    assert "missing_key:watch_overhead_pct" in text


# ---------------------------------------------------------------------------
# The two modules side by side


def _lines(path):
    """History lines without their timestamps."""
    with open(path) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "ts"}
                for line in f if line.strip()]


_SESSION = [
    # Three recordings, then checks: pass, seeded regression, improved,
    # a vanished key, a key of each direction, a wide MAD band.
    ["--record-value", "kv_handoff_ms=10.0",
     "--record-value", "quantized_ar_x=3.5"],
    ["--record-value", "kv_handoff_ms=11.0",
     "--record-value", "quantized_ar_x=3.6"],
    ["--record-value", "kv_handoff_ms=9.5",
     "--record-value", "quantized_ar_x=3.4"],
    ["--check", "--keys", "kv_handoff_ms,quantized_ar_x",
     "--record-value", "kv_handoff_ms=10.2",
     "--record-value", "quantized_ar_x=3.5"],
    ["--check", "--keys", "kv_handoff_ms,quantized_ar_x",
     "--record-value", "kv_handoff_ms=10.2",
     "--record-value", "quantized_ar_x=3.5",
     "--seed-regression", "kv_handoff_ms:30"],
    ["--check", "--keys", "quantized_ar_x",
     "--record-value", "quantized_ar_x=3.5",
     "--seed-regression", "quantized_ar_x:20"],
    ["--check", "--keys", "kv_handoff_ms,quantized_ar_x",
     "--record-value", "kv_handoff_ms=5.0",
     "--record-value", "quantized_ar_x=7.0"],
    ["--check", "--keys", "kv_handoff_ms,quantized_ar_x,absent_ms",
     "--record-value", "quantized_ar_x=3.5"],
    ["--check", "--json", "--keys", "kv_handoff_ms,quantized_ar_x",
     "--record-value", "kv_handoff_ms=30.0",
     "--record-value", "quantized_ar_x=1.0"],
    ["--check", "--k", "3", "--band-pct", "0.5",
     "--keys", "kv_handoff_ms"],
    ["--json", "--record-value", "serde_ms=2.0"],
]


def test_same_rows_exit_codes_and_history_lines(tmp_path):
    """The same command lines on twin histories: the same printed rows
    (verdict, baseline median, band, n), the same exit codes and the
    same history lines."""
    hist = {pkg: str(tmp_path / f"{pkg}.jsonl") for pkg in ("jax", "torch")}
    rcs = []
    for argv in _SESSION:
        got = {pkg: _Gate(pkg).run(["--history", hist[pkg]] + argv)
               for pkg in hist}
        (jrc, jtext), (trc, ttext) = got["jax"], got["torch"]
        assert trc == jrc, argv
        assert ttext.replace(hist["torch"], "H") == \
            jtext.replace(hist["jax"], "H"), argv
        rcs.append(trc)
    assert rcs == [0, 0, 0, 0, 1, 1, 0, 1, 1, 1, 0]
    assert _lines(hist["torch"]) == _lines(hist["jax"])
    # The rows the port's main returns are the rows it printed.
    out = torch_perf_gate.main(["--history", hist["torch"], "--check",
                                "--json", "--keys", "kv_handoff_ms"])
    assert json.loads(out["text"])["rows"] == out["rows"]


@pytest.mark.parametrize("kind,driver", [("coll", "coll_s"),
                                         ("zero", "memory_feasible")])
def test_plan_diff_flip_matches_the_reference(tmp_path, kind, driver):
    """``--plan-diff`` on the committed winner-flip fixtures: the same
    ``plan_flip`` from both modules, failing the gate with no bench
    improvement and passing when the gated key improved."""
    before = os.path.join(FIXTURES, f"{kind}_flip_before.json")
    after = os.path.join(FIXTURES, f"{kind}_flip_after.json")
    key = "quantized_ar_x" if kind == "coll" else "zero_opt_mem_x"
    flips = {}
    for pkg in ("jax", "torch"):
        g = _Gate(pkg)
        flat = str(tmp_path / f"{pkg}_flat.jsonl")
        imp = str(tmp_path / f"{pkg}_imp.jsonl")
        for _ in range(3):
            g.run(["--history", flat, "--record-value", f"{key}=3.0"])
            g.run(["--history", imp, "--record-value", f"{key}=1.5"])
        rc, text = g.run(["--history", flat, "--check", "--json",
                          "--keys", key, "--record-value", f"{key}=3.0",
                          "--plan-diff", f"{before},{after}"])
        assert rc == 1, pkg
        doc = json.loads(text)
        flips[pkg] = doc["plan_flip"]
        assert doc["ok"] is False
        rc, text = g.run(["--history", imp, "--check", "--keys", key,
                          "--record-value", f"{key}=3.0",
                          "--plan-diff", f"{before},{after}"])
        assert rc == 0, pkg
        assert f"covered by bench improvement on {key}" in text
        # Identical reports carry no flip.
        rc, _ = g.run(["--history", flat, "--check", "--keys", key,
                       "--record-value", f"{key}=3.0",
                       "--plan-diff", f"{before},{before}"])
        assert rc == 0, pkg
    assert flips["torch"] == flips["jax"]
    assert flips["torch"]["driver"] == driver
    assert flips["torch"]["ok"] is False
    assert flips["torch"]["bench_improved"] == []


def test_default_history_is_the_ports_own():
    path = torch_perf_gate.DEFAULT_HISTORY
    assert os.path.basename(path) == "torch_bench_history.jsonl"
    assert os.path.dirname(path) == ROOT
    assert os.path.basename(path) != os.path.basename(
        perf_gate.DEFAULT_HISTORY)
    assert torch_perf_gate.DEFAULT_KEYS == perf_gate.DEFAULT_KEYS
    assert torch_perf_gate.BAND_FLOOR_PCT == perf_gate.BAND_FLOOR_PCT
