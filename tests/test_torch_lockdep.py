"""The port's lockdep (``tepdist_tpu_torch/analysis/lockdep.py``, its
allowlist and ``tools/torch_lockdep.py``) held to the JAX package's
``analysis/lockdep.py`` and ``tests/test_lockdep.py``: the same findings
and static edges on the same synthetic sources, the same allowlist
parser, the port's package lockdep-clean with no inversion, and the
supervisor -> engine order confirmed on a live port supervisor under
``TEPDIST_LOCKDEP=1``."""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from tepdist_tpu_torch.analysis import lockdep, lockdep_runtime
from tepdist_tpu_torch.analysis.lockdep import (analyze, is_allowed,
                                                load_allowlist)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALLOWLIST = os.path.join(ROOT, "tepdist_tpu_torch", "analysis",
                         "lockdep_allow.toml")

# The synthetic source of tests/test_lockdep.py, copied.
SYNTH = textwrap.dedent('''
    import queue
    import threading
    import time


    class Worker:
        def __init__(self):
            self.a = threading.Lock()
            self.b = threading.Lock()
            self.q = queue.Queue()
            self.cv = threading.Condition()

        def ab(self):
            with self.a:
                with self.b:
                    pass

        def ba(self):
            with self.b:
                with self.a:
                    pass

        def leak(self):
            self.a.acquire()
            return 1

        def guarded(self):
            self.b.acquire()
            try:
                return 2
            finally:
                self.b.release()

        def sleepy(self):
            with self.a:
                time.sleep(1.0)

        def parked(self):
            with self.cv:
                self.cv.wait()

        def bounded(self):
            with self.cv:
                self.cv.wait(0.5)

        def pulls(self):
            with self.a:
                self.q.get()

        def pulls_bounded(self):
            with self.a:
                self.q.get(timeout=1.0)

        def helper(self):
            with self.b:
                pass

        def indirect(self):
            with self.a:
                self.helper()
''')

# A module-level set's ``add`` called under a lock, beside a class whose
# ``add`` takes another lock (the shape of ``lockdep_runtime._edges`` and
# ``watchtower.StragglerScorer.add`` in the port).
CONTAINER = textwrap.dedent('''
    import threading

    _edges_lock = threading.Lock()
    _edges = set()


    def record(edge):
        with _edges_lock:
            _edges.add(edge)


    class Scorer:
        def __init__(self):
            self._lock = threading.Lock()

        def add(self, x):
            with self._lock:
                pass

        def flush(self):
            with self._lock:
                record(("a", "b"))
''')


def _reports(tmp_path_factory, source):
    from tepdist_tpu.analysis.lockdep import analyze as janalyze

    root = tmp_path_factory.mktemp("synth")
    pkg = root / "pkg"
    pkg.mkdir()
    (pkg / "mod.py").write_text(source)
    return (analyze(str(root), package="pkg"),
            janalyze(str(root), package="pkg"))


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return _reports(tmp_path_factory, SYNTH)


def test_synthetic_findings_and_edges_equal_the_reference(synth):
    got, want = synth
    assert got.locks == want.locks
    assert got.static_edges() == want.static_edges()
    assert [f.key for f in got.findings] == [f.key for f in want.findings]
    assert ([(e.outer, e.inner, e.func, e.line, e.via) for e in got.edges]
            == [(e.outer, e.inner, e.func, e.line, e.via)
                for e in want.edges])
    # The reference test's own assertions, on the port's report.
    assert {"Worker.a", "Worker.b", "Worker.cv"} <= set(got.locks)
    assert {("Worker.a", "Worker.b"), ("Worker.b", "Worker.a")} <= (
        got.static_edges())
    inv = [f for f in got.findings if f.kind == "lock_inversion"]
    assert len(inv) == 1
    assert "Worker.a -> Worker.b" in inv[0].message
    assert "Worker.b -> Worker.a" in inv[0].message
    assert [f.func for f in got.findings
            if f.kind == "bare_acquire"] == ["Worker.leak"]
    blk = {f.func: f.detail for f in got.findings
           if f.kind == "blocking_under_lock"}
    assert blk["Worker.sleepy"].startswith("time.sleep")
    assert blk["Worker.parked"].startswith("wait@Worker.cv")
    assert blk["Worker.pulls"].startswith("queue.get@q")
    assert "Worker.bounded" not in blk and "Worker.pulls_bounded" not in blk
    via = [e for e in got.edges
           if (e.outer, e.inner) == ("Worker.a", "Worker.b") and e.via]
    assert via and "helper" in via[0].via


def test_container_method_is_not_a_class_method(tmp_path_factory):
    """The port's one departure from the reference's analyzer: a call on
    a module-level set/dict/list (``_edges.add``) is a builtin's, not
    the only class method of that name. The reference resolves it to
    ``Scorer.add`` and reports a false ``_edges_lock -> Scorer._lock``
    edge, and with ``flush`` an inversion; the port reports neither."""
    got, want = _reports(tmp_path_factory, CONTAINER)
    false_edge = ("mod:_edges_lock", "Scorer._lock")
    assert false_edge in want.static_edges()
    assert [f.kind for f in want.findings] == ["lock_inversion"]
    assert false_edge not in got.static_edges()
    assert ("Scorer._lock", "mod:_edges_lock") in got.static_edges()
    assert not got.findings


def test_allowlist_parser_equals_the_reference(tmp_path):
    from tepdist_tpu.analysis import lockdep as jlockdep

    p = tmp_path / "allow.toml"
    p.write_text(textwrap.dedent('''
        # a comment
        [[allow]]
        key = "bare_acquire:pkg/mod.py:Worker.leak:Worker.a"
        reason = "released by a callback"

        [[allow]]
        key = "blocking_under_lock:pkg/mod.py:*"
        reason = "demo glob"
    '''))
    allow = load_allowlist(str(p))
    assert allow == jlockdep.load_allowlist(str(p))
    for kind, func, detail, ok in (
            ("bare_acquire", "Worker.leak", "Worker.a", True),
            ("blocking_under_lock", "Worker.sleepy", "time.sleep|held=x",
             True),
            ("lock_inversion", "Worker.ab", "a<->b", False)):
        f = lockdep.Finding(kind=kind, file="pkg/mod.py", func=func,
                            detail=detail, line=1, message="")
        jf = jlockdep.Finding(kind=kind, file="pkg/mod.py", func=func,
                              detail=detail, line=1, message="")
        assert is_allowed(f, allow) == jlockdep.is_allowed(jf, allow) == ok
    bad = tmp_path / "bad.toml"
    for text in ('[[allow]]\nkey = "x"\n', 'key = "x"\n'):
        bad.write_text(text)
        with pytest.raises(ValueError):
            load_allowlist(str(bad))
        with pytest.raises(ValueError):
            jlockdep.load_allowlist(str(bad))
    assert load_allowlist(str(tmp_path / "missing.toml")) == []


def test_port_is_lockdep_clean():
    rep = analyze(ROOT)
    allow = load_allowlist(ALLOWLIST)
    assert allow and all(e["reason"] for e in allow)
    flagged = [f.key for f in rep.findings if not is_allowed(f, allow)]
    assert not flagged, f"un-allowlisted lockdep findings: {flagged}"
    # No inversion may EVER be allowlisted: the port's static lock-order
    # graph must be inversion-free outright.
    assert not [f for f in rep.findings if f.kind == "lock_inversion"]
    assert not [e for e in allow if e["key"].startswith("lock_inversion")]
    # Every entry still matches a finding (no stale entries).
    import fnmatch
    assert all(any(fnmatch.fnmatchcase(f.key, e["key"])
                   for f in rep.findings) for e in allow)
    assert ("ServingSupervisor._lock", "ServingEngine._cv") \
        in rep.static_edges()
    assert all(f.file.startswith("tepdist_tpu_torch/")
               for f in rep.findings)


def test_cli_check_and_confirm(tmp_path):
    tool = os.path.join(ROOT, "tools", "torch_lockdep.py")
    r = subprocess.run([sys.executable, tool, "--check", "--json"],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    out = json.loads(r.stdout)
    assert not out["findings"] and not out["stale_allowlist"]
    assert len(out["allowed"]) == len(load_allowlist(ALLOWLIST))
    good = tmp_path / "good.json"
    good.write_text(json.dumps([["ServingSupervisor._lock",
                                 "ServingEngine._cv"]]))
    r = subprocess.run([sys.executable, tool, "--confirm", str(good)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "1 confirmed" in r.stdout, r.stdout
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps([["ServingEngine._cv",
                                "ServingSupervisor._lock"]]))
    r = subprocess.run([sys.executable, tool, "--confirm", str(bad)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and "CONTRADICTED" in r.stdout, r.stdout
    # A stale entry exits 2.
    stale = tmp_path / "stale.toml"
    stale.write_text(open(ALLOWLIST).read() + '\n[[allow]]\nkey = '
                     '"bare_acquire:nowhere.py:X.y:Z"\nreason = "gone"\n')
    r = subprocess.run([sys.executable, tool, "--check", "--allowlist",
                        str(stale)], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 2, r.stdout


def test_runtime_mode_confirms_supervisor_engine_order(monkeypatch):
    from tepdist_tpu_torch.models import gpt2
    from tepdist_tpu_torch.serving.supervisor import ServingSupervisor

    monkeypatch.setenv("TEPDIST_LOCKDEP", "1")
    lockdep_runtime.reset_edges()
    cfg = gpt2.CONFIGS["test"]
    params = gpt2.init_params(cfg, seed=0, device="cpu")
    sup = ServingSupervisor(params, cfg, slots=2, max_len=32, device="cpu")
    sup.start()
    try:
        p = np.arange(1, 6, dtype=np.int32) % cfg.vocab_size
        assert sup.submit("r0", p, max_new_tokens=4)["status"] == "queued"
        assert sup.poll(["r0"], wait_ms=10000)[0]["status"] == "done"
    finally:
        sup.stop(timeout=10.0)
    observed = lockdep_runtime.edges()
    assert ("ServingSupervisor._lock", "ServingEngine._cv") in observed
    assert ("ServingEngine._cv", "ServingSupervisor._lock") not in observed
    static = analyze(ROOT).static_edges()
    assert lockdep_runtime.confirms(static) == sorted(
        e for e in static if e in observed)
    assert ("ServingSupervisor._lock", "ServingEngine._cv") in (
        lockdep_runtime.confirms(static))
    # No observed edge contradicts the static graph.
    assert not [e for e in observed
                if e not in static and (e[1], e[0]) in static]


def test_factories_return_plain_primitives_when_off(monkeypatch):
    import threading

    monkeypatch.delenv("TEPDIST_LOCKDEP", raising=False)
    assert isinstance(lockdep_runtime.make_lock("x"),
                      type(threading.Lock()))
    monkeypatch.setenv("TEPDIST_LOCKDEP", "1")
    lk = lockdep_runtime.make_lock("x")
    assert isinstance(lk, lockdep_runtime._TrackedLock)
    with lk:
        pass
