"""The port's ``runtime/health.py`` held to the JAX package's: the cases of
``tests/test_health.py`` (HealthMonitor with fake clients: the miss ->
dead -> assert_healthy escalation, the on_failure callback contract,
miss-count reset on recovery, and the heartbeat RTT gauge/histogram),
each run on both packages' monitor, envelope and metrics."""

import pytest

from tepdist_tpu.rpc import protocol as jax_protocol
from tepdist_tpu.runtime.health import HealthMonitor as JaxHealthMonitor
from tepdist_tpu.telemetry import metrics as jax_metrics
from tepdist_tpu_torch.rpc import protocol as torch_protocol
from tepdist_tpu_torch.runtime.health import (
    HealthMonitor as TorchHealthMonitor)
from tepdist_tpu_torch.telemetry import metrics as torch_metrics

IMPLS = {"jax": (jax_protocol, JaxHealthMonitor, jax_metrics),
         "torch": (torch_protocol, TorchHealthMonitor, torch_metrics)}
protocol, HealthMonitor, metrics = IMPLS["torch"]


@pytest.fixture(autouse=True, params=list(IMPLS))
def impl(request):
    """Every case on each package (module globals the cases read)."""
    global protocol, HealthMonitor, metrics
    protocol, HealthMonitor, metrics = IMPLS[request.param]
    yield request.param
    protocol, HealthMonitor, metrics = IMPLS["torch"]


class _FakeStub:
    """Scriptable Ping endpoint: pops the next behaviour per call."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = 0

    def call(self, method, payload, timeout=None):
        assert method == "Ping"
        self.calls += 1
        beh = self.script.pop(0) if self.script else "ok"
        if beh == "ok":
            return protocol.pack({"ok": True})
        if beh == "notok":
            return protocol.pack({"ok": False})
        raise ConnectionError("fake heartbeat failure")


class _FakeClient:
    def __init__(self, script=()):
        self.stub = _FakeStub(script)


def test_all_healthy_resets_misses_and_records_rtt():
    metrics().reset()
    clients = {0: _FakeClient(), 1: _FakeClient()}
    mon = HealthMonitor(clients, max_misses=2)
    mon.misses[1] = 1  # a prior transient miss...
    status = mon.check_once()
    assert status == {0: True, 1: True}
    assert mon.misses == {0: 0, 1: 0}  # ...cleared by the successful Ping
    assert mon.healthy() and not mon.dead
    mon.assert_healthy()  # must not raise
    assert mon.last_rtt_ms[0] > 0.0 and mon.last_rtt_ms[1] > 0.0
    snap = metrics().snapshot()
    assert snap["gauges"]["heartbeat_rtt_ms:0"] == mon.last_rtt_ms[0]
    assert snap["gauges"]["heartbeat_rtt_ms:1"] == mon.last_rtt_ms[1]
    assert snap["histograms"]["heartbeat_rtt_ms"]["count"] == 2


def test_misses_accumulate_then_dead_then_raise():
    failures = []
    clients = {0: _FakeClient(),
               1: _FakeClient(["raise", "raise", "raise"])}
    mon = HealthMonitor(clients, max_misses=2,
                        on_failure=lambda ti, e: failures.append((ti, e)))
    assert mon.check_once() == {0: True, 1: False}
    assert mon.misses[1] == 1 and not mon.dead and failures == []
    assert mon.check_once() == {0: True, 1: False}
    assert 1 in mon.dead
    assert [ti for ti, _ in failures] == [1]
    assert isinstance(failures[0][1], ConnectionError)
    # Dead workers ARE re-probed each sweep (3rd failing call) but stay
    # dead while the probe fails — and on_failure does not fire again.
    mon.check_once()
    assert clients[1].stub.calls == 3
    assert 1 in mon.dead and [ti for ti, _ in failures] == [1]
    assert not mon.healthy()
    with pytest.raises(RuntimeError, match=r"workers \[1\] are dead"):
        mon.assert_healthy()


def test_dead_worker_revived_by_successful_reprobe():
    metrics().reset()
    # Two failing sweeps kill worker 0; the script then answers again.
    mon = HealthMonitor({0: _FakeClient(["raise", "raise", "ok"])},
                        max_misses=2)
    mon.check_once()
    mon.check_once()
    assert 0 in mon.dead
    status = mon.check_once()   # re-probe succeeds -> automatic revive
    assert status == {0: True}
    assert not mon.dead and mon.misses[0] == 0 and mon.healthy()
    assert metrics().snapshot()["counters"]["worker_revived"] == 1


def test_revive_clears_dead_and_misses():
    mon = HealthMonitor({0: _FakeClient(["raise"])}, max_misses=1)
    mon.check_once()
    assert 0 in mon.dead
    mon.revive(0)
    assert not mon.dead and mon.misses[0] == 0
    mon.revive(0)   # idempotent on an already-live worker
    assert mon.healthy()


def test_check_once_snapshots_clients_mid_sweep():
    # A concurrent re-dispatch may swap self.clients while a sweep is
    # iterating; the sweep must work over its own snapshot.
    class _SwappingDict(dict):
        def items(self):
            snap = list(super().items())
            self.clear()   # simulate the swap happening mid-iteration
            return iter(snap)

    clients = _SwappingDict({0: _FakeClient(), 1: _FakeClient()})
    mon = HealthMonitor(clients, max_misses=2)
    assert mon.check_once() == {0: True, 1: True}


def test_not_ok_response_counts_as_unhealthy_but_not_a_miss():
    # ok=False is an answering-but-unhealthy worker: reported False, yet
    # only exceptions escalate toward dead.
    mon = HealthMonitor({0: _FakeClient(["notok", "ok"])}, max_misses=1)
    assert mon.check_once() == {0: False}
    assert not mon.dead
    assert mon.check_once() == {0: True}


def test_transient_miss_recovers():
    mon = HealthMonitor({0: _FakeClient(["raise", "ok"])}, max_misses=2)
    assert mon.check_once() == {0: False}
    assert mon.misses[0] == 1
    assert mon.check_once() == {0: True}
    assert mon.misses[0] == 0 and mon.healthy()


def test_dead_worker_rtt_gauge_not_updated():
    metrics().reset()
    mon = HealthMonitor({3: _FakeClient(["raise"])}, max_misses=1)
    mon.check_once()
    assert 3 in mon.dead
    assert 3 not in mon.last_rtt_ms
    assert "heartbeat_rtt_ms:3" not in metrics().snapshot()["gauges"]
