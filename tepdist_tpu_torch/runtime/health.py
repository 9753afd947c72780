"""Worker health monitoring: heartbeats + failure surfacing (a copy of the
JAX package's ``runtime/health.py`` on the port's lockdep locks).

Reference parity: NONE — the reference has no heartbeats, failure detection,
or elasticity (SURVEY §5.3: "gRPC errors surface as CHECK failures"; recovery
= checkpoint + restart). This module is deliberate surplus: a background
heartbeat loop over the worker fleet that detects dead/unresponsive workers
*between* steps, reports them through a callback, and arms the session's
recovery path (restore-from-checkpoint after the cluster is restored —
the same recovery contract the reference documents, minus the manual
discovery of which worker died)."""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

from tepdist_tpu_torch.analysis.lockdep_runtime import make_lock

log = logging.getLogger(__name__)


class HealthMonitor:
    """Periodic Ping over a set of TepdistClients.

    ``misses``/``dead``/``last_seen`` are mutated from the heartbeat
    thread AND from session threads (``revive``, ``mark_dead`` during
    elastic re-dispatch), so every state transition takes ``_lock``. The
    Ping RPC itself runs OUTSIDE the lock — a slow worker must not hold
    health state hostage for ``timeout_s`` (and lockdep flags RPC under
    a lock); ``on_failure`` fires outside it too, since callbacks take
    their own locks."""

    def __init__(self, clients: Dict[int, "object"],
                 interval_s: float = 5.0,
                 timeout_s: float = 3.0,
                 max_misses: int = 2,
                 on_failure: Optional[Callable[[int, Exception], None]] = None,
                 on_revive: Optional[Callable[[int], None]] = None):
        self.clients = clients
        self.interval = interval_s
        self.timeout = timeout_s
        self.max_misses = max_misses
        self.on_failure = on_failure
        # Fired (outside the lock, like on_failure) when a dead worker's
        # heartbeat answers again — the elastic session's hook to fold a
        # revived worker back into the plan via live migration.
        self.on_revive = on_revive
        self.misses: Dict[int, int] = {ti: 0 for ti in clients}
        self.dead: set = set()
        self.last_seen: Dict[int, float] = {}
        self.last_rtt_ms: Dict[int, float] = {}
        self._lock = make_lock("HealthMonitor._lock")
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def revive(self, ti: int) -> None:
        """Clear a worker's dead mark + miss count (its process came back
        or the partition healed). The next sweep treats it as healthy."""
        with self._lock:
            if ti not in self.dead:
                return
            self.dead.discard(ti)
            self.misses[ti] = 0
        from tepdist_tpu_torch.telemetry import metrics
        metrics().counter("worker_revived").inc()
        log.warning("worker %d revived (heartbeat answered again)", ti)
        if self.on_revive is not None:
            try:
                self.on_revive(ti)
            except Exception:  # noqa: BLE001
                log.exception("on_revive callback raised")

    def mark_dead(self, tis: Sequence[int]) -> None:
        """Declare workers dead from outside the heartbeat loop (the
        session's recovery path observed execute-time failures before the
        next sweep would have)."""
        with self._lock:
            self.dead |= set(tis)

    def check_once(self) -> Dict[int, bool]:
        """One synchronous sweep; returns {task_index: healthy}.

        Dead workers are RE-PROBED each sweep: a successful Ping revives
        them (clears dead + misses) instead of leaving a recovered process
        marked dead forever. Snapshot the client map so a concurrent
        re-dispatch swapping ``self.clients`` mid-sweep cannot blow up the
        iteration."""
        status: Dict[int, bool] = {}
        for ti, client in list(self.clients.items()):
            with self._lock:
                was_dead = ti in self.dead
            try:
                from tepdist_tpu_torch.rpc import protocol
                from tepdist_tpu_torch.telemetry import metrics
                t0 = time.perf_counter()
                resp = client.stub.call("Ping", protocol.pack({}),
                                        timeout=self.timeout)
                rtt_ms = (time.perf_counter() - t0) * 1e3
                header, _ = protocol.unpack(resp)
                ok = bool(header.get("ok"))
                if ok:
                    if was_dead:
                        self.revive(ti)
                    with self._lock:
                        self.misses[ti] = 0
                        self.last_seen[ti] = time.time()
                        self.last_rtt_ms[ti] = rtt_ms
                    m = metrics()
                    m.gauge(f"heartbeat_rtt_ms:{ti}").set(rtt_ms)
                    m.histogram("heartbeat_rtt_ms").observe(rtt_ms)
                    # Per-worker RTT histogram: trace_summary's health
                    # section prints p50/p95/p99 per worker, and the
                    # watchtower's straggler scorer reads the per-worker
                    # distribution (the pooled histogram can't attribute
                    # a tail to a worker).
                    m.histogram(f"heartbeat_rtt_ms:{ti}").observe(rtt_ms)
                status[ti] = ok
            except Exception as e:  # noqa: BLE001
                status[ti] = False
                if was_dead:
                    continue   # still dead; on_failure already fired once
                with self._lock:
                    self.misses[ti] = self.misses.get(ti, 0) + 1
                    newly_dead = self.misses[ti] >= self.max_misses
                    if newly_dead:
                        self.dead.add(ti)
                    n_misses = self.misses[ti]
                if newly_dead:
                    log.error("worker %d declared dead after %d missed "
                              "heartbeats: %s", ti, n_misses, e)
                    if self.on_failure is not None:
                        try:
                            self.on_failure(ti, e)
                        except Exception:  # noqa: BLE001
                            log.exception("on_failure callback raised")
        return status

    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self.interval):
                self.check_once()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="tepdist-heartbeat")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval + 1)
            if self._thread.is_alive():
                # Keep the reference: dropping it would leak a running
                # thread we could never join; a later stop() retries.
                log.warning("heartbeat thread did not stop within %.1fs; "
                            "keeping reference for a later join",
                            self.interval + 1)
                return
            self._thread = None

    def healthy(self) -> bool:
        return not self.dead

    def assert_healthy(self) -> None:
        if self.dead:
            raise RuntimeError(
                f"workers {sorted(self.dead)} are dead; restore the cluster "
                "and resume from the last checkpoint (DoRemoteRestore)")
