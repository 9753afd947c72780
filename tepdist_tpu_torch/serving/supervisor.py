"""ServingSupervisor: engine lifecycle, request journal, replay, shedding —
the port of ``tepdist_tpu/serving/supervisor.py``, the same host logic.

The serving-plane counterpart of the training plane's recovery ladder
(retry -> same-step re-execute -> elastic re-dispatch). The supervisor
owns the ``ServingEngine`` the RPC verbs talk to, and turns an engine
fault — which the bare engine could only answer with
``_fail_all_locked`` — into a supervised restart:

  * Every ADMITTED request is journaled in memory (prompt, sampling
    params, seed, plus the tokens emitted by any engine generation that
    died under it). The journal is the replay source, not the engine's
    own ``_reqs`` — a dead engine's state is snapshotted once and
    discarded.
  * On an engine fault (``on_fault`` from the scheduler thread, or an
    exception out of a lockstep ``step()``), the supervisor rebuilds a
    FRESH engine + SlotPool — adopting the dead engine's compiled
    executables, so the restart costs milliseconds, not a recompile —
    and resubmits every non-terminal request under its original id:

      - greedy requests are RE-PREFILLED from ``prompt + emitted
        prefix`` with correspondingly fewer ``max_new_tokens``; on this
        stack that continuation is BIT-IDENTICAL to the uninterrupted
        run, so a crash is invisible in the output stream.
      - seeded-sampling requests restart from the original prompt with
        the original seed: the request's generator stream is a pure
        function of (seed, position), so full regeneration is
        deterministic — resuming mid-stream from a re-prefill is not,
        hence replay-from-scratch.

    Terminal results trapped in the dead engine (finished but not yet
    polled) are carried forward and answered from the supervisor, so a
    restart can neither lose nor re-deliver a finished result.
  * The restart budget (``max_restarts``) is the ladder: only when it
    is exhausted does the supervisor fall to ``_fail_all_locked`` —
    the last rung, not the first response.
  * Admission passes through a HIGH/LOW queue watermark (overload
    protection): at ``shed_high`` queued requests the supervisor starts
    answering ``{"status": "shed"}`` — a typed refusal the client's
    circuit breaker (serving/client.py) understands — and keeps
    shedding until the queue falls to ``shed_low`` (hysteresis, so the
    admission decision doesn't flap per-request). Shed requests are NOT
    journaled and leave no engine record: the same id can be
    resubmitted to another replica.

Retention: ``_journal`` / ``_completed`` / ``_delivered`` are bounded:
a DELIVERED request's bookkeeping expires ``completed_ttl_s`` after its
first delivery, and carried results are LRU-capped at ``completed_cap``
(delivered entries evicted first). Within the TTL/cap window the
exactly-once guarantees hold; past it, a replayed submit of an ancient
rid is a fresh request.

Control-plane journal: pass ``wal=`` (a ControlPlaneWAL) and
every serving-journal transition — admit / finish / deliver (terminal
status) / handoff — is appended to the master's durable WAL.
``rebuild_from_wal`` then reconstructs a supervisor after a master
crash: non-terminal requests replay under their ORIGINAL rids (greedy
continuations bit-identical, seeded sampling regenerated from the
seed), terminal-but-undelivered ones re-run and deliver exactly once.

Counters: ``engine_restarts``, ``requests_replayed``, ``serve_shed``,
``serve_retention_expired`` (plus everything the engine already emits).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from tepdist_tpu_torch.analysis.lockdep_runtime import make_rlock
from tepdist_tpu_torch.models.gpt2 import GPT2Config
from tepdist_tpu_torch.serving.engine import TERMINAL, ServingEngine
from tepdist_tpu_torch.telemetry import flight, metrics

log = logging.getLogger("tepdist.serving")


@dataclasses.dataclass
class _JournalEntry:
    """Everything needed to resubmit a request to a fresh engine."""
    rid: str
    prompt: np.ndarray
    max_new_tokens: int
    greedy: bool
    temperature: float
    top_k: int
    seed: int
    deadline_ms: Optional[float]
    slo_class: str = "default"
    prefix: List[int] = dataclasses.field(default_factory=list)
    replays: int = 0
    prefill_only: bool = False


class ServingSupervisor:
    """Owns one ServingEngine generation at a time; same client surface
    (submit/cancel/poll/drain/stats/start/stop/step/run_until_idle), so
    the RPC servicer talks to the supervisor exactly as it talked to the
    bare engine."""

    def __init__(self, params, cfg: GPT2Config, *, slots: int = 4,
                 max_len: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 max_queue: int = 64, name: str = "servable",
                 task_index: Optional[int] = None,
                 max_restarts: int = 3,
                 shed_high: Optional[int] = None,
                 shed_low: Optional[int] = None,
                 kv_mode: str = "paged", page_size: int = 16,
                 n_pages: Optional[int] = None,
                 hbm_budget_bytes: Optional[float] = None,
                 prefix_cache: bool = True,
                 prefill_chunk: Optional[int] = None,
                 completed_cap: int = 1024,
                 completed_ttl_s: float = 900.0,
                 wal=None, device="cuda"):
        self._params = params
        self._cfg = cfg
        # A rebuilt engine gets the SAME paged-KV geometry, so replay
        # rebuilds page tables (and re-attaches prefix hits as replayed
        # prompts re-commit their pages) on an identically-shaped pool.
        self._engine_kwargs = dict(slots=slots, max_len=max_len,
                                   buckets=buckets, max_queue=max_queue,
                                   name=name, kv_mode=kv_mode,
                                   page_size=page_size, n_pages=n_pages,
                                   hbm_budget_bytes=hbm_budget_bytes,
                                   prefix_cache=prefix_cache,
                                   prefill_chunk=prefill_chunk,
                                   device=device)
        self.name = name
        self.task_index = task_index
        self.max_restarts = int(max_restarts)
        self.shed_high = int(shed_high if shed_high is not None
                             else max_queue)
        self.shed_low = int(shed_low if shed_low is not None
                            else max(1, self.shed_high // 2))
        if not 0 < self.shed_low <= self.shed_high:
            raise ValueError(
                f"need 0 < shed_low <= shed_high, got "
                f"{self.shed_low}/{self.shed_high}")
        # RLock: _recover runs under it and calls submit-adjacent engine
        # methods; poll/submit from RPC threads serialize against it.
        # Lock order: ServingSupervisor._lock before ServingEngine._cv,
        # never the reverse (on_fault fires outside _cv).
        self._lock = make_rlock("ServingSupervisor._lock")
        self._journal: Dict[str, _JournalEntry] = {}
        self._completed: Dict[str, Dict[str, Any]] = {}  # dead-gen results
        # rid -> monotonic time of FIRST delivery; the retention clock.
        # (Insertion-ordered dicts give oldest-first iteration for free.)
        self._delivered: Dict[str, float] = {}
        self.completed_cap = int(completed_cap)
        self.completed_ttl_s = float(completed_ttl_s)
        self._wal = wal
        self._serve_seq = itertools.count()
        self._shedding = False
        self._threaded = False
        self.restarts = 0
        self.engine = self._make_engine()

    # -- bounded retention -----------------------------------------------
    def _prune_locked(self) -> None:
        """Expire DELIVERED bookkeeping past ``completed_ttl_s`` and cap
        carried results at ``completed_cap`` (delivered evicted first,
        then oldest). Non-terminal journal entries — the replay source —
        are never touched."""
        now = time.monotonic()
        drop = [rid for rid, ts in self._delivered.items()
                if now - ts >= self.completed_ttl_s]
        over = len(self._completed) - len(
            [r for r in drop if r in self._completed]) - self.completed_cap
        if over > 0:
            spill = sorted(
                (r for r in self._completed if r not in drop),
                key=lambda r: r not in self._delivered)
            drop.extend(spill[:over])
        for rid in drop:
            self._delivered.pop(rid, None)
            self._completed.pop(rid, None)
            self._journal.pop(rid, None)
        if drop:
            metrics().counter("serve_retention_expired").inc(len(drop))

    # -- control-plane journal hooks ------------------------------------
    def _wal_serve(self, rid: str, event: str, **fields: Any) -> None:
        if self._wal is None:
            return
        from tepdist_tpu_torch.runtime import controlplane
        try:
            controlplane.log_serve(self._wal, rid, event, **fields)
        except Exception:  # noqa: BLE001 — journal loss must not fail
            log.exception("serving WAL append failed (%s %s)", rid, event)

    _STATUS_EVENT = {"done": "delivered", "drained": "delivered",
                     "cancelled": "cancelled", "failed": "failed",
                     "rejected": "failed", "expired": "expired",
                     "handed_off": "handoff"}

    # -- engine lifecycle ----------------------------------------------
    def _make_engine(self, old: Optional[ServingEngine] = None
                     ) -> ServingEngine:
        eng = ServingEngine(self._params, self._cfg,
                            task_index=self.task_index,
                            on_fault=self._on_engine_fault,
                            gen=self.restarts,
                            **self._engine_kwargs)
        if old is not None:
            eng.model.adopt_executables(old.model)
        return eng

    def start(self) -> None:
        with self._lock:
            self._threaded = True
            self.engine.start()

    def stop(self, timeout: float = 10.0, drain: bool = True) -> None:
        with self._lock:
            self._threaded = False
            eng = self.engine
        eng.stop(timeout=timeout, drain=drain)

    # -- admission (shedding watermark, then the engine) ----------------
    def submit(self, rid: str, prompt, **kwargs) -> Dict[str, Any]:
        """Admission: dedup/carried-result passthrough, then the shed
        watermark, then the engine. A submit can race the window between
        an engine marking itself dead (scheduler thread, engine lock) and
        ``_recover`` swapping in the replacement (supervisor lock): a
        dead-engine rejection is retried briefly instead of bounced to
        the caller — unless the restart budget is spent, in which case
        dead is permanent. A dead engine keeps no record of the rid, so
        the retry cannot double-admit."""
        deadline = time.monotonic() + 5.0
        while True:
            out = self._submit_once(rid, prompt, **kwargs)
            if not (out.get("status") == "rejected"
                    and "engine dead" in out.get("error", "")):
                return out
            with self._lock:
                if self.restarts >= self.max_restarts:
                    return out
            if time.monotonic() > deadline:  # pragma: no cover — stalled
                return out
            time.sleep(0.005)

    def _submit_once(self, rid: str, prompt, **kwargs) -> Dict[str, Any]:
        with self._lock:
            self._prune_locked()
            eng = self.engine
            if rid in self._journal or rid in self._completed:
                # Replay of an applied submit: let the engine's dedup
                # answer (and count) it; results carried from a dead
                # generation answer directly.
                if rid in self._completed:
                    metrics().counter("serve_requests_deduped").inc()
                    return {"status": "duplicate",
                            "state": self._completed[rid]["status"]}
                return eng.submit(rid, prompt, **kwargs)
            depth = eng.queue_depth()
            if self._shedding and depth <= self.shed_low:
                self._shedding = False
            if self._shedding or depth >= self.shed_high:
                self._shedding = True
                metrics().counter("serve_shed").inc()
                flight.record(rid, "shed", depth=depth,
                              high=self.shed_high)
                return {"status": "shed",
                        "error": (f"queue depth {depth} over high "
                                  f"watermark {self.shed_high}")}
            out = eng.submit(rid, prompt, **kwargs)
            if out["status"] == "queued":
                e = _JournalEntry(
                    rid=rid,
                    prompt=np.asarray(prompt, np.int32).reshape(-1),
                    max_new_tokens=int(kwargs["max_new_tokens"]),
                    greedy=bool(kwargs.get("greedy", True)),
                    temperature=float(kwargs.get("temperature", 1.0)),
                    top_k=int(kwargs.get("top_k", 0)),
                    seed=int(kwargs.get("seed", 0)),
                    deadline_ms=kwargs.get("deadline_ms"),
                    slo_class=str(kwargs.get("slo_class", "default")),
                    prefill_only=bool(kwargs.get("prefill_only", False)))
                self._journal[rid] = e
                self._wal_serve(
                    rid, "admit", seq=next(self._serve_seq),
                    prompt=[int(t) for t in e.prompt],
                    max_new_tokens=e.max_new_tokens, greedy=e.greedy,
                    temperature=e.temperature, top_k=e.top_k,
                    seed=e.seed, deadline_ms=e.deadline_ms,
                    slo_class=e.slo_class, prefill_only=e.prefill_only)
            return out

    def cancel(self, rid: str) -> bool:
        with self._lock:
            eng = self.engine
        return eng.cancel(rid)

    # -- poll (journal-aware, restart-proof) ----------------------------
    def _merge_prefix(self, res: Dict[str, Any]) -> Dict[str, Any]:
        e = self._journal.get(res.get("request_id"))
        if e is None or not e.prefix or "tokens" not in res:
            return res
        res = dict(res)
        res["tokens"] = list(e.prefix) + list(res["tokens"])
        res["n_tokens"] = len(res["tokens"])
        return res

    def _poll_once(self, rids: Optional[Sequence[str]]
                   ) -> List[Dict[str, Any]]:
        # Entirely under the supervisor lock (the engine poll is a
        # non-blocking snapshot): a snapshot can never interleave with a
        # recovery half-way through moving a prefix into the journal.
        with self._lock:
            self._prune_locked()
            out = []
            seen = set()
            for r in self.engine.poll(rids, wait_ms=0.0):
                rid = r.get("request_id")
                seen.add(rid)
                if r.get("status") == "unknown" \
                        and rid in self._completed:
                    out.append(self._completed[rid])
                else:
                    out.append(self._merge_prefix(r))
            if rids is None:
                out.extend(v for k, v in self._completed.items()
                           if k not in seen)
            # Flight: exactly one "deliver" per rid, at the FIRST poll
            # that observes its terminal result (carried or live).
            for r in out:
                rid = r.get("request_id")
                if (r.get("status") in TERMINAL
                        and rid not in self._delivered):
                    self._delivered[rid] = time.monotonic()
                    flight.record(rid, "deliver",
                                  status=r.get("status"),
                                  n_tokens=r.get("n_tokens", 0))
                    if rid in self._journal:   # shed/unknown: not ours
                        st = r.get("status")
                        self._wal_serve(
                            rid,
                            self._STATUS_EVENT.get(st, "delivered"),
                            n_tokens=r.get("n_tokens", 0))
            return out

    def poll(self, rids: Optional[Sequence[str]] = None,
             wait_ms: float = 0.0) -> List[Dict[str, Any]]:
        """Engine-generation-proof long-poll: waits in short slices and
        re-reads ``self.engine`` each round, so a poller blocked across
        a supervised restart wakes up against the replacement engine
        instead of a corpse's condition variable."""
        deadline = time.monotonic() + wait_ms / 1e3
        while True:
            out = self._poll_once(rids)
            done = all(r.get("status") in TERMINAL + ("unknown",)
                       for r in out)
            remaining = deadline - time.monotonic()
            if not wait_ms or done or remaining <= 0:
                return out
            eng = self.engine
            with eng._cv:
                eng._cv.wait(min(0.05, remaining))

    # -- drain ----------------------------------------------------------
    def drain(self, wait_ms: float = 0.0) -> List[Dict[str, Any]]:
        with self._lock:
            eng = self.engine
        return eng.drain(wait_ms=wait_ms)

    # -- disaggregated handoff (serving/fleet.py) ------------------------
    def export_pages(self, rid: str, want=None):
        with self._lock:
            eng = self.engine
        return eng.export_pages(rid, want)

    def complete_handoff(self, rid: str) -> bool:
        with self._lock:
            eng = self.engine
        return eng.complete_handoff(rid)

    def adopt_pages(self, rid: str, prompt, *, fetch,
                    **kwargs) -> Dict[str, Any]:
        """Journal-aware adoption: the entry is registered up front so a
        decode-engine crash after adoption replays the request as a
        PLAIN submit (full local prefill) on the rebuilt engine — the
        handoff pages died with the corpse, the prompt did not. The
        nested fetch runs OUTSIDE the supervisor lock (it is a network
        pull; poll/submit must not stall behind it)."""
        with self._lock:
            eng = self.engine
            if rid in self._completed:
                metrics().counter("serve_requests_deduped").inc()
                return {"status": "duplicate",
                        "state": self._completed[rid]["status"]}
            fresh_entry = rid not in self._journal
            if fresh_entry:
                self._journal[rid] = _JournalEntry(
                    rid=rid,
                    prompt=np.asarray(prompt, np.int32).reshape(-1),
                    max_new_tokens=int(kwargs["max_new_tokens"]),
                    greedy=bool(kwargs.get("greedy", True)),
                    temperature=float(kwargs.get("temperature", 1.0)),
                    top_k=int(kwargs.get("top_k", 0)),
                    seed=int(kwargs.get("seed", 0)),
                    deadline_ms=kwargs.get("deadline_ms"),
                    slo_class=str(kwargs.get("slo_class", "default")))
        try:
            out = eng.adopt_pages(rid, prompt, fetch=fetch, **kwargs)
        except Exception:
            if fresh_entry:
                with self._lock:
                    self._journal.pop(rid, None)
            raise
        if fresh_entry and out.get("status") not in ("adopted",
                                                     "duplicate"):
            with self._lock:
                self._journal.pop(rid, None)
        elif fresh_entry and out.get("status") == "adopted":
            self._wal_serve(rid, "handoff", seq=next(self._serve_seq),
                            adopted=True)
        return out

    # -- recovery -------------------------------------------------------
    def _on_engine_fault(self, exc: BaseException) -> None:
        """Engine fault callback — runs on the DYING engine's scheduler
        thread (or a lockstep driver's thread via step())."""
        self._recover(exc)

    def _recover(self, exc: BaseException) -> None:
        with self._lock:
            old = self.engine
            if old._thread is not None \
                    and old._thread is not threading.current_thread():
                # A lockstep driver raced the scheduler thread; only one
                # recovery per corpse.
                return
            if self.restarts >= self.max_restarts:
                log.error("serving engine fault after %d restarts; "
                          "failing in-flight requests", self.restarts)
                with old._cv:
                    old._fail_all_locked(
                        f"engine dead after {self.restarts} restarts: "
                        f"{exc!r}")
                return
            self.restarts += 1
            metrics().counter("engine_restarts").inc()
            # rid "*" = engine-wide event: bypasses TEPDIST_FLIGHT_SAMPLE
            # so a restart is never shed from a sampled waterfall.
            flight.record("*", "restart", gen=self.restarts,
                          reason=repr(exc))
            log.warning("serving engine fault (%r): restart %d/%d",
                        exc, self.restarts, self.max_restarts)
            old.stop(timeout=0.0, drain=False)
            with old._cv:
                dead_reqs = list(old._reqs.values())
            new = self._make_engine(old=old)
            replay: List[_JournalEntry] = []
            for r in dead_reqs:
                e = self._journal.get(r.rid)
                if r.state in TERMINAL:
                    # Finished-but-unpolled results must survive the
                    # corpse: exactly-once delivery.
                    res = r.result()
                    if e is not None and e.prefix and "tokens" in res:
                        res["tokens"] = list(e.prefix) + res["tokens"]
                        res["n_tokens"] = len(res["tokens"])
                    self._completed[r.rid] = res
                    flight.record(r.rid, "carry", gen=self.restarts,
                                  status=res.get("status"))
                    # Finished but not yet delivered: non-terminal in the
                    # control-plane journal, so a master rebuilt from the
                    # WAL re-runs it and delivers exactly once.
                    self._wal_serve(r.rid, "finish",
                                    status=res.get("status"))
                    continue
                if e is None:      # pragma: no cover — journal invariant
                    continue
                if e.greedy and not e.prefill_only:
                    # Accumulate across generations: a request may
                    # survive several crashes.
                    e.prefix = list(e.prefix) + list(r.tokens)
                else:
                    # Non-greedy regenerates from the seed; a prefill-only
                    # request must replay its WHOLE prompt — a prefix
                    # would shift the handoff position the decode replica
                    # adopts at (the single picked token re-picks
                    # deterministically from the same seed anyway).
                    e.prefix = []
                replay.append(e)
            # Replays bypass the queue bound: every one of them was
            # already admitted once (queued + resident can exceed
            # max_queue alone).
            new.max_queue = max(new.max_queue, len(replay))
            for e in replay:
                prompt = (np.concatenate(
                    [e.prompt, np.asarray(e.prefix, np.int32)])
                    if e.prefix else e.prompt)
                out = new.submit(
                    e.rid, prompt,
                    max_new_tokens=e.max_new_tokens - len(e.prefix),
                    greedy=e.greedy, temperature=e.temperature,
                    top_k=e.top_k, seed=e.seed, deadline_ms=e.deadline_ms,
                    slo_class=e.slo_class, prefill_only=e.prefill_only)
                e.replays += 1
                metrics().counter("requests_replayed").inc()
                flight.record(e.rid, "replay", gen=self.restarts,
                              prefix=len(e.prefix),
                              status=out["status"])
                if out["status"] != "queued":  # pragma: no cover
                    log.error("replay of %s not admitted: %s", e.rid, out)
            self.engine = new
            if self._threaded:
                new.start()

    # -- lockstep driving (tests/benches) -------------------------------
    def step(self) -> bool:
        with self._lock:
            eng = self.engine
        try:
            return eng.step()
        except Exception as e:  # noqa: BLE001 — supervised ladder
            log.exception("lockstep serving step failed")
            self._recover(e)
            return True

    def run_until_idle(self, max_steps: int = 100000) -> None:
        for _ in range(max_steps):
            with self._lock:
                eng = self.engine
            if not eng._has_work():
                return
            self.step()
        raise RuntimeError("run_until_idle: scheduler did not drain")

    # -- master-crash rebuild ------------------------------------------
    @classmethod
    def rebuild_from_wal(cls, params, cfg: GPT2Config, state, *,
                         wal=None, **kwargs) -> "ServingSupervisor":
        """Reconstruct a supervisor from a replayed control-plane state
        (``controlplane.replay(wal_dir)`` or a ControlPlaneState): every
        NON-terminal journaled request — admitted, finished-but-
        undelivered, or mid-handoff — is resubmitted under its ORIGINAL
        rid, in admission order. Greedy requests re-prefill and continue
        bit-identically; seeded sampling regenerates deterministically
        from the journaled seed; already-delivered/cancelled/failed rids
        are NOT replayed (exactly-once delivery across master crashes).
        ``wal``: the new master's re-opened ControlPlaneWAL, so replayed
        admissions are journaled under the new epoch."""
        if isinstance(state, str):
            from tepdist_tpu_torch.runtime import controlplane
            state = controlplane.replay(state)
        sup = cls(params, cfg, wal=wal, **kwargs)
        for rid, ent in state.pending_serving():
            prompt = np.asarray(ent.get("prompt", []), np.int32)
            out = sup.submit(
                rid, prompt,
                max_new_tokens=int(ent.get("max_new_tokens", 16)),
                greedy=bool(ent.get("greedy", True)),
                temperature=float(ent.get("temperature", 1.0)),
                top_k=int(ent.get("top_k", 0)),
                seed=int(ent.get("seed", 0)),
                deadline_ms=ent.get("deadline_ms"),
                slo_class=str(ent.get("slo_class", "default")),
                prefill_only=bool(ent.get("prefill_only", False)))
            metrics().counter("requests_replayed").inc()
            flight.record(rid, "replay", gen=-1, prefix=0,
                          status=out.get("status"))
        return sup

    # -- introspection ---------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._lock:
            self._prune_locked()
            eng = self.engine
            out = eng.stats()
            out.update({
                "restarts": self.restarts,
                "shedding": self._shedding,
                "shed_high": self.shed_high,
                "shed_low": self.shed_low,
                "journal": len(self._journal),
                "carried_results": len(self._completed),
            })
            return out
