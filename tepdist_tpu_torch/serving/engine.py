"""Continuous-batching inference engine: queue, admission, scheduler —
the port of ``tepdist_tpu/serving/engine.py``.

Orca-style iteration-level scheduling (Yu et al., OSDI'22) over the slot
pool in kv_cache.py or the page pool in paged_kv.py. The scheduler is the
JAX package's, with the same spans, flight records and metrics under the
same names; what differs is the device work and the sampling:

  * A decode step makes ONE host sync: the batched decode, one argmax
    over the batch for every greedy row, a draw from each sampled
    request's own ``torch.Generator`` (seeded from ``seed``), and one
    ``.cpu()`` of the picks. ``serve:decode``/``step_ms`` cover that whole
    step up to the sync, as they cover the decode up to
    ``block_until_ready`` in JAX.
  * A request's draws depend only on its seed, never on which other
    requests share the batch.

  * ``submit()`` enqueues a request under ADMISSION CONTROL — a bounded
    queue (reject when full), per-request deadlines (expire un-admitted
    requests whose deadline passed), and duplicate-id dedup (the RPC
    retry path replays a submit whose response was lost; the engine must
    not generate twice — ``serve_requests_deduped`` proves it didn't).
  * ``step()`` is ONE scheduler iteration: retire/cancel finished slots,
    admit queued requests into free slots (prefill each — its logits
    yield the request's FIRST token, closing the TTFT span), then run
    ONE batched decode step appending one token to every active request.
    New requests slip in between decode steps; a finished sequence frees
    its slot without stalling the rest of the batch.
  * ``kv_mode="paged"`` (the default) swaps the slot pool for the
    block-paged subsystem in paged_kv.py: admission reserves PAGES
    (page_size tokens each) instead of a max_len slot — prefix-cache
    hits attach to shared pages and skip that prefill span entirely —
    and prompts prefill in page-aligned CHUNKS, one chunk per request
    per scheduler iteration, interleaved with the batched decode so a
    giant prompt never monopolizes an iteration. ``kv_mode="slots"``
    keeps the original fixed-slot engine as a fallback.
  * ``start()`` runs ``step()`` on a daemon scheduler thread that idles
    on a condition variable when there is no work; tests that need
    lockstep determinism drive ``step()``/``run_until_idle()`` directly
    instead.
  * ``drain()`` stops admission, hands un-started queued requests back
    to the caller (for resubmission on another replica) and optionally
    waits for resident slots to finish — ``stop()`` drains by default.
  * Fault ladder: a step failure on a SUPERVISED engine (``on_fault``
    set, see supervisor.py) marks the engine dead and escalates — the
    supervisor rebuilds and replays, and ``_fail_all_locked`` is its
    last rung, not the first response. An UNSUPERVISED engine keeps the
    pre-supervisor contract: fail every in-flight request (releasing
    their slots — lockstep callers must not leak SlotPool capacity) and
    keep serving new submissions. ``serve_fault``/``engine_crash`` rules
    in ``TEPDIST_FAULT_SPEC`` inject into exactly these paths.

Telemetry (always-on metrics; spans when tracing is enabled):
counters   serve_requests_{submitted,completed,rejected,expired,
           cancelled,deduped,failed}, serve_prefills, serve_decode_steps,
           serve_tokens, serve_compiles; paged: prefill_chunks,
           serve_prefill_tokens, prefix_hits, prefix_hit_tokens,
           prefix_evictions, pages_cow
gauges     serve_queue_depth, serve_slot_occupancy; paged: pages_used,
           pages_free, pages_cached
histograms serve_ttft_ms, serve_token_ms, serve_batch_size
spans      serve:ttft (submit -> first token, one per request),
           serve:prefill, serve:decode (one per step), serve:token (one
           per request per decode step — its duration IS that token's
           latency).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from tepdist_tpu_torch.analysis.lockdep_runtime import make_condition
from tepdist_tpu_torch.models.gpt2 import GPT2Config
from tepdist_tpu_torch.runtime import faults
from tepdist_tpu_torch.serving.kv_cache import (ServableModel,
                                                request_generator)
from tepdist_tpu_torch.serving.paged_kv import (PagedServableModel,
                                                PageTable, pages_for)
from tepdist_tpu_torch.telemetry import flight, metrics, span

log = logging.getLogger("tepdist.serving")

# Terminal request states (poll stops waiting on these). "drained" =
# handed back un-started by drain() for resubmission elsewhere; "shed" =
# refused by the supervisor's overload watermark (supervisor.py);
# "handed_off" = a prefill-pool request whose KV pages were adopted by a
# decode replica (serving/fleet.py) — terminal HERE, decode finishes it
# THERE under the same request id.
TERMINAL = ("done", "rejected", "expired", "cancelled", "failed",
            "drained", "shed", "handed_off")


@dataclasses.dataclass
class ServeRequest:
    rid: str
    prompt: np.ndarray               # int32 [T]
    max_new_tokens: int
    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0
    seed: int = 0
    deadline_ms: Optional[float] = None
    slo_class: str = "default"       # SLO class (watchtower burn-rate
    state: str = "queued"            # targets key per-class tails)
    tokens: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None
    error: Optional[str] = None
    t_submit: float = 0.0
    t_deadline: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    rng: Any = None                  # torch.Generator (non-greedy)
    pos: int = 0                     # next cache write position
    ttft_span: Any = None
    decode_ms: float = 0.0           # summed batched-decode step time
    decode_steps: int = 0
    table: Any = None                # paged_kv.PageTable (kv_mode=paged)
    prefilled: int = 0               # prompt tokens whose k/v are cached
    prefix_tokens: int = 0           # of those, tokens from a prefix hit
    chunks: int = 0                  # prefill chunk executions
    prefill_only: bool = False       # disagg: park at "prefilled", never
                                     # decode (fleet.py hands the KV off)

    def result(self) -> Dict[str, Any]:
        out = {
            "request_id": self.rid,
            "status": self.state,
            "n_tokens": len(self.tokens),
            "tokens": list(self.tokens),
        }
        if self.error:
            out["error"] = self.error
        if self.t_first is not None:
            out["ttft_ms"] = round((self.t_first - self.t_submit) * 1e3, 3)
        if self.t_done is not None:
            out["total_ms"] = round((self.t_done - self.t_submit) * 1e3, 3)
        if self.decode_steps:
            # Per-request attribution: how much of total_ms was actual
            # batched decode compute vs queueing/scheduling (the serving
            # analogue of the per-step fidelity attribution).
            out["decode_ms"] = round(self.decode_ms, 3)
            out["decode_steps"] = self.decode_steps
        return out


class ServingEngine:
    """One servable model + its request queue + the batching scheduler."""

    def __init__(self, params, cfg: GPT2Config, *, slots: int = 4,
                 max_len: Optional[int] = None,
                 buckets: Optional[Sequence[int]] = None,
                 max_queue: int = 64, name: str = "servable",
                 task_index: Optional[int] = None,
                 on_fault: Optional[Callable[[BaseException], None]]
                 = None, kv_mode: str = "paged", page_size: int = 16,
                 n_pages: Optional[int] = None,
                 hbm_budget_bytes: Optional[float] = None,
                 prefix_cache: bool = True,
                 prefill_chunk: Optional[int] = None,
                 gen: int = 0, device="cuda"):
        if kv_mode not in ("paged", "slots"):
            raise ValueError(f"kv_mode must be 'paged' or 'slots', "
                             f"got {kv_mode!r}")
        self.kv_mode = kv_mode
        if kv_mode == "paged":
            # `slots` survives as the capacity hint: with no explicit
            # n_pages/HBM budget the pool holds the same token count the
            # slot pool would have (slots * max_len), just page-granular.
            self.model: Any = PagedServableModel(
                params, cfg, page_size=page_size, n_pages=n_pages,
                hbm_budget_bytes=hbm_budget_bytes, slots=slots,
                max_len=max_len, buckets=buckets,
                prefix_cache=prefix_cache, prefill_chunk=prefill_chunk,
                name=name, device=device)
        else:
            self.model = ServableModel(params, cfg, slots=slots,
                                       max_len=max_len, buckets=buckets,
                                       name=name, device=device)
        self.name = name
        self.max_queue = int(max_queue)
        self.task_index = task_index      # fault-rule ti filter target
        self.on_fault = on_fault          # set => supervised (ladder up)
        # Engine incarnation (supervisor restarts bump it): every flight
        # event carries gen= so a request surviving a restart shows its
        # history across BOTH incarnations.
        self.gen = int(gen)
        # Serve spans carry worker= when known so the fidelity join
        # attributes them to a lane instead of the untagged clamp.
        self._wtag = ({"worker": task_index} if task_index is not None
                      else {})
        self._reqs: Dict[str, ServeRequest] = {}
        self._queue: deque = deque()
        # Resident requests in admission order (paged decode batches it;
        # slot mode orders its decode batch by slot id below).
        self._active: Dict[str, ServeRequest] = {}
        self._cv = make_condition("ServingEngine._cv")
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self._draining = False
        self._dead = False
        self._error: Optional[str] = None
        self._steps = 0                   # scheduler iterations (1-based)

    # -- client surface (thread-safe) ----------------------------------
    def submit(self, rid: str, prompt, *, max_new_tokens: int,
               greedy: bool = True, temperature: float = 1.0,
               top_k: int = 0, seed: int = 0,
               deadline_ms: Optional[float] = None,
               slo_class: str = "default",
               prefill_only: bool = False) -> Dict[str, Any]:
        """Admission control happens here (bounded queue, validation,
        duplicate dedup); deadline expiry happens at slot-assignment
        time. Returns {"status": queued|rejected|duplicate, ...}.
        ``slo_class`` tags the request's latency/error metrics with a
        per-class suffix (``serve_ttft_ms:<class>`` …) so slo.toml
        targets can hold interactive traffic to a tighter tail than
        batch traffic (telemetry/watchtower.py). ``prefill_only`` parks
        the request at state "prefilled" after its last chunk (KV
        resident, first token picked, NO decode) for a disaggregated
        handoff to a decode replica (serving/fleet.py)."""
        m = metrics()
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        now = time.monotonic()
        with self._cv:
            if rid in self._reqs:
                # RPC replay of an applied submit (or a client reusing an
                # id): never enqueue twice — this counter is the
                # exactly-once evidence the chaos test asserts on.
                m.counter("serve_requests_deduped").inc()
                flight.record(rid, "dedup", gen=self.gen)
                return {"status": "duplicate",
                        "state": self._reqs[rid].state}
            if self._dead:
                # No record is kept: a dead engine must not claim rids
                # the supervisor's replacement will own.
                flight.record(rid, "reject", gen=self.gen, reason="dead")
                return {"status": "rejected",
                        "error": f"engine dead: {self._error}"}
            if self._draining:
                # Honest backpressure, not a terminal record: the caller
                # resubmits the same rid on another replica.
                flight.record(rid, "draining", gen=self.gen)
                return {"status": "draining"}
            m.counter("serve_requests_submitted").inc()
            m.counter(f"serve_requests_submitted:{slo_class}").inc()
            err = None
            if prompt.size == 0:
                err = "empty prompt"
            elif max_new_tokens < 1:
                err = "max_new_tokens < 1"
            elif prompt.size + max_new_tokens > self.model.max_len:
                err = (f"prompt+max_new_tokens "
                       f"{prompt.size + max_new_tokens} > "
                       f"max_len={self.model.max_len}")
            elif prefill_only and self.kv_mode != "paged":
                err = "prefill_only requires kv_mode='paged'"
            elif len(self._queue) >= self.max_queue:
                err = f"queue full ({self.max_queue})"
            r = ServeRequest(
                rid=rid, prompt=prompt, max_new_tokens=int(max_new_tokens),
                greedy=bool(greedy), temperature=float(temperature),
                top_k=int(top_k), seed=int(seed), deadline_ms=deadline_ms,
                slo_class=str(slo_class), t_submit=now,
                t_deadline=(now + deadline_ms / 1e3
                            if deadline_ms is not None else None),
                prefill_only=bool(prefill_only))
            self._reqs[rid] = r
            if err is not None:
                r.state = "rejected"
                r.error = err
                m.counter("serve_requests_rejected").inc()
                m.counter(f"serve_requests_rejected:{r.slo_class}").inc()
                flight.record(rid, "reject", gen=self.gen, reason=err)
                return {"status": "rejected", "error": err}
            flight.record(rid, "queue", gen=self.gen,
                          prompt_len=int(prompt.size),
                          max_new_tokens=int(max_new_tokens),
                          depth=len(self._queue))
            sp = span("serve:ttft", cat="serve", rid=rid,
                      prompt_len=int(prompt.size))
            sp.__enter__()
            r.ttft_span = sp
            self._queue.append(rid)
            m.gauge("serve_queue_depth").set(len(self._queue))
            self._cv.notify_all()
            return {"status": "queued"}

    def _release_locked(self, r: ServeRequest) -> None:
        """Return a request's KV resources (slot or page table) to the
        pool and drop it from the resident set. Idempotent per request:
        the slot/table field is cleared so a second call is a no-op —
        the pool itself raises ``KVFreeError`` on a true double free."""
        if r.slot is not None:
            self.model.pool.release(r.slot)
            r.slot = None
        if r.table is not None:
            self.model.release_table(r.table)
            r.table = None
        self._active.pop(r.rid, None)
        metrics().gauge("serve_slot_occupancy").set(
            len(self._active) if self.kv_mode == "paged"
            else self.model.pool.n_used)

    def cancel(self, rid: str) -> bool:
        """Cancel a queued or decoding request; terminal ones are left
        alone (their result already stands)."""
        with self._cv:
            r = self._reqs.get(rid)
            if r is None or r.state in TERMINAL:
                return False
            if r.state == "adopting":
                # The adopt thread is scattering into this table's pages
                # outside the lock; yanking them now could hand the pages
                # to another request mid-write. The adopter resolves the
                # state (active/failed) within its RPC deadline.
                return False
            self._release_locked(r)
            r.state = "cancelled"
            r.t_done = time.monotonic()
            flight.record(rid, "cancel", gen=self.gen)
            metrics().counter("serve_requests_cancelled").inc()
            self._cv.notify_all()
            return True

    def poll(self, rids: Optional[Sequence[str]] = None,
             wait_ms: float = 0.0) -> List[Dict[str, Any]]:
        """Snapshot request states (all requests when ``rids`` is None).
        ``wait_ms`` blocks until every polled request is terminal (or the
        wait expires) — long-polling keeps the RPC chatter bounded."""
        deadline = time.monotonic() + wait_ms / 1e3
        with self._cv:
            while True:
                ids = list(rids) if rids is not None else list(self._reqs)
                reqs = [self._reqs[i] for i in ids if i in self._reqs]
                missing = [i for i in ids if i not in self._reqs]
                if (not wait_ms
                        or all(r.state in TERMINAL for r in reqs)
                        or missing):
                    out = [r.result() for r in reqs]
                    out += [{"request_id": i, "status": "unknown"}
                            for i in missing]
                    return out
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return [r.result() for r in reqs]
                self._cv.wait(remaining)

    # -- scheduler ------------------------------------------------------
    def _has_work(self) -> bool:
        if self._queue:
            return True
        # "prefilled"/"adopting" residents are parked on KV-handoff RPCs
        # (fleet.py) — not schedulable work; counting them would busy-spin
        # the scheduler thread until the handoff lands.
        return any(r.state in ("prefill", "active")
                   for r in self._active.values())

    def queue_depth(self) -> int:
        with self._cv:
            return len(self._queue)

    def step(self) -> bool:
        """One scheduler iteration (admit + one batched decode step).
        Called from the scheduler thread, or directly by lockstep
        tests/benches. Returns False when there was nothing to do.

        On ANY failure (injected or real): a supervised engine is marked
        dead and the exception escalates to ``on_fault`` (via ``_loop``)
        or the lockstep driver; an unsupervised engine fails every
        in-flight request — releasing their slots, so direct ``step()``
        callers can't leak SlotPool capacity — and stays serviceable."""
        try:
            return self._step_inner()
        except Exception as e:  # noqa: BLE001 — ladder decides below
            with self._cv:
                if self.on_fault is not None:
                    self._dead = True
                    self._error = repr(e)
                else:
                    self._fail_all_locked(repr(e))
            raise

    def _step_inner(self) -> bool:
        m = metrics()
        admitted: List[ServeRequest] = []
        with self._cv:
            self._steps += 1
        plan = faults.active()
        if plan is not None and plan.engine_crash_on_step(
                self.task_index, self._steps):
            raise faults.InjectedFault(
                f"injected engine crash at scheduler step {self._steps} "
                f"(worker {self.task_index})", kind="engine_crash")
        paged = self.kv_mode == "paged"
        with self._cv:
            while self._queue:
                if not paged and not self.model.pool.n_free:
                    break
                rid = self._queue.popleft()
                r = self._reqs.get(rid)
                if r is None or r.state != "queued":
                    continue          # cancelled while queued
                if (r.t_deadline is not None
                        and time.monotonic() > r.t_deadline):
                    r.state = "expired"
                    r.error = f"deadline {r.deadline_ms} ms passed in queue"
                    r.t_done = time.monotonic()
                    m.counter("serve_requests_expired").inc()
                    m.counter(
                        f"serve_requests_expired:{r.slo_class}").inc()
                    flight.record(rid, "expire", gen=self.gen)
                    self._cv.notify_all()
                    continue
                if paged:
                    # Reservation-based admission: attach() reserves every
                    # page the request could need (after a prefix-cache
                    # lookup and, on pressure, LRU eviction) so an
                    # admitted request can never die of page exhaustion.
                    # Head-of-line FIFO: if the head doesn't fit, nothing
                    # behind it jumps the queue.
                    att = self.model.attach(r.prompt, r.max_new_tokens)
                    if att is None:
                        self._queue.appendleft(rid)
                        break
                    r.table, r.prefix_tokens = att
                    r.prefilled = r.prefix_tokens
                    r.state = "prefill"
                    flight.record(rid, "admit", gen=self.gen,
                                  pages=len(r.table.pages),
                                  prefix_tokens=int(r.prefix_tokens))
                else:
                    r.slot = self.model.pool.alloc()
                    r.state = "active"
                    flight.record(rid, "admit", gen=self.gen, slot=r.slot)
                self._active[rid] = r
                admitted.append(r)
            m.gauge("serve_queue_depth").set(len(self._queue))
            if admitted:
                m.gauge("serve_slot_occupancy").set(
                    len(self._active) if paged
                    else self.model.pool.n_used)

        if paged:
            # One page-aligned chunk per prefilling request per iteration
            # — long prompts interleave with the decode batch below
            # instead of monopolizing the iteration.
            with self._cv:
                prefilling = [r for r in self._active.values()
                              if r.state == "prefill"]
            for r in prefilling:
                self._prefill_chunk(r)
        else:
            for r in admitted:
                self._prefill_one(r)

        with self._cv:
            batch = [r for r in self._active.values()
                     if r.state == "active"]
            if not paged:
                batch.sort(key=lambda r: r.slot)
        if not batch:
            return bool(admitted) or (paged and bool(prefilling))
        self._decode_once(batch)
        return True

    def _prefill_one(self, r: ServeRequest) -> None:
        m = metrics()
        plan = faults.active()
        if plan is not None:
            plan.serve_op("prefill", self.task_index)
        with span("serve:prefill", cat="serve", rid=r.rid, slot=r.slot,
                  prompt_len=int(r.prompt.size), **self._wtag) as sp:
            logits, k, v, bucket = self.model.prefill(r.prompt)
            sp.set(bucket=bucket)
            self.model.insert(k, v, r.slot)
            if not r.greedy:
                r.rng = request_generator(r.seed, self.model.device)
            tok = self.model.pick(logits, r.rng, r.temperature, r.top_k,
                                  r.greedy)
        m.counter("serve_prefills").inc()
        flight.record(r.rid, "prefill", gen=self.gen,
                      prompt_len=int(r.prompt.size))
        with self._cv:
            r.t_first = time.monotonic()
            r.tokens.append(tok)
            r.pos = int(r.prompt.size)
            flight.record(r.rid, "first_token", gen=self.gen)
            m.counter("serve_tokens").inc()
            ttft_ms = (r.t_first - r.t_submit) * 1e3
            m.histogram("serve_ttft_ms").observe(ttft_ms)
            m.histogram(
                f"serve_ttft_ms:{r.slo_class}").observe(ttft_ms)
            if r.ttft_span is not None:
                r.ttft_span.__exit__(None, None, None)
                r.ttft_span = None
            if len(r.tokens) >= r.max_new_tokens:
                self._finish_locked(r)
            self._cv.notify_all()

    def _prefill_chunk(self, r: ServeRequest) -> None:
        """Run ONE page-aligned prefill chunk for ``r`` (kv_mode=paged).
        The final chunk's logits yield the request's first token, closing
        the TTFT span — a prefix-cache hit skips straight to the tail, so
        ``serve_prefill_tokens`` counts exactly the un-shared span."""
        m = metrics()
        plan = faults.active()
        if plan is not None:
            plan.serve_op("prefill", self.task_index)
        T = int(r.prompt.size)
        start = r.prefilled
        end = min(start + self.model.chunk_tokens, T)
        with self._cv:
            if r.state != "prefill":
                return                # cancelled since the batch snapshot
            # Host-side page allocation under the lock; the executable
            # below runs outside it like every device call here. The
            # pages snapshot keeps a concurrent cancel's release_table
            # from yanking the table mid-call (its stray writes land in
            # pages only this thread could reallocate).
            self.model.extend_table(r.table, end)
            pages = list(r.table.pages)
        with span("serve:prefill", cat="serve", rid=r.rid,
                  chunk=end - start, chunk_index=r.chunks, start=start,
                  prompt_len=T, **self._wtag) as sp:
            logits = self.model.prefill_chunk(pages, r.prompt,
                                              start, end)
            sp.set(chunks=r.chunks + 1)
            tok = None
            if end >= T:
                if not r.greedy:
                    r.rng = request_generator(r.seed, self.model.device)
                tok = self.model.pick(logits, r.rng, r.temperature,
                                      r.top_k, r.greedy)
        m.counter("prefill_chunks").inc()
        m.counter("serve_prefill_tokens").inc(end - start)
        flight.record(r.rid, "prefill_chunk", gen=self.gen,
                      start=start, end=end, chunk=end - start)
        with self._cv:
            if r.state != "prefill":
                return                # cancelled mid-chunk: drop it
            r.prefilled = end
            r.chunks += 1
            if end < T:
                return
            # Prompt fully resident: publish its full pages for prefix
            # sharing, emit the first token, and join the decode batch —
            # or, for a disagg prefill-pool request, park at "prefilled"
            # with the KV held for the decode replica's AdoptPages pull.
            self.model.commit_prefix(r.prompt, r.table)
            r.t_first = time.monotonic()
            r.tokens.append(tok)
            r.pos = T
            r.state = "prefilled" if r.prefill_only else "active"
            flight.record(r.rid, "first_token", gen=self.gen,
                          chunks=r.chunks)
            m.counter("serve_prefills").inc()
            m.counter("serve_tokens").inc()
            ttft_ms = (r.t_first - r.t_submit) * 1e3
            m.histogram("serve_ttft_ms").observe(ttft_ms)
            m.histogram(
                f"serve_ttft_ms:{r.slo_class}").observe(ttft_ms)
            if r.ttft_span is not None:
                r.ttft_span.__exit__(None, None, None)
                r.ttft_span = None
            if r.prefill_only:
                flight.record(r.rid, "prefilled", gen=self.gen,
                              pages=len(r.table.pages))
            elif len(r.tokens) >= r.max_new_tokens:
                self._finish_locked(r)
            self._cv.notify_all()

    def _decode_once(self, batch) -> None:
        m = metrics()
        plan = faults.active()
        if plan is not None:
            plan.serve_op("decode", self.task_index)
        paged = self.kv_mode == "paged"
        slots: List[int] = []
        if paged:
            with self._cv:
                batch = [r for r in batch if r.state == "active"]
                if not batch:
                    return
                for r in batch:
                    # Grow each table to cover this token's write and
                    # COW-split a shared target page (structurally
                    # unreachable — shared pages lie below the write
                    # frontier — but the guard is load-bearing for any
                    # future partial-page sharing).
                    self.model.extend_table(r.table, r.pos + 1)
                    self.model.ensure_writable(r.table, r.pos)
                # Page-list snapshots: a cancel mid-decode releases the
                # live table; freed pages can't be reallocated until this
                # scheduler thread runs admission again.
                rows = [(list(r.table.pages), r.tokens[-1], r.pos)
                        for r in batch]
        else:
            S = self.model.n_slots
            tok = np.zeros(S, np.int32)
            pos = np.zeros(S, np.int32)
            with self._cv:
                # Snapshot slot ids under the lock: a concurrent cancel()
                # sets r.slot = None mid-decode, and tok[None] = x is a
                # numpy broadcast that would overwrite EVERY slot's token.
                pairs = [(r.slot, r) for r in batch
                         if r.state == "active" and r.slot is not None]
            if not pairs:
                return
            slots = [s for s, _ in pairs]
            batch = [r for _, r in pairs]
            for s, r in pairs:
                tok[s] = r.tokens[-1]
                pos[s] = r.pos
        tok_spans = [span("serve:token", cat="serve", rid=r.rid)
                     for r in batch]
        for sp in tok_spans:
            sp.__enter__()
        t0 = time.perf_counter()
        with span("serve:decode", cat="serve", batch=len(batch),
                  **self._wtag):
            if paged:
                logits = self.model.decode_batch(rows)
            else:
                logits = self.model.decode_step(tok, pos)
            # The step's one host sync: every row's pick in one copy.
            picked = self.model.pick_rows(
                logits, range(len(batch)) if paged else slots,
                [(r.rng, r.temperature, r.top_k, r.greedy)
                 for r in batch])
        step_ms = (time.perf_counter() - t0) * 1e3
        for sp in tok_spans:
            sp.__exit__(None, None, None)
        m.counter("serve_decode_steps").inc()
        m.histogram("serve_batch_size").observe(len(batch))
        # Per-token loop: bind the instrument entry points once per decode
        # step instead of per token (module-attr + registry lookups are
        # measurable at token rate; the record calls themselves are
        # ring-slot writes).
        record = flight.record
        tokens_inc = m.counter("serve_tokens").inc
        token_ms_observe = m.histogram("serve_token_ms").observe
        # Per-class token histograms, bound once per decode step per
        # class present in the batch (not per token — registry lookups
        # are measurable at token rate).
        cls_observe = {
            cls: m.histogram(f"serve_token_ms:{cls}").observe
            for cls in {r.slo_class for r in batch}}
        n_batch = len(batch)
        with self._cv:
            for r, tok_i in zip(batch, picked):
                if r.state != "active":
                    continue          # cancelled mid-step: drop the token
                r.tokens.append(tok_i)
                r.pos += 1
                r.decode_ms += step_ms
                r.decode_steps += 1
                record(r.rid, "decode", gen=self.gen,
                       pos=r.pos, batch=n_batch)
                tokens_inc()
                token_ms_observe(step_ms)
                cls_observe[r.slo_class](step_ms)
                if len(r.tokens) >= r.max_new_tokens:
                    self._finish_locked(r)
            self._cv.notify_all()

    def _finish_locked(self, r: ServeRequest) -> None:
        self._release_locked(r)
        r.state = "done"
        r.t_done = time.monotonic()
        flight.record(r.rid, "finish", gen=self.gen,
                      n_tokens=len(r.tokens))
        m = metrics()
        m.counter("serve_requests_completed").inc()
        m.histogram("serve_request_ms").observe(
            (r.t_done - r.t_submit) * 1e3)
        if (self._draining and not self._active
                and self.kv_mode == "paged"):
            self._clear_prefix_locked()

    def _clear_prefix_locked(self) -> None:
        """Drop prefix-cache page references once a drain has retired
        every resident request — the no-page-leaks contract is
        ``pages_used == 0`` after drain, cache included."""
        if getattr(self.model, "prefix", None) is not None:
            self.model.prefix.clear()
            self.model._update_gauges()

    def _fail_all_locked(self, err: str) -> None:
        """The LAST rung of the fault ladder: every non-terminal request
        fails (its slot returned to the pool) and the queue empties.
        Supervised engines only reach this via the supervisor after the
        restart budget is exhausted."""
        m = metrics()
        for r in self._reqs.values():
            if r.state in TERMINAL:
                continue
            self._release_locked(r)
            if r.ttft_span is not None:
                r.ttft_span.__exit__(None, None, None)
                r.ttft_span = None
            r.state = "failed"
            r.error = err
            r.t_done = time.monotonic()
            flight.record(r.rid, "fail", gen=self.gen, reason=err)
            m.counter("serve_requests_failed").inc()
            m.counter(f"serve_requests_failed:{r.slo_class}").inc()
        self._queue.clear()
        if self.kv_mode == "paged":
            self._clear_prefix_locked()
        m.gauge("serve_queue_depth").set(0)
        self._cv.notify_all()

    # -- drain ----------------------------------------------------------
    def drain(self, wait_ms: float = 0.0) -> List[Dict[str, Any]]:
        """Graceful drain: stop admission, hand every un-started queued
        request back to the caller (terminal state "drained"; the specs
        returned here are resubmittable on another replica under the
        SAME request id), then wait up to ``wait_ms`` for resident slots
        to finish decoding. Threaded engines keep stepping while we
        wait; lockstep callers pass ``wait_ms=0`` and drive
        ``run_until_idle()`` themselves."""
        m = metrics()
        handed: List[Dict[str, Any]] = []

        def _hand_back(r: ServeRequest) -> None:
            if r.ttft_span is not None:
                r.ttft_span.__exit__(None, None, None)
                r.ttft_span = None
            r.state = "drained"
            r.t_done = time.monotonic()
            handed.append({
                "request_id": r.rid,
                "prompt": [int(t) for t in r.prompt],
                "max_new_tokens": r.max_new_tokens,
                "greedy": r.greedy,
                "temperature": r.temperature,
                "top_k": r.top_k,
                "seed": r.seed,
                "deadline_ms": r.deadline_ms,
                "prefill_only": r.prefill_only,
            })
            flight.record(r.rid, "drain_handoff", gen=self.gen)
            m.counter("drain_handoffs").inc()

        with self._cv:
            self._draining = True
            while self._queue:
                rid = self._queue.popleft()
                r = self._reqs.get(rid)
                if r is None or r.state != "queued":
                    continue
                _hand_back(r)
            # Paged: a partially-prefilled request has emitted NO tokens
            # yet (its first token appears only when the last chunk
            # lands), so it is still a clean resubmittable spec — hand it
            # back rather than burning drain budget finishing its prefill
            # plus a full decode. A parked "prefilled" disagg request is
            # equally resubmittable (its single picked token regenerates
            # deterministically from the same seed), so it hands back too
            # instead of holding pages hostage waiting for an adopter.
            for r in [q for q in self._active.values()
                      if q.state in ("prefill", "prefilled")]:
                self._release_locked(r)
                r.tokens = []
                _hand_back(r)
            m.gauge("serve_queue_depth").set(0)
            self._cv.notify_all()
            deadline = time.monotonic() + wait_ms / 1e3
            while self._active:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(remaining)
            if not self._active and self.kv_mode == "paged":
                self._clear_prefix_locked()
        return handed

    # -- disaggregated prefill/decode handoff (serving/fleet.py) --------
    def export_pages(self, rid: str,
                     want: Optional[Sequence[int]] = None
                     ) -> Optional[Dict[str, Any]]:
        """Gather a parked ("prefilled") request's live KV pages for the
        decode replica. ``want`` selects live-page ORDINALS (0-based
        within the request's table) so the adopter's prefix-cache hits
        are never re-shipped. Live pages = ``pages_for(len(prompt))``:
        prefill wrote k/v for exactly the prompt tokens (the first
        generated token's k/v lands at the adopter's first decode step).
        Pure read — returns None when ``rid`` is not exportable."""
        with self._cv:
            r = self._reqs.get(rid)
            if (r is None or r.state != "prefilled"
                    or r.table is None):
                return None
            T = int(r.prompt.size)
            n_live = pages_for(T, self.model.page_size)
            live = list(r.table.pages[:n_live])
            idx = list(want) if want is not None else list(range(n_live))
            sel = [live[i] for i in idx]
            first_token = int(r.tokens[0])
            pos = int(r.pos)
        k, v = self.model.export_pages(sel)
        with self._cv:
            # The gather ran outside the lock; a cancel/fail in between
            # could have released (and recycled) the pages — re-validate
            # before vouching for the bytes.
            r = self._reqs.get(rid)
            if (r is None or r.state != "prefilled" or r.table is None
                    or list(r.table.pages[:n_live]) != live):
                return None
        metrics().counter("kv_pages_exported").inc(len(sel))
        flight.record(rid, "kv_export", gen=self.gen, pages=len(sel),
                      bytes=int(k.nbytes + v.nbytes))
        return {"first_token": first_token, "pos": pos,
                "n_live": n_live, "idx": idx, "k": k, "v": v}

    def complete_handoff(self, rid: str) -> bool:
        """Release a parked request's pages after a decode replica
        adopted them: "prefilled" -> terminal "handed_off". Idempotent by
        state machine — a replayed release finds "handed_off" and simply
        confirms it."""
        with self._cv:
            r = self._reqs.get(rid)
            if r is None:
                return False
            if r.state == "handed_off":
                return True
            if r.state != "prefilled":
                return False
            self._release_locked(r)
            r.state = "handed_off"
            r.t_done = time.monotonic()
            flight.record(rid, "pool_handoff", gen=self.gen,
                          n_tokens=len(r.tokens))
            metrics().counter("pool_handoffs").inc()
            if (self._draining and not self._active
                    and self.kv_mode == "paged"):
                self._clear_prefix_locked()
            self._cv.notify_all()
            return True

    def adopt_pages(self, rid: str, prompt, *, max_new_tokens: int,
                    fetch: Callable[[Sequence[int]],
                                    Optional[Dict[str, Any]]],
                    greedy: bool = True, temperature: float = 1.0,
                    top_k: int = 0, seed: int = 0,
                    deadline_ms: Optional[float] = None,
                    slo_class: str = "default") -> Dict[str, Any]:
        """Decode-side adoption: allocate local pages for the request,
        pull the KV contents the prefix cache does NOT already cover via
        ``fetch(want_ordinals)`` (an ExportPages RPC to the prefill
        replica), install them, and enter the decode batch at
        ``pos=len(prompt)`` with the prefill's first token. Page-table-
        aware: only live pages move, prefix-hit pages are never
        re-shipped (``kv_pages_reused``). Deduped by rid exactly like
        ``submit`` — a replayed adoption never double-installs."""
        m = metrics()
        if self.kv_mode != "paged":
            return {"status": "rejected",
                    "error": "adopt_pages requires kv_mode='paged'"}
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        T = int(prompt.size)
        now = time.monotonic()
        model = self.model
        ps = model.page_size
        with self._cv:
            if rid in self._reqs:
                m.counter("serve_requests_deduped").inc()
                flight.record(rid, "dedup", gen=self.gen)
                return {"status": "duplicate",
                        "state": self._reqs[rid].state}
            if self._dead:
                flight.record(rid, "reject", gen=self.gen, reason="dead")
                return {"status": "rejected",
                        "error": f"engine dead: {self._error}"}
            if self._draining:
                flight.record(rid, "draining", gen=self.gen)
                return {"status": "draining"}
            if (T == 0 or max_new_tokens < 1
                    or T + max_new_tokens > model.max_len):
                return {"status": "rejected",
                        "error": f"invalid adoption spec (prompt {T}, "
                                 f"max_new {max_new_tokens}, "
                                 f"max_len {model.max_len})"}
            n_live = pages_for(T, ps)
            total = model.request_pages(T, max_new_tokens)
            # Local prefix hits substitute for shipped pages: decode
            # already holds their contents, so they drop out of `want`.
            hit = (model.prefix.lookup(prompt)
                   if model.prefix is not None else [])
            shared = list(hit[:n_live])
            for p in shared:
                model.pool.incref(p)
            fresh = total - len(shared)
            avail = model.pool.available
            if avail < fresh and model.prefix is not None:
                model.prefix.evict(fresh - avail)
            if not model.pool.reserve(fresh):
                for p in shared:
                    model.pool.decref(p)
                model._update_gauges()
                return {"status": "rejected",
                        "error": f"page pool exhausted (need {fresh})"}
            fresh_now = n_live - len(shared)
            new_pages = (model.pool.alloc(fresh_now, reserved=True)
                         if fresh_now else [])
            table = PageTable(pages=shared + new_pages,
                              n_shared=len(shared),
                              reserved=total - n_live)
            r = ServeRequest(
                rid=rid, prompt=prompt,
                max_new_tokens=int(max_new_tokens), greedy=bool(greedy),
                temperature=float(temperature), top_k=int(top_k),
                seed=int(seed), deadline_ms=deadline_ms,
                slo_class=str(slo_class), t_submit=now, state="adopting",
                table=table,
                t_deadline=(now + deadline_ms / 1e3
                            if deadline_ms is not None else None))
            # Registered while still mid-pull so a replayed AdoptPages
            # dedups instead of double-allocating.
            self._reqs[rid] = r
            model._update_gauges()
        try:
            want = list(range(len(shared), n_live))
            export = fetch(want)
            if export is None:
                raise RuntimeError(
                    f"source could not export pages for {rid}")
            if fresh_now:
                model.adopt_pages_into(new_pages, export["k"],
                                       export["v"])
            tok0 = int(export["first_token"])
            moved = int(export["k"].nbytes + export["v"].nbytes)
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            with self._cv:
                model.release_table(table)
                # Drop the record entirely: the router retries on another
                # decode replica under the SAME rid, which must not dedup
                # against this failed attempt.
                self._reqs.pop(rid, None)
                self._cv.notify_all()
            flight.record(rid, "kv_adopt_fail", gen=self.gen,
                          reason=repr(e))
            raise
        with self._cv:
            r.tokens = [tok0]
            r.pos = T
            r.prefilled = T
            r.prefix_tokens = len(shared) * ps
            r.t_first = time.monotonic()
            if not r.greedy:
                # Reconstruct the sampling RNG exactly where the prefill
                # replica left it: one draw consumed picking tok0.
                r.rng = request_generator(r.seed, model.device)
                torch.rand((1, model.cfg.vocab_size), generator=r.rng,
                           device=model.device)
            r.state = "active"
            self._active[rid] = r
            model.commit_prefix(prompt, table)
            m.counter("kv_pages_adopted").inc(fresh_now)
            m.counter("kv_pages_reused").inc(len(shared))
            flight.record(rid, "kv_adopt", gen=self.gen,
                          pages=fresh_now, reused=len(shared),
                          bytes=moved, pos=T)
            m.gauge("serve_slot_occupancy").set(len(self._active))
            if len(r.tokens) >= r.max_new_tokens:
                self._finish_locked(r)
            self._cv.notify_all()
        return {"status": "adopted", "pages": fresh_now,
                "reused": len(shared)}

    def run_until_idle(self, max_steps: int = 100000) -> None:
        """Drive the scheduler synchronously (lockstep tests/benches;
        do not mix with ``start()``)."""
        for _ in range(max_steps):
            if not self._has_work():
                return
            self.step()
        raise RuntimeError("run_until_idle: scheduler did not drain")

    # -- scheduler thread ----------------------------------------------
    def start(self) -> None:
        with self._cv:
            if self._thread is not None:
                return
            self._stop = False
            self._thread = threading.Thread(
                target=self._loop, name=f"serve-{self.name}", daemon=True)
            self._thread.start()

    def stop(self, timeout: float = 10.0, drain: bool = True) -> None:
        """Stop the scheduler thread; by default DRAIN first (stop
        admission, let resident slots finish within ``timeout``) so a
        routine shutdown strands no half-decoded request. ``drain=False``
        is the hard-stop path (supervisor discarding a dead engine)."""
        with self._cv:
            t = self._thread
            dead = self._dead
        me = threading.current_thread()
        if drain and not dead and t is not None and t is not me:
            try:
                self.drain(wait_ms=timeout * 1e3)
            except Exception:  # noqa: BLE001 — shutdown must proceed
                log.exception("drain during stop failed")
        with self._cv:
            t = self._thread
            self._stop = True
            self._cv.notify_all()
        # The supervisor calls stop() from the dying engine's own
        # scheduler thread (on_fault runs there): joining would deadlock.
        if t is not None and t is not me:
            t.join(timeout)
        with self._cv:
            self._thread = None

    def _loop(self) -> None:
        while True:
            with self._cv:
                while not self._stop and not self._has_work():
                    self._cv.wait()
                if self._stop:
                    return
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — ladder, not hang
                log.exception("serving scheduler step failed")
                cb = self.on_fault
                if cb is not None:
                    # Supervised: step() marked us dead; hand the corpse
                    # to the supervisor (it rebuilds + replays on THIS
                    # thread) and exit — this engine is done.
                    try:
                        cb(e)
                    except Exception:  # noqa: BLE001
                        log.exception("engine fault handler failed")
                        with self._cv:
                            self._fail_all_locked(repr(e))
                    return
                # Unsupervised: step() already failed all in-flight
                # requests; keep serving new submissions (pre-supervisor
                # contract).

    # -- introspection --------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        with self._cv:
            states: Dict[str, int] = {}
            for r in self._reqs.values():
                states[r.state] = states.get(r.state, 0) + 1
            out = {
                "name": self.name,
                "kv_mode": self.kv_mode,
                "max_len": self.model.max_len,
                "buckets": list(self.model.buckets),
                "queue_depth": len(self._queue),
                "requests": states,
                "draining": self._draining,
                "dead": self._dead,
                "scheduler_steps": self._steps,
            }
            if self.kv_mode == "paged":
                out.update({
                    "page_size": self.model.page_size,
                    "pages": self.model.n_pages,
                    "pages_used": self.model.pool.n_used,
                    "pages_free": self.model.pool.n_free,
                    "pages_reserved": self.model.pool.reserved,
                    "page_refs": self.model.pool.refs_total(),
                    "pages_cached": (len(self.model.prefix)
                                     if self.model.prefix is not None
                                     else 0),
                    "prefill_chunk": self.model.chunk_tokens,
                    "resident": len(self._active),
                })
            else:
                out.update({
                    "slots": self.model.n_slots,
                    "slots_used": self.model.pool.n_used,
                })
            return out
