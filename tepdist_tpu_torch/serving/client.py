"""ServeClient: the user-facing serving session (the port of the JAX
package's ``serving/client.py``).

Reference parity: NONE (deliberate surplus). Drives the serve verbs
(LoadServable / SubmitRequest / PollResult / CancelRequest / Drain) over
any TepdistClient transport — ``inproc:`` for tests, gRPC for real
fleets — with ROUND-ROBIN placement: ``load()`` installs the servable on
every worker, ``submit()`` spreads requests across them, and ``poll()``
fans the long-poll out per worker. ``generate()`` is the batch
convenience that mirrors ``sampling.sample()``'s contract (returns
prompt + generated tokens per request) so tests can compare the two
token-for-token.

Overload/failure handling (the client half of the serving fault
ladder):

  * Each replica gets a CIRCUIT BREAKER: ``breaker_threshold``
    consecutive transport errors or overload answers ("shed" from the
    supervisor watermark, "draining" from a drain) trip it OPEN, and
    submits skip it for ``breaker_cooldown_s``; after the cooldown one
    HALF-OPEN probe is allowed through — success closes the breaker,
    failure re-opens it. Counter ``serve_breaker_trips``; gauge
    ``serve_breaker_open`` (replicas currently open).
  * ``submit()`` FAILS OVER: it walks the round-robin past open/
    drained replicas and overload refusals, and only raises a typed
    ``ServeOverloadError`` once every replica has refused — honest
    backpressure, not a deadline-retry storm.
  * ``drain(i)`` gracefully empties replica ``i``: its resident slots
    finish, its un-started queued requests come back and are
    resubmitted (same request ids) on the remaining replicas; counter
    ``drain_handoffs`` counts them on the server side.
"""

from __future__ import annotations

import itertools
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from tepdist_tpu_torch.core.tree import tree_leaves
from tepdist_tpu_torch.models.gpt2 import GPT2Config
from tepdist_tpu_torch.rpc.client import TepdistClient
from tepdist_tpu_torch.serving.engine import TERMINAL
from tepdist_tpu_torch.serving.kv_cache import config_to_spec
from tepdist_tpu_torch.telemetry import flight, metrics


class ServeOverloadError(RuntimeError):
    """Every replica refused a submit (breaker open, draining, or over
    its shed watermark). The caller should back off — the fleet said so
    explicitly; hammering retries is what the watermark exists to
    prevent."""


class _Breaker:
    """Per-replica circuit breaker (closed -> open -> half-open)."""

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        self.failures = 0
        self.state = "closed"
        self._open_until = 0.0

    def allow(self) -> bool:
        if self.state == "closed":
            return True
        if time.monotonic() >= self._open_until:
            # One probe rides through; its outcome decides the state.
            self.state = "half-open"
            return True
        return False

    def record_success(self) -> None:
        self.failures = 0
        self.state = "closed"

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == "half-open" or self.failures >= self.threshold:
            if self.state != "open":
                metrics().counter("serve_breaker_trips").inc()
            self.state = "open"
            self._open_until = time.monotonic() + self.cooldown_s


class ServeClient:
    """One servable, placed on every worker, requests round-robined."""

    def __init__(self, addresses: Optional[Sequence[str]] = None,
                 clients: Optional[Sequence[TepdistClient]] = None,
                 breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 1.0,
                 prefix_affinity: bool = False,
                 page_size: int = 16):
        if clients is not None:
            self.clients = list(clients)
            self._own_clients = False
        else:
            self.clients = [TepdistClient(a) for a in (addresses or ())]
            self._own_clients = True
        if not self.clients:
            raise ValueError("ServeClient needs addresses or clients")
        self._placements: List[Tuple[TepdistClient, str]] = []
        self._rr = itertools.count()
        self._where: Dict[str, Tuple[TepdistClient, str]] = {}
        self._uid = uuid.uuid4().hex[:8]
        self._rid_seq = itertools.count(1)
        self._breaker_threshold = breaker_threshold
        self._breaker_cooldown_s = breaker_cooldown_s
        self.breakers: List[_Breaker] = []
        self._drained: set = set()        # replica indices taken out
        # Opt-in PREFIX-AFFINE routing (off by default: tests and
        # existing callers depend on pure round-robin): repeat prompts
        # sharing a first page_size-token chunk land on the replica
        # whose PrefixCache already holds those pages.
        self.prefix_affinity = bool(prefix_affinity)
        self.page_size = int(page_size)
        self._affinity: Dict[bytes, int] = {}

    # -- lifecycle ------------------------------------------------------
    def load(self, params, cfg: GPT2Config, *, slots: int = 4,
             max_len: Optional[int] = None,
             buckets: Optional[Sequence[int]] = None,
             max_queue: int = 64, name: str = "servable",
             max_restarts: int = 3, shed_high: Optional[int] = None,
             shed_low: Optional[int] = None, kv_mode: str = "paged",
             page_size: int = 16, n_pages: Optional[int] = None,
             hbm_budget_bytes: Optional[float] = None,
             prefix_cache: bool = True,
             prefill_chunk: Optional[int] = None) -> List[str]:
        """Install the model on every worker; returns per-worker ids."""
        spec = config_to_spec(cfg)
        leaves = list(tree_leaves(params))
        self._placements = [
            (c, c.load_servable(spec, leaves, slots=slots, max_len=max_len,
                                buckets=buckets, max_queue=max_queue,
                                name=name, max_restarts=max_restarts,
                                shed_high=shed_high, shed_low=shed_low,
                                kv_mode=kv_mode, page_size=page_size,
                                n_pages=n_pages,
                                hbm_budget_bytes=hbm_budget_bytes,
                                prefix_cache=prefix_cache,
                                prefill_chunk=prefill_chunk))
            for c in self.clients]
        self.breakers = [_Breaker(self._breaker_threshold,
                                  self._breaker_cooldown_s)
                         for _ in self._placements]
        self._drained.clear()
        return [sid for _, sid in self._placements]

    # -- request surface -----------------------------------------------
    def _update_breaker_gauge(self) -> None:
        metrics().gauge("serve_breaker_open").set(
            sum(1 for b in self.breakers if b.state == "open"))

    def _affinity_key(self, prompt) -> Optional[bytes]:
        """PrefixCache's chunk-0 chain key: blake2b over the first
        ``page_size`` prompt tokens (paged_kv.PrefixCache._keys with an
        empty chain seed). None for prompts shorter than one page."""
        import hashlib
        p = np.asarray(prompt, np.int32).reshape(-1)
        if p.size < self.page_size:
            return None
        chunk = np.ascontiguousarray(p[:self.page_size], np.int32)
        return hashlib.blake2b(chunk.tobytes(),
                               digest_size=16).digest()

    def submit(self, prompt, *, max_new_tokens: int,
               request_id: Optional[str] = None, greedy: bool = True,
               temperature: float = 1.0, top_k: int = 0, seed: int = 0,
               deadline_ms: Optional[float] = None) -> Dict[str, Any]:
        """Round-robin one request onto the next worker, FAILING OVER
        past open breakers, drained replicas, transport errors, and
        overload ("shed"/"draining") answers. Raises ServeOverloadError
        once every replica has refused. Returns the admission answer
        plus the request id to poll with."""
        if not self._placements:
            raise RuntimeError("load() a servable first")
        rid = request_id or f"{self._uid}-{next(self._rid_seq)}"
        flight.record(rid, "submit",
                      prompt_len=int(np.asarray(prompt).size),
                      max_new_tokens=int(max_new_tokens))
        n = len(self._placements)
        key = self._affinity_key(prompt) if self.prefix_affinity else None
        if key is not None and key in self._affinity:
            a = self._affinity[key]
            metrics().counter("prefix_affinity_hits").inc()
            flight.record(rid, "affinity_hit", replica=a)
            order = [a] + [i for i in range(n) if i != a]
        else:
            # Each submit starts one replica further on. (The JAX
            # package draws the counter n times a submit, so with two
            # replicas every submit starts at replica 0: ROADMAP C10.)
            start = next(self._rr) % n
            order = [(start + k) % n for k in range(n)]
        last: Any = None
        for i in order:
            if i in self._drained:
                continue
            br = self.breakers[i]
            if not br.allow():
                continue
            c, sid = self._placements[i]
            try:
                out = dict(c.submit_request(
                    sid, rid, prompt, max_new_tokens=max_new_tokens,
                    greedy=greedy, temperature=temperature, top_k=top_k,
                    seed=seed, deadline_ms=deadline_ms))
            except OSError as e:
                # Transport failure AFTER the per-call retry budget (and
                # TimeoutError, which subclasses OSError): count it
                # against this replica and try the next one.
                br.record_failure()
                if br.state == "open":
                    flight.record(rid, "breaker_open", replica=i)
                self._update_breaker_gauge()
                last = e
                continue
            if out.get("status") in ("shed", "draining"):
                br.record_failure()
                if br.state == "open":
                    flight.record(rid, "breaker_open", replica=i)
                self._update_breaker_gauge()
                last = f"worker {i}: {out}"
                continue
            br.record_success()
            self._update_breaker_gauge()
            if key is not None:
                self._affinity[key] = i
            self._where[rid] = (c, sid)
            out["request_id"] = rid
            flight.record(rid, "placed", replica=i,
                          status=out.get("status"))
            return out
        flight.record(rid, "overload", replicas=n)
        raise ServeOverloadError(
            f"all {n} replicas unavailable or overloaded "
            f"(last: {last})") from (last if isinstance(last, BaseException)
                                     else None)

    def cancel(self, rid: str) -> bool:
        c, sid = self._where[rid]
        return c.cancel_request(sid, rid)

    def drain(self, index: int, wait_ms: float = 30000.0
              ) -> Dict[str, Any]:
        """Gracefully empty replica ``index``: stop its admission, wait
        (up to ``wait_ms``) for its resident slots to finish, then
        resubmit the un-started queued requests it hands back onto the
        remaining replicas — under their ORIGINAL request ids, so the
        submitter's polling handle survives the move. Returns
        {"handed_off": n, "resubmitted": [rids], "failed": [rids]}."""
        c, sid = self._placements[index]
        self._drained.add(index)
        handed = c.drain_servable(sid, wait_ms=wait_ms)
        resubmitted, failed = [], []
        for h in handed:
            rid = h["request_id"]
            try:
                out = self.submit(
                    np.asarray(h["prompt"], np.int32),
                    max_new_tokens=h["max_new_tokens"],
                    request_id=rid, greedy=h.get("greedy", True),
                    temperature=h.get("temperature", 1.0),
                    top_k=h.get("top_k", 0), seed=h.get("seed", 0),
                    deadline_ms=h.get("deadline_ms"))
            except ServeOverloadError:
                failed.append(rid)
                continue
            (resubmitted if out.get("status") in ("queued", "duplicate")
             else failed).append(rid)
        return {"handed_off": len(handed), "resubmitted": resubmitted,
                "failed": failed}

    def poll(self, rids: Optional[Sequence[str]] = None,
             wait_ms: float = 0.0) -> Dict[str, Dict[str, Any]]:
        """One poll round, fanned out per worker. ``rids=None`` polls
        every request this client ever submitted."""
        ids = list(rids) if rids is not None else list(self._where)
        by_place: Dict[Tuple[int, str], List[str]] = {}
        for rid in ids:
            c, sid = self._where[rid]
            by_place.setdefault((id(c), sid), []).append(rid)
        out: Dict[str, Dict[str, Any]] = {}
        for (_, sid), group in by_place.items():
            c = self._where[group[0]][0]
            for r in c.poll_result(sid, group, wait_ms=wait_ms):
                out[r["request_id"]] = r
        return out

    def wait(self, rids: Optional[Sequence[str]] = None,
             timeout_s: float = 120.0,
             poll_ms: float = 200.0) -> Dict[str, Dict[str, Any]]:
        """Poll until every request is terminal (or timeout)."""
        deadline = time.monotonic() + timeout_s
        while True:
            results = self.poll(rids, wait_ms=poll_ms)
            if all(r.get("status") in TERMINAL + ("unknown",)
                   for r in results.values()):
                return results
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"serve requests not terminal after {timeout_s}s: "
                    f"{ {k: v.get('status') for k, v in results.items()} }")

    def generate(self, prompts: Sequence, *, max_new_tokens,
                 greedy: bool = True, temperature: float = 1.0,
                 top_k: int = 0, seeds: Optional[Sequence[int]] = None,
                 timeout_s: float = 120.0) -> List[np.ndarray]:
        """Submit every prompt, wait, and return prompt+generated token
        arrays (int32 [T_i + max_new_i]) — ``sampling.sample()``'s layout
        for a B=1 row. ``max_new_tokens`` may be per-request."""
        n = len(prompts)
        mnts = (list(max_new_tokens) if isinstance(max_new_tokens,
                                                   (list, tuple))
                else [max_new_tokens] * n)
        rids = []
        for i, p in enumerate(prompts):
            out = self.submit(
                p, max_new_tokens=mnts[i], greedy=greedy,
                temperature=temperature, top_k=top_k,
                seed=seeds[i] if seeds is not None else 0)
            if out["status"] not in ("queued", "duplicate"):
                raise RuntimeError(f"submit rejected: {out}")
            rids.append(out["request_id"])
        results = self.wait(rids, timeout_s=timeout_s)
        out = []
        for i, rid in enumerate(rids):
            r = results[rid]
            if r["status"] != "done":
                raise RuntimeError(f"request {rid} ended {r['status']}: "
                                   f"{r.get('error')}")
            out.append(np.concatenate([
                np.asarray(prompts[i], np.int32).reshape(-1),
                np.asarray(r["tokens"], np.int32)]))
        return out

    # -- observability --------------------------------------------------
    def dump_trace(self, path: Optional[str] = None) -> Optional[str]:
        from tepdist_tpu_torch.telemetry.export import dump_merged_trace
        return dump_merged_trace(self.clients, path, name="serve_trace")

    def close(self) -> None:
        if self._own_clients:
            for c in self.clients:
                c.close()
