"""Deterministic fault injection for the RPC/runtime planes (a copy of the
JAX package's ``runtime/faults.py``; in the port the serving engine's
``serve_fault`` and ``engine_crash`` hooks consult it).

Reference parity: NONE (deliberate surplus). The reference's failure story
is "gRPC errors surface as CHECK failures; recovery = checkpoint + restart"
(SURVEY §5.3) — it has no way to *provoke* a failure on demand, so its
recovery path was never testable in CI. This module is the provocation
side of the robustness contract: a seeded ``FaultPlan`` that the client
stubs (gRPC and in-proc), the raw-transfer plane, and the servicer's
``ExecutePlan``/``DispatchPlan`` handlers consult, so every failure mode
the retry/recovery machinery claims to handle is reproducible in a unit
test.

Spec grammar (``TEPDIST_FAULT_SPEC``): semicolon-separated rules, each
``kind:key=val,key=val``. Example::

    rpc_drop:p=0.2,seed=7;rpc_delay:ms=50;worker_crash:step=3,ti=1

Kinds:

  ``rpc_drop``     ``p=`` [``verb=``] [``ti=``] [``seed=``] — client-side:
                   the call raises ``InjectedFault`` either *before* the
                   request is sent (pure loss) or *after* the server
                   processed it (applied-but-unacknowledged: the case that
                   exercises server-side dedup). 50/50, drawn from the
                   plan's seeded RNG.
  ``rpc_delay``    ``ms=`` [``p=``] [``verb=``] [``ti=``] — client-side
                   added latency before the send.
  ``server_fault`` ``p=`` [``verb=``] [``ti=``] — raised inside the
                   servicer handler (the handler half-ran; classified
                   retryable by the in-proc transport).
  ``raw_drop``     ``p=`` [``ti=``] — a raw-transfer put
                   (``TransferHostRawData``) fails server-side before
                   storing; the sender's retry lands it.
  ``worker_crash`` ``step=`` ``ti=`` — the worker becomes permanently
                   unreachable (ConnectionError on every call) from the
                   moment it is asked to execute step >= N. Exercises the
                   permanent/elastic escalation path, not the transient
                   retry path.
  ``serve_fault``  [``op=prefill|decode``] (``step=`` | ``p=``) [``ti=``]
                   — raised inside the serving engine's compute path
                   (serving/engine.py). ``step=N`` fires exactly once, at
                   the Nth matching prefill/decode op this rule observes
                   (deterministic: the engine's scheduler is single-
                   threaded per worker); ``p=`` draws from the plan RNG.
  ``engine_crash`` ``step=`` [``ti=``] — the serving engine dies (its
                   scheduler iteration raises) at its Nth scheduler step.
                   Fires ONCE per rule, so the supervisor-restarted
                   replacement engine is not re-killed at the same step.

``seed=`` on any rule seeds the whole plan (default 0); all probability
draws come from one ``random.Random`` under a lock, so a single-threaded
call sequence is exactly reproducible (the determinism unit test). The
plan also carries ``retry_rng``, a second RNG (derived from the same
seed) that ``rpc/retry.py`` uses for backoff jitter whenever a plan is
active — keeping the fault draw sequence independent of how many retries
happen, and the retry sleeps themselves reproducible. Every fired rule
increments ``fault_injected`` (and ``fault_injected:<kind>``) in the
telemetry registry.

The active plan is parsed lazily from ``TEPDIST_FAULT_SPEC`` on first use;
tests (and tools/chaos_run.py) install one directly with ``configure()``.
With no spec, ``active()`` returns None and every hook is a no-op.
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
import time
from typing import Dict, List, Optional

from tepdist_tpu_torch.telemetry import metrics


class InjectedFault(ConnectionError):
    """A fault manufactured by the active FaultPlan. Subclasses
    ConnectionError so the retry classifier treats it as transport-loss
    (retryable) without special-casing injection anywhere else."""

    def __init__(self, msg: str, kind: str = "injected"):
        super().__init__(msg)
        self.kind = kind


@dataclasses.dataclass
class FaultRule:
    kind: str                      # rpc_drop | rpc_delay | server_fault |
                                   # raw_drop | worker_crash | serve_fault |
                                   # engine_crash
    p: float = 1.0
    verb: Optional[str] = None     # None = any RPC verb (serve_fault: op)
    ti: Optional[int] = None       # None = any worker
    ms: float = 0.0                # rpc_delay only
    step: Optional[int] = None     # worker_crash / serve_fault /
                                   # engine_crash

    def matches(self, verb: Optional[str], ti: Optional[int]) -> bool:
        if self.verb is not None and self.verb != verb:
            return False
        if self.ti is not None and self.ti != ti:
            return False
        return True


class FaultPlan:
    """A parsed, seeded fault specification consulted by the transports."""

    def __init__(self, rules: List[FaultRule], seed: int = 0):
        self.rules = rules
        self.seed = seed
        self._rng = random.Random(seed)
        # Separate stream for retry backoff jitter: retries must not
        # perturb the fault draw sequence (and vice versa) or two chaos
        # runs with different retry counts would diverge.
        self.retry_rng = random.Random(seed ^ 0x5EED0FF5)
        self._lock = threading.Lock()
        self._crashed: set = set()
        self._serve_op_counts: Dict[int, int] = {}   # rule idx -> #ops seen
        self._fired_once: set = set()                # rule idxs (step rules)

    # -- parsing -------------------------------------------------------
    @classmethod
    def parse(cls, spec: Optional[str]) -> Optional["FaultPlan"]:
        if not spec or not spec.strip():
            return None
        rules: List[FaultRule] = []
        seed = 0
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            kind, _, argstr = part.partition(":")
            kind = kind.strip()
            kwargs: Dict[str, object] = {}
            for kv in argstr.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                k, _, v = kv.partition("=")
                k = k.strip()
                v = v.strip()
                if k == "seed":
                    seed = int(v)
                elif k == "p":
                    kwargs["p"] = float(v)
                elif k == "ms":
                    kwargs["ms"] = float(v)
                elif k in ("ti", "step"):
                    kwargs[k] = int(v)
                elif k == "verb":
                    kwargs["verb"] = v
                elif k == "op":
                    # serve_fault's op filter rides the verb field.
                    if v not in ("prefill", "decode"):
                        raise ValueError(
                            f"TEPDIST_FAULT_SPEC: op must be prefill|"
                            f"decode, got {v!r} in {part!r}")
                    kwargs["verb"] = v
                else:
                    raise ValueError(
                        f"TEPDIST_FAULT_SPEC: unknown key {k!r} in {part!r}")
            if kind not in ("rpc_drop", "rpc_delay", "server_fault",
                            "raw_drop", "worker_crash", "serve_fault",
                            "engine_crash"):
                raise ValueError(
                    f"TEPDIST_FAULT_SPEC: unknown fault kind {kind!r}")
            if kind == "worker_crash" and ("step" not in kwargs
                                           or "ti" not in kwargs):
                raise ValueError(
                    "TEPDIST_FAULT_SPEC: worker_crash needs step= and ti=")
            if kind == "engine_crash" and "step" not in kwargs:
                raise ValueError(
                    "TEPDIST_FAULT_SPEC: engine_crash needs step=")
            if kind == "serve_fault" and ("step" not in kwargs
                                          and "p" not in kwargs):
                raise ValueError(
                    "TEPDIST_FAULT_SPEC: serve_fault needs step= or p=")
            rules.append(FaultRule(kind=kind, **kwargs))  # type: ignore
        return cls(rules, seed=seed)

    # -- RNG -----------------------------------------------------------
    def _roll(self, p: float) -> bool:
        with self._lock:
            return self._rng.random() < p

    def _coin(self) -> bool:
        with self._lock:
            return self._rng.random() < 0.5

    def _count(self, kind: str) -> None:
        m = metrics()
        m.counter("fault_injected").inc()
        m.counter(f"fault_injected:{kind}").inc()

    # -- client-side hooks --------------------------------------------
    def rpc_action(self, verb: str, ti: Optional[int] = None
                   ) -> Optional[str]:
        """Consulted by the stubs per call attempt. Applies any matching
        delay inline (sleeps), then returns None, "drop_request" or
        "drop_response" for the attempt."""
        action = None
        for r in self.rules:
            if not r.matches(verb, ti):
                continue
            if r.kind == "rpc_delay" and self._roll(r.p):
                self._count("rpc_delay")
                time.sleep(r.ms / 1e3)
            elif r.kind == "rpc_drop" and action is None and self._roll(r.p):
                self._count("rpc_drop")
                action = "drop_request" if self._coin() else "drop_response"
        return action

    # -- server-side hook ---------------------------------------------
    def server_fault(self, verb: str, ti: Optional[int] = None) -> None:
        """Consulted inside servicer handlers; raises InjectedFault when a
        matching server_fault/raw_drop rule fires."""
        for r in self.rules:
            if r.kind == "server_fault" and r.matches(verb, ti) \
                    and self._roll(r.p):
                self._count("server_fault")
                raise InjectedFault(
                    f"injected server fault in {verb} (worker {ti})",
                    kind="server_fault")
            if (r.kind == "raw_drop" and verb == "TransferHostRawData"
                    and (r.ti is None or r.ti == ti) and self._roll(r.p)):
                self._count("raw_drop")
                raise InjectedFault(
                    f"injected raw-transfer drop (worker {ti})",
                    kind="raw_drop")

    # -- serving hooks -------------------------------------------------
    def serve_op(self, op: str, ti: Optional[int] = None) -> None:
        """Consulted by the serving engine before each prefill/decode
        computation; raises InjectedFault when a matching ``serve_fault``
        rule fires. ``step=N`` rules count only the ops THEY match (op +
        ti filters applied first), so the Nth matching op is deterministic
        regardless of what other workers/ops do."""
        for i, r in enumerate(self.rules):
            if r.kind != "serve_fault" or not r.matches(op, ti):
                continue
            if r.step is not None:
                with self._lock:
                    n = self._serve_op_counts.get(i, 0) + 1
                    self._serve_op_counts[i] = n
                    fire = n == r.step and i not in self._fired_once
                    if fire:
                        self._fired_once.add(i)
            else:
                fire = self._roll(r.p)
            if fire:
                self._count("serve_fault")
                raise InjectedFault(
                    f"injected serve fault in {op} (worker {ti})",
                    kind="serve_fault")

    def engine_crash_on_step(self, ti: Optional[int], step: int) -> bool:
        """Consulted by the serving engine at the top of each scheduler
        iteration (``step`` is the engine's own 1-based counter). A
        matching ``engine_crash`` rule fires exactly once — the
        supervisor's replacement engine restarts its counter but must not
        be re-killed at the same step, or no recovery would ever
        succeed."""
        for i, r in enumerate(self.rules):
            if r.kind != "engine_crash":
                continue
            if r.ti is not None and r.ti != ti:
                continue
            if r.step is not None and step >= r.step:
                with self._lock:
                    if i in self._fired_once:
                        continue
                    self._fired_once.add(i)
                self._count("engine_crash")
                return True
        return False

    # -- crash rules ---------------------------------------------------
    def has_crash_rule(self, ti: Optional[int]) -> bool:
        return any(r.kind == "worker_crash" and r.ti == ti
                   for r in self.rules)

    def is_crashed(self, ti: Optional[int]) -> bool:
        return ti in self._crashed

    def crash_on_step(self, ti: Optional[int], step: Optional[int]) -> bool:
        """Mark ``ti`` crashed when an execute verb for ``step`` >= the
        rule's threshold arrives; returns True if the worker is (now)
        crashed."""
        if ti in self._crashed:
            return True
        if step is None:
            return False
        for r in self.rules:
            if (r.kind == "worker_crash" and r.ti == ti
                    and r.step is not None and step >= r.step):
                with self._lock:
                    self._crashed.add(ti)
                self._count("worker_crash")
                return True
        return False


# -- module-level active plan ---------------------------------------------

_UNSET = object()
_active = _UNSET


def active() -> Optional[FaultPlan]:
    """The process's fault plan: parsed from ``TEPDIST_FAULT_SPEC`` on
    first use (None when unset/empty)."""
    global _active
    if _active is _UNSET:
        _active = FaultPlan.parse(os.environ.get("TEPDIST_FAULT_SPEC", ""))
    return _active


def configure(spec) -> Optional[FaultPlan]:
    """Install a fault plan programmatically: a spec string, a FaultPlan,
    or None to disable injection. Returns the active plan."""
    global _active
    if spec is None or isinstance(spec, FaultPlan):
        _active = spec
    else:
        _active = FaultPlan.parse(spec)
    return _active


def reset() -> None:
    """Forget any installed plan; the next ``active()`` re-reads the env."""
    global _active
    _active = _UNSET
