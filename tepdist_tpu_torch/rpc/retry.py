"""RPC retry policy: backoff, per-verb deadlines, error classification (a
copy of the JAX package's ``rpc/retry.py``; faults come from the port's
``runtime/faults.py``).

Reference parity: NONE (deliberate surplus — the reference client treats
any gRPC error as a CHECK failure; SURVEY §5.3). Production MPMD runtimes
treat the dispatch/transfer plane as unreliable: single-step operations
are idempotent and retryable (cf. arXiv:2412.14374 §4), so a dropped
packet costs one backoff, not a checkpoint rollback.

Classification contract:

  * transport errors (gRPC UNAVAILABLE, ``ConnectionError`` — which
    includes injected faults — ``OSError``) are always retryable: either
    the request never reached the server, or the response was lost and
    the server dedups the replay via the idempotency token in the header
    (rpc/client.py / rpc/server.py).
  * deadline expiries (gRPC DEADLINE_EXCEEDED, ``TimeoutError``) are
    retryable EXCEPT for verbs in ``NO_DEADLINE_RETRY``: an execute verb
    may still be running server-side when the client's deadline fires —
    a blind replay would race the original execution (the master's
    step-level recovery fences with AbortStep first instead), and a Ping
    deadline IS the unresponsive signal the HealthMonitor's miss counter
    exists to count.
  * ``ServerError`` (the server's handler raised — the in-proc analogue
    of gRPC INTERNAL) and everything else is fatal: the request arrived
    and failed deterministically; replaying it replays the failure.

Both stubs (``GRPCStub`` and ``InProcStub``) route every call through
``call_with_retry``; retries emit ``rpc_retries`` (+ per-verb) counters.
"""

from __future__ import annotations

import dataclasses
import random
import time
from typing import Callable, List, Optional

from tepdist_tpu_torch.telemetry import ledger as wire_ledger
from tepdist_tpu_torch.telemetry import metrics

# Per-verb deadlines (seconds) replacing the old blanket 300 s default:
# control verbs fail fast, data verbs get transfer-sized budgets, compile/
# execute verbs keep long budgets (BuildExecutionPlan runs the planner +
# XLA compile). ``stub.call(timeout=None)`` resolves from this table.
DEADLINES = {
    "Ping": 10.0,
    "AbortStep": 15.0,
    "GetTelemetry": 30.0,
    # Delta polls are small and frequent (watchtower interval): a poll
    # that cannot answer in 15 s is itself a straggler signal.
    "GetTelemetryDelta": 15.0,
    "InitMeshTopology": 30.0,
    "TransferVarArgMap": 30.0,
    "TransferToServerHost": 120.0,
    "TransferHostRawData": 120.0,
    "TransferModuleAndDefCtx": 120.0,
    "DispatchPlan": 120.0,
    "FetchResourceVars": 300.0,
    "DoRemoteSave": 300.0,
    "DoRemoteRestore": 300.0,
    "ExecutePlan": 600.0,
    "ExecuteRemotePlan": 600.0,
    "ExecuteStepSlice": 600.0,
    "BuildExecutionPlan": 900.0,
    # Serving: LoadServable ships params + warms compiles; PollResult's
    # budget is on top of the client-requested long-poll wait.
    "LoadServable": 300.0,
    "SubmitRequest": 30.0,
    "PollResult": 60.0,
    "CancelRequest": 15.0,
    # Drain's budget is on top of the client-requested slot-finish wait
    # (rpc/client.py adds wait_ms to the timeout, like PollResult).
    "Drain": 60.0,
    # Live migration: FetchShard is a pure read sized like a
    # variable transfer; AdoptShard pulls + assembles + installs a whole
    # destination shard set (nested FetchShards or checkpoint reads).
    "FetchShard": 120.0,
    "AdoptShard": 300.0,
    # Disaggregated serving: ExportPages is a pure KV-page read
    # sized like FetchShard; AdoptPages pulls + installs a whole request's
    # page set (nested ExportPages); ExecuteServableSlice runs one stage
    # step of a sharded servable (execute-class budget).
    "ExportPages": 120.0,
    "AdoptPages": 300.0,
    "ExecuteServableSlice": 600.0,
}
DEFAULT_DEADLINE = 300.0

# Verbs whose deadline expiry must NOT be blindly replayed (see module
# docstring). Transport errors on these verbs are still retried — the
# server-side idempotency cache absorbs an applied-but-unacknowledged
# replay.
NO_DEADLINE_RETRY = {"ExecutePlan", "ExecuteRemotePlan",
                     "ExecuteStepSlice", "Ping",
                     # AdoptShard fans out nested FetchShards and may
                     # still be assembling when the deadline fires; a
                     # blind replay would race the original (the idem
                     # cache only absorbs COMPLETED originals). FetchShard
                     # stays deadline-retryable: it is a pure read.
                     "AdoptShard",
                     # AdoptPages mirrors AdoptShard (nested ExportPages
                     # pulls may still be assembling at the deadline), and
                     # ExecuteServableSlice is an execute verb: a blind
                     # replay would race the original stage step.
                     # ExportPages stays deadline-retryable: the gather is
                     # a pure read and the release is state-idempotent.
                     "AdoptPages", "ExecuteServableSlice"}


def deadline_for(method: str, override: Optional[float] = None) -> float:
    if override is not None:
        return override
    return DEADLINES.get(method, DEFAULT_DEADLINE)


class ServerError(RuntimeError):
    """The server's handler raised (application failure) — fatal, never
    retried. The in-proc transport's analogue of gRPC INTERNAL."""


class StaleEpochError(ServerError):
    """Epoch fence: a mutating verb carried a ``master_epoch``
    older than the one this worker has already latched — the sender is a
    wedged-then-revived old master and must NOT mutate fleet state.
    Fatal by construction (a retry replays the same stale epoch); the
    rejected handler guarantees no state changed before raising.

    Both transports preserve the type: the in-proc stub re-raises it
    unwrapped, and the gRPC stub re-types INTERNAL aborts whose details
    carry the ``STALE_EPOCH`` marker (see ``parse_stale_epoch``)."""

    MARKER = "STALE_EPOCH"

    def __init__(self, message: str, *, seen: Optional[int] = None,
                 current: Optional[int] = None):
        super().__init__(message)
        self.seen = seen          # the stale epoch the request carried
        self.current = current    # the epoch the worker has latched


def parse_stale_epoch(details: str) -> Optional[StaleEpochError]:
    """Re-type a gRPC INTERNAL's repr'd details back into a
    ``StaleEpochError`` when the marker rode along (wire format:
    ``... STALE_EPOCH seen=<n> current=<m> ...``)."""
    if StaleEpochError.MARKER not in details:
        return None
    seen = current = None
    for tok in details.replace("'", " ").replace('"', " ").split():
        if tok.startswith("seen="):
            try:
                seen = int(tok[5:].rstrip(",)"))
            except ValueError:
                pass
        elif tok.startswith("current="):
            try:
                current = int(tok[8:].rstrip(",)"))
            except ValueError:
                pass
    return StaleEpochError(details, seen=seen, current=current)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with multiplicative jitter."""

    max_attempts: int = 5
    base_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.5        # delay *= 1 + jitter * U(-1, 1)

    def backoff_schedule(self, attempts: Optional[int] = None,
                         rng: Optional[random.Random] = None
                         ) -> List[float]:
        """Sleep durations between attempts (attempts-1 entries)."""
        n = (self.max_attempts if attempts is None else attempts) - 1
        rng = rng or random
        out = []
        for k in range(max(n, 0)):
            d = min(self.base_s * self.multiplier ** k, self.max_backoff_s)
            if self.jitter:
                d *= 1.0 + self.jitter * (rng.random() * 2.0 - 1.0)
            out.append(d)
        return out


DEFAULT_POLICY = RetryPolicy()


def _is_deadline_exc(exc: BaseException) -> bool:
    if isinstance(exc, TimeoutError):
        return True
    try:
        import grpc
    except Exception:  # noqa: BLE001 — grpc optional for in-proc use
        return False
    return (isinstance(exc, grpc.RpcError)
            and exc.code() == grpc.StatusCode.DEADLINE_EXCEEDED)


def _is_transport_exc(exc: BaseException) -> bool:
    # InjectedFault subclasses ConnectionError; ConnectionError subclasses
    # OSError.
    if isinstance(exc, OSError):
        return True
    try:
        import grpc
    except Exception:  # noqa: BLE001
        return False
    return (isinstance(exc, grpc.RpcError)
            and exc.code() == grpc.StatusCode.UNAVAILABLE)


def is_retryable(exc: BaseException, method: str) -> bool:
    if isinstance(exc, ServerError):
        return False
    # Deadline first: TimeoutError subclasses OSError, so the transport
    # check would otherwise classify a deadline expiry as transport loss.
    if _is_deadline_exc(exc):
        return method not in NO_DEADLINE_RETRY
    if _is_transport_exc(exc):
        return True
    return False


def call_with_retry(send: Callable[[str, bytes, float], bytes],
                    method: str, payload: bytes, timeout: float,
                    policy: Optional[RetryPolicy] = None,
                    max_attempts: Optional[int] = None,
                    rng: Optional[random.Random] = None) -> bytes:
    """Invoke ``send(method, payload, timeout)`` under the retry policy.
    ``max_attempts=1`` disables retries for this call (e.g. fire-and-
    forget aborts where the caller has its own fallback)."""
    policy = policy or DEFAULT_POLICY
    attempts = max_attempts if max_attempts is not None \
        else policy.max_attempts
    if rng is None:
        # Under an active (seeded) fault plan, jitter is the one input
        # that would make a chaos run non-reproducible — draw it from the
        # plan's dedicated retry RNG instead of the global random module.
        from tepdist_tpu_torch.runtime import faults
        plan = faults.active()
        if plan is not None:
            rng = plan.retry_rng
    delays = policy.backoff_schedule(attempts, rng=rng)
    for attempt in range(attempts):
        try:
            return send(method, payload, timeout)
        except Exception as e:  # noqa: BLE001 — classified below
            if attempt >= attempts - 1 or not is_retryable(e, method):
                raise
            m = metrics()
            m.counter("rpc_retries").inc()
            m.counter(f"rpc_retries:{method}").inc()
            led = wire_ledger.active()
            if led is not None:
                # Backoff sleep is the client-side queue wait the ledger
                # charges against the verb.
                led.record_retry(method, delays[attempt])
            time.sleep(delays[attempt])
    raise AssertionError("unreachable")  # pragma: no cover
