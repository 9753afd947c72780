"""In-process RPC transport: a worker fleet without gRPC (the port of the
JAX package's ``rpc/inproc.py``; the card's machine has no ``grpcio``, so
the card runs the service through this transport).

Reference parity: NONE (deliberate surplus). The reference can only
exercise its RPC surface against real server processes; this module
registers ``TepdistServicer`` instances under ``inproc:<port>`` addresses
so the whole client/server stack — ``TepdistClient``, the distributed
pipeline session, peer-to-peer raw pushes — runs unchanged inside one
process. That makes chaos testing cheap enough for tier-1: faults inject
at the same stub boundary as the gRPC transport, and a two-worker fleet
spins up in milliseconds with no sockets or subprocesses.

``TepdistClient`` (rpc/client.py) selects this stub automatically for any
address starting with ``inproc:``; ``WorkerSpec(ip="inproc", port=N)``
makes cluster specs route here with no other changes.

Error mapping mirrors gRPC: a servicer handler that raises surfaces as
``retry.ServerError`` (the INTERNAL analogue, fatal); an unregistered
address raises ``ConnectionError`` (the UNAVAILABLE analogue, retryable).
Injected faults from the active FaultPlan pass through as themselves
(retryable ConnectionErrors).
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

from tepdist_tpu_torch.rpc import protocol, retry
from tepdist_tpu_torch.runtime import faults
from tepdist_tpu_torch.telemetry import ledger as wire_ledger
from tepdist_tpu_torch.telemetry import metrics, span

_SERVICERS: Dict[str, object] = {}
_LOCK = threading.Lock()
# Fresh ports per cluster so addresses never collide across tests.
_NEXT_PORT = itertools.count(1)


def register_servicer(address: str, servicer) -> None:
    with _LOCK:
        _SERVICERS[address] = servicer


def unregister_servicer(address: str) -> None:
    """Drop the servicer at ``address``; a group-form servicer's rank
    processes end with it (``TepdistServicer.close``)."""
    with _LOCK:
        servicer = _SERVICERS.pop(address, None)
    if getattr(servicer, "rank_group", None) is not None:
        servicer.close()


def resolve(address: str):
    with _LOCK:
        servicer = _SERVICERS.get(address)
    if servicer is None:
        raise ConnectionError(f"no in-proc servicer at {address!r}")
    return servicer


class InProcStub:
    """Drop-in for ``GRPCStub`` dispatching to a registered servicer."""

    def __init__(self, address: str):
        self.address = address

    def call(self, method: str, payload: bytes,
             timeout: Optional[float] = None,
             max_attempts: Optional[int] = None) -> bytes:
        timeout = retry.deadline_for(method, timeout)
        t0 = time.perf_counter()
        # Ledger client scope here (not TepdistClient) so direct stub
        # users — worker_plan's peer pushes — are accounted too.
        with wire_ledger.client_scope(method), \
                span(f"rpc:{method}", cat="rpc", addr=self.address,
                     req_bytes=len(payload)) as sp:
            resp = retry.call_with_retry(self._call_once, method, payload,
                                         timeout, max_attempts=max_attempts)
            sp.set(resp_bytes=len(resp))
        m = metrics()
        m.histogram(f"rpc_ms:{method}").observe(
            (time.perf_counter() - t0) * 1e3)
        m.counter(f"rpc_bytes_out:{method}").inc(len(payload))
        m.counter(f"rpc_bytes_in:{method}").inc(len(resp))
        return resp

    def _call_once(self, method: str, payload: bytes,
                   timeout: float) -> bytes:
        servicer = resolve(self.address)
        ti = getattr(servicer, "task_index", None)
        plan = faults.active()
        action = None
        if plan is not None:
            if plan.is_crashed(ti):
                raise ConnectionError(
                    f"worker {ti} crashed (injected worker_crash)")
            if plan.has_crash_rule(ti) and method in ("ExecutePlan",
                                                      "ExecuteRemotePlan",
                                                      "ExecuteStepSlice"):
                try:
                    # peek_header: ledger-free — the handler's own unpack
                    # is the one byte-accounted parse of this request.
                    step = protocol.peek_header(payload).get("step")
                except Exception:  # noqa: BLE001 — malformed = no step
                    step = None
                if plan.crash_on_step(ti, step):
                    raise ConnectionError(
                        f"worker {ti} crashed (injected worker_crash)")
            action = plan.rpc_action(method, ti)
            if action == "drop_request":
                raise faults.InjectedFault(
                    f"{method} request to worker {ti} dropped",
                    kind="rpc_drop")
        try:
            # The handler runs on the CALLER's thread: the server scope
            # nests inside the client scope and inherits its step tag, so
            # in-proc handler time lands in the right step with no header
            # plumbing.
            with wire_ledger.server_scope(method):
                resp = getattr(servicer, method)(payload, None)
        except faults.InjectedFault:
            raise                     # server-side injection: retryable
        except (ConnectionError, TimeoutError):
            raise                     # nested transport errors propagate
        except retry.StaleEpochError:
            raise                     # epoch fence: typed, already fatal
        except Exception as e:
            # gRPC-INTERNAL analogue: application failure, fatal.
            raise retry.ServerError(
                f"{method} failed on worker {ti}: {e!r}") from e
        if action == "drop_response":
            raise faults.InjectedFault(
                f"{method} response from worker {ti} dropped",
                kind="rpc_drop")
        return resp

    def wait_ready(self, timeout: float = 30.0) -> None:
        resolve(self.address)

    def close(self) -> None:
        pass


def make_inproc_cluster(n: int, devices=None) -> Tuple[object, List[object]]:
    """Spin up ``n`` in-process workers: returns (ClusterSpec, servicers).
    Call ``close_inproc_cluster`` when done to unregister them."""
    from tepdist_tpu_torch.core.cluster_spec import ClusterSpec, WorkerSpec
    from tepdist_tpu_torch.rpc.server import TepdistServicer

    specs, servicers = [], []
    for i in range(n):
        port = next(_NEXT_PORT)
        servicer = TepdistServicer(devices, task_index=i)
        register_servicer(f"inproc:{port}", servicer)
        specs.append(WorkerSpec(ip="inproc", port=port,
                                device_ids=[0], task_index=i))
        servicers.append(servicer)
    return ClusterSpec(specs), servicers


def close_inproc_cluster(cluster) -> None:
    for w in cluster.workers:
        unregister_servicer(w.address)
