"""One rank a device behind one servicer: the group form of
``TepdistServicer``.

A servicer over several devices that can each hold a rank of their own
(distinct cards under NCCL, CPU devices under gloo) starts one rank
process a device (``python -m tepdist_tpu_torch.rpc.rank_group``, one
torch thread each, a free localhost port for the group's rendezvous).
Each rank runs a one-device ``TepdistServicer`` in a world of
``len(devices)`` ranks: the multi-rank server, whose explore cuts
pipeline stages over the world's ranks and may split a stage over TP.
The servicer the client talks to holds no process group: it forwards
every verb's request bytes to all ranks, in one order under its lock,
over one authenticated localhost connection a rank (no gRPC: the card's
machine has none), and answers with rank 0's reply once every rank has
answered and they agree on plan handles and losses (as
``MultiHostSession`` checks). A verb waits for the one before it, a
``Ping`` behind a running step too. The ranks are new interpreters, not
forks: the caller's main module is never run again, and each rank gets
the caller's ``ServiceEnv`` values.

A repeated card (``[cuda:0] * 4``) stays one process: NCCL refuses two
ranks on one card.

Failures: a rank that raises sends its traceback. When every rank has
answered the group stays usable and the caller gets the first traceback;
when a rank is still busy ``RANK_ERROR_GRACE_S`` after another raised (it
waits in a collective the raising rank never joined), or a rank exits, or
no answer comes within ``VERB_TIMEOUT_S``, the ranks are killed, the
caller gets the traceback, and the servicer refuses further verbs.
``close()`` asks each rank to stop its engines and leave its group, and
kills what is left after ``CLOSE_TIMEOUT_S``.
"""

from __future__ import annotations

import os
import secrets
import socket
import struct
import subprocess
import sys
import threading
import time
import traceback
from multiprocessing.connection import (Connection, answer_challenge,
                                        deliver_challenge)
from multiprocessing.connection import wait as wait_any
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

# Seconds the other ranks get to answer after one raised (a rank that
# raised before a collective leaves its peers waiting in it).
RANK_ERROR_GRACE_S = 10.0
# Seconds a verb may run on the ranks (a full-width plan compiles for
# minutes on the card).
VERB_TIMEOUT_S = 3600.0
# Seconds the ranks get to start (import torch, join the group).
START_TIMEOUT_S = 300.0
CLOSE_TIMEOUT_S = 30.0
# Relative gap allowed between the ranks' replicated losses.
LOSS_RTOL = 1e-5
# The environment variable that carries the connection's key to a rank.
_AUTHKEY_ENV = "TEPDIST_RANK_AUTHKEY"


def takes_group_form(devices: Sequence[torch.device]) -> bool:
    """Whether a servicer over ``devices`` forms one rank a device: two or
    more CPU devices (gloo), or two or more distinct cards (NCCL). A
    repeated card stays one process."""
    if len(devices) < 2:
        return False
    types = {d.type for d in devices}
    if types == {"cpu"}:
        return True
    if types == {"cuda"}:
        return len({d.index for d in devices}) == len(devices)
    return False


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _serve(conn: Connection) -> None:
    """A rank process: receive ``(rank, world, port, device, task_index,
    env)``, join the world, then serve the head's messages (``(verb,)``
    then the request bytes, ``("call", fn, args)``, or None to stop); a
    verb's reply is ``("bytes", None)`` then its bytes."""
    import torch.distributed as dist

    from tepdist_tpu_torch.core.service_env import ServiceEnv
    from tepdist_tpu_torch.rpc import protocol

    rank, world, port, device, task_index, env = conn.recv()
    torch.set_num_threads(1)
    ServiceEnv.reset(env)
    dev = torch.device(device)
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        from tepdist_tpu_torch.rpc.server import TepdistServicer, init_world

        init_world(f"127.0.0.1:{port}", world, rank, dev)
        servicer = TepdistServicer([dev], task_index=task_index)
        # Checkpoints go through rank 0: the others gather with it and
        # write nothing.
        servicer.ckpt_writer = rank == 0
        conn.send(("ok", None))
    except Exception:  # noqa: BLE001 — reported to the head
        conn.send(("error", f"rank {rank}: {traceback.format_exc()}"))
        return
    while True:
        try:
            msg = conn.recv()
        except EOFError:
            break
        if msg is None:
            break
        try:
            if msg[0] == "call":
                conn.send(("ok", msg[1](*msg[2])))
                continue
            resp = getattr(servicer, msg[0])(conn.recv_bytes(), None)
            if isinstance(resp, protocol.Frames):
                resp = resp.join()
            conn.send(("bytes", None))
            conn.send_bytes(resp)
        except Exception:  # noqa: BLE001 — reported to the head
            conn.send(("error", f"rank {rank}: {traceback.format_exc()}"))
    servicer.close_servables()
    dist.destroy_process_group()


def _first_output(resp: bytes) -> Optional[float]:
    """Output 0 of an ExecutePlan reply as a float when it is one value
    (a loss): the header and the first blob only."""
    from tepdist_tpu_torch.rpc import protocol

    header = protocol.peek_header(resp)
    metas = header.get("outputs") or []
    if not metas or header.get("output_indices", [None])[0] != 0:
        return None
    meta = metas[0]
    if int(torch.Size(meta.get("shape", [])).numel()) != 1:
        return None
    mv = memoryview(resp)
    (hlen,) = struct.unpack_from("<I", mv, 4)
    off = 12 + hlen
    (n,) = struct.unpack_from("<Q", mv, off)
    blob = bytes(mv[off + 8:off + 8 + n])
    return float(protocol.decode_literal(meta, blob).reshape(()))


class _RankError(RuntimeError):
    """A rank raised and every rank answered: the group stays usable."""


class RankGroup:
    """The rank processes of a group-form servicer and the connections to
    them. The ranks start here; ``forward`` waits for them the first time
    (so the client's tracing overlaps their start)."""

    def __init__(self, devices: Sequence[torch.device], task_index: int):
        from tepdist_tpu_torch.core.service_env import ServiceEnv

        self.devices = list(devices)
        self._task_index = task_index
        self._env = ServiceEnv.get().values()
        self._authkey = secrets.token_bytes(16)
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(len(self.devices))
        host, port = self._sock.getsockname()
        self._port = _free_port()        # the group's rendezvous
        env = dict(os.environ, **{_AUTHKEY_ENV: self._authkey.hex()})
        # The caller's import path, so the ranks import what it imports.
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in [os.getcwd()] + sys.path if p)
        self._procs = [subprocess.Popen(
            [sys.executable, "-m", "tepdist_tpu_torch.rpc.rank_group",
             host, str(port)], env=env, stdin=subprocess.DEVNULL)
            for _ in self.devices]
        self._conns: List[Connection] = []
        self._lock = threading.Lock()
        self._started = False
        self._failed: Optional[str] = None

    @property
    def size(self) -> int:
        return len(self._procs)

    def alive(self) -> List[bool]:
        return [p.poll() is None for p in self._procs]

    # -- start ----------------------------------------------------------
    def _accept(self) -> None:
        """Each rank's connection, authenticated, in rank order (the
        ranks connect in any order; rank r is the r-th to connect)."""
        deadline = time.monotonic() + START_TIMEOUT_S
        self._sock.settimeout(1.0)
        while len(self._conns) < self.size:
            dead = [r for r, p in enumerate(self._procs)
                    if p.poll() is not None]
            if dead or time.monotonic() > deadline:
                raise RuntimeError(
                    f"ranks {dead} exited before joining" if dead else
                    f"the ranks did not connect in {START_TIMEOUT_S:.0f} s")
            try:
                sock, _ = self._sock.accept()
            except socket.timeout:
                continue
            sock.settimeout(None)
            conn = Connection(sock.detach())
            deliver_challenge(conn, self._authkey)
            answer_challenge(conn, self._authkey)
            rank = len(self._conns)
            conn.send((rank, self.size, self._port,
                       str(self.devices[rank]), self._task_index, self._env))
            self._conns.append(conn)
        self._sock.close()

    def _ensure_started(self) -> None:
        if self._failed is not None:
            raise RuntimeError(f"this servicer's rank group is stopped "
                               f"({self._failed})")
        if not self._started:
            try:
                self._roundtrip("start", self._accept, START_TIMEOUT_S)
            except Exception as e:
                self._failed = self._failed or f"start failed: {e}"
                self._kill()
                raise
            self._started = True

    def _roundtrip(self, what: str, send: Callable[[], None],
                   timeout: float) -> List[Any]:
        """``send()`` the message to every rank, then every rank's value;
        a failure that leaves the group unusable (a rank gone or left
        waiting, a start that did not finish) stops it."""
        try:
            send()
            return self._collect(what, timeout)
        except _RankError:
            raise
        except Exception as e:
            self._failed = f"{what} failed: {e}"
            self._kill()
            raise RuntimeError(f"{what} on a group of {self.size} ranks: "
                               f"the group was stopped\n{e}") from e

    # -- replies --------------------------------------------------------
    def _collect(self, what: str, timeout: float) -> List[Any]:
        """Every rank's value for the message just sent. Raises
        ``_RankError`` when a rank raised and every rank answered, and
        ``RuntimeError`` when a rank exited or gave no answer in
        ``timeout`` (in ``RANK_ERROR_GRACE_S`` once another raised)."""
        n = self.size
        replies: List[Any] = [None] * n
        pending = {conn: r for r, conn in enumerate(self._conns)}
        error: Optional[str] = None
        lost = False
        deadline = time.monotonic() + timeout
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            for conn in wait_any(list(pending), timeout=min(left, 1.0)):
                r = pending.pop(conn)
                try:
                    status, value = conn.recv()
                    if status == "bytes":
                        status, value = "ok", conn.recv_bytes()
                except (EOFError, OSError):
                    lost = True
                    status, value = "error", (
                        f"rank {r} exited (code {self._procs[r].poll()}) "
                        f"during {what}")
                replies[r] = value
                if status == "error" and error is None:
                    error = value
                    deadline = min(deadline,
                                   time.monotonic() + RANK_ERROR_GRACE_S)
        if pending or lost:
            ranks = sorted(pending.values())
            raise RuntimeError(error or f"ranks {ranks} gave no answer to "
                               f"{what} in {timeout:.0f} s")
        if error is not None:
            # Every rank answered: the group stays usable.
            raise _RankError(f"{what} failed on a group of {n} ranks:\n"
                             f"{error}")
        return replies

    # -- messages -------------------------------------------------------
    def forward(self, verb: str, request) -> bytes:
        """``verb`` with ``request`` on every rank; rank 0's reply."""
        from tepdist_tpu_torch.rpc import protocol

        if isinstance(request, protocol.Frames):
            request = request.join()

        def send():
            for conn in self._conns:
                conn.send((verb,))
                conn.send_bytes(request)

        with self._lock:
            self._ensure_started()
            replies = self._roundtrip(verb, send, VERB_TIMEOUT_S)
        self._check_agree(verb, replies)
        return replies[0]

    def call_each(self, fn: Callable, *args) -> List[Any]:
        """``fn(*args)`` on every rank, between verbs; each rank's result
        (``fn`` a function of an importable module, its args and result
        picklable: ``rank_stats``, say)."""
        def send():
            for conn in self._conns:
                conn.send(("call", fn, args))

        with self._lock:
            self._ensure_started()
            return self._roundtrip(f"call of {fn.__name__}", send,
                                   VERB_TIMEOUT_S)

    @staticmethod
    def _check_agree(verb: str, replies: List[bytes]) -> None:
        from tepdist_tpu_torch.rpc import protocol

        if verb == "BuildExecutionPlan":
            handles = {protocol.peek_header(r).get("handle")
                       for r in replies}
            if len(handles) != 1:
                raise RuntimeError(f"divergent plan handles across ranks: "
                                   f"{sorted(map(str, handles))}")
        elif verb == "ExecutePlan":
            losses = [_first_output(r) for r in replies]
            if None not in losses and (
                    max(losses) - min(losses)
                    > LOSS_RTOL * (abs(losses[0]) + 1e-9)):
                raise RuntimeError(f"divergent losses across ranks: "
                                   f"{losses}")

    # -- shutdown -------------------------------------------------------
    def _kill(self) -> None:
        for proc in self._procs:
            if proc.poll() is None:
                proc.kill()
        for proc in self._procs:
            proc.wait(timeout=CLOSE_TIMEOUT_S)
        for conn in self._conns:
            conn.close()
        self._sock.close()

    def close(self) -> None:
        """Stop every rank: each stops its engines and leaves the group;
        what is still alive after ``CLOSE_TIMEOUT_S`` is killed."""
        with self._lock:
            if self._failed is None:
                for conn in self._conns:
                    try:
                        conn.send(None)
                    except OSError:
                        pass
            deadline = time.monotonic() + CLOSE_TIMEOUT_S
            for proc in self._procs:
                try:
                    proc.wait(timeout=max(deadline - time.monotonic(), 0.1))
                except subprocess.TimeoutExpired:
                    pass
            self._failed = self._failed or "closed"
            self._kill()


def span_ms(spans: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Milliseconds of ``spans`` (the tracer's snapshot) by category, and
    the window they cover; spans nest (an ``rpc`` span holds the step's
    task spans), so the categories overlap."""
    by_cat: Dict[str, float] = {}
    for sp in spans:
        by_cat[sp["cat"]] = by_cat.get(sp["cat"], 0.0) + sp["dur"] / 1e3
    window = ((max(sp["ts"] + sp["dur"] for sp in spans)
               - min(sp["ts"] for sp in spans)) / 1e3 if spans else None)
    return {"by_category": by_cat, "window_ms": window}


def rank_stats() -> Dict[str, Any]:
    """A rank's kernel launches (by kernel and by kernel and shape) and
    its spans (when tracing) since the last reset, and its card's peak
    memory: ``call_each(rank_stats)`` in a tool."""
    from tepdist_tpu_torch import telemetry
    from tepdist_tpu_torch.ops import flash_attention as fa

    out: Dict[str, Any] = {
        "pid": os.getpid(), "launches": dict(fa.launch_counts),
        "shape_launches": dict(fa.shape_launch_counts),
        "spans": (span_ms(telemetry.tracer().snapshot(clear=True))
                  if telemetry.enabled() else None),
        "peak_bytes": None}
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def reset_rank_stats(trace: bool = False) -> None:
    """Zero a rank's launch counts and its card's peak memory, empty its
    span tracer and turn it on when ``trace`` (off otherwise)."""
    from tepdist_tpu_torch import telemetry
    from tepdist_tpu_torch.ops import flash_attention as fa

    fa.reset_launch_counts()
    telemetry.trace.configure(enabled=trace)
    telemetry.tracer().snapshot(clear=True)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats()


def _main() -> None:
    host, port = sys.argv[1], int(sys.argv[2])
    authkey = bytes.fromhex(os.environ.pop(_AUTHKEY_ENV))
    conn = Connection(socket.create_connection((host, port)).detach())
    answer_challenge(conn, authkey)
    deliver_challenge(conn, authkey)
    _serve(conn)


if __name__ == "__main__":
    _main()
