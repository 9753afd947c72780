"""Durable control-plane WAL: crash-safe master state (the port of the
JAX package's ``runtime/controlplane.py``; framework neutral, so the port
keeps its own copy, byte for byte the same journal).

Reference parity: NONE (deliberate surplus). The reference master keeps
the plan, the step watermark, and the serving journal in process memory;
a master crash loses the run even though every worker still holds the
variables, the compiled plan, and the committed optimizer state. This
module makes master death a recoverable event: every control-plane
decision is logged to a write-ahead journal *before* (or concurrently
with — see the group-commit note) the fleet observes it, and a restarted
master replays the journal to re-adopt the live fleet without re-pushing
a single weight.

Record format (one segment file ``wal-NNNNNN.log``)::

    [u32 len][u32 crc32(payload)][payload: UTF-8 JSON]

both integers little-endian. Records are appended by a single writer
thread that drains the pending queue in batches and issues ONE fsync per
batch (group commit): callers on the step critical path pay a lock +
list append, never an fsync. ``flush()`` blocks until everything
enqueued so far is durable — the session uses it only at plan/epoch
boundaries where durability *orders* an externally visible action.

Durability contract under group commit: the only record whose loss is
possible (the crash beats the fsync) is the tail of the last batch —
for the step watermark that means the re-adopting master resumes at most
one step early, which the workers' completed-step caches absorb
bit-identically (``WorkerPlan._completed``: a replayed step is a cache
hit). Every record whose loss would NOT be absorbed (epoch bumps, plan
dispatches, serving admits) is flushed explicitly by its writer.

Recovery classification (``read_records``):

  * a torn tail — an incomplete header, an incomplete payload, or a
    CRC-mismatched record that is the FINAL record of the LAST segment —
    is dropped, never fatal: it is the half-written record of the crash
    itself (``torn_tail`` in the replay report counts it);
  * a CRC mismatch (or short read) with valid data *after* it, or in any
    non-last segment, is real corruption: typed ``WalCorruptError``
    naming the segment and byte offset. Silently resuming past it would
    resurrect a fleet state that never existed.

Snapshot + truncate: ``snapshot()`` serializes the replayed
``ControlPlaneState``, fsyncs it as ``snap-NNNNNN.json`` (NNNNNN = the
seq of the next segment), rotates to that fresh segment, then unlinks
all older segments and snapshots. Replay = newest valid snapshot + every
segment with seq >= its own.

Counters: ``wal_records``, ``wal_fsyncs``, ``wal_write_errors``
(telemetry/metrics.py); a write failure also raises a ``control_plane``
watchtower alert (the journal going dark is a page, not a log line).
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Optional, Tuple

from tepdist_tpu_torch.telemetry.metrics import metrics

log = __import__("logging").getLogger(__name__)

_HDR = struct.Struct("<II")          # [u32 len][u32 crc32]
_SEG_FMT = "wal-{:06d}.log"
_SNAP_FMT = "snap-{:06d}.json"
# Serving journal states that are terminal (nothing to replay).
_SERVE_TERMINAL = ("delivered", "cancelled", "failed", "expired")


class WalCorruptError(RuntimeError):
    """Mid-journal corruption: a CRC-mismatched or short record with
    valid data following it (or in a non-last segment). ``segment`` is
    the file name, ``offset`` the byte position of the bad record."""

    def __init__(self, segment: str, offset: int, reason: str):
        super().__init__(
            f"WAL corrupt in {segment} at byte {offset}: {reason}")
        self.segment = segment
        self.offset = offset
        self.reason = reason


def _encode(rec: Dict[str, Any]) -> bytes:
    payload = json.dumps(rec, separators=(",", ":"),
                         sort_keys=True).encode("utf-8")
    return _HDR.pack(len(payload), zlib.crc32(payload)) + payload


def _segment_seq(name: str) -> int:
    return int(name.split("-")[1].split(".")[0])


def list_segments(wal_dir: str) -> List[str]:
    try:
        names = os.listdir(wal_dir)
    except FileNotFoundError:
        return []
    return sorted((n for n in names
                   if n.startswith("wal-") and n.endswith(".log")),
                  key=_segment_seq)


def list_snapshots(wal_dir: str) -> List[str]:
    try:
        names = os.listdir(wal_dir)
    except FileNotFoundError:
        return []
    return sorted((n for n in names
                   if n.startswith("snap-") and n.endswith(".json")),
                  key=_segment_seq)


def read_records(wal_dir: str) -> Tuple[List[Dict[str, Any]], int]:
    """Decode every record across all segments in seq order.

    Returns ``(records, torn_tail)`` where ``torn_tail`` counts dropped
    half-written tail records (0 or 1). Raises ``WalCorruptError`` on
    mid-journal corruption (see module docstring for the rule)."""
    segments = list_segments(wal_dir)
    records: List[Dict[str, Any]] = []
    torn = 0
    for si, name in enumerate(segments):
        last_segment = si == len(segments) - 1
        with open(os.path.join(wal_dir, name), "rb") as f:
            data = f.read()
        off = 0
        while off < len(data):
            bad: Optional[str] = None
            end = off
            if off + _HDR.size > len(data):
                bad = "incomplete record header"
                end = len(data)
            else:
                length, crc = _HDR.unpack_from(data, off)
                end = off + _HDR.size + length
                if end > len(data):
                    bad = (f"incomplete payload ({len(data) - off - _HDR.size}"
                           f" of {length} bytes)")
                    end = len(data)
                elif zlib.crc32(data[off + _HDR.size:end]) != crc:
                    bad = "crc mismatch"
            if bad is None:
                try:
                    records.append(
                        json.loads(data[off + _HDR.size:end].decode("utf-8")))
                except (UnicodeDecodeError, json.JSONDecodeError):
                    bad = "undecodable payload"
            if bad is not None:
                # Torn tail iff nothing (valid or not) follows it in the
                # journal: final extent of the final segment.
                if last_segment and end >= len(data):
                    torn = 1
                    break
                raise WalCorruptError(name, off, bad)
            off = end
    return records, torn


# --------------------------------------------------------------------------
# Replayed state


@dataclasses.dataclass
class ControlPlaneState:
    """The master state a WAL replay reconstructs — everything a fresh
    process needs to re-adopt a live fleet (weights stay on the workers).
    """

    epoch: int = 0
    plan_gen: int = 0
    plan_fingerprint: str = ""
    plan_meta: Dict[str, Any] = dataclasses.field(default_factory=dict)
    # task_index -> address, as of the last plan/membership record.
    members: Dict[int, str] = dataclasses.field(default_factory=dict)
    stage_worker: List[int] = dataclasses.field(default_factory=list)
    step: int = 0                    # commit watermark: steps COMPLETED
    ckpt_steps: List[int] = dataclasses.field(default_factory=list)
    # rid -> serving journal entry: {"state", "gen", "prompt", ...}.
    serving: Dict[str, Dict[str, Any]] = dataclasses.field(
        default_factory=dict)
    records: int = 0                 # records applied (incl. snapshot base)
    torn_tail: int = 0

    def apply(self, rec: Dict[str, Any]) -> None:
        kind = rec.get("kind")
        self.records += 1
        if kind == "epoch":
            self.epoch = max(self.epoch, int(rec["epoch"]))
        elif kind == "plan":
            self.plan_gen = int(rec["plan_gen"])
            self.plan_fingerprint = str(rec.get("fingerprint", ""))
            self.plan_meta = dict(rec.get("plan_meta") or {})
            self.stage_worker = [int(s) for s in rec.get("stage_worker", [])]
            if rec.get("members"):
                self.members = {int(k): str(v)
                                for k, v in rec["members"].items()}
        elif kind == "member":
            if rec.get("action") == "dead":
                self.members.pop(int(rec["task_index"]), None)
            else:
                self.members[int(rec["task_index"])] = str(rec["addr"])
        elif kind == "step":
            self.step = max(self.step, int(rec["step"]) + 1)
        elif kind == "ckpt":
            s = int(rec["step"])
            if s not in self.ckpt_steps:
                self.ckpt_steps.append(s)
        elif kind == "serve":
            rid = str(rec["rid"])
            ent = self.serving.setdefault(rid, {})
            ent["state"] = str(rec["event"])
            for k, v in rec.items():
                if k not in ("kind", "rid", "event", "ts"):
                    ent[k] = v
        # Unknown kinds are skipped: old masters must replay journals
        # written by newer ones (forward compatibility).

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["members"] = {str(k): v for k, v in self.members.items()}
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ControlPlaneState":
        st = cls()
        for f in dataclasses.fields(cls):
            if f.name in d:
                setattr(st, f.name, d[f.name])
        st.members = {int(k): str(v)
                      for k, v in (d.get("members") or {}).items()}
        return st

    def pending_serving(self) -> List[Tuple[str, Dict[str, Any]]]:
        """Non-terminal serving requests, admission order — what a
        rebuilt supervisor must replay under the original rids."""
        out = [(rid, ent) for rid, ent in self.serving.items()
               if ent.get("state") not in _SERVE_TERMINAL]
        out.sort(key=lambda kv: kv[1].get("seq", 0))
        return out


def replay(wal_dir: str) -> ControlPlaneState:
    """Newest valid snapshot + every later segment -> ControlPlaneState."""
    snaps = list_snapshots(wal_dir)
    state = ControlPlaneState()
    min_seq = -1
    if snaps:
        snap = snaps[-1]
        with open(os.path.join(wal_dir, snap)) as f:
            state = ControlPlaneState.from_dict(json.load(f)["state"])
        min_seq = _segment_seq(snap)
    records, torn = _read_from(wal_dir, min_seq)
    for rec in records:
        state.apply(rec)
    state.torn_tail = torn
    return state


def _read_from(wal_dir: str, min_seq: int
               ) -> Tuple[List[Dict[str, Any]], int]:
    if min_seq < 0:
        return read_records(wal_dir)
    # Same classification as read_records but restricted to segments the
    # snapshot does not cover. Build a scratch view by filtering names.
    segments = [n for n in list_segments(wal_dir)
                if _segment_seq(n) >= min_seq]
    if not segments:
        return [], 0
    all_segments = list_segments(wal_dir)
    if segments == all_segments:
        return read_records(wal_dir)
    # Older segments exist but are superseded; reuse read_records on the
    # full dir (it tolerates them — they end in valid records) and drop
    # their records by re-reading only the relevant ones directly.
    records: List[Dict[str, Any]] = []
    torn = 0
    for si, name in enumerate(segments):
        sub = _SubDirView(wal_dir, segments, si)
        recs, t = sub.read()
        records.extend(recs)
        torn = t
    return records, torn


class _SubDirView:
    """Per-segment decode with the same torn-tail rule, where 'last
    segment' means last of the FILTERED list."""

    def __init__(self, wal_dir: str, segments: List[str], idx: int):
        self.path = os.path.join(wal_dir, segments[idx])
        self.name = segments[idx]
        self.is_last = idx == len(segments) - 1

    def read(self) -> Tuple[List[Dict[str, Any]], int]:
        with open(self.path, "rb") as f:
            data = f.read()
        records: List[Dict[str, Any]] = []
        off = 0
        while off < len(data):
            bad = None
            end = off
            if off + _HDR.size > len(data):
                bad, end = "incomplete record header", len(data)
            else:
                length, crc = _HDR.unpack_from(data, off)
                end = off + _HDR.size + length
                if end > len(data):
                    bad, end = "incomplete payload", len(data)
                elif zlib.crc32(data[off + _HDR.size:end]) != crc:
                    bad = "crc mismatch"
            if bad is None:
                try:
                    records.append(
                        json.loads(data[off + _HDR.size:end].decode("utf-8")))
                except (UnicodeDecodeError, json.JSONDecodeError):
                    bad = "undecodable payload"
            if bad is not None:
                if self.is_last and end >= len(data):
                    return records, 1
                raise WalCorruptError(self.name, off, bad)
            off = end
        return records, 0


# --------------------------------------------------------------------------
# Writer


class ControlPlaneWAL:
    """Append-only journal with a group-commit writer thread.

    ``append()`` enqueues and returns the record's commit seq
    immediately; ``flush(seq)`` blocks until that seq is durable
    (fsync'd). ``append(..., sync=True)`` is the composition. One
    ControlPlaneWAL owns one directory; a second writer on the same dir
    is the split-brain scenario epoch fencing exists to reject, not
    something the file layer arbitrates.
    """

    def __init__(self, wal_dir: str, *,
                 segment_bytes: int = 4 << 20,
                 snapshot_every: int = 0,
                 fsync: bool = True,
                 on_error=None):
        self.dir = wal_dir
        self.segment_bytes = int(segment_bytes)
        self.snapshot_every = int(snapshot_every)
        self._fsync = bool(fsync)
        self._on_error = on_error      # callable(exc) — watchtower hook
        os.makedirs(wal_dir, exist_ok=True)
        segs = list_segments(wal_dir)
        self._seg_seq = _segment_seq(segs[-1]) + 1 if segs else 0
        snaps = list_snapshots(wal_dir)
        if snaps:
            self._seg_seq = max(self._seg_seq,
                                _segment_seq(snaps[-1]) + 1)
        self._f = open(os.path.join(
            wal_dir, _SEG_FMT.format(self._seg_seq)), "ab")
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._pending: List[bytes] = []
        self._next_seq = 0             # seq assigned to the next append
        self._durable_seq = -1         # highest seq known fsync'd
        self._paused = False           # snapshot holds the writer idle
        self._writing = False          # writer is inside _write_batch
        self._records_since_snap = 0
        self._error: Optional[BaseException] = None
        self._closed = False
        self._writer = threading.Thread(
            target=self._writer_loop, name="wal-writer", daemon=True)
        self._writer.start()

    # -- append path -------------------------------------------------------

    def append(self, kind: str, *, sync: bool = False,
               **fields: Any) -> int:
        """Enqueue one record; returns its commit seq. ``sync=True``
        blocks until it is durable (use at ordering boundaries only —
        the step hot path must stay enqueue-only)."""
        rec = dict(fields)
        rec["kind"] = kind
        blob = _encode(rec)
        with self._cv:
            if self._closed:
                raise RuntimeError("WAL is closed")
            seq = self._next_seq
            self._next_seq += 1
            self._pending.append(blob)
            self._cv.notify_all()
        metrics().counter("wal_records").inc()
        if sync:
            self.flush(seq)
        return seq

    def flush(self, seq: Optional[int] = None,
              timeout: float = 30.0) -> None:
        """Block until ``seq`` (default: everything enqueued so far) is
        durable. Raises the writer's error if the journal went dark."""
        with self._cv:
            target = (self._next_seq - 1) if seq is None else seq
            deadline = time.monotonic() + timeout
            while self._durable_seq < target and self._error is None \
                    and not (self._closed and not self._pending):
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"WAL flush timed out waiting for seq {target}")
                self._cv.wait(left)
            if self._error is not None:
                raise RuntimeError("WAL writer failed") from self._error

    def _writer_loop(self) -> None:
        while True:
            with self._cv:
                while (self._paused or not self._pending) \
                        and not self._closed:
                    self._cv.wait()
                batch = self._pending
                self._pending = []
                closed = self._closed
                if not batch and closed:
                    return
                top_seq = self._next_seq - 1
                self._writing = True
            try:
                self._write_batch(batch)
            except Exception as e:  # noqa: BLE001 — journal went dark
                metrics().counter("wal_write_errors").inc()
                log.error("WAL write failed: %r", e)
                with self._cv:
                    self._error = e
                    self._writing = False
                    self._cv.notify_all()
                if self._on_error is not None:
                    try:
                        self._on_error(e)
                    except Exception:  # noqa: BLE001
                        pass
                return
            with self._cv:
                self._durable_seq = top_seq
                self._writing = False
                self._cv.notify_all()
                if closed and not self._pending:
                    return

    def _write_batch(self, batch: List[bytes]) -> None:
        self._f.write(b"".join(batch))
        self._f.flush()
        if self._fsync:
            os.fsync(self._f.fileno())
            metrics().counter("wal_fsyncs").inc()
        self._records_since_snap += len(batch)
        if self._f.tell() >= self.segment_bytes:
            self._rotate()

    def _rotate(self) -> None:
        self._f.close()
        self._seg_seq += 1
        self._f = open(os.path.join(
            self.dir, _SEG_FMT.format(self._seg_seq)), "ab")

    # -- snapshot + truncate ----------------------------------------------

    def maybe_snapshot(self) -> bool:
        """Snapshot iff ``snapshot_every`` records accumulated since the
        last one (0 disables). Called off the hot path (e.g. after
        autosave)."""
        if (self.snapshot_every
                and self._records_since_snap >= self.snapshot_every):
            self.snapshot()
            return True
        return False

    def snapshot(self) -> str:
        """Serialize the current replayed state, fsync it, rotate to a
        fresh segment, unlink everything the snapshot supersedes.
        Appends arriving mid-snapshot stay queued (the writer is held
        idle) and land in the fresh segment — replayed on top of the
        snapshot, never lost with the truncated ones."""
        self.flush()
        with self._cv:
            self._paused = True
            while self._writing:
                self._cv.wait()
        try:
            state = replay(self.dir)
            next_seq = self._seg_seq + 1
            snap_name = _SNAP_FMT.format(next_seq)
            tmp = os.path.join(self.dir, snap_name + ".tmp")
            with open(tmp, "w") as f:
                json.dump({"state": state.to_dict(),
                           "through_segment": self._seg_seq}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, os.path.join(self.dir, snap_name))
            self._f.close()
            self._seg_seq = next_seq
            self._f = open(os.path.join(
                self.dir, _SEG_FMT.format(next_seq)), "ab")
            for name in list_segments(self.dir):
                if _segment_seq(name) < next_seq:
                    os.unlink(os.path.join(self.dir, name))
            for name in list_snapshots(self.dir)[:-1]:
                os.unlink(os.path.join(self.dir, name))
        finally:
            with self._cv:
                self._paused = False
                self._records_since_snap = 0
                self._cv.notify_all()
        return snap_name

    # -- lifecycle ---------------------------------------------------------

    def close(self) -> None:
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        self._writer.join(timeout=10.0)
        try:
            self._f.close()
        except Exception:  # noqa: BLE001
            pass

    def __enter__(self) -> "ControlPlaneWAL":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# --------------------------------------------------------------------------
# Convenience: session-facing log helpers (thin, but they pin the schema
# in ONE place so writer and replayer cannot drift).


def log_epoch(wal: ControlPlaneWAL, epoch: int) -> None:
    wal.append("epoch", epoch=int(epoch), sync=True)


def log_plan(wal: ControlPlaneWAL, *, plan_gen: int, fingerprint: str,
             plan_meta: Optional[Dict[str, Any]],
             stage_worker: List[int],
             members: Dict[int, str]) -> None:
    wal.append("plan", sync=True, plan_gen=int(plan_gen),
               fingerprint=str(fingerprint),
               plan_meta=plan_meta or {},
               stage_worker=[int(s) for s in stage_worker],
               members={str(k): v for k, v in members.items()})


def log_member(wal: ControlPlaneWAL, task_index: int, addr: str,
               action: str = "join") -> None:
    wal.append("member", task_index=int(task_index), addr=str(addr),
               action=action, sync=True)


def log_step(wal: ControlPlaneWAL, step: int) -> None:
    # Hot path: enqueue only. Losing the tail record resumes one step
    # early; the worker completed-step cache replays it bit-identically.
    wal.append("step", step=int(step))


def log_ckpt(wal: ControlPlaneWAL, step: int) -> None:
    wal.append("ckpt", step=int(step))


def log_serve(wal: ControlPlaneWAL, rid: str, event: str,
              sync: bool = False, **fields: Any) -> None:
    wal.append("serve", rid=str(rid), event=str(event), sync=sync,
               **fields)
