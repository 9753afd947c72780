"""Wire protocol: message codec + RPC surface definition (the port of the
JAX package's ``rpc/protocol.py``: the same envelope and the same literal
bytes, with literals encoded from and decoded to host ``torch.Tensor``).

Reference parity: the ``XlaService`` proto (reference:
rpc/xla_service.proto:49-199) with TePDist's 12 added RPCs. The TPU build
keeps gRPC as the control plane but replaces protobuf codegen with a compact
self-described envelope (JSON header + length-prefixed raw blobs) — array
payloads travel as raw little-endian bytes, not base64/proto repeated fields.
``tepdist.proto`` in this directory documents the equivalent schema.

RPC surface (method -> reference RPC):
  BuildExecutionPlan    -> BuildExecutionPlan
  ExecutePlan           -> ExecutePlan
  TransferToServerHost  -> TransferToServerHost (variable|input literal)
  TransferHostRawData   -> TransferHostRawData (per-step input slices)
  TransferVarArgMap     -> TransferVarArgMap
  FetchResourceVars     -> FetchResourceVars
  TransferModuleAndDefCtx -> TransferModuleAndDefCtx (master->slave)
  DispatchPlan          -> DispatchPlan (per-worker task lists)
  ExecuteRemotePlan     -> ExecuteRemotePlan
  InitMeshTopology      -> InitRemoteNcclComm (communicator setup -> mesh)
  DoRemoteSave          -> DoRemoteSave
  DoRemoteRestore       -> DoRemoteRestore
  AbortStep             -> (no reference analogue: cancels an in-flight
                           ExecuteRemotePlan's recv waits so mid-step
                           worker death is detected at heartbeat latency,
                           not RPC-timeout latency; header {"reset": true}
                           instead CLEARS the abort latch, keeping the raw
                           store's data, so the master can re-execute the
                           same step after a transient fault)
  Ping                  -> GetDeviceHandles (liveness/metadata)
  GetTelemetry          -> (no reference analogue: pulls the worker's span
                           ring buffer + metrics snapshot, stamped with the
                           worker's clock so the client can align fleets'
                           timelines — telemetry/export.py)
  GetTelemetryDelta     -> (no reference analogue: cursor-based incremental
                           read of the telemetry rings — the caller passes
                           its last-seen per-ring cursors, the server
                           returns only NEW records plus exact drop
                           counters. Non-consuming: snapshots and the
                           final trace dump still see everything. The
                           watchtower poller lives on this verb —
                           telemetry/watchtower.py)
  FetchShard            -> (no reference analogue: live-migration pure
                           read — returns the requested slice of a held
                           variable, or a stage's optimizer slots, as
                           Frames blobs encoded at the caller's
                           ``wire_dtype``. Naturally idempotent; safe to
                           deadline-retry. ``{"found": false}`` when the
                           worker does not hold the key)
  AdoptShard            -> (no reference analogue: live-migration write —
                           the destination worker pulls shard pieces from
                           live peers via nested FetchShard (or from the
                           shared checkpoint dir when no live clean source
                           remains), assembles them (plan_redistribution),
                           and installs variables/opt-state locally.
                           Mutating: carries an idem token, deduped by the
                           server response cache, and classified
                           NO_DEADLINE_RETRY — a retried AdoptShard can
                           never double-apply)
  LoadServable          -> (no reference analogue: ships a model config +
                           params and starts a continuous-batching serving
                           engine — tepdist_tpu/serving/)
  SubmitRequest         -> (serving: enqueue one generation request under
                           admission control; replays dedup via idem token)
  PollResult            -> (serving: long-poll request states/tokens —
                           a pure read, naturally idempotent)
  CancelRequest         -> (serving: cancel a queued/active request)
  ExportPages           -> (serving fleet: gather a prefilled request's
                           live KV pages as Frames blobs — a pure read,
                           like FetchShard; a ``release`` call flips the
                           source request to "handed_off" and frees its
                           pages — naturally idempotent by state machine)
  AdoptPages            -> (serving fleet: the decode replica pulls a
                           prefilled request's KV pages from the prefill
                           replica — nested ExportPages, like AdoptShard's
                           nested FetchShards — installs them into its
                           PagePool and resumes decode. Mutating: idem
                           token + server dedup + NO_DEADLINE_RETRY)
  ExecuteServableSlice  -> (serving fleet: run one prefill/decode step of
                           a pipeline-STAGE servable — the serving twin of
                           ExecuteStepSlice's coalesced dispatch; exact
                           activation bytes ride the Frames path)

Retry + idempotency (rpc/retry.py, no reference analogue): mutating verbs
(ExecutePlan, DispatchPlan, TransferToServerHost, LoadServable,
SubmitRequest, CancelRequest) carry an ``idem`` header token —
``"<client-uid>:<method>:<seq>"`` — and the server caches each
token's response bytes, so a retried request whose original WAS applied
(response lost in flight) is answered from the cache instead of being
re-run. SubmitRequest is additionally deduped by request id inside the
engine, so even a replay past the LRU idem cache cannot generate twice.
All other verbs are naturally idempotent (pure reads or keyed puts
that overwrite with identical values).
"""

from __future__ import annotations

import json
import struct
import time
from typing import Any, Dict, List, Tuple

import warnings

import numpy as np
import torch

from tepdist_tpu_torch.telemetry import ledger as wire_ledger
from tepdist_tpu_torch.telemetry.trace import span

SERVICE_NAME = "tepdist.TepdistService"

METHODS = [
    "BuildExecutionPlan",
    "ExecutePlan",
    "TransferToServerHost",
    "TransferHostRawData",
    "TransferVarArgMap",
    "FetchResourceVars",
    "TransferModuleAndDefCtx",
    "DispatchPlan",
    "ExecuteRemotePlan",
    "ExecuteStepSlice",
    "InitMeshTopology",
    "DoRemoteSave",
    "DoRemoteRestore",
    "AbortStep",
    "Ping",
    "GetTelemetry",
    "GetTelemetryDelta",
    "LoadServable",
    "SubmitRequest",
    "PollResult",
    "CancelRequest",
    "Drain",
    "FetchShard",
    "AdoptShard",
    "ExportPages",
    "AdoptPages",
    "ExecuteServableSlice",
]

# Reference keeps INT_MAX message sizes (client_library.cc:152-156).
GRPC_OPTIONS = [
    ("grpc.max_send_message_length", 2**31 - 1),
    ("grpc.max_receive_message_length", 2**31 - 1),
]

_MAGIC = b"TPD1"


def _nbytes(b) -> int:
    return b.nbytes if isinstance(b, memoryview) else len(b)


class Frames:
    """Scatter-gather envelope: the segment list of one packed frame
    (one framing/header segment + per-blob length prefixes + BORROWED
    blob buffers), deferring the ``b"".join`` to the transport boundary.
    ``len(frames)`` is the joined frame length; ``join()`` materializes
    (and caches) the contiguous frame for transports that need one
    buffer (gRPC); inproc hands the Frames object straight to the
    handler and never joins."""

    __slots__ = ("segments", "header_bytes", "blob_bytes", "nbytes",
                 "_joined")

    def __init__(self, segments, header_bytes: int, blob_bytes: int):
        self.segments = segments
        self.header_bytes = header_bytes
        self.blob_bytes = blob_bytes
        self.nbytes = header_bytes + blob_bytes
        self._joined = None

    def __len__(self) -> int:
        return self.nbytes

    def join(self) -> bytes:
        # Cached so a transport retry replays byte-identical payload
        # without re-joining (and without racing a caller that mutated
        # a borrowed buffer after the first send).
        if self._joined is None:
            self._joined = b"".join(self.segments)
        return self._joined

    def __bytes__(self) -> bytes:
        return self.join()


def _build_segments(header: Dict[str, Any], blobs) -> Tuple[list, int, int]:
    """One preallocated head segment (MAGIC | u32 header_len |
    header_json | u32 n_blobs) + per blob an 8-byte length prefix and a
    borrowed view of the payload. Returns (segments, header_bytes,
    blob_bytes) with header_bytes + blob_bytes == joined length exactly
    (the ledger invariant)."""
    h = json.dumps(header, separators=(",", ":")).encode()
    head = bytearray(12 + len(h))
    head[0:4] = _MAGIC
    struct.pack_into("<I", head, 4, len(h))
    head[8:8 + len(h)] = h
    struct.pack_into("<I", head, 8 + len(h), len(blobs))
    segments: list = [head]
    blob_bytes = 0
    for b in blobs:
        if isinstance(b, memoryview) and not b.c_contiguous:
            b = bytes(b)      # join/transports need contiguous buffers
        n = _nbytes(b)
        segments.append(struct.pack("<Q", n))
        segments.append(b)
        blob_bytes += n
    return segments, 12 + len(h) + 8 * len(blobs), blob_bytes


def pack(header: Dict[str, Any], blobs: List[bytes] = ()) -> bytes:
    """Envelope: MAGIC | u32 header_len | header_json | u32 n_blobs |
    (u64 len | bytes)*

    Ledger accounting (telemetry/ledger.py, when enabled): header bytes
    are the full envelope minus the raw blob payloads — framing + JSON —
    so ledger header + blob bytes equal ``len(frame)`` exactly."""
    led = wire_ledger.active()
    # Ledger timestamps bracket ONLY the inner work, inside the span, and
    # the locked ledger record runs after the span closes: neither
    # instrument counts the other's recording overhead, so the gap
    # table's serde bucket and the fidelity attribution's host_serde lane
    # reconcile (at toy frame sizes a few us/op of mutual overhead would
    # otherwise dominate the comparison).
    with span("serde:pack", cat="serde") as sp:
        t0 = time.monotonic_ns() if led is not None else 0
        segments, hb, bb = _build_segments(header, blobs)
        frame = b"".join(segments)
        sp.set(bytes=len(frame))
        t1 = time.monotonic_ns() if led is not None else 0
    if led is not None:
        led.record_pack(hb, bb, t0, t1)
    return frame


def pack_frames(header: Dict[str, Any], blobs: List[bytes] = ()) -> Frames:
    """``pack`` without the join: returns a :class:`Frames` whose
    segments borrow the blob buffers (zero copy). Ledger accounting is
    identical to ``pack`` — the deferred join changes when bytes are
    materialized, never how many are accounted."""
    led = wire_ledger.active()
    with span("serde:pack", cat="serde") as sp:
        t0 = time.monotonic_ns() if led is not None else 0
        segments, hb, bb = _build_segments(header, blobs)
        frames = Frames(segments, hb, bb)
        sp.set(bytes=frames.nbytes)
        t1 = time.monotonic_ns() if led is not None else 0
    if led is not None:
        led.record_pack(hb, bb, t0, t1)
    return frames


def _unpack_frames(frames: Frames):
    """Zero-copy fast path: header parsed from the head segment, blob
    segments returned as-is (borrowed). Accounting matches a joined-frame
    parse to the byte."""
    led = wire_ledger.active()
    with span("serde:unpack", cat="serde") as sp:
        t0 = time.monotonic_ns() if led is not None else 0
        head = frames.segments[0]
        if len(head) < 12 or bytes(head[0:4]) != _MAGIC:
            raise ValueError("bad envelope magic")
        (hlen,) = struct.unpack_from("<I", head, 4)
        header = json.loads(bytes(head[8:8 + hlen]).decode())
        blobs = frames.segments[2::2]
        sp.set(bytes=frames.nbytes)
        t1 = time.monotonic_ns() if led is not None else 0
    if led is not None:
        led.record_unpack(frames.header_bytes, frames.blob_bytes, t0, t1)
    return header, blobs


def peek_header(data) -> Dict[str, Any]:
    """Parse ONLY the JSON header, touching neither the ledger nor the
    trace: transport-layer introspection (fault-plan step matching in
    rpc/inproc.py) must not double-count a request the handler will
    unpack again."""
    if isinstance(data, Frames):
        head = data.segments[0]
    else:
        head = memoryview(data)
    if len(head) < 12 or bytes(head[0:4]) != _MAGIC:
        raise ValueError("bad envelope magic")
    (hlen,) = struct.unpack_from("<I", head, 4)
    if 8 + hlen > len(head):
        raise ValueError("truncated envelope (header)")
    return json.loads(bytes(head[8:8 + hlen]).decode())


def unpack(data) -> Tuple[Dict[str, Any], List[bytes]]:
    """Accepts bytes/bytearray/memoryview or a :class:`Frames` (inproc
    fast path, no join). Blob payloads are returned as zero-copy
    memoryviews into ``data``."""
    if isinstance(data, Frames):
        return _unpack_frames(data)
    led = wire_ledger.active()
    mv = data if isinstance(data, memoryview) else memoryview(data)
    total = mv.nbytes
    if total < 12 or bytes(mv[:4]) != _MAGIC:
        raise ValueError("bad envelope magic")
    with span("serde:unpack", cat="serde") as sp:
        t0 = time.monotonic_ns() if led is not None else 0
        off = 4
        (hlen,) = struct.unpack_from("<I", mv, off)
        off += 4
        if off + hlen + 4 > total:
            raise ValueError("truncated envelope (header)")
        header = json.loads(bytes(mv[off:off + hlen]).decode())
        off += hlen
        (n,) = struct.unpack_from("<I", mv, off)
        off += 4
        blobs = []
        for i in range(n):
            if off + 8 > total:
                raise ValueError(f"truncated envelope (blob {i} length)")
            (blen,) = struct.unpack_from("<Q", mv, off)
            off += 8
            if off + blen > total:
                raise ValueError(f"truncated envelope (blob {i} payload)")
            blobs.append(mv[off:off + blen])
            off += blen
        sp.set(bytes=total)
        t1 = time.monotonic_ns() if led is not None else 0
    if led is not None:
        blob_total = sum(b.nbytes for b in blobs)
        led.record_unpack(total - blob_total, blob_total, t0, t1)
    return header, blobs


# -- literals (tensors) as (meta, blob) pairs ------------------------------
#
# A literal is a host tensor as the reference's (meta, blob): meta
# ``{"dtype": <numpy dtype name>, "shape": [...]}`` and the blob its raw
# little-endian bytes, C order. bfloat16 travels as its 16 bits under the
# name "bfloat16" (the reference's ``ml_dtypes`` name; the port needs no
# ml_dtypes: the bits are viewed through int16 on both ends). serde spans
# feed the host_serde bucket of the fidelity attribution
# (telemetry/fidelity.py).

_TORCH_DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """The wire (numpy) name of a torch dtype."""
    try:
        return _DTYPE_NAMES[dtype]
    except KeyError:
        raise TypeError(f"no wire form for dtype {dtype}") from None


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a wire (numpy) dtype name."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise TypeError(f"unknown wire dtype {name!r}") from None


def _host(x) -> torch.Tensor:
    """``x`` as a host tensor (numpy arrays and scalars are converted)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.as_tensor(np.asarray(x))


def _blob_view(t: torch.Tensor) -> memoryview:
    """Borrowed byte view of a C-contiguous host tensor (bf16 through its
    int16 bits): never copies."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return memoryview(t.reshape(-1).numpy().view(np.uint8))


def encode_literal(x, wire_dtype: str = None) -> Tuple[Dict[str, Any], Any]:
    """Tensor -> (meta, blob). The blob BORROWS a C-contiguous host
    tensor's buffer (zero copy); a device tensor is copied to the host
    once, and only non-contiguous inputs, or an opt-in ``wire_dtype``
    down-cast, materialize. The ledger's ``copies`` counter records every
    materialization.

    ``wire_dtype`` rules (floats only; integer payloads are never cast):
      * a float dtype name (``bfloat16``/``float16``): down-cast, decode
        upcasts via ``meta["wire_from"]``;
      * ``int8``: shape-aware chunk-scale quantization
        (parallel/quantize.py): the blob is the f32 per-chunk scale vector
        followed by the int8 codes, ~26% of the f32 payload.
    """
    led = wire_ledger.active()
    with span("serde:encode", cat="serde") as sp:
        t0 = time.monotonic_ns() if led is not None else 0
        copies = int(isinstance(x, torch.Tensor) and x.device.type != "cpu")
        t = _host(x)
        meta = {"dtype": dtype_name(t.dtype), "shape": list(t.shape)}
        is_float = t.dtype in (torch.float32, torch.float64)
        if wire_dtype == "int8" and is_float:
            from tepdist_tpu_torch.parallel.quantize import (
                CHUNK, quantize_np_int8)
            q, scales = quantize_np_int8(t.numpy(), CHUNK)
            meta["wire_from"] = meta["dtype"]
            meta["dtype"] = "int8"
            meta["qscales"] = int(scales.size)
            meta["qchunk"] = CHUNK
            blob = scales.tobytes() + q.tobytes()
            sp.set(bytes=len(blob))
            t1 = time.monotonic_ns() if led is not None else 0
            if led is not None:
                led.record_encode(t0, t1, 1)
            return (meta, blob)
        if wire_dtype and wire_dtype != "int8" and is_float:
            wdt = torch_dtype(wire_dtype)
            if wdt != t.dtype:
                meta["wire_from"] = meta["dtype"]
                meta["dtype"] = wire_dtype
                t = t.to(wdt)
                copies = 1
        if not t.is_contiguous():
            t = t.contiguous()
            copies = 1
        blob = _blob_view(t)
        sp.set(bytes=blob.nbytes)
        t1 = time.monotonic_ns() if led is not None else 0
    if led is not None:
        led.record_encode(t0, t1, copies)
    return (meta, blob)


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    # A view of a read-only wire buffer: torch warns that writing to it
    # is undefined; the decoded literal is read, never written in place.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(arr)


def decode_literal(meta: Dict[str, Any], blob) -> torch.Tensor:
    """(meta, blob) -> host tensor. The tensor BORROWS the blob's buffer
    unless the wire form needs a conversion (int8, ``wire_from``)."""
    led = wire_ledger.active()
    with span("serde:decode", cat="serde") as sp:
        t0 = time.monotonic_ns() if led is not None else 0
        sp.set(bytes=_nbytes(blob))
        qscales = meta.get("qscales")
        if qscales is not None:
            # int8 chunk-scale wire: f32 scales followed by int8 codes.
            from tepdist_tpu_torch.parallel.quantize import (
                dequantize_np_int8)
            mv = memoryview(blob)
            scales = np.frombuffer(mv[:4 * qscales], dtype=np.float32)
            q = np.frombuffer(mv[4 * qscales:], dtype=np.int8)
            wire_from = meta.get("wire_from") or "float32"
            out = torch.from_numpy(dequantize_np_int8(
                q, scales, meta["shape"], dtype=np.dtype(wire_from),
                chunk=meta.get("qchunk", 256)))
        else:
            dt = torch_dtype(meta["dtype"])
            np_dt = (np.int16 if dt == torch.bfloat16
                     else np.dtype(meta["dtype"]))
            out = _from_numpy(np.frombuffer(blob, dtype=np_dt).reshape(
                meta["shape"]))
            if dt == torch.bfloat16:
                out = out.view(torch.bfloat16)
            wire_from = meta.get("wire_from")
            if wire_from:
                out = out.to(torch_dtype(wire_from))
        t1 = time.monotonic_ns() if led is not None else 0
    if led is not None:
        led.record_decode(t0, t1)
    return out


def method_path(name: str) -> str:
    return f"/{SERVICE_NAME}/{name}"
