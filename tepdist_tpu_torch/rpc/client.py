"""Client library: gRPC stub + Client over the Tepdist service (the port of
the JAX package's ``rpc/client.py``: literals are encoded from and decoded
to host tensors; ``grpc`` is imported only where a channel opens).

Reference parity: ``GRPCStub`` / ``Client`` / ``ClientLibrary`` (reference:
rpc/grpc_stub.{h,cc}, client/client.cc:287-410, client/client_library.cc:
142-165): channel resolved from ``SERVER_IP``/``SERVER_PORT`` env vars with
INT_MAX message sizes; methods mirror the TePDist RPC set.

Robustness deltas over the reference (which treats any gRPC error as a
CHECK failure): every stub call runs under rpc/retry.py's policy —
per-verb deadlines, exponential backoff + jitter, transport-vs-fatal
classification — and consults the active fault plan (runtime/faults.py)
so injected drops/delays exercise exactly this path. ``TepdistClient``
attaches idempotency tokens to mutating verbs; the server dedups replays
(an applied-but-unacknowledged request is retried safely). Addresses
beginning with ``inproc:`` route to the in-process transport
(rpc/inproc.py) instead of a gRPC channel.
"""

from __future__ import annotations

import itertools
import os
import time
import uuid
from typing import Any, Dict, List, Optional, Sequence

from tepdist_tpu_torch.rpc import protocol, retry
from tepdist_tpu_torch.runtime import faults
from tepdist_tpu_torch.telemetry import ledger as wire_ledger
from tepdist_tpu_torch.telemetry import metrics, span

# Mutating verbs that carry an idempotency token: a retried request whose
# original WAS applied (response lost) must not double-apply. Everything
# else is naturally idempotent (pure reads, or keyed puts that overwrite
# with the same value).
IDEMPOTENT_TOKEN_VERBS = {"ExecutePlan", "DispatchPlan",
                          "TransferToServerHost",
                          # Serving verbs: a replayed LoadServable must not
                          # build a second engine, a replayed SubmitRequest
                          # must not generate twice, a replayed Cancel must
                          # report the original cancel's outcome.
                          "LoadServable", "SubmitRequest", "CancelRequest",
                          # A replayed Drain must answer with the ORIGINAL
                          # handoff list — re-draining an already-drained
                          # engine would return [] and lose the handoffs.
                          "Drain",
                          # Live migration: a replayed AdoptShard must
                          # answer from the cache, never re-pull and
                          # re-install (FetchShard is a pure read and
                          # carries no token).
                          "AdoptShard",
                          # Disaggregated serving: a replayed AdoptPages
                          # must not re-pull and re-install a request's KV
                          # pages (ExportPages' gather is a pure read and
                          # its release is state-idempotent — no token).
                          "AdoptPages"}


class GRPCStub:
    """Thin bytes-level stub over the channel."""

    def __init__(self, address: Optional[str] = None):
        import grpc

        if address is None:
            ip = os.environ.get("SERVER_IP", "127.0.0.1")
            port = os.environ.get("SERVER_PORT", "2222")
            address = f"{ip}:{port}"
        self.address = address
        self._channel = grpc.insecure_channel(
            address, options=protocol.GRPC_OPTIONS)
        self._methods = {
            m: self._channel.unary_unary(
                protocol.method_path(m),
                request_serializer=None,
                response_deserializer=None,
            )
            for m in protocol.METHODS
        }

    def call(self, method: str, payload: bytes,
             timeout: Optional[float] = None,
             max_attempts: Optional[int] = None) -> bytes:
        timeout = retry.deadline_for(method, timeout)
        t0 = time.perf_counter()
        # The ledger scope sits here (the stub, not TepdistClient) so
        # direct stub users — worker_plan's peer pushes — are accounted.
        with wire_ledger.client_scope(method), \
                span(f"rpc:{method}", cat="rpc", addr=self.address,
                     req_bytes=len(payload)) as sp:
            resp = retry.call_with_retry(self._call_once, method, payload,
                                         timeout, max_attempts=max_attempts)
            sp.set(resp_bytes=len(resp))
        m = metrics()
        # Metrics are always on (spans are not): measure independently.
        m.histogram(f"rpc_ms:{method}").observe(
            (time.perf_counter() - t0) * 1e3)
        m.counter(f"rpc_bytes_out:{method}").inc(len(payload))
        m.counter(f"rpc_bytes_in:{method}").inc(len(resp))
        return resp

    def _call_once(self, method: str, payload: bytes,
                   timeout: float) -> bytes:
        plan = faults.active()
        action = plan.rpc_action(method) if plan is not None else None
        if action == "drop_request":
            raise faults.InjectedFault(
                f"{method} request dropped", kind="rpc_drop")
        if isinstance(payload, protocol.Frames):
            # The channel boundary is the ONE place scatter-gather frames
            # materialize for gRPC; Frames caches the join, so retries
            # replay identical bytes without re-joining.
            payload = payload.join()
        try:
            resp = self._methods[method](payload, timeout=timeout)
        except Exception as e:  # noqa: BLE001 — re-typed below
            # Epoch fence: the server aborts INTERNAL with the
            # STALE_EPOCH marker in the details — surface the typed error
            # so callers (and the retry classifier) see the fence, not a
            # generic RPC failure.
            import grpc
            if isinstance(e, grpc.RpcError) \
                    and e.code() == grpc.StatusCode.INTERNAL:
                stale = retry.parse_stale_epoch(e.details() or "")
                if stale is not None:
                    raise stale from e
            raise
        if action == "drop_response":
            raise faults.InjectedFault(
                f"{method} response dropped", kind="rpc_drop")
        return resp

    def wait_ready(self, timeout: float = 30.0) -> None:
        import grpc
        grpc.channel_ready_future(self._channel).result(timeout=timeout)

    def close(self) -> None:
        self._channel.close()


def make_stub(address: Optional[str] = None):
    """Transport selection: ``inproc:<port>`` addresses get the in-process
    stub (rpc/inproc.py); everything else a gRPC channel."""
    if address is not None and str(address).startswith("inproc:"):
        from tepdist_tpu_torch.rpc.inproc import InProcStub
        return InProcStub(address)
    return GRPCStub(address)


class TepdistClient:
    """High-level client (reference ``Client``)."""

    def __init__(self, address: Optional[str] = None):
        self.stub = make_stub(address)
        self._uid = uuid.uuid4().hex[:12]
        self._idem_seq = itertools.count(1)
        # Epoch fence: when set, every call carries
        # ``master_epoch`` in its header and workers reject anything
        # older than the epoch they have latched (StaleEpochError) — a
        # wedged-then-revived old master cannot poison the fleet. None =
        # unfenced (single-master setups that never enable the WAL).
        self.epoch: Optional[int] = None

    # -- generic call --------------------------------------------------
    def call(self, method: str, header: Dict[str, Any],
             blobs: Sequence[bytes] = (),
             timeout: Optional[float] = None,
             max_attempts: Optional[int] = None) -> bytes:
        """Pack + send with retry. Mutating verbs get an ``idem`` token in
        the header: the payload is packed ONCE, so every retry replays the
        identical bytes and the server's dedup cache can recognize (and
        answer) an already-applied request instead of re-running it."""
        if method in IDEMPOTENT_TOKEN_VERBS and "idem" not in header:
            header = dict(header)
            header["idem"] = f"{self._uid}:{method}:{next(self._idem_seq)}"
        if self.epoch is not None and "master_epoch" not in header:
            header = dict(header)
            header["master_epoch"] = int(self.epoch)
        # Ledger step attribution: the header's step= tag covers the pack
        # (and, in-proc, the whole server handler on this same thread).
        # pack_frames borrows the blob buffers: inproc hands the segments
        # straight to the handler, gRPC joins once at the channel.
        with wire_ledger.step_hint(header.get("step")):
            return self.stub.call(method,
                                  protocol.pack_frames(header, list(blobs)),
                                  timeout=timeout,
                                  max_attempts=max_attempts)

    # -- lifecycle ----------------------------------------------------
    def ping(self, want_ckpt_steps: bool = False) -> Dict[str, Any]:
        hdr = {"want_ckpt_steps": True} if want_ckpt_steps else {}
        header, _ = protocol.unpack(self.call("Ping", hdr))
        return header

    def wait_ready(self, timeout: float = 30.0) -> None:
        self.stub.wait_ready(timeout)

    def get_telemetry(self, clear: bool = False) -> Dict[str, Any]:
        """Pull the worker's span buffer + metrics snapshot, annotated
        with the clock alignment estimate: ``offset_us`` is the NTP-style
        midpoint offset (worker clock minus client clock, accurate to
        half the round-trip ``rtt_us``) — subtract it from the worker's
        span timestamps to merge timelines (telemetry/export.py)."""
        t0 = time.time_ns() // 1000
        resp = self.call("GetTelemetry", {"clear": clear})
        t1 = time.time_ns() // 1000
        header, _ = protocol.unpack(resp)
        header["rtt_us"] = t1 - t0
        header["offset_us"] = header.get("now_us", t1) - (t0 + t1) / 2
        return header

    def get_telemetry_delta(self, cursors: Optional[Dict[str, Any]] = None,
                            spans: bool = False) -> Dict[str, Any]:
        """Incremental telemetry read (watchtower poll verb): pass the
        ``cursors`` dict from the previous response (None for a first
        read from the ring bases) and receive only records written
        since, with exact drop counters. A pure non-consuming read —
        naturally idempotent, no idem token. Same NTP-style clock
        annotation as get_telemetry."""
        t0 = time.time_ns() // 1000
        resp = self.call("GetTelemetryDelta",
                         {"cursors": cursors, "spans": bool(spans)})
        t1 = time.time_ns() // 1000
        header, _ = protocol.unpack(resp)
        header["rtt_us"] = t1 - t0
        header["offset_us"] = header.get("now_us", t1) - (t0 + t1) / 2
        return header

    # -- plan building --------------------------------------------------
    def build_execution_plan(
        self,
        module_bytes: bytes,
        mesh_axes: Sequence = (),
        variable_indices: Sequence[int] = (),
        state_alias: Optional[Dict[int, int]] = None,
        mode: str = "cost",
        annotations: Optional[Dict[int, Dict[str, dict]]] = None,
        share_dev_flags: Optional[Sequence[bool]] = None,
        init_specs: Optional[Dict[int, dict]] = None,
        init_seed: int = 0,
        loss_module: Optional[bytes] = None,
        micro_loss_module: Optional[bytes] = None,
        replica_loss_modules: Optional[Sequence[bytes]] = None,
        n_param_leaves: Optional[int] = None,
        optimizer_spec: Optional[dict] = None,
        num_micro_batches: int = 1,
        explore: bool = False,
    ) -> Dict[str, Any]:
        """``module_bytes``: the step's graph (``rpc/fx_serde.py``).
        ``explore=True`` + ``loss_module`` (the serialized loss graph)
        asks the SERVER to run the full parallelism exploration — SPMD
        meshes, seq meshes, pipeline stage cuts — and compile the winner
        (reference: RunExplorationlMode inside BuildExecutionPlan,
        auto_parallel.cc:236 + service_rt.cc:218-308). ``optimizer_spec``
        (see tepdist_tpu_torch.optim.optimizer_spec) lets the server
        materialize pipeline/seq winners by composing the step itself."""
        options = {
            "mesh_axes": [[a, n] for a, n in mesh_axes] or None,
            "variable_indices": list(variable_indices),
            "state_alias": {str(k): v for k, v in (state_alias or {}).items()},
            "mode": mode,
            "annotations": annotations,
            "share_dev_flags": list(share_dev_flags) if share_dev_flags
            else None,
            "init_specs": ({str(k): v for k, v in init_specs.items()}
                           if init_specs else None),
            "init_seed": init_seed,
        }
        blobs = [module_bytes]
        if explore:
            options["explore"] = True
            options["optimizer_spec"] = optimizer_spec
            options["num_micro_batches"] = num_micro_batches
            if loss_module is not None:
                options["loss_module_blob"] = len(blobs)
                options["n_param_leaves"] = int(n_param_leaves)
                blobs.append(loss_module)
            if micro_loss_module is not None:
                # The loss re-traced at MICRO-batch shapes: a captured
                # graph bakes the trace shape (mean denominators), so the
                # server's pipeline stage modules must come from a trace
                # at batch/M, not a re-eval of the full-batch graph.
                options["micro_loss_module_blob"] = len(blobs)
                blobs.append(micro_loss_module)
            if replica_loss_modules:
                # The loss at a replica's share of the micro batch, for
                # each replica count that divides its rows: a pipeline
                # stage over R intra-stage replicas is captured there.
                options["replica_loss_module_blobs"] = list(range(
                    len(blobs), len(blobs) + len(replica_loss_modules)))
                blobs.extend(replica_loss_modules)
        resp = self.call("BuildExecutionPlan", {"options": options}, blobs)
        header, _ = protocol.unpack(resp)
        return header

    # -- data transfer ----------------------------------------------------
    def transfer_to_server_host(self, value, global_idx: int,
                                variable: bool = False) -> None:
        meta, blob = protocol.encode_literal(value)
        self.call("TransferToServerHost",
                  {"global_idx": global_idx, "variable": variable,
                   "literal": meta}, [blob])

    def transfer_var_arg_map(self, var_arg_map: Dict[int, int]) -> None:
        self.call("TransferVarArgMap",
                  {"var_arg_map": {str(k): v
                                   for k, v in var_arg_map.items()}})

    # -- execution ----------------------------------------------------
    def execute_plan(self, handle: int,
                     inline_args: Optional[Dict[int, Any]] = None,
                     fetch_resource_variables: bool = False,
                     inference: bool = False
                     ) -> Dict[str, Any]:
        blobs: List[bytes] = []
        inline, inline_meta = {}, {}
        for idx, val in (inline_args or {}).items():
            meta, blob = protocol.encode_literal(val)
            inline[str(idx)] = len(blobs)
            inline_meta[str(idx)] = meta
            blobs.append(blob)
        resp = self.call("ExecutePlan", {
            "handle": handle, "inline": inline, "inline_meta": inline_meta,
            "fetch_resource_variables": fetch_resource_variables,
            "inference": inference}, blobs)
        header, rblobs = protocol.unpack(resp)
        outputs = [protocol.decode_literal(m, rblobs[i])
                   for i, m in enumerate(header["outputs"])]
        fetched = {
            int(k): protocol.decode_literal(v["meta"], rblobs[v["blob"]])
            for k, v in header.get("fetched", {}).items()
        }
        return {"outputs": outputs,
                "output_indices": header["output_indices"],
                "fetched": fetched,
                "global_step": header["global_step"]}

    def fetch_resource_vars(self, indices: Optional[Sequence[int]] = None
                            ) -> Dict[int, Any]:
        resp = self.call("FetchResourceVars", {
            "indices": list(indices) if indices is not None else None})
        header, blobs = protocol.unpack(resp)
        return {int(m["global_idx"]): protocol.decode_literal(m, blobs[i])
                for i, m in enumerate(header["vars"])}

    # -- checkpoint ----------------------------------------------------
    def do_remote_save(self, max_to_keep: int = 5,
                       global_step: Optional[int] = None,
                       lazy: bool = False) -> None:
        self.call("DoRemoteSave",
                  {"max_to_keep": max_to_keep, "global_step": global_step,
                   "lazy": lazy})

    def do_remote_restore(self, global_step: int = -1,
                          lazy: bool = False,
                          all_shards: bool = False) -> int:
        """Returns the restored global step (-1 when lazy: the restore is
        latched and consumed on the next ExecutePlan)."""
        resp = self.call("DoRemoteRestore",
                         {"global_step": global_step, "lazy": lazy,
                          "all_shards": all_shards})
        header, _ = protocol.unpack(resp)
        return int(header.get("global_step", -1))

    # -- serving (single-engine servables) -----------------------------
    def load_servable(self, config: Dict[str, Any],
                      param_leaves: Sequence[Any], *,
                      slots: int = 4, max_len: Optional[int] = None,
                      buckets: Optional[Sequence[int]] = None,
                      max_queue: int = 64,
                      name: str = "servable",
                      max_restarts: int = 3,
                      shed_high: Optional[int] = None,
                      shed_low: Optional[int] = None,
                      kv_mode: str = "paged", page_size: int = 16,
                      n_pages: Optional[int] = None,
                      hbm_budget_bytes: Optional[float] = None,
                      prefix_cache: bool = True,
                      prefill_chunk: Optional[int] = None,
                      stage: Optional[Dict[str, Any]] = None) -> str:
        """Ship a model (JSON-able GPT2Config dict + flat param leaves in
        tree order) and start its supervised serving engine. Returns the
        servable id the other serve verbs take. ``stage`` loads a
        pipeline-STAGE servable instead of a whole-model engine: a dict
        ``{"lo", "hi", "first", "last", "names"}`` naming the layer range
        and the dotted param leaves being shipped (``serving/fleet.py``)."""
        metas, blobs = [], []
        for leaf in param_leaves:
            meta, blob = protocol.encode_literal(leaf)
            metas.append(meta)
            blobs.append(blob)
        resp = self.call("LoadServable", {
            "config": config, "params_meta": metas, "slots": int(slots),
            "max_len": max_len,
            "buckets": list(buckets) if buckets is not None else None,
            "max_queue": int(max_queue), "name": name,
            "max_restarts": int(max_restarts),
            "shed_high": shed_high, "shed_low": shed_low,
            "kv_mode": kv_mode, "page_size": int(page_size),
            "n_pages": n_pages, "hbm_budget_bytes": hbm_budget_bytes,
            "prefix_cache": bool(prefix_cache),
            "prefill_chunk": prefill_chunk,
            "stage": stage}, blobs)
        header, _ = protocol.unpack(resp)
        return header["servable_id"]

    @staticmethod
    def _prompt(prompt):
        import numpy as np
        return protocol.encode_literal(
            np.asarray(prompt, np.int32).reshape(-1))

    def submit_request(self, servable_id: str, request_id: str,
                       prompt, *, max_new_tokens: int, greedy: bool = True,
                       temperature: float = 1.0, top_k: int = 0,
                       seed: int = 0,
                       deadline_ms: Optional[float] = None,
                       slo_class: str = "default",
                       prefill_only: bool = False
                       ) -> Dict[str, Any]:
        meta, blob = self._prompt(prompt)
        resp = self.call("SubmitRequest", {
            "servable_id": servable_id, "request_id": request_id,
            "prompt": meta, "max_new_tokens": int(max_new_tokens),
            "greedy": bool(greedy), "temperature": float(temperature),
            "top_k": int(top_k), "seed": int(seed),
            "deadline_ms": deadline_ms,
            "slo_class": str(slo_class),
            "prefill_only": bool(prefill_only)}, [blob])
        header, _ = protocol.unpack(resp)
        return header

    def poll_result(self, servable_id: str,
                    request_ids: Optional[Sequence[str]] = None,
                    wait_ms: float = 0.0) -> List[Dict[str, Any]]:
        """Long-poll request states; generated tokens ride in the JSON
        header (short int lists, not tensor payloads)."""
        resp = self.call("PollResult", {
            "servable_id": servable_id,
            "request_ids": (list(request_ids)
                            if request_ids is not None else None),
            "wait_ms": float(wait_ms)},
            timeout=retry.deadline_for("PollResult") + wait_ms / 1e3)
        header, _ = protocol.unpack(resp)
        return header["results"]

    def cancel_request(self, servable_id: str,
                       request_id: str) -> bool:
        resp = self.call("CancelRequest", {
            "servable_id": servable_id, "request_id": request_id})
        header, _ = protocol.unpack(resp)
        return bool(header["cancelled"])

    def drain_servable(self, servable_id: str,
                       wait_ms: float = 0.0) -> List[Dict[str, Any]]:
        """Gracefully drain the servable: admission stops, resident
        slots get up to ``wait_ms`` to finish, and every un-started
        queued request comes back as a resubmittable spec."""
        resp = self.call("Drain", {
            "servable_id": servable_id, "wait_ms": float(wait_ms)},
            timeout=retry.deadline_for("Drain") + wait_ms / 1e3)
        header, _ = protocol.unpack(resp)
        return header["handed_off"]

    # -- live migration ------------------------------------------------
    def fetch_shard(self, global_idx: Optional[int] = None, *,
                    bounds: Optional[Sequence[Sequence[int]]] = None,
                    opt_stage: Optional[int] = None,
                    wire_dtype: Optional[str] = None
                    ) -> Optional[Any]:
        """Pure read of migration source state. Variable mode
        (``global_idx``, optional ``bounds`` slice in global coordinates)
        returns one host tensor; ``opt_stage`` mode returns the stage's
        optimizer slot list. None when the worker does not hold the key."""
        resp = self.call("FetchShard", {
            "global_idx": global_idx,
            "bounds": [list(b) for b in bounds] if bounds else None,
            "opt_stage": opt_stage, "wire_dtype": wire_dtype})
        header, blobs = protocol.unpack(resp)
        if not header.get("found"):
            return None
        if opt_stage is not None:
            return [protocol.decode_literal(m, blobs[i])
                    for i, m in enumerate(header["slots"])]
        return protocol.decode_literal(header["literal"], blobs[0])

    def adopt_shard(self, moves: List[Dict[str, Any]],
                    migration_id: str = "") -> Dict[str, Any]:
        """Instruct the destination worker to pull + install the listed
        shard moves (see the server's AdoptShard for the move schema).
        Mutating: rides the idem token."""
        resp = self.call("AdoptShard",
                         {"moves": moves, "migration_id": migration_id})
        header, _ = protocol.unpack(resp)
        return header

    # -- KV handoff ----------------------------------------------------
    def export_pages(self, servable_id: str, request_id: str, *,
                     want: Optional[Sequence[int]] = None,
                     release: bool = False,
                     wire_dtype: Optional[str] = None
                     ) -> Optional[Dict[str, Any]]:
        """Gather a prefilled request's live KV pages (pure read).
        ``want`` selects live-page ordinals; ``release=True`` flips the
        source request to "handed_off" and frees its pages. Gather mode
        returns None when the request is not exportable."""
        resp = self.call("ExportPages", {
            "servable_id": servable_id, "request_id": request_id,
            "want": list(want) if want is not None else None,
            "release": bool(release), "wire_dtype": wire_dtype})
        header, blobs = protocol.unpack(resp)
        if release:
            return {"released": bool(header.get("released"))}
        if not header.get("found"):
            return None
        return {"first_token": int(header["first_token"]),
                "pos": int(header["pos"]),
                "n_live": int(header["n_live"]),
                "idx": list(header["idx"]),
                "k": protocol.decode_literal(header["k"], blobs[0]),
                "v": protocol.decode_literal(header["v"], blobs[1])}

    def adopt_pages(self, servable_id: str, request_id: str, prompt, *,
                    source_addr: str, source_sid: str,
                    max_new_tokens: int, greedy: bool = True,
                    temperature: float = 1.0, top_k: int = 0,
                    seed: int = 0, deadline_ms: Optional[float] = None,
                    slo_class: str = "default",
                    wire_dtype: Optional[str] = None) -> Dict[str, Any]:
        """Instruct the decode replica to pull the request's live KV
        pages from ``source_addr``/``source_sid`` (nested ExportPages),
        install them and resume decode. Mutating: rides the idem token."""
        meta, blob = self._prompt(prompt)
        resp = self.call("AdoptPages", {
            "servable_id": servable_id, "request_id": request_id,
            "prompt": meta, "source_addr": source_addr,
            "source_sid": source_sid,
            "max_new_tokens": int(max_new_tokens),
            "greedy": bool(greedy), "temperature": float(temperature),
            "top_k": int(top_k), "seed": int(seed),
            "deadline_ms": deadline_ms, "slo_class": str(slo_class),
            "wire_dtype": wire_dtype}, [blob])
        header, _ = protocol.unpack(resp)
        return header

    def execute_servable_slice(self, servable_id: str, op: str,
                               array, pos: int = 0):
        """Run one ``op`` ("prefill" | "decode") of a pipeline-STAGE
        servable: int tokens [1, S] into the first stage, hidden
        activations [1, S, d] into later ones. Returns a host tensor;
        exact activation bytes cross on the Frames path (bf16 as its
        uint16 bits)."""
        meta, blob = protocol.encode_literal(array)
        resp = self.call("ExecuteServableSlice", {
            "servable_id": servable_id, "op": str(op),
            "array": meta, "pos": int(pos)}, [blob])
        header, blobs = protocol.unpack(resp)
        return protocol.decode_literal(header["out"], blobs[0])

    def close(self) -> None:
        self.stub.close()
