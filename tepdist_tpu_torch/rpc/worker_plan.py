"""Worker-side distributed plan execution: the port of the JAX package's
``rpc/worker_plan.py``.

Reference parity: the slave lifecycle (reference: service_rt.cc:310-528 +
DAPPLEExecutable::ExecuteRemotePlan, virtual_client.cc:2314): a worker
receives the stage modules (TransferModuleAndDefCtx), its slice of the
task DAG (DispatchPlan), per-step raw inputs (TransferHostRawData), and
executes its task list on ExecuteRemotePlan / ExecuteStepSlice, receiving
activations from peers and sending its own onward.

``RawStore`` is the keyed host store of per-step raw data with a blocking
get (the reference's kRecv wait); ``StepAbortedError`` wakes its waiters
when a step is aborted. A stage module arrives as a captured aten graph
(``rpc/fx_serde.py``) and runs on the worker's device; its backward runs
the forward again under autograd (``parallel/pipeline.stage_vjp``), as
``jax.vjp`` of the stage forward does in the reference. The per-stage
optimizer arrives the same way: its ``init`` and ``update`` captured as
graphs on the master.

Peer hops: an RPC raw-data push to the consumer's store (the reference's
DCN path), or a device-direct pull ticket: the producer parks the tensor
in this process's transfer registry and the consumer, when it lives in
the same process (``inproc:`` workers that each hold a card), copies it
device to device. Workers in other processes always take the push.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from tepdist_tpu_torch.telemetry import _NULL_SPAN, metrics, span

log = logging.getLogger(__name__)


def _nbytes(val) -> int:
    """Payload size of a task value (tuples = GA accumulator bundles)."""
    if isinstance(val, tuple):
        return sum(_nbytes(v) for v in val)
    if isinstance(val, torch.Tensor):
        return val.numel() * val.element_size()
    return 0


# The process's device-direct transfer registry: uuid -> parked tensors.
# Its address names the process, so a consumer in another process knows
# it cannot pull (and the producer never issues it a ticket).
_PARKED: Dict[int, Tuple[torch.Tensor, ...]] = {}
_PARKED_LOCK = threading.Lock()
_UUIDS = itertools.count(1)


def transfer_address() -> str:
    return f"local:{os.getpid()}"


def park(vals: Tuple[torch.Tensor, ...]) -> int:
    uuid = next(_UUIDS)
    with _PARKED_LOCK:
        _PARKED[uuid] = vals
    return uuid


def unpark(uuids) -> int:
    with _PARKED_LOCK:
        n = 0
        for u in uuids:
            n += _PARKED.pop(u, None) is not None
        return n


@dataclasses.dataclass
class PendingPull:
    """A ticket whose pull was started the moment it arrived (server-side
    prefetch): the consumer's recv overlaps the copy."""

    future: Any

    def resolve(self, timeout: float = 60.0):
        return self.future.result(timeout=timeout)


@dataclasses.dataclass
class PullTicket:
    """Control-plane stand-in for a device-resident value: the producer
    parked the tensors in its transfer registry; the consumer pulls them
    device to device when its recv task runs. ``specs``: [[shape,
    dtype_name], ...]; ``bundle``: True when the value is a tuple (GA
    accumulators)."""

    uuid: int
    address: str
    specs: List[Any]
    bundle: bool = False

    def pull(self, device: torch.device):
        if self.address != transfer_address():
            raise RuntimeError(
                f"pull ticket {self.uuid} names transfer registry "
                f"{self.address}; this process is {transfer_address()}")
        with _PARKED_LOCK:
            vals = _PARKED.get(self.uuid)
        if vals is None:
            raise KeyError(f"pull ticket {self.uuid}: buffers released")
        out = tuple(v.to(device, copy=True) for v in vals)
        return out if self.bundle else out[0]


class StepAbortedError(RuntimeError):
    """Raised out of a blocking recv when the master aborts the step
    (a peer worker died mid-step and this worker's inputs will never
    arrive)."""


class RawStore:
    """Keyed host store with blocking get (the kRecv wait)."""

    def __init__(self):
        self._data: Dict[str, Any] = {}
        self._cv = threading.Condition()
        self._aborted = False

    def put(self, key: str, value: Any) -> None:
        with self._cv:
            self._data[key] = value
            self._cv.notify_all()

    def get(self, key: str, timeout: float = 60.0) -> Any:
        """Non-destructive blocking read: the forward AND its remat backward
        both re-read stage inputs, so values live until the step's cleanup."""
        deadline = time.time() + timeout
        with self._cv:
            while key not in self._data:
                if self._aborted:
                    raise StepAbortedError(
                        f"step aborted while waiting for {key!r}")
                remaining = deadline - time.time()
                if remaining <= 0:
                    raise TimeoutError(f"raw data {key!r} never arrived")
                self._cv.wait(remaining)
            return self._data[key]

    def abort(self) -> None:
        """Wake every blocked get with StepAbortedError (master-initiated
        cancellation: a peer died, this step cannot complete)."""
        with self._cv:
            self._aborted = True
            self._cv.notify_all()

    def reset_abort(self) -> None:
        with self._cv:
            self._aborted = False

    def clear_step(self, step: int) -> None:
        suffix = f":{step}"
        prefix = f"batch:{step}:"
        with self._cv:
            for k in [k for k in self._data
                      if k.endswith(suffix) or k.startswith(prefix)]:
                del self._data[k]

    @staticmethod
    def _key_step(key: str) -> Optional[int]:
        """The step index a store key belongs to: ``batch:{step}:{m}:{gi}``
        or ``t{send_id}:{step}``; None for unrecognized keys."""
        try:
            if key.startswith("batch:"):
                return int(key.split(":")[1])
            return int(key.rsplit(":", 1)[1])
        except (IndexError, ValueError):
            return None

    def clear_older(self, step: int) -> None:
        """Drop every key from steps < ``step``. Abandoned-step leftovers
        (kept for the master's transient-fault retry) are bounded by this:
        once the fleet moves past a step, its data is gone."""
        with self._cv:
            for k in [k for k in self._data
                      if (s := self._key_step(k)) is not None and s < step]:
                del self._data[k]

    def clear(self) -> None:
        with self._cv:
            self._data.clear()


class StageModuleRuntime:
    """One received stage module: its forward graph on the worker's
    device, the backward through ``stage_vjp``, and the optional shipped
    optimizer ``init``/``update`` graphs."""

    def __init__(self, gm, meta: Dict[str, Any], device: torch.device,
                 opt_init=None, opt_update=None):
        self.meta = meta
        self.device = device
        self._gm = gm
        self.opt_init = opt_init
        self.opt_update = opt_update
        self._n_out = len([n for n in gm.graph.nodes
                           if n.op == "output"][0].args[0])
        self._wired = set(meta.get("wired_cots", []))
        lo = meta.get("loss_out")
        self._loss_out = lo if lo is not None and lo >= 0 else None
        self._ppos = tuple(meta.get("param_positions", ()))
        from tepdist_tpu_torch.rpc import protocol
        self._param_avals = [(tuple(sh), protocol.torch_dtype(dt))
                             for sh, dt in meta.get("param_avals", ())]

    def forward(self, *args):
        with torch.no_grad():
            return tuple(self._gm(*args))

    def backward(self, *args):
        from tepdist_tpu_torch.parallel.pipeline import stage_vjp
        n_in = self.meta["n_invars"]
        it = iter(args[n_in:])
        cots = [next(it) if k in self._wired else None
                for k in range(self._n_out)]
        grads = stage_vjp(self._gm, args[:n_in], cots,
                          ones_at=self._loss_out)
        # An integer input (token ids) has no cotangent: zeros stand in,
        # as the reference substitutes them for float0.
        return tuple(torch.zeros(x.shape, dtype=torch.float32,
                                 device=self.device) if g is None else g
                     for g, x in zip(grads, args[:n_in]))

    def ga(self, acc, bwd_outs):
        return tuple(a + bwd_outs[p].to(a.dtype)
                     for a, p in zip(acc, self._ppos))

    def gainit(self):
        return tuple(torch.zeros(sh, dtype=dt, device=self.device)
                     for sh, dt in self._param_avals)


class WorkerPlan:
    """A dispatched per-worker task list, executable step by step."""

    def __init__(self, servicer, tasks: List[dict], plan_meta: Dict[str, Any]):
        self.servicer = servicer
        self.tasks = tasks
        self.meta = plan_meta
        self.task_index = plan_meta["task_index"]
        self.num_micro = plan_meta["num_micro_batches"]
        self.raw = servicer.raw_store
        self.device = servicer.device
        # Stamped onto peer pushes; receivers drop mismatched generations.
        self.plan_gen = getattr(servicer, "plan_gen", 0)
        self._peers: Dict[int, Any] = {}
        # stage id -> StageModuleRuntime (from servicer.stage_modules)
        self.stages = servicer.stage_modules
        # consumer task id -> (worker, key) routing for sends
        self.send_routes = {int(k): v for k, v in
                            plan_meta.get("send_routes", {}).items()}
        self.micro_rows = plan_meta.get("micro_rows")
        # Device-direct stage hops (pull tickets), for a peer in this
        # process: on by default on a card, where the pull is a device to
        # device copy and skips both host copies; on the CPU the push is
        # as cheap. TEPDIST_DEVICE_TRANSFER=0/1 overrides.
        env_knob = os.environ.get("TEPDIST_DEVICE_TRANSFER", "")
        if env_knob:
            self._device_xfer = env_knob != "0"
        else:
            self._device_xfer = self.device.type == "cuda"
        from tepdist_tpu_torch.core.service_env import ServiceEnv
        _env = ServiceEnv.get()
        self._send_overlap = bool(_env.tepdist_send_overlap)
        # Peer wire dtype: the local TEPDIST_WIRE_DTYPE knob wins, else
        # the exploration winner's planned comm dtype from plan_meta.
        self._wire_dtype = (_env.tepdist_wire_dtype
                            or plan_meta.get("comm_dtype", "") or None)
        from concurrent.futures import ThreadPoolExecutor
        self._send_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="peer-send")
        self._send_futures: List[Any] = []
        self._peer_lock = threading.Lock()
        # Idempotent step re-execution (transient-fault survival): a
        # replayed step returns its cached result; this step's parameter
        # and optimizer writes stage until the step completes, so an
        # abandoned step leaves the committed state at the previous step
        # and a retry recomputes bit-identically.
        self._completed: Dict[int, Dict[str, Any]] = {}
        self._completed_max = 4
        self._staged_vars: Dict[int, Any] = {}
        self._staged_opt: Dict[int, List[Any]] = {}
        self.opt_states: Dict[int, List[Any]] = {}
        # Push accounting (bytes, seconds) for reports.
        self.push_bytes = 0
        self.push_seconds = 0.0

    def close(self) -> None:
        """Drop this plan's async-send machinery (called when a new plan
        replaces it; stale pushes are generation-dropped anyway)."""
        try:
            self._send_pool.shutdown(wait=False, cancel_futures=True)
        except Exception:  # noqa: BLE001 — shutdown is best-effort
            pass

    def _place_local(self, val):
        if isinstance(val, torch.Tensor) and val.device != self.device:
            return val.to(self.device, copy=True)
        return val

    def _peer(self, task_index: int):
        from tepdist_tpu_torch.rpc.client import TepdistClient

        with self._peer_lock:
            if task_index not in self._peers:
                workers = self.meta["cluster"]["workers"]
                w = next(w for w in workers
                         if w["task_index"] == task_index)
                self._peers[task_index] = TepdistClient(
                    f"{w['ip']}:{w['port']}")
            return self._peers[task_index]

    def _peer_in_process(self, task_index: int) -> bool:
        w = next((w for w in self.meta["cluster"]["workers"]
                  if w["task_index"] == task_index), None)
        return bool(w and w["ip"] == "inproc")

    # ------------------------------------------------------------------
    def run_step(self, step: int) -> Dict[str, Any]:
        cached = self._completed.get(step)
        if cached is not None:
            # A replay of a completed step (its response was lost, or the
            # master's transient-fault retry reached a worker that had
            # finished): the updates are committed; re-running would
            # apply them twice.
            metrics().counter("dedup_hits").inc()
            self.raw.clear_step(step)
            self._push_shared()
            return cached
        self.servicer.release_parked_transfers(before_step=step)
        self.raw.clear_older(step)
        self._staged_vars = {}
        self._staged_opt = {}
        outputs: Dict[int, Tuple] = {}
        losses: List[torch.Tensor] = []

        def stage_args(task) -> List[Any]:
            s = task["stage"]
            meta = self.stages[s].meta
            args = []
            for pos in range(meta["n_invars"]):
                src = meta["input_def_map"][str(pos)]
                if src[0] == "arg":
                    gi = src[1]
                    if gi in meta["batch_indices"]:
                        key = f"batch:{step}:{task['micro']}:{gi}"
                        val = self.raw.get(key)
                        if val.device != self.device:
                            # Keep the DEVICE copy: fwd and its remat
                            # bwd both read this key.
                            val = self._place_local(val)
                            self.raw.put(key, val)
                        args.append(val)
                    else:
                        args.append(self.servicer.variables[gi])
                else:
                    pid, oi = task["input_specs"][str(pos)]
                    args.append(outputs[pid][oi])
            return args

        from tepdist_tpu_torch.core.service_env import ServiceEnv
        debug = ServiceEnv.get().debug
        with span("run_step", cat="step", step=step,
                  worker=self.task_index) as sp_step:
            for task in self.tasks:
                tt = task["type"]
                tid = task["node_id"]
                s = task["stage"]
                with span(task["name"], cat=tt, stage=s,
                          micro=task.get("micro"), step=step, task=tid,
                          worker=self.task_index) as sp:
                    try:
                        self._run_one(task, tt, tid, s, step, outputs,
                                      losses, stage_args, sp)
                    except TimeoutError:
                        self._abandon_step(step)
                        raise
                    except Exception as e:  # noqa: BLE001 — task context
                        self._abandon_step(step)
                        raise RuntimeError(
                            f"worker {self.task_index} failed at task "
                            f"{task['name']}#{tid} (step {step}): {e!r}"
                        ) from e
                if debug:
                    log.info("[task] %s#%d stage=%s %.3f ms", task["name"],
                             tid, s, sp.dur_ms)
            try:
                self._join_sends()
            except Exception:
                self._abandon_step(step)
                raise
            self._commit_staged()
            self._push_shared()
            self.raw.clear_step(step)
            # ONE host round trip for all micro losses and their fp32
            # sum on the device (the one-process executor's reduction).
            out = {"losses": []}
            if losses:
                stacked = torch.stack([x.float() for x in losses])
                vals = torch.cat([stacked, stacked.sum()[None]]).cpu()
                out = {"losses": vals[:-1].tolist(),
                       "loss_sum": float(vals[-1])}
        self._completed[step] = out
        while len(self._completed) > self._completed_max:
            del self._completed[min(self._completed)]
        metrics().counter("worker_steps").inc()
        if debug:
            log.info("[run_step] worker=%d step=%d %.3f ms",
                     self.task_index, step, sp_step.dur_ms)
        return out

    def _run_one(self, task, tt, tid, s, step, outputs, losses,
                 stage_args, sp=_NULL_SPAN) -> None:
        if tt == "compute" and task["name"].startswith("fwd"):
            outs = self.stages[s].forward(*stage_args(task))
            outputs[tid] = outs
            loss_out = self.stages[s].meta.get("loss_out")
            if loss_out is not None and loss_out >= 0:
                # A device scalar now; ONE host fetch at step end.
                losses.append(outs[loss_out])
        elif tt == "compute" and task["name"].startswith("bwd"):
            meta = self.stages[s].meta
            args = stage_args(task)
            cot_args = [outputs[pid][oi] for pos, (pid, oi) in
                        sorted(((int(p), v) for p, v in
                                task["input_specs"].items()))
                        if pos >= meta["n_invars"]]
            outputs[tid] = self.stages[s].backward(*args, *cot_args)
        elif tt == "send":
            pid, oi = task["input_specs"]["0"]
            val = outputs[pid][oi]
            route = self.send_routes.get(tid)
            outputs[tid] = (val,)
            if route is not None:
                peer_worker, key = route
                key = f"{key}:{step}"
                nb = _nbytes(val)
                sp.set(bytes=nb, peer=peer_worker)
                metrics().counter("transport_bytes_out").inc(nb)
                if peer_worker == self.task_index:
                    self.raw.put(key, val)
                elif (self._device_xfer
                      and self._peer_in_process(peer_worker)):
                    self._send_device_direct(peer_worker, key, val, step)
                elif self._send_overlap:
                    # Overlap the host copy, encode and peer RPC with the
                    # tail of this worker's compute; a failure surfaces at
                    # _join_sends.
                    self._send_futures.append(self._send_pool.submit(
                        self._send_host_push, peer_worker, key, val))
                else:
                    self._send_host_push(peer_worker, key, val)
        elif tt == "recv":
            parent = task["input_specs"].get("0")
            if parent is not None and parent[0] in outputs:
                # producer ran on this worker: local passthrough
                outputs[tid] = (outputs[parent[0]][parent[1]],)
            else:
                key = self.meta["recv_keys"][str(tid)] + f":{step}"
                val = self.raw.get(key)
                if isinstance(val, PendingPull):
                    try:
                        val = val.resolve()
                    except Exception as e:  # noqa: BLE001
                        # AbortStep frees the producer's parked buffers
                        # at once: surface the ABORT, not the secondary
                        # error, so the master classifies it right.
                        if self.raw._aborted:
                            raise StepAbortedError(
                                f"step aborted while pulling {key!r}"
                            ) from e
                        raise
                    # fwd AND remat bwd re-read this key; a pull is
                    # single-use, so keep the value instead.
                    self.raw.put(key, val)
                nb = _nbytes(val)
                sp.set(bytes=nb)
                metrics().counter("transport_bytes_in").inc(nb)
                if isinstance(val, tuple):
                    val = tuple(self._place_local(v) for v in val)
                else:
                    val = self._place_local(val)
                outputs[tid] = (val,)
        elif tt == "ga_init":
            outputs[tid] = (self.stages[s].gainit(),)
        elif tt == "ga":
            acc = outputs[task["input_specs"]["0"][0]][
                task["input_specs"]["0"][1]]
            bwd_outs = outputs[task["input_specs"]["1"][0]]
            outputs[tid] = (self.stages[s].ga(acc, tuple(bwd_outs)),)
        elif tt == "apply":
            acc = outputs[task["input_specs"]["0"][0]][
                task["input_specs"]["0"][1]]
            # Shared-parameter contributions from other stages arrive at
            # arg positions >= 1 (stage id + 1).
            extras = {}
            for pos_s, spec in task["input_specs"].items():
                if int(pos_s) >= 1:
                    extras[int(pos_s) - 1] = outputs[spec[0]][spec[1]]
            self._apply(s, acc, extras)
            outputs[tid] = ()
        else:
            outputs[tid] = ()
        # GC: release buffers whose last (scheduled) consumer just ran.
        for rid in task.get("mem_to_release", []):
            outputs.pop(rid, None)

    def _send_host_push(self, peer_worker: int, key: str, val) -> None:
        """Host-path peer send: the value to the host, encoded (with the
        opt-in wire dtype for f32/f64 payloads), and ONE
        TransferHostRawData to the consumer's store."""
        from tepdist_tpu_torch.rpc import protocol

        t0 = time.perf_counter()
        wd = self._wire_dtype
        if isinstance(val, tuple):  # GA accumulator bundles
            metas, blobs = [], []
            for v in val:
                m, b = protocol.encode_literal(v, wire_dtype=wd)
                metas.append(m)
                blobs.append(b)
            payload = protocol.pack_frames(
                {"raw_key": key, "plan_gen": self.plan_gen,
                 "literals": metas}, blobs)
        else:
            meta_l, blob = protocol.encode_literal(val, wire_dtype=wd)
            payload = protocol.pack_frames(
                {"raw_key": key, "plan_gen": self.plan_gen,
                 "literal": meta_l}, [blob])
        if self.raw._aborted:
            raise StepAbortedError(f"step aborted before send {key!r}")
        self._peer(peer_worker).stub.call(
            "TransferHostRawData", payload, timeout=60.0)
        self.push_bytes += _nbytes(val)
        self.push_seconds += time.perf_counter() - t0

    def _send_device_direct(self, peer_worker: int, key: str, val,
                            step: int) -> None:
        """Park ``val`` in this process's transfer registry and notify
        the consumer with a pull ticket (the data stays on the device;
        the message is control-plane only)."""
        from tepdist_tpu_torch.rpc import protocol

        vals = tuple(val) if isinstance(val, tuple) else (val,)
        uuid = park(vals)
        # Keep the parked buffers alive past the task-list GC until the
        # pull has landed (freed a step behind, or at AbortStep).
        self.servicer.park_transfer(step, uuid)
        payload = protocol.pack(
            {"raw_key": key, "plan_gen": self.plan_gen,
             "pull": {"uuid": uuid, "address": transfer_address(),
                      "bundle": isinstance(val, tuple),
                      "specs": [[list(v.shape), protocol.dtype_name(v.dtype)]
                                for v in vals]}})
        if self.raw._aborted:
            raise StepAbortedError(f"step aborted before send {key!r}")

        def notify():
            if self.raw._aborted:
                raise StepAbortedError(
                    f"step aborted before send {key!r}")
            self._peer(peer_worker).stub.call(
                "TransferHostRawData", payload, timeout=60.0)

        self._send_futures.append(self._send_pool.submit(notify))

    def _abandon_step(self, step: int) -> None:
        """Failed-step cleanup: cancel queued sends and discard the step's
        STAGED writes (the committed variables still hold the previous
        step, which makes a retry bit-identical). The step's store
        entries are KEPT for a transient-fault retry."""
        for f in self._send_futures:
            f.cancel()
        self._send_futures.clear()
        self._staged_vars = {}
        self._staged_opt = {}

    def _commit_staged(self) -> None:
        """Publish the completed step's parameter/optimizer updates (host
        dict writes, no RPC)."""
        for gi, p in self._staged_vars.items():
            self.servicer.variables[gi] = p
        self.opt_states.update(self._staged_opt)
        self._staged_vars = {}
        self._staged_opt = {}

    def _push_shared(self) -> None:
        """Send the committed value of every shared param this worker owns
        to the workers that also read it (``plan_meta["shared_push"]``),
        so their next step reads this step's update. (The JAX package's
        fleet leaves their copies at the loaded value: ROADMAP C9.)"""
        for gi_s, peers in self.meta.get("shared_push", {}).items():
            val = self.servicer.variables[int(gi_s)]
            for peer in peers:
                self._peer(int(peer)).transfer_to_server_host(
                    val, int(gi_s), variable=True)

    def _join_sends(self) -> None:
        futures, self._send_futures = self._send_futures, []
        for f in futures:
            f.result(timeout=90.0)

    def _stage_gis(self, t: int):
        if t in self.stages:
            return self.stages[t].meta["param_global_idx"]
        t_gis = {int(k): v for k, v in
                 self.meta.get("stage_param_gi", {}).items()}.get(t)
        if t_gis is None:
            raise KeyError(f"no param index map for remote stage {t}")
        return t_gis

    @torch.no_grad()
    def _apply(self, s: int, acc, extras=None) -> None:
        """Apply the mean gradient of the params OWNED by stage ``s``,
        adding shared params' contributions from other stages'
        accumulators, through the shipped optimizer graphs (SGD at the
        plan's rate without them). Reads see the COMMITTED state; writes
        stage until the step completes."""
        stage = self.stages[s]
        meta = stage.meta
        M = self.num_micro
        owned = meta.get("owned_global_idx", meta["param_global_idx"])
        if not owned:
            return
        gis = list(meta["param_global_idx"])
        rank = {gi: k for k, gi in enumerate(owned)}
        grads = [acc[gis.index(gi)] for gi in owned]
        for t in sorted((extras or {}).keys()):
            for j, gi in enumerate(self._stage_gis(t)):
                if gi in rank:
                    k = rank[gi]
                    grads[k] = grads[k] + extras[t][j].to(grads[k].device)
        grads = [g / M for g in grads]
        params = [self.servicer.variables[gi] for gi in owned]
        if stage.opt_update is not None:
            state = self.opt_states.get(s)
            if state is None:
                state = list(stage.opt_init(*params))
            outs = stage.opt_update(*params, *state, *grads)
            new_params = outs[:len(params)]
            self._staged_opt[s] = list(outs[len(params):])
        else:
            lr = self.meta.get("learning_rate", 0.01)
            new_params = [p - lr * g for p, g in zip(params, grads)]
        for gi, p in zip(owned, new_params):
            self._staged_vars[gi] = p
