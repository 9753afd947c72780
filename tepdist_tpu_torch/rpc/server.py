"""Tepdist RPC server: the service layer (the port of the JAX package's
``rpc/server.py``).

Reference parity: ``GRPCService`` over ``xla::Service`` with TePDist's
handlers (reference: rpc/grpc_service.{h,cc}, service/service_rt.cc):
  * BuildExecutionPlan (service_rt.cc:218): the step's graph from the wire
    (``rpc/fx_serde.py``) -> plan (``auto_parallel.plan_graph``) -> lower
    to a DTensor program -> plan cache handle; with no mesh, the
    server-side exploration, whose pipeline winner runs as a
    ``PipelineExecutable`` over the server's devices.
  * ExecutePlan (service_rt.cc:530): resolve inputs/variables, run, write
    aliased state back to the server-side variable store, return literals.
  * Variable registration / FetchResourceVars / checkpoint latching
    (ckpt_opts_ consumed on next ExecutePlan, service_rt.cc:84-118).
  * The fleet's worker verbs (TransferModuleAndDefCtx, DispatchPlan,
    ExecuteRemotePlan / ExecuteStepSlice, AbortStep, FetchShard /
    AdoptShard; ``rpc/worker_plan.py``), and the single-engine servable
    verbs (LoadServable, SubmitRequest, PollResult, CancelRequest, Drain,
    ExportPages / AdoptPages) over a supervised serving engine.

The server owns the devices (client machines need none): by default the
card, the CPU only when asked (``--device cpu``, ``devices=["cpu"]``). An
SPMD plan runs over the server's process group: a world of one rank on
its device, or, for a server started with ``--coordinator_address`` and
``--num_processes`` (the multi-host client's), one rank of a world whose
ranks compose the plan's mesh (rank 0 plans and broadcasts). ``grpc`` is
imported only where a server opens.
"""

from __future__ import annotations

import argparse
import logging
import os
import socket
import tempfile
import threading
import time
from collections import OrderedDict
from concurrent import futures
from typing import Any, Dict, List, Optional

import torch

from tepdist_tpu_torch.core.device import resolve_device
from tepdist_tpu_torch.core.mesh import MeshTopology
from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.core.tree import (tree_leaves, tree_structure,
                                         tree_unflatten)
from tepdist_tpu_torch.rpc import fx_serde, protocol
from tepdist_tpu_torch.rpc import retry as rpc_retry
from tepdist_tpu_torch.runtime import faults
from tepdist_tpu_torch.telemetry import flight
from tepdist_tpu_torch.telemetry import ledger as wire_ledger
from tepdist_tpu_torch.telemetry import metrics, span
from tepdist_tpu_torch.telemetry import watchtower

log = logging.getLogger("tepdist.server")

# Verbs whose handlers can run for seconds to minutes (execute, compile,
# model load). A gRPC server's bounded gate admits only so many of THESE
# at once, so the short control verbs (heartbeat Pings, AbortStep fences,
# telemetry pulls, serving polls) always find a free pool thread.
HEAVY_VERBS = frozenset({
    "ExecuteStepSlice", "ExecuteRemotePlan", "ExecutePlan",
    "BuildExecutionPlan", "LoadServable",
    # A stage's forward runs the model's layers: gate it with the other
    # compute verbs so control RPCs never queue behind it.
    "ExecuteServableSlice",
})


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def init_seed_for(seed: int, idx: int) -> int:
    """The fill seed of state leaf ``idx`` under ``init_seed`` (the
    reference folds the index into its PRNG key)."""
    return seed * 1_000_003 + idx


class ExecutionPlanCache:
    """handle -> compiled plan (reference: execution_plan_cache.h:34)."""

    def __init__(self):
        self._plans: Dict[int, Any] = {}
        self._next = 1
        self._lock = threading.Lock()

    def insert(self, plan) -> int:
        with self._lock:
            h = self._next
            self._next += 1
            self._plans[h] = plan
        return h

    def resolve(self, handle: int):
        plan = self._plans.get(handle)
        if plan is None:
            raise KeyError(f"unknown plan handle {handle}")
        return plan


class _CompiledPlan:
    """Server-side lowered plan + its argument routing metadata: ``exe``
    runs the step over DTensors (``SpmdExecutable``), ``place(i, val)``
    brings input ``i`` to its planned placements."""

    kind = "spmd"

    def __init__(self, exe, var_arg_indices, state_alias, n_invars,
                 donate=()):
        self.exe = exe
        self.var_arg_indices = var_arg_indices      # invar idx -> variable
        self.state_alias = state_alias              # out idx -> invar idx
        self.out_is_state = dict(state_alias)
        self.n_invars = n_invars
        self.donate = tuple(donate)

    def place(self, i: int, val):
        return self.exe.distribute_input(i, val)

    def run(self, args: List[Any]) -> List[Any]:
        return self.exe.run(args)


class _CompiledPipelinePlan:
    """A pipeline-winner plan from the service's explore mode: the
    task-graph runtime executable with server-held per-stage state
    (reference: the PIPELINE par type executing through the virtual-client
    task machinery rather than one SPMD module, service_rt.cc:218-308).

    State contract with the servicer's variable store: global indices
    0..n_params-1 are the parameter leaves, n_params..n_state-1 the
    optimizer-state leaves (the SAME layout the SPMD plans use), loaded
    into the executable lazily on first step / after a restore, and synced
    back on fetch/save."""

    kind = "pipeline"

    def __init__(self, exe, n_params, n_state, n_invars):
        self.exe = exe
        self.n_params = n_params
        self.n_state = n_state
        self.n_invars = n_invars          # n_state + batch leaves
        self.var_arg_indices = set(range(n_state))
        self.state_alias = {}             # state lives in the executable
        self.out_is_state = {}
        self.loaded = False
        self.retired = False

    def load_from_store(self, variables, with_opt_state: bool):
        """Pull params (and optionally optimizer slots) from the servicer's
        variable store into the per-stage runtime."""
        missing = [i for i in range(self.n_params) if i not in variables]
        if missing:
            raise KeyError(
                f"pipeline plan: parameter leaves {missing} neither "
                "transferred nor initialized")
        params = [_whole(variables[i]) for i in range(self.n_params)]
        self.exe.load_variables(params)   # re-inits per-stage opt states
        if with_opt_state:
            self.exe.load_opt_state(
                [_whole(variables[i])
                 for i in range(self.n_params, self.n_state)])
        self.loaded = True

    def state_leaves(self):
        """The runtime's current state as flat store-ordered leaves."""
        if not self.loaded:
            return None
        return (list(tree_leaves(self.exe.fetch_variables()))
                + list(tree_leaves(self.exe.fetch_opt_state())))


def _indexed(device: torch.device) -> torch.device:
    """A card named without an index as the current one (NCCL binds a
    process group to an indexed device)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _whole(val) -> torch.Tensor:
    """A stored value as one plain tensor (a DTensor gathered)."""
    return val.full_tensor() if hasattr(val, "full_tensor") else val


class _LossGraphs:
    """The loss as the client shipped it: one graph per batch shape (the
    full batch and, for the pipeline proposals, the micro batch; a
    captured graph bakes its trace shape, as a jaxpr's constants do).
    Called as ``loss(params_list, *batch)``, it runs the graph whose
    shapes match, so the exploration and the stage capture can trace it
    at either shape."""

    def __init__(self, graphs: List[torch.fx.GraphModule], n_params: int):
        self.n_params = n_params
        self.graphs = {self._key(g): g for g in graphs}

    @staticmethod
    def _key(gm) -> tuple:
        return tuple(tuple(n.meta["val"].shape) for n in gm.graph.nodes
                     if n.op == "placeholder")

    def example(self, gm, device):
        """(params list, batch list) of empty tensors at ``gm``'s
        shapes."""
        vals = [torch.empty(n.meta["val"].shape, dtype=n.meta["val"].dtype,
                            device=device)
                for n in gm.graph.nodes if n.op == "placeholder"]
        return vals[:self.n_params], vals[self.n_params:]

    def has_batch(self, batch) -> bool:
        """Whether a graph was shipped at ``batch``'s shapes."""
        key = tuple(tuple(x.shape) for x in tree_leaves(batch))
        return any(k[self.n_params:] == key for k in self.graphs)

    def __call__(self, plist, *batch):
        leaves = list(tree_leaves(plist)) + list(tree_leaves(batch))
        key = tuple(tuple(x.shape) for x in leaves)
        gm = self.graphs.get(key)
        if gm is None:
            raise ValueError(f"the client shipped no loss trace at batch "
                             f"shapes {key[self.n_params:]}")
        return gm(*leaves)[0]


class TepdistServicer:
    """All RPC method implementations (bytes in -> bytes out).

    Over several devices that can each hold a rank (distinct cards, CPU
    devices) the servicer takes the group form (``rpc/rank_group.py``):
    one rank process a device, each a one-device servicer of a world of
    ``len(devices)`` ranks, and every verb forwarded to all of them. Over
    one device, or a repeated card, it runs in this process; a world of
    several ranks is then the caller's (a multi-rank server)."""

    def __init__(self, devices=None, task_index: int = 0):
        from tepdist_tpu_torch.rpc import rank_group

        self.devices = [_indexed(resolve_device(d))
                        for d in (devices if devices is not None
                                  else ["cuda"])]
        self.device = self.devices[0]
        self.task_index = task_index
        self.rank_group = (rank_group.RankGroup(self.devices, task_index)
                           if rank_group.takes_group_form(self.devices)
                           else None)
        # A rank of a group-form servicer other than rank 0 gathers state
        # with the others on a save and writes nothing.
        self.ckpt_writer = True
        self.plan_cache = ExecutionPlanCache()
        # global_idx -> tensor (server-held variables; DTensors once a
        # step has run; reference WholeGraphLaunchContext +
        # RegisteredForVariable).
        self.variables: Dict[int, Any] = {}
        self.inputs: Dict[int, Any] = {}     # per-step input literals
        self.var_arg_map: Dict[int, int] = {}
        self.global_step = 0
        self.ckpt_opts: Dict[str, Any] = {}  # latched save/restore
        self.ckpt_dir = os.environ.get(
            "TEPDIST_CKPT_DIR",
            os.path.join(tempfile.gettempdir(), "tepdist_ckpt"))
        self.cluster_spec: Dict[str, Any] = {}
        self._lock = threading.Lock()
        # Serialize plan execution: pipelined client submissions must run in
        # arrival order against a consistent variable store (reference:
        # execute_plan_mutex_, service_rt.cc:619).
        self._exec_lock = threading.Lock()
        from tepdist_tpu_torch.rpc.worker_plan import RawStore
        self.raw_store = RawStore()
        # Raw pushes tagged with another plan generation are dropped (the
        # fleet's DispatchPlan bumps it, item 16).
        self.plan_gen = 0
        # Epoch fence: highest master_epoch this worker has seen on any
        # header; mutating verbs carrying an OLDER epoch are rejected with
        # StaleEpochError before any state changes. -1 = never fenced.
        self.master_epoch = -1
        # Idempotency dedup: token -> cached response bytes for mutating
        # verbs (ExecutePlan / TransferToServerHost). A client retry whose
        # original request WAS applied (response lost in transit) replays
        # the same token and gets the cached answer. Bounded LRU.
        self._idem_cache: "OrderedDict[str, bytes]" = OrderedDict()
        self._idem_lock = threading.Lock()
        self._active_pipeline: Optional[_CompiledPipelinePlan] = None
        self._pipeline_restored = False
        # Slave-side distributed plan state (reference lifecycle §3.5):
        # module id -> stage runtime, and the dispatched task list.
        self.modules: Dict[int, bytes] = {}
        self.stage_modules: Dict[int, Any] = {}
        self.worker_plan = None
        # step -> parked transfer-registry uuids (device-direct hops):
        # kept alive until the consumer's pull has landed (a step behind),
        # or freed at AbortStep.
        self._parked_transfers: Dict[int, List[int]] = {}
        self._pull_pool_obj = None
        # Serving engines: servable_id -> supervised engine.
        self.servables: Dict[str, Any] = {}
        self._servable_next = 1
        # Live migration staging: optimizer slots adopted BEFORE the
        # migration's DispatchPlan lands; its carry_state merge reads it.
        self.adopted_opt: Dict[int, List[Any]] = {}
        self._migration_peers: Dict[str, Any] = {}

    # -- idempotency dedup (see _idem_cache in __init__) ----------------
    _IDEM_CACHE_MAX = 128

    def _idem_get(self, header) -> Optional[bytes]:
        tok = header.get("idem")
        if tok is None:
            return None
        with self._idem_lock:
            resp = self._idem_cache.get(tok)
        if resp is not None:
            metrics().counter("dedup_hits").inc()
            log.info("idempotent replay deduped: %s", tok)
        return resp

    def _idem_put(self, header, resp: bytes) -> bytes:
        tok = header.get("idem")
        if tok is not None:
            with self._idem_lock:
                self._idem_cache[tok] = resp
                while len(self._idem_cache) > self._IDEM_CACHE_MAX:
                    self._idem_cache.popitem(last=False)
        return resp

    def _check_epoch(self, header) -> None:
        """Epoch fence: latch newer epochs, reject older ones. Runs FIRST
        in every mutating handler, before the idem cache, before fault
        injection, before any effect, so a rejected verb provably mutated
        nothing."""
        e = header.get("master_epoch")
        if e is None:
            return
        e = int(e)
        with self._lock:
            cur = self.master_epoch
            if e >= cur:
                self.master_epoch = e
                return
        metrics().counter("stale_epoch_rejections").inc()
        log.warning("worker %d rejected stale master_epoch %d (< %d)",
                    self.task_index, e, cur)
        raise rpc_retry.StaleEpochError(
            f"STALE_EPOCH seen={e} current={cur} worker={self.task_index}",
            seen=e, current=cur)

    def _inject_server_fault(self, verb: str) -> None:
        plan = faults.active()
        if plan is not None:
            plan.server_fault(verb, self.task_index)

    def park_transfer(self, step: int, uuid: int) -> None:
        with self._lock:
            self._parked_transfers.setdefault(step, []).append(uuid)
        metrics().counter("transfers_parked").inc()

    def release_parked_transfers(self, before_step: Optional[int] = None
                                 ) -> int:
        from tepdist_tpu_torch.rpc.worker_plan import unpark

        with self._lock:
            gone = [st for st in self._parked_transfers
                    if before_step is None or st < before_step]
            uuids = [u for st in gone for u in self._parked_transfers[st]]
            for st in gone:
                del self._parked_transfers[st]
        freed = unpark(uuids)
        if freed:
            metrics().counter("transfers_freed").inc(freed)
        return freed

    def _pull_pool(self):
        if self._pull_pool_obj is None:
            self._pull_pool_obj = futures.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="ticket-pull")
        return self._pull_pool_obj

    def _sync_active_pipeline(self) -> None:
        """Flush the live pipeline runtime's state into the variable store
        before ANY store read (fetch / save / an SPMD plan resolving
        variable args). Takes _exec_lock so the sync cannot observe a
        torn mid-step state."""
        ap = self._active_pipeline
        if ap is None:
            return
        with self._exec_lock:
            flat = ap.state_leaves()
            if flat is not None:
                with self._lock:
                    for i, leaf in enumerate(flat):
                        self.variables[i] = leaf

    def _retire_active_pipeline(self) -> None:
        """A new STATE-WRITING plan supersedes the live pipeline runtime:
        flush its state once and stop treating it as the store's source
        of truth. The retired runtime refuses further steps. Read-only
        plans (compile_generate: empty state_alias) do NOT retire it."""
        ap = self._active_pipeline
        if ap is None:
            return
        self._sync_active_pipeline()
        ap.retired = True
        self._active_pipeline = None

    def _ensure_world(self) -> None:
        """The process group the server's SPMD plans run over: the
        process's world when it has one (a multi-rank server's, made at
        start), else a world of one rank on its device (NCCL on a card,
        gloo on the CPU), made at the first plan."""
        import torch.distributed as dist

        if dist.is_initialized():
            return
        cuda = self.device.type == "cuda"
        dist.init_process_group(
            "nccl" if cuda else "gloo",
            init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
            world_size=1, **({"device_id": self.device} if cuda else {}))

    @staticmethod
    def _world() -> int:
        """The ranks an SPMD or seq mesh may span (one device a rank)."""
        import torch.distributed as dist

        return dist.get_world_size() if dist.is_initialized() else 1

    def _graph(self, blob) -> torch.fx.GraphModule:
        with span("planner:deserialize", cat="planner"):
            return fx_serde.deserialize_graph(blob, device=self.device)

    # ------------------------------------------------------------------
    def _explore_plan(self, opts, blobs):
        """Server-side fully-automatic planning (reference: the service
        invokes AutoParallel's exploration itself, RunExplorationlMode
        from BuildExecutionPlan, auto_parallel.cc:236 +
        service_rt.cc:218-308): rebuild the loss from its shipped graphs,
        search the UNIFIED candidate space (SPMD / seq / pipeline stage
        cuts) for this server's devices, and return the Evaluator-minimal
        winner.

        Returns (winner_dict, loss, params, batch, optimizer,
        explored_summary)."""
        from tepdist_tpu_torch.optim import make_optimizer
        from tepdist_tpu_torch.parallel.exploration import (
            candidate_summary, explore)
        from tepdist_tpu_torch.parallel.pipeline import (
            micro_abstract_batch, on_rank0)

        n_p = int(opts["n_param_leaves"])
        full = self._graph(blobs[int(opts["loss_module_blob"])])
        graphs = [full]
        if "micro_loss_module_blob" in opts:
            graphs.append(self._graph(
                blobs[int(opts["micro_loss_module_blob"])]))
        micro_ok = len(graphs) > 1
        graphs += [self._graph(blobs[int(i)])
                   for i in opts.get("replica_loss_module_blobs") or ()]
        loss = _LossGraphs(graphs, n_p)
        params, batch = loss.example(full, self.device)
        opt_spec = opts.get("optimizer_spec")
        optimizer = make_optimizer(opt_spec) if opt_spec else None
        M = max(int(opts.get("num_micro_batches", 1)), 1)
        # Pipeline proposals need the loss at MICRO-batch shapes, so the
        # service explores pipeline cuts only at the CLIENT's M, for which
        # a micro trace was shipped; pipeline and seq winners re-compose
        # the step SERVER-side, which needs the optimizer's update rule.
        include = optimizer is not None and (micro_ok or M == 1)
        # SPMD and seq meshes span the world's ranks. Pipeline stages are
        # cut from the world's ranks where the server has several (its
        # group form, or a multi-rank server), and a stage may then be
        # TP over its group's ranks; a one-rank server cuts them from its
        # device list and runs them in one process, which holds no TP
        # group.
        world = self._world()
        n_pipe = world if world > 1 else len(self.devices)
        if include:
            # A stage over R intra-stage replicas is captured at a
            # replica's share of the micro rows: every share the explore
            # may propose (R = a group's devices over its TP degree, so R
            # divides the devices and is at most half of them; R dividing
            # the rows) must have been shipped.
            rows = tree_leaves(batch)[0].shape[0] // M
            missing = [
                r for r in range(2, n_pipe // 2 + 1)
                if n_pipe % r == 0 and rows % r == 0 and not loss.has_batch(
                    micro_abstract_batch(tuple(batch), M, replicas=r))]
            if missing:
                raise ValueError(
                    f"the client shipped no loss trace at a replica's "
                    f"share of the {rows} micro rows for R in {missing} "
                    f"(a server on {n_pipe} devices may place a stage "
                    "over any of them)")

        def search():
            best = explore(
                loss, params, *batch, n_devices=world,
                pipeline_devices=n_pipe, num_micro_batches=M,
                include_pipeline=include, include_seq=include,
                pipeline_micro_options=[M], pipeline_stage_tp=world > 1,
                entry_point="BuildExecutionPlan")
            return ({k: v for k, v in best.items()
                     if k not in ("candidates", "strategies", "cost")},
                    candidate_summary(best["candidates"], best))

        # Rank 0 explores and sends the winner to every rank (the search
        # has time limits, so ranks exploring alone could disagree).
        best, rows = on_rank0(search)
        explored = {
            "winner": best["kind"],
            "candidates": rows,
        }
        if "report" in best:
            # The full decision record rides the explore RPC (plain JSON
            # header payload); the client embeds it in dump_trace().
            explored["report"] = best["report"]
        explored["pipeline_form"] = (
            f"{world} ranks, one a device: stage cuts with intra-stage TP"
            if world > 1 else
            f"one process over {n_pipe} device(s): stage cuts without "
            "intra-stage TP (one process holds no TP group)")
        if best.get("excluded_kinds"):
            explored["excluded_kinds"] = best["excluded_kinds"]
            explored["excluded_reason"] = (
                "no optimizer_spec from client" if optimizer is None
                else "no micro-shape loss trace")
        return best, loss, params, batch, optimizer, explored

    def _recompose_step(self, loss, optimizer, num_micro_batches,
                        topology, params, batch, n_state):
        """The full training step composed again server-side (gradients +
        GA + the optimizer's apply: ``client/session.py``'s composition),
        for an explore winner whose step differs from the shipped one: a
        ``seq`` axis rewrites the loss's attention into the ring or
        Ulysses op first, at the shapes GA evaluates the loss at (the
        micro batch's for M > 1). Returns the captured step's graph."""
        from tepdist_tpu_torch.graph.fx_graph import trace_graph
        from tepdist_tpu_torch.parallel.pipeline import micro_abstract_batch
        from tepdist_tpu_torch.parallel.sync_free import build_ga_step
        from tepdist_tpu_torch.train import value_and_grad

        if optimizer is None:
            raise ValueError("a seq winner composes the step server-side: "
                             "the client must send its optimizer_spec")
        seq = dict(topology.device_axes()).get("seq", 1)
        if seq > 1:
            from tepdist_tpu_torch.parallel.attention_motif import (
                seq_rewritten_loss)
            micro = (micro_abstract_batch(tuple(batch), num_micro_batches)
                     if num_micro_batches > 1 else tuple(batch))
            loss, _impl = seq_rewritten_loss(loss, seq, list(params),
                                             *micro)

        def apply_fn(p, st, g):
            return p, optimizer.apply(p, g, st)

        step_fn = build_ga_step(
            value_and_grad(loss), apply_fn, num_micro_batches,
            batch_argnums=tuple(range(1, 1 + len(batch))))
        plist = list(params)
        opt_state = optimizer.init(plist)
        n_server = len(plist) + len(tree_leaves(opt_state))
        if n_server != n_state:
            raise ValueError(
                f"server-composed state has {n_server} leaves but the "
                f"client registered {n_state}: the optimizer_spec does "
                "not match the client's optimizer")
        graph, _, _ = trace_graph(step_fn, plist, opt_state, *batch,
                                  functional=True)
        return graph.gm

    def _build_pipeline_plan(self, opts, best, loss, params, batch,
                             optimizer, explored, t0) -> bytes:
        """Materialize a pipeline explore winner as the plan behind the
        handle: plan the stage cut, build the task-graph runtime (over the
        world's ranks in the group form, one device a rank; else over this
        server's devices in one process), and register a pipeline-kind
        plan (reference: the PIPELINE DeviceSplitPlan compiled into
        per-stage def-modules + task graph, service_rt.cc:218-308)."""
        from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
        from tepdist_tpu_torch.runtime.executor import (PipelineExecutable,
                                                        stage_replicas)

        S = best["num_stages"]
        M = best["num_micro_batches"]
        tp = best.get("intra_tp", 1)
        placement = best.get("placement", "blocked")
        il_groups = best.get("interleave_groups")
        n_params = len(params)
        n_state = n_params + len(tree_leaves(optimizer.init(
            [torch.empty_like(p) for p in params])))
        n_state_client = len(opts.get("variable_indices", []))
        if n_state_client and n_state != n_state_client:
            raise ValueError(
                f"server-composed state has {n_state} leaves but the "
                f"client registered {n_state_client}: the optimizer_spec "
                "does not match the client's optimizer")
        world = self._world()
        devices = [self.device] * world if world > 1 else self.devices
        prog = plan_pipeline(loss, S, M, params, *batch,
                             replicas=stage_replicas(
                                 len(devices), S, tp, placement, il_groups))
        prog.comm_dtype = best.get("comm_dtype", "")
        prog.zero = bool(best.get("zero", False))
        summary = {
            "axes": [["stage", S]] + ([["model", tp]] if tp > 1 else []),
            "mode": "explore",
            "kind": "pipeline",
            "num_stages": S,
            "num_micro_batches": M,
            "intra_tp": tp,
            "placement": placement,
            "interleave_groups": il_groups,
            "explored": explored,
        }
        exe = PipelineExecutable(prog, devices=devices,
                                 optimizer=optimizer, intra_stage_tp=tp,
                                 placement=placement,
                                 interleave_groups=il_groups)
        summary["planner_seconds"] = round(time.time() - t0, 3)
        plan = _CompiledPipelinePlan(exe, n_params, n_state,
                                     n_state + len(batch))
        handle = self.plan_cache.insert(plan)
        # The store's state reads (FetchResourceVars / checkpoints) must
        # see this runtime's live state once it loads.
        self._active_pipeline = plan
        self._init_variables(opts, summary)
        log.info("BuildExecutionPlan handle=%d %s", handle, summary)
        return protocol.pack({"handle": handle, "summary": summary})

    def _init_variables(self, opts, summary, plan=None) -> None:
        """Server-side variable initialization (reference: init_from_remote
        + init_specs_map: weights are created on the server's devices and
        NEVER travel), each leaf in its planned placements."""
        init_specs = opts.get("init_specs") or {}
        if not init_specs:
            return
        from tepdist_tpu_torch.runtime.initializers import init_from_spec

        seed = int(opts.get("init_seed", 0))
        with self._lock:
            for idx_s, spec in init_specs.items():
                idx = int(idx_s)
                if plan is not None:
                    self.variables[idx] = init_from_spec(
                        init_seed_for(seed, idx), spec, plan.exe.mesh,
                        list(plan.exe.plan.in_specs[idx]))
                else:
                    self.variables[idx] = init_from_spec(
                        init_seed_for(seed, idx), spec, device=self.device)
        summary["initialized_vars"] = len(init_specs)

    def BuildExecutionPlan(self, request: bytes, context=None) -> bytes:
        header, blobs = protocol.unpack(request)
        opts = header.get("options", {})
        t0 = time.time()
        # A new STATE-WRITING plan (training: non-empty state_alias)
        # supersedes any live pipeline runtime as the store's source of
        # truth. Read-only plans (compile_generate) leave it active.
        if opts.get("state_alias"):
            self._retire_active_pipeline()

        from tepdist_tpu_torch.core.dist_spec import DimStrategy
        from tepdist_tpu_torch.graph.fx_graph import FxGraph
        from tepdist_tpu_torch.parallel.auto_parallel import plan_graph

        mode = opts.get("mode", "cost")
        axes = opts.get("mesh_axes")
        explored = None
        recompose = None
        env = ServiceEnv.get()
        if (opts.get("explore") and not axes and mode != "rule"
                and env.opt_level >= 1 and "loss_module_blob" in opts):
            with span("planner:explore", cat="planner"):
                (best, loss, params, batch, optimizer,
                 explored) = self._explore_plan(opts, blobs)
            if best["kind"] == "pipeline":
                return self._build_pipeline_plan(
                    opts, best, loss, params, batch, optimizer, explored,
                    t0)
            axes = [[a, n] for a, n in best["topology"].device_axes()]
            if any(a == "seq" and n > 1 for a, n in axes):
                # The shipped step traced plain attention; the seq winner
                # runs the ring/Ulysses rewrite: the step is composed
                # again here and THAT is planned.
                M_c = max(int(opts.get("num_micro_batches", 1)), 1)
                n_state = len(opts.get("variable_indices", []))

                def recompose(topo):
                    return self._recompose_step(loss, optimizer, M_c, topo,
                                                params, batch, n_state)
        if not axes:
            axes = [["data", self._world()]]
        topology = MeshTopology(
            [(a, int(n)) for a, n in axes],
            share_dev_flags=opts.get("share_dev_flags"))
        self._ensure_world()
        import torch.distributed as dist

        world = dist.get_world_size()
        if topology.num_devices != world:
            raise ValueError(
                f"a plan over {topology.num_devices} devices ({axes}) runs "
                f"one rank a device; this server's world has {world} "
                "rank(s) (start the servers with --coordinator_address and "
                "--num_processes for a multi-host plan)")
        if recompose is not None:
            gm = recompose(topology)
        else:
            gm = self._graph(blobs[0])
        with span("planner:sketch", cat="planner"):
            graph = FxGraph(gm)
        annotations = None
        if opts.get("annotations"):
            annotations = {
                int(i): {ax: DimStrategy(**d) for ax, d in spec.items()}
                for i, spec in opts["annotations"].items()
            }
        state_alias = {int(k): int(v)
                       for k, v in (opts.get("state_alias") or {}).items()}
        with span("planner:strategy_ilp", cat="planner", mode=mode):
            pplan = plan_graph(graph, topology, annotations=annotations,
                               mode=mode, state_alias=state_alias)
        with span("planner:spmd_transform", cat="planner"):
            exe = pplan.executable(self.device.type)
        var_idx = set(int(i) for i in opts.get("variable_indices", []))
        summary = {
            "axes": [[a, n] for a, n in zip(topology.axis_names,
                                            topology.split_nums)],
            "in_specs": [str(s) for s in pplan.sharding_plan.in_specs],
            "mode": mode,
            "planner_seconds": round(time.time() - t0, 3),
            "graph_nodes": len(graph),
        }
        if explored is not None:
            summary["explored"] = explored
        plan = _CompiledPlan(exe, var_idx, state_alias, len(graph.invars),
                             donate=pplan.state_donation())
        handle = self.plan_cache.insert(plan)
        if env.debug:
            # Reference parity: def-module text dumped per compile
            # (service.cc:732-735): here the planned graph + specs.
            from tepdist_tpu_torch.core.debug_dump import write_dump
            write_dump(f"plan_{handle}.graph.txt", f"{summary}\n\n{gm.code}")
        self._init_variables(opts, summary, plan)
        log.info("BuildExecutionPlan handle=%d %s", handle,
                 {k: v for k, v in summary.items() if k != "in_specs"})
        return protocol.pack({"handle": handle, "summary": summary})

    # ------------------------------------------------------------------
    def TransferToServerHost(self, request: bytes, context=None) -> bytes:
        """Register a literal: variable (cached across steps) or per-step
        input, keyed by global arg index (reference
        TransferToServerRequest.{variable,global_idx})."""
        header, blobs = protocol.unpack(request)
        self._check_epoch(header)
        cached = self._idem_get(header)
        if cached is not None:
            return cached
        idx = int(header["global_idx"])
        val = self._to_device(protocol.decode_literal(header["literal"],
                                                      blobs[0]))
        with self._lock:
            if header.get("variable"):
                self.variables[idx] = val
            else:
                self.inputs[idx] = val
        return self._idem_put(header,
                              protocol.pack({"ok": True, "global_idx": idx}))

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        """A decoded literal on the server's device (a copy: the literal
        borrows the request's buffer)."""
        return t.to(self.device, copy=True)

    def TransferHostRawData(self, request: bytes, context=None) -> bytes:
        """Raw-keyed per-step data (reference: per-step input slices +
        peer-to-peer activation pushes in the RPC transport): the raw-key,
        multi and tuple forms; without a raw key, a literal as
        TransferToServerHost."""
        header, blobs = protocol.unpack(request)
        self._check_epoch(header)
        if "raw_key" in header or "raw_multi" in header:
            self._inject_server_fault("TransferHostRawData")
            gen = header.get("plan_gen")
            if gen is not None and gen != self.plan_gen:
                # Stale-plan push: acknowledge but do not store.
                return protocol.pack({"ok": False, "stale_plan_gen": gen})
            if "raw_multi" in header:
                # Batched keyed literals (all micro slices of one leaf).
                for i, ent in enumerate(header["raw_multi"]):
                    self.raw_store.put(
                        ent["raw_key"], protocol.decode_literal(
                            ent["literal"], blobs[i]).clone())
            elif "pull" in header:
                # Device-direct ticket: the value stays on the producer's
                # device. PREFETCH: the pull starts NOW on a pool thread,
                # so the consumer's recv overlaps the copy.
                from tepdist_tpu_torch.rpc.worker_plan import (PendingPull,
                                                               PullTicket)
                ticket = PullTicket(**header["pull"])
                self.raw_store.put(header["raw_key"], PendingPull(
                    self._pull_pool().submit(ticket.pull, self.device)))
            elif "literals" in header:  # tuple payload (GA accumulators)
                vals = tuple(protocol.decode_literal(m, blobs[i]).clone()
                             for i, m in enumerate(header["literals"]))
                self.raw_store.put(header["raw_key"], vals)
            else:
                self.raw_store.put(header["raw_key"], protocol.decode_literal(
                    header["literal"], blobs[0]).clone())
            return protocol.pack({"ok": True})
        return self.TransferToServerHost(request, context)

    def TransferVarArgMap(self, request: bytes, context=None) -> bytes:
        header, _ = protocol.unpack(request)
        self._check_epoch(header)
        self.var_arg_map = {int(k): int(v)
                            for k, v in header["var_arg_map"].items()}
        return protocol.pack({"ok": True})

    # ------------------------------------------------------------------
    def _fetched(self, plan, out_blobs) -> Dict[str, Any]:
        """The plan's variables as literals appended to ``out_blobs``."""
        fetched = {}
        with self._lock:
            for ii in sorted(plan.var_arg_indices):
                if ii in self.variables:
                    m, b = protocol.encode_literal(_whole(self.variables[ii]))
                    fetched[str(ii)] = {"meta": m, "blob": len(out_blobs)}
                    out_blobs.append(b)
        return fetched

    def _inline(self, header, blobs, i: int):
        meta = header["inline_meta"][str(i)]
        return self._to_device(protocol.decode_literal(
            meta, blobs[int(header["inline"][str(i)])]))

    def _execute_pipeline_plan(self, plan, header, blobs, sp) -> bytes:
        """ExecutePlan for a pipeline-kind plan (service explore winner):
        batch leaves route to the task-graph runtime; state lives in the
        per-stage executable and syncs through the variable store on
        fetch/save/restore."""
        if plan.retired:
            raise RuntimeError(
                "pipeline plan was superseded by a newer state-writing "
                "plan; its runtime is detached from the variable store: "
                "recompile instead of stepping the old handle")
        fetch = bool(header.get("fetch_resource_variables"))
        if self.ckpt_opts.get("restore"):
            self._do_restore(self.ckpt_opts.pop("restore"))
        inline = header.get("inline") or {}
        batch_vals: List[Any] = []
        with self._lock:
            for i in range(plan.n_state, plan.n_invars):
                if str(i) in inline:
                    val = self._inline(header, blobs, i)
                elif i in self.inputs:
                    val = self.inputs[i]
                else:
                    raise KeyError(
                        f"batch arg {i} neither transferred nor inline")
                batch_vals.append(val)
        with self._exec_lock:
            if not plan.loaded:
                with self._lock:
                    snapshot = dict(self.variables)
                plan.load_from_store(snapshot,
                                     with_opt_state=self._pipeline_restored)
                self._pipeline_restored = False
            loss = plan.exe.step(*batch_vals)
            if not header.get("inference"):
                self.global_step += 1
        if self.ckpt_opts.get("save"):
            self._do_save(self.ckpt_opts.pop("save"))
        meta, blob = protocol.encode_literal(
            torch.tensor(loss, dtype=torch.float32))
        out_blobs = [blob]
        fetched = {}
        if fetch:
            self._sync_active_pipeline()
            fetched = self._fetched(plan, out_blobs)
        sp.set(step=self.global_step)
        return protocol.pack(
            {"outputs": [meta], "output_indices": [0],
             "fetched": fetched, "global_step": self.global_step},
            out_blobs)

    def ExecutePlan(self, request: bytes, context=None) -> bytes:
        header, blobs = protocol.unpack(request)
        self._check_epoch(header)
        cached = self._idem_get(header)
        if cached is not None:
            return cached
        self._inject_server_fault("ExecutePlan")
        handle = int(header["handle"])
        plan = self.plan_cache.resolve(handle)
        with span("ExecutePlan", cat="rpc", handle=handle,
                  kind=plan.kind) as sp:
            resp = self._execute_plan_body(plan, header, blobs, sp)
        if ServiceEnv.get().debug:
            log.info("[ExecutePlan Duration] step=%d %.1f ms (%s)",
                     self.global_step, sp.dur_ms, plan.kind)
        return self._idem_put(header, resp)

    def _execute_plan_body(self, plan, header, blobs, sp) -> bytes:
        if plan.kind == "pipeline":
            return self._execute_pipeline_plan(plan, header, blobs, sp)
        # An SPMD plan (e.g. compile_generate) reading variables while a
        # pipeline runtime is live must see ITS state, not the store's
        # stale copy.
        if plan.var_arg_indices:
            self._sync_active_pipeline()
        fetch = bool(header.get("fetch_resource_variables"))
        # Consume a latched restore before stepping (reference: lazy
        # restore consumed during warm-up, virtual_client.cc:2867-2870).
        if self.ckpt_opts.get("restore"):
            self._do_restore(self.ckpt_opts.pop("restore"))
        inline = header.get("inline") or {}
        args: List[Any] = []
        with self._exec_lock:
            with self._lock:
                for i in range(plan.n_invars):
                    if str(i) in inline:
                        val = self._inline(header, blobs, i)
                    elif i in plan.var_arg_indices and i in self.variables:
                        val = self.variables[i]
                    elif i in self.inputs:
                        val = self.inputs[i]
                    else:
                        raise KeyError(
                            f"arg {i} neither transferred nor inline")
                    args.append(plan.place(i, val))
                # Donation: the store gives up the aliased state for the
                # step (the args list is its only holder, so each leaf is
                # freed after its last use); the outputs replace it.
                donated = [ii for ii in plan.donate if ii in self.variables]
                for ii in donated:
                    del self.variables[ii]
            try:
                outs = plan.run(args)
            except Exception:
                if donated:
                    log.error(
                        "ExecutePlan failed after buffer donation; "
                        "variables %s invalidated: re-transfer them or "
                        "DoRemoteRestore before the next step",
                        sorted(donated))
                raise
            # Write aliased state back into the variable store.
            with self._lock:
                for oi, ii in plan.state_alias.items():
                    self.variables[ii] = outs[oi]
            if not header.get("inference"):
                # Inference plans (generate) read weights without advancing
                # the training step counter checkpoints are named by.
                self.global_step += 1
            metas, out_blobs, out_idx = [], [], []
            for oi, val in enumerate(outs):
                if oi in plan.out_is_state:
                    continue
                meta, blob = protocol.encode_literal(_whole(val))
                metas.append(meta)
                out_blobs.append(blob)
                out_idx.append(oi)
        if self.ckpt_opts.get("save"):
            self._do_save(self.ckpt_opts.pop("save"))
        fetched = self._fetched(plan, out_blobs) if fetch else {}
        sp.set(step=self.global_step)
        return protocol.pack(
            {"outputs": metas, "output_indices": out_idx,
             "fetched": fetched, "global_step": self.global_step},
            out_blobs)

    # ------------------------------------------------------------------
    def FetchResourceVars(self, request: bytes, context=None) -> bytes:
        header, _ = protocol.unpack(request)
        idxs = header.get("indices")
        self._sync_active_pipeline()
        with self._lock:
            if idxs is None:
                idxs = sorted(self.variables)
            metas, out_blobs = [], []
            for i in idxs:
                meta, blob = protocol.encode_literal(
                    _whole(self.variables[int(i)]))
                meta["global_idx"] = int(i)
                metas.append(meta)
                out_blobs.append(blob)
        return protocol.pack({"vars": metas}, out_blobs)

    def InitMeshTopology(self, request: bytes, context=None) -> bytes:
        header, _ = protocol.unpack(request)
        self._check_epoch(header)
        self.cluster_spec = header.get("cluster_spec", {})
        return protocol.pack({"ok": True,
                              "n_devices": len(self.devices)})

    # ------------------------------------------------------------------
    def DoRemoteSave(self, request: bytes, context=None) -> bytes:
        header, _ = protocol.unpack(request)
        self._check_epoch(header)
        gs = header.get("global_step")
        opts = {"max_to_keep": int(header.get("max_to_keep") or 5),
                "global_step": self.global_step if gs is None else int(gs)}
        if header.get("lazy"):
            self.ckpt_opts["save"] = opts   # latched (warm-up semantics)
        else:
            self._do_save(opts)
        return protocol.pack({"ok": True})

    def DoRemoteRestore(self, request: bytes, context=None) -> bytes:
        header, _ = protocol.unpack(request)
        self._check_epoch(header)
        opts = {"global_step": int(header.get("global_step", -1)),
                "all_shards": bool(header.get("all_shards"))}
        if header.get("lazy"):
            self.ckpt_opts["restore"] = opts
            return protocol.pack({"ok": True})
        self._do_restore(opts)
        return protocol.pack({"ok": True, "global_step": self.global_step})

    def _do_save(self, opts) -> None:
        from tepdist_tpu_torch.runtime.checkpoint import CheckpointUtil

        self._sync_active_pipeline()
        if not self.ckpt_writer:
            # A group-form rank other than rank 0: gather each DTensor
            # leaf with the writer, in its order, and write nothing.
            with self._lock:
                for v in list(self.variables.values()):
                    _whole(v)
            return
        with self._lock:
            # DTensor leaves are gathered by the writer, one at a time.
            data = {str(k): v for k, v in self.variables.items()}
            # Worker-side optimizer slots are recoverable state too.
            if self.worker_plan is not None:
                for stage, slots in self.worker_plan.opt_states.items():
                    for j, slot in enumerate(slots):
                        data[f"opt:{stage}:{j}"] = slot
            CheckpointUtil(self.ckpt_dir,
                           max_to_keep=opts.get("max_to_keep", 5),
                           own_manifest=(self.task_index == 0)).save(
                opts.get("global_step", self.global_step), data,
                worker_id=self.task_index)

    def _do_restore(self, opts) -> None:
        from tepdist_tpu_torch.runtime.checkpoint import CheckpointUtil

        util = CheckpointUtil(self.ckpt_dir)
        if opts.get("all_shards"):
            # Elastic re-dispatch: this worker may have adopted stages a
            # dead worker owned: read the union of every worker's files.
            data, step = util.restore_union(opts.get("global_step", -1))
        else:
            data, step = util.restore(opts.get("global_step", -1),
                                      worker_id=self.task_index)
        with self._lock:
            opt_states: Dict[int, Dict[int, Any]] = {}
            for k, v in data.items():
                if k.startswith("opt:"):
                    _, stage, j = k.split(":")
                    opt_states.setdefault(int(stage), {})[int(j)] = (
                        self._to_device(v))
                else:
                    self.variables[int(k)] = self._to_device(v)
            if self.worker_plan is not None and opt_states:
                self.worker_plan.opt_states = {
                    stage: [slots[j] for j in sorted(slots)]
                    for stage, slots in opt_states.items()}
            self.global_step = step
        # A live pipeline runtime reloads the restored state (params AND
        # optimizer slots) before its next step.
        if self._active_pipeline is not None:
            self._active_pipeline.loaded = False
            self._pipeline_restored = True

    # ------------------------------------------------------------------
    def Ping(self, request: bytes, context=None) -> bytes:
        header, _ = protocol.unpack(request)
        out = {
            "ok": True,
            "task_index": self.task_index,
            "n_devices": len(self.devices),
            "platform": self.device.type,
            "global_step": self.global_step,
            "plan_gen": self.plan_gen,
            "master_epoch": self.master_epoch,
        }
        if header.get("want_ckpt_steps"):
            from tepdist_tpu_torch.runtime.checkpoint import CheckpointUtil
            try:
                out["ckpt_steps"] = [
                    int(s) for s in CheckpointUtil(self.ckpt_dir).steps()]
            except Exception:  # noqa: BLE001 — no manifest yet
                out["ckpt_steps"] = []
        # Live migration dirty-worker probe: the steps this plan already
        # committed locally (a survivor ahead of the agreed state is
        # rebased from the checkpoint, not trusted).
        if self.worker_plan is not None:
            out["wp_completed"] = sorted(self.worker_plan._completed)
        return protocol.pack(out)

    def GetTelemetry(self, request: bytes, context=None) -> bytes:
        """Pull this process's span ring + metrics snapshot. ``now_us``
        stamps the worker's epoch clock so the caller can estimate the
        clock offset from the RPC round-trip (telemetry/export.py)."""
        from tepdist_tpu_torch import telemetry

        header, _ = protocol.unpack(request)
        t = telemetry.tracer()
        dropped = t.dropped
        clear = bool(header.get("clear"))
        spans = t.snapshot(clear=clear)
        ledger_snap = wire_ledger.ledger().snapshot(clear=clear)
        flight_snap = flight.recorder().snapshot(clear=clear)
        return protocol.pack({
            "ok": True,
            "task_index": self.task_index,
            "now_us": time.time_ns() // 1000,
            "enabled": telemetry.enabled(),
            "spans": spans,
            "spans_dropped": dropped,
            "ledger_dropped": ledger_snap.get("records_dropped", 0),
            "flight_dropped": flight_snap.get("dropped", 0),
            "flight_sampled_out": flight_snap.get("sampled_out", 0),
            "metrics": telemetry.metrics().snapshot(),
            "ledger": ledger_snap,
            "flight": flight_snap,
            "alerts": watchtower.active_alerts(),
        })

    def GetTelemetryDelta(self, request: bytes, context=None) -> bytes:
        """Cursor-based incremental telemetry read (the watchtower's poll
        verb): only records written since the caller's ``cursors``, plus
        exact drop counters; non-consuming. ``spans=true`` also streams
        trace-span deltas."""
        from tepdist_tpu_torch import telemetry

        header, _ = protocol.unpack(request)
        cursors = header.get("cursors") or {}
        ledger_delta, led_state = wire_ledger.ledger().delta(
            cursors.get("ledger"))
        flight_delta, fl_state = flight.recorder().delta(
            cursors.get("flight"))
        out = {
            "ok": True,
            "task_index": self.task_index,
            "now_us": time.time_ns() // 1000,
            "enabled": telemetry.enabled(),
            "global_step": self.global_step,
            "ledger": ledger_delta,
            "flight": flight_delta,
            "metrics": telemetry.metrics().snapshot(),
            "alerts": watchtower.active_alerts(),
            "cursors": {"ledger": led_state, "flight": fl_state},
        }
        if header.get("spans"):
            trace_delta, tr_state = telemetry.tracer().delta(
                cursors.get("trace"))
            out["trace"] = trace_delta
            out["cursors"]["trace"] = tr_state
        return protocol.pack(out)

    # -- the fleet's worker verbs ---------------------------------------
    def TransferModuleAndDefCtx(self, request: bytes, context=None) -> bytes:
        """Receive a stage module (its captured graph) and its metadata,
        and the stage optimizer's ``init``/``update`` graphs when shipped
        (reference: create_def_ctx_from_proto + module rebuild,
        service_rt.cc:467)."""
        header, blobs = protocol.unpack(request)
        self._check_epoch(header)
        module_id = int(header.get("module_id", 0))
        self.modules[module_id] = bytes(blobs[0])
        meta = header.get("stage_meta")
        if meta is not None:
            from tepdist_tpu_torch.rpc.worker_plan import StageModuleRuntime
            with span("worker:deserialize", cat="planner"):
                gm = self._graph(blobs[0])
                opt_init = opt_update = None
                if len(blobs) >= 3:
                    opt_init = self._graph(blobs[1])
                    opt_update = self._graph(blobs[2])
            self.stage_modules[module_id] = StageModuleRuntime(
                gm, meta, self.device, opt_init=opt_init,
                opt_update=opt_update)
        return protocol.pack({"ok": True})

    def DispatchPlan(self, request: bytes, context=None) -> bytes:
        """Receive this worker's task list + plan metadata and build the
        executable WorkerPlan (reference: BuildDistributedPlanRPC,
        virtual_client.cc:776)."""
        header, _ = protocol.unpack(request)
        self._check_epoch(header)
        cached = self._idem_get(header)
        if cached is not None:
            # The original was applied and its response lost: a replay
            # would discard the fresh RawStore and what was pushed to it.
            return cached
        self._inject_server_fault("DispatchPlan")
        tasks = header.get("tasks", [])
        # Live migration: a re-plan over the SAME program carries the
        # named stages' optimizer slots (kept or just adopted) across the
        # plan swap instead of letting the fresh plan re-run opt_init.
        old_opt = None
        if header.get("carry_state"):
            old_opt = {}
            if self.worker_plan is not None:
                old_opt.update(self.worker_plan.opt_states)
            old_opt.update(self.adopted_opt)   # adopted slots win
            keep = header.get("carry_stages")
            if keep is not None:
                keep = {int(st) for st in keep}
                old_opt = {st: v for st, v in old_opt.items() if st in keep}
        self.adopted_opt = {}
        # Each plan gets a FRESH RawStore: an old plan's still-running
        # step keeps its reference to the ABORTED store and dies at its
        # next recv/send check.
        from tepdist_tpu_torch.rpc.worker_plan import RawStore, WorkerPlan
        self.raw_store = RawStore()
        self.release_parked_transfers()   # the old plan's pulls are moot
        if self.worker_plan is not None:
            self.worker_plan.close()
        self.plan_gen = int(header.get("plan_gen", self.plan_gen + 1))
        if header.get("plan_meta"):
            self.worker_plan = WorkerPlan(self, tasks, header["plan_meta"])
            if old_opt:
                self.worker_plan.opt_states = old_opt
        else:
            # A coordinator-style dispatch (tasks only) must not leave a
            # stale WorkerPlan bound to the old aborted store.
            self.worker_plan = None
        return self._idem_put(
            header, protocol.pack({"ok": True, "n_tasks": len(tasks)}))

    def _run_worker_step(self, verb: str, step: int) -> bytes:
        with span(verb, cat="rpc", step=step), \
                wire_ledger.step_hint(step):
            result = self.worker_plan.run_step(step)
        return protocol.pack({"ok": True, **result})

    def ExecuteRemotePlan(self, request: bytes, context=None) -> bytes:
        header, _ = protocol.unpack(request)
        self._check_epoch(header)
        # Injection BEFORE run_step: the completed-step cache makes a
        # replay a cache hit, so a post-run fault would exercise only the
        # rpc retry, never the master's _recover_step ladder.
        self._inject_server_fault("ExecuteRemotePlan")
        if self.worker_plan is None:
            return protocol.pack({"ok": True, "losses": []})
        return self._run_worker_step("ExecuteRemotePlan",
                                     int(header.get("step", 0)))

    def ExecuteStepSlice(self, request: bytes, context=None) -> bytes:
        """Coalesced per-step dispatch: this worker's micro-batch slices
        and the execute trigger in ONE envelope, results in one reply.
        The puts are idempotent keyed writes with TransferHostRawData's
        stale-generation drop; the execute rides the completed-step
        cache, so a retried slice dedups as ExecuteRemotePlan does."""
        header, blobs = protocol.unpack(request)
        self._check_epoch(header)
        self._inject_server_fault("ExecuteStepSlice")
        gen = header.get("plan_gen")
        if gen is not None and gen != self.plan_gen:
            return protocol.pack({"ok": False, "stale_plan_gen": gen})
        for i, ent in enumerate(header.get("raw_multi", ())):
            self.raw_store.put(ent["raw_key"], protocol.decode_literal(
                ent["literal"], blobs[i]).to(self.device, copy=True))
        if self.worker_plan is None:
            return protocol.pack({"ok": True, "losses": []})
        return self._run_worker_step("ExecuteStepSlice",
                                     int(header.get("step", 0)))

    def AbortStep(self, request: bytes, context=None) -> bytes:
        """Cancel an in-flight step: wake every blocked recv with
        StepAbortedError (a peer died mid-step). ``{"reset": true}``
        CLEARS the abort flag, keeping the store's data, for the master's
        transient-fault retry of the same step."""
        header, _ = protocol.unpack(request)
        self._check_epoch(header)
        if header.get("reset"):
            self.raw_store.reset_abort()
            return protocol.pack({"ok": True, "reset": True})
        self.raw_store.abort()
        # The abort latch fails every pre-abort pull: the parked buffers
        # can go now.
        freed = self.release_parked_transfers()
        if freed:
            metrics().counter("transfers_freed_on_abort").inc(freed)
        return protocol.pack({"ok": True, "freed_transfers": freed})

    # -- live migration -------------------------------------------------
    def FetchShard(self, request: bytes, context=None) -> bytes:
        """Pure read of migration source state. Variable mode
        (``global_idx`` + optional ``bounds`` slice in global coordinates)
        returns one literal; ``opt_stage`` mode that stage's optimizer
        slots. ``wire_dtype`` compresses floats on the wire."""
        header, _ = protocol.unpack(request)
        self._inject_server_fault("FetchShard")
        wire = header.get("wire_dtype")
        opt_stage = header.get("opt_stage")
        if opt_stage is not None:
            slots = None
            if self.worker_plan is not None:
                slots = self.worker_plan.opt_states.get(int(opt_stage))
            if slots is None:
                slots = self.adopted_opt.get(int(opt_stage))
            if slots is None:
                return protocol.pack({"found": False})
            metas, blobs = [], []
            for slot in slots:
                meta, blob = protocol.encode_literal(_whole(slot),
                                                     wire_dtype=wire)
                metas.append(meta)
                blobs.append(blob)
            return protocol.pack_frames({"found": True, "slots": metas},
                                        blobs)
        gi = int(header["global_idx"])
        with self._lock:
            val = self.variables.get(gi)
        if val is None:
            return protocol.pack({"found": False})
        val = _whole(val)
        bounds = header.get("bounds")
        if bounds:
            val = val[tuple(slice(int(lo), int(hi)) for lo, hi in bounds)]
        meta, blob = protocol.encode_literal(val, wire_dtype=wire)
        return protocol.pack_frames({"found": True, "literal": meta},
                                    [blob])

    def _migration_peer(self, addr: str):
        """Cached TepdistClient to a live migration or KV-handoff source."""
        cli = self._migration_peers.get(addr)
        if cli is None:
            from tepdist_tpu_torch.rpc.client import TepdistClient
            cli = self._migration_peers[addr] = TepdistClient(addr)
        return cli

    def _ckpt_worker_data(self, step: int, worker_id: int, cache: Dict):
        """Checkpoint-fallback source: one worker's restored dict at the
        fenced step, loaded once per AdoptShard call."""
        key = (int(step), int(worker_id))
        if key not in cache:
            from tepdist_tpu_torch.runtime.checkpoint import CheckpointUtil
            data, _ = CheckpointUtil(self.ckpt_dir).restore(
                int(step), worker_id=int(worker_id))
            cache[key] = data
        return cache[key]

    def _adopt_var(self, mv: Dict[str, Any], ckpt_cache: Dict):
        """One destination shard, assembled from its source pieces
        (``parallel/redistribution.py``'s plan entry) in a tensor of the
        move's dtype on this server's device."""
        srcs = mv["sources"]
        dst = [(int(a), int(z)) for a, z in mv["dst_bounds"]]
        out = torch.zeros([z - a for a, z in dst],
                          dtype=protocol.torch_dtype(mv["dtype"]))
        for s in srcs:
            inter = [(int(a), int(z)) for a, z in s["bounds"]]
            if s.get("addr"):
                piece = self._migration_peer(s["addr"]).fetch_shard(
                    int(mv["global_idx"]), bounds=inter,
                    wire_dtype=mv.get("wire_dtype"))
                if piece is None:
                    raise KeyError(
                        f"migration source {s['addr']} lost var "
                        f"{mv['global_idx']}")
            else:
                data = self._ckpt_worker_data(s["ckpt_step"],
                                              s["worker_id"], ckpt_cache)
                full = data[str(mv["global_idx"])]
                piece = full[tuple(slice(lo, hi) for lo, hi in inter)]
            out[tuple(slice(lo - a, hi - a) for (lo, hi), (a, _z)
                      in zip(inter, dst))] = piece.to(out.dtype)
        return self._to_device(out)

    def _adopt_opt(self, mv: Dict[str, Any], ckpt_cache: Dict):
        """The source stage's slot list, or None where the source holds
        no state for it (a stateless optimizer, a stage never stepped):
        the adopter's lazy opt_init then makes the agreed state."""
        src_stage = int(mv.get("src_stage", mv["stage"]))
        if mv.get("addr"):
            slots = self._migration_peer(mv["addr"]).fetch_shard(
                opt_stage=src_stage, wire_dtype=mv.get("wire_dtype"))
        else:
            data = self._ckpt_worker_data(mv["ckpt_step"], mv["worker_id"],
                                          ckpt_cache)
            prefix = f"opt:{src_stage}:"
            found = {int(k.split(":")[2]): v for k, v in data.items()
                     if k.startswith(prefix)}
            slots = [found[j] for j in sorted(found)] if found else None
        if slots is None:
            return None
        return [self._to_device(x) for x in slots]

    def AdoptShard(self, request: bytes, context=None) -> bytes:
        """Destination side of a live shard move: pull the listed pieces
        from live peers (nested FetchShard) or the shared checkpoint dir,
        assemble each destination shard, and install variables and
        per-stage optimizer slots. Mutating: idem-token deduped.

        Move schema (header["moves"] entries):
          {"kind": "var", "global_idx": gi, "dst_bounds": [[lo,hi]..],
           "dtype": name, "wire_dtype": opt, "sources": [
               {"addr": "ip:port", "bounds": [[lo,hi]..]} |
               {"ckpt_step": N, "worker_id": w, "bounds": [[lo,hi]..]}]}
          {"kind": "opt", "stage": s, "src_stage": s_old,
           "addr": ... | "ckpt_step"/"worker_id": ..., "wire_dtype": opt}
        """
        header, _ = protocol.unpack(request)
        self._check_epoch(header)
        cached = self._idem_get(header)
        if cached is not None:
            return cached
        self._inject_server_fault("AdoptShard")
        ckpt_cache: Dict = {}
        adopted = 0
        for mv in header.get("moves", ()):
            if mv["kind"] == "var":
                val = self._adopt_var(mv, ckpt_cache)
                with self._lock:
                    self.variables[int(mv["global_idx"])] = val
            elif mv["kind"] == "opt":
                slots = self._adopt_opt(mv, ckpt_cache)
                if slots is not None:
                    # Staged for the migration's DispatchPlan carry merge,
                    # and mirrored into a live plan.
                    self.adopted_opt[int(mv["stage"])] = slots
                    if self.worker_plan is not None:
                        self.worker_plan.opt_states[int(mv["stage"])] = slots
            else:
                raise ValueError(f"unknown move kind {mv['kind']!r}")
            adopted += 1
        metrics().counter("shards_adopted").inc(adopted)
        log.info("AdoptShard: %d moves (migration %s)", adopted,
                 header.get("migration_id", "?"))
        return self._idem_put(header, protocol.pack(
            {"ok": True, "adopted": adopted,
             "migration_id": header.get("migration_id", "")}))

    # -- single-engine servables ----------------------------------------
    def _servable(self, sid: str):
        eng = self.servables.get(sid)
        if eng is None:
            raise ValueError(f"unknown servable {sid!r} "
                             f"(loaded: {sorted(self.servables)})")
        return eng

    def LoadServable(self, request: bytes, context=None) -> bytes:
        """Ship a model (config spec + flat param leaves in tree order)
        and start its SUPERVISED continuous-batching engine
        (``serving/supervisor.py``). Idempotent: a replayed load answers
        with the original servable id."""
        header, blobs = protocol.unpack(request)
        self._check_epoch(header)
        cached = self._idem_get(header)
        if cached is not None:
            return cached
        self._inject_server_fault("LoadServable")
        from tepdist_tpu_torch.models import gpt2
        from tepdist_tpu_torch.serving.kv_cache import config_from_spec
        from tepdist_tpu_torch.serving.supervisor import ServingSupervisor

        cfg = config_from_spec(header["config"])
        leaves = [self._to_device(protocol.decode_literal(m, blobs[i]))
                  for i, m in enumerate(header["params_meta"])]
        if header.get("stage") is not None:
            return self._load_stage_servable(header, cfg, leaves,
                                             header["stage"])
        # The param tree's structure depends on the depth alone: a
        # one-wide model of the same depth gives it.
        import dataclasses
        template = gpt2.init_params(dataclasses.replace(
            cfg, n_embd=cfg.n_head, vocab_size=1, n_ctx=1), device="cpu")
        params = tree_unflatten(tree_structure(template), leaves)
        with self._lock:
            sid = f"sv{self._servable_next}"
            self._servable_next += 1
        name = header.get("name") or sid
        kv_mode = header.get("kv_mode", "paged")
        page_size = int(header.get("page_size", 16))
        from tepdist_tpu_torch.analysis.plan_verify import (verify_enabled,
                                                            verify_servable)
        if verify_enabled():
            # Pre-load gate: a servable whose KV plan cannot fit is
            # refused before anything compiles.
            from tepdist_tpu_torch.serving.kv_cache import default_buckets
            v_slots = int(header.get("slots", 4))
            v_max_len = int(header.get("max_len") or cfg.n_ctx)
            v_buckets = sorted({min(int(b), v_max_len) for b in
                                (header.get("buckets")
                                 or default_buckets(v_max_len))})
            v_pages = None
            if kv_mode == "paged":
                from tepdist_tpu_torch.serving.paged_kv import (
                    derive_n_pages)
                v_pages = derive_n_pages(
                    cfg, page_size=page_size, max_len=v_max_len,
                    slots=v_slots, n_pages=header.get("n_pages"),
                    hbm_budget_bytes=header.get("hbm_budget_bytes"))
            verify_servable(cfg, slots=v_slots, max_len=v_max_len,
                            buckets=v_buckets, kv_mode=kv_mode,
                            page_size=page_size, n_pages=v_pages,
                            where=f"LoadServable@{self.task_index}")
        eng = ServingSupervisor(
            params, cfg, slots=int(header.get("slots", 4)),
            max_len=header.get("max_len"),
            buckets=header.get("buckets"),
            max_queue=int(header.get("max_queue", 64)),
            name=f"{name}@{self.task_index}",
            task_index=self.task_index,
            max_restarts=int(header.get("max_restarts", 3)),
            shed_high=header.get("shed_high"),
            shed_low=header.get("shed_low"),
            kv_mode=kv_mode, page_size=page_size,
            n_pages=header.get("n_pages"),
            hbm_budget_bytes=header.get("hbm_budget_bytes"),
            prefix_cache=bool(header.get("prefix_cache", True)),
            prefill_chunk=header.get("prefill_chunk"),
            device=self.device)
        eng.start()
        self.servables[sid] = eng
        log.info("LoadServable %s: %s", sid, eng.stats())
        return self._idem_put(header, protocol.pack(
            {"ok": True, "servable_id": sid, **eng.stats()}))

    def _load_stage_servable(self, header, cfg, leaves, stage) -> bytes:
        """Sharded arm of LoadServable: install ONE pipeline stage (a
        layer range plus the embedding/logit tables it owns) as a
        StageServable driven over ExecuteServableSlice, instead of a
        whole-model engine. The planner-priced split was verified
        fleet-wide client-side; each worker re-verifies just ITS stage
        against the local HBM budget."""
        from tepdist_tpu_torch.analysis.plan_verify import (
            verify_enabled, verify_sharded_servable)
        from tepdist_tpu_torch.serving.fleet import (StageServable,
                                                     build_stage_params)
        lo, hi = int(stage["lo"]), int(stage["hi"])
        first, last = bool(stage["first"]), bool(stage["last"])
        max_len = int(header.get("max_len") or cfg.n_ctx)
        if verify_enabled():
            verify_sharded_servable(
                cfg, stages=[(lo, hi, first, last)], max_len=max_len,
                where=f"LoadServable@{self.task_index}")
        params = build_stage_params(stage["names"], leaves)
        with self._lock:
            sid = f"sv{self._servable_next}"
            self._servable_next += 1
        name = header.get("name") or sid
        sv = StageServable(params, cfg, lo=lo, hi=hi, first=first,
                           last=last, max_len=max_len,
                           name=f"{name}@{self.task_index}",
                           device=self.device)
        self.servables[sid] = sv
        log.info("LoadServable %s (stage): %s", sid, sv.stats())
        return self._idem_put(header, protocol.pack(
            {"ok": True, "servable_id": sid, **sv.stats()}))

    def SubmitRequest(self, request: bytes, context=None) -> bytes:
        """Enqueue one generation request. Two dedup layers: the idem
        response cache and the engine's request-id dedup."""
        header, blobs = protocol.unpack(request)
        self._check_epoch(header)
        cached = self._idem_get(header)
        if cached is not None:
            return cached
        self._inject_server_fault("SubmitRequest")
        eng = self._servable(header["servable_id"])
        prompt = protocol.decode_literal(header["prompt"], blobs[0]).numpy()
        out = eng.submit(
            header["request_id"], prompt,
            max_new_tokens=int(header["max_new_tokens"]),
            greedy=bool(header.get("greedy", True)),
            temperature=float(header.get("temperature", 1.0)),
            top_k=int(header.get("top_k", 0)),
            seed=int(header.get("seed", 0)),
            deadline_ms=header.get("deadline_ms"),
            slo_class=str(header.get("slo_class", "default")),
            prefill_only=bool(header.get("prefill_only", False)))
        return self._idem_put(header, protocol.pack({"ok": True, **out}))

    def PollResult(self, request: bytes, context=None) -> bytes:
        """Long-poll request states (a pure read); generated tokens ride
        in the JSON header."""
        header, _ = protocol.unpack(request)
        self._inject_server_fault("PollResult")
        eng = self._servable(header["servable_id"])
        results = eng.poll(header.get("request_ids"),
                           wait_ms=float(header.get("wait_ms", 0.0)))
        return protocol.pack({"ok": True, "results": results})

    def CancelRequest(self, request: bytes, context=None) -> bytes:
        header, _ = protocol.unpack(request)
        self._check_epoch(header)
        cached = self._idem_get(header)
        if cached is not None:
            return cached
        self._inject_server_fault("CancelRequest")
        eng = self._servable(header["servable_id"])
        ok = eng.cancel(header["request_id"])
        return self._idem_put(header,
                              protocol.pack({"ok": True, "cancelled": ok}))

    def Drain(self, request: bytes, context=None) -> bytes:
        """Graceful drain: admission stops, resident slots finish (up to
        ``wait_ms``), and every un-started queued request comes back as a
        resubmittable spec. Idempotent: a replay answers with the
        ORIGINAL handoff list."""
        header, _ = protocol.unpack(request)
        self._check_epoch(header)
        cached = self._idem_get(header)
        if cached is not None:
            return cached
        self._inject_server_fault("Drain")
        eng = self._servable(header["servable_id"])
        handed = eng.drain(wait_ms=float(header.get("wait_ms", 0.0)))
        return self._idem_put(header, protocol.pack(
            {"ok": True, "handed_off": handed}))

    def ExportPages(self, request: bytes, context=None) -> bytes:
        """Prefill side of the paged KV handoff. Gather mode is a pure
        read (``want`` selects live-page ordinals; ``wire_dtype``
        compresses); ``release`` flips the parked request to
        "handed_off" and frees its pages (state-idempotent)."""
        header, _ = protocol.unpack(request)
        self._inject_server_fault("ExportPages")
        eng = self._servable(header["servable_id"])
        rid = header["request_id"]
        if header.get("release"):
            ok = eng.complete_handoff(rid)
            return protocol.pack({"ok": True, "released": bool(ok)})
        out = eng.export_pages(rid, want=header.get("want"))
        if out is None:
            return protocol.pack({"found": False})
        wire = header.get("wire_dtype")
        k_meta, k_blob = protocol.encode_literal(out["k"], wire_dtype=wire)
        v_meta, v_blob = protocol.encode_literal(out["v"], wire_dtype=wire)
        return protocol.pack_frames(
            {"found": True, "first_token": int(out["first_token"]),
             "pos": int(out["pos"]), "n_live": int(out["n_live"]),
             "idx": [int(i) for i in out["idx"]], "k": k_meta,
             "v": v_meta}, [k_blob, v_blob])

    def AdoptPages(self, request: bytes, context=None) -> bytes:
        """Decode side of the paged KV handoff: pull the request's live KV
        pages from the prefill replica (nested ExportPages), install them
        and resume decode from the prefill's first token. Mutating:
        idem-token deduped, with the engine's rid dedup behind it."""
        header, blobs = protocol.unpack(request)
        self._check_epoch(header)
        cached = self._idem_get(header)
        if cached is not None:
            return cached
        self._inject_server_fault("AdoptPages")
        eng = self._servable(header["servable_id"])
        prompt = protocol.decode_literal(header["prompt"], blobs[0]).numpy()
        src = self._migration_peer(header["source_addr"])
        src_sid = header["source_sid"]
        rid = header["request_id"]
        wire = header.get("wire_dtype")

        def fetch(want):
            return src.export_pages(src_sid, rid, want=want,
                                    wire_dtype=wire)

        out = eng.adopt_pages(
            rid, prompt, fetch=fetch,
            max_new_tokens=int(header["max_new_tokens"]),
            greedy=bool(header.get("greedy", True)),
            temperature=float(header.get("temperature", 1.0)),
            top_k=int(header.get("top_k", 0)),
            seed=int(header.get("seed", 0)),
            deadline_ms=header.get("deadline_ms"),
            slo_class=str(header.get("slo_class", "default")))
        return self._idem_put(header,
                              protocol.pack({"ok": True, **out}))

    def ExecuteServableSlice(self, request: bytes, context=None
                             ) -> bytes:
        """Run one op of a pipeline-STAGE servable (``serving/fleet.py``
        StageServable): tokens into the first stage, hidden activations
        into later ones. Exact ``cfg.dtype`` activation bytes ride back
        on the Frames path (bf16 as its uint16 bits)."""
        header, blobs = protocol.unpack(request)
        self._check_epoch(header)
        self._inject_server_fault("ExecuteServableSlice")
        sv = self._servable(header["servable_id"])
        arr = protocol.decode_literal(header["array"], blobs[0])
        out = sv.execute(str(header["op"]), arr,
                         pos=int(header.get("pos", 0)))
        meta, blob = protocol.encode_literal(out)
        return protocol.pack_frames({"ok": True, "out": meta}, [blob])

    def close_servables(self) -> None:
        """Stop every serving engine (drain by default: admission stops
        and resident slots finish within the stop timeout)."""
        for eng in list(self.servables.values()):
            eng.stop(drain=True)
        self.servables.clear()

    def close(self) -> None:
        """Stop the serving engines; in the group form, each rank stops
        its own and its process ends (``inproc.unregister_servicer`` calls
        this for a group-form servicer)."""
        if self.rank_group is not None:
            self.rank_group.close()
        self.close_servables()


# Verbs whose reply names the server's device count: the group form's
# head answers with its own (a rank holds one device).
_DEVICE_COUNT_VERBS = frozenset({"Ping", "InitMeshTopology"})


def _on_device(verb):
    """A verb run with the server's card as the calling thread's current
    device: handlers run on transport threads (gRPC's pool, a caller's
    thread in process), whose current card is card 0, and NCCL binds a
    rank's collectives to its own card. A group-form servicer forwards
    the verb to its ranks instead."""
    def handler(self, request: bytes, context=None):
        if self.rank_group is not None:
            resp = self.rank_group.forward(verb.__name__, request)
            if verb.__name__ in _DEVICE_COUNT_VERBS:
                header, blobs = protocol.unpack(resp)
                header["n_devices"] = len(self.devices)
                resp = protocol.pack(header, blobs)
            return resp
        if self.device.type != "cuda":
            return verb(self, request, context)
        with torch.cuda.device(self.device):
            return verb(self, request, context)
    handler.__name__ = verb.__name__
    handler.__doc__ = verb.__doc__
    return handler


for _name in protocol.METHODS:
    setattr(TepdistServicer, _name,
            _on_device(getattr(TepdistServicer, _name)))


def heavy_rpc_slots(max_workers: int) -> Optional[int]:
    """The heavy-handler concurrency bound from TEPDIST_HEAVY_RPC_SLOTS:
    0 = auto (a quarter of the pool, at least 2), negative = unbounded
    (None), positive = that many — always leaving at least one pool
    thread free for control verbs."""
    knob = int(ServiceEnv.get().tepdist_heavy_rpc_slots)
    if knob < 0:
        return None
    slots = knob if knob > 0 else max(2, max_workers // 4)
    return max(1, min(slots, max_workers - 1))


def create_server(port: int, devices=None, task_index: int = 0,
                  max_workers: int = 8):
    """A gRPC server over generic (bytes-in/bytes-out) handlers; a
    handler that raises aborts its call with INTERNAL and the repr.
    Heavy verbs (``HEAVY_VERBS``) first take a slot of a bounded gate
    (``heavy_rpc_slots``); control verbs bypass it."""
    import grpc

    servicer = TepdistServicer(devices, task_index)
    slots = heavy_rpc_slots(max_workers)
    gate = threading.BoundedSemaphore(slots) if slots is not None else None
    handlers = {}
    for m in protocol.METHODS:
        fn = getattr(servicer, m)

        def make(fn=fn, m=m):
            heavy = gate is not None and m in HEAVY_VERBS

            def handler(request, context):
                try:
                    with wire_ledger.server_scope(m):
                        if heavy:
                            with gate:
                                resp = fn(request, context)
                        else:
                            resp = fn(request, context)
                    if isinstance(resp, protocol.Frames):
                        resp = resp.join()
                    return resp
                except Exception as e:  # surface server errors to client
                    log.exception("RPC failed")
                    context.abort(grpc.StatusCode.INTERNAL, repr(e))
            return handler

        handlers[m] = grpc.unary_unary_rpc_method_handler(
            make(), request_deserializer=None, response_serializer=None)
    generic = grpc.method_handlers_generic_handler(
        protocol.SERVICE_NAME, handlers)
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=protocol.GRPC_OPTIONS)
    server.add_generic_rpc_handlers((generic,))
    bound = server.add_insecure_port(f"[::]:{port}")
    return server, servicer, bound


def init_world(coordinator_address: str, num_processes: int, rank: int,
               device: torch.device) -> None:
    """A multi-rank server's world (the reference's
    ``jax.distributed.initialize``): NCCL with the rank bound to its
    indexed card, or gloo on the CPU, over ``tcp://`` at the coordinator
    address."""
    import datetime

    import torch.distributed as dist

    cuda = device.type == "cuda"
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=f"tcp://{coordinator_address}", rank=rank,
        world_size=num_processes, timeout=datetime.timedelta(minutes=5),
        **({"device_id": device} if cuda else {}))
    log.info("torch.distributed: rank %d/%d on %s", rank, num_processes,
             device)


def main() -> None:
    """Server binary (reference: grpc_service_gpu ``RealMain`` with flags
    --platform --ip --port --task_index, rpc/grpc_service_gpu.cc:32-81).

        python -m tepdist_tpu_torch.rpc.server --port N [--device cpu|cuda]
            [--coordinator_address HOST:PORT --num_processes N]

    With ``--coordinator_address`` the server is rank ``--task_index`` of
    a world of ``--num_processes`` ranks (one a card: rank r on card
    r modulo the cards present) that a multi-host session drives.
    """
    parser = argparse.ArgumentParser("tepdist_server")
    parser.add_argument("--port", type=int, default=2222)
    parser.add_argument("--task_index", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="the server's device: cuda (the card, the "
                             "default) or cpu")
    parser.add_argument("--coordinator_address", default="",
                        help="host:port of the process group's rendezvous "
                             "(a multi-rank server)")
    parser.add_argument("--num_processes", type=int, default=1)
    args = parser.parse_args()
    logging.basicConfig(level=logging.INFO)
    device = args.device
    if args.coordinator_address:
        dev = resolve_device(args.device)
        if dev.type == "cuda":
            dev = torch.device(
                "cuda", args.task_index % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        device = dev
        init_world(args.coordinator_address, args.num_processes,
                   args.task_index, dev)
    server, _, bound = create_server(args.port, devices=[device],
                                     task_index=args.task_index)
    server.start()
    print(f"tepdist server listening on {bound}", flush=True)
    server.wait_for_termination()


if __name__ == "__main__":
    main()
