"""PipelineExecutable: execute a scheduled TaskDAG on a list of devices: the
port of ``tepdist_tpu/runtime/executor.py``, one device per stage.

Reference parity: ``DAPPLEExecutable`` (reference: pjrt/virtual_client.cc —
per-task-type executors DoInputTask/DoComputeTask/DoSendTask/DoRecvTask/
DoGATask/DoGAInitTask/DoOutputTask and the per-device ``ExecuteTaskList``
loop). In the port:

  * One process walks the scheduler's static order and issues every task on
    its device's current stream; work on different cards overlaps because
    CUDA launches return at once. The host waits once a step, for the loss.
  * Stage ``s`` runs on one ``torch.device``; its device group is the
    logical id of that device, its position in the executor's list. A list
    may name one physical device more than once (``["cuda:0"] * 4`` on one
    card, ``["cpu"] * S`` in the tests): the DAG keeps the shape it has on
    S cards, SEND/RECV tasks included, and a RECV's ``tensor.to(device,
    non_blocking=True)`` (the reference's ``jax.device_put``) is then a
    no-op.
  * Each payload is a plain Python callable over tensors: a stage's forward
    is its ``fx.GraphModule`` under ``torch.no_grad()``; its backward runs
    that module again under autograd (``parallel/pipeline.stage_vjp``).
  * Variables are held per stage: parameters and optimizer state live on
    their owning stage's device across steps, and ``fetch_variables`` /
    ``fetch_opt_state`` assemble the global state whose flat leaves are the
    eager plan's, so checkpoints cross between the two runtimes.

Not in the port yet (ROADMAP item 13b): more than one device in a stage —
intra-stage data parallelism, stage x TP nesting and ZeRO. Each raises
``NotImplementedError``.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tepdist_tpu_torch.core.device import resolve_device
from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.core.tree import (tree_leaves, tree_structure,
                                         tree_unflatten)
from tepdist_tpu_torch.graph.fx_graph import var_val
from tepdist_tpu_torch.parallel.pipeline import PipelineProgram, stage_vjp
from tepdist_tpu_torch.runtime.execution_plan import build_pipeline_task_dag
from tepdist_tpu_torch.runtime.task_graph import TaskType
from tepdist_tpu_torch.runtime.task_scheduler import (ScheduleResult,
                                                      TaskScheduler)
from tepdist_tpu_torch.telemetry import _NULL_SPAN, metrics, span, tracer

log = logging.getLogger(__name__)

# Span category per task type (Perfetto's category filter slices by these).
_SPAN_CAT = {
    TaskType.COMPUTE: "compute",
    TaskType.SEND: "send",
    TaskType.RECV: "recv",
    TaskType.GAINIT: "ga",
    TaskType.GA: "ga",
    TaskType.APPLY: "apply",
}

_ITEM_13B = ("needs more than one device in a pipeline stage, which the "
             "port does not run yet (ROADMAP item 13b)")

# Seed of the int8 gradient fake-quant generators; each (stage, slot)
# folds in s * 131 + p, as the reference folds its PRNG key.
_INT8_SEED = 0x7e9d


def _tree_paths(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(path, leaf) pairs in ``tree_leaves`` order; a path element is
    ``("key", k)`` for a dict key and ``("idx", i)`` for a sequence index
    (``jax.tree_util``'s DictKey / SequenceKey)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in _tree_paths(tree[k], prefix + (("key", k),))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, x in enumerate(tree)
                for pl in _tree_paths(x, prefix + (("idx", i),))]
    return [(prefix, tree)]


def _to_device(val, device: torch.device):
    """A RECV's copy onto the consumer's device (a no-op there already):
    an activation or a cotangent (``None`` for an integer input), or a
    stage's gradient accumulators (a tuple)."""
    if isinstance(val, tuple):
        return tuple(_to_device(v, device) for v in val)
    if val is None:
        return None
    return val.to(device, non_blocking=True)


def _leaf_owner_index(path) -> Optional[int]:
    """The flat param index a state leaf mirrors: the first integer dict
    key on its path (per-stage states are ``init({index: leaf})``)."""
    for kind, k in path:
        if kind == "key" and isinstance(k, int):
            return k
    return None


class PipelineExecutable:
    """Owns variables + stage programs; runs scheduled steps."""

    def __init__(
        self,
        prog: PipelineProgram,
        devices: Optional[Sequence] = None,
        optimizer=None,
        intra_stage_tp: int = 1,
        placement: str = "blocked",
        interleave_groups: Optional[int] = None,
    ):
        """``devices``: one ``torch.device`` (or name) per stage, by
        default ``[cuda:0] * num_stages``, never the CPU unless asked. The
        stage's device group is its entry's position in the list.

        ``placement``: "blocked" (stage s on entry s) or "interleaved" —
        VIRTUAL stages: more stages than device groups, assigned round-
        robin (stage s -> group s % G, G = ``interleave_groups`` or
        min(devices, stages)); hops between co-resident stages are direct
        edges (no send/recv), and the scheduler's candidate search includes
        the Megatron chunk-alternating priority.

        ``intra_stage_tp`` > 1, more than one device a stage, and ZeRO
        (``prog.zero``) raise ``NotImplementedError`` (ROADMAP item 13b);
        the reference's ``intra_stage_dp`` and ``stage_var_mem_limit`` act
        only there and come with it."""
        self.prog = prog
        S = prog.num_stages
        if devices is None:
            devices = [resolve_device("cuda")] * S
        devices = [resolve_device(d) for d in devices]
        if placement not in ("blocked", "interleaved"):
            raise ValueError(f"unknown placement {placement!r}")
        if int(intra_stage_tp) > 1:
            raise NotImplementedError(
                f"intra_stage_tp={intra_stage_tp} {_ITEM_13B}")
        if getattr(prog, "zero", False):
            raise NotImplementedError(f"ZeRO {_ITEM_13B}")
        if placement == "interleaved":
            # Group count = ``interleave_groups`` when given, else
            # min(devices, stages); each group hosts S/G virtual stages.
            G = interleave_groups or min(len(devices), S)
            if len(devices) % G:
                raise ValueError(
                    f"interleaved placement: {len(devices)} devices not "
                    f"divisible into {G} groups")
            if S % G:
                src = ("interleave_groups" if interleave_groups
                       else "min(devices, stages)")
                raise ValueError(
                    f"interleaved placement needs num_stages ({S}) "
                    f"divisible by the group count ({G} from {src}); "
                    "pick a dividing stage count")
            if len(devices) // G > 1:
                raise NotImplementedError(
                    f"{len(devices)} devices in {G} groups {_ITEM_13B}")
            self._stage_group = [s % G for s in range(S)]
        else:
            if len(devices) < S:
                raise ValueError(f"need >= {S} devices for {S} stages")
            if len(devices) // S > 1:
                raise NotImplementedError(
                    f"{len(devices)} devices for {S} stages {_ITEM_13B}")
            self._stage_group = list(range(S))
        self.stage_device: List[torch.device] = [
            devices[g] for g in self._stage_group]
        self.stage_devices: List[Tuple[int, ...]] = [
            (g,) for g in self._stage_group]
        # The device type the schedule is priced for (ASYNC_TRANSPORT).
        self.device_type = ("cuda" if any(d.type == "cuda" for d in devices)
                            else "cpu")

        self.dag, self.maps = build_pipeline_task_dag(
            prog, self.stage_devices)
        self.schedule: ScheduleResult = TaskScheduler(
            self.dag, device_type=self.device_type).schedule()
        # Rebuild the GC plan for the CHOSEN order (candidate simulations
        # may have left a different order's plan in place).
        self.dag.build_gc_plan(self.schedule.order)
        # Pre-dispatch gate (TEPDIST_VERIFY_PLAN): a planner bug is caught
        # before anything runs.
        from tepdist_tpu_torch.analysis.plan_verify import maybe_verify_plan
        self.verify_report = maybe_verify_plan(
            self.dag, schedule=self.schedule, prog=prog,
            where="PipelineExecutable")
        self.optimizer = optimizer

        # Param ownership: flat invar idx -> owning stage (first consumer).
        # Shared params (tied embeddings) are handed to the other consumers
        # each step; their gradients are summed into the owner's APPLY.
        self.param_owner: Dict[int, int] = {}
        self.param_stages: Dict[int, List[int]] = {}
        batch = set(prog.batch_flat_indices)
        for s in range(S):
            mod = prog.stages[s]
            for pos in mod.param_positions():
                i = mod.input_def_map[pos][1]
                if i in batch:
                    continue
                self.param_stages.setdefault(i, [])
                if s not in self.param_stages[i]:
                    self.param_stages[i].append(s)
        for i, stages_of_i in self.param_stages.items():
            self.param_owner[i] = min(stages_of_i)

        self._compile_payloads()
        # Stage-held state.
        self.var_store: Dict[int, torch.Tensor] = {}
        self.opt_states: Dict[int, Any] = {}
        self.params_tree = None
        self.n_params = 0
        self.global_step = 0
        self._param_cache: Dict[Tuple[int, int], torch.Tensor] = {}

    # ------------------------------------------------------------------
    def _compile_payloads(self) -> None:
        """The task bodies of every stage (the reference's AOT-compiled
        executables): plain callables over tensors. Compiling a stage is
        speed work for later."""
        prog = self.prog
        S = prog.num_stages
        self._fwd: List[Callable] = []
        self._bwd: List[Callable] = []
        self._ga: List[Callable] = []
        self._gainit: List[Callable] = []
        self._bwd_wired: List[List[int]] = []
        batch_set = set(prog.batch_flat_indices)
        # Param positions per stage EXCLUDING batch args (both are "arg"
        # entries in input_def_map; only trainables join GA/apply).
        self._stage_ppos: List[Tuple[int, ...]] = [
            tuple(p for p in prog.stages[s].param_positions()
                  if prog.stages[s].input_def_map[p][1] not in batch_set)
            for s in range(S)
        ]
        # Graph invar index per GA-accumulator slot, per stage.
        self._stage_pidx: List[Tuple[int, ...]] = [
            tuple(prog.stages[s].input_def_map[p][1]
                  for p in self._stage_ppos[s])
            for s in range(S)
        ]
        # Pre-bound per-task argument templates: one (kind, idx, pos) list
        # per stage.
        self._arg_templates: List[List[Tuple[str, Optional[int], int]]] = []
        for s in range(S):
            mod = prog.stages[s]
            tpl: List[Tuple[str, Optional[int], int]] = []
            for pos in range(len(mod.invars)):
                src = mod.input_def_map[pos]
                if src[0] == "arg":
                    i = src[1]
                    tpl.append(("batch" if i in batch_set else "param", i,
                                pos))
                else:
                    tpl.append(("wire", None, pos))
            self._arg_templates.append(tpl)

        # Which cot positions are wired per stage (from the DAG build):
        for s in range(S):
            n_in = len(prog.stages[s].invars)
            bwd_id = self.maps.bwd_tasks[(s, 0)]
            self._bwd_wired.append(sorted(
                pos - n_in for pos in self.dag.node(bwd_id).input_specs
                if pos >= n_in))

        loss_stage = next(s for s in range(S)
                          if 0 in prog.stages[s].graph_out_map)
        self._loss_stage = loss_stage
        # Winner-planned gradient-contribution compression: the GA add
        # takes the bwd output through the comm dtype (bf16 cast, or int8
        # chunk-scale stochastic-rounding fake quant). Fidelity ("") adds
        # the raw contribution.
        comm_dtype = getattr(prog, "comm_dtype", "") or ""

        for s in range(S):
            mod = prog.stages[s]
            dev = self.stage_device[s]
            gm = prog.decomp.stage_fn(s, device=dev)
            n_in = len(mod.invars)

            def make_fwd(gm=gm):
                def fwd(*args):
                    with torch.no_grad():
                        return gm(*args)
                return fwd

            def make_bwd(gm=gm, wired=tuple(self._bwd_wired[s]),
                         n_out=len(mod.outvars), n_in=n_in,
                         loss_out=(mod.graph_out_map.get(0)
                                   if s == loss_stage else None)):
                def bwd(*args):
                    ins, it = args[:n_in], iter(args[n_in:])
                    cots = [next(it) if k in wired else None
                            for k in range(n_out)]
                    return stage_vjp(gm, ins, cots, ones_at=loss_out)
                return bwd

            self._fwd.append(make_fwd())
            self._bwd.append(make_bwd())

            ppos = self._stage_ppos[s]
            param_vals = tuple(var_val(mod.invars[p]) for p in ppos)

            def make_ga(ppos=ppos, s=s, cd=comm_dtype):
                gens: Dict[int, torch.Generator] = {}

                def contrib(g, p):
                    if not cd or not g.is_floating_point():
                        return g
                    if cd == "bfloat16":
                        return g.to(torch.bfloat16)
                    if cd == "int8":
                        from tepdist_tpu_torch.parallel.quantize import (
                            fake_quant_int8)
                        if p not in gens:
                            gens[p] = torch.Generator(g.device).manual_seed(
                                (_INT8_SEED << 20) + s * 131 + p)
                        return fake_quant_int8(g, gens[p])
                    return g

                def ga(acc, bwd_outs):
                    # In place: only the GA chain holds the accumulator.
                    for a, p in zip(acc, ppos):
                        a.add_(contrib(bwd_outs[p], p).to(a.dtype))
                    return acc
                return ga

            def make_gainit(vals=param_vals, dev=dev):
                def gi():
                    return tuple(torch.zeros(v.shape, dtype=v.dtype,
                                             device=dev) for v in vals)
                return gi

            self._ga.append(make_ga())
            self._gainit.append(make_gainit())

    # ------------------------------------------------------------------
    # Variable management (stage-held; reference RegisteredForVariable /
    # VarsCacheInRemote / FetchResourceVars).
    def load_variables(self, params) -> None:
        """Place each param leaf on its owner stage's device (a tensor
        already there is used as it is, as the eager plan uses it) and
        initialize each stage's optimizer state over the params it owns,
        keyed by flat index."""
        flat = tree_leaves(params)
        self.params_tree = tree_structure(params)
        self.n_params = len(flat)
        for i, leaf in enumerate(flat):
            s = self.param_owner.get(i, 0)   # an unused param: stage 0
            self.var_store[i] = leaf.to(self.stage_device[s])
        self._param_cache.clear()
        if self.optimizer is not None:
            for s in range(self.prog.num_stages):
                sub = {i: self.var_store[i] for i in sorted(self.param_owner)
                       if self.param_owner[i] == s}
                self.opt_states[s] = self.optimizer.init(sub) if sub else None

    def _stage_param(self, s: int, i: int) -> torch.Tensor:
        """Param value for stage ``s``: the owner's tensor, copied to
        ``s``'s device if shared across devices (once a step: params change
        only at APPLY)."""
        val = self.var_store[i]
        if self.param_owner.get(i, s) == s:
            return val
        key = (s, i)
        if key not in self._param_cache:
            self._param_cache[key] = val.to(self.stage_device[s],
                                            non_blocking=True)
        return self._param_cache[key]

    def fetch_variables(self):
        """The params tree: the live stage-held tensors, not copies."""
        assert self.params_tree is not None, "load_variables first"
        return tree_unflatten(self.params_tree,
                              [self.var_store[i]
                               for i in range(self.n_params)])

    # -- global optimizer-state assembly --------------------------------
    # Per-stage states are optimizer.init({i: leaf}) over GLOBAL flat param
    # indices, so a whole-run state with the same index-dict structure is
    # assembled leaf for leaf BY TREE PATH: mirroring leaves (mu/nu[i])
    # come from the owning stage, params-independent scalars (the step
    # count) are equal across stages. Its flat leaf ORDER is that of
    # optimizer.init(user_params_tree) (index order == flatten order), so
    # pipeline checkpoints cross to the eager plan and back.

    def _opt_template(self):
        """The global state's structure, on the meta device (no memory)."""
        full = {i: torch.empty_like(self.var_store[i], device="meta")
                for i in range(self.n_params)}
        return self.optimizer.init(full)

    def fetch_opt_state(self):
        """Assemble the per-stage states into ONE state over the full index
        dict (its flat leaves are the eager plan's)."""
        assert self.optimizer is not None, "no optimizer"
        template = self._opt_template()
        stage_maps = {s: dict(_tree_paths(st))
                      for s, st in self.opt_states.items() if st is not None}
        extra_map: Dict[Tuple, Any] = {}   # leaves of graph-UNUSED params
        leaves = []
        for path, _ in _tree_paths(template):
            i = _leaf_owner_index(path)
            if i is not None:
                owner = stage_maps.get(self.param_owner.get(i, 0), {})
                if path in owner:
                    leaves.append(owner[path])
                else:
                    # Param unused by the graph: no stage state holds its
                    # moments; they are their INIT values (it never
                    # updates).
                    if path not in extra_map:
                        extra_map.update(_tree_paths(
                            self.optimizer.init({i: self.var_store[i]})))
                    leaves.append(extra_map[path])
            else:
                # Params-independent scalar (the count): any stage's.
                src = next(m for m in stage_maps.values() if path in m)
                leaves.append(src[path])
        return tree_unflatten(template, leaves)

    def load_opt_state(self, state) -> None:
        """Scatter a global state back into the per-stage states (inverse
        of fetch_opt_state; any tree with the template's flat leaves). The
        leaves are copied onto each stage's device."""
        assert self.optimizer is not None, "no optimizer"
        tmpl = _tree_paths(self._opt_template())
        state_leaves = tree_leaves(state)
        if len(state_leaves) != len(tmpl):
            raise ValueError(
                f"optimizer state has {len(state_leaves)} leaves; "
                f"expected {len(tmpl)}")
        by_key = {path: v for (path, _), v in zip(tmpl, state_leaves)}
        for s, st in self.opt_states.items():
            if st is None:
                continue
            dev = self.stage_device[s]
            self.opt_states[s] = tree_unflatten(
                st, [by_key[p].to(dev, copy=True)
                     for p, _ in _tree_paths(st)])

    # ------------------------------------------------------------------
    def step(self, *batch) -> float:
        """Run one scheduled training step; returns the mean loss (the one
        host wait of the step).

        With DEBUG on, per-task wall-clock is logged with task/stage/micro
        ids, read from the task's span (DEBUG implies tracing)."""
        debug = ServiceEnv.get().debug
        tracing = tracer().enabled
        sp_step = (span("pipeline_step", cat="step",
                        step=self.global_step).__enter__()
                   if tracing else _NULL_SPAN)
        prog = self.prog
        M = prog.num_micro_batches
        bdim = prog.batch_dim
        self._param_cache.clear()

        # SPLIT: one split of each batch leaf into M micro slices (views).
        micro_slices: Dict[Tuple[int, int], torch.Tensor] = {}
        for j, leaf in enumerate(tree_leaves(tuple(batch))):
            i = self.n_params + j
            msize = leaf.shape[bdim] // M
            for m, sl in enumerate(leaf.split(msize, dim=bdim)[:M]):
                micro_slices[(m, i)] = sl

        outputs: Dict[int, Tuple] = {}
        losses: List[torch.Tensor] = []

        def stage_args(s: int, m: int, tid: int) -> List[Any]:
            node = self.dag.node(tid)
            dev = self.stage_device[s]
            args: List[Any] = []
            for kind, i, pos in self._arg_templates[s]:
                if kind == "param":
                    args.append(self._stage_param(s, i))
                elif kind == "batch":
                    args.append(micro_slices[(m, i)].to(dev,
                                                        non_blocking=True))
                else:
                    pid, oi = node.input_specs[pos]
                    args.append(outputs[pid][oi])
            return args

        for tid in self.schedule.order:
            node = self.dag.node(tid)
            tt = node.task_type
            s, m = node.stage, node.micro
            sp = (span(node.name, cat=_SPAN_CAT.get(tt, "data"),
                       stage=s, micro=m, task=tid,
                       step=self.global_step).__enter__()
                  if tracing else _NULL_SPAN)
            if tt in (TaskType.SPLIT, TaskType.INPUT, TaskType.MERGE):
                outputs[tid] = ()
            elif tt == TaskType.COMPUTE and node.name.startswith("fwd"):
                outs = self._fwd[s](*stage_args(s, m, tid))
                outputs[tid] = outs
                if s == self._loss_stage:
                    losses.append(outs[prog.stages[s].graph_out_map[0]])
            elif tt == TaskType.COMPUTE and node.name.startswith("bwd"):
                n_in = len(prog.stages[s].invars)
                args = stage_args(s, m, tid)
                cot_args = [outputs[pid][oi] for pos, (pid, oi) in
                            sorted(node.input_specs.items())
                            if pos >= n_in]
                outputs[tid] = self._bwd[s](*args, *cot_args)
            elif tt == TaskType.SEND:
                pid, oi = node.input_specs[0]
                outputs[tid] = (outputs[pid][oi],)
            elif tt == TaskType.RECV:
                pid, oi = node.input_specs[0]
                outputs[tid] = (_to_device(outputs[pid][oi],
                                           self.stage_device[s]),)
            elif tt == TaskType.GAINIT:
                outputs[tid] = (self._gainit[s](),)
            elif tt == TaskType.GA:
                acc_pid, acc_oi = node.input_specs[0]
                bwd_pid, _ = node.input_specs[1]
                outputs[tid] = (self._ga[s](outputs[acc_pid][acc_oi],
                                            outputs[bwd_pid]),)
            elif tt == TaskType.APPLY:
                pid, oi = node.input_specs[0]
                acc = outputs[pid][oi]
                extras = {}
                for pos, (epid, eoi) in node.input_specs.items():
                    if pos >= 1:
                        extras[pos - 1] = outputs[epid][eoi]  # pos-1 = stage
                self._apply_stage(s, acc, M, extras)
                outputs[tid] = ()
            else:
                outputs[tid] = ()
            if tracing:
                if tt in (TaskType.SEND, TaskType.RECV):
                    sp.set(bytes=sum(
                        v.nbytes for v in outputs.get(tid, ())
                        if isinstance(v, torch.Tensor)))
                sp.__exit__(None, None, None)
            if debug:
                log.info("[task] %s stage=%d micro=%d %.3f ms",
                         node.key(), node.stage, node.micro, sp.dur_ms)
            # GC: free buffers whose last consumer just ran.
            for rid in node.mem_to_release:
                outputs.pop(rid, None)

        self.global_step += 1
        # ONE host wait for all micro losses.
        loss = float(torch.stack([x.float() for x in losses]).sum()) / M
        metrics().counter("pipeline_steps").inc()
        if tracing:
            sp_step.__exit__(None, None, None)
        if debug:
            log.info("[ExecutePlan Duration] step=%d %.3f ms",
                     self.global_step, sp_step.dur_ms)
        return loss

    @torch.no_grad()
    def _apply_stage(self, s: int, acc: Tuple, M: int,
                     extras: Optional[Dict[int, Tuple]] = None) -> None:
        """Apply the mean gradient of the params OWNED by stage ``s``,
        adding the accumulators of the other stages that use a shared
        param (a tied embedding's last-stage contribution reaches its
        owner here, once). The port's optimizers update the params in
        place."""
        owner = self.param_owner
        dev = self.stage_device[s]
        grads = {i: g for i, g in zip(self._stage_pidx[s], acc)
                 if owner[i] == s}
        for t in sorted(extras or {}):
            for i, g in zip(self._stage_pidx[t], extras[t]):
                if owner.get(i) == s and i in grads:
                    grads[i] = grads[i] + g.to(dev)
        if not grads:
            return
        grads = {i: g / M for i, g in grads.items()}
        params = {i: self.var_store[i] for i in grads}
        if self.optimizer is None:
            for i, g in grads.items():
                self.var_store[i] = params[i] - 0.01 * g
            return
        self.opt_states[s] = self.optimizer.apply(params, grads,
                                                  self.opt_states[s])
