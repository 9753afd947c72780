"""PipelineExecutable: execute a scheduled TaskDAG on a list of devices: the
port of ``tepdist_tpu/runtime/executor.py``.

Reference parity: ``DAPPLEExecutable`` (reference: pjrt/virtual_client.cc —
per-task-type executors DoInputTask/DoComputeTask/DoSendTask/DoRecvTask/
DoGATask/DoGAInitTask/DoOutputTask and the per-device ``ExecuteTaskList``
loop). In the port:

  * The devices form stage groups: ``per`` devices a group, ``per = dp *
    tp`` (``intra_stage_tp`` = tp). Stage ``s`` runs on group ``s`` (or
    ``s % G`` under interleaved placement) as ``dp`` intra-stage data
    replicas, each over ``tp`` devices of tensor parallelism.
  * A process holds some ranks of some groups, in one of two forms (as
    ``ops/seq_comm`` runs the ring):

    - the one-process form (no process group, or a world of one): the
      process holds every rank of every group, ``devices`` naming them
      (a device may repeat: ``["cuda:0"] * 4`` on one card, ``["cpu"] * 4``
      in the tests); a SEND/RECV is a ``tensor.to(device)`` and the
      replicas' collectives are copies and adds (``DeviceTransport``);
    - the group form (a world of ``G * dp * tp`` ranks, one device each):
      rank ``g * per + r * tp + t`` holds coordinate (group g, intra r,
      model t). Every rank walks the SAME static order (the scheduler's,
      made on rank 0 and sent to all) and issues only its groups' tasks; a
      SEND/RECV is point-to-point between the ranks with the same (intra,
      model) coordinates of the two groups, and the replicas' collectives
      run over the intra process group (``GroupTransport``).

  * Point-to-point ordering: NCCL matches the n-th send to the n-th recv
    of a pair of ranks and ignores tags, so no tags are passed, and both
    ends post a transfer where the global order lists its SEND (the
    receiver's irecv is posted then, and waited on at the RECV task: the
    consumer's stream waits, the host does not). Each pair thus posts its
    transfers in one sequence on both ends, and a transfer at position p
    waits only on work at earlier positions, so 1F1B cannot deadlock.
    Shared parameters (GPT-2's tied ``wte``) reach their other stages the
    same way before the order's first task, each step.
  * Intra-stage data parallelism: stage modules are captured at a
    replica's rows (``PipelineProgram.with_replicas``); replica r takes
    rows r of each micro batch; parameters are replicated; the partial
    gradients are summed ONCE, at APPLY (an all-reduce over the replicas),
    and losses and gradients are averaged over replicas and micro batches.
    A winner's compressed comm dtype (bf16, int8) acts on the reduced
    per-micro contribution, as the reference's GSPMD reduces in the
    backward program: then each micro's contribution is all-reduced
    before its cast or fake quantization.
  * ZeRO (``prog.zero``, dp > 1): each stage's optimizer state is held as
    padded flat leaves (``sync_free.zero_pad_params``), replica r holding
    rows ``[r * c, (r + 1) * c)``; APPLY is reduce-scatter -> the update on
    the shard -> all-gather.
  * Stage x TP (group form only; one process cannot hold the ranks of a
    TP group): each stage's forward graph is planned over ``model`` by
    ``CostSpmdStrategy`` with dim 0 forbidden on every tensor of the
    replica's rows, and runs as a DTensor program (``spmd_transform``'s
    interpreter) on the ``model`` dimension of one ``DeviceMesh``
    ("stage", "intra", "model"). Values cross stages as local shards with
    the producer's placements and are redistributed on the consumer's
    sub-mesh.
  * Each payload is a plain Python callable over tensors: a stage's forward
    is its ``fx.GraphModule`` under ``torch.no_grad()``; its backward runs
    that module again under autograd (``parallel/pipeline.stage_vjp``).
  * Variables are held per stage: parameters and optimizer state live on
    their owning stage's devices across steps, and ``fetch_variables`` /
    ``fetch_opt_state`` assemble the global state whose flat leaves are the
    eager plan's (from every rank in the group form), so checkpoints cross
    between the runtimes.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tepdist_tpu_torch.core.device import resolve_device
from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.core.tree import (tree_leaves, tree_structure,
                                         tree_unflatten)
from tepdist_tpu_torch.graph.fx_graph import var_shape, var_val
from tepdist_tpu_torch.ops.seq_comm import DeviceTransport, GroupTransport
from tepdist_tpu_torch.parallel.pipeline import (PipelineProgram, on_rank0,
                                                 stage_vjp)
from tepdist_tpu_torch.parallel.sync_free import zero_pad_flat
from tepdist_tpu_torch.runtime.checkpoint import ShardPieces
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

# Seed of the int8 gradient fake-quant generators; each (stage, slot)
# folds in s * 131 + p, as the reference folds its PRNG key (the same on
# every replica, which quantizes the same reduced contribution).
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


def _zero_chunk(numel: int, dp: int) -> int:
    """Rows of one replica's shard of a padded flat leaf."""
    return -(-numel // dp)


def _flat_range_boxes(shape: Sequence[int], a: int, b: int
                     ) -> List[Tuple[Tuple[int, int], ...]]:
    """The flat range ``[a, b)`` of a C-ordered tensor of ``shape`` as
    rectangular boxes (per dim ``(start, stop)``), in flat order: a ZeRO
    shard of a padded flat leaf as checkpoint shard entries."""
    shape = tuple(shape)
    if a >= b:
        return []
    if len(shape) <= 1:
        return [((a, b),)]
    inner = 1
    for d in shape[1:]:
        inner *= d
    r0, r_last = a // inner, (b - 1) // inner
    if r0 == r_last:
        return [((r0, r0 + 1),) + box for box in _flat_range_boxes(
            shape[1:], a - r0 * inner, b - r0 * inner)]
    boxes = []
    full_from, full_to = r0, b // inner
    if a % inner:
        boxes += [((r0, r0 + 1),) + box for box in _flat_range_boxes(
            shape[1:], a % inner, inner)]
        full_from = r0 + 1
    if full_from < full_to:
        boxes.append(((full_from, full_to),)
                     + tuple((0, d) for d in shape[1:]))
    if b % inner:
        boxes += [((full_to, full_to + 1),) + box for box in
                  _flat_range_boxes(shape[1:], 0, b % inner)]
    return boxes


def stage_replicas(n_devices: int, num_stages: int, intra_stage_tp: int = 1,
                   placement: str = "blocked",
                   interleave_groups: Optional[int] = None) -> int:
    """The intra-stage data replicas an executable over ``n_devices``
    devices gives each stage: a group's devices over its TP degree (what
    ``plan_pipeline(..., replicas=...)`` captures for, once)."""
    groups = (num_stages if placement != "interleaved"
              else interleave_groups or min(n_devices, num_stages))
    return max(n_devices // groups // max(int(intra_stage_tp), 1), 1)


class PipelineExecutable:
    """Owns variables + stage programs; runs scheduled steps."""

    def __init__(
        self,
        prog: PipelineProgram,
        devices: Optional[Sequence] = None,
        optimizer=None,
        intra_stage_tp: int = 1,
        stage_var_mem_limit: Optional[int] = None,
        placement: str = "blocked",
        interleave_groups: Optional[int] = None,
    ):
        """``devices``: the devices of every rank (one per rank in the
        group form, this rank's at its index), by default ``[cuda:0] *
        num_stages`` (the group form: ``[this rank's card] * world``),
        never the CPU unless asked.

        ``placement``: "blocked" (stage s on group s, ``len(devices) //
        S`` devices a group) or "interleaved" — VIRTUAL stages: more
        stages than device groups, assigned round-robin (stage s -> group
        s % G, G = ``interleave_groups`` or min(devices, stages)); hops
        between co-resident stages are direct edges (no send/recv), and
        the scheduler's candidate search includes the Megatron
        chunk-alternating priority.

        ``intra_stage_tp``: the model-parallel degree within a group; the
        rest of the group's devices are intra-stage data replicas, each
        running its share of every micro batch's rows (the reference's
        ``intra_stage_dp``, always on here). ``stage_var_mem_limit``
        (default VAR_MEM_LIMIT) caps each device's stage variables in the
        TP planner's ILP. ZeRO is ``prog.zero``."""
        import torch.distributed as dist

        S = prog.num_stages
        self.group_form = dist.is_initialized() and dist.get_world_size() > 1
        world = dist.get_world_size() if self.group_form else 1
        self.rank = dist.get_rank() if self.group_form else 0
        if devices is None:
            devices = [resolve_device("cuda")] * (world if self.group_form
                                                  else S)
        devices = [resolve_device(d) for d in devices]
        if self.group_form and len(devices) != world:
            raise ValueError(f"the group form takes one device a rank: "
                             f"{len(devices)} devices for {world} ranks")
        if placement not in ("blocked", "interleaved"):
            raise ValueError(f"unknown placement {placement!r}")
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
            self._stage_group = [s % G for s in range(S)]
        else:
            G = S
            if len(devices) < S:
                raise ValueError(f"need >= {S} devices for {S} stages")
            if self.group_form and len(devices) % S:
                raise ValueError(f"{len(devices)} ranks do not divide into "
                                 f"{S} stage groups")
            self._stage_group = list(range(S))
        per = len(devices) // G
        tp = max(int(intra_stage_tp), 1)
        if per % tp:
            raise ValueError(
                f"{per} devices/stage not divisible by intra_stage_tp={tp}")
        if tp > 1 and not self.group_form:
            raise ValueError(
                f"intra_stage_tp={tp}: tensor parallelism needs one rank a "
                "device (a process group of one rank per device); one "
                "process cannot hold the ranks of a TP group")
        dp = per // tp
        self.num_groups, self.per, self.tp, self.dp = G, per, tp, dp
        self.intra_dp = dp > 1
        self.devices = devices
        if prog.replicas != dp:
            prog = prog.with_replicas(dp)
        self.prog = prog
        self.zero = bool(getattr(prog, "zero", False)) and dp > 1

        # Held replicas: stage s -> [(replica r, device)] this process runs.
        self._coord = ((self.rank // per, (self.rank % per) // tp,
                        self.rank % tp) if self.group_form else None)
        self._held: List[List[Tuple[int, torch.device]]] = []
        for s in range(S):
            g = self._stage_group[s]
            if not self.group_form:
                self._held.append([(r, devices[g * per + r])
                                   for r in range(dp)])
            elif g == self._coord[0]:
                self._held.append([(self._coord[1], devices[self.rank])])
            else:
                self._held.append([])
        self.stage_device: List[torch.device] = [
            devices[self._stage_group[s] * per] for s in range(S)]
        self.stage_devices: List[Tuple[int, ...]] = [
            tuple(range(g * per, (g + 1) * per)) for g in self._stage_group]
        # The device type the schedule is priced for (ASYNC_TRANSPORT).
        self.device_type = ("cuda" if any(d.type == "cuda" for d in devices)
                            else "cpu")
        self._mesh = None
        self._intra: Dict[int, Any] = {}
        if self.group_form:
            from torch.distributed.device_mesh import init_device_mesh

            self._mesh = init_device_mesh(
                devices[self.rank].type, (G, dp, tp),
                mesh_dim_names=("stage", "intra", "model"))
            intra = GroupTransport(self._mesh.get_group("intra"))
            for s in range(S):
                if self._held[s]:
                    self._intra[s] = intra
            # One process group per direction of each pair of peers (the
            # ranks with one (intra, model) coordinate in two groups): an
            # unbatched P2P op on the world group is serialized with every
            # other op there (NCCL with eager init), and one direction's
            # transfers must not queue behind the other's.
            self._p2p: Dict[Tuple[int, int], Any] = {}
            for g1 in range(G):
                for g2 in range(G):
                    for c in range(per if g1 != g2 else 0):
                        pair = (g1 * per + c, g2 * per + c)
                        group = dist.new_group(list(pair))
                        if self.rank in pair:
                            self._p2p[pair] = group
        else:
            for s in range(S):
                self._intra[s] = DeviceTransport([d for _, d in
                                                  self._held[s]])
        if stage_var_mem_limit is None:
            env_lim = ServiceEnv.get().var_mem_limit
            stage_var_mem_limit = env_lim if env_lim > 0 else None
        self._stage_var_mem_limit = stage_var_mem_limit

        self.dag, self.maps = build_pipeline_task_dag(
            prog, self.stage_devices)
        # Every rank runs rank 0's order (the scheduler's candidate search
        # may end on a tie that ranks break alike, but a time-limited
        # search need not).
        self.schedule: ScheduleResult = on_rank0(
            lambda: TaskScheduler(self.dag,
                                  device_type=self.device_type).schedule())
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
        # (param, consumer stage) pairs handed over each step, in the one
        # order every rank posts them.
        self._shared = sorted((i, s) for i, ss in self.param_stages.items()
                              for s in ss if s != self.param_owner[i])

        self._tp_in_specs: List[Optional[List]] = [None] * S
        self._tp_out_specs: List[Optional[List]] = [None] * S
        self._spmd: List[Any] = [None] * S
        if tp > 1:
            self._plan_stage_tp()
        self._compile_payloads()
        # Stage-held state.
        self.var_store: Dict[int, torch.Tensor] = {}
        self.opt_states: Dict[int, Any] = {}
        self.params_tree = None
        self.n_params = 0
        self.global_step = 0
        self._param_cache: Dict[Tuple[int, int, torch.device], Any] = {}

    # ------------------------------------------------------------------
    # Stage x TP (the group form).
    def _micro_rows(self) -> Optional[int]:
        """Rows of a replica's share of a micro batch: dim 0 of the first
        batch leaf as the stage modules were captured."""
        prog = self.prog
        if not prog.batch_flat_indices:
            return None
        shape = var_shape(prog.graph.invars[prog.batch_flat_indices[0]])
        return shape[prog.batch_dim] if shape else None

    def _compose_spec(self, v, st, allow_intra: bool):
        """The (intra, model) placement of a stage value (the reference's
        ``_compose_spec``): the replica's rows on ``intra`` under intra-DP
        (handled by the executor, not DTensor: each replica runs its own
        rows), the planner's split on ``model``."""
        from torch.distributed.tensor import Replicate, Shard

        shape = var_shape(v)
        intra = (Shard(0) if allow_intra and self.intra_dp and shape
                 and shape[0] == self._micro_rows() else Replicate())
        model = Replicate()
        if (st is not None and st.is_split()
                and st.partition_dim < len(shape)
                and not (isinstance(intra, Shard) and st.partition_dim == 0)
                and shape[st.partition_dim] % self.tp == 0):
            model = Shard(st.partition_dim)
        return (intra, model)

    def _plan_stage_tp(self) -> None:
        """Plan each stage's forward graph over the ``model`` axis with the
        cost planner (reference ``_plan_stage_tp``: per-stage SPMD planning
        under the stage split ordinal) on rank 0, sent to every rank, and
        lower each to a DTensor program on the ``model`` mesh dimension.
        Fills ``_tp_in_specs`` / ``_tp_out_specs`` (model placements per
        stage input / output) and ``_spmd``."""
        from tepdist_tpu_torch.core.mesh import MeshTopology
        from tepdist_tpu_torch.graph.fx_graph import FxGraph
        from tepdist_tpu_torch.parallel.auto_parallel import plan_on_rank0
        from tepdist_tpu_torch.parallel.cost_spmd_strategy import (
            CostSpmdStrategy)
        from tepdist_tpu_torch.parallel.spmd_transform import SpmdTransform

        prog, tp = self.prog, self.tp
        rows = self._micro_rows()
        model_mesh = self._mesh["model"]
        batch_set = set(prog.batch_flat_indices)
        topo = MeshTopology([("model", tp)])
        for s in range(prog.num_stages):
            mod = prog.stages[s]
            gm = prog.decomp.stage_fn(s, device=self.devices[self.rank])
            g = FxGraph(gm)
            # The intra axis owns the replica's rows: the model planner may
            # not split dim 0 of ANY tensor of those rows (inputs AND
            # interior values: the row dim flows through).
            forbidden: Dict[Any, set] = {}
            if self.intra_dp and rows:
                allv = list(g.invars) + [ov for n in g.nodes
                                         for ov in n.outvars
                                         if ov is not None]
                for v in allv:
                    shape = var_shape(v)
                    if shape and shape[0] == rows:
                        forbidden[v] = {0}
            (gs,), _ = plan_on_rank0(g, lambda: ([CostSpmdStrategy(
                g, "model", tp, fixed={}, forbidden_dims=forbidden,
                mem_limit_bytes=self._stage_var_mem_limit).run()], None))
            xform = SpmdTransform(g, topo)
            plan = xform.lower([gs])
            in_specs, out_specs = [], []
            for pos, v in enumerate(g.invars):
                src = mod.input_def_map[pos]
                allow_intra = (src[0] == "stage"
                               or (src[0] == "arg" and src[1] in batch_set))
                composed = self._compose_spec(
                    v, gs.var_strategies.get(v), allow_intra)
                plan.in_specs[pos] = [composed[1]]
                in_specs.append(composed)
            for k, a in enumerate(g.outvars):
                st = gs.var_strategies.get(a) if a is not None else None
                composed = self._compose_spec(a, st, True)
                plan.out_specs[k] = [composed[1]]
                out_specs.append(composed)
            self._tp_in_specs[s] = in_specs
            self._tp_out_specs[s] = out_specs
            self._spmd[s] = xform.executable(plan, mesh=model_mesh)
            log.info("stage %d TP plan over model=%d: %d/%d inputs split",
                     s, tp, sum(1 for p in in_specs
                                if type(p[1]).__name__ == "Shard"),
                     len(in_specs))

    def _tp_local(self, val):
        """A DTensor's local shard (plain tensors pass through)."""
        return val.to_local() if hasattr(val, "to_local") else val

    def _tp_wrap(self, local, spec):
        """A local shard with (intra, model) placements ``spec`` as a
        DTensor on this rank's ``model`` sub-mesh."""
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(local, self._mesh["model"], [spec[1]],
                                  run_check=False)

    def _tp_as(self, val, spec):
        """``val`` (a DTensor, or a whole plain value every rank of the
        model group holds) with model placement ``spec``."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        mesh = self._mesh["model"]
        if isinstance(val, DTensor):
            if list(val.placements) != [spec[1]]:
                val = val.redistribute(mesh, [spec[1]])
            return val
        return distribute_tensor(val, mesh, [spec[1]], src_data_rank=None)

    def _respec(self, local, have, want):
        """A local shard with placements ``have`` as this rank's shard
        under ``want`` (the same tensor where they agree)."""
        if have is None or have == want:
            return local
        return self._tp_as(self._tp_wrap(local, have), want).to_local()

    def _local_shape(self, v, spec) -> Tuple[int, ...]:
        """This rank's local shape of stage value ``v`` under ``spec``."""
        if spec is None:
            return tuple(var_shape(v))
        from torch.distributed.tensor._utils import (
            compute_local_shape_and_global_offset)

        shape, _ = compute_local_shape_and_global_offset(
            tuple(var_shape(v)), self._mesh["model"], [spec[1]])
        return tuple(shape)

    # ------------------------------------------------------------------
    def _compile_payloads(self) -> None:
        """The task bodies of every held stage (the reference's AOT-
        compiled executables): plain callables over tensors, one module a
        stage and device. Compiling a stage is speed work for later."""
        prog = self.prog
        S = prog.num_stages
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
        # The position of each param in each stage that reads it.
        self._param_pos: Dict[Tuple[int, int], int] = {
            (s, i): p for s in range(S)
            for p, i in zip(self._stage_ppos[s], self._stage_pidx[s])}
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
        self._comm_dtype = getattr(prog, "comm_dtype", "") or ""
        # With replicas, a compressed contribution is the reduced one.
        self._reduce_per_micro = bool(self._comm_dtype) and self.dp > 1
        self._gms: Dict[Tuple[int, torch.device], Callable] = {}
        self._gens: Dict[Tuple[int, int, int], torch.Generator] = {}

    def _stage_gm(self, s: int, device: torch.device) -> Callable:
        """Stage ``s``'s forward on ``device``: its GraphModule, or under
        TP its DTensor program (over flat inputs)."""
        key = (s, device)
        if key not in self._gms:
            if self._spmd[s] is not None:
                exe = self._spmd[s]
                self._gms[key] = lambda *args: tuple(exe.run(list(args)))
            else:
                self._gms[key] = self.prog.decomp.stage_fn(s, device=device)
        return self._gms[key]

    def _fwd(self, s: int, device, args):
        outs = self._stage_gm(s, device)
        with torch.no_grad():
            return tuple(outs(*args))

    def _bwd(self, s: int, device, args, cot_args):
        mod = self.prog.stages[s]
        n_in, n_out = len(mod.invars), len(mod.outvars)
        wired = self._bwd_wired[s]
        it = iter(cot_args)
        cots = [next(it) if k in wired else None for k in range(n_out)]
        loss_out = (mod.graph_out_map.get(0) if s == self._loss_stage
                    else None)
        grads = stage_vjp(self._stage_gm(s, device), args[:n_in], cots,
                          ones_at=loss_out)
        if self._spmd[s] is not None:
            # Every cotangent in its input's planned placement.
            grads = tuple(None if g is None
                          else self._tp_as(g, self._tp_in_specs[s][pos])
                          for pos, g in enumerate(grads))
        return grads

    def _contrib(self, s: int, k: int, p: int, g: torch.Tensor):
        """One micro batch's gradient contribution through the comm
        dtype."""
        cd = self._comm_dtype
        if not cd or not g.is_floating_point():
            return g
        if cd == "bfloat16":
            return g.to(torch.bfloat16)
        if cd == "int8":
            from tepdist_tpu_torch.parallel.quantize import fake_quant_int8
            key = (s, k, p)
            if key not in self._gens:
                self._gens[key] = torch.Generator(g.device).manual_seed(
                    (_INT8_SEED << 20) + s * 131 + p)
            return fake_quant_int8(g, self._gens[key])
        return g

    def _ga(self, s: int, accs: List[Tuple], bwd_outs: List[Tuple]):
        """GA over the held replicas: in place (only the GA chain holds
        the accumulators)."""
        ppos = self._stage_ppos[s]
        if self._reduce_per_micro:
            # The reduced contribution (mean over the replicas), then its
            # compression, as the reference's backward program reduces.
            dp = self.dp
            for j, p in enumerate(ppos):
                gs = [self._tp_local(o[p]) for o in bwd_outs]
                total = self._intra[s].all_reduce_raw(
                    [g.clone() if g.is_floating_point() else g for g in gs])
                for k, (acc, g) in enumerate(zip(accs, total)):
                    acc[j].add_(self._contrib(s, k, p, g / dp)
                                .to(acc[j].dtype))
            return accs
        for k, (acc, outs) in enumerate(zip(accs, bwd_outs)):
            for a, p in zip(acc, ppos):
                a.add_(self._contrib(s, k, p, self._tp_local(outs[p]))
                       .to(a.dtype))
        return accs

    def _gainit(self, s: int, device) -> Tuple:
        mod = self.prog.stages[s]
        out = []
        for p in self._stage_ppos[s]:
            v = mod.invars[p]
            spec = (self._tp_in_specs[s][p]
                    if self._tp_in_specs[s] is not None else None)
            out.append(torch.zeros(self._local_shape(v, spec),
                                   dtype=var_val(v).dtype, device=device))
        return tuple(out)

    # ------------------------------------------------------------------
    # Variable management (stage-held; reference RegisteredForVariable /
    # VarsCacheInRemote / FetchResourceVars). The process keeps ONE copy
    # of each param it holds (under TP its local shard): on its first held
    # replica's device; its other replicas read it through ``.to()``.
    def _param_spec(self, s: int, i: int):
        if self._tp_in_specs[s] is None:
            return None
        return self._tp_in_specs[s][self._param_pos[(s, i)]]

    def _home(self, i: int) -> int:
        """The stage that holds param ``i`` (an unused param: stage 0)."""
        return self.param_owner.get(i, 0)

    def load_variables(self, params) -> None:
        """Place each param leaf with its owner stage (a tensor already on
        the device is used as it is, as the eager plan uses it; under TP
        this rank's shard) and initialize each stage's optimizer state over
        the params it owns, keyed by flat index (ZeRO: over this process's
        shards of them). In the group form every rank passes the same
        whole tree and keeps its groups' leaves."""
        flat = tree_leaves(params)
        self.params_tree = tree_structure(params)
        self.n_params = len(flat)
        self._param_meta = [(tuple(x.shape), x.dtype) for x in flat]
        self.var_store = {}
        for i, leaf in enumerate(flat):
            s = self._home(i)
            if not self._held[s]:
                continue
            dev = self._held[s][0][1]
            spec = self._param_spec(s, i) if i in self.param_owner else None
            if spec is not None:
                leaf = self._tp_as(leaf.to(dev), spec).to_local()
            self.var_store[i] = leaf.to(dev)
        self._param_cache.clear()
        self.opt_states = {}
        if self.optimizer is None:
            return
        for s in range(self.prog.num_stages):
            if not self._held[s]:
                continue
            owned = [i for i in sorted(self.param_owner)
                     if self.param_owner[i] == s]
            if not owned:
                self.opt_states[s] = None
            elif self.zero:
                self.opt_states[s] = {
                    r: self.optimizer.init(
                        {i: self._zero_shard(self.var_store[i], r, dev)
                         for i in owned})
                    for r, dev in self._held[s]}
            else:
                self.opt_states[s] = self.optimizer.init(
                    {i: self.var_store[i] for i in owned})

    def _zero_shard(self, x: torch.Tensor, r: int, device) -> torch.Tensor:
        """Replica ``r``'s rows of ``x``'s padded flat layout (a copy)."""
        c = _zero_chunk(x.numel(), self.dp)
        return zero_pad_flat(x, self.dp)[r * c:(r + 1) * c].to(device,
                                                             copy=True)

    def _stage_param(self, s: int, i: int, device):
        """Param ``i`` for stage ``s`` on ``device``: the held copy, or the
        copy handed over this step for a shared param; moved to the
        replica's device once a step (params change only at APPLY)."""
        key = (s, i, device)
        if key not in self._param_cache:
            if i in self.var_store:
                val = self._respec(self.var_store[i],
                                   self._param_spec(self._home(i), i),
                                   self._param_spec(s, i))
            else:
                val = self._handed[(i, s)]
            self._param_cache[key] = val.to(device, non_blocking=True)
        return self._param_cache[key]

    def _isend(self, t: torch.Tensor, dst: int):
        import torch.distributed as dist

        return dist.isend(t.contiguous(), dst,
                          group=self._p2p[(self.rank, dst)])

    def _irecv(self, buf: torch.Tensor, src: int):
        import torch.distributed as dist

        return dist.irecv(buf, src, group=self._p2p[(src, self.rank)])

    def _peer(self, group: int) -> int:
        """The rank of ``group`` with this rank's (intra, model)
        coordinates."""
        return group * self.per + self._coord[1] * self.tp + self._coord[2]

    def _leader(self, group: int) -> int:
        return group * self.per

    def _hand_over_shared(self) -> None:
        """Group form: each shared param crosses from its owner's group to
        each other consumer's, before the step's first task (P2P, posted
        in ``_shared``'s order on both ends)."""
        import torch.distributed as dist

        self._handed: Dict[Tuple[int, int], Any] = {}
        my_group = self._coord[0]
        pending = []
        for i, s in self._shared:
            src_g = self._stage_group[self.param_owner[i]]
            dst_g = self._stage_group[s]
            if src_g == dst_g:
                continue
            if my_group == src_g:
                self._sends.append(self._isend(self.var_store[i],
                                               self._peer(dst_g)))
            elif my_group == dst_g:
                spec = self._param_spec(self.param_owner[i], i)
                shape, dtype = self._param_meta[i]
                if spec is not None:
                    shape = self._local_shape(
                        self.prog.stages[self.param_owner[i]].invars[
                            self._param_pos[(self.param_owner[i], i)]], spec)
                buf = torch.empty(shape, dtype=dtype,
                                  device=self.devices[self.rank])
                pending.append((i, s, buf,
                                self._irecv(buf, self._peer(src_g)), spec))
        for i, s, buf, req, spec in pending:
            req.wait()
            self._handed[(i, s)] = self._respec(buf, spec,
                                                self._param_spec(s, i))

    # -- the global state, assembled from every rank ---------------------
    def _gather_leaf(self, group: int, local: Optional[torch.Tensor],
                     shape, dtype) -> torch.Tensor:
        """Group form: the whole value ``local`` that the ranks of
        ``group`` hold, on every rank (broadcast from the group's
        leader)."""
        import torch.distributed as dist

        dev = self.devices[self.rank]
        buf = (local.to(dev).contiguous() if self.rank == self._leader(group)
               else torch.empty(shape, dtype=dtype, device=dev))
        dist.broadcast(buf, src=self._leader(group))
        return buf

    def _whole_param(self, i: int) -> Optional[torch.Tensor]:
        """Param ``i`` whole, where this process holds it (under TP a
        collective over the model group)."""
        if i not in self.var_store:
            return None
        val = self.var_store[i]
        spec = self._param_spec(self._home(i), i) if (
            i in self.param_owner) else None
        if spec is not None:
            val = self._tp_wrap(val, spec).full_tensor()
        return val

    def fetch_variables(self):
        """The params tree: the live stage-held tensors in the one-process
        form; in the group form every leaf whole on every rank (a
        collective)."""
        assert self.params_tree is not None, "load_variables first"
        leaves = []
        for i in range(self.n_params):
            val = self._whole_param(i)
            if self.group_form:
                shape, dtype = self._param_meta[i]
                val = self._gather_leaf(self._stage_group[self._home(i)],
                                        val, shape, dtype)
            leaves.append(val)
        return tree_unflatten(self.params_tree, leaves)

    # Per-stage states are optimizer.init({i: leaf}) over GLOBAL flat param
    # indices, so a whole-run state with the same index-dict structure is
    # assembled leaf for leaf BY TREE PATH: mirroring leaves (mu/nu[i])
    # come from the owning stage, params-independent scalars (the step
    # count) are equal across stages. Its flat leaf ORDER is that of
    # optimizer.init(user_params_tree) (index order == flatten order), so
    # pipeline checkpoints cross to the eager plan and back.

    def _opt_template(self):
        """The global state's structure, on the meta device (no memory)."""
        full = {i: torch.empty(shape, dtype=dtype, device="meta")
                for i, (shape, dtype) in enumerate(self._param_meta)}
        return self.optimizer.init(full)

    def _stage_state_maps(self) -> Dict[int, Dict[Tuple, Any]]:
        """Held stage -> {path: leaf} of its state (ZeRO: replica ->
        {path: shard} under key ``("zero", r)``)."""
        maps: Dict[int, Dict[Tuple, Any]] = {}
        for s, st in self.opt_states.items():
            if st is None:
                continue
            if self.zero:
                maps[s] = {("zero", r): dict(_tree_paths(sub))
                           for r, sub in st.items()}
            else:
                maps[s] = dict(_tree_paths(st))
        return maps

    def _state_leaf(self, maps, s: int, path, i: Optional[int]):
        """Stage ``s``'s leaf at ``path`` whole, where this process holds
        it: ZeRO shards joined (a collective over the replicas in the
        group form), a TP shard gathered."""
        if s not in maps:
            return None
        if not self.zero:
            val = maps[s].get(path)
        else:
            shards = [maps[s][("zero", r)].get(path)
                      for r, _ in self._held[s]]
            if shards[0] is None:
                return None
            if i is None or shards[0].dim() == 0:
                val = shards[0]
            else:
                flat = self._intra[s].all_gather_raw(
                    [x.reshape(-1) for x in shards])[0]
                local = self.var_store[i]
                val = flat[:local.numel()].reshape(local.shape)
        if val is not None and i is not None and val.dim():
            spec = self._param_spec(s, i)
            if spec is not None:
                val = self._tp_wrap(val, spec).full_tensor()
        return val

    def fetch_opt_state(self):
        """Assemble the per-stage states into ONE state over the full index
        dict (its flat leaves are the eager plan's); in the group form on
        every rank (a collective)."""
        assert self.optimizer is not None, "no optimizer"
        template = self._opt_template()
        maps = self._stage_state_maps()
        first = next(s for s in range(self.prog.num_stages)
                     if any(self.param_owner.get(i) == s
                            for i in self.param_owner))
        extra_map: Dict[Tuple, Any] = {}   # leaves of graph-UNUSED params
        leaves = []
        for path, tleaf in _tree_paths(template):
            i = _leaf_owner_index(path)
            if i is not None and i in self.param_owner:
                s = self.param_owner[i]
                val = self._state_leaf(maps, s, path, i)
            elif i is not None:
                # Param unused by the graph: no stage state holds its
                # moments; they are their INIT values (it never updates).
                s = self._home(i)
                val = None
                if self._held[s]:
                    if path not in extra_map:
                        extra_map.update(_tree_paths(
                            self.optimizer.init({i: self.var_store[i]})))
                    val = extra_map[path]
            else:
                # Params-independent scalar (the count): the first owning
                # stage's.
                s = first
                val = self._state_leaf(maps, s, path, None)
            if self.group_form:
                val = self._gather_leaf(self._stage_group[s], val,
                                        tuple(tleaf.shape), tleaf.dtype)
            leaves.append(val)
        return tree_unflatten(template, leaves)

    def load_opt_state(self, state) -> None:
        """Scatter a global state back into the per-stage states (inverse
        of fetch_opt_state; any tree with the template's flat leaves). The
        leaves are copied onto each stage's devices; each process keeps
        what it holds (ZeRO: its shards, TP: its model shard)."""
        assert self.optimizer is not None, "no optimizer"
        tmpl = _tree_paths(self._opt_template())
        state_leaves = tree_leaves(state)
        if len(state_leaves) != len(tmpl):
            raise ValueError(
                f"optimizer state has {len(state_leaves)} leaves; "
                f"expected {len(tmpl)}")
        by_key = {path: v for (path, _), v in zip(tmpl, state_leaves)}

        def local(s, path, dev):
            val = by_key[path].to(dev, copy=True)
            i = _leaf_owner_index(path)
            if i is not None and val.dim():
                spec = self._param_spec(s, i)
                if spec is not None:
                    val = self._tp_as(val, spec).to_local().clone()
            return val, i

        for s, st in self.opt_states.items():
            if st is None:
                continue
            if not self.zero:
                dev = self._held[s][0][1]
                self.opt_states[s] = tree_unflatten(
                    st, [local(s, p, dev)[0] for p, _ in _tree_paths(st)])
                continue
            for r, dev in self._held[s]:
                sub = st[r]
                new = []
                for p, _ in _tree_paths(sub):
                    val, i = local(s, p, dev)
                    if i is not None and val.dim():
                        val = self._zero_shard(val, r, dev)
                    new.append(val)
                st[r] = tree_unflatten(sub, new)

    def checkpoint_leaves(self) -> List[Any]:
        """The flat (params, opt_state) leaves for a checkpoint: whole
        tensors, except the ZeRO optimizer leaves that mirror a param,
        which are this process's pieces (:class:`ShardPieces`, written as
        shard entries), so no rank gathers the sharded state."""
        params = tree_leaves(self.fetch_variables())
        if self.optimizer is None:
            return params
        if not self.zero:
            return params + tree_leaves(self.fetch_opt_state())
        template = self._opt_template()
        maps = self._stage_state_maps()
        whole = None
        leaves = []
        for n, (path, tleaf) in enumerate(_tree_paths(template)):
            i = _leaf_owner_index(path)
            if (i is None or i not in self.param_owner
                    or not tleaf.dim()):
                if whole is None:
                    whole = tree_leaves(self.fetch_opt_state())
                leaves.append(whole[n])
                continue
            s = self.param_owner[i]
            pieces = []
            for r, _ in self._held[s]:
                shard = maps[s][("zero", r)][path] if s in maps else None
                if shard is not None:
                    pieces += self._zero_pieces(s, i, r, shard)
            # Ids unique over every writer of the leaf: replica, TP rank,
            # box.
            pieces = [(n_id, b, t) for n_id, (b, t) in pieces]
            leaves.append(ShardPieces(tleaf.shape, tleaf.dtype, pieces))
        return params + leaves

    def _zero_pieces(self, s: int, i: int, r: int, shard: torch.Tensor):
        """Replica ``r``'s ZeRO shard of a leaf mirroring param ``i`` as
        (global bounds, tensor) boxes (offset by the TP shard's place)."""
        local_shape = tuple(self.var_store[i].shape)
        n = self.var_store[i].numel()
        c = _zero_chunk(n, self.dp)
        a, b = r * c, min((r + 1) * c, n)
        offset = [0] * len(local_shape)
        spec = self._param_spec(s, i)
        if spec is not None:
            from torch.distributed.tensor._utils import (
                compute_local_shape_and_global_offset)
            _, offset = compute_local_shape_and_global_offset(
                self._param_meta[i][0], self._mesh["model"], [spec[1]])
        out = []
        flat = shard.reshape(-1)
        model = self._coord[2] if self.group_form else 0
        for n_box, box in enumerate(_flat_range_boxes(local_shape, a, b)):
            lo = sum(st * stride for (st, _), stride in zip(
                box, torch.empty(local_shape, device="meta").stride()))
            dims = [hi - st for st, hi in box]
            numel = 1
            for d in dims:
                numel *= d
            # A box is contiguous in C order within its range.
            piece = flat[lo - a:lo - a + numel].reshape(dims)
            gbox = tuple((st + o, hi + o) for (st, hi), o in
                         zip(box, offset))
            out.append(((r * self.tp + model) * 64 + n_box, (gbox, piece)))
        return out

    # ------------------------------------------------------------------
    def step(self, *batch) -> float:
        """Run one scheduled training step; returns the mean loss (the one
        host wait of the step; in the group form a scalar all-reduce gives
        it to every rank).

        With DEBUG on, per-task wall-clock is logged with task/stage/micro
        ids, read from the task's span (DEBUG implies tracing)."""
        import torch.distributed as dist

        debug = ServiceEnv.get().debug
        tracing = tracer().enabled
        sp_step = (span("pipeline_step", cat="step",
                        step=self.global_step).__enter__()
                   if tracing else _NULL_SPAN)
        prog = self.prog
        M, dp = prog.num_micro_batches, self.dp
        bdim = prog.batch_dim
        self._param_cache.clear()
        # The step's isends, waited on at its end (on a card the stream
        # waits): a send's buffer lives until its transfer is done.
        self._sends: List[Any] = []
        if self.group_form:
            self._hand_over_shared()

        # SPLIT: each batch leaf into M micro slices, each into dp replica
        # shares where its rows divide (views).
        slices: Dict[Tuple[int, int, int], torch.Tensor] = {}
        for j, leaf in enumerate(tree_leaves(tuple(batch))):
            i = self.n_params + j
            msize = leaf.shape[bdim] // M
            for m, sl in enumerate(leaf.split(msize, dim=bdim)[:M]):
                for r in range(dp):
                    slices[(m, i, r)] = (
                        sl.narrow(bdim, r * (msize // dp), msize // dp)
                        if dp > 1 and msize % dp == 0 else sl)

        outputs: Dict[int, List[Tuple]] = {}
        pending: Dict[int, Any] = {}
        losses: List[torch.Tensor] = []

        def stage_args(s: int, m: int, tid: int, k: int) -> List[Any]:
            node = self.dag.node(tid)
            r, dev = self._held[s][k]
            specs = self._tp_in_specs[s]
            args: List[Any] = []
            for kind, i, pos in self._arg_templates[s]:
                if kind == "param":
                    val = self._stage_param(s, i, dev)
                    if specs is not None:
                        val = self._tp_wrap(val, specs[pos])
                elif kind == "batch":
                    val = slices[(m, i, r)].to(dev, non_blocking=True)
                    if specs is not None:
                        val = self._tp_as(val, specs[pos])
                else:
                    pid, oi = node.input_specs[pos]
                    val = outputs[pid][k][oi]
                    if specs is not None:
                        val = self._tp_as(val, specs[pos])
                args.append(val)
            return args

        for tid in self.schedule.order:
            node = self.dag.node(tid)
            self._run_task(node, outputs, pending, losses, stage_args,
                           tracing, debug)
            # GC: free buffers whose last consumer just ran.
            for rid in node.mem_to_release:
                outputs.pop(rid, None)

        for work in self._sends:
            work.wait()
        self._sends = []
        self.global_step += 1
        # ONE host wait for all micro losses.
        total = (torch.stack([x.float() for x in losses]).sum()
                 if losses else torch.zeros((), dtype=torch.float32))
        if self.group_form:
            # Each TP rank of a loss replica holds the same loss.
            total = (total / self.tp).to(self.devices[self.rank])
            dist.all_reduce(total)
        loss = float(total) / (M * dp)
        metrics().counter("pipeline_steps").inc()
        if tracing:
            sp_step.__exit__(None, None, None)
        if debug:
            log.info("[ExecutePlan Duration] step=%d %.3f ms",
                     self.global_step, sp_step.dur_ms)
        return loss

    def _run_task(self, node, outputs, pending, losses, stage_args,
                  tracing: bool, debug: bool) -> None:
        """Issue one task of the order for the replicas this process holds
        (a group-form SEND posts both ends of its transfer)."""
        prog = self.prog
        tid, tt = node.id, node.task_type
        s, m = node.stage, node.micro
        held = self._held[s] if s >= 0 else []
        if tt == TaskType.SEND and self.group_form:
            self._post_transfer(node, outputs, pending)
            return
        if not held:
            return
        sp = (span(node.name, cat=_SPAN_CAT.get(tt, "data"),
                   stage=s, micro=m, task=tid,
                   step=self.global_step).__enter__()
              if tracing else _NULL_SPAN)
        if tt in (TaskType.SPLIT, TaskType.INPUT, TaskType.MERGE):
            outputs[tid] = []
        elif tt == TaskType.COMPUTE and node.name.startswith("fwd"):
            outs = [self._fwd(s, dev, stage_args(s, m, tid, k))
                    for k, (_, dev) in enumerate(held)]
            outputs[tid] = outs
            if s == self._loss_stage:
                out = prog.stages[s].graph_out_map[0]
                losses += [self._tp_local(o[out]) for o in outs]
        elif tt == TaskType.COMPUTE and node.name.startswith("bwd"):
            n_in = len(prog.stages[s].invars)
            res = []
            for k, (_, dev) in enumerate(held):
                args = stage_args(s, m, tid, k)
                cots = [outputs[pid][k][oi] for pos, (pid, oi) in
                        sorted(node.input_specs.items())
                        if pos >= n_in]
                if self._tp_out_specs[s] is not None:
                    ks = [pos - n_in for pos in sorted(node.input_specs)
                          if pos >= n_in]
                    cots = [None if c is None else
                            self._tp_as(c, self._tp_out_specs[s][q])
                            for c, q in zip(cots, ks)]
                res.append(self._bwd(s, dev, args, cots))
            outputs[tid] = res
        elif tt == TaskType.SEND:
            pid, oi = node.input_specs[0]
            outputs[tid] = [(o[oi],) for o in outputs[pid]]
        elif tt == TaskType.RECV:
            if self.group_form:
                outputs[tid] = [(self._finish_transfer(tid, pending),)]
            else:
                pid, oi = node.input_specs[0]
                outputs[tid] = [(_to_device(o[oi], dev),) for o, (_, dev)
                                in zip(outputs[pid], held)]
        elif tt == TaskType.GAINIT:
            outputs[tid] = [(self._gainit(s, dev),) for _, dev in held]
        elif tt == TaskType.GA:
            acc_pid, acc_oi = node.input_specs[0]
            bwd_pid, _ = node.input_specs[1]
            accs = self._ga(s, [a[acc_oi] for a in outputs[acc_pid]],
                            outputs[bwd_pid])
            outputs[tid] = [(a,) for a in accs]
        elif tt == TaskType.APPLY:
            pid, oi = node.input_specs[0]
            accs = [a[oi] for a in outputs[pid]]
            extras = {}
            for pos, (epid, eoi) in node.input_specs.items():
                if pos >= 1:   # pos - 1 = the contributing stage
                    extras[pos - 1] = [e[eoi] for e in outputs[epid]]
            self._apply_stage(s, accs, extras)
            outputs[tid] = []
        else:
            outputs[tid] = []
        if tracing:
            if tt in (TaskType.SEND, TaskType.RECV):
                sp.set(bytes=sum(
                    v.nbytes for o in outputs.get(tid, ())
                    for v in tree_leaves(o)
                    if isinstance(v, torch.Tensor)))
            sp.__exit__(None, None, None)
        if debug:
            log.info("[task] %s stage=%d micro=%d %.3f ms",
                     node.key(), node.stage, node.micro, sp.dur_ms)

    # -- group-form transfers ------------------------------------------
    def _transfer_meta(self, send_node):
        """(consumer stage, recv task, what it carries) of a SEND:
        ``("value", var, producer spec)`` for an activation or a
        cotangent, ``("grads", [slot indices])`` for a stage's gradient
        accumulators handed to a shared param's owner (the slots of the
        params that owner applies)."""
        recv_id = send_node.children[0]
        s, t = self.dag.node(recv_id).stage, send_node.stage
        _, k = send_node.input_specs[0]
        if self.maps.recv_target.get(recv_id) is None:
            idx = [j for j, i in enumerate(self._stage_pidx[t])
                   if self.param_owner.get(i) == s
                   and i in self._stage_pidx[s]]
            return s, recv_id, ("grads", idx)
        if send_node.name.startswith("send_cot"):
            # The cotangent of stage t's input k (its bwd output k).
            var = self.prog.stages[t].invars[k]
            specs = self._tp_in_specs[t]
        else:
            # Stage t's forward output k.
            var = self.prog.stages[t].outvars[k]
            specs = self._tp_out_specs[t]
        return s, recv_id, ("value", var, None if specs is None
                            else specs[k])

    def _post_transfer(self, node, outputs, pending) -> None:
        """A SEND in the global order: the producer's rank posts its isend
        and the consumer's rank its irecv, now, on both ends."""
        import torch.distributed as dist

        s, recv_id, what = self._transfer_meta(node)
        t = node.stage
        src_g, dst_g = self._stage_group[t], self._stage_group[s]
        my_g = self._coord[0]
        if my_g == src_g:
            pid, oi = node.input_specs[0]
            val = outputs[pid][0][oi]
            vals = ([val[j] for j in what[1]] if what[0] == "grads"
                    else [val])
            for v in vals:
                if v is not None:
                    self._sends.append(self._isend(self._tp_local(v),
                                                   self._peer(dst_g)))
            outputs[node.id] = [(val,)]
        elif my_g == dst_g:
            dev = self.devices[self.rank]
            bufs, reqs = [], []
            if what[0] == "grads":
                for j in what[1]:
                    p = self._stage_ppos[t][j]
                    v = self.prog.stages[t].invars[p]
                    spec = (self._tp_in_specs[t][p]
                            if self._tp_in_specs[t] is not None else None)
                    bufs.append((torch.empty(self._local_shape(v, spec),
                                             dtype=var_val(v).dtype,
                                             device=dev), spec))
            else:
                _, var, spec = what
                val = var_val(var)
                if node.name.startswith("send_cot") and not (
                        val.is_floating_point()):
                    bufs.append((None, None))   # an integer's cotangent
                else:
                    bufs.append((torch.empty(self._local_shape(var, spec),
                                             dtype=val.dtype, device=dev),
                                 spec))
            for b, _ in bufs:
                reqs.append(None if b is None
                            else self._irecv(b, self._peer(src_g)))
            pending[recv_id] = (what, t, bufs, reqs)

    def _finish_transfer(self, recv_id: int, pending):
        """A RECV: wait on its posted irecv (on a card, the consumer's
        stream waits, not the host) and bring TP shards to this stage's
        placements."""
        what, t, bufs, reqs = pending.pop(recv_id)
        for req in reqs:
            if req is not None:
                req.wait()
        if what[0] == "grads":
            # In the sender's placements (APPLY brings them to its own).
            return tuple(b for b, _ in bufs)
        b, spec = bufs[0]
        if b is not None and spec is not None:
            kind, ts, ix = self.maps.recv_target[recv_id]
            want = (self._tp_in_specs[ts][ix] if kind == "in"
                    else self._tp_out_specs[ts][ix])
            b = self._tp_as(self._tp_wrap(b, spec), want)
        return b

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _apply_stage(self, s: int, accs: List[Tuple],
                     extras: Dict[int, List[Tuple]]) -> None:
        """Apply the mean gradient of the params OWNED by stage ``s``,
        adding the accumulators of the other stages that use a shared
        param (a tied embedding's last-stage contribution reaches its
        owner here, once): per held replica, then summed over the replicas
        (all-reduce, or reduce-scatter under ZeRO) and divided by the micro
        batches and replicas. The port's optimizers update the params in
        place."""
        owner = self.param_owner
        held = self._held[s]
        grads_k = []
        for k, (acc, (_, dev)) in enumerate(zip(accs, held)):
            grads = {i: g for i, g in zip(self._stage_pidx[s], acc)
                     if owner[i] == s}
            for t in sorted(extras):
                ex = extras[t][k]
                # A transfer carries the slots this stage applies; a
                # co-resident stage's accumulators come whole.
                idx = list(self._stage_pidx[t])
                if len(ex) != len(idx):
                    idx = [i for i in idx if owner.get(i) == s
                           and i in grads]
                for i, g in zip(idx, ex):
                    if owner.get(i) == s and i in grads:
                        g = self._respec(g, self._param_spec(t, i),
                                         self._param_spec(s, i))
                        grads[i] = grads[i] + g.to(dev)
            grads_k.append(grads)
        if not grads_k[0]:
            return
        order = sorted(grads_k[0])
        M = self.prog.num_micro_batches
        # Already reduced per micro batch (a compressed comm dtype): the
        # accumulators hold the replicas' mean.
        scale = M if self._reduce_per_micro else M * self.dp
        if self.zero:
            self._apply_zero(s, order, grads_k, scale)
            return
        if self.dp > 1 and not self._reduce_per_micro:
            for i in order:
                total = self._intra[s].all_reduce_raw(
                    [g[i].contiguous() for g in grads_k])
                for g, x in zip(grads_k, total):
                    g[i] = x
        grads = {i: grads_k[0][i] / scale for i in order}
        params = {i: self.var_store[i] for i in order}
        if self.optimizer is None:
            for i, g in grads.items():
                self.var_store[i] = params[i] - 0.01 * g
            return
        self.opt_states[s] = self.optimizer.apply(params, grads,
                                                  self.opt_states[s])

    def _apply_zero(self, s: int, order: List[int], grads_k, scale) -> None:
        """The ZeRO update of stage ``s``: each replica's shard of the
        summed gradient (reduce-scatter of the padded flat leaves), the
        optimizer on its shard of the params, then the params all-gathered
        back into the held copy."""
        dp, held = self.dp, self._held[s]
        g_sh: Dict[int, List[torch.Tensor]] = {}
        for i in order:
            flats = [zero_pad_flat(g[i], dp) for g in grads_k]
            if self._reduce_per_micro:
                c = flats[0].numel() // dp
                g_sh[i] = [f[r * c:(r + 1) * c]
                           for f, (r, _) in zip(flats, held)]
            else:
                g_sh[i] = self._intra[s].reduce_scatter_raw(flats)
        p_sh: Dict[int, List[torch.Tensor]] = {i: [] for i in order}
        for k, (r, dev) in enumerate(held):
            params = {i: self._zero_shard(self.var_store[i], r, dev)
                      for i in order}
            grads = {i: g_sh[i][k] / scale for i in order}
            if self.optimizer is None:
                for i in order:
                    params[i].sub_(0.01 * grads[i])
            else:
                self.opt_states[s][r] = self.optimizer.apply(
                    params, grads, self.opt_states[s][r])
            for i in order:
                p_sh[i].append(params[i])
        for i in order:
            full = self._intra[s].all_gather_raw(p_sh[i])[0]
            p = self.var_store[i]
            p.copy_(full[:p.numel()].view(p.shape))
