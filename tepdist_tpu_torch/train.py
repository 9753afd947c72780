"""Training entry point: the port of ``tepdist_tpu/train.py``
(``plan_training``, ``explore_parallelism``).

    plan = plan_training(loss_fn, adamw_bf16(1e-4), params, tokens,
                         num_micro_batches=2)
    for _ in range(steps):
        loss = plan.step(tokens)

On one device the JAX planner's exploration picks plain SPMD over a
one-device data mesh with no ZeRO, comm dtype or pipeline, so what remains
is the GA step of ``build_ga_step`` followed by the optimizer apply. The
micro count is passed explicitly (or by NUM_MICRO_BATCHES); without one,
the plan captures the loss-and-grad step on fake tensors (``trace_graph``)
and takes it from the sync-free analysis, as the JAX package's SPMD path
does (``plan.sync_free``, ``plan.topology``). The plan owns
its state and updates it in place (the JAX plan donates its buffers
instead): the tensors passed as ``params`` are the plan's state when they
already lie on the device. ``save`` and ``restore`` write and read the JAX
package's checkpoint format by flat leaf index of ``(params, opt_state)``,
so a plan of either package resumes from the other's checkpoint.

With a ``topology`` (or ``explore=True``, which picks one from the SPMD
candidates of ``parallel/exploration``), the plan is the reference's SPMD
plan: the whole GA step, optimizer apply included, is captured on fake
tensors and planned over the mesh by ``auto_parallel`` (cost ILP or rule
mode, memory save, ZeRO, affinity), then lowered to DTensor placements and
run by an fx interpreter on DTensors over the topology's
``torch.distributed`` device mesh (``_SpmdTrainingPlan``). The caller
starts the process group, one rank per device of the mesh. Without either,
the plan stays the eager one-device plan above, where the reference
sends one device through ``auto_parallel`` too (a deliberate break:
ROADMAP).

With ``num_stages`` > 1 (or NUM_STAGES), the plan is the reference's
pipeline plan (``_PipelineTrainingPlan``): the forward loss is captured at
micro-batch shapes, cut into stages by the stage ILP, decomposed into
per-stage ``fx.GraphModule``s, and run as a verified fwd/bwd/Send/Recv/GA/
Apply task DAG in the scheduler's 1F1B order over a list of devices, with
parameters and optimizer state held per stage. A stage spans ``len(devices)
// num_stages`` devices: intra-stage data replicas times ``intra_stage_tp``
(tensor parallelism, with a process group of one rank a device), and a
ZeRO winner shards each stage's optimizer state over its replicas. Under a
process group every rank holds one device of one stage group
(``runtime/executor.py``). Its checkpoints have the eager plan's flat
leaves, so a run moves between the two; a ZeRO plan writes its optimizer
state as per-shard entries.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from tepdist_tpu_torch.core import remat
from tepdist_tpu_torch.core.device import resolve_device
from tepdist_tpu_torch.core.mesh import MeshTopology
from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.core.tree import (tree_leaves, tree_map,
                                         tree_structure, tree_unflatten)
from tepdist_tpu_torch.graph.fx_graph import trace_graph
from tepdist_tpu_torch.parallel.sync_free import (SyncFreeResult,
                                                  analyze_sync_free,
                                                  build_ga_step)
from tepdist_tpu_torch.runtime.checkpoint import CheckpointUtil

log = logging.getLogger(__name__)


class TrainingPlan:
    """Device-resident (params, opt_state) and the step that updates them."""

    def __init__(self, step_fn: Callable, params, opt_state,
                 device: torch.device, topology: MeshTopology,
                 sync_free: Optional[SyncFreeResult] = None):
        self._step_fn = step_fn
        self._params = params
        self._opt_state = opt_state
        self.device = device
        # The [micro (time), data] topology of the plan, and the analysis
        # that sized the micro count (None when the caller gave it).
        self.topology = topology
        self.sync_free = sync_free
        # One CheckpointUtil per (directory, max_to_keep), so overlapping
        # async saves serialize on its lock.
        self._ckpt_utils = {}

    def step(self, *batch) -> float:
        env = ServiceEnv.get()
        t0 = time.perf_counter()
        batch = tuple(b.to(self.device) for b in batch)
        loss, self._params, self._opt_state = self._step_fn(
            self._params, self._opt_state, *batch)
        loss = float(loss)  # waits for the step
        if env.debug:
            log.info("[ExecutePlan Duration] %.3f ms",
                     (time.perf_counter() - t0) * 1e3)
        return loss

    def variables(self):
        """(params, opt_state): the live state tensors, not copies."""
        return self._params, self._opt_state

    def _device_state(self):
        """Flat state leaves, still on the device (the checkpoint writer
        copies them to the host one variable at a time)."""
        return tree_leaves(self.variables())

    def save(self, directory: str, step: int, max_to_keep: int = 5,
             block: bool = True):
        """Checkpoint the training state. ``block=False`` snapshots
        device->host now and writes on a background thread; returns an
        AsyncSaveHandle (call .result() before shutdown)."""
        key = (directory, max_to_keep)
        if key not in self._ckpt_utils:
            self._ckpt_utils[key] = CheckpointUtil(directory, max_to_keep)
        util = self._ckpt_utils[key]
        variables = {str(i): v for i, v in enumerate(self._device_state())}
        if block:
            util.save(step, variables)
            return None
        return util.save_async(step, variables)

    def restore(self, directory: str, step: int = -1) -> int:
        """Load a checkpoint of this package or the JAX package into the
        plan's state; returns the step restored."""
        data, got = CheckpointUtil(directory).restore(step)
        self._load([data[str(i)] for i in range(len(data))])
        return got

    @torch.no_grad()
    def _load(self, leaves) -> None:
        """Copy host leaves into the live state tensors, in place."""
        live = self._device_state()
        if len(leaves) != len(live):
            raise ValueError(f"checkpoint holds {len(leaves)} leaves, the "
                             f"plan's state {len(live)}")
        for dst, src in zip(live, leaves):
            if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                raise ValueError(
                    f"checkpoint leaf {tuple(src.shape)} {src.dtype} does "
                    f"not fit the plan's {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)


class _PipelineTrainingPlan(TrainingPlan):
    """The pipeline plan (the reference's ``_PipelineTrainingPlan``): a
    ``runtime.executor.PipelineExecutable`` holding the state per stage.
    ``variables()`` assembles the global (params, opt_state), whose flat
    leaves are the eager plan's, so ``save``/``restore`` cross between
    the two runtimes."""

    def __init__(self, exe, params, device: torch.device):
        super().__init__(None, None, None, device, None)
        self._exe = exe
        self.pipeline = exe.prog
        exe.load_variables(params)

    @property
    def executable(self):
        return self._exe

    def step(self, *batch) -> float:
        return self._exe.step(*batch)

    def save(self, directory: str, step: int, max_to_keep: int = 5,
             block: bool = True):
        """Checkpoint the state. A ZeRO plan writes each optimizer-state
        leaf that mirrors a param as its replicas' shards (per-shard
        entries and their index); under a process group every rank takes
        part (the whole leaves are gathered), rank r writes
        ``worker{r}.npz`` with its shards, rank 0 the whole leaves and the
        manifest, and the save is blocking."""
        exe = self._exe
        if not exe.group_form and not exe.zero:
            return super().save(directory, step, max_to_keep, block)
        import torch.distributed as dist

        from tepdist_tpu_torch.runtime.checkpoint import ShardPieces

        if exe.group_form and not block:
            raise ValueError("a pipeline plan over a process group saves "
                             "blocking (block=True)")
        variables = {str(i): v
                     for i, v in enumerate(exe.checkpoint_leaves())}
        util = CheckpointUtil(directory, max_to_keep,
                              own_manifest=exe.rank == 0,
                              shard_addressable=exe.zero)
        if not exe.group_form:
            if block:
                util.save(step, variables)
                return None
            return util.save_async(step, variables)
        if exe.rank != 0:
            mine = {k: v for k, v in variables.items()
                    if isinstance(v, ShardPieces) and v.pieces}
            if mine:
                util.save(step, mine, worker_id=exe.rank)
        # The manifest names the step once every rank's file is in place.
        dist.barrier()
        if exe.rank == 0:
            util.save(step, variables, worker_id=0)
        dist.barrier()
        return None

    def variables(self):
        """(params, opt_state): the live params; the optimizer state
        assembled from the stages' (its leaves are theirs, not copies)."""
        return (self._exe.fetch_variables(), self._exe.fetch_opt_state())

    @torch.no_grad()
    def _load(self, leaves) -> None:
        """Load flat (params, opt_state) leaves: the params onto their
        owner stages (re-initializing the stage states), then the state."""
        live = self._device_state()
        if len(leaves) != len(live):
            raise ValueError(f"checkpoint holds {len(leaves)} leaves, the "
                             f"plan's state {len(live)}")
        for dst, src in zip(live, leaves):
            if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                raise ValueError(
                    f"checkpoint leaf {tuple(src.shape)} {src.dtype} does "
                    f"not fit the plan's {tuple(dst.shape)} {dst.dtype}")
        n = self._exe.n_params
        params = tree_unflatten(self._exe.params_tree,
                                list(leaves[:n]))
        self._exe.load_variables(params)
        self._exe.load_opt_state(list(leaves[n:]))


class _SpmdTrainingPlan(TrainingPlan):
    """The SPMD plan (the reference's ``_SpmdTrainingPlan``): the state is
    a list of DTensors in the plan's input placements, and each step runs
    the lowered GA step on it and rebinds it to the step's state outputs
    (``state_alias = {1 + k: k}``)."""

    def __init__(self, plan, params, opt_state, device: torch.device,
                 sync_free: Optional[SyncFreeResult] = None):
        super().__init__(None, None, None, device, plan.topology, sync_free)
        self.parallel_plan = plan
        self._exe = plan.executable(device.type)
        self._state_tree = tree_structure((params, opt_state))
        flat_state = tree_leaves((params, opt_state))
        self._n_state = len(flat_state)
        self._state = [self._exe.distribute_input(i, v)
                       for i, v in enumerate(flat_state)]
        self._donate = bool(plan.state_donation())

    def _inputs(self, batch) -> list:
        return list(self._state) + [b.to(self.device)
                                    for b in tree_leaves(batch)]

    def step(self, *batch) -> float:
        env = ServiceEnv.get()
        t0 = time.perf_counter()
        inputs = self._inputs(batch)
        if self._donate:
            # The input list holds the only reference to the old state,
            # so each leaf is freed after its last use in the step.
            self._state = None
        outs = self._exe.run(inputs)
        self._state = list(outs[1:1 + self._n_state])
        loss = float(outs[0].full_tensor())  # waits for the step
        if env.debug:
            log.info("[ExecutePlan Duration] %.3f ms",
                     (time.perf_counter() - t0) * 1e3)
        return loss

    def save(self, directory: str, step: int, max_to_keep: int = 5,
             block: bool = True):
        """Checkpoint the state whole: every rank gathers each DTensor
        leaf (a collective), rank 0 alone writes it."""
        import torch.distributed as dist

        if dist.get_rank() == 0:
            return super().save(directory, step, max_to_keep, block)
        for leaf in self._state:
            leaf.full_tensor()
        return None

    def involuntary_remats(self, *batch):
        """One diagnostic step on the current state and ``batch`` (nothing
        is updated): the graph nodes at which DTensor all-gathered an
        operand the plan keeps split (``parallel/lowering_check``)."""
        return self.parallel_plan.lowering_diagnostics(
            self._inputs(batch), device_type=self.device.type)

    def variables(self):
        """(params, opt_state) as whole tensors on the device."""
        return tree_unflatten(self._state_tree,
                              [v.full_tensor() for v in self._state])

    def _device_state(self):
        # The DTensors themselves: the checkpoint writer gathers one at a
        # time.
        return list(self._state)

    def _load(self, leaves) -> None:
        if len(leaves) != self._n_state:
            raise ValueError(f"checkpoint holds {len(leaves)} leaves, the "
                             f"plan's state {self._n_state}")
        state = []
        for i, (src, dst) in enumerate(zip(leaves, self._state)):
            if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                raise ValueError(
                    f"checkpoint leaf {tuple(src.shape)} {src.dtype} does "
                    f"not fit the plan's {tuple(dst.shape)} {dst.dtype}")
            state.append(self._exe.distribute_input(i, src.to(self.device)))
        self._state = state


_REMAT_POLICIES = {**remat.POLICIES, "true": None, "1": None}


def _remat(loss_fn: Callable) -> Callable:
    """REMAT_POLICY knob: "full" (or "true"/"1") recomputes the whole loss
    in backward; "dots" keeps every matmul output and "dots_no_batch"
    those without a batch dimension. Another value is ignored with a
    warning, as in the JAX package."""
    policy = ServiceEnv.get().remat_policy
    if not policy or policy == "none":
        return loss_fn
    if policy not in _REMAT_POLICIES:
        log.warning("unknown REMAT_POLICY %r ignored", policy)
        return loss_fn
    return remat.remat(loss_fn, _REMAT_POLICIES[policy])


def value_and_grad(loss_fn: Callable) -> Callable:
    """``(params, *batch) -> (loss, grads)`` of ``loss_fn``: the JAX
    package's ``jax.value_and_grad(loss_fn)``, on detached leaves."""
    def grad_fn(p, *b):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(p, leaves), *b)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(p, list(grads))
    return grad_fn


def explore_parallelism(
    loss_fn: Callable,
    params,
    *example_batch,
    n_devices: int,
    num_micro_batches: int = 4,
    entry_point: str = "explore_parallelism",
) -> Dict[str, Any]:
    """Exploration over the SPMD candidate space — every mesh
    factorization of ``n_devices`` with its ``@bf16``, ``@int8`` and
    ``@zero`` modifiers, priced by the Evaluator on the loss's captured
    value-and-grad graph, and the sequence-parallel data x seq meshes
    priced with the ring/Ulysses attention cost
    (parallel/exploration.py; reference: RunExplorationlMode,
    auto_parallel.cc:236), and the pipeline stage cuts (S x M x intra-stage
    TP, with their ZeRO and comm-dtype modifiers). Needs no device."""
    from tepdist_tpu_torch.parallel.exploration import explore

    return explore(loss_fn, params, *example_batch, n_devices=n_devices,
                   num_micro_batches=num_micro_batches,
                   entry_point=entry_point)


def plan_training(
    loss_fn: Callable,
    optimizer,
    params,
    *example_batch,
    num_micro_batches: Optional[int] = None,
    device="cuda",
    topology: Optional[MeshTopology] = None,
    explore: bool = False,
    mode: Optional[str] = None,
    annotations: Optional[Dict[int, Dict[str, Any]]] = None,
    var_mem_limit: Optional[int] = None,
    devices: Optional[Sequence] = None,
    num_stages: Optional[int] = None,
    intra_stage_tp: Optional[int] = None,
    placement: str = "blocked",
    interleave_groups: Optional[int] = None,
) -> TrainingPlan:
    """Plan a training loop for ``loss_fn(params, *batch)``.

    ``optimizer`` has ``init(params)`` and ``apply(params, grads, state)``
    (``optim.adamw_bf16``). ``params`` is a tree of tensors; it is moved to
    ``device`` (default the card, which must exist). As in the JAX
    package, every batch arg splits into micro batches along dim 0. With no
    micro count (argument or NUM_MICRO_BATCHES), the step is captured on
    fake tensors made from ``params`` and the example batch, and the
    sync-free analysis sizes it from the peak-activation estimate against
    the chip's HBM (``parallel/performance_utils.chip_spec``).

    SPMD plans: ``topology`` is the mesh to plan over (the process group
    must span its devices, this rank's on ``device``); ``explore=True``
    picks the topology, comm dtype and ZeRO from the SPMD candidates for
    ``len(devices)`` devices (default: the process group's size). ``mode``
    is "cost" (default) or "rule" (OPT_LEVEL=0 or RULE_MODE);
    ``annotations`` pins strategies as ``{flat invar index: {axis:
    DimStrategy}}`` over the captured step's inputs (params, then the
    optimizer state, then the batch); ``var_mem_limit`` (or VAR_MEM_LIMIT)
    caps per-device variable bytes. A ``seq`` axis in the topology (given
    or explored) rewrites the loss's attention into the sequence op, ring
    or Ulysses as priced (``attention_motif.seq_rewritten_loss``), before
    the REMAT_POLICY wrap and the gradient.

    Pipeline plans: ``num_stages`` > 1 (or NUM_STAGES when the argument is
    absent) cuts the forward loss into that many stages with
    ``num_micro_batches`` (default NUM_MICRO_BATCHES, else 2) micro
    batches, run by ``runtime.executor.PipelineExecutable`` on
    ``devices`` (by default ``[device] * num_stages``, one a stage; a
    device may repeat; under a process group, one a rank). A stage spans
    ``len(devices) // num_stages`` devices: ``intra_stage_tp`` (or
    INTRA_STAGE_TP, or a topology's ``model`` axis) of tensor parallelism
    (needing a process group of one rank a device) times intra-stage data
    replicas; ``var_mem_limit`` caps each device's stage variables in the
    TP planner. ``placement`` is "blocked" or "interleaved" (with
    ``interleave_groups``). ``explore=True`` may pick a pipeline winner
    (stages, micro batches, TP, placement, ZeRO, comm dtype)."""
    dev = resolve_device(device)
    env = ServiceEnv.get()
    if mode is None and env.opt_level == 0:
        mode = "rule"
    explored_winner = None
    comm_dtype = ""
    zero = False
    if explore and topology is None and num_stages is None:
        if devices is not None:
            n_devices = len(devices)
        else:
            import torch.distributed as dist
            n_devices = dist.get_world_size() if dist.is_initialized() else 1
        best = explore_parallelism(
            loss_fn, params, *example_batch, n_devices=n_devices,
            num_micro_batches=num_micro_batches or 4,
            entry_point="plan_training")
        explored_winner = best
        import torch.distributed as dist
        if dist.is_initialized() and dist.get_world_size() > 1:
            # Every rank runs rank 0's winner (the search has time limits).
            keys = ("kind", "comm_dtype", "zero", "num_stages",
                    "num_micro_batches", "intra_tp", "placement",
                    "interleave_groups")
            box = [({k: best[k] for k in keys if k in best},
                    best["topology"].device_axes()
                    if "topology" in best else None)]
            dist.broadcast_object_list(box, src=0)
            fields, axes = box[0]
            for k in keys:
                best.pop(k, None)
            best.update(fields)
            best.pop("topology", None)
            if axes is not None:
                best["topology"] = MeshTopology(axes)
        if best["kind"] == "pipeline":
            num_stages = best["num_stages"]
            num_micro_batches = best["num_micro_batches"]
            if intra_stage_tp is None:
                intra_stage_tp = best.get("intra_tp", 1)
            placement = best.get("placement", placement)
            interleave_groups = best.get("interleave_groups",
                                         interleave_groups)
        else:
            topology = best["topology"]
        # The winner's modifiers: compressed gradient contributions, and
        # the optimizer state split over the data axis (ZeRO).
        comm_dtype = best.get("comm_dtype", "")
        zero = best.get("zero", False)
        if comm_dtype:
            log.info("exploration winner compresses gradient collectives "
                     "to %s", comm_dtype)
        if zero:
            log.info("exploration winner shards optimizer state over the "
                     "data axis (ZeRO)")
    if num_stages is None:
        num_stages = env.num_stages if env.num_stages > 0 else 1
    if num_stages > 1:
        if intra_stage_tp is None and topology is not None:
            intra_stage_tp = dict(topology.device_axes()).get("model")
        return _plan_pipeline(loss_fn, optimizer, params, example_batch,
                              dev, num_stages, num_micro_batches, devices,
                              intra_stage_tp, placement, interleave_groups,
                              comm_dtype, zero, var_mem_limit,
                              explored_winner)
    if num_micro_batches is None and env.num_micro_batches > 0:
        num_micro_batches = env.num_micro_batches
    if num_micro_batches is None and not example_batch:
        raise ValueError("without num_micro_batches (or NUM_MICRO_BATCHES) "
                         "the sync-free analysis needs an example batch")
    params = tree_map(lambda p: p.to(dev), params)
    opt_state = optimizer.init(params)
    seq_size = (dict(topology.device_axes()).get("seq", 1)
                if topology is not None else 1)
    if seq_size > 1:
        # Sequence axis: rewrite the attention motifs into the sequence
        # op (ring or Ulysses, as priced) BEFORE differentiation, so the
        # gradient runs the reverse ring and the sequence dim stays split
        # both ways (parallel/attention_motif.py). Before the REMAT wrap:
        # the rewrite captures the loss, and the wrap must enclose it.
        from tepdist_tpu_torch.parallel.attention_motif import (
            seq_rewritten_loss)

        loss_fn, impl = seq_rewritten_loss(loss_fn, seq_size, params,
                                           *example_batch)
        log.info("seq axis -> %s attention", impl)
    grad_fn = value_and_grad(_remat(loss_fn))

    res = None
    if num_micro_batches is None:
        graph, _, _ = trace_graph(grad_fn, params, *example_batch)
        n_param_leaves = len(tree_leaves(params))
        batch_leaves = tree_leaves(example_batch)
        res = analyze_sync_free(
            graph, batch_size=batch_leaves[0].shape[0],
            candidate_args=list(range(n_param_leaves,
                                      n_param_leaves + len(batch_leaves))))
        num_micro_batches = res.num_micro_batches
        log.info("sync-free analysis: %d micro batches "
                 "(%.0f%% sync-free flops)", num_micro_batches,
                 100 * res.sync_free_fraction)

    if seq_size > 1 and num_micro_batches > 1:
        # The step calls the rewritten loss on micro batches: capture it
        # at their shape now, before the step itself is captured.
        loss_fn.prepare(params, *(b.chunk(num_micro_batches)[0]
                                  for b in example_batch))

    def apply_fn(p, s, g):
        return p, optimizer.apply(p, g, s)

    step_fn = build_ga_step(grad_fn, apply_fn, num_micro_batches,
                            batch_argnums=tuple(
                                range(1, 1 + max(1, len(example_batch)))),
                            comm_dtype=comm_dtype)
    if topology is not None:
        return _plan_spmd(step_fn, params, opt_state, example_batch, dev,
                          topology, res, mode, annotations, var_mem_limit,
                          zero, explored_winner)
    axes = [("data", 1)]
    if num_micro_batches > 1:
        topology = MeshTopology([("micro", num_micro_batches)] + axes,
                                share_dev_flags=[True, False])
    else:
        topology = MeshTopology(axes)
    return TrainingPlan(step_fn, params, opt_state, dev, topology, res)


def _plan_pipeline(loss_fn, optimizer, params, example_batch, dev,
                   num_stages, num_micro_batches, devices, intra_stage_tp,
                   placement, interleave_groups, comm_dtype, zero,
                   var_mem_limit, explored_winner) -> TrainingPlan:
    """The pipeline path of ``plan_training`` (the reference's,
    ``tepdist_tpu/train.py:302-328``): the REMAT_POLICY wrapper first,
    then ``plan_pipeline`` on the loss (not on a GA step) at a replica's
    rows, then the task-graph executable over the stage groups."""
    import torch.distributed as dist

    from tepdist_tpu_torch.parallel.pipeline import plan_pipeline
    from tepdist_tpu_torch.runtime.executor import (PipelineExecutable,
                                                    stage_replicas)

    env = ServiceEnv.get()
    M = num_micro_batches or (
        env.num_micro_batches if env.num_micro_batches > 0 else 2)
    params = tree_map(lambda p: p.to(dev), params)
    example_batch = tree_map(lambda b: b.to(dev), example_batch)
    tp = intra_stage_tp
    if tp is None and env.intra_stage_tp > 0:
        tp = env.intra_stage_tp
    tp = tp or 1
    if devices is None:
        if dist.is_initialized() and dist.get_world_size() > 1:
            devices = [dev] * dist.get_world_size()
        else:
            groups = (interleave_groups if placement == "interleaved"
                      and interleave_groups else num_stages)
            devices = [dev] * groups
    devices = list(devices)
    # Capture once, at a replica's rows.
    prog = plan_pipeline(_remat(loss_fn), num_stages, M, params,
                         *example_batch, replicas=stage_replicas(
                             len(devices), num_stages, tp, placement,
                             interleave_groups))
    prog.comm_dtype = comm_dtype
    prog.zero = zero
    exe = PipelineExecutable(
        prog, devices=devices, optimizer=optimizer, intra_stage_tp=tp,
        stage_var_mem_limit=var_mem_limit, placement=placement,
        interleave_groups=interleave_groups)
    plan = _PipelineTrainingPlan(exe, params, dev)
    if explored_winner is not None and "report" in explored_winner:
        plan.exploration_report = explored_winner["report"]
    return plan


def _plan_spmd(step_fn, params, opt_state, example_batch, dev, topology,
               res, mode, annotations, var_mem_limit, zero,
               explored_winner) -> TrainingPlan:
    """The SPMD path of ``plan_training``: ``auto_parallel`` of the whole
    GA step over ``topology``, lowered to DTensor (the reference's SPMD
    path, ``tepdist_tpu/train.py:367-412``)."""
    from tepdist_tpu_torch.parallel.auto_parallel import auto_parallel

    env = ServiceEnv.get()
    n_param = len(tree_leaves(params))
    n_state = len(tree_leaves((params, opt_state)))
    state_alias = {1 + k: k for k in range(n_state)}
    # ZeRO winners: the optimizer-state leaves are flat invars
    # n_param..n_state-1 of step_fn(params, opt_state, *batch); the
    # planner force-splits them over the data axis so DTensor runs the
    # reduce-scatter / sharded-apply / all-gather update.
    zero_invars = list(range(n_param, n_state)) if zero else None
    example_batch = tree_map(lambda b: b.to(dev), example_batch)
    plan = auto_parallel(
        step_fn, topology, params, opt_state, *example_batch,
        annotations=annotations, mode=mode, state_alias=state_alias,
        var_mem_limit=var_mem_limit, zero_invars=zero_invars)
    tplan = _SpmdTrainingPlan(plan, params, opt_state, dev, res)
    if explored_winner is not None and env.lowering_postcheck:
        from tepdist_tpu_torch.telemetry import metrics, observatory
        try:
            remats = tplan.involuntary_remats(*example_batch)
        except Exception as e:  # noqa: BLE001 — diagnostics only
            log.warning("lowering post-check failed: %r", e)
        else:
            tplan.lowering_remats = remats
            observatory.fold_remats(explored_winner.get("report"), remats)
            if remats:
                metrics().counter("involuntary_remat").inc(len(remats))
                log.warning(
                    "explore winner (axes=%s): %d op(s) all-gathered a "
                    "split operand (%s) — the chosen sharding forces "
                    "resharding the cost model did not price; consider a "
                    "different topology", list(topology.device_axes()),
                    len(remats), ", ".join(remats[:3]))
    if explored_winner is not None and "report" in explored_winner:
        tplan.exploration_report = explored_winner["report"]
    return tplan
