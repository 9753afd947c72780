"""AutoParallel: the driver pass tying tracer → planner → SPMD transform.

Reference parity: ``AutoParallel::Run`` (reference:
service/parallel/auto_parallel.cc:395) with its three modes:
  * rule mode  (``RULE_MODE``)  → FastSpmdStrategy annotation sweep
  * config mode                 → fixed mesh from the caller, cost planner
  * exploration mode            → enumerate mesh-shape proposals
    (``GenerateSplitProposals``, auto_parallel.cc:132), plan each, keep the
    evaluator-minimal one.

Output is a ``ParallelPlan``: the sharded training step plus the full
annotation record (the analogue of DistSpec-decorated HLO + DefContext
tree, which later stages — pipeline decomposition, runtime — consume).

The port of ``tepdist_tpu/parallel/auto_parallel.py``. The step is
captured on fake tensors (``trace_graph(..., functional=True)``: the
port's optimizers update in place, so the capture turns each state update
into an output), planned axis by axis as in the reference, and lowered to
DTensor placements (``parallel/spmd_transform.py``). The executable is an
fx interpreter over DTensors on a ``torch.distributed`` device mesh, where
the reference jits a jaxpr interpreter under GSPMD.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.fx as fx

from tepdist_tpu_torch.core.dist_spec import DimStrategy
from tepdist_tpu_torch.core.mesh import MeshTopology
from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.core.tree import tree_leaves, tree_unflatten
from tepdist_tpu_torch.graph.fx_graph import (FxGraph, trace_graph,
                                              var_bytes, var_shape)
from tepdist_tpu_torch.parallel.cost_spmd_strategy import (CostSpmdStrategy,
                                                           GraphStrategy)
from tepdist_tpu_torch.parallel.fast_spmd_strategy import FastSpmdStrategy
from tepdist_tpu_torch.parallel.spmd_transform import (ShardingPlan,
                                                       SpmdTransform)

Var = fx.Node
log = logging.getLogger(__name__)


@dataclasses.dataclass
class ParallelPlan:
    """A planned + lowered training step."""

    graph: FxGraph
    topology: MeshTopology
    strategies: List[GraphStrategy]
    sharding_plan: ShardingPlan
    in_tree: Any
    out_tree: Any
    mode: str
    # The exploration winner's comm-dtype modifier (""/"float32" =
    # fidelity; "bfloat16"/"int8" = compressed gradient collectives).
    # Consumed by train.plan_training when it rebuilds the GA step; the
    # plan's own executable is dtype-agnostic.
    comm_dtype: str = ""
    # ZeRO weight-update sharding (arXiv:2004.13336): True when the
    # optimizer-state invars were force-split over the data axis
    # (apply_zero_sharding), so DTensor reduce-scatters the gradient into
    # the sharded apply and all-gathers the updated params. Consumed by
    # train.plan_training.
    zero: bool = False

    _exe: Any = None
    _mesh: Any = None

    def mesh(self, device_type: str = "cuda"):
        """The topology's ``torch.distributed`` device mesh (the process
        group must span ``topology.num_devices`` ranks)."""
        if self._mesh is None:
            self._mesh = self.topology.to_device_mesh(device_type)
        return self._mesh

    def executable(self, device_type: str = "cuda"):
        """The flat-args step over DTensors (order = graph invars):
        ``exe(*flat)``, or ``exe.run(flat_list)``, which empties the list
        so inputs the caller no longer holds are freed after their last
        use (the reference's donated state)."""
        if self._exe is None:
            xform = SpmdTransform(self.graph, self.topology)
            self._exe = xform.executable(self.sharding_plan,
                                         self.mesh(device_type))
        return self._exe

    def lowering_diagnostics(self, args: Sequence[Any],
                             device_type: str = "cuda") -> List[str]:
        """Run the lowered step once on ``args`` (flat, graph order;
        nothing is updated: the graph is functional) and return the graph
        nodes at which DTensor all-gathered an operand the plan keeps
        split (parallel/lowering_check.py). [] == no resharding the plan
        did not place."""
        from tepdist_tpu_torch.parallel.lowering_check import (
            involuntary_remats)

        return involuntary_remats(self.executable(device_type), list(args))

    def state_donation(self) -> Tuple[int, ...]:
        """Invar indices the caller may give up when it threads the aliased
        state (outputs replace these inputs): the plan's step drops its
        references to them, so each is freed after its last use and the
        state is not double-buffered for the whole step. Honors
        DISABLE_BUFFER_ALIAS."""
        if ServiceEnv.get().disable_buffer_alias:
            return ()
        alias = self.sharding_plan.state_alias or {}
        return tuple(sorted({ii for ii in alias.values() if ii >= 0}))

    def step(self, *args, **kwargs):
        """Tree-level convenience wrapper around the flat executable."""
        flat = tree_leaves((args, kwargs))
        device_type = next((a.device.type for a in flat
                            if isinstance(a, torch.Tensor)), "cuda")
        outs = self.executable(device_type).run(list(flat))
        return tree_unflatten(self.out_tree, list(outs))

    def input_shardings(self) -> List[Tuple]:
        """The DTensor placements of each flat input, over ``mesh()``."""
        return list(self.sharding_plan.in_specs)


def _resolve_fixed(
    graph: FxGraph,
    annotations: Optional[Dict[int, Dict[str, DimStrategy]]],
) -> Dict[str, Dict[Var, DimStrategy]]:
    """annotations: flat-arg-index -> {axis: DimStrategy} → per-axis maps."""
    per_axis: Dict[str, Dict[Var, DimStrategy]] = {}
    for idx, spec in (annotations or {}).items():
        v = graph.invars[idx]
        for axis, s in spec.items():
            per_axis.setdefault(axis, {})[v] = s
    return per_axis


def plan_axes(
    graph: FxGraph,
    topology: MeshTopology,
    annotations: Optional[Dict[int, Dict[str, DimStrategy]]] = None,
    mode: str = "cost",
    mem_limit_bytes: Optional[float] = None,
) -> List[GraphStrategy]:
    """Run the per-axis planner sequence (reference: per-mesh-level
    CostSpmdStrategy loop in RunExplorationlMode step 2).

    ``mem_limit_bytes``: per-device storage budget enforced INSIDE the
    cost ILP (reference SplitPlanByMemCost integrated into the search) —
    variable sharding (ZeRO/TP) emerges where replication would not fit,
    with split dims chosen by the gather costs already in the objective.
    Applies to the cost mode's whole-graph ILP; the subgraph-DP and greedy
    paths fall back to the post-hoc ``apply_mem_save``."""
    fixed_per_axis = _resolve_fixed(graph, annotations)
    strategies: List[GraphStrategy] = []
    forbidden: Dict[Var, set] = {}
    prior_splits: Dict[Var, int] = {}
    # Annotation pins RESERVE their tensor dim against every OTHER axis up
    # front: an earlier-planned axis must not take a dim a later axis's
    # annotation will pin (e.g. the data axis ZeRO-splitting expert-weight
    # dim 0 that the expert annotation owns — the combined factor would
    # overrun the dim).
    planned_axes = {n for n, sz in topology.device_axes() if sz > 1}
    pinned: Dict[Var, Dict[str, int]] = {}
    for ax_name, pins in fixed_per_axis.items():
        if ax_name not in planned_axes:
            continue    # a size-1 axis never materialises its pin
        for v, s in pins.items():
            if s.is_split():
                pinned.setdefault(v, {})[ax_name] = s.partition_dim
    for name, size in topology.device_axes():
        if size <= 1:
            continue
        fixed = fixed_per_axis.get(name, {})
        axis_forbidden = {v: set(d) for v, d in forbidden.items()}
        for v, by_axis in pinned.items():
            reserved = {d for ax, d in by_axis.items() if ax != name}
            if reserved:
                axis_forbidden[v] = axis_forbidden.get(v, set()) | reserved
        if name == "seq":
            # The sequence axis is owned by the ring/Ulysses attention
            # lowering (parallel/attention_motif.py). A graph with closed
            # motifs (a forward graph) gets a seq strategy that prices and
            # propagates the axis; a graph rewritten before capture holds
            # the sequence ops, the axis propagates from them, and the
            # SPMD transform lowers them (auto_parallel rewrites a graph
            # with closed motifs before it plans).
            from tepdist_tpu_torch.parallel.attention_motif import (
                build_anchored_seq_strategy, build_seq_strategy,
                detect_motifs, seq_op_nodes)
            motifs = detect_motifs(graph)
            if motifs:
                gs = build_seq_strategy(graph, size, motifs)
            elif seq_op_nodes(graph):
                gs = build_anchored_seq_strategy(graph, size)
            else:
                raise ValueError(
                    "topology requests a 'seq' axis but the graph has no "
                    "rewritable attention motif (grad graphs hide the "
                    "motif — plan via plan_training, which rewrites "
                    "attention BEFORE differentiation)")
        elif mode == "rule":
            gs = FastSpmdStrategy(graph, name, size, fixed).run()
        else:
            gs = CostSpmdStrategy(
                graph, name, size, fixed=fixed,
                forbidden_dims=axis_forbidden,
                mem_limit_bytes=mem_limit_bytes,
                prior_var_splits=prior_splits,
            ).run()
        strategies.append(gs)
        # Later axes may not re-split dims this axis already split.
        for v, s in gs.var_strategies.items():
            if s.is_split():
                forbidden.setdefault(v, set()).add(s.partition_dim)
                prior_splits[v] = prior_splits.get(v, 1) * s.num_splits
    return strategies


def apply_mem_save(
    graph: FxGraph,
    strategies: List[GraphStrategy],
    topology: MeshTopology,
    var_mem_limit: int,
    state_invars: Optional[Sequence[int]] = None,
) -> List[int]:
    """ZeRO-style variable splitting for memory (reference:
    ``SplitPlanByMemCost``/``MemSavePlan``, cost_spmd_strategy.h:900-911 +
    the ``VAR_MEM_LIMIT`` env): while per-device variable bytes exceed the
    limit, force-shard the largest still-replicated state variable's storage
    along the biggest mesh axis. DTensor inserts the gathers where compute
    needs the full value. Returns the invar indices that were split.

    The split DIM is chosen by gather cost, not size (reference integrates
    mem-save into the cost search — SplitPlanByMemCost's per-dim cost
    terms): for each divisible dim, every consumer equation is checked for
    whether a storage split on that dim flows through consistently with the
    planner's already-chosen strategies (StrategyUtil.forward_infer seeded
    with the trial split + the plan's strategies for the other operands).
    Consumers the split flows through cost nothing; every other consumer
    costs the all-gather DTensor must insert. Ties break to the largest dim."""
    if not strategies:
        return []
    # Shard over the largest device axis (usually 'data' — ZeRO semantics).
    gs = max(strategies, key=lambda g: g.num_splits)
    n = gs.num_splits
    candidates = (list(state_invars) if state_invars is not None
                  else range(len(graph.invars)))

    def per_device_bytes() -> float:
        total = 0.0
        for i in candidates:
            v = graph.invars[i]
            b = var_bytes(v)
            for g in strategies:
                s = g.var_strategies.get(v)
                if s is not None and s.is_split():
                    b /= s.num_splits
            total += b
        return total

    split: List[int] = []
    order = sorted(
        candidates,
        key=lambda i: -var_bytes(graph.invars[i]))
    for i in order:
        if per_device_bytes() <= var_mem_limit:
            break
        v = graph.invars[i]
        cur = gs.var_strategies.get(v)
        if cur is not None and cur.is_split():
            continue
        shape = var_shape(v)
        # Dims another axis already splits are off-limits (one mesh axis
        # per tensor dim).
        taken = {g.var_strategies[v].partition_dim for g in strategies
                 if g is not gs and (s := g.var_strategies.get(v)) is not None
                 and s.is_split()}
        best = None
        for d in range(len(shape)):
            if d in taken or shape[d] % n or shape[d] < n:
                continue
            c = _mem_save_dim_cost(graph, gs, v, d, n)
            key = (c, -shape[d])
            if best is None or key < best[0]:
                best = (key, d)
        if best is not None:
            gs.var_strategies[v] = DimStrategy.split_on(best[1], n)
            split.append(i)
    return split


def _mem_save_dim_cost(graph: FxGraph, gs: GraphStrategy, v: Var,
                       d: int, n: int) -> float:
    """Gather traffic a storage split of ``v`` on dim ``d`` would cause,
    given the consumer demands the planner already fixed (the dim choice
    must not be cost-blind)."""
    from tepdist_tpu_torch.parallel.performance_utils import PerfUtils, chip_spec
    from tepdist_tpu_torch.parallel.strategy_utils import StrategyUtil

    spec = chip_spec()
    gather = PerfUtils.all_gather_cost(var_bytes(v), n, spec)
    trial = DimStrategy.split_on(d, n)
    total = 0.0
    for node in graph.consumers.get(v, []):
        known = {}
        for idx, a in enumerate(node.invars):
            if a is v:
                known[idx] = trial
            elif isinstance(a, Var):
                s = gs.var_strategies.get(a)
                if s is not None and not s.is_glue():
                    known[idx] = s
        res = StrategyUtil.forward_infer(node, known, n)
        flows = res is not None
        if flows:
            for ov, s_out in zip(node.outvars, res.out_strategies):
                chosen = gs.var_strategies.get(ov)
                if (chosen is not None and s_out is not None
                        and chosen != s_out):
                    flows = False
                    break
        if not flows:
            total += gather
    return total


def apply_zero_sharding(
    graph: FxGraph,
    strategies: List[GraphStrategy],
    topology: MeshTopology,
    zero_invars: Sequence[int],
    axis: str = "data",
) -> List[int]:
    """ZeRO-1 realization for the single-program SPMD path
    (arXiv:2004.13336): force-split the OPTIMIZER-STATE invars over the
    data axis in their ORIGINAL shapes. With ``state_alias`` forcing
    out := in specs, DTensor then runs the apply as the ZeRO update —
    the gradient psum's output is consumed sliced (reduce-scatter), the
    elementwise optimizer update runs on the local shard only, and the
    updated params (whose storage stays replicated) all-gather.

    Original shapes — NOT a (dp, chunk) re-layout — so the shard extents
    are natural ``Shard(d)`` slices, and ``restore_sharded`` can land a
    checkpoint on ANY DP width (a padded flat layout would make the global
    length dp-dependent and break cross-width restore).

    Returns the invar indices actually split (leaves with no dim
    divisible by dp — scalars like Adam's step count — stay replicated;
    they are O(bytes) irrelevant)."""
    axis_names = [nm for nm, sz in topology.device_axes() if sz > 1]
    if axis not in axis_names:
        return []
    gs = strategies[axis_names.index(axis)]
    n = gs.num_splits
    split: List[int] = []
    for i in zero_invars:
        v = graph.invars[i]
        cur = gs.var_strategies.get(v)
        if cur is not None and cur.is_split():
            split.append(i)
            continue   # planner/mem-save already sharded it — same effect
        shape = var_shape(v)
        taken = {s.partition_dim for g in strategies if g is not gs
                 if (s := g.var_strategies.get(v)) is not None
                 and s.is_split()}
        best = None
        for d in range(len(shape)):
            if d in taken or shape[d] % n or shape[d] < n:
                continue
            c = _mem_save_dim_cost(graph, gs, v, d, n)
            key = (c, -shape[d])
            if best is None or key < best[0]:
                best = (key, d)
        if best is not None:
            gs.var_strategies[v] = DimStrategy.split_on(best[1], n)
            split.append(i)
    return split


def align_state_storage(
    graph: FxGraph,
    strategies: List[GraphStrategy],
    state_alias: Dict[int, int],
) -> int:
    """Align variable STORAGE shardings with the strategy their updated
    value is naturally produced in.

    ``state_alias`` forces out spec := in spec for training-state threading
    (SpmdTransform). When the planner leaves a variable replicated but its
    update is computed sharded, that forcing inserts an all-gather of the
    updated parameters EVERY step. Adopting the produced sharding as the
    storage sharding removes the gather and shards the optimizer state
    (ZeRO-flavored — the reference's mem-save direction, here driven by
    consistency rather than a memory limit). Returns #vars realigned."""
    changed = 0
    for gs in strategies:
        for oi, ii in state_alias.items():
            if oi >= len(gs.out_strategies) or ii < 0:
                continue
            out_s = gs.out_strategies[oi]
            a = graph.outvars[oi]
            if out_s is None or not out_s.is_split():
                continue
            v = graph.invars[ii]
            cur = gs.var_strategies.get(v)
            if cur is not None and cur.is_split():
                continue  # planner chose a storage split already
            shape = var_shape(v)
            # Dims another axis already splits are off-limits (one mesh
            # axis per tensor dim — adopting dim 0 here while the expert
            # axis pins dim 0 would overrun the dim with the combined
            # factor).
            taken = {s.partition_dim for g in strategies if g is not gs
                     if (s := g.var_strategies.get(v)) is not None
                     and s.is_split()}
            if (out_s.partition_dim < len(shape)
                    and out_s.partition_dim not in taken
                    and shape[out_s.partition_dim] % out_s.num_splits == 0):
                gs.var_strategies[v] = out_s
                changed += 1
    return changed


def plan_on_rank0(graph: FxGraph, plan: Callable[[], Tuple]) -> Tuple:
    """``plan()`` -> (strategies, extra) on rank 0 of an initialized
    process group, sent to every other rank: the search has time limits,
    so two ranks planning alone may disagree, and ranks that run
    different placements of one program compute wrong values or hang in
    a collective. Without a group (or on one rank, or nested in a
    decision rank 0 makes alone: ``pipeline.on_rank0``), ``plan()``
    itself."""
    import torch.distributed as dist

    from tepdist_tpu_torch.parallel import pipeline

    if (not dist.is_initialized() or dist.get_world_size() == 1
            or pipeline.deciding_alone()):
        return plan()
    box: List[Any] = [None]
    if dist.get_rank() == 0:
        strategies, extra = pipeline.decide_alone(plan)
        box = [([_export_strategy(gs) for gs in strategies], extra)]
    dist.broadcast_object_list(box, src=0)
    if dist.get_rank() == 0:
        return strategies, extra
    exported, extra = box[0]
    by_name = {v.name: v for v in list(graph.invars) + list(graph.constvars)}
    by_name.update({ov.name: ov for node in graph.nodes
                    for ov in node.outvars if ov is not None})
    return [_import_strategy(e, by_name) for e in exported], extra


def _export_strategy(gs: GraphStrategy) -> Dict[str, Any]:
    d = dict(vars(gs))
    d["var_strategies"] = {v.name: s for v, s in gs.var_strategies.items()}
    d["motifs"] = None
    return d


def _import_strategy(d: Dict[str, Any], by_name) -> GraphStrategy:
    d = dict(d)
    d["var_strategies"] = {by_name[n]: s
                           for n, s in d["var_strategies"].items()}
    return GraphStrategy(**d)


def _rewrite_seq_motifs(graph: FxGraph, seq_size: int,
                        flat_args: List[Any]) -> FxGraph:
    """``graph`` with its closed attention motifs replaced by the sequence
    op, ring or Ulysses as priced for ``seq_size`` ranks, captured anew
    over the same flat inputs, so that a ``seq`` axis is lowered from the
    op's nodes. A graph without closed motifs comes back as it is
    (``plan_axes`` plans the sequence ops it holds, or raises)."""
    from tepdist_tpu_torch.parallel.attention_motif import (
        best_seq_comm, build_ring_rewritten, detect_motifs)

    motifs = detect_motifs(graph)
    if not motifs:
        return graph
    impl, _ = best_seq_comm(motifs, seq_size, with_backward=True)
    for m in motifs:
        m.impl = impl
    rewritten, _, _ = trace_graph(build_ring_rewritten(graph, motifs,
                                                       seq_size),
                                  *flat_args, functional=True)
    return rewritten


def auto_parallel(
    fn: Callable,
    topology: MeshTopology,
    *example_args,
    annotations: Optional[Dict[int, Dict[str, DimStrategy]]] = None,
    mode: Optional[str] = None,
    state_alias: Optional[Dict[int, int]] = None,
    var_mem_limit: Optional[int] = None,
    zero_invars: Optional[Sequence[int]] = None,
    **example_kwargs,
) -> ParallelPlan:
    """Plan ``fn`` over ``topology``. Modes: "cost" (default), "rule".

    ``fn`` is captured on fake tensors made from the examples (nothing
    runs, no device memory is allocated); a step that updates its inputs
    in place is captured in value form (``functional=True``).
    ``state_alias``: outvar flat index -> invar flat index for training-state
    threading (forces matching shardings across steps). ``var_mem_limit``
    (or the VAR_MEM_LIMIT env): per-device variable-byte budget triggering
    ZeRO-style storage splitting. ``zero_invars``: flat invar indices of
    the OPTIMIZER-STATE leaves to force-shard over the data axis
    (``apply_zero_sharding`` — the exploration winner's ``@zero``
    modifier realized by the planner)."""
    env = ServiceEnv.get()
    if mode is None:
        mode = "rule" if env.rule_mode else "cost"
    if env.ignore_annotation:
        annotations = None
    graph, in_tree, out_tree = trace_graph(fn, *example_args,
                                           functional=True, **example_kwargs)
    seq_size = dict(topology.device_axes()).get("seq", 1)
    if seq_size > 1:
        graph = _rewrite_seq_motifs(
            graph, seq_size, tree_leaves((example_args, example_kwargs)))
    return plan_graph(graph, topology, in_tree, out_tree,
                      annotations=annotations, mode=mode,
                      state_alias=state_alias, var_mem_limit=var_mem_limit,
                      zero_invars=zero_invars)


def plan_graph(
    graph: FxGraph,
    topology: MeshTopology,
    in_tree: Any = None,
    out_tree: Any = None,
    annotations: Optional[Dict[int, Dict[str, DimStrategy]]] = None,
    mode: Optional[str] = None,
    state_alias: Optional[Dict[int, int]] = None,
    var_mem_limit: Optional[int] = None,
    zero_invars: Optional[Sequence[int]] = None,
) -> ParallelPlan:
    """The planning half of :func:`auto_parallel` on a captured graph (the
    RPC server's, from the wire): the strategies over ``topology`` (rank 0
    plans and broadcasts), the state alignment, affinity and ZeRO passes,
    and the lowering."""
    env = ServiceEnv.get()
    if mode is None:
        mode = "rule" if env.rule_mode else "cost"
    if env.ignore_annotation:
        annotations = None
    if var_mem_limit is None and env.var_mem_limit > 0:
        var_mem_limit = env.var_mem_limit

    def plan():
        strategies = plan_axes(graph, topology, annotations, mode,
                               mem_limit_bytes=var_mem_limit)
        if state_alias:
            n_aligned = align_state_storage(graph, strategies, state_alias)
            if n_aligned:
                log.info("aligned %d state variables to their produced "
                         "sharding", n_aligned)
        state_invars = sorted({ii for ii in (state_alias or {}).values()
                               if ii >= 0})
        if var_mem_limit is not None and var_mem_limit > 0:
            # Safety net for plans from the subgraph-DP/greedy paths (the
            # whole-graph ILP already enforced the budget in-search and
            # this becomes a no-op there).
            apply_mem_save(graph, strategies, topology, var_mem_limit,
                           state_invars or None)
        # Param <-> optimizer-slot affinity: slots adopt their param's
        # sharding (reference AUX_AFFINITY) so the apply step never
        # reshards.
        if state_alias and env.aux_affinity:
            from tepdist_tpu_torch.parallel.inst_affinity import (
                build_affinity_groups,
                unify_group_strategies,
            )
            try:
                groups = build_affinity_groups(graph, state_alias)
                unify_group_strategies(graph, strategies, groups)
            except Exception as e:  # noqa: BLE001 — an optimization
                log.warning("affinity unification skipped: %s", e)
        zero_split: List[int] = []
        if zero_invars:
            # After affinity unification on purpose: ZeRO-1 wants the
            # state slots SPLIT while params stay replicated, the opposite
            # of the slots-adopt-param-sharding affinity default.
            zero_split = apply_zero_sharding(graph, strategies, topology,
                                             zero_invars)
            log.info("ZeRO: sharded %d/%d optimizer-state invars over the "
                     "data axis", len(zero_split), len(zero_invars))
        return strategies, zero_split

    strategies, zero_split = plan_on_rank0(graph, plan)
    xform = SpmdTransform(graph, topology)
    sharding_plan = xform.lower(strategies, state_alias=state_alias)
    return ParallelPlan(
        graph=graph,
        topology=topology,
        strategies=strategies,
        sharding_plan=sharding_plan,
        in_tree=in_tree,
        out_tree=out_tree,
        mode=mode,
        zero=bool(zero_split),
    )


def auto_parallel_explore(
    fn: Callable,
    num_devices: int,
    *example_args,
    annotations: Optional[Dict[int, Dict[str, DimStrategy]]] = None,
    state_alias: Optional[Dict[int, int]] = None,
    num_micro_batches: int = 1,
    **example_kwargs,
) -> Any:
    """Exploration mode (reference: AutoParallel::RunExplorationlMode,
    auto_parallel.cc:236): enumerate proposals, plan each, keep the
    Evaluator-minimal one — over the candidate space of
    parallel/exploration.py, the one ``train.plan_training`` searches.

    When ``fn`` is a scalar-output loss of the form ``fn(params, *batch)``,
    the candidates are priced on its value-and-grad graph (the executed
    step is the gradient), as in the reference, and the space includes
    the sequence-parallel meshes (priced with the ring/Ulysses cost); a
    seq winner is lowered from ``fn`` rewritten by
    ``attention_motif.seq_rewritten_loss``, and the pipeline stage cuts;
    a pipeline winner is returned as a
    :class:`~tepdist_tpu_torch.parallel.exploration.PipelineWinner` (call
    ``.build(optimizer)`` for the executable). A non-scalar ``fn``
    searches mesh factorizations only (the report records the kinds left
    out as ``excluded_kinds``).

    SPMD and seq winners come back as a lowered :class:`ParallelPlan` with
    ``.cost`` and ``.candidates`` attached (planning needs no devices;
    running it needs a process group of the winner's size)."""
    from tepdist_tpu_torch.parallel.exploration import (
        PipelineWinner,
        pipeline_candidates,
        seq_candidates,
        spmd_candidates,
        winner_lowering_postcheck,
    )
    from tepdist_tpu_torch.telemetry import observatory
    import time as _time

    graph, in_tree, out_tree = trace_graph(fn, *example_args,
                                           functional=True, **example_kwargs)
    scalar_loss = (not example_kwargs and len(graph.outvars) == 1
                   and var_shape(graph.outvars[0]) == ()
                   and len(example_args) >= 2)
    # Price on the TRUE step graph: for a scalar loss the executed step is
    # grad(fn) — ranking SPMD candidates on the forward-only graph would
    # omit the backward ~2/3 and every gradient reduce.
    if scalar_loss:
        from tepdist_tpu_torch.train import value_and_grad
        price_graph, _, _ = trace_graph(value_and_grad(fn), *example_args)
    else:
        price_graph = graph
    # This entry point calls the enumerator directly (it lowers its own
    # winner), so it opens its own observatory capture — the report
    # lands on the returned plan as ``plan.exploration_report``.
    with observatory.capture("auto_parallel_explore") as _col:
        _t0 = _time.perf_counter()
        candidates = spmd_candidates(price_graph, num_devices, annotations,
                                     num_micro_batches)
        if _col is not None:
            _col.phase("spmd", _time.perf_counter() - _t0)
        if scalar_loss:
            batch_rows = tree_leaves(example_args[1:])[0].shape[0]
            _t0 = _time.perf_counter()
            candidates += seq_candidates(price_graph, num_devices,
                                         batch_rows)
            if _col is not None:
                _col.phase("seq", _time.perf_counter() - _t0)
            _t0 = _time.perf_counter()
            candidates += pipeline_candidates(
                fn, example_args[0], tuple(example_args[1:]), num_devices,
                batch_rows, num_micro_batches if num_micro_batches > 1
                else 4)
            if _col is not None:
                _col.phase("pipeline", _time.perf_counter() - _t0)
    excluded = [] if scalar_loss else ["seq", "pipeline"]
    if not candidates:
        raise RuntimeError("no feasible topology proposal")

    fallbacks = []
    for best in sorted(candidates, key=lambda c: c["cost"].key()):
        try:
            plan = _materialize_explored(
                best, fn, graph, in_tree, out_tree, example_args,
                annotations, state_alias, price_graph is graph, candidates)
        except Exception as e:  # noqa: BLE001 — fall to the runner-up
            log.warning("winner %s failed to materialize (%s); trying "
                        "the runner-up", best.get("topology", best["kind"]),
                        e)
            fallbacks.append({
                "config": observatory.candidate_config(best),
                "exc_type": type(e).__name__, "message": str(e)[:300]})
            continue
        log.info("exploration winner: %s (duration %.3e s/step) of %d "
                 "proposals", best["kind"], best["cost"].total_duration,
                 len(candidates))
        if _col is not None:
            report = observatory.build_report(
                _col, candidates, best, num_devices,
                excluded_kinds=excluded).to_dict()
            if fallbacks:
                # The cost-minimal proposal(s) that could not be
                # lowered: the report's winner is the argmin over what
                # MATERIALIZED, and the skips are on the record.
                report["materialization_fallbacks"] = fallbacks
            plan.exploration_report = report
        plan.excluded_kinds = excluded
        if not isinstance(plan, PipelineWinner):
            # Winner-only lowering post-check: runs when this process
            # group spans the winner's mesh (a pipeline winner has no
            # single lowered step until .build()).
            winner_lowering_postcheck(
                plan, tree_leaves((example_args, example_kwargs)))
        return plan
    raise RuntimeError("no proposal could be materialized")


def _materialize_explored(best, fn, graph, in_tree, out_tree, example_args,
                          annotations, state_alias, priced_on_fn_graph,
                          candidates):
    """Lower one explored candidate into its plan form."""
    if best["kind"] == "pipeline":
        from tepdist_tpu_torch.parallel.exploration import PipelineWinner

        return PipelineWinner(
            num_stages=best["num_stages"],
            num_micro_batches=best["num_micro_batches"],
            intra_tp=best.get("intra_tp", 1),
            cost=best["cost"], candidates=candidates,
            loss_fn=fn, params=example_args[0],
            example_batch=tuple(example_args[1:]),
            placement=best.get("placement", "blocked"),
            interleave_groups=best.get("interleave_groups"),
            comm_dtype=best.get("comm_dtype", ""),
            zero=best.get("zero", False))
    topo = best["topology"]
    # Candidate strategies were planned on the PRICING graph; when that is
    # the fn graph itself (non-scalar fn) they can be reused directly.
    strategies = best.get("strategies") if priced_on_fn_graph else None
    seq_size = dict(topo.device_axes()).get("seq", 1)
    if seq_size > 1:
        # Materialize the seq winner: rewrite the attention motifs to the
        # priced ring/Ulysses algorithm BEFORE planning, so the sequence
        # dim stays split through the sequence op (the lowering
        # plan_training applies). Strict motif detection: an escaping
        # motif was priceable but is not rewritable, and the caller's loop
        # falls back to the runner-up.
        from tepdist_tpu_torch.parallel.attention_motif import (
            seq_rewritten_loss)

        fn_rw, _impl = seq_rewritten_loss(fn, seq_size, *example_args)
        graph, in_tree, out_tree = trace_graph(fn_rw, *example_args,
                                               functional=True)
        strategies = None
    strategies, _ = plan_on_rank0(graph, lambda: (
        strategies if strategies is not None
        else plan_axes(graph, topo, annotations, "cost"), None))
    xform = SpmdTransform(graph, topo)
    sharding_plan = xform.lower(strategies, state_alias=state_alias)
    plan = ParallelPlan(
        graph=graph, topology=topo, strategies=strategies,
        sharding_plan=sharding_plan, in_tree=in_tree, out_tree=out_tree,
        mode="exploration",
        comm_dtype=best.get("comm_dtype", ""),
        zero=best.get("zero", False),
    )
    plan.cost = best["cost"]
    plan.candidates = candidates
    return plan


def explore_topologies(
    num_devices: int, max_levels: int = 3
) -> List[MeshTopology]:
    """Mesh-shape proposals for exploration mode (reference:
    GenerateSplitProposals — factor device count into <=3 ordinals)."""
    shapes: List[Tuple[Tuple[str, int], ...]] = []
    # 1-level: pure data or pure model.
    shapes.append((("data", num_devices),))
    shapes.append((("model", num_devices),))
    # 2-level factorizations data x model.
    d = 2
    while d * d <= num_devices:
        if num_devices % d == 0:
            shapes.append((("data", num_devices // d), ("model", d)))
            shapes.append((("data", d), ("model", num_devices // d)))
        d += 1
    # 3-level factorizations data x model x model2 (reference proposes up
    # to 3 split ordinals, auto_parallel.cc:132-181).
    if max_levels >= 3:
        a = 2
        while a * 4 <= num_devices:
            rest = num_devices // a
            if num_devices % a == 0:
                b = 2
                while b * b <= rest:
                    if rest % b == 0:
                        shapes.append((("data", a), ("model", rest // b),
                                       ("model2", b)))
                    b += 1
            a += 1
    out = []
    seen = set()
    for axes in shapes:
        key = tuple(axes)
        if key not in seen:
            seen.add(key)
            out.append(MeshTopology(list(axes)))
    return out
