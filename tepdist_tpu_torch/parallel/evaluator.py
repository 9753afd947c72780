"""Analytic cost evaluator for planned modules: the port of
``tepdist_tpu/parallel/evaluator.py``, ``run_pipeline`` included (the
port's ``TaskScheduler`` simulation prices a pipeline plan's task DAG).
"GSPMD" below is the reference's partitioner; in the port the same
collectives are DTensor's.

Reference parity: ``Evaluator::Run`` (reference: parallel/evaluator.{h,cc}:
per-stage flops vs device power, collective time via PerfUtils, pipeline
fwd/bwd wave simulation with cross-stage transfer on inter-node bandwidth,
memory feasibility gate ``usage_ratio * max_bytes_per_device``; returns
{total_duration, gpu_efficiency, coll_ratio, bubble_ratio}). The V100/NVLink
constants are replaced by the per-TPU-generation chip specs; the pipeline
wave simulation is delegated to the real TaskScheduler (the reference keeps
a closed-form 1F1B approximation — our scheduler IS that simulator).

v2: the SPMD path prices *every* comm edge, not just
partial->psum resolutions — reshard edges (all-gather / all-to-all /
re-slice) are recovered by back-inferring each node's input demands from
its chosen output strategy and pricing the (produced -> demanded)
transition; the pipeline path reports real coll/bubble ratios from the
schedule, with cross-worker Send/Recv priced at DCN bandwidth.

v3: demands are priced from EVERY output strategy of
a multi-output node (deduped per physical reshard); collective time is
always re-derived from the final assignment with the planner's own
comm_cost kept only as a lower bound (an ILP that decided conflicts
outside its cones reported comm=0 for measured-comm-dominated plans); a
COMM_OVERLAP factor discounts exposed collective time multiplicatively
for XLA's async-collective overlap. Validated against measured CPU-mesh
step times in tests/test_evaluator_measured.py (argmin agreement over
annotation-forced dp/tp/tp0 plans) and tests/test_evaluator.py
(replicated-vs-sharded).

v4: cross-axis conflicts are priced — a split input
consumed by a node left replicated on an axis pays the gather GSPMD
performs unless the op provably carries the split (_hidden_gather_time,
with forward-inference/structural carry checks so clean DP plans price
zero phantom gathers), and an entangled partition-dim change (the var is
split on another axis) upgrades from all-to-all to full-remat pricing
(_reshard_time). Remaining documented gap: pathologies created INSIDE
lowering by device-order permutations of the composed mesh (transposed
tile assignments XLA remats) are invisible to any pre-lowering model."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch.fx as fx

from tepdist_tpu_torch.core.dist_spec import DimStrategy
from tepdist_tpu_torch.core.mesh import MeshTopology
from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.graph.cost import COMPUTE_INTENSIVE
from tepdist_tpu_torch.graph.fx_graph import FxGraph, var_bytes, var_shape
from tepdist_tpu_torch.parallel.cost_spmd_strategy import (
    GraphStrategy,
    transition_cost,
)
from tepdist_tpu_torch.parallel.performance_utils import PerfUtils, chip_spec

Var = fx.Node


@dataclasses.dataclass
class Cost:
    """Evaluator verdict (reference evaluator.h:37-43)."""

    total_duration: float          # seconds per step
    compute_efficiency: float      # busy fraction (was gpu_efficiency)
    coll_ratio: float              # collective time / total
    bubble_ratio: float            # pipeline bubbles / total
    peak_bytes_per_device: float
    memory_feasible: bool
    # Per-device optimizer-state bytes priced into ``peak_bytes_per_device``
    # (state is not free — ZeRO candidates shrink this by
    # 1/dp). Defaulted so Cost dicts serialized before the field existed
    # still load.
    opt_state_bytes_per_device: float = 0.0

    def key(self) -> float:
        # Infeasible plans lose to any feasible plan.
        return self.total_duration if self.memory_feasible else float("inf")


class Evaluator:
    def __init__(self, topology: MeshTopology, chip=None,
                 usage_ratio: float = 0.9, comm_dtype: str = "",
                 zero: bool = False):
        """``comm_dtype``: price gradient collectives at a compressed wire
        dtype (""/"float32" = fidelity, "bfloat16", "int8"). Only the
        partial-resolution psums (gradient AllReduce) compress — reshard
        edges and hidden gathers move activations/params whose consumers
        need full precision, so they stay at fidelity bytes.

        ``zero``: price the candidate with ZeRO-1 weight-update sharding
        over the data axis (arXiv:2004.13336) — optimizer state shrinks to
        1/dp per device, and the gradient all-reduce is replaced by
        reduce-scatter + updated-param all-gather (both composing with
        ``comm_dtype``)."""
        self.topology = topology
        self.spec = chip or chip_spec()
        self.usage_ratio = usage_ratio
        self.comm_dtype = comm_dtype
        self.zero = zero

    # -- SPMD ------------------------------------------------------------
    def _reshard_time(self, graph: FxGraph, gs: GraphStrategy,
                      produced: Optional[Dict] = None,
                      cross_split_vars: Optional[set] = None) -> float:
        """Price reshard edges for one axis: each node's input demand
        (back-inferred from its chosen output strategy) vs what the
        producer actually emits (reference: the reshard CustomCollectives
        SpmdTransform would insert; priced but never materialised here —
        GSPMD emits the real ones).

        ``cross_split_vars``: vars split (produced or demanded) on ANOTHER
        mesh axis. A partition-DIM change on this axis for such a var is
        an entangled cross-axis transition GSPMD cannot lower as a cheap
        all-to-all — it falls back to "Involuntary full rematerialization"
        (replicate, then re-partition; spmd_partitioner.cc) — so it is
        priced as the full-bytes all-gather that remat performs
        (measured 2.5x pathology in
        tests/test_evaluator_measured.py)."""

        from tepdist_tpu_torch.core.dist_spec import DimStrategy as _DS
        from tepdist_tpu_torch.parallel.strategy_utils import StrategyUtil

        if produced is None:
            produced = self._produced_map(graph, gs)
        repl = _DS.make_replicated(gs.num_splits)
        t = 0.0
        for node in graph.nodes:
            outs = gs.node_out.get(node.id)
            if not outs:
                continue
            # Price demands from EVERY split output strategy, not just the
            # first (multi-output nodes were under-priced).
            # The same (input, demand) pair implied by several outputs is
            # one physical reshard — dedup by demand signature.
            seen: set = set()
            for out_s in outs:
                if out_s is None or not out_s.is_split():
                    continue
                r = StrategyUtil.back_infer(node, out_s, gs.num_splits)
                if r is None:
                    continue
                for pos, (a, want) in enumerate(
                        zip(node.invars, r.in_strategies)):
                    if want is None or not isinstance(a, Var):
                        continue
                    key = (pos, want.partition_dim, want.num_splits,
                           want.partial, want.replicated)
                    if key in seen:
                        continue
                    seen.add(key)
                    src = produced.get(a)
                    if src is None or src.partial:
                        continue    # partial->psum priced separately
                    cost = transition_cost(src, want, var_bytes(a),
                                           gs.num_splits, self.spec)
                    if (cross_split_vars and a in cross_split_vars
                            and src.is_split() and want.is_split()
                            and want.partition_dim != src.partition_dim):
                        # Entangled cross-axis dim change: full remat.
                        cost = max(cost, transition_cost(
                            src, repl, var_bytes(a),
                            self.topology.num_devices, self.spec))
                    t += cost
        return t

    @staticmethod
    def _demanded_split_vars(graph: FxGraph, gs: GraphStrategy) -> set:
        """Vars some consumer demands SPLIT on this axis (back-inferred
        from split outputs) — one half of the cross-axis entanglement
        signal."""

        from tepdist_tpu_torch.parallel.strategy_utils import StrategyUtil

        out: set = set()
        for node in graph.nodes:
            outs = gs.node_out.get(node.id)
            if not outs:
                continue
            for out_s in outs:
                if out_s is None or not out_s.is_split():
                    continue
                r = StrategyUtil.back_infer(node, out_s, gs.num_splits)
                if r is None:
                    continue
                for a, want in zip(node.invars, r.in_strategies):
                    if (isinstance(a, Var) and want is not None
                            and want.is_split()):
                        out.add(a)
        return out

    @staticmethod
    def _produced_map(graph: FxGraph, gs: GraphStrategy) -> Dict:
        produced: Dict = dict(gs.var_strategies)
        for nid, outs in gs.node_out.items():
            node = graph.nodes[nid]
            for ov, s in zip(node.outvars, outs):
                if s is not None:
                    produced[ov] = s
        return produced

    def derived_comm(self, graph: FxGraph, gs: GraphStrategy,
                     produced: Optional[Dict] = None,
                     cross_split_vars: Optional[set] = None) -> float:
        """Collective seconds of one axis's plan, re-derived from the final
        strategy assignment — psums at partial-resolution frontiers +
        reshard edges — with the planner's own comm_cost as a lower bound.
        The ONE pricing used for every candidate in an exploration argmin
        (rule-mode, cost-mode, and the hand-priced seq hybrids in
        train.py) so candidate kinds never compete under different
        rulers."""

        cost_factor = ServiceEnv.get().cost_factor
        if produced is None:
            produced = self._produced_map(graph, gs)
        # Partial-ness propagates through linear ops; GSPMD inserts the ONE
        # physical psum where the partial chain RESOLVES (a consumer whose
        # outputs are non-partial, or the graph boundary). Charging at
        # origination instead double-charges e.g. tied-embedding grads
        # (add of two partial contributions = one psum of the sum).
        consumers: Dict = {}
        for node in graph.nodes:
            for a in node.invars:
                if isinstance(a, Var):
                    consumers.setdefault(a, []).append(node)
        outvar_set = {a for a in graph.outvars if isinstance(a, Var)}
        coll = 0.0
        for nid, outs in gs.node_out.items():
            node = graph.nodes[nid]
            for ov, s in zip(node.outvars, outs):
                if s is None or not s.partial:
                    continue
                resolved = ov in outvar_set
                if not resolved:
                    for cons in consumers.get(ov, []):
                        couts = gs.node_out.get(cons.id)
                        if couts is None or not any(
                                cs is not None and cs.partial
                                for cs in couts):
                            resolved = True
                            break
                if resolved:
                    coll += cost_factor * PerfUtils.compressed_all_reduce_cost(
                        var_bytes(ov), gs.num_splits, self.comm_dtype,
                        self.spec)
        if gs.reshard_edges:
            # Rule-mode plans record their reshard decisions explicitly
            # (FastSpmdStrategy Solution edges) — price those directly.
            for nid, posmap in gs.reshard_edges.items():
                node = graph.nodes[nid]
                for pos, (src, want) in posmap.items():
                    if src.partial:
                        continue       # partial->psum priced above already
                    a = node.invars[pos]
                    coll += transition_cost(
                        src, want, var_bytes(a), gs.num_splits,
                        self.spec)
        else:
            coll += self._reshard_time(graph, gs, produced,
                                       cross_split_vars)
        coll += self._hidden_gather_time(graph, gs, produced)
        # The planner's ILP objective priced fidelity bytes; under a
        # compressed comm dtype the lower bound shrinks with the wire.
        from tepdist_tpu_torch.parallel.performance_utils import COMM_DTYPE_RATIOS
        ratio = COMM_DTYPE_RATIOS.get(self.comm_dtype, 1.0)
        return max(coll, (gs.comm_cost or 0.0) * ratio)

    def _hidden_gather_time(self, graph: FxGraph, gs: GraphStrategy,
                            produced: Dict) -> float:
        """Cross-axis conflict rematerialization: a split
        input consumed by a node the planner left REPLICATED on this axis
        is gathered by GSPMD over the axis ("Involuntary full
        rematerialization", spmd_partitioner.cc) — typically because the
        consumer's split lives on ANOTHER mesh axis, which the per-axis
        demand back-inference cannot see (demands are only derived from
        split outputs, so a replicated-on-this-axis consumer derives
        none). Measured 2.5x pathology on the conflict fixture in
        tests/test_evaluator_measured.py.

        The planner's node marks are ADVISORY for intermediates (only
        invar/outvar shardings are pinned at lowering; GSPMD propagates
        the rest), so a planner-replicated node whose op can CARRY the
        input's split (forward inference yields a split output — every
        elementwise op) is computed sharded by GSPMD and priced zero
        here. Only ops the split cannot flow through (forward inference
        fails, or degrades to a partial the plan never resolves) pay the
        gather."""

        from tepdist_tpu_torch.core.dist_spec import DimStrategy as _DS
        from tepdist_tpu_torch.parallel.strategy_utils import StrategyUtil

        repl = _DS.make_replicated(gs.num_splits)
        gathered: set = set()   # one gather per var on this axis
        t = 0.0
        for node in graph.nodes:
            outs = gs.node_out.get(node.id)
            if not outs or all(s is None for s in outs):
                continue        # glue/unassigned: GSPMD keeps it sharded
            if any(s is not None and (s.is_split() or s.partial)
                   for s in outs):
                continue        # node participates on this axis: the
                                # normal demand machinery prices it
            for pos, a in enumerate(node.invars):
                if not isinstance(a, Var) or a in gathered:
                    continue
                src = produced.get(a)
                if src is None or not src.is_split() or src.partial:
                    continue
                if self._split_carries(node, pos, a, src, gs.num_splits):
                    continue    # GSPMD carries the split through
                gathered.add(a)
                t += transition_cost(src, repl, var_bytes(a),
                                     gs.num_splits, self.spec)
        return t

    @staticmethod
    def _split_carries(node, pos: int, a, src, num_splits: int) -> bool:
        """Can GSPMD propagate this operand's split through the op
        without comm? Ops the inference rules know (dot/conv/reduce/
        dim-mapped) answer via forward inference — a split output means
        carry, a partial/None means real comm. Ops OUTSIDE the rule
        table (add_any, broadcast elementwise, most transparent glue)
        default to the structural check: the output preserves the split
        dim, so slicing commutes with the op. Opaque ops that fail both
        default to carry=True, i.e. priced zero — the pre-r5 behavior
        (never over-price what we cannot model)."""
        from tepdist_tpu_torch.parallel.strategy_utils import (
            StrategyUtil,
            dim_maps,
        )

        try:
            fwd = StrategyUtil.forward_infer(node, {pos: src},
                                             num_splits)
        except Exception:  # noqa: BLE001 — unknown op
            fwd = None
        if fwd is not None:
            return any(s is not None and s.is_split()
                       for s in fwd.out_strategies)
        try:
            known_op = (node.prim in COMPUTE_INTENSIVE
                        or dim_maps(node) is not None)
        except Exception:  # noqa: BLE001
            known_op = False
        if known_op:
            return False        # the rules understood it and said comm
        # Structural fallback: output keeps the operand's split dim.
        d = src.partition_dim
        out_shape = var_shape(node.outvars[0]) if node.outvars else ()
        in_shape = var_shape(a)
        return (d < len(out_shape) and d < len(in_shape)
                and len(out_shape) == len(in_shape)
                and out_shape[d] == in_shape[d])

    def run(self, graph: FxGraph,
            strategies: Sequence[GraphStrategy],
            num_micro_batches: int = 1) -> Cost:

        n_shards = 1
        for _, size in self.topology.device_axes():
            n_shards *= size
        # Per-node compute honoring the ACTUAL sharding decisions: a node
        # the planner left replicated on an axis runs its full flops there
        # (pretending total_flops/n_shards would make a replicated plan and
        # a fully sharded plan cost the same — an earlier bug that made
        # exploration rankings degenerate).
        produced_maps = [self._produced_map(graph, gs) for gs in strategies]
        compute_t = 0.0
        for node in graph.nodes:
            div = 1
            for gs, prod in zip(strategies, produced_maps):
                outs = gs.node_out.get(node.id)
                sharded = any(
                    s is not None and (s.is_split() or s.partial)
                    for s in (outs or []))
                if not sharded:
                    sharded = any(
                        isinstance(a, Var)
                        and (st := prod.get(a)) is not None and st.is_split()
                        for a in node.invars)
                if sharded:
                    div *= gs.num_splits
            compute_t += PerfUtils.compute_time(node.flops / div, self.spec)

        # Collective time: ALWAYS re-derived from the final strategy
        # assignment (derived_comm — psums at partial-resolution frontiers
        # + reshard edges). The cost planner's own comm_cost is its ILP
        # objective view, which misses everything decided OUTSIDE the
        # cones (glue-node conflicts GSPMD resolves at runtime, partial
        # grads resolved at the apply boundary) — trusting it verbatim
        # reported comm=0 for plans whose measured step is comm-dominated.
        # Cross-axis entanglement context: vars split (produced or
        # demanded) on each axis, so axis i's reshard pricing can detect
        # dim changes GSPMD must lower as full rematerialization.
        split_vars_per_axis = []
        if len(strategies) > 1:
            for gs, prod in zip(strategies, produced_maps):
                sv = {a for a, s in prod.items()
                      if s is not None and s.is_split()}
                sv |= self._demanded_split_vars(graph, gs)
                split_vars_per_axis.append(sv)
        coll_t = 0.0
        for i, (gs, produced) in enumerate(zip(strategies, produced_maps)):
            cross = None
            if split_vars_per_axis:
                cross = set().union(*(sv for j, sv in
                                      enumerate(split_vars_per_axis)
                                      if j != i)) or None
            coll_t += self.derived_comm(graph, gs, produced, cross)

        # Memory: parameters (sharded where split) + activation peak
        # + optimizer state. The state term
        # was FREE before: a dp-wide replica set held dp full Adam-moment
        # copies the feasibility gate never saw, so the planner could not
        # see the one scenario ZeRO exists for. The traced step graph is
        # value_and_grad's (loss, grads) — every non-scalar outvar mirrors
        # a param leaf, so gradient bytes double as the state-payload base.
        from tepdist_tpu_torch.parallel.performance_utils import OPT_STATE_FACTOR
        from tepdist_tpu_torch.parallel.sync_free import (
            estimate_peak_activation_bytes,
        )
        act_peak = estimate_peak_activation_bytes(graph) / max(
            n_shards * num_micro_batches, 1)
        invar_bytes = 0.0
        for v in graph.invars:
            b = var_bytes(v)
            factor = 1
            for gs in strategies:
                s = gs.var_strategies.get(v)
                if s is not None and s.is_split():
                    factor *= s.num_splits
            invar_bytes += b / factor
        grad_bytes = 0.0
        dp_grad_psum = False
        axis_names = [nm for nm, sz in self.topology.device_axes()
                      if sz > 1]   # strategies align 1:1 (plan_axes order)
        for ov in graph.outvars:
            if not isinstance(ov, Var) or not var_shape(ov):
                continue
            b = float(var_bytes(ov))
            for nm, gs, prod in zip(axis_names, strategies, produced_maps):
                s = prod.get(ov)
                if s is not None and s.is_split():
                    b /= gs.num_splits
                if nm == "data" and s is not None and s.partial:
                    dp_grad_psum = True
            grad_bytes += b
        opt_bytes = OPT_STATE_FACTOR * grad_bytes
        dp = next((sz for nm, sz in self.topology.device_axes()
                   if nm == "data" and sz > 1), 1)
        if self.zero and dp > 1:
            opt_bytes /= dp
            # RS(grads) + sharded apply + AG(updated params) replaces the
            # data axis's gradient all-reduce. Net ~ +ALPHA_S*(dp-1) at
            # equal bytes (ring algebra), so ZeRO never wins on pure
            # seconds — it must win via memory feasibility, which is why
            # fidelity-first tie-breaking stays safe.
            delta = PerfUtils.zero_update_cost(
                grad_bytes, dp, self.comm_dtype, self.spec)
            if dp_grad_psum:
                delta -= PerfUtils.compressed_all_reduce_cost(
                    grad_bytes, dp, self.comm_dtype, self.spec)
            coll_t += max(delta, 0.0)
        peak = act_peak + invar_bytes + opt_bytes
        budget = self.spec.hbm_gb * 1e9 * self.usage_ratio

        # Compute/comm overlap: XLA overlaps async
        # collectives with independent compute, so strictly-serial pricing
        # over-penalizes comm-heavy plans in exploration rankings. The
        # discount is multiplicative — exposed = (1-overlap)*coll — not
        # subtractive (max(0, coll - overlap*compute) hides ALL comm on
        # compute-heavy graphs and degenerates every ranking to compute,
        # which is itself topology-invariant once fully sharded).
        overlap = min(max(ServiceEnv.get().comm_overlap, 0.0), 1.0)
        exposed_coll = (1.0 - overlap) * coll_t
        total = compute_t + exposed_coll
        return Cost(
            total_duration=total,
            compute_efficiency=compute_t / total if total > 0 else 0.0,
            coll_ratio=exposed_coll / total if total > 0 else 0.0,
            bubble_ratio=0.0,
            peak_bytes_per_device=peak,
            memory_feasible=peak <= budget,
            opt_state_bytes_per_device=opt_bytes,
        )

    # -- pipeline --------------------------------------------------------
    def run_pipeline(self, dag, chip=None, opt_state_bytes: float = 0.0,
                     zero_dp: int = 1, zero_comm_s: float = 0.0) -> Cost:
        """Pipeline plans: the TaskScheduler simulation is the cost model
        (cross-worker Send/Recv priced at DCN bandwidth inside the
        scheduler's time model); coll/bubble ratios come from the schedule
        rather than being reported as zero.

        ``opt_state_bytes``: per-device optimizer-state bytes of the stage
        owner under fidelity (the scheduler's activation/weight model does
        not see the optimizer); divided by ``zero_dp`` when the candidate
        shards the weight update, with ``zero_comm_s`` the priced
        reduce-scatter + all-gather substitution added to the makespan."""
        from tepdist_tpu_torch.runtime.task_graph import TaskType
        from tepdist_tpu_torch.runtime.task_scheduler import TaskScheduler

        spec = chip or self.spec
        budget = spec.hbm_gb * 1e9 * self.usage_ratio
        # The scheduler enforces the memory budget itself: OOM candidate
        # windows are rejected during the search (a wider/narrower 1F1B
        # window is chosen), not merely reported after the fact.
        ts = TaskScheduler(dag, chip=spec, mem_limit_bytes=budget)
        sched = ts.schedule()
        state = opt_state_bytes / max(zero_dp, 1)
        peak = max(sched.peak_bytes.values(), default=0.0) + state
        busy = 1.0 - sched.bubble_ratio
        devices = {d for n in dag.nodes for d in n.device_group} or {0}
        comm_t = sum(
            ts.task_time(n) for n in dag.nodes
            if n.task_type in (TaskType.SEND, TaskType.RECV, TaskType.AR))
        comm_t += zero_comm_s
        makespan = sched.makespan + zero_comm_s
        coll = comm_t / (makespan * len(devices)) if makespan else 0.0
        return Cost(
            total_duration=makespan,
            compute_efficiency=busy,
            coll_ratio=min(coll, 1.0),
            bubble_ratio=sched.bubble_ratio,
            peak_bytes_per_device=peak,
            memory_feasible=sched.memory_feasible and peak <= budget,
            opt_state_bytes_per_device=state,
        )
