"""Rule-based (annotation-driven) SPMD inference — the fast path.

Reference parity: ``FastSpmdStrategyBase`` / ``AnnotFastSpmdStrategy``
(reference: service/parallel/fast_spmd_strategy.{h,cc}, ~4.4k LoC): a single
forward/backward sweep that spreads user ``xla_sharding``-style annotations
through per-opcode transfer functions, without any cost search. Used when
``RULE_MODE`` is on or as the planner for already-annotated graphs.

The port of ``tepdist_tpu/parallel/fast_spmd_strategy.py``: the sweep
runs over the port's captured aten graph using the shared ``StrategyUtil``
transfer functions; the result is the same ``GraphStrategy`` the cost planner
produces, so the SPMD transform is agnostic to which planner ran.

Conflict handling: an earlier sweep was a worklist
with first-written-wins values and a magic revisit bound — conflicting
annotations produced order-dependent plans. This version sweeps the graph
in TOPOLOGICAL order to a fixpoint (deterministic regardless of annotation
insertion order; values are only ever set, never overwritten, so the sweep
count is bounded by the number of variables), and a consumer whose demand
disagrees with a variable's produced strategy records an explicit RESHARD
EDGE (the reference's reshard ``Solution`` edges) instead of silently
dropping one side: ``GraphStrategy.reshard_edges`` maps
``node id -> {operand position: (produced, demanded)}``, the Evaluator
prices them, and DTensor materialises the actual conversion.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch.fx as fx

from tepdist_tpu_torch.core.dist_spec import DimStrategy
from tepdist_tpu_torch.graph.fx_graph import FxGraph
from tepdist_tpu_torch.parallel.cost_spmd_strategy import GraphStrategy
from tepdist_tpu_torch.parallel.strategy_utils import StrategyUtil

Var = fx.Node


class FastSpmdStrategy:
    """Fixpoint annotation propagation for one mesh axis."""

    def __init__(self, graph: FxGraph, axis_name: str, num_splits: int,
                 fixed: Dict[Var, DimStrategy]):
        self.graph = graph
        self.axis = axis_name
        self.n = num_splits
        self.fixed = dict(fixed)

    def run(self) -> GraphStrategy:
        value: Dict[Var, DimStrategy] = dict(self.fixed)
        # node id -> {operand pos: (produced strategy, demanded strategy)}
        reshards: Dict[int, Dict[int, Tuple[DimStrategy, DimStrategy]]] = {}
        nodes = self.graph.nodes            # program order == topological

        def interesting(s: Optional[DimStrategy]) -> bool:
            return s is not None and (s.is_split() or s.partial)

        changed = True
        sweeps = 0
        # Each sweep either adds at least one var value or terminates, so
        # the worst-case sweep count is the number of assignable variables
        # (invars + constvars + every eqn output).
        max_sweeps = (len(self.graph.invars) + len(self.graph.constvars)
                      + sum(len(n.outvars) for n in nodes) + 2)
        while changed and sweeps <= max_sweeps:
            changed = False
            sweeps += 1
            reshards.clear()    # re-derived each sweep from current values
            for node in nodes:
                known = {}
                for i, a in enumerate(node.invars):
                    if isinstance(a, Var) and interesting(value.get(a)):
                        known[i] = value[a]
                if not known:
                    continue
                r = StrategyUtil.forward_infer(node, known, self.n)
                if r is None and len(known) > 1:
                    # Operand strategies conflict at this op: keep the
                    # lowest operand position's view (deterministic) and
                    # let the others become reshard edges below.
                    for i in sorted(known):
                        r = StrategyUtil.forward_infer(
                            node, {i: known[i]}, self.n)
                        if r is not None:
                            break
                if r is None:
                    continue
                # Demands: fill unset producer strategies; disagreements
                # with an already-produced strategy become reshard edges.
                for i, (a, want) in enumerate(zip(node.invars,
                                                  r.in_strategies)):
                    if not isinstance(a, Var) or want is None:
                        continue
                    have = value.get(a)
                    if have is None:
                        if want.is_split():
                            value[a] = want
                            changed = True
                    elif have != want and (interesting(have)
                                           or interesting(want)):
                        reshards.setdefault(node.id, {})[i] = (have, want)
                for ov, s in zip(node.outvars, r.out_strategies):
                    if (isinstance(ov, Var) and ov not in value
                            and interesting(s)):
                        value[ov] = s
                        changed = True

        rep = DimStrategy.make_replicated(self.n)
        var_strat = {}
        for v in list(self.graph.invars) + list(self.graph.constvars):
            var_strat[v] = value.get(v, rep)
        node_out: Dict[int, List[DimStrategy]] = {}
        for node in nodes:
            node_out[node.id] = [
                value.get(ov, rep) if isinstance(ov, Var) else rep
                for ov in node.outvars
            ]
        outs: List[Optional[DimStrategy]] = []
        for a in self.graph.outvars:
            outs.append(value.get(a, rep) if isinstance(a, Var) else None)
        return GraphStrategy(
            axis_name=self.axis,
            num_splits=self.n,
            var_strategies=var_strat,
            node_out=node_out,
            out_strategies=outs,
            total_cost=0.0,
            ilp_status="rule",
            reshard_edges=reshards or None,
        )
