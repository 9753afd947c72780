"""Liveness optimizer: duplicate cheap long-lived values.

The port of ``tepdist_tpu/parallel/liveness.py`` (reference parity:
``HloLivenessOptimizer``, parallel/hlo_liveness_optimizer.{h,cc}):
a pre-planning pass that duplicates cheap instructions with long live
ranges so each consumer region regenerates them locally instead of keeping
them alive — shortening live ranges before memory planning.

The pass exists for the *planner's* benefit: the activation-peak estimator
sees the shortened ranges, so micro-batch counts are sized against
realistic liveness. The duplicable producers are the aten counterparts of
the reference's scalar-fed ``broadcast_in_dim`` and ``iota``: ``full``,
``zeros``, ``ones``, ``arange``, and ``expand`` of a 0-d tensor.
"""

from __future__ import annotations

from typing import Dict, List

import torch.fx as fx

from tepdist_tpu_torch.graph.fx_graph import FxGraph, GraphNode, var_val

# Cheap, operand-light producers worth duplicating.
_DUPLICABLE = {"full", "zeros", "ones", "arange", "expand"}


def _scalar_fed(node: GraphNode) -> bool:
    """Only producers fed by Python scalars or 0-d tensors."""
    return all(var_val(a) is not None and var_val(a).dim() == 0
               for a in node.invars)


def optimize_liveness(graph: FxGraph, min_range: int = 32,
                      min_bytes: int = 1 << 16) -> FxGraph:
    """Rewrite the graph duplicating duplicable producers whose consumers
    span more than ``min_range`` nodes, one copy per far consumer.
    Returns a new FxGraph (the input is untouched)."""
    overrides: Dict[int, List[GraphNode]] = {}
    for node in graph.nodes:
        if node.prim not in _DUPLICABLE or not _scalar_fed(node):
            continue
        if node.out_bytes() < min_bytes:
            continue
        far = [u for u in node.users if u.id - node.id > min_range]
        if len(node.users) < 2 or not far:
            continue
        for u in far:
            overrides.setdefault(u.id, []).append(node)

    if not overrides:
        return graph

    new_graph = fx.Graph()
    env: Dict[fx.Node, fx.Node] = {}
    out = new_graph.graph_copy(graph.gm.graph, env)
    new_graph.output(out)
    for node in graph.nodes:
        for producer in overrides.get(node.id, ()):
            user = env[node.eqn]
            with new_graph.inserting_before(user):
                dup = new_graph.node_copy(producer.eqn, lambda n: env[n])
            user.replace_input_with(env[producer.eqn], dup)
    return FxGraph(fx.GraphModule(graph.gm, new_graph))
