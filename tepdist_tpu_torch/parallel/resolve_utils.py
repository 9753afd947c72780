"""Gradient / forward / backward / apply resolution over captured train steps.

Reference parity: ``ResolveGradients`` / ``ResolveForwardBackwardAndApply-
Gradients`` (reference: parallel/resolve_utils.{h,cc}) pattern-matched TF
optimizer update subgraphs (SGD, AdamWeightDecay, TF-1.14, JAX AdaFactor).
The port of ``tepdist_tpu/parallel/resolve_utils.py`` classifies regions
structurally, as the JAX package does, over the port's functional capture
of a step (``trace_graph(..., functional=True)``) — it works for any of the
port's optimizers:

  FORWARD  = ancestors of the loss output,
  BACKWARD = non-forward nodes that reach a state output AND (transitively)
             depend on batch data — the grad computation,
  APPLY    = nodes reaching a state output that depend only on state and
             gradients (the optimizer update),
  gradients = first-contact rule: per state invar, the shape-matching
             data-dependent operand of its first non-forward consumer.

These drive the sync-free decomposition's gradient detection and the
variable<->optimizer-state affinity groups.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch.fx as fx

from tepdist_tpu_torch.graph.fx_graph import FxGraph, GraphNode, var_shape

Var = fx.Node


@dataclasses.dataclass
class ResolveResult:
    forward_nodes: Set[int]
    backward_nodes: Set[int]
    apply_nodes: Set[int]
    # state invar index -> gradient Var entering the apply region
    gradients: Dict[int, Var]


def _ancestors(graph: FxGraph, seeds: Sequence[GraphNode]) -> Set[int]:
    seen: Set[int] = set()
    stack = list(seeds)
    while stack:
        n = stack.pop()
        if n.id in seen:
            continue
        seen.add(n.id)
        stack.extend(n.operands)
    return seen


def _descendants(graph: FxGraph, seeds: Sequence[GraphNode]) -> Set[int]:
    seen: Set[int] = set()
    stack = list(seeds)
    while stack:
        n = stack.pop()
        if n.id in seen:
            continue
        seen.add(n.id)
        stack.extend(n.users)
    return seen


def resolve_forward_backward_apply(
    graph: FxGraph,
    loss_out_index: int = 0,
    state_alias: Optional[Dict[int, int]] = None,
) -> ResolveResult:
    """``state_alias``: outvar idx -> invar idx of training state (params +
    optimizer slots). Without it, every non-scalar output except the loss is
    treated as state."""
    loss_atom = graph.outvars[loss_out_index]
    loss_nodes = []
    if isinstance(loss_atom, Var) and loss_atom in graph.producer:
        loss_nodes = [graph.producer[loss_atom][0]]
    forward = _ancestors(graph, loss_nodes)

    if state_alias is None:
        state_alias = {
            oi: -1 for oi, a in enumerate(graph.outvars)
            if oi != loss_out_index and isinstance(a, Var)
        }
    state_producers = []
    for oi in state_alias:
        a = graph.outvars[oi]
        if isinstance(a, Var) and a in graph.producer:
            state_producers.append(graph.producer[a][0])
    reaches_state = _ancestors(graph, state_producers)

    # Data-dependent nodes: descendants of non-state (batch) invars.
    state_invar_set = {ii for ii in state_alias.values() if ii >= 0}
    if not state_invar_set:
        state_invar_set = set()
    data_seeds = []
    for i, v in enumerate(graph.invars):
        if i in state_invar_set:
            continue
        data_seeds.extend(graph.arg_consumers(v))
    depends_on_data = _descendants(graph, data_seeds)

    backward = (reaches_state & depends_on_data) - forward
    apply_nodes = reaches_state - forward - backward

    # Gradient-entry values by FIRST CONTACT (the reference pattern-matched
    # optimizer structures here; the structural equivalent): for each state
    # invar, its first non-forward consumer joins optimizer state with a
    # data-dependent value of the same shape — that value is the gradient
    # (possibly pre-scaled) entering that variable's update.
    grads: Dict[int, Var] = {}
    for oi, ii in state_alias.items():
        if ii < 0 or ii in grads:
            continue
        v = graph.invars[ii]
        for consumer in graph.arg_consumers(v):
            if consumer.id in forward:
                continue
            for a in consumer.invars:
                if (isinstance(a, Var) and a is not v
                        and a in graph.producer
                        and graph.producer[a][0].id in depends_on_data
                        and var_shape(a) == var_shape(v)):
                    grads[ii] = a
                    break
            if ii in grads:
                break
    return ResolveResult(forward, backward, apply_nodes, grads)


def resolve_gradients(graph: FxGraph,
                      state_alias: Optional[Dict[int, int]] = None
                      ) -> Dict[int, Var]:
    return resolve_forward_backward_apply(graph,
                                          state_alias=state_alias).gradients
