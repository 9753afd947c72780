"""Instruction/variable affinity groups.

Reference parity: ``InstAffinityMap`` / ``VarAuxAffinity`` (reference:
parallel/inst_affinity_map.{h,cc}): directional affinity terms added to the
cone ILP, most importantly variable <-> auxiliary (Adam m/v) affinity so a
parameter and its optimizer slots shard identically (otherwise every apply
step pays a reshard).

The port of ``tepdist_tpu/parallel/inst_affinity.py``: affinity is enforced as a post-planning unification pass over the
per-axis variable strategies — for each affinity group (param + same-shaped
optimizer state consumed in the same apply region), the group adopts the
param's strategy. In/out affinity for elementwise ops is already implicit in
the transfer functions."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set

import torch.fx as fx

from tepdist_tpu_torch.graph.fx_graph import FxGraph, var_shape
from tepdist_tpu_torch.parallel.cost_spmd_strategy import GraphStrategy
from tepdist_tpu_torch.parallel.resolve_utils import resolve_forward_backward_apply

Var = fx.Node


def build_affinity_groups(
    graph: FxGraph,
    state_alias: Optional[Dict[int, int]] = None,
) -> List[List[int]]:
    """Group state invars: a param with every same-shaped state invar that
    shares an apply-region consumer chain (Adam m/v, master copies)."""
    rr = resolve_forward_backward_apply(graph, state_alias=state_alias)
    invar_index = {v: i for i, v in enumerate(graph.invars)}
    state_set = {ii for ii in (state_alias or {}).values() if ii >= 0}
    if not state_set and state_alias is None:
        state_set = set(invar_index.values())

    # Update region: everything outside the forward. Connected components of
    # this region identify per-leaf optimizer chains — with SCALAR nodes
    # removed from connectivity, since shared bias-correction scalars would
    # otherwise bridge every leaf's chain into one blob.
    region = {n.id for n in graph.nodes if n.id not in rr.forward_nodes}

    def is_scalar_node(nid: int) -> bool:
        node = graph.nodes[nid]
        return all(len(var_shape(ov)) == 0
                   for ov in node.outvars if ov is not None)

    comp: Dict[int, int] = {}
    for nid in sorted(region):
        if nid in comp or is_scalar_node(nid):
            continue
        stack, members = [nid], set()
        while stack:
            cur = stack.pop()
            if cur in members:
                continue
            members.add(cur)
            node = graph.nodes[cur]
            for nb in list(node.operands) + list(node.users):
                if (nb.id in region and nb.id not in members
                        and not is_scalar_node(nb.id)):
                    stack.append(nb.id)
        cid = min(members)
        for m in members:
            comp[m] = cid

    # Collect state invars touched by each component, grouped by shape.
    by_comp_shape: Dict[tuple, Set[int]] = {}
    for i in sorted(state_set):
        v = graph.invars[i]
        shape = var_shape(v)
        if not shape:
            continue  # scalar state (step counters) never groups
        for consumer in graph.arg_consumers(v):
            cid = comp.get(consumer.id)
            if cid is not None:
                by_comp_shape.setdefault((cid, shape), set()).add(i)
    groups = [sorted(g) for g in by_comp_shape.values() if len(g) > 1]
    # Deduplicate (a group may be discovered via several components).
    uniq, seen = [], set()
    for g in sorted(groups):
        key = tuple(g)
        if key not in seen:
            seen.add(key)
            uniq.append(g)
    return uniq


def unify_group_strategies(graph: FxGraph,
                           strategies: Sequence[GraphStrategy],
                           groups: List[List[int]]) -> None:
    """Post-pass: every member of a group adopts the leader's (the lowest
    index — the parameter precedes its optimizer slots in flatten order)
    strategy on every axis (reference: AUX_AFFINITY ILP terms)."""
    for gs in strategies:
        for group in groups:
            leader = graph.invars[group[0]]
            s = gs.var_strategies.get(leader)
            if s is None:
                continue
            for idx in group[1:]:
                gs.var_strategies[graph.invars[idx]] = s
