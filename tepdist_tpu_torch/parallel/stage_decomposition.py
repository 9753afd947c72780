"""Stage decomposition: physically split the forward graph into per-stage
modules: the port of ``tepdist_tpu/parallel/stage_decomposition.py``.

Reference parity: ``StageDecomposition`` (reference:
service/parallel/stage_decomposition.{h,cc}) splits CG/GA/GAInit/AG
computations into ``*_SLICE`` DefContexts per pipeline stage and wires
``input_def_map_`` (arg <- (prev_stage, out_idx)) across stages. Here the
split operates on the captured forward aten graph (``graph/fx_graph.py``):
each ``StageModule`` records its nodes, its external inputs (graph args and
activations) and an ``input_def_map`` identical in role to the reference's,
and :meth:`StageDecomposition.stage_fn` cuts it out as an
``fx.GraphModule``. A ``getitem`` goes with the node it reads, and a stage
carries the ``get_attr`` constants it reads (the jaxpr's constvars).

Backward stages are not carved from a traced backward graph: stage i's
backward runs stage i's forward module again under autograd
(:func:`tepdist_tpu_torch.parallel.pipeline.stage_vjp`), as the
reference's ``jax.vjp`` of the stage forward recomputes it, and emits
cotangents for exactly the activation edges ``input_def_map`` records.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Dict, List, Optional, Tuple

import torch
import torch.fx as fx

from tepdist_tpu_torch.graph.fx_graph import FxGraph, GraphNode, Var, var_bytes


@dataclasses.dataclass
class StageModule:
    """One pipeline stage of the forward graph (a *_SLICE DefContext)."""

    stage_id: int
    eqns: List[GraphNode]
    invars: List[Var]                 # external inputs, fixed order
    outvars: List[Var]                # produced here, consumed downstream
    # Tensor constants (``get_attr`` nodes) the stage reads.
    constvars: List[Var] = dataclasses.field(default_factory=list)
    # arg position -> ("arg", graph invar index) | ("stage", src_stage, out_idx)
    input_def_map: Dict[int, Tuple] = dataclasses.field(default_factory=dict)
    # graph outvar index -> position in self.outvars
    graph_out_map: Dict[int, int] = dataclasses.field(default_factory=dict)

    def param_positions(self) -> List[int]:
        return [i for i, src in self.input_def_map.items() if src[0] == "arg"]

    def activation_positions(self) -> List[int]:
        return [i for i, src in self.input_def_map.items() if src[0] == "stage"]


def _owner(n: fx.Node) -> fx.Node:
    """The node whose GraphNode holds ``n``: a ``getitem`` belongs to the
    multi-output node it reads."""
    if n.op == "call_function" and n.target is operator.getitem:
        return n.args[0]
    return n


class StageDecomposition:
    """Split a (forward) FxGraph by a per-node stage assignment."""

    def __init__(self, graph: FxGraph, stage_assignment, num_stages: int):
        self.graph = graph
        self.assignment = list(stage_assignment)
        self.num_stages = num_stages
        self.stages: List[StageModule] = []
        self._consts = set(graph.constvars)
        self._build()

    def _build(self) -> None:
        g = self.graph
        invar_index = {v: i for i, v in enumerate(g.invars)}
        produced_by: Dict[Var, Tuple[int, int]] = {}  # var -> (stage, out_idx)
        graph_out_index: Dict[Var, List[int]] = {}
        for oi, a in enumerate(g.outvars):
            if a is not None:
                graph_out_index.setdefault(a, []).append(oi)

        for s in range(self.num_stages):
            nodes = [n for n in g.nodes if self.assignment[n.id] == s]
            produced_here = {ov for n in nodes for ov in n.outvars
                             if ov is not None}
            # External inputs in first-use order; constants apart.
            invars: List[Var] = []
            consts: List[Var] = []
            seen = set()
            for n in nodes:
                for a in n.invars:
                    if a in produced_here or a in seen:
                        continue
                    seen.add(a)
                    (consts if a in self._consts else invars).append(a)
            module = StageModule(stage_id=s, eqns=nodes, invars=invars,
                                 outvars=[], constvars=consts)
            for pos, v in enumerate(invars):
                if v in invar_index:
                    module.input_def_map[pos] = ("arg", invar_index[v])
                elif v in produced_by:
                    src_stage, out_idx = produced_by[v]
                    module.input_def_map[pos] = ("stage", src_stage, out_idx)
                else:
                    raise ValueError(
                        f"stage {s} input {v} produced by a LATER stage — "
                        "stage assignment violates precedence")
            # Outputs: consumed by later stages or graph outputs.
            later_consumers = set()
            for n in g.nodes:
                if self.assignment[n.id] > s:
                    later_consumers.update(n.invars)
            for n in nodes:
                for ov in n.outvars:
                    if ov is None:
                        continue
                    if ov in later_consumers or ov in graph_out_index:
                        out_idx = len(module.outvars)
                        module.outvars.append(ov)
                        produced_by[ov] = (s, out_idx)
                        for oi in graph_out_index.get(ov, []):
                            module.graph_out_map[oi] = out_idx
            self.stages.append(module)

    # ------------------------------------------------------------------
    def stage_fn(self, s: int,
                 device: Optional[torch.device] = None) -> fx.GraphModule:
        """Stage ``s`` as an ``fx.GraphModule``: ``(*invars) ->
        tuple(outvars)``. With ``device``, every ``device=`` argument the
        capture baked into a node (factory ops such as ``ones``, ``zeros``,
        ``arange``) and every constant the stage reads is moved there, so a
        stage never runs on the capture's device by accident."""
        m = self.stages[s]
        in_stage = {n.eqn for n in m.eqns}
        graph = fx.Graph()
        env: Dict[fx.Node, fx.Node] = {}
        for v in m.invars:
            env[v] = graph.placeholder(v.name)
            env[v].meta = dict(v.meta)
        for c in m.constvars:
            env[c] = graph.get_attr(c.target)
            env[c].meta = dict(c.meta)
        for n in self.graph.gm.graph.nodes:
            if n.op != "call_function" or _owner(n) not in in_stage:
                continue
            new = graph.node_copy(n, lambda a: env[a])
            if device is not None and isinstance(
                    new.kwargs.get("device"), torch.device):
                new.kwargs = {**new.kwargs, "device": device}
            env[n] = new
        graph.output(tuple(env[v] for v in m.outvars))
        gm = fx.GraphModule(self.graph.gm, graph)
        if device is not None:
            for c in m.constvars:
                setattr(gm, c.target, getattr(gm, c.target).to(device))
        return gm

    def forward_fns(self) -> List[fx.GraphModule]:
        return [self.stage_fn(s) for s in range(self.num_stages)]

    def cross_stage_bytes(self) -> float:
        """Activation traffic of the cut (reference CollectCrossStageInsts)."""
        total = 0.0
        for m in self.stages:
            for pos in m.activation_positions():
                total += var_bytes(m.invars[pos])
        return total
