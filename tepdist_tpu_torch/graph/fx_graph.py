"""Dataflow-graph view over an FX graph of aten ops: the planner's IR.

The port of ``tepdist_tpu/graph/jaxpr_graph.py``. The JAX package traces
the training step to a jaxpr (``jax.make_jaxpr`` over ``value_and_grad``);
the port captures the joint forward and backward with
``torch.fx.experimental.proxy_tensor.make_fx`` on fake tensors, which
records the aten ops that autograd runs, the flash-attention ops
(``tepdist::flash_fwd``/``flash_dq``/``flash_dkv``) among them, each with
its fake output in ``node.meta["val"]``. Capture allocates no device
memory: real tensors enter through the fake mode, so a step at full size
costs host time only.

What the reference's inlining pass does (flattening ``pjit``, custom VJPs
and remat into one equation list) capture does by itself: checkpointed
regions appear as their forward ops and, in the backward, their
recomputation. One thing is removed: ``aten.detach``, the identity that
the port's ``value_and_grad`` (``detach().requires_grad_()`` on each leaf)
leaves behind and the reference's has no counterpart of.

The models' tanh GELU and SiLU appear at the reference's granularity, as
the chains of primitives of ``jax.nn.gelu`` and ``jax.nn.silu`` whose
intermediates the backward keeps (``ops/activations.py`` runs the chains
on fake tensors); the step itself runs the fused ops.

A value ("var") is an ``fx.Node`` whose ``meta["val"]`` is a tensor. A
multi-output op is one :class:`GraphNode` whose ``outvars`` are the
``getitem`` nodes that read its outputs (``None`` where an output is
unused, the jaxpr's ``DropVar``).
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.fx as fx

from tepdist_tpu_torch.core.tree import (tree_leaves, tree_structure,
                                         tree_unflatten)
from tepdist_tpu_torch.graph.cost import (COMPUTE_INTENSIVE,
                                          fold_view_flops, node_bytes,
                                          node_flops, tensor_vals, val_bytes)

Var = fx.Node


def op_name(target) -> str:
    """The op's name without namespace or overload: ``aten.mm.default`` ->
    ``mm``, ``tepdist.flash_fwd.default`` -> ``flash_fwd``."""
    if isinstance(target, torch._ops.OpOverload):
        return target._opname
    return getattr(target, "__name__", str(target))


def flat_vars(args) -> List[Var]:
    """The ``fx.Node`` entries of an argument tuple, lists flattened, in
    order (a node's tensor operands: its ``invars``)."""
    out: List[Var] = []
    for a in args:
        if isinstance(a, fx.Node):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(flat_vars(a))
    return out


@dataclasses.dataclass(eq=False)
class GraphNode:
    """One aten call plus planner metadata (the jaxpr equation's
    counterpart: ``eqn`` is the ``fx.Node``)."""

    id: int
    eqn: fx.Node
    prim: str
    invars: List[Var]
    outvars: List[Optional[Var]]
    out_vals: List[Any]
    flops: float = 0.0
    bytes: float = 0.0
    operands: List["GraphNode"] = dataclasses.field(default_factory=list)
    users: List["GraphNode"] = dataclasses.field(default_factory=list)
    # Ranks filled by FxGraph.compute_ranks (reference: SketchNode asap/alap).
    asap: int = 0
    alap: int = 0
    stage: int = -1

    @property
    def target(self):
        return self.eqn.target

    @property
    def args(self):
        return self.eqn.args

    @property
    def kwargs(self):
        return self.eqn.kwargs

    def out_bytes(self) -> float:
        return float(sum(val_bytes(v) for v in self.out_vals))

    def is_compute_intensive(self) -> bool:
        return self.prim in COMPUTE_INTENSIVE

    def __hash__(self):
        return self.id

    def __repr__(self):
        return f"<{self.id}:{self.prim}>"


def var_val(v) -> Any:
    """The traced value of a var (a fake tensor), or None."""
    return v.meta.get("val") if isinstance(v, fx.Node) else None


def var_shape(v) -> Tuple[int, ...]:
    """The shape of a var's value (``()`` for a non-tensor): the jaxpr
    var's ``aval.shape``."""
    val = var_val(v)
    return tuple(val.shape) if isinstance(val, torch.Tensor) else ()


def var_bytes(v) -> int:
    """Bytes of a var's value: the reference's ``aval_bytes(v.aval)``."""
    return val_bytes(var_val(v))


class FxGraph:
    """Operand/user adjacency + costs over a captured aten graph."""

    def __init__(self, gm: fx.GraphModule):
        self.gm = gm
        graph = gm.graph
        self.invars: List[Var] = [n for n in graph.nodes
                                  if n.op == "placeholder"]
        # Tensor constants of the capture (``get_attr`` nodes): the
        # jaxpr's constvars.
        self.constvars: List[Var] = []
        for n in graph.nodes:
            if n.op != "get_attr":
                continue
            if "val" not in n.meta:
                n.meta["val"] = getattr(gm, n.target)
            if isinstance(n.meta["val"], torch.Tensor):
                self.constvars.append(n)
        out_node = next(n for n in reversed(graph.nodes) if n.op == "output")
        self.outvars: List[Optional[Var]] = [
            a if isinstance(a, fx.Node) else None
            for a in tree_leaves(list(out_node.args[0]))]

        self.nodes: List[GraphNode] = []
        self.producer: Dict[Var, Tuple[GraphNode, int]] = {}
        self.consumers: Dict[Var, List[GraphNode]] = {}
        by_fx: Dict[fx.Node, GraphNode] = {}
        tensor_index: Dict[fx.Node, Dict[int, int]] = {}
        for n in graph.nodes:
            if n.op != "call_function":
                continue
            if n.target is operator.getitem:
                parent = by_fx[n.args[0]]
                # The index among the parent's tensor outputs (a tuple
                # output may hold None, e.g. an unneeded input gradient).
                idx = tensor_index[n.args[0]].get(n.args[1])
                if idx is not None:
                    parent.outvars[idx] = n
                    self.producer[n] = (parent, idx)
                continue
            val = n.meta.get("val")
            outs = tensor_vals(val)
            multi = isinstance(val, (tuple, list))
            if multi:
                tensor_index[n] = {
                    i: k for k, i in enumerate(
                        i for i, v in enumerate(val)
                        if isinstance(v, torch.Tensor))}
            invars = flat_vars(n.args) + flat_vars(tuple(n.kwargs.values()))
            in_vals = [var_val(a) for a in invars]
            prim = op_name(n.target)
            node = GraphNode(
                id=len(self.nodes), eqn=n, prim=prim, invars=invars,
                outvars=[None] * len(outs) if multi else [n],
                out_vals=outs,
                flops=node_flops(prim, in_vals, outs),
                bytes=node_bytes([v for v in in_vals
                                  if isinstance(v, torch.Tensor)], outs))
            self.nodes.append(node)
            by_fx[n] = node
            if not multi and outs:
                self.producer[n] = (node, 0)
        for node in self.nodes:
            seen = set()
            for a in node.invars:
                self.consumers.setdefault(a, []).append(node)
                if a in self.producer:
                    op = self.producer[a][0]
                    if op.id not in seen:
                        seen.add(op.id)
                        node.operands.append(op)
                        op.users.append(node)
        fold_view_flops(self.nodes, lambda n: n.users)
        self.compute_ranks()

    # -- queries ----------------------------------------------------------
    def total_flops(self) -> float:
        return float(sum(n.flops for n in self.nodes))

    def compute_intensive_nodes(self) -> List[GraphNode]:
        return [n for n in self.nodes if n.is_compute_intensive()]

    def arg_consumers(self, invar: Var) -> List[GraphNode]:
        return self.consumers.get(invar, [])

    def compute_ranks(self) -> None:
        """ASAP/ALAP levels (reference: GraphSketch rank computation)."""
        for n in self.nodes:  # nodes are in topological (program) order
            n.asap = 1 + max((op.asap for op in n.operands), default=-1)
        max_rank = max((n.asap for n in self.nodes), default=0)
        for n in reversed(self.nodes):
            n.alap = min((u.alap - 1 for u in n.users), default=max_rank)

    def var_aval(self, v) -> Any:
        return var_val(v)

    def count(self, prim: str) -> int:
        return sum(1 for n in self.nodes if n.prim == prim)

    def __len__(self):
        return len(self.nodes)


def _drop_detach(gm: fx.GraphModule) -> None:
    detach = torch.ops.aten.detach.default
    for n in list(gm.graph.nodes):
        if n.op == "call_function" and n.target is detach:
            n.replace_all_uses_with(n.args[0])
            gm.graph.erase_node(n)
    gm.recompile()


def _mutates(n: fx.Node) -> bool:
    schema = getattr(n.target, "_schema", None)
    return schema is not None and schema.is_mutable


def _functionalize(gm: fx.GraphModule, leaves) -> fx.GraphModule:
    """The value-semantics form of a captured step that updates state in
    place: each input mutation becomes an output value (the step returns
    its state leaves), and the copies back into the inputs that
    ``torch.func.functionalize`` appends are dropped, so the graph is a
    pure function of its placeholders, as a jaxpr is. The functional
    ``copy(dst, src)`` it leaves (an in-place ``copy_`` of a whole
    tensor) becomes a cast of ``src`` to ``dst``'s dtype, and
    ``lift_fresh_copy`` a ``clone``."""
    from torch.func import functionalize
    from torch.fx.experimental.proxy_tensor import make_fx

    aten = torch.ops.aten
    fgm = make_fx(functionalize(gm, remove="mutations"),
                  tracing_mode="fake")(*leaves)
    graph = fgm.graph
    for n in list(graph.nodes):
        if n.op != "call_function":
            continue
        if n.target is aten.copy_.default and n.args[0].op == "placeholder":
            if n.users:
                n.replace_all_uses_with(n.args[1])
            graph.erase_node(n)
        elif n.target is aten.copy.default:
            dst, src = n.args[0], n.args[1]
            if tuple(var_shape(dst)) != tuple(var_shape(src)):
                raise NotImplementedError(
                    "functional copy with a broadcast source")
            with graph.inserting_before(n):
                new = graph.call_function(
                    aten._to_copy.default, (src,),
                    {"dtype": var_val(dst).dtype})
            new.meta = dict(n.meta)
            n.replace_all_uses_with(new)
            graph.erase_node(n)
        elif n.target is aten.lift_fresh_copy.default:
            n.target = aten.clone.default
    fgm.recompile()
    return fgm


def trace_graph(fn, *example_args, functional: bool = False,
                **example_kwargs):
    """Capture ``fn`` to an :class:`FxGraph` plus the I/O tree structures.

    ``fn`` is called on fake tensors made from ``example_args`` (through
    ``make_fx(tracing_mode="fake")``, which converts each real input with
    ``FakeTensorMode.from_tensor``), so nothing runs and no device memory
    is allocated. The graph's placeholders are the flat leaves of
    ``(example_args, example_kwargs)`` in the reference's flat order
    (``core/tree.py`` flattens as ``jax.tree_util`` does), and its outputs
    the flat leaves of ``fn``'s result.

    ``functional=True`` is for a step that updates its inputs in place
    (the port's optimizers do): the graph is captured again through
    ``torch.func.functionalize`` (:func:`_functionalize`), so every state
    update is an output value and no node mutates, as in the reference's
    jaxpr of a step that returns new state. The first capture records
    autograd's backward as aten ops, which the second pass can take.
    """
    from torch.fx.experimental.proxy_tensor import make_fx

    template = tree_structure((example_args, example_kwargs))
    out_tree: List[Any] = []

    def flat_fn(*leaves):
        args, kwargs = tree_unflatten(template, list(leaves))
        out = fn(*args, **kwargs)
        out_tree.append(tree_structure(out))
        return tree_leaves(out)

    leaves = tree_leaves((example_args, example_kwargs))
    gm = make_fx(flat_fn, tracing_mode="fake")(*leaves)
    if functional and any(n.op == "call_function" and _mutates(n)
                          for n in gm.graph.nodes):
        gm = _functionalize(gm, leaves)
    _drop_detach(gm)
    return FxGraph(gm), template, out_tree[0]
