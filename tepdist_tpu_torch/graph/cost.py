"""Per-node flop/byte accounting over aten graphs.

The port of ``tepdist_tpu/graph/cost.py``. The unit of IR is a node of an
FX graph of aten ops (``graph/fx_graph.py``) instead of a jaxpr equation;
shapes and dtypes come from each node's ``meta["val"]``, the fake tensor
that capture recorded. The rules follow the reference: the contractions
(``dot_general`` there; ``mm``/``addmm``/``bmm``/``baddbmm`` here) and the
convolution cost 2 x output elements x contracted size, and everything
else one flop per output element, with memory traffic as the sum of
operand and result bytes (the HBM-bound view).

A contraction's operand layouts are free: ``dot_general`` takes its
batch and contracting dimensions as numbers, so the jaxpr holds no
equation for the reshapes, broadcasts and transposes that feed aten's
``mm``/``bmm`` or reshape its result. Those nodes (``FOLDED_VIEWS``) cost
nothing where every consumer is a contraction or another such node, and a
reshape of a contraction's result costs nothing; anywhere else they cost
one flop per output element, as a jaxpr's ``reshape`` or ``transpose``
does (``fold_view_flops``).

The flash-attention ops cost one flop per output element, as the reference
prices its ``pallas_call`` (``eqn_flops`` falls through to the elementwise
rule there). That undercounts attention on both sides alike.
"""

from __future__ import annotations

import math
from typing import Any, Iterable

import torch


def val_size(val) -> int:
    """Element count of a traced value (0 for non-tensors)."""
    if not isinstance(val, torch.Tensor):
        return 0
    return int(math.prod(val.shape)) if val.dim() else 1


def val_bytes(val) -> int:
    if not isinstance(val, torch.Tensor):
        return 0
    return val_size(val) * val.element_size()


def tensor_vals(val) -> list:
    """The tensors of one node's value: itself, or those in its tuple."""
    if isinstance(val, (tuple, list)):
        return [v for v in val if isinstance(v, torch.Tensor)]
    return [val] if isinstance(val, torch.Tensor) else []


# Ops that seed planner cones (the reference's dot_general and
# conv_general_dilated).
MATMULS = frozenset({"mm", "addmm", "bmm", "baddbmm"})
COMPUTE_INTENSIVE = MATMULS | {"convolution"}


def _lhs_of(prim: str) -> int:
    """Operand index of the contraction's left side: ``addmm`` and
    ``baddbmm`` take the bias first."""
    return 1 if prim in ("addmm", "baddbmm") else 0


def node_flops(prim: str, in_vals: Iterable[Any], out_vals) -> float:
    """Estimated FLOPs of one node from its operand and result values."""
    ins = list(in_vals)
    if prim in MATMULS:
        k = ins[_lhs_of(prim)].shape[-1]
        return 2.0 * val_size(out_vals[0]) * k
    if prim == "convolution":
        w = ins[1]
        kernel_spatial = math.prod(w.shape[2:])
        return 2.0 * val_size(out_vals[0]) * kernel_spatial * w.shape[1]
    # Elementwise / data movement / opaque: one flop per output element.
    return float(sum(val_size(v) for v in out_vals))


# Layout nodes that ``dot_general``'s dimension numbers absorb.
FOLDED_VIEWS = frozenset({"view", "_unsafe_view", "unsqueeze", "expand",
                          "permute", "t"})
_RESHAPES = frozenset({"view", "_unsafe_view"})
_TRANSPOSES = frozenset({"permute", "t"})
_BATCHED_MATMULS = frozenset({"bmm", "baddbmm"})


def fold_view_flops(nodes, users) -> None:
    """Zero the flops of the ``FOLDED_VIEWS`` nodes among ``nodes`` (in
    topological order) that only lay out a contraction's operands, or its
    result; ``users(node)`` are a node's consumers. A transpose keeps its
    price next to a plain ``mm``: the jaxpr writes ``x @ w.T`` with a
    ``transpose`` equation too, where an ``einsum``'s batched contraction
    absorbs its operands' and its result's permutations."""
    def layout_ok(n, contractions) -> bool:
        return n.prim not in _TRANSPOSES or contractions <= _BATCHED_MATMULS

    feeds: dict = {}     # node id -> the contractions its chain feeds
    for n in reversed(nodes):
        if n.prim not in FOLDED_VIEWS:
            continue
        reach = set()
        for u in users(n):
            if u.prim in MATMULS:
                reach.add(u.prim)
            elif u.id in feeds:
                reach |= feeds[u.id]
            else:
                reach = None
                break
        if reach and layout_ok(n, reach):
            feeds[n.id] = reach
            n.flops = 0.0
    source: dict = {}    # node id -> the contraction its result chain left
    for n in nodes:
        if n.prim not in FOLDED_VIEWS or len(n.operands) != 1:
            continue
        op = n.operands[0]
        src = op.prim if op.prim in MATMULS else source.get(op.id)
        if src is not None and layout_ok(n, {src}):
            source[n.id] = src
            n.flops = 0.0


def node_bytes(in_vals: Iterable[Any], out_vals) -> float:
    """HBM traffic estimate: operands read + results written."""
    return float(sum(val_bytes(v) for v in in_vals)
                 + sum(val_bytes(v) for v in out_vals))
