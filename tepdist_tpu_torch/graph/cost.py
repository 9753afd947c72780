"""Per-node flop/byte accounting over aten graphs.

The port of ``tepdist_tpu/graph/cost.py``. The unit of IR is a node of an
FX graph of aten ops (``graph/fx_graph.py``) instead of a jaxpr equation;
shapes and dtypes come from each node's ``meta["val"]``, the fake tensor
that capture recorded. The rules follow the reference: the contractions
(``dot_general`` there; ``mm``/``addmm``/``bmm``/``baddbmm`` here) and the
convolution cost 2 x output elements x contracted size, and everything
else one flop per output element, with memory traffic as the sum of
operand and result bytes (the HBM-bound view).

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


def node_bytes(in_vals: Iterable[Any], out_vals) -> float:
    """HBM traffic estimate: operands read + results written."""
    return float(sum(val_bytes(v) for v in in_vals)
                 + sum(val_bytes(v) for v in out_vals))
