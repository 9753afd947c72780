"""Per-op forward/backward DimStrategy transfer functions over aten nodes.

The port of ``tepdist_tpu/parallel/strategy_utils.py`` (reference parity:
``StrategyUtil``'s ``Infer*`` / ``BackInfer*`` per-opcode propagation and
the ``GenSplitProposals`` / ``GenDotProposals`` / ``GenConvProposals``
generators, service/parallel/utils.{h,cc}). The rules take a
:class:`~tepdist_tpu_torch.graph.fx_graph.GraphNode` of a captured aten
graph where the JAX package takes a jaxpr equation; operand ``i`` is the
node's ``invars[i]``, its tensor arguments in order.

All rules reason about ONE mesh axis at a time ("split ordinal"), exactly
like the reference.

Core abstraction: most ops are *dim-mapping* ops — each operand dim either
maps to an output dim or disappears. Forward/backward inference then
reduces to map application/inversion. The contractions (``mm``, ``bmm``,
``addmm``, ``baddbmm``), the convolution and the reductions get bespoke
rules (partial-sum semantics).

Where aten differs from a jaxpr:

- Broadcasting is implicit. An elementwise operand dim that is missing or
  of size 1 where the output's is larger maps to no output dim, so an
  output split leaves that operand replicated: the meaning of the
  reference's ``broadcast_in_dim`` rule. (The reference's elementwise rule
  assumes equal shapes and gives up on a size-1 dim; under jax 0.9 jaxprs
  carry such implicit broadcasts, ROADMAP fault C4.)
- ``x @ w`` on a 3-D ``x`` is ``view`` + ``mm`` + ``view``, so a reshape
  maps the majormost dim of each merged or split group of dims (the batch
  dim of ``[B, T, D] -> [B*T, D]``), not only dims that survive whole.
- The flash-attention ops (``tepdist::flash_fwd``, ``flash_dq``,
  ``flash_dkv``) map dim 0 (batch x head) of every tensor operand and
  output through and keep the other dims whole. ``n_head`` on the node
  says where the batch ends, so a split of dim 0 must fall at multiples of
  it: a split of the batch. The reference has no rule for its
  ``pallas_call``, so there a split stops at the kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from tepdist_tpu_torch.core.dist_spec import DimStrategy
from tepdist_tpu_torch.graph.fx_graph import GraphNode, var_val


@dataclasses.dataclass
class InferResult:
    """A consistent one-axis assignment for every operand and output of a
    node. ``in_strategies[i] is None`` means operand i is a 0-d tensor that
    needs no strategy."""

    in_strategies: List[Optional[DimStrategy]]
    out_strategies: List[DimStrategy]
    # Communication this assignment implies on the *output* (e.g. partial →
    # psum later). Purely informational; cost comes from performance_utils.
    partial_output: bool = False


# --------------------------------------------------------------------------
# Op sets (by aten op name, overload dropped)
# --------------------------------------------------------------------------

# Copies and dtype casts: elementwise, but not tagged pointwise in aten.
COPIES = {"clone", "_to_copy", "lift_fresh_copy", "alias", "detach",
          "copy"}

RESHAPES = {"view", "_unsafe_view", "reshape", "squeeze", "unsqueeze"}

REDUCE_PARTIAL = {"sum", "mean", "prod"}  # split reduced dim -> partial
REDUCE_NONLINEAR = {"amax", "amin", "argmax", "argmin", "logsumexp", "var"}

# Ops that produce fresh values with no operand coupling: any split of the
# output is legal (each shard generates its slice). The ``*_like`` and
# ``new_*`` ops read only their operand's shape, as the reference's
# broadcast of a literal does.
GENERATIVE = {"full", "zeros", "ones", "empty", "arange", "scalar_tensor",
              "rand", "randn", "randint", "randperm", "normal",
              "zeros_like", "ones_like", "full_like", "empty_like",
              "rand_like", "randn_like", "randint_like",
              "new_zeros", "new_ones", "new_full", "new_empty"}

OPAQUE = {"sort", "topk", "cumsum", "cumprod", "cummax", "cummin"}

# The flash-attention ops: [B*H, T, ...] operands and outputs, dim 0
# mapped through (``n_head``, their last argument, is H). The sequence
# ops (``tepdist::seq_attn``, ``seq_attn_bwd``; ``ops/ring_attention.py``)
# take [B*H, T, D] or [B, H, T, D] and map dim 0 the same way; their
# sequence dim is the ``seq`` axis's, seeded by
# ``attention_motif.build_anchored_seq_strategy``.
FLASH = {"flash_fwd", "flash_dq", "flash_dkv", "seq_attn", "seq_attn_bwd"}
_N_HEAD_ARG = {"seq_attn": 5, "seq_attn_bwd": 9}

# Ops that apply along one dim and map the others through.
ROWWISE = {"_softmax", "_log_softmax"}
ROWWISE_BACKWARD = {"_softmax_backward_data", "_log_softmax_backward_data"}


def _val_shape(v) -> Tuple[int, ...]:
    val = var_val(v)
    return tuple(val.shape) if isinstance(val, torch.Tensor) else ()


def _shape(node: GraphNode, i: int) -> Tuple[int, ...]:
    return _val_shape(node.invars[i])


def _out_shape(node: GraphNode, i: int = 0) -> Tuple[int, ...]:
    return tuple(node.out_vals[i].shape) if node.out_vals else ()


def _is_scalar(v) -> bool:
    return len(_val_shape(v)) == 0


def _divisible(shape: Tuple[int, ...], dim: int, n: int) -> bool:
    return 0 <= dim < len(shape) and shape[dim] % n == 0 and shape[dim] >= n


def _arg(node: GraphNode, pos: int, name: str, default=None):
    if len(node.args) > pos:
        return node.args[pos]
    return node.kwargs.get(name, default)


def _norm(dim: int, ndim: int) -> int:
    return dim + ndim if dim < 0 else dim


def is_elementwise(node: GraphNode) -> bool:
    target = node.target
    if node.prim in COPIES:
        return True
    return (isinstance(target, torch._ops.OpOverload)
            and torch.Tag.pointwise in target.tags)


# --------------------------------------------------------------------------
# Dim maps: operand_dim -> out_dim (single-output ops)
# --------------------------------------------------------------------------

def _broadcast_map(in_shape, out_shape) -> Dict[int, int]:
    """Operand dims aligned from the right; a dim maps only where its size
    equals the output's (a size-1 or missing dim is broadcast)."""
    off = len(out_shape) - len(in_shape)
    return {i: i + off for i in range(len(in_shape))
            if in_shape[i] == out_shape[i + off]}


def _identity_except(ndim: int, skip: Sequence[int]) -> Dict[int, int]:
    return {i: i for i in range(ndim) if i not in skip}


def dim_maps(node: GraphNode) -> Optional[List[Dict[int, int]]]:
    """Per-operand mapping operand_dim → output_dim for mapping-style ops.
    Returns None if the op needs bespoke handling (or has no rule)."""
    name = node.prim
    out_shape = _out_shape(node)
    shapes = [_val_shape(a) for a in node.invars]

    if is_elementwise(node):
        return [_broadcast_map(s, out_shape) for s in shapes]

    if name == "expand":
        return [_broadcast_map(shapes[0], out_shape)]

    if name in RESHAPES:
        return [_reshape_map(shapes[0], out_shape)]

    if name == "t":
        return [{0: 1, 1: 0} if len(shapes[0]) == 2 else {0: 0}]

    if name == "transpose":
        nd = len(shapes[0])
        d0, d1 = _norm(node.args[1], nd), _norm(node.args[2], nd)
        m = {i: i for i in range(nd)}
        m[d0], m[d1] = d1, d0
        return [m]

    if name == "permute":
        nd = len(shapes[0])
        perm = [_norm(d, nd) for d in node.args[1]]
        return [{src: i for i, src in enumerate(perm)}]

    if name == "cat":
        nd = len(out_shape)
        cdim = _norm(_arg(node, 1, "dim", 0), nd)
        return [_identity_except(len(s), [cdim]) for s in shapes]

    if name == "stack":
        nd = len(out_shape)
        sdim = _norm(_arg(node, 1, "dim", 0), nd)
        return [{i: (i if i < sdim else i + 1) for i in range(len(s))}
                for s in shapes]

    if name in ("slice", "split", "split_with_sizes", "chunk"):
        # Dims left whole map through; the sliced/split dim doesn't.
        in_shape = shapes[0]
        return [{i: i for i in range(len(in_shape))
                 if all(i < len(o.shape) and o.shape[i] == in_shape[i]
                        for o in node.out_vals)}]

    if name in ("select", "unbind"):
        nd = len(shapes[0])
        dim = _norm(_arg(node, 1, "dim", 0), nd)
        return [{i: (i if i < dim else i - 1) for i in range(nd) if i != dim}]

    if name == "embedding":
        # Embedding lookup: the indices' dims map to the same output dims;
        # the table is replicated (as the reference's gather rule).
        return [{}, {i: i for i in range(len(shapes[1]))}]

    if name == "index":
        # ``table[idx]``: only the embedding pattern, one index tensor on
        # dim 0 of a 2-D table; other indexing stays without a rule.
        indices = node.args[1]
        if (len(shapes) == 2 and len(shapes[0]) == 2 and len(indices) == 1
                and indices[0] is not None):
            return [{}, {i: i for i in range(len(shapes[1]))}]
        return None

    if name == "gather":
        nd = len(shapes[0])
        dim = _norm(node.args[1], nd)
        return [{i: i for i in range(nd)
                 if i != dim and shapes[0][i] == out_shape[i]},
                _identity_except(len(shapes[1]), [dim])]

    if name in ("scatter_add", "scatter"):
        nd = len(out_shape)
        dim = _norm(node.args[1], nd)
        return [_identity_except(nd, [dim])] + [
            {i: i for i in range(len(s)) if i != dim and s[i] == out_shape[i]}
            for s in shapes[1:]]

    if name == "select_backward":
        nd = len(out_shape)
        dim = _norm(node.args[2], nd)
        return [{i: (i if i < dim else i + 1) for i in range(nd - 1)}]

    if name == "slice_backward":
        g = shapes[0]
        return [{i: i for i in range(len(g)) if g[i] == out_shape[i]}]

    if name in ROWWISE:
        nd = len(out_shape)
        return [_identity_except(nd, [_norm(node.args[1], nd)])]

    if name in ROWWISE_BACKWARD:
        nd = len(out_shape)
        dim = _norm(node.args[2], nd)
        return [_identity_except(nd, [dim]) for _ in shapes]

    if name in ("tril", "triu"):
        return [{i: i for i in range(len(out_shape) - 2)}]

    if name in FLASH:
        return [{0: 0} for _ in shapes]

    if name == "constant_pad_nd":
        # ``pad`` lists (before, after) pairs from the last dim backwards
        # (the explicit padding of a SAME convolution, which a jaxpr keeps
        # inside the conv); the dims it leaves alone map through.
        nd = len(shapes[0])
        pad = list(node.args[1])
        padded = {nd - 1 - i // 2 for i in range(len(pad)) if pad[i]}
        return [_identity_except(nd, padded)]

    return None


def flash_splits(node: GraphNode, num_splits: int) -> bool:
    """Whether a flash op's dim 0 splits ``num_splits`` ways at whole
    batch rows (multiples of its ``n_head`` where dim 0 is B*H)."""
    rows = _out_shape(node)[0]
    per_row = int(node.args[_N_HEAD_ARG.get(node.prim, -1)])
    if len(_out_shape(node)) == 4:
        per_row = 1                  # [B, H, T, D]: dim 0 is the batch
    return rows % (num_splits * per_row) == 0


def _reshape_map(src: Tuple[int, ...], dst: Tuple[int, ...]) -> Dict[int, int]:
    """Map each group of src dims to the group of dst dims it reshapes to
    (equal products), through the majormost dims of size > 1 of the two
    groups: splitting those n ways cuts the group's flat index range into
    the same n contiguous pieces on both sides. A dim that survives whole
    is a group of its own."""
    m: Dict[int, int] = {}
    i = j = 0
    while i < len(src) and j < len(dst):
        gi, gj = i, j
        ps, pd = src[i], dst[j]
        i, j = i + 1, j + 1
        while ps != pd and (i < len(src) or j < len(dst)):
            if (ps < pd and i < len(src)) or j >= len(dst):
                ps *= src[i]
                i += 1
            else:
                pd *= dst[j]
                j += 1
        a = next((d for d in range(gi, i) if src[d] > 1), None)
        b = next((d for d in range(gj, j) if dst[d] > 1), None)
        if a is not None and b is not None:
            m[a] = b
    return m


# --------------------------------------------------------------------------
# Contraction helpers
# --------------------------------------------------------------------------

def dot_dims(node: GraphNode):
    """Dim numbers of a contraction, in the reference's form, plus the
    operand indices of its two sides and of an added bias (or None)."""
    name = node.prim
    bias = 0 if name in ("addmm", "baddbmm") else None
    lhs_i = 1 if bias is not None else 0
    rhs_i = lhs_i + 1
    if name in ("mm", "addmm"):
        lb, rb, lc, rc = [], [], [1], [0]
    else:  # bmm, baddbmm
        lb, rb, lc, rc = [0], [0], [2], [1]
    lhs_shape, rhs_shape = _shape(node, lhs_i), _shape(node, rhs_i)
    lhs_free = [d for d in range(len(lhs_shape)) if d not in lc and d not in lb]
    rhs_free = [d for d in range(len(rhs_shape)) if d not in rc and d not in rb]
    # Output layout: batch dims, then lhs free, then rhs free.
    out_of_lhs = {}
    out_of_rhs = {}
    for k, (ld, rd) in enumerate(zip(lb, rb)):
        out_of_lhs[ld] = k
        out_of_rhs[rd] = k
    for n, d in enumerate(lhs_free):
        out_of_lhs[d] = len(lb) + n
    for n, d in enumerate(rhs_free):
        out_of_rhs[d] = len(lb) + len(lhs_free) + n
    return {
        "lhs": lhs_i, "rhs": rhs_i, "bias": bias,
        "lc": lc, "rc": rc, "lb": lb, "rb": rb,
        "lhs_free": lhs_free, "rhs_free": rhs_free,
        "out_of_lhs": out_of_lhs, "out_of_rhs": out_of_rhs,
    }


# Convolution layout (aten): input [N, C, spatial...], weight
# [O, C/groups, kernel...], bias [O], output [N, O, spatial...].
_LHS_BATCH, _LHS_FEAT, _RHS_OFEAT, _RHS_IFEAT = 0, 1, 0, 1
_OUT_BATCH, _OUT_FEAT = 0, 1


# --------------------------------------------------------------------------
# StrategyUtil
# --------------------------------------------------------------------------

class StrategyUtil:
    """One-mesh-axis strategy inference over aten nodes."""

    # ---- forward --------------------------------------------------------
    @staticmethod
    def forward_infer(node: GraphNode, known: Dict[int, DimStrategy],
                      num_splits: int) -> Optional[InferResult]:
        """Given concrete strategies for a subset of operands (``known``:
        operand index → strategy), complete a consistent assignment or return
        None (meaning: a reshard would be required to use this op this way).
        Replicated inputs propagate to replicated outputs."""
        name = node.prim
        n_in = len(node.invars)
        n_out = len(node.out_vals)

        def all_replicated() -> InferResult:
            rep = DimStrategy.make_replicated(num_splits)
            return InferResult(
                in_strategies=[None if _is_scalar(a) else rep
                               for a in node.invars],
                out_strategies=[rep] * n_out,
            )

        # Anything opaque: only replicated flows through.
        if name in OPAQUE:
            if all(s.replicated or s.is_glue() for s in known.values()):
                return all_replicated()
            return None

        if name in GENERATIVE:
            return all_replicated()

        # No information: replicate.
        split_known = {i: s for i, s in known.items() if s.is_split() or s.partial}
        if not split_known:
            return all_replicated()

        if any(s.partial for s in known.values()):
            # Partial operands must be resolved (psum) before reuse except in
            # linear ops where partial-ness propagates: keep it to pure adds.
            if name == "add":
                out = DimStrategy.make_partial(num_splits)
                return InferResult(
                    in_strategies=[known.get(i, DimStrategy.make_partial(num_splits))
                                   for i in range(n_in)],
                    out_strategies=[out],
                    partial_output=True,
                )
            return None

        if name in ("mm", "addmm", "bmm", "baddbmm"):
            return StrategyUtil._forward_dot(node, split_known, num_splits)
        if name == "convolution":
            return StrategyUtil._forward_conv(node, split_known, num_splits)
        if name in REDUCE_PARTIAL or name in REDUCE_NONLINEAR:
            return StrategyUtil._forward_reduce(node, split_known, num_splits)

        maps = dim_maps(node)
        if maps is None:
            return None
        if name in FLASH and not flash_splits(node, num_splits):
            return None
        # Determine the output dim implied by each known split operand.
        out_dim = None
        for i, s in split_known.items():
            m = maps[i]
            if s.partition_dim not in m:
                return None
            od = m[s.partition_dim]
            if out_dim is None:
                out_dim = od
            elif out_dim != od:
                return None
        if out_dim is None:
            return None
        if not _divisible(_out_shape(node), out_dim, num_splits):
            return None
        out_s = DimStrategy.split_on(out_dim, num_splits)
        in_strategies: List[Optional[DimStrategy]] = []
        for i, a in enumerate(node.invars):
            if _is_scalar(a):
                in_strategies.append(None)
                continue
            inv = {v: k for k, v in maps[i].items()}
            if out_dim in inv:
                d = inv[out_dim]
                if not _divisible(_val_shape(a), d, num_splits):
                    return None
                in_strategies.append(DimStrategy.split_on(d, num_splits))
            else:
                # Operand lacks the split dim (a broadcast operand, an
                # index): must be replicated.
                in_strategies.append(DimStrategy.make_replicated(num_splits))
        # Known strategies must match what we derived.
        for i, s in known.items():
            if in_strategies[i] is not None and s.is_split():
                if in_strategies[i].partition_dim != s.partition_dim:
                    return None
        return InferResult(in_strategies=in_strategies,
                           out_strategies=[out_s] * n_out)

    @staticmethod
    def _bias_strategy(node, d, out_s: DimStrategy, num_splits):
        """The added bias of ``addmm``/``baddbmm`` under output strategy
        ``out_s`` (broadcast to the output, so replicated unless one of its
        dims maps to the split output dim)."""
        rep = DimStrategy.make_replicated(num_splits)
        if d["bias"] is None or not out_s.is_split():
            return rep
        b_shape = _shape(node, d["bias"])
        inv = {v: k for k, v in
               _broadcast_map(b_shape, _out_shape(node)).items()}
        if out_s.partition_dim in inv:
            bd = inv[out_s.partition_dim]
            if not _divisible(b_shape, bd, num_splits):
                return None
            return DimStrategy.split_on(bd, num_splits)
        return rep

    @staticmethod
    def _dot_result(node, d, l, r, o, num_splits, partial=False):
        ins: List[Optional[DimStrategy]] = [None] * len(node.invars)
        ins[d["lhs"]], ins[d["rhs"]] = l, r
        if d["bias"] is not None:
            if partial:
                return None  # bias + partial sum double-counts the bias
            b = StrategyUtil._bias_strategy(node, d, o, num_splits)
            if b is None:
                return None
            ins[d["bias"]] = b
        return InferResult(in_strategies=ins, out_strategies=[o],
                           partial_output=partial)

    @staticmethod
    def _forward_dot(node, known, num_splits) -> Optional[InferResult]:
        d = dot_dims(node)
        out_shape = _out_shape(node)
        lhs_shape, rhs_shape = _shape(node, d["lhs"]), _shape(node, d["rhs"])
        ls = known.get(d["lhs"])
        rs = known.get(d["rhs"])
        if d["bias"] is not None and d["bias"] in known:
            return None  # a split bias alone decides nothing here

        def res(l, r, o, partial=False):
            return StrategyUtil._dot_result(node, d, l, r, o, num_splits,
                                            partial)

        rep = DimStrategy.make_replicated(num_splits)

        if ls is not None and ls.is_split():
            pd = ls.partition_dim
            if pd in d["lb"]:
                k = d["lb"].index(pd)
                rd = d["rb"][k]
                if rs is not None and rs.is_split() and rs.partition_dim != rd:
                    return None
                if not _divisible(rhs_shape, rd, num_splits):
                    return None
                return res(ls, DimStrategy.split_on(rd, num_splits),
                           DimStrategy.split_on(k, num_splits))
            if pd in d["lc"]:
                k = d["lc"].index(pd)
                rd = d["rc"][k]
                if rs is not None and rs.is_split() and rs.partition_dim != rd:
                    return None
                if not _divisible(rhs_shape, rd, num_splits):
                    return None
                return res(ls, DimStrategy.split_on(rd, num_splits),
                           DimStrategy.make_partial(num_splits), partial=True)
            # lhs free dim
            if rs is not None and rs.is_split():
                # both free: 2D output tiling needs two axes; on one axis -> conflict
                return None
            od = d["out_of_lhs"][pd]
            if not _divisible(out_shape, od, num_splits):
                return None
            return res(ls, rep, DimStrategy.split_on(od, num_splits))

        if rs is not None and rs.is_split():
            pd = rs.partition_dim
            if pd in d["rb"]:
                k = d["rb"].index(pd)
                ld = d["lb"][k]
                if not _divisible(lhs_shape, ld, num_splits):
                    return None
                return res(DimStrategy.split_on(ld, num_splits), rs,
                           DimStrategy.split_on(k, num_splits))
            if pd in d["rc"]:
                k = d["rc"].index(pd)
                ld = d["lc"][k]
                if not _divisible(lhs_shape, ld, num_splits):
                    return None
                return res(DimStrategy.split_on(ld, num_splits), rs,
                           DimStrategy.make_partial(num_splits), partial=True)
            od = d["out_of_rhs"][pd]
            if not _divisible(out_shape, od, num_splits):
                return None
            return res(rep, rs, DimStrategy.split_on(od, num_splits))

        return None

    @staticmethod
    def _forward_conv(node, known, num_splits) -> Optional[InferResult]:
        lhs_shape, rhs_shape = _shape(node, 0), _shape(node, 1)
        out_shape = _out_shape(node)
        groups = _arg(node, 8, "groups", 1)
        rep = DimStrategy.make_replicated(num_splits)
        ls, rs = known.get(0), known.get(1)
        if 2 in known:
            return None

        def res(l, r, o, partial=False):
            ins: List[Optional[DimStrategy]] = [l, r] + [
                None] * (len(node.invars) - 2)
            if len(node.invars) > 2:  # bias [O]
                if partial:
                    return None
                ins[2] = (DimStrategy.split_on(0, num_splits)
                          if o.is_split() and o.partition_dim == _OUT_FEAT
                          else rep)
            return InferResult(ins, [o], partial_output=partial)

        if ls is not None and ls.is_split():
            if ls.partition_dim == _LHS_BATCH:
                if rs is not None and rs.is_split():
                    return None
                if not _divisible(out_shape, _OUT_BATCH, num_splits):
                    return None
                return res(ls, rep,
                           DimStrategy.split_on(_OUT_BATCH, num_splits))
            if ls.partition_dim == _LHS_FEAT and groups == 1:
                need = DimStrategy.split_on(_RHS_IFEAT, num_splits)
                if rs is not None and rs.is_split() and rs.partition_dim != _RHS_IFEAT:
                    return None
                if not _divisible(rhs_shape, _RHS_IFEAT, num_splits):
                    return None
                return res(ls, need, DimStrategy.make_partial(num_splits),
                           partial=True)
            return None  # spatial split: needs halo exchange, not in v1
        if rs is not None and rs.is_split():
            if rs.partition_dim == _RHS_OFEAT and groups == 1:
                if not _divisible(out_shape, _OUT_FEAT, num_splits):
                    return None
                return res(rep, rs,
                           DimStrategy.split_on(_OUT_FEAT, num_splits))
            if rs.partition_dim == _RHS_IFEAT and groups == 1:
                if not _divisible(lhs_shape, _LHS_FEAT, num_splits):
                    return None
                return res(DimStrategy.split_on(_LHS_FEAT, num_splits), rs,
                           DimStrategy.make_partial(num_splits), partial=True)
            return None
        return None

    @staticmethod
    def reduce_axes(node: GraphNode) -> Tuple[List[int], bool]:
        """(reduced dims, keepdim) of a reduction node; every dim when the
        overload or an empty dim list says so."""
        nd = len(_shape(node, 0))
        if node.prim in ("argmax", "argmin"):
            dim = _arg(node, 1, "dim", None)
            dims = list(range(nd)) if dim is None else [dim]
            keepdim = _arg(node, 2, "keepdim", False)
        else:
            dims = _arg(node, 1, "dim", None)
            if isinstance(dims, int):
                dims = [dims]
            if not dims or not isinstance(dims, (list, tuple)):
                dims = list(range(nd))
            keepdim = _arg(node, 2, "keepdim", False)
            if not isinstance(keepdim, bool):  # sum.default's dtype kwarg
                keepdim = False
        return sorted(_norm(d, nd) for d in dims), bool(keepdim)

    @staticmethod
    def _forward_reduce(node, known, num_splits) -> Optional[InferResult]:
        name = node.prim
        axes, keepdim = StrategyUtil.reduce_axes(node)
        s = known.get(0)
        if s is None or not s.is_split():
            return None
        pd = s.partition_dim
        n_out = len(node.out_vals)
        if pd in axes:
            if name in REDUCE_PARTIAL:
                return InferResult([s], [DimStrategy.make_partial(num_splits)]
                                   * n_out, partial_output=True)
            return None  # max/min over split dim needs a real collective
        out_dim = pd if keepdim else pd - sum(1 for a in axes if a < pd)
        if not _divisible(_out_shape(node), out_dim, num_splits):
            return None
        return InferResult([s], [DimStrategy.split_on(out_dim, num_splits)]
                           * n_out)

    # ---- backward -------------------------------------------------------
    @staticmethod
    def back_infer(node: GraphNode, out_strategy: DimStrategy,
                   num_splits: int) -> Optional[InferResult]:
        """Given the desired strategy of output 0, derive operand strategies.
        Returns None when the output split can't be realized locally."""
        name = node.prim
        n_out = len(node.out_vals)
        rep = DimStrategy.make_replicated(num_splits)
        if not out_strategy.is_split():
            if out_strategy.replicated:
                return InferResult(
                    [None if _is_scalar(a) else rep for a in node.invars],
                    [out_strategy] * n_out)
            return None

        if name in GENERATIVE:
            return InferResult([None for _ in node.invars],
                               [out_strategy] * n_out)

        od = out_strategy.partition_dim
        if name in ("mm", "addmm", "bmm", "baddbmm"):
            d = dot_dims(node)
            inv_l = {v: k for k, v in d["out_of_lhs"].items()}
            inv_r = {v: k for k, v in d["out_of_rhs"].items()}
            in_l = in_r = None
            if od in inv_l:
                ld = inv_l[od]
                if not _divisible(_shape(node, d["lhs"]), ld, num_splits):
                    return None
                in_l = DimStrategy.split_on(ld, num_splits)
            if od in inv_r:
                rd = inv_r[od]
                if not _divisible(_shape(node, d["rhs"]), rd, num_splits):
                    return None
                in_r = DimStrategy.split_on(rd, num_splits)
            if in_l is None and in_r is None:
                return None
            return StrategyUtil._dot_result(node, d, in_l or rep, in_r or rep,
                                            out_strategy, num_splits)

        if name == "convolution":
            if _arg(node, 8, "groups", 1) != 1 and od == _OUT_FEAT:
                return None
            bias = [rep] if len(node.invars) > 2 else []
            if od == _OUT_BATCH:
                if not _divisible(_shape(node, 0), _LHS_BATCH, num_splits):
                    return None
                return InferResult(
                    [DimStrategy.split_on(_LHS_BATCH, num_splits), rep] + bias,
                    [out_strategy])
            if od == _OUT_FEAT:
                if not _divisible(_shape(node, 1), _RHS_OFEAT, num_splits):
                    return None
                return InferResult(
                    [rep, DimStrategy.split_on(_RHS_OFEAT, num_splits)]
                    + [DimStrategy.split_on(0, num_splits)] * len(bias),
                    [out_strategy])
            return None

        if name in REDUCE_PARTIAL or name in REDUCE_NONLINEAR:
            axes, keepdim = StrategyUtil.reduce_axes(node)
            pd = od
            if not keepdim:
                for a in axes:
                    if a <= pd:
                        pd += 1
            elif pd in axes:
                return None
            if not _divisible(_shape(node, 0), pd, num_splits):
                return None
            return InferResult([DimStrategy.split_on(pd, num_splits)],
                               [out_strategy] * n_out)

        maps = dim_maps(node)
        if maps is None:
            return None
        if name in FLASH and not flash_splits(node, num_splits):
            return None
        in_strategies: List[Optional[DimStrategy]] = []
        ok = False
        for i, a in enumerate(node.invars):
            if _is_scalar(a):
                in_strategies.append(None)
                continue
            inv = {v: k for k, v in maps[i].items()}
            if od in inv:
                d_in = inv[od]
                if not _divisible(_val_shape(a), d_in, num_splits):
                    return None
                in_strategies.append(DimStrategy.split_on(d_in, num_splits))
                ok = True
            else:
                in_strategies.append(rep)
        # expand: an output dim absent from the operand map is a
        # broadcast-created (or size-1 stretched) dim — every shard computes
        # its slice locally from the replicated operand, no comm needed.
        if not ok and name == "expand":
            return InferResult(in_strategies, [out_strategy] * n_out)
        # slice_backward (the reference's ``pad``): an output split on the
        # padded dim is made locally from a replicated gradient, each shard
        # writing the part of the slice that falls in its range.
        if not ok and name == "slice_backward":
            return InferResult(in_strategies, [out_strategy] * n_out)
        if not ok:
            return None
        return InferResult(in_strategies, [out_strategy] * n_out)

    # ---- proposal generation -------------------------------------------
    @staticmethod
    def gen_proposals(node: GraphNode, num_splits: int) -> List[InferResult]:
        """Candidate one-axis strategies for a cone root (reference:
        GenDotProposals/GenConvProposals/GenSplitProposals)."""
        name = node.prim
        proposals: List[InferResult] = []
        if name in ("mm", "addmm", "bmm", "baddbmm"):
            d = dot_dims(node)
            lhs_shape = _shape(node, d["lhs"])
            for pd in d["lb"] + d["lhs_free"] + d["lc"]:
                if _divisible(lhs_shape, pd, num_splits):
                    r = StrategyUtil.forward_infer(
                        node, {d["lhs"]: DimStrategy.split_on(pd, num_splits)},
                        num_splits)
                    if r is not None:
                        proposals.append(r)
            rhs_shape = _shape(node, d["rhs"])
            for pd in d["rhs_free"]:
                if _divisible(rhs_shape, pd, num_splits):
                    r = StrategyUtil.forward_infer(
                        node, {d["rhs"]: DimStrategy.split_on(pd, num_splits)},
                        num_splits)
                    if r is not None:
                        proposals.append(r)
        elif name == "convolution":
            for op_idx, pd in ((0, _LHS_BATCH), (0, _LHS_FEAT),
                               (1, _RHS_OFEAT)):
                if _divisible(_shape(node, op_idx), pd, num_splits):
                    r = StrategyUtil.forward_infer(
                        node, {op_idx: DimStrategy.split_on(pd, num_splits)},
                        num_splits)
                    if r is not None:
                        proposals.append(r)
        else:
            out_shape = _out_shape(node)
            for od in range(len(out_shape)):
                if _divisible(out_shape, od, num_splits):
                    r = StrategyUtil.back_infer(
                        node, DimStrategy.split_on(od, num_splits), num_splits)
                    if r is not None:
                        proposals.append(r)
        # Always offer full replication as a fallback.
        rep = DimStrategy.make_replicated(num_splits)
        proposals.append(InferResult(
            [None if _is_scalar(a) else rep for a in node.invars],
            [rep] * len(node.out_vals)))
        return proposals
