"""Attention-motif detection and the planner's sequence axis.

The port of ``tepdist_tpu/parallel/attention_motif.py``:

1. :func:`detect_motifs` recognizes softmax(QK^T)V in a captured aten
   graph (``graph/fx_graph.py``), in two forms: a ``tepdist::flash_fwd``
   node (its ``causal``, ``scale`` and ``n_head`` arguments say what the
   reference parses out of its ``pallas_call``'s name), and the einsum
   chain of ``bmm`` -> scale / causal mask / softmax -> ``bmm`` with the
   views aten puts around each ``bmm``.
2. :func:`build_seq_strategy` plans a ``seq`` mesh axis: q, k, v and the
   output split on the sequence dim, propagated through the rest of the
   graph by the shared transfer functions, priced with the cheaper of the
   ring and Ulysses costs.
3. The lowering replaces each motif by the sequence-parallel algorithm
   before the graph that runs is captured: :func:`build_ring_rewritten`
   runs a captured graph with each motif replaced by the
   ``tepdist::seq_attn`` op (``ops/ring_attention.py``, through
   :func:`lower_motif_call`), and capturing that callable gives a graph
   holding the op. :func:`seq_rewritten_loss` (the path of
   ``plan_training`` and of a seq winner of the explorer) rewrites a loss
   before differentiation, so its gradient holds the op's registered
   backward, ``tepdist::seq_attn_bwd`` (the reverse ring), and the
   sequence stays split both ways; ``auto_parallel`` rewrites a forward
   graph with closed motifs once before planning it. A graph that holds
   the ops is planned on the ``seq`` axis from them
   (:func:`build_anchored_seq_strategy`), and the DTensor interpreter
   (``parallel/spmd_transform.py``) runs each op node on the local blocks
   of the ``seq`` dimension's process group; DTensor never sees a split
   it would gather.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Set, Tuple

import torch
import torch.fx as fx

from tepdist_tpu_torch.core.dist_spec import DimStrategy
from tepdist_tpu_torch.graph.fx_graph import FxGraph, var_shape, var_val

Var = fx.Node

# Ops allowed inside an einsum motif between the two bmm's (the
# reference's _CHAIN_PRIMS, in aten): views, casts, the scale, the mask,
# the softmax and its pieces.
_VIEWS = {"view", "_unsafe_view", "reshape", "unsqueeze", "squeeze",
          "permute", "transpose", "t", "expand", "clone", "alias",
          "contiguous"}
_CHAIN_OPS = _VIEWS | {
    "_to_copy", "lift_fresh_copy", "mul", "div", "sub", "add", "exp",
    "amax", "sum", "maximum", "minimum", "neg", "where", "_softmax", "full",
    "scalar_tensor", "ones", "tril", "arange", "ge", "gt", "le", "lt",
    "bitwise_and", "bitwise_or", "logical_and", "logical_or", "eq", "ne",
    "pow"}
_COMPARES = {"ge", "gt", "le", "lt"}
_COMPOSITE = {"bitwise_and", "bitwise_or", "logical_and", "logical_or",
              "eq", "ne"}

_NEG_FILL = -1e8      # a mask's fill must be at least this negative

SEQ_OPS = ("seq_attn", "seq_attn_bwd")


@dataclasses.dataclass(eq=False)
class AttentionMotif:
    """One softmax(QK^T)V occurrence: an einsum chain, or a flash forward
    node (``flash``)."""

    qk_id: int                 # the bmm producing the scores
    pv_id: int                 # the bmm producing probs @ v
    member_ids: Set[int]       # every node the lowering replaces
    q: Var
    k: Var
    v: Var
    out: Var
    causal: bool
    scale: float
    seq_len: int
    flash: bool = False        # one tepdist::flash_fwd node
    seq_dim: int = 2           # T position: 2 in [B,H,T,D], 1 in [BH,T,D]
    n_head: Optional[int] = None
    # "ring" (K/V rotation, hops overlap block compute) or "ulysses"
    # (head <-> seq all-to-alls), picked per plan by the priced comm.
    impl: str = "ring"
    # The fx node whose value the lowering computes: the flash node (its
    # (o, lse) tuple), or the einsum output.
    anchor: Optional[Var] = None

    @property
    def inner(self) -> str:
        return "flash" if self.flash else "einsum"


# --------------------------------------------------------------------------
# Detection
# --------------------------------------------------------------------------

def _rank(v) -> int:
    return len(var_shape(v))


def _producer(graph: FxGraph, v):
    p = graph.producer.get(v) if isinstance(v, fx.Node) else None
    return p[0] if p is not None else None


def _back_to_4d(graph: FxGraph, v, members: Set[int]):
    """Walk back from ``v`` through view ops to the first rank-4 value
    (what an einsum operand was before aten's views), adding the views to
    ``members``; None if a non-view op comes first."""
    while _rank(v) != 4:
        node = _producer(graph, v)
        if node is None or node.prim not in _VIEWS or not node.invars:
            return None
        members.add(node.id)
        v = node.invars[0]
    return v


def _forward_to_4d(graph: FxGraph, v, members: Set[int]):
    """Walk forward from a bmm's [BH, T, D] output through single-consumer
    view ops to its rank-4 [B, H, T, D] form."""
    while _rank(v) != 4:
        users = graph.arg_consumers(v)
        if len(users) != 1 or users[0].prim not in _VIEWS:
            return None
        members.add(users[0].id)
        v = users[0].outvars[0]
        if v is None:
            return None
    return v


def _scalar_value(graph: FxGraph, v) -> Optional[float]:
    """The value of a 0-d constant operand (a traced Python scalar or a
    tensor constant of the capture), else None."""
    if isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    if not isinstance(v, fx.Node):
        return None
    if v.op == "get_attr":
        val = getattr(graph.gm, v.target)       # the real constant
        if isinstance(val, torch.Tensor) and val.dim() == 0:
            return float(val)
        return None
    node = _producer(graph, v)
    if node is None:
        return None
    if node.prim in ("lift_fresh_copy", "clone", "_to_copy", "alias"):
        return _scalar_value(graph, node.args[0])
    if node.prim in ("full", "scalar_tensor") and not var_shape(v):
        return float(node.args[1] if node.prim == "full" else node.args[0])
    return None


def _is_plain_iota(graph: FxGraph, a, depth: int = 0) -> bool:
    """True when ``a`` is an un-shifted position index: arange, possibly
    viewed or converted, possibly offset by a zero."""
    if depth > 6:
        return False
    if isinstance(a, (int, float)):
        return True                  # a scalar operand is fine
    node = _producer(graph, a)
    if node is None:
        return False
    if node.prim == "arange":
        return True
    if node.prim in _VIEWS or node.prim == "_to_copy":
        return _is_plain_iota(graph, node.args[0], depth + 1)
    if node.prim in ("add", "sub"):
        others = [x for x in node.args[:2]]
        consts = [x for x in others if _scalar_value(graph, x) is not None]
        rest = [x for x in others if _scalar_value(graph, x) is None]
        if (len(consts) == 1 and _scalar_value(graph, consts[0]) == 0.0
                and len(rest) == 1):
            return _is_plain_iota(graph, rest[0], depth + 1)
    return False


def _is_causal_tril(graph: FxGraph, node) -> bool:
    """``tril(ones(T, T))``: the plain causal mask (diagonal 0)."""
    diag = node.args[1] if len(node.args) > 1 else node.kwargs.get(
        "diagonal", 0)
    src = _producer(graph, node.args[0])
    return diag == 0 and src is not None and src.prim == "ones"


_PASS_THROUGH = _VIEWS | {"_to_copy"}


def _flash_lse_escapes(graph: FxGraph, node) -> bool:
    """True when the flash node's LSE output has live consumers beyond
    shape plumbing: the signature of a grad graph (the backward kernels
    read the residual)."""
    if len(node.outvars) < 2 or node.outvars[1] is None:
        return False
    outs = set(graph.outvars)
    stack = [node.outvars[1]]
    while stack:
        v = stack.pop()
        if v in outs:
            return True
        for user in graph.arg_consumers(v):
            if user.prim not in _PASS_THROUGH:
                return True
            stack.extend(ov for ov in user.outvars if ov is not None)
    return False


def _flash_motifs(graph: FxGraph, allow_escape: bool):
    out = []
    for node in graph.nodes:
        if node.prim != "flash_fwd" or len(node.invars) < 3:
            continue
        if not all(_rank(a) == 3 for a in node.invars[:3]):
            continue
        # Only the pre-differentiation forward is rewritable: in a grad
        # graph the LSE feeds the backward kernels, which read whole-T
        # K/V; grad graphs see flash motifs in pricing mode only.
        if not allow_escape and _flash_lse_escapes(graph, node):
            continue
        q, k, v = node.invars[:3]
        causal, scale, n_head = node.args[3:6]
        out.append(AttentionMotif(
            qk_id=node.id, pv_id=node.id, member_ids={node.id},
            q=q, k=k, v=v, out=node.outvars[0], causal=bool(causal),
            scale=float(scale), seq_len=var_shape(q)[1], flash=True,
            seq_dim=1, n_head=int(n_head), anchor=node.eqn))
    return out


def _qk_operands(graph: FxGraph, node, members: Set[int]):
    """(q, k) of a scores bmm: both operands walk back to rank-4
    [B, H, T, D] values, and the output is [B*H, Tq, Tk]."""
    if node.prim != "bmm" or len(node.invars) != 2:
        return None
    own: Set[int] = set()
    q = _back_to_4d(graph, node.invars[0], own)
    k = _back_to_4d(graph, node.invars[1], own)
    if q is None or k is None:
        return None
    qs, ks = var_shape(q), var_shape(k)
    BH, Tq, Tk = var_shape(node.outvars[0])
    if qs[:2] != ks[:2] or qs[3] != ks[3] or qs[0] * qs[1] != BH or (
            qs[2], ks[2]) != (Tq, Tk):
        return None
    members |= own
    return q, k


def _einsum_motif(graph: FxGraph, pv, claimed: Set[int],
                  allow_escape: bool) -> Optional[AttentionMotif]:
    members: Set[int] = set()
    probs = _back_to_4d(graph, pv.invars[0], members)
    v = _back_to_4d(graph, pv.invars[1], members)
    if probs is None or v is None:
        return None
    qk = None
    q = k = None
    stack = [probs]
    seen: Set[Var] = set()
    scale = 1.0
    has_mask = False
    n_compares = 0
    while stack:
        cur = stack.pop()
        if cur in seen:
            continue
        seen.add(cur)
        node = _producer(graph, cur)
        if node is None:
            return None          # reaches a graph input: not closed
        if node.id in members:
            continue
        if node.prim == "bmm":
            got = _qk_operands(graph, node, members)
            if got is None or (qk is not None and qk.id != node.id):
                return None
            qk, (q, k) = node, got
            members.add(node.id)
            continue
        if node.prim not in _CHAIN_OPS:
            return None
        members.add(node.id)
        if node.prim in _COMPOSITE:
            return None          # composite masks are not plain causal
        if node.prim in ("mul", "div"):
            # Scaling of the logits by a constant. A huge constant is an
            # additive mask (mask * -1e9), not a scale: reject rather
            # than corrupt the softmax temperature.
            for pos, a in enumerate(node.args[:2]):
                val = _scalar_value(graph, a)
                if val is None:
                    continue
                if abs(val) >= abs(_NEG_FILL):
                    return None
                if node.prim == "mul":
                    scale *= val
                elif pos == 1:
                    scale /= val
        if node.prim in _COMPARES:
            n_compares += 1
            # Plain iotas on both sides; banded or windowed masks shift
            # or combine positions.
            if not all(_is_plain_iota(graph, a) for a in node.args[:2]):
                return None
            continue
        if node.prim == "tril":
            if not _is_causal_tril(graph, node):
                return None
            n_compares += 1
            members.add(_producer(graph, node.args[0]).id)
            continue
        if node.prim == "where":
            has_mask = True
            for a in node.args[1:3]:
                val = _scalar_value(graph, a)
                if val is not None and val > _NEG_FILL:
                    return None
        for a in node.invars:
            if _scalar_value(graph, a) is None:
                stack.append(a)
    if qk is None or n_compares > 1 or (has_mask and n_compares != 1):
        return None
    out = _forward_to_4d(graph, pv.outvars[0], members)
    if out is None or members & claimed:
        return None
    inside = members | {pv.id}
    out_node = _producer(graph, out)
    closed = all(user.id in inside
                 for nid in members if nid != out_node.id
                 for ov in graph.nodes[nid].outvars if ov is not None
                 for user in graph.arg_consumers(ov))
    if not closed and not allow_escape:
        return None
    members.add(pv.id)
    return AttentionMotif(
        qk_id=qk.id, pv_id=pv.id, member_ids=members, q=q, k=k, v=v,
        out=out, causal=has_mask, scale=scale, seq_len=var_shape(q)[2],
        n_head=var_shape(q)[1], anchor=out)


def detect_motifs(graph: FxGraph,
                  allow_escape: bool = False) -> List[AttentionMotif]:
    """Every rewritable softmax(QK^T)V motif of ``graph``.

    A motif counts only when the chain between the two bmm's is closed
    (no intermediate reaches a consumer outside it) and any mask is a
    locally made causal mask (``tril`` of ``ones``, or one plain compare
    of positions) with a large negative fill: the family of programs the
    ring computes. ``allow_escape=True`` skips the closure check, for
    PRICING a seq proposal on a grad graph (its backward reads the
    softmax); rewriting always runs on the closed forward graph."""
    motifs = _flash_motifs(graph, allow_escape)
    claimed: Set[int] = {m.pv_id for m in motifs}
    for node in graph.nodes:
        if node.prim != "bmm" or node.id in claimed:
            continue
        m = _einsum_motif(graph, node, claimed, allow_escape)
        if m is not None:
            motifs.append(m)
            claimed |= m.member_ids
    return motifs


def seq_op_nodes(graph: FxGraph):
    """The ``tepdist::seq_attn`` / ``seq_attn_bwd`` nodes of a graph whose
    motifs were rewritten before capture."""
    return [n for n in graph.nodes if n.prim in SEQ_OPS]


# --------------------------------------------------------------------------
# Lowering
# --------------------------------------------------------------------------

def lower_motif_call(m: AttentionMotif, q, k, v, seq_size: int):
    """Lower one motif to its chosen algorithm over ``seq_size`` ranks:
    the sequence op while a capture is active, else its one-process form
    over ``[q.device] * seq_size``. Returns (o, lse): flash motifs keep
    their [B*H, T, D] layout and return the global LSE, so a live
    residual consumer can be bound; einsum motifs return (o, None)."""
    from tepdist_tpu_torch.ops.ring_attention import seq_attention

    o, lse = seq_attention(q, k, v, m.causal, m.scale, m.n_head, m.impl,
                           m.inner, seq_size)
    return o, (lse if m.flash else None)


def bind_motif_outputs(m: AttentionMotif, o, lse):
    """The anchor's value for a lowered motif: the flash node's (o, lse)
    tuple (its getitem users read both; the LSE in fp32 as the kernel
    writes it), or the einsum output in the motif's dtype."""
    if m.flash:
        return o, lse
    return o.to(var_val(m.out).dtype)


class _RewriteInterpreter(fx.Interpreter):
    """Runs a captured graph with its motifs replaced: member nodes are
    skipped, each motif's q, k and v are kept until its anchor, and the
    anchor's value is the lowered motif's."""

    def __init__(self, graph: FxGraph, motifs, seq_size: int):
        super().__init__(graph.gm, garbage_collect_values=True)
        self.seq_size = seq_size
        self._at = {m.anchor: m for m in motifs}
        self._skip = {graph.nodes[i].eqn for m in motifs
                      for i in m.member_ids} - set(self._at)
        self._want: Dict[Var, int] = {}
        for m in motifs:
            for x in (m.q, m.k, m.v):
                self._want[x] = self._want.get(x, 0) + 1
        self._stash: Dict[Var, object] = {}

    def run_node(self, n):
        if n in self._skip:
            return None
        m = self._at.get(n)
        if m is not None:
            vals = []
            for x in (m.q, m.k, m.v):
                vals.append(self._stash[x])
                self._want[x] -= 1
                if not self._want[x]:
                    del self._stash[x]
            o, lse = lower_motif_call(m, *vals, self.seq_size)
            return bind_motif_outputs(m, o, lse)
        val = super().run_node(n)
        if n in self._want:
            self._stash[n] = val
        return val

    def get_attr(self, target, args, kwargs):
        val = super().get_attr(target, args, kwargs)
        if isinstance(val, torch.Tensor):
            # A constant made anew, as the traced code made it: under a
            # capture it becomes a constant of the new graph.
            val = torch.tensor(val.tolist(), dtype=val.dtype,
                               device=val.device)
        return val


def build_ring_rewritten(graph: FxGraph, motifs: List[AttentionMotif],
                         seq_size: int) -> Callable:
    """A differentiable callable over the graph's FLAT inputs that
    computes the same program with every motif replaced by the sequence
    op (``ops.ring_attention.seq_attention``, ring or Ulysses as each
    motif's ``impl`` says) over ``seq_size`` ranks. Run eagerly it is the
    one-process form; captured, it holds the op, which a DTensor lowering
    runs over its ``seq`` group."""
    def run(*flat_args):
        return tuple(_RewriteInterpreter(graph, motifs, seq_size).run(
            *flat_args))
    return run


# --------------------------------------------------------------------------
# Pricing
# --------------------------------------------------------------------------

def ring_comm_cost(motifs: List[AttentionMotif], num_splits: int,
                   spec=None, with_backward: bool = False) -> float:
    """EXPOSED ring comm per motif: each K/V hop overlaps the previous
    block's compute, so a hop exposes max(alpha, hop - block compute);
    block compute grows as (T/P)^2 and hop bytes as T/P, which is why the
    ring wins at long T. ``with_backward`` adds the reverse ring (2x the
    messages: K, V and dK, dV; about 2x the block compute)."""
    from tepdist_tpu_torch.graph.fx_graph import var_bytes
    from tepdist_tpu_torch.parallel.performance_utils import (ALPHA_S,
                                                              PerfUtils,
                                                              chip_spec)

    spec = spec or chip_spec()
    t = 0.0
    for m in motifs:
        if num_splits <= 1:
            continue
        kv_bytes = (var_bytes(m.k) + var_bytes(m.v)) / num_splits
        hop = PerfUtils.ppermute_cost(kv_bytes, spec)
        shape = var_shape(m.q)
        if len(shape) == 4:
            B, H, T, D = shape
        else:                       # flash layout [B*H, T, D]
            BH, T, D = shape
            B, H = 1, BH
        blk = T // num_splits
        # QK^T + PV per block pair: 4*B*H*blk^2*D flops.
        block_compute = PerfUtils.compute_time(4.0 * B * H * blk * blk * D,
                                               spec)
        t += (num_splits - 1) * max(ALPHA_S, hop - block_compute)
        if with_backward:
            t += (num_splits - 1) * max(ALPHA_S,
                                        2.0 * hop - 2.0 * block_compute)
    return t


def ulysses_comm_cost(motifs: List[AttentionMotif], num_splits: int,
                      spec=None, with_backward: bool = False) -> float:
    """Ulysses comm per motif: 4 head <-> seq all-to-alls forward (q, k, v
    in; o out), fully exposed (all-to-all, compute, all-to-all run in
    series); the backward's transposed ones double it. inf when a motif's
    head count does not divide."""
    from tepdist_tpu_torch.graph.fx_graph import var_bytes
    from tepdist_tpu_torch.parallel.performance_utils import (PerfUtils,
                                                              chip_spec)

    spec = spec or chip_spec()
    t = 0.0
    for m in motifs:
        if num_splits <= 1:
            continue
        if not m.n_head or m.n_head % num_splits:
            return float("inf")
        local_bytes = var_bytes(m.q) / num_splits
        one = PerfUtils.all_to_all_cost(local_bytes, num_splits, spec)
        t += 4.0 * one
        if with_backward:
            t += 4.0 * one
    return t


def best_seq_comm(motifs: List[AttentionMotif], num_splits: int,
                  spec=None, with_backward: bool = False
                  ) -> Tuple[str, float]:
    """(impl, seconds): the cheaper of ring and Ulysses for the motifs."""
    ring = ring_comm_cost(motifs, num_splits, spec,
                          with_backward=with_backward)
    uly = ulysses_comm_cost(motifs, num_splits, spec,
                            with_backward=with_backward)
    return ("ulysses", uly) if uly < ring else ("ring", ring)


# --------------------------------------------------------------------------
# The seq axis's strategy
# --------------------------------------------------------------------------

def build_seq_strategy(graph: FxGraph, num_splits: int,
                       motifs: Optional[List[AttentionMotif]] = None,
                       chip=None):
    """Plan the ``seq`` axis: sequence-split attention by the motif
    lowering, the token dim propagated elsewhere (shared transfer
    functions)."""
    from tepdist_tpu_torch.parallel.fast_spmd_strategy import (
        FastSpmdStrategy)

    if motifs is None:
        motifs = detect_motifs(graph)
    if not motifs:
        raise ValueError("seq axis proposed but no attention motif found")
    for m in motifs:
        if m.seq_len % num_splits:
            raise ValueError(
                f"seq len {m.seq_len} not divisible by seq={num_splits}")
    seeds: Dict[Var, DimStrategy] = {}
    for m in motifs:
        split_t = DimStrategy(partition_dim=m.seq_dim,
                              num_splits=num_splits)
        for v in (m.q, m.k, m.v, m.out):
            seeds[v] = split_t
    gs = FastSpmdStrategy(graph, "seq", num_splits, seeds).run()
    # The motif interiors are replaced by the lowering: their strategies
    # must not leak constraints ([B, H, Tq, Tk] scores would otherwise be
    # constrained on a dim the lowering removes).
    for m in motifs:
        keep = _producer(graph, m.out)
        for nid in m.member_ids:
            if keep is None or nid != keep.id:
                gs.node_out.pop(nid, None)
    # Choose AND price forward + backward: the lowered rewrite is
    # differentiated, and exploration prices the rival candidates
    # with_backward=True.
    impl, comm = best_seq_comm(motifs, num_splits, chip, with_backward=True)
    for m in motifs:
        m.impl = impl
    gs.motifs = motifs
    gs.comm_cost = comm
    gs.ilp_status = f"seq-{impl}"
    return gs


def _op_motif(node) -> AttentionMotif:
    """The motif a forward sequence op stands for (pricing only)."""
    q, k, v = node.invars[:3]
    causal, scale, n_head, impl = node.args[3:7]
    shape = var_shape(q)
    return AttentionMotif(
        qk_id=node.id, pv_id=node.id, member_ids={node.id}, q=q, k=k, v=v,
        out=node.outvars[0], causal=bool(causal), scale=float(scale),
        seq_len=shape[-2], flash=True, seq_dim=len(shape) - 2,
        n_head=int(n_head), impl=str(impl), anchor=node.eqn)


def build_anchored_seq_strategy(graph: FxGraph, num_splits: int,
                                chip=None):
    """Plan the ``seq`` axis of a graph whose motifs were rewritten into
    sequence ops before capture: every tensor of every op node split on
    its sequence dim (dim -2 of q-like tensors, -1 of the LSE), propagated
    as :func:`build_seq_strategy` propagates. The reference leaves such a
    graph's axis to GSPMD's propagation from its ``shard_map``; DTensor
    has none, so the planner propagates from the op nodes. Priced with
    the algorithm the rewrite chose."""
    from tepdist_tpu_torch.parallel.fast_spmd_strategy import (
        FastSpmdStrategy)

    nodes = seq_op_nodes(graph)
    if not nodes:
        raise ValueError("seq axis proposed but no sequence op found")
    seeds: Dict[Var, DimStrategy] = {}
    fwd = []
    for node in nodes:
        q_rank = _rank(node.invars[0])
        if var_shape(node.invars[0])[-2] % num_splits:
            raise ValueError(f"seq len {var_shape(node.invars[0])[-2]} not "
                             f"divisible by seq={num_splits}")
        for v in list(node.invars) + [o for o in node.outvars
                                      if o is not None]:
            r = _rank(v)
            if r:
                dim = r - 2 if r == q_rank else r - 1
                seeds[v] = DimStrategy(partition_dim=dim,
                                       num_splits=num_splits)
        if node.prim == "seq_attn":
            fwd.append(_op_motif(node))
    gs = FastSpmdStrategy(graph, "seq", num_splits, seeds).run()
    impls = {m.impl for m in fwd}
    comm = sum((ulysses_comm_cost if m.impl == "ulysses" else
                ring_comm_cost)([m], num_splits, chip, with_backward=True)
               for m in fwd)
    gs.comm_cost = comm
    gs.ilp_status = "seq-" + "+".join(sorted(impls))
    return gs


# --------------------------------------------------------------------------
# The rewrite before capture
# --------------------------------------------------------------------------

class SeqRewrittenLoss:
    """``loss_fn`` with its attention motifs replaced by the sequence op
    (see :func:`seq_rewritten_loss`). The graph is captured per input
    shape: eagerly at the first call with new shapes, or ahead of a
    capture by :meth:`prepare` (a capture cannot capture inside itself)."""

    def __init__(self, loss_fn: Callable, seq_size: int,
                 impl: Optional[str]):
        self.loss_fn = loss_fn
        self.seq_size = seq_size
        self.impl = impl
        self._runs: Dict[tuple, Callable] = {}

    @staticmethod
    def _key(flat) -> tuple:
        return tuple((tuple(x.shape), x.dtype, x.device.type)
                     if isinstance(x, torch.Tensor) else type(x)
                     for x in flat)

    def prepare(self, *args) -> List[AttentionMotif]:
        """Capture the loss at ``args``' shapes and detect its motifs;
        returns them."""
        from tepdist_tpu_torch.core.tree import tree_leaves
        from tepdist_tpu_torch.graph.fx_graph import trace_graph

        key = self._key(tree_leaves((args, {})))
        g_loss, _, _ = trace_graph(self.loss_fn, *args)
        motifs = detect_motifs(g_loss)
        if not motifs:
            raise ValueError("topology has a 'seq' axis but the loss has "
                             "no rewritable attention motif")
        if self.impl is None:
            self.impl, _ = best_seq_comm(motifs, self.seq_size,
                                         with_backward=True)
        for m in motifs:
            m.impl = self.impl
        self._runs[key] = build_ring_rewritten(g_loss, motifs,
                                               self.seq_size)
        self.motifs = motifs
        return motifs

    def __call__(self, *args):
        from tepdist_tpu_torch.core.tree import tree_leaves
        from tepdist_tpu_torch.ops.flash_attention import _use_ops

        flat = tree_leaves((args, {}))
        key = self._key(flat)
        if key not in self._runs:
            if _use_ops():
                raise RuntimeError(
                    "the sequence-rewritten loss was not prepared for "
                    "these input shapes; call .prepare(*args) before "
                    "capturing it")
            self.prepare(*args)
        return self._runs[key](*flat)[0]


def seq_rewritten_loss(loss_fn: Callable, seq_size: int, *example_args,
                       impl: Optional[str] = None):
    """Rewrite ``loss_fn``'s attention motifs to the priced ring or
    Ulysses algorithm for a ``seq`` axis of ``seq_size``: the one
    sequence lowering that ``plan_training`` and the explorer share. The
    rewrite runs BEFORE differentiation, so the gradient runs the op's
    reverse ring and the sequence dim stays split both ways.

    Returns ``(rewritten_fn, impl)``; ``rewritten_fn`` takes ``loss_fn``'s
    positional args. Raises ValueError when the loss has no closed motif
    (an escaping motif can be priced, not rewritten). The reference takes
    a mesh here for its ``shard_map``; the op needs none: it runs over
    ``[device] * seq_size`` in one process, or over the ``seq`` group of
    the DTensor lowering that runs its captured graph."""
    rw = SeqRewrittenLoss(loss_fn, seq_size, impl)
    rw.prepare(*example_args)
    return rw, rw.impl

