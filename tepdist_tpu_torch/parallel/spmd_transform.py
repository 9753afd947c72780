"""SPMD transform: lower planned strategies onto DTensor.

Reference parity: ``SpmdTransform`` (reference:
service/parallel/spmd_transform.{h,cc}, ~3.1k LoC) rewrote every HLO
instruction's shape by hand and inserted kCustomCollective nodes. The JAX
package hands that job to GSPMD (``NamedSharding`` on inputs and outputs,
``with_sharding_constraint`` at the cone roots). The port of
``tepdist_tpu/parallel/spmd_transform.py`` hands it to DTensor:

  * every input and output gets DTensor placements (``Shard(d)``,
    ``Replicate()``, ``Partial()``; ``core/dist_spec``), one per mesh axis;
  * every compute-intensive value with a planned placement is
    ``redistribute``\\ d to it as the interpreter writes it (the
    reference's ``with_sharding_constraint`` in ``write``);
  * DTensor's sharding propagation does the per-op rewrite and inserts the
    collectives (all-reduce, all-gather, all-to-all) in between.

The executable interprets the planner's captured graph with a
``torch.fx.Interpreter`` on DTensors, so the executed program is exactly
the analyzed one. It frees each value after its last use
(``garbage_collect_values``), and an input the caller passes in a list it
no longer holds is freed the same way (the state donation of the
reference's jit).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.fx as fx

from tepdist_tpu_torch.core.dist_spec import DimStrategy, TensorStrategy
from tepdist_tpu_torch.core.mesh import MeshTopology
from tepdist_tpu_torch.graph.fx_graph import FxGraph, op_name, var_shape
from tepdist_tpu_torch.parallel.cost_spmd_strategy import GraphStrategy

Var = fx.Node
Placements = tuple


def combine_axis_strategies(
    graph: FxGraph, strategies: Sequence[GraphStrategy]
) -> Dict[Var, TensorStrategy]:
    """Merge per-axis planning results into one TensorStrategy per var
    (vars covered: graph inputs + every node output)."""
    combined: Dict[Var, TensorStrategy] = {}

    def add(v: Var, axis: str, s: DimStrategy):
        combined.setdefault(v, TensorStrategy()).set(axis, s)

    for gs in strategies:
        for v, s in gs.var_strategies.items():
            add(v, gs.axis_name, s)
        for nid, outs in gs.node_out.items():
            node = graph.nodes[nid]
            for ov, s in zip(node.outvars, outs):
                if isinstance(ov, Var):
                    add(ov, gs.axis_name, s)
    return combined


_FLASH_SHARDING_REGISTERED = False


def register_flash_sharding() -> None:
    """Register the flash ops' sharding rule with DTensor (the
    ``strategy_utils`` rule): every tensor operand and output either
    replicated or split on dim 0 (batch x head), on each mesh axis; split
    only where the mesh divides dim 0 (25 heads of one row over 2 ranks
    would split unevenly, and the backward's view back to the hidden dim
    cannot take an uneven split: ROADMAP C8). Without it DTensor cannot
    run the custom ops at all. Idempotent."""
    global _FLASH_SHARDING_REGISTERED
    if _FLASH_SHARDING_REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    import tepdist_tpu_torch.ops.flash_attention  # noqa: F401 — the ops

    ops = torch.ops.tepdist

    def rule(n_in: int, n_out: int):
        def fn(q, *args):
            n_scalar = len(args) + 1 - n_in
            options = [Replicate()]
            if q.shape[0] % q.mesh.size() == 0:
                options.append(Shard(0))
            return [([p] * n_out, [p] * n_in + [None] * n_scalar)
                    for p in options]
        return fn

    register_sharding(ops.flash_fwd.default)(rule(3, 2))
    register_sharding(ops.flash_dq.default)(rule(6, 1))
    register_sharding(ops.flash_dkv.default)(rule(6, 2))
    _FLASH_SHARDING_REGISTERED = True


@dataclasses.dataclass
class ShardingPlan:
    """Lowered plan: DTensor placements for I/O + interior constraint
    points (one placement per device axis of the topology, in order)."""

    topology: MeshTopology
    in_specs: List[Placements]                 # one per graph invar
    out_specs: List[Optional[Placements]]      # one per graph outvar
    constraints: Dict[Var, Placements]         # interior anchors
    var_strategies: Dict[Var, TensorStrategy]
    # outvar idx -> invar idx threading (reference input_output_alias_map_);
    # these invars are safe to donate — the step replaces them.
    state_alias: Optional[Dict[int, int]] = None

    def mesh(self, device_type: str = "cuda"):
        return self.topology.to_device_mesh(device_type)


def _axis_order(topology: MeshTopology) -> List[str]:
    return [name for name, _ in topology.device_axes()]


class SpmdTransform:
    """Build a ShardingPlan and an executable sharded step function."""

    def __init__(self, graph: FxGraph, topology: MeshTopology):
        self.graph = graph
        self.topology = topology

    @staticmethod
    def _validate(ts: TensorStrategy, shape, axis_sizes) -> None:
        """Reject shardings that would pad or misplace: every split dim
        must exist and divide by the product of axis sizes on it (catches
        bad user annotations before an opaque DTensor error)."""
        per_dim = {}
        for axis, s in ts.strategies.items():
            if not s.is_split():
                continue
            d = s.partition_dim
            if d >= len(shape):
                raise ValueError(
                    f"annotation splits dim {d} of a rank-{len(shape)} "
                    f"tensor (axis {axis!r})")
            per_dim[d] = per_dim.get(d, 1) * axis_sizes.get(axis,
                                                            s.num_splits)
        for d, factor in per_dim.items():
            if shape[d] % factor:
                raise ValueError(
                    f"dim {d} (size {shape[d]}) not divisible by the "
                    f"combined mesh factor {factor}")

    def lower(self, strategies: Sequence[GraphStrategy],
              state_alias: Optional[Dict[int, int]] = None) -> ShardingPlan:
        """``state_alias``: outvar index -> invar index for training-state
        threading (reference input_output_alias_map_): the aliased output is
        forced to its input's placements so step N's outputs feed step N+1
        without resharding.

        A ``seq`` axis is lowered from the graph's sequence-op nodes
        (``tepdist::seq_attn`` / ``seq_attn_bwd``); a strategy of closed
        attention motifs (``attention_motif.build_seq_strategy``) is for
        pricing, and its graph is lowered once rewritten
        (``auto_parallel`` rewrites it)."""
        if any(getattr(gs, "motifs", None) for gs in strategies):
            raise ValueError(
                "a seq strategy of closed attention motifs is lowered from "
                "the rewritten graph: rewrite the motifs into sequence ops "
                "(attention_motif.build_ring_rewritten) and plan that graph")
        combined = combine_axis_strategies(self.graph, strategies)
        sizes = {gs.axis_name: gs.num_splits for gs in strategies}
        order = _axis_order(self.topology)
        in_specs = []
        for v in self.graph.invars:
            ts = combined.get(v, TensorStrategy())
            shape = var_shape(v)
            self._validate(ts, shape, sizes)
            in_specs.append(ts.placements(order, len(shape)))
        out_specs: List[Optional[Placements]] = []
        for a in self.graph.outvars:
            if isinstance(a, Var) and a in combined:
                ts = combined[a]
                if ts.has_partial():
                    # The materialized output is the reduced value:
                    # replicated along the partial axes.
                    ts = TensorStrategy({
                        ax: s for ax, s in ts.strategies.items()
                        if not s.partial})
                out_specs.append(ts.placements(order, len(var_shape(a))))
            elif isinstance(a, Var):
                out_specs.append(TensorStrategy().placements(
                    order, len(var_shape(a))))
            else:
                out_specs.append(None)
        for oi, ii in (state_alias or {}).items():
            if oi < len(out_specs):
                out_specs[oi] = in_specs[ii]
        constraints: Dict[Var, Placements] = {}
        for node in self.graph.nodes:
            if not node.is_compute_intensive():
                continue
            for ov in node.outvars:
                if not isinstance(ov, Var) or ov not in combined:
                    continue
                ts = combined[ov]
                if ts.has_partial():
                    continue  # partial values are DTensor's to resolve
                if ts.sharded_dims():
                    constraints[ov] = ts.placements(order,
                                                    len(var_shape(ov)))
        return ShardingPlan(
            topology=self.topology,
            in_specs=in_specs,
            out_specs=out_specs,
            constraints=constraints,
            var_strategies=combined,
            state_alias=dict(state_alias) if state_alias else None,
        )

    # ------------------------------------------------------------------
    def executable(self, plan: ShardingPlan, mesh=None
                   ) -> "SpmdExecutable":
        """The planned program over DTensors on ``mesh`` (default: the
        topology's mesh on the card). Called over FLAT invars (same order
        as ``graph.invars``), it returns flat DTensor outputs with
        ``plan.out_specs`` placements — runtime layers wrap trees around
        it."""
        register_flash_sharding()
        mesh = mesh if mesh is not None else plan.mesh()
        return SpmdExecutable(self.graph.gm, plan, mesh, plan.constraints)


_SEQ_OPS = ("seq_attn", "seq_attn_bwd")


class _DTensorInterpreter(fx.Interpreter):
    """Runs the captured aten graph on DTensors: inputs come from a list
    that is emptied as they are read, factory ops' plain outputs become
    replicated DTensors, constants are distributed as replicated, and a
    constrained value is redistributed to its planned placements as it is
    written.

    Sequence parallelism runs here, on local blocks: a node of the
    ``tepdist::seq_attn`` / ``seq_attn_bwd`` ops (attention rewritten
    before capture) takes its operands' blocks split on the sequence dim
    over the ``seq`` mesh dimension (a value that arrives replicated there
    is sliced, not gathered), runs the ring or Ulysses over that
    dimension's process group, and gives back DTensors of the same
    placements."""

    def __init__(self, exe: "SpmdExecutable", inputs: List[Any],
                 comm_mode=None):
        super().__init__(exe.gm, garbage_collect_values=True)
        self.exe = exe
        self._inputs = inputs
        self._next = 0
        self.comm_mode = comm_mode
        self.remats: List[str] = []

    def placeholder(self, target, args, kwargs):
        i = self._next
        self._next += 1
        val = self._inputs[i]
        self._inputs[i] = None        # the env holds the only reference
        return self.exe.distribute_input(i, val)

    def get_attr(self, target, args, kwargs):
        val = super().get_attr(target, args, kwargs)
        if isinstance(val, torch.Tensor):
            return self.exe.replicated(val)
        return val

    def call_function(self, target, args, kwargs):
        before = _gathers(self.comm_mode) if self.comm_mode else 0
        args = reduce_seq_partial_factors(self.exe.mesh, target, args)
        try:
            out = super().call_function(target, args, kwargs)
        except RuntimeError:
            if not _has_split_operand(args, kwargs, partial=True):
                raise
            # DTensor's rule for this op cannot take the split operands
            # (a view across a split dim it cannot express): gather them
            # and run it whole, as GSPMD falls back to a full
            # rematerialization. The diagnostic run lists the node.
            args, kwargs = self.exe.replicate_all((args, kwargs))
            out = super().call_function(target, args, kwargs)
            if self.comm_mode is not None:
                self.remats.append(self.current_node)
                before = None
        if (self.comm_mode is not None and before is not None
                and _gathers(self.comm_mode) > before
                and _has_split_operand(args, kwargs)):
            self.remats.append(self.current_node)
        if isinstance(out, (tuple, list)):
            return type(out)(self.exe.as_dtensor(t) for t in out)
        return self.exe.as_dtensor(out)

    def run_node(self, n: fx.Node):
        self.current_node = n.name
        if n.op == "call_function" and op_name(n.target) in _SEQ_OPS:
            return self._seq_op(n)
        val = super().run_node(n)
        spec = self.exe.constraints.get(n)
        if spec is not None:
            val = val.redistribute(self.exe.mesh, spec)
        return val

    # -- sequence parallelism ----------------------------------------------
    def _blocks(self, tensors, seq_dim: int):
        """(local blocks, placements) of DTensor operands split on
        ``seq_dim`` over the ``seq`` mesh dimension, dim 0 splits kept, any
        other mesh dimension replicated. An all-gather this takes is an
        involuntary remat of the node."""
        from torch.distributed.tensor import Replicate, Shard

        seq = self.exe.seq_mesh_dim()
        before = _gathers(self.comm_mode) if self.comm_mode else 0
        out, placements = [], None
        for t in tensors:
            if t is None:
                out.append(None)
                continue
            # An LSE keeps q's dims but D, so T sits at seq_dim there too.
            t = self.exe.as_dtensor(t)
            want = [Shard(seq_dim) if i == seq else
                    (p if p.is_shard(0) else Replicate())
                    for i, p in enumerate(t.placements)]
            if list(t.placements) != want:
                t = t.redistribute(self.exe.mesh, want)
            if placements is None:
                placements = want
            out.append(t.to_local())
        if self.comm_mode is not None and _gathers(self.comm_mode) > before:
            self.remats.append(self.current_node)
        return out, placements

    def _wrap(self, local, placements):
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(local, self.exe.mesh, placements,
                                  run_check=False)

    def _seq_op(self, n: fx.Node):
        from tepdist_tpu_torch.ops.ring_attention import (
            seq_attention_blocks, seq_attention_blocks_backward)

        args, _ = self.fetch_args_kwargs_from_env(n)
        if op_name(n.target) == "seq_attn":
            q, k, v, causal, scale, n_head, impl, inner, seq_size = args
            (ql, kl, vl), pl = self._blocks((q, k, v), q.dim() - 2)
            o, lse = seq_attention_blocks(
                ql, kl, vl, self.exe.seq_transport(seq_size), causal, scale,
                n_head, impl, inner)
            return self._wrap(o, pl), self._wrap(lse, pl)
        (q, k, v, o, lse, do, dlse, causal, scale, n_head, impl, inner,
         seq_size) = args
        blocks, pl = self._blocks((q, k, v, o, lse, do, dlse), q.dim() - 2)
        grads = seq_attention_blocks_backward(
            *blocks, self.exe.seq_transport(seq_size), causal, scale,
            n_head, impl, inner)
        return tuple(self._wrap(g, pl) for g in grads)


def _seq_mesh_dim(mesh) -> Optional[int]:
    """The index of ``mesh``'s dimension named ``seq``, or None."""
    names = mesh.mesh_dim_names or ()
    return names.index("seq") if "seq" in names else None


def reduce_seq_partial_factors(mesh, target, args):
    """``args`` of a product (``aten.mul.Tensor``) with every operand that
    is a partial sum over the ``seq`` mesh dimension reduced first, when
    two or more are.

    DTensor reduces one factor of a product of partial sums and keeps the
    product partial: exact in exact arithmetic, but under a sequence split
    a gradient can be zero in exact arithmetic while its partial sums are
    not (a key bias's: softmax ignores a shift of a row's scores), and
    the partial products of its square then sum to a value that may round
    below zero, where Adam's sqrt gives NaN. Reducing both factors costs
    the one all-reduce of the gradient that DTensor would take anyway.
    Other mesh dimensions keep DTensor's rule."""
    from torch.distributed.tensor import DTensor, Replicate

    if target is not torch.ops.aten.mul.Tensor:
        return args
    seq = _seq_mesh_dim(mesh)
    if seq is None:
        return args
    partial = [i for i, a in enumerate(args) if isinstance(a, DTensor)
               and a.placements[seq].is_partial()]
    if len(partial) < 2:
        return args
    args = list(args)
    reduced = {}                       # x * x: one all-reduce of x
    for i in partial:
        a = args[i]
        if id(a) not in reduced:
            want = list(a.placements)
            want[seq] = Replicate()
            reduced[id(a)] = a.redistribute(mesh, want)
        args[i] = reduced[id(a)]
    return tuple(args)


def _gathers(comm_mode) -> int:
    return sum(c for op, c in comm_mode.get_comm_counts().items()
               if "all_gather" in str(op))


def _has_split_operand(args, kwargs, partial: bool = False) -> bool:
    """Whether a DTensor operand is split (or, with ``partial``, split or
    a partial sum)."""
    from torch.distributed.tensor import DTensor

    def split(a):
        if isinstance(a, DTensor):
            return any(not p.is_replicate() and (partial
                                                  or not p.is_partial())
                       for p in a.placements)
        if isinstance(a, (list, tuple)):
            return any(split(x) for x in a)
        return False
    return split(args) or split(tuple(kwargs.values()))


class SpmdExecutable:
    """The lowered step: ``exe(*flat)`` or ``exe.run(flat_list)``."""

    def __init__(self, gm: fx.GraphModule, plan: ShardingPlan, mesh,
                 constraints: Dict[Var, Placements]):
        self.gm = gm
        self.plan = plan
        self.mesh = mesh
        self.constraints = constraints
        self._replicate = None
        self._seq_transport = None

    # -- sequence parallelism ----------------------------------------------
    def seq_mesh_dim(self) -> Optional[int]:
        """The mesh dimension named ``seq``, or None."""
        return _seq_mesh_dim(self.mesh)

    def seq_transport(self, seq_size: Optional[int] = None):
        """The ring of the sequence ops: the ``seq`` mesh dimension's
        process group (of ``seq_size`` ranks, when given)."""
        from tepdist_tpu_torch.ops.seq_comm import GroupTransport

        seq = self.seq_mesh_dim()
        if seq is None:
            raise ValueError("sequence attention needs a 'seq' mesh "
                             "dimension")
        if self._seq_transport is None:
            self._seq_transport = GroupTransport(self.mesh.get_group(seq))
        t = self._seq_transport
        if seq_size is not None and seq_size != t.size:
            raise ValueError(f"a sequence op for {seq_size} ranks on a seq "
                             f"mesh dimension of {t.size}")
        return t

    # -- value conversion ------------------------------------------------
    def _rep(self):
        if self._replicate is None:
            from torch.distributed.tensor import Replicate
            self._replicate = [Replicate()] * self.mesh.ndim
        return self._replicate

    def replicated(self, t: torch.Tensor):
        """A plain tensor that every rank holds whole, as a DTensor."""
        from torch.distributed.tensor import DTensor

        t = t.to(self.mesh.device_type)
        return DTensor.from_local(t, self.mesh, self._rep(), run_check=False)

    def replicate_all(self, tree):
        """Every DTensor of ``tree`` (nested lists, tuples and dicts)
        redistributed to replicated."""
        from torch.distributed.tensor import DTensor

        if isinstance(tree, DTensor):
            return DTensor.from_local(tree.full_tensor(), self.mesh,
                                      self._rep(), run_check=False)
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.replicate_all(t) for t in tree)
        if isinstance(tree, dict):
            return {k: self.replicate_all(v) for k, v in tree.items()}
        return tree

    def as_dtensor(self, t):
        """An op's output as a DTensor: a factory op's plain output (no
        DTensor operand) is the same whole value on every rank."""
        from torch.distributed.tensor import DTensor

        if isinstance(t, torch.Tensor) and not isinstance(t, DTensor):
            return DTensor.from_local(t, self.mesh, self._rep(),
                                      run_check=False)
        if isinstance(t, DTensor) and any(
                type(p).__name__ == "_MaskPartial" for p in t.placements):
            # A gather from a vocab-split operand leaves a masked partial
            # sum that later view ops cannot carry (its mask keeps the
            # gather's shape): resolve it where it was made.
            from torch.distributed.tensor import Replicate
            t = t.redistribute(self.mesh, [
                Replicate() if type(p).__name__ == "_MaskPartial" else p
                for p in t.placements])
        return t

    def distribute_input(self, i: int, val):
        """Input ``i`` with its planned placements: a plain tensor (the
        same whole value on every rank) is distributed, each rank keeping
        its slice; a DTensor is redistributed if its placements differ."""
        from torch.distributed.tensor import DTensor, distribute_tensor

        spec = list(self.plan.in_specs[i])
        if isinstance(val, DTensor):
            if list(val.placements) != spec:
                val = val.redistribute(self.mesh, spec)
            return val
        if not isinstance(val, torch.Tensor):
            return val
        # Every rank passes the same whole value (the params come from one
        # seed, the batch is the global batch): each keeps its own slice,
        # with no collective and no copy of a replicated value.
        val = val.to(self.mesh.device_type)
        return distribute_tensor(val, self.mesh, spec, src_data_rank=None)

    # -- running -----------------------------------------------------------
    def run(self, inputs: List[Any], comm_mode=None) -> List[Any]:
        """Run one step over the flat ``inputs`` list, which is emptied:
        a caller that keeps no other reference to an input lets it be
        freed after its last use."""
        interp = _DTensorInterpreter(self, inputs, comm_mode)
        outs = interp.run()
        self.last_remats = interp.remats
        return self._finish(list(outs))

    def __call__(self, *flat):
        return self.run(list(flat))

    def _finish(self, outs: List[Any]) -> List[Any]:
        """Bring the outputs to ``out_specs``, resolving partial sums."""
        from torch.distributed.tensor import DTensor

        for i, (o, spec) in enumerate(zip(outs, self.plan.out_specs)):
            if spec is None or not isinstance(o, DTensor):
                continue
            if list(o.placements) != list(spec):
                outs[i] = o.redistribute(self.mesh, list(spec))
        return outs
