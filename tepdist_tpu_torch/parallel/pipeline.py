"""Pipeline planning + pipelined training-step construction: the port of
``tepdist_tpu/parallel/pipeline.py``.

Ties together GraphSketch (stage ILP), StageDecomposition (per-stage forward
modules + input_def_map) and the stage backwards into a gradient-
accumulating pipelined training step (reference: the PIPELINE par type —
GraphSketch::StagePlan + StageDecomposition + the GA/GAInit machinery, with
the 1F1B order produced by TaskScheduler). The semantics function below is
the *correctness anchor*; the task-graph runtime (``runtime/executor.py``)
executes the same stage modules in 1F1B order over a list of devices.

A stage's backward runs its forward ``GraphModule`` again under autograd
(:func:`stage_vjp`), as ``jax.vjp`` of the stage forward does in the
reference: only stage inputs live from a forward task to its backward, which
is what the scheduler's memory model assumes.

A stage spread over ``replicas`` intra-stage data replicas runs modules
captured at the replica's rows (the micro batch's rows / replicas): each
replica computes the loss over its own rows, and the executor averages
losses and gradients over the replicas (PyTorch DDP's rule; the
reference's GSPMD program computes the global mean, the same value for a
loss that is a mean over rows, as every model of the repo's is). Under an
initialized process group the stage cut is made on rank 0 and sent to
every rank (:func:`on_rank0`): the stage ILP stops at a time limit, and
ranks that cut alone could disagree.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tepdist_tpu_torch.core.tree import (tree_leaves, tree_map,
                                         tree_structure, tree_unflatten)
from tepdist_tpu_torch.graph.fx_graph import FxGraph, trace_graph
from tepdist_tpu_torch.parallel.graph_sketch import GraphSketch
from tepdist_tpu_torch.parallel.stage_decomposition import StageDecomposition


def stage_vjp(fn: Callable, ins: Sequence[Any],
              cots: Sequence[Optional[torch.Tensor]],
              ones_at: Optional[int] = None) -> Tuple[Any, ...]:
    """Cotangents of ``fn``'s inputs: ``fn(*ins)`` is run again under
    autograd on detached inputs (floating-point ones require grad) and
    ``torch.autograd.grad`` takes the output cotangents ``cots`` (ones for
    output ``ones_at``, the loss; ``None`` is a zero cotangent, an output
    with no consumer). Returns one entry per input: its gradient (zeros
    where the outputs do not depend on it), or ``None`` for an integer
    input, which has no cotangent (the reference's float0)."""
    leaves = [x.detach().requires_grad_() if x.is_floating_point() else x
              for x in ins]
    with torch.enable_grad():
        outs = fn(*leaves)
    diff_outs, diff_cots = [], []
    for k, o in enumerate(outs):
        c = torch.ones_like(o) if k == ones_at else cots[k]
        if c is None or not o.requires_grad:
            continue
        diff_outs.append(o)
        diff_cots.append(c)
    wrt = [x for x in leaves if x.requires_grad]
    grads = (torch.autograd.grad(diff_outs, wrt, diff_cots,
                                 allow_unused=True)
             if diff_outs and wrt else [None] * len(wrt))
    it = iter(grads)
    res = []
    for x in leaves:
        if not x.requires_grad:
            res.append(None)
            continue
        g = next(it)
        res.append(torch.zeros_like(x) if g is None else g)
    return tuple(res)


@dataclasses.dataclass
class PipelineProgram:
    """A planned pipeline: stage modules + wiring + batch info."""

    graph: FxGraph
    decomp: StageDecomposition
    num_stages: int
    num_micro_batches: int
    batch_flat_indices: List[int]   # graph invar indices carrying batch dim
    batch_dim: int
    in_tree: Any
    # The exploration winner's comm-dtype modifier for this program's
    # collectives/wire (""/"float32" = fidelity), read by
    # build_pipeline_task_dag (SEND/RECV tagging) and the executor's
    # gradient-accumulate payloads.
    comm_dtype: str = ""
    # ZeRO weight-update sharding modifier: each stage's optimizer state
    # is sharded over its intra-stage data replicas (the executor acts on
    # it where a stage has more than one replica).
    zero: bool = False
    # The stage planner (its ``solver_status`` and ``solve_seconds``) and
    # the capture's seconds, for reports.
    sketch: Optional[GraphSketch] = None
    trace_seconds: float = 0.0
    # The intra-stage data replicas the stage modules were captured for
    # (each runs micro rows / replicas), and what ``with_replicas`` needs
    # to capture the loss again for another count.
    replicas: int = 1
    loss_fn: Optional[Callable] = None
    example: Optional[Tuple[Any, Tuple[Any, ...]]] = None

    @property
    def stages(self):
        return self.decomp.stages

    def with_replicas(self, replicas: int) -> "PipelineProgram":
        """This program captured and cut again for ``replicas`` intra-stage
        data replicas (the modifiers carried over)."""
        if replicas == self.replicas:
            return self
        if self.loss_fn is None:
            raise ValueError("this program keeps no loss to capture again "
                             f"for {replicas} replicas: plan it with "
                             "plan_pipeline(..., replicas=...)")
        params, batch = self.example
        prog = plan_pipeline(self.loss_fn, self.num_stages,
                             self.num_micro_batches, params, *batch,
                             batch_dim=self.batch_dim, replicas=replicas)
        prog.comm_dtype, prog.zero = self.comm_dtype, self.zero
        return prog

    def stage_flops(self) -> List[float]:
        flops = [0.0] * self.num_stages
        for n in self.graph.nodes:
            s = self.decomp.assignment[n.id]
            if s >= 0:
                flops[s] += n.flops
        return flops

    # ------------------------------------------------------------------
    def forward_backward_micro(self) -> Callable:
        """Build ``(flat_args) -> (loss, {flat index: grad})`` for ONE micro
        batch, running stage fwds in order then stage bwds in reverse (the
        fwd/bwd task bodies the runtime schedules)."""
        decomp = self.decomp
        S = self.num_stages
        fwd_fns = decomp.forward_fns()
        batch_set = set(self.batch_flat_indices)
        loss_stage = next(s for s in range(S)
                          if 0 in decomp.stages[s].graph_out_map)
        loss_out = decomp.stages[loss_stage].graph_out_map[0]

        def run(flat_args: Sequence[Any]):
            stage_inputs: List[Tuple] = [None] * S
            stage_outputs: List[Tuple] = [None] * S
            with torch.no_grad():
                for s in range(S):
                    m = decomp.stages[s]
                    ins = []
                    for pos in range(len(m.invars)):
                        src = m.input_def_map[pos]
                        if src[0] == "arg":
                            ins.append(flat_args[src[1]])
                        else:
                            ins.append(stage_outputs[src[1]][src[2]])
                    stage_inputs[s] = tuple(ins)
                    stage_outputs[s] = fwd_fns[s](*ins)
            loss = stage_outputs[loss_stage][loss_out]

            # Backward sweep.
            cot: Dict[Tuple[int, int], Any] = {}
            grads: Dict[int, Any] = {}
            for s in range(S - 1, -1, -1):
                m = decomp.stages[s]
                outs_cot = [cot.get((s, k)) for k in range(len(m.outvars))]
                ones_at = loss_out if s == loss_stage else None
                if ones_at is None and all(c is None for c in outs_cot):
                    continue
                in_cots = stage_vjp(fwd_fns[s], stage_inputs[s], outs_cot,
                                    ones_at=ones_at)
                for pos, c in enumerate(in_cots):
                    src = m.input_def_map[pos]
                    if c is None:
                        continue
                    if src[0] == "arg":
                        i = src[1]
                        if i in batch_set:
                            continue
                        grads[i] = c if i not in grads else grads[i] + c
                    else:
                        key = (src[1], src[2])
                        cot[key] = c if key not in cot else cot[key] + c
            return loss, grads

        return run

    # ------------------------------------------------------------------
    def reference_step(self, apply_fn: Callable) -> Callable:
        """Sequential-semantics pipelined GA step (the correctness anchor):
        ``step(params, opt_state, *batch) -> (loss, params, opt_state)``,
        with ``apply_fn(params, opt_state, grads) -> (params, opt_state)``.

        Numerically what the 1F1B runtime computes: micro grads accumulate
        in the param dtype; the optimizer applies the mean."""
        micro_fn = self.forward_backward_micro()
        M = self.num_micro_batches
        bset = set(self.batch_flat_indices)
        bdim = self.batch_dim

        def step(params, opt_state, *batch):
            flat = tree_leaves(((params,) + tuple(batch), {}))
            param_leaf_count = len(tree_leaves(params))
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=flat[0].device)
            grad_acc: Dict[int, Any] = {}
            for mb in range(M):
                mb_flat = list(flat)
                for i in bset:
                    b = flat[i]
                    msize = b.shape[bdim] // M
                    mb_flat[i] = b.narrow(bdim, mb * msize, msize)
                loss, grads = micro_fn(mb_flat)
                loss_sum = loss_sum + loss
                for i, g in grads.items():
                    grad_acc[i] = g if i not in grad_acc else grad_acc[i] + g
            inv = 1.0 / M
            params_flat = flat[:param_leaf_count]
            grads_flat = []
            for i in range(param_leaf_count):
                g = grad_acc.get(i)
                grads_flat.append(
                    torch.zeros_like(params_flat[i]) if g is None else g * inv)
            grads_tree = tree_unflatten(tree_structure(params), grads_flat)
            new_params, new_opt = apply_fn(params, opt_state, grads_tree)
            return loss_sum * inv, new_params, new_opt

        return step


def micro_abstract_batch(batch, num_micro_batches: int, batch_dim: int = 0,
                         replicas: int = 1):
    """Batch trees cut to MICRO-batch shapes (the batch dim divided by M
    where it divides), and over ``replicas`` where that divides too — THE
    micro-shape trace contract: plan_pipeline traces the stage modules at
    these shapes, because the capture bakes constants such as mean
    denominators from the trace shapes. The leaves are views of the first
    slice (no copy): the capture reads only their shapes, dtypes and
    devices."""

    def micro(leaf):
        if not leaf.dim() or leaf.shape[batch_dim] % num_micro_batches:
            return leaf
        rows = leaf.shape[batch_dim] // num_micro_batches
        if rows % replicas == 0:
            rows //= replicas
        return leaf.narrow(batch_dim, 0, rows)

    return tuple(tree_map(micro, b) for b in batch)


def on_rank0(fn: Callable[[], Any]) -> Any:
    """``fn()`` on rank 0 of an initialized process group, its result sent
    to every rank (a search with a time limit decides once); without a
    group, or on one rank, ``fn()`` itself."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return fn()
    box = [fn() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def plan_pipeline(
    loss_fn: Callable,
    num_stages: int,
    num_micro_batches: int,
    params,
    *batch,
    batch_dim: int = 0,
    replicas: int = 1,
) -> PipelineProgram:
    """Capture, ILP-cut and decompose ``loss_fn(params, *batch)`` into a
    pipeline program (reference: AutoParallel pipeline path steps 3-5).

    The forward loss is captured on fake tensors at MICRO-batch shapes (no
    device memory): the stage modules are the per-micro-batch slices
    (reference: SyncFreeDecomposition builds CG over micro-batch shapes),
    so baked constants like mean denominators are right per micro batch.
    With ``replicas`` > 1 (intra-stage data parallelism) the shapes are a
    replica's share of the micro batch, and the first batch leaf's micro
    rows must divide over the replicas. Under a process group the cut is
    rank 0's (:func:`on_rank0`)."""
    leaves = tree_leaves(tuple(batch))
    if replicas > 1:
        rows = leaves[0].shape[batch_dim] if leaves else 0
        if not leaves or rows % (num_micro_batches * replicas):
            raise ValueError(
                f"intra-stage data parallelism over {replicas} replicas "
                f"needs the batch rows ({rows}) to divide into "
                f"{num_micro_batches} micro batches of {replicas} equal "
                "shares")
    micro_batch = micro_abstract_batch(batch, num_micro_batches, batch_dim,
                                       replicas)
    t0 = time.perf_counter()
    graph, in_tree, _ = trace_graph(loss_fn, params, *micro_batch,
                                    functional=True)
    trace_seconds = time.perf_counter() - t0
    sketch = GraphSketch(graph)
    assignment = on_rank0(lambda: sketch.stage_plan(num_stages))
    decomp = StageDecomposition(graph, assignment, num_stages)
    # Batch leaves: flat indices belonging to the batch args (everything
    # after the params leaves).
    n_param_leaves = len(tree_leaves(params))
    batch_flat = list(range(n_param_leaves, len(graph.invars)))
    return PipelineProgram(
        graph=graph,
        decomp=decomp,
        num_stages=num_stages,
        num_micro_batches=num_micro_batches,
        batch_flat_indices=batch_flat,
        batch_dim=batch_dim,
        in_tree=in_tree,
        sketch=sketch,
        trace_seconds=trace_seconds,
        replicas=replicas,
        loss_fn=loss_fn,
        example=(params, tuple(batch)),
    )
