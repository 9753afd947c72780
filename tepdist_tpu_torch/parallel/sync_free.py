"""Sync-free analysis and gradient accumulation: the port of
``tepdist_tpu/parallel/sync_free.py``.

The analysis (reference parity: ``SyncFreeSplittingAnalysis``) finds a
batch-dim split of the captured step graph whose largest part (forward and
backward up to the gradient sync points) runs per micro-batch without
cross-replica synchronization, and sizes ``num_micro_batches`` from the
activation-memory estimate. It runs on the port's captured aten graph
(``graph/fx_graph.py``) with the port's strategy rules.

The decomposition ENTRY -> {GAInit, CG, GA, AG} becomes one Python step
(``build_ga_step``): GAInit = zero accumulators shaped like the params,
CG = the per-micro-batch ``grad_fn``, GA = an add into the accumulator,
AG = the optimizer apply after the loop. Ported: the fidelity path, the
FP16_COMM bf16 compress path, the int8 comm dtype (stochastic-rounding
fake quantization, ``parallel/quantize.py``) and the explicit ZeRO update
(``zero_dp``: reduce-scatter, the apply on a shard, all-gather, over a
process group of data replicas, where the reference runs ``shard_map``).
On the SPMD path ZeRO is placements only
(``auto_parallel.apply_zero_sharding``); the pipeline executor shards its
stages' state in the same padded flat layout (``zero_pad_params``).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Optional, Tuple

import torch

from tepdist_tpu_torch.core.dist_spec import DimStrategy
from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.core.tree import tree_leaves, tree_map
from tepdist_tpu_torch.graph.cost import val_bytes
from tepdist_tpu_torch.graph.fx_graph import FxGraph, Var, var_val
from tepdist_tpu_torch.parallel.liveness import optimize_liveness
from tepdist_tpu_torch.parallel.performance_utils import chip_spec
from tepdist_tpu_torch.parallel.strategy_utils import StrategyUtil

log = logging.getLogger(__name__)


@dataclasses.dataclass
class SyncFreeResult:
    """Decision record of the analysis."""

    batch_arg_indices: List[int]     # flat invar indices carrying the batch dim
    batch_dims: Dict[int, int]       # arg index -> batch dim
    sync_free_fraction: float        # fraction of flops in the sync-free set
    num_micro_batches: int
    peak_activation_bytes: float


def find_sync_free_split(
    graph: FxGraph, candidate_args: Optional[List[int]] = None
) -> Optional[Tuple[Dict[int, int], float]]:
    """Find batch dims on data args such that forward propagation reaches a
    maximal flop fraction with partials only at gradient-shaped sinks
    (reference: SearchForMostSyncFreeInsts).

    Tries dim 0 of each non-matrix arg set; returns ({arg: dim}, fraction)."""
    n_probe = 2  # split factor used only for feasibility probing
    best: Optional[Tuple[Dict[int, int], float]] = None
    indices = candidate_args
    if indices is None:
        indices = list(range(len(graph.invars)))
    # Group candidate args by their dim-0 size: batch args share it.
    by_size: Dict[int, List[int]] = {}
    for i in indices:
        shape = tuple(var_val(graph.invars[i]).shape)
        if len(shape) >= 1 and shape[0] % n_probe == 0:
            by_size.setdefault(shape[0], []).append(i)
    for size, args in by_size.items():
        # Args whose dim 0 merely coincides with the batch size (e.g. a
        # [batch_like, d] weight) poison the split: drop any arg whose
        # inclusion lowers the sync-free fraction.
        assign = {i: 0 for i in args}
        frac = _probe_fraction(graph, assign, n_probe)
        for i in list(assign):
            if len(assign) == 1:
                break
            trial = {k: v for k, v in assign.items() if k != i}
            trial_frac = _probe_fraction(graph, trial, n_probe)
            if trial_frac > frac:
                assign, frac = trial, trial_frac
        if frac > 0 and (best is None or frac > best[1]):
            best = (assign, frac)
    return best


def _probe_fraction(graph: FxGraph, assign: Dict[int, int], n: int) -> float:
    """Forward-propagate the candidate split; return flop fraction of nodes
    that stay split or partial (i.e. run per-micro-batch sync-free)."""
    value: Dict[Var, DimStrategy] = {}
    for i, d in assign.items():
        value[graph.invars[i]] = DimStrategy.split_on(d, n)
    covered = 0.0
    total = graph.total_flops() or 1.0
    for node in graph.nodes:
        known = {}
        for k, a in enumerate(node.invars):
            if a in value and (value[a].is_split() or value[a].partial):
                known[k] = value[a]
        if not known:
            continue
        r = StrategyUtil.forward_infer(node, known, n)
        if r is None and len(known) > 1:
            r = StrategyUtil.forward_infer(
                node, dict([next(iter(known.items()))]), n)
        if r is None:
            continue
        moved = False
        for ov, s in zip(node.outvars, r.out_strategies):
            if ov is not None and (s.is_split() or s.partial):
                value[ov] = s
                moved = True
        if moved:
            covered += node.flops
    return covered / total


def estimate_peak_activation_bytes(graph: FxGraph) -> float:
    """Liveness-based peak estimate: sweep program order, tracking bytes of
    values whose last use is later (reference: memory feasibility input to
    the analysis / Evaluator). Every node output counts, views and aliases
    too, as the reference counts its reshape/transpose/broadcast outputs;
    the graph's inputs (params, batch) do not."""
    last_use: Dict[Var, int] = {}
    for node in graph.nodes:
        for a in node.invars:
            last_use[a] = node.id
    for a in graph.outvars:
        if a is not None:
            last_use[a] = len(graph.nodes) + 1
    live = 0.0
    peak = 0.0
    expiry: Dict[int, float] = {}
    for node in graph.nodes:
        for ov in node.outvars:
            if ov is not None and ov in last_use:
                b = val_bytes(var_val(ov))
                live += b
                expiry[last_use[ov]] = expiry.get(last_use[ov], 0.0) + b
        peak = max(peak, live)
        live -= expiry.pop(node.id, 0.0)
    return peak


def choose_num_micro_batches(
    graph: FxGraph,
    batch_size: int,
    hbm_budget_bytes: Optional[float] = None,
    usage_ratio: float = 0.6,
) -> int:
    env = ServiceEnv.get()
    if env.num_micro_batches > 0:
        return env.num_micro_batches
    if hbm_budget_bytes is None:
        hbm_budget_bytes = chip_spec().hbm_gb * 1e9
    peak = estimate_peak_activation_bytes(graph)
    budget = hbm_budget_bytes * usage_ratio
    n = 1
    while peak / n > budget and n < batch_size:
        n *= 2
    while batch_size % n != 0 and n > 1:
        n //= 2
    return max(1, n)


def analyze_sync_free(
    graph: FxGraph,
    batch_size: int,
    candidate_args: Optional[List[int]] = None,
    hbm_budget_bytes: Optional[float] = None,
) -> SyncFreeResult:
    # Liveness pre-pass (reference: HloLivenessOptimizer runs before the
    # planner): the peak estimate below sees shortened live ranges for
    # cheap duplicable producers.
    graph = optimize_liveness(graph)
    found = find_sync_free_split(graph, candidate_args)
    if found is None:
        return SyncFreeResult([], {}, 0.0, 1, estimate_peak_activation_bytes(graph))
    assign, frac = found
    n = choose_num_micro_batches(graph, batch_size, hbm_budget_bytes)
    return SyncFreeResult(
        batch_arg_indices=sorted(assign),
        batch_dims=assign,
        sync_free_fraction=frac,
        num_micro_batches=n,
        peak_activation_bytes=estimate_peak_activation_bytes(graph),
    )


# --------------------------------------------------------------------------
# The decomposition (constructive form)
# --------------------------------------------------------------------------


def zero_pad_flat(x: torch.Tensor, dp: int) -> torch.Tensor:
    """``x`` flattened and zero-padded to a multiple of ``dp``: the
    canonical ZeRO shard layout, contiguous 1/dp rows of the padded flat
    vector a replica."""
    flat = x.reshape(-1)
    pad = (-flat.numel()) % dp
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def zero_pad_params(params, zero_dp: int):
    """Params tree re-laid-out as padded flat leaves (``zero_pad_flat``).
    ``optimizer.init`` on this tree gives the GLOBAL optimizer state of
    the explicit ZeRO GA path: each moment leaf is a flat (dp * chunk,)
    vector whose contiguous 1/dp rows are one replica's shard."""
    return tree_map(lambda p: zero_pad_flat(p, zero_dp), params)


def zero_shard_params(params, zero_dp: int, index: int):
    """Replica ``index``'s rows of :func:`zero_pad_params` (copies): the
    params tree the step's ``opt_state`` is initialized over on that
    replica."""
    def shard(p):
        flat = zero_pad_flat(p, zero_dp)
        c = flat.numel() // zero_dp
        return flat[index * c:(index + 1) * c].clone()
    return tree_map(shard, params)


def _compress(grads):
    """The bf16 wire of FP16_COMM: round each floating gradient to bf16."""
    return tree_map(lambda g: g.to(torch.bfloat16)
                    if g.is_floating_point() else g, grads)


def build_ga_step(
    grad_fn: Callable,
    apply_fn: Callable,
    num_micro_batches: int,
    batch_argnums: Tuple[int, ...] = (1,),
    comm_dtype: str = "",
    zero_dp: int = 0,
    zero_axis_name=None,
) -> Callable:
    """Construct the sync-free GA training step.

    Args:
      grad_fn: ``(params, *batch) -> (loss, grads)`` per micro-batch.
      apply_fn: ``(params, opt_state, grads) -> (params, opt_state)``.
      num_micro_batches: micro-batches per step (a time axis).
      batch_argnums: positions (in the step signature after params and
        opt_state, params counting as 0) of batch args split along dim 0.
      comm_dtype: "" or "float32" (fidelity), "bfloat16" (round the
        per-micro gradient contributions to bf16, as FP16_COMM does) or
        "int8" (quantize->dequantize each contribution through int8 chunk
        scales with stochastic rounding, drawn from one generator seeded
        0x7e9d on the params' device).
      zero_dp / zero_axis_name: the explicit ZeRO-1 weight update
        (arXiv:2004.13336) over ``zero_axis_name``, the process group of
        ``zero_dp`` data replicas (one a process, each calling the step on
        its own rows): the accumulated gradient is reduce-scattered
        (``reduce_scatter_tensor``: the apply sees the SUM over the
        replicas on its 1/dp shard; fold your own 1/dp for a mean),
        ``apply_fn`` runs on the padded flat param and gradient SHARDS
        (init the optimizer on ``zero_shard_params(params, dp, rank)``),
        and the updated shards are all-gathered back to full shapes
        (``all_gather_into_tensor``). With a compressed comm dtype the
        reduce-scatter runs at bf16 (int8 contributions were quantized per
        micro batch already), and the all-gather at
        ``param_wire_dtype`` (bf16: params are never int8-quantized).

    Returns ``step(params, opt_state, *batch) -> (mean_loss, params,
    opt_state)``. As in the JAX package, the accumulator has the
    parameters' dtype, the loss sum is fp32, and both are scaled by
    1/num_micro_batches.
    """
    if comm_dtype not in ("", "float32", "bfloat16", "int8"):
        raise ValueError(f"comm_dtype {comm_dtype!r}: expected '', "
                         "'float32', 'bfloat16' or 'int8'")
    int8 = comm_dtype == "int8"
    compress = not int8 and (ServiceEnv.get().fp16_comm
                             or comm_dtype == "bfloat16")
    gens = {}
    zero = zero_dp > 1 and zero_axis_name is not None
    do_apply = apply_fn
    if zero:
        do_apply = _zero_apply(apply_fn, zero_dp, zero_axis_name,
                               comm_dtype, compress)

    def maybe_compress(grads):
        if int8:
            from tepdist_tpu_torch.parallel.quantize import fake_quant_grads
            dev = tree_leaves(grads)[0].device
            if dev not in gens:
                gens[dev] = torch.Generator(dev).manual_seed(0x7e9d)
            return fake_quant_grads(grads, gens[dev])
        return _compress(grads) if compress else grads

    if num_micro_batches <= 1:
        def step1(params, opt_state, *batch):
            loss, grads = grad_fn(params, *batch)
            if compress or int8:
                grads = tree_map(lambda g, p: g.to(p.dtype),
                                 maybe_compress(grads), params)
            params, opt_state = do_apply(params, opt_state, grads)
            return loss, params, opt_state
        return step1

    def step(params, opt_state, *batch):
        def resplit(i, b):
            if i + 1 not in batch_argnums:
                return [b] * num_micro_batches
            if b.shape[0] % num_micro_batches:
                raise ValueError(
                    f"batch dim {b.shape[0]} does not divide into "
                    f"{num_micro_batches} micro batches")
            return b.chunk(num_micro_batches)

        micro = list(zip(*(resplit(i, b) for i, b in enumerate(batch))))
        # GAInit: accumulators in the params' dtype (fp32 only where the
        # param is; under FP16_COMM only the contributions are compressed).
        acc = tree_map(torch.zeros_like, params)
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=tree_leaves(params)[0].device)
        for mb in micro:  # CG + GA
            loss, grads = grad_fn(params, *mb)
            grads = maybe_compress(grads)
            for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
                a.add_(g.to(a.dtype))
            loss_sum = loss_sum + loss
            del grads
        inv = 1.0 / num_micro_batches
        # 1/M in the accumulator's dtype, as JAX's weak typing rounds it.
        grads = tree_map(lambda g: g.mul_(torch.tensor(inv, dtype=g.dtype,
                                                       device=g.device)), acc)
        # AG: the apply-gradients slice (or the ZeRO RS -> apply -> AG).
        params, opt_state = do_apply(params, opt_state, grads)
        return loss_sum * inv, params, opt_state

    return step


def _zero_apply(apply_fn: Callable, zero_dp: int, group, comm_dtype: str,
                compress: bool) -> Callable:
    """The ZeRO-1 update over ``group`` (a process group or a
    ``GroupTransport``): reduce-scatter -> ``apply_fn`` on this replica's
    shards -> all-gather; the params tree is updated in place."""
    from tepdist_tpu_torch.ops.seq_comm import GroupTransport, Transport
    from tepdist_tpu_torch.parallel.performance_utils import (
        param_wire_dtype)

    comm = group if isinstance(group, Transport) else GroupTransport(group)
    if comm.size != zero_dp:
        raise ValueError(f"zero_dp={zero_dp} over a group of {comm.size}")
    ag_bf16 = param_wire_dtype(comm_dtype) == "bfloat16"

    def rs(g):
        flat = zero_pad_flat(g, zero_dp)
        if compress and flat.is_floating_point():
            # The bf16 wire: the sum is reduced at bf16, the shard comes
            # back in the gradient's dtype.
            return comm.reduce_scatter_raw(
                [flat.to(torch.bfloat16)])[0].to(g.dtype)
        return comm.reduce_scatter_raw([flat])[0]

    def apply(params, opt_state, grads):
        rank = comm.ranks[0]
        p_shards = zero_shard_params(params, zero_dp, rank)
        g_shards = tree_map(rs, grads)
        p_shards, opt_state = apply_fn(p_shards, opt_state, g_shards)

        def ag(sh, p):
            if ag_bf16 and sh.is_floating_point():
                sh = sh.to(torch.bfloat16)
            full = comm.all_gather_raw([sh])[0]
            with torch.no_grad():
                p.copy_(full[:p.numel()].view(p.shape).to(p.dtype))
            return p

        return tree_map(ag, p_shards, params), opt_state

    return apply
