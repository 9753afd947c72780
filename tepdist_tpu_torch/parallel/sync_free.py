"""Sync-free gradient accumulation: the port of ``build_ga_step`` from
``tepdist_tpu/parallel/sync_free.py``.

The reference decomposition ENTRY -> {GAInit, CG, GA, AG} becomes one
Python step: GAInit = zero accumulators shaped like the params, CG = the
per-micro-batch ``grad_fn``, GA = an add into the accumulator, AG = the
optimizer apply after the loop. Ported: the fidelity path and the
FP16_COMM bf16 compress path. Not ported: ZeRO, the int8 comm dtype and
``analyze_sync_free`` (the micro count is passed in).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.core.tree import tree_leaves, tree_map


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
) -> Callable:
    """Construct the sync-free GA training step.

    Args:
      grad_fn: ``(params, *batch) -> (loss, grads)`` per micro-batch.
      apply_fn: ``(params, opt_state, grads) -> (params, opt_state)``.
      num_micro_batches: micro-batches per step (a time axis).
      batch_argnums: positions (in the step signature after params and
        opt_state, params counting as 0) of batch args split along dim 0.
      comm_dtype: "" or "float32" (fidelity) or "bfloat16" (round the
        per-micro gradient contributions to bf16, as FP16_COMM does).

    Returns ``step(params, opt_state, *batch) -> (mean_loss, params,
    opt_state)``. As in the JAX package, the accumulator has the
    parameters' dtype, the loss sum is fp32, and both are scaled by
    1/num_micro_batches.
    """
    if comm_dtype not in ("", "float32", "bfloat16"):
        raise ValueError(f"comm_dtype {comm_dtype!r} is not ported; "
                         "expected '', 'float32' or 'bfloat16'")
    compress = ServiceEnv.get().fp16_comm or comm_dtype == "bfloat16"

    if num_micro_batches <= 1:
        def step1(params, opt_state, *batch):
            loss, grads = grad_fn(params, *batch)
            if compress:
                grads = tree_map(lambda g, p: g.to(p.dtype),
                                 _compress(grads), params)
            params, opt_state = apply_fn(params, opt_state, grads)
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
            if compress:
                grads = _compress(grads)
            for a, g in zip(tree_leaves(acc), tree_leaves(grads)):
                a.add_(g.to(a.dtype))
            loss_sum = loss_sum + loss
            del grads
        inv = 1.0 / num_micro_batches
        # 1/M in the accumulator's dtype, as JAX's weak typing rounds it.
        grads = tree_map(lambda g: g.mul_(torch.tensor(inv, dtype=g.dtype,
                                                       device=g.device)), acc)
        # AG: the apply-gradients slice.
        params, opt_state = apply_fn(params, opt_state, grads)
        return loss_sum * inv, params, opt_state

    return step
