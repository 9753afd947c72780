"""Training entry point: the port of ``tepdist_tpu/train.py::plan_training``
for one device.

    plan = plan_training(loss_fn, adamw_bf16(1e-4), params, tokens,
                         num_micro_batches=2)
    for _ in range(steps):
        loss = plan.step(tokens)

On one device the JAX planner's exploration picks plain SPMD over a
one-device data mesh with no ZeRO, comm dtype or pipeline, so what remains
is the GA step of ``build_ga_step`` followed by the optimizer apply. The
micro count is passed explicitly (or by NUM_MICRO_BATCHES): the sync-free
analysis that sizes it from the traced graph is not ported. The plan owns
its state and updates it in place (the JAX plan donates its buffers
instead): the tensors passed as ``params`` are the plan's state when they
already lie on the device.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from tepdist_tpu_torch.core.device import resolve_device
from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from tepdist_tpu_torch.parallel.sync_free import build_ga_step

log = logging.getLogger(__name__)


class TrainingPlan:
    """Device-resident (params, opt_state) and the step that updates them."""

    def __init__(self, step_fn: Callable, params, opt_state,
                 device: torch.device):
        self._step_fn = step_fn
        self._params = params
        self._opt_state = opt_state
        self.device = device

    def step(self, *batch) -> float:
        env = ServiceEnv.get()
        t0 = time.perf_counter()
        batch = tuple(b.to(self.device) for b in batch)
        loss, self._params, self._opt_state = self._step_fn(
            self._params, self._opt_state, *batch)
        loss = float(loss)  # waits for the step
        if env.debug:
            log.info("[ExecutePlan Duration] %.3f ms",
                     (time.perf_counter() - t0) * 1e3)
        return loss

    def variables(self):
        """(params, opt_state): the live state tensors, not copies."""
        return self._params, self._opt_state


def _remat(loss_fn: Callable) -> Callable:
    """REMAT_POLICY knob: "full" (or "true"/"1") recomputes the whole loss
    in backward; the JAX package's "dots" policies are not ported."""
    policy = ServiceEnv.get().remat_policy
    if not policy or policy == "none":
        return loss_fn
    if policy not in ("full", "true", "1"):
        raise ValueError(f"REMAT_POLICY {policy!r} is not ported; expected "
                         "'none' or 'full'")

    def remat_loss(p, *b):
        return checkpoint(loss_fn, p, *b, use_reentrant=False)
    return remat_loss


def plan_training(
    loss_fn: Callable,
    optimizer,
    params,
    *example_batch,
    num_micro_batches: Optional[int] = None,
    device="cuda",
) -> TrainingPlan:
    """Plan a training loop for ``loss_fn(params, *batch)`` on one device.

    ``optimizer`` has ``init(params)`` and ``apply(params, grads, state)``
    (``optim.adamw_bf16``). ``params`` is a tree of tensors; it is moved to
    ``device`` (default the card, which must exist). As in the JAX
    package, every batch arg splits into micro batches along dim 0; the
    example batch only counts them (the port traces nothing)."""
    dev = resolve_device(device)
    env = ServiceEnv.get()
    if num_micro_batches is None:
        if env.num_micro_batches <= 0:
            raise ValueError(
                "num_micro_batches is required (or NUM_MICRO_BATCHES): the "
                "sync-free analysis that sizes it is not ported")
        num_micro_batches = env.num_micro_batches
    params = tree_map(lambda p: p.to(dev), params)
    opt_state = optimizer.init(params)
    loss_of = _remat(loss_fn)

    def grad_fn(p, *b):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
        with torch.enable_grad():
            loss = loss_of(tree_unflatten(p, leaves), *b)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(p, list(grads))

    def apply_fn(p, s, g):
        return p, optimizer.apply(p, g, s)

    step_fn = build_ga_step(grad_fn, apply_fn, num_micro_batches,
                            batch_argnums=tuple(
                                range(1, 1 + max(1, len(example_batch)))))
    return TrainingPlan(step_fn, params, opt_state, dev)
