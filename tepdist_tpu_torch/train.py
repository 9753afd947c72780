"""Training entry point: the port of ``tepdist_tpu/train.py::plan_training``
for one device.

    plan = plan_training(loss_fn, adamw_bf16(1e-4), params, tokens,
                         num_micro_batches=2)
    for _ in range(steps):
        loss = plan.step(tokens)

On one device the JAX planner's exploration picks plain SPMD over a
one-device data mesh with no ZeRO, comm dtype or pipeline, so what remains
is the GA step of ``build_ga_step`` followed by the optimizer apply. The
micro count is passed explicitly (or by NUM_MICRO_BATCHES); without one,
the plan captures the loss-and-grad step on fake tensors (``trace_graph``)
and takes it from the sync-free analysis, as the JAX package's SPMD path
does (``plan.sync_free``, ``plan.topology``). The plan owns
its state and updates it in place (the JAX plan donates its buffers
instead): the tensors passed as ``params`` are the plan's state when they
already lie on the device. ``save`` and ``restore`` write and read the JAX
package's checkpoint format by flat leaf index of ``(params, opt_state)``,
so a plan of either package resumes from the other's checkpoint.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Optional

import torch

from tepdist_tpu_torch.core import remat
from tepdist_tpu_torch.core.device import resolve_device
from tepdist_tpu_torch.core.mesh import MeshTopology
from tepdist_tpu_torch.core.service_env import ServiceEnv
from tepdist_tpu_torch.core.tree import tree_leaves, tree_map, tree_unflatten
from tepdist_tpu_torch.graph.fx_graph import trace_graph
from tepdist_tpu_torch.parallel.sync_free import (SyncFreeResult,
                                                  analyze_sync_free,
                                                  build_ga_step)
from tepdist_tpu_torch.runtime.checkpoint import CheckpointUtil

log = logging.getLogger(__name__)


class TrainingPlan:
    """Device-resident (params, opt_state) and the step that updates them."""

    def __init__(self, step_fn: Callable, params, opt_state,
                 device: torch.device, topology: MeshTopology,
                 sync_free: Optional[SyncFreeResult] = None):
        self._step_fn = step_fn
        self._params = params
        self._opt_state = opt_state
        self.device = device
        # The [micro (time), data] topology of the plan, and the analysis
        # that sized the micro count (None when the caller gave it).
        self.topology = topology
        self.sync_free = sync_free
        # One CheckpointUtil per (directory, max_to_keep), so overlapping
        # async saves serialize on its lock.
        self._ckpt_utils = {}

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

    def _device_state(self):
        """Flat state leaves, still on the device (the checkpoint writer
        copies them to the host one variable at a time)."""
        return tree_leaves(self.variables())

    def save(self, directory: str, step: int, max_to_keep: int = 5,
             block: bool = True):
        """Checkpoint the training state. ``block=False`` snapshots
        device->host now and writes on a background thread; returns an
        AsyncSaveHandle (call .result() before shutdown)."""
        key = (directory, max_to_keep)
        if key not in self._ckpt_utils:
            self._ckpt_utils[key] = CheckpointUtil(directory, max_to_keep)
        util = self._ckpt_utils[key]
        variables = {str(i): v for i, v in enumerate(self._device_state())}
        if block:
            util.save(step, variables)
            return None
        return util.save_async(step, variables)

    def restore(self, directory: str, step: int = -1) -> int:
        """Load a checkpoint of this package or the JAX package into the
        plan's state; returns the step restored."""
        data, got = CheckpointUtil(directory).restore(step)
        self._load([data[str(i)] for i in range(len(data))])
        return got

    @torch.no_grad()
    def _load(self, leaves) -> None:
        """Copy host leaves into the live state tensors, in place."""
        live = self._device_state()
        if len(leaves) != len(live):
            raise ValueError(f"checkpoint holds {len(leaves)} leaves, the "
                             f"plan's state {len(live)}")
        for dst, src in zip(live, leaves):
            if tuple(src.shape) != tuple(dst.shape) or src.dtype != dst.dtype:
                raise ValueError(
                    f"checkpoint leaf {tuple(src.shape)} {src.dtype} does "
                    f"not fit the plan's {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(src)


_REMAT_POLICIES = {**remat.POLICIES, "true": None, "1": None}


def _remat(loss_fn: Callable) -> Callable:
    """REMAT_POLICY knob: "full" (or "true"/"1") recomputes the whole loss
    in backward; "dots" keeps every matmul output and "dots_no_batch"
    those without a batch dimension. Another value is ignored with a
    warning, as in the JAX package."""
    policy = ServiceEnv.get().remat_policy
    if not policy or policy == "none":
        return loss_fn
    if policy not in _REMAT_POLICIES:
        log.warning("unknown REMAT_POLICY %r ignored", policy)
        return loss_fn
    return remat.remat(loss_fn, _REMAT_POLICIES[policy])


def value_and_grad(loss_fn: Callable) -> Callable:
    """``(params, *batch) -> (loss, grads)`` of ``loss_fn``: the JAX
    package's ``jax.value_and_grad(loss_fn)``, on detached leaves."""
    def grad_fn(p, *b):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(p)]
        with torch.enable_grad():
            loss = loss_fn(tree_unflatten(p, leaves), *b)
            grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tree_unflatten(p, list(grads))
    return grad_fn


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
    package, every batch arg splits into micro batches along dim 0. With no
    micro count (argument or NUM_MICRO_BATCHES), the step is captured on
    fake tensors made from ``params`` and the example batch, and the
    sync-free analysis sizes it from the peak-activation estimate against
    the chip's HBM (``parallel/performance_utils.chip_spec``)."""
    dev = resolve_device(device)
    env = ServiceEnv.get()
    if num_micro_batches is None and env.num_micro_batches > 0:
        num_micro_batches = env.num_micro_batches
    if num_micro_batches is None and not example_batch:
        raise ValueError("without num_micro_batches (or NUM_MICRO_BATCHES) "
                         "the sync-free analysis needs an example batch")
    params = tree_map(lambda p: p.to(dev), params)
    opt_state = optimizer.init(params)
    grad_fn = value_and_grad(_remat(loss_fn))

    res = None
    if num_micro_batches is None:
        graph, _, _ = trace_graph(grad_fn, params, *example_batch)
        n_param_leaves = len(tree_leaves(params))
        batch_leaves = tree_leaves(example_batch)
        res = analyze_sync_free(
            graph, batch_size=batch_leaves[0].shape[0],
            candidate_args=list(range(n_param_leaves,
                                      n_param_leaves + len(batch_leaves))))
        num_micro_batches = res.num_micro_batches
        log.info("sync-free analysis: %d micro batches "
                 "(%.0f%% sync-free flops)", num_micro_batches,
                 100 * res.sync_free_fraction)

    def apply_fn(p, s, g):
        return p, optimizer.apply(p, g, s)

    step_fn = build_ga_step(grad_fn, apply_fn, num_micro_batches,
                            batch_argnums=tuple(
                                range(1, 1 + max(1, len(example_batch)))))
    axes = [("data", 1)]
    if num_micro_batches > 1:
        topology = MeshTopology([("micro", num_micro_batches)] + axes,
                                share_dev_flags=[True, False])
    else:
        topology = MeshTopology(axes)
    return TrainingPlan(step_fn, params, opt_state, dev, topology, res)
