"""Rematerialisation by ``torch.utils.checkpoint``, with the JAX package's
checkpoint policies as selective-checkpoint policies.

A policy is the set of ops whose outputs the forward keeps; every other
op of the region is recomputed in backward. ``None`` keeps nothing but the
region's inputs (``jax.checkpoint`` with no policy, "full"). The dot sets
follow ``jax.checkpoint_policies``: ``checkpoint_dots`` keeps every matmul
output, ``dots_with_no_batch_dims_saveable`` only those without a batch
dimension. ``x @ w`` with a 3-D ``x`` dispatches to ``mm`` (no batch
dimension), as its ``dot_general`` has none in JAX; the einsums of
attention dispatch to ``bmm``.
"""

from __future__ import annotations

import functools
from typing import Callable, FrozenSet, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

_aten = torch.ops.aten
NO_BATCH_DOTS: FrozenSet = frozenset({_aten.mm.default, _aten.addmm.default})
DOTS: FrozenSet = NO_BATCH_DOTS | {_aten.bmm.default,
                                   _aten.baddbmm.default}
# Policy name -> the ops whose outputs it keeps. Callers extend it with
# their own names (the knob's aliases, a model's tagged outputs).
POLICIES = {"full": None, "dots": DOTS, "dots_no_batch": NO_BATCH_DOTS}


def _context(saved: FrozenSet):
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def remat(fn: Callable, saved: Optional[FrozenSet] = None) -> Callable:
    """``fn`` under a non-reentrant checkpoint that keeps the outputs of
    the ops in ``saved`` (None: keep nothing, recompute all)."""
    kwargs = {}
    if saved is not None:
        kwargs["context_fn"] = functools.partial(_context, saved)

    def wrapped(*args):
        return checkpoint(fn, *args, use_reentrant=False, **kwargs)
    return wrapped
