"""Activations of the port's models, at the reference's granularity when
captured.

Eagerly each is one fused aten op (``F.gelu``, ``F.silu``), whose autograd
keeps only its input. The JAX package's ``jax.nn.gelu`` and ``jax.nn.silu``
are chains of primitives, and its jaxpr keeps their intermediates for the
backward. On fake tensors, that is while ``graph/fx_graph.trace_graph``
captures a step, these functions run the same chains, so the planner's
peak-activation estimate and costs count what the reference's count; the
step itself runs the fused ops.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation of GELU (``jax.nn.gelu``'s default)."""
    if isinstance(x, FakeTensor):
        cdf = 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                      * (x + 0.044715 * x ** 3)))
        return x * cdf
    return F.gelu(x, approximate="tanh")


def silu(x: torch.Tensor) -> torch.Tensor:
    if isinstance(x, FakeTensor):
        return x * torch.sigmoid(x)
    return F.silu(x)
