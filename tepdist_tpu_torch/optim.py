"""Optimizers: the port of ``tepdist_tpu/optim.py`` and the optax
optimizers it names (``sgd``, ``adam``, ``adamw``).

Each optimizer has ``init(params) -> state`` and ``apply(params, grads,
state) -> state``, which updates params in place, one leaf at a time (the
JAX package returns new, donated arrays instead). States are dicts whose
flat leaves line up with the optax states' leaves, so checkpoints cross
between the packages:

- ``sgd``: ``{}``, or ``{"trace": tree}`` with momentum (optax's
  ``TraceState``);
- ``adam`` / ``adamw``: ``{"count", "mu", "nu"}`` with the moments in the
  param dtype (optax's ``ScaleByAdamState``);
- ``adamw_bf16``: ``{"count", "mu", "nu"}`` with bf16 moments.

The arithmetic follows the optax chains op by op, each op in the leaf's
dtype, with every Python-scalar rate rounded to that dtype first, as JAX's
weak typing rounds it (``0.01 * p`` with a bf16 ``p`` multiplies by
bf16(0.01)).

``adamw_bf16`` stores both Adam moments in bf16 (4 bytes/param of state)
and runs all moment math in fp32 (``scale_by_adam_bf16 ->
add_decayed_weights -> scale(-lr)``):

1. mu, nu in fp32 from the stored bf16 moments and the gradient;
2. the direction ``(mu / c1) / (sqrt(nu / c2) + eps)`` is cast to the
   gradient's dtype *before* weight decay;
3. ``+ weight_decay * p`` on every leaf the mask selects (all without a
   mask), then ``* -lr``, each in the parameter's dtype;
4. ``p + update`` in the parameter's dtype.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from tepdist_tpu_torch.core.tree import tree_leaves, tree_map

Mask = Optional[Union[Any, Callable[[Any], Any]]]


def _rate(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar rounded to ``like``'s dtype (JAX's weak typing)."""
    return torch.tensor(x, dtype=like.dtype, device=like.device)


def _decay_mask(mask: Mask, params) -> List[bool]:
    """Per flat leaf, whether weight decay applies: a tree of bools shaped
    like the params, or a callable that makes one (optax's ``mask``)."""
    n = len(tree_leaves(params))
    if mask is None:
        return [True] * n
    if callable(mask):
        mask = mask(params)
    flags = [bool(m) for m in tree_leaves(mask)]
    if len(flags) != n:
        raise ValueError(f"mask has {len(flags)} leaves, params {n}")
    return flags


def _bias_corrections(count: torch.Tensor, b1: float, b2: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``1 - b ** count`` for both moments."""
    cf = count.float()
    one = torch.ones((), dtype=torch.float32, device=cf.device)
    return (one - torch.tensor(b1, dtype=torch.float32,
                               device=cf.device) ** cf,
            one - torch.tensor(b2, dtype=torch.float32,
                               device=cf.device) ** cf)


def _zeros_count(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


class Sgd:
    """optax ``sgd``: ``trace`` (``t = g + momentum * t``) when momentum is
    set, then ``scale(-lr)``."""

    def __init__(self, learning_rate: float,
                 momentum: Optional[float] = None, nesterov: bool = False):
        self.learning_rate = learning_rate
        self.momentum, self.nesterov = momentum, nesterov

    def init(self, params) -> Dict[str, Any]:
        if self.momentum is None:
            return {}
        return {"trace": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def apply(self, params, grads, state):
        traces = (tree_leaves(state["trace"]) if self.momentum is not None
                  else [None] * len(tree_leaves(params)))
        for p, g, t in zip(tree_leaves(params), tree_leaves(grads), traces):
            u = g
            if t is not None:
                t.copy_(g + _rate(self.momentum, g) * t)
                u = g + _rate(self.momentum, g) * t if self.nesterov else t
            p.add_((u * _rate(-self.learning_rate, u)).to(p.dtype))
        return state


class Adam:
    """optax ``adam`` (``weight_decay=None``) and ``adamw``:
    ``scale_by_adam -> [add_decayed_weights] -> scale(-lr)``, moments in
    the param dtype."""

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: Optional[float] = None, mask: Mask = None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.mask = weight_decay, mask

    def init(self, params) -> Dict[str, Any]:
        return {"count": _zeros_count(params),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    @torch.no_grad()
    def apply(self, params, grads, state):
        count = state["count"] + 1
        c1, c2 = _bias_corrections(count, self.b1, self.b2)
        decay = _decay_mask(self.mask, params)
        leaves = zip(tree_leaves(params), tree_leaves(grads),
                     tree_leaves(state["mu"]), tree_leaves(state["nu"]),
                     decay)
        for p, g, mu, nu, d in leaves:
            mu.copy_(_rate(1 - self.b1, g) * g + _rate(self.b1, mu) * mu)
            nu.copy_(_rate(1 - self.b2, g) * (g * g)
                     + _rate(self.b2, nu) * nu)
            u = (mu / c1.to(mu.dtype)) / (
                torch.sqrt(nu / c2.to(nu.dtype)) + _rate(self.eps, nu))
            if self.weight_decay is not None and d:
                u = u + _rate(self.weight_decay, u) * p
            p.add_((u * _rate(-self.learning_rate, u)).to(p.dtype))
        return {"count": count, "mu": state["mu"], "nu": state["nu"]}


def scale_by_adam_bf16(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                       c1: torch.Tensor, c2: torch.Tensor, b1: float,
                       b2: float, eps: float
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One leaf of Adam: (direction in g's dtype, new bf16 mu, new bf16
    nu). ``c1``/``c2`` are the fp32 bias corrections 1 - b**count."""
    g32 = g.float()
    mu32 = b1 * mu.float() + (1 - b1) * g32
    nu32 = b2 * nu.float() + (1 - b2) * torch.square(g32)
    direction = ((mu32 / c1) / (torch.sqrt(nu32 / c2) + eps)).to(g.dtype)
    return direction, mu32.to(torch.bfloat16), nu32.to(torch.bfloat16)


class AdamWBf16:
    """``adamw_bf16``: ``init(params)`` makes the state, ``apply(params,
    grads, state)`` updates params in place and returns the new state."""

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.01, mask: Mask = None):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.mask = weight_decay, mask

    def init(self, params) -> Dict[str, Any]:
        """{"count": int32 scalar, "mu": bf16 tree, "nu": bf16 tree}; flat
        leaves line up with the JAX chain's state leaves."""
        def zeros(p):
            return torch.zeros_like(p, dtype=torch.bfloat16)

        return {"count": _zeros_count(params),
                "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def apply(self, params, grads, state):
        count = state["count"] + 1
        c1, c2 = _bias_corrections(count, self.b1, self.b2)
        leaves = zip(tree_leaves(params), tree_leaves(grads),
                     tree_leaves(state["mu"]), tree_leaves(state["nu"]),
                     _decay_mask(self.mask, params))
        for p, g, mu, nu, d in leaves:
            u, mu_new, nu_new = scale_by_adam_bf16(
                g, mu, nu, c1, c2, self.b1, self.b2, self.eps)
            mu.copy_(mu_new)
            nu.copy_(nu_new)
            u = u.to(p.dtype)
            if d:
                u = u + _rate(self.weight_decay, p) * p
            p.add_(u * _rate(-self.learning_rate, p))
        return {"count": count, "mu": state["mu"], "nu": state["nu"]}


def sgd(learning_rate: float, momentum: Optional[float] = None,
        nesterov: bool = False) -> Sgd:
    """optax.sgd: plain SGD, or heavy-ball / Nesterov momentum."""
    return Sgd(learning_rate, momentum=momentum, nesterov=nesterov)


def adam(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Adam:
    """optax.adam (moments in the param dtype)."""
    return Adam(learning_rate, b1=b1, b2=b2, eps=eps)


def adamw(learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4,
          mask: Mask = None) -> Adam:
    """optax.adamw: Adam plus decoupled weight decay on the masked leaves."""
    return Adam(learning_rate, b1=b1, b2=b2, eps=eps,
                weight_decay=weight_decay, mask=mask)


def adamw_bf16(learning_rate: float, b1: float = 0.9, b2: float = 0.95,
               eps: float = 1e-8, weight_decay: float = 0.01,
               mask: Mask = None) -> AdamWBf16:
    """AdamW with bf16 moment storage (4 bytes/param optimizer state)."""
    return AdamWBf16(learning_rate, b1=b1, b2=b2, eps=eps,
                     weight_decay=weight_decay, mask=mask)


# Declarative optimizer specs (the wire form of an optimizer), as in the
# JAX package: a name and its hyperparameters.

_OPTIMIZERS = {
    "sgd": sgd,
    "adam": adam,
    "adamw": adamw,
    "adamw_bf16": adamw_bf16,
}


def optimizer_spec(name: str, **kwargs) -> dict:
    """Build a wire-serializable optimizer spec; validates the name."""
    if name not in _OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; "
                       f"known: {sorted(_OPTIMIZERS)}")
    return {"name": name, **kwargs}


def make_optimizer(spec: dict):
    """Reconstruct the optimizer from its wire spec."""
    spec = dict(spec)
    name = spec.pop("name")
    if name not in _OPTIMIZERS:
        raise KeyError(f"unknown optimizer {name!r}; "
                       f"known: {sorted(_OPTIMIZERS)}")
    return _OPTIMIZERS[name](**spec)
