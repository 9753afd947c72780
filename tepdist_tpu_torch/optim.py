"""AdamW with bf16 moment storage: the port of ``tepdist_tpu/optim.py``.

Both Adam moments are stored in bfloat16 (4 bytes/param of optimizer state);
all moment math runs in fp32. The arithmetic and its roundings follow the
JAX package's optax chain ``scale_by_adam_bf16 -> add_decayed_weights ->
scale(-lr)`` and ``optax.apply_updates`` step by step:

1. mu, nu in fp32 from the stored bf16 moments and the gradient;
2. the direction ``(mu / c1) / (sqrt(nu / c2) + eps)`` is cast to the
   gradient's dtype *before* weight decay;
3. ``+ weight_decay * p`` on every leaf (LayerNorm and biases included,
   since the JAX recipe passes no mask), then ``* -lr``, each in the
   parameter's dtype, with the two rates themselves rounded to that dtype
   as JAX's weak typing rounds a Python scalar;
4. ``p + update`` in the parameter's dtype.

The port applies the update in place, one leaf at a time, where the JAX
package returns new (donated) arrays: the transient fp32 moments then never
exceed one leaf.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from tepdist_tpu_torch.core.tree import tree_leaves, tree_map


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
                 weight_decay: float = 0.01):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay

    def init(self, params) -> Dict[str, object]:
        """{"count": int32 scalar, "mu": bf16 tree, "nu": bf16 tree}; flat
        leaves line up with the JAX chain's state leaves."""
        device = tree_leaves(params)[0].device

        def zeros(p):
            return torch.zeros_like(p, dtype=torch.bfloat16)

        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_map(zeros, params),
                "nu": tree_map(zeros, params)}

    @torch.no_grad()
    def apply(self, params, grads, state):
        count = state["count"] + 1
        cf = count.float()
        c1 = 1 - torch.tensor(self.b1, dtype=torch.float32,
                              device=cf.device) ** cf
        c2 = 1 - torch.tensor(self.b2, dtype=torch.float32,
                              device=cf.device) ** cf
        leaves = zip(tree_leaves(params), tree_leaves(grads),
                     tree_leaves(state["mu"]), tree_leaves(state["nu"]))
        for p, g, mu, nu in leaves:
            u, mu_new, nu_new = scale_by_adam_bf16(
                g, mu, nu, c1, c2, self.b1, self.b2, self.eps)
            mu.copy_(mu_new)
            nu.copy_(nu_new)
            # JAX gives a Python scalar the array's dtype (weak typing),
            # so the decay rate and -lr are rounded to p's dtype first.
            wd = torch.tensor(self.weight_decay, dtype=p.dtype,
                              device=p.device)
            neg_lr = torch.tensor(-self.learning_rate, dtype=p.dtype,
                                  device=p.device)
            u = (u.to(p.dtype) + wd * p) * neg_lr
            p.add_(u)
        return {"count": count, "mu": state["mu"], "nu": state["nu"]}


def adamw_bf16(learning_rate: float, b1: float = 0.9, b2: float = 0.95,
               eps: float = 1e-8, weight_decay: float = 0.01) -> AdamWBf16:
    """AdamW with bf16 moment storage (4 bytes/param optimizer state)."""
    return AdamWBf16(learning_rate, b1=b1, b2=b2, eps=eps,
                     weight_decay=weight_decay)
