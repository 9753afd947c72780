"""The port's ``adamw_bf16`` held against the JAX package's optax chain
(``tepdist_tpu.optim.adamw_bf16``) for three steps, on the CPU.

Params mix bf16 matrices and fp32 vectors, as GPT-2's do; grads come from
one numpy seed. Params match bit for bit. The bf16 moments match bit for
bit on almost every element: both sides compute in fp32 and round to bf16
at the same places, but where jitted XLA contracts ``b1 * m + (1 - b1) * g``
into an FMA the fp32 result can round to the other side of a bf16 step. So
at most 1% of moment elements may differ, by at most one bf16 step per
optimizer step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from tepdist_tpu.optim import adamw_bf16 as jax_adamw_bf16
from tepdist_tpu_torch import convert
from tepdist_tpu_torch.core.tree import tree_leaves
from tepdist_tpu_torch.optim import adamw_bf16

LR = 1e-2


def _params(rng):
    return {"w": rng.standard_normal((32, 48)).astype(np.float32) * 0.1,
            "b": np.zeros((48,), np.float32),
            "ln_g": np.ones((48,), np.float32)}


def _to_jax(tree):
    return {"w": jnp.asarray(tree["w"], jnp.bfloat16),
            "b": jnp.asarray(tree["b"], jnp.bfloat16),
            "ln_g": jnp.asarray(tree["ln_g"], jnp.float32)}


def _close_bf16(a, b, steps=3):
    """Equal on >= 99% of elements; elsewhere within one bf16 step (ulp)
    per optimizer step, since a flipped rounding carries into the next."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    differ = a != b
    assert differ.mean() <= 0.01, differ.mean()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(b[differ]) + 1e-38)) - 7)
    assert np.all(np.abs(a - b)[differ] <= steps * ulp)


def test_three_steps_match_optax_chain():
    rng = np.random.default_rng(0)
    jparams = _to_jax(_params(rng))
    grads = [_to_jax(_params(rng)) for _ in range(3)]
    tx = jax_adamw_bf16(LR)
    jstate = tx.init(jparams)

    tparams = convert.to_torch(jax.device_get(jparams), device="cpu")
    opt = adamw_bf16(LR)
    tstate = opt.init(tparams)

    @jax.jit
    def jstep(p, s, g):
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s

    for g in grads:
        jparams, jstate = jstep(jparams, jstate, g)
        tg = convert.to_torch(jax.device_get(g), device="cpu")
        tstate = opt.apply(tparams, tg, tstate)

    adam = jstate[0]
    assert int(tstate["count"]) == int(adam.count) == 3
    for name in ("w", "b", "ln_g"):
        np.testing.assert_array_equal(tparams[name].float().numpy(),
                                      np.asarray(jparams[name], np.float32))
    for mine, ref in ((tstate["mu"], adam.mu), (tstate["nu"], adam.nu)):
        for a, b in zip(tree_leaves(mine),
                        jax.tree_util.tree_leaves(ref)):
            assert a.dtype == torch.bfloat16
            _close_bf16(a.float().numpy(), np.asarray(b, np.float32))


def test_decay_applies_to_every_leaf():
    """No mask: LayerNorm gains and zero-grad biases decay too."""
    p = {"g": torch.ones(4), "b": torch.ones(4, dtype=torch.bfloat16)}
    opt = adamw_bf16(0.1, weight_decay=0.5)
    state = opt.init(p)
    opt.apply(p, {"g": torch.zeros(4),
                  "b": torch.zeros(4, dtype=torch.bfloat16)}, state)
    assert torch.all(p["g"] < 1) and torch.all(p["b"] < 1)
