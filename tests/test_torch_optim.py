"""The port's optimizers held against the JAX package's: ``adamw_bf16``
against its optax chain (``tepdist_tpu.optim.adamw_bf16``), and ``sgd``
(plain, momentum, Nesterov), ``adam`` and ``adamw`` against optax, for
three steps each, on the CPU.

sgd, adam and adamw: every state leaf (params, traces, counts, moments) at
fp32 within rtol 1e-6 / atol 1e-7 (jitted XLA contracts ``p + u * -lr``
and the moment updates into FMAs, a last-bit difference); at bf16 bit for
bit, since both sides round each op to bf16 at the same places.

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

import pytest

from tepdist_tpu import optim as joptim
from tepdist_tpu.optim import adamw_bf16 as jax_adamw_bf16
from tepdist_tpu_torch import convert, optim
from tepdist_tpu_torch.core.tree import tree_leaves
from tepdist_tpu_torch.optim import adamw_bf16

torch.set_num_threads(2)

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


OPTAX_CASES = {
    "sgd": dict(learning_rate=0.1),
    "sgd_momentum": dict(learning_rate=0.1, momentum=0.9),
    "sgd_nesterov": dict(learning_rate=0.1, momentum=0.9, nesterov=True),
    "adam": dict(learning_rate=1e-2),
    "adamw": dict(learning_rate=1e-2, weight_decay=0.1),
}


def _run_both(name, kwargs, dtype, mask=None):
    """Three steps of the optax optimizer and the port's on the same
    params and grads; both final (params, state) as flat fp32 leaves."""
    base = name.split("_")[0]
    rng = np.random.default_rng(1)

    def tree():
        return {"w": jnp.asarray(rng.standard_normal((32, 48)) * 0.1, dtype),
                "b": jnp.asarray(rng.standard_normal((48,)) * 0.1, dtype)}

    jparams, grads = tree(), [tree() for _ in range(3)]
    extra = {} if mask is None else {"mask": mask}
    tx = getattr(optax, base)(**kwargs, **extra)
    opt = getattr(optim, base)(**kwargs, **extra)
    jstate = tx.init(jparams)
    tparams = convert.to_torch(jax.device_get(jparams), device="cpu")
    tstate = opt.init(tparams)

    @jax.jit
    def jstep(p, s, g):
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s

    for g in grads:
        jparams, jstate = jstep(jparams, jstate, g)
        tstate = opt.apply(tparams, convert.to_torch(jax.device_get(g),
                                                     device="cpu"), tstate)
    ref = [np.asarray(x, np.float32)
           for x in jax.tree_util.tree_leaves((jparams, jstate))]
    got = [x.float().numpy() for x in tree_leaves((tparams, tstate))]
    assert len(got) == len(ref)
    return got, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(OPTAX_CASES))
def test_optax_optimizers_match(name, dtype):
    got, ref = _run_both(name, OPTAX_CASES[name], getattr(jnp, dtype))
    for a, b in zip(got, ref):
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        else:
            np.testing.assert_array_equal(a, b)


def test_adamw_mask_matches_optax():
    """Decay on the matrix only: a tree of bools and a callable agree."""
    mask = {"b": False, "w": True}
    got, ref = _run_both("adamw", OPTAX_CASES["adamw"], jnp.float32, mask)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
    got2, _ = _run_both("adamw", OPTAX_CASES["adamw"], jnp.float32,
                        lambda p: {k: k == "w" for k in p})
    for a, b in zip(got, got2):
        np.testing.assert_array_equal(a, b)


def test_adamw_bf16_mask_matches_jax_chain():
    rng = np.random.default_rng(2)
    jparams = _to_jax(_params(rng))
    grads = [_to_jax(_params(rng)) for _ in range(3)]
    mask = {"w": True, "b": False, "ln_g": False}
    tx = jax_adamw_bf16(LR, mask=mask)
    jstate = tx.init(jparams)
    tparams = convert.to_torch(jax.device_get(jparams), device="cpu")
    opt = adamw_bf16(LR, mask=mask)
    tstate = opt.init(tparams)

    @jax.jit
    def jstep(p, s, g):
        updates, s = tx.update(g, s, p)
        return optax.apply_updates(p, updates), s

    for g in grads:
        jparams, jstate = jstep(jparams, jstate, g)
        tstate = opt.apply(tparams, convert.to_torch(jax.device_get(g),
                                                     device="cpu"), tstate)
    for name in ("w", "b", "ln_g"):
        np.testing.assert_array_equal(tparams[name].float().numpy(),
                                      np.asarray(jparams[name], np.float32))


@pytest.mark.parametrize("name", ["sgd", "adam", "adamw", "adamw_bf16"])
def test_spec_round_trip(name):
    spec = optim.optimizer_spec(name, learning_rate=0.5)
    assert spec == joptim.optimizer_spec(name, learning_rate=0.5)
    opt = optim.make_optimizer(spec)
    assert opt.learning_rate == 0.5
    assert type(opt) is type(getattr(optim, name)(0.5))


def test_spec_unknown_name_raises():
    with pytest.raises(KeyError, match="unknown optimizer"):
        optim.optimizer_spec("lamb", learning_rate=1.0)
    with pytest.raises(KeyError, match="unknown optimizer"):
        optim.make_optimizer({"name": "lamb", "learning_rate": 1.0})


def test_state_leaves_line_up_with_optax():
    """Flat state leaves (count, mu, nu / trace) in optax's order and
    shapes, so checkpoints cross by index."""
    params = {"w": np.zeros((3, 2), np.float32), "b": np.zeros(2, np.float32)}
    tparams = convert.to_torch(params, device="cpu")
    for tx, opt in ((optax.adamw(0.1), optim.adamw(0.1)),
                    (optax.sgd(0.1, momentum=0.9), optim.sgd(0.1, 0.9)),
                    (optax.sgd(0.1), optim.sgd(0.1))):
        want = jax.tree_util.tree_leaves(tx.init(params))
        got = tree_leaves(opt.init(tparams))
        assert [np.shape(a) for a in want] == [tuple(t.shape) for t in got]
        assert [str(np.asarray(a).dtype) for a in want] == [
            str(t.dtype)[6:] for t in got]
