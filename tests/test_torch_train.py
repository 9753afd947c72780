"""The port's GA step and ``plan_training`` held against the JAX package,
on the CPU.

Tolerances: the GA property (micro-batched step == full-batch step) is the
JAX test's own (loss rtol 1e-5, params rtol 1e-4 / atol 1e-6). The 3-step
trajectory at ``CONFIGS["test"]`` (fp32 params, bf16 Adam moments): losses
rtol 1e-5, since fp32 sums in another order move them by ~1e-7 relative;
params atol 2e-5, since a gradient that differs in its last fp32 bits can
round a bf16 moment to the neighbouring value, which moves that element's
update by up to lr * 2**-7 (1e-3 * 2**-7 = 8e-6) per step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tepdist_tpu.models import gpt2 as jgpt2
from tepdist_tpu.optim import adamw_bf16 as jax_adamw_bf16
from tepdist_tpu.train import plan_training as jax_plan_training
from tepdist_tpu_torch import convert
from tepdist_tpu_torch.core.tree import tree_leaves, tree_map
from tepdist_tpu_torch.models import gpt2 as tgpt2
from tepdist_tpu_torch.optim import adamw_bf16
from tepdist_tpu_torch.parallel.sync_free import build_ga_step
from tepdist_tpu_torch.train import plan_training

torch.set_num_threads(2)

LR = 1e-3


def _mlp_setup(batch=64, din=32, dh=96, dout=8):
    rng = np.random.default_rng(0)
    params = {"w1": torch.tensor(rng.standard_normal((din, dh)) * 0.1,
                                 dtype=torch.float32),
              "w2": torch.tensor(rng.standard_normal((dh, dout)) * 0.1,
                                 dtype=torch.float32)}
    x = torch.tensor(rng.standard_normal((batch, din)), dtype=torch.float32)
    y = torch.tensor(rng.standard_normal((batch, dout)), dtype=torch.float32)

    def loss_fn(p, x, y):
        return ((torch.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2).mean()

    def grad_fn(p, x, y):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(p)]
        loss = loss_fn(dict(zip(sorted(p), leaves)), x, y)
        return loss.detach(), dict(zip(sorted(p), torch.autograd.grad(
            loss, leaves)))

    return grad_fn, params, x, y


def _sgd_apply(p, s, g):
    return tree_map(lambda a, b: a - 0.1 * b, p, g), s


def test_ga_step_matches_full_batch():
    grad_fn, params, x, y = _mlp_setup()
    full = build_ga_step(grad_fn, _sgd_apply, 1)
    ga = build_ga_step(grad_fn, _sgd_apply, 8, batch_argnums=(1, 2))
    l1, p1, _ = full(params, None, x, y)
    l2, p2, _ = ga(params, None, x, y)
    np.testing.assert_allclose(float(l1), float(l2), rtol=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("comm_dtype", ["", "bfloat16"])
def test_ga_step_matches_jax_build_ga_step(comm_dtype):
    """The port's GA step against the JAX package's, fidelity and the
    bf16-compressed (FP16_COMM) path: same MLP, data and SGD apply. The
    bf16 path rounds each micro gradient to bf16, so an fp32 gradient that
    differs in its last bits can round one bf16 step (2**-8 relative) the
    other way: params atol 0.1 * 2**-8 * max|grad| there, 1e-6 otherwise."""
    import optax

    from tepdist_tpu.parallel.sync_free import build_ga_step as jax_ga

    grad_fn, params, x, y = _mlp_setup()

    def jloss(p, x, y):
        return jnp.mean((jnp.tanh(x @ p["w1"]) @ p["w2"] - y) ** 2)

    tx = optax.sgd(0.1)
    jstep = jax_ga(lambda p, x, y: jax.value_and_grad(jloss)(p, x, y),
                   lambda p, s, g: (optax.apply_updates(
                       p, tx.update(g, s, p)[0]), s),
                   4, batch_argnums=(1, 2), comm_dtype=comm_dtype)
    jp = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
    jl, jp, _ = jax.jit(jstep)(jp, tx.init(jp), x.numpy(), y.numpy())

    tstep = build_ga_step(grad_fn, _sgd_apply, 4, batch_argnums=(1, 2),
                          comm_dtype=comm_dtype)
    tl, tp, _ = tstep(params, None, x, y)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    _, g = grad_fn(params, x, y)
    for k in sorted(params):
        atol = 1e-6
        if comm_dtype:
            atol += 0.1 * 2.0 ** -8 * g[k].abs().max().item()
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   atol=atol, rtol=0)


def _trajectories(jdtype, tdtype):
    """3-step losses of the JAX and the port's plan_training on the same
    weights and tokens, and both final params (flat fp32 numpy leaves)."""
    cfg_j = dataclasses.replace(jgpt2.CONFIGS["test"], attn="flash",
                                remat=True, loss_chunk=16, dtype=jdtype)
    cfg_t = dataclasses.replace(tgpt2.CONFIGS["test"], attn="flash",
                                remat=True, loss_chunk=16, dtype=tdtype)
    params = jgpt2.stacked_init_params(cfg_j, jax.random.PRNGKey(0))
    toks = jgpt2.fake_batch(cfg_j, 4, 32, seed=0)
    tparams = convert.to_torch(jax.device_get(params), device="cpu")
    ttoks = torch.tensor(np.asarray(toks))
    jplan = jax_plan_training(
        lambda p, t: jgpt2.loss_fn_stacked(p, t, cfg_j),
        jax_adamw_bf16(LR), params, toks, num_micro_batches=2,
        devices=jax.devices()[:1])
    tplan = plan_training(
        lambda p, t: tgpt2.loss_fn_stacked(p, t, cfg_t), adamw_bf16(LR),
        tparams, ttoks, num_micro_batches=2, device="cpu")
    jl = [jplan.step(toks) for _ in range(3)]
    tl = [tplan.step(ttoks) for _ in range(3)]
    jp = [np.asarray(jnp.asarray(a, jnp.float32))
          for a in jax.tree_util.tree_leaves(jplan.variables()[0])]
    tp = [a.float().numpy() for a in tree_leaves(tplan.variables()[0])]
    assert len(jp) == len(tp)
    return np.array(jl), np.array(tl), jp, tp


@pytest.fixture(scope="module")
def fp32_trajectories():
    return _trajectories(jnp.float32, torch.float32)


def test_plan_training_trajectory_matches_jax(fp32_trajectories):
    jl, tl, jp, tp = fp32_trajectories
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)


def test_plan_training_trajectory_matches_jax_bf16(fp32_trajectories):
    """bf16 params. Losses within twice the JAX bf16-vs-fp32 gap per step.
    Params: Adam moves an element by about lr per step whatever its
    gradient's size, so a gradient near zero that rounds differently flips
    that element's update; over all elements, the share that differ from
    JAX's by more than lr/2, and the largest difference, may be at most
    twice those between JAX's own bf16 and fp32 runs."""
    jl, tl, jp, tp = _trajectories(jnp.bfloat16, torch.bfloat16)
    jl32, _, jp32, _ = fp32_trajectories
    assert np.all(np.abs(tl - jl) <= 2 * np.abs(jl - jl32) + 1e-6)
    assert tl[-1] < tl[0]
    got, ref, ref32 = (np.concatenate([a.ravel() for a in leaves])
                       for leaves in (tp, jp, jp32))
    diff, gap = np.abs(got - ref), np.abs(ref - ref32)
    assert (diff > LR / 2).mean() <= 2 * (gap > LR / 2).mean()
    assert diff.max() <= 2 * gap.max()


def test_plan_training_needs_a_micro_count():
    cfg = tgpt2.CONFIGS["test"]
    params = tgpt2.init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="num_micro_batches"):
        plan_training(lambda p, t: tgpt2.loss_fn(p, t, cfg), adamw_bf16(LR),
                      params, device="cpu")


def test_plan_training_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    cfg = tgpt2.CONFIGS["test"]
    params = tgpt2.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        plan_training(lambda p, t: tgpt2.loss_fn(p, t, cfg), adamw_bf16(LR),
                      params, num_micro_batches=2)


@pytest.mark.parametrize("policy", ["full", "dots", "dots_no_batch",
                                    "bogus"])
def test_remat_policy_knob(policy, caplog):
    """REMAT_POLICY wraps the loss in the named checkpoint policy, which
    changes no value (losses and params as without it, fp32 rtol 1e-6);
    an unknown value is ignored with a warning, as in the JAX package."""
    from tepdist_tpu_torch.core.service_env import ServiceEnv

    cfg = dataclasses.replace(tgpt2.CONFIGS["test"], attn="flash")
    params = tgpt2.init_params(cfg, seed=0, device="cpu")
    toks = tgpt2.fake_batch(cfg, 4, 16, seed=0, device="cpu")

    def run():
        plan = plan_training(
            lambda p, t: tgpt2.loss_fn(p, t, cfg), adamw_bf16(LR),
            tree_map(torch.clone, params), toks, num_micro_batches=2,
            device="cpu")
        return ([plan.step(toks) for _ in range(2)],
                tree_leaves(plan.variables()[0]))

    want_l, want_p = run()
    try:
        ServiceEnv.reset({"REMAT_POLICY": policy})
        with caplog.at_level("WARNING"):
            got_l, got_p = run()
    finally:
        ServiceEnv.reset()
    np.testing.assert_allclose(got_l, want_l, rtol=1e-6)
    for a, b in zip(got_p, want_p):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    assert ("unknown REMAT_POLICY" in caplog.text) == (policy == "bogus")
