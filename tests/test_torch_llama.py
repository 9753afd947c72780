"""The port's Llama (tepdist_tpu_torch.models.llama) held against the JAX
package's model at ``CONFIGS["test"]`` (4 query heads over 2 KV heads, so
the GQA repeat's order matters), on the CPU.

Both sides get the same weights (the JAX init, through the weight bridge)
and the same tokens. ``attn="flash"`` runs the JAX Pallas kernels in
interpret mode and the port's kernels' plain versions.

Tolerances: fp32 loss rtol 1e-5 and grads atol 1e-5 / rtol 1e-4 (fp32 sums
in another order), as ``test_torch_gpt2.py``. bf16: each grad leaf and the
per-token losses within twice the relative L2 gap between the JAX model's
bf16 and fp32 runs on the same weights. One ``plan_training`` step with
``adamw``: the loss rtol 1e-5 and params atol 2e-5 against the JAX plan's
step, except where the gradient is below 100 * eps (1e-6): there Adam's
first step g / (|g| + eps) turns on the gradient's last bits, so those
elements are held only to Adam's bound on a step, 2 * lr.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tepdist_tpu.models import llama as jllama
from tepdist_tpu.train import plan_training as jax_plan_training
from tepdist_tpu_torch import convert
from tepdist_tpu_torch.core.tree import tree_leaves
from tepdist_tpu_torch.models import llama as tllama
from tepdist_tpu_torch.optim import adamw
from tepdist_tpu_torch.train import plan_training

torch.set_num_threads(2)


def _cfgs(attn, dtype_j=jnp.float32, dtype_t=torch.float32):
    return (dataclasses.replace(jllama.CONFIGS["test"], attn=attn,
                                dtype=dtype_j),
            dataclasses.replace(tllama.CONFIGS["test"], attn=attn,
                                dtype=dtype_t))


def _setup(cfg_j):
    params = jax.device_get(jllama.init_params(cfg_j,
                                               jax.random.PRNGKey(0)))
    toks = np.asarray(jllama.fake_batch(cfg_j, 2, 32, seed=3))
    return params, toks


def _jax_value_and_grad(params, toks, cfg):
    val, grads = jax.jit(jax.value_and_grad(
        lambda p: jllama.loss_fn(p, toks, cfg)))(params)
    return float(val), [np.asarray(jnp.asarray(g, jnp.float32))
                        for g in jax.tree_util.tree_leaves(grads)]


def _torch_value_and_grad(params, toks, cfg):
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    val = tllama.loss_fn(params, toks, cfg)
    grads = torch.autograd.grad(val, leaves)
    return val.item(), [g.float().numpy() for g in grads]


@pytest.mark.parametrize("attn", ["einsum", "flash"])
def test_loss_and_grads_match_jax_fp32(attn):
    cfg_j, cfg_t = _cfgs(attn)
    assert cfg_t.n_kv_head < cfg_t.n_head
    params, toks = _setup(cfg_j)
    l_ref, g_ref = _jax_value_and_grad(params, toks, cfg_j)
    l_got, g_got = _torch_value_and_grad(
        convert.to_torch(params, device="cpu"), torch.tensor(toks), cfg_t)
    np.testing.assert_allclose(l_got, l_ref, rtol=1e-5)
    assert len(g_got) == len(g_ref)
    for a, b in zip(g_got, g_ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_token_ce(params, toks, cfg):
    logits = jax.jit(lambda p: jllama.forward(p, toks[:, :-1], cfg))(params)
    gold = jnp.take_along_axis(logits, toks[:, 1:, None], -1)[..., 0]
    return np.asarray(jax.nn.logsumexp(logits, -1) - gold).ravel()


def _torch_token_ce(params, toks, cfg):
    with torch.no_grad():
        logits = tllama.forward(params, toks[:, :-1], cfg)
        gold = logits.gather(-1, toks[:, 1:, None])[..., 0]
        return (torch.logsumexp(logits, -1) - gold).numpy().ravel()


def test_loss_and_grads_match_jax_bf16():
    cfg_j, cfg_t = _cfgs("flash", jnp.bfloat16, torch.bfloat16)
    cfg_j32 = dataclasses.replace(cfg_j, dtype=jnp.float32)
    params, toks = _setup(cfg_j)
    params32 = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                      params)
    tparams = convert.to_torch(params, device="cpu")
    ttoks = torch.tensor(toks).long()
    _, g16 = _jax_value_and_grad(params, toks, cfg_j)
    _, g32 = _jax_value_and_grad(params32, toks, cfg_j32)
    _, g_got = _torch_value_and_grad(tparams, ttoks, cfg_t)
    c16 = _jax_token_ce(params, toks, cfg_j)
    c32 = _jax_token_ce(params32, toks, cfg_j32)
    c_got = _torch_token_ce(tparams, ttoks, cfg_t)
    assert _rel_l2(c_got, c16) <= 2 * _rel_l2(c16, c32)
    for a, b, b32 in zip(g_got, g16, g32):
        assert _rel_l2(a, b) <= 2 * _rel_l2(b, b32)


def test_plan_training_step_matches_jax():
    cfg_j, cfg_t = _cfgs("flash")
    params, toks = _setup(cfg_j)
    jplan = jax_plan_training(
        lambda p, t: jllama.loss_fn(p, t, cfg_j), optax.adamw(1e-3),
        jax.tree_util.tree_map(np.array, params), toks,
        num_micro_batches=1, devices=jax.devices()[:1])
    tplan = plan_training(
        lambda p, t: tllama.loss_fn(p, t, cfg_t), adamw(1e-3),
        convert.to_torch(params, device="cpu"), torch.tensor(toks),
        num_micro_batches=1, device="cpu")
    _, grads = _torch_value_and_grad(convert.to_torch(params, device="cpu"),
                                     torch.tensor(toks), cfg_t)
    np.testing.assert_allclose(tplan.step(torch.tensor(toks)),
                               jplan.step(toks), rtol=1e-5)
    jp = jax.tree_util.tree_leaves(jplan.variables()[0])
    tp = tree_leaves(tplan.variables()[0])
    assert len(jp) == len(tp) == len(grads)
    for a, b, g in zip(tp, jp, grads):
        atol = np.where(np.abs(g) < 1e-6, 2e-3, 2e-5)
        assert np.all(np.abs(a.numpy() - np.asarray(b)) <= atol)


def test_rope_and_rms_norm_keep_the_input_dtype():
    x = torch.randn(2, 4, 8, 16).to(torch.bfloat16)
    assert tllama._rope(x, 10000.0).dtype == torch.bfloat16
    g = torch.ones(16)
    assert tllama._rms_norm(x, g).dtype == torch.bfloat16


def test_init_params_layout():
    cfg = tllama.CONFIGS["test"]
    params = tllama.init_params(cfg, seed=0, device="cpu")
    ref = jax.device_get(jllama.init_params(jllama.CONFIGS["test"],
                                            jax.random.PRNGKey(0)))
    got = tree_leaves(params)
    want = jax.tree_util.tree_leaves(ref)
    assert [tuple(t.shape) for t in got] == [a.shape for a in want]
    assert [str(t.dtype)[6:] for t in got] == [str(a.dtype) for a in want]
