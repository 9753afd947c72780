"""The port's other model families (tepdist_tpu_torch.models.gpt_moe,
wide_resnet and mlp) held against the JAX package's at their test
configs, on the CPU: same weights (the JAX init, through the weight
bridge), same inputs from a numpy seed, loss and every grad leaf.

Tolerances: loss rtol 1e-5 and grads atol 1e-5 / rtol 1e-4 (fp32 sums in
another order), as ``test_torch_gpt2.py``; a single conv's output atol
1e-5 / rtol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tepdist_tpu.models import gpt2 as jgpt2
from tepdist_tpu.models import gpt_moe as jmoe
from tepdist_tpu.models import mlp as jmlp
from tepdist_tpu.models import wide_resnet as jwrn
from tepdist_tpu_torch import convert
from tepdist_tpu_torch.core.tree import tree_leaves
from tepdist_tpu_torch.models import gpt_moe as tmoe
from tepdist_tpu_torch.models import mlp as tmlp
from tepdist_tpu_torch.models import wide_resnet as twrn

torch.set_num_threads(2)


def _compare(jloss, tloss, params, *inputs):
    """Loss and grads of ``jloss(params, *inputs)`` (JAX, numpy params)
    and ``tloss`` on the same weights and inputs."""
    val, grads = jax.jit(jax.value_and_grad(jloss))(params, *inputs)
    ref = [np.asarray(g, np.float32) for g in jax.tree_util.tree_leaves(grads)]
    tparams = convert.to_torch(params, device="cpu")
    leaves = [p.requires_grad_() for p in tree_leaves(tparams)]
    tval = tloss(tparams, *(torch.tensor(np.asarray(x)) for x in inputs))
    got = torch.autograd.grad(tval, leaves)
    np.testing.assert_allclose(tval.item(), float(val), rtol=1e-5)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.float().numpy(), b, atol=1e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5],
                         ids=["roomy", "dropping"])
def test_gpt_moe_matches_jax(capacity_factor):
    """At 0.5 the experts' capacity is below the tokens routed to them, so
    the capacity cut drops tokens."""
    jcfg = dataclasses.replace(jmoe.CONFIGS["test"],
                               capacity_factor=capacity_factor)
    tcfg = dataclasses.replace(tmoe.CONFIGS["test"],
                               capacity_factor=capacity_factor)
    params = jax.device_get(jmoe.init_params(jcfg, jax.random.PRNGKey(0)))
    toks = np.asarray(jgpt2.fake_batch(jcfg.base, 2, 16, seed=1))
    _compare(lambda p, t: jmoe.loss_fn(p, t, jcfg),
             lambda p, t: tmoe.loss_fn(p, t, tcfg), params, toks)


def test_gpt_moe_init_layout():
    cfg = tmoe.CONFIGS["test"]
    got = tree_leaves(tmoe.init_params(cfg, seed=0, device="cpu"))
    want = jax.tree_util.tree_leaves(jmoe.init_params(
        jmoe.CONFIGS["test"], jax.random.PRNGKey(0)))
    assert [tuple(t.shape) for t in got] == [a.shape for a in want]


def test_wide_resnet_matches_jax():
    """The test config has a block with ``shortcut: None`` (stage 0) and
    one with a 1x1 stride-2 shortcut (stage 1); 16x16 images make every
    stride-2 SAME conv pad asymmetrically."""
    jcfg, tcfg = jwrn.CONFIGS[-1], twrn.CONFIGS[-1]
    params = jax.device_get(jwrn.init_params(jcfg, jax.random.PRNGKey(0)))
    assert params["s0b0"]["shortcut"] is None
    assert params["s1b0"]["shortcut"] is not None
    rng = np.random.default_rng(0)
    images = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    labels = rng.integers(0, jcfg.num_classes, 2).astype(np.int32)
    _compare(lambda p, x, y: jwrn.loss_fn(p, x, y, jcfg),
             lambda p, x, y: twrn.loss_fn(p, x, y, tcfg), params, images,
             labels)


def test_wide_resnet_init_layout():
    got = twrn.init_params(twrn.CONFIGS[-1], seed=0, device="cpu")
    want = jwrn.init_params(jwrn.CONFIGS[-1], jax.random.PRNGKey(0))
    assert got["s0b0"]["shortcut"] is None
    assert [tuple(t.shape) for t in tree_leaves(got)] == [
        a.shape for a in jax.tree_util.tree_leaves(want)]


@pytest.mark.parametrize("size,k,stride", [(224, 7, 2), (15, 7, 2),
                                           (16, 3, 2), (16, 1, 2),
                                           (9, 3, 1)])
def test_same_conv_matches_xla(size, k, stride):
    """``padding="SAME"`` with stride 2 on an even input pads one more
    after than before (the 7x7 stem on 224 pads 2 and 3)."""
    rng = np.random.default_rng(size + k)
    x = rng.standard_normal((1, size, size, 3)).astype(np.float32)
    w = rng.standard_normal((k, k, 3, 4)).astype(np.float32)
    want = jax.lax.conv_general_dilated(
        x, w, window_strides=(stride, stride), padding="SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = twrn._conv(torch.tensor(x), torch.tensor(w), stride)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    if (size, k, stride) == (224, 7, 2):
        assert twrn._same_pads(224, 7, 2) == (2, 3)


def test_mlp_losses_match_jax():
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(0)
    params = jax.device_get(jmlp.init_mlp(key, depth=3))
    x = rng.standard_normal((8, 32)).astype(np.float32)
    y = rng.standard_normal((8, 8)).astype(np.float32)
    _compare(jmlp.mlp_loss, tmlp.mlp_loss, params, x, y)

    params = jax.device_get(jmlp.init_attention(key))
    x = rng.standard_normal((2, 8, 64)).astype(np.float32)
    y = rng.standard_normal((2, 8, 64)).astype(np.float32)
    _compare(jmlp.attention_loss, tmlp.attention_loss, params, x, y)

    params = jax.device_get(jmlp.init_conv(key))
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, 2).astype(np.int32)
    _compare(jmlp.conv_loss, tmlp.conv_loss, params, x, y)


def test_mlp_inits_layout():
    pairs = ((tmlp.init_mlp(depth=3, device="cpu"),
              jmlp.init_mlp(jax.random.PRNGKey(0), depth=3)),
             (tmlp.init_attention(device="cpu"),
              jmlp.init_attention(jax.random.PRNGKey(0))),
             (tmlp.init_conv(device="cpu"),
              jmlp.init_conv(jax.random.PRNGKey(0))))
    for got, want in pairs:
        assert [tuple(t.shape) for t in tree_leaves(got)] == [
            a.shape for a in jax.tree_util.tree_leaves(want)]


def test_bf16_models_run_and_keep_dtypes():
    """bf16 configs run forward and backward with bf16 weights."""
    cfg = dataclasses.replace(twrn.CONFIGS[-1], dtype=torch.bfloat16)
    params = twrn.init_params(cfg, device="cpu")
    x = torch.randn(2, 16, 16, 3)
    loss = twrn.loss_fn(params, x, torch.tensor([1, 2]), cfg)
    assert torch.isfinite(loss)
    assert params["stem"].dtype == torch.bfloat16
    mcfg = dataclasses.replace(
        tmoe.CONFIGS["test"],
        base=dataclasses.replace(tmoe.CONFIGS["test"].base,
                                 dtype=torch.bfloat16))
    mparams = tmoe.init_params(mcfg, device="cpu")
    toks = torch.randint(0, 512, (2, 9))
    assert torch.isfinite(tmoe.loss_fn(mparams, toks, mcfg))


def test_weight_bridge_carries_a_tree_with_none():
    """The weight bridge crosses Wide ResNet's tree (``shortcut: None``),
    each JAX leaf dtype mapped to the port's, bf16 included."""
    cfg = dataclasses.replace(jwrn.CONFIGS[-1], dtype=jnp.bfloat16)
    params = jax.device_get(jwrn.init_params(cfg, jax.random.PRNGKey(0)))
    tparams = convert.to_torch(params, device="cpu")
    assert tparams["s0b0"]["shortcut"] is None
    for a, t in zip(jax.tree_util.tree_leaves(params), tree_leaves(tparams)):
        assert str(t.dtype)[6:] == str(a.dtype)
