"""The port's GPT-2 (tepdist_tpu_torch.models.gpt2) held against the JAX
package's model at ``CONFIGS["test"]``, on the CPU.

Both sides get the same weights (the JAX init, through the weight bridge)
and the same tokens. The model runs the flash path with per-block remat
and a chunked loss whose chunk does not divide the token count; the JAX
side runs its Pallas kernels in interpret mode, the port its kernels' plain
versions.

Tolerances: fp32 loss rtol 1e-5 and grads atol 1e-5 / rtol 1e-4 (fp32 sums
in another order across ~10^2-term dots). bf16: derived from the reference,
as twice the gap between the JAX model's bf16 and fp32 runs on the same
weights (the port rounds to bf16 at other places: eager PyTorch rounds
after every op, where XLA keeps fused intermediates in fp32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tepdist_tpu.models import gpt2 as jgpt2
from tepdist_tpu_torch import convert
from tepdist_tpu_torch.core.tree import tree_leaves
from tepdist_tpu_torch.models import gpt2 as tgpt2

torch.set_num_threads(2)

FLASH = dict(attn="flash", remat=True, loss_chunk=48)  # 4*32 tokens: ragged


def _cfgs(dtype_j=jnp.float32, dtype_t=torch.float32):
    return (dataclasses.replace(jgpt2.CONFIGS["test"], dtype=dtype_j,
                                **FLASH),
            dataclasses.replace(tgpt2.CONFIGS["test"], dtype=dtype_t,
                                **FLASH))


def _jax_value_and_grad(loss, params, toks, cfg):
    val, grads = jax.jit(jax.value_and_grad(
        lambda p: loss(p, toks, cfg)))(params)
    return float(val), [np.asarray(jnp.asarray(g, jnp.float32))
                        for g in jax.tree_util.tree_leaves(grads)]


def _torch_value_and_grad(loss, params, toks, cfg):
    leaves = [p.requires_grad_() for p in tree_leaves(params)]
    val = loss(params, toks, cfg)
    grads = torch.autograd.grad(val, leaves)
    return val.item(), [g.float().numpy() for g in grads]


def _batch(cfg_j):
    return jgpt2.fake_batch(cfg_j, 4, 32, seed=3)


@pytest.mark.parametrize("stacked", [False, True],
                         ids=["unrolled", "stacked"])
def test_loss_and_grads_match_jax_fp32(stacked):
    cfg_j, cfg_t = _cfgs()
    params = jgpt2.init_params(cfg_j, jax.random.PRNGKey(0))
    if stacked:
        params = {**{k: params[k] for k in ("wte", "wpe", "ln_f_g",
                                            "ln_f_b")},
                  "blocks": jgpt2.stack_block_params(params, cfg_j)}
    toks = _batch(cfg_j)
    jloss = jgpt2.loss_fn_stacked if stacked else jgpt2.loss_fn
    tloss = tgpt2.loss_fn_stacked if stacked else tgpt2.loss_fn
    l_ref, g_ref = _jax_value_and_grad(jloss, params, toks, cfg_j)
    l_got, g_got = _torch_value_and_grad(
        tloss, convert.to_torch(jax.device_get(params), device="cpu"),
        torch.tensor(np.asarray(toks)), cfg_t)
    np.testing.assert_allclose(l_got, l_ref, rtol=1e-5)
    assert len(g_got) == len(g_ref)
    for a, b in zip(g_got, g_ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _jax_token_ce(params, toks, cfg):
    logits = jax.jit(lambda p: jgpt2.forward(p, toks[:, :-1], cfg))(params)
    gold = jnp.take_along_axis(logits, toks[:, 1:, None], -1)[..., 0]
    return np.asarray(jax.nn.logsumexp(logits, -1) - gold).ravel()


def _torch_token_ce(params, toks, cfg):
    with torch.no_grad():
        logits = tgpt2.forward(params, toks[:, :-1], cfg)
        gold = logits.gather(-1, toks[:, 1:, None])[..., 0]
        return (torch.logsumexp(logits, -1) - gold).numpy().ravel()


def test_loss_and_grads_match_jax_bf16():
    """Per-token losses and every grad leaf within twice the relative L2
    gap between the JAX model's bf16 and fp32 runs; the mean loss within
    twice the RMS of that per-token gap (|mean d| <= rms d)."""
    cfg_j, cfg_t = _cfgs(jnp.bfloat16, torch.bfloat16)
    cfg_j32 = dataclasses.replace(cfg_j, dtype=jnp.float32)
    params = jgpt2.init_params(cfg_j, jax.random.PRNGKey(0))
    params32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                      params)
    toks = _batch(cfg_j)
    tparams = convert.to_torch(jax.device_get(params), device="cpu")
    ttoks = torch.tensor(np.asarray(toks)).long()
    l16, g16 = _jax_value_and_grad(jgpt2.loss_fn, params, toks, cfg_j)
    _, g32 = _jax_value_and_grad(jgpt2.loss_fn, params32, toks, cfg_j32)
    l_got, g_got = _torch_value_and_grad(tgpt2.loss_fn, tparams, ttoks,
                                         cfg_t)
    c16 = _jax_token_ce(params, toks, cfg_j)
    c32 = _jax_token_ce(params32, toks, cfg_j32)
    c_got = _torch_token_ce(tparams, ttoks, cfg_t)
    assert _rel_l2(c_got, c16) <= 2 * _rel_l2(c16, c32)
    assert abs(l_got - l16) <= 2 * float(np.sqrt(np.mean((c16 - c32) ** 2)))
    for a, b, b32 in zip(g_got, g16, g32):
        assert _rel_l2(a, b) <= 2 * _rel_l2(b, b32)


def test_stacked_equals_unrolled():
    cfg = dataclasses.replace(tgpt2.CONFIGS["test"], **FLASH)
    params = tgpt2.init_params(cfg, seed=1, device="cpu")
    stacked = {k: params[k] for k in ("wte", "wpe", "ln_f_g", "ln_f_b")}
    stacked["blocks"] = tgpt2.stack_block_params(params, cfg)
    toks = tgpt2.fake_batch(cfg, 2, 16, seed=1, device="cpu")
    l1, g1 = _torch_value_and_grad(tgpt2.loss_fn, params, toks, cfg)
    l2, g2 = _torch_value_and_grad(tgpt2.loss_fn_stacked, stacked, toks, cfg)
    np.testing.assert_allclose(l1, l2, rtol=1e-6)
    # Unrolled leaves sort as (h0 keys, h1 keys, ..., ln_f, wpe, wte),
    # stacked as (blocks keys, ln_f, wpe, wte): compare by name.
    names_u = [f"h{i}.{k}" for i in range(cfg.n_layer)
               for k in sorted(params["h0"])]
    by_name = dict(zip(names_u, g1[:len(names_u)]))
    blocks_keys = sorted(stacked["blocks"])
    for j, k in enumerate(blocks_keys):
        want = np.stack([by_name[f"h{i}.{k}"] for i in range(cfg.n_layer)])
        np.testing.assert_allclose(g2[j], want, atol=1e-6, rtol=1e-5)
    for a, b in zip(g1[len(names_u):], g2[len(blocks_keys):]):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=1e-5)


REMAT_POLICIES = ["full", "dots", "dots_no_batch", "save_attn"]


@pytest.fixture(scope="module")
def no_remat_reference():
    """JAX loss and grads with no remat, the common reference of the
    policy cases, and the inputs they share."""
    cfg_j, _ = _cfgs()
    cfg_j = dataclasses.replace(cfg_j, remat=False)
    params = jax.device_get(jgpt2.init_params(cfg_j, jax.random.PRNGKey(0)))
    toks = _batch(cfg_j)
    return params, toks, _jax_value_and_grad(jgpt2.loss_fn, params, toks,
                                             cfg_j)


@pytest.mark.parametrize("policy", REMAT_POLICIES)
def test_remat_policy_matches_jax(policy, no_remat_reference):
    """Each policy changes what is kept, not what is computed: loss and
    grads equal the JAX package's under the same policy and the no-remat
    run, at the fp32 tolerances above."""
    params, toks, (l_none, g_none) = no_remat_reference
    cfg_j, cfg_t = _cfgs()
    cfg_j = dataclasses.replace(cfg_j, remat_policy=policy)
    cfg_t = dataclasses.replace(cfg_t, remat_policy=policy)
    l_ref, g_ref = _jax_value_and_grad(jgpt2.loss_fn, params, toks, cfg_j)
    l_got, g_got = _torch_value_and_grad(
        tgpt2.loss_fn, convert.to_torch(params, device="cpu"),
        torch.tensor(np.asarray(toks)), cfg_t)
    for want_l, want_g in ((l_ref, g_ref), (l_none, g_none)):
        np.testing.assert_allclose(l_got, want_l, rtol=1e-5)
        for a, b in zip(g_got, want_g):
            np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("policy,per_layer,op_per_layer", [
    (None, 1, 0), ("full", 2, 0), ("dots", 2, 2), ("dots_no_batch", 2, 2),
    ("save_attn", 1, 2)])
def test_flash_forward_runs_per_policy(policy, per_layer, op_per_layer,
                                       monkeypatch):
    """The flash forward runs once per layer in forward, and again in the
    backward's recompute unless the policy keeps its output: under
    ``save_attn`` a step runs it L times, not 2L. The autograd op goes
    through the ``tepdist::flash_fwd`` custom op only inside a selective
    checkpoint (forward and recompute), and calls the wrapper directly
    under no remat and ``full``."""
    from tepdist_tpu_torch.ops import flash_attention as tfa

    calls, op_calls = [], []
    plain, op = tfa.flash_fwd, tfa.FLASH_FWD_OP
    monkeypatch.setattr(tfa, "flash_fwd",
                        lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setattr(tfa, "FLASH_FWD_OP",
                        lambda *a: op_calls.append(1) or op(*a))
    cfg = dataclasses.replace(tgpt2.CONFIGS["test"],
                              **{**FLASH, "remat": policy is not None},
                              remat_policy=policy or "full")
    params = tgpt2.init_params(cfg, device="cpu")
    toks = tgpt2.fake_batch(cfg, 2, 16, device="cpu")
    loss, _ = _torch_value_and_grad(tgpt2.loss_fn, params, toks, cfg)
    assert np.isfinite(loss)
    assert len(calls) == per_layer * cfg.n_layer
    assert len(op_calls) == op_per_layer * cfg.n_layer


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the dispatches of each op. Outside a checkpoint it sees an
    op the backward recomputes twice and an op whose output a policy keeps
    once (the policy's cache answers the recompute)."""

    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


def test_policies_keep_what_they_name():
    """Einsum attention, one step of forward and backward: ``dots`` runs
    as many mm and bmm as no remat (it keeps them all), ``dots_no_batch``
    as many mm but more bmm, ``full`` more of both; ``save_attn`` runs its
    ``attn_out`` tag once per layer (kept, not recomputed)."""
    aten = torch.ops.aten
    cfg = dataclasses.replace(tgpt2.CONFIGS["test"],
                              **{**FLASH, "attn": "einsum"})
    params = tgpt2.init_params(cfg, device="cpu")
    toks = tgpt2.fake_batch(cfg, 2, 16, device="cpu")

    def counts(policy):
        c = dataclasses.replace(cfg, remat=policy is not None,
                                remat_policy=policy or "full")
        with _CountOps() as mode:
            _torch_value_and_grad(tgpt2.loss_fn, params, toks, c)
        return mode.counts

    none, dots, nobatch, full, attn = (counts(p) for p in (
        None, "dots", "dots_no_batch", "full", "save_attn"))
    mm, bmm = aten.mm.default, aten.bmm.default
    assert dots[mm] == none[mm] and dots[bmm] == none[bmm]
    assert nobatch[mm] == none[mm] and nobatch[bmm] > none[bmm]
    assert full[mm] > none[mm] and full[bmm] > none[bmm]
    assert attn[torch.ops.tepdist.attn_out.default] == cfg.n_layer
    assert torch.ops.tepdist.attn_out.default not in full


@pytest.mark.parametrize("policy", ["bogus"])
def test_unported_remat_policy_raises(policy):
    """A policy the JAX package does not have raises, as it does there
    (the dots, dots_no_batch and save_attn cases became the parity cases
    above when those policies were ported)."""
    cfg = dataclasses.replace(tgpt2.CONFIGS["test"], remat_policy=policy,
                              **FLASH)
    params = tgpt2.init_params(cfg, device="cpu")
    toks = tgpt2.fake_batch(cfg, 1, 8, device="cpu")
    with pytest.raises(ValueError, match=policy):
        tgpt2.loss_fn(params, toks, cfg)


def test_init_params_statistics():
    cfg = dataclasses.replace(tgpt2.CONFIGS["test"], n_embd=128)
    params = tgpt2.init_params(cfg, seed=0, device="cpu")
    resid = 0.02 / np.sqrt(2 * cfg.n_layer)
    assert abs(params["wte"].std().item() - 0.02) < 0.002
    blk = params["h0"]
    assert abs(blk["attn_qkv_w"].std().item() - 0.02) < 0.002
    assert abs(blk["mlp_proj_w"].std().item() - resid) < 0.1 * resid
    assert blk["attn_qkv_b"].abs().max().item() == 0.0
    assert torch.equal(blk["ln1_g"], torch.ones(cfg.n_embd))
    assert blk["ln1_g"].dtype == torch.float32
    assert params["wte"].dtype == cfg.dtype
    counts = sum(p.numel() for p in tree_leaves(params))
    assert counts == tgpt2.num_params(cfg)


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tgpt2.init_params(tgpt2.CONFIGS["test"])
