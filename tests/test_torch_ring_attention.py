"""The port's ring and Ulysses attention (``tepdist_tpu_torch.ops``) held
against the JAX package's, in the one-process form over ``["cpu"] * 4``
against ``shard_map`` over 4 of the 8 virtual CPU devices.

Same numpy inputs on both sides; the JAX flash inner runs its Pallas
kernels in interpret mode, the port's its kernels' plain versions.
Forward outputs, LSEs and the gradients of <o, dO> (+ <lse, dLSE> where
the LSE is returned) are compared.

Tolerances: fp32 atol 2e-5 / rtol 1e-4 (sums in another order, as for the
flash kernels, ``tests/test_torch_flash_attention.py``). bf16: each output
within twice the reference's own gap between its bf16 and fp32 results on
the same (bf16-valued) inputs plus the fp32 rtol, both as relative L2 errors
(the rule of
``tests/test_torch_gpt2.py``'s bf16 test: a bf16 result may sit one
rounding step to either side where the two packages sum in another
order). The GPT-2 training mirror: losses rtol
2e-4 and params rtol 2e-3 / atol 2e-5, the JAX package's own bounds for
its ring against dense training
(``tests/test_sequence_parallel.py::test_gpt2_training_with_ring_
attention_matches_dense``).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from tepdist_tpu.models import gpt2 as jgpt2
from tepdist_tpu.ops.pallas.flash_attention import \
    flash_attention as jflash
from tepdist_tpu.ops.ring_attention import ring_attention as jring
from tepdist_tpu.ops.ulysses import ulysses_attention as julysses
from tepdist_tpu_torch import convert
from tepdist_tpu_torch.core.tree import tree_leaves, tree_unflatten
from tepdist_tpu_torch.models import gpt2 as tgpt2
from tepdist_tpu_torch.ops import flash_attention as tfa
from tepdist_tpu_torch.ops import ring_attention as tring
from tepdist_tpu_torch.ops import ulysses_attention as tulysses
from tepdist_tpu_torch.optim import sgd

# ``tepdist_tpu_torch.ops`` exports the function under the module's name.
ring_module = importlib.import_module("tepdist_tpu_torch.ops.ring_attention")

torch.set_num_threads(2)

ATOL, RTOL = 2e-5, 1e-4
RING = ["cpu"] * 4
SHAPE = (1, 4, 32, 16)


@pytest.fixture(scope="module")
def mesh(devices):
    return Mesh(np.array(devices[:4]), axis_names=("seq",))


def _inputs(seed, bf16):
    """q, k, v, dO (bf16-valued when ``bf16``) and a dLSE, as fp32 numpy."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(SHAPE).astype(np.float32) for _ in range(4)]
    if bf16:
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    return arrs, rng.standard_normal(SHAPE[:3]).astype(np.float32)


def _jax(fn, arrs, dlse, dtype, with_lse):
    """(o, lse or None, dq, dk, dv) of ``fn`` as fp32 numpy."""
    q, k, v, do = (jnp.asarray(x, dtype) for x in arrs)

    def f(q, k, v):
        res = fn(q, k, v)
        o, lse = res if with_lse else (res, None)
        val = jnp.vdot(o.astype(jnp.float32), do.astype(jnp.float32))
        if with_lse:
            val = val + jnp.vdot(lse, jnp.asarray(dlse))
        return val, (o, lse)

    (_, (o, lse)), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    out = [o, lse, *grads]
    return [None if x is None else np.asarray(jnp.asarray(x, jnp.float32))
            for x in out]


def _torch(fn, arrs, dlse, dtype, with_lse):
    q, k, v, do = (torch.tensor(x).to(dtype) for x in arrs)
    leaves = [x.requires_grad_() for x in (q, k, v)]
    res = fn(*leaves)
    o, lse = res if with_lse else (res, None)
    val = (o.float() * do.float()).sum()
    if with_lse:
        val = val + (lse * torch.tensor(dlse)).sum()
    grads = torch.autograd.grad(val, leaves)
    out = [o, lse, *grads]
    return [None if x is None else x.detach().float().numpy() for x in out]


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _check(name, jfn, tfn, with_lse, bf16, seed=0):
    arrs, dlse = _inputs(seed, bf16)
    want32 = _jax(jfn, arrs, dlse, jnp.float32, with_lse)
    if not bf16:
        got = _torch(tfn, arrs, dlse, torch.float32, with_lse)
        for label, a, b in zip(("o", "lse", "dq", "dk", "dv"), got, want32):
            if b is not None:
                np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL,
                                           err_msg=f"{name} {label}")
        return
    want = _jax(jfn, arrs, dlse, jnp.bfloat16, with_lse)
    got = _torch(tfn, arrs, dlse, torch.bfloat16, with_lse)
    for label, a, b, b32 in zip(("o", "lse", "dq", "dk", "dv"), got, want,
                                want32):
        if b is None:
            continue
        # An output both packages compute in fp32 from the bf16-valued
        # inputs (the LSE) has no bf16 gap: the fp32 rtol bounds it.
        got_gap, ref_gap = _rel_l2(a, b), _rel_l2(b, b32)
        assert got_gap <= 2 * ref_gap + RTOL, (name, label, got_gap,
                                               ref_gap)


def _cases(mesh):
    """name -> (JAX fn, port fn, returns the LSE)."""
    cases = {}
    for causal in (True, False):
        c = "causal" if causal else "full"
        cases[f"ring_einsum_{c}"] = (
            lambda q, k, v, c=causal: jring(q, k, v, mesh, causal=c),
            lambda q, k, v, c=causal: tring(q, k, v, RING, causal=c),
            False)
        cases[f"ring_flash_{c}"] = (
            lambda q, k, v, c=causal: jring(q, k, v, mesh, causal=c,
                                            inner="flash", return_lse=True),
            lambda q, k, v, c=causal: tring(q, k, v, RING, causal=c,
                                            inner="flash", return_lse=True),
            True)
        cases[f"ulysses_{c}"] = (
            lambda q, k, v, c=causal: julysses(q, k, v, mesh, causal=c),
            lambda q, k, v, c=causal: tulysses(q, k, v, RING, causal=c),
            False)
        cases[f"ulysses_flash_{c}"] = (
            lambda q, k, v, c=causal: julysses(
                q, k, v, mesh, causal=c,
                inner=lambda a, b, d: jflash(a, b, d, causal=c,
                                             interpret=True)),
            lambda q, k, v, c=causal: tulysses(
                q, k, v, RING, causal=c,
                inner=lambda a, b, d: tfa.flash_attention(a, b, d,
                                                          causal=c)),
            False)
        cases[f"ulysses_flash_lse_{c}"] = (
            lambda q, k, v, c=causal: julysses(q, k, v, mesh, causal=c,
                                               return_lse=True),
            lambda q, k, v, c=causal: tulysses(q, k, v, RING, causal=c,
                                               return_lse=True),
            True)
    return cases


_NAMES = [f"{kind}_{c}" for kind in ("ring_einsum", "ring_flash", "ulysses",
                                     "ulysses_flash", "ulysses_flash_lse")
          for c in ("causal", "full")]


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("name", _NAMES)
def test_matches_jax(mesh, name, bf16):
    jfn, tfn, with_lse = _cases(mesh)[name]
    _check(name, jfn, tfn, with_lse, bf16)


def test_ulysses_head_divisibility(mesh):
    q = np.zeros((2, 3, 64, 16), np.float32)
    with pytest.raises(ValueError):
        julysses(q, q, q, mesh)
    t = torch.tensor(q)
    with pytest.raises(ValueError, match="not divisible"):
        tulysses(t, t, t, RING)


def test_einsum_ring_has_no_lse():
    t = torch.zeros(SHAPE)
    with pytest.raises(ValueError, match="return_lse requires"):
        tring(t, t, t, RING, return_lse=True)


def test_ring_hops_by_kind():
    """The causal ring's hops: P diagonal, P(P-1)/2 full and as many
    skipped (no launch); the non-causal ring's P^2 full."""
    assert ring_module.ring_hops(4, True) == {"diag": 4, "full": 6, "skip": 6}
    assert ring_module.ring_hops(4, False) == {"diag": 0, "full": 16, "skip": 0}


def test_gpt2_training_with_ring_attention_matches_jax(mesh):
    """3 sgd steps of GPT-2 ``test`` with the einsum ring as attention on
    both sides (the JAX package's ``test_gpt2_training_with_ring_
    attention_matches_dense`` recipe), from the JAX init."""
    import optax

    cj = jgpt2.CONFIGS["test"]
    ct = tgpt2.CONFIGS["test"]
    params = jgpt2.init_params(cj, jax.random.PRNGKey(0))
    toks = jgpt2.fake_batch(cj, 2, 32)
    tx = optax.sgd(0.05)

    def jstep(p, o, t):
        loss, g = jax.value_and_grad(lambda p: jgpt2.loss_fn(
            p, t, cj, attn_impl=lambda q, k, v: jring(q, k, v, mesh)))(p)
        u, o = tx.update(g, o, p)
        return loss, optax.apply_updates(p, u), o

    jstep = jax.jit(jstep)
    jp, jo = params, tx.init(params)
    tp = convert.to_torch(jax.device_get(params), device="cpu")
    tt = torch.tensor(np.asarray(toks))
    opt = sgd(0.05)
    ts = opt.init(tp)

    def tloss(p):
        return tgpt2.loss_fn(p, tt, ct, attn_impl=lambda q, k, v: tring(
            q, k, v, RING))

    for _ in range(3):
        jl, jp, jo = jstep(jp, jo, toks)
        leaves = [x.detach().requires_grad_() for x in tree_leaves(tp)]
        p = tree_unflatten(tp, leaves)
        tl = tloss(p)
        grads = torch.autograd.grad(tl, leaves)
        with torch.no_grad():
            ts = opt.apply(p, tree_unflatten(tp, list(grads)), ts)
        tp = tree_unflatten(tp, [x.detach() for x in leaves])
        np.testing.assert_allclose(tl.item(), float(jl), rtol=2e-4)
    for a, b in zip(tree_leaves(tp), jax.tree_util.tree_leaves(
            jax.device_get(jp))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-3,
                                   atol=2e-5)


def test_gpt2_ring_flash_attention_matches_dense():
    """GPT-2 ``test`` with the flash ring (the seq_step recipe's inner)
    as attention: the loss and grads of the dense flash model."""
    cfg = dataclasses.replace(tgpt2.CONFIGS["test"], attn="flash")
    params = tgpt2.init_params(cfg, seed=0, device="cpu")
    toks = tgpt2.fake_batch(cfg, 2, 32, seed=1, device="cpu")

    def run(impl):
        leaves = [x.detach().requires_grad_() for x in tree_leaves(params)]
        loss = tgpt2.loss_fn(tree_unflatten(params, leaves), toks, cfg,
                             attn_impl=impl)
        return loss.item(), torch.autograd.grad(loss, leaves)

    l_ring, g_ring = run(lambda q, k, v: tring(q, k, v, RING,
                                               inner="flash"))
    l_ref, g_ref = run(None)
    np.testing.assert_allclose(l_ring, l_ref, rtol=1e-5)
    for a, b in zip(g_ring, g_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5,
                                   rtol=1e-4)


def test_sequence_op_checks_ulysses_heads():
    """The sequence op (the rewrite's path) refuses Ulysses on a head
    count the ring does not divide, as ``ulysses_attention`` does."""
    t = torch.zeros(1, 3, 32, 16)
    with pytest.raises(ValueError, match="not divisible"):
        ring_module.seq_attention(t, t, t, True, 0.25, 3, "ulysses",
                                  "flash", 4)
    o, lse = ring_module.seq_attention(t, t, t, True, 0.25, 3, "ring",
                                       "flash", 4)
    assert o.shape == t.shape and lse.shape == t.shape[:-1]
