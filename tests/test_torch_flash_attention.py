"""The port's flash attention (tepdist_tpu_torch.ops.flash_attention) held
against the JAX package's Pallas kernels, run in interpret mode on the CPU.

On the CPU the port's wrappers run their kernels' plain PyTorch versions, so
these tests hold the algorithm (masking, LSE, the dLSE fold into delta, the
autograd wiring) against the reference. The CUDA kernels themselves are
checked on the card by ``chip_smoke.py`` and ``tests/test_torch_cuda.py``.

Tolerances: fp32 atol 2e-5 / rtol 1e-4 (fp32 sums taken in another order).
bf16: derived per case from the reference itself, as twice the largest gap
between the JAX kernel's bf16 and fp32 results at the same (bf16-valued)
inputs, since both implementations compute in fp32 and round once to bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tepdist_tpu.ops.pallas import flash_attention as jfa
from tepdist_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

ATOL, RTOL = 2e-5, 1e-4


def _inputs(shape, seed, dtype=np.float32):
    """q, k, v, dO as numpy fp32 (bf16-valued when dtype is bf16) and a dLSE
    cotangent, from one numpy seed."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    if dtype != np.float32:
        arrs = [np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    dlse = rng.standard_normal(shape[:3]).astype(np.float32)
    return arrs, dlse


def _jax_run(q, k, v, do, dlse, causal, dtype, with_lse, **kw):
    """(o, lse or None, dq, dk, dv) of the JAX op as fp32 numpy."""
    q, k, v, do = (jnp.asarray(x, dtype) for x in (q, k, v, do))

    def f(q, k, v):
        if with_lse:
            o, lse = jfa.flash_attention_with_lse(q, k, v, causal=causal,
                                                  interpret=True, **kw)
            return (jnp.vdot(o.astype(jnp.float32), do.astype(jnp.float32))
                    + jnp.vdot(lse, jnp.asarray(dlse))), (o, lse)
        o = jfa.flash_attention(q, k, v, causal=causal, interpret=True, **kw)
        return jnp.vdot(o.astype(jnp.float32),
                        do.astype(jnp.float32)), (o, None)

    (_, (o, lse)), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    def as_np(x):
        return None if x is None else np.asarray(jnp.asarray(x, jnp.float32))

    return (as_np(o), as_np(lse), *(as_np(g) for g in grads))


def _torch_run(q, k, v, do, dlse, causal, dtype, with_lse, **kw):
    q, k, v = (torch.tensor(x).to(dtype).requires_grad_() for x in (q, k, v))
    do_t = torch.tensor(do).to(dtype)
    if with_lse:
        o, lse = tfa.flash_attention_with_lse(q, k, v, causal=causal, **kw)
        loss = (o.float() * do_t.float()).sum() + (lse * torch.tensor(
            dlse)).sum()
    else:
        o, lse = tfa.flash_attention(q, k, v, causal=causal, **kw), None
        loss = (o.float() * do_t.float()).sum()
    grads = torch.autograd.grad(loss, (q, k, v))

    def as_np(x):
        return None if x is None else x.detach().float().numpy()

    return (as_np(o), as_np(lse), *(as_np(g) for g in grads))


NAMES = ("o", "lse", "dq", "dk", "dv")


@pytest.mark.parametrize("with_lse", [False, True], ids=["o", "o_lse"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("T,blocks", [(64, dict(block_q=16, block_k=16)),
                                      (100, {})], ids=["T64", "T100"])
def test_matches_pallas_fp32(T, blocks, causal, with_lse):
    """Forward and backward, with and without the LSE output (a nonzero
    dLSE folds into delta), at a tiled T and at an awkward T=100 where the
    JAX package pads (causal) or goes dense (non-causal)."""
    (q, k, v, do), dlse = _inputs((2, 3, T, 16), seed=T + 2 * causal)
    ref = _jax_run(q, k, v, do, dlse, causal, jnp.float32, with_lse,
                   **blocks)
    got = _torch_run(q, k, v, do, dlse, causal, torch.float32, with_lse,
                     **blocks)
    for name, a, b in zip(NAMES, got, ref):
        if b is None:
            continue
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_matches_pallas_bf16(causal):
    (q, k, v, do), dlse = _inputs((1, 2, 64, 32), seed=7 + causal,
                                  dtype="bf16")
    ref32 = _jax_run(q, k, v, do, dlse, causal, jnp.float32, True)
    ref16 = _jax_run(q, k, v, do, dlse, causal, jnp.bfloat16, True)
    got = _torch_run(q, k, v, do, dlse, causal, torch.bfloat16, True)
    for name, a, b, b32 in zip(NAMES, got, ref16, ref32):
        tol = 2 * np.abs(b - b32).max() + ATOL
        assert np.abs(a - b).max() <= tol, (name, np.abs(a - b).max(), tol)


def test_explicit_blocks_must_divide_T():
    q = torch.zeros(1, 1, 64, 16)
    with pytest.raises(ValueError, match="must divide"):
        tfa.flash_attention(q, q, q, block_q=48)
    tfa.flash_attention(q, q, q, block_q=16, block_k=32)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "contiguity", "rank"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    q = torch.zeros(2, 8, 16)
    if bad == "dtype":
        q = q.half()
    elif bad == "head_dim":
        q = torch.zeros(2, 8, 24)
    elif bad == "contiguity":
        q = torch.zeros(2, 16, 8).transpose(1, 2)
    else:
        q = torch.zeros(8, 16)
    with pytest.raises((TypeError, ValueError)):
        tfa.flash_fwd(q, q, q, True, 0.25)


def test_plain_path_counts_no_launch():
    tfa.reset_launch_counts()
    q = torch.randn(2, 8, 16)
    tfa.flash_fwd(q, q, q, True, 0.25)
    assert tfa.launch_counts == {"flash_fwd": 0, "flash_dq": 0,
                                 "flash_dkv": 0}
