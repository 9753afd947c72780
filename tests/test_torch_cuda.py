"""The port's CUDA kernels on the card: each against its plain version, and
the autograd ops end to end. Needs an NVIDIA GPU with nvcc; skips without
one. The file imports no jax, so it runs where jax is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Tolerances: fp32 atol 2e-5 / rtol 1e-4 (sums in another order). bf16
outputs: both sides compute in fp32 and round once to bf16, so they may
differ by one bf16 step (2**-7 relative) beyond that. The atol is per unit
of the inputs' scale: with q times 8 the terms of dK's sums are 8 times
larger, and so is the error of summing them in another order (on an H100,
4.6e-5 at an element near zero whose neighbours reach 30).
"""

import math

import pytest
import torch
import torch.utils._python_dispatch

from tepdist_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda
NAMES = ("o", "lse", "dq", "dk", "dv")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, ref, bf16, name, in_scale=1):
    got, ref = got.float(), ref.float()
    tol = 2e-5 * in_scale + 1e-4 * ref.abs()
    if bf16:
        tol = tol + 2.0 ** -7 * ref.abs()
    err = (got - ref).abs()
    assert bool(torch.all(err <= tol)), (name, err.max().item())


@pytest.mark.parametrize("T,D,dtype,causal,q_mul", [
    (100, 16, torch.float32, True, 1),
    (100, 16, torch.float32, False, 1),
    (130, 64, torch.bfloat16, True, 1),
    (33, 128, torch.float32, True, 1),
    (257, 32, torch.bfloat16, False, 1),
    (200, 128, torch.bfloat16, True, 1),
    # Scores spread over about +-30, so the forward's running max rises
    # across key tiles and its rescaling carries the result.
    (300, 64, torch.bfloat16, True, 8),
])
def test_kernels_match_plain(cuda, T, D, dtype, causal, q_mul):
    gen = torch.Generator(device=cuda).manual_seed(T + D)
    q, k, v, do = (torch.randn(6, T, D, generator=gen, device=cuda)
                   .to(dtype) for _ in range(4))
    q = q * q_mul  # a power of two: exact in bf16
    dlse = torch.randn(6, T, generator=gen, device=cuda)
    scale = 1 / math.sqrt(D)
    tfa.reset_launch_counts()
    o, lse = tfa.flash_fwd(q, k, v, causal, scale)
    o_ref, lse_ref = tfa.flash_fwd_plain(q, k, v, causal, scale)
    delta = ((do.float() * o_ref.float()).sum(-1) - dlse).contiguous()
    args = (q, k, v, do, lse_ref, delta, causal, scale)
    dq, (dk, dv) = tfa.flash_dq(*args), tfa.flash_dkv(*args)
    refs = (o_ref, lse_ref, tfa.flash_dq_plain(*args),
            *tfa.flash_dkv_plain(*args))
    for name, a, b in zip(NAMES, (o, lse, dq, dk, dv), refs):
        _assert_close(a, b, dtype == torch.bfloat16 and name != "lse", name,
                      q_mul)
    assert tfa.launch_counts == {"flash_fwd": 1, "flash_dq": 1,
                                 "flash_dkv": 1}


def test_autograd_op_launches_the_kernels(cuda):
    """flash_attention_with_lse forward and backward (with a dLSE
    cotangent) on the card equal the same op run on the CPU's plain
    versions, and launch each kernel once."""
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(2, 3, 70, 32, generator=gen)
                   for _ in range(4))
    dlse = torch.randn(2, 3, 70, generator=gen)

    def run(device):
        xs = [t.to(device).requires_grad_() for t in (q, k, v)]
        o, lse = tfa.flash_attention_with_lse(*xs, causal=True)
        loss = (o * do.to(device)).sum() + (lse * dlse.to(device)).sum()
        return [t.detach().cpu() for t in
                (o, lse, *torch.autograd.grad(loss, xs))]

    ref = run("cpu")
    tfa.reset_launch_counts()
    got = run(cuda)
    assert tfa.launch_counts == {"flash_fwd": 1, "flash_dq": 1,
                                 "flash_dkv": 1}
    for name, a, b in zip(NAMES, got, ref):
        _assert_close(a, b, False, name)


class _Passthrough(torch.utils._python_dispatch.TorchDispatchMode):
    """An active dispatch mode that changes nothing: the flash attention
    takes its op path (``tepdist::flash_*``) under it."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_op_path_equals_direct_path(cuda, dtype):
    """Forward and backward (with a dLSE cotangent) through the custom
    ops and straight through the wrappers: the same bits and the same
    launches of each kernel."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v, do = (torch.randn(2, 25, 300, 64, generator=gen, device=cuda)
                   .to(dtype) for _ in range(4))
    dlse = torch.randn(2, 25, 300, generator=gen, device=cuda)

    def run():
        tfa.reset_launch_counts()
        xs = [t.clone().requires_grad_() for t in (q, k, v)]
        o, lse = tfa.flash_attention_with_lse(*xs, causal=True)
        loss = (o.float() * do.float()).sum() + (lse * dlse).sum()
        out = [t.detach() for t in (o, lse, *torch.autograd.grad(loss, xs))]
        torch.cuda.synchronize()
        return out, dict(tfa.launch_counts)

    direct, direct_launches = run()
    with _Passthrough():
        via_ops, op_launches = run()
    assert direct_launches == op_launches == {
        "flash_fwd": 1, "flash_dq": 1, "flash_dkv": 1}
    for name, a, b in zip(NAMES, direct, via_ops):
        assert torch.equal(a, b), name


def test_wrong_device_mix_raises(cuda):
    q = torch.zeros(2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="different devices"):
        tfa.flash_fwd(q, q.cpu(), q, True, 0.25)
