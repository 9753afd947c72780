"""The port's CUDA kernel sources, compiled for the host by g++ against a
CPU stand-in of the CUDA runtime (tests/cuda_emu/), held against the plain
PyTorch versions.

No GPU or nvcc is needed: each CUDA thread runs as a host thread and
``__syncthreads`` is a barrier, so the kernels' indexing, tiling, causal
tile skipping, ragged-edge masking and online softmax run exactly as
written, in fp32 on the host. The Hopper instructions of the bf16
kernels (``csrc/flash_sm90.cuh``: wgmma, TMA and mbarriers, for the
forward, dQ and dK/dV) run as host stand-ins with the same layouts
(``tests/cuda_emu/``), a wgmma's result landing only at the wait that
completes it. That checks their logic on every host; only
``chip_smoke.py`` checks them as nvcc builds them, on the card.

Tolerance: fp32 atol 2e-5 / rtol 1e-4 (sums in another order). bf16
outputs: both sides compute in fp32 and round once to bf16, so they may
differ by one bf16 step (2**-7 relative, plus the fp32 tolerance).
"""

import ctypes
import math
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tepdist_tpu_torch.ops import _build
from tepdist_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(2)

EMU = Path(__file__).resolve().parent / "cuda_emu"
NAMES = ("flash_fwd", "flash_dq", "flash_dkv")


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """The three kernel sources built for the host, as ctypes entries."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel sources for the host")
    out = tmp_path_factory.mktemp("cuda_emu")
    procs = {}
    for name in NAMES:
        src = (_build.CSRC / f"{name}.cu").read_text()
        # One shared-memory arena for the block, 1024-byte aligned as the
        # 128-byte swizzle needs and known to the wgmma and TMA stand-ins,
        # and launches as calls.
        src = src.replace(
            '#include "flash_common.cuh"',
            '#include "flash_common.cuh"\n'
            "namespace tepdist { alignas(1024) float4 smem4[16384];\n"
            "const bool emu_arena = (emu_smem_base = (char*)smem4, true); }")
        src = re.sub(r"(\w+)<<<(.*?)>>>\(", r"::emu::launch(\1, \2, ", src,
                     flags=re.S)
        cpp = out / f"{name}.cpp"
        cpp.write_text(src)
        procs[name] = subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
             "-I", str(EMU), "-I", str(_build.CSRC), "-o",
             str(out / f"lib{name}.so"), str(cpp)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=300)
        assert proc.returncode == 0, log
        fn = getattr(ctypes.CDLL(str(out / f"lib{name}.so")),
                     f"tepdist_{name}")
        fn.argtypes = tfa._ARGTYPES[name]
        fn.restype = ctypes.c_int
        entries[name] = fn
    return entries


def _close(got, ref, bf16):
    got, ref = got.float(), ref.float()
    tol = 2e-5 + 1e-4 * ref.abs()
    if bf16:
        tol = tol + 2.0 ** -7 * ref.abs()
    return bool(torch.all((got - ref).abs() <= tol))


@pytest.mark.parametrize("T,D,dtype,causal", [
    (100, 16, torch.float32, True),
    (100, 16, torch.float32, False),
    (130, 64, torch.bfloat16, True),
    (64, 32, torch.bfloat16, False),
    (33, 128, torch.float32, True),
    (1, 16, torch.float32, True),
    # bf16 dQ and dK/dV run on the Hopper stand-ins (flash_sm90.cuh):
    # ragged and aligned T, one and several tiles, every head dim.
    (100, 16, torch.bfloat16, True),
    (100, 16, torch.bfloat16, False),
    (100, 128, torch.bfloat16, True),
    (100, 128, torch.bfloat16, False),
    (1, 16, torch.bfloat16, True),
    (1, 16, torch.bfloat16, False),
    (1, 128, torch.bfloat16, True),
    (1, 128, torch.bfloat16, False),
    (128, 32, torch.bfloat16, True),
    (192, 64, torch.bfloat16, False),
])
def test_kernel_sources_match_plain(emulated, T, D, dtype, causal):
    rng = np.random.default_rng(T * 131 + D)
    q, k, v, do = (torch.tensor(rng.standard_normal((2, T, D)),
                                dtype=torch.float32).to(dtype)
                   for _ in range(4))
    dlse = torch.tensor(rng.standard_normal((2, T)), dtype=torch.float32)
    scale = 1.0 / math.sqrt(D)
    meta = tfa._meta(q, causal, scale)
    ptr = lambda t: t.data_ptr()  # noqa: E731

    o, lse = torch.empty_like(q), torch.empty(2, T)
    assert emulated["flash_fwd"](ptr(q), ptr(k), ptr(v), ptr(o), ptr(lse),
                                 *meta, None) == 0
    o_ref, lse_ref = tfa.flash_fwd_plain(q, k, v, causal, scale)
    delta = ((do.float() * o_ref.float()).sum(-1) - dlse).contiguous()
    args = (q, k, v, do, lse_ref, delta)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    assert emulated["flash_dq"](*map(ptr, args), ptr(dq), *meta, None) == 0
    assert emulated["flash_dkv"](*map(ptr, args), ptr(dk), ptr(dv), *meta,
                                 None) == 0
    dq_ref = tfa.flash_dq_plain(*args, causal, scale)
    dk_ref, dv_ref = tfa.flash_dkv_plain(*args, causal, scale)
    bf16 = dtype == torch.bfloat16
    for name, a, b in (("o", o, o_ref), ("lse", lse, lse_ref),
                       ("dq", dq, dq_ref), ("dk", dk, dk_ref),
                       ("dv", dv, dv_ref)):
        assert _close(a, b, bf16 and name != "lse"), name


def test_unsupported_head_dim_is_refused(emulated):
    q = torch.zeros(1, 8, 24)
    lse = torch.empty(1, 8)
    err = emulated["flash_fwd"](q.data_ptr(), q.data_ptr(), q.data_ptr(),
                                q.data_ptr(), lse.data_ptr(), 1, 8, 24, 0, 1,
                                0.2, None)
    assert err != 0


@pytest.mark.parametrize("T,D,causal", [
    (300, 64, True),
    (300, 128, False),
])
def test_forward_large_scores_match_plain(emulated, T, D, causal):
    """The bf16 forward with q times 8, so the scores spread over about
    +-30 and the running max of most rows rises after their first key
    tile: the rescaling by corr = exp(m - m_new) and the _NEG_INF guards
    carry the result, and T = 300 leaves a ragged last tile."""
    rng = np.random.default_rng(T * 7 + D)
    q, k, v = (torch.tensor(rng.standard_normal((2, T, D)),
                            dtype=torch.float32).to(torch.bfloat16)
               for _ in range(3))
    q = q * 8  # exact in bf16
    scale = 1.0 / math.sqrt(D)
    s, keep = tfa._scores(q, k, causal, scale)
    # Of the rows that see more than one 64-key tile, most find a larger
    # score after their first: the inputs exercise corr.
    several = keep.sum(-1) > 64
    rises = s.amax(-1) > s[..., :64].amax(-1)
    assert rises[..., several].float().mean() > 0.5

    o, lse = torch.empty_like(q), torch.empty(2, T)
    assert emulated["flash_fwd"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(),
                                 *tfa._meta(q, causal, scale), None) == 0
    o_ref, lse_ref = tfa.flash_fwd_plain(q, k, v, causal, scale)
    assert _close(o, o_ref, True), "o"
    assert _close(lse, lse_ref, False), "lse"


def _forward(emulated, q, k, v, causal, scale):
    o, lse = torch.empty_like(q), torch.empty(q.shape[0], q.shape[1])
    assert emulated["flash_fwd"](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 o.data_ptr(), lse.data_ptr(),
                                 *tfa._meta(q, causal, scale), None) == 0
    return o, lse


def _bf16_inputs(seed, T, D):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal((2, T, D)),
                         dtype=torch.float32).to(torch.bfloat16)
            for _ in range(3)]


@pytest.mark.parametrize("causal", [True, False])
def test_forward_ring_wraps_match_plain(emulated, causal):
    """The bf16 forward at T = 520: a CTA of the last query tile streams
    9 key tiles through the 3-stage ring, so every stage is refilled twice
    and the producer waits on each stage's empty barrier; the last tile is
    ragged."""
    q, k, v = _bf16_inputs(520, 520, 64)
    scale = 1.0 / math.sqrt(64)
    o, lse = _forward(emulated, q, k, v, causal, scale)
    o_ref, lse_ref = tfa.flash_fwd_plain(q, k, v, causal, scale)
    assert _close(o, o_ref, True), "o"
    assert _close(lse, lse_ref, False), "lse"


@pytest.mark.parametrize("D", [64, 128])
def test_forward_reruns_give_the_same_bits(emulated, D):
    """Each output row is summed by one CTA in a fixed order (no atomics),
    so two runs of the bf16 forward on the same inputs agree bit for bit,
    as chip_smoke.py checks on the card."""
    q, k, v = _bf16_inputs(D, 200, D)
    scale = 1.0 / math.sqrt(D)
    o, lse = _forward(emulated, q, k, v, True, scale)
    o2, lse2 = _forward(emulated, q, k, v, True, scale)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
