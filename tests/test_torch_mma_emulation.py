"""The host stand-ins of the tensor-core instructions (tests/cuda_emu/
flash_mma.cuh) against numpy, and their fragment layouts against the PTX
ISA's tables for ``mma.m16n8k16`` and ``ldmatrix``.

The bf16 forward (``csrc/flash_fwd.cu``) runs every dot through those
instructions, and the kernel emulation test runs it through the
stand-ins. A stand-in whose layout differed from the
hardware's would let a kernel with the same mistake pass there, so this
file pins each layout to the ISA independently of the kernels: one warp
loads a 16x16 A and two 8-wide B tiles with ``ldmatrix`` (B with and
without ``.trans``), each register is held against the element the ISA
assigns it, and the ``m16n8k16`` products against a numpy matmul.

Tolerance: the products of bf16 values are exact in fp32 and 16 of them
are summed, so the fp32 result is within 1e-6 relative of float64. The
hi/lo product (``accumulate`` of ``csrc/flash_common.cuh``) carries fp32 P
to 2**-16 relative, so it is held to 2**-15 of sum |P| |X|.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from tepdist_tpu_torch.ops import _build

torch.set_num_threads(2)

EMU = Path(__file__).resolve().parent / "cuda_emu"

HARNESS = r"""
#include "flash_common.cuh"

namespace tepdist {

// One warp: A [16][16] and B (as [n][k] without .trans, [k][n] with) into
// registers by ldmatrix, then D = A B over two 8-wide tiles of n.
void mma_kernel(const uint16_t* a, const uint16_t* b, int trans, float* d,
                uint32_t* a_regs, uint32_t* b_regs) {
  const int lane = threadIdx.x;
  uint32_t fa[4], fb[4];
  ldmatrix_x4(fa, a + ldm_row_a(lane) * 16 + ldm_col_a(lane));
  if (trans)
    ldmatrix_x4_trans(fb, b + ldm_row_a(lane) * 16 + ldm_col_a(lane));
  else
    ldmatrix_x4(fb, b + ldm_row_b(lane) * 16 + ldm_col_b(lane));
  float acc[2][4] = {};
  mma_bf16_16816(acc[0], fa, fb);
  mma_bf16_16816(acc[1], fa, fb + 2);
  for (int i = 0; i < 4; ++i) {
    a_regs[lane * 4 + i] = fa[i];
    b_regs[lane * 4 + i] = fb[i];
  }
  for (int n = 0; n < 2; ++n)
    for (int e = 0; e < 4; ++e)
      d[(lane / 4 + 8 * (e >> 1)) * 16 + 8 * n + 2 * (lane % 4) + (e & 1)] =
          acc[n][e];
}

// One warp: acc = P X with fp32 P [16][16] given in the accumulator layout
// and bf16 X [16][16] in shared-memory layout (row stride Tc<16>::stride).
void accumulate_kernel(const float* p, const __nv_bfloat16* x, float* out) {
  const int lane = threadIdx.x;
  float pf[2][4], acc[2][4] = {};
  for (int j = 0; j < 2; ++j)
    for (int e = 0; e < 4; ++e)
      pf[j][e] = p[(lane / 4 + 8 * (e >> 1)) * 16 + 8 * j + 2 * (lane % 4) +
                   (e & 1)];
  accumulate<16, 16>(acc, pf, x);
  for (int j = 0; j < 2; ++j)
    for (int e = 0; e < 4; ++e)
      out[(lane / 4 + 8 * (e >> 1)) * 16 + 8 * j + 2 * (lane % 4) +
          (e & 1)] = acc[j][e];
}

// Each thread copies one 16-byte piece, or zero-fills it.
void copy_kernel(const float* src, float* dst, int fill_below) {
  const int i = threadIdx.x;
  cp_async_16(dst + 4 * i, src + 4 * i, i < fill_below);
  cp_async_commit();
  cp_async_wait<0>();
}

}  // namespace tepdist

extern "C" void run_mma(const uint16_t* a, const uint16_t* b, int trans,
                        float* d, uint32_t* a_regs, uint32_t* b_regs) {
  ::emu::launch(tepdist::mma_kernel, 1, 32, 0, nullptr, a, b, trans, d,
                a_regs, b_regs);
}
extern "C" void run_accumulate(const float* p, const __nv_bfloat16* x,
                               float* out) {
  ::emu::launch(tepdist::accumulate_kernel, 1, 32, 0, nullptr, p, x, out);
}
extern "C" void run_copy(const float* src, float* dst, int fill_below) {
  ::emu::launch(tepdist::copy_kernel, 1, 8, 0, nullptr, src, dst,
                fill_below);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the stand-ins for the host")
    out = tmp_path_factory.mktemp("mma_emu")
    cpp = out / "mma_harness.cpp"
    cpp.write_text(HARNESS)
    so = out / "libmma_harness.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I",
         str(EMU), "-I", str(_build.CSRC), "-o", str(so), str(cpp)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return ctypes.CDLL(str(so))


def _bf16(rng, shape):
    """Random bf16 values as (float32 array, uint16 bits)."""
    x = rng.standard_normal(shape).astype(np.float32)
    bits = (x.view(np.uint32) >> 16).astype(np.uint16)  # truncate to bf16
    return (bits.astype(np.uint32) << 16).view(np.float32), bits


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _halves(reg):
    """The two bf16 values of a packed register, low half first."""
    lo = np.uint32(reg) & np.uint32(0xFFFF)
    hi = np.uint32(reg) >> np.uint32(16)
    return [int(lo), int(hi)]


@pytest.mark.parametrize("trans", [False, True])
def test_ldmatrix_and_mma_follow_the_isa(lib, trans):
    rng = np.random.default_rng(7 + trans)
    a, a_bits = _bf16(rng, (16, 16))        # A[m][k]
    bmat, bmat_bits = _bf16(rng, (16, 16))  # B[k][n]
    stored = np.ascontiguousarray(bmat_bits if trans else bmat_bits.T)
    d = np.zeros((16, 16), np.float32)
    a_regs = np.zeros((32, 4), np.uint32)
    b_regs = np.zeros((32, 4), np.uint32)
    lib.run_mma(_ptr(a_bits), _ptr(stored), int(trans), _ptr(d),
                _ptr(a_regs), _ptr(b_regs))

    for lane in range(32):
        g, t = lane // 4, lane % 4
        # A fragment: a[0] = (g, 2t..), a[1] = (g+8, 2t..),
        # a[2] = (g, 2t+8..), a[3] = (g+8, 2t+8..).
        for i, (row, col) in enumerate([(g, 2 * t), (g + 8, 2 * t),
                                        (g, 2 * t + 8), (g + 8, 2 * t + 8)]):
            assert _halves(a_regs[lane, i]) == [a_bits[row, col],
                                                a_bits[row, col + 1]]
        # B fragments of n-tiles 0 and 1: b[0] = (k 2t.., n g),
        # b[1] = (k 2t+8.., n g).
        for i, (k, n) in enumerate([(2 * t, g), (2 * t + 8, g),
                                    (2 * t, g + 8), (2 * t + 8, g + 8)]):
            assert _halves(b_regs[lane, i]) == [bmat_bits[k, n],
                                                bmat_bits[k + 1, n]]
    ref = a.astype(np.float64) @ bmat.astype(np.float64)
    np.testing.assert_allclose(d, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


def test_accumulate_carries_fp32_p_through_the_split(lib):
    rng = np.random.default_rng(3)
    p = rng.standard_normal((16, 16)).astype(np.float32)
    x, x_bits = _bf16(rng, (16, 16))
    stride = 16 + 8  # Tc<16>::stride
    x_smem = np.zeros((16, stride), np.uint16)
    x_smem[:, :16] = x_bits
    out = np.zeros((16, 16), np.float32)
    lib.run_accumulate(_ptr(p), _ptr(x_smem), _ptr(out))
    p64, x64 = p.astype(np.float64), x.astype(np.float64)
    ref = p64 @ x64
    assert np.all(np.abs(out - ref) <= 2.0 ** -15 * (np.abs(p64)
                                                     @ np.abs(x64)))
    # A single bf16 P would miss by about 2**-9 relative: the split matters.
    assert np.abs(out - ref).max() < 2.0 ** -12 * np.abs(ref).max()


def test_cp_async_copies_or_zero_fills(lib):
    src = np.arange(32, dtype=np.float32) + 1
    dst = np.full(32, -1, np.float32)
    lib.run_copy(_ptr(src), _ptr(dst), 5)
    np.testing.assert_array_equal(dst[:20], src[:20])
    np.testing.assert_array_equal(dst[20:], 0)
