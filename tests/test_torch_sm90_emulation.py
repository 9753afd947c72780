"""The host stand-ins of the Hopper instructions (tests/cuda_emu/
flash_sm90.cuh) against numpy, and their layouts against the PTX ISA's
tables for ``wgmma.mma_async``, its shared-memory matrix descriptor, the
128-byte swizzle that ``cp.async.bulk.tensor`` writes, and ``mbarrier``.

The bf16 kernels (``csrc/flash_fwd.cu``, ``csrc/flash_dq.cu``,
``csrc/flash_dkv.cu``) run every dot through ``wgmma`` on tiles that TMA
brings in, and the kernel emulation test runs them through the stand-ins. A stand-in whose layout
differed from the hardware's would let a kernel with the same mistake pass
there, so this file pins each layout independently of the kernels: numpy
places the operands in shared memory by the ISA's swizzle formula (piece c
of row r of a 128-byte row at piece c ^ (r % 8)), builds the register A
fragments by the ISA's table, and reads each thread's accumulator back by
the table (``d[4j + 2h + e]`` = row 16w + g + 8h, column 8j + 2t + e).

Tolerance: products of bf16 values are exact in fp32 and 16 of them are
summed, so a wgmma is within 1e-6 relative of float64. The hi/lo product
(``accumulate_sm90`` of ``csrc/flash_common.cuh``) carries fp32 X to
2**-16 relative, so it is held to 2**-15 of sum |X| |B|.
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
ARENA = 1 << 16

HARNESS = r"""
#include "flash_common.cuh"

namespace tepdist {

alignas(1024) uint8_t arena[1 << 16];

// One warpgroup: d = A B with A at a_off (K-major, sbo a_sbo) or from
// each thread's a_regs[thread][4], B at b_off read K-major or MN-major;
// each thread's accumulator to d_out[thread][N / 2].
template <int N>
void wgmma_kernel(int rs, const uint32_t* a_regs, int a_off, int a_sbo,
                  int b_off, int b_lbo, int b_sbo, int trans_b, float* d_out) {
  const int t = threadIdx.x;
  float d[N / 2];
  for (int i = 0; i < N / 2; ++i) d[i] = 100.f;  // scale_d = 0 drops it
  const uint64_t db = smem_desc(arena + b_off, b_lbo, b_sbo);
  wgmma_fence();
  if (rs) {
    uint32_t a[4];
    for (int i = 0; i < 4; ++i) a[i] = a_regs[4 * t + i];
    if constexpr (N == 64) {
      if (trans_b) wgmma_rs_n64<1>(d, a, db, 0);
      else wgmma_rs_n64<0>(d, a, db, 0);
    }
  } else {
    const uint64_t da = smem_desc(arena + a_off, 16, a_sbo);
    if constexpr (N == 128) {
      if (trans_b) wgmma_ss_n128<1>(d, da, db, 0);
      else wgmma_ss_n128<0>(d, da, db, 0);
    } else if constexpr (N == 64) {
      if (trans_b) wgmma_ss_n64<1>(d, da, db, 0);
      else wgmma_ss_n64<0>(d, da, db, 0);
    } else {
      if (trans_b) wgmma_ss_n32<1>(d, da, db, 0);
      else wgmma_ss_n32<0>(d, da, db, 0);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(d);
  for (int i = 0; i < N / 2; ++i) d_out[t * (N / 2) + i] = d[i];
}

// One warpgroup: acc (64 x 64) = X B through a_pairs and accumulate_sm90,
// X fp32 given per thread in the accumulator layout, B a 64-row tile at
// offset 0 read MN-major.
void accumulate_kernel(const float* x, float* out) {
  const int t = threadIdx.x;
  float xs[32], acc[1][32] = {};
  for (int i = 0; i < 32; ++i) xs[i] = x[t * 32 + i];
  uint32_t hi[4][4], lo[4][4];
  a_pairs<64>(xs, hi, lo);
  wgmma_fence();
  accumulate_sm90<64, 64>(acc, hi, lo, arena);
  wgmma_wait<0>();
  fence_regs(acc[0]);
  for (int i = 0; i < 32; ++i) out[t * 32 + i] = acc[0][i];
}

// One thread: a 3-D box of a bf16 [BH, T, D] slab at (c0, row0, bh), or a
// 1-D box of an fp32 vector at row0, into the arena under an mbarrier.
void tma_kernel(const CUtensorMap* map, int rank, int c0, int row0, int bh,
                int dst, int* err) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(arena + (1 << 15));
  mbar_init(bar, 1);
  fence_barrier_init();
  uint32_t bytes = map->elem;
  for (int d = 0; d < map->rank; ++d) bytes *= map->box[d];
  mbar_arrive_expect_tx(bar, bytes);
  if (rank == 3)
    tma_load_3d(arena + dst, map, bar, c0, row0, bh);
  else
    tma_load_1d(arena + dst, map, bar, row0);
  *err = mbar_try_wait(bar, 0) ? 0 : 1;
}

// Two threads on one barrier of count 2, recording try_wait at each step;
// the expected bytes come from a 1-D copy of 16 floats.
void mbar_kernel(const CUtensorMap* map, int* seen) {
  uint64_t* bar = reinterpret_cast<uint64_t*>(arena + 1024);
  if (threadIdx.x == 0) {
    mbar_init(bar, 2);
    fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    seen[0] = mbar_try_wait(bar, 0);  // phase 0 running
    seen[1] = mbar_try_wait(bar, 1);  // the phase before phase 0
    mbar_arrive_expect_tx(bar, 64);
  }
  __syncthreads();
  if (threadIdx.x == 1) {
    mbar_arrive(bar);
    seen[2] = mbar_try_wait(bar, 0);  // 64 bytes still to come
    tma_load_1d(arena, map, bar, 0);
    seen[3] = mbar_try_wait(bar, 0);  // phase 0 complete
    seen[4] = mbar_try_wait(bar, 1);  // phase 1 running
    mbar_arrive(bar);
    mbar_arrive(bar);
    seen[5] = mbar_try_wait(bar, 1);  // phase 1 complete, no bytes asked
  }
}

// One warpgroup, two commit groups: d1 = A B, then d2 = A B, with A at
// offset 0 and B at b_off (both K-major, 64 x 16 in 64-wide rows). Each
// thread's accumulators to seen[stage][thread][32] after issue (stage 0),
// after wait<1> (1: d1 complete, d2 still in flight) and after wait<0>
// (2): seen[stage][0] is d1's, seen[stage][1] d2's.
void wait_kernel(int b_off, float* seen) {
  const int t = threadIdx.x;
  float d1[32], d2[32];
  for (int i = 0; i < 32; ++i) d1[i] = d2[i] = 100.f;
  const uint64_t da = smem_desc(arena, 16, 1024);
  const uint64_t db = smem_desc(arena + b_off, 16, 1024);
  auto record = [&](int stage) {
    for (int i = 0; i < 32; ++i) {
      seen[((stage * 2 + 0) * 128 + t) * 32 + i] = d1[i];
      seen[((stage * 2 + 1) * 128 + t) * 32 + i] = d2[i];
    }
  };
  wgmma_fence();
  wgmma_ss_n64<0>(d1, da, db, 0);
  wgmma_commit();
  wgmma_ss_n64<0>(d2, da, db, 0);
  wgmma_commit();
  record(0);
  wgmma_wait<1>();
  fence_regs(d1);
  record(1);
  wgmma_wait<0>();
  fence_regs(d2);
  record(2);
}

// One warpgroup's 64 x D accumulator (acc given per thread, panels of 32)
// to out, a bf16 [T, D] slab, by the per-row store_wg_rows: this thread's
// rows times mul[2 * thread] and mul[2 * thread + 1].
template <int D>
void store_kernel(const float* acc_in, const float* mul, int row0, int T,
                  __nv_bfloat16* out) {
  const int t = threadIdx.x;
  float acc[Sm90<D>::panels][32];
  for (int p = 0; p < Sm90<D>::panels; ++p)
    for (int i = 0; i < 32; ++i)
      acc[p][i] = acc_in[(t * Sm90<D>::panels + p) * 32 + i];
  const float m[2] = {mul[2 * t], mul[2 * t + 1]};
  store_wg_rows<D>(out, acc, row0, T, m);
}

// Two warpgroups take turns on named barriers 1 and 2, as the forward's
// consumers do: warpgroup w waits at 1 + w, and arrives at 2 - w when its
// turn ends; warpgroup 1 arrives once first, warpgroup 0 waits once last.
// Each turn's first thread appends its warpgroup to log, slowly.
int turns_seen = 0;
void pingpong_kernel(int rounds, int* log) {
  const int wg = threadIdx.x / 128;
  if (wg == 1) bar_arrive<256>(1);
  for (int r = 0; r < rounds; ++r) {
    bar_sync<256>(1 + wg);
    if (threadIdx.x % 128 == 0) {
      std::this_thread::sleep_for(std::chrono::milliseconds(1));
      log[turns_seen++] = wg;
    }
    bar_arrive<256>(2 - wg);
  }
  if (wg == 0) bar_sync<256>(1);
}

// A producer (the threads from `consumers`) lowers its registers to
// PRODUCER, the rest raise theirs to CONSUMER.
template <int PRODUCER, int CONSUMER>
void regs_kernel(int consumers) {
  if ((int)threadIdx.x >= consumers)
    setmaxnreg_dec<PRODUCER>();
  else
    setmaxnreg_inc<CONSUMER>();
}

}  // namespace tepdist

using namespace tepdist;

// The launch's error after a block of `threads` rebalances its registers:
// two consumer warpgroups, the rest producer.
extern "C" int run_regs(int threads, int producer) {
  if (producer == 24)
    ::emu::launch(regs_kernel<24, 240>, 1, threads, 0, nullptr, 256);
  else
    ::emu::launch(regs_kernel<40, 240>, 1, threads, 0, nullptr, 256);
  return cudaGetLastError();
}

extern "C" void run_wgmma(int n, int rs, const uint8_t* smem,
                          const uint32_t* a_regs, int a_off, int a_sbo,
                          int b_off, int b_lbo, int b_sbo, int trans_b,
                          float* d_out) {
  emu_smem_base = reinterpret_cast<char*>(arena);
  std::memcpy(arena, smem, sizeof(arena));
  if (n == 128)
    ::emu::launch(wgmma_kernel<128>, 1, 128, 0, nullptr, rs, a_regs, a_off,
                  a_sbo, b_off, b_lbo, b_sbo, trans_b, d_out);
  else if (n == 64)
    ::emu::launch(wgmma_kernel<64>, 1, 128, 0, nullptr, rs, a_regs, a_off,
                  a_sbo, b_off, b_lbo, b_sbo, trans_b, d_out);
  else
    ::emu::launch(wgmma_kernel<32>, 1, 128, 0, nullptr, rs, a_regs, a_off,
                  a_sbo, b_off, b_lbo, b_sbo, trans_b, d_out);
}

extern "C" void run_pingpong(int rounds, int* log) {
  turns_seen = 0;
  ::emu::launch(pingpong_kernel, 1, 256, 0, nullptr, rounds, log);
}

extern "C" void run_wait(const uint8_t* smem, int b_off, float* seen) {
  emu_smem_base = reinterpret_cast<char*>(arena);
  std::memcpy(arena, smem, sizeof(arena));
  ::emu::launch(wait_kernel, 1, 128, 0, nullptr, b_off, seen);
}

extern "C" void run_store(int D, const float* acc, const float* mul,
                          int row0, int T, __nv_bfloat16* out) {
  if (D == 32)
    ::emu::launch(store_kernel<32>, 1, 128, 0, nullptr, acc, mul, row0, T,
                  out);
  else
    ::emu::launch(store_kernel<128>, 1, 128, 0, nullptr, acc, mul, row0, T,
                  out);
}

extern "C" void run_accumulate(const uint8_t* smem, const float* x,
                               float* out) {
  emu_smem_base = reinterpret_cast<char*>(arena);
  std::memcpy(arena, smem, sizeof(arena));
  ::emu::launch(accumulate_kernel, 1, 128, 0, nullptr, x, out);
}

extern "C" uint64_t run_desc(int off, int lbo, int sbo) {
  emu_smem_base = reinterpret_cast<char*>(arena);
  return smem_desc(arena + off, lbo, sbo);
}

// A slab map (rank 3) or a row map (rank 1) as the kernels make them, one
// box loaded; the arena after the load to out. Returns the map's error.
extern "C" int run_tma(const void* src, int rank, int BH, int T, int D,
                       int rows, int c0, int row0, int bh, int dst,
                       uint8_t* out, int* wait_err) {
  emu_smem_base = reinterpret_cast<char*>(arena);
  std::memset(arena, 0xAB, sizeof(arena));
  CUtensorMap map;
  const cudaError_t err = rank == 3 ? slab_map(&map, src, BH, T, D, rows)
                                    : row_map(&map, src, BH, T, rows);
  if (err != cudaSuccess) return err;
  ::emu::launch(tma_kernel, 1, 1, 0, nullptr, &map, rank, c0, row0, bh, dst,
                wait_err);
  std::memcpy(out, arena, 1 << 15);
  return cudaGetLastError();
}

extern "C" void run_mbar(const float* src, int* seen) {
  emu_smem_base = reinterpret_cast<char*>(arena);
  CUtensorMap map;
  row_map(&map, src, 1, 16, 16);
  ::emu::launch(mbar_kernel, 1, 2, 0, nullptr, &map, seen);
}
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the stand-ins for the host")
    out = tmp_path_factory.mktemp("sm90_emu")
    cpp = out / "sm90_harness.cpp"
    cpp.write_text(HARNESS)
    so = out / "libsm90_harness.so"
    proc = subprocess.run(
        [gxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread", "-I",
         str(EMU), "-I", str(_build.CSRC), "-o", str(so), str(cpp)],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.run_desc.restype = ctypes.c_uint64
    return lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _bf16(rng, shape):
    """Random bf16 values as (float32 array, uint16 bits)."""
    x = rng.standard_normal(shape).astype(np.float32)
    bits = (x.view(np.uint32) >> 16).astype(np.uint16)  # truncate to bf16
    return (bits.astype(np.uint32) << 16).view(np.float32), bits


def _swizzled(byte):
    """Where the 128-byte swizzle puts byte offset ``byte`` of a
    1024-byte-aligned region: 16-byte piece c of 128-byte row r moves to
    piece c ^ (r % 8) (the ISA's table for the 128B mode)."""
    row, piece, within = byte // 128, (byte % 128) // 16, byte % 16
    return row * 128 + (piece ^ (row % 8)) * 16 + within


def _place(smem, off, rows_bits):
    """Rows of 64 bf16 (uint16 [R, 64]) into smem at off, one 128-byte row
    each, swizzled."""
    flat = rows_bits.astype(np.uint16).view(np.uint8).reshape(-1)
    for b in range(flat.size):
        smem[off + _swizzled(b)] = flat[b]


def _accumulator(d, n):
    """A [128 threads, N/2] accumulator as the 64 x N matrix, by the ISA's
    table: d[4j + 2h + e] of thread 32w + 4g + t is (16w + g + 8h,
    8j + 2t + e)."""
    out = np.full((64, n), np.nan, np.float32)
    for thread in range(128):
        w, g, t = thread // 32, (thread % 32) // 4, thread % 4
        for j in range(n // 8):
            for h in range(2):
                for e in range(2):
                    out[16 * w + g + 8 * h, 8 * j + 2 * t + e] = \
                        d[thread, 4 * j + 2 * h + e]
    return out


def _a_fragments(a_bits):
    """The register A operand (64 x 16 bf16) by the ISA's table: thread
    32w + 4g + t holds a[0] = (16w + g, 2t..2t+1), a[1] = (16w + g + 8, 2t..),
    a[2] = (16w + g, 2t+8..), a[3] = (16w + g + 8, 2t+8..), low column in
    the low half."""
    regs = np.zeros((128, 4), np.uint32)
    for thread in range(128):
        w, g, t = thread // 32, (thread % 32) // 4, thread % 4
        for i, (r, c) in enumerate([(g, 2 * t), (g + 8, 2 * t),
                                    (g, 2 * t + 8), (g + 8, 2 * t + 8)]):
            row = 16 * w + r
            regs[thread, i] = (int(a_bits[row, c])
                               | (int(a_bits[row, c + 1]) << 16))
    return regs


def test_descriptor_fields_follow_the_isa(lib):
    # start >> 4 in bits 0-13, LBO >> 4 in 16-29, SBO >> 4 in 32-45,
    # base offset 0 (bits 49-51), layout type 1 (128B swizzle) in 62-63.
    desc = lib.run_desc(0x1230, 0x2000, 0x400)
    assert desc & 0x3FFF == 0x123
    assert (desc >> 16) & 0x3FFF == 0x200
    assert (desc >> 32) & 0x3FFF == 0x40
    assert (desc >> 49) & 0x7 == 0
    assert desc >> 62 == 1


@pytest.mark.parametrize("n,rs,trans_b", [
    (64, False, False), (64, False, True), (32, False, False),
    (64, True, False), (64, True, True), (128, False, False)])
def test_wgmma_follows_the_isa(lib, n, rs, trans_b):
    """D = A B for m64nNk16 with A K-major in shared memory (or from
    registers) and B K-major (stored as N rows of k) or MN-major (stored as
    16 rows of n), each operand at a k offset inside its swizzled rows."""
    rng = np.random.default_rng(11 + n + 2 * rs + trans_b)
    a, a_bits = _bf16(rng, (64, 16))
    b, b_bits = _bf16(rng, (16, n))
    smem = np.zeros(ARENA, np.uint8)
    kk = 2  # the k slice: columns 32..47 of 64-wide rows
    a_rows = np.zeros((64, 64), np.uint16)
    a_rows[:, 16 * kk:16 * kk + 16] = a_bits
    _place(smem, 0, a_rows)  # 8 KB at 0
    b_off = 8192
    if trans_b:
        b_rows = np.zeros((16, 64), np.uint16)
        b_rows[:, :n] = b_bits  # row k holds n = 0..N-1
        _place(smem, b_off, b_rows)
        b_start, lbo, sbo = b_off, 1024, 1024
    else:
        b_rows = np.zeros((n, 64), np.uint16)
        b_rows[:, 16 * kk:16 * kk + 16] = b_bits.T  # row n holds k
        _place(smem, b_off, b_rows)
        b_start, lbo, sbo = b_off + 32 * kk, 16, 1024
    regs = _a_fragments(a_bits)
    d = np.zeros((128, n // 2), np.float32)
    lib.run_wgmma(n, int(rs), _ptr(smem), _ptr(regs), 32 * kk, 1024,
                  b_start, lbo, sbo, int(trans_b), _ptr(d))
    got = _accumulator(d, n)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


def test_accumulate_carries_fp32_x_through_the_split(lib):
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 64)).astype(np.float32)
    b, b_bits = _bf16(rng, (64, 64))
    smem = np.zeros(ARENA, np.uint8)
    _place(smem, 0, b_bits)  # 64 rows of k, n along the row
    xs = np.zeros((128, 32), np.float32)
    for thread in range(128):
        w, g, t = thread // 32, (thread % 32) // 4, thread % 4
        for j in range(8):
            for i in range(4):
                xs[thread, 4 * j + i] = x[16 * w + g + 8 * (i >> 1),
                                          8 * j + 2 * t + (i & 1)]
    out = np.zeros((128, 32), np.float32)
    lib.run_accumulate(_ptr(smem), _ptr(xs), _ptr(out))
    got = _accumulator(out, 64)
    x64, b64 = x.astype(np.float64), b.astype(np.float64)
    ref = x64 @ b64
    assert np.all(np.abs(got - ref) <= 2.0 ** -15 * (np.abs(x64)
                                                     @ np.abs(b64)))
    # A single bf16 X would miss by about 2**-9 relative: the split matters.
    assert np.abs(got - ref).max() < 2.0 ** -12 * np.abs(ref).max()


def test_named_barriers_alternate_two_warpgroups(lib):
    """bar.sync / bar.arrive of 256 threads on barriers 1 and 2 let the
    forward's two consumer warpgroups issue in turns, 0 first: each turn
    ends before the other warpgroup's begins, and the last arrival of
    warpgroup 1 is taken up, so the block ends."""
    log = np.full(12, -1, np.int32)
    lib.run_pingpong(6, _ptr(log))
    assert list(log) == [0, 1] * 6


def test_wgmma_result_lands_at_its_wait(lib):
    """A wgmma's product reaches its accumulator only at the wait that
    completes its commit group: read before, the accumulator holds its
    value from before the issue (100); wait<1> completes the first of two
    groups and leaves the second in flight (flash_dq.cu waits so for S
    while dP runs); wait<0> completes both."""
    rng = np.random.default_rng(3)
    a, a_bits = _bf16(rng, (64, 16))
    b, b_bits = _bf16(rng, (16, 64))
    smem = np.zeros(ARENA, np.uint8)
    a_rows = np.zeros((64, 64), np.uint16)
    a_rows[:, :16] = a_bits
    _place(smem, 0, a_rows)
    b_rows = np.zeros((64, 64), np.uint16)
    b_rows[:, :16] = b_bits.T  # row n holds k
    _place(smem, 8192, b_rows)
    seen = np.zeros((3, 2, 128, 32), np.float32)
    lib.run_wait(_ptr(smem), 8192, _ptr(seen))
    ref = a.astype(np.float64) @ b.astype(np.float64)
    stale = np.full((64, 64), 100.0)
    tol = dict(rtol=1e-6, atol=1e-6 * np.abs(ref).max())
    for stage, want in enumerate([(stale, stale), (ref, stale),
                                  (ref, ref)]):
        for which in range(2):
            np.testing.assert_allclose(
                _accumulator(seen[stage, which], 64), want[which], **tol,
                err_msg=f"after stage {stage}, d{which + 1}")


@pytest.mark.parametrize("D,row0,T", [(32, 0, 50), (128, 64, 100)])
def test_store_rows_scales_each_row(lib, D, row0, T):
    """The forward's epilogue: each thread's two rows times their own
    multipliers (1 / l), rounded to bf16 once, columns past D and rows at
    or past T left as they were."""
    rng = np.random.default_rng(D + T)
    panels = max(1, D // 64)
    acc = rng.standard_normal((64, 64 * panels)).astype(np.float32)
    row_mul = rng.uniform(0.5, 2.0, 64).astype(np.float32)
    acc_in = np.zeros((128, panels, 32), np.float32)
    mul = np.zeros((128, 2), np.float32)
    for thread in range(128):
        w, g, t = thread // 32, (thread % 32) // 4, thread % 4
        for h in range(2):
            mul[thread, h] = row_mul[16 * w + g + 8 * h]
        for p in range(panels):
            for j in range(8):
                for i in range(4):
                    acc_in[thread, p, 4 * j + i] = acc[
                        16 * w + g + 8 * (i >> 1),
                        64 * p + 8 * j + 2 * t + (i & 1)]
    out = np.full((T, D), 0x7FC1, np.uint16)  # a NaN pattern: untouched
    lib.run_store(D, _ptr(acc_in), _ptr(mul), row0, T, _ptr(out))
    want = out.copy()
    rows = min(64, T - row0)
    prod = (acc[:rows, :D] * row_mul[:rows, None]).astype(np.float32)
    bits = prod.view(np.uint32)
    # round to nearest even, as __floats2bfloat162_rn does
    rounded = ((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16).astype(np.uint16)
    want[row0:row0 + rows] = rounded
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("D,T,rows,c0,row0,bh", [
    (64, 100, 64, 0, 64, 1),     # rows 100..127 past T: zeros
    (128, 70, 32, 64, 32, 0),    # the second 64-column box of D = 128
    (32, 50, 64, 0, 0, 1),       # columns 32..63 past D: zeros
])
def test_tma_box_is_swizzled_and_zero_filled(lib, D, T, rows, c0, row0, bh):
    """A box of the 3-D slab map lands as rows of 128 bytes with the
    128-byte swizzle; rows past T and columns past D arrive as zeros (the
    next head's rows are never read), and the barrier completes."""
    rng = np.random.default_rng(D + T)
    BH = 2
    _, bits = _bf16(rng, (BH, T, D))
    out = np.zeros(1 << 15, np.uint8)
    wait_err = np.zeros(1, np.int32)
    err = lib.run_tma(_ptr(bits), 3, BH, T, D, rows, c0, row0, bh, 0,
                      _ptr(out), _ptr(wait_err))
    assert err == 0 and wait_err[0] == 0
    want = np.zeros((rows, 64), np.uint16)
    for r in range(rows):
        for c in range(64):
            if row0 + r < T and c0 + c < D:
                want[r, c] = bits[bh, row0 + r, c0 + c]
    image = np.zeros(rows * 128, np.uint8)
    flat = want.view(np.uint8).reshape(-1)
    for byte in range(flat.size):
        image[_swizzled(byte)] = flat[byte]
    np.testing.assert_array_equal(out[:rows * 128], image)


def test_tma_row_vector_and_refusals(lib):
    """The 1-D row map: a box past the vector's end arrives as zeros, a box
    that starts off 16 bytes or lands off 128 fails the launch (as both did
    on the card), and an address TMA cannot take is refused."""
    BH, T, n = 2, 37, 32
    vec = np.arange(BH * T, dtype=np.float32) + 1
    out = np.zeros(1 << 15, np.uint8)
    wait_err = np.zeros(1, np.int32)
    start = T + 19  # 56, a multiple of 4
    assert lib.run_tma(_ptr(vec), 1, BH, T, 0, n, 0, start, 0, 0, _ptr(out),
                       _ptr(wait_err)) == 0
    got = out[:4 * n].view(np.float32)
    want = np.zeros(n, np.float32)
    valid = BH * T - start
    want[:valid] = vec[start:]
    np.testing.assert_array_equal(got, want)
    # A box whose first value is not on 16 bytes, or that lands off 128
    # bytes of shared memory, faults on the card.
    assert lib.run_tma(_ptr(vec), 1, BH, T, 0, n, 0, T, 0, 0, _ptr(out),
                       _ptr(wait_err)) == 715  # cudaErrorIllegalInstruction
    assert lib.run_tma(_ptr(vec), 1, BH, T, 0, n, 0, start, 0, 272,
                       _ptr(out), _ptr(wait_err)) == 716  # misaligned
    misaligned = vec.ctypes.data + 4
    err = lib.run_tma(ctypes.c_void_p(misaligned), 1, BH, T - 1, 0, n, 0, 0,
                      0, 0, _ptr(out), _ptr(wait_err))
    assert err == 716  # cudaErrorMisalignedAddress


def test_mbarrier_parity_follows_the_isa(lib):
    """try_wait.parity(P) succeeds once the phase of parity P has
    completed: at once for the parity before phase 0, and for phase 0 only
    after every arrival and every expected byte."""
    src = np.zeros(16, np.float32)
    seen = np.full(6, -1, np.int32)
    lib.run_mbar(_ptr(src), _ptr(seen))
    assert list(seen) == [0, 1, 0, 1, 0, 1]


@pytest.mark.parametrize("threads,producer,err", [
    (384, 24, 0),      # 128 x 24 + 256 x 240 = 384 x 168
    (288, 40, 702),    # one producer warp frees 32 x 128, 256 x 72 wanted
])
def test_setmaxnreg_keeps_the_block_within_its_registers(lib, threads,
                                                         producer, err):
    """ptxas launches a kernel that uses setmaxnreg with 168 registers a
    thread at 288 and at 384 threads (whole warpgroups; the card's ptxas
    report for 288). An inc that the decs do not pay for would wait
    forever on the card; the stand-in fails the launch instead."""
    assert lib.run_regs(threads, producer) == err
