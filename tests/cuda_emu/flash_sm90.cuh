// CPU stand-in for tepdist_tpu_torch/csrc/flash_sm90.cuh: the same functions,
// computing what the Hopper instructions compute with the layouts of the
// PTX ISA (see the header comment there), on the host threads of
// cuda_runtime.h.
//
// Shared memory: a descriptor's start address counts from emu_smem_base, the
// 1024-byte-aligned arena a host build gives the kernels, so the 128-byte
// swizzle (bits 4-6 of an address ^= bits 7-9) falls where the hardware puts
// it. wgmma publishes each thread's A registers in slots of its warpgroup,
// waits at the warpgroup's barrier, computes this thread's accumulator elements
// from the operands the descriptors and slots give, and waits again before the
// slots are reused. Its result lands in the accumulator registers only at the
// wgmma_wait<N> that completes its commit group, as on the card: each thread
// keeps its products in flight with the group they were issued in (the count
// of its commits so far), and wait<N> writes those of every group but the N
// it committed last. Until then a read of the accumulator sees its value from
// before the issue, and a write to it is lost; a wgmma that adds to an
// accumulator still in flight adds to the value in flight. A TMA load copies its box at once (swizzled, zero past the tensor) and
// then completes its bytes on the mbarrier; a box whose first element is not on
// 16 bytes, or whose destination is not on 128, fails the launch as it does on
// the card (cudaErrorIllegalInstruction, cudaErrorMisalignedAddress). An
// mbarrier is its 8 bytes of shared memory, updated with atomics: transaction
// bytes (bits 0-31), pending arrivals (32-46), the arrival count (47-61) and
// the phase (63); a wait that finds the phase still running yields the thread.
// setmaxnreg keeps the block's register count: ptxas launches a kernel that
// uses it with 65536 / (128 x its warpgroups) registers a thread, rounded down
// to 8 (168 for 288 or 384 threads on the card); each warp's dec gives the
// difference to the block's pool and each warp's inc takes it, and an inc that
// finds too little within a second would wait forever on the card, so it fails
// the launch (cudaErrorLaunchTimeout) instead.
#pragma once
#include <stdint.h>

#include <atomic>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include "cuda_bf16.h"
#include "cuda_runtime.h"

namespace tepdist {

// Internal linkage: every host build of a kernel source is a library of
// its own with its own arena, and an inline variable would be one symbol
// across all the libraries a process loads.
static char* emu_smem_base = nullptr;

inline uint32_t emu_offset(const void* p) {
  if (emu_smem_base == nullptr) {
    std::fprintf(stderr, "flash_sm90 stand-in: emu_smem_base is not set\n");
    std::abort();
  }
  return (uint32_t)(static_cast<const char*>(p) - emu_smem_base);
}

// Byte offset of an address after the 128-byte swizzle.
inline uint32_t emu_swizzle128(uint32_t a) {
  return a ^ (((a >> 7) & 7) << 4);
}

inline uint64_t smem_desc(const void* start, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((emu_offset(start) & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

// ---- wgmma --------------------------------------------------------------

// This thread's products in flight: the accumulator each lands in, its
// commit group and its value (one entry an accumulator). Static: a library
// of its own per host build, as emu_smem_base.
struct EmuInFlight {
  float* d;
  int n;
  long group;
  float value[64];
};
static thread_local std::vector<EmuInFlight> emu_in_flight;
static thread_local long emu_commits = 0;  // this thread's commit groups

inline void wgmma_fence() {}
inline void wgmma_commit() { ++emu_commits; }

// Groups 0 .. emu_commits - 1 are committed; all but the last N complete.
template <int N>
inline void wgmma_wait() {
  std::vector<EmuInFlight> still;
  for (const EmuInFlight& f : emu_in_flight) {
    if (f.group < emu_commits - N)
      std::memcpy(f.d, f.value, sizeof(float) * f.n);
    else
      still.push_back(f);
  }
  emu_in_flight.swap(still);
}

template <int N>
inline void fence_regs(float (&)[N]) {}

struct EmuDesc {
  uint32_t start, lbo, sbo;
};

inline EmuDesc emu_decode(uint64_t desc) {
  if ((desc >> 62) != 1) {
    std::fprintf(stderr, "flash_sm90 stand-in: only the 128-byte swizzle "
                         "layout is modelled\n");
    std::abort();
  }
  return EmuDesc{(uint32_t)(desc & 0x3FFF) << 4,
                 (uint32_t)((desc >> 16) & 0x3FFF) << 4,
                 (uint32_t)((desc >> 32) & 0x3FFF) << 4};
}

inline float emu_bf16_at(uint32_t offset) {
  uint16_t bits;
  std::memcpy(&bits, emu_smem_base + emu_swizzle128(offset), 2);
  return __bfloat162float(__nv_bfloat16{bits});
}

// Element (row, k) of a K-major operand: row m of A, or n of B.
inline float emu_kmajor(const EmuDesc& d, int row, int k) {
  return emu_bf16_at(d.start + (row / 8) * d.sbo + (row % 8) * 128 + 2 * k);
}

// Element (k, n) of an MN-major B.
inline float emu_mnmajor(const EmuDesc& d, int k, int n) {
  return emu_bf16_at(d.start + (n / 64) * d.lbo + 2 * (n % 64) +
                     (k / 8) * d.sbo + (k % 8) * 128);
}

inline uint32_t emu_wg_a[1024][4];

// d (this thread's N / 2 elements of the 64 x N accumulator) = A B
// + (scale_d ? d : 0); A from the descriptor, or from every thread's a.
// The result is in flight until the wait that completes this commit group.
template <int N>
inline void emu_wgmma(float* d, const uint32_t* a, uint64_t desc_a,
                      uint64_t desc_b, int trans_b, int scale_d) {
  static_assert(N / 2 <= 64, "EmuInFlight holds 64 values");
  EmuInFlight* prior = nullptr;  // d's value in flight, if any
  for (EmuInFlight& f : emu_in_flight)
    if (f.d == d) prior = &f;
  const float* base = prior ? prior->value : d;
  const int wt = threadIdx.x % 128, wg0 = threadIdx.x - wt;
  if (a) std::memcpy(emu_wg_a[threadIdx.x], a, sizeof(emu_wg_a[0]));
  emu_syncwarpgroup();
  const EmuDesc da = a ? EmuDesc{} : emu_decode(desc_a);
  const EmuDesc db = emu_decode(desc_b);
  auto A = [&](int m, int k) {
    if (!a) return emu_kmajor(da, m, k);
    // Warp m / 16, lane (m % 8) * 4 + (k % 8) / 2, register
    // (m % 16 >= 8) + 2 (k >= 8), half k % 2.
    const uint32_t* regs =
        emu_wg_a[wg0 + 32 * (m / 16) + (m % 8) * 4 + (k % 8) / 2];
    const uint32_t reg = regs[(m % 16 >= 8) + 2 * (k >= 8)];
    return __bfloat162float(__nv_bfloat16{(uint16_t)(reg >> (16 * (k % 2)))});
  };
  auto B = [&](int k, int n) {
    return trans_b ? emu_mnmajor(db, k, n) : emu_kmajor(db, n, k);
  };
  const int warp = wt / 32, g = (wt % 32) / 4, t = wt % 4;
  float out[N / 2];
  for (int j = 0; j < N / 8; ++j)
    for (int i = 0; i < 4; ++i) {
      const int m = 16 * warp + g + 8 * (i >> 1), n = 8 * j + 2 * t + (i & 1);
      float acc = 0.f;
      for (int k = 0; k < 16; ++k) acc += A(m, k) * B(k, n);
      out[4 * j + i] = (scale_d ? base[4 * j + i] : 0.f) + acc;
    }
  emu_syncwarpgroup();
  if (!prior) {
    emu_in_flight.push_back(EmuInFlight{d, N / 2, 0, {}});
    prior = &emu_in_flight.back();
  }
  prior->group = emu_commits;
  std::memcpy(prior->value, out, sizeof(out));
}

template <int TRANS_B>
inline void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                         int scale_d) {
  emu_wgmma<64>(d, nullptr, desc_a, desc_b, TRANS_B, scale_d);
}

template <int TRANS_B>
inline void wgmma_ss_n32(float (&d)[16], uint64_t desc_a, uint64_t desc_b,
                         int scale_d) {
  emu_wgmma<32>(d, nullptr, desc_a, desc_b, TRANS_B, scale_d);
}

template <int TRANS_B>
inline void wgmma_ss_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b,
                          int scale_d) {
  emu_wgmma<128>(d, nullptr, desc_a, desc_b, TRANS_B, scale_d);
}

template <int TRANS_B>
inline void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                         uint64_t desc_b, int scale_d) {
  emu_wgmma<64>(d, a, 0, desc_b, TRANS_B, scale_d);
}

// ---- named barriers -------------------------------------------------------

template <int N>
inline void bar_sync(int id) {
  emu_named_barrier(id, N).arrive_and_wait();
}

template <int N>
inline void bar_arrive(int id) {
  (void)emu_named_barrier(id, N).arrive();
}

// ---- mbarrier -----------------------------------------------------------

constexpr uint64_t kEmuTx = 0xFFFFFFFFull, kEmuPending = 0x7FFFull << 32,
                   kEmuCount = 0x7FFFull << 47, kEmuPhase = 1ull << 63;

// Adds arrivals (-1 or 0) and transaction bytes to the barrier; the phase
// completes when both reach zero.
inline void emu_mbar_update(uint64_t* bar, int arrivals, int64_t tx) {
  std::atomic_ref<uint64_t> word(*bar);
  uint64_t old = word.load(), next;
  do {
    const uint64_t count = (old & kEmuCount) >> 47;
    uint64_t pending = ((old & kEmuPending) >> 32) + arrivals;
    int64_t bytes = (int32_t)(uint32_t)(old & kEmuTx) + tx;
    uint64_t phase = old & kEmuPhase;
    if (pending == 0 && bytes == 0) {
      pending = count;
      phase ^= kEmuPhase;
    }
    next = phase | (count << 47) | (pending << 32) | (uint32_t)(int32_t)bytes;
  } while (!word.compare_exchange_weak(old, next));
}

inline void mbar_init(uint64_t* bar, uint32_t count) {
  std::atomic_ref<uint64_t>(*bar).store(((uint64_t)count << 47) |
                                        ((uint64_t)count << 32));
}

inline void fence_barrier_init() {}

inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  emu_mbar_update(bar, -1, bytes);
}

inline void mbar_arrive(uint64_t* bar) { emu_mbar_update(bar, -1, 0); }

inline bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  const uint64_t word = std::atomic_ref<uint64_t>(*bar).load();
  if ((word >> 63) != parity) return true;
  std::this_thread::yield();
  return false;
}

// ---- TMA ------------------------------------------------------------------

inline void emu_tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                         const int* coord) {
  // The box's first element must lie on 16 bytes: on the card a 1-D fp32
  // box at an odd start stops the kernel with an illegal instruction. Its
  // destination must lie on 128 bytes: one on 16 stops it with a
  // misaligned address.
  const uint32_t at = emu_offset(dst);
  if ((int64_t)coord[0] * map->elem % 16 != 0) {
    std::fprintf(stderr, "flash_sm90 stand-in: a TMA box starts at %d, "
                 "not on 16 bytes\n", coord[0]);
    emu_launch_error = cudaErrorIllegalInstruction;
  }
  if (at % 128 != 0) {
    std::fprintf(stderr, "flash_sm90 stand-in: a TMA box lands at shared "
                 "offset %u, not on 128 bytes\n", at);
    emu_launch_error = cudaErrorMisalignedAddress;
  }
  uint32_t n = 1;
  for (int d = 0; d < map->rank; ++d) n *= map->box[d];
  for (uint32_t idx = 0; idx < n; ++idx) {
    uint32_t rest = idx;
    bool inside = true;
    uint64_t src = 0;
    for (int d = 0; d < map->rank; ++d) {
      const int64_t c = coord[d] + (int64_t)(rest % map->box[d]);
      rest /= map->box[d];
      inside = inside && c >= 0 && c < (int64_t)map->dims[d];
      src += (uint64_t)c * map->strides[d];
    }
    uint32_t off = at + idx * map->elem;
    if (map->swizzle == CU_TENSOR_MAP_SWIZZLE_128B) off = emu_swizzle128(off);
    if (inside)
      std::memcpy(emu_smem_base + off, map->base + src, map->elem);
    else
      std::memset(emu_smem_base + off, 0, map->elem);
  }
  emu_mbar_update(bar, 0, -(int64_t)n * map->elem);
}

inline void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                        int c0, int c1, int c2) {
  const int coord[3] = {c0, c1, c2};
  emu_tma_load(dst, map, bar, coord);
}

inline void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar,
                        int c0) {
  emu_tma_load(dst, map, bar, &c0);
}

// ---- arithmetic -----------------------------------------------------------

// ex2.approx.ftz: 2^x, results below 2^-126 flushed to zero.
inline float ex2_approx(float x) {
  const float y = std::exp2(x);
  return y < 1.17549435e-38f ? 0.f : y;
}

// ---- registers ------------------------------------------------------------

inline int emu_entry_regs() {
  const int groups = (int)(blockDim.x + 127) / 128;
  return 65536 / (128 * groups) / 8 * 8;
}

template <int R>
inline void setmaxnreg_inc() {
  if (threadIdx.x % 32 != 0) return;
  const long need = (long)(R - emu_entry_regs()) * 32;
  const auto start = std::chrono::steady_clock::now();
  for (long have = emu_reg_pool.load();;) {
    if (have >= need && emu_reg_pool.compare_exchange_weak(have, have - need))
      return;
    if (std::chrono::steady_clock::now() - start > std::chrono::seconds(1)) {
      std::fprintf(stderr, "flash_sm90 stand-in: setmaxnreg.inc %d finds %ld "
                   "of %ld registers\n", R, have, need);
      emu_launch_error = cudaErrorLaunchTimeout;
      return;
    }
    std::this_thread::yield();
    have = emu_reg_pool.load();
  }
}

template <int R>
inline void setmaxnreg_dec() {
  if (threadIdx.x % 32 == 0) emu_reg_pool += (long)(emu_entry_regs() - R) * 32;
}

}  // namespace tepdist
