// CPU stand-in for tepdist_tpu_torch/csrc/flash_mma.cuh: the same functions,
// computing what the PTX instructions compute with the fragment layouts of
// the PTX ISA (see the header comment there), on the host threads of
// cuda_runtime.h. A warp-wide instruction publishes each lane's operands in
// slots of its warp, waits at the warp's barrier, reads the other lanes'
// operands and waits again before the slots are reused. cp.async is a plain
// copy (or zero fill), so commit and wait have nothing to do.
#pragma once
#include <stdint.h>

#include <cstring>

#include "cuda_bf16.h"
#include "cuda_runtime.h"

namespace tepdist {

inline const void* emu_lane_addr[1024];
inline uint32_t emu_lane_a[1024][4];
inline uint32_t emu_lane_b[1024][2];

inline float emu_bf16_half(uint32_t reg, int half) {
  return __bfloat162float(__nv_bfloat16{(uint16_t)(reg >> (16 * half))});
}

inline void emu_ldmatrix_x4(uint32_t r[4], const void* row_addr, bool trans) {
  const int lane = threadIdx.x % 32, warp0 = threadIdx.x - lane;
  emu_lane_addr[threadIdx.x] = row_addr;
  emu_syncwarp();
  const int g = lane / 4, t = lane % 4;
  for (int i = 0; i < 4; ++i) {
    uint32_t reg = 0;
    for (int h = 0; h < 2; ++h) {
      // Element (row, col) of matrix i; lane 8i + row gave that row.
      const int row = trans ? 2 * t + h : g;
      const int col = trans ? g : 2 * t + h;
      const uint16_t* src =
          static_cast<const uint16_t*>(emu_lane_addr[warp0 + 8 * i + row]);
      reg |= (uint32_t)src[col] << (16 * h);
    }
    r[i] = reg;
  }
  emu_syncwarp();
}

inline void ldmatrix_x4(uint32_t r[4], const void* row_addr) {
  emu_ldmatrix_x4(r, row_addr, false);
}

inline void ldmatrix_x4_trans(uint32_t r[4], const void* row_addr) {
  emu_ldmatrix_x4(r, row_addr, true);
}

inline void mma_bf16_16816(float d[4], const uint32_t a[4],
                           const uint32_t b[2]) {
  const int lane = threadIdx.x % 32, warp0 = threadIdx.x - lane;
  std::memcpy(emu_lane_a[threadIdx.x], a, sizeof(emu_lane_a[0]));
  std::memcpy(emu_lane_b[threadIdx.x], b, sizeof(emu_lane_b[0]));
  emu_syncwarp();
  // A(row, k): lane (row % 8) * 4 + (k % 8) / 2, register
  // (row >= 8) + 2 * (k >= 8), half k % 2. B(k, n): lane n * 4 + (k % 8) / 2,
  // register k >= 8, half k % 2.
  auto A = [&](int row, int k) {
    const uint32_t* regs = emu_lane_a[warp0 + (row % 8) * 4 + (k % 8) / 2];
    return emu_bf16_half(regs[(row >= 8) + 2 * (k >= 8)], k % 2);
  };
  auto B = [&](int k, int n) {
    return emu_bf16_half(emu_lane_b[warp0 + n * 4 + (k % 8) / 2][k >= 8],
                         k % 2);
  };
  const int g = lane / 4, t = lane % 4;
  float out[4];
  for (int e = 0; e < 4; ++e) {
    const int row = g + 8 * (e >> 1), col = 2 * t + (e & 1);
    float acc = d[e];
    for (int k = 0; k < 16; ++k) acc += A(row, k) * B(k, col);
    out[e] = acc;
  }
  emu_syncwarp();
  std::memcpy(d, out, sizeof(out));
}

inline void cp_async_16(void* dst, const void* src, bool fill) {
  if (fill)
    std::memcpy(dst, src, 16);
  else
    std::memset(dst, 0, 16);
}

inline void cp_async_commit() {}

template <int N>
inline void cp_async_wait() {}

}  // namespace tepdist
