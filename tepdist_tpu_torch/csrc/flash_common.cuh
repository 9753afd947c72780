// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_dq.cu, flash_dkv.cu).
//
// Layout: every operand is one [BH, T, D] slab, row-major and contiguous;
// LSE and delta are [BH, T] fp32. A CTA owns kRows rows of one (b*h) slab
// and streams the other operand through shared memory.
//
// CUDA-core path (fp32 forward, dQ and dK/dV): each owned row has
// Split<D, ACC>::value threads, adjacent lanes of one warp; each thread
// holds the row's accumulators for its share of the head dim (every
// value-th float4 group) in registers, and the per-row dot products are
// summed across those lanes with warp shuffles. Shared memory holds fp32
// (bf16 inputs are widened on load), rows padded (Split::stride) so that
// float4 reads stay aligned and threads reading their own rows hit distinct
// banks, while reads of a streamed row are broadcasts. All arithmetic is
// fp32 FMA, so the kernels compute what the Pallas kernels compute (they
// upcast Q, K, V to fp32 before both dots).
//
// Tensor-core path (bf16 forward, dQ and dK/dV): a CTA of kTcWarps warps,
// 16 owned rows each; bf16 tiles in shared memory (Tc::stride), loaded with
// cp.async, and every dot an mma.sync of flash_mma.cuh with fp32 sums. The
// first dots (S, dP) multiply bf16 inputs exactly, as the Pallas kernels'
// fp32 dots of upcast bf16 do; the second dots take the fp32 P or dS as a
// hi/lo pair of bf16 values (split2), so the product carries P to about
// 2^-17 relative instead of rounding it to bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

// Angle brackets: found through the include path, never beside this file,
// so the host build of tests/test_torch_kernel_emulation.py gets its
// stand-in (tests/cuda_emu/flash_mma.cuh).
#include <flash_mma.cuh>

namespace tepdist {

constexpr float kNegInf = -1e30f;  // _NEG_INF of the Pallas kernels
constexpr int kRows = 64;          // rows a CTA owns
constexpr int kTile = 32;          // streamed rows staged per step

// Threads per owned row, for a kernel whose threads keep at most ACC floats
// of each D-wide accumulator row in registers, so that accumulators and
// the scores of a chunk fit in the 255 registers without spilling.
template <int D, int ACC>
struct Split {
  static constexpr int value = D > ACC ? D / ACC : 1;
  static constexpr int groups = D / 4 / value;  // float4 groups per thread
  // Shared-memory row stride in floats. One float4 of padding per lane of
  // a row shifts consecutive rows by 4 * value banks, so the float4 reads
  // of a quarter warp (8 lanes: 8 / value rows, each lane at its own
  // group) fall on distinct banks.
  static constexpr int stride = D + 4 * value;
};

// Sum of v over the TPR lanes of one row (all lanes get the sum).
template <int TPR>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 1; off < TPR; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename scalar_t>
__device__ __forceinline__ scalar_t from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Rows [row0, row0 + nrows) of one [T, D] slab into fp32 shared memory
// with row stride S, times mul. Rows at or past T (the ragged edge) are
// zero.
template <typename scalar_t, int D, int S>
__device__ __forceinline__ void load_rows(float* dst,
                                          const scalar_t* __restrict__ src,
                                          int row0, int nrows, int T,
                                          float mul) {
  for (int idx = threadIdx.x; idx < nrows * D; idx += blockDim.x) {
    const int r = idx / D, c = idx % D;
    const int g = row0 + r;
    dst[r * S + c] = g < T ? to_f32(src[(size_t)g * D + c]) * mul : 0.f;
  }
}

// Entries [row0, row0 + nrows) of a per-row fp32 vector, zero past T.
__device__ __forceinline__ void load_vec(float* dst,
                                         const float* __restrict__ src,
                                         int row0, int nrows, int T) {
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    const int g = row0 + r;
    dst[r] = g < T ? src[g] : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// ---- Tensor-core path --------------------------------------------------

constexpr int kTcWarps = 4;  // warps of a CTA; each owns 16 of the kRows

template <int D>
struct Tc {
  // bf16 row stride in shared memory: 16 bytes of padding shift each row by
  // four banks, so the eight 16-byte rows of one ldmatrix hit distinct
  // banks, and rows stay 16-byte aligned for cp.async.
  static constexpr int stride = D + 8;
  // Streamed rows a warp scores per register round (S and dP hold
  // cols / 2 floats each), fewer at D = 128 where the accumulators of the
  // owned rows take D / 2 floats each.
  static constexpr int cols = D <= 64 ? 64 : 32;
};

// This lane's row and column offsets within a 16x16 tile for ldmatrix_x4.
// Pattern "a" gives an A operand from a row-major [m][k] tile, or with
// .trans two B operands (n 0-7, n 8-15) from a row-major [k][n] tile;
// pattern "b" gives two B operands from a row-major [n][k] tile, without
// .trans. Either way registers {0, 1} and {2, 3} are the two 8-wide halves.
__device__ __forceinline__ int ldm_row_a(int lane) {
  return (lane & 7) + ((lane >> 3) & 1) * 8;
}
__device__ __forceinline__ int ldm_col_a(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int ldm_row_b(int lane) {
  return (lane & 7) + (lane >> 4) * 8;
}
__device__ __forceinline__ int ldm_col_b(int lane) {
  return ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// x0, x1 as packed bf16 pairs with x = hi + lo to about 2^-17 relative.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(__float2bfloat16(x0 - __bfloat162float(h0)),
                 __float2bfloat16(x1 - __bfloat162float(h1)));
}

// Rows [row0, row0 + ROWS) of one bf16 [T, D] slab into shared memory with
// row stride Tc<D>::stride, by cp.async in 16-byte pieces; rows at or past T
// (the ragged edge) are zero. The caller commits and waits.
template <int D, int ROWS = kRows>
__device__ __forceinline__ void load_tile_async(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int row0,
    int T) {
  constexpr int kPieces = D / 8;  // 16-byte pieces per row
  for (int idx = threadIdx.x; idx < ROWS * kPieces; idx += blockDim.x) {
    const int r = idx / kPieces, c = (idx % kPieces) * 8;
    const int g = row0 + r;
    cp_async_16(dst + r * Tc<D>::stride + c,
                src + (size_t)(g < T ? g : 0) * D + c, g < T);
  }
}

// One warp's S = A X^T and dP = B Y^T for its 16 owned rows (a, b: their
// first rows in shared memory) against N streamed rows (x, y: the first of
// them), D deep. Tile j of s and dp covers streamed rows 8j..8j+7 in the
// accumulator layout of flash_mma.cuh.
template <int D, int N>
__device__ __forceinline__ void scores(float (&s)[N / 8][4],
                                       float (&dp)[N / 8][4],
                                       const __nv_bfloat16* a,
                                       const __nv_bfloat16* b,
                                       const __nv_bfloat16* x,
                                       const __nv_bfloat16* y) {
  constexpr int S = Tc<D>::stride;
  const int lane = threadIdx.x % 32;
  const int ar = ldm_row_a(lane), ac = ldm_col_a(lane);
  const int br = ldm_row_b(lane), bc = ldm_col_b(lane);
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t fa[4], fb[4];
    ldmatrix_x4(fa, a + ar * S + kk * 16 + ac);
    ldmatrix_x4(fb, b + ar * S + kk * 16 + ac);
#pragma unroll
    for (int jj = 0; jj < N / 16; ++jj) {
      uint32_t fx[4], fy[4];
      ldmatrix_x4(fx, x + (jj * 16 + br) * S + kk * 16 + bc);
      ldmatrix_x4(fy, y + (jj * 16 + br) * S + kk * 16 + bc);
      mma_bf16_16816(s[2 * jj], fa, fx);
      mma_bf16_16816(s[2 * jj + 1], fa, fx + 2);
      mma_bf16_16816(dp[2 * jj], fb, fy);
      mma_bf16_16816(dp[2 * jj + 1], fb, fy + 2);
    }
  }
}

// One warp's S = A X^T for R blocks of 16 owned rows against N streamed
// rows (x: the first, in shared memory), D deep, with the A operands in
// registers (a[r][kk]: block r, columns 16kk..16kk+15, as ldmatrix_x4 with
// pattern "a" leaves them). Each B operand is loaded once for all R blocks.
// Tile j of s[r] covers streamed rows 8j..8j+7 in the accumulator layout.
template <int D, int N, int R>
__device__ __forceinline__ void score(float (&s)[R][N / 8][4],
                                      const uint32_t (&a)[R][D / 16][4],
                                      const __nv_bfloat16* x) {
  constexpr int S = Tc<D>::stride;
  const int lane = threadIdx.x % 32;
  const int br = ldm_row_b(lane), bc = ldm_col_b(lane);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[r][j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int jj = 0; jj < N / 16; ++jj) {
      uint32_t fx[4];
      ldmatrix_x4(fx, x + (jj * 16 + br) * S + kk * 16 + bc);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        mma_bf16_16816(s[r][2 * jj], a[r][kk], fx);
        mma_bf16_16816(s[r][2 * jj + 1], a[r][kk], fx + 2);
      }
    }
}

// acc += P X for one warp: P (16 x N, fp32, in the layout scores() leaves)
// against N streamed rows of X (x: the first, in shared memory), D wide.
// Two tiles of P make one A operand straight from registers, fed as a
// hi/lo pair of bf16 values; X comes in as B through ldmatrix .trans.
template <int D, int N>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&p)[N / 8][4],
                                           const __nv_bfloat16* x) {
  constexpr int S = Tc<D>::stride;
  const int lane = threadIdx.x % 32;
  const int ar = ldm_row_a(lane), ac = ldm_col_a(lane);
#pragma unroll
  for (int kq = 0; kq < N / 16; ++kq) {
    uint32_t hi[4], lo[4];
    split2(p[2 * kq][0], p[2 * kq][1], hi[0], lo[0]);
    split2(p[2 * kq][2], p[2 * kq][3], hi[1], lo[1]);
    split2(p[2 * kq + 1][0], p[2 * kq + 1][1], hi[2], lo[2]);
    split2(p[2 * kq + 1][2], p[2 * kq + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int dd = 0; dd < D / 16; ++dd) {
      uint32_t fx[4];
      ldmatrix_x4_trans(fx, x + (kq * 16 + ar) * S + dd * 16 + ac);
      mma_bf16_16816(acc[2 * dd], hi, fx);
      mma_bf16_16816(acc[2 * dd], lo, fx);
      mma_bf16_16816(acc[2 * dd + 1], hi, fx + 2);
      mma_bf16_16816(acc[2 * dd + 1], lo, fx + 2);
    }
  }
}

// One warp's 16 x D fp32 accumulator to rows [row0, row0 + 16) of a bf16
// [T, D] slab, this lane's row row0 + lane / 4 times mul[0] and the row 8
// below it times mul[1]; rows at or past T are not written.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           const float (&acc)[D / 8][4],
                                           int row0, int T,
                                           const float (&mul)[2]) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + lane / 4 + 8 * h;
    if (r >= T) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int c = 8 * j + 2 * (lane % 4);
      out[(size_t)r * D + c] = __float2bfloat16(acc[j][2 * h] * mul[h]);
      out[(size_t)r * D + c + 1] =
          __float2bfloat16(acc[j][2 * h + 1] * mul[h]);
    }
  }
}

// The same, every row times one mul.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ out,
                                           const float (&acc)[D / 8][4],
                                           int row0, int T, float mul) {
  const float both[2] = {mul, mul};
  store_rows<D>(out, acc, row0, T, both);
}

// Dynamic shared memory above 48 KB needs the attribute; set it every
// launch (a host-side call) so no static state is kept.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace tepdist

// Expands the body (the trailing arguments) once per (dtype, head dim) the
// kernels are built for, with scalar_t and HEAD_DIM bound; an unsupported
// pair returns
// cudaErrorInvalidValue. The Python wrapper checks both before the call.
#define TEPDIST_DISPATCH(is_bf16, D, ...)                          \
  do {                                                              \
    if (is_bf16) {                                                  \
      using scalar_t = __nv_bfloat16;                               \
      switch (D) {                                                  \
        case 16: { constexpr int HEAD_DIM = 16; __VA_ARGS__; } break;      \
        case 32: { constexpr int HEAD_DIM = 32; __VA_ARGS__; } break;      \
        case 64: { constexpr int HEAD_DIM = 64; __VA_ARGS__; } break;      \
        case 128: { constexpr int HEAD_DIM = 128; __VA_ARGS__; } break;    \
        default: return (int)cudaErrorInvalidValue;                 \
      }                                                             \
    } else {                                                        \
      using scalar_t = float;                                       \
      switch (D) {                                                  \
        case 16: { constexpr int HEAD_DIM = 16; __VA_ARGS__; } break;      \
        case 32: { constexpr int HEAD_DIM = 32; __VA_ARGS__; } break;      \
        case 64: { constexpr int HEAD_DIM = 64; __VA_ARGS__; } break;      \
        case 128: { constexpr int HEAD_DIM = 128; __VA_ARGS__; } break;    \
        default: return (int)cudaErrorInvalidValue;                 \
      }                                                             \
    }                                                               \
  } while (0)
