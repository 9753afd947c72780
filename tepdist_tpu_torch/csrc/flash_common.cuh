// Shared pieces of the three flash-attention kernels (flash_fwd.cu,
// flash_dq.cu, flash_dkv.cu).
//
// Layout: every operand is one [BH, T, D] slab, row-major and contiguous;
// LSE and delta are [BH, T] fp32. A CTA owns kRows rows of one (b*h) slab
// and streams the other operand through shared memory kTile rows at a time.
// Each owned row has Split<D, ACC>::value threads, adjacent lanes of one
// warp; each thread holds the row's accumulators for its share of the head
// dim (every value-th float4 group) in registers, and the per-row dot
// products are summed across those lanes with warp shuffles. Shared memory
// always holds fp32 (bf16 inputs are widened on load), rows padded
// (Split::stride) so that float4 reads stay aligned and threads reading
// their own rows hit distinct banks, while reads of a streamed row are
// broadcasts. All arithmetic is fp32 FMA on the CUDA cores, including for
// bf16 inputs, so the kernels compute what the Pallas kernels compute (they
// upcast Q, K, V to fp32 before both dots).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

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
