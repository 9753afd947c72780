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
// Hopper path (bf16 forward, dQ and dK/dV): warpgroup-wide wgmma on tiles
// that TMA brings into shared memory under mbarriers (flash_sm90.cuh); see
// "Hopper path" below. The first dots (S, dP) multiply bf16 inputs
// exactly, as the Pallas kernels' fp32 dots of upcast bf16 do; the second
// dots take the fp32 P or dS as a hi/lo pair of bf16 values (split_pair),
// so the product carries P to about 2^-17 relative instead of rounding it
// to bf16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

// Angle brackets: found through the include path, never beside this file,
// so the host build of tests/test_torch_kernel_emulation.py gets its
// stand-in (tests/cuda_emu/flash_sm90.cuh).
#include <flash_sm90.cuh>

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

// ---- Hopper path ----------------------------------------------------------
//
// A CTA of the bf16 forward, dQ and dK/dV kernels has kConsumers
// warpgroups, each owning kWgRows rows of the CTA's kCtaRows, and a
// producer warpgroup after them, one thread of which issues TMA loads: the
// CTA's own rows once (the persistent forward: once an item, into one of
// two buffers), then the streamed operands in tiles through a ring of
// kStages stages, each stage with a "full" mbarrier (the loads' bytes) and
// an "empty" one (an arrival from each consumer warp once its wgmmas that
// read the stage have completed). setmaxnreg moves registers from the producer warpgroup to the
// consumers: ptxas launches such a kernel with 65536 / 384 = 168 registers
// a thread (whole warpgroups, one CTA an SM), and 128 x 24 + 256 x 240 is
// the same 64512.
//
// Shared tiles hold bf16 rows with the 128-byte swizzle: a tile of R rows
// is Sm90<D>::panels panels of R x 64 columns, each R * 128 bytes and
// 1024-byte aligned (flash_sm90.cuh). Head dims below 64 are held as 64
// columns: the tensor map's box is 64 wide and TMA fills the columns past
// D with zeros, which add nothing to a dot.

constexpr int kWgRows = 64;                    // rows a consumer warpgroup owns
constexpr int kConsumers = 2;                  // consumer warpgroups
constexpr int kCtaRows = kWgRows * kConsumers;  // rows a CTA owns
constexpr int kStages = 3;                     // stages of the ring
constexpr int kSm90Threads = (kConsumers + 1) * 128;
constexpr int kProducerRegs = 24, kConsumerRegs = 240;  // setmaxnreg
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Sm90 {
  static constexpr int width = D < 64 ? 64 : D;  // columns held
  static constexpr int panels = width / 64;
  static constexpr int ksteps = D / 16;  // 16-deep steps of a dot over D
  // Bytes of a tile of R rows.
  __host__ __device__ static constexpr int tile(int rows) {
    return rows * width * 2;
  }
};

// The first 1024-byte boundary at or after p.
__device__ __forceinline__ uint8_t* align1024(void* p) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  return reinterpret_cast<uint8_t*>((a + 1023) & ~uintptr_t(1023));
}

// Descriptor of the rows from r0 of a tile of R rows, K-major, for the 16
// columns from 16 kk: A (64 rows), or B stored as its n rows. (LBO is
// unused for a swizzled K-major operand; 16 is its conventional value.)
template <int R>
__device__ __forceinline__ uint64_t desc_rows(const uint8_t* tile, int r0,
                                              int kk) {
  return smem_desc(tile + (kk / 4) * R * 128 + r0 * 128 + (kk % 4) * 32, 16,
                   1024);
}

// Descriptor of rows [16 kk, 16 kk + 16) of a tile of R rows as B stored
// MN-major (k = the row, n = the column), for the 64 columns of panel p.
// Both byte offsets are 1024, the stride of 8 rows: with N = 64 the
// operand is one swizzle atom wide, so the stride between atoms along n
// never applies.
template <int R>
__device__ __forceinline__ uint64_t desc_cols(const uint8_t* tile, int kk,
                                              int p) {
  return smem_desc(tile + p * R * 128 + kk * 16 * 128, 1024, 1024);
}

// Spins on an mbarrier until the phase of the given parity completes.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// One warpgroup's D (64 x N) = A B^T over the head dim: A is rows [a0,
// a0 + 64) of a tile of RA rows, B the N rows of a tile of N rows, both
// K-major. Committed as one group.
template <int D, int RA, int N>
__device__ __forceinline__ void dots_sm90(float (&d)[N / 2],
                                          const uint8_t* a_tile, int a0,
                                          const uint8_t* b_tile) {
  static_assert(N == 32 || N == 64 || N == 128, "wgmma_ss_n32/64/128");
#pragma unroll
  for (int kk = 0; kk < Sm90<D>::ksteps; ++kk) {
    const uint64_t a = desc_rows<RA>(a_tile, a0, kk);
    const uint64_t b = desc_rows<N>(b_tile, 0, kk);
    if constexpr (N == 128)
      wgmma_ss_n128<0>(d, a, b, kk > 0);
    else if constexpr (N == 64)
      wgmma_ss_n64<0>(d, a, b, kk > 0);
    else
      wgmma_ss_n32<0>(d, a, b, kk > 0);
  }
  wgmma_commit();
}

// One warpgroup's acc (64 x width, panels of 64 columns) += X B, X the
// 64 x N fp32 operand as hi/lo pairs per 16-column k-slice (a_pair), B a
// tile of N rows read MN-major. Committed as one group.
template <int D, int N>
__device__ __forceinline__ void accumulate_sm90(
    float (&acc)[Sm90<D>::panels][32], const uint32_t (&hi)[N / 16][4],
    const uint32_t (&lo)[N / 16][4], const uint8_t* b_tile) {
#pragma unroll
  for (int kq = 0; kq < N / 16; ++kq)
#pragma unroll
    for (int p = 0; p < Sm90<D>::panels; ++p) {
      const uint64_t b = desc_cols<N>(b_tile, kq, p);
      wgmma_rs_n64<1>(acc[p], hi[kq], b, 1);
      wgmma_rs_n64<1>(acc[p], lo[kq], b, 1);
    }
  wgmma_commit();
}

// x0, x1 as packed bf16 pairs with x = hi + lo to about 2^-17 relative,
// with one conversion per pair: on the card dQ and dK/dV take 4-10% less
// time with it than with one conversion per value (tools/torch_kernel_ab.py,
// PERF.md section 6).
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(
      x0 - __low2float(h), x1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The A operands of a 64 x N fp32 accumulator, each 16-column k-slice kq
// as a hi/lo pair: register r of the fragment is columns (2t, 2t + 1) of
// row g (r = 0, 2) or g + 8 (r = 1, 3), plus 8 for r >= 2, which the
// accumulator holds in x[8 kq + 2 r] and x[8 kq + 2 r + 1].
template <int N>
__device__ __forceinline__ void a_pairs(const float (&x)[N / 2],
                                        uint32_t (&hi)[N / 16][4],
                                        uint32_t (&lo)[N / 16][4]) {
#pragma unroll
  for (int kq = 0; kq < N / 16; ++kq)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_pair(x[8 * kq + 2 * r], x[8 * kq + 2 * r + 1], hi[kq][r],
                 lo[kq][r]);
}

// Rows of one warpgroup's 64 x width fp32 accumulator (panels of 64
// columns) to a bf16 [T, D] slab: this thread's rows row0 + 16 w + g times
// mul[0] and 8 below it times mul[1], where they are below T, and columns
// below D, two at a time.
template <int D>
__device__ __forceinline__ void store_wg_rows(
    __nv_bfloat16* __restrict__ out, const float (&acc)[Sm90<D>::panels][32],
    int row0, int T, const float (&mul)[2]) {
  const int wt = threadIdx.x % 128;
  const int r = row0 + 16 * (wt / 32) + (wt % 32) / 4;
  const int t = wt % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= T) continue;
    __nv_bfloat16* row = out + (size_t)(r + 8 * h) * D;
#pragma unroll
    for (int p = 0; p < Sm90<D>::panels; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (64 * p + 8 * j >= D) continue;  // D is a multiple of 8
        const int c = 64 * p + 8 * j + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(row + c) =
            __floats2bfloat162_rn(acc[p][4 * j + 2 * h] * mul[h],
                                  acc[p][4 * j + 2 * h + 1] * mul[h]);
      }
  }
}

// The same with one multiplier for every row.
template <int D>
__device__ __forceinline__ void store_wg_rows(
    __nv_bfloat16* __restrict__ out, const float (&acc)[Sm90<D>::panels][32],
    int row0, int T, float mul) {
  const float muls[2] = {mul, mul};
  store_wg_rows<D>(out, acc, row0, T, muls);
}

// Host side: cuTensorMapEncodeTiled, a CUDA API entry found through the
// runtime (no -lcuda at link time), looked up once.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The tensor map of a bf16 [BH, T, D] slab as a 3-D tensor (D, T, BH):
// boxes of rows x 64 columns of one (b*h), 128-byte swizzled. A box past T
// or D is zero-filled (a 2-D map over BH*T rows would read the next head's
// rows at a ragged edge). TMA needs a 16-byte aligned address.
inline cudaError_t slab_map(CUtensorMap* map, const void* base, int BH, int T,
                            int D, int rows) {
  if (reinterpret_cast<uintptr_t>(base) % 16) return cudaErrorMisalignedAddress;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The tensor map of an fp32 [BH, T] row vector as one run of BH * T values,
// in boxes of n. A box must start on 16 bytes (a multiple of 4 values; a
// box at an odd start faults on the card), so a kernel that wants rows
// i0 .. of head b*h loads the box at ((b*h) * T + i0) & ~3 with 3 values to
// spare. Past T come the next head's values (zeros past the end), which the
// kernels mask. (A 2-D map would need T * 4 to be a multiple of 16 bytes.)
inline cudaError_t row_map(CUtensorMap* map, const void* base, int BH, int T,
                           int n) {
  if (reinterpret_cast<uintptr_t>(base) % 16) return cudaErrorMisalignedAddress;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dims[1] = {(cuuint64_t)BH * T};
  const cuuint64_t strides[1] = {4};  // unused at rank 1
  const cuuint32_t box[1] = {(cuuint32_t)n};
  const cuuint32_t step[1] = {1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
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
