// Flash-attention forward for Hopper: O = softmax(scale * Q K^T) V and
// LSE = m + log(l), with an online softmax over K/V tiles.
//
// Replaces tepdist_tpu/ops/pallas/flash_attention.py:_fwd_kernel (called
// through _fwd_call). Same arithmetic: Q is upcast and pre-scaled in fp32,
// masked scores are _NEG_INF (-1e30), fully masked rows are guarded, and O
// and LSE are divided/logged by max(l, 1e-30).
//
// Design: one CTA per (b*h, 64-row Q tile), with Layout<D>::value threads
// per query row, each holding at most 32 floats of the row's fp32 output
// (flash_common.cuh). A row's threads keep its running max m and
// denominator l (replicated) and their share of its fp32 output row in
// registers; K and V stream through shared memory 32 rows at a time, and
// the scores of 16 keys at a time sit in registers. A causal CTA stops at
// its diagonal tile; keys past the diagonal or past T are masked, so any T
// works without padding. The TPU grid's sequential key loop becomes the
// loop inside the CTA.
//
// Bound on H100 (main path [4*25, 1024, 64] bf16, causal): 2 dots of
// 2*BH*T^2*D FLOPs, halved under causal (0.013 ms at the 989 TFLOP/s bf16
// peak), against q, k, v read and o, lse written once (0.016 ms at
// 3.35 TB/s): the bytes bound it. This kernel runs its dots as fp32 FMAs on
// the CUDA cores (67 TFLOP/s), so in practice the FMA issue rate bounds it.
#include "flash_common.cuh"

namespace tepdist {

// Accumulator floats per thread, and streamed rows scored per chunk.
template <int D>
using Layout = Split<D, 32>;
constexpr int kChunk = 16;

template <typename scalar_t, int D>
__global__ void __launch_bounds__(kRows * Layout<D>::value)
    flash_fwd_kernel(const scalar_t* __restrict__ q,
                     const scalar_t* __restrict__ k,
                     const scalar_t* __restrict__ v, scalar_t* __restrict__ o,
                     float* __restrict__ lse, int T, int n_tiles, bool causal,
                     float scale) {
  constexpr int S = Layout<D>::stride;
  constexpr int TPR = Layout<D>::value;
  constexpr int G = Layout<D>::groups;
  constexpr int C = kChunk;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [kRows][S], pre-scaled
  float* sk = sq + kRows * S;                    // [kTile][S]
  float* sv = sk + kTile * S;                    // [kTile][S]

  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * kRows;
  const int part = threadIdx.x % TPR;
  const int row = q0 + threadIdx.x / TPR;
  const size_t base = (size_t)bh * T * D;
  load_rows<scalar_t, D, S>(sq, q + base, q0, kRows, T, scale);
  const float* my_q = sq + (threadIdx.x / TPR) * S;

  float m = kNegInf, l = 0.f;
  float acc[4 * G];
#pragma unroll
  for (int i = 0; i < 4 * G; ++i) acc[i] = 0.f;

  const int k_end = causal ? min(T, q0 + kRows) : T;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous tile is consumed (and sq is loaded)
    load_rows<scalar_t, D, S>(sk, k + base, k0, kTile, T, 1.f);
    load_rows<scalar_t, D, S>(sv, v + base, k0, kTile, T, 1.f);
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += C) {
      float s[C];
#pragma unroll
      for (int j = 0; j < C; ++j) s[j] = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int d = (part + TPR * g) * 4;
        const float4 qd = ld4(my_q + d);
#pragma unroll
        for (int j = 0; j < C; ++j)
          s[j] = dot4(qd, ld4(sk + (c0 + j) * S + d), s[j]);
      }
      float m_blk = kNegInf;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        s[j] = row_sum<TPR>(s[j]);
        const int col = k0 + c0 + j;
        if (col >= T || (causal && col > row)) s[j] = kNegInf;
        m_blk = fmaxf(m_blk, s[j]);
      }
      const float m_new = fmaxf(m, m_blk);
      const bool dead = m_new <= kNegInf / 2;  // every key so far masked
      const float corr = m <= kNegInf / 2 ? 0.f : expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int i = 0; i < 4 * G; ++i) acc[i] *= corr;
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float p = dead ? 0.f : expf(s[j] - m_new);
        l += p;
        const float* vj = sv + (c0 + j) * S;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 vd = ld4(vj + (part + TPR * g) * 4);
          acc[4 * g] = fmaf(p, vd.x, acc[4 * g]);
          acc[4 * g + 1] = fmaf(p, vd.y, acc[4 * g + 1]);
          acc[4 * g + 2] = fmaf(p, vd.z, acc[4 * g + 2]);
          acc[4 * g + 3] = fmaf(p, vd.w, acc[4 * g + 3]);
        }
      }
      m = m_new;
    }
  }
  if (row < T) {
    const float lc = fmaxf(l, 1e-30f);
    scalar_t* out = o + base + (size_t)row * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int d = (part + TPR * g) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[d + e] = from_f32<scalar_t>(acc[4 * g + e] / lc);
    }
    if (part == 0) lse[(size_t)bh * T + row] = m + logf(lc);
  }
}

template <typename scalar_t, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int BH, int T, int causal, float scale,
                       cudaStream_t stream) {
  const int n_tiles = (T + kRows - 1) / kRows;
  const size_t smem = (size_t)(kRows + 2 * kTile) * Layout<D>::stride * 4;
  auto kernel = flash_fwd_kernel<scalar_t, D>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)BH * n_tiles, kRows * Layout<D>::value, smem, stream>>>(
      static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
      static_cast<const scalar_t*>(v), static_cast<scalar_t*>(o),
      static_cast<float*>(lse), T, n_tiles, causal != 0, scale);
  return cudaGetLastError();
}

}  // namespace tepdist

// q, k, v, o: [BH, T, D] of one dtype (fp32, or bf16 when is_bf16);
// lse: [BH, T] fp32. Returns the launch's cudaError_t.
extern "C" int tepdist_flash_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int BH, int T, int D,
                                 int is_bf16, int causal, float scale,
                                 void* stream) {
  using namespace tepdist;
  TEPDIST_DISPATCH(is_bf16, D,
                   return (int)launch_fwd<scalar_t, HEAD_DIM>(
                       q, k, v, o, lse, BH, T, causal, scale,
                       static_cast<cudaStream_t>(stream)));
  return (int)cudaErrorInvalidValue;
}
