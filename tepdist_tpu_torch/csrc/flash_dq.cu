// Flash-attention backward, dQ: dQ = scale * sum_j dS_j K_j with
// P = exp(S - LSE), dP = dO V^T and dS = P * (dP - delta).
//
// Replaces tepdist_tpu/ops/pallas/flash_attention.py:_dq_kernel (called
// through _bwd_call). P is recomputed from the saved LSE, so no
// renormalisation pass is needed. delta = rowsum(dO * O) - dLSE comes in
// precomputed (a torch reduction in the wrapper, as XLA fused it outside the
// Pallas kernel). Keys past the diagonal or past T get P = 0, so any T works
// without padding, and a causal CTA stops at its diagonal tile.
//
// Bound on H100 (main path [4*25, 1024, 64] bf16, causal): 3 dots of
// 2*BH*T^2*D FLOPs, halved under causal (0.020 ms at the bf16 tensor-core
// peak), against 5 slabs and 2 row vectors moved once (0.020 ms):
// operations and bytes bound it about equally.
//
// bf16 (flash_dq_mma_kernel): the dots run on the tensor cores. One CTA of
// 4 warps per (b*h, 64-row Q tile); its Q and dO stay in shared memory as
// bf16, each warp owning 16 rows and their dQ in fp32 registers. K and V
// stream in 64-row tiles, double-buffered by cp.async so the next tile's
// copy overlaps this one's dots. A warp forms S = Q_w K^T and dP = dO_w V^T
// with mma.sync, P and dS in registers, and dQ_w += dS K with dS re-packed
// from the accumulators into the A operand (a hi/lo bf16 pair, see
// flash_common.cuh) and K as B through ldmatrix .trans. scale multiplies
// the fp32 S and, once, dQ in the epilogue (a bf16 Q * scale would round).
// CTAs are numbered so that the longest (last, under causal) start first.
//
// fp32 (flash_dq_kernel): fp32 FMAs on the CUDA cores, where TF32 would
// change the reference's fp32 numerics, so their issue rate bounds it. One
// CTA per (b*h, 64-row Q tile), with Layout<D>::value threads per query row
// (flash_common.cuh). The row's Q (pre-scaled) and dO sit in shared memory,
// its dQ in fp32 registers, each thread holding at most 16 floats of it;
// the scores and dP of 8 keys at a time sit in registers. K and V stream
// through shared memory 32 rows at a time.
#include "flash_common.cuh"

namespace tepdist {

// Accumulator floats per thread, and streamed rows scored per chunk.
template <int D>
using Layout = Split<D, 16>;
constexpr int kChunk = 8;

template <typename scalar_t, int D>
__global__ void __launch_bounds__(kRows * Layout<D>::value)
    flash_dq_kernel(const scalar_t* __restrict__ q,
                    const scalar_t* __restrict__ k,
                    const scalar_t* __restrict__ v,
                    const scalar_t* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, scalar_t* __restrict__ dq,
                    int T, int n_tiles, bool causal, float scale) {
  constexpr int S = Layout<D>::stride;
  constexpr int TPR = Layout<D>::value;
  constexpr int G = Layout<D>::groups;
  constexpr int C = kChunk;
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);  // [kRows][S], pre-scaled
  float* sdo = sq + kRows * S;                   // [kRows][S]
  float* sk = sdo + kRows * S;                   // [kTile][S]
  float* sv = sk + kTile * S;                    // [kTile][S]

  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x % n_tiles) * kRows;
  const int part = threadIdx.x % TPR;
  const int row = q0 + threadIdx.x / TPR;
  const size_t base = (size_t)bh * T * D;
  load_rows<scalar_t, D, S>(sq, q + base, q0, kRows, T, scale);
  load_rows<scalar_t, D, S>(sdo, dout + base, q0, kRows, T, 1.f);
  const float* my_q = sq + (threadIdx.x / TPR) * S;
  const float* my_do = sdo + (threadIdx.x / TPR) * S;
  const float my_lse = row < T ? lse[(size_t)bh * T + row] : 0.f;
  const float my_delta = row < T ? delta[(size_t)bh * T + row] : 0.f;

  float acc[4 * G];
#pragma unroll
  for (int i = 0; i < 4 * G; ++i) acc[i] = 0.f;

  const int k_end = causal ? min(T, q0 + kRows) : T;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();
    load_rows<scalar_t, D, S>(sk, k + base, k0, kTile, T, 1.f);
    load_rows<scalar_t, D, S>(sv, v + base, k0, kTile, T, 1.f);
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += C) {
      float s[C], dp[C];
#pragma unroll
      for (int j = 0; j < C; ++j) s[j] = dp[j] = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int d = (part + TPR * g) * 4;
        const float4 qd = ld4(my_q + d);
        const float4 dod = ld4(my_do + d);
#pragma unroll
        for (int j = 0; j < C; ++j) {
          s[j] = dot4(qd, ld4(sk + (c0 + j) * S + d), s[j]);
          dp[j] = dot4(dod, ld4(sv + (c0 + j) * S + d), dp[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float sj = row_sum<TPR>(s[j]);
        const float dpj = row_sum<TPR>(dp[j]);
        const int col = k0 + c0 + j;
        const bool masked = col >= T || (causal && col > row);
        const float p = masked ? 0.f : expf(sj - my_lse);
        const float ds = p * (dpj - my_delta);
        const float* kj = sk + (c0 + j) * S;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 kd = ld4(kj + (part + TPR * g) * 4);
          acc[4 * g] = fmaf(ds, kd.x, acc[4 * g]);
          acc[4 * g + 1] = fmaf(ds, kd.y, acc[4 * g + 1]);
          acc[4 * g + 2] = fmaf(ds, kd.z, acc[4 * g + 2]);
          acc[4 * g + 3] = fmaf(ds, kd.w, acc[4 * g + 3]);
        }
      }
    }
  }
  if (row < T) {
    scalar_t* out = dq + base + (size_t)row * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int d = (part + TPR * g) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[d + e] = from_f32<scalar_t>(acc[4 * g + e] * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcWarps * 32)
    flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int T, int n_tiles,
                        bool causal, float scale) {
  constexpr int S = Tc<D>::stride;
  constexpr int N = Tc<D>::cols;
  constexpr int TILE = kRows * S;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem4);  // [kRows][S]
  __nv_bfloat16* sdo = sq + TILE;                                // [kRows][S]
  __nv_bfloat16* sk = sdo + TILE;  // [2][kRows][S], double-buffered
  __nv_bfloat16* sv = sk + 2 * TILE;

  const int BH = gridDim.x / n_tiles;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_tiles - 1 - (int)blockIdx.x / BH) * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * T * D;
  const int row_w = q0 + 16 * warp;  // this warp's first row
  const int k_end = causal ? min(T, q0 + kRows) : T;
  const int n_k = (k_end + kRows - 1) / kRows;

  load_tile_async<D>(sq, q + base, q0, T);
  load_tile_async<D>(sdo, dout + base, q0, T);
  load_tile_async<D>(sk, k + base, 0, T);
  load_tile_async<D>(sv, v + base, 0, T);
  cp_async_commit();
  // This lane's rows are row_w + lane / 4 and 8 below it.
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row_w + lane / 4 + 8 * h;
    row_lse[h] = r < T ? lse[(size_t)bh * T + r] : 0.f;
    row_delta[h] = r < T ? delta[(size_t)bh * T + r] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_k; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_k) {
      load_tile_async<D>(sk + (buf ^ 1) * TILE, k + base, (it + 1) * kRows, T);
      load_tile_async<D>(sv + (buf ^ 1) * TILE, v + base, (it + 1) * kRows, T);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = sk + buf * TILE;
    const __nv_bfloat16* vt = sv + buf * TILE;
#pragma unroll 1
    for (int c0 = 0; c0 < kRows; c0 += N) {
      const int col0 = it * kRows + c0;
      // Past T, or every key after every row of this warp: P = 0.
      if (col0 >= T || (causal && col0 > row_w + 15)) break;
      float s[N / 8][4], dp[N / 8][4];
      scores<D, N>(s, dp, sq + 16 * warp * S, sdo + 16 * warp * S,
                   kt + c0 * S, vt + c0 * S);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = row_w + lane / 4 + 8 * (e >> 1);
          const int col = col0 + 8 * j + 2 * (lane % 4) + (e & 1);
          const bool masked = col >= T || row >= T || (causal && col > row);
          const float p =
              masked ? 0.f : expf(s[j][e] * scale - row_lse[e >> 1]);
          s[j][e] = p * (dp[j][e] - row_delta[e >> 1]);  // dS
        }
      accumulate<D, N>(acc, s, kt + c0 * S);
    }
    __syncthreads();
  }
  store_rows<D>(dq + base, acc, row_w, T, scale);
}

template <typename scalar_t, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int BH, int T, int causal, float scale,
                      cudaStream_t stream) {
  const int n_tiles = (T + kRows - 1) / kRows;
  if constexpr (std::is_same<scalar_t, __nv_bfloat16>::value) {
    const size_t smem = (size_t)6 * kRows * Tc<D>::stride * 2;
    auto kernel = flash_dq_mma_kernel<D>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)BH * n_tiles, kTcWarps * 32, smem, stream>>>(
        static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
        static_cast<const scalar_t*>(v), static_cast<const scalar_t*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<scalar_t*>(dq), T, n_tiles, causal != 0, scale);
  } else {
    const size_t smem =
        (size_t)(2 * kRows + 2 * kTile) * Layout<D>::stride * 4;
    auto kernel = flash_dq_kernel<scalar_t, D>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)BH * n_tiles, kRows * Layout<D>::value, smem, stream>>>(
        static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
        static_cast<const scalar_t*>(v), static_cast<const scalar_t*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<scalar_t*>(dq), T, n_tiles, causal != 0, scale);
  }
  return cudaGetLastError();
}

}  // namespace tepdist

// q, k, v, dout, dq: [BH, T, D] of one dtype (fp32, or bf16 when is_bf16);
// lse, delta: [BH, T] fp32. Returns the launch's cudaError_t.
extern "C" int tepdist_flash_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int BH, int T,
                                int D, int is_bf16, int causal, float scale,
                                void* stream) {
  using namespace tepdist;
  TEPDIST_DISPATCH(is_bf16, D,
                   return (int)launch_dq<scalar_t, HEAD_DIM>(
                       q, k, v, dout, lse, delta, dq, BH, T, causal, scale,
                       static_cast<cudaStream_t>(stream)));
  return (int)cudaErrorInvalidValue;
}
