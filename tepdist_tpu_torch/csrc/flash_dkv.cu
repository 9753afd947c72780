// Flash-attention backward, dK and dV: dV = sum_i P_i^T dO_i and
// dK = scale * sum_i dS_i^T Q_i, with P = exp(S - LSE) and
// dS = P * (dP - delta).
//
// Replaces tepdist_tpu/ops/pallas/flash_attention.py:_dkv_kernel (called
// through _bwd_call). A causal CTA starts at the first query tile that can
// see its keys; queries before a key or past T get P = 0, so any T works
// without padding. The reference's dQ/dK/dV split into two kernels is kept,
// so no atomics are needed.
//
// Bound on H100 (main path [4*25, 1024, 64] bf16, causal): 4 dots of
// 2*BH*T^2*D FLOPs, halved under causal (0.027 ms at the bf16 tensor-core
// peak), against 6 slabs and 2 row vectors moved once (0.024 ms): the
// operations bound it.
//
// bf16 (flash_dkv_mma_kernel): the dots run on the tensor cores. One CTA
// of 4 warps per (b*h, 64-row K/V tile); its K and V stay in shared memory
// as bf16, each warp owning 16 key rows and their dK and dV in fp32
// registers. Q and dO stream in 64-row tiles, with their LSE and delta,
// double-buffered by cp.async so the next tile's copy overlaps this one's
// dots. A warp forms S^T = K_w Q^T and dP^T = V_w dO^T with mma.sync, P^T
// and dS^T in registers, then dV_w += P^T dO and dK_w += dS^T Q with P^T
// and dS^T re-packed from the accumulators into the A operand (a hi/lo
// bf16 pair, see flash_common.cuh) and Q, dO as B through ldmatrix .trans.
// scale multiplies the fp32 S^T and, once, dK in the epilogue (a bf16
// Q * scale would round). Under causal the first key tiles see the most
// queries, and their CTAs are numbered first.
//
// fp32 (flash_dkv_kernel): fp32 FMAs on the CUDA cores, where TF32 would
// change the reference's fp32 numerics, so their issue rate bounds it. One
// CTA per (b*h, 64-row K/V tile), with Layout<D>::value threads per key row
// (flash_common.cuh). The row's K and V sit in shared memory, its dK and
// dV in fp32 registers, each thread holding at most 16 floats of each; the
// scores and dP of 4 queries at a time sit in registers. Q (pre-scaled, so
// dK carries its one factor of scale without a final multiply), dO, LSE
// and delta stream through shared memory 32 query rows at a time.
#include "flash_common.cuh"

namespace tepdist {

// Accumulator floats per thread, and streamed rows scored per chunk.
template <int D>
using Layout = Split<D, 16>;
constexpr int kChunk = 4;

template <typename scalar_t, int D>
__global__ void __launch_bounds__(kRows * Layout<D>::value)
    flash_dkv_kernel(const scalar_t* __restrict__ q,
                     const scalar_t* __restrict__ k,
                     const scalar_t* __restrict__ v,
                     const scalar_t* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     scalar_t* __restrict__ dk, scalar_t* __restrict__ dv,
                     int T, int n_tiles, bool causal, float scale) {
  constexpr int S = Layout<D>::stride;
  constexpr int TPR = Layout<D>::value;
  constexpr int G = Layout<D>::groups;
  constexpr int C = kChunk;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);  // [kRows][S]
  float* sv = sk + kRows * S;                    // [kRows][S]
  float* sq = sv + kRows * S;                    // [kTile][S], pre-scaled
  float* sdo = sq + kTile * S;                   // [kTile][S]
  float* slse = sdo + kTile * S;                 // [kTile]
  float* sdelta = slse + kTile;                  // [kTile]

  const int bh = blockIdx.x / n_tiles;
  const int k0 = (blockIdx.x % n_tiles) * kRows;
  const int part = threadIdx.x % TPR;
  const int col = k0 + threadIdx.x / TPR;
  const size_t base = (size_t)bh * T * D;
  const float* lse_bh = lse + (size_t)bh * T;
  const float* delta_bh = delta + (size_t)bh * T;
  load_rows<scalar_t, D, S>(sk, k + base, k0, kRows, T, 1.f);
  load_rows<scalar_t, D, S>(sv, v + base, k0, kRows, T, 1.f);
  const float* my_k = sk + (threadIdx.x / TPR) * S;
  const float* my_v = sv + (threadIdx.x / TPR) * S;

  float acc_k[4 * G], acc_v[4 * G];
#pragma unroll
  for (int i = 0; i < 4 * G; ++i) acc_k[i] = acc_v[i] = 0.f;

  // kRows is a multiple of kTile, so a causal start at k0 is tile-aligned.
  for (int i0 = causal ? k0 : 0; i0 < T; i0 += kTile) {
    __syncthreads();
    load_rows<scalar_t, D, S>(sq, q + base, i0, kTile, T, scale);
    load_rows<scalar_t, D, S>(sdo, dout + base, i0, kTile, T, 1.f);
    load_vec(slse, lse_bh, i0, kTile, T);
    load_vec(sdelta, delta_bh, i0, kTile, T);
    __syncthreads();
#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += C) {
      float s[C], dp[C];
#pragma unroll
      for (int i = 0; i < C; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int d = (part + TPR * g) * 4;
        const float4 kd = ld4(my_k + d);
        const float4 vd = ld4(my_v + d);
#pragma unroll
        for (int i = 0; i < C; ++i) {
          s[i] = dot4(kd, ld4(sq + (c0 + i) * S + d), s[i]);
          dp[i] = dot4(vd, ld4(sdo + (c0 + i) * S + d), dp[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const float si = row_sum<TPR>(s[i]);
        const float dpi = row_sum<TPR>(dp[i]);
        const int qrow = i0 + c0 + i;
        const bool masked = qrow >= T || col >= T || (causal && qrow < col);
        const float p = masked ? 0.f : expf(si - slse[c0 + i]);
        const float ds = p * (dpi - sdelta[c0 + i]);
        const float* qi = sq + (c0 + i) * S;
        const float* doi = sdo + (c0 + i) * S;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const int d = (part + TPR * g) * 4;
          const float4 qd = ld4(qi + d);
          const float4 dod = ld4(doi + d);
          acc_v[4 * g] = fmaf(p, dod.x, acc_v[4 * g]);
          acc_v[4 * g + 1] = fmaf(p, dod.y, acc_v[4 * g + 1]);
          acc_v[4 * g + 2] = fmaf(p, dod.z, acc_v[4 * g + 2]);
          acc_v[4 * g + 3] = fmaf(p, dod.w, acc_v[4 * g + 3]);
          acc_k[4 * g] = fmaf(ds, qd.x, acc_k[4 * g]);
          acc_k[4 * g + 1] = fmaf(ds, qd.y, acc_k[4 * g + 1]);
          acc_k[4 * g + 2] = fmaf(ds, qd.z, acc_k[4 * g + 2]);
          acc_k[4 * g + 3] = fmaf(ds, qd.w, acc_k[4 * g + 3]);
        }
      }
    }
  }
  if (col < T) {
    scalar_t* out_k = dk + base + (size_t)col * D;
    scalar_t* out_v = dv + base + (size_t)col * D;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int d = (part + TPR * g) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        out_k[d + e] = from_f32<scalar_t>(acc_k[4 * g + e]);
        out_v[d + e] = from_f32<scalar_t>(acc_v[4 * g + e]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcWarps * 32)
    flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int T, int n_tiles,
                         bool causal, float scale) {
  constexpr int S = Tc<D>::stride;
  constexpr int N = Tc<D>::cols;
  constexpr int TILE = kRows * S;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sk = reinterpret_cast<__nv_bfloat16*>(smem4);  // [kRows][S]
  __nv_bfloat16* sv = sk + TILE;                                 // [kRows][S]
  __nv_bfloat16* sq = sv + TILE;  // [2][kRows][S], double-buffered
  __nv_bfloat16* sdo = sq + 2 * TILE;
  float* slse = reinterpret_cast<float*>(sdo + 2 * TILE);  // [2][kRows]
  float* sdelta = slse + 2 * kRows;                        // [2][kRows]

  const int BH = gridDim.x / n_tiles;
  const int bh = blockIdx.x % BH;
  const int k0 = ((int)blockIdx.x / BH) * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * T * D;
  const float* lse_bh = lse + (size_t)bh * T;
  const float* delta_bh = delta + (size_t)bh * T;
  const int key_w = k0 + 16 * warp;  // this warp's first key
  // kRows is the query tile too, so a causal start at k0 is tile-aligned.
  const int i_begin = causal ? k0 : 0;
  const int n_q = (T - i_begin + kRows - 1) / kRows;

  load_tile_async<D>(sk, k + base, k0, T);
  load_tile_async<D>(sv, v + base, k0, T);
  load_tile_async<D>(sq, q + base, i_begin, T);
  load_tile_async<D>(sdo, dout + base, i_begin, T);
  cp_async_commit();
  load_vec(slse, lse_bh, i_begin, kRows, T);
  load_vec(sdelta, delta_bh, i_begin, kRows, T);

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;

  for (int it = 0; it < n_q; ++it) {
    const int buf = it & 1;
    const int i0 = i_begin + it * kRows;
    if (it + 1 < n_q) {
      const int nb = buf ^ 1;
      load_tile_async<D>(sq + nb * TILE, q + base, i0 + kRows, T);
      load_tile_async<D>(sdo + nb * TILE, dout + base, i0 + kRows, T);
      cp_async_commit();
      load_vec(slse + nb * kRows, lse_bh, i0 + kRows, kRows, T);
      load_vec(sdelta + nb * kRows, delta_bh, i0 + kRows, kRows, T);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* qt = sq + buf * TILE;
    const __nv_bfloat16* dot = sdo + buf * TILE;
    const float* lse_t = slse + buf * kRows;
    const float* delta_t = sdelta + buf * kRows;
#pragma unroll 1
    for (int c0 = 0; c0 < kRows; c0 += N) {
      // Past T: P = 0 here and in every later round.
      if (i0 + c0 >= T) break;
      // Every query before every key of this warp: P = 0.
      if (causal && i0 + c0 + N - 1 < key_w) continue;
      float s[N / 8][4], dp[N / 8][4];
      scores<D, N>(s, dp, sk + 16 * warp * S, sv + 16 * warp * S,
                   qt + c0 * S, dot + c0 * S);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key_w + lane / 4 + 8 * (e >> 1);
          const int qc = c0 + 8 * j + 2 * (lane % 4) + (e & 1);
          const int qrow = i0 + qc;
          const bool masked =
              qrow >= T || key >= T || (causal && qrow < key);
          const float p = masked ? 0.f : expf(s[j][e] * scale - lse_t[qc]);
          s[j][e] = p;                              // P^T
          dp[j][e] = p * (dp[j][e] - delta_t[qc]);  // dS^T
        }
      accumulate<D, N>(acc_v, s, dot + c0 * S);
      accumulate<D, N>(acc_k, dp, qt + c0 * S);
    }
    __syncthreads();
  }
  store_rows<D>(dk + base, acc_k, key_w, T, scale);
  store_rows<D>(dv + base, acc_v, key_w, T, 1.f);
}

template <typename scalar_t, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int BH, int T, int causal,
                       float scale, cudaStream_t stream) {
  const int n_tiles = (T + kRows - 1) / kRows;
  if constexpr (std::is_same<scalar_t, __nv_bfloat16>::value) {
    const size_t smem =
        (size_t)6 * kRows * Tc<D>::stride * 2 + (size_t)4 * kRows * 4;
    auto kernel = flash_dkv_mma_kernel<D>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)BH * n_tiles, kTcWarps * 32, smem, stream>>>(
        static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
        static_cast<const scalar_t*>(v), static_cast<const scalar_t*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<scalar_t*>(dk), static_cast<scalar_t*>(dv), T, n_tiles,
        causal != 0, scale);
  } else {
    const size_t smem =
        ((size_t)(2 * kRows + 2 * kTile) * Layout<D>::stride + 2 * kTile) * 4;
    auto kernel = flash_dkv_kernel<scalar_t, D>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)BH * n_tiles, kRows * Layout<D>::value, smem, stream>>>(
        static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
        static_cast<const scalar_t*>(v), static_cast<const scalar_t*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<scalar_t*>(dk), static_cast<scalar_t*>(dv), T, n_tiles,
        causal != 0, scale);
  }
  return cudaGetLastError();
}

}  // namespace tepdist

// q, k, v, dout, dk, dv: [BH, T, D] of one dtype (fp32, or bf16 when
// is_bf16); lse, delta: [BH, T] fp32. Returns the launch's cudaError_t.
extern "C" int tepdist_flash_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int BH, int T, int D, int is_bf16, int causal,
                                 float scale, void* stream) {
  using namespace tepdist;
  TEPDIST_DISPATCH(is_bf16, D,
                   return (int)launch_dkv<scalar_t, HEAD_DIM>(
                       q, k, v, dout, lse, delta, dk, dv, BH, T, causal,
                       scale, static_cast<cudaStream_t>(stream)));
  return (int)cudaErrorInvalidValue;
}
