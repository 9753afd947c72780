// Flash-attention backward, dQ: dQ = scale * sum_j dS_j K_j with
// P = exp(S - LSE), dP = dO V^T and dS = P * (dP - delta).
//
// Replaces tepdist_tpu/ops/pallas/flash_attention.py:_dq_kernel (called
// through _bwd_call). P is recomputed from the saved LSE, so no
// renormalisation pass is needed. delta = rowsum(dO * O) - dLSE comes in
// precomputed (a torch reduction in the wrapper, as XLA fused it outside the
// Pallas kernel). Keys past the diagonal or past T get P = 0, so any T works
// without padding, and a causal CTA stops at its diagonal tile. Each output
// element is summed by one CTA in a fixed order (no atomics), so two runs
// on the same inputs give the same bits.
//
// Bound on H100 (main path [4*25, 1024, 64] bf16, causal): 3 dots of
// 2*BH*T^2*D FLOPs, halved under causal (0.020 ms at the bf16 tensor-core
// peak), against 5 slabs and 2 row vectors moved once (0.020 ms):
// operations and bytes bound it about equally. The bf16 kernel runs 4
// product passes where the bound counts 3 (dS enters dS K as a hi/lo
// pair): its tensor-core floor is 0.027 ms (0.326 ms at the plan shape
// [48*25, 1024, 64]), beside about 8 CUDA-core instructions an element of
// P for the exp, the masks and the split.
//
// bf16 (flash_dq_sm90_kernel), Hopper: one CTA per (b*h, 128-query tile), two
// consumer warpgroups of 64 queries each and a producer warpgroup
// (flash_common.cuh, "Hopper path"). TMA loads Q and dO once, 128-byte
// swizzled, and streams K and V in tiles of kDqKeys keys through a ring of
// kStages stages. Per tile a warpgroup forms S = Q K^T and dP = dO V^T as
// wgmmas with both operands in shared memory, P and dS in registers, and dQ +=
// dS K as wgmmas with dS a register operand (hi and lo) and K read MN-major. A
// tile wholly below the diagonal and inside T takes no mask arithmetic; a
// warpgroup skips the products of a tile whose keys all follow its queries.
// scale multiplies the fp32 S (inside ex2) and, once, dQ in the epilogue (a
// bf16 Q * scale would round). CTAs are numbered so that the longest (last,
// under causal) start first. As for dK/dV (flash_dkv.cu), a warpgroup's
// dependent chain per tile, not the exp or the lo products, keeps it well above
// its floor.
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

// Keys a stage of the bf16 kernel streams.
constexpr int kDqKeys = 64;

template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dq, int T, int n_tiles,
                         bool causal, float scale) {
  using L = Sm90<D>;
  constexpr int BK = kDqKeys;
  constexpr int QT = L::tile(kCtaRows);  // bytes of Q (and of dO)
  constexpr int KT = L::tile(BK);        // bytes of a K (and a V) tile
  constexpr int STAGE = 2 * KT;          // a multiple of 1024
  extern __shared__ float4 smem4[];
  uint8_t* sq = align1024(smem4);
  uint8_t* sdo = sq + QT;
  uint8_t* ring = sdo + QT;  // stage s: K, V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + kStages * STAGE);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;

  const int BH = gridDim.x / n_tiles;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_tiles - 1 - (int)blockIdx.x / BH) * kCtaRows;
  const int k_end = causal ? min(T, q0 + kCtaRows) : T;
  const int n_k = (k_end + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers * 128) {
    // The producer warpgroup: one thread issues every load.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != kConsumers * 128) return;
    mbar_arrive_expect_tx(q_full, 2 * QT);
    for (int p = 0; p < L::panels; ++p) {
      tma_load_3d(sq + p * kCtaRows * 128, &tm_q, q_full, 64 * p, q0, bh);
      tma_load_3d(sdo + p * kCtaRows * 128, &tm_do, q_full, 64 * p, q0, bh);
    }
    for (int it = 0; it < n_k; ++it) {
      const int s = it % kStages;
      uint8_t* st = ring + s * STAGE;
      wait_phase(&empty[s], ((it / kStages) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[s], STAGE);
      for (int p = 0; p < L::panels; ++p) {
        tma_load_3d(st + p * BK * 128, &tm_k, &full[s], 64 * p, it * BK, bh);
        tma_load_3d(st + KT + p * BK * 128, &tm_v, &full[s], 64 * p, it * BK,
                    bh);
      }
    }
    return;
  }

  // A consumer warpgroup: queries rw .. rw + 63; this thread's are
  // rw + 16 warp + g and 8 below it, its keys in a tile k0 + 8 j + 2 t + e.
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rw = q0 + kWgRows * wg;
  const float scale_log2 = scale * kLog2e;
  float lse_log2[2], row_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rw + 16 * warp + g + 8 * h;
    lse_log2[h] = r < T ? lse[(size_t)bh * T + r] * kLog2e : 0.f;
    row_delta[h] = r < T ? delta[(size_t)bh * T + r] : 0.f;
  }
  float acc[L::panels][32];
#pragma unroll
  for (int p = 0; p < L::panels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
  wait_phase(q_full, 0);

  for (int it = 0; it < n_k; ++it) {
    const int s = it % kStages;
    const int k0 = it * BK;
    wait_phase(&full[s], (it / kStages) & 1);
    // Rows past T are never stored; keys all after every row: P = 0.
    if (rw < T && !(causal && k0 > rw + kWgRows - 1)) {
      const uint8_t* sk = ring + s * STAGE;
      const uint8_t* sv = sk + KT;
      float ds[BK / 2], dp[BK / 2];  // S then P then dS; dP
      wgmma_fence();
      dots_sm90<D, kCtaRows, BK>(ds, sq, rw - q0, sk);
      dots_sm90<D, kCtaRows, BK>(dp, sdo, rw - q0, sv);
      wgmma_wait<1>();
      fence_regs(ds);
      // Only a tile on the diagonal or past T computes the mask.
      const bool edge = (causal && k0 + BK - 1 > rw) || k0 + BK > T;
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i >> 1) & 1;
        float p = ex2_approx(fmaf(ds[i], scale_log2, -lse_log2[h]));
        if (edge) {
          const int row = rw + 16 * warp + g + 8 * h;
          const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
          if (col >= T || (causal && col > row)) p = 0.f;
        }
        ds[i] = p;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < BK / 2; ++i)
        ds[i] = ds[i] * (dp[i] - row_delta[(i >> 1) & 1]);
      uint32_t ds_hi[BK / 16][4], ds_lo[BK / 16][4];
      a_pairs<BK>(ds, ds_hi, ds_lo);
      wgmma_fence();
      accumulate_sm90<D, BK>(acc, ds_hi, ds_lo, sk);  // dQ += dS K
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < L::panels; ++p) fence_regs(acc[p]);
    }
    // This warp's wgmmas that read the stage have completed.
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  store_wg_rows<D>(dq + (size_t)bh * T * D, acc, rw, T, scale);
}

template <typename scalar_t, int D>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      void* dq, int BH, int T, int causal, float scale,
                      cudaStream_t stream) {
  if constexpr (std::is_same<scalar_t, __nv_bfloat16>::value) {
    using L = Sm90<D>;
    constexpr int BK = kDqKeys;
    CUtensorMap tm_q, tm_k, tm_v, tm_do;
    cudaError_t err;
    if ((err = slab_map(&tm_q, q, BH, T, D, kCtaRows)) != cudaSuccess ||
        (err = slab_map(&tm_k, k, BH, T, D, BK)) != cudaSuccess ||
        (err = slab_map(&tm_v, v, BH, T, D, BK)) != cudaSuccess ||
        (err = slab_map(&tm_do, dout, BH, T, D, kCtaRows)) != cudaSuccess)
      return err;
    if (reinterpret_cast<uintptr_t>(dq) % 4) return cudaErrorMisalignedAddress;
    const int n_tiles = (T + kCtaRows - 1) / kCtaRows;
    const size_t smem = 1024 + 2 * (size_t)L::tile(kCtaRows) +
                        (size_t)kStages * 2 * L::tile(BK) +
                        (1 + 2 * kStages) * 8;
    auto kernel = flash_dq_sm90_kernel<D>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<(unsigned)BH * n_tiles, kSm90Threads, smem, stream>>>(
        tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<scalar_t*>(dq), T,
        n_tiles, causal != 0, scale);
  } else {
    const int n_tiles = (T + kRows - 1) / kRows;
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
// lse, delta: [BH, T] fp32. Returns the launch's cudaError_t,
// cudaErrorMisalignedAddress for a bf16 operand that TMA cannot take (not
// 16-byte aligned).
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
