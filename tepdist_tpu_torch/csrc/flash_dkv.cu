// Flash-attention backward, dK and dV: dV = sum_i P_i^T dO_i and
// dK = scale * sum_i dS_i^T Q_i, with P = exp(S - LSE) and
// dS = P * (dP - delta).
//
// Replaces tepdist_tpu/ops/pallas/flash_attention.py:_dkv_kernel (called
// through _bwd_call). A causal CTA starts at the first query tile that can
// see its keys; queries before a key or past T get P = 0, so any T works
// without padding. The reference's dQ/dK/dV split into two kernels is kept,
// so no atomics are needed: each output element is summed by one CTA in a
// fixed order, and two runs on the same inputs give the same bits.
//
// Bound on H100 (main path [4*25, 1024, 64] bf16, causal): 4 dots of
// 2*BH*T^2*D FLOPs, halved under causal (0.027 ms at the bf16 tensor-core
// peak), against 6 slabs and 2 row vectors moved once (0.024 ms): the
// operations bound it. The bf16 kernel runs 6 product passes where the
// bound counts 4 (P and dS enter the second dots as a hi/lo pair), so its
// tensor-core floor is 1.5x the bound (0.041 ms; 0.489 ms at the plan
// shape [48*25, 1024, 64]), and the exp, the masks and the hi/lo splits
// (about 11 instructions an element of P) run on the CUDA cores beside it.
//
// bf16 (flash_dkv_sm90_kernel), Hopper: one CTA per (b*h, 128-key tile), two
// consumer warpgroups of 64 keys each and a producer warpgroup
// (flash_common.cuh, "Hopper path"). TMA loads K and V once, 128-byte swizzled,
// and streams Q, dO, LSE and delta in tiles of DkvTile::rows queries through a
// ring of kStages stages, so the next tiles' loads overlap this one's dots. Per
// tile a warpgroup forms S^T = K Q^T and dP^T = V dO^T as wgmmas with both
// operands in shared memory, then P^T in registers, and issues dV += P^T dO
// (P^T as a register operand, hi and lo, dO read MN-major) before it waits for
// dP^T, so the dS^T arithmetic overlaps those products; then dK += dS^T Q the
// same way. A tile wholly inside the causal triangle and inside T takes no mask
// arithmetic; a warpgroup skips the products of a tile whose queries all
// precede its keys. scale multiplies the fp32 S^T (inside ex2) and, once, dK in
// the epilogue (a bf16 Q * scale would round). At D = 128 the query tile is 32
// rows, so dK and dV (128 registers a thread) fit beside S^T and dP^T without
// spilling. Under causal the first key tiles see the most queries, and their
// CTAs are numbered first. Measured on the card (PERF.md section 6), the kernel
// sits well above its floor, and neither the exp nor the lo products are most
// of the gap: a warpgroup's tile is one dependent chain (dots, wait, exp, dots,
// wait, dS, dots, wait), and two consumer warpgroups an SM leave the tensor
// cores idle for much of it.
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

// Queries a stage of the bf16 kernel streams.
template <int D>
struct DkvTile {
  static constexpr int rows = D <= 64 ? 64 : 32;
};

template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_lse,
                          const __grid_constant__ CUtensorMap tm_delta,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int T, int n_tiles,
                          bool causal, float scale) {
  using L = Sm90<D>;
  constexpr int BQ = DkvTile<D>::rows;
  constexpr int KV = L::tile(kCtaRows);  // bytes of K (and of V)
  constexpr int QT = L::tile(BQ);        // bytes of a Q (and a dO) tile
  constexpr int RV = BQ + 4;             // LSE (and delta) values a stage holds
  constexpr int TX = 2 * QT + 2 * RV * 4;  // bytes a stage's loads bring
  constexpr int RVB = (RV * 4 + 127) / 128 * 128;  // TMA writes on 128 bytes
  constexpr int STAGE = (2 * QT + 2 * RVB + 1023) / 1024 * 1024;
  extern __shared__ float4 smem4[];
  uint8_t* sk = align1024(smem4);
  uint8_t* sv = sk + KV;
  uint8_t* ring = sv + KV;  // stage s: Q, dO, LSE, delta
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(ring + kStages * STAGE);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;

  const int BH = gridDim.x / n_tiles;
  const int bh = blockIdx.x % BH;
  const int k0 = ((int)blockIdx.x / BH) * kCtaRows;
  // kCtaRows is a multiple of BQ, so a causal start at k0 is tile-aligned.
  const int i_begin = causal ? k0 : 0;
  const int n_q = (T - i_begin + BQ - 1) / BQ;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
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
    mbar_arrive_expect_tx(kv_full, 2 * KV);
    for (int p = 0; p < L::panels; ++p) {
      tma_load_3d(sk + p * kCtaRows * 128, &tm_k, kv_full, 64 * p, k0, bh);
      tma_load_3d(sv + p * kCtaRows * 128, &tm_v, kv_full, 64 * p, k0, bh);
    }
    for (int it = 0; it < n_q; ++it) {
      const int s = it % kStages;
      const int i0 = i_begin + it * BQ;
      uint8_t* st = ring + s * STAGE;
      wait_phase(&empty[s], ((it / kStages) & 1) ^ 1);
      mbar_arrive_expect_tx(&full[s], TX);
      for (int p = 0; p < L::panels; ++p) {
        tma_load_3d(st + p * BQ * 128, &tm_q, &full[s], 64 * p, i0, bh);
        tma_load_3d(st + QT + p * BQ * 128, &tm_do, &full[s], 64 * p, i0,
                    bh);
      }
      // A 1-D box starts on 16 bytes: from the multiple of 4 at or below.
      const int r0 = (bh * T + i0) & ~3;
      tma_load_1d(st + 2 * QT, &tm_lse, &full[s], r0);
      tma_load_1d(st + 2 * QT + RVB, &tm_delta, &full[s], r0);
    }
    return;
  }

  // A consumer warpgroup: keys kw .. kw + 63; this thread's are
  // kw + 16 warp + g and 8 below it, its queries in a tile
  // i0 + 8 j + 2 t + e.
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int kw = k0 + kWgRows * wg;
  const float scale_log2 = scale * kLog2e;
  float acc_k[L::panels][32], acc_v[L::panels][32];
#pragma unroll
  for (int p = 0; p < L::panels; ++p)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[p][i] = acc_v[p][i] = 0.f;
  wait_phase(kv_full, 0);

  for (int it = 0; it < n_q; ++it) {
    const int s = it % kStages;
    const int i0 = i_begin + it * BQ;
    wait_phase(&full[s], (it / kStages) & 1);
    // Keys past T are never stored; queries all before every key: P = 0.
    if (kw < T && !(causal && i0 + BQ - 1 < kw)) {
      const uint8_t* sq = ring + s * STAGE;
      const uint8_t* sdo = sq + QT;
      const float* slse =
          reinterpret_cast<const float*>(sq + 2 * QT) + ((bh * T + i0) & 3);
      const float* sdelta = slse + RVB / 4;
      float pt[BQ / 2], dst[BQ / 2];  // S^T then P^T; dP^T then dS^T
      wgmma_fence();
      dots_sm90<D, kCtaRows, BQ>(pt, sk, kw - k0, sq);
      dots_sm90<D, kCtaRows, BQ>(dst, sv, kw - k0, sdo);
      wgmma_wait<1>();
      fence_regs(pt);
      // Only a tile on the diagonal or past T computes the mask.
      const bool edge = (causal && i0 < kw + kWgRows - 1) || i0 + BQ > T;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float lse_log2 = slse[8 * j + 2 * t + e] * kLog2e;
          const int q = i0 + 8 * j + 2 * t + e;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float p =
                ex2_approx(fmaf(pt[4 * j + 2 * h + e], scale_log2, -lse_log2));
            if (edge) {
              const int key = kw + 16 * warp + g + 8 * h;
              if (q >= T || (causal && q < key)) p = 0.f;
            }
            pt[4 * j + 2 * h + e] = p;
          }
        }
      }
      uint32_t p_hi[BQ / 16][4], p_lo[BQ / 16][4];
      a_pairs<BQ>(pt, p_hi, p_lo);
      wgmma_fence();
      accumulate_sm90<D, BQ>(acc_v, p_hi, p_lo, sdo);  // dV += P^T dO
      wgmma_wait<1>();  // dP^T, issued before dV's group, has completed
      fence_regs(dst);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dst[4 * j + i] = pt[4 * j + i] *
                           (dst[4 * j + i] - sdelta[8 * j + 2 * t + (i & 1)]);
      uint32_t ds_hi[BQ / 16][4], ds_lo[BQ / 16][4];
      a_pairs<BQ>(dst, ds_hi, ds_lo);
      wgmma_fence();
      accumulate_sm90<D, BQ>(acc_k, ds_hi, ds_lo, sq);  // dK += dS^T Q
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < L::panels; ++p) {
        fence_regs(acc_k[p]);
        fence_regs(acc_v[p]);
      }
    }
    // This warp's wgmmas that read the stage have completed.
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  const size_t base = (size_t)bh * T * D;
  store_wg_rows<D>(dk + base, acc_k, kw, T, scale);
  store_wg_rows<D>(dv + base, acc_v, kw, T, 1.f);
}

template <typename scalar_t, int D>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dk, void* dv, int BH, int T, int causal,
                       float scale, cudaStream_t stream) {
  if constexpr (std::is_same<scalar_t, __nv_bfloat16>::value) {
    using L = Sm90<D>;
    constexpr int BQ = DkvTile<D>::rows;
    CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta;
    cudaError_t err;
    if ((err = slab_map(&tm_q, q, BH, T, D, BQ)) != cudaSuccess ||
        (err = slab_map(&tm_k, k, BH, T, D, kCtaRows)) != cudaSuccess ||
        (err = slab_map(&tm_v, v, BH, T, D, kCtaRows)) != cudaSuccess ||
        (err = slab_map(&tm_do, dout, BH, T, D, BQ)) != cudaSuccess ||
        (err = row_map(&tm_lse, lse, BH, T, BQ + 4)) != cudaSuccess ||
        (err = row_map(&tm_delta, delta, BH, T, BQ + 4)) != cudaSuccess)
      return err;
    if ((reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv)) %
        4)
      return cudaErrorMisalignedAddress;
    const int n_tiles = (T + kCtaRows - 1) / kCtaRows;
    const int rvb = ((BQ + 4) * 4 + 127) / 128 * 128;
    const int stage = (L::tile(BQ) * 2 + 2 * rvb + 1023) / 1024 * 1024;
    const size_t smem = 1024 + 2 * (size_t)L::tile(kCtaRows) +
                        (size_t)kStages * stage + (1 + 2 * kStages) * 8;
    auto kernel = flash_dkv_sm90_kernel<D>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    kernel<<<(unsigned)BH * n_tiles, kSm90Threads, smem, stream>>>(
        tm_q, tm_k, tm_v, tm_do, tm_lse, tm_delta,
        static_cast<scalar_t*>(dk), static_cast<scalar_t*>(dv), T, n_tiles,
        causal != 0, scale);
  } else {
    const int n_tiles = (T + kRows - 1) / kRows;
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
// is_bf16); lse, delta: [BH, T] fp32. Returns the launch's cudaError_t,
// cudaErrorMisalignedAddress for a bf16 operand that TMA cannot take (not
// 16-byte aligned).
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
