// Flash-attention forward for Hopper: O = softmax(scale * Q K^T) V and
// LSE = m + log(l), with an online softmax over K/V tiles.
//
// Replaces tepdist_tpu/ops/pallas/flash_attention.py:_fwd_kernel (called
// through _fwd_call). Same arithmetic: S is the fp32 sum of exact products
// of the inputs times scale, masked scores are _NEG_INF (-1e30), fully
// masked rows are guarded, and O and LSE are divided/logged by
// max(l, 1e-30). Keys past the diagonal or past T are masked, so any T
// works without padding, and a causal CTA stops at its diagonal. The TPU
// grid's sequential key loop becomes the loop inside the CTA.
//
// Bound on H100 (main path [4*25, 1024, 64] bf16, causal): 2 dots of
// 2*BH*T^2*D FLOPs, halved under causal (0.013 ms at the 989 TFLOP/s bf16
// peak), against q, k, v read and o, lse written once (0.016 ms at
// 3.35 TB/s): the bytes bound it. The bf16 kernel runs 3 product passes
// where the bound counts 2 (P enters P V as a hi/lo pair, since the
// reference sums P V from fp32 P), so its tensor-core floor is 0.020 ms
// (0.244 ms at the plan shape [48*25, 1024, 64]), beside about 6 CUDA-core
// instructions an element of P for the exp, the max, the sum and the split.
//
// bf16 (flash_fwd_sm90_kernel), Hopper: a persistent grid of one CTA an
// SM, each walking over its share of the (b*h, 128-query tile) items
// (fwd_item), with two consumer warpgroups of 64 queries each and a
// producer warpgroup (flash_common.cuh, "Hopper path"). TMA loads an
// item's Q once, 128-byte swizzled, into one of two buffers, and streams
// K and V in tiles of kFwdKeys<D> keys through a ring of kStages stages
// that runs on across items, so the next item's loads run under this
// item's last products and its epilogue. Per tile a warpgroup issues
// S = Q K^T of this tile (both operands in shared memory) together with
// O += P V of the tile before (P a register operand, hi and lo; V read
// MN-major), waits for S alone and runs this tile's online softmax under
// P V: the running max m and the denominator l of its rows stay in
// registers (the max reduced over the 4 threads of a row's quad by
// shuffles, l summed per thread and reduced once at the end). It waits
// for P V before it rescales O by corr = exp(m - m_new) and refills the
// P registers, and only then releases that tile's stage. The two
// warpgroups take turns to issue (named barriers, "ping-pong"), so one's
// exp runs under the other's products. exp is ex2 with log2(e) folded into
// scale; m stays in units of the unscaled scores, so the _NEG_INF guards
// read as in the Pallas kernel and LSE = scale * m + log(l) in natural-log
// units. Only a tile on the diagonal or past T pays for masking. Both
// warpgroups run all of an item's tiles (under causal, warpgroup 0 masks
// the last one whole when tiles are narrower than the item): a wgmma
// issued under a branch that depends on the thread, or left in flight
// across one, makes ptxas serialize every wgmma of the kernel. The items
// are dealt longest first, in alternating directions round by round, so
// the CTAs' shares stay even under causal. No atomics: each output row is
// summed by one warpgroup in a fixed order, and two runs on the same
// inputs give the same bits.
//
// fp32 (flash_fwd_kernel): fp32 FMAs on the CUDA cores, where TF32 would
// change the reference's fp32 numerics, so their issue rate bounds it. One
// CTA per (b*h, 64-row Q tile), with Layout<D>::value threads per query
// row, each holding at most 32 floats of the row's fp32 output
// (flash_common.cuh). A row's threads keep its running max m and
// denominator l (replicated) and their share of its fp32 output row in
// registers; K and V stream through shared memory 32 rows at a time, and
// the scores of 16 keys at a time sit in registers.
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

// Keys a stage of the bf16 kernel streams: 128 at D <= 64 (S as one
// m64n128k16 wgmma a k step), 64 at D = 128, where O takes 64 registers a
// thread beside S and the hi/lo P, 32 each.
template <int D>
constexpr int kFwdKeys = D <= 64 ? 128 : 64;

// One tile of the online softmax for this thread's two rows of a consumer
// warpgroup (rows rw + 16 warp + g and 8 below it; keys k0 + 8 j + 2 t + e
// in s[4 j + 2 h + e]): masks keys past T or after the row where the tile
// reaches them, raises the running max m of the unscaled scores, turns s
// into P = 2^(scale_log2 (s - m)), adds P's sums to this thread's share
// of l, and gives corr = 2^(scale_log2 (m_before - m)) per row, by which O
// must be rescaled.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2],
                                             float (&l)[2], float (&corr)[2],
                                             int k0, int rw, int T,
                                             bool causal, float scale_log2) {
  const int warp = threadIdx.x % 128 / 32, g = threadIdx.x % 32 / 4;
  const int t = threadIdx.x % 4;
  // Only a tile on the warpgroup's diagonal or past T computes the mask.
  if ((causal && k0 + BK - 1 > rw) || k0 + BK > T) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int row = rw + 16 * warp + g + 8 * ((i >> 1) & 1);
      const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (col >= T || (causal && col > row)) s[i] = kNegInf;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    // The guards of the Pallas kernel: no earlier key (corr = 0), or no
    // key at all so far (P = 0: 2^x of about -1e30).
    corr[h] = m[h] <= kNegInf / 2 ? 0.f
                                  : ex2_approx((m[h] - m_new) * scale_log2);
    const float m_sub = m_new <= kNegInf / 2 ? -kNegInf : m_new * scale_log2;
    m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = s[4 * j + 2 * h + e];
        x = ex2_approx(fmaf(x, scale_log2, -m_sub));
        sum += x;
      }
    l[h] = l[h] * corr[h] + sum;
  }
}

// The items of a launch are (head, query tile) pairs, item w the head
// w % BH and the query tile n_tiles - 1 - w / BH, so that under causal the
// longest come first. CTA c takes item r G + c in even rounds r and
// r G + G - 1 - c in odd ones (G CTAs), so that a CTA with a long item in
// one round has a short one in the next. fwd_item gives round r's item of
// this CTA (false past the last item) with the key tiles it streams.
template <int BK>
__device__ __forceinline__ bool fwd_item(int r, int BH, int T, int n_tiles,
                                         bool causal, int& bh, int& q0,
                                         int& n_k) {
  const int G = gridDim.x, c = blockIdx.x;
  const int w = r * G + (r & 1 ? G - 1 - c : c);
  if (w >= BH * n_tiles) return false;
  bh = w % BH;
  q0 = (n_tiles - 1 - w / BH) * kCtaRows;
  n_k = ((causal ? min(T, q0 + kCtaRows) : T) + BK - 1) / BK;
  return true;
}

template <int D>
__global__ void __launch_bounds__(kSm90Threads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int BH, int T,
                          int n_tiles, bool causal, float scale) {
  using L = Sm90<D>;
  constexpr int BK = kFwdKeys<D>;
  constexpr int QT = L::tile(kCtaRows);  // bytes of Q
  constexpr int KT = L::tile(BK);        // bytes of a K (and a V) tile
  constexpr int STAGE = 2 * KT;          // a multiple of 1024
  extern __shared__ float4 smem4[];
  uint8_t* sq = align1024(smem4);  // Q of items 2i and 2i + 1
  uint8_t* ring = sq + 2 * QT;     // stage s: K, V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ring + kStages * STAGE);
  uint64_t* q_empty = q_full + 2;
  uint64_t* full = q_empty + 2;
  uint64_t* empty = full + kStages;
  const int n_items = BH * n_tiles;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&q_full[b], 1);
      mbar_init(&q_empty[b], kConsumers * 4);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  int bh, q0, n_k;
  if (threadIdx.x >= kConsumers * 128) {
    // The producer warpgroup: one thread issues every load. g counts the
    // key tiles of this CTA's earlier items: the ring runs on across them.
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x != kConsumers * 128) return;
    int g = 0;
    for (int r = 0, i = 0; r * (int)gridDim.x < n_items; ++r) {
      if (!fwd_item<BK>(r, BH, T, n_tiles, causal, bh, q0, n_k)) continue;
      const int b = i & 1;
      wait_phase(&q_empty[b], ((i++ >> 1) & 1) ^ 1);
      mbar_arrive_expect_tx(&q_full[b], QT);
      for (int p = 0; p < L::panels; ++p)
        tma_load_3d(sq + b * QT + p * kCtaRows * 128, &tm_q, &q_full[b],
                    64 * p, q0, bh);
      for (int it = 0; it < n_k; ++it, ++g) {
        const int s = g % kStages;
        uint8_t* st = ring + s * STAGE;
        wait_phase(&empty[s], ((g / kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], STAGE);
        for (int p = 0; p < L::panels; ++p) {
          tma_load_3d(st + p * BK * 128, &tm_k, &full[s], 64 * p, it * BK,
                      bh);
          tma_load_3d(st + KT + p * BK * 128, &tm_v, &full[s], 64 * p,
                      it * BK, bh);
        }
      }
    }
    return;
  }

  // A consumer warpgroup: of each item, queries rw .. rw + 63. Both
  // warpgroups run all n_k tiles (a tile past a warpgroup's rows is masked
  // whole), so that every wgmma is issued on a path the compiler sees as
  // uniform. They take turns to issue their products (named barriers
  // 1 + wg), warpgroup 0 first, so that one's exp runs under the other's
  // products.
  setmaxnreg_inc<kConsumerRegs>();
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x % 128 / 32, g8 = lane / 4, t = lane % 4;
  const float scale_log2 = scale * kLog2e;
  // This warp has read a stage: its wgmmas on it have completed.
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) mbar_arrive(bar);
  };
  float sc[BK / 2];  // S, then P
  uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
  float acc[L::panels][32];
  if (wg == 1) bar_arrive<kConsumers * 128>(1);
  int g = 0, i = 0;
  for (int r = 0; r * (int)gridDim.x < n_items; ++r) {
    if (!fwd_item<BK>(r, BH, T, n_tiles, causal, bh, q0, n_k)) continue;
    const uint8_t* q_tile = sq + (i & 1) * QT;
    const int rw = q0 + kWgRows * wg;
    // Per row h: the running max of the unscaled scores, and this thread's
    // share of the denominator (summed over the quad at the end).
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
#pragma unroll
    for (int p = 0; p < L::panels; ++p)
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[p][j] = 0.f;
    wait_phase(&q_full[i & 1], (i >> 1) & 1);
    ++i;

    // Tile 0: S, and P for the first product (O is zero: no rescaling).
    wait_phase(&full[g % kStages], (g / kStages) & 1);
    bar_sync<kConsumers * 128>(1 + wg);
    wgmma_fence();
    dots_sm90<D, kCtaRows, BK>(sc, q_tile, rw - q0,
                               ring + g % kStages * STAGE);
    bar_arrive<kConsumers * 128>(2 - wg);
    wgmma_wait<0>();
    fence_regs(sc);
    softmax_tile<BK>(sc, m, l, corr, 0, rw, T, causal, scale_log2);
    a_pairs<BK>(sc, p_hi, p_lo);

    // Tile it: S = Q K^T of tile it and O += P V of tile it - 1 together,
    // so that this tile's exp runs under the previous tile's product.
    for (int it = 1; it < n_k; ++it) {
      const int s = (g + it) % kStages;
      wait_phase(&full[s], ((g + it) / kStages) & 1);
      bar_sync<kConsumers * 128>(1 + wg);
      wgmma_fence();
      dots_sm90<D, kCtaRows, BK>(sc, q_tile, rw - q0, ring + s * STAGE);
      accumulate_sm90<D, BK>(acc, p_hi, p_lo,
                             ring + (g + it - 1) % kStages * STAGE + KT);
      bar_arrive<kConsumers * 128>(2 - wg);
      wgmma_wait<1>();  // S is complete; P V may still run
      fence_regs(sc);
      softmax_tile<BK>(sc, m, l, corr, it * BK, rw, T, causal, scale_log2);
      // P V is complete before O is rescaled and its P registers refilled.
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < L::panels; ++p) fence_regs(acc[p]);
      release(&empty[(g + it - 1) % kStages]);
#pragma unroll
      for (int p = 0; p < L::panels; ++p)
#pragma unroll
        for (int j = 0; j < 32; ++j) acc[p][j] *= corr[(j >> 1) & 1];
      a_pairs<BK>(sc, p_hi, p_lo);
    }
    // Every S of the item is complete: its Q buffer may take item i + 1.
    release(&q_empty[(i - 1) & 1]);
    bar_sync<kConsumers * 128>(1 + wg);
    wgmma_fence();
    accumulate_sm90<D, BK>(acc, p_hi, p_lo,
                           ring + (g + n_k - 1) % kStages * STAGE + KT);
    bar_arrive<kConsumers * 128>(2 - wg);
    wgmma_wait<0>();
#pragma unroll
    for (int p = 0; p < L::panels; ++p) fence_regs(acc[p]);
    release(&empty[(g + n_k - 1) % kStages]);
    g += n_k;

    float mul[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float lc = fmaxf(lt, 1e-30f);
      mul[h] = 1.f / lc;
      const int row = rw + 16 * warp + g8 + 8 * h;
      if (t == 0 && row < T) {
        const float mm = m[h] <= kNegInf / 2 ? kNegInf : m[h] * scale;
        lse[(size_t)bh * T + row] = mm + logf(lc);
      }
    }
    store_wg_rows<D>(o + (size_t)bh * T * D, acc, rw, T, mul);
  }
  // Warpgroup 1's last turn, given back.
  if (wg == 0) bar_sync<kConsumers * 128>(1);
}

template <typename scalar_t, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int BH, int T, int causal, float scale,
                       cudaStream_t stream) {
  if constexpr (std::is_same<scalar_t, __nv_bfloat16>::value) {
    using L = Sm90<D>;
    constexpr int BK = kFwdKeys<D>;
    CUtensorMap tm_q, tm_k, tm_v;
    cudaError_t err;
    if ((err = slab_map(&tm_q, q, BH, T, D, kCtaRows)) != cudaSuccess ||
        (err = slab_map(&tm_k, k, BH, T, D, BK)) != cudaSuccess ||
        (err = slab_map(&tm_v, v, BH, T, D, BK)) != cudaSuccess)
      return err;
    if (reinterpret_cast<uintptr_t>(o) % 4) return cudaErrorMisalignedAddress;
    const int n_tiles = (T + kCtaRows - 1) / kCtaRows;
    int device, sms;
    if ((err = cudaGetDevice(&device)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess)
      return err;
    const size_t smem = 1024 + 2 * (size_t)L::tile(kCtaRows) +
                        (size_t)kStages * 2 * L::tile(BK) +
                        (4 + 2 * kStages) * 8;
    auto kernel = flash_fwd_sm90_kernel<D>;
    if ((err = allow_smem(kernel, smem)) != cudaSuccess) return err;
    // One CTA an SM (the consumers' registers fill it), each walking over
    // its share of the BH * n_tiles items.
    const int grid = BH * n_tiles < sms ? BH * n_tiles : sms;
    kernel<<<(unsigned)grid, kSm90Threads, smem, stream>>>(
        tm_q, tm_k, tm_v, static_cast<scalar_t*>(o), static_cast<float*>(lse),
        BH, T, n_tiles, causal != 0, scale);
  } else {
    const int n_tiles = (T + kRows - 1) / kRows;
    const size_t smem = (size_t)(kRows + 2 * kTile) * Layout<D>::stride * 4;
    auto kernel = flash_fwd_kernel<scalar_t, D>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)BH * n_tiles, kRows * Layout<D>::value, smem,
             stream>>>(
        static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
        static_cast<const scalar_t*>(v), static_cast<scalar_t*>(o),
        static_cast<float*>(lse), T, n_tiles, causal != 0, scale);
  }
  return cudaGetLastError();
}

}  // namespace tepdist

// q, k, v, o: [BH, T, D] of one dtype (fp32, or bf16 when is_bf16);
// lse: [BH, T] fp32. Returns the launch's cudaError_t,
// cudaErrorMisalignedAddress for a bf16 operand that TMA cannot take (not
// 16-byte aligned).
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
