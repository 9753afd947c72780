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
// 3.35 TB/s): the bytes bound it.
//
// bf16 (flash_fwd_mma_kernel): the dots run on the tensor cores. One CTA
// of FwdTile::warps warps per (b*h, FwdTile::rows-row Q tile), each warp
// owning FwdTile::blocks blocks of 16 rows. Q comes in once by cp.async and
// each warp keeps its Q A-fragments in registers for the whole key loop. K
// and V stream in 64-row tiles, double-buffered by cp.async so the next
// tile's copy overlaps this one's dots. A warp forms S = Q_w K^T with
// mma.sync (K as B through ldmatrix), keeps the running max m and the
// denominator l of its rows in registers (the max reduced over the 4 lanes
// of a row's quad by shuffles, l summed per lane and reduced once at the
// end), rescales its fp32 O accumulator by corr = exp(m - m_new), and adds
// P V with P re-packed from the accumulators into the A operand as a hi/lo
// bf16 pair and V as B through ldmatrix .trans (accumulate, as in the
// backward kernels). exp is exp2 with log2(e) folded into scale; m stays
// in units of the unscaled scores, so the _NEG_INF guards read as in the
// Pallas kernel and LSE = scale * m + log(l) in natural-log units. Only the
// round of keys that straddles the diagonal or T pays for masking. CTAs are
// numbered so that the longest (last, under causal) start first.
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

// Tile of the bf16 kernel: warps per CTA, 16-row blocks a warp owns, and
// streamed rows a warp scores per register round.
template <int D>
struct FwdTile {
  static constexpr int warps = kTcWarps;
  static constexpr int blocks = 1;
  static constexpr int cols = Tc<D>::cols;
  static constexpr int rows = 16 * warps * blocks;  // query rows of a CTA
};

template <int D>
__global__ void __launch_bounds__(FwdTile<D>::warps * 32)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int T, int n_tiles,
                         bool causal, float scale) {
  constexpr int S = Tc<D>::stride;
  constexpr int N = FwdTile<D>::cols;
  constexpr int R = FwdTile<D>::blocks;
  constexpr int QR = FwdTile<D>::rows;
  constexpr int TILE = kRows * S;
  extern __shared__ float4 smem4[];
  __nv_bfloat16* sq = reinterpret_cast<__nv_bfloat16*>(smem4);  // [QR][S]
  __nv_bfloat16* sk = sq + QR * S;  // [2][kRows][S], double-buffered
  __nv_bfloat16* sv = sk + 2 * TILE;

  const int BH = gridDim.x / n_tiles;
  const int bh = blockIdx.x % BH;
  const int q0 = (n_tiles - 1 - (int)blockIdx.x / BH) * QR;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const size_t base = (size_t)bh * T * D;
  const int row_w = q0 + 16 * R * warp;  // this warp's first row
  const int row_last = row_w + 16 * R - 1;
  const int k_end = causal ? min(T, q0 + QR) : T;
  const int n_k = (k_end + kRows - 1) / kRows;
  const float scale_log2 = scale * 1.4426950408889634f;  // log2(e)

  // Q in its own group, so its fragments load while K/V tile 0 is in
  // flight.
  load_tile_async<D, QR>(sq, q + base, q0, T);
  cp_async_commit();
  load_tile_async<D>(sk, k + base, 0, T);
  load_tile_async<D>(sv, v + base, 0, T);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  uint32_t qa[R][D / 16][4];
  {
    const int ar = ldm_row_a(lane), ac = ldm_col_a(lane);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qa[r][kk],
                    sq + (16 * (R * warp + r) + ar) * S + kk * 16 + ac);
  }

  // Per owned row (block r, h = 0: row g, h = 1: row g + 8 of the block):
  // the running max of the unscaled scores, and this lane's share of l.
  float m[R][2], l[R][2];
  float acc[R][D / 8][4];
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int h = 0; h < 2; ++h) m[r][h] = kNegInf, l[r][h] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;
  }

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
      // Past T, or every key after every row of this warp: nothing to add.
      if (col0 >= T || (causal && col0 > row_last)) break;
      float s[R][N / 8][4];
      score<D, N, R>(s, qa, kt + c0 * S);
      // Only a round that reaches past T or past this warp's first row's
      // diagonal has keys to mask.
      if (col0 + N > T || (causal && col0 + N - 1 > row_w)) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int row = row_w + 16 * r + lane / 4 + 8 * (e >> 1);
              const int col = col0 + 8 * j + 2 * (lane % 4) + (e & 1);
              if (col >= T || (causal && col > row)) s[r][j][e] = kNegInf;
            }
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
            mx = fmaxf(mx, fmaxf(s[r][j][2 * h], s[r][j][2 * h + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[r][h], mx);
          // The guards of the Pallas kernel: no earlier key (corr = 0), or
          // no key at all so far (P = 0: exp2 of about -1e30).
          const float corr = m[r][h] <= kNegInf / 2
                                 ? 0.f
                                 : exp2f((m[r][h] - m_new) * scale_log2);
          const float m_sub =
              m_new <= kNegInf / 2 ? -kNegInf : m_new * scale_log2;
          m[r][h] = m_new;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < N / 8; ++j)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              const float p = exp2f(fmaf(s[r][j][e], scale_log2, -m_sub));
              s[r][j][e] = p;
              sum += p;
            }
          l[r][h] = l[r][h] * corr + sum;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            acc[r][j][2 * h] *= corr;
            acc[r][j][2 * h + 1] *= corr;
          }
        }
#pragma unroll
      for (int r = 0; r < R; ++r)
        accumulate<D, N>(acc[r], s[r], vt + c0 * S);
    }
    __syncthreads();  // this buffer is consumed before it is refilled
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    float mul[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lt = l[r][h];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float lc = fmaxf(lt, 1e-30f);
      mul[h] = 1.f / lc;
      const int row = row_w + 16 * r + lane / 4 + 8 * h;
      if (lane % 4 == 0 && row < T) {
        const float mm = m[r][h] <= kNegInf / 2 ? kNegInf : m[r][h] * scale;
        lse[(size_t)bh * T + row] = mm + logf(lc);
      }
    }
    store_rows<D>(o + base, acc[r], row_w + 16 * r, T, mul);
  }
}

template <typename scalar_t, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int BH, int T, int causal, float scale,
                       cudaStream_t stream) {
  if constexpr (std::is_same<scalar_t, __nv_bfloat16>::value) {
    using Tile = FwdTile<D>;
    const int n_tiles = (T + Tile::rows - 1) / Tile::rows;
    const size_t smem = (size_t)(Tile::rows + 4 * kRows) * Tc<D>::stride * 2;
    auto kernel = flash_fwd_mma_kernel<D>;
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<(unsigned)BH * n_tiles, Tile::warps * 32, smem, stream>>>(
        static_cast<const scalar_t*>(q), static_cast<const scalar_t*>(k),
        static_cast<const scalar_t*>(v), static_cast<scalar_t*>(o),
        static_cast<float*>(lse), T, n_tiles, causal != 0, scale);
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
