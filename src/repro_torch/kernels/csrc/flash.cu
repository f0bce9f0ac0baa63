// Causal GQA flash attention for Hopper (sm_90a): the forward, the forward
// that also writes the per-row log-sum-exp, and the FlashAttention-2
// backward (dQ, and dK/dV).
//
// Replaces the TPU kernels of src/repro/kernels/flash.py:
//   :55  `_flash_kernel`            -> flash_fwd_tc_kernel<HD, false> (bf16),
//                                      flash_fwd_kernel<float, HD, false>
//   :150 `_flash_fwd_stats_kernel`  -> the same with STATS = true
//   :196 `_flash_bwd_dq_kernel`     -> flash_bwd_dq_kernel<T, HD>
//   :239 `_flash_bwd_dkv_kernel`    -> flash_bwd_dkv_kernel<T, HD>
// They compute what those compute, not how.  On the TPU the kv (or q) tile
// axis is the last, sequential grid axis and the accumulators live in VMEM
// scratch across its steps.  Here blocks run in parallel in no order, so a
// block owns its output tile and loops over the summed tile axis itself:
//   forward, dQ: one block per (q tile, query head, batch), looping over the
//                kv tiles in ascending order;
//   dK/dV:       one block per (kv tile, kv head, batch), looping over the G
//                query heads of its kv head and over the q tiles, summing the
//                G heads' contributions in f32 inside the block (the TPU
//                version writes one partial per query head, rounds each to
//                k's dtype and sums them outside).  No atomics: every output
//                element is written by one thread, so results are
//                deterministic.
//
// Block skipping.  This is why the kernels exist: a tile pair that is fully
// masked is never touched.  Causal: kv tile kt is needed by q tile qt iff its
// first key is at or before the tile's last query.  Window w (keys kp with
// qp - w < kp <= qp): iff also its last key is after the first query's
// window start.  The loops run from the first needed tile to the last.
//
// The finite mask value.  Scores outside the mask are NEG_INF = -1e30, as in
// the reference.  A processed kv tile in which a row is fully masked (the
// window's edge) gives that row p = exp(0) = 1 while its running max is
// still NEG_INF; the first tile with a real score wipes that out through
// corr = exp(NEG_INF - m) = 0.  That needs the ascending tile order and the
// finite constant (-INFINITY would give inf - inf = NaN); every row's last
// processed tile holds its diagonal, so every row ends with a real score.
//
// Numerics, as the reference: q.k products exact in f32 (inputs upcast),
// scaled by 1/sqrt(hd) after the sum; m, l and the accumulator f32; in the
// forward p is rounded to v's dtype before p.V; l floored at 1e-30; output
// in q's dtype, lse = m + log(l) in f32.  The backward upcasts dO and v to
// f32 and recomputes p = exp(s - lse) under the mask (0 outside).
//
// Layout.  q, o, dO, dQ are (B, H, S, hd) and k, v, dK, dV (B, KV, S, hd)
// as strided views: the caller passes each tensor's (batch, head, sequence)
// strides, hd is contiguous.  So the model's (B, S, H, hd) activations go
// in without a transposed copy.  Query head h reads kv head h / G.  lse and
// delta are (B, H, S) f32, contiguous.  S need not be a multiple of the
// tile: rows past S are zero-filled and masked.
//
// What bounds them.  Per causal (B, H, S, hd) call the forward does
// 2 B H S^2 hd flops and moves ~(2 H + 2 KV) B S hd elements, about 1300
// flops per byte at Qwen3's widths: bound by operations, so by the tensor
// cores for bf16.  The bf16 forward runs its two tile products as wmma
// fragments on the tensor cores (exact bf16 products, f32 sums: the
// reference's numerics).  The f32 forward and the backward run them on the
// CUDA cores in f32 (64 x 64 tiles, each thread a 4 x 4 register block of
// scores and a 4 x hd/16 block of the output, tiles staged in f32 shared
// memory with a padded row so that the 16 threads of a row group hit 16
// banks): the backward's second products take f32 operands (p and dS, as
// the reference keeps them), which bf16 fragments would round.  Copies
// through TMA, wgmma and a bf16-rounded backward are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

#include "tile.cuh"

namespace {

constexpr int BQ = 64;          // query rows per tile
constexpr int BK = 64;          // keys per tile
constexpr int NT = 256;         // threads: 16 row groups x 16 column lanes
constexpr int LP = BK + 1;      // padded row of a (64 x 64) score tile
constexpr float NEG_INF = -1e30f;

struct Strides {
  long long b, h, s;            // elements; the hd stride is 1
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// rows [row0, row0 + 64) of one (S, HD) head into a (64, HD + 1) f32 tile;
// rows at or past S are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long ss, int row0, int S) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i - r * HD;
    const int s = row0 + r;
    dst[r * LD + d] = s < S ? to_f32(src[(long long)s * ss + d]) : 0.0f;
  }
}

// max / sum over the 16 lanes of a row group (lanes 0-15 or 16-31)
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// acc[i][j] += sum_d A[ra + 16 i][d] B[rb + 16 j][d] over two (64, HD + 1)
// tiles: a 4 x 4 block of a tile product A B^T.
template <int HD>
__device__ __forceinline__ void dot_block(float (&acc)[4][4],
                                          const float* __restrict__ A, int ra,
                                          const float* __restrict__ B, int rb) {
  constexpr int LD = HD + 1;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float a[4], c[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ra + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) c[j] = B[(rb + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
  }
}

__device__ __forceinline__ bool keep(int qp, int kp, int window) {
  return kp <= qp && (window <= 0 || kp > qp - window);
}

// ------------------------------------------------------------------------- //
// Forward (rows 9 and 10) on the CUDA cores, for f32: one block per (q tile,
// query head, batch)
// ------------------------------------------------------------------------- //
template <typename T, int HD, bool STATS>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Strides qs, Strides ks,
                     Strides vs, Strides os, int H, int KV, int S, int window,
                     float scale) {
  constexpr int LD = HD + 1, NC = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                 // (BQ, LD)
  float* KVs = Qs + BQ * LD;        // (BK, LD): K, then V, of one kv tile
  float* Ps = KVs + BK * LD;        // (BQ, LP): p rounded to v's dtype

  const int nq = (S + BQ - 1) / BQ;
  const int qt = nq - 1 - (int)blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  load_tile<T, HD>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }
  const int kt_first = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int kt_last = (min(q0 + BQ, S) - 1) / BK;
  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                // the last tile's p.V is done
    load_tile<T, HD>(KVs, kb, ks.s, k0, S);
    __syncthreads();
    float s[4][4] = {};
    dot_block<HD>(s, Qs, ty, KVs, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = keep(qp, k0 + tx + 16 * j, window) ? s[i][j] * scale
                                                     : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * LP + tx + 16 * j] = round_like<T>(p);
      }
      l[i] = l[i] * corr + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();                // K read, p written
    load_tile<T, HD>(KVs, vb, vs.s, k0, S);
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float vv = KVs[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(p[i], vv, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* dst = o + b * os.b + h * os.h + (long long)r * os.s;
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[tx + 16 * c] = from_f32<T>(acc[i][c] / den);
    if (STATS && tx == 0) lse[((long long)b * H + h) * S + r] = m[i] + logf(den);
  }
}

// ------------------------------------------------------------------------- //
// Forward on the tensor cores, for bf16 (rows 9 and 10): the block, tiles,
// loop and online softmax of flash_fwd_kernel, with S = Q K^T and P V as
// bf16 wmma products (16x16x16 fragments, f32 accumulators) through shared
// memory.  The numerics stay the reference's: bf16 products are exact and
// summed in f32, p is rounded to bf16 before P V.  Each of the 8 warps
// computes 2 of the 16 score fragments and HD/8 of the output fragments;
// the threads then fold the tile's P V into their f32 registers.
// ------------------------------------------------------------------------- //
using bf16 = __nv_bfloat16;

template <int HD>
__device__ __forceinline__ void load_tile_bf16(bf16* dst,
                                               const bf16* __restrict__ src,
                                               long long ss, int row0, int S) {
  constexpr int LDH = HD + 8;
  for (int i = threadIdx.x; i < BQ * HD; i += NT) {
    const int r = i / HD, d = i - r * HD;
    const int s = row0 + r;
    dst[r * LDH + d] = s < S ? src[(long long)s * ss + d] : __float2bfloat16(0.0f);
  }
}

template <int HD, bool STATS>
__global__ void __launch_bounds__(NT)
    flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, Strides qs, Strides ks,
                        Strides vs, Strides os, int H, int KV, int S,
                        int window, float scale) {
  namespace wmma = nvcuda::wmma;
  // padded rows; every fragment pointer stays 32-byte aligned
  constexpr int LDH = HD + 8, LDS = BK + 4, LDP = BK + 8, LDO = HD + 4;
  constexpr int NC = HD / 16, NW = NT / 32;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);           // (BQ, LDH)
  bf16* Ks = Qs + BQ * LDH;                               // (BK, LDH)
  bf16* Vs = Ks + BK * LDH;                               // (BK, LDH)
  float* Ss = reinterpret_cast<float*>(Vs + BK * LDH);    // (BQ, LDS)
  bf16* Ps = reinterpret_cast<bf16*>(Ss + BQ * LDS);      // (BQ, LDP)
  float* Os = reinterpret_cast<float*>(Ps + BQ * LDP);    // (BQ, LDO)

  const int nq = (S + BQ - 1) / BQ;
  const int qt = nq - 1 - (int)blockIdx.x;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  load_tile_bf16<HD>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }
  const int kt_first = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int kt_last = (min(q0 + BQ, S) - 1) / BK;
  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                // the last tile's fold is done
    load_tile_bf16<HD>(Ks, kb, ks.s, k0, S);
    load_tile_bf16<HD>(Vs, vb, vs.s, k0, S);
    __syncthreads();
    for (int f = warp; f < (BQ / 16) * (BK / 16); f += NW) {
      const int fi = f / (BK / 16), fj = f % (BK / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(a, Qs + fi * 16 * LDH + kk, LDH);
        wmma::load_matrix_sync(kf, Ks + fj * 16 * LDH + kk, LDH);
        wmma::mma_sync(sf, a, kf, sf);
      }
      wmma::store_matrix_sync(Ss + fi * 16 * LDS + fj * 16, sf, LDS,
                              wmma::mem_row_major);
    }
    __syncthreads();
    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
      float s[4], mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float dot = Ss[(ty + 16 * i) * LDS + tx + 16 * j];
        s[j] = keep(qp, k0 + tx + 16 * j, window) ? dot * scale : NEG_INF;
        mx = fmaxf(mx, s[j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      corr[i] = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * LDP + tx + 16 * j] = __float2bfloat16(p);
      }
      l[i] = l[i] * corr[i] + group_sum(sum);
      m[i] = m_new;
    }
    __syncthreads();
    for (int f = warp; f < (BQ / 16) * (HD / 16); f += NW) {
      const int fi = f / (HD / 16), fj = f % (HD / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.0f);
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, Ps + fi * 16 * LDP + kk, LDP);
        wmma::load_matrix_sync(vf, Vs + kk * LDH + fj * 16, LDH);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(Os + fi * 16 * LDO + fj * 16, of, LDO,
                              wmma::mem_row_major);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c)
        acc[i][c] = fmaf(acc[i][c], corr[i], Os[(ty + 16 * i) * LDO + tx + 16 * c]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    bf16* dst = o + b * os.b + h * os.h + (long long)r * os.s;
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[tx + 16 * c] = __float2bfloat16(acc[i][c] / den);
    if (STATS && tx == 0) lse[((long long)b * H + h) * S + r] = m[i] + logf(den);
  }
}

// ------------------------------------------------------------------------- //
// dQ (row 11): one block per (q tile, query head, batch)
// ------------------------------------------------------------------------- //
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        Strides qs, Strides ks, Strides vs, Strides dos,
                        Strides dqs, int H, int KV, int S, int window,
                        float scale) {
  constexpr int LD = HD + 1, NC = HD / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                 // (BQ, LD)
  float* dOs = Qs + BQ * LD;        // (BQ, LD)
  float* KVs = dOs + BQ * LD;       // (BK, LD): V, then K, of one kv tile
  float* dSs = KVs + BK * LD;       // (BQ, LP)

  const int nq = (S + BQ - 1) / BQ;
  const int qt = nq - 1 - (int)blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kb = k + b * ks.b + kvh * ks.h;
  const T* vb = v + b * vs.b + kvh * vs.h;
  load_tile<T, HD>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_tile<T, HD>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, S);
  const long long row0 = ((long long)b * H + h) * S;
  float lse_r[4], delta_r[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < S ? lse[row0 + r] : 0.0f;
    delta_r[i] = r < S ? delta[row0 + r] : 0.0f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.0f;
  }
  const int kt_first = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int kt_last = (min(q0 + BQ, S) - 1) / BK;
  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();                // the last tile's dS.K is done
    load_tile<T, HD>(KVs, vb, vs.s, k0, S);
    __syncthreads();
    float dp[4][4] = {};
    dot_block<HD>(dp, dOs, ty, KVs, tx);
    __syncthreads();                // V read
    load_tile<T, HD>(KVs, kb, ks.s, k0, S);
    __syncthreads();
    float s[4][4] = {};
    dot_block<HD>(s, Qs, ty, KVs, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep(qp, k0 + tx + 16 * j, window) && qp < S
                            ? expf(s[i][j] * scale - lse_r[i])
                            : 0.0f;
        dSs[(ty + 16 * i) * LP + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * LP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = KVs[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(ds[i], kv, acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= S) continue;
    T* dst = dq + b * dqs.b + h * dqs.h + (long long)r * dqs.s;
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[tx + 16 * c] = from_f32<T>(acc[i][c]);
  }
}

// ------------------------------------------------------------------------- //
// dK, dV (row 12): one block per (kv tile, kv head, batch), summing over the
// G query heads of the kv head and over the q tiles that see the kv tile
// ------------------------------------------------------------------------- //
template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, Strides qs, Strides ks,
                         Strides vs, Strides dos, Strides dks, Strides dvs,
                         int H, int KV, int S, int window, float scale) {
  constexpr int LD = HD + 1, NC = HD / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                 // (BK, LD)
  float* Vs = Ks + BK * LD;         // (BK, LD)
  float* Qs = Vs + BK * LD;         // (BQ, LD)
  float* dOs = Qs + BQ * LD;        // (BQ, LD)
  float* Pt = dOs + BQ * LD;        // (BK, LP): p transposed
  float* dSt = Pt + BK * LP;        // (BK, LP): dS transposed
  float* lse_s = dSt + BK * LP;     // (BQ)
  float* delta_s = lse_s + BQ;      // (BQ)

  const int kt = blockIdx.x;        // the first kv tiles see the most q tiles
  const int kvh = blockIdx.y, b = blockIdx.z, G = H / KV;
  const int k0 = kt * BK;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  load_tile<T, HD>(Ks, k + b * ks.b + kvh * ks.h, ks.s, k0, S);
  load_tile<T, HD>(Vs, v + b * vs.b + kvh * vs.h, vs.s, k0, S);
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.0f;

  const int nq = (S + BQ - 1) / BQ;
  const int qt_first = k0 / BQ;
  const int qt_last =
      window > 0 ? min(nq - 1, (k0 + BK + window - 2) / BQ) : nq - 1;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const long long row0 = ((long long)b * H + h) * S;
    for (int qt = qt_first; qt <= qt_last; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();              // the last tile's products are done
      load_tile<T, HD>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
      load_tile<T, HD>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, S);
      for (int r = threadIdx.x; r < BQ; r += NT) {
        lse_s[r] = q0 + r < S ? lse[row0 + q0 + r] : 0.0f;
        delta_s[r] = q0 + r < S ? delta[row0 + q0 + r] : 0.0f;
      }
      __syncthreads();
      // transposed tiles: rows are keys k0 + ty + 16 i, columns queries
      float s[4][4] = {}, dp[4][4] = {};
      dot_block<HD>(s, Ks, ty, Qs, tx);
      dot_block<HD>(dp, Vs, ty, dOs, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kp = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qr = tx + 16 * j, qp = q0 + qr;
          const float p = keep(qp, kp, window) && qp < S
                              ? expf(s[i][j] * scale - lse_s[qr])
                              : 0.0f;
          Pt[(ty + 16 * i) * LP + qr] = p;
          dSt[(ty + 16 * i) * LP + qr] = p * (dp[i][j] - delta_s[qr]) * scale;
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float p[4], ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          p[i] = Pt[(ty + 16 * i) * LP + qq];
          ds[i] = dSt[(ty + 16 * i) * LP + qq];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float dov = dOs[qq * LD + tx + 16 * c];
          const float qv = Qs[qq * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dv_acc[i][c] = fmaf(p[i], dov, dv_acc[i][c]);
            dk_acc[i][c] = fmaf(ds[i], qv, dk_acc[i][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= S) continue;
    T* kd = dk + b * dks.b + kvh * dks.h + (long long)r * dks.s;
    T* vd = dv + b * dvs.b + kvh * dvs.h + (long long)r * dvs.s;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      kd[tx + 16 * c] = from_f32<T>(dk_acc[i][c]);
      vd[tx + 16 * c] = from_f32<T>(dv_acc[i][c]);
    }
  }
}

constexpr size_t tile_bytes(int hd) { return sizeof(float) * BQ * (hd + 1); }
constexpr size_t score_bytes() { return sizeof(float) * BQ * LP; }

Strides strides(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// Sets the kernel's dynamic shared memory limit (above 48 KB it must be
// raised explicitly) and launches it.
template <typename K, typename... Args>
int launch(K kernel, dim3 grid, size_t smem, cudaStream_t s, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

constexpr size_t tc_bytes(int hd) {
  return 2 * (3 * BQ * (hd + 8) + BQ * (BK + 8)) +
         4 * (BQ * (BK + 4) + BQ * (hd + 4));
}

// bf16 runs the tensor-core forward, f32 the CUDA-core one.
template <typename T, int HD>
int fwd(int stats, const void* q, const void* k, const void* v, void* o,
        void* lse, const long long* st, int B, int H, int KV, int S,
        int window, float scale, cudaStream_t s) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const size_t smem = tc_bytes(HD);
    if (stats)
      return launch(flash_fwd_tc_kernel<HD, true>, grid, smem, s,
                    (const T*)q, (const T*)k, (const T*)v, (T*)o,
                    (float*)lse, strides(st, 0), strides(st, 1),
                    strides(st, 2), strides(st, 3), H, KV, S, window, scale);
    return launch(flash_fwd_tc_kernel<HD, false>, grid, smem, s, (const T*)q,
                  (const T*)k, (const T*)v, (T*)o, (float*)lse,
                  strides(st, 0), strides(st, 1), strides(st, 2),
                  strides(st, 3), H, KV, S, window, scale);
  } else {
    const size_t smem = 2 * tile_bytes(HD) + score_bytes();
    if (stats)
      return launch(flash_fwd_kernel<T, HD, true>, grid, smem, s, (const T*)q,
                    (const T*)k, (const T*)v, (T*)o, (float*)lse,
                    strides(st, 0), strides(st, 1), strides(st, 2),
                    strides(st, 3), H, KV, S, window, scale);
    return launch(flash_fwd_kernel<T, HD, false>, grid, smem, s, (const T*)q,
                  (const T*)k, (const T*)v, (T*)o, (float*)lse,
                  strides(st, 0), strides(st, 1), strides(st, 2),
                  strides(st, 3), H, KV, S, window, scale);
  }
}

template <typename T, int HD>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, const long long* st,
           int B, int H, int KV, int S, int window, float scale,
           cudaStream_t s) {
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  const size_t smem = 3 * tile_bytes(HD) + score_bytes();
  return launch(flash_bwd_dq_kernel<T, HD>, grid, smem, s, (const T*)q,
                (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
                (const float*)delta, (T*)dq, strides(st, 0), strides(st, 1),
                strides(st, 2), strides(st, 3), strides(st, 4), H, KV, S,
                window, scale);
}

template <typename T, int HD>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv,
            const long long* st, int B, int H, int KV, int S, int window,
            float scale, cudaStream_t s) {
  const dim3 grid((S + BK - 1) / BK, KV, B);
  const size_t smem =
      4 * tile_bytes(HD) + 2 * score_bytes() + 2 * sizeof(float) * BQ;
  return launch(flash_bwd_dkv_kernel<T, HD>, grid, smem, s, (const T*)q,
                (const T*)k, (const T*)v, (const T*)dout, (const float*)lse,
                (const float*)delta, (T*)dk, (T*)dv, strides(st, 0),
                strides(st, 1), strides(st, 2), strides(st, 3),
                strides(st, 4), strides(st, 5), H, KV, S, window, scale);
}

// Calls F::run<T, HD>() for the (dtype, hd) pair; cudaErrorInvalidValue for
// one that has no instance (the wrapper refuses those first).
template <typename F, typename... Args>
int dispatch(int dtype, int hd, Args... args) {
  if (dtype == 0 && hd == 64) return F::template run<float, 64>(args...);
  if (dtype == 0 && hd == 128) return F::template run<float, 128>(args...);
  if (dtype == 1 && hd == 64)
    return F::template run<__nv_bfloat16, 64>(args...);
  if (dtype == 1 && hd == 128)
    return F::template run<__nv_bfloat16, 128>(args...);
  return (int)cudaErrorInvalidValue;
}

struct Fwd {
  template <typename T, int HD, typename... A>
  static int run(A... a) { return fwd<T, HD>(a...); }
};
struct BwdDq {
  template <typename T, int HD, typename... A>
  static int run(A... a) { return bwd_dq<T, HD>(a...); }
};
struct BwdDkv {
  template <typename T, int HD, typename... A>
  static int run(A... a) { return bwd_dkv<T, HD>(a...); }
};

}  // namespace

extern "C" const char* flash_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dO and the gradients share
// it); hd: 64 or 128; window <= 0: none.  `strides` holds (batch, head,
// sequence) element strides, three per tensor, in argument order.  Each
// returns cudaGetLastError() after its launch (0 when it was accepted).
extern "C" int flash_fwd_launch(int dtype, int hd, int stats, const void* q,
                                const void* k, const void* v, void* o,
                                void* lse, const long long* strides, int B,
                                int H, int KV, int S, int window, float scale,
                                void* stream) {
  if (B == 0 || S == 0) return 0;
  return dispatch<Fwd>(dtype, hd, stats, q, k, v, o, lse, strides, B, H, KV,
                       S, window, scale, (cudaStream_t)stream);
}

extern "C" int flash_bwd_dq_launch(int dtype, int hd, const void* q,
                                   const void* k, const void* v,
                                   const void* dout, const void* lse,
                                   const void* delta, void* dq,
                                   const long long* strides, int B, int H,
                                   int KV, int S, int window, float scale,
                                   void* stream) {
  if (B == 0 || S == 0) return 0;
  return dispatch<BwdDq>(dtype, hd, q, k, v, dout, lse, delta, dq, strides, B,
                         H, KV, S, window, scale, (cudaStream_t)stream);
}

extern "C" int flash_bwd_dkv_launch(int dtype, int hd, const void* q,
                                    const void* k, const void* v,
                                    const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv,
                                    const long long* strides, int B, int H,
                                    int KV, int S, int window, float scale,
                                    void* stream) {
  if (B == 0 || S == 0) return 0;
  return dispatch<BwdDkv>(dtype, hd, q, k, v, dout, lse, delta, dk, dv,
                          strides, B, H, KV, S, window, scale,
                          (cudaStream_t)stream);
}
