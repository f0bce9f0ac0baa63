// Causal GQA flash attention for Hopper (sm_90a): the forward, the forward
// that also writes the per-row log-sum-exp, and the FlashAttention-2
// backward (dQ, and dK/dV).
//
// Replaces the TPU kernels of src/repro/kernels/flash.py:
//   :55  `_flash_kernel`            -> flash_fwd_tc_kernel<HD, false> (bf16),
//                                      flash_fwd_kernel<float, HD, false>
//   :150 `_flash_fwd_stats_kernel`  -> the same with STATS = true
//   :196 `_flash_bwd_dq_kernel`     -> flash_bwd_dq_tc_kernel<HD> (bf16),
//                                      flash_bwd_dq_kernel<HD> (f32)
//   :239 `_flash_bwd_dkv_kernel`    -> flash_bwd_dkv_tc_kernel<HD> (bf16),
//                                      flash_bwd_dkv_kernel<HD> (f32)
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
// The blocks with the most tiles to walk are launched first.
//
// Block skipping.  This is why the kernels exist: a tile pair that is fully
// masked is never touched.  Causal: kv tile kt is needed by q tile qt iff its
// first key is at or before the tile's last query.  Window w (keys kp with
// qp - w < kp <= qp): iff also its last key is after the first query's
// window start.  The loops run from the first needed tile to the last.  The
// bf16 dK/dV up to hd 128 also skips a 32-query half of a q tile that none
// of its keys sees (its products would add exact zeros).
//
// The finite mask value.  Scores outside the mask are NEG_INF = -1e30, as in
// the reference.  A processed kv tile in which a row is fully masked (the
// window's edge) gives that row p = exp(0) = 1 while its running max is
// still NEG_INF; the first tile with a real score wipes that out through
// corr = exp(NEG_INF - m) = 0.  That needs the ascending tile order and the
// finite constant (-INFINITY would give inf - inf = NaN); every row's last
// processed tile holds its diagonal, so every row ends with a real score.
// The backward needs none of that: p = exp(s - lse) where kept, else 0.
//
// Numerics, as the reference: q.k products exact in f32 (bf16 products are
// exact in f32), scaled by 1/sqrt(hd) after the sum; m, l and the
// accumulator f32; in the forward p is rounded to v's dtype before p.V; l
// floored at 1e-30; output in q's dtype, lse = m + log(l) in f32.  The
// bf16 forward takes exp as exp2 of scores scaled by log2(e) (the f32 one
// calls expf): each p is within a few f32 ulps of the reference's, which
// moves its bf16 rounding only where p lies at a boundary.  At hd 192 the
// exp2 is the MUFU's alone (exp2_ftz): exp2f's value wherever that is a
// normal float, 0 where exp2f gives a subnormal (p < 2^-126).  The
// backward recomputes p = expf(s * scale - lse) under the mask (0 outside),
// dS = p (dP - delta) scale, all in f32, and multiplies p and dS, which the
// reference keeps in f32, into dV = P^T dO, dK = dS^T Q and dQ = dS K.  The
// bf16 backward does those three products on the tensor cores, which take
// bf16 operands, so it splits each f32 value x into hi = bf16(x) and
// lo = bf16(x - hi) and issues two products, hi then lo, into one f32
// accumulator.  x - hi is exact in f32, |x - hi| <= 2^-8 |x| and lo rounds
// it to 8 bits, so |hi + lo - x| <= 2^-16 |x|: far below the one bf16
// rounding (2^-8) of each output, where a single bf16 rounding of p and dS
// (FlashAttention-2's) would put 2^-8 on every term.  The other operands
// (q, k, v, dO) are bf16 and exact.  Products are summed in the tensor
// cores' order, not the reference's; the one exception, dP of a row with a
// single kept key, is explained at flash_bwd_dq_tc_kernel.
//
// Layout.  q, o, dO, dQ are (B, H, S, hd) and k, v, dK, dV (B, KV, S, hd)
// as strided views: the caller passes each tensor's (batch, head, sequence)
// strides, hd is contiguous.  So the model's (B, S, H, hd) activations go
// in without a transposed copy.  Query head h reads kv head h / G.  lse and
// delta are (B, H, S) f32, contiguous.  S need not be a multiple of the
// tile: rows past S are zero-filled and masked.  The bf16 kernels copy
// rows in 16-byte pieces, so they take only 16-byte aligned pointers and
// strides that are multiples of 8 elements (the wrapper ensures both).
//
// What bounds them.  Per causal (B, H, S, hd) call the forward does
// 2 B H S^2 hd flops and moves ~(2 H + 2 KV) B S hd elements, about 1300
// flops per byte at Qwen3's widths (2 x 4096 x 128; ~1800 at Nemotron-4
// 340B's hd 192); dQ recomputes S and dP and does three tile products,
// dK/dV four, on about 1.5-2x the forward's bytes.  All four are bound by
// operations, so, for bf16, by the tensor cores.  Head dims 64, 128 and
// 192 are built, every head dim of the configs in repro_torch/configs.
//   bf16, every tile product on the tensor cores as wgmma (m64nNk16, bf16
//     -> f32), a warpgroup on 64 rows.  Tiles stay bf16 in shared memory
//     in wgmma's 128-byte swizzled layout, filled by 16-byte cp.async
//     copies (rows past S zero-filled by a source size of 0; a proxy fence
//     hands them to wgmma) in a ring: the streamed operand (forward, dQ: K
//     and V per kv tile; dK/dV: Q, dO, lse and delta per (head, q tile))
//     loads the next tile while the block multiplies this one; the
//     resident operand (forward: Q; dQ: Q, dO; dK/dV: K, V) loads once.
//     A product whose A is formed in registers (P for P V; p, dS as hi +
//     lo for dV, dK, dQ) takes it straight from the accumulator it was
//     formed in: a warp's 16 accumulator rows are, two columns packed to a
//     register, exactly an A fragment, so nothing goes back through shared
//     memory.  B of those products (V; K for dQ; dO, Q for dV, dK) is read
//     from shared memory MN-major, the transposed mode, so one tile serves
//     both its K-major and its MN-major reads.  No wgmma sits under a
//     warpgroup-dependent branch: ptxas serializes every wgmma of a kernel
//     that has one (its C7520 note), so warpgroups that own different rows
//     or outputs run the same straight line of products.
//   bf16 forward: S = Q K^T, then the online softmax on the S accumulator
//     (in log2 units, exp2; the row max by quad shuffles, the row sums per
//     thread until the end), and P V with p rounded to bf16, pipelined one
//     kv tile deep through a three-stage ring (see flash_fwd_tc_kernel).
//     One warpgroup a block up to hd 128 (two blocks an SM).  At hd 192
//     a persistent block an SM, warp-specialised (flash_fwd_ws_kernel): a
//     producer warpgroup whose one thread copies the Q and the K and V
//     tiles by TMA into an mbarrier ring, and two consumer warpgroups of
//     64 rows each that take turns on the tensor cores, so that one's
//     softmax runs under the other's products.
//   bf16 backward: S = Q K^T and dP = dO V^T (dK/dV: S^T = K Q^T, dP^T =
//     V dO^T, so that P^T and dS^T come out with rows = keys, the rows of
//     dV and dK); p and dS split into bf16 hi and lo for the three later
//     products.  Up to hd 128 one warpgroup a block: dQ does a 64 x 64
//     tile a step, dK/dV a 64 x 32 half of one, so that the two f32
//     accumulators (hd/2 each a thread) fit beside S and dP.  At hd 192,
//     where one 64 x 192 f32 accumulator takes 96 registers a thread, two
//     warpgroups split every step and form each product once: one forms
//     S (S^T), the other dP (dP^T); they swap what the other needs through
//     16 KB of f32 in shared memory; dQ's warpgroups each add dS K over
//     half of the tile's keys into a partial dQ of their own (the two added
//     once at the end), dK/dV's add dV and dK over a whole 64-query tile.
//     The steps are pipelined one deep (the score product of step j + 1,
//     then the products of step j, and p and dS of step j + 1 on the CUDA
//     cores under them) through a three-stage ring.  Work a causal pair:
//     dQ 4 hd multiply-adds against the bound's 3 hd, dK/dV 6 hd against
//     4 hd, at every head dim (see the kernels).
//   Per instance, as ptxas and the card reported them on an H100
//   (chip_smoke.py prints them; registers, spills, shared bytes, blocks
//   per SM; the forward with lse within two registers of these; the
//   hd-192 forward's registers are ptxas's count at entry, its warpgroups
//   then set FWD_PRODUCER_REGS and FWD_CONSUMER_REGS):
//                    hd 64              hd 128              hd 192
//     forward   152 0 58,368 3     238 0 115,712 2     168 0 197,696 1
//     dQ        166 0 50,176 3     245 0  99,328 2     241 0 214,016 1
//     dK/dV     162 0 51,200 3     254 0 100,352 2     248 0 215,552 1
//   Registers bound every kernel to few warpgroups an SM; the tensor cores
//   idle while a warpgroup forms p (and dS).  In the forward, a
//   timing-only build with the copies, P V, exp and the barrier all taken
//   out kept most of a qwen3_attn call's time: the latency of each tile
//   step's S product and softmax, not one unit, holds it back.  In the
//   hd-192 forward each consumer's CUDA-core work a step (the row max,
//   the exps, O's rescale), about twice the other's products, holds it
//   back: a clock64 build saw its warps issue ~94 % of their cycles.
//   f32: every kernel on the CUDA cores (64 x 64 tiles, each thread a 4 x 4
//     register block of scores and a 4 x hd/16 block of the output, tiles
//     staged in f32 shared memory with a padded row so that the 16 threads
//     of a row group hit 16 banks).  The dK/dV at hd 192 (four (64, 193)
//     tiles and two score tiles) takes 231,424 of the 232,448 bytes a block
//     may use.
// Later work: the hd-192 forward's warp specialisation for hd 64 and 128
// and for the backward, larger kv tiles in the forward.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include "tile.cuh"

namespace {

using bf16 = __nv_bfloat16;

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
// dQ (row 11) for f32, on the CUDA cores: one block per (q tile, query head,
// batch)
// ------------------------------------------------------------------------- //
template <int HD>
__global__ void __launch_bounds__(NT)
    flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, float* __restrict__ dq,
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
  const float* kb = k + b * ks.b + kvh * ks.h;
  const float* vb = v + b * vs.b + kvh * vs.h;
  load_tile<float, HD>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_tile<float, HD>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, S);
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
    load_tile<float, HD>(KVs, vb, vs.s, k0, S);
    __syncthreads();
    float dp[4][4] = {};
    dot_block<HD>(dp, dOs, ty, KVs, tx);
    __syncthreads();                // V read
    load_tile<float, HD>(KVs, kb, ks.s, k0, S);
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
    float* dst = dq + b * dqs.b + h * dqs.h + (long long)r * dqs.s;
#pragma unroll
    for (int c = 0; c < NC; ++c) dst[tx + 16 * c] = acc[i][c];
  }
}

// ------------------------------------------------------------------------- //
// dK, dV (row 12) for f32, on the CUDA cores: one block per (kv tile, kv
// head, batch), summing over the G query heads of the kv head and over the q
// tiles that see the kv tile
// ------------------------------------------------------------------------- //
template <int HD>
__global__ void __launch_bounds__(NT)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         Strides qs, Strides ks, Strides vs, Strides dos,
                         Strides dks, Strides dvs, int H, int KV, int S,
                         int window, float scale) {
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
  load_tile<float, HD>(Ks, k + b * ks.b + kvh * ks.h, ks.s, k0, S);
  load_tile<float, HD>(Vs, v + b * vs.b + kvh * vs.h, vs.s, k0, S);
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
      load_tile<float, HD>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
      load_tile<float, HD>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, S);
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
    float* kd = dk + b * dks.b + kvh * dks.h + (long long)r * dks.s;
    float* vd = dv + b * dvs.b + kvh * dvs.h + (long long)r * dvs.s;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      kd[tx + 16 * c] = dk_acc[i][c];
      vd[tx + 16 * c] = dv_acc[i][c];
    }
  }
}

// ------------------------------------------------------------------------- //
// bf16 on the tensor cores (rows 9-12): wgmma products, a cp.async ring
// (see the note at the top).  A block is one or more warpgroups; warp w of
// a warpgroup holds rows 16 w .. 16 w + 16 of its 64-row products.  Accumulator
// layout of wgmma.m64nNk16 (g = lane / 4, t = lane % 4): element 4 j + e of
// a thread is (row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2).  The A
// operand from registers is a warp's 16 rows as an mma.m16n8k16 A fragment:
// (g, 2t..2t+1), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..).  So the
// accumulator elements 8 s .. 8 s + 8 are, pairwise packed, the A operand of
// the k16 step s over the accumulator's columns.
// ------------------------------------------------------------------------- //
constexpr int NTC = 128;        // one warpgroup
constexpr int STAGES = 2;       // depth of the streamed operands' ring
static_assert(NTC == 2 * BQ, "one thread per lse or delta row of a tile");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zeros where !ok (no bytes are
// read, src need only be a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's copy groups are in flight, then
// make what arrived visible to wgmma (which reads through the async proxy)
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A (64, HD) bf16 tile in the 128-byte swizzled layout that wgmma reads: HD
// / 64 column blocks of 64 rows of 128 bytes, 8 KB each; the 16-byte piece
// c of row r of a block sits at piece c ^ (r % 8).  Element offset of
// (r, c):
__device__ __forceinline__ int swz(int r, int c) {
  return (c >> 6) * (BQ * 64) + r * 64 + ((((c >> 3) & 7) ^ (r & 7)) << 3) +
         (c & 7);
}

// rows [row0, row0 + 64) of one (S, HD) bf16 head into a swizzled tile, by
// the block's NTH threads; rows at or past S are zero
template <int HD, int NTH = NTC>
__device__ __forceinline__ void load_tile_async(bf16* dst,
                                                const bf16* __restrict__ src,
                                                long long ss, int row0,
                                                int S) {
  constexpr int CPR = HD / 8;                 // 16-byte pieces a row
  static_assert(BQ * CPR % NTH == 0, "whole pieces a thread");
#pragma unroll
  for (int j = 0; j < BQ * CPR / NTH; ++j) {
    const int i = threadIdx.x + j * NTH;
    const int r = i / CPR, c = (i % CPR) * 8;
    const bool ok = row0 + r < S;
    cp_async16(dst + swz(r, c), ok ? src + (long long)(row0 + r) * ss + c : src,
               ok);
  }
}

// lse then delta rows [q0, q0 + 64) of one head (from its row0) into
// (2, 64) f32, by the block's first 128 threads; rows at or past S are zero
__device__ __forceinline__ void load_stats_async(float* dst,
                                                 const float* __restrict__ lse,
                                                 const float* __restrict__ delta,
                                                 long long row0, int q0,
                                                 int S) {
  if (threadIdx.x >= NTC) return;
  const int r = threadIdx.x & (BQ - 1);
  const float* src = threadIdx.x < BQ ? lse : delta;
  const bool ok = q0 + r < S;
  cp_async4(dst + threadIdx.x, ok ? src + row0 + q0 + r : src, ok);
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets, 128-byte swizzle
__device__ __forceinline__ uint64_t gmma_desc(const bf16* p, unsigned lbo,
                                              unsigned sbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}
// K-major operand: rows [r0, r0 + N) of a swizzled tile (r0 a multiple of
// 8), columns [16 s, 16 s + 16); 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k(const bf16* tile, int r0, int s) {
  return gmma_desc(tile + (s >> 2) * (BQ * 64) + r0 * 64 + (s & 3) * 16, 16,
                   1024);
}
// MN-major operand, the B of a product summed over the tile's rows: rows
// [16 s, 16 s + 16) as K, the columns as N; 8-row groups 1024 bytes apart,
// 64-column blocks 8 KB apart
__device__ __forceinline__ uint64_t desc_mn(const bf16* tile, int s) {
  return gmma_desc(tile + s * 16 * 64, BQ * 64 * 2, 1024);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads or writes of accumulators across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(unsigned (&r)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// d (64 x 32 f32, 16 a thread) = (accumulate ? d : 0) + A B^T, A (64 x 16)
// and B (32 x 16) K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15 "
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32, 32 a thread) = (accumulate ? d : 0) + A B^T, A (64 x 16)
// and B (64 x 16) K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32, 32 a thread) = (accumulate ? d : 0) + A B^T, A (64 x 16)
// from registers (a warp's 16 rows as an mma.m16n8k16 A fragment), B (64 x
// 16) K-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64_k(float (&d)[32],
                                               const unsigned (&a)[4],
                                               uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (64 x 64 f32) += A B, A (64 x 16) from registers (a warp's 16 rows as
// an mma.m16n8k16 A fragment), B (16 x 64) MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const unsigned (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128 f32) += A B, A (64 x 16) from registers (a warp's 16 rows as
// an mma.m16n8k16 A fragment), B (16 x 128) MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const unsigned (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 192 f32) += A B, A (64 x 16) from registers (a warp's 16 rows as
// an mma.m16n8k16 A fragment), B (16 x 192) MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n192(float (&d)[96],
                                             const unsigned (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95 "
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


// d (64 x N) += A B over one k16 step, B the MN-major rows [16 s, 16 s +
// 16) of a tile's first N columns
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const unsigned (&a)[4],
                                         const bf16* tile, int s) {
  static_assert(N == 64 || N == 128 || N == 192, "an instantiated width");
  if constexpr (N == 192)
    wgmma_rs_n192(d, a, desc_mn(tile, s));
  else if constexpr (N == 128)
    wgmma_rs_n128(d, a, desc_mn(tile, s));
  else
    wgmma_rs_n64(d, a, desc_mn(tile, s));
}

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<unsigned*>(&v);
}

// The A operand of a k16 step from 8 accumulator elements c[0..8), split
// as hi = bf16(x), lo = bf16(x - hi): |hi + lo - x| <= 2^-16 |x|.
__device__ __forceinline__ void split_a(const float* c, unsigned (&hi)[4],
                                        unsigned (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(c[2 * i], c[2 * i + 1]);
    const float2 hf = __bfloat1622float2(h);
    hi[i] = bf16x2_bits(h);
    lo[i] = bf16x2_bits(
        __floats2bfloat162_rn(c[2 * i] - hf.x, c[2 * i + 1] - hf.y));
  }
}

// row ra of swizzled tile A . row rb of swizzled tile B over HD, as one
// ascending f32 FMA chain
template <int HD>
__device__ __forceinline__ float dot_ascending(const bf16* A, int ra,
                                            const bf16* B, int rb) {
  float acc = 0.0f;
  for (int d = 0; d < HD; ++d)
    acc = fmaf(__bfloat162float(A[swz(ra, d)]), __bfloat162float(B[swz(rb, d)]),
               acc);
  return acc;
}

// accumulator elements v[0..4) (rows r, r + 8; cols c, c + 1) rounded to
// bf16 into a row-major (rows, stride ss) output; rows at or past S are
// skipped
__device__ __forceinline__ void store_c(bf16* out, long long ss, int r, int c,
                                        const float* v, int S) {
  if (r < S)
    *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * ss + c) =
        __floats2bfloat162_rn(v[0], v[1]);
  if (r + 8 < S)
    *reinterpret_cast<__nv_bfloat162*>(out + (long long)(r + 8) * ss + c) =
        __floats2bfloat162_rn(v[2], v[3]);
}

// The dynamic shared memory of a block, its start rounded up to the 1024
// bytes the swizzled tiles need (the launch asks for 1 KB more)
__device__ __forceinline__ unsigned char* smem_1k(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// The bf16 forward (rows 9 and 10): one block of fwd_wgs(HD) warpgroups
// per (64 query rows a warpgroup, query head, batch), all sharing one ring
// of FSTAGES K/V stages, walking the kv tiles in ascending order.  Per
// warpgroup and kv tile j: S = Q K_j^T (64 x 64, A and B from shared
// memory); the online softmax on the S accumulator in registers (the row
// max over a quad by two shuffles, each thread's share of the row sum kept
// apart until the end); p rounded to bf16 and packed as the A operand of
// P V, V read MN-major: nothing goes back through shared memory between
// the two products.  The products are pipelined one tile deep: in step j
// O is rescaled by tile j-1's correction and P_{j-1} packed, S_j formed
// and its row max taken, then O += P_{j-1} V_{j-1} issued, and the exps of
// tile j run while the tensor cores do it.  Tile j's K and tile j-1's V are both read in
// step j, so tile j+1 is copied into the third stage, from the start of
// step j (after the one barrier a step, which every warpgroup passes only
// once done with step j-1).  Every warpgroup walks all of the block's kv
// tiles (the union of its warpgroups' own) and masks only the tiles that
// cross its rows' diagonal or window edge.  Blocks are ordered by q tile,
// most kv tiles first, across every head.  This body runs hd 64 and 128,
// one warpgroup a block; hd 192 runs flash_fwd_ws_kernel, whose two
// consumer warpgroups (a 64 x 192 f32 O is 96 registers a thread) run the
// same per-row arithmetic.
// fwd_wgs: the warpgroups a block that own 64 query rows each;
// fwd_ws: whether the block is warp-specialised, with a producer
// warpgroup besides them.
__host__ __device__ constexpr int fwd_wgs(int hd) { return hd > 128 ? 2 : 1; }
__host__ __device__ constexpr bool fwd_ws(int hd) { return hd > 128; }
__host__ __device__ constexpr int fwd_threads(int hd) {
  return NTC * (fwd_wgs(hd) + (fwd_ws(hd) ? 1 : 0));
}
constexpr int FSTAGES = 3;          // K/V stages of the forward's ring
constexpr float LOG2E = 1.4426950408889634f;

// The online softmax of one 64 x 64 score tile (s, the S accumulator) for
// rows qr[0], qr[1] of a thread, in log2 units, in two halves.  row_max:
// scale by scale * log2(e) (sl) and mask (mask: the tile crosses a row's
// diagonal or window edge; scale_scores), update the running max m (over
// the row's quad by two shuffles) and set corr = 2^(m_old - m_new)
// (quad_max).  row_exp: p = 2^(s - m) into s, and the thread's share of
// the row sums into l (reduced over the quad once, at the end).  A masked
// score is NEG_INF in these units too, so a row with no kept key in the
// tile gets p = 1 until a kept key's correction (0) wipes it, as in the
// reference.  Masking a tile that crosses none of the rows keeps every
// score, so MASK may be set for more tiles than need it.
// 2^x by the MUFU alone: exp2f's value wherever 2^x is a normal float (x
// >= -126); 0 where exp2f gives a subnormal.  exp2f adds a test and two
// predicated products a call for those.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool MASK>
__device__ __forceinline__ void scale_scores(float (&s)[32], const int (&qr)[2],
                                             int k0, int t, int window,
                                             float sl) {
  // selects, not branches, per element (short-circuit tests here compiled
  // to a branch region per element)
  if constexpr (MASK) {
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x >> 1) & 1, kp = k0 + 8 * (x >> 2) + 2 * t + (x & 1);
      const bool kept = (kp <= qr[i]) & ((window <= 0) | (kp > qr[i] - window));
      s[x] = kept ? s[x] * sl : NEG_INF;
    }
  } else {
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] *= sl;
  }
}

// The running max of row_max, its thread's 16 scores a row taken as a tree
// (a maximum is exact, so its order does not matter: four dependent steps
// instead of sixteen), and corr by exp2_ftz.
__device__ __forceinline__ void quad_max(const float (&s)[32], float (&m)[2],
                                         float (&corr)[2]) {
  float mx[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {     // row i: elements 4 j + 2 i + e
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]);
#pragma unroll
    for (int w = 4; w > 0; w >>= 1)
#pragma unroll
      for (int j = 0; j < w; ++j) v[j] = fmaxf(v[j], v[j + w]);
    mx[i] = fmaxf(NEG_INF, v[0]);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {     // a row's four threads are one quad
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    corr[i] = exp2_ftz(m[i] - m_new);
    m[i] = m_new;
  }
}

// row_max, for hd 64 and 128: the mask chosen at run time (one branch for
// the tile), the maxima in one chain and corr by exp2f, as that forward
// was compiled (splitting it gave ptxas other register counts there).  The
// hd-192 forward calls scale_scores and quad_max.
__device__ __forceinline__ void row_max(float (&s)[32], float (&m)[2],
                                        float (&corr)[2], const int (&qr)[2],
                                        int k0, int t, bool mask, int window,
                                        float sl) {
  if (mask) {
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x >> 1) & 1, kp = k0 + 8 * (x >> 2) + 2 * t + (x & 1);
      const bool kept = (kp <= qr[i]) & ((window <= 0) | (kp > qr[i] - window));
      s[x] = kept ? s[x] * sl : NEG_INF;
    }
  } else {
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] *= sl;
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int x = 0; x < 32; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {     // a row's four threads are one quad
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    corr[i] = exp2f(m[i] - m_new);
    m[i] = m_new;
  }
}

template <bool FTZ = false>
__device__ __forceinline__ void row_exp(float (&s)[32], const float (&m)[2],
                                        float (&l)[2],
                                        const float (&corr)[2]) {
  float sum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    const int i = (x >> 1) & 1;
    s[x] = FTZ ? exp2_ftz(s[x] - m[i]) : exp2f(s[x] - m[i]);
    sum[i] += s[x];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
}

template <int HD, bool STATS>
__global__ void __launch_bounds__(NTC * fwd_wgs(HD))
    flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, Strides qs, Strides ks,
                        Strides vs, Strides os, int H, int KV, int S,
                        int window, float scale) {
  constexpr int TILE = BQ * HD, FWG = fwd_wgs(HD);
  constexpr int NTH = NTC * FWG, BQF = BQ * FWG;
  static_assert(!fwd_ws(HD), "hd 192 runs flash_fwd_ws_kernel");
  extern __shared__ unsigned char smem_fwd[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_1k(smem_fwd));  // warpgroup w's at w TILE
  bf16* ring = Qs + FWG * TILE;     // stage st: K at 2 st TILE, V after it

  const int nq = (S + BQF - 1) / BQF;
  const int hb = gridDim.x / nq;    // (head, batch) pairs
  const int qt = nq - 1 - (int)blockIdx.x / hb;   // most kv tiles first
  const int h = (int)blockIdx.x % hb % H, b = (int)blockIdx.x % hb / H;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQF;
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, t = lane & 3;
  const int r0 = q0 + BQ * wg;      // the warpgroup's first row
  const bf16* qb = q + b * qs.b + h * qs.h;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  const int kt_first = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int kt_last = (min(q0 + BQF, S) - 1) / BK;
  const int nkt = kt_last - kt_first + 1;
  const float sl = scale * LOG2E;
  auto load_kv = [&](int it) {      // kv tile kt_first + it into its stage
    bf16* dst = ring + 2 * (it % FSTAGES) * TILE;
    const int k0 = (kt_first + it) * BK;
    load_tile_async<HD, NTH>(dst, kb, ks.s, k0, S);
    load_tile_async<HD, NTH>(dst + TILE, vb, vs.s, k0, S);
  };

#pragma unroll
  for (int w = 0; w < FWG; ++w)
    load_tile_async<HD, NTH>(Qs + w * TILE, qb, qs.s, q0 + BQ * w, S);
  load_kv(0);
  cp_async_commit();

  const bf16* Qw = Qs + wg * TILE;
  const int qr[2] = {r0 + 16 * warp + (lane >> 2), r0 + 16 * warp + (lane >> 2) + 8};
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  unsigned pa[BK / 16][4];          // the last tile's p in bf16: the A of P V
  float corr[2];
  // the row max of kv tile it's scores s (masked where the tile crosses a
  // row's diagonal or window edge)
  auto softmax_max = [&](float (&s)[32], int it) {
    const int k0 = (kt_first + it) * BK;
    row_max(s, m, corr, qr, k0, t,
            k0 + BK - 1 > r0 || (window > 0 && k0 <= r0 + BQ - 1 - window),
            window, sl);
  };
  // O rescaled by a tile's correction and its p rounded to bf16 into pa
  auto rescale_and_pack = [&](const float (&s)[32]) {
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) acc[x] *= corr[(x >> 1) & 1];
#pragma unroll
    for (int st = 0; st < BK / 16; ++st)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[st][i] = bf16x2_bits(__floats2bfloat162_rn(s[8 * st + 2 * i],
                                                      s[8 * st + 2 * i + 1]));
  };

  // Every warpgroup walks every kv tile of the block, so that each product
  // sequence is one straight line (wgmma under a warpgroup-dependent branch
  // is serialized by ptxas): a tile none of a warpgroup's rows sees is
  // masked whole and adds exact zeros, or, before the rows' first seen
  // tile, a sum that that tile's correction (0) wipes out, as the plain
  // version's masked chunks do.
  float s[32];                      // S, then p, of the current tile
  {                                 // tile 0: S only
    cp_async_wait<0>();
    __syncthreads();
    if (nkt > 1) load_kv(1);
    cp_async_commit();
    wg_fence();
#pragma unroll
    for (int d = 0; d < HD / 16; ++d)
      wgmma_ss_n64(s, desc_k(Qw, 0, d), desc_k(ring, 0, d), d);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    softmax_max(s, 0);
    row_exp(s, m, l, corr);
  }
  // Step it: O rescaled by tile it - 1's correction and that tile's p
  // packed, while no product is in flight; S_it, its row max; then O +=
  // P_{it-1} V_{it-1} issued and the exps of tile it run while it is on the
  // tensor cores.  The row max comes first: placed after the P V issue,
  // with its shuffles, it had ptxas put the P V wait ahead of every exp (in
  // the SASS of each such order tried); this way some of the exps are
  // scheduled under P V.
  for (int it = 1; it < nkt; ++it) {
    cp_async_wait<0>();             // tile it's copies are done
    __syncthreads();                // and everyone's, and step it - 1
    if (it + 1 < nkt) load_kv(it + 1);   // into tile it - 2's stage
    cp_async_commit();
    const bf16* Ks = ring + 2 * (it % FSTAGES) * TILE;
    const bf16* Vprev = ring + (2 * ((it - 1) % FSTAGES) + 1) * TILE;
    rescale_and_pack(s);
    wg_fence();
#pragma unroll
    for (int d = 0; d < HD / 16; ++d)
      wgmma_ss_n64(s, desc_k(Qw, 0, d), desc_k(Ks, 0, d), d);
    wg_commit();
    wg_wait<0>();                   // S is in
    fence_regs(s);
    softmax_max(s, it);
    wg_fence();
#pragma unroll                      // O += P V of tile it - 1
    for (int st = 0; st < BK / 16; ++st) wgmma_rs<HD>(acc, pa[st], Vprev, st);
    wg_commit();
    row_exp(s, m, l, corr);         // under P V
    fence_regs(s);
    wg_wait<0>();                   // P V is in
    fence_regs(acc);
  }
  {                                 // the last tile's P V
    const bf16* Vlast = ring + (2 * ((nkt - 1) % FSTAGES) + 1) * TILE;
    rescale_and_pack(s);
    wg_fence();
#pragma unroll
    for (int st = 0; st < BK / 16; ++st) wgmma_rs<HD>(acc, pa[st], Vlast, st);
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
  }

  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {     // the row sums over the quad
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    den[i] = fmaxf(l[i], 1e-30f);
  }
  bf16* out = o + b * os.b + h * os.h;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const float vals[4] = {acc[4 * n] / den[0], acc[4 * n + 1] / den[0],
                           acc[4 * n + 2] / den[1], acc[4 * n + 3] / den[1]};
    store_c(out, os.s, qr[0], 8 * n + 2 * t, vals, S);
  }
  if (STATS && t == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (qr[i] < S)
        lse[((long long)b * H + h) * S + qr[i]] = m[i] / LOG2E + logf(den[i]);
}

// Registers a thread of the hd-192 forward's producer warpgroup and of each
// of its consumer warpgroups after setmaxnreg: 128 x 24 + 256 x 240 =
// 64,512 of the SM's 65,536 (kernels/flash.py names the same two).
constexpr int FWD_PRODUCER_REGS = 24;
constexpr int FWD_CONSUMER_REGS = 240;
static_assert(NTC * FWD_PRODUCER_REGS + 2 * NTC * FWD_CONSUMER_REGS <= 65536,
              "the register file of an SM");

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
// one arrival that also adds bytes the barrier's phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// wait until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One (64 columns, 64 rows) box of a (hd, S, heads, batch) bf16 tensor map
// into 8 KB of shared memory, completing on bar.  With the map's 128-byte
// swizzle and a 1 KB aligned destination, the box lands in the layout of
// swz: row r's 16-byte piece c at piece c ^ (r % 8).  Rows at or past S
// arrive as zeros.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int col, int row,
                                        int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row), "r"(head), "r"(batch)
      : "memory");
}
// rows [row0, row0 + 64) of one head into a (64, HD) swizzled tile: HD / 64
// boxes, one a column block
template <int HD>
__device__ __forceinline__ void tma_tile(bf16* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row0, int head,
                                         int batch) {
#pragma unroll
  for (int cb = 0; cb < HD / 64; ++cb)
    tma_box(dst + cb * BQ * 64, map, bar, 64 * cb, row0, head, batch);
}

// The bf16 forward at hd 192 (rows 9b and 10b), warp-specialised and
// persistent: a block of three warpgroups on each SM walks its share of
// the work items, (128 query rows, query head, batch) each, taken in
// flash_fwd_tc_kernel's order (most kv tiles first, across every head)
// and dealt to the blocks in rounds, back and forth (block c takes item
// r G + c in even rounds r and r G + G - 1 - c in odd ones, G blocks), so
// that every block gets about the same number of tiles.
//   Warpgroup 0, the producer, drops to FWD_PRODUCER_REGS registers; one
//   of its threads copies, item after item, the two 64-row Q tiles (once
//   the consumers have Q in registers: the "qempty" mbarrier) and then,
//   tile after tile, K and V by TMA into a ring of FSTAGES stages, each
//   with a "full" mbarrier (the copies' bytes) and an "empty" one (a
//   consumer warp's arrival each once it no longer reads the stage).  So
//   the next item's Q and first tiles load while the consumers finish an
//   item.
//   Warpgroups 1 and 2, the consumers, rise to FWD_CONSUMER_REGS and own
//   an item's query rows [q0, q0 + 64) and [q0 + 64, q0 + 128).  Each
//   runs flash_fwd_tc_kernel's per-row arithmetic in its order (the scaled
//   and masked scores, the running max, corr, the exps and the thread's
//   row sums, O rescaled by the last tile's correction before P V, P V in
//   ascending tile order into one f32 accumulator, the row sums reduced at
//   the end), pipelined one kv tile deep: step j issues S_j = Q K_j^T (Q
//   from registers), then O += P_{j-1} V_{j-1}, and forms the row max and
//   the exps of S_j while P V runs.  Three savings keep its values: the
//   max as a tree (exact in any order), the exp2s by the MUFU alone
//   (exp2_ftz), and O's rescale skipped where every row of a warp has
//   corr 1 (a product by 1 leaves O as it is).
//   The turns: a consumer issues a step's products only in its
//   turn, handed over by two named barriers of 256 threads, so that the
//   tensor cores run one consumer's products while the other forms its
//   softmax on the CUDA cores.  Both walk every kv tile of an item (the
//   union; consumer 0's last is masked whole, as in flash_fwd_tc_kernel),
//   so each takes nkt + 1 turns an item; consumer 1 opens consumer 0's
//   first turn and skips the hand-over after its very last, so every
//   barrier's arrivals match its waits.
// The warpgroup index is broadcast from lane 0 so that ptxas sees the role
// branch uniform: a warpgroup-dependent branch around wgmma serializes
// every product of the kernel.
template <int HD, bool STATS>
__global__ void __launch_bounds__(fwd_threads(HD), 1)
    flash_fwd_ws_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        bf16* __restrict__ o, float* __restrict__ lse,
                        Strides os, int B, int H, int KV, int S, int window,
                        float scale) {
  constexpr int TILE = BQ * HD, CW = fwd_wgs(HD), BQF = BQ * CW;
  constexpr unsigned TILE_BYTES = sizeof(bf16) * TILE;
  static_assert(fwd_ws(HD) && CW == 2, "two consumers take turns");
  extern __shared__ unsigned char smem_fwd[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_1k(smem_fwd));  // consumer c's at c TILE
  bf16* ring = Qs + CW * TILE;      // stage st: K at 2 st TILE, V after it
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + 2 * FSTAGES * TILE);
  uint64_t* empty = full + FSTAGES;
  uint64_t* qfull = empty + FSTAGES;
  uint64_t* qempty = qfull + 1;

  const int nq = (S + BQF - 1) / BQF, hb = H * B, items = nq * hb;
  const int G = gridDim.x, blk = blockIdx.x;
  // the block's item of round r (at or past items: none)
  auto item_of = [&](int r) { return r * G + (r & 1 ? G - 1 - blk : blk); };
  // an item's first row, head, batch and kv tiles
  struct Item {
    int q0, h, b, kt_first, nkt;
  };
  auto item = [&](int i) {
    Item it;
    it.q0 = (nq - 1 - i / hb) * BQF;  // most kv tiles first
    it.h = i % hb % H;
    it.b = i % hb / H;
    it.kt_first = window > 0 ? max(0, it.q0 - window + 1) / BK : 0;
    it.nkt = (min(it.q0 + BQF, S) - 1) / BK - it.kt_first + 1;
    return it;
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < FSTAGES; ++st) {
      mbar_init(full + st, 1);
      mbar_init(empty + st, 4 * CW);
    }
    mbar_init(qfull, 1);
    mbar_init(qempty, 4 * CW);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);   // uniform
  if (wg == 0) {                    // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(FWD_PRODUCER_REGS));
    if (threadIdx.x == 0) {
      int g = 0;                    // tiles copied so far
      for (int r = 0; item_of(r) < items; ++r) {
        const Item w = item(item_of(r));
        const int kvh = w.h / (H / KV);
        if (r > 0) mbar_wait(qempty, (r - 1) & 1);
        mbar_expect_tx(qfull, CW * TILE_BYTES);
        for (int c = 0; c < CW; ++c)
          tma_tile<HD>(Qs + c * TILE, &tq, qfull, w.q0 + BQ * c, w.h, w.b);
        for (int it = 0; it < w.nkt; ++it, ++g) {
          const int st = g % FSTAGES, k0 = (w.kt_first + it) * BK;
          if (g >= FSTAGES) mbar_wait(empty + st, (g / FSTAGES - 1) & 1);
          mbar_expect_tx(full + st, 2 * TILE_BYTES);
          tma_tile<HD>(ring + 2 * st * TILE, &tk, full + st, k0, kvh, w.b);
          tma_tile<HD>(ring + (2 * st + 1) * TILE, &tv, full + st, k0, kvh, w.b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(FWD_CONSUMER_REGS));

  const int c = wg - 1;             // the consumer
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g4 = lane >> 2, t = lane & 3;
  const float sl = scale * LOG2E;
  // the turns: consumer c's products wait on named barrier 1 + c, which the
  // other consumer's hand-over completes (barrier 0 is __syncthreads')
  auto take_turn = [&]() {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + c), "n"(2 * NTC) : "memory");
  };
  auto pass_turn = [&]() {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(2 - c), "n"(2 * NTC) : "memory");
  };

  float m[2], l[2], corr[2];
  float acc[HD / 2];
  unsigned pa[BK / 16][4];          // the last tile's p in bf16: the A of P V
  unsigned qa[HD / 16][4];          // Q: the A of S, the k16 step d of the
                                    // warp's 16 rows (see the note above wgmma_rs)
  float s[32];                      // S, then p, of the current tile
  // O rescaled by a tile's correction (skipped where every row of the warp
  // has corr 1, which leaves O as it is) and its p rounded to bf16 into
  // pa, both held before the products' fence (else nvcc sinks them past it
  // and ptxas injects another)
  auto rescale_and_pack = [&]() {
    if (!__all_sync(0xffffffffu, (corr[0] == 1.0f) & (corr[1] == 1.0f)))
#pragma unroll
      for (int x = 0; x < HD / 2; ++x) acc[x] *= corr[(x >> 1) & 1];
#pragma unroll
    for (int st = 0; st < BK / 16; ++st)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[st][i] = bf16x2_bits(__floats2bfloat162_rn(s[8 * st + 2 * i],
                                                      s[8 * st + 2 * i + 1]));
    fence_regs(acc);
    fence_regs(pa);
  };
  // S of the tile in stage Ks into s, issued (after a wg_fence)
  auto score = [&](const bf16* Ks) {
#pragma unroll
    for (int d = 0; d < HD / 16; ++d)
      wgmma_rs_n64_k(s, qa[d], desc_k(Ks, 0, d), d);
    wg_commit();
  };

  if (c == 1) pass_turn();          // consumer 0 takes the first turn
  int g = 0;                        // tiles of the ring read so far
  for (int r = 0; item_of(r) < items; ++r) {
    const Item w = item(item_of(r));
    const bool last_item = item_of(r + 1) >= items;
    const int r0 = w.q0 + BQ * c;   // the consumer's first row
    const int qr[2] = {r0 + 16 * warp + g4, r0 + 16 * warp + g4 + 8};
    // whether kv tile it crosses the diagonal or the window edge of a row
    // of the item (of either consumer): one test for both, so that the
    // loop's control flow is the item's
    auto crosses = [&](int it) {
      const int k0 = (w.kt_first + it) * BK;
      return k0 + BK - 1 > w.q0 || (window > 0 && k0 <= w.q0 + BQF - 1 - window);
    };
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = NEG_INF;
      l[i] = 0.0f;
    }
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;

    mbar_wait(qfull, r & 1);
    {
      const bf16* Qw = Qs + c * TILE;
#pragma unroll
      for (int d = 0; d < HD / 16; ++d)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          qa[d][i] = *reinterpret_cast<const unsigned*>(
              Qw + swz(16 * warp + g4 + 8 * (i & 1), 16 * d + 2 * t + 8 * (i >> 1)));
    }
    __syncwarp();                   // the warp's reads of Q are done:
    if (lane == 0) mbar_arrive(qempty);   // the next item's Q may come in

    {                               // tile 0: S only
      const int st = g % FSTAGES;
      mbar_wait(full + st, (g / FSTAGES) & 1);
      take_turn();
      wg_fence();
      score(ring + 2 * st * TILE);
      pass_turn();
      wg_wait<0>();
      fence_regs(s);
      if (crosses(0))
        scale_scores<true>(s, qr, w.kt_first * BK, t, window, sl);
      else
        scale_scores<false>(s, qr, w.kt_first * BK, t, window, sl);
      quad_max(s, m, corr);
      row_exp<true>(s, m, l, corr);
    }
    // Step it: O rescaled by tile it - 1's correction and its p packed; in
    // the turn, S_it and then O += P_{it-1} V_{it-1} issued; the row max
    // and the exps of tile it while P V runs; tile it - 1's stage
    // released.  A step is compiled twice, masked and not, so that no
    // branch sits between the issue of P V and its wait (ptxas put the
    // wait at a branch's join, ahead of the shuffles and the exps).
    auto step = [&](int it, auto masked) {
      const int st = (g + it) % FSTAGES, sp = (g + it - 1) % FSTAGES;
      rescale_and_pack();
      mbar_wait(full + st, ((g + it) / FSTAGES) & 1);
      take_turn();
      wg_fence();
      score(ring + 2 * st * TILE);
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
        wgmma_rs<HD>(acc, pa[k], ring + (2 * sp + 1) * TILE, k);
      wg_commit();
      pass_turn();
      wg_wait<1>();                 // S is in
      fence_regs(s);
      scale_scores<decltype(masked)::value>(s, qr, (w.kt_first + it) * BK, t,
                                            window, sl);
      quad_max(s, m, corr);
      row_exp<true>(s, m, l, corr); // under P V
      fence_regs(s);
      wg_wait<0>();                 // P V is in
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + sp);
    };
    for (int it = 1; it < w.nkt; ++it) {
      if (crosses(it))
        step(it, std::true_type{});
      else
        step(it, std::false_type{});
    }
    {                               // the last tile's P V
      const int sp = (g + w.nkt - 1) % FSTAGES;
      rescale_and_pack();
      take_turn();
      wg_fence();
#pragma unroll
      for (int k = 0; k < BK / 16; ++k)
        wgmma_rs<HD>(acc, pa[k], ring + (2 * sp + 1) * TILE, k);
      wg_commit();
      if (c == 0 || !last_item) pass_turn();   // consumer 1's very last: none
      wg_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty + sp);
    }
    g += w.nkt;

    float den[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {   // the row sums over the quad
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      den[i] = fmaxf(l[i], 1e-30f);
    }
    bf16* out = o + w.b * os.b + w.h * os.h;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const float vals[4] = {acc[4 * n] / den[0], acc[4 * n + 1] / den[0],
                             acc[4 * n + 2] / den[1], acc[4 * n + 3] / den[1]};
      store_c(out, os.s, qr[0], 8 * n + 2 * t, vals, S);
    }
    if (STATS && t == 0)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (qr[i] < S)
          lse[((long long)w.b * H + w.h) * S + qr[i]] = m[i] / LOG2E + logf(den[i]);
  }
}

// Warpgroups of a bf16 backward block (dQ and dK/dV): one up to hd 128; at
// hd 192, where a 64 x 192 f32 accumulator (96 registers a thread) leaves
// no room beside the score products and the hi and lo operands, two that
// split each tile's products between them (see the hd-192 bodies).
__host__ __device__ constexpr int bwd_wgs(int hd) { return hd > 128 ? 2 : 1; }
constexpr int WSTAGES = 3;          // the streamed tiles' ring at hd 192
__host__ __device__ constexpr int bwd_stages(int hd) {
  return bwd_wgs(hd) > 1 ? WSTAGES : STAGES;
}

// dQ for bf16 up to hd 128: one block of one warpgroup per (q tile, query
// head, batch), walking the kv tiles: S = Q K^T and dP = dO V^T (64 x 64,
// A and B from shared memory), dS, then dQ += dS K (A = dS hi and lo from
// registers, B = K MN-major).  Work a causal (query, key) pair, in
// multiply-adds: hd (S) + hd (dP) + 2 hd (dQ, hi and lo) = 4 hd, against
// the bound's 3 hd.
//
// Rows with one kept key (the first query; every row under a one-key
// window) have dS = p (dP - delta) scale = 0 in exact arithmetic: their dq
// is the rounding residue of dP - delta alone, and the element-wise check,
// which scales each row by its own largest entry, holds a row of residues to
// the bits.  The plain version's f32 product sums dP as one ascending FMA
// chain over hd; the tensor cores sum in another order.  So for such a row
// the kernel forms dP with that chain on the CUDA cores (one dot product of
// hd a row).
template <int HD>
__device__ __forceinline__ void dq_tc(const bf16* __restrict__ q,
                                      const bf16* __restrict__ k,
                                      const bf16* __restrict__ v,
                                      const bf16* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ delta,
                                      bf16* __restrict__ dq, Strides qs,
                                      Strides ks, Strides vs, Strides dos,
                                      Strides dqs, int H, int KV, int S,
                                      int window, float scale) {
  constexpr int TILE = BQ * HD;
  extern __shared__ unsigned char smem_bwd[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_1k(smem_bwd));
  bf16* dOs = Qs + TILE;
  bf16* ring = dOs + TILE;          // stage st: K at 2 st TILE, V after it

  const int nq = (S + BQ - 1) / BQ;
  const int qt = nq - 1 - (int)blockIdx.x;   // most kv tiles first
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  const int kt_first = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int kt_last = (min(q0 + BQ, S) - 1) / BK;
  const int nkt = kt_last - kt_first + 1;

  load_tile_async<HD>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_tile_async<HD>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, S);
  load_tile_async<HD>(ring, kb, ks.s, kt_first * BK, S);
  load_tile_async<HD>(ring + TILE, vb, vs.s, kt_first * BK, S);
  cp_async_commit();

  const int qr[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const long long row0 = ((long long)b * H + h) * S;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse_r[i] = qr[i] < S ? lse[row0 + qr[i]] : 0.0f;
    delta_r[i] = qr[i] < S ? delta[row0 + qr[i]] : 0.0f;
  }
  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;

  for (int it = 0; it < nkt; ++it) {
    const int k0 = (kt_first + it) * BK;
    if (it + 1 < nkt) {             // the next kv tile into the other stage
      bf16* nxt = ring + 2 * ((it + 1) % STAGES) * TILE;
      load_tile_async<HD>(nxt, kb, ks.s, k0 + BK, S);
      load_tile_async<HD>(nxt + TILE, vb, vs.s, k0 + BK, S);
    }
    cp_async_commit();
    cp_async_wait<1>();             // this tile's copies are done
    __syncthreads();                // and everyone's
    const bf16* Ks = ring + 2 * (it % STAGES) * TILE;
    const bf16* Vs = Ks + TILE;
    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int d = 0; d < HD / 16; ++d)
      wgmma_ss_n64(s, desc_k(Qs, 0, d), desc_k(Ks, 0, d), d);
    wg_commit();
#pragma unroll
    for (int d = 0; d < HD / 16; ++d)
      wgmma_ss_n64(dp, desc_k(dOs, 0, d), desc_k(Vs, 0, d), d);
    wg_commit();
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    if (k0 == 0 || window == 1) {   // a row with one kept key may be here
      float one[2];
      bool has[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {   // its key is its diagonal's column
        const int col = qr[i] - k0;
        has[i] = qr[i] < S && (qr[i] == 0 || window == 1) && col >= 0 &&
                 col < BK && ((col >> 1) & 3) == t;
        one[i] = has[i] ? dot_ascending<HD>(dOs, qr[i] - q0, Vs, col) : 0.0f;
      }
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int i = (x >> 1) & 1, kp = k0 + 8 * (x >> 2) + 2 * t + (x & 1);
        dp[x] = has[i] && kp == qr[i] ? one[i] : dp[x];
      }
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {    // selects, not branches, per element
      const int i = (x >> 1) & 1, kp = k0 + 8 * (x >> 2) + 2 * t + (x & 1);
      const bool kept = (kp <= qr[i]) & ((window <= 0) | (kp > qr[i] - window)) &
                        (qr[i] < S);
      const float p = kept ? expf(s[x] * scale - lse_r[i]) : 0.0f;
      s[x] = p * (dp[x] - delta_r[i]) * scale;               // dS
    }
    unsigned hi[BK / 16][4], lo[BK / 16][4];
#pragma unroll
    for (int st = 0; st < BK / 16; ++st) split_a(s + 8 * st, hi[st], lo[st]);
    wg_fence();
#pragma unroll
    for (int st = 0; st < BK / 16; ++st) {
      wgmma_rs<HD>(acc, hi[st], Ks, st);
      wgmma_rs<HD>(acc, lo[st], Ks, st);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(acc);
    __syncthreads();                // this stage is read; it is refilled next
  }

  bf16* out = dq + b * dqs.b + h * dqs.h;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    store_c(out, dqs.s, qr[0], 8 * n + 2 * t, acc + 4 * n, S);
}

// dQ for bf16 at hd 192: one block of two warpgroups per (q tile, query
// head, batch), walking the kv tiles, every product formed once a (q tile,
// kv tile j):
//   warpgroup 0 forms S = Q K_j^T and warpgroup 1 dP = dO V_j^T (64 x 64 at
//   depth 192, A and B from shared memory: one straight line of products
//   on selected descriptors);
//   the two swap halves through 16 KB of shared memory, so that warpgroup
//   0 holds S and dP of keys 0-31 of the tile and warpgroup 1 of keys
//   32-63, and each forms p and dS on its 32 keys;
//   each adds dS K_j over its 32 keys (A = dS hi and lo from registers, B
//   = K_j's rows of those keys MN-major, 64 x 192) into a 64 x 192 f32
//   partial dQ of its own, 96 registers a thread.
// The steps are pipelined one tile deep: step j issues the score product
// of tile j + 1, then the dQ products of tile j, and forms p and dS of
// tile j + 1 on the CUDA cores while the tensor cores do those products.
// K and V stream through a ring of WSTAGES stages (tile j + 2 loads while
// tiles j and j + 1 are read).  A tile that crosses no row's diagonal,
// window edge or end is not masked.  Blocks go q tile by q tile, the most
// kv tiles first, across every head.  After the last tile warpgroup 1
// hands its partial to warpgroup 0 through shared memory, which adds the
// two and rounds once: every dq element is one fixed-order f32 sum.  Work a
// causal (query, key) pair, in multiply-adds: 192 (S) + 192 (dP) + 2 x 192
// (dQ, hi and lo) = 768, against the bound's 3 x 192 = 576 (the lo
// products are the 1.33x).  The one-key rows' dP (see dq_tc) is formed by
// warpgroup 1, before the swap.
template <int HD>
__device__ __forceinline__ void dq_tc_wide(const bf16* __restrict__ q,
                                           const bf16* __restrict__ k,
                                           const bf16* __restrict__ v,
                                           const bf16* __restrict__ dout,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           bf16* __restrict__ dq, Strides qs,
                                           Strides ks, Strides vs, Strides dos,
                                           Strides dqs, int H, int KV, int S,
                                           int window, float scale) {
  constexpr int TILE = BQ * HD, NTH = NTC * bwd_wgs(HD);
  extern __shared__ unsigned char smem_bwd[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_1k(smem_bwd));
  bf16* dOs = Qs + TILE;
  bf16* ring = dOs + TILE;          // stage st: K at 2 st TILE, V after it
  float* xch = reinterpret_cast<float*>(ring + 2 * WSTAGES * TILE);
                                    // the swap: (16, NTH) f32

  const int nq = (S + BQ - 1) / BQ;
  const int qt = nq - 1 - (int)blockIdx.z;   // most kv tiles first
  const int h = blockIdx.x, b = blockIdx.y, kvh = h / (H / KV);
  const int q0 = qt * BQ;
  // the warpgroup, broadcast from lane 0 so that ptxas sees it uniform and
  // forms the selected descriptors in uniform registers
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* kb = k + b * ks.b + kvh * ks.h;
  const bf16* vb = v + b * vs.b + kvh * vs.h;
  const int kt_first = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int kt_last = (min(q0 + BQ, S) - 1) / BK;
  const int nkt = kt_last - kt_first + 1;
  auto load_kv = [&](int it) {      // kv tile kt_first + it into its stage
    bf16* dst = ring + 2 * (it % WSTAGES) * TILE;
    const int k0 = (kt_first + it) * BK;
    load_tile_async<HD, NTH>(dst, kb, ks.s, k0, S);
    load_tile_async<HD, NTH>(dst + TILE, vb, vs.s, k0, S);
  };

  load_tile_async<HD, NTH>(Qs, q + b * qs.b + h * qs.h, qs.s, q0, S);
  load_tile_async<HD, NTH>(dOs, dout + b * dos.b + h * dos.h, dos.s, q0, S);
  load_kv(0);
  cp_async_commit();
  if (nkt > 1) load_kv(1);
  cp_async_commit();

  // Both warpgroups hold the tile's 64 rows: warp w rows 16 w .. 16 w + 16.
  const int qr[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const long long row0 = ((long long)b * H + h) * S;
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse_r[i] = qr[i] < S ? lse[row0 + qr[i]] : 0.0f;
    delta_r[i] = qr[i] < S ? delta[row0 + qr[i]] : 0.0f;
  }
  float acc[HD / 2];                // the warpgroup's partial dQ
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  const bf16* As = wg ? dOs : Qs;   // A of the score product: Q, or dO
  const int other = threadIdx.x ^ NTC;   // this thread's twin in the other
  float sc[32];                     // S (warpgroup 0) or dP (1) of a tile
  float ds[16];                     // dS of a tile on the warpgroup's keys

  // the score product of tile it into sc, issued (after a wg_fence)
  auto score = [&](int it) {
    const bf16* Bs = ring + (2 * (it % WSTAGES) + wg) * TILE;   // K, or V
#pragma unroll
    for (int d = 0; d < HD / 16; ++d)
      wgmma_ss_n64(sc, desc_k(As, 0, d), desc_k(Bs, 0, d), d);
    wg_commit();
  };
  // p and dS of tile it into ds, from sc (its product done) and the swap
  auto probs = [&](int it) {
    const int k0 = (kt_first + it) * BK;
    if (k0 == 0 || window == 1) {   // a row with one kept key may be here
      const bf16* Vs = ring + (2 * (it % WSTAGES) + 1) * TILE;
      float one[2];
      bool has[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {   // its key is its diagonal's column
        const int col = qr[i] - k0;
        has[i] = wg == 1 && qr[i] < S && (qr[i] == 0 || window == 1) &&
                 col >= 0 && col < BK && ((col >> 1) & 3) == t;
        one[i] = has[i] ? dot_ascending<HD>(dOs, qr[i] - q0, Vs, col) : 0.0f;
      }
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int i = (x >> 1) & 1, kp = k0 + 8 * (x >> 2) + 2 * t + (x & 1);
        sc[x] = has[i] && kp == qr[i] ? one[i] : sc[x];
      }
    }
    // The swap: accumulator elements 0-15 are keys 0-31 of the tile, 16-31
    // keys 32-63.  Warpgroup 0 hands over S of keys 32-63, warpgroup 1 dP
    // of keys 0-31 (each thread to its twin, 32 neighbouring words a warp).
#pragma unroll
    for (int j = 0; j < 16; ++j) xch[j * NTH + threadIdx.x] = wg ? sc[j] : sc[16 + j];
    __syncthreads();
    auto form = [&](auto masked) {  // selects, not branches, per element
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float mine = wg ? sc[16 + j] : sc[j];
        const float theirs = xch[j * NTH + other];
        const float s = wg ? theirs : mine, dp = wg ? mine : theirs;
        const int i = (j >> 1) & 1;
        const int kp = k0 + 32 * wg + 8 * (j >> 2) + 2 * t + (j & 1);
        const bool kept = !decltype(masked)::value ||
                          ((kp <= qr[i]) & ((window <= 0) | (kp > qr[i] - window)) &
                           (qr[i] < S));
        const float p = kept ? expf(s * scale - lse_r[i]) : 0.0f;
        ds[j] = p * (dp - delta_r[i]) * scale;
      }
    };
    if (k0 + BK - 1 > q0 || (window > 0 && k0 <= q0 + BQ - 1 - window) ||
        q0 + BQ > S)
      form(std::true_type{});
    else
      form(std::false_type{});
  };

  // dS of the tile the products take next split into its A operands, and
  // the copies of the tile after it in (everyone's, visible to wgmma): tile
  // it - 1's stage is free
  unsigned dh[2][4], dl[2][4];      // dS hi and lo of the warpgroup's keys
  auto hand_over = [&]() {
#pragma unroll
    for (int st = 0; st < 2; ++st) split_a(ds + 8 * st, dh[st], dl[st]);
    cp_async_wait<0>();
    __syncthreads();
  };
  // dQ += dS K of tile it, issued: K's rows of the warpgroup's keys
  auto products = [&](int it) {
    const bf16* Ks = ring + 2 * (it % WSTAGES) * TILE;
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      wgmma_rs<HD>(acc, dh[st], Ks, 2 * wg + st);
      wgmma_rs<HD>(acc, dl[st], Ks, 2 * wg + st);
    }
    wg_commit();
  };

  cp_async_wait<1>();               // tile 0 is in
  __syncthreads();
  wg_fence();
  score(0);
  wg_wait<0>();
  fence_regs(sc);
  probs(0);
  // Step it: the score product of tile it + 1, then tile it's products;
  // p and dS of tile it + 1 under them.  The last tile's products are
  // peeled off, so that every wait and every read of sc sits on the one
  // straight line of products (ptxas serializes every wgmma of a kernel
  // where it cannot place an accumulator read after its wait).
  for (int it = 0; it + 1 < nkt; ++it) {
    hand_over();
    if (it + 2 < nkt) load_kv(it + 2);
    cp_async_commit();
    wg_fence();
    score(it + 1);
    products(it);
    wg_wait<1>();                   // the score product of tile it + 1 is in
    fence_regs(sc);
    probs(it + 1);
    wg_wait<0>();
    fence_regs(acc);
  }
  hand_over();
  wg_fence();
  products(nkt - 1);
  wg_wait<0>();
  fence_regs(acc);

  // Warpgroup 1's partial through the ring, once every product has read it.
  __syncthreads();
  float* part = reinterpret_cast<float*>(ring);     // (HD / 2, NTC) f32
  const int tid = threadIdx.x & (NTC - 1);
  if (wg == 1)
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) part[x * NTC + tid] = acc[x];
  __syncthreads();
  if (wg == 0) {
    bf16* out = dq + b * dqs.b + h * dqs.h;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      float vals[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) vals[e] = acc[4 * n + e] + part[(4 * n + e) * NTC + tid];
      store_c(out, dqs.s, qr[0], 8 * n + 2 * t, vals, S);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(NTC * bwd_wgs(HD))
    flash_bwd_dq_tc_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dq, Strides qs, Strides ks,
                           Strides vs, Strides dos, Strides dqs, int H, int KV,
                           int S, int window, float scale) {
  if constexpr (bwd_wgs(HD) > 1)
    dq_tc_wide<HD>(q, k, v, dout, lse, delta, dq, qs, ks, vs, dos, dqs, H, KV,
                   S, window, scale);
  else
    dq_tc<HD>(q, k, v, dout, lse, delta, dq, qs, ks, vs, dos, dqs, H, KV, S,
              window, scale);
}

// dK, dV for bf16 up to hd 128: one block of one warpgroup per (kv tile, kv
// head, batch), walking the G query heads of the kv head and their q tiles,
// each in two 32-query halves, transposed: S^T = K Q^T and dP^T = V dO^T
// (64 keys x 32 queries), then dV += P^T dO and dK += dS^T Q (A = P^T, dS^T
// hi and lo from registers, B = dO, Q MN-major).  Work a causal (query,
// key) pair, in multiply-adds: hd (S^T) + hd (dP^T) + 2 hd (dV) + 2 hd (dK)
// = 6 hd, against the bound's 4 hd.
template <int HD>
__device__ __forceinline__ void dkv_tc(const bf16* __restrict__ q,
                                       const bf16* __restrict__ k,
                                       const bf16* __restrict__ v,
                                       const bf16* __restrict__ dout,
                                       const float* __restrict__ lse,
                                       const float* __restrict__ delta,
                                       bf16* __restrict__ dk, bf16* __restrict__ dv,
                                       Strides qs, Strides ks, Strides vs,
                                       Strides dos, Strides dks, Strides dvs,
                                       int H, int KV, int S, int window,
                                       float scale) {
  constexpr int TILE = BQ * HD;
  extern __shared__ unsigned char smem_bwd[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_1k(smem_bwd));
  bf16* Vs = Ks + TILE;
  bf16* ring = Vs + TILE;           // stage st: Q at 2 st TILE, dO after it
  float* stats = reinterpret_cast<float*>(ring + 2 * STAGES * TILE);
                                    // stage st: lse, delta at 2 st BQ

  const int kt = blockIdx.x;        // the first kv tiles see the most q tiles
  const int kvh = blockIdx.y, b = blockIdx.z, G = H / KV;
  const int k0 = kt * BK;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nq = (S + BQ - 1) / BQ;
  const int qt_first = k0 / BQ;
  const int qt_last =
      window > 0 ? min(nq - 1, (k0 + BK + window - 2) / BQ) : nq - 1;
  const int nqt = qt_last - qt_first + 1, nit = G * nqt;
  const bf16* qb = q + b * qs.b + kvh * G * qs.h;
  const bf16* dob = dout + b * dos.b + kvh * G * dos.h;
  const long long rows = ((long long)b * H + kvh * G) * S;  // lse row of g 0

  // stage st <- (head g, q tile qt) of iteration i
  auto load_stage = [&](int i, int st) {
    const int gi = i / nqt, q0 = (qt_first + i % nqt) * BQ;
    bf16* dst = ring + 2 * st * TILE;
    load_tile_async<HD>(dst, qb + gi * qs.h, qs.s, q0, S);
    load_tile_async<HD>(dst + TILE, dob + gi * dos.h, dos.s, q0, S);
    load_stats_async(stats + 2 * st * BQ, lse, delta, rows + gi * S, q0, S);
  };
  load_tile_async<HD>(Ks, k + b * ks.b + kvh * ks.h, ks.s, k0, S);
  load_tile_async<HD>(Vs, v + b * vs.b + kvh * vs.h, vs.s, k0, S);
  load_stage(0, 0);
  cp_async_commit();

  const int kr[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  float dv_acc[HD / 2], dk_acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dv_acc[i] = dk_acc[i] = 0.0f;

  for (int it = 0; it < nit; ++it) {
    const int q0 = (qt_first + it % nqt) * BQ;
    if (it + 1 < nit) load_stage(it + 1, (it + 1) % STAGES);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qs = ring + 2 * (it % STAGES) * TILE;
    const bf16* dOs = Qs + TILE;
    const float* lse_s = stats + 2 * (it % STAGES) * BQ;
    const float* delta_s = lse_s + BQ;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = q0 + 32 * half;  // the half's first query
      if (c0 >= S || c0 + 31 < k0 || (window > 0 && k0 + BK - 1 <= c0 - window))
        continue;
      float s[16], dp[16];
      wg_fence();
#pragma unroll
      for (int d = 0; d < HD / 16; ++d)
        wgmma_ss_n32(s, desc_k(Ks, 0, d), desc_k(Qs, 32 * half, d), d);
      wg_commit();
#pragma unroll
      for (int d = 0; d < HD / 16; ++d)
        wgmma_ss_n32(dp, desc_k(Vs, 0, d), desc_k(dOs, 32 * half, d), d);
      wg_commit();
      wg_wait<1>();                 // S^T is in
      fence_regs(s);
#pragma unroll
      for (int x = 0; x < 16; ++x) {  // selects, not branches, per element
        const int col = 32 * half + 8 * (x >> 2) + 2 * t + (x & 1);
        const int qp = q0 + col, kp = kr[(x >> 1) & 1];
        const bool kept = (kp <= qp) & ((window <= 0) | (kp > qp - window)) &
                          (qp < S);
        s[x] = kept ? expf(s[x] * scale - lse_s[col]) : 0.0f;  // P^T
      }
      unsigned ph[2][4], pl[2][4];
      split_a(s, ph[0], pl[0]);
      split_a(s + 8, ph[1], pl[1]);
      wg_fence();
#pragma unroll
      for (int st = 0; st < 2; ++st) {                      // dV += P^T dO
        wgmma_rs<HD>(dv_acc, ph[st], dOs, 2 * half + st);
        wgmma_rs<HD>(dv_acc, pl[st], dOs, 2 * half + st);
      }
      wg_commit();
      wg_wait<1>();               // dP^T is in
      fence_regs(dp);
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int col = 32 * half + 8 * (x >> 2) + 2 * t + (x & 1);
        s[x] = s[x] * (dp[x] - delta_s[col]) * scale;     // dS^T
      }
      unsigned dh[2][4], dl[2][4];
      split_a(s, dh[0], dl[0]);
      split_a(s + 8, dh[1], dl[1]);
      wg_fence();
#pragma unroll
      for (int st = 0; st < 2; ++st) {                      // dK += dS^T Q
        wgmma_rs<HD>(dk_acc, dh[st], Qs, 2 * half + st);
        wgmma_rs<HD>(dk_acc, dl[st], Qs, 2 * half + st);
      }
      wg_commit();
      wg_wait<0>();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    __syncthreads();
  }

  bf16* kd = dk + b * dks.b + kvh * dks.h;
  bf16* vd = dv + b * dvs.b + kvh * dvs.h;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    store_c(kd, dks.s, kr[0], 8 * n + 2 * t, dk_acc + 4 * n, S);
    store_c(vd, dvs.s, kr[0], 8 * n + 2 * t, dv_acc + 4 * n, S);
  }
}

// dK, dV for bf16 at hd 192: one block of two warpgroups per (kv tile, kv
// head, batch), walking the G query heads of the kv head and their q tiles
// in ascending order, a whole 64-query tile a step, transposed:
//   warpgroup 0 forms S^T = K Q^T and warpgroup 1 dP^T = V dO^T (64 keys x
//   64 queries at depth 192, one straight line of products on selected
//   descriptors);
//   warpgroup 0 hands S^T to warpgroup 1 through 16 KB of shared memory;
//   both form P^T from it (the same f32 operations on the same values),
//   warpgroup 1 then dS^T;
//   warpgroup 0 adds dV += P^T dO, warpgroup 1 dK += dS^T Q (A = P^T or
//   dS^T, hi and lo, from registers; B = dO or Q MN-major, selected), each
//   into one 64 x 192 f32 accumulator of its own, 96 registers a thread.
// The steps are pipelined one deep, as in dq_tc_wide: step j issues the
// score product of step j + 1, then the dV or dK products of step j, and
// forms P^T and dS^T of step j + 1 under those products; Q, dO, lse and
// delta stream through a ring of WSTAGES stages.  A step that crosses no
// pair's diagonal, window edge or end is not masked.  Blocks go kv tile by
// kv tile, the most q tiles first, across every kv head.  Each dK and dV
// element is summed in the order of the hd-128 kernel: head by head, q tile
// by q tile, its 64 queries in four k16 steps, hi then lo.  Work a causal
// (query, key) pair, in multiply-adds: 192 (S^T) + 192 (dP^T) + 2 x 192
// (dV) + 2 x 192 (dK) = 1152, against the bound's 4 x 192 = 768 (the lo
// products are the 1.5x).
template <int HD>
__device__ __forceinline__ void dkv_tc_wide(const bf16* __restrict__ q,
                                            const bf16* __restrict__ k,
                                            const bf16* __restrict__ v,
                                            const bf16* __restrict__ dout,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta,
                                            bf16* __restrict__ dk,
                                            bf16* __restrict__ dv, Strides qs,
                                            Strides ks, Strides vs, Strides dos,
                                            Strides dks, Strides dvs, int H,
                                            int KV, int S, int window,
                                            float scale) {
  constexpr int TILE = BQ * HD, NTH = NTC * bwd_wgs(HD);
  extern __shared__ unsigned char smem_bwd[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_1k(smem_bwd));
  bf16* Vs = Ks + TILE;
  bf16* ring = Vs + TILE;           // stage st: Q at 2 st TILE, dO after it
  float* stats = reinterpret_cast<float*>(ring + 2 * WSTAGES * TILE);
                                    // stage st: lse, delta at 2 st BQ
  float* xch = stats + 2 * WSTAGES * BQ;   // S^T: (32, NTC) f32

  const int kt = blockIdx.z;        // the first kv tiles see the most q tiles
  const int kvh = blockIdx.x, b = blockIdx.y, G = H / KV;
  const int k0 = kt * BK;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);   // uniform
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int tid = threadIdx.x & (NTC - 1);
  const int nq = (S + BQ - 1) / BQ;
  const int qt_first = k0 / BQ;
  const int qt_last =
      window > 0 ? min(nq - 1, (k0 + BK + window - 2) / BQ) : nq - 1;
  const int nqt = qt_last - qt_first + 1, nit = G * nqt;
  const bf16* qb = q + b * qs.b + kvh * G * qs.h;
  const bf16* dob = dout + b * dos.b + kvh * G * dos.h;
  const long long rows = ((long long)b * H + kvh * G) * S;  // lse row of g 0

  // (head g, q tile qt) of step i into its stage
  auto load_stage = [&](int i) {
    const int gi = i / nqt, q0 = (qt_first + i % nqt) * BQ, st = i % WSTAGES;
    bf16* dst = ring + 2 * st * TILE;
    load_tile_async<HD, NTH>(dst, qb + gi * qs.h, qs.s, q0, S);
    load_tile_async<HD, NTH>(dst + TILE, dob + gi * dos.h, dos.s, q0, S);
    load_stats_async(stats + 2 * st * BQ, lse, delta, rows + gi * S, q0, S);
  };
  load_tile_async<HD, NTH>(Ks, k + b * ks.b + kvh * ks.h, ks.s, k0, S);
  load_tile_async<HD, NTH>(Vs, v + b * vs.b + kvh * vs.h, vs.s, k0, S);
  load_stage(0);
  cp_async_commit();
  if (nit > 1) load_stage(1);
  cp_async_commit();

  // Both warpgroups hold the tile's 64 keys: warp w rows 16 w .. 16 w + 16.
  const int kr[2] = {k0 + 16 * warp + g, k0 + 16 * warp + g + 8};
  float acc[HD / 2];                // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.0f;
  const bf16* As = wg ? Vs : Ks;    // A of the score product: K, or V
  float sc[32];                     // S^T (warpgroup 0) or dP^T (1) of a step

  // the score product of step it into sc, issued (after a wg_fence)
  auto score = [&](int it) {
    const bf16* Bs = ring + (2 * (it % WSTAGES) + wg) * TILE;   // Q, or dO
#pragma unroll
    for (int d = 0; d < HD / 16; ++d)
      wgmma_ss_n64(sc, desc_k(As, 0, d), desc_k(Bs, 0, d), d);
    wg_commit();
  };
  // P^T (warpgroup 0) or dS^T (warpgroup 1) of step it into sc, from sc
  // (its product done) and warpgroup 0's S^T
  auto probs = [&](int it) {
    const int q0 = (qt_first + it % nqt) * BQ;
    const float* lse_s = stats + 2 * (it % WSTAGES) * BQ;
    const float* delta_s = lse_s + BQ;
    if (wg == 0)
#pragma unroll
      for (int x = 0; x < 32; ++x) xch[x * NTC + tid] = sc[x];
    __syncthreads();
    auto form = [&](auto masked) {  // selects, not branches, per element
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int col = 8 * (x >> 2) + 2 * t + (x & 1);
        const int qp = q0 + col, kp = kr[(x >> 1) & 1];
        const bool kept = !decltype(masked)::value ||
                          ((kp <= qp) & ((window <= 0) | (kp > qp - window)) &
                           (qp < S));
        const float s = wg ? xch[x * NTC + tid] : sc[x];
        const float p = kept ? expf(s * scale - lse_s[col]) : 0.0f;   // P^T
        sc[x] = wg ? p * (sc[x] - delta_s[col]) * scale : p;          // dS^T
      }
    };
    if (q0 < k0 + BK - 1 || (window > 0 && k0 <= q0 + BQ - 1 - window) ||
        q0 + BQ > S)
      form(std::true_type{});
    else
      form(std::false_type{});
  };

  // P^T (warpgroup 0) or dS^T (1) of the step the products take next split
  // into its A operands, and the copies of the step after it in
  // (everyone's, visible to wgmma): step it - 1's stage is free
  unsigned hi[BQ / 16][4], lo[BQ / 16][4];
  auto hand_over = [&]() {
#pragma unroll
    for (int st = 0; st < BQ / 16; ++st) split_a(sc + 8 * st, hi[st], lo[st]);
    cp_async_wait<0>();
    __syncthreads();
  };
  // dV += P^T dO (warpgroup 0) or dK += dS^T Q (1) of step it, issued
  auto products = [&](int it) {
    const bf16* Bd = ring + (2 * (it % WSTAGES) + 1 - wg) * TILE;
#pragma unroll
    for (int st = 0; st < BQ / 16; ++st) {
      wgmma_rs<HD>(acc, hi[st], Bd, st);
      wgmma_rs<HD>(acc, lo[st], Bd, st);
    }
    wg_commit();
  };

  cp_async_wait<1>();               // K, V and step 0 are in
  __syncthreads();
  wg_fence();
  score(0);
  wg_wait<0>();
  fence_regs(sc);
  probs(0);
  // As in dq_tc_wide: the score product of step it + 1, then step it's
  // products, P^T and dS^T of step it + 1 under them; the last step's
  // products peeled off.
  for (int it = 0; it + 1 < nit; ++it) {
    hand_over();
    if (it + 2 < nit) load_stage(it + 2);
    cp_async_commit();
    wg_fence();
    score(it + 1);
    products(it);
    wg_wait<1>();                   // the score product of step it + 1 is in
    fence_regs(sc);
    probs(it + 1);
    wg_wait<0>();
    fence_regs(acc);
  }
  hand_over();
  wg_fence();
  products(nit - 1);
  wg_wait<0>();
  fence_regs(acc);

  bf16* out = wg ? dk + b * dks.b + kvh * dks.h : dv + b * dvs.b + kvh * dvs.h;
  const long long ss = wg ? dks.s : dvs.s;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
    store_c(out, ss, kr[0], 8 * n + 2 * t, acc + 4 * n, S);
}

template <int HD>
__global__ void __launch_bounds__(NTC * bwd_wgs(HD))
    flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q,
                            const bf16* __restrict__ k,
                            const bf16* __restrict__ v,
                            const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            bf16* __restrict__ dk, bf16* __restrict__ dv,
                            Strides qs, Strides ks, Strides vs, Strides dos,
                            Strides dks, Strides dvs, int H, int KV, int S,
                            int window, float scale) {
  if constexpr (bwd_wgs(HD) > 1)
    dkv_tc_wide<HD>(q, k, v, dout, lse, delta, dk, dv, qs, ks, vs, dos, dks,
                    dvs, H, KV, S, window, scale);
  else
    dkv_tc<HD>(q, k, v, dout, lse, delta, dk, dv, qs, ks, vs, dos, dks, dvs, H,
               KV, S, window, scale);
}

// Dynamic shared memory a block, in bytes, of each instance: the counts the
// launches ask for.  kernels/flash.py `smem_bytes` counts the same; the
// wrappers check the two agree at an instance's first launch (flash_info).
//   f32: padded (rows, hd + 1) tiles and (64, 65) score tiles, on the CUDA
//   cores; bf16: swizzled (64, hd) tiles (resident ones, then the stages
//   of the streamed ones: 3 in the forward, 2 in the backward, 3 in the
//   two-warpgroup backward at hd 192), for dK/dV the lse and delta rows of
//   each stage, at hd 192 the backward warpgroups' 64 x 64 f32 swap and
//   the forward's mbarriers (full and empty a stage, and Q's), and 1 KB to
//   align the tiles.
constexpr size_t f32_tile(int rows, int hd) {
  return sizeof(float) * rows * (hd + 1);
}
constexpr size_t fwd_bytes(bool tc, int hd) {
  return tc ? sizeof(bf16) * (fwd_wgs(hd) + 2 * FSTAGES) * BQ * hd + 1024 +
                  (fwd_ws(hd) ? sizeof(uint64_t) * (2 * FSTAGES + 2) : 0)
            : 2 * f32_tile(BQ, hd) + f32_tile(BQ, BK);
}
constexpr size_t swap_bytes(int hd) {
  return bwd_wgs(hd) > 1 ? sizeof(float) * BQ * BK : 0;
}
constexpr size_t dq_bytes(bool tc, int hd) {
  return tc ? sizeof(bf16) * (2 + 2 * bwd_stages(hd)) * BQ * hd +
                  swap_bytes(hd) + 1024
            : 3 * f32_tile(BQ, hd) + f32_tile(BQ, BK);
}
constexpr size_t dkv_bytes(bool tc, int hd) {
  return tc ? sizeof(bf16) * (2 + 2 * bwd_stages(hd)) * BQ * hd +
                  sizeof(float) * 2 * bwd_stages(hd) * BQ + swap_bytes(hd) + 1024
            : 4 * f32_tile(BQ, hd) + 2 * f32_tile(BQ, BK) +
                  sizeof(float) * 2 * BQ;
}

Strides strides(const long long* st, int i) {
  return Strides{st[3 * i], st[3 * i + 1], st[3 * i + 2]};
}

// Sets the kernel's dynamic shared memory limit (above 48 KB it must be
// raised explicitly) and launches it.
template <typename K, typename... Args>
int launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t s,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

// The bf16 kernels' 16-byte copies need 16-byte aligned pointers and
// strides of whole 16-byte pieces.
bool aligned16(std::initializer_list<const void*> ptrs, const long long* st,
               int n_strides) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) & 15) return false;
  for (int i = 0; i < n_strides; ++i)
    if (st[i] & 7) return false;
  return true;
}

// The kernel of each (kind, dtype, hd) instance, its threads a block, its
// grid and its shared bytes.  kind: 0 forward, 1 forward with lse, 2 dQ,
// 3 dK/dV.
template <typename T, int HD>
struct Instance {
  static constexpr bool TC = std::is_same<T, bf16>::value;
  static const void* kernel(int kind) {
    if constexpr (TC) {
      if constexpr (fwd_ws(HD)) {
        if (kind == 0) return (const void*)flash_fwd_ws_kernel<HD, false>;
        if (kind == 1) return (const void*)flash_fwd_ws_kernel<HD, true>;
      } else {
        if (kind == 0) return (const void*)flash_fwd_tc_kernel<HD, false>;
        if (kind == 1) return (const void*)flash_fwd_tc_kernel<HD, true>;
      }
      if (kind == 2) return (const void*)flash_bwd_dq_tc_kernel<HD>;
      return (const void*)flash_bwd_dkv_tc_kernel<HD>;
    } else {
      if (kind == 0) return (const void*)flash_fwd_kernel<T, HD, false>;
      if (kind == 1) return (const void*)flash_fwd_kernel<T, HD, true>;
      if (kind == 2) return (const void*)flash_bwd_dq_kernel<HD>;
      return (const void*)flash_bwd_dkv_kernel<HD>;
    }
  }
  static int threads(int kind) {
    if (!TC) return NT;
    return kind < 2 ? fwd_threads(HD) : NTC * bwd_wgs(HD);
  }
  static size_t smem(int kind) {
    return kind < 2 ? fwd_bytes(TC, HD)
                    : kind == 2 ? dq_bytes(TC, HD) : dkv_bytes(TC, HD);
  }
};

// Errors of the launch entry points beyond CUDA's own (flash_error_string
// names them): libcuda has no cuTensorMapEncodeTiled, or it refused a
// tensor map.
constexpr int FLASH_NO_TMA_ENCODE = 10000;
constexpr int FLASH_BAD_TENSOR_MAP = 10001;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime so that the
// library links no libcuda; null where libcuda lacks it.
EncodeTiled encode_tiled() {
  void* fn = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
  return reinterpret_cast<EncodeTiled>(fn);
}

// The TMA map of a (B, heads, S, hd) bf16 tensor at p with (batch, head,
// sequence) element strides st: dims (hd, S, heads, B), innermost first,
// byte strides, (64, 64, 1, 1) boxes in the 128-byte swizzle of the
// tiles; rows past S read as zeros.
int tensor_map(CUtensorMap* map, const void* p, const long long* st, int hd,
               int S, int heads, int B) {
  static const EncodeTiled encode = encode_tiled();
  if (!encode) return FLASH_NO_TMA_ENCODE;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)S, (cuuint64_t)heads,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {sizeof(bf16) * st[2], sizeof(bf16) * st[1],
                                 sizeof(bf16) * st[0]};
  const cuuint32_t box[4] = {64, (cuuint32_t)BK, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(p), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : FLASH_BAD_TENSOR_MAP;
}

// bf16 runs the tensor-core forward (warp-specialised on TMA maps at hd
// 192), f32 the CUDA-core one.
template <typename T, int HD>
int fwd(int stats, const void* q, const void* k, const void* v, void* o,
        void* lse, const long long* st, int B, int H, int KV, int S,
        int window, float scale, cudaStream_t s) {
  using I = Instance<T, HD>;
  if constexpr (I::TC) {
    if (!aligned16({q, k, v, o}, st, 12)) return (int)cudaErrorMisalignedAddress;
    // one block per (q tile, head, batch), q tiles in the slowest place
    const int rows = BQ * fwd_wgs(HD);
    const dim3 grid((S + rows - 1) / rows * H * B);
    if constexpr (fwd_ws(HD)) {
      CUtensorMap tq, tk, tv;
      int err = tensor_map(&tq, q, st, HD, S, H, B);
      if (!err) err = tensor_map(&tk, k, st + 3, HD, S, KV, B);
      if (!err) err = tensor_map(&tv, v, st + 6, HD, S, KV, B);
      // persistent: a block an SM, or one an item where there are fewer
      int dev = 0, sms = 0;
      if (!err) err = (int)cudaGetDevice(&dev);
      if (!err)
        err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (err) return err;
      const dim3 blocks(std::min<unsigned>(grid.x, (unsigned)sms));
      if (stats)
        return launch(flash_fwd_ws_kernel<HD, true>, blocks, I::threads(1),
                      I::smem(1), s, tq, tk, tv, (T*)o, (float*)lse,
                      strides(st, 3), B, H, KV, S, window, scale);
      return launch(flash_fwd_ws_kernel<HD, false>, blocks, I::threads(0),
                    I::smem(0), s, tq, tk, tv, (T*)o, (float*)lse,
                    strides(st, 3), B, H, KV, S, window, scale);
    } else {
      if (stats)
        return launch(flash_fwd_tc_kernel<HD, true>, grid, I::threads(1),
                      I::smem(1), s, (const T*)q, (const T*)k, (const T*)v,
                      (T*)o, (float*)lse, strides(st, 0), strides(st, 1),
                      strides(st, 2), strides(st, 3), H, KV, S, window, scale);
      return launch(flash_fwd_tc_kernel<HD, false>, grid, I::threads(0),
                    I::smem(0), s, (const T*)q, (const T*)k, (const T*)v,
                    (T*)o, (float*)lse, strides(st, 0), strides(st, 1),
                    strides(st, 2), strides(st, 3), H, KV, S, window, scale);
    }
  } else {
    const dim3 grid((S + BQ - 1) / BQ, H, B);
    if (stats)
      return launch(flash_fwd_kernel<T, HD, true>, grid, NT, I::smem(1), s,
                    (const T*)q, (const T*)k, (const T*)v, (T*)o,
                    (float*)lse, strides(st, 0), strides(st, 1),
                    strides(st, 2), strides(st, 3), H, KV, S, window, scale);
    return launch(flash_fwd_kernel<T, HD, false>, grid, NT, I::smem(0), s,
                  (const T*)q, (const T*)k, (const T*)v, (T*)o, (float*)lse,
                  strides(st, 0), strides(st, 1), strides(st, 2),
                  strides(st, 3), H, KV, S, window, scale);
  }
}

// The grid of a backward kernel: one block per (tile, head, batch), tiles
// being q tiles (dQ) or kv tiles (dK/dV), the first tile the one whose
// block walks the most of the other axis.  The two-warpgroup bf16 bodies
// (hd 192) put the tiles slowest, so that the longest blocks of every head
// start first.
template <typename T, int HD>
dim3 bwd_grid(int tiles, int heads, int B) {
  if (std::is_same<T, bf16>::value && bwd_wgs(HD) > 1)
    return dim3(heads, B, tiles);
  return dim3(tiles, heads, B);
}

// bf16 runs the tensor-core backward, f32 the CUDA-core one.
template <typename T, int HD>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, const long long* st,
           int B, int H, int KV, int S, int window, float scale,
           cudaStream_t s) {
  using I = Instance<T, HD>;
  const dim3 grid = bwd_grid<T, HD>((S + BQ - 1) / BQ, H, B);
  if constexpr (I::TC) {
    if (!aligned16({q, k, v, dout, dq}, st, 15))
      return (int)cudaErrorMisalignedAddress;
    return launch(flash_bwd_dq_tc_kernel<HD>, grid, I::threads(2), I::smem(2),
                  s, (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                  (const float*)lse, (const float*)delta, (T*)dq,
                  strides(st, 0), strides(st, 1), strides(st, 2),
                  strides(st, 3), strides(st, 4), H, KV, S, window, scale);
  } else {
    return launch(flash_bwd_dq_kernel<HD>, grid, NT, I::smem(2), s,
                  (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                  (const float*)lse, (const float*)delta, (T*)dq,
                  strides(st, 0), strides(st, 1), strides(st, 2),
                  strides(st, 3), strides(st, 4), H, KV, S, window, scale);
  }
}

template <typename T, int HD>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv,
            const long long* st, int B, int H, int KV, int S, int window,
            float scale, cudaStream_t s) {
  using I = Instance<T, HD>;
  const dim3 grid = bwd_grid<T, HD>((S + BK - 1) / BK, KV, B);
  if constexpr (I::TC) {
    if (!aligned16({q, k, v, dout, dk, dv}, st, 18))
      return (int)cudaErrorMisalignedAddress;
    return launch(flash_bwd_dkv_tc_kernel<HD>, grid, I::threads(3),
                  I::smem(3), s, (const T*)q, (const T*)k, (const T*)v,
                  (const T*)dout, (const float*)lse, (const float*)delta,
                  (T*)dk, (T*)dv, strides(st, 0), strides(st, 1),
                  strides(st, 2), strides(st, 3), strides(st, 4),
                  strides(st, 5), H, KV, S, window, scale);
  } else {
    return launch(flash_bwd_dkv_kernel<HD>, grid, NT, I::smem(3), s,
                  (const T*)q, (const T*)k, (const T*)v, (const T*)dout,
                  (const float*)lse, (const float*)delta, (T*)dk, (T*)dv,
                  strides(st, 0), strides(st, 1), strides(st, 2),
                  strides(st, 3), strides(st, 4), strides(st, 5), H, KV, S,
                  window, scale);
  }
}

// Dynamic shared bytes a block (out[0]) and resident blocks per SM on this
// card (out[1]) of one instance; ptxas reports its registers and spills.
template <typename T, int HD>
int info(int kind, int* out) {
  using I = Instance<T, HD>;
  const void* kernel = I::kernel(kind);
  const size_t smem = I::smem(kind);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel, I::threads(kind), smem);
  out[0] = (int)smem;
  out[1] = blocks;
  return (int)err;
}

// Calls F::run<T, HD>() for the (dtype, hd) pair; cudaErrorInvalidValue for
// one that has no instance (the wrapper refuses those first).
template <typename F, typename... Args>
int dispatch(int dtype, int hd, Args... args) {
  if (dtype == 0 && hd == 64) return F::template run<float, 64>(args...);
  if (dtype == 0 && hd == 128) return F::template run<float, 128>(args...);
  if (dtype == 0 && hd == 192) return F::template run<float, 192>(args...);
  if (dtype == 1 && hd == 64) return F::template run<bf16, 64>(args...);
  if (dtype == 1 && hd == 128) return F::template run<bf16, 128>(args...);
  if (dtype == 1 && hd == 192) return F::template run<bf16, 192>(args...);
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
struct Info {
  template <typename T, int HD, typename... A>
  static int run(A... a) { return info<T, HD>(a...); }
};

}  // namespace

extern "C" const char* flash_error_string(int err) {
  if (err == FLASH_NO_TMA_ENCODE)
    return "libcuda has no cuTensorMapEncodeTiled";
  if (err == FLASH_BAD_TENSOR_MAP)
    return "cuTensorMapEncodeTiled refused a tensor map of q, k or v";
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dO and the gradients share
// it); hd: 64, 128 or 192; window <= 0: none.  `strides` holds (batch,
// head, sequence) element strides, three per tensor, in argument order.
// Each returns cudaGetLastError() after its launch (0 when it was
// accepted).
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

// The instance (kind: 0 forward, 1 forward with lse, 2 dQ, 3 dK/dV; dtype
// and hd as above): out[0] = dynamic shared memory a block in bytes, as its
// launch asks for it, out[1] = resident blocks per SM on this card.
extern "C" int flash_info(int kind, int dtype, int hd, int* out) {
  if (kind < 0 || kind > 3) return (int)cudaErrorInvalidValue;
  return dispatch<Info>(dtype, hd, kind, out);
}
