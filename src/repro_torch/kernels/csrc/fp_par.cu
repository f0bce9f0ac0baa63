// Parallel-beam Separable-Footprint forward projection (FP) and its exact
// transpose, the backprojection (BP), for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/fp_par.py:122 `_fp_kernel`
// and src/repro/kernels/fp_par.py:264 `_bp_kernel`.  Both compute what those
// compute, not how: the TPU kernels contract a (columns x window) weight
// tile against a volume window on the matrix unit and carry the sum across
// a sequential grid axis; on this card blocks run in no order, so each
// output is owned by one thread, which loops over the summed axis itself.
//
// Layout.  The axial (z -> detector row) part of the footprint is applied
// outside the kernels, so the innermost axis is `lanes` = batch x rows,
// contiguous in memory.  Views come in two groups (kernels/fp_par.py,
// `_view_params`): in the x-gathered group the gathered index gi is ix and
// the loop index li is iy, in the y-gathered group the other way round.
// The kernels take the (gi, li) strides of the one (nx, ny, lanes) buffer,
// so neither group needs a transposed copy in device memory.  Each view row
// of `table` is (P, Q, R, hs, hd, h): the voxel centre (gi, li) projects to
// uc = P*gi + Q*li + R with trapezoid half-widths hs, hd and plateau h.
// `rows[a]` is the sinogram row of the group's a-th view.
//
// What bounds them.  The first version (a thread per output and 8 lanes,
// each weight evaluated by every thread that needed it, one voxel or column
// of margin around each window) was bound by its loads, not its weights:
// with a constant weight it ran 4-6 % faster, and its eight 4-byte loads a
// weight, each spread over eight 128-byte lines (and over 32 in the
// x-gathered group at 8 lanes, where neighbouring columns read voxels a
// whole volume row apart), held it to a few multiply-adds a clock per SM
// (PERF.md, the parallel pair's step 0).  So this design:
//   * reads 16 bytes a thread per load, neighbouring threads on
//     neighbouring lanes: the FP stages the slab its tile meets (gathered
//     window x loop chunk x lane chunk) in shared memory with cp.async, in
//     the memory order of the view group, so both groups' copies are
//     contiguous; the BP reads the sinogram, whose layout is the same for
//     both groups, straight from global memory;
//   * evaluates each weight once per block and shares it across the block's
//     lanes (the FP through shared memory, the BP through a warp's slots),
//     a thread carrying 8 lanes, or 16 in wide lane chunks;
//   * evaluates only the taps that can be nonzero: the windows are cut
//     exactly (par_gather_window, par_column_window), and everything they
//     drop gets a weight of exactly zero, so no sum changes;
//   * lets one FP block serve a few neighbouring views (a batch): they meet
//     nearly the same voxels, so one staged slab serves them all;
//   * keeps the lane chunk the slowest grid axis, so the views sweep one
//     chunk's volume (FP) or sinogram (BP) together.
// What bounds it now (PERF.md, kernel table rows 1-2): the BP and the FP
// at 8 lanes, the weights (~100 operations and five IEEE divisions each);
// the FP at the 512^3 cell, moving the volume from L2 to shared memory once
// per batch of views and tile (bf16 runs ~30 % faster than f32 there); the
// small 128^3 cell, latency (few blocks, each walking 128 lines in chunks).
//
// Sums.  Each output sums the same terms in the same order as the first
// version: the FP over li, then gi; the BP over views, then columns.  Both
// evaluate their weights with footprint.cuh's sf_weight of the same
// arguments, so the BP is the exact transpose of the FP, and both give the
// first version's bits when built alike (with -fmad=false; nvcc contracts
// the two bodies' weights differently, ~1e-7 apart, otherwise).
//
// Precision.  Tiles are f32 or bf16; the weight is derived in f32 and, for
// bf16 tiles, rounded to bf16 before the multiply; sums are f32 into an f32
// output.  Tiles are read 16 bytes at a time only: the tile's address and
// its lanes' bytes are multiples of 16 (the wrappers in kernels/fp_par.py
// pad the lane axis where they are not).  No atomics: every output element is written by one thread, so
// results are deterministic.  A window that exceeds the host's bound (which
// the bounds in kernels/fp_par.py rule out) writes NaN, so it cannot pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "footprint.cuh"
#include "tile.cuh"

#define PAR_MARGIN 2        // voxels of margin of the FP's staged window
#define BP_UNROLL 3         // BP: columns a (voxel, view) summed unrolled
#define PAR_MAX_THREADS 1024
// FP and BP pack a first index and a count in 16 bits each
#define PAR_MAX_COUNT 65535

// Lanes in one 16-byte vector of a tile type.
template <typename T>
struct ParVec;
template <>
struct ParVec<float> {
  static constexpr int N = 4;
};
template <>
struct ParVec<__nv_bfloat16> {
  static constexpr int N = 8;
};

// The 16 bytes at p (16-byte aligned, shared memory) as floats.
__device__ __forceinline__ void par_load16(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void par_bf16x8(const uint4& v, float* x) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(b[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void par_load16(const __nv_bfloat16* p, float* x) {
  par_bf16x8(*reinterpret_cast<const uint4*>(p), x);
}
// The same from global memory, through the read-only cache.
__device__ __forceinline__ void par_ldg16(const float* p, float* x) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void par_ldg16(const __nv_bfloat16* p, float* x) {
  par_bf16x8(__ldg(reinterpret_cast<const uint4*>(p)), x);
}

// 16 bytes global -> shared, asynchronously, and the wait for all of them.
__device__ __forceinline__ void par_cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void par_cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float par_nan() { return __int_as_float(0x7fffffff); }

// FP: the gathered indices [*g0, *g1] (empty when *g0 > *g1) of the voxels
// on loop line li whose footprint meets the pixel [el, eh): the gi with
// t0 < eh and t3 > el, where t0 = uc - hs and t3 = uc + hs are rounded as
// sf_weight rounds them.  Every other gi gets a weight of exactly zero from
// sf_weight (both of its cdfs are then evaluated at the same clamped
// points).  uc is monotonic in gi, so the set is an interval: estimated
// from rP = 1/P, then moved to the exact tests' edges.
__device__ __forceinline__ void par_gather_window(float P, float Q, float R,
                                                  float hs, float rP, int li,
                                                  float el, float eh, int ng,
                                                  int* g0, int* g1) {
  const float ql = __fmul_rn(Q, (float)li);
  const bool up = P > 0.0f;
  // uc(g) exactly as sf_uc rounds it
  auto uc = [&](int g) {
    return __fadd_rn(__fadd_rn(__fmul_rn(P, (float)g), ql), R);
  };
  // A(g): true from some g on; B(g): true up to some g; the window is A && B
  auto A = [&](int g) {
    const float v = uc(g);
    return up ? __fadd_rn(v, hs) > el : __fsub_rn(v, hs) < eh;
  };
  auto B = [&](int g) {
    const float v = uc(g);
    return up ? __fsub_rn(v, hs) < eh : __fadd_rn(v, hs) > el;
  };
  const float c = __fadd_rn(ql, R);
  const float xa = (el - hs - c) * rP, xb = (eh + hs - c) * rP;
  int lo = min(max(clamp_floor(fminf(xa, xb), -1, ng) + 1, 0), ng);
  while (lo > 0 && A(lo - 1)) --lo;
  while (lo < ng && !A(lo)) ++lo;
  int hi = min(max(clamp_floor(fmaxf(xa, xb), -1, ng), -1), ng - 1);
  while (hi < ng - 1 && B(hi + 1)) ++hi;
  while (hi >= 0 && !B(hi)) --hi;
  *g0 = lo;
  *g1 = hi;
}

// BP: the detector columns [*u0, *u1] (empty when *u0 > *u1) whose pixel
// [el, el + du) meets the footprint (t0, t3): el + du > t0 and el < t3, as
// sf_weight rounds them; every other column's weight is exactly zero.
__device__ __forceinline__ void par_column_window(float t0, float t3,
                                                  float e0, float du,
                                                  float rdu, int nu, int* u0,
                                                  int* u1) {
  auto A = [&](int u) { return __fadd_rn(sf_edge(e0, du, u), du) > t0; };
  auto B = [&](int u) { return sf_edge(e0, du, u) < t3; };
  int lo = min(max(clamp_floor((t0 - e0) * rdu, -1, nu), 0), nu);
  while (lo > 0 && A(lo - 1)) --lo;
  while (lo < nu && !A(lo)) ++lo;
  int hi = min(max(clamp_floor((t3 - e0) * rdu, -1, nu), -1), nu - 1);
  while (hi < nu - 1 && B(hi + 1)) ++hi;
  while (hi >= 0 && !B(hi)) --hi;
  *u0 = lo;
  *u1 = hi;
}

// FP: the staged window [*G0, *G1] of a tile: the gathered indices that the
// footprints of columns u_first..u_last can meet on loop lines l0..l1 in any
// of the block's nvb views (sv: 8 floats a view, P Q R hs hd h 1/P and 1
// for a view, 0 for an empty slot), estimated with PAR_MARGIN voxels of
// margin on each side and clamped to the volume (empty: *G0 > *G1).  The
// exact windows are checked against it.  kernels/fp_par.py `_tile_window`
// is the host's copy.
__device__ __forceinline__ void par_tile_window(const float* sv, int nvb,
                                                float e0, float du,
                                                int u_first, int u_last,
                                                int l0, int l1, int ng,
                                                int* G0, int* G1) {
  const float el = sf_edge(e0, du, u_first);
  const float eh = __fadd_rn(sf_edge(e0, du, u_last), du);
  float lo = 3.0e38f, hi = -3.0e38f;
  for (int k = 0; k < nvb; ++k) {
    const float* v = sv + 8 * k;
    if (v[7] == 0.0f) continue;
    const float Q = v[1], R = v[2], hs = v[3], rP = v[6];
    const float tlo = __fsub_rn(el, hs), thi = __fadd_rn(eh, hs);
    const float c0 = __fadd_rn(__fmul_rn(Q, (float)l0), R);
    const float c1 = __fadd_rn(__fmul_rn(Q, (float)l1), R);
    const float x0 = __fmul_rn(__fsub_rn(tlo, c0), rP);
    const float x1 = __fmul_rn(__fsub_rn(thi, c0), rP);
    const float x2 = __fmul_rn(__fsub_rn(tlo, c1), rP);
    const float x3 = __fmul_rn(__fsub_rn(thi, c1), rP);
    lo = fminf(lo, fminf(fminf(x0, x1), fminf(x2, x3)));
    hi = fmaxf(hi, fmaxf(fmaxf(x0, x1), fmaxf(x2, x3)));
  }
  if (lo > hi) {
    *G0 = 0;
    *G1 = -1;
    return;
  }
  *G0 = max(clamp_floor(lo, -1, ng) - PAR_MARGIN, 0);
  *G1 = min(clamp_floor(hi, -1, ng) + 1 + PAR_MARGIN, ng - 1);
}

__host__ __device__ __forceinline__ size_t par_align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// FP: where the dynamic shared memory of a block of nvb views, tiles of tu
// columns and lane chunks of lc lanes (elem bytes each), lch loop lines a
// chunk, wcap staged rows and kw weights a pair puts each buffer (byte
// offsets), and its size.  The kernel carves its memory with it and the
// launch asks for `bytes`; kernels/fp_par.py `ParallelPlan.fp_layout` counts
// the same bytes to choose a layout and checks its count against this one
// (fp_par_sf_info) at each layout's first launch.
struct ParFpSmem {
  size_t sw, ss, sv, sbad, bytes;
};
__host__ __device__ __forceinline__ ParFpSmem par_fp_smem(int elem, int vn,
                                                          int tu, int lc,
                                                          int nvb, int lch,
                                                          int wcap, int kw) {
  const size_t pairs = (size_t)nvb * lch * tu;
  ParFpSmem m;
  m.sw = par_align16((size_t)wcap * (lch * lc + vn) * elem);  // staged slab
  m.ss = m.sw + pairs * kw * 4;                                 // weights
  m.sv = m.ss + pairs * 4;                                      // windows
  m.sbad = m.sv + 8 * 4 * (size_t)nvb;                          // view rows
  m.bytes = m.sbad + 4;                                         // bad flag
  return m;
}

// FP: copy the slab gi in [G0, G0 + gn), li in [l0, l0 + nlch), lanes
// [lane0, lane0 + nlc) to sx[(gi - G0) * row + (li - l0) * lc + lane] with
// 16-byte cp.async (nlc is a multiple of 16 bytes).  A (gi, li) entry's
// lanes are contiguous, and consecutive threads take consecutive pieces of
// an entry, then consecutive entries in the group's memory order (the
// x-gathered group's li, the y-gathered group's gi is the faster axis).
// A thread keeps one piece of its entries and walks the entries by pointer
// increments, with a carry into the slower axis.
template <typename T>
__device__ __forceinline__ void par_stage(T* sx, const T* __restrict__ g,
                                          int G0, int gn, int l0, int nlch,
                                          int lane0, int nlc, long long gs,
                                          long long ls, int row, int lc,
                                          int tid, int nt) {
  if (gn <= 0) return;
  constexpr int VN = ParVec<T>::N;
  const int nv = nlc / VN;                   // pieces of an entry
  const bool gfirst = gs < ls;
  const int M = gfirst ? gn : nlch, S = gfirst ? nlch : gn;  // fast, slow
  const long long fsrc = gfirst ? gs : ls, ssrc = gfirst ? ls : gs;
  const int fdst = gfirst ? row : lc, sdst = gfirst ? lc : row;
  // pieces v0, v0 + dv, ... of entries e0, e0 + de, ...
  int v0, dv, e, de;
  if (nv >= nt) {
    v0 = tid, dv = nt, e = 0, de = 1;
  } else {
    de = nt / nv, v0 = tid % nv, dv = nv, e = tid / nv;
    if (e >= de) return;
  }
  int s = e / M, f = e - s * M;
  const int ds = de / M, df = de - ds * M;
  const T* src = g + (long long)(l0 + (gfirst ? s : f)) * ls +
                 (long long)(G0 + (gfirst ? f : s)) * gs + lane0;
  T* dst = sx + (gfirst ? s : f) * lc + (gfirst ? f : s) * row;
  const long long src_step = df * fsrc + ds * ssrc, src_wrap = ssrc - M * fsrc;
  const int dst_step = df * fdst + ds * sdst, dst_wrap = sdst - M * fdst;
  while (s < S) {
    for (int v = v0; v < nv; v += dv) par_cp_async16(dst + v * VN, src + v * VN);
    f += df;
    s += ds;
    src += src_step;
    dst += dst_step;
    if (f >= M) {
      f -= M;
      ++s;
      src += src_wrap;
      dst += dst_wrap;
    }
  }
}

// FP: a block per (tile of blockDim.y columns, batch of blockDim.z
// neighbouring views, lane chunk of LPT * blockDim.x lanes); `batches`
// holds each batch's view indices (-1: an empty slot).  Thread (j, c, z)
// owns column c of the tile in view z of the batch and the lanes
// (i * blockDim.x + j) * VN .. + VN - 1 of the chunk, i < LPT / VN, so that
// each 16-byte read of the threads of one output is contiguous.  Per chunk
// of lch loop lines: the threads stage the slab that the batch's views
// meet (one slab for all of them), and meanwhile evaluate the exact window
// and the weights of every (view, line, column) once (sw, ss: start in the
// staged window << 16 | count); then each thread sums its output's terms.
template <typename T, int LPT>
__global__ void __launch_bounds__(PAR_MAX_THREADS)
    fp_par_sf_kernel(const float* __restrict__ table,
                     const int* __restrict__ rows,
                     const int* __restrict__ batches, const T* __restrict__ g,
                     float* __restrict__ out, int ng, int nl, int lanes,
                     long long gs, long long ls, int nu, float e0, float du,
                     int lch, int wcap, int kw) {
  constexpr int VN = ParVec<T>::N, NV = LPT / VN;
  extern __shared__ __align__(16) unsigned char par_smem[];
  const int tl = blockDim.x, tu = blockDim.y, nvb = blockDim.z;
  const int j = threadIdx.x, c = threadIdx.y, z = threadIdx.z;
  const int tid = j + tl * (c + tu * z), nt = tl * tu * nvb;
  const int lc = LPT * tl;
  const int row = lch * lc + VN;  // a staged gi row, padded by 16 bytes
  const ParFpSmem m = par_fp_smem(sizeof(T), VN, tu, lc, nvb, lch, wcap, kw);
  T* sx = reinterpret_cast<T*>(par_smem);
  float* sw = reinterpret_cast<float*>(par_smem + m.sw);
  unsigned* ss = reinterpret_cast<unsigned*>(par_smem + m.ss);
  float* sv = reinterpret_cast<float*>(par_smem + m.sv);
  int* sbad = reinterpret_cast<int*>(par_smem + m.sbad);

  // the view rows; a block may have fewer threads than the 8 nvb slots
  const int* vb = batches + (long long)blockIdx.y * nvb;
  for (int i = tid; i < 8 * nvb; i += nt) {
    const int a = __ldg(vb + (i >> 3)), f = i & 7;
    float v = 0.0f;
    if (a >= 0) {
      const float* p = table + 6 * a;
      v = f < 6 ? __ldg(p + f) : f == 6 ? __frcp_rn(__ldg(p)) : 1.0f;
    }
    sv[i] = v;
  }
  if (tid == 0) *sbad = 0;
  __syncthreads();

  const int a = __ldg(vb + z);
  const int u_first = blockIdx.x * tu;
  const int u_last = min(u_first + tu, nu) - 1;
  const int u = u_first + c;
  const int lane0 = blockIdx.z * lc;
  const int nlc = min(lc, lanes - lane0);
  const bool own = a >= 0 && u <= u_last;

  float acc[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) acc[k] = 0.0f;

  for (int l0 = 0; l0 < nl; l0 += lch) {
    const int nlch = min(lch, nl - l0);
    int G0, G1;
    par_tile_window(sv, nvb, e0, du, u_first, u_last, l0, l0 + nlch - 1, ng,
                    &G0, &G1);
    const int gn = min(G1 - G0 + 1, wcap);
    if (G1 - G0 + 1 > wcap) *sbad = 1;
    par_stage<T>(sx, g, G0, gn, l0, nlch, lane0, nlc, gs, ls, row, lc, tid,
                 nt);
    const int per_view = nlch * tu;
    for (int q = tid; q < nvb * per_view; q += nt) {
      const int zq = q / per_view, r = q - zq * per_view;
      const int l = r / tu, cq = r - l * tu, uq = u_first + cq;
      const int qi = (zq * lch + l) * tu + cq;
      const float* v = sv + 8 * zq;
      int s = 0, cnt = 0;
      if (v[7] != 0.0f && uq <= u_last) {
        const float P = v[0], Q = v[1], R = v[2], hs = v[3], hd = v[4],
                    h = v[5], rP = v[6];
        const float el = sf_edge(e0, du, uq), eh = __fadd_rn(el, du);
        int g0, g1;
        par_gather_window(P, Q, R, hs, rP, l0 + l, el, eh, ng, &g0, &g1);
        if (g0 <= g1) {
          if (g0 < G0 || g1 >= G0 + gn || g1 - g0 + 1 > kw) {
            *sbad = 1;
          } else {
            s = g0 - G0;
            cnt = g1 - g0 + 1;
            float* wq = sw + qi * kw;
            for (int k = 0; k < cnt; ++k)
              wq[k] = round_like<T>(sf_weight(
                  el, du, sf_uc(P, Q, R, g0 + k, l0 + l), hs, hd, h));
          }
        }
      }
      ss[qi] = (unsigned)s << 16 | (unsigned)cnt;
    }
    par_cp_async_wait();
    __syncthreads();
    if (own) {
      for (int l = 0; l < nlch; ++l) {
        const int qi = (z * lch + l) * tu + c;
        const unsigned sc = ss[qi];
        const int cnt = (int)(sc & 0xffffu);
        const float* wq = sw + qi * kw;
        const T* xq = sx + (sc >> 16) * row + l * lc + j * VN;
        for (int k = 0; k < cnt; ++k, xq += row) {
          const float w = wq[k];
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            float x[VN];
            par_load16(xq + i * tl * VN, x);
#pragma unroll
            for (int e = 0; e < VN; ++e) acc[i * VN + e] += w * x[e];
          }
        }
      }
    }
    __syncthreads();
  }
  if (!own) return;
  const bool bad = *sbad != 0;
  float* dst = out + ((long long)__ldg(rows + a) * nu + u) * lanes + lane0;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < VN; ++e) {
      const int lane = (i * tl + j) * VN + e;
      if (lane < nlc) dst[lane] = bad ? par_nan() : acc[i * VN + e];
    }
}

// BP (gather form): a thread per (voxel gi, li; LPT lanes), blockDim.x
// consecutive threads of a warp per voxel carrying its chunk of
// LPT * blockDim.x lanes (the FP's lane assignment), blockDim.y x
// blockDim.z voxels a block.  The voxel's threads take the views blockDim.x at a
// time: thread j finds the exact column window of view a0 + j and its
// weights and leaves them in its slots of the warp's shared memory (su:
// first column << 16 | count; sw: the weights); then every thread of the
// voxel sums, view after view and column after column, the weights times
// its lanes of the sinogram.  `accumulate` adds into the buffer (the second
// view group) instead of overwriting it (the first).
template <typename T, int LPT>
__global__ void __launch_bounds__(PAR_MAX_THREADS)
    bp_par_sf_kernel(const float* __restrict__ table,
                     const int* __restrict__ rows, int n_views,
                     const T* __restrict__ q, float* __restrict__ out, int ng,
                     int nl, int lanes, long long gs, long long ls, int nu,
                     float e0, float du, int accumulate, int ku) {
  constexpr int VN = ParVec<T>::N, NV = LPT / VN;
  extern __shared__ __align__(16) unsigned char par_smem[];
  const int tl = blockDim.x, j = threadIdx.x;
  const int gi = blockIdx.x * blockDim.y + threadIdx.y;
  const int li = blockIdx.y * blockDim.z + threadIdx.z;
  const int lc = LPT * tl, lane0 = blockIdx.z * lc;
  const int nlc = min(lc, lanes - lane0);
  const int tid = j + tl * (threadIdx.y + blockDim.y * threadIdx.z);
  const int wl = tid & 31, first = wl - j, kup = ku | 1;
  float* sw = reinterpret_cast<float*>(par_smem) + (tid >> 5) * 32 * (kup + 1);
  unsigned* su = reinterpret_cast<unsigned*>(sw + 32 * kup);
  const bool live = gi < ng && li < nl;
  const float rdu = __frcp_rn(du);

  float acc[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) acc[k] = 0.0f;
  bool bad = false;

  for (int a0 = 0; a0 < n_views; a0 += tl) {
    const int a = a0 + j;
    int u0 = 0, cnt = 0;
    if (live && a < n_views) {
      const float* p = table + 6 * a;
      const float P = __ldg(p), Q = __ldg(p + 1), R = __ldg(p + 2);
      const float hs = __ldg(p + 3), hd = __ldg(p + 4), h = __ldg(p + 5);
      const float uc = sf_uc(P, Q, R, gi, li);
      int u1;
      par_column_window(__fsub_rn(uc, hs), __fadd_rn(uc, hs), e0, du, rdu, nu,
                        &u0, &u1);
      cnt = max(u1 - u0 + 1, 0);
      if (cnt > ku) {
        cnt = ku + 1;
      } else {
        for (int k = 0; k < cnt; ++k)
          sw[wl * kup + k] = round_like<T>(
              sf_weight(sf_edge(e0, du, u0 + k), du, uc, hs, hd, h));
      }
    }
    su[wl] = (unsigned)u0 << 16 | (unsigned)cnt;
    __syncwarp();
    if (live) {
      const int nb = min(tl, n_views - a0);
      for (int b = 0; b < nb; ++b) {
        const unsigned pk = su[first + b];
        const int cb = (int)(pk & 0xffffu);
        if (cb > ku) {
          bad = true;
          continue;
        }
        const float* wb = sw + (first + b) * kup;
        const T* xb = q + ((long long)__ldg(rows + a0 + b) * nu + (pk >> 16)) *
                              lanes + lane0;
        // one column's terms; the first BP_UNROLL columns unrolled, so
        // that their loads are in flight together
        auto column = [&](int k) {
          const float w = wb[k];
          const T* xk = xb + (long long)k * lanes;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int v0 = (i * tl + j) * VN;
            if (v0 < nlc) {
              float x[VN];
              par_ldg16(xk + v0, x);
#pragma unroll
              for (int e = 0; e < VN; ++e) acc[i * VN + e] += w * x[e];
            }
          }
        };
#pragma unroll
        for (int k = 0; k < BP_UNROLL; ++k)
          if (k < cb) column(k);
        for (int k = BP_UNROLL; k < cb; ++k) column(k);
      }
    }
    __syncwarp();
  }
  if (!live) return;
  float* dst = out + (long long)gi * gs + (long long)li * ls + lane0;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < VN; ++e) {
      const int lane = (i * tl + j) * VN + e;
      if (lane < nlc) {
        const float v = accumulate ? dst[lane] + acc[i * VN + e]
                                   : acc[i * VN + e];
        dst[lane] = bad ? par_nan() : v;
      }
    }
}

// Bytes of the BP's warp slots for `threads` threads and `ku` columns.
static int bp_smem_bytes(int threads, int ku) {
  return (threads + 31) / 32 * 32 * ((ku | 1) + 1) * 4;
}

template <typename K>
static cudaError_t par_smem_attr(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Call F::template run<T, LPT>() for the instance of dtype (0 = float32, 1 =
// bfloat16 tiles) and lpt (8 or 16 lanes a thread).
template <class F>
static cudaError_t par_dispatch(int dtype, int lpt, F f) {
  if ((dtype != 0 && dtype != 1) || (lpt != 8 && lpt != 16))
    return cudaErrorInvalidValue;
  if (dtype == 0)
    return lpt == 8 ? f.template run<float, 8>() : f.template run<float, 16>();
  return lpt == 8 ? f.template run<__nv_bfloat16, 8>()
                  : f.template run<__nv_bfloat16, 16>();
}

extern "C" const char* fp_par_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

namespace {

// The launches of one FP, one BP, or an occupancy query, for par_dispatch.
struct ParFpRun {
  dim3 grid, block;
  int smem;
  cudaStream_t s;
  const float* table;
  const int* rows;
  const int* batches;
  const void* g;
  float* out;
  int ng, nl, lanes;
  long long gs, ls;
  int nu;
  float e0, du;
  int lch, wcap, kw;
  template <typename T, int L>
  cudaError_t run() const {
    auto k = fp_par_sf_kernel<T, L>;
    const cudaError_t err = par_smem_attr(k, smem);
    if (err != cudaSuccess) return err;
    k<<<grid, block, smem, s>>>(table, rows, batches, (const T*)g, out, ng, nl,
                                lanes, gs, ls, nu, e0, du, lch, wcap, kw);
    return cudaGetLastError();
  }
};

struct ParBpRun {
  dim3 grid, block;
  int smem;
  cudaStream_t s;
  const float* table;
  const int* rows;
  int n_views;
  const void* q;
  float* out;
  int ng, nl, lanes;
  long long gs, ls;
  int nu;
  float e0, du;
  int accumulate, ku;
  template <typename T, int L>
  cudaError_t run() const {
    auto k = bp_par_sf_kernel<T, L>;
    const cudaError_t err = par_smem_attr(k, smem);
    if (err != cudaSuccess) return err;
    k<<<grid, block, smem, s>>>(table, rows, n_views, (const T*)q, out, ng, nl,
                                lanes, gs, ls, nu, e0, du, accumulate, ku);
    return cudaGetLastError();
  }
};

template <typename K>
cudaError_t par_occupancy(K kernel, int threads, int smem, int* blocks) {
  const cudaError_t err = par_smem_attr(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads,
                                                       smem);
}

struct ParOcc {
  int fp, threads, smem;
  int* blocks;
  template <typename T, int L>
  cudaError_t run() const {
    return fp ? par_occupancy(fp_par_sf_kernel<T, L>, threads, smem, blocks)
              : par_occupancy(bp_par_sf_kernel<T, L>, threads, smem, blocks);
  }
};

int par_elem(int dtype) { return dtype == 0 ? 4 : 2; }

// The kernels read tiles 16 bytes at a time: the tile's address and its
// lanes' bytes must be multiples of 16.
bool par_aligned(const void* x, int lanes, int dtype) {
  return (uintptr_t)x % 16 == 0 && lanes * par_elem(dtype) % 16 == 0;
}

}  // namespace

// The dynamic shared memory of the FP of dtype at a layout, in bytes.
static int fp_smem_bytes(int dtype, int tu, int tl, int lpt, int nvb, int lch,
                         int wcap, int kw) {
  const int elem = par_elem(dtype);
  return (int)par_fp_smem(elem, 16 / elem, tu, lpt * tl, nvb, lch, wcap, kw)
      .bytes;
}

// The FP of kernels/fp_par.py `ParallelPlan.fp_layout`: tu columns x tl
// threads a column of lpt lanes x nvb views a block, over n_batches
// batches of nvb views (`batches`), lch loop lines a chunk, wcap staged gi
// rows, kw weights a (view, line, column).  The tile's address and its
// lanes' bytes are multiples of 16.  Returns the error of the launch (a
// failed shared-memory attribute included; 0 when the launch was accepted).
extern "C" int fp_par_sf_launch(int dtype, const void* table, const void* rows,
                                int n_views, const void* g, void* out, int ng,
                                int nl, int lanes, long long gs, long long ls,
                                int nu, float e0, float du,
                                const void* batches, int n_batches, int tu,
                                int tl, int lpt, int nvb, int lch, int wcap,
                                int kw, void* stream) {
  if (n_views == 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (!par_aligned(g, lanes, dtype)) return (int)cudaErrorMisalignedAddress;
  if (wcap < 1 || wcap > 65535 || kw < 1 || kw > PAR_MAX_COUNT)
    return (int)cudaErrorInvalidValue;
  const int lc = lpt * tl;
  const ParFpRun run{
      dim3((nu + tu - 1) / tu, n_batches, (lanes + lc - 1) / lc),
      dim3(tl, tu, nvb),
      fp_smem_bytes(dtype, tu, tl, lpt, nvb, lch, wcap, kw),
      (cudaStream_t)stream, (const float*)table, (const int*)rows,
      (const int*)batches, g, (float*)out, ng, nl, lanes, gs, ls, nu, e0, du,
      lch, wcap, kw};
  return (int)par_dispatch(dtype, lpt, run);
}

// The BP of `ParallelPlan.bp_layout`: bx x by voxels (gi x li) and tl
// threads a voxel of lpt lanes a block, ku columns a (voxel, view) at most;
// 16-byte aligned as the FP.
extern "C" int bp_par_sf_launch(int dtype, const void* table, const void* rows,
                                int n_views, const void* q, void* out, int ng,
                                int nl, int lanes, long long gs, long long ls,
                                int nu, float e0, float du, int accumulate,
                                int bx, int by, int tl, int lpt, int ku,
                                void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (!par_aligned(q, lanes, dtype)) return (int)cudaErrorMisalignedAddress;
  if (ku < 1 || ku > PAR_MAX_COUNT - 1 || nu > 65536)
    return (int)cudaErrorInvalidValue;
  const int lc = lpt * tl;
  const ParBpRun run{
      dim3((ng + bx - 1) / bx, (nl + by - 1) / by, (lanes + lc - 1) / lc),
      dim3(tl, bx, by), bp_smem_bytes(tl * bx * by, ku), (cudaStream_t)stream,
      (const float*)table, (const int*)rows, n_views, q, (float*)out, ng, nl,
      lanes, gs, ls, nu, e0, du, accumulate, ku};
  return (int)par_dispatch(dtype, lpt, run);
}

// The FP instance of dtype and lpt at a layout (as fp_par_sf_launch takes
// it): the dynamic shared memory the launch asks for (*smem, bytes; the
// host checks its own count against it) and resident blocks per SM at that
// size on this card (*blocks).  Returns the CUDA error.
extern "C" int fp_par_sf_info(int dtype, int tu, int tl, int lpt, int nvb,
                              int lch, int wcap, int kw, int* smem,
                              int* blocks) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  *smem = fp_smem_bytes(dtype, tu, tl, lpt, nvb, lch, wcap, kw);
  const ParOcc occ{1, tl * tu * nvb, *smem, blocks};
  return (int)par_dispatch(dtype, lpt, occ);
}

// The same for the BP instance with `threads` threads a block and ku
// columns a (voxel, view).
extern "C" int bp_par_sf_info(int dtype, int lpt, int threads, int ku,
                              int* smem, int* blocks) {
  *smem = bp_smem_bytes(threads, ku);
  const ParOcc occ{0, threads, *smem, blocks};
  return (int)par_dispatch(dtype, lpt, occ);
}
