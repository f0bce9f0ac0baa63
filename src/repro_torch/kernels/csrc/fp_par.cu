// Parallel-beam Separable-Footprint forward projection (FP) and its exact
// transpose, the backprojection (BP), for Hopper (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/fp_par.py:122 `_fp_kernel`
// and src/repro/kernels/fp_par.py:264 `_bp_kernel`.  Both compute what those
// compute, not how: the TPU kernels contract a (columns x window) weight
// tile against a volume window on the matrix unit and carry the sum across
// a sequential grid axis; on this card blocks run in no order, so each
// thread owns its output and loops over the summed axis itself.
//
// Layout.  The axial (z -> detector row) part of the footprint is applied
// outside the kernels, so the innermost axis is `lanes` = batch x rows,
// contiguous in memory.  Views come in two groups (kernels/fp_par.py,
// `_view_params`): in the x-gathered group the gathered index gi is ix and
// the loop index li is iy, in the y-gathered group the other way round.
// The kernels take the (gi, li) strides of the one (nx, ny, lanes) buffer,
// so neither group needs a transposed copy.  Each view row of `table` is
// (P, Q, R, hs, hd, h): the voxel centre (gi, li) projects to
// uc = P*gi + Q*li + R with trapezoid half-widths hs, hd and plateau h.
// `rows[a]` is the sinogram row of the group's a-th view.
//
// What bounds them.  Both read little (the main 2D training cell moves
// ~26 MB) and do a lot of arithmetic per byte: each weight costs ~40 f32
// operations and is recomputed wherever it is needed, so they are bound by
// operations, not by memory.  The design answers that in two ways: a
// thread carries LPT lanes so one weight serves LPT multiply-adds, and the
// summed range is cut to the voxels (FP) or columns (BP) whose footprint
// can meet the output, about 3-6 per step.  Sharing weights across threads
// through shared memory is later work.
//
// Precision.  Tiles are f32 or bf16; the weight is derived in f32 and, for
// bf16 tiles, rounded to bf16 before the multiply; sums are f32 into an f32
// output.  No atomics: every output element is written by one thread, so
// results are deterministic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "footprint.cuh"
#include "tile.cuh"

#define LPT 8  // lanes per thread; kernels/tune.py LANES_PER_THREAD

// FP: one thread per (view a, detector column u, LPT lanes).  For each loop
// index li it sums weight x volume over the gathered voxels whose
// footprint [uc - hs, uc + hs] can meet the pixel [el, el + du].
template <typename T>
__global__ void fp_par_sf_kernel(const float* __restrict__ table,
                                 const int* __restrict__ rows,
                                 const T* __restrict__ g,
                                 float* __restrict__ out, int ng, int nl,
                                 int lanes, long long gs, long long ls,
                                 int nu, float e0, float du) {
  const int a = blockIdx.y;
  const int u = blockIdx.x * blockDim.y + threadIdx.y;
  const int lane0 = (blockIdx.z * blockDim.x + threadIdx.x) * LPT;
  if (u >= nu || lane0 >= lanes) return;
  const float* p = table + 6 * a;
  const float P = __ldg(p), Q = __ldg(p + 1), R = __ldg(p + 2);
  const float hs = __ldg(p + 3), hd = __ldg(p + 4), h = __ldg(p + 5);
  const int nlane = min(LPT, lanes - lane0);
  const float el = sf_edge(e0, du, u);
  const float lo = el - hs, hi = el + du + hs;

  float acc[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) acc[j] = 0.0f;

  for (int li = 0; li < nl; ++li) {
    // gathered indices whose centre lands in (lo, hi), one voxel of margin
    const float base = __fadd_rn(__fmul_rn(Q, (float)li), R);
    const float ga = (lo - base) / P, gb = (hi - base) / P;
    const int g0 = max((int)floorf(fminf(ga, gb)) - 1, 0);
    const int g1 = min((int)ceilf(fmaxf(ga, gb)) + 1, ng - 1);
    const T* line = g + (long long)li * ls + lane0;
    for (int gi = g0; gi <= g1; ++gi) {
      const float w =
          round_like<T>(sf_weight(el, du, sf_uc(P, Q, R, gi, li), hs, hd, h));
      const T* src = line + (long long)gi * gs;
#pragma unroll
      for (int j = 0; j < LPT; ++j)
        if (j < nlane) acc[j] += w * to_f32(src[j]);
    }
  }
  float* dst = out + ((long long)rows[a] * nu + u) * lanes + lane0;
#pragma unroll
  for (int j = 0; j < LPT; ++j)
    if (j < nlane) dst[j] = acc[j];
}

// BP (gather form): one thread per (gi, li, LPT lanes) output voxel, looping
// over the group's views and, per view, over the detector columns its
// footprint meets.  `accumulate` adds into the buffer (the second view
// group) instead of overwriting it (the first).
template <typename T>
__global__ void bp_par_sf_kernel(const float* __restrict__ table,
                                 const int* __restrict__ rows, int n_views,
                                 const T* __restrict__ q,
                                 float* __restrict__ out, int ng, int nl,
                                 int lanes, long long gs, long long ls,
                                 int nu, float e0, float du, int accumulate) {
  const int gi = blockIdx.x * blockDim.y + threadIdx.y;
  const int li = blockIdx.y;
  const int lane0 = (blockIdx.z * blockDim.x + threadIdx.x) * LPT;
  if (gi >= ng || lane0 >= lanes) return;
  const int nlane = min(LPT, lanes - lane0);

  float acc[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) acc[j] = 0.0f;

  for (int a = 0; a < n_views; ++a) {
    const float* p = table + 6 * a;
    const float P = __ldg(p), Q = __ldg(p + 1), R = __ldg(p + 2);
    const float hs = __ldg(p + 3), hd = __ldg(p + 4), h = __ldg(p + 5);
    const float uc = sf_uc(P, Q, R, gi, li);
    // columns whose pixel can meet [uc - hs, uc + hs], one of margin
    const int u0 = max((int)floorf((uc - hs - e0) / du) - 1, 0);
    const int u1 = min((int)floorf((uc + hs - e0) / du) + 1, nu - 1);
    const T* sino = q + (long long)__ldg(rows + a) * nu * lanes + lane0;
    for (int u = u0; u <= u1; ++u) {
      const float w =
          round_like<T>(sf_weight(sf_edge(e0, du, u), du, uc, hs, hd, h));
      const T* src = sino + (long long)u * lanes;
#pragma unroll
      for (int j = 0; j < LPT; ++j)
        if (j < nlane) acc[j] += w * to_f32(src[j]);
    }
  }
  float* dst = out + (long long)gi * gs + (long long)li * ls + lane0;
#pragma unroll
  for (int j = 0; j < LPT; ++j) {
    if (j < nlane) dst[j] = accumulate ? dst[j] + acc[j] : acc[j];
  }
}

static dim3 lane_blocks(int lanes, int lg) {
  const int groups = (lanes + LPT - 1) / LPT;
  return dim3(1, 1, (groups + lg - 1) / lg);
}

extern "C" const char* fp_par_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32 tiles, 1 = bfloat16 tiles.  Returns cudaGetLastError()
// after the launch (0 when the launch was accepted).
extern "C" int fp_par_sf_launch(int dtype, const void* table, const void* rows,
                                int n_views, const void* g, void* out, int ng,
                                int nl, int lanes, long long gs, long long ls,
                                int nu, float e0, float du, int bu, int lg,
                                void* stream) {
  if (n_views == 0) return 0;
  const dim3 block(lg, bu);
  dim3 grid = lane_blocks(lanes, lg);
  grid.x = (nu + bu - 1) / bu;
  grid.y = n_views;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    fp_par_sf_kernel<float><<<grid, block, 0, s>>>(
        (const float*)table, (const int*)rows, (const float*)g, (float*)out,
        ng, nl, lanes, gs, ls, nu, e0, du);
  } else {
    fp_par_sf_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const float*)table, (const int*)rows, (const __nv_bfloat16*)g,
        (float*)out, ng, nl, lanes, gs, ls, nu, e0, du);
  }
  return (int)cudaGetLastError();
}

extern "C" int bp_par_sf_launch(int dtype, const void* table, const void* rows,
                                int n_views, const void* q, void* out, int ng,
                                int nl, int lanes, long long gs, long long ls,
                                int nu, float e0, float du, int accumulate,
                                int bg, int lg, void* stream) {
  const dim3 block(lg, bg);
  dim3 grid = lane_blocks(lanes, lg);
  grid.x = (ng + bg - 1) / bg;
  grid.y = nl;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    bp_par_sf_kernel<float><<<grid, block, 0, s>>>(
        (const float*)table, (const int*)rows, n_views, (const float*)q,
        (float*)out, ng, nl, lanes, gs, ls, nu, e0, du, accumulate);
  } else {
    bp_par_sf_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const float*)table, (const int*)rows, n_views,
        (const __nv_bfloat16*)q, (float*)out, ng, nl, lanes, gs, ls, nu, e0,
        du, accumulate);
  }
  return (int)cudaGetLastError();
}
