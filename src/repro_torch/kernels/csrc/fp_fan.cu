// Fan-beam Separable-Footprint forward projection (FP) and its exact
// transpose, the backprojection (BP), for Hopper (sm_90a), on a flat or a
// curved (equiangular) detector.
//
// Replaces the TPU kernels src/repro/kernels/fp_fan.py:94 `_fp_fan_kernel`
// and src/repro/kernels/fp_fan.py:247 `_bp_fan_kernel`.  Both compute what
// those compute, not how: each thread owns its output and loops over the
// summed axis (see fp_par.cu, whose layout these kernels share).
//
// Layout.  As in fp_par.cu: the axial part of the footprint is applied
// outside the kernels, the innermost axis is `lanes` = batch x rows, and the
// x- and y-gathered view groups read the one (nx, ny, lanes) buffer through
// (gi, li) strides.  Each view row of `table` is the 20 floats of
// kernels/fp_cone.py `_view_params_cone`; the weight is the corner-
// projection trapezoid of footprint.cuh `sf_corner_trapezoid`, the same
// device function as the cone kernels', so FP and BP evaluate the same
// weights.
//
// What bounds them.  At the sparse-view fan cell (512^2 volume, 360 views,
// 768 columns, 8 lanes) they move ~36 MB but evaluate ~2.3e8 weights of
// ~100 f32 operations each (four corner divisions or arctangents, a sqrt,
// the trapezoid integral), so operations bound them.  As in fp_par.cu a
// thread carries LPT lanes so one weight serves LPT multiply-adds, and the
// summed range is cut to what the footprint can meet: the FP inverts the
// centre projection at the column's edges widened by `hw`, a bound on the
// footprint's half-width (footprint.cuh `sf_gather_window`); the BP takes
// the columns between the trapezoid's outer breakpoints.
//
// Precision.  Tiles are f32 or bf16; the weight is derived in f32 and, for
// bf16 tiles, rounded to bf16 before the multiply; sums are f32 into an f32
// output.  No atomics, deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "footprint.cuh"
#include "tile.cuh"

#define LPT 8  // lanes per thread; kernels/tune.py LANES_PER_THREAD

// FP: one thread per (view a, detector column u, LPT lanes).
template <typename T, bool CURVED>
__global__ void fp_fan_sf_kernel(const float* __restrict__ table,
                                 const int* __restrict__ rows,
                                 const T* __restrict__ g,
                                 float* __restrict__ out, int ng, int nl,
                                 int lanes, long long gs, long long ls,
                                 int nu, float e0, float du, float sdd,
                                 float dxv, float hw) {
  const int a = blockIdx.y;
  const int u = blockIdx.x * blockDim.y + threadIdx.y;
  const int lane0 = (blockIdx.z * blockDim.x + threadIdx.x) * LPT;
  if (u >= nu || lane0 >= lanes) return;
  const float* P = table + 20 * a;
  const int nlane = min(LPT, lanes - lane0);
  const float el = sf_edge(e0, du, u);

  float acc[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) acc[j] = 0.0f;

  for (int li = 0; li < nl; ++li) {
    int g0, g1;
    sf_gather_window(P, li, el - hw, el + du + hw, sdd, CURVED, ng, &g0, &g1);
    const T* line = g + (long long)li * ls + lane0;
    for (int gi = g0; gi <= g1; ++gi) {
      const SfTrap tr = sf_corner_trapezoid(P, gi, li, sdd, dxv, CURVED);
      const float w = round_like<T>(
          sf_pixel_weight(el, du, tr.t0, tr.t1, tr.t2, tr.t3, tr.h));
      if (w == 0.0f) continue;
      const T* src = line + (long long)gi * gs;
#pragma unroll
      for (int j = 0; j < LPT; ++j)
        if (j < nlane) acc[j] += w * to_f32(src[j]);
    }
  }
  float* dst = out + ((long long)__ldg(rows + a) * nu + u) * lanes + lane0;
#pragma unroll
  for (int j = 0; j < LPT; ++j)
    if (j < nlane) dst[j] = acc[j];
}

// BP (gather form): one thread per (gi, li, LPT lanes) output voxel, looping
// over the group's views and, per view, over the detector columns between
// the trapezoid's outer breakpoints (one of margin).  `accumulate` adds into
// the buffer (the second view group) instead of overwriting it (the first).
template <typename T, bool CURVED>
__global__ void bp_fan_sf_kernel(const float* __restrict__ table,
                                 const int* __restrict__ rows, int n_views,
                                 const T* __restrict__ q,
                                 float* __restrict__ out, int ng, int nl,
                                 int lanes, long long gs, long long ls,
                                 int nu, float e0, float du, float sdd,
                                 float dxv, int accumulate) {
  const int gi = blockIdx.x * blockDim.y + threadIdx.y;
  const int li = blockIdx.y;
  const int lane0 = (blockIdx.z * blockDim.x + threadIdx.x) * LPT;
  if (gi >= ng || lane0 >= lanes) return;
  const int nlane = min(LPT, lanes - lane0);

  float acc[LPT];
#pragma unroll
  for (int j = 0; j < LPT; ++j) acc[j] = 0.0f;

  for (int a = 0; a < n_views; ++a) {
    const SfTrap tr = sf_corner_trapezoid(table + 20 * a, gi, li, sdd, dxv,
                                          CURVED);
    const float lo = fminf(fmaxf((tr.t0 - e0) / du, -2.0f), (float)nu);
    const float hi = fminf(fmaxf((tr.t3 - e0) / du, -2.0f), (float)nu);
    const int u0 = max((int)floorf(lo) - 1, 0);
    const int u1 = min((int)floorf(hi) + 1, nu - 1);
    const T* sino = q + (long long)__ldg(rows + a) * nu * lanes + lane0;
    for (int u = u0; u <= u1; ++u) {
      const float w = round_like<T>(sf_pixel_weight(
          sf_edge(e0, du, u), du, tr.t0, tr.t1, tr.t2, tr.t3, tr.h));
      if (w == 0.0f) continue;
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

extern "C" const char* fp_fan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

template <typename T>
static void fp_fan_dispatch(dim3 grid, dim3 block, cudaStream_t s, int curved,
                            const float* table, const int* rows, const void* g,
                            float* out, int ng, int nl, int lanes, long long gs,
                            long long ls, int nu, float e0, float du, float sdd,
                            float dxv, float hw) {
  if (curved) {
    fp_fan_sf_kernel<T, true><<<grid, block, 0, s>>>(
        table, rows, (const T*)g, out, ng, nl, lanes, gs, ls, nu, e0, du, sdd,
        dxv, hw);
  } else {
    fp_fan_sf_kernel<T, false><<<grid, block, 0, s>>>(
        table, rows, (const T*)g, out, ng, nl, lanes, gs, ls, nu, e0, du, sdd,
        dxv, hw);
  }
}

template <typename T>
static void bp_fan_dispatch(dim3 grid, dim3 block, cudaStream_t s, int curved,
                            const float* table, const int* rows, int n_views,
                            const void* q, float* out, int ng, int nl,
                            int lanes, long long gs, long long ls, int nu,
                            float e0, float du, float sdd, float dxv,
                            int accumulate) {
  if (curved) {
    bp_fan_sf_kernel<T, true><<<grid, block, 0, s>>>(
        table, rows, n_views, (const T*)q, out, ng, nl, lanes, gs, ls, nu, e0,
        du, sdd, dxv, accumulate);
  } else {
    bp_fan_sf_kernel<T, false><<<grid, block, 0, s>>>(
        table, rows, n_views, (const T*)q, out, ng, nl, lanes, gs, ls, nu, e0,
        du, sdd, dxv, accumulate);
  }
}

// dtype: 0 = float32 tiles, 1 = bfloat16 tiles; curved: 0 = flat, 1 =
// equiangular.  Returns cudaGetLastError() after the launch.
extern "C" int fp_fan_sf_launch(int dtype, const void* table, const void* rows,
                                int n_views, const void* g, void* out, int ng,
                                int nl, int lanes, long long gs, long long ls,
                                int nu, float e0, float du, float sdd,
                                float dxv, float hw, int curved, int bu, int lg,
                                void* stream) {
  if (n_views == 0) return 0;
  const dim3 block(lg, bu);
  dim3 grid = lane_blocks(lanes, lg);
  grid.x = (nu + bu - 1) / bu;
  grid.y = n_views;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    fp_fan_dispatch<float>(grid, block, s, curved, (const float*)table,
                           (const int*)rows, g, (float*)out, ng, nl, lanes,
                           gs, ls, nu, e0, du, sdd, dxv, hw);
  } else {
    fp_fan_dispatch<__nv_bfloat16>(grid, block, s, curved, (const float*)table,
                                   (const int*)rows, g, (float*)out, ng, nl,
                                   lanes, gs, ls, nu, e0, du, sdd, dxv, hw);
  }
  return (int)cudaGetLastError();
}

extern "C" int bp_fan_sf_launch(int dtype, const void* table, const void* rows,
                                int n_views, const void* q, void* out, int ng,
                                int nl, int lanes, long long gs, long long ls,
                                int nu, float e0, float du, float sdd,
                                float dxv, int curved, int accumulate, int bg,
                                int lg, void* stream) {
  const dim3 block(lg, bg);
  dim3 grid = lane_blocks(lanes, lg);
  grid.x = (ng + bg - 1) / bg;
  grid.y = nl;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    bp_fan_dispatch<float>(grid, block, s, curved, (const float*)table,
                           (const int*)rows, n_views, q, (float*)out, ng, nl,
                           lanes, gs, ls, nu, e0, du, sdd, dxv, accumulate);
  } else {
    bp_fan_dispatch<__nv_bfloat16>(grid, block, s, curved, (const float*)table,
                                   (const int*)rows, n_views, q, (float*)out,
                                   ng, nl, lanes, gs, ls, nu, e0, du, sdd, dxv,
                                   accumulate);
  }
  return (int)cudaGetLastError();
}
