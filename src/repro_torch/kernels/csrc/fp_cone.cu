// Exact cone-beam (flat detector) Separable-Footprint forward projection
// (FP) and its exact transpose, the backprojection (BP), for Hopper
// (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/fp_cone.py:183
// `_fp_cone_kernel` and src/repro/kernels/fp_cone.py:346 `_bp_cone_kernel`.
// Both compute what those compute, not how: the TPU kernels contract a
// (columns x window) transaxial weight tile and a per-element (rows x z)
// rect-overlap matrix on the matrix unit and carry the sum across
// sequential grid steps; here each thread owns its outputs and loops over
// the summed axes itself.  No atomics: every output element is written by
// one thread, so results are deterministic.
//
// Weight of voxel (gi, li, z) at detector pixel (u, v) in one view:
//   wu(u) x round_like(ov(z, v) x obl(z)),
// wu the corner-projection trapezoid's mean over column u
// (footprint.cuh `sf_corner_trapezoid`, `sf_pixel_weight`), ov the overlap
// of row v with the axial rectangle [(z - dz/2), (z + dz/2)] x sdd / ell
// over dv, obl = sqrt(1 + z^2 / rt2).  The batch cannot share a lane axis
// with the rows here (the axial magnification is per voxel), so the volume
// is (batch, nx, ny, nz) and the sinogram (batch, n_angles, nv, nu); the
// batch is folded into the grid.
//
// What bounds them.  At the 512^3 / 180-view cell the FP reads 537 MB and
// writes 283 MB, but each weight costs ~100 f32 operations (four corner
// divisions, a sqrt, the trapezoid integral) and is recomputed wherever it
// is needed, so they are bound by operations.  The design answers that by
// reuse inside a thread: an FP thread carries RPT consecutive detector rows
// and a BP thread ZPT consecutive z slices, so one transaxial weight serves
// all of them, and the loops are cut to the voxels (FP) or columns and rows
// (BP) whose footprint can meet the output.  Sharing weights across threads
// through shared memory is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "footprint.cuh"
#include "tile.cuh"

#define RPT 4  // FP detector rows per thread
#define ZPT 8  // BP z slices per thread
// Threads in a block.  With at least four blocks per SM the BP gets at most
// 128 registers a thread: unbounded, its f32 instance took 230, which
// leaves room for two blocks of 128 threads per SM.
#define CONE_THREADS 128

// Integer part of x clamped to [lo, hi] before the conversion, so that a
// huge quotient cannot overflow the int.
__device__ __forceinline__ int clamp_floor(float x, int lo, int hi) {
  return (int)floorf(fminf(fmaxf(x, (float)lo), (float)hi));
}

// Axial weight of slice extent [vlo, vhi] (detector mm) over the row whose
// lower edge is elv, times the obliquity: the float expression of
// fp_cone.py `_fp_chunk`.
__device__ __forceinline__ float axial_weight(float vlo, float vhi, float elv,
                                              float dv, float obl) {
  const float ov = __fdiv_rn(
      fmaxf(__fsub_rn(fminf(vhi, __fadd_rn(elv, dv)), fmaxf(vlo, elv)), 0.0f),
      dv);
  return __fmul_rn(ov, obl);
}

// The slice's axial extent at magnification mag and its obliquity.
__device__ __forceinline__ void slice_extent(int k, float z0, float dz,
                                             float mag, float rt2, float* vlo,
                                             float* vhi, float* obl) {
  const float zt = __fadd_rn(z0, __fmul_rn((float)k, dz));
  const float hdz = 0.5f * dz;
  *vlo = __fmul_rn(__fsub_rn(zt, hdz), mag);
  *vhi = __fmul_rn(__fadd_rn(zt, hdz), mag);
  *obl = __fsqrt_rn(__fadd_rn(1.0f, __fdiv_rn(__fmul_rn(zt, zt), rt2)));
}

// FP: one thread per (sample b, view a, detector column u, RPT rows).  For
// each loop index li it visits the gathered voxels whose footprint can meet
// column u (footprint.cuh `sf_gather_window`, the column widened by hw, a
// bound on the footprint's half-width), and per voxel the z slices whose
// axial rectangle can meet the thread's rows.
template <typename T>
__global__ void __launch_bounds__(CONE_THREADS)
    fp_cone_sf_kernel(const float* __restrict__ table,
                      const int* __restrict__ rows, int n_views, int na,
                      const T* __restrict__ f, float* __restrict__ out, int ng,
                      int nl, int nz, long long gs, long long ls, int nu,
                      int nv, float e0, float du, float ev0, float dv,
                      float z0, float dz, float sdd, float dxv, float hw) {
  const int b = blockIdx.x / n_views;
  const int a = blockIdx.x - b * n_views;
  const int u = blockIdx.y * blockDim.y + threadIdx.y;
  const int v0 = (blockIdx.z * blockDim.x + threadIdx.x) * RPT;
  if (u >= nu || v0 >= nv) return;
  const int nrow = min(RPT, nv - v0);
  const float* P = table + 20 * a;
  const float el = sf_edge(e0, du, u);
  float elv[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) elv[j] = sf_edge(ev0, dv, v0 + j);
  const float evlo = elv[0];
  const float evhi = sf_edge(ev0, dv, v0 + nrow);
  const T* vol = f + (long long)b * ng * nl * nz;

  float acc[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) acc[j] = 0.0f;

  for (int li = 0; li < nl; ++li) {
    int g0, g1;
    sf_gather_window(P, li, el - hw, el + du + hw, sdd, false, ng, &g0, &g1);
    for (int gi = g0; gi <= g1; ++gi) {
      const SfTrap tr = sf_corner_trapezoid(P, gi, li, sdd, dxv, false);
      const float wu = sf_pixel_weight(el, du, tr.t0, tr.t1, tr.t2, tr.t3, tr.h);
      if (wu == 0.0f) continue;
      const float mag = __fdiv_rn(sdd, fmaxf(tr.ell, SF_EPS));
      const float rt2 = fmaxf(tr.rt2, SF_EPS);
      // slices k with (z_k + dz/2) mag > evlo and (z_k - dz/2) mag < evhi,
      // one of margin
      const int k0 = max(clamp_floor((evlo / mag - z0) / dz - 0.5f, -2, nz) - 1, 0);
      const int k1 = min(clamp_floor((evhi / mag - z0) / dz + 0.5f, -2, nz) + 2,
                         nz - 1);
      const T* line = vol + (long long)gi * gs + (long long)li * ls;
      for (int k = k0; k <= k1; ++k) {
        float vlo, vhi, obl;
        slice_extent(k, z0, dz, mag, rt2, &vlo, &vhi, &obl);
        const float fv = to_f32(line[k]);
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          if (j < nrow)
            acc[j] += wu * (round_like<T>(axial_weight(vlo, vhi, elv[j], dv, obl)) * fv);
        }
      }
    }
  }
  float* dst = out + (((long long)b * na + __ldg(rows + a)) * nv + v0) * nu + u;
#pragma unroll
  for (int j = 0; j < RPT; ++j)
    if (j < nrow) dst[(long long)j * nu] = acc[j];
}

// BP (gather form): one thread per (sample b, gathered gi, loop li, ZPT z
// slices), looping over the group's views and, per view, over the detector
// columns the voxel's trapezoid meets and, per slice, the rows its axial
// rectangle meets.  `accumulate` adds into the buffer (the second view
// group) instead of overwriting it (the first).
template <typename T>
__global__ void __launch_bounds__(CONE_THREADS, 4)
    bp_cone_sf_kernel(const float* __restrict__ table,
                      const int* __restrict__ rows, int n_views, int na,
                      const T* __restrict__ q, float* __restrict__ out, int ng,
                      int nl, int nz, long long gs, long long ls, int nu,
                      int nv, float e0, float du, float ev0, float dv,
                      float z0, float dz, float sdd, float dxv,
                      int accumulate) {
  const int b = blockIdx.x / nl;
  const int li = blockIdx.x - b * nl;
  const int gi = blockIdx.y * blockDim.y + threadIdx.y;
  const int k0 = (blockIdx.z * blockDim.x + threadIdx.x) * ZPT;
  if (gi >= ng || k0 >= nz) return;
  const int nk = min(ZPT, nz - k0);

  float acc[ZPT];
#pragma unroll
  for (int j = 0; j < ZPT; ++j) acc[j] = 0.0f;

  for (int a = 0; a < n_views; ++a) {
    const float* P = table + 20 * a;
    const SfTrap tr = sf_corner_trapezoid(P, gi, li, sdd, dxv, false);
    const float mag = __fdiv_rn(sdd, fmaxf(tr.ell, SF_EPS));
    const float rt2 = fmaxf(tr.rt2, SF_EPS);
    // columns whose pixel can meet [t0, t3], one of margin
    const int u0 = max(clamp_floor((tr.t0 - e0) / du, -2, nu) - 1, 0);
    const int u1 = min(clamp_floor((tr.t3 - e0) / du, -2, nu) + 1, nu - 1);
    float vlo[ZPT], vhi[ZPT], obl[ZPT];
    int r0[ZPT], r1[ZPT];
#pragma unroll
    for (int j = 0; j < ZPT; ++j) {
      slice_extent(k0 + j, z0, dz, mag, rt2, &vlo[j], &vhi[j], &obl[j]);
      // rows whose pixel can meet [vlo, vhi], one of margin; none past nk
      r0[j] = max(clamp_floor((vlo[j] - ev0) / dv, -2, nv) - 1, 0);
      r1[j] = j < nk ? min(clamp_floor((vhi[j] - ev0) / dv, -2, nv) + 1, nv - 1)
                     : -1;
    }
    const T* sino = q + ((long long)b * na + __ldg(rows + a)) * nv * nu;
    for (int u = u0; u <= u1; ++u) {
      const float wu = sf_pixel_weight(sf_edge(e0, du, u), du, tr.t0, tr.t1,
                                       tr.t2, tr.t3, tr.h);
      if (wu == 0.0f) continue;
#pragma unroll
      for (int j = 0; j < ZPT; ++j) {
        for (int v = r0[j]; v <= r1[j]; ++v) {
          const float w = round_like<T>(
              axial_weight(vlo[j], vhi[j], sf_edge(ev0, dv, v), dv, obl[j]));
          acc[j] += wu * (w * to_f32(sino[(long long)v * nu + u]));
        }
      }
    }
  }
  float* dst = out + (long long)b * ng * nl * nz + (long long)gi * gs +
               (long long)li * ls + k0;
#pragma unroll
  for (int j = 0; j < ZPT; ++j) {
    if (j < nk) dst[j] = accumulate ? dst[j] + acc[j] : acc[j];
  }
}

// Block shape of both kernels: as many row runs (FP) or z runs (BP) as the
// larger of the two needs, up to 32, along threadIdx.x (fastest); the rest
// of CONE_THREADS along detector columns (FP) or gathered voxels (BP).
static dim3 cone_block(int nv, int nz) {
  const int fp_runs = (nv + RPT - 1) / RPT, bp_runs = (nz + ZPT - 1) / ZPT;
  const int runs = fp_runs > bp_runs ? fp_runs : bp_runs;
  int cr = 1;
  while (cr < runs && cr < 32) cr *= 2;
  return dim3(cr, CONE_THREADS / cr);
}

extern "C" const char* fp_cone_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32 volume, 1 = bfloat16.  Returns cudaGetLastError()
// after the launch (0 when the launch was accepted).
extern "C" int fp_cone_sf_launch(int dtype, const void* table, const void* rows,
                                 int n_views, int na, int batch, const void* f,
                                 void* out, int ng, int nl, int nz, long long gs,
                                 long long ls, int nu, int nv, float e0, float du,
                                 float ev0, float dv, float z0, float dz,
                                 float sdd, float dxv, float hw, void* stream) {
  if (n_views == 0 || batch == 0) return 0;
  const dim3 block = cone_block(nv, nz);
  const int runs = (nv + RPT - 1) / RPT;
  const dim3 grid(batch * n_views, (nu + block.y - 1) / block.y,
                  (runs + block.x - 1) / block.x);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    fp_cone_sf_kernel<float><<<grid, block, 0, s>>>(
        (const float*)table, (const int*)rows, n_views, na, (const float*)f,
        (float*)out, ng, nl, nz, gs, ls, nu, nv, e0, du, ev0, dv, z0, dz, sdd,
        dxv, hw);
  } else {
    fp_cone_sf_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const float*)table, (const int*)rows, n_views, na,
        (const __nv_bfloat16*)f, (float*)out, ng, nl, nz, gs, ls, nu, nv, e0,
        du, ev0, dv, z0, dz, sdd, dxv, hw);
  }
  return (int)cudaGetLastError();
}

extern "C" int bp_cone_sf_launch(int dtype, const void* table, const void* rows,
                                 int n_views, int na, int batch, const void* q,
                                 void* out, int ng, int nl, int nz, long long gs,
                                 long long ls, int nu, int nv, float e0, float du,
                                 float ev0, float dv, float z0, float dz,
                                 float sdd, float dxv, int accumulate,
                                 void* stream) {
  if (batch == 0) return 0;
  const dim3 block = cone_block(nv, nz);
  const int runs = (nz + ZPT - 1) / ZPT;
  const dim3 grid(batch * nl, (ng + block.y - 1) / block.y,
                  (runs + block.x - 1) / block.x);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    bp_cone_sf_kernel<float><<<grid, block, 0, s>>>(
        (const float*)table, (const int*)rows, n_views, na, (const float*)q,
        (float*)out, ng, nl, nz, gs, ls, nu, nv, e0, du, ev0, dv, z0, dz, sdd,
        dxv, accumulate);
  } else {
    bp_cone_sf_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        (const float*)table, (const int*)rows, n_views, na,
        (const __nv_bfloat16*)q, (float*)out, ng, nl, nz, gs, ls, nu, nv, e0,
        du, ev0, dv, z0, dz, sdd, dxv, accumulate);
  }
  return (int)cudaGetLastError();
}
