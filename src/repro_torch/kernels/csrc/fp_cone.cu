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
// the summed axes itself.  The bodies are cone_sf.cuh's, on the cone's
// axial map (ConeAxial: v = (z -+ dz/2) x sdd / ell); the design, the
// weights and what bounds the kernels are described there.
#include "cone_sf.cuh"

template <typename T, int BPT>
__global__ void __launch_bounds__(SF_THREADS)
    fp_cone_sf_kernel(const SfArgs p, const T* __restrict__ f,
                      float* __restrict__ out) {
  sf_fp<ConeAxial, T, BPT>(p, f, out);
}

template <typename T, int BPT>
__global__ void __launch_bounds__(SF_THREADS, 4)
    bp_cone_sf_kernel(const SfArgs p, const T* __restrict__ q,
                      float* __restrict__ out) {
  sf_bp<ConeAxial, T, BPT>(p, q, out);
}

struct ConeKernels {
  template <typename T, int BPT>
  static void run(bool fp, const SfArgs& p, const void* in, void* out,
                  cudaStream_t s) {
    dim3 grid, block;
    sf_grid<BPT>(fp, p, &grid, &block);
    if (fp)
      fp_cone_sf_kernel<T, BPT><<<grid, block, 0, s>>>(p, (const T*)in,
                                                       (float*)out);
    else
      bp_cone_sf_kernel<T, BPT><<<grid, block, 0, s>>>(p, (const T*)in,
                                                       (float*)out);
  }
};

extern "C" const char* fp_cone_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32 volume, 1 = bfloat16; spt: samples per thread (1, or
// 8 for a batch).  Returns cudaGetLastError() after the launch (0 when the
// launch was accepted).
extern "C" int fp_cone_sf_launch(int dtype, int spt, const void* table,
                                 const void* rows, int n_views, int na,
                                 int batch, const void* f, void* out, int ng,
                                 int nl, int nz, long long gs, long long ls,
                                 int nu, int nv, float e0, float du, float ev0,
                                 float dv, float z0, float dz, float sdd,
                                 float dxv, float hw, void* stream) {
  if (n_views == 0 || batch == 0) return 0;
  const SfArgs p = {(const float*)table, (const int*)rows, n_views, na, batch,
                    ng, nl, nz, gs, ls, nu, nv, e0, du, ev0, dv, z0, dz, sdd,
                    dxv, hw, 0};
  return sf_launch<ConeKernels>(true, dtype, spt, p, f, out,
                                (cudaStream_t)stream);
}

extern "C" int bp_cone_sf_launch(int dtype, int spt, const void* table,
                                 const void* rows, int n_views, int na,
                                 int batch, const void* q, void* out, int ng,
                                 int nl, int nz, long long gs, long long ls,
                                 int nu, int nv, float e0, float du, float ev0,
                                 float dv, float z0, float dz, float sdd,
                                 float dxv, int accumulate, void* stream) {
  if (batch == 0) return 0;
  const SfArgs p = {(const float*)table, (const int*)rows, n_views, na, batch,
                    ng, nl, nz, gs, ls, nu, nv, e0, du, ev0, dv, z0, dz, sdd,
                    dxv, 0.0f, accumulate};
  return sf_launch<ConeKernels>(false, dtype, spt, p, q, out,
                                (cudaStream_t)stream);
}
