// Axial-frame modular Separable-Footprint forward projection (FP) and its
// exact transpose, the backprojection (BP), for Hopper (sm_90a): helical
// scans, per-view detector shifts and non-circular orbits.
//
// Replaces the TPU kernels src/repro/kernels/fp_modular.py:223
// `_fp_modular_kernel` and src/repro/kernels/fp_modular.py:407
// `_bp_modular_kernel`.  Both compute what those compute, not how: the TPU
// kernels contract a (columns x window) transaxial weight tile and a
// per-element (rows x z) rect-overlap matrix on the matrix unit and carry
// the sum across sequential grid steps.  Here the weights' arithmetic
// bounds both.  The FP's block owns an output tile (on the helical cell all
// 6 rows and 168 columns) and loops over li itself, forming each transaxial
// weight and slice extent once in shared memory; a voxel whose slices miss
// the tile's rows, as most do under a moving source, is dropped before its
// trapezoid.  The BP's thread owns its voxels, in warps of 32 neighbouring
// gathered voxels, and drops a view whose slices miss the rows before its
// trapezoid.  No atomics on the outputs.
//
// The exact cone pair (fp_cone.cu) with per-view frames: the bodies are
// cone_sf.cuh's on the modular axial map (ModularAxial: each view's
// 24-float row, kernels/fp_modular.py `_view_params_modular`, holds the cone
// layout on the rescaled and sheared q̂, then e_vz*sdd_a, the source height
// s_z and the row offset cv), with the static reference distance sdd_ref in
// the place of sdd.  cone_sf.cuh names the places where this can go wrong:
// the signed magnification, the modular footprint half-width bound (which
// also sizes the FP's records), the axial window of a moving source and
// register pressure.
#include "cone_sf.cuh"

template <typename T, int BPT>
__global__ void __launch_bounds__(SF_FP_THREADS, SfFpBlocks<BPT>::value)
    fp_modular_sf_kernel(const SfArgs p, const T* __restrict__ f,
                         float* __restrict__ out) {
  sf_fp<ModularAxial, T, BPT>(p, f, out);
}

template <typename T, int BPT>
__global__ void __launch_bounds__(SF_THREADS, SfBpBlocks<BPT>::value)
    bp_modular_sf_kernel(const SfArgs p, const T* __restrict__ q,
                         float* __restrict__ out) {
  sf_bp<ModularAxial, T, BPT>(p, q, out);
}

struct ModularKernels {
  template <typename T, int BPT>
  static cudaError_t run(bool fp, const SfArgs& p, const void* in, void* out,
                         cudaStream_t s) {
    return sf_run<BPT>(fp, fp_modular_sf_kernel<T, BPT>,
                       bp_modular_sf_kernel<T, BPT>, p, (const T*)in,
                       (float*)out, s);
  }
};

#if defined(SF_FP_PHASES) || defined(SF_BP_PHASES)
// The phase sums of the FP or BP launched last (cone_sf.cuh SF_FP_PHASES,
// SF_BP_PHASES) into host[8], zeroed after.
extern "C" int fp_modular_phases_read(void* host) {
  return sf_phases_read((unsigned long long*)host);
}
#endif

extern "C" const char* fp_modular_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32 tiles, 1 = bfloat16; spt: samples per block (1, or 8
// for a batch); tv .. emax: the tile's rows and the shared buffers' sizes
// (fp_cone.py `fp_layout`).  sdd is the reference distance sdd_ref of the
// tables.  Returns cudaGetLastError() after the launch (0 when it was
// accepted).
extern "C" int fp_modular_sf_launch(int dtype, int spt, const void* table,
                                    const void* rows, int n_views, int na,
                                    int batch, const void* f, void* out, int ng,
                                    int nl, int nz, long long gs, long long ls,
                                    int nu, int nv, float e0, float du,
                                    float ev0, float dv, float z0, float dz,
                                    float sdd, float dxv, float hw, int tv,
                                    int ncap, int smax, int emax,
                                    void* stream) {
  if (n_views == 0 || batch == 0) return 0;
  const SfArgs p = {(const float*)table, (const int*)rows, n_views, na, batch,
                    ng, nl, nz, gs, ls, nu, nv, e0, du, ev0, dv, z0, dz, sdd,
                    dxv, hw, 0, tv, ncap, smax, emax, 0};
  return sf_launch<ModularKernels>(true, dtype, spt, p, f, out,
                                   (cudaStream_t)stream);
}

// The FP instance (dtype 0 = float32, 1 = bfloat16; spt 1 or 8) at the
// host's layout (tv .. emax, fp_cone.py `fp_layout`): the dynamic shared
// memory a block carves from it (*smem, bytes: the count the launch asks
// for, which the host checks against its own) and resident blocks per SM
// at that size on this card (*blocks).
extern "C" int fp_modular_sf_info(int dtype, int spt, int tv, int ncap, int smax,
                               int emax, int* smem, int* blocks) {
  SfArgs p = {};
  p.tv = tv;
  p.ncap = ncap;
  p.smax = smax;
  p.emax = emax;
  *smem = (int)(sf_fp_smem_words(p, spt) * 4);
  if (dtype == 0)
    return spt == 8 ? sf_fp_occupancy(fp_modular_sf_kernel<float, 8>, *smem, blocks)
                    : sf_fp_occupancy(fp_modular_sf_kernel<float, 1>, *smem, blocks);
  return spt == 8
             ? sf_fp_occupancy(fp_modular_sf_kernel<__nv_bfloat16, 8>, *smem, blocks)
             : sf_fp_occupancy(fp_modular_sf_kernel<__nv_bfloat16, 1>, *smem, blocks);
}

extern "C" int bp_modular_sf_launch(int dtype, int spt, const void* table,
                                    const void* rows, int n_views, int na,
                                    int batch, const void* q, void* out, int ng,
                                    int nl, int nz, long long gs, long long ls,
                                    int nu, int nv, float e0, float du,
                                    float ev0, float dv, float z0, float dz,
                                    float sdd, float dxv, int accumulate,
                                    int bp_rows, void* stream) {
  if (batch == 0) return 0;
  const SfArgs p = {(const float*)table, (const int*)rows, n_views, na, batch,
                    ng, nl, nz, gs, ls, nu, nv, e0, du, ev0, dv, z0, dz, sdd,
                    dxv, 0.0f, accumulate, 0, 0, 0, 0, bp_rows};
  return sf_launch<ModularKernels>(false, dtype, spt, p, q, out,
                                   (cudaStream_t)stream);
}

// Resident blocks per SM (*blocks) of the BP instance (dtype 0 = float32,
// 1 = bfloat16; spt 1 or 8) on this card.
extern "C" int bp_modular_sf_info(int dtype, int spt, int* blocks) {
  if (dtype == 0)
    return spt == 8 ? sf_bp_occupancy(bp_modular_sf_kernel<float, 8>, blocks)
                    : sf_bp_occupancy(bp_modular_sf_kernel<float, 1>, blocks);
  return spt == 8 ? sf_bp_occupancy(bp_modular_sf_kernel<__nv_bfloat16, 8>, blocks)
                  : sf_bp_occupancy(bp_modular_sf_kernel<__nv_bfloat16, 1>, blocks);
}
