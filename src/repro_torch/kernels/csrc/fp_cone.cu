// Exact cone-beam (flat detector) Separable-Footprint forward projection
// (FP) and its exact transpose, the backprojection (BP), for Hopper
// (sm_90a).
//
// Replaces the TPU kernels src/repro/kernels/fp_cone.py:183
// `_fp_cone_kernel` and src/repro/kernels/fp_cone.py:346 `_bp_cone_kernel`.
// Both compute what those compute, not how: the TPU kernels contract a
// (columns x window) transaxial weight tile and a per-element (rows x z)
// rect-overlap matrix on the matrix unit and carry the sum across
// sequential grid steps.  Here the weights' arithmetic, not the bytes,
// bounds both kernels.  The FP's block owns an output tile and loops over
// the TPU kernel's li axis itself, forming each transaxial weight and each
// slice extent once in shared memory and each axial weight once or twice;
// the BP's thread owns its voxels, forms each axial weight once a view and
// reuses each weight across its slices and samples, in warps of 32
// neighbouring gathered voxels that read neighbouring detector columns.  No
// atomics on the outputs.  The bodies are cone_sf.cuh's, on the cone's axial
// map (ConeAxial: v = (z -+ dz/2) x sdd / ell); the design, the weights and
// what bounds the kernels are described there.
#include "cone_sf.cuh"

template <typename T, int BPT>
__global__ void __launch_bounds__(SF_FP_THREADS, SfFpBlocks<BPT>::value)
    fp_cone_sf_kernel(const SfArgs p, const T* __restrict__ f,
                      float* __restrict__ out) {
  sf_fp<ConeAxial, T, BPT>(p, f, out);
}

template <typename T, int BPT>
__global__ void __launch_bounds__(SF_THREADS, SfBpBlocks<BPT>::value)
    bp_cone_sf_kernel(const SfArgs p, const T* __restrict__ q,
                      float* __restrict__ out) {
  sf_bp<ConeAxial, T, BPT>(p, q, out);
}

struct ConeKernels {
  template <typename T, int BPT>
  static cudaError_t run(bool fp, const SfArgs& p, const void* in, void* out,
                         cudaStream_t s) {
    return sf_run<BPT>(fp, fp_cone_sf_kernel<T, BPT>,
                       bp_cone_sf_kernel<T, BPT>, p, (const T*)in,
                       (float*)out, s);
  }
};

#if defined(SF_FP_PHASES) || defined(SF_BP_PHASES)
// The phase sums of the FP or BP launched last (cone_sf.cuh SF_FP_PHASES,
// SF_BP_PHASES) into host[8], zeroed after.
extern "C" int fp_cone_phases_read(void* host) {
  return sf_phases_read((unsigned long long*)host);
}
#endif

extern "C" const char* fp_cone_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// dtype: 0 = float32 volume, 1 = bfloat16; spt: samples per block (1, or
// 8 for a batch); tv .. emax: the tile's rows and the shared buffers' sizes
// (fp_cone.py `fp_layout`).  Returns cudaGetLastError() after the launch (0
// when the launch was accepted).
extern "C" int fp_cone_sf_launch(int dtype, int spt, const void* table,
                                 const void* rows, int n_views, int na,
                                 int batch, const void* f, void* out, int ng,
                                 int nl, int nz, long long gs, long long ls,
                                 int nu, int nv, float e0, float du, float ev0,
                                 float dv, float z0, float dz, float sdd,
                                 float dxv, float hw, int tv, int ncap,
                                 int smax, int emax, void* stream) {
  if (n_views == 0 || batch == 0) return 0;
  const SfArgs p = {(const float*)table, (const int*)rows, n_views, na, batch,
                    ng, nl, nz, gs, ls, nu, nv, e0, du, ev0, dv, z0, dz, sdd,
                    dxv, hw, 0, tv, ncap, smax, emax, 0};
  return sf_launch<ConeKernels>(true, dtype, spt, p, f, out,
                                (cudaStream_t)stream);
}

// The FP instance (dtype 0 = float32, 1 = bfloat16; spt 1 or 8) at the
// host's layout (tv .. emax, fp_cone.py `fp_layout`): the dynamic shared
// memory a block carves from it (*smem, bytes: the count the launch asks
// for, which the host checks against its own) and resident blocks per SM
// at that size on this card (*blocks).
extern "C" int fp_cone_sf_info(int dtype, int spt, int tv, int ncap, int smax,
                               int emax, int* smem, int* blocks) {
  SfArgs p = {};
  p.tv = tv;
  p.ncap = ncap;
  p.smax = smax;
  p.emax = emax;
  *smem = (int)(sf_fp_smem_words(p, spt) * 4);
  if (dtype == 0)
    return spt == 8 ? sf_fp_occupancy(fp_cone_sf_kernel<float, 8>, *smem, blocks)
                    : sf_fp_occupancy(fp_cone_sf_kernel<float, 1>, *smem, blocks);
  return spt == 8
             ? sf_fp_occupancy(fp_cone_sf_kernel<__nv_bfloat16, 8>, *smem, blocks)
             : sf_fp_occupancy(fp_cone_sf_kernel<__nv_bfloat16, 1>, *smem, blocks);
}

// The FP's division (cone_sf.cuh sf_div_rn) against __fdiv_rn for the
// divisor dv over every float ov whose bit pattern lies in [lo, hi): adds
// the count of quotients whose bits differ to *bad (a device counter).
__global__ void div_check_kernel(float dv, unsigned lo, unsigned hi,
                                 unsigned long long* bad) {
  const float rdv = __frcp_rn(dv);
  unsigned n = 0;
  for (unsigned long long i = lo + blockIdx.x * (unsigned long long)blockDim.x +
                              threadIdx.x;
       i < hi; i += (unsigned long long)gridDim.x * blockDim.x) {
    const float ov = __uint_as_float((unsigned)i);
    n += __float_as_uint(sf_div_rn(ov, dv, rdv)) !=
         __float_as_uint(__fdiv_rn(ov, dv));
  }
  for (int o = 16; o > 0; o >>= 1) n += __shfl_down_sync(0xffffffffu, n, o);
  if ((threadIdx.x & 31) == 0 && n) atomicAdd(bad, (unsigned long long)n);
}

extern "C" int fp_cone_div_check(float dv, unsigned lo, unsigned hi,
                                 void* bad, void* stream) {
  if (hi > lo)
    div_check_kernel<<<1056, 256, 0, (cudaStream_t)stream>>>(
        dv, lo, hi, (unsigned long long*)bad);
  return (int)cudaGetLastError();
}

extern "C" int bp_cone_sf_launch(int dtype, int spt, const void* table,
                                 const void* rows, int n_views, int na,
                                 int batch, const void* q, void* out, int ng,
                                 int nl, int nz, long long gs, long long ls,
                                 int nu, int nv, float e0, float du, float ev0,
                                 float dv, float z0, float dz, float sdd,
                                 float dxv, int accumulate, int bp_rows,
                                 void* stream) {
  if (batch == 0) return 0;
  const SfArgs p = {(const float*)table, (const int*)rows, n_views, na, batch,
                    ng, nl, nz, gs, ls, nu, nv, e0, du, ev0, dv, z0, dz, sdd,
                    dxv, 0.0f, accumulate, 0, 0, 0, 0, bp_rows};
  return sf_launch<ConeKernels>(false, dtype, spt, p, q, out,
                                (cudaStream_t)stream);
}

// Resident blocks per SM (*blocks) of the BP instance (dtype 0 = float32,
// 1 = bfloat16; spt 1 or 8) on this card.
extern "C" int bp_cone_sf_info(int dtype, int spt, int* blocks) {
  if (dtype == 0)
    return spt == 8 ? sf_bp_occupancy(bp_cone_sf_kernel<float, 8>, blocks)
                    : sf_bp_occupancy(bp_cone_sf_kernel<float, 1>, blocks);
  return spt == 8 ? sf_bp_occupancy(bp_cone_sf_kernel<__nv_bfloat16, 8>, blocks)
                  : sf_bp_occupancy(bp_cone_sf_kernel<__nv_bfloat16, 1>, blocks);
}
