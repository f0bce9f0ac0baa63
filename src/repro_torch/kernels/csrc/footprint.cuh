// Separable-Footprint (SF) transaxial weight, shared by every projector
// kernel of the port so that each backprojector evaluates exactly the
// weights of its forward projector (the matched-pair contract).
//
// These are the float expressions of kernels/footprint.py
// (trapezoid_cdf / trapezoid_pixel_weight); keep the two in step.
#pragma once

#include <cuda_runtime.h>

#define SF_EPS 1e-9f

// Integral from -inf to t of the trapezoid with breakpoints t0<=t1<=t2<=t3
// and plateau height h.  Constant below t0 and above t3, so a pixel that
// misses the support gets a weight of exactly zero.
__device__ __forceinline__ float sf_trapezoid_cdf(float t, float t0, float t1,
                                                  float t2, float t3, float h) {
  const float d01 = fmaxf(t1 - t0, SF_EPS);
  const float d23 = fmaxf(t3 - t2, SF_EPS);
  const float tc1 = fminf(fmaxf(t, t0), t1);
  const float tc2 = fminf(fmaxf(t, t1), t2);
  const float tc3 = fminf(fmaxf(t, t2), t3);
  const float r = tc1 - t0;
  const float rise = r * r / (2.0f * d01);
  const float mid = tc2 - t1;
  const float a = t3 - t2;
  const float b = t3 - tc3;
  const float fall = (a * a - b * b) / (2.0f * d23);
  return h * (rise + mid + fall);
}

// Mean footprint over detector pixel [el, el + du] of the voxel whose
// centre projects to uc, with trapezoid half-widths hs (outer), hd (inner)
// and plateau h: footprint.trapezoid_pixel_weight(el, el + du, uc - hs,
// uc - hd, uc + hd, uc + hs, h).
__device__ __forceinline__ float sf_weight(float el, float du, float uc,
                                           float hs, float hd, float h) {
  const float eh = el + du;
  const float t0 = uc - hs, t1 = uc - hd, t2 = uc + hd, t3 = uc + hs;
  return (sf_trapezoid_cdf(eh, t0, t1, t2, t3, h) -
          sf_trapezoid_cdf(el, t0, t1, t2, t3, h)) /
         fmaxf(eh - el, SF_EPS);
}

// Detector coordinate of the voxel centre at gathered index gi and loop
// index li, uc = P*gi + Q*li + R, rounded exactly as the plain PyTorch
// version computes it (no fused multiply-add).
__device__ __forceinline__ float sf_uc(float P, float Q, float R, int gi,
                                       int li) {
  return __fadd_rn(__fadd_rn(__fmul_rn(P, (float)gi), __fmul_rn(Q, (float)li)),
                   R);
}

// Left edge of detector column u: e0 + u*du, unfused like the plain version.
__device__ __forceinline__ float sf_edge(float e0, float du, int u) {
  return __fadd_rn(e0, __fmul_rn((float)u, du));
}
