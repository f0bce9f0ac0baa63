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

// Mean over detector pixel [el, el + du] of the trapezoid t0..t3 with
// plateau h: footprint.trapezoid_pixel_weight(el, el + du, t0, t1, t2, t3, h).
__device__ __forceinline__ float sf_pixel_weight(float el, float du, float t0,
                                                 float t1, float t2, float t3,
                                                 float h) {
  const float eh = el + du;
  return (sf_trapezoid_cdf(eh, t0, t1, t2, t3, h) -
          sf_trapezoid_cdf(el, t0, t1, t2, t3, h)) /
         fmaxf(eh - el, SF_EPS);
}

// Mean footprint over detector pixel [el, el + du] of the voxel whose
// centre projects to uc, with trapezoid half-widths hs (outer), hd (inner)
// and plateau h (parallel beam).
__device__ __forceinline__ float sf_weight(float el, float du, float uc,
                                           float hs, float hd, float h) {
  return sf_pixel_weight(el, du, uc - hs, uc - hd, uc + hd, uc + hs, h);
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

// --------------------------------------------------------------------------
// Divergent beams (fan, cone): the corner-projection trapezoid.
// --------------------------------------------------------------------------

// What the corner projection of one voxel gives: the sorted breakpoints
// t0..t3 and plateau h of its transaxial trapezoid, the squared transaxial
// length rt2 of the ray through its centre (cone obliquity), and ell, the
// centre's distance from the source along the central ray (magnification).
struct SfTrap {
  float t0, t1, t2, t3, h, rt2, ell;
};

// The trapezoid of the voxel at gathered index gi and loop index li in the
// view whose 20-float row is P (kernels/fp_cone.py `_view_params_cone`:
// Aq Bq Cq Al Bl Cl Arx Brx Crx Ary Bry Cry dq0 dl0 .. dq3 dl3).  The float
// expressions of fp_cone.py `_corner_trapezoid`, every product and sum
// rounded on its own (no fused multiply-add), so that the forward and the
// backward kernels and the plain version agree; the same min/max sorting
// network orders the four corner projections.  `curved` projects onto the
// equiangular arc u = sdd*atan2(q, ell) instead of u = sdd*q/ell.
__device__ __forceinline__ SfTrap sf_corner_trapezoid(const float* __restrict__ P,
                                                      int gi, int li, float sdd,
                                                      float dxv, bool curved) {
  const float g = (float)gi, l = (float)li;
  const float q0 = __fadd_rn(__fmul_rn(__ldg(P + 1), l), __ldg(P + 2));
  const float l0 = __fadd_rn(__fmul_rn(__ldg(P + 4), l), __ldg(P + 5));
  const float q = __fadd_rn(__fmul_rn(__ldg(P + 0), g), q0);
  const float ell = __fadd_rn(__fmul_rn(__ldg(P + 3), g), l0);
  float tau[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float qk = __fadd_rn(q, __ldg(P + 12 + 2 * k));
    const float lc = fmaxf(__fadd_rn(ell, __ldg(P + 13 + 2 * k)), SF_EPS);
    tau[k] = curved ? __fmul_rn(sdd, atan2f(qk, lc))
                    : __fdiv_rn(__fmul_rn(sdd, qk), lc);
  }
  const float m1 = fminf(tau[0], tau[1]), M1 = fmaxf(tau[0], tau[1]);
  const float m2 = fminf(tau[2], tau[3]), M2 = fmaxf(tau[2], tau[3]);
  const float ta = fmaxf(m1, m2), tb = fminf(M1, M2);
  SfTrap r;
  r.t0 = fminf(m1, m2);
  r.t3 = fmaxf(M1, M2);
  r.t1 = fminf(ta, tb);
  r.t2 = fmaxf(ta, tb);
  const float rx = __fadd_rn(
      __fadd_rn(__fmul_rn(__ldg(P + 6), g), __fmul_rn(__ldg(P + 7), l)),
      __ldg(P + 8));
  const float ry = __fadd_rn(
      __fadd_rn(__fmul_rn(__ldg(P + 9), g), __fmul_rn(__ldg(P + 10), l)),
      __ldg(P + 11));
  r.rt2 = __fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry));
  r.h = __fdiv_rn(__fmul_rn(dxv, __fsqrt_rn(r.rt2)),
                  fmaxf(fmaxf(fabsf(rx), fabsf(ry)), SF_EPS));
  r.ell = ell;
  return r;
}

// Integer part of x clamped to [lo, hi] before the conversion, so that a
// huge quotient cannot overflow the int.
__device__ __forceinline__ int clamp_floor(float x, int lo, int hi) {
  return (int)floorf(fminf(fmaxf(x, (float)lo), (float)hi));
}

// Axial weight (cone, modular) of slice extent [vlo, vhi] (detector mm) over
// the row whose lower edge is elv, times the obliquity: the float expression
// of fp_cone.py `chunk_taps`.
__device__ __forceinline__ float axial_weight(float vlo, float vhi, float elv,
                                              float dv, float obl) {
  const float ov = __fdiv_rn(
      fmaxf(__fsub_rn(fminf(vhi, __fadd_rn(elv, dv)), fmaxf(vlo, elv)), 0.0f),
      dv);
  return __fmul_rn(ov, obl);
}

// Gathered indices [*g0, *g1] of the voxels on loop line li whose footprint
// can meet the detector interval [lo, hi], where lo and hi are already
// widened by a bound on the footprint's half-width.  Inverts the centre
// projection u(gi) = sdd*(Aq*gi + q0)/(Al*gi + l0) (curved: tan(u/sdd) =
// q/ell), which is a Moebius map of gi and so monotonic on either side of
// its pole; when the pole falls inside [lo, hi] (the denominators at the
// two ends differ in sign) the whole line is taken.  One voxel of margin on
// each side absorbs rounding.
__device__ __forceinline__ void sf_gather_window(const float* __restrict__ P,
                                                 int li, float lo, float hi,
                                                 float sdd, bool curved, int ng,
                                                 int* g0, int* g1) {
  const float l = (float)li;
  const float Aq = __ldg(P + 0), Al = __ldg(P + 3);
  const float q0 = __fadd_rn(__fmul_rn(__ldg(P + 1), l), __ldg(P + 2));
  const float l0 = __fadd_rn(__fmul_rn(__ldg(P + 4), l), __ldg(P + 5));
  float num[2], den[2];
  const float us[2] = {lo, hi};
  bool whole = false;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (curved) {
      const float ang = us[k] / sdd;
      whole |= fabsf(ang) > 1.5f;  // tan is no longer monotonic safely
      const float t = tanf(ang);
      num[k] = t * l0 - q0;
      den[k] = Aq - t * Al;
    } else {
      num[k] = us[k] * l0 - sdd * q0;
      den[k] = sdd * Aq - us[k] * Al;
    }
    whole |= fabsf(den[k]) < 1e-6f;
  }
  whole |= (den[0] < 0.0f) != (den[1] < 0.0f);
  if (whole) {
    *g0 = 0;
    *g1 = ng - 1;
    return;
  }
  const float lim = (float)ng + 1.0f;
  const float ga = fminf(fmaxf(num[0] / den[0], -2.0f), lim);
  const float gb = fminf(fmaxf(num[1] / den[1], -2.0f), lim);
  *g0 = max((int)floorf(fminf(ga, gb)) - 1, 0);
  *g1 = min((int)ceilf(fmaxf(ga, gb)) + 1, ng - 1);
}
