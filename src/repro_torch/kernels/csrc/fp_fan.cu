// Fan-beam Separable-Footprint forward projection (FP) and its exact
// transpose, the backprojection (BP), for Hopper (sm_90a), on a flat or a
// curved (equiangular) detector.
//
// Replaces the TPU kernels src/repro/kernels/fp_fan.py:94 `_fp_fan_kernel`
// and src/repro/kernels/fp_fan.py:247 `_bp_fan_kernel`.  Both compute what
// those compute, not how: each output is owned by one thread, which loops
// over the summed axis itself (blocks run in no order on this card).
//
// Layout.  As in fp_par.cu: the axial part of the footprint is applied
// outside the kernels, the innermost axis is `lanes` = batch x rows, and the
// x- and y-gathered view groups read the one (nx, ny, lanes) buffer through
// (gi, li) strides.  Each view row of `table` is the 20 floats of
// kernels/fp_cone.py `_view_params_cone`; a voxel's weight is the pixel
// mean of its corner-projection trapezoid (footprint.cuh
// `sf_corner_trapezoid`, the cone kernels' function), formed here by one
// function that both kernels call (fan_trap, fan_weight), so the BP is the
// exact transpose of the FP.
//
// What bounds them.  At the fan cell (512^2 volume, 768 views, 1126
// columns, 8 lanes; ~6.0e8 nonzeros, ~2.0e8 distinct (voxel, view)
// trapezoids) they move ~40 MB, so operations bound them: a trapezoid is
// ~100 f32 operations (four corner divisions or arctangents, a square
// root, a division), a pixel weight ~60 more.  The first kernels (a thread
// per output and 8 lanes) evaluated ~1.8e9 trapezoids and pixel weights in
// the FP, each column re-forming the trapezoids of every voxel in its
// widened window, two thirds of them giving exact zeros; the BP a column of
// margin on each side (PERF.md, the fan pair's step 0).  So this design:
//   * FP: a block per (tile of columns, view, lane chunk) walks the loop
//     lines in pieces of up to `vcap` voxels: per piece its threads form
//     each voxel's trapezoid once, find the tile columns it meets and their
//     weights (the weights in shared memory, shared by every thread of a
//     column), and stage the voxel's lanes with 16-byte cp.async; then each
//     column's first and last voxel of each line are marked, and each thread
//     sums its column's terms from shared memory;
//   * BP: a voxel's lane chunk on threads of one warp, which split the views
//     and share each view's weights through the warp's shared memory (as in
//     fp_par.cu), reading the sinogram 16 bytes a thread;
//   * both evaluate only the taps whose trapezoid meets the pixel (t0 < el +
//     du and t3 > el, as the weight rounds them): every other tap's cdfs are
//     taken at the same clamped points, so its weight is exactly zero;
//   * the divisions by 2 (t1 - t0), 2 (t3 - t2) (fixed per trapezoid) and by
//     the pixel width (fixed per column) are a product by a reciprocal
//     formed once and two corrections (fan_div_rn: __fdiv_rn's bits).
// What bounds it now (PERF.md, kernel table rows 3-4): the FP issues at a
// fraction of the card's rate between a piece's barriers, its time spread
// over the trapezoids, the weights, the column sums and the windows and
// marks; at 64 lanes the sums and the staging of every view's window of
// lanes; the BP the trapezoid and the weights of every (voxel, view).
//
// Sums.  Each output sums the same terms in the same order as the first
// kernels: the FP over li, then gi ascending; the BP over the group's views,
// then u ascending, the second group added into the first (`accumulate`).
// The weight is formed without fused multiply-adds, so both give the first
// kernels' bits when those are built with -fmad=false (nvcc's default
// contraction gave the first kernels' misses weights of ~1e-7 instead of
// exact zeros).
//
// Precision.  Tiles are f32 or bf16; the weight is derived in f32 and, for
// bf16 tiles, rounded to bf16 before the multiply; sums are f32 into an f32
// output.  Tiles are read 16 bytes at a time only: the tile's address and
// its lanes' bytes are multiples of 16 (the wrappers in kernels/fp_par.py
// pad the lane axis where they are not).  No atomics: every output element
// is written by one thread, so results are deterministic.  A voxel meeting
// more columns than the host's bound `ku` (kernels/fp_fan.py
// `FanPlan.ku`, which rules it out) writes NaN, so it cannot pass.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "footprint.cuh"
#include "tile.cuh"

#define FAN_MAX_THREADS 1024
#define FAN_BP_UNROLL 3  // BP: columns a (voxel, view) summed unrolled
// BP: a warp slot packs a view's first column and its count (at most ku + 1)
// in 16 bits each
#define FAN_MAX_KU 65534
#define FAN_SLOT_VECS 2  // FP: 16-byte vectors a voxel that its slot's
                         // thread stages (wider: a segment at a time)

// Lanes in one 16-byte vector of a tile type.
template <typename T>
struct FanVec;
template <>
struct FanVec<float> {
  static constexpr int N = 4;
};
template <>
struct FanVec<__nv_bfloat16> {
  static constexpr int N = 8;
};

// The 16 bytes at p (16-byte aligned) as floats, from shared memory or,
// through the read-only cache, from global memory.
__device__ __forceinline__ void fan_f32x4(const float4& v, float* x) {
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void fan_bf16x8(const uint4& v, float* x) {
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(b[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void fan_load16(const float* p, float* x) {
  fan_f32x4(*reinterpret_cast<const float4*>(p), x);
}
__device__ __forceinline__ void fan_load16(const __nv_bfloat16* p, float* x) {
  fan_bf16x8(*reinterpret_cast<const uint4*>(p), x);
}
__device__ __forceinline__ void fan_ldg16(const float* p, float* x) {
  fan_f32x4(__ldg(reinterpret_cast<const float4*>(p)), x);
}
__device__ __forceinline__ void fan_ldg16(const __nv_bfloat16* p, float* x) {
  fan_bf16x8(__ldg(reinterpret_cast<const uint4*>(p)), x);
}

// 16 bytes global -> shared, asynchronously (through L1: a voxel's lanes
// may take several copies), and the wait for all of them.
__device__ __forceinline__ void fan_cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
}
__device__ __forceinline__ void fan_cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ float fan_nan() { return __int_as_float(0x7fffffff); }

// ov / dv rounded as __fdiv_rn rounds it, given rdv = __frcp_rn(dv), for
// dv > 0 (csrc/cone_sf.cuh `sf_div_rn`, the same steps): q = ov x rdv, then
// two corrections q += (ov - dv q) rdv, each residual exact by FMA
// (Markstein's theorem); an ov below 2^-60 (0 included) is scaled by 2^64
// and its quotient back.  chip_smoke.py holds it against __fdiv_rn on the
// card over the divisors the weights take (fp_fan_div_check).
__device__ __forceinline__ float fan_div_rn(float ov, float dv, float rdv) {
  const bool tiny = ov < 0x1p-60f;
  const float a = tiny ? __fmul_rn(ov, 0x1p64f) : ov;
  float q = __fmul_rn(a, rdv);
  q = __fmaf_rn(__fmaf_rn(-dv, q, a), rdv, q);
  q = __fmaf_rn(__fmaf_rn(-dv, q, a), rdv, q);
  return tiny ? __fmul_rn(q, 0x1p-64f) : q;
}

// One voxel's trapezoid in one view, with what its pixel weights divide by
// (2 d01, 2 d23 and their reciprocals) and a^2 = (t3 - t2)^2, formed once.
struct FanTrap {
  float t0, t1, t2, t3, h, d01x2, r01, d23x2, r23, aa;
};

__device__ __forceinline__ FanTrap fan_trap(const float* __restrict__ P,
                                            int gi, int li, float sdd,
                                            float dxv, bool curved) {
  const SfTrap tr = sf_corner_trapezoid(P, gi, li, sdd, dxv, curved);
  FanTrap f;
  f.t0 = tr.t0;
  f.t1 = tr.t1;
  f.t2 = tr.t2;
  f.t3 = tr.t3;
  f.h = tr.h;
  f.d01x2 = __fmul_rn(2.0f, fmaxf(__fsub_rn(tr.t1, tr.t0), SF_EPS));
  f.r01 = __frcp_rn(f.d01x2);
  const float a = __fsub_rn(tr.t3, tr.t2);
  f.d23x2 = __fmul_rn(2.0f, fmaxf(a, SF_EPS));
  f.r23 = __frcp_rn(f.d23x2);
  f.aa = __fmul_rn(a, a);
  return f;
}

// footprint.cuh `sf_trapezoid_cdf`, every operation rounded on its own and
// its divisions by fan_div_rn.
__device__ __forceinline__ float fan_cdf(float t, const FanTrap& f) {
  const float tc1 = fminf(fmaxf(t, f.t0), f.t1);
  const float tc2 = fminf(fmaxf(t, f.t1), f.t2);
  const float tc3 = fminf(fmaxf(t, f.t2), f.t3);
  const float r = __fsub_rn(tc1, f.t0);
  const float rise = fan_div_rn(__fmul_rn(r, r), f.d01x2, f.r01);
  const float mid = __fsub_rn(tc2, f.t1);
  const float b = __fsub_rn(f.t3, tc3);
  const float fall =
      fan_div_rn(__fsub_rn(f.aa, __fmul_rn(b, b)), f.d23x2, f.r23);
  return __fmul_rn(f.h, __fadd_rn(__fadd_rn(rise, mid), fall));
}

// The weight of trapezoid f over the pixel [el, eh), eh = el + du as
// fan_edges rounds it, deh = max(eh - el, eps), rdeh = 1 / deh:
// footprint.cuh `sf_pixel_weight`'s value.  The one weight function of
// both kernels.
__device__ __forceinline__ float fan_weight(float el, float eh, float deh,
                                            float rdeh, const FanTrap& f) {
  return fan_div_rn(__fsub_rn(fan_cdf(eh, f), fan_cdf(el, f)), deh, rdeh);
}

// Column u's pixel: its edges and what its weights divide by.
__device__ __forceinline__ float4 fan_edges(float e0, float du, int u) {
  const float el = sf_edge(e0, du, u), eh = __fadd_rn(el, du);
  const float deh = fmaxf(__fsub_rn(eh, el), SF_EPS);
  return make_float4(el, eh, deh, __frcp_rn(deh));
}

// The columns of [cb, ce) whose pixel [el, el + du) meets the trapezoid
// (t0, t3): el + du > t0 and el < t3, rounded as fan_edges rounds them;
// every other column's weight is exactly zero.  *u0 is the first (ce if
// none), *u1 the last (cb - 1 if none); both are monotone in t0 and t3.
// Estimated from rdu = 1/du, then moved to the exact tests' edges.
__device__ __forceinline__ void fan_column_window(float t0, float t3,
                                                  float e0, float du,
                                                  float rdu, int cb, int ce,
                                                  int* u0, int* u1) {
  auto A = [&](int u) { return __fadd_rn(sf_edge(e0, du, u), du) > t0; };
  auto B = [&](int u) { return sf_edge(e0, du, u) < t3; };
  int lo = min(max(clamp_floor((t0 - e0) * rdu, cb - 1, ce), cb), ce);
  while (lo > cb && A(lo - 1)) --lo;
  while (lo < ce && !A(lo)) ++lo;
  int hi = min(max(clamp_floor((t3 - e0) * rdu, cb - 1, ce), cb - 1), ce - 1);
  while (hi < ce - 1 && B(hi + 1)) ++hi;
  while (hi >= cb && !B(hi)) --hi;
  *u0 = lo;
  *u1 = hi;
}

__host__ __device__ __forceinline__ size_t fan_align16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// Ints of one FP piece plan: nseg, nvox, then off[segs + 1] (each segment's
// first slot), line[segs], g0[segs] (its loop line and first gi).
__host__ __device__ __forceinline__ int fan_plan_ints(int segs) {
  return 3 * segs + 3;
}

// FP: where the dynamic shared memory of a block of tu columns and lane
// chunks of lc lanes (elem bytes each), nl loop lines, pieces of vcap voxel
// slots and segs line segments, and ku columns a voxel puts each buffer
// (byte offsets), and its size.  The kernel carves its memory with it and
// the launch asks for `bytes`; kernels/fp_fan.py `FanPlan.fp_layout` counts
// the same bytes to choose vcap and checks its count against this one
// (fp_fan_sf_info) at each layout's first launch.
struct FanFpSmem {
  size_t sx, sc, sw, sr, sf, sl, sn, sp, sflag, bytes;
};
__host__ __device__ __forceinline__ FanFpSmem fan_fp_smem(int elem, int vn,
                                                          int tu, int lc,
                                                          int nl, int vcap,
                                                          int segs, int ku) {
  FanFpSmem m;
  m.sx = 0;                                                   // staged lanes
  m.sc = fan_align16(m.sx + (size_t)vcap * (lc + vn) * elem);  // columns
  m.sw = fan_align16(m.sc + (size_t)tu * 16);                 // weights
  m.sr = fan_align16(m.sw + (size_t)vcap * ku * 4);           // slot columns
  m.sf = fan_align16(m.sr + (size_t)vcap * 4);                // first slots
  m.sl = fan_align16(m.sf + (size_t)segs * tu * 2);           // last slots
  m.sn = fan_align16(m.sl + (size_t)segs * tu * 2);           // windows
  m.sp = fan_align16(m.sn + (size_t)nl * 8);                  // two plans
  m.sflag = fan_align16(m.sp + (size_t)2 * fan_plan_ints(segs) * 4);
  m.bytes = m.sflag + 16;                                     // flags
  return m;
}

// FP: the next piece, from the cursor (line *cl, gi *cg): the voxels of the
// lines' windows `sn` in (line, gi) order, at most vcap of them in at most
// segs segments (a segment: consecutive gi of one line); a line may end in
// the next piece.  Run by one thread.
__device__ void fan_plan(int* plan, const int2* sn, int nl, int vcap,
                         int segs, int* cl, int* cg) {
  int* off = plan + 2;
  int* pline = off + segs + 1;
  int* pg0 = pline + segs;
  int n = 0, s = 0, l = *cl, g = *cg;
  while (s < segs && n < vcap && l < nl) {
    const int g1 = sn[l].y;
    if (g > g1) {
      if (++l < nl) g = sn[l].x;
      continue;
    }
    const int take = min(g1 - g + 1, vcap - n);
    off[s] = n;
    pline[s] = l;
    pg0[s] = g;
    n += take;
    g += take;
    ++s;
  }
  off[s] = n;
  plan[0] = s;
  plan[1] = n;
  *cl = l;
  *cg = g;
}

// The segment of slot i: the last s < nseg with off[s] <= i.
__device__ __forceinline__ int fan_segment(const int* off, int nseg, int i) {
  int lo = 0, hi = nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= i)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// FP: a block per (tile of blockDim.y columns, view, lane chunk of LPT *
// blockDim.x lanes).  Thread (j, c) owns column c of the tile and the lanes
// (i * blockDim.x + j) * VN .. + VN - 1 of the chunk, i < LPT / VN.  First
// each line's window [G0, G1] for the whole tile (footprint.cuh
// `sf_gather_window` at the tile's edges widened by hw, the bound on a
// footprint's half-width).  Then, piece after piece (fan_plan):
//   1. stage the slots' lanes (cp.async); per voxel slot: form its
//      trapezoid, the tile columns [ua, ub] it meets (fan_column_window)
//      and their weights;
//   2. per slot: mark, for each of its columns, whether it is that column's
//      first or last slot of the segment, and check that the slots' column
//      ranges move one way along each segment (then each column's slots are
//      the run between its marks; else each column scans the segment);
//   3. per thread: its column's terms, segment after segment.
template <typename T, bool CURVED, int LPT>
__global__ void __launch_bounds__(FAN_MAX_THREADS)
    fp_fan_sf_kernel(const float* __restrict__ table,
                     const int* __restrict__ rows, const T* __restrict__ g,
                     float* __restrict__ out, int ng, int nl, int lanes,
                     long long gs, long long ls, int nu, float e0, float du,
                     float sdd, float dxv, float hw, int vcap, int segs,
                     int ku) {
  constexpr int VN = FanVec<T>::N, NV = LPT / VN;
  extern __shared__ __align__(16) unsigned char fan_smem[];
  const int tl = blockDim.x, tu = blockDim.y;
  const int j = threadIdx.x, c = threadIdx.y;
  const int tid = j + tl * c, nt = tl * tu;
  const int lc = LPT * tl, row = lc + VN;  // a staged slot, padded by 16 B
  const FanFpSmem m = fan_fp_smem(sizeof(T), VN, tu, lc, nl, vcap, segs, ku);
  T* sx = reinterpret_cast<T*>(fan_smem + m.sx);
  float4* sc = reinterpret_cast<float4*>(fan_smem + m.sc);
  float* sw = reinterpret_cast<float*>(fan_smem + m.sw);
  short2* sr = reinterpret_cast<short2*>(fan_smem + m.sr);
  unsigned short* sf = reinterpret_cast<unsigned short*>(fan_smem + m.sf);
  unsigned short* sl = reinterpret_cast<unsigned short*>(fan_smem + m.sl);
  int2* sn = reinterpret_cast<int2*>(fan_smem + m.sn);
  int* sp = reinterpret_cast<int*>(fan_smem + m.sp);
  int* sflag = reinterpret_cast<int*>(fan_smem + m.sflag);
  const int plan_ints = fan_plan_ints(segs);

  const int a = blockIdx.y;
  const float* P = table + 20 * a;
  const int u_first = blockIdx.x * tu;
  const int u_last = min(u_first + tu, nu) - 1;
  const int ntu = u_last - u_first + 1;
  const int lane0 = blockIdx.z * lc;
  const int nlc = min(lc, lanes - lane0), nvec = nlc / VN;
  const int k0 = tid / nvec, v0 = tid % nvec, dk = nt / nvec, dv = nt % nvec;
  const bool own = c < ntu;
  const float rdu = __frcp_rn(du);

  for (int i = tid; i < ntu; i += nt) sc[i] = fan_edges(e0, du, u_first + i);
  {
    const float lo = sf_edge(e0, du, u_first) - hw;
    const float hi = sf_edge(e0, du, u_last) + du + hw;
    for (int l = tid; l < nl; l += nt) {
      int g0, g1;
      sf_gather_window(P, l, lo, hi, sdd, CURVED, ng, &g0, &g1);
      sn[l] = make_int2(g0, g1);
    }
  }
  if (tid == 0) sflag[2] = 0;  // a voxel met more than ku columns
  __syncthreads();
  int cl = 0, cg = 0;  // thread 0's cursor
  if (tid == 0) {
    cg = sn[0].x;
    fan_plan(sp, sn, nl, vcap, segs, &cl, &cg);
  }
  __syncthreads();

  float acc[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) acc[k] = 0.0f;

  for (int p = 0;; ++p) {
    const int* plan = sp + (p & 1) * plan_ints;
    const int nseg = plan[0], nvox = plan[1];
    if (nvox == 0) break;
    const int* off = plan + 2;
    const int* pline = off + segs + 1;
    const int* pg0 = pline + segs;

    // 1. slots: lanes, trapezoid, columns and weights
    for (int i = tid; i < nseg * tu; i += nt) {
      sf[i] = 0xffff;
      sl[i] = 0;
    }
    if (tid == 0) sflag[0] = sflag[1] = 0;
    // the lanes: a voxel's one or two vectors by its slot's thread (below);
    // wider lane chunks segment by segment, consecutive threads on
    // consecutive 16 bytes of a voxel, then on the next voxel of the line
    // (thread tid takes vector v0 of voxel k0, then steps nt vectors on)
    for (int s = 0; nvec > FAN_SLOT_VECS && s < nseg; ++s) {
      const int cnt = off[s + 1] - off[s];
      const T* src =
          g + (long long)pline[s] * ls + (long long)pg0[s] * gs + lane0;
      T* dst = sx + off[s] * row;
      for (int k = k0, v = v0; k < cnt;) {
        fan_cp_async16(dst + k * row + v * VN,
                       src + (long long)k * gs + v * VN);
        k += dk;
        v += dv;
        if (v >= nvec) {
          v -= nvec;
          ++k;
        }
      }
    }
    for (int i = tid; i < nvox; i += nt) {
      const int s = fan_segment(off, nseg, i);
      const int gi = pg0[s] + (i - off[s]), li = pline[s];
      if (nvec <= FAN_SLOT_VECS) {
        const T* src = g + (long long)li * ls + (long long)gi * gs + lane0;
        for (int v = 0; v < nlc; v += VN)
          fan_cp_async16(sx + i * row + v, src + v);
      }
      const FanTrap f = fan_trap(P, gi, li, sdd, dxv, CURVED);
      int ua, ub;
      fan_column_window(f.t0, f.t3, e0, du, rdu, u_first, u_last + 1, &ua,
                        &ub);
      ua -= u_first;
      ub -= u_first;
      if (ub - ua + 1 > ku) {
        sflag[2] = 1;
        ub = ua + ku - 1;
      }
      float* wq = sw + i * ku;
      for (int k = ua; k <= ub; ++k) {
        const float4 e = sc[k];
        wq[k - ua] = round_like<T>(fan_weight(e.x, e.y, e.z, e.w, f));
      }
      sr[i] = make_short2((short)ua, (short)ub);
    }
    if (tid == 0)
      fan_plan(sp + ((p + 1) & 1) * plan_ints, sn, nl, vcap, segs, &cl, &cg);
    fan_cp_async_wait();
    __syncthreads();

    // 2. each column's first and last slot of each segment
    for (int i = tid; i < nvox; i += nt) {
      const int s = fan_segment(off, nseg, i);
      const short2 r = sr[i];
      const bool first = i == off[s], last = i == off[s + 1] - 1;
      const short2 rp = first ? r : sr[i - 1];
      const short2 rn = last ? r : sr[i + 1];
      if (rp.x > r.x || rp.y > r.y) sflag[0] = 1;  // not non-decreasing
      if (rp.x < r.x || rp.y < r.y) sflag[1] = 1;  // not non-increasing
      for (int k = r.x; k <= r.y; ++k) {
        if (first || k < rp.x || k > rp.y) sf[s * tu + k] = (unsigned short)i;
        if (last || k < rn.x || k > rn.y) sl[s * tu + k] = (unsigned short)i;
      }
    }
    __syncthreads();

    // 3. the column's terms, in the first kernel's order
    if (own) {
      const bool scan = sflag[0] && sflag[1];
      for (int s = 0; s < nseg; ++s) {
        const int i0 = scan ? off[s] : sf[s * tu + c];
        const int i1 = scan ? off[s + 1] - 1 : sl[s * tu + c];
        for (int i = i0; i <= i1; ++i) {
          const short2 r = sr[i];
          if (c < r.x || c > r.y) continue;
          const float w = sw[i * ku + (c - r.x)];
          if (w == 0.0f) continue;
          const T* xq = sx + i * row + j * VN;
#pragma unroll
          for (int q = 0; q < NV; ++q) {
            float x[VN];
            fan_load16(xq + q * tl * VN, x);
#pragma unroll
            for (int e = 0; e < VN; ++e) acc[q * VN + e] += w * x[e];
          }
        }
      }
    }
    __syncthreads();
  }
  if (!own) return;
  const bool bad = sflag[2] != 0;
  float* dst =
      out + ((long long)__ldg(rows + a) * nu + u_first + c) * lanes + lane0;
#pragma unroll
  for (int q = 0; q < NV; ++q)
#pragma unroll
    for (int e = 0; e < VN; ++e) {
      const int lane = (q * tl + j) * VN + e;
      if (lane < nlc) dst[lane] = bad ? fan_nan() : acc[q * VN + e];
    }
}

// BP (gather form): a thread per (voxel gi, li; LPT lanes), blockDim.x
// consecutive threads of a warp per voxel carrying its chunk of LPT *
// blockDim.x lanes (the FP's lane assignment), blockDim.y x blockDim.z
// voxels a block.  First every column's divisor (fan_edges) into shared
// memory.  The voxel's threads take the views blockDim.x at a time: thread
// j forms the trapezoid of view a0 + j, its exact column window and its
// weights, and leaves them in its slots of the warp's shared memory (su:
// first column << 16 | count; sw: the weights); then every thread of the
// voxel sums, view after view and column after column, the weights times
// its lanes of the sinogram.  `accumulate` adds into the buffer (the second
// view group) instead of overwriting it (the first).
template <typename T, bool CURVED, int LPT>
__global__ void __launch_bounds__(FAN_MAX_THREADS)
    bp_fan_sf_kernel(const float* __restrict__ table,
                     const int* __restrict__ rows, int n_views,
                     const T* __restrict__ q, float* __restrict__ out, int ng,
                     int nl, int lanes, long long gs, long long ls, int nu,
                     float e0, float du, float sdd, float dxv, int accumulate,
                     int ku) {
  constexpr int VN = FanVec<T>::N, NV = LPT / VN;
  extern __shared__ __align__(16) unsigned char fan_smem[];
  const int tl = blockDim.x, j = threadIdx.x;
  const int gi = blockIdx.x * blockDim.y + threadIdx.y;
  const int li = blockIdx.y * blockDim.z + threadIdx.z;
  const int lc = LPT * tl, lane0 = blockIdx.z * lc;
  const int nlc = min(lc, lanes - lane0);
  const int tid = j + tl * (threadIdx.y + blockDim.y * threadIdx.z);
  const int nt = tl * blockDim.y * blockDim.z;
  const int wl = tid & 31, first = wl - j, kup = ku | 1;
  float2* sd = reinterpret_cast<float2*>(fan_smem);
  float* sw = reinterpret_cast<float*>(fan_smem + fan_align16((size_t)nu * 8)) +
              (tid >> 5) * 32 * (kup + 1);
  unsigned* su = reinterpret_cast<unsigned*>(sw + 32 * kup);
  const bool live = gi < ng && li < nl;
  const float rdu = __frcp_rn(du);

  for (int u = tid; u < nu; u += nt) {
    const float4 e = fan_edges(e0, du, u);
    sd[u] = make_float2(e.z, e.w);
  }
  __syncthreads();

  float acc[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) acc[k] = 0.0f;
  bool bad = false;

  for (int a0 = 0; a0 < n_views; a0 += tl) {
    const int a = a0 + j;
    int u0 = 0, cnt = 0;
    if (live && a < n_views) {
      const FanTrap f = fan_trap(table + 20 * a, gi, li, sdd, dxv, CURVED);
      int u1;
      fan_column_window(f.t0, f.t3, e0, du, rdu, 0, nu, &u0, &u1);
      cnt = max(u1 - u0 + 1, 0);
      if (cnt > ku) {
        cnt = ku + 1;
      } else {
        for (int k = 0; k < cnt; ++k) {
          const float el = sf_edge(e0, du, u0 + k);
          const float2 d = sd[u0 + k];
          sw[wl * kup + k] =
              round_like<T>(fan_weight(el, __fadd_rn(el, du), d.x, d.y, f));
        }
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
        // one column's terms; the first FAN_BP_UNROLL columns unrolled, so
        // that their loads are in flight together
        auto column = [&](int k) {
          const float w = wb[k];
          if (w == 0.0f) return;
          const T* xk = xb + (long long)k * lanes;
#pragma unroll
          for (int i = 0; i < NV; ++i) {
            const int v0 = (i * tl + j) * VN;
            if (v0 < nlc) {
              float x[VN];
              fan_ldg16(xk + v0, x);
#pragma unroll
              for (int e = 0; e < VN; ++e) acc[i * VN + e] += w * x[e];
            }
          }
        };
#pragma unroll
        for (int k = 0; k < FAN_BP_UNROLL; ++k)
          if (k < cb) column(k);
        for (int k = FAN_BP_UNROLL; k < cb; ++k) column(k);
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
        dst[lane] = bad ? fan_nan() : v;
      }
    }
}

// Bytes of the BP's shared memory: the columns' divisors, then the warp
// slots of `threads` threads for ku columns.
static int bp_smem_bytes(int nu, int threads, int ku) {
  return (int)(fan_align16((size_t)nu * 8) +
               (size_t)(threads + 31) / 32 * 32 * ((ku | 1) + 1) * 4);
}

static int fan_elem(int dtype) { return dtype == 0 ? 4 : 2; }

// The dynamic shared memory of the FP of dtype at a layout, in bytes.
static int fp_smem_bytes(int dtype, int tu, int tl, int lpt, int nl, int vcap,
                         int segs, int ku) {
  const int elem = fan_elem(dtype);
  return (int)fan_fp_smem(elem, 16 / elem, tu, lpt * tl, nl, vcap, segs, ku)
      .bytes;
}

template <typename K>
static cudaError_t fan_smem_attr(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// Call F::template run<T, CURVED, LPT>() for the instance of dtype (0 =
// float32, 1 = bfloat16 tiles), curved (0 = flat, 1 = equiangular) and lpt
// (8 or 16 lanes a thread).
template <class F>
static cudaError_t fan_dispatch(int dtype, int curved, int lpt, F f) {
  if ((dtype != 0 && dtype != 1) || (lpt != 8 && lpt != 16))
    return cudaErrorInvalidValue;
  if (dtype == 0) {
    if (curved)
      return lpt == 8 ? f.template run<float, true, 8>()
                      : f.template run<float, true, 16>();
    return lpt == 8 ? f.template run<float, false, 8>()
                    : f.template run<float, false, 16>();
  }
  if (curved)
    return lpt == 8 ? f.template run<__nv_bfloat16, true, 8>()
                    : f.template run<__nv_bfloat16, true, 16>();
  return lpt == 8 ? f.template run<__nv_bfloat16, false, 8>()
                  : f.template run<__nv_bfloat16, false, 16>();
}

extern "C" const char* fp_fan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

namespace {

// The launches of one FP, one BP, or an occupancy query, for fan_dispatch.
struct FanFpRun {
  dim3 grid, block;
  int smem;
  cudaStream_t s;
  const float* table;
  const int* rows;
  const void* g;
  float* out;
  int ng, nl, lanes;
  long long gs, ls;
  int nu;
  float e0, du, sdd, dxv, hw;
  int vcap, segs, ku;
  template <typename T, bool C, int L>
  cudaError_t run() const {
    auto k = fp_fan_sf_kernel<T, C, L>;
    const cudaError_t err = fan_smem_attr(k, smem);
    if (err != cudaSuccess) return err;
    k<<<grid, block, smem, s>>>(table, rows, (const T*)g, out, ng, nl, lanes,
                                gs, ls, nu, e0, du, sdd, dxv, hw, vcap, segs,
                                ku);
    return cudaGetLastError();
  }
};

struct FanBpRun {
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
  float e0, du, sdd, dxv;
  int accumulate, ku;
  template <typename T, bool C, int L>
  cudaError_t run() const {
    auto k = bp_fan_sf_kernel<T, C, L>;
    const cudaError_t err = fan_smem_attr(k, smem);
    if (err != cudaSuccess) return err;
    k<<<grid, block, smem, s>>>(table, rows, n_views, (const T*)q, out, ng,
                                nl, lanes, gs, ls, nu, e0, du, sdd, dxv,
                                accumulate, ku);
    return cudaGetLastError();
  }
};

template <typename K>
cudaError_t fan_occupancy(K kernel, int threads, int smem, int* blocks) {
  const cudaError_t err = fan_smem_attr(kernel, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads,
                                                       smem);
}

struct FanOcc {
  int fp, threads, smem;
  int* blocks;
  template <typename T, bool C, int L>
  cudaError_t run() const {
    return fp ? fan_occupancy(fp_fan_sf_kernel<T, C, L>, threads, smem, blocks)
              : fan_occupancy(bp_fan_sf_kernel<T, C, L>, threads, smem, blocks);
  }
};

// The kernels read tiles 16 bytes at a time: the tile's address and its
// lanes' bytes must be multiples of 16.
bool fan_aligned(const void* x, int lanes, int dtype) {
  return (uintptr_t)x % 16 == 0 && lanes * fan_elem(dtype) % 16 == 0;
}

}  // namespace

// The FP of kernels/fp_fan.py `FanPlan.fp_layout`: tu columns x tl threads
// a column of lpt lanes a block, pieces of vcap voxel slots in segs line
// segments, ku columns a voxel at most.  The tile's address and its lanes'
// bytes are multiples of 16.  Returns the error of the launch (a failed
// shared-memory attribute included; 0 when the launch was accepted).
extern "C" int fp_fan_sf_launch(int dtype, const void* table, const void* rows,
                                int n_views, const void* g, void* out, int ng,
                                int nl, int lanes, long long gs, long long ls,
                                int nu, float e0, float du, float sdd,
                                float dxv, float hw, int curved, int tu,
                                int tl, int lpt, int vcap, int segs, int ku,
                                void* stream) {
  if (n_views == 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (!fan_aligned(g, lanes, dtype)) return (int)cudaErrorMisalignedAddress;
  if (vcap < 1 || vcap > 65535 || segs < 1 || ku < 1 || tu > 32767)
    return (int)cudaErrorInvalidValue;
  const int lc = lpt * tl;
  const FanFpRun run{dim3((nu + tu - 1) / tu, n_views, (lanes + lc - 1) / lc),
                     dim3(tl, tu),
                     fp_smem_bytes(dtype, tu, tl, lpt, nl, vcap, segs, ku),
                     (cudaStream_t)stream, (const float*)table,
                     (const int*)rows, g, (float*)out, ng, nl, lanes, gs, ls,
                     nu, e0, du, sdd, dxv, hw, vcap, segs, ku};
  return (int)fan_dispatch(dtype, curved, lpt, run);
}

// The BP of `FanPlan.bp_layout`: bx x by voxels (gi x li) and tl threads a
// voxel of lpt lanes a block, ku columns a (voxel, view) at most; 16-byte
// aligned as the FP.
extern "C" int bp_fan_sf_launch(int dtype, const void* table, const void* rows,
                                int n_views, const void* q, void* out, int ng,
                                int nl, int lanes, long long gs, long long ls,
                                int nu, float e0, float du, float sdd,
                                float dxv, int curved, int accumulate, int bx,
                                int by, int tl, int lpt, int ku,
                                void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (!fan_aligned(q, lanes, dtype)) return (int)cudaErrorMisalignedAddress;
  if (ku < 1 || ku > FAN_MAX_KU || nu > 65536)
    return (int)cudaErrorInvalidValue;
  const int lc = lpt * tl;
  const FanBpRun run{
      dim3((ng + bx - 1) / bx, (nl + by - 1) / by, (lanes + lc - 1) / lc),
      dim3(tl, bx, by), bp_smem_bytes(nu, tl * bx * by, ku),
      (cudaStream_t)stream, (const float*)table, (const int*)rows, n_views, q,
      (float*)out, ng, nl, lanes, gs, ls, nu, e0, du, sdd, dxv, accumulate,
      ku};
  return (int)fan_dispatch(dtype, curved, lpt, run);
}

// The FP instance of dtype, curved and lpt at a layout (as fp_fan_sf_launch
// takes it, with nl loop lines): the dynamic shared memory the launch asks
// for (*smem, bytes; the host checks its own count against it) and resident
// blocks per SM at that size on this card (*blocks).  Returns the CUDA
// error.
extern "C" int fp_fan_sf_info(int dtype, int curved, int tu, int tl, int lpt,
                              int nl, int vcap, int segs, int ku, int* smem,
                              int* blocks) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  *smem = fp_smem_bytes(dtype, tu, tl, lpt, nl, vcap, segs, ku);
  const FanOcc occ{1, tl * tu, *smem, blocks};
  return (int)fan_dispatch(dtype, curved, lpt, occ);
}

// The same for the BP instance with `threads` threads a block, nu columns
// and ku columns a (voxel, view).
extern "C" int bp_fan_sf_info(int dtype, int curved, int lpt, int threads,
                              int nu, int ku, int* smem, int* blocks) {
  *smem = bp_smem_bytes(nu, threads, ku);
  const FanOcc occ{0, threads, *smem, blocks};
  return (int)fan_dispatch(dtype, curved, lpt, occ);
}

// fan_div_rn against __fdiv_rn on n pseudo-random (ov, dv) pairs from
// `seed`: dv log-uniform over [2^-30, 2^20] (2 d01 and 2 d23 reach down to
// 2e-9, the pixel widths sit near du), ov uniform in [0, 2 dv) with one pair
// in eight scaled below 2^-60 (the scaled branch) and one in 64 set to 0.
// Adds the pairs that differ in any bit to *bad.
__global__ void fan_div_check_kernel(unsigned seed, unsigned long long n,
                                     unsigned long long* bad) {
  unsigned cnt = 0;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x +
                              threadIdx.x;
       i < n; i += (unsigned long long)gridDim.x * blockDim.x) {
    unsigned long long x = (i + 1) * 0x9E3779B97F4A7C15ull ^ seed;
    x ^= x >> 31;
    x *= 0xBF58476D1CE4E5B9ull;
    x ^= x >> 27;
    x *= 0x94D049BB133111EBull;
    x ^= x >> 31;
    const float u1 = (float)(x & 0xffffff) * 0x1p-24f;
    const float u2 = (float)((x >> 24) & 0xffffff) * 0x1p-24f;
    const float dv = exp2f(-30.0f + 50.0f * u1);
    float ov = __fmul_rn(2.0f * u2, dv);
    if (((x >> 48) & 7) == 0) ov = __fmul_rn(ov, 0x1p-70f);
    if (((x >> 51) & 63) == 0) ov = 0.0f;
    cnt += __float_as_uint(fan_div_rn(ov, dv, __frcp_rn(dv))) !=
           __float_as_uint(__fdiv_rn(ov, dv));
  }
  for (int o = 16; o > 0; o >>= 1) cnt += __shfl_down_sync(0xffffffffu, cnt, o);
  if ((threadIdx.x & 31) == 0 && cnt) atomicAdd(bad, (unsigned long long)cnt);
}

extern "C" int fp_fan_div_check(unsigned seed, unsigned long long n, void* bad,
                                void* stream) {
  fan_div_check_kernel<<<1056, 256, 0, (cudaStream_t)stream>>>(
      seed, n, (unsigned long long*)bad);
  return (int)cudaGetLastError();
}
