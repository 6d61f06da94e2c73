// The warp kernel's samplers, shared by warp.cu and divergent.cu: the sample
// at one source coordinate (sample_point) and the per-pixel sampler that
// computes the coordinate first (sample_warp, the divergent kernel's).
//
// Every step matches cvgpuspeedup_tpu_torch/ops/warp.py bit for bit. The
// coordinates are recomputed from the plane's float32 inverse map in the op
// order of ops/warp.py::decompose_inverse_map,
//   sx = c00*X + (c01*Y + c02),  sy = c10*X + (c11*Y + c12),
// each product and sum rounded once; a perspective map divides both by
// den = c20*X + (c21*Y + c22), with den == 0 taken as 1. The host computes
// the terms c00*X and c01*Y + c02 in numpy, which keeps a subnormal operand
// or result, and only their sum is a flushed float32 op: map_coords computes
// the terms so for every map (fmul_keep, fadd_keep) and flushes the sum. A
// tap is valid when it lies inside the source, decided on the floored
// coordinate in float before any integer conversion, so a coordinate far
// outside int32 reads the border and nothing overflows; an invalid tap
// reads the plane's per-channel border value. The lerps go horizontal,
// then vertical.

#pragma once

#include "chain.cuh"

namespace {

constexpr int kCoeffs = 9;  // per plane in a parameter block

// a * b and a + b rounded once to float32 as numpy rounds them, a subnormal
// operand or result kept: PTX mul.rn.f32 and add.rn.f32 without .ftz, so
// -ftz=true flushes neither. They are the SASS census's one exception, an
// FMUL or FADD without .FTZ (tools/kernel_sass.py::KEEP_TERMS).
__device__ __forceinline__ float fmul_keep(float a, float b) {
  float d;
  asm("mul.rn.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float fadd_keep(float a, float b) {
  float d;
  asm("add.rn.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The source coordinates (sx[p], sy[p]) of the P pixels at columns xs[p] of
// row y under the map c (6 coefficients; 9 where persp), each coefficient
// loaded once: the row's terms b*Y + c once, the column's a*X per pixel, as
// the host computes them (fmul_keep, fadd_keep); then the flushed sums and
// a perspective map's division.
template <int P>
__device__ __forceinline__ void map_coords(const float* __restrict__ c, bool persp,
                                           const int (&xs)[P], int y, float (&sx)[P],
                                           float (&sy)[P]) {
  float k[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) k[i] = i < 6 || persp ? __ldg(c + i) : 0.f;
  const float fy = (float)y;
  float cx[P], cy[P], cw[P];
  const float rx = fadd_keep(fmul_keep(k[1], fy), k[2]);
  const float ry = fadd_keep(fmul_keep(k[4], fy), k[5]);
  const float rw = persp ? fadd_keep(fmul_keep(k[7], fy), k[8]) : 0.f;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const float fx = (float)xs[p];
    cx[p] = fmul_keep(k[0], fx);
    cy[p] = fmul_keep(k[3], fx);
    cw[p] = persp ? fmul_keep(k[6], fx) : 0.f;
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    sx[p] = __fadd_rn(cx[p], rx);
    sy[p] = __fadd_rn(cy[p], ry);
    if (persp) {
      float den = __fadd_rn(cw[p], rw);
      if (den == 0.f) den = 1.f;
      sx[p] = __fdiv_rn(sx[p], den);
      sy[p] = __fdiv_rn(sy[p], den);
    }
  }
}

// The tap at p where ok, else the border value b. A float64 element is
// loaded under the predicate and converted whatever it holds, so that the
// conversion (PTX, chain.cuh::to_f32) needs no branch of its own.
template <typename SrcT>
__device__ __forceinline__ float tap(bool ok, const SrcT* __restrict__ p, float b) {
  return ok ? ldf(p) : b;
}
__device__ __forceinline__ float tap(bool ok, const double* __restrict__ p, float b) {
  const float f = to_f32(ok ? __ldg(p) : 0.0);
  return ok ? f : b;
}

// The sample of `src`, an (src_h, src_w * nch) image (sides below 2^24), at
// the float coordinates (px, py) with the border values b, into v[0..nch):
// four taps, each outside the source replaced by the border, the lerps
// horizontal, then vertical.
template <typename SrcT>
__device__ __forceinline__ void sample_point(const SrcT* __restrict__ src, int src_h, int src_w,
                                             int nch, const float (&b)[kMaxCh], float px,
                                             float py, float (&v)[kMaxCh]) {
  const float x0f = floorf(px), y0f = floorf(py);
  const float wx = __fsub_rn(px, x0f), wy = __fsub_rn(py, y0f);
  const float fw = (float)src_w, fh = (float)src_h;  // exact: sides < 2^24
  const bool vx0 = x0f >= 0.f && x0f < fw, vx1 = x0f >= -1.f && x0f < fw - 1.f;
  const bool vy0 = y0f >= 0.f && y0f < fh, vy1 = y0f >= -1.f && y0f < fh - 1.f;
  const int ix0 = vx0 ? (int)x0f * nch : 0, ix1 = vx1 ? ((int)x0f + 1) * nch : 0;
  const long long row = (long long)src_w * nch;
  const SrcT* r0 = src + (vy0 ? (long long)y0f * row : 0);
  const SrcT* r1 = src + (vy1 ? ((long long)y0f + 1) * row : 0);
#pragma unroll
  for (int ch = 0; ch < kMaxCh; ++ch) {
    if (ch < nch) {
      const float v00 = tap(vy0 && vx0, r0 + ix0 + ch, b[ch]);
      const float v01 = tap(vy0 && vx1, r0 + ix1 + ch, b[ch]);
      const float v10 = tap(vy1 && vx0, r1 + ix0 + ch, b[ch]);
      const float v11 = tap(vy1 && vx1, r1 + ix1 + ch, b[ch]);
      v[ch] = lerp_rn(lerp_rn(v00, v01, wx), lerp_rn(v10, v11, wx), wy);
    }
  }
}

// Output pixel (x, y) of `src` warped through the inverse map `c` (6 or 9
// floats) with the border `b` (nch floats), into v[0..nch).
template <typename SrcT, bool kPersp>
__device__ __forceinline__ void sample_warp(const SrcT* __restrict__ src, int src_h, int src_w,
                                            int nch, const float* __restrict__ c,
                                            const float* __restrict__ b, int x, int y,
                                            float (&v)[kMaxCh]) {
  const int xs[1] = {x};
  float px[1], py[1];
  map_coords(c, kPersp, xs, y, px, py);
  float border[kMaxCh];
#pragma unroll
  for (int ch = 0; ch < kMaxCh; ++ch) border[ch] = ch < nch ? __ldg(b + ch) : 0.f;
  sample_point(src, src_h, src_w, nch, border, px[0], py[0], v);
}

}  // namespace
