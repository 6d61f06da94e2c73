// K2's per-pixel samplers over host tap tables, shared by frame_resize.cu
// and divergent.cu: a packed image, and an NV12/NV21 buffer with YUV->RGB.
//
// Every step matches cvgpuspeedup_tpu_torch/ops/resize.py::sample_frame and
// ops/nv12.py bit for bit: horizontal lerp, then vertical, each
// a*(1-w) + b*w; with keep_edge a weight of 0 keeps the first tap's value;
// the conversion in the reference's f32 op order.
//
// Tap tables, int32, each one entry per output column or row:
//   [x0 | x1 | y0 | y1] and, for an NV12 source, [cx0 | cx1 | cy0 | cy1];
// weights, float32: [wx | wy].

#pragma once

#include "chain.cuh"

namespace {

// One bilinear sample from rows r0, r1 at element offsets c0, c1.
template <typename SrcT>
__device__ __forceinline__ float bilerp(const SrcT* __restrict__ r0, const SrcT* __restrict__ r1,
                                        int c0, int c1, float wx, float wy, bool keep_edge) {
  const float a = (float)__ldg(r0 + c0);
  const float d = (float)__ldg(r1 + c0);
  float h0 = a, h1 = d;
  if (!(keep_edge && wx == 0.f)) {
    h0 = lerp_rn(a, (float)__ldg(r0 + c1), wx);
    h1 = lerp_rn(d, (float)__ldg(r1 + c1), wx);
  }
  return (keep_edge && wy == 0.f) ? h0 : lerp_rn(h0, h1, wy);
}

struct Conv {
  int limited, alpha;
  float ys, cs, rv, gu, gv, bu;
};

// Output pixel (x, y) of an (src_h, src_w * nch) image, into v[0..nch).
template <typename SrcT>
__device__ __forceinline__ void sample_image(const SrcT* __restrict__ src, int src_w, int nch,
                                             const int* __restrict__ taps,
                                             const float* __restrict__ wts, int dst_w, int dst_h,
                                             int x, int y, bool keep, float (&v)[kMaxCh]) {
  const int x0 = __ldg(taps + x), x1 = __ldg(taps + dst_w + x);
  const int y0 = __ldg(taps + 2 * dst_w + y), y1 = __ldg(taps + 2 * dst_w + dst_h + y);
  const float wx = __ldg(wts + x), wy = __ldg(wts + dst_w + y);
  const long long row = (long long)src_w * nch;
  const SrcT* r0 = src + y0 * row;
  const SrcT* r1 = src + y1 * row;
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) {
    if (c < nch) v[c] = bilerp(r0, r1, x0 * nch + c, x1 * nch + c, wx, wy, keep);
  }
}

// Output pixel (x, y) of an NV12 (nv21 = 0) or NV21 buffer of an
// src_h x src_w frame, converted to RGB into v[0..3) (v[3] = 1 for alpha):
// luma at full resolution, the UV pairs at half resolution with the
// full-resolution taps halved, the conversion on the sampled values.
__device__ __forceinline__ void sample_nv12(const uint8_t* __restrict__ src, int src_h, int src_w,
                                            int nv21, const int* __restrict__ taps,
                                            const float* __restrict__ wts, int dst_w, int dst_h,
                                            int x, int y, bool keep, const Conv& conv,
                                            float (&v)[kMaxCh]) {
  const int x0 = __ldg(taps + x), x1 = __ldg(taps + dst_w + x);
  const int y0 = __ldg(taps + 2 * dst_w + y), y1 = __ldg(taps + 2 * dst_w + dst_h + y);
  const float wx = __ldg(wts + x), wy = __ldg(wts + dst_w + y);
  // luma: src_h rows of src_w bytes; then src_h/2 rows of src_w/2 pairs
  const int* ct = taps + 2 * (dst_w + dst_h);
  const int cx0 = __ldg(ct + x), cx1 = __ldg(ct + dst_w + x);
  const int cy0 = __ldg(ct + 2 * dst_w + y), cy1 = __ldg(ct + 2 * dst_w + dst_h + y);
  const float lum = bilerp(src + (long long)y0 * src_w, src + (long long)y1 * src_w, x0, x1,
                           wx, wy, keep);
  const uint8_t* uv = src + (long long)src_h * src_w;
  const uint8_t* u0 = uv + (long long)cy0 * src_w;
  const uint8_t* u1 = uv + (long long)cy1 * src_w;
  const int iu = nv21 ? 1 : 0;
  float u = bilerp(u0, u1, 2 * cx0 + iu, 2 * cx1 + iu, wx, wy, keep);
  float w = bilerp(u0, u1, 2 * cx0 + 1 - iu, 2 * cx1 + 1 - iu, wx, wy, keep);
  // ops/nv12.py::ConvertYUVToRGB.apply, op for op
  float yv = lum;
  u = __fsub_rn(u, 128.f);
  w = __fsub_rn(w, 128.f);
  if (conv.limited) {
    yv = __fmul_rn(__fsub_rn(yv, 16.f), conv.ys);
    u = __fmul_rn(u, conv.cs);
    w = __fmul_rn(w, conv.cs);
  }
  v[0] = __fadd_rn(yv, __fmul_rn(conv.rv, w));
  v[1] = __fsub_rn(__fsub_rn(yv, __fmul_rn(conv.gu, u)), __fmul_rn(conv.gv, w));
  v[2] = __fadd_rn(yv, __fmul_rn(conv.bu, u));
  v[3] = 1.f;
}

}  // namespace
