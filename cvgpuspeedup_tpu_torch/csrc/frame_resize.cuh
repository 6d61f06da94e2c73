// K2's samplers over host tap tables, shared by frame_resize.cu and
// divergent.cu: a packed image, and an NV12/NV21 buffer with YUV->RGB. A
// sample has a row's part (image_rows, nv12_rows: the two source rows and
// the vertical weight, read once per thread) and a pixel's part
// (image_pixels, nv12_pixels: the x taps and weight, the taps' values, the
// lerps) for the thread's P adjacent pixels of that row.
//
// Every step matches cvgpuspeedup_tpu_torch/ops/resize.py::sample_frame and
// ops/nv12.py bit for bit: horizontal lerp, then vertical, each
// a*(1-w) + b*w; with keep_edge a weight of 0 keeps the first tap's value;
// the conversion in the reference's f32 op order.
//
// Every tap is read element by element. Two wider fetches were built and
// measured slower on an H100: a uint8 image's two adjacent taps of a row as
// three aligned 4-byte words, as the warp kernel fetches them (3 to 9 %
// slower at every size: neighbouring threads' taps already share their
// sectors in L1, and the funnel shifts and bounds tests are extra
// instructions), and an NV12 tap's UV pair as one aligned 2-byte load (7 %
// slower on a 6K buffer -> 1080p).
//
// Tap tables, int32, each one entry per output column or row:
//   [x0 | x1 | y0 | y1] and, for an NV12 source, [cx0 | cx1 | cy0 | cy1];
// weights, float32: [wx | wy].

#pragma once

#include "chain.cuh"

// The YUV -> RGB conversion's range, alpha and coefficients (ops/nv12.py);
// outside the anonymous namespace, since a launch's arguments hold it
// across translation units (frame_resize_kernel.cuh).
namespace cvgs {
struct Conv {
  int limited, alpha;
  float ys, cs, rv, gu, gv, bu;
};
}  // namespace cvgs

namespace {

using cvgs::Conv;

// The bilinear sample of a, b (the two taps of the upper row) and d, e (of
// the lower one).
__device__ __forceinline__ float bilerp_values(float a, float b, float d, float e, float wx,
                                               float wy, bool keep_edge) {
  float h0 = a, h1 = d;
  if (!(keep_edge && wx == 0.f)) {
    h0 = lerp_rn(a, b, wx);
    h1 = lerp_rn(d, e, wx);
  }
  return (keep_edge && wy == 0.f) ? h0 : lerp_rn(h0, h1, wy);
}

// One bilinear sample from rows r0, r1 at element offsets c0, c1.
template <typename SrcT>
__device__ __forceinline__ float bilerp(const SrcT* __restrict__ r0, const SrcT* __restrict__ r1,
                                        int c0, int c1, float wx, float wy, bool keep_edge) {
  const float a = ldf(r0 + c0);
  const float d = ldf(r1 + c0);
  float h0 = a, h1 = d;
  if (!(keep_edge && wx == 0.f)) {  // else the second taps are not read
    h0 = lerp_rn(a, ldf(r0 + c1), wx);
    h1 = lerp_rn(d, ldf(r1 + c1), wx);
  }
  return (keep_edge && wy == 0.f) ? h0 : lerp_rn(h0, h1, wy);
}

// The two source rows of output row y of an (src_h, src_w * nch) image and
// its vertical weight.
template <typename SrcT>
struct ImageRows {
  const SrcT* r0;
  const SrcT* r1;
  float wy;
};

template <typename SrcT>
__device__ __forceinline__ ImageRows<SrcT> image_rows(const SrcT* __restrict__ src, int src_w,
                                                      int nch, const int* __restrict__ taps,
                                                      const float* __restrict__ wts, int dst_w,
                                                      int dst_h, int y) {
  const int y0 = __ldg(taps + 2 * dst_w + y), y1 = __ldg(taps + 2 * dst_w + dst_h + y);
  const long long row = (long long)src_w * nch;
  return {src + y0 * row, src + y1 * row, __ldg(wts + dst_w + y)};
}

// Output pixels x .. x + n - 1 (n <= P) of the row `r`, into v[q][0..nch).
template <typename SrcT, int P>
__device__ __forceinline__ void image_pixels(const ImageRows<SrcT>& r, int nch,
                                             const int* __restrict__ taps,
                                             const float* __restrict__ wts, int dst_w, int x, int n,
                                             bool keep, float (&v)[P][kMaxCh]) {
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (q >= n) continue;
    const int c0 = __ldg(taps + x + q) * nch, c1 = __ldg(taps + dst_w + x + q) * nch;
    const float wx = __ldg(wts + x + q);
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) {
      if (c < nch) v[q][c] = bilerp(r.r0, r.r1, c0 + c, c1 + c, wx, r.wy, keep);
    }
  }
}

// The luma and chroma rows of output row y of an NV12/NV21 buffer of an
// src_h x src_w frame (src_h rows of src_w luma bytes, then src_h / 2 rows
// of src_w / 2 UV pairs) and its vertical weight.
struct Nv12Rows {
  const uint8_t* y0;
  const uint8_t* y1;
  const uint8_t* uv0;
  const uint8_t* uv1;
  float wy;
};

__device__ __forceinline__ Nv12Rows nv12_rows(const uint8_t* __restrict__ src, int src_h,
                                              int src_w, const int* __restrict__ taps,
                                              const float* __restrict__ wts, int dst_w, int dst_h,
                                              int y) {
  const int* ct = taps + 2 * (dst_w + dst_h) + 2 * dst_w;
  const int y0 = __ldg(taps + 2 * dst_w + y), y1 = __ldg(taps + 2 * dst_w + dst_h + y);
  const int cy0 = __ldg(ct + y), cy1 = __ldg(ct + dst_h + y);
  const uint8_t* uv = src + (long long)src_h * src_w;
  return {src + (long long)y0 * src_w, src + (long long)y1 * src_w,
          uv + (long long)cy0 * src_w, uv + (long long)cy1 * src_w, __ldg(wts + dst_w + y)};
}

// The UV pair at byte offset c of a chroma row, byte 0 in the low bits.
__device__ __forceinline__ unsigned load_pair(const uint8_t* __restrict__ row, int c) {
  return (unsigned)__ldg(row + c) | ((unsigned)__ldg(row + c + 1) << 8);
}

// ops/nv12.py::ConvertYUVToRGB.apply on sampled (yv, u, w), op for op, into
// v[0..3) (v[3] = 1 for alpha).
__device__ __forceinline__ void yuv_to_rgb(float yv, float u, float w, const Conv& conv,
                                           float (&v)[kMaxCh]) {
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

// Output pixels x .. x + n - 1 (n <= P) of the row `r`, converted to RGB
// into v[q][0..3) (v[q][3] = 1 for alpha): luma at full resolution, the UV
// pairs at half resolution with the full-resolution taps halved, the
// conversion on the sampled values. One pixel is sampled tap by tap; of
// several, every load is started before the first lerp (7 % faster on a 6K
// buffer -> 1080p with 4 pixels, 5 % slower with 1).
template <int P>
__device__ __forceinline__ void nv12_pixels(const Nv12Rows& r, int nv21,
                                            const int* __restrict__ taps,
                                            const float* __restrict__ wts, int dst_w, int dst_h,
                                            int x, int n, bool keep, const Conv& conv,
                                            float (&v)[P][kMaxCh]) {
  const int* ct = taps + 2 * (dst_w + dst_h);
  const int iu = nv21 ? 1 : 0;
  if constexpr (P == 1) {
    const int cx0 = 2 * __ldg(ct + x), cx1 = 2 * __ldg(ct + dst_w + x);
    const float wx = __ldg(wts + x);
    yuv_to_rgb(bilerp(r.y0, r.y1, __ldg(taps + x), __ldg(taps + dst_w + x), wx, r.wy, keep),
               bilerp(r.uv0, r.uv1, cx0 + iu, cx1 + iu, wx, r.wy, keep),
               bilerp(r.uv0, r.uv1, cx0 + 1 - iu, cx1 + 1 - iu, wx, r.wy, keep), conv, v[0]);
  } else {
    float wx[P], lum[P];
    unsigned p00[P], p01[P], p10[P], p11[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int xq = min(x + q, dst_w - 1);  // a row's tail repeats its last column
      const int cx0 = 2 * __ldg(ct + xq), cx1 = 2 * __ldg(ct + dst_w + xq);
      wx[q] = __ldg(wts + xq);
      lum[q] = bilerp(r.y0, r.y1, __ldg(taps + xq), __ldg(taps + dst_w + xq), wx[q], r.wy, keep);
      p00[q] = load_pair(r.uv0, cx0);
      p01[q] = load_pair(r.uv0, cx1);
      p10[q] = load_pair(r.uv1, cx0);
      p11[q] = load_pair(r.uv1, cx1);
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (q >= n) continue;
      yuv_to_rgb(lum[q],
                 bilerp_values(byte_of(p00[q], iu), byte_of(p01[q], iu), byte_of(p10[q], iu),
                               byte_of(p11[q], iu), wx[q], r.wy, keep),
                 bilerp_values(byte_of(p00[q], 1 - iu), byte_of(p01[q], 1 - iu),
                               byte_of(p10[q], 1 - iu), byte_of(p11[q], 1 - iu), wx[q], r.wy, keep),
                 conv, v[q]);
    }
  }
}

}  // namespace
