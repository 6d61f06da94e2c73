// K1's coordinate rules (letterbox, axis_lerp, source_index), which
// batch_resize.cu evaluates once per column and row of a tile, and the
// per-pixel crop sampler built from them, which divergent.cu runs.
//
// Every step matches cvgpuspeedup_tpu_torch/ops/resize.py bit for bit: the
// letterbox fit in f32 with a truncating conversion, the rational source
// coordinates with a floor division for the left tap and one correctly
// rounded division for the weight, a tap left of or above the frame read
// from the far edge and one past the right or bottom edge read at the edge
// (source_index), the lerps horizontal first, then vertical.

#pragma once

#include "chain.cuh"

namespace {

// AspectRatio codes; keep in step with exec/cuda_batch_resize.py
enum : int { AR_IGNORE = 0, AR_PRESERVE = 1, AR_RN_EVEN = 2, AR_LEFT = 3 };

// ops/resize.py::letterbox_geometry
__device__ __forceinline__ void letterbox(int cw, int ch, int dst_w, int dst_h, int mode,
                                          int& nw, int& nh, int& ox, int& oy) {
  if (mode == AR_IGNORE) {
    nw = dst_w;
    nh = dst_h;
    ox = 0;
    oy = 0;
    return;
  }
  const float scale = __fdiv_rn((float)dst_h, (float)ch);
  int w = (int)__fmul_rn(scale, (float)cw);  // trunc, as static_cast<int>
  int h = dst_h;
  if (w > dst_w) {
    const float scale2 = __fdiv_rn((float)dst_w, (float)cw);
    h = (int)__fmul_rn(scale2, (float)ch);
    w = dst_w;
  }
  if (mode == AR_RN_EVEN) {
    w = min(floor_div(w + 1, 2) * 2, dst_w);
    h = min(floor_div(h + 1, 2) * 2, dst_h);
  }
  if (mode == AR_LEFT) {
    ox = 0;
    oy = 0;
  } else {
    ox = floor_div(dst_w - w, 2);
    oy = floor_div(dst_h - h, 2);
  }
  nw = w;
  nh = h;
}

// ops/resize.py::axis_lerp for one output index (dst >= 1)
__device__ __forceinline__ void axis_lerp(int q, int src, int dst, int& i0, int& i1, float& w) {
  const int num = (2 * q + 1) * src - dst;
  const int den = 2 * dst;
  int i = floor_div(num, den);
  float wt = __fdiv_rn((float)(num - i * den), (float)den);
  if (i < 0) wt = 0.f;
  i = max(i, 0);
  if (i >= src - 1) wt = 0.f;
  i = min(i, src - 1);
  i0 = i;
  i1 = min(i + 1, src - 1);
  w = wt;
}

// ops/resize.py::source_index: a negative index counts from the far end,
// then the index is clamped into the source, as the reference's gather reads
__device__ __forceinline__ int source_index(int t, int len) {
  return clampi(t < 0 ? t + len : t, 0, len - 1);
}

// Output pixel (x, y) of the crop [rx, ry, rw, rh] of `plane`, an
// (src_h, src_w * nch) image, resized to dst_w x dst_h under the
// aspect-ratio `mode`, into v[0..nch). Returns false, leaving v alone,
// where the pixel lies outside the letterbox sub-rect.
template <typename SrcT>
__device__ __forceinline__ bool sample_crop(const SrcT* __restrict__ plane, int src_h, int src_w,
                                            int nch, int rx, int ry, int rw, int rh, int dst_w,
                                            int dst_h, int mode, int x, int y,
                                            float (&v)[kMaxCh]) {
  int nw, nh, ox, oy;
  letterbox(rw, rh, dst_w, dst_h, mode, nw, nh, ox, oy);
  if (!(x >= ox && x < ox + nw && y >= oy && y < oy + nh)) return false;
  int ix0, ix1, iy0, iy1;
  float wx, wy;
  axis_lerp(x - ox, rw, nw, ix0, ix1, wx);
  axis_lerp(y - oy, rh, nh, iy0, iy1, wy);
  const long long row = (long long)src_w * nch;
  const SrcT* r0 = plane + source_index(ry + iy0, src_h) * row;
  const SrcT* r1 = plane + source_index(ry + iy1, src_h) * row;
  const int c0 = source_index(rx + ix0, src_w) * nch;
  const int c1 = source_index(rx + ix1, src_w) * nch;
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) {
    if (c < nch) {
      const float h0 = lerp_rn(ldf(r0 + c0 + c), ldf(r0 + c1 + c), wx);
      const float h1 = lerp_rn(ldf(r1 + c0 + c), ldf(r1 + c1 + c), wx);
      v[c] = lerp_rn(h0, h1, wy);
    }
  }
  return true;
}

}  // namespace
