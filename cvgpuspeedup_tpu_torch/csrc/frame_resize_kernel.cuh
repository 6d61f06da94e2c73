// K2, the full-frame resize kernel (frame_resize.cu): the kernel template and
// its launch for one source element type. frame_resize.cu instantiates it
// for NV12 buffers and uint8 and float32 images and holds the C entry;
// source_*.cu instantiate it for the other element types (sources.cuh).

#pragma once

#include "frame_resize.cuh"

// One launch's arguments, as the C entry takes them; store_op, where not 0,
// is the row that converts the chain's values for the buffer's dtype before
// the store (chain.cuh::run_integer_row).
namespace cvgs {
struct FrameResizeArgs {
  const void* src;
  int src_h, src_w, nch, nv21;
  const int* taps;
  const float* wts;
  int keep_edge;
  Conv conv;
  const float* fp;
  const int* ops;
  int n_ops, dst_w, dst_h;
  void* out;
  int out_type, out_ch;
  int store_op;
  long long sc, sy, sx;
  cudaStream_t stream;
};
}  // namespace cvgs

namespace {
namespace k2 {

using cvgs::FrameResizeArgs;

// The adjacent output pixels a thread takes, from the launch's output
// count: 4 where a thread per 4 pixels still fills 7/16 of the card's
// resident threads (an NV12 source: half of them), else 1. A small launch
// is bound by the latency of one thread's dependent chain, which more
// pixels per thread only lengthen.
inline int pixels_per_thread(long long outputs, bool yuv) {
  return 4 * outputs >= (yuv ? 8 : 7) * resident_threads() ? 4 : 1;
}

// The tap tables and weights are laid out as csrc/frame_resize.cuh says.
template <typename SrcT, typename OutT, bool kYuv, int P>
__global__ void __launch_bounds__(256) frame_resize_kernel(
    const SrcT* __restrict__ src, int src_h, int src_w, int nch, int nv21,
    const int* __restrict__ taps, const float* __restrict__ wts, int keep_edge, Conv conv,
    const float* __restrict__ fp, const int* __restrict__ ops, int n_ops, int dst_w, int dst_h,
    OutT* __restrict__ out, int out_ch, int store_op, long long sc, long long sy,
    long long sx) {
  const int x = (blockIdx.x * blockDim.x + threadIdx.x) * P;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= dst_w || y >= dst_h) return;
  const int n = min(P, dst_w - x);
  const bool keep = keep_edge != 0;
  float v[P][kMaxCh];
#pragma unroll
  for (int q = 0; q < P; ++q) {
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) v[q][c] = 0.f;
  }
  int ch;
  if constexpr (!kYuv) {
    image_pixels<SrcT, P>(image_rows(src, src_w, nch, taps, wts, dst_w, dst_h, y), nch, taps,
                          wts, dst_w, x, n, keep, v);
    ch = nch;
  } else {
    nv12_pixels<P>(nv12_rows(src, src_h, src_w, taps, wts, dst_w, dst_h, y), nv21, taps, wts,
                   dst_w, dst_h, x, n, keep, conv, v);
    ch = conv.alpha ? 4 : 3;
  }

  run_chain(v, ch, ops, n_ops, fp);
  if (store_op) run_integer_row(store_op, v);

  store_any(out + (long long)y * sy + (long long)x * sx, v, n, out_ch, sc, sx);
}


template <typename SrcT, typename OutT, bool kYuv>
void launch(const FrameResizeArgs& a) {
  const int pix = pixels_per_thread((long long)a.dst_w * a.dst_h, kYuv);
  const dim3 block = group_block(a.dst_w, pix);
  const int tile_w = block.x * pix;
  const dim3 grid((a.dst_w + tile_w - 1) / tile_w, (a.dst_h + block.y - 1) / block.y);
#define CVGS_KERNEL(P)                                                                            \
  frame_resize_kernel<SrcT, OutT, kYuv, P><<<grid, block, 0, a.stream>>>(                         \
      static_cast<const SrcT*>(a.src), a.src_h, a.src_w, a.nch, a.nv21, a.taps, a.wts,            \
      a.keep_edge, a.conv, a.fp, a.ops, a.n_ops, a.dst_w, a.dst_h, static_cast<OutT*>(a.out),     \
      a.out_ch, a.store_op, a.sc, a.sy, a.sx)
  if (pix == 4) {
    CVGS_KERNEL(4);
  } else {
    CVGS_KERNEL(1);
  }
#undef CVGS_KERNEL
}

// The launch for a source of element type SrcT (an NV12 buffer with kYuv),
// by the output's element type.
template <typename SrcT, bool kYuv = false>
void launch_source(const FrameResizeArgs& a) {
  switch (a.out_type) {
    case PW_U8:
    case PW_I8: launch<SrcT, uint8_t, kYuv>(a); break;
    case PW_U16:
    case PW_I16: launch<SrcT, uint16_t, kYuv>(a); break;
    case PW_F16: launch<SrcT, f16, kYuv>(a); break;
    default: launch<SrcT, float, kYuv>(a); break;
  }
}

}  // namespace k2
}  // namespace
