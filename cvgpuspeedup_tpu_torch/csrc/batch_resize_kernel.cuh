// K1, the batched crop-resize kernel (batch_resize.cu): the kernel template
// and its launch for one source element type. batch_resize.cu instantiates
// it for uint8 and float32 sources and holds the C entry; source_*.cu
// instantiate it for the other element types (sources.cuh), so that no one
// translation unit compiles every instance and the build runs them in
// parallel.

#pragma once

#include <algorithm>

#include "batch_resize.cuh"

// One launch's arguments, as the C entry takes them; store_op, where not 0,
// is the row that converts the chain's values for the buffer's dtype before
// the store (chain.cuh::run_integer_row).
namespace cvgs {
struct BatchResizeArgs {
  const void* src;
  long long plane_stride;
  int src_h, src_w, nch;
  const int* rects;
  const int* used;
  const float* fp;
  const int* ops;
  int n_ops, n_planes, dst_w, dst_h, mode;
  void* out;
  int out_type, out_ch;
  int store_op;
  long long sn, sc, sy, sx;
  cudaStream_t stream;
};
}  // namespace cvgs

namespace {
namespace k1 {

using cvgs::BatchResizeArgs;

constexpr int kThreads = 128;
constexpr int kPix = 4;                   // adjacent output pixels of a thread
constexpr int kMaxTileW = 256;            // output columns of a tile, a multiple of kPix
constexpr int kMaxTileH = 64;             // output rows of a tile

// A tile's taps. c0 < 0 marks a column, r0 < 0 a row, outside the letterbox.
struct Taps {
  int c0[kMaxTileW];
  int c1[kMaxTileW];
  float wx[kMaxTileW];
  int r0[kMaxTileH];
  int r1[kMaxTileH];
  float wy[kMaxTileH];
};

// One output pixel: its four taps at r0 and r1 + o0 and o1, the lerps
// horizontal, then vertical.
template <typename SrcT>
__device__ __forceinline__ void sample_pixel(const SrcT* __restrict__ r0,
                                             const SrcT* __restrict__ r1, int o0, int o1, int nch,
                                             float wx, float wy, float (&v)[kMaxCh]) {
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) {
    if (c >= nch) continue;
    const float a = ldf(r0 + o0 + c), b = ldf(r0 + o1 + c);
    const float d = ldf(r1 + o0 + c), e = ldf(r1 + o1 + c);
    v[c] = lerp_rn(lerp_rn(a, b, wx), lerp_rn(d, e, wx), wy);
  }
}

// The thread's n pixels from local columns lx.. (a multiple of kPix) of the
// tile, rows `r0`, `r1` of the source plane. A thread whose kPix pixels are
// all sampled runs them as one straight line, so their loads are in flight
// together; one that a letterbox border or the row's end cuts through takes
// them one by one and leaves the others at the background.
template <typename SrcT>
__device__ __forceinline__ void sample_pixels(const Taps& t, const SrcT* __restrict__ r0,
                                              const SrcT* __restrict__ r1, int nch, int lx, int n,
                                              float wy, float (&v)[kPix][kMaxCh]) {
  int a0[kPix], a1[kPix];
  float wx[kPix];
  bool all = n == kPix;
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
    a0[p] = t.c0[lx + p];
    a1[p] = t.c1[lx + p];
    wx[p] = t.wx[lx + p];
    all = all && a0[p] >= 0;
  }
  if (all) {
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      sample_pixel(r0, r1, a0[p] * nch, a1[p] * nch, nch, wx[p], wy, v[p]);
    }
  } else {
#pragma unroll
    for (int p = 0; p < kPix; ++p) {
      if (p < n && a0[p] >= 0) {
        sample_pixel(r0, r1, a0[p] * nch, a1[p] * nch, nch, wx[p], wy, v[p]);
      }
    }
  }
}

template <typename SrcT, typename OutT>
__global__ void __launch_bounds__(kThreads) batch_resize_kernel(
    const SrcT* __restrict__ src, long long plane_stride, int src_h, int src_w, int nch,
    const int* __restrict__ rects, const int* __restrict__ used, const float* __restrict__ fp,
    const int* __restrict__ ops, int n_ops, int dst_w, int dst_h, int mode, int tile_w,
    int tile_h, OutT* __restrict__ out, int out_ch, int store_op, long long sn,
    long long sc, long long sy, long long sx) {
  __shared__ Taps t;

  const int z = blockIdx.z;
  const int tx0 = blockIdx.x * tile_w, ty0 = blockIdx.y * tile_h;
  const int groups = tile_w / kPix;
  const int ly = threadIdx.x / groups;
  const int lx = (threadIdx.x - ly * groups) * kPix;
  const int x = tx0 + lx, y = ty0 + ly;
  const bool active = ly < tile_h && x < dst_w && y < dst_h;
  // the block's uniform loads, all in flight before the first is used
  const int* r = rects + 4 * z;
  const int rx = __ldg(r), ry = __ldg(r + 1), rw = __ldg(r + 2), rh = __ldg(r + 3);
  float bg[kMaxCh];
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) bg[c] = c < nch ? __ldg(fp + c) : 0.f;
  const bool plane_used = z < __ldg(used);

  if (plane_used) {
    int nw, nh, ox, oy;
    letterbox(rw, rh, dst_w, dst_h, mode, nw, nh, ox, oy);
    for (int i = threadIdx.x; i < tile_w + tile_h; i += kThreads) {
      int i0, i1;
      float w;
      if (i < tile_w) {
        const int q = tx0 + i - ox;
        if (q >= 0 && q < nw) {
          axis_lerp(q, rw, nw, i0, i1, w);
          t.c0[i] = source_index(rx + i0, src_w);
          t.c1[i] = source_index(rx + i1, src_w);
          t.wx[i] = w;
        } else {
          t.c0[i] = -1;
        }
      } else {
        const int j = i - tile_w;
        const int q = ty0 + j - oy;
        if (q >= 0 && q < nh) {
          axis_lerp(q, rh, nh, i0, i1, w);
          t.r0[j] = source_index(ry + i0, src_h);
          t.r1[j] = source_index(ry + i1, src_h);
          t.wy[j] = w;
        } else {
          t.r0[j] = -1;
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;

  float v[kPix][kMaxCh];
#pragma unroll
  for (int p = 0; p < kPix; ++p) {
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) v[p][c] = bg[c];
  }
  const int n = min(kPix, dst_w - x);
  if (plane_used && t.r0[ly] >= 0) {
    const SrcT* plane = src + (long long)z * plane_stride;
    const int row = src_w * nch;  // fits: sides < 2^24; a 64-bit row made ptxas spill
    sample_pixels(t, plane + (long long)t.r0[ly] * row, plane + (long long)t.r1[ly] * row, nch, lx,
                  n, t.wy[ly], v);
  }

  run_chain(v, nch, ops, n_ops, fp);
  if (store_op) run_integer_row(store_op, v);

  store_pixels(out + (long long)z * sn + (long long)y * sy + (long long)x * sx, v, n, out_ch, sc,
               sx);
}


template <typename SrcT, typename OutT>
void launch(const BatchResizeArgs& a) {
  // a tile of about kThreads * kPix outputs, as wide as the output allows
  const int tile_w = std::min(kMaxTileW, (a.dst_w + kPix - 1) / kPix * kPix);
  const int tile_h = std::min(kMaxTileH, std::max(1, kThreads * kPix / tile_w));
  const dim3 grid((a.dst_w + tile_w - 1) / tile_w, (a.dst_h + tile_h - 1) / tile_h, a.n_planes);
  batch_resize_kernel<SrcT, OutT><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const SrcT*>(a.src), a.plane_stride, a.src_h, a.src_w, a.nch, a.rects, a.used,
      a.fp, a.ops, a.n_ops, a.dst_w, a.dst_h, a.mode, tile_w, tile_h, static_cast<OutT*>(a.out),
      a.out_ch, a.store_op, a.sn, a.sc, a.sy, a.sx);
}

// The launch for a source of element type SrcT, by the output's element type.
template <typename SrcT>
void launch_source(const BatchResizeArgs& a) {
  switch (a.out_type) {
    case PW_U8:
    case PW_I8: launch<SrcT, uint8_t>(a); break;
    case PW_U16:
    case PW_I16: launch<SrcT, uint16_t>(a); break;
    case PW_F16: launch<SrcT, f16>(a); break;
    default: launch<SrcT, float>(a); break;
  }
}

}  // namespace k1
}  // namespace
