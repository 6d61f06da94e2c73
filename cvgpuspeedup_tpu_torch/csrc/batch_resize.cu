// Batched crop-resize with a fused pointwise chain and a strided planar write.
//
// Replaces cvgpuspeedup_tpu/exec/pallas_backend.py::_emit_batch_resize, the
// TPU kernel of the flagship pipeline: N crops of one frame (rect mode) or N
// images of a zero-padded stack (stack mode), each resized bilinearly
// (INTER_LINEAR on exact rational coordinates) to one dsize, letterboxed
// under the PRESERVE_AR modes, masked to `background` for planes from
// `used_planes` on, run through the pointwise chain and written in any of
// the port's output layouts. The coordinate rules are csrc/batch_resize.cuh
// (shared with the divergent kernel, which keeps the per-pixel sampler),
// the chain interpreter and the vector store csrc/chain.cuh.
//
// What bounds it: bytes, in principle. A flagship batch (50 crops of 60x120
// from a 3840x2160 u8 frame -> 64x128, f32 planar out) writes 4.9 MB and
// reads the 32-byte sectors under 50 overlapping crops, well under 0.1 MB:
// about 1.7 us at an H100's copy bandwidth. In practice it is bounded by
// executed instructions and their latency: 409,600 output pixels of 12 taps,
// 9 lerps and a 3-op chain each finish in a few microseconds only if
// nothing is computed twice and the one wave of blocks keeps its loads in
// flight. On an H100 at 700 W the flagship takes 7.1 us in a torch.profiler
// trace (11.3 us between CUDA events, which carry the 5 us floor of any
// launch), against 11.6 us for one thread per pixel with everything
// recomputed per thread; what remains is a block's chain of dependent
// steps (rect, tables, barrier, taps, chain, store) on top of the launch
// itself.
//
// What the design does about it:
//  - One block of 128 threads per (plane, tile of tile_w x tile_h outputs);
//    a thread owns 4 adjacent pixels of one row (64 x 8 for the flagship:
//    800 blocks, one wave of the 132 SMs). Measured on the flagship, 2 or 1
//    pixels per thread and 256-thread blocks are all slower.
//  - The block's prologue computes the letterbox once per thread from the
//    rect (uniform loads) and the tile's x taps (source column of both taps
//    and the weight, for tile_w columns) and y taps (tile_h rows) once per
//    block into shared memory, with the per-pixel sampler's own functions
//    (letterbox, axis_lerp, source_index), so every value is bit-identical
//    and the two integer divisions and two float divisions per pixel of the
//    one-thread-per-pixel kernel become two per column or row of a tile.
//  - Every block gathers its taps from global memory through those tables,
//    whether the rect lies inside the frame or wraps and clamps at its
//    edges (source_index). Staging a tile's source window into shared
//    memory with aligned 16- or 4-byte loads first was built and measured:
//    6.90 us (6.86 .. 6.96 over six rounds) against 7.14 (7.00 .. 7.17)
//    without, 3 % for a second gather path with its own hazards at odd
//    addresses, pitches and the buffer's ends, so it was taken out again:
//    a tile's taps are a few hundred bytes that L1 serves either way.
//  - The chain is decoded once per op for the thread's 12 values, and each
//    channel of a planar float32 output goes out as one 16-byte store
//    (uint8: 4 bytes) where the address allows; a letterbox border may cut
//    through a thread's 4 pixels, which then mix background and samples.
//
// Numerics: every step matches cvgpuspeedup_tpu_torch/ops/resize.py bit for
// bit. A tap left of or above the frame reads from the far edge, one past
// the right or bottom edge reads the edge pixel (source_index). The left
// tap is a floor division (C++ '/' truncates, which gives wrong taps
// whenever num < 0, e.g. the first column of an upscale). All
// float arithmetic is written with __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn,
// so nothing is contracted into an FMA; the library is also built with
// -fmad=false and never with --use_fast_math.

#include <algorithm>

#include "batch_resize.cuh"

namespace {

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
    const float a = (float)__ldg(r0 + o0 + c), b = (float)__ldg(r0 + o1 + c);
    const float d = (float)__ldg(r1 + o0 + c), e = (float)__ldg(r1 + o1 + c);
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
    int tile_h, OutT* __restrict__ out, int out_ch, long long sn, long long sc, long long sy,
    long long sx) {
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

  store_pixels(out + (long long)z * sn + (long long)y * sy + (long long)x * sx, v, n, out_ch, sc,
               sx);
}

template <typename SrcT, typename OutT>
void launch(const void* src, long long plane_stride, int src_h, int src_w, int nch,
            const int* rects, const int* used, const float* fp, const int* ops, int n_ops,
            int n_planes, int dst_w, int dst_h, int mode, void* out, int out_ch, long long sn,
            long long sc, long long sy, long long sx, cudaStream_t stream) {
  // a tile of about kThreads * kPix outputs, as wide as the output allows
  const int tile_w = std::min(kMaxTileW, (dst_w + kPix - 1) / kPix * kPix);
  const int tile_h = std::min(kMaxTileH, std::max(1, kThreads * kPix / tile_w));
  const dim3 grid((dst_w + tile_w - 1) / tile_w, (dst_h + tile_h - 1) / tile_h, n_planes);
  batch_resize_kernel<SrcT, OutT><<<grid, kThreads, 0, stream>>>(
      static_cast<const SrcT*>(src), plane_stride, src_h, src_w, nch, rects, used, fp, ops, n_ops,
      dst_w, dst_h, mode, tile_w, tile_h, static_cast<OutT*>(out), out_ch, sn, sc, sy, sx);
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `src` is uint8 (src_u8 = 1) or float32; `out` is uint8 (out_u8 = 1) or
// float32 with out_ch channels, element strides (sn, sc, sy, sx) per (plane, channel, row, col).
extern "C" int cvgs_batch_resize(const void* src, int src_u8, long long plane_stride,
                                 int src_h, int src_w, int nch, const int* rects,
                                 const int* used, const float* fparams, const int* ops,
                                 int n_ops, int n_planes, int dst_w, int dst_h, int mode,
                                 void* out, int out_u8, int out_ch, long long sn, long long sc,
                                 long long sy, long long sx, void* stream) {
  if (nch < 1 || nch > kMaxCh || out_ch < 1 || out_ch > kMaxCh || n_planes < 1 ||
      n_planes > 65535 || dst_w < 1 || dst_h < 1 || dst_h > 65535 || src_h < 1 || src_w < 1 ||
      src_h >= (1 << 24) || src_w >= (1 << 24) || n_ops < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CVGS_LAUNCH(SrcT, OutT)                                                              \
  launch<SrcT, OutT>(src, plane_stride, src_h, src_w, nch, rects, used, fparams, ops, n_ops, \
                     n_planes, dst_w, dst_h, mode, out, out_ch, sn, sc, sy, sx, s)
  if (src_u8 && out_u8) {
    CVGS_LAUNCH(uint8_t, uint8_t);
  } else if (src_u8) {
    CVGS_LAUNCH(uint8_t, float);
  } else if (out_u8) {
    CVGS_LAUNCH(float, uint8_t);
  } else {
    CVGS_LAUNCH(float, float);
  }
#undef CVGS_LAUNCH
  return (int)cudaGetLastError();
}

extern "C" const char* cvgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
