// Full-frame static resize with a fused pointwise chain and a strided write,
// from a packed image or from an NV12/NV21 buffer converted to RGB.
//
// Replaces cvgpuspeedup_tpu/exec/pallas_frame.py::_emit_frame_resize, the
// TPU kernel of the reference's other hot read pattern: one frame resized
// per call (cvGS::resize(src, dsize) feeding a pointwise chain and a planar
// write), including the fused NV12 "ComputeWhatYouSee" read, where Y is
// sampled at full resolution, the UV pairs at half resolution with
// full-resolution tap math, and YUV->RGB runs on destination pixels only
// (the conversion is affine, so it commutes with the resize).
//
// What bounds it: bytes. A 1080p RGB u8 frame -> 640x360 f32 planar (path
// (a)) writes 2.8 MB and reads the source rows its taps touch, 4.1 MB; a 6K
// NV12 buffer -> 1920x1080 f32 planar (path (b)) writes 24.9 MB and reads
// 21.8 of the buffer's 28 MB. In practice the one-thread-per-pixel kernel
// was bound by its instruction count: per output pixel 6 (NV12: 10) words of
// the tap tables, 12 one-byte loads, the chain's decode and 3 scalar
// stores. The TPU kernel's row bands, DMA rings, banded and block-Toeplitz
// MXU matmuls and bf16/Dekker weight splits all exist because Mosaic has no
// gather; Hopper has one, so none of them came over.
//
// What the design does about it:
//  - Blocks of 256 threads, a thread owning P adjacent output pixels of one
//    row (pixels_per_thread: 4 in a launch large enough to fill the card
//    with a thread per 4 pixels, 1 in a smaller one, which is bound by the
//    latency of one thread's dependent chain). 64 x 4 threads cover 256 x 4
//    outputs of a wide frame (group_block narrows the block for a narrow
//    one), so neighbouring threads read neighbouring taps and store
//    neighbouring vectors.
//  - The row's taps and weight (y0, y1, wy; cy0, cy1) are read once per
//    thread, the x taps and weights per pixel, from tables the host builds
//    once per geometry (exec/cuda_frame_resize.py).
//  - The chain is decoded once per op for the thread's pixels, and each
//    channel of a planar output goes out as one 16-byte store (uint8: 4
//    bytes) where the address allows (chain.cuh).
// Measured on an H100 and dropped (profiler medians, 6K NV12 -> 1080p unless
// said): 2 pixels per thread, 24.9 us against 22.1 with 4 and 5.25 against
// 4.96 with 1 on 1080p -> 640x360; a block staging the luma and chroma
// rows of its tile in shared memory before it samples, 26.8 us against
// 22.9 unstaged (the taps of neighbouring threads already share their
// sectors in L1, and that variant spilled 68 bytes); packed tap fetches
// (frame_resize.cuh).
//
// Numerics: every step matches cvgpuspeedup_tpu_torch/ops/resize.py::
// sample_frame and ops/nv12.py bit for bit (the samplers are
// csrc/frame_resize.cuh, shared with the divergent kernel). Every float op
// is an _rn intrinsic and the library is built with -fmad=false.

#include "frame_resize.cuh"

namespace {

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
    OutT* __restrict__ out, int out_ch, int clamp_store, long long sc, long long sy, long long sx) {
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
  if (clamp_store) clamp_to_range<OutT>(v);

  store_any(out + (long long)y * sy + (long long)x * sx, v, n, out_ch, sc, sx);
}

template <typename SrcT, typename OutT, bool kYuv>
void launch(const void* src, int src_h, int src_w, int nch, int nv21, const int* taps,
            const float* wts, int keep_edge, const Conv& conv, const float* fp, const int* ops,
            int n_ops, int dst_w, int dst_h, void* out, int out_ch, int clamp_store, long long sc,
            long long sy, long long sx, cudaStream_t stream) {
  const int pix = pixels_per_thread((long long)dst_w * dst_h, kYuv);
  const dim3 block = group_block(dst_w, pix);
  const int tile_w = block.x * pix;
  const dim3 grid((dst_w + tile_w - 1) / tile_w, (dst_h + block.y - 1) / block.y);
#define CVGS_KERNEL(P)                                                                          \
  frame_resize_kernel<SrcT, OutT, kYuv, P><<<grid, block, 0, stream>>>(                         \
      static_cast<const SrcT*>(src), src_h, src_w, nch, nv21, taps, wts, keep_edge, conv, fp,   \
      ops, n_ops, dst_w, dst_h, static_cast<OutT*>(out), out_ch, clamp_store, sc, sy, sx)
  if (pix == 4) {
    CVGS_KERNEL(4);
  } else {
    CVGS_KERNEL(1);
  }
#undef CVGS_KERNEL
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `src` is an (src_h, src_w * nch) image, uint8 (src_u8 = 1) or float32, or
// with yuv = 1 an NV12 (nv21 = 0) or NV21 uint8 buffer of (src_h * 3/2,
// src_w). `out` holds elements of type `out_type` (PW_U8 .. PW_F32) with
// out_ch channels, element strides (sc, sy, sx) per (channel, row, col).
// With clamp_store, a float32 chain's values are clamped to an integer
// buffer's range, then truncated.
extern "C" int cvgs_frame_resize(const void* src, int src_u8, int src_h, int src_w, int nch,
                                 int yuv, int nv21, const int* taps, const float* wts,
                                 int keep_edge, int limited, int alpha, float ys, float cs,
                                 float rv, float gu, float gv, float bu, const float* fparams,
                                 const int* ops, int n_ops, int dst_w, int dst_h, void* out,
                                 int out_type, int out_ch, int clamp_store, long long sc,
                                 long long sy, long long sx, void* stream) {
  if (nch < 1 || nch > kMaxCh || out_ch < 1 || out_ch > kMaxCh || dst_w < 1 || dst_h < 1 ||
      src_h < 1 || src_w < 1 || n_ops < 0 || (yuv && (!src_u8 || nch != 1)) ||
      out_type < PW_U8 || out_type > PW_F32) {
    return (int)cudaErrorInvalidValue;
  }
  const Conv conv{limited, alpha, ys, cs, rv, gu, gv, bu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CVGS_LAUNCH(SrcT, OutT, YUV)                                                        \
  launch<SrcT, OutT, YUV>(src, src_h, src_w, nch, nv21, taps, wts, keep_edge, conv, fparams, \
                          ops, n_ops, dst_w, dst_h, out, out_ch, clamp_store, sc, sy, sx, s)
#define CVGS_OUT(SrcT, YUV)                              \
  switch (out_type) {                                    \
    case PW_U8: CVGS_LAUNCH(SrcT, uint8_t, YUV); break;  \
    case PW_I8: CVGS_LAUNCH(SrcT, int8_t, YUV); break;   \
    case PW_U16: CVGS_LAUNCH(SrcT, uint16_t, YUV); break; \
    case PW_I16: CVGS_LAUNCH(SrcT, int16_t, YUV); break; \
    default: CVGS_LAUNCH(SrcT, float, YUV); break;       \
  }
  if (yuv) {
    CVGS_OUT(uint8_t, true)
  } else if (src_u8) {
    CVGS_OUT(uint8_t, false)
  } else {
    CVGS_OUT(float, false)
  }
#undef CVGS_OUT
#undef CVGS_LAUNCH
  return (int)cudaGetLastError();
}
