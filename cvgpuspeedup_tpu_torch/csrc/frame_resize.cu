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
// What bounds it: memory traffic. A 1080p RGB u8 frame -> 640x360 f32
// planar writes 2.8 MB and reads the source rows its taps touch; a 6K NV12
// buffer -> 1920x1080 f32 planar writes 24.9 MB and reads up to 28 MB. The
// TPU kernel's row bands, DMA rings, banded and block-Toeplitz MXU
// matmuls and bf16/Dekker weight splits all exist because Mosaic has no
// gather; Hopper has one, so this kernel is deliberately simple: one thread
// per output pixel (all channels), blocks of 64x4 threads so neighbouring
// threads store neighbouring addresses, taps and weights read from tables
// the host builds once per geometry (exec/cuda_frame_resize.py), source
// values read straight from global memory. Staging source rows through
// shared memory (TMA) and vector stores are left to later work.
//
// Numerics: every step matches cvgpuspeedup_tpu_torch/ops/resize.py::
// sample_frame and ops/nv12.py bit for bit (the samplers are
// csrc/frame_resize.cuh, shared with the divergent kernel). Every float op
// is an _rn intrinsic and the library is built with -fmad=false.

#include "frame_resize.cuh"

namespace {

// The tap tables and weights are laid out as csrc/frame_resize.cuh says.
template <typename SrcT, typename OutT, bool kYuv>
__global__ void __launch_bounds__(256) frame_resize_kernel(
    const SrcT* __restrict__ src, int src_h, int src_w, int nch, int nv21,
    const int* __restrict__ taps, const float* __restrict__ wts, int keep_edge, Conv conv,
    const float* __restrict__ fp, const int* __restrict__ ops, int n_ops, int dst_w, int dst_h,
    OutT* __restrict__ out, int out_ch, long long sc, long long sy, long long sx) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= dst_w || y >= dst_h) return;
  const bool keep = keep_edge != 0;
  float v[1][kMaxCh] = {{0.f, 0.f, 0.f, 0.f}};
  int ch;
  if (!kYuv) {
    sample_image(src, src_w, nch, taps, wts, dst_w, dst_h, x, y, keep, v[0]);
    ch = nch;
  } else {
    sample_nv12(reinterpret_cast<const uint8_t*>(src), src_h, src_w, nv21, taps, wts, dst_w,
                dst_h, x, y, keep, conv, v[0]);
    ch = conv.alpha ? 4 : 3;
  }

  run_chain(v, ch, ops, n_ops, fp);

  OutT* o = out + (long long)y * sy + (long long)x * sx;
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) {
    if (c < out_ch) o[c * sc] = to_out<OutT>(v[0][c]);
  }
}

template <typename SrcT, typename OutT, bool kYuv>
void launch(const void* src, int src_h, int src_w, int nch, int nv21, const int* taps,
            const float* wts, int keep_edge, const Conv& conv, const float* fp, const int* ops,
            int n_ops, int dst_w, int dst_h, void* out, int out_ch, long long sc, long long sy,
            long long sx, cudaStream_t stream) {
  const dim3 block(64, 4);
  const dim3 grid((dst_w + 63) / 64, (dst_h + 3) / 4);
  frame_resize_kernel<SrcT, OutT, kYuv><<<grid, block, 0, stream>>>(
      static_cast<const SrcT*>(src), src_h, src_w, nch, nv21, taps, wts, keep_edge, conv, fp,
      ops, n_ops, dst_w, dst_h, static_cast<OutT*>(out), out_ch, sc, sy, sx);
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `src` is an (src_h, src_w * nch) image, uint8 (src_u8 = 1) or float32, or
// with yuv = 1 an NV12 (nv21 = 0) or NV21 uint8 buffer of (src_h * 3/2,
// src_w). `out` is uint8 (out_u8 = 1) or float32 with out_ch channels,
// element strides (sc, sy, sx) per (channel, row, col).
extern "C" int cvgs_frame_resize(const void* src, int src_u8, int src_h, int src_w, int nch,
                                 int yuv, int nv21, const int* taps, const float* wts,
                                 int keep_edge, int limited, int alpha, float ys, float cs,
                                 float rv, float gu, float gv, float bu, const float* fparams,
                                 const int* ops, int n_ops, int dst_w, int dst_h, void* out,
                                 int out_u8, int out_ch, long long sc, long long sy,
                                 long long sx, void* stream) {
  if (nch < 1 || nch > kMaxCh || out_ch < 1 || out_ch > kMaxCh || dst_w < 1 || dst_h < 1 ||
      src_h < 1 || src_w < 1 || n_ops < 0 || (yuv && (!src_u8 || nch != 1))) {
    return (int)cudaErrorInvalidValue;
  }
  const Conv conv{limited, alpha, ys, cs, rv, gu, gv, bu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CVGS_LAUNCH(SrcT, OutT, YUV)                                                        \
  launch<SrcT, OutT, YUV>(src, src_h, src_w, nch, nv21, taps, wts, keep_edge, conv, fparams, \
                          ops, n_ops, dst_w, dst_h, out, out_ch, sc, sy, sx, s)
  if (yuv) {
    if (out_u8) CVGS_LAUNCH(uint8_t, uint8_t, true);
    else CVGS_LAUNCH(uint8_t, float, true);
  } else if (src_u8) {
    if (out_u8) CVGS_LAUNCH(uint8_t, uint8_t, false);
    else CVGS_LAUNCH(uint8_t, float, false);
  } else {
    if (out_u8) CVGS_LAUNCH(float, uint8_t, false);
    else CVGS_LAUNCH(float, float, false);
  }
#undef CVGS_LAUNCH
  return (int)cudaGetLastError();
}
