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

#include "sources.cuh"

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `src` is an (src_h, src_w * nch) image of elements of type `src_type`
// (PW_U8 .. PW_F64), or with yuv = 1 an NV12 (nv21 = 0) or NV21 uint8 buffer
// of (src_h * 3/2, src_w). `out` holds elements of type `out_type` (PW_U8 ..
// PW_I32) with out_ch channels, element strides (sc, sy, sx) per (channel,
// row, col). A store_op other than 0 is the row that converts the chain's
// values for the buffer's dtype (exec/cuda_batch_resize.py::store_cast).
extern "C" int cvgs_frame_resize(const void* src, int src_type, int src_h, int src_w, int nch,
                                 int yuv, int nv21, const int* taps, const float* wts,
                                 int keep_edge, int limited, int alpha, float ys, float cs,
                                 float rv, float gu, float gv, float bu, const float* fparams,
                                 const int* ops, int n_ops, int dst_w, int dst_h, void* out,
                                 int out_type, int out_ch, int store_op, long long sc,
                                 long long sy, long long sx, void* stream) {
  if (nch < 1 || nch > kMaxCh || out_ch < 1 || out_ch > kMaxCh || dst_w < 1 || dst_h < 1 ||
      src_h < 1 || src_w < 1 || n_ops < 0 || src_type < PW_U8 || src_type > PW_F64 ||
      (yuv && (src_type != PW_U8 || nch != 1)) || out_type < PW_U8 || out_type > PW_I32) {
    return (int)cudaErrorInvalidValue;
  }
  cvgs::FrameResizeArgs a{src, src_h, src_w, nch, nv21, taps, wts, keep_edge,
                          Conv{limited, alpha, ys, cs, rv, gu, gv, bu},
                          fparams, ops, n_ops, dst_w, dst_h, out, out_type, out_ch, store_op,
                          sc, sy, sx, static_cast<cudaStream_t>(stream)};
  if (yuv) {
    k2::launch_source<uint8_t, true>(a);
    return (int)cudaGetLastError();
  }
  switch (src_type) {
    case PW_U8: k2::launch_source<uint8_t>(a); break;
    case PW_F32: k2::launch_source<float>(a); break;
    case PW_I8: cvgs::frame_resize_i8(a); break;
    case PW_U16: cvgs::frame_resize_u16(a); break;
    case PW_I16: cvgs::frame_resize_i16(a); break;
    case PW_F16: cvgs::frame_resize_f16(a); break;
    case PW_I32: cvgs::frame_resize_i32(a); break;
    case PW_I64: cvgs::frame_resize_i64(a); break;
    case PW_F64: cvgs::frame_resize_f64(a); break;
  }
  return (int)cudaGetLastError();
}
