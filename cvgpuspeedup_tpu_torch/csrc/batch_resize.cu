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

#include "sources.cuh"

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `src` holds elements of type `src_type` (PW_U8 .. PW_F64); `out` holds
// elements of type `out_type` (PW_U8 .. PW_I32) with out_ch channels,
// element strides (sn, sc, sy, sx) per (plane, channel, row, col). A
// store_op other than 0 is the row that converts the chain's values for the
// buffer's dtype (exec/cuda_batch_resize.py::store_cast).
extern "C" int cvgs_batch_resize(const void* src, int src_type, long long plane_stride,
                                 int src_h, int src_w, int nch, const int* rects,
                                 const int* used, const float* fparams, const int* ops,
                                 int n_ops, int n_planes, int dst_w, int dst_h, int mode,
                                 void* out, int out_type, int out_ch, int store_op,
                                 long long sn, long long sc, long long sy, long long sx,
                                 void* stream) {
  if (nch < 1 || nch > kMaxCh || out_ch < 1 || out_ch > kMaxCh || n_planes < 1 ||
      n_planes > 65535 || dst_w < 1 || dst_h < 1 || dst_h > 65535 || src_h < 1 || src_w < 1 ||
      src_h >= (1 << 24) || src_w >= (1 << 24) || n_ops < 0 || out_type < PW_U8 ||
      out_type > PW_I32 || src_type < PW_U8 || src_type > PW_F64) {
    return (int)cudaErrorInvalidValue;
  }
  cvgs::BatchResizeArgs a{src, plane_stride, src_h, src_w, nch, rects, used, fparams,
                          ops, n_ops, n_planes, dst_w, dst_h, mode, out, out_type,
                          out_ch, store_op, sn, sc, sy, sx, static_cast<cudaStream_t>(stream)};
  switch (src_type) {
    case PW_U8: k1::launch_source<uint8_t>(a); break;
    case PW_F32: k1::launch_source<float>(a); break;
    case PW_I8: cvgs::batch_resize_i8(a); break;
    case PW_U16: cvgs::batch_resize_u16(a); break;
    case PW_I16: cvgs::batch_resize_i16(a); break;
    case PW_F16: cvgs::batch_resize_f16(a); break;
    case PW_I32: cvgs::batch_resize_i32(a); break;
    case PW_I64: cvgs::batch_resize_i64(a); break;
    case PW_F64: cvgs::batch_resize_f64(a); break;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cvgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
