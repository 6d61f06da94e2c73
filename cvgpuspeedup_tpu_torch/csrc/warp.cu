// Affine and perspective warps, single or batched, with a constant border,
// a fused pointwise chain and a strided write.
//
// Replaces the reference's four TPU warp kernels:
//   cvgpuspeedup_tpu/exec/pallas_warp.py::_emit_warp (separable affine),
//   cvgpuspeedup_tpu/exec/pallas_warp_general.py::_emit (affine with cross
//     terms: rotations, shears),
//   cvgpuspeedup_tpu/exec/pallas_warp_universal.py::_emit (any affine,
//     upscales, flips, perspective),
//   cvgpuspeedup_tpu/exec/pallas_warp_universal.py::_emit_batch (one matrix
//     per image, N images in one launch, ragged used_planes).
// On the TPU the split into three classes, the one-hot MXU gathers, the
// candidate selects, the DMA windows sized by magnitude or derivative
// buckets and their gates (src_h % 8, lanes % 128, |a| >= 2, e > 0, uint8
// sources, den > 0) exist because Mosaic has no dynamic gather. Hopper
// gathers, so one kernel serves all four: a single warp is a batch of one
// plane.
//
// What bounds it: bytes, in principle. Eight 1080p -> 640x360 f32 planar
// warps of one shared RGB u8 frame write 22.1 MB and read the frame's
// sectors under seven rotated footprints once through L2: 7.8 us at an
// H100's copy bandwidth. In practice the kernel is bounded by executed
// instructions: per output pixel two coordinates, four validity tests, four
// taps of nch values, nine lerps and the chain, on 1.8 million pixels. On
// an H100 at 700 W the eight warps take 15.0 us in a torch.profiler trace,
// against 22.9 us for one thread per pixel recomputing everything; one
// 640x360 warp is a launch too small to fill the card and takes 4.4 to
// 5.1 us, bound by the latency of one thread's dependent chain.
//
// What the design does about it:
//  - One block of 128 threads per (plane, tile of 64 outputs across), a
//    thread owning P adjacent pixels of one row (pixels_per_thread: 4 in a
//    launch of at least twice the card's resident threads, 1 in a smaller
//    one, where 4 measured a quarter slower). With P = 4 a warp covers
//    64 x 2 outputs and a block 64 x 8, so a rotated footprint stays a few
//    source rows tall and lives in L1.
//  - `used`, the plane's source address, its 6 or 9 coefficients and its
//    border are read once per thread, not once per pixel, and the
//    row-constant sums c01*Y + c02, c11*Y + c12 (and c21*Y + c22) are
//    hoisted out of the pixel loop. warp.cuh::map_coords computes them as
//    their own rounded step, so this is bit-safe; c00*X and the outer sum
//    stay per pixel (incremental coordinates would round differently).
//  - A thread whose 4 pixels have all four taps inside the source (decided
//    in float, like every validity test) skips the border selects and, on a
//    uint8 source, fetches each row's two taps, 2 * nch contiguous bytes,
//    as three aligned 4-byte words, funnel-shifted to the run's first byte
//    (load_run); 4-byte words need no cross-word select, which 8-byte
//    words would. Against per-byte loads the packed runs measured 10 %
//    faster on the eight warps and 15 % on one rotation. A thread with a
//    tap at the border, or a run whose words would reach outside the
//    source buffer (the first or last word of a buffer at an odd
//    address), takes the per-byte path of sample_point for
//    its pixels. Either way the thread's pixels run as one straight line,
//    so the loads of all 4 are in flight together.
//  - The chain is decoded once per op for the thread's pixels, and each
//    channel of a planar float32 output goes out as one 16-byte store
//    (uint8: 4 bytes) where the address allows.
// Each plane's source comes from a table of addresses, so one frame passed
// N times is read from one buffer and nothing is stacked.
//
// Numerics: every step matches cvgpuspeedup_tpu_torch/ops/warp.py bit for
// bit; the coordinate recomputation and the four-tap constant-border sample
// are csrc/warp.cuh, shared with the divergent kernel. Every float op is an
// _rn intrinsic and the library is built with -fmad=false, never with
// --use_fast_math.

#include "sources.cuh"

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `srcs` holds n_planes device addresses of (src_h, src_w * nch) images of
// elements of type `src_type` (PW_U8 .. PW_F64); `coeffs` 9 floats per
// plane (the inverse map, row-major; an affine map uses the first 6),
// `border` 4 per plane, `dflt` 4 (planes from *used on hold it), `used` one
// int. `out` holds elements of type `out_type` (PW_U8 .. PW_I32) with out_ch
// channels, element strides (sn, sc, sy, sx) per (plane, channel, row, col).
// A store_op other than 0 is the row that converts the chain's values for
// the buffer's dtype (exec/cuda_batch_resize.py::store_cast).
extern "C" int cvgs_warp(const unsigned long long* srcs, int src_type, int src_h, int src_w,
                         int nch, int perspective, const float* coeffs, const float* border,
                         const float* dflt, const int* used, const float* fparams,
                         const int* ops, int n_ops, int n_planes, int dst_w, int dst_h,
                         void* out, int out_type, int out_ch, int store_op, long long sn,
                         long long sc, long long sy, long long sx, void* stream) {
  if (nch < 1 || nch > kMaxCh || out_ch < 1 || out_ch > kMaxCh || n_planes < 1 ||
      n_planes > 65535 || dst_w < 1 || dst_h < 1 || src_h < 1 || src_w < 1 ||
      src_h >= (1 << 24) || src_w >= (1 << 24) || n_ops < 0 || dst_h > 65535 ||
      src_type < PW_U8 || src_type > PW_F64 || out_type < PW_U8 || out_type > PW_I32) {
    return (int)cudaErrorInvalidValue;
  }
  cvgs::WarpArgs a{srcs, src_h, src_w, nch, perspective, coeffs, border, dflt, used, fparams,
                   ops, n_ops, n_planes, dst_w, dst_h, out, out_type, out_ch, store_op,
                   sn, sc, sy, sx, static_cast<cudaStream_t>(stream)};
  switch (src_type) {
    case PW_U8: kw::launch_source<uint8_t>(a); break;
    case PW_F32: kw::launch_source<float>(a); break;
    case PW_I8: cvgs::warp_i8(a); break;
    case PW_U16: cvgs::warp_u16(a); break;
    case PW_I16: cvgs::warp_i16(a); break;
    case PW_F16: cvgs::warp_f16(a); break;
    case PW_I32: cvgs::warp_i32(a); break;
    case PW_I64: cvgs::warp_i64(a); break;
    case PW_F64: cvgs::warp_f64(a); break;
  }
  return (int)cudaGetLastError();
}
