// Batched crop-resize with a fused pointwise chain and a strided planar write.
//
// Replaces cvgpuspeedup_tpu/exec/pallas_backend.py::_emit_batch_resize, the
// TPU kernel of the flagship pipeline: N crops of one frame (rect mode) or N
// images of a zero-padded stack (stack mode), each resized bilinearly
// (INTER_LINEAR on exact rational coordinates) to one dsize, letterboxed
// under the PRESERVE_AR modes, masked to `background` for planes from
// `used_planes` on, run through the pointwise chain and written in any of
// the port's output layouts. The coordinate rules and the per-pixel sampler
// are csrc/batch_resize.cuh (shared with the divergent kernel), the chain
// interpreter csrc/chain.cuh.
//
// What bounds it: memory traffic and launch overhead, not arithmetic. Per
// flagship batch (50 crops of 60x120 from a 3840x2160 u8 frame -> 64x128,
// f32 planar out) it writes about 4.9 MB of f32 output and reads about
// 1.1 MB of crop pixels; the crops overlap, so L2 should serve most of the
// repeated taps. The design is deliberately simple: one thread per output
// pixel (all C channels), blocks of 64x4 threads so neighbouring threads
// store neighbouring addresses in every planar layout, grid.z = plane, taps
// read straight from global memory. Staging crop windows through shared
// memory with cp.async or TMA is left to later work.
//
// Numerics: every step matches cvgpuspeedup_tpu_torch/ops/resize.py bit for
// bit. A tap left of or above the frame reads from the far edge, one past
// the right or bottom edge reads the edge pixel (source_index). The left
// tap is a floor division (C++ '/' truncates, which gives wrong taps
// whenever num < 0, e.g. the first column of an upscale). All
// float arithmetic is written with __fadd_rn/__fsub_rn/__fmul_rn/__fdiv_rn,
// so nothing is contracted into an FMA; the library is also built with
// -fmad=false and never with --use_fast_math.

#include "batch_resize.cuh"

namespace {

template <typename SrcT, typename OutT>
__global__ void __launch_bounds__(256) batch_resize_kernel(
    const SrcT* __restrict__ src, long long plane_stride, int src_h, int src_w, int nch,
    const int* __restrict__ rects, const int* __restrict__ used, const float* __restrict__ fp,
    const int* __restrict__ ops, int n_ops, int dst_w, int dst_h, int mode,
    OutT* __restrict__ out, int out_ch, long long sn, long long sc, long long sy, long long sx) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= dst_w || y >= dst_h) return;

  float v[kMaxCh];
  bool sampled = false;
  if (z < __ldg(used)) {
    const int* r = rects + 4 * z;
    sampled = sample_crop(src + (long long)z * plane_stride, src_h, src_w, nch, __ldg(r),
                          __ldg(r + 1), __ldg(r + 2), __ldg(r + 3), dst_w, dst_h, mode, x, y, v);
  }
  if (!sampled) {
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) v[c] = c < nch ? __ldg(fp + c) : 0.f;
  }

  run_chain(v, nch, ops, n_ops, fp);

  OutT* o = out + (long long)z * sn + (long long)y * sy + (long long)x * sx;
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) {
    if (c < out_ch) o[c * sc] = to_out<OutT>(v[c]);
  }
}

template <typename SrcT, typename OutT>
void launch(const void* src, long long plane_stride, int src_h, int src_w, int nch,
            const int* rects, const int* used, const float* fp, const int* ops, int n_ops,
            int n_planes, int dst_w, int dst_h, int mode, void* out, int out_ch, long long sn,
            long long sc, long long sy, long long sx, cudaStream_t stream) {
  const dim3 block(64, 4);
  const dim3 grid((dst_w + 63) / 64, (dst_h + 3) / 4, n_planes);
  batch_resize_kernel<SrcT, OutT><<<grid, block, 0, stream>>>(
      static_cast<const SrcT*>(src), plane_stride, src_h, src_w, nch, rects, used, fp, ops,
      n_ops, dst_w, dst_h, mode, static_cast<OutT*>(out), out_ch, sn, sc, sy, sx);
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `src` is uint8 (src_u8 = 1) or float32; `out` is uint8 (out_u8 = 1) or
// float32 with out_ch channels, element strides (sn, sc, sy, sx) per
// (plane, channel, row, col).
extern "C" int cvgs_batch_resize(const void* src, int src_u8, long long plane_stride,
                                 int src_h, int src_w, int nch, const int* rects,
                                 const int* used, const float* fparams, const int* ops,
                                 int n_ops, int n_planes, int dst_w, int dst_h, int mode,
                                 void* out, int out_u8, int out_ch, long long sn, long long sc,
                                 long long sy, long long sx, void* stream) {
  if (nch < 1 || nch > kMaxCh || out_ch < 1 || out_ch > kMaxCh || n_planes < 1 ||
      n_planes > 65535 || dst_w < 1 || dst_h < 1 || src_h < 1 || src_w < 1 || n_ops < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_u8 && out_u8) {
    launch<uint8_t, uint8_t>(src, plane_stride, src_h, src_w, nch, rects, used, fparams, ops,
                             n_ops, n_planes, dst_w, dst_h, mode, out, out_ch, sn, sc, sy, sx, s);
  } else if (src_u8) {
    launch<uint8_t, float>(src, plane_stride, src_h, src_w, nch, rects, used, fparams, ops,
                           n_ops, n_planes, dst_w, dst_h, mode, out, out_ch, sn, sc, sy, sx, s);
  } else if (out_u8) {
    launch<float, uint8_t>(src, plane_stride, src_h, src_w, nch, rects, used, fparams, ops,
                           n_ops, n_planes, dst_w, dst_h, mode, out, out_ch, sn, sc, sy, sx, s);
  } else {
    launch<float, float>(src, plane_stride, src_h, src_w, nch, rects, used, fparams, ops,
                         n_ops, n_planes, dst_w, dst_h, mode, out, out_ch, sn, sc, sy, sx, s);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* cvgs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
