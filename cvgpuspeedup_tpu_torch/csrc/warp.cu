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
// What bounds it: memory traffic and launch overhead. A 1080p RGB u8 frame
// warped to 640x360 f32 planar writes 2.8 MB and reads the source sectors
// its taps touch (at most the 6.2 MB frame); eight warps of one shared
// frame read it through L2. The design is deliberately simple: one thread
// per output pixel (all C channels), blocks of 64x4 threads so
// neighbouring threads store neighbouring addresses in every planar
// layout, grid.z = plane, taps read straight from global memory. Each
// plane's source comes from a table of addresses, so one frame passed N
// times is read from one buffer and nothing is stacked. Staging source
// windows in shared memory is left to later work.
//
// Numerics: every step matches cvgpuspeedup_tpu_torch/ops/warp.py bit for
// bit; the coordinate recomputation and the four-tap constant-border sample
// are csrc/warp.cuh, shared with the divergent kernel. Every float op is an
// _rn intrinsic and the library is built with -fmad=false, never with
// --use_fast_math.

#include "warp.cuh"

namespace {

template <typename SrcT, typename OutT, bool kPersp>
__global__ void __launch_bounds__(256) warp_kernel(
    const unsigned long long* __restrict__ srcs, int src_h, int src_w, int nch,
    const float* __restrict__ coeffs, const float* __restrict__ border,
    const float* __restrict__ dflt, const int* __restrict__ used, const float* __restrict__ fp,
    const int* __restrict__ ops, int n_ops, int dst_w, int dst_h, OutT* __restrict__ out,
    int out_ch, long long sn, long long sc, long long sy, long long sx) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= dst_w || y >= dst_h) return;

  float v[kMaxCh] = {0.f, 0.f, 0.f, 0.f};
  if (z < __ldg(used)) {
    const SrcT* src = reinterpret_cast<const SrcT*>(__ldg(srcs + z));
    sample_warp<SrcT, kPersp>(src, src_h, src_w, nch, coeffs + kCoeffs * z,
                              border + kMaxCh * z, x, y, v);
  } else {
#pragma unroll
    for (int ch = 0; ch < kMaxCh; ++ch) {
      if (ch < nch) v[ch] = __ldg(dflt + ch);
    }
  }

  run_chain(v, nch, ops, n_ops, fp);

  OutT* o = out + (long long)z * sn + (long long)y * sy + (long long)x * sx;
#pragma unroll
  for (int ch = 0; ch < kMaxCh; ++ch) {
    if (ch < out_ch) o[ch * sc] = to_out<OutT>(v[ch]);
  }
}

template <typename SrcT, typename OutT, bool kPersp>
void launch(const unsigned long long* srcs, int src_h, int src_w, int nch, const float* coeffs,
            const float* border, const float* dflt, const int* used, const float* fp,
            const int* ops, int n_ops, int n_planes, int dst_w, int dst_h, void* out,
            int out_ch, long long sn, long long sc, long long sy, long long sx,
            cudaStream_t stream) {
  const dim3 block(64, 4);
  const dim3 grid((dst_w + 63) / 64, (dst_h + 3) / 4, n_planes);
  warp_kernel<SrcT, OutT, kPersp><<<grid, block, 0, stream>>>(
      srcs, src_h, src_w, nch, coeffs, border, dflt, used, fp, ops, n_ops, dst_w, dst_h,
      static_cast<OutT*>(out), out_ch, sn, sc, sy, sx);
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `srcs` holds n_planes device addresses of (src_h, src_w * nch) images,
// uint8 (src_u8 = 1) or float32; `coeffs` 9 floats per plane (the inverse
// map, row-major; an affine map uses the first 6), `border` 4 per plane,
// `dflt` 4 (planes from *used on hold it), `used` one int. `out` is uint8
// (out_u8 = 1) or float32 with out_ch channels, element strides
// (sn, sc, sy, sx) per (plane, channel, row, col).
extern "C" int cvgs_warp(const unsigned long long* srcs, int src_u8, int src_h, int src_w,
                         int nch, int perspective, const float* coeffs, const float* border,
                         const float* dflt, const int* used, const float* fparams,
                         const int* ops, int n_ops, int n_planes, int dst_w, int dst_h,
                         void* out, int out_u8, int out_ch, long long sn, long long sc,
                         long long sy, long long sx, void* stream) {
  if (nch < 1 || nch > kMaxCh || out_ch < 1 || out_ch > kMaxCh || n_planes < 1 ||
      n_planes > 65535 || dst_w < 1 || dst_h < 1 || src_h < 1 || src_w < 1 ||
      src_h >= (1 << 24) || src_w >= (1 << 24) || n_ops < 0) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CVGS_LAUNCH(SrcT, OutT, P)                                                             \
  launch<SrcT, OutT, P>(srcs, src_h, src_w, nch, coeffs, border, dflt, used, fparams, ops,     \
                        n_ops, n_planes, dst_w, dst_h, out, out_ch, sn, sc, sy, sx, s)
#define CVGS_LAUNCH_P(SrcT, OutT)     \
  if (perspective) {                  \
    CVGS_LAUNCH(SrcT, OutT, true);    \
  } else {                            \
    CVGS_LAUNCH(SrcT, OutT, false);   \
  }
  if (src_u8 && out_u8) {
    CVGS_LAUNCH_P(uint8_t, uint8_t)
  } else if (src_u8) {
    CVGS_LAUNCH_P(uint8_t, float)
  } else if (out_u8) {
    CVGS_LAUNCH_P(float, uint8_t)
  } else {
    CVGS_LAUNCH_P(float, float)
  }
#undef CVGS_LAUNCH_P
#undef CVGS_LAUNCH
  return (int)cudaGetLastError();
}
