// Every pipeline with no resampling head in one launch: a read that takes
// one source pixel per output pixel, the pointwise chain, a strided write.
//
// Replaces the one jitted XLA program that cvgpuspeedup_tpu/exec/executor.py
// (_compiled) builds for a pipeline no Pallas kernel takes: pointwise chains
// on an image or a stack (the reference's 200-op multiply-add stress), reads
// of a ring from a runtime `first`, crops at runtime origins, the five border
// modes, a bare NV12/NV21 -> RGB(A) conversion, and CircularTensor's update
// of one ring slot. XLA fuses these on the TPU, so the reference has no
// Pallas kernel for them; here one kernel interprets the head (pointwise.cuh)
// and the chain (chain.cuh).
//
// What bounds it: bytes for a short chain (a 1080p frame with a border into
// planar float32 moves 6 MB in and 25 MB out), the launch itself for a small
// output, and for a long chain the float32 operations, none of which may fuse
// into an FMA (-fmad=false): 200 ops on 2048 x 2048 values are 8.4e8 separate
// multiplies and adds.
//
// The design: blocks of 256 threads, a thread owning P adjacent output pixels
// of one row (4 in a large launch, 1 in a small one, chosen as the divergent
// kernel chooses; group_block narrows the block for a narrow output), grid.z
// the plane. The head struct rides the kernel's parameters; runtime values
// (`first`, crop origins, border values, chain scalars) come from one int32
// block, so nothing of them keys a plan. The source's element type is a
// runtime switch every thread takes alike; the output's type and P are
// template parameters, so planar outputs go out as vector stores (chain.cuh).
// run_chain<P, true> also decodes the wide table (int8, uint16, int16).
//
// Numerics: bit for bit the plain version (each op's own apply): every float
// op is an _rn intrinsic (__fmul_rn, __fadd_rn, __fsub_rn and __fdiv_rn in
// chain.cuh), built with -fmad=false, never fast math; the YUV -> RGB sums
// are frame_resize.cuh's yuv_to_rgb, as the full-frame kernel rounds them.

#include "pointwise.cuh"

namespace {

// As the divergent kernel's: 4 pixels per thread where a thread per 4 pixels
// still fills a third of the card's resident threads, else 1.
inline int pixels_per_thread(long long outputs) {
  return 3 * outputs >= 4 * resident_threads() ? 4 : 1;
}

template <typename OutT>
struct Range;
template <>
struct Range<uint8_t> { static constexpr float lo = 0.f, hi = 255.f; };
template <>
struct Range<int8_t> { static constexpr float lo = -128.f, hi = 127.f; };
template <>
struct Range<uint16_t> { static constexpr float lo = 0.f, hi = 65535.f; };
template <>
struct Range<int16_t> { static constexpr float lo = -32768.f, hi = 32767.f; };
template <>
struct Range<float> { static constexpr float lo = 0.f, hi = 0.f; };

template <typename OutT, int P>
__global__ void __launch_bounds__(256) pointwise_kernel(
    const void* __restrict__ src, PwHead h, Conv conv, const int* __restrict__ blk,
    const int* __restrict__ ops, int n_ops, int fp_off, int dst_w, int dst_h,
    OutT* __restrict__ out, int out_ch, int clamp_store, long long sn, long long sc, long long sy,
    long long sx) {
  const int x = (blockIdx.x * blockDim.x + threadIdx.x) * P;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= dst_w || y >= dst_h) return;
  const int n = min(P, dst_w - x);

  float v[P][kMaxCh];
#pragma unroll
  for (int q = 0; q < P; ++q) {
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) v[q][c] = 0.f;
  }
  const int pz = head_plane(h, blk, z);
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (q >= n) continue;
    head_read(h, src, blk, pz, x + q, y, v[q]);
    if (h.conv_first) yuv_to_rgb(v[q][0], v[q][1], v[q][2], conv, v[q]);
  }

  run_chain<P, true>(v, h.nch, ops, n_ops, reinterpret_cast<const float*>(blk) + fp_off);

  // a float32 value stored into an integer buffer of another dtype (a ring
  // slot): clamp to its range, then truncate, as utils/dtypes.py::astype
  if constexpr (sizeof(OutT) < 4) {
    if (clamp_store) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
#pragma unroll
        for (int c = 0; c < kMaxCh; ++c) {
          v[q][c] = fminf(fmaxf(v[q][c], Range<OutT>::lo), Range<OutT>::hi);
        }
      }
    }
  }

  store_any(out + (long long)z * sn + (long long)y * sy + (long long)x * sx, v, n, out_ch, sc, sx);
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `head` points at the 12 + 8 * kMaxStages host words of a PwHead; `blk` is
// the device block of runtime values, the chain scalars at word `fp_off`;
// `out` holds elements of type `out_type` (PW_U8 .. PW_F32) with out_ch
// channels and element strides (sn, sc, sy, sx) per (plane, channel, row,
// col).
extern "C" int cvgs_pointwise(const void* src, const int* head, float ys, float cs, float rv,
                              float gu, float gv, float bu, const int* blk, const int* ops,
                              int n_ops, int fp_off, int n_planes, int dst_w, int dst_h,
                              void* out, int out_type, int out_ch, int clamp_store, long long sn,
                              long long sc, long long sy, long long sx, void* stream) {
  PwHead h;
  const int* w = head;
  h.base = w[0], h.src_h = w[1], h.src_w = w[2], h.nch = w[3], h.src_type = w[4], h.n_src = w[5];
  h.first = w[6], h.asc = w[7], h.nv21 = w[8], h.n_stages = w[9], h.conv_first = w[10];
  h.limited = w[11];
  for (int s = 0; s < kMaxStages; ++s) {
    const int* t = w + 12 + 8 * s;
    h.st[s] = PwStage{t[0], t[1], t[2], t[3], t[4], t[5], t[6], t[7]};
  }
  if (out_ch < 1 || out_ch > kMaxCh || h.nch < 1 || h.nch > kMaxCh || n_planes < 1 ||
      n_planes > 65535 || dst_w < 1 || dst_h < 1 || h.src_h < 1 || h.src_w < 1 || n_ops < 0 ||
      h.n_stages < 0 || h.n_stages > kMaxStages || h.base < PW_IMAGE || h.base > PW_YUV ||
      h.src_type < PW_U8 || h.src_type > PW_F32 || out_type < PW_U8 || out_type > PW_F32 ||
      (h.base == PW_YUV && (h.src_type != PW_U8 || h.nch != 3)) || (h.conv_first && h.nch != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const Conv conv{h.limited, 0, ys, cs, rv, gu, gv, bu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pix = pixels_per_thread((long long)n_planes * dst_w * dst_h);
  const dim3 block = group_block(dst_w, pix);
  const int tile_w = block.x * pix;
  const dim3 grid((dst_w + tile_w - 1) / tile_w, (dst_h + block.y - 1) / block.y, n_planes);
#define CVGS_KERNEL(OutT, P)                                                                   \
  pointwise_kernel<OutT, P><<<grid, block, 0, s>>>(src, h, conv, blk, ops, n_ops, fp_off,      \
                                                   dst_w, dst_h, static_cast<OutT*>(out),      \
                                                   out_ch, clamp_store, sn, sc, sy, sx)
#define CVGS_TYPE(OutT)     \
  if (pix == 4) {           \
    CVGS_KERNEL(OutT, 4);   \
  } else {                  \
    CVGS_KERNEL(OutT, 1);   \
  }                         \
  break;
  switch (out_type) {
    case PW_U8: CVGS_TYPE(uint8_t)
    case PW_I8: CVGS_TYPE(int8_t)
    case PW_U16: CVGS_TYPE(uint16_t)
    case PW_I16: CVGS_TYPE(int16_t)
    default: CVGS_TYPE(float)
  }
#undef CVGS_TYPE
#undef CVGS_KERNEL
  return (int)cudaGetLastError();
}
