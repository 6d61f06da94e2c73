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
// and the chain (pointwise_chain.cuh).
//
// What bounds it: bytes for a short chain (a 1080p frame with a border into
// planar float32 moves 6 MB in and 25 MB out), the launch itself for a small
// output, and for a long chain the float32 operations, none of which may fuse
// into an FMA (-fmad=false): 200 ops on 2048 x 2048 values are 8.4e8 separate
// multiplies and adds.
//
// The design: blocks of 256 threads, a thread owning P adjacent output pixels
// of one row (group_block narrows the block for a narrow output), grid.z the
// plane. The head struct rides the kernel's parameters; runtime values
// (`first`, crop origins, border values, chain scalars) come from one int32
// block, so nothing of them keys a plan. The block stages the op table once
// into shared memory (pointwise_chain.cuh), so a row costs a thread one or
// two broadcast shared loads and a uniform branch, not a decode from device
// memory. A chain whose widest point is one channel runs in a one-lane
// instance that gives a thread 16 pixels in a large launch on a base with no
// stage (4 in a middle one), so that one row serves that many values; any
// other chain holds 4 lanes and 4 pixels (1 in a small launch). A thread
// reads its group in one run of loads before it converts any (a group read
// pixel by pixel waited for memory once per pixel), as words where they
// follow each other and are aligned (a one-channel run, NV12's two words,
// four whole pixels of 3 or 4 channels); a one-lane group stores its run as
// 16-byte words where aligned, a four-lane group as store_any (one 16-byte
// store per RGBA uint8 group measured 1.6 % on P5 and 4.8 % slower on P3:
// removed). The source's element type is a runtime switch every thread takes
// alike; the output's type, the lanes and P are template parameters.
//
// Numerics: bit for bit the plain version (each op's own apply): every float
// op is an _rn intrinsic (__fmul_rn, __fadd_rn, __fsub_rn and __fdiv_rn in
// pointwise_chain.cuh), built with -fmad=false, never fast math; the YUV ->
// RGB sums are frame_resize.cuh's yuv_to_rgb, as the full-frame kernel
// rounds them.

#include "pointwise.cuh"

namespace {

// pixels per thread of a one-lane chain in a large launch
constexpr int kWideP = 16;

// 4 pixels per thread where a thread per 4 pixels still fills a third of the
// card's resident threads, else 1, as the divergent kernel chooses; a
// one-lane chain (width 1) on a base with no stage takes kWideP from twice
// the outputs that take 4 (720,896 on an H100: P1's chain on 1024 x 1024
// read 25.97 us with 16 pixels against 28.09 with 4, on 768 x 768 24.26
// against 17.84; tools/kernel_variants.json, pw_p16).
inline int pixels_per_thread(long long outputs, int width, int stages) {
  if (width == 1 && stages == 0 && 3 * outputs >= 8 * resident_threads()) return kWideP;
  return 3 * outputs >= 4 * resident_threads() ? 4 : 1;
}

// The values of the thread's n <= P pixels x .. x + n - 1 of row y, plane
// z, before the chain, every lane written (0 where nothing is read): a
// one-channel base with no stage above it as a run (whole words where it
// can), a whole NV12 group as two words; else the stages' walk, the base's
// pixels in one run of loads (read_base_row) and the CONSTANT borders'
// values; then a leading YUV -> RGB.
template <int L, int P>
__device__ __forceinline__ void read_group(const PwHead& h, const void* __restrict__ src,
                                           const int* __restrict__ blk, const Conv& conv, int z,
                                           int x, int y, int n, float (&v)[P][L]) {
  const int pz = head_plane(h, blk, z);
  if constexpr (L == 1) {
    // the host launches a group of more than 4 only for a base with no stage
    if (P > 4 || h.n_stages == 0) {
      load_run_typed(src, h.src_type, ((long long)pz * h.src_h + y) * h.src_w + x, n, v);
      return;
    }
  }
  if constexpr (L == kMaxCh && P == 4) {
    if (n == P && h.n_stages == 0 && h.base == PW_YUV && nv12_words(h, src, x, y, v)) {
      if (h.conv_first) {
#pragma unroll
        for (int q = 0; q < P; ++q) yuv_to_rgb(v[q][0], v[q][1], v[q][2], conv, v[q]);
      }
      return;
    }
  }
  int xs[P], fill[P];
#pragma unroll
  for (int q = 0; q < P; ++q) xs[q] = x + q, fill[q] = -1;
  walk_stages(h, blk, xs, fill, y);
  unsigned mask = 0;
#pragma unroll
  for (int q = 0; q < P; ++q) mask |= (unsigned)(q < n && fill[q] < 0) << q;
  read_base_row(h, src, pz, y, xs, mask, v);
  const float* fblk = reinterpret_cast<const float*>(blk);
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (q >= n || fill[q] < 0) continue;
#pragma unroll
    for (int c = 0; c < L; ++c) {
      if (c < h.nch) v[q][c] = cast_to_type(__ldg(fblk + fill[q] + c), h.src_type);
    }
  }
  if constexpr (L == kMaxCh) {
    if (h.conv_first) {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (q < n) yuv_to_rgb(v[q][0], v[q][1], v[q][2], conv, v[q]);
      }
    }
  }
}

template <typename OutT, int L, int P>
__global__ void __launch_bounds__(256) pointwise_kernel(
    const void* __restrict__ src, PwHead h, Conv conv, const int* __restrict__ blk,
    const int* __restrict__ ops, int n_ops, int fp_off, int dst_w, int dst_h,
    OutT* __restrict__ out, int out_ch, int clamp_store, long long sn, long long sc, long long sy,
    long long sx) {
  __shared__ PwRow rows[kStageRows];
  const int x = (blockIdx.x * blockDim.x + threadIdx.x) * P;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  // every thread stages; one outside the output skips its read, chain and
  // store
  const bool live = x < dst_w && y < dst_h;
  const int n = live ? min(P, dst_w - x) : 0;

  float v[P][L];
  if (live) read_group(h, src, blk, conv, z, x, y, n, v);

  const float* fp = reinterpret_cast<const float*>(blk) + fp_off;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;  // blocks are 256 threads
  for (int k0 = 0; k0 < n_ops; k0 += kStageRows) {
    const int m = min(kStageRows, n_ops - k0);
    if (k0 > 0) __syncthreads();  // every thread is done with the last chunk
    stage_rows(rows, ops, n_ops, k0, m, fp, tid, kStageRows);
    __syncthreads();
    if (live) run_rows(v, rows, m);
  }
  if (!live) return;

  // a float32 value stored into an integer buffer of another dtype (a ring
  // slot): clamp to its range, then truncate, as utils/dtypes.py::astype
  if (clamp_store) clamp_to_range<OutT>(v);

  OutT* o = out + (long long)z * sn + (long long)y * sy + (long long)x * sx;
  if constexpr (L == 1) {
    store_run(o, v, n, sx);
  } else {
    store_any(o, v, n, out_ch, sc, sx);
  }
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `head` points at the kHeadWords host words of a PwHead, the chain's width
// last; `ops` holds the n_ops rows, a sentinel, then each row's channel
// count; `blk` is the device block of runtime values, the chain scalars at
// word `fp_off`;
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
  h.width = w[kHeadWords - 1];
  if (out_ch < 1 || out_ch > h.width || h.nch < 1 || h.nch > h.width || h.width > kMaxCh ||
      n_planes < 1 || n_planes > 65535 || dst_w < 1 || dst_h < 1 || h.src_h < 1 || h.src_w < 1 ||
      n_ops < 0 || h.n_stages < 0 || h.n_stages > kMaxStages || h.base < PW_IMAGE ||
      h.base > PW_YUV || h.src_type < PW_U8 || h.src_type > PW_F32 || out_type < PW_U8 || out_type > PW_F32 ||
      (h.base == PW_YUV && (h.src_type != PW_U8 || h.nch != 3)) || (h.conv_first && h.nch != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const Conv conv{h.limited, 0, ys, cs, rv, gu, gv, bu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pix = pixels_per_thread((long long)n_planes * dst_w * dst_h, h.width, h.n_stages);
  const dim3 block = group_block(dst_w, pix);
  const int tile_w = block.x * pix;
  const dim3 grid((dst_w + tile_w - 1) / tile_w, (dst_h + block.y - 1) / block.y, n_planes);
#define CVGS_KERNEL(OutT, L, P)                                                              \
  pointwise_kernel<OutT, L, P><<<grid, block, 0, s>>>(src, h, conv, blk, ops, n_ops, fp_off, \
                                                      dst_w, dst_h, static_cast<OutT*>(out), \
                                                      out_ch, clamp_store, sn, sc, sy, sx)
  // four instances per output type: one lane x kWideP or 4 pixels, four
  // lanes x 4 or 1
#define CVGS_TYPE(OutT)                   \
  if (pix == kWideP) {                    \
    CVGS_KERNEL(OutT, 1, kWideP);         \
  } else if (pix == 4 && h.width == 1) {  \
    CVGS_KERNEL(OutT, 1, 4);              \
  } else if (pix == 4) {                  \
    CVGS_KERNEL(OutT, kMaxCh, 4);         \
  } else {                                \
    CVGS_KERNEL(OutT, kMaxCh, 1);         \
  }                                       \
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
