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
//    hoisted out of the pixel loop. affine_term computes them as their own
//    rounded step, so this is bit-safe; c00*X and the outer sum stay per
//    pixel (incremental coordinates would round differently).
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

#include "warp.cuh"

namespace {

constexpr int kTileW = 64;    // outputs of a block along x: 64 / P threads of P pixels each
constexpr int kThreads = 128;  // a block covers kThreads * P / kTileW output rows

// The adjacent output pixels a thread takes, from the launch's output
// count: 4 where a thread per 4 pixels still fills half of the card's
// resident threads, else 1. A small launch is bound by the latency of one
// thread's dependent chain, which more pixels per thread only lengthen; a
// large one by executed instructions, which 4 pixels per thread amortize.
// Measured on an H100 (540,672 outputs are twice its resident threads), 1
// against 4 pixels by torch.profiler: one 640x360 warp (230,400 outputs)
// 4.4 against 5.6 us, two in a batch (460,800) 7.0 against 6.8, three
// (691,200) 9.5 against 8.8, eight 21.6 against 15.0. 2 pixels per thread
// won at no size.
inline int pixels_per_thread(long long outputs) {
  return outputs >= 2 * resident_threads() ? 4 : 1;
}

// The 2 * nch bytes at p (two adjacent taps of a uint8 row): `left` holds
// the first tap's channels in its low bytes, `right` the second's. Reads
// the three aligned 4-byte words from p & ~3, which cover any run of up to
// 8 bytes; the caller has checked that all three lie inside the source
// buffer. Loading the third word only where the run reaches it measured
// slower and made ptxas spill.
__device__ __forceinline__ void load_run(const uint8_t* __restrict__ p, int nch, unsigned& left,
                                         unsigned& right) {
  const unsigned k = (unsigned)(reinterpret_cast<unsigned long long>(p) & 3ull);
  const unsigned* a = reinterpret_cast<const unsigned*>(p - k);
  const unsigned w0 = __ldg(a), w1 = __ldg(a + 1), w2 = __ldg(a + 2);
  const unsigned lo = __funnelshift_r(w0, w1, 8u * k);
  const unsigned hi = __funnelshift_r(w1, w2, 8u * k);
  left = lo;
  right = __funnelshift_rc(lo, hi, 8u * (unsigned)nch);
}

// Whether the four taps around (px, py) all lie inside the source and, for
// a uint8 source, the words of both rows' runs lie inside its buffer.
template <typename SrcT>
__device__ __forceinline__ bool is_interior(const SrcT* __restrict__ src, int src_h, int src_w,
                                            int nch, float px, float py) {
  const float x0f = floorf(px), y0f = floorf(py);
  const float fw = (float)src_w, fh = (float)src_h;  // exact: sides < 2^24
  if (!(x0f >= 0.f && x0f < fw - 1.f && y0f >= 0.f && y0f < fh - 1.f)) return false;
  if constexpr (sizeof(SrcT) == 1) {
    const long long row = (long long)src_w * nch;
    const unsigned long long lo = reinterpret_cast<unsigned long long>(src);
    const unsigned long long a0 = lo + ((long long)y0f * src_w + (int)x0f) * nch;
    const unsigned long long hi = lo + (unsigned long long)src_h * row;
    return (a0 & ~3ull) >= lo && ((a0 + row) & ~3ull) + 12ull <= hi;
  }
  return true;
}

// The thread's P pixels, all interior (is_interior): no border selects;
// the loads of all pixels come first, so they are in flight together.
template <typename SrcT, int P>
__device__ __forceinline__ void sample_interior(const SrcT* __restrict__ src, int src_w, int nch,
                                                const float (&px)[P], const float (&py)[P],
                                                float (&v)[P][kMaxCh]) {
  const long long row = (long long)src_w * nch;
  if constexpr (sizeof(SrcT) == 1) {
    unsigned l0[P], t0[P], l1[P], t1[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const SrcT* r0 = src + ((long long)floorf(py[p]) * src_w + (int)floorf(px[p])) * nch;
      load_run(r0, nch, l0[p], t0[p]);
      load_run(r0 + row, nch, l1[p], t1[p]);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float wx = __fsub_rn(px[p], floorf(px[p])), wy = __fsub_rn(py[p], floorf(py[p]));
#pragma unroll
      for (int ch = 0; ch < kMaxCh; ++ch) {
        if (ch < nch) {
          v[p][ch] = lerp_rn(lerp_rn(byte_of(l0[p], ch), byte_of(t0[p], ch), wx),
                             lerp_rn(byte_of(l1[p], ch), byte_of(t1[p], ch), wx), wy);
        }
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const SrcT* r0 = src + ((long long)floorf(py[p]) * src_w + (int)floorf(px[p])) * nch;
      const SrcT* r1 = r0 + row;
      const float wx = __fsub_rn(px[p], floorf(px[p])), wy = __fsub_rn(py[p], floorf(py[p]));
#pragma unroll
      for (int ch = 0; ch < kMaxCh; ++ch) {
        if (ch < nch) {
          v[p][ch] = lerp_rn(lerp_rn((float)__ldg(r0 + ch), (float)__ldg(r0 + nch + ch), wx),
                             lerp_rn((float)__ldg(r1 + ch), (float)__ldg(r1 + nch + ch), wx), wy);
        }
      }
    }
  }
}

template <typename SrcT, typename OutT, bool kPersp, int P>
__global__ void __launch_bounds__(kThreads) warp_kernel(
    const unsigned long long* __restrict__ srcs, int src_h, int src_w, int nch,
    const float* __restrict__ coeffs, const float* __restrict__ border,
    const float* __restrict__ dflt, const int* __restrict__ used, const float* __restrict__ fp,
    const int* __restrict__ ops, int n_ops, int dst_w, int dst_h, OutT* __restrict__ out,
    int out_ch, long long sn, long long sc, long long sy, long long sx) {
  constexpr int kGroups = kTileW / P;
  const int x = blockIdx.x * kTileW + (threadIdx.x % kGroups) * P;
  const int y = blockIdx.y * (kThreads / kGroups) + threadIdx.x / kGroups;
  const int z = blockIdx.z;
  if (x >= dst_w || y >= dst_h) return;
  const int n = min(P, dst_w - x);

  // The plane's parameters are read before `used` is known (every plane has
  // them), so all of the thread's uniform loads are in flight together.
  const SrcT* src = reinterpret_cast<const SrcT*>(__ldg(srcs + z));
  const float* c = coeffs + kCoeffs * z;
  float b[kMaxCh];
#pragma unroll
  for (int ch = 0; ch < kMaxCh; ++ch) b[ch] = ch < nch ? __ldg(border + kMaxCh * z + ch) : 0.f;
  // a*X + (b*Y + c) per coordinate, as affine_term: the inner sum is the
  // row's, each op rounded once
  const float fy = (float)y;
  const float c00 = __ldg(c), c10 = __ldg(c + 3);
  const float row_x = __fadd_rn(__fmul_rn(__ldg(c + 1), fy), __ldg(c + 2));
  const float row_y = __fadd_rn(__fmul_rn(__ldg(c + 4), fy), __ldg(c + 5));
  const float c20 = kPersp ? __ldg(c + 6) : 0.f;
  const float row_w = kPersp ? __fadd_rn(__fmul_rn(__ldg(c + 7), fy), __ldg(c + 8)) : 0.f;

  float v[P][kMaxCh];
  if (z < __ldg(used)) {
    float px[P], py[P];
    bool interior = n == P;
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int ch = 0; ch < kMaxCh; ++ch) v[p][ch] = 0.f;
      const float fx = (float)(x + p);
      px[p] = __fadd_rn(__fmul_rn(c00, fx), row_x);
      py[p] = __fadd_rn(__fmul_rn(c10, fx), row_y);
      if (kPersp) {
        float den = __fadd_rn(__fmul_rn(c20, fx), row_w);
        if (den == 0.f) den = 1.f;
        px[p] = __fdiv_rn(px[p], den);
        py[p] = __fdiv_rn(py[p], den);
      }
      interior = interior && is_interior(src, src_h, src_w, nch, px[p], py[p]);
    }
    // One branch per thread: its pixels run as one straight line either way.
    if (interior) {
      sample_interior(src, src_w, nch, px, py, v);
    } else {
#pragma unroll
      for (int p = 0; p < P; ++p) {
        if (p < n) sample_point(src, src_h, src_w, nch, b, px[p], py[p], v[p]);
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int ch = 0; ch < kMaxCh; ++ch) v[p][ch] = ch < nch ? __ldg(dflt + ch) : 0.f;
    }
  }

  run_chain(v, nch, ops, n_ops, fp);

  store_pixels(out + (long long)z * sn + (long long)y * sy + (long long)x * sx, v, n, out_ch, sc,
               sx);
}

template <typename SrcT, typename OutT, bool kPersp>
void launch(const unsigned long long* srcs, int src_h, int src_w, int nch, const float* coeffs,
            const float* border, const float* dflt, const int* used, const float* fp,
            const int* ops, int n_ops, int n_planes, int dst_w, int dst_h, void* out,
            int out_ch, long long sn, long long sc, long long sy, long long sx,
            cudaStream_t stream) {
  const int pix = pixels_per_thread((long long)n_planes * dst_w * dst_h);
  const int tile_h = kThreads * pix / kTileW;
  const dim3 grid((dst_w + kTileW - 1) / kTileW, (dst_h + tile_h - 1) / tile_h, n_planes);
#define CVGS_KERNEL(P)                                                                       \
  warp_kernel<SrcT, OutT, kPersp, P><<<grid, kThreads, 0, stream>>>(                         \
      srcs, src_h, src_w, nch, coeffs, border, dflt, used, fp, ops, n_ops, dst_w, dst_h,     \
      static_cast<OutT*>(out), out_ch, sn, sc, sy, sx)
  if (pix == 4) {
    CVGS_KERNEL(4);
  } else {
    CVGS_KERNEL(1);
  }
#undef CVGS_KERNEL
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
      src_h >= (1 << 24) || src_w >= (1 << 24) || n_ops < 0 ||
      dst_h > 65535) {
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
