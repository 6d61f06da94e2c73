// The warp kernel (warp.cu): the kernel template and its launch for one
// source element type. warp.cu instantiates it for uint8 and float32
// sources and holds the C entry; source_*.cu instantiate it for the other
// element types (sources.cuh).

#pragma once

#include "warp.cuh"

// One launch's arguments, as the C entry takes them; store_op, where not 0,
// is the row that converts the chain's values for the buffer's dtype before
// the store (chain.cuh::run_integer_row).
namespace cvgs {
struct WarpArgs {
  const unsigned long long* srcs;
  int src_h, src_w, nch, perspective;
  const float* coeffs;
  const float* border;
  const float* dflt;
  const int* used;
  const float* fp;
  const int* ops;
  int n_ops, n_planes, dst_w, dst_h;
  void* out;
  int out_type, out_ch;
  int store_op;
  long long sn, sc, sy, sx;
  cudaStream_t stream;
};
}  // namespace cvgs

namespace {
namespace kw {

using cvgs::WarpArgs;

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
      load_run(reinterpret_cast<const uint8_t*>(r0), nch, l0[p], t0[p]);
      load_run(reinterpret_cast<const uint8_t*>(r0 + row), nch, l1[p], t1[p]);
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float wx = __fsub_rn(px[p], floorf(px[p])), wy = __fsub_rn(py[p], floorf(py[p]));
#pragma unroll
      for (int ch = 0; ch < kMaxCh; ++ch) {
        if (ch < nch) {
          v[p][ch] = lerp_rn(lerp_rn(byte_as<SrcT>(l0[p], ch), byte_as<SrcT>(t0[p], ch), wx),
                             lerp_rn(byte_as<SrcT>(l1[p], ch), byte_as<SrcT>(t1[p], ch), wx), wy);
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
          v[p][ch] = lerp_rn(lerp_rn(ldf(r0 + ch), ldf(r0 + nch + ch), wx),
                             lerp_rn(ldf(r1 + ch), ldf(r1 + nch + ch), wx), wy);
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
    int out_ch, int store_op, long long sn, long long sc, long long sy,
    long long sx) {
  constexpr int kGroups = kTileW / P;
  const int x = blockIdx.x * kTileW + (threadIdx.x % kGroups) * P;
  const int y = blockIdx.y * (kThreads / kGroups) + threadIdx.x / kGroups;
  const int z = blockIdx.z;
  if (x >= dst_w || y >= dst_h) return;
  const int n = min(P, dst_w - x);

  // The plane's source and border are read before `used` is known (every
  // plane has them), so the thread's uniform loads are in flight together.
  const SrcT* src = reinterpret_cast<const SrcT*>(__ldg(srcs + z));
  const float* c = coeffs + kCoeffs * z;
  float b[kMaxCh];
#pragma unroll
  for (int ch = 0; ch < kMaxCh; ++ch) b[ch] = ch < nch ? __ldg(border + kMaxCh * z + ch) : 0.f;
  float v[P][kMaxCh];
  if (z < __ldg(used)) {
    // the coordinates as warp.cuh::map_coords computes them: the row's terms
    // once for the thread's pixels
    int xs[P];
    float px[P], py[P];
#pragma unroll
    for (int p = 0; p < P; ++p) xs[p] = x + p;
    map_coords(c, kPersp, xs, y, px, py);
    bool interior = n == P;
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int ch = 0; ch < kMaxCh; ++ch) v[p][ch] = 0.f;
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
  if (store_op) run_integer_row(store_op, v);

  store_pixels(out + (long long)z * sn + (long long)y * sy + (long long)x * sx, v, n, out_ch, sc,
               sx);
}


template <typename SrcT, typename OutT, bool kPersp>
void launch(const WarpArgs& a) {
  const int pix = pixels_per_thread((long long)a.n_planes * a.dst_w * a.dst_h);
  const int tile_h = kThreads * pix / kTileW;
  const dim3 grid((a.dst_w + kTileW - 1) / kTileW, (a.dst_h + tile_h - 1) / tile_h, a.n_planes);
#define CVGS_KERNEL(P)                                                                         \
  warp_kernel<SrcT, OutT, kPersp, P><<<grid, kThreads, 0, a.stream>>>(                         \
      a.srcs, a.src_h, a.src_w, a.nch, a.coeffs, a.border, a.dflt, a.used, a.fp, a.ops, a.n_ops, \
      a.dst_w, a.dst_h, static_cast<OutT*>(a.out), a.out_ch, a.store_op, a.sn, a.sc, \
      a.sy, a.sx)
  if (pix == 4) {
    CVGS_KERNEL(4);
  } else {
    CVGS_KERNEL(1);
  }
#undef CVGS_KERNEL
}

template <typename SrcT, typename OutT>
void launch_map(const WarpArgs& a) {
  if (a.perspective) {
    launch<SrcT, OutT, true>(a);
  } else {
    launch<SrcT, OutT, false>(a);
  }
}

// The launch for a source of element type SrcT, by the output's element type.
template <typename SrcT>
void launch_source(const WarpArgs& a) {
  switch (a.out_type) {
    case PW_U8:
    case PW_I8: launch_map<SrcT, uint8_t>(a); break;
    case PW_U16:
    case PW_I16: launch_map<SrcT, uint16_t>(a); break;
    case PW_F16: launch_map<SrcT, f16>(a); break;
    default: launch_map<SrcT, float>(a); break;
  }
}

}  // namespace kw
}  // namespace
