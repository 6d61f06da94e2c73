// The composed-read kernel (composed.cu): its head, the kernel template and
// its launch for one kind of source. composed.cu instantiates it for uint8
// images and holds the C entry; composed_f32.cu for float32 and int32
// images, composed_nv12.cu for NV12/NV21 buffers and composed_any.cu for
// the other source types, which share their instances (exec/_build.py
// compiles every .cu file in a process of its own).
//
// A launch reads, from the output inwards: the outer stages (crops and
// borders above the core), the core (a resize over host tap tables, a warp
// whose coordinates are recomputed from the block's coefficients, or one
// pixel), the upper stages (between the core and a fused read), the lower
// stages (between the fused read and the base) and the base (one frame or
// an NV12/NV21 buffer). Each stage list rides a PwHead; the lower list's
// PwHead also describes the base and carries the fused read's leading
// YUV -> RGB (conv_first, limited).
//
// A batch (a BatchRead of N planes of one read-tree structure) is one
// launch, grid.z = plane: the head holds plane 0's words, and plane z's
// runtime values (crop origins, border values, warp coefficients and
// border, the fused chain's scalars) lie z * plane_stride block words past
// plane 0's, where the head's offsets point; its base's address is 8-byte
// block word z (batch). A plane at or past the block's used_planes
// (used_off) reads nothing and holds the default (default_off) cast to the
// core's type, then runs the pipeline's chain.
//
// Planes of one shape may differ in geometry: the base's size, the crops'
// and borders' sizes, a resample's output size and so its source's (cameras
// of mixed resolution, ROIs of their own sizes, letterboxes of their own
// aspect). Such a batch (batch == CM_MIXED) launches instances of its own
// (composed_kernel_mixed): each plane's whole head lies in the consts,
// kCmWords words a plane from word 0, with its own tap tables; a block
// copies its plane's head into shared memory once and runs the same body
// over it. A batch of one geometry keeps its head by value, so it pays
// nothing for this.
//
// A divergent batch (batch == CM_DIVERGENT, exec/cuda_composed.py::
// build_divergent_plan) runs a group of planes per sequence: each plane's
// head is its group's for that plane, in the consts as a mixed batch's,
// with absolute block offsets (plane_stride 0) and its group's op and tap
// tables; each plane's store row (the cast of its group's values into the
// batch's dtype) follows the heads. Groups of one kind of source and one
// store row launch that kind's mixed instances with the row as the launch's
// (the C entry checks); any other batch of images launches the general
// instances (composed_divergent.cu): AnyImage's switch on the plane's source
// type lies around all of a thread's loads, uniform over a block, and the
// block reads its plane's store row.
//
// Every rule matches exec/cuda_composed.py::composed_reference and the
// eager lowering bit for bit:
//   a tap's position walks the upper stages, then the lower ones; a lower
//   CONSTANT border gives its value cast to the source's type, which then
//   goes through the fused read's chain; an upper one gives its value cast
//   to the chain's type (tap_type), without the chain;
//   an outer CONSTANT border gives its value cast to the core's type
//   (core_type: float32 after a resample, else tap_type).
//
// A crop adds an origin on each axis and a border folds each axis on its
// own, so a tap's walk is two walks, one per axis (walk_axis): a thread
// walks its pixels' x taps and its row's y taps once each, not every tap
// in 2-D. What pointwise.cuh::walk_stages calls a tap's fill (the first
// CONSTANT border it lies outside of) is the outermost of the first such
// stage of its column and of its row.

#pragma once

#include <cstring>

#include "chain.cuh"
#include "frame_resize.cuh"
#include "pointwise.cuh"
#include "pointwise_chain.cuh"
#include "warp.cuh"
#include "warp_kernel.cuh"

namespace {

// keep every code in step with exec/cuda_composed.py
enum : int { CM_NONE = 0, CM_RESIZE = 1, CM_WARP = 2 };  // cores
enum : int { CM_ONE = 0, CM_BATCH = 1, CM_MIXED = 2, CM_DIVERGENT = 3 };  // the batch word

// The head of one launch; the host fills it from the plan
// (exec/cuda_composed.py::ComposedPlan.head).
struct CmHead {
  PwHead lower;  // the base, the stages below the fused read, its YUV -> RGB
  PwHead upper;  // n_stages and st only: the stages between the core and the fused read
  PwHead outer;  // n_stages and st only: the stages above the core
  int core;
  int core_h, core_w;  // the core's output
  int in_h, in_w;      // the core's source: the inner virtual image
  int keep_edge;       // resize: the edge rule of ops/resize.py::keeps_edge_weight
  int persp;           // warp: a 3x3 map
  int coef_off;        // warp: block offset of its 9 coefficients
  int border_off;      // warp: block offset of its border (tap_ch floats)
  int taps_off;        // resize: consts offset of x0 | x1 | y0 | y1 | wx | wy
  int tap_type;        // a tap's type after the fused read's chain (PW_U8 .. PW_I32)
  int core_type;       // the core's output type
  int tap_ch;          // a tap's channels after the fused read's chain
  int batch;           // a BatchRead (CM_BATCH, CM_MIXED, CM_DIVERGENT): plane z's source
                       // address at 8-byte block word z; CM_MIXED, CM_DIVERGENT: plane
                       // z's head at consts word z * kCmWords
  int in_n_ops, in_ops_off, in_fp_off;    // the fused read's chain: rows, table, scalars
  int out_n_ops, out_ops_off, out_fp_off;  // the pipeline's chain
  int plane_stride;             // plane z's values z * plane_stride words past plane 0's
  int used_off, default_off;    // used_planes (int) and the default (tap_ch floats); -1: none
};
constexpr int kCmWords = 3 * kHeadWords + 23;
static_assert(sizeof(CmHead) == kCmWords * 4, "all int32 words");

}  // namespace

// One launch's arguments, as the C entry takes them; `head` points at the
// kCmWords host words of a CmHead, `pix` is the adjacent output pixels a
// thread takes (pixels_per_thread).
namespace cvgs {
struct ComposedArgs {
  const void* src;
  const int* head;
  Conv conv;
  const int* blk;
  const int* consts;
  int n_planes, dst_w, dst_h;
  void* out;
  int out_type, out_ch, store_op;
  long long sn, sc, sy, sx;
  int pix;
  cudaStream_t stream;
};
void composed_f32(const ComposedArgs& a);
void composed_nv12(const ComposedArgs& a);
void composed_any(const ComposedArgs& a);
void composed_divergent(const ComposedArgs& a);
}  // namespace cvgs

namespace {
namespace kc {

using cvgs::ComposedArgs;

// The sources beside an element type: an NV12/NV21 buffer (a tap reads its
// luma byte and its chroma pair) and the types that share one instance
// (int8, uint16, int16, float16, int64, float64), loaded by the head's
// src_type through one switch around all of a thread's loads.
struct Nv12 {};
struct AnyType {};
// Every image source type (AnyType's and uint8, float32, int32): a divergent
// batch's general instances, whose groups read different types.
struct AnyImage {};

// A thread's N taps as loaded, until each pixel converts its own: the
// elements of an element type; a uint8 image's or an NV12 buffer's bytes
// packed four lanes to a 32-bit word (an NV12 tap's luma, U and V), one
// register a tap, not four; AnyType's values float32 already (each case
// converts where it loads). lane(i, c) is lane c of tap i as float32.
template <typename Src, int N>
struct TapRegs {
  Src e[N][kMaxCh];
  __device__ __forceinline__ float lane(int i, int c) const { return to_f32(e[i][c]); }
};
template <int N>
struct PackedTaps {
  unsigned w[N];
  __device__ __forceinline__ float lane(int i, int c) const { return byte_of(w[i], c); }
};
template <int N>
struct TapRegs<uint8_t, N> : PackedTaps<N> {};
template <int N>
struct TapRegs<Nv12, N> : PackedTaps<N> {};
template <int N>
struct TapRegs<AnyType, N> {
  float e[N][kMaxCh];
  __device__ __forceinline__ float lane(int i, int c) const { return e[i][c]; }
};
template <int N>
struct TapRegs<AnyImage, N> : TapRegs<AnyType, N> {};

constexpr int kThreads = 256;          // threads per block
constexpr int kNone = 2 * kMaxStages;  // no CONSTANT border: the tap reads the base

// The adjacent output pixels a thread of a 1-tap read takes, from the
// launch's output count: 4 where a thread per 4 pixels still fills half of
// the card's resident threads, else 1, as the warp kernel chooses them
// (warp_kernel.cuh::pixels_per_thread). A resample (4 taps) takes 1 at
// every size: on an H100 its 4-pixel instance measured 1.6 to 1.9 times the
// 1-pixel one's time at 0.2 to 0.4 million outputs, C4 (2 million) at 134
// against 80 us with a thread's pixels adjacent and at 78 against 80 with
// them a warp width apart, whose 80 registers left fewer threads resident.
// The host's mirror is exec/cuda_composed.py::pixels_per_thread.
inline int pixels_per_thread(long long outputs, int taps) {
  return taps == 1 && outputs >= 2 * resident_threads() ? 4 : 1;
}

// The N positions of one axis (x where kX, else y) walked through the
// stages of h, outermost first: a crop adds its origin on this axis, a
// border folds it. first[i] takes base + s for the first CONSTANT stage s
// that position i lies outside of on this axis, where it has none yet
// (kNone).
template <bool kX, int N>
__device__ __forceinline__ void walk_axis(const PwHead& h, const int* __restrict__ blk, int base,
                                          int (&pos)[N], int (&first)[N]) {
#pragma unroll
  for (int s = 0; s < kMaxStages; ++s) {
    if (s >= h.n_stages) break;
    const PwStage& st = h.st[s];
    if (st.kind == PW_CROP) {
      const int o = kX ? crop_start(__ldg(blk + st.a), st.src_w, st.c)
                       : crop_start(__ldg(blk + st.b), st.src_h, st.d);
#pragma unroll
      for (int i = 0; i < N; ++i) pos[i] += o;
    } else {
      const int n = kX ? st.src_w : st.src_h;
      const int lead = kX ? st.b : st.a;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int j = pos[i] - lead;
        if (st.mode == PW_CONSTANT && first[i] == kNone && (j < 0 || j >= n)) first[i] = base + s;
        pos[i] = fold_index(j, n, st.mode);
      }
    }
  }
}

// Both axes' walks of a thread: through the upper stages (fills 0 ..
// kMaxStages - 1), then the lower ones (kMaxStages ..).
template <int NX, int NY>
__device__ __forceinline__ void walk_taps(const CmHead& h, const int* __restrict__ blk,
                                          int (&xs)[NX], int (&fx)[NX], int (&ys)[NY],
                                          int (&fy)[NY]) {
#pragma unroll
  for (int i = 0; i < NX; ++i) fx[i] = kNone;
#pragma unroll
  for (int i = 0; i < NY; ++i) fy[i] = kNone;
  walk_axis<true>(h.upper, blk, 0, xs, fx);
  walk_axis<false>(h.upper, blk, 0, ys, fy);
  walk_axis<true>(h.lower, blk, kMaxStages, xs, fx);
  walk_axis<false>(h.lower, blk, kMaxStages, ys, fy);
}

// The block offset of the value of fill stage s: an upper border's for s
// below kMaxStages, else a lower one's (s < kNone).
__device__ __forceinline__ int fill_offset(const CmHead& h, int s) {
  int off = 0;
#pragma unroll
  for (int k = 0; k < kMaxStages; ++k) {
    if (s == k) off = h.upper.st[k].c;
    if (s == kMaxStages + k) off = h.lower.st[k].c;
  }
  return off;
}

// The N taps at base positions (ty[i], tx[i]) of an image of element type
// SrcT with nch channels, for each i whose bit of rd is set: every load of
// the thread in one straight run, nothing converted. A tap not read holds
// 0 in every lane.
template <typename SrcT, int N>
__device__ __forceinline__ void load_image(const SrcT* __restrict__ src, int src_w, int nch,
                                           const int (&ty)[N], const int (&tx)[N], unsigned rd,
                                           SrcT (&raw)[N][kMaxCh]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const SrcT* p = src + ((long long)ty[i] * src_w + tx[i]) * nch;
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) {
      raw[i][c] = SrcT{};
      if ((rd >> i & 1u) && c < nch) raw[i][c] = ld_elem(p + c);
    }
  }
}

// The thread's loads for its kind of source, into regs (TapRegs): an
// element type's elements; a uint8 image's bytes or an NV12/NV21 buffer's
// luma byte and chroma pair (U, V), packed; for AnyType, one case per
// source type, each loading all taps, then converting them. A tap whose
// bit of rd is clear reads nothing and holds 0 in every lane.
template <bool kPairs, typename Src, int N>
__device__ __forceinline__ void load_taps(const CmHead& h, const void* __restrict__ src,
                                          const int (&ty)[N], const int (&tx)[N], unsigned rd,
                                          TapRegs<Src, N>& regs) {
  const PwHead& b = h.lower;
  if constexpr (std::is_same_v<Src, Nv12>) {
    const uint8_t* buf = static_cast<const uint8_t*>(src);
    const int iu = b.nv21 ? 1 : 0;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const uint8_t* lum = buf + (long long)ty[i] * b.src_w + tx[i];
      const uint8_t* uv = buf + ((long long)b.src_h + ty[i] / 2) * b.src_w + 2 * (tx[i] / 2);
      unsigned l = 0u, u = 0u, v = 0u;
      if (rd >> i & 1u) l = __ldg(lum), u = __ldg(uv + iu), v = __ldg(uv + 1 - iu);
      regs.w[i] = l | u << 8 | v << 16;
    }
  } else if constexpr (std::is_same_v<Src, uint8_t>) {
    const uint8_t* img = static_cast<const uint8_t*>(src);
    const int nch = b.nch;
    // a resample's two taps of one row (k = 0, 1 and 2, 3) whose columns lie
    // side by side in the base read their 2 * nch bytes as the warp kernel's
    // packed run (warp_kernel.cuh::load_run): three aligned words, half the
    // loads of byte by byte. A thread takes that path where each pair it
    // reads is such a run inside the buffer (a warp's interior); any other
    // reads byte by byte.
    bool runs = kPairs;
    if constexpr (kPairs) {
      const unsigned long long lo = reinterpret_cast<unsigned long long>(img);
      const unsigned long long hi = lo + (unsigned long long)b.src_h * b.src_w * nch;
#pragma unroll
      for (int i = 0; i < N; i += 2) {
        const unsigned both = rd >> i & 3u;
        const unsigned long long a =
            (lo + ((unsigned long long)ty[i] * b.src_w + tx[i]) * nch) & ~3ull;
        const bool run = both == 3u && ty[i + 1] == ty[i] && tx[i + 1] == tx[i] + 1 && a >= lo &&
                         a + 12ull <= hi;
        runs = runs && (both == 0u || run);
      }
    }
    if (runs) {
      const unsigned mask = nch >= 4 ? 0xffffffffu : (1u << (8 * nch)) - 1u;
#pragma unroll
      for (int i = 0; i < N; i += 2) {
        unsigned left = 0u, right = 0u;
        if (rd >> i & 3u) {
          kw::load_run(img + ((long long)ty[i] * b.src_w + tx[i]) * nch, nch, left, right);
        }
        regs.w[i] = left & mask;
        regs.w[i + 1] = right & mask;
      }
    } else {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const uint8_t* p = img + ((long long)ty[i] * b.src_w + tx[i]) * nch;
        unsigned w = 0u;
#pragma unroll
        for (int c = 0; c < kMaxCh; ++c) {
          if ((rd >> i & 1u) && c < nch) w |= (unsigned)__ldg(p + c) << (8 * c);
        }
        regs.w[i] = w;
      }
    }
  } else if constexpr (std::is_same_v<Src, AnyType> || std::is_same_v<Src, AnyImage>) {
#define CVGS_LOAD(SrcT)                                                                    \
  {                                                                                        \
    SrcT r[N][kMaxCh];                                                                     \
    load_image(static_cast<const SrcT*>(src), b.src_w, b.nch, ty, tx, rd, r);              \
    _Pragma("unroll") for (int i = 0; i < N; ++i) {                                        \
      _Pragma("unroll") for (int c = 0; c < kMaxCh; ++c) regs.e[i][c] = to_f32(r[i][c]);  \
    }                                                                                      \
  }                                                                                        \
  break;
#define CVGS_NONE                                    \
  _Pragma("unroll") for (int i = 0; i < N; ++i) {    \
    _Pragma("unroll") for (int c = 0; c < kMaxCh; ++c) regs.e[i][c] = 0.f; \
  }                                                  \
  break;
    if constexpr (std::is_same_v<Src, AnyType>) {
      // every type this instance takes is a case by name; the C entry sends
      // uint8, float32 and int32 sources and NV12 buffers to their own
      switch (b.src_type) {
        case PW_I8: CVGS_LOAD(int8_t)
        case PW_U16: CVGS_LOAD(uint16_t)
        case PW_I16: CVGS_LOAD(int16_t)
        case PW_F16: CVGS_LOAD(f16)
        case PW_I64: CVGS_LOAD(i64_bits)
        case PW_F64: CVGS_LOAD(double)
        default: CVGS_NONE
      }
    } else {
      // AnyImage: every image type is a case by name, an int32 element read
      // as float32's words as the float32 instance reads it (the C entry
      // sends no NV12 buffer here)
      switch (b.src_type) {
        case PW_U8: CVGS_LOAD(uint8_t)
        case PW_I8: CVGS_LOAD(int8_t)
        case PW_U16: CVGS_LOAD(uint16_t)
        case PW_I16: CVGS_LOAD(int16_t)
        case PW_F16: CVGS_LOAD(f16)
        case PW_F32:
        case PW_I32: CVGS_LOAD(float)
        case PW_I64: CVGS_LOAD(i64_bits)
        case PW_F64: CVGS_LOAD(double)
        default: CVGS_NONE
      }
    }
#undef CVGS_LOAD
#undef CVGS_NONE
  } else {
    load_image(static_cast<const Src*>(src), b.src_w, b.nch, ty, tx, rd, regs.e);
  }
}

// A value stored into a buffer of element type out_type (PW_U8 .. PW_I32)
// at element offset off: chain.cuh::store_any for that type.
template <int P>
__device__ __forceinline__ void store_typed(void* __restrict__ out, int out_type, long long off,
                                            const float (&v)[P][kMaxCh], int n, int out_ch,
                                            long long sc, long long sx) {
  switch (out_type) {
    case PW_U8:
    case PW_I8: store_any(static_cast<uint8_t*>(out) + off, v, n, out_ch, sc, sx); break;
    case PW_U16:
    case PW_I16: store_any(static_cast<uint16_t*>(out) + off, v, n, out_ch, sc, sx); break;
    case PW_F16: store_any(static_cast<f16*>(out) + off, v, n, out_ch, sc, sx); break;
    default: store_any(static_cast<float*>(out) + off, v, n, out_ch, sc, sx); break;
  }
}

// The chain of `n_ops` rows whose table is at `ops` and scalars at `fp` on
// v where `on`: from `rows` where the whole table was staged there at the
// kernel's start (once), else staged chunk by chunk here by the block
// (every thread reaches this call, so the barriers hold).
template <int P>
__device__ __forceinline__ void run_table(float (&v)[P][kMaxCh], PwRow* rows, bool once,
                                          const int* __restrict__ ops, int n_ops,
                                          const float* __restrict__ fp, int tid, bool on) {
  for (int k0 = 0; k0 < n_ops; k0 += kStageRows) {  // once: one pass over the staged rows
    const int m = min(kStageRows, n_ops - k0);
    if (!once) {
      __syncthreads();  // every thread is done with the last chunk
      stage_rows(rows, ops, n_ops, k0, m, fp, tid, kThreads);
      __syncthreads();
    }
    if (on) run_rows(v, rows, m);
  }
}

// The kernel for a source of kind Src, T taps a pixel (1: no resample; 4:
// a resize or a warp) and P adjacent output pixels a thread (1 or 4).
// Four blocks of 256 threads resident per SM (__launch_bounds__), which
// bounds a thread at 64 registers: the kernel gains from resident threads
// (at 66 registers a 4-tap thread kept 3 blocks resident and C1 took 12.19
// against 9.76 us on an H100); the shared instances' 4-tap thread, whose
// taps are float32 from the load, 3.
template <typename Src, int T>
constexpr int kBlocks =
    T == 4 && (std::is_same_v<Src, AnyType> || std::is_same_v<Src, AnyImage>) ? 3 : 4;

// The kernel's body over the plane's head h: the kernel's parameter, or a
// mixed-geometry batch's plane head in shared memory.
template <typename Src, int T, int P>
__device__ __forceinline__ void composed_body(
    const void* __restrict__ src, const CmHead& h, const Conv& conv, const int* __restrict__ blk,
    const int* __restrict__ consts, int dst_w, int dst_h, void* __restrict__ out, int out_type,
    int out_ch, int store_op, long long sn, long long sc, long long sy, long long sx) {
  // a thread's N taps over NX x positions and NY y positions: a
  // resample's 2 columns and 2 rows, P pixels' columns and their row
  static_assert(T == 1 || P == 1, "a resample takes 1 pixel a thread (pixels_per_thread)");
  constexpr int N = P * T;
  constexpr int NX = T == 1 ? P : 2;
  constexpr int NY = T == 1 ? 1 : 2;
  __shared__ PwRow in_rows[kStageRows];
  __shared__ PwRow out_rows[kStageRows];
  const int x = (blockIdx.x * blockDim.x + threadIdx.x) * P;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
#include "composed_body.cuh"
}

// composed_body at the place pl of a block of the split kernel
// (divergent_split.cuh), which takes its plane and tile from its index
// among its part's blocks.
template <typename Src, int T, int P>
__device__ __forceinline__ void composed_body_at(
    const void* __restrict__ src, const CmHead& h, const Conv& conv, const int* __restrict__ blk,
    const int* __restrict__ consts, int dst_w, int dst_h, void* __restrict__ out, int out_type,
    int out_ch, int store_op, long long sn, long long sc, long long sy, long long sx,
    const Place& pl) {
  // a thread's N taps over NX x positions and NY y positions: a
  // resample's 2 columns and 2 rows, P pixels' columns and their row
  static_assert(T == 1 || P == 1, "a resample takes 1 pixel a thread (pixels_per_thread)");
  constexpr int N = P * T;
  constexpr int NX = T == 1 ? P : 2;
  constexpr int NY = T == 1 ? 1 : 2;
  __shared__ PwRow in_rows[kStageRows];
  __shared__ PwRow out_rows[kStageRows];
  const int x = (pl.bx * pl.bw + pl.tx) * P;
  const int y = pl.by * pl.bh + pl.ty;
  const int z = pl.z;
  const int tid = pl.ty * pl.bw + pl.tx;
#include "composed_body.cuh"
}

template <typename Src, int T, int P>
__global__ void __launch_bounds__(kThreads, (kBlocks<Src, T>)) composed_kernel(
    const void* __restrict__ src, CmHead h, Conv conv, const int* __restrict__ blk,
    const int* __restrict__ consts, int dst_w, int dst_h, void* __restrict__ out, int out_type,
    int out_ch, int store_op, long long sn, long long sc, long long sy, long long sx) {
  composed_body<Src, T, P>(src, h, conv, blk, consts, dst_w, dst_h, out, out_type, out_ch,
                           store_op, sn, sc, sy, sx);
}

// The block's plane head of a mixed-geometry or divergent batch: the
// kWords consts words at blockIdx.z * kWords copied by the block's threads
// into `words`, in shared memory, then a barrier. A
// divergent batch's general instance (Src AnyImage, which runs no other
// batch) takes its plane's store row, consts word gridDim.z * kWords +
// blockIdx.z, as the launch's store_op.
template <typename Src, int kWords>
__device__ __forceinline__ void copy_plane_head(int* words, const int* __restrict__ consts,
                                                int& store_op) {
  const int* rec = consts + (long long)blockIdx.z * kWords;
  const int threads = blockDim.x * blockDim.y;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < kWords; i += threads) {
    words[i] = __ldg(rec + i);
  }
  if constexpr (std::is_same_v<Src, AnyImage>) {
    store_op = __ldg(consts + (long long)gridDim.z * kWords + blockIdx.z);
  }
  __syncthreads();
}

// A mixed-geometry batch's instance: the block's plane head copied into
// shared memory (copy_plane_head), then the body over it.
template <typename Src, int T, int P>
__global__ void __launch_bounds__(kThreads, (kBlocks<Src, T>)) composed_kernel_mixed(
    const void* __restrict__ src, Conv conv, const int* __restrict__ blk,
    const int* __restrict__ consts, int dst_w, int dst_h, void* __restrict__ out, int out_type,
    int out_ch, int store_op, long long sn, long long sc, long long sy, long long sx) {
  __shared__ CmHead h;
  copy_plane_head<Src, kCmWords>(reinterpret_cast<int*>(&h), consts, store_op);
  composed_body<Src, T, P>(src, h, conv, blk, consts, dst_w, dst_h, out, out_type, out_ch,
                           store_op, sn, sc, sy, sx);
}

// The launch for a source of kind Src: 1 or 4 taps from the core, P from
// a.pix (1 for a mixed-geometry batch, whose instances take one pixel a
// thread). A block is 256 threads: 64 x 4, narrowed while half as many
// threads across still cover a row.
template <typename Src>
void launch_source(const ComposedArgs& a) {
  CmHead h;
  std::memcpy(&h, a.head, sizeof(CmHead));
  const dim3 block = group_block(a.dst_w, a.pix);
  const int tile_w = block.x * a.pix;
  const dim3 grid((a.dst_w + tile_w - 1) / tile_w, (a.dst_h + block.y - 1) / block.y, a.n_planes);
  if (h.batch == CM_MIXED) {
#define CVGS_MIXED(T)                                                                    \
  composed_kernel_mixed<Src, T, 1><<<grid, block, 0, a.stream>>>(                        \
      a.src, a.conv, a.blk, a.consts, a.dst_w, a.dst_h, a.out, a.out_type, a.out_ch,     \
      a.store_op, a.sn, a.sc, a.sy, a.sx)
    if (h.core == CM_NONE) {
      CVGS_MIXED(1);
    } else {
      CVGS_MIXED(4);
    }
#undef CVGS_MIXED
    return;
  }
  // a divergent batch's general instances are mixed ones alone
  if constexpr (!std::is_same_v<Src, AnyImage>) {
#define CVGS_KERNEL(T, P)                                                                    \
  composed_kernel<Src, T, P><<<grid, block, 0, a.stream>>>(a.src, h, a.conv, a.blk, a.consts, \
                                                           a.dst_w, a.dst_h, a.out, a.out_type, \
                                                           a.out_ch, a.store_op, a.sn, a.sc,   \
                                                           a.sy, a.sx)
  if (h.core == CM_NONE) {
    if (a.pix == 4) {
      CVGS_KERNEL(1, 4);
    } else {
      CVGS_KERNEL(1, 1);
    }
  } else {
    CVGS_KERNEL(4, 1);
  }
#undef CVGS_KERNEL
  }
}

}  // namespace kc
}  // namespace

namespace {

// The C entries' checks of a head (composed.cu, composed_nested.cu): one
// plane's head, the words the launch does not set.
inline bool head_ok(const CmHead& h) {
  const PwHead& b = h.lower;
  const bool stages_ok = b.n_stages >= 0 && b.n_stages <= kMaxStages && h.upper.n_stages >= 0 &&
                         h.upper.n_stages <= kMaxStages && h.outer.n_stages >= 0 &&
                         h.outer.n_stages <= kMaxStages;
  return stages_ok && h.core >= CM_NONE && h.core <= CM_WARP && h.plane_stride >= 0 &&
         h.used_off >= -1 && (h.used_off >= 0) == (h.default_off >= 0) && b.base >= PW_IMAGE &&
         b.base <= PW_YUV && b.base != PW_CIRC && b.src_type >= PW_U8 && b.src_type <= PW_F64 &&
         b.nch >= 1 && b.nch <= kMaxCh && b.src_h >= 1 && b.src_w >= 1 &&
         !(b.base == PW_YUV && (b.src_type != PW_U8 || b.nch != 3)) &&
         !(b.conv_first && b.nch != 3) && h.tap_ch >= 1 && h.tap_ch <= kMaxCh &&
         h.tap_type >= PW_U8 && h.tap_type <= PW_I32 && h.core_type >= PW_U8 &&
         h.core_type <= PW_I32 && h.in_n_ops >= 0 && h.out_n_ops >= 0 && h.core_h >= 1 &&
         h.core_w >= 1 && h.in_h >= 1 && h.in_w >= 1;
}

// Whether two stage lists share their structure: counts, kinds, modes and
// block offsets (their sizes may differ).
inline bool same_stages(const PwHead& a, const PwHead& b) {
  if (a.n_stages != b.n_stages) return false;
  for (int s = 0; s < a.n_stages; ++s) {
    const PwStage &x = a.st[s], &y = b.st[s];
    const bool crop = x.kind == PW_CROP;
    if (x.kind != y.kind || x.mode != y.mode || (crop ? x.a != y.a || x.b != y.b : x.c != y.c)) {
      return false;
    }
  }
  return true;
}

// Whether plane head b of a divergent batch runs in the launch of plane
// head a: its batch word, absolute offsets (plane_stride 0), and a
// resampling core where a has one (the instances take 4 taps a pixel or 1).
inline bool same_instance(const CmHead& a, const CmHead& b) {
  return b.batch == CM_DIVERGENT && b.plane_stride == 0 &&
         (a.core == CM_NONE) == (b.core == CM_NONE);
}

// Which instances read a plane head's source: uint8, float32 and int32,
// NV12, the six others (composed.cu's switch).
inline int source_kind(const PwHead& b) {
  if (b.base == PW_YUV) return 2;
  if (b.src_type == PW_U8) return 0;
  return b.src_type == PW_F32 || b.src_type == PW_I32 ? 1 : 3;
}

// Whether plane heads a and b of a mixed-geometry batch differ in geometry
// alone: the base's and stages' sizes, the core's sizes, its edge rule and
// its tap tables.
inline bool same_structure(const CmHead& a, const CmHead& b) {
  const PwHead &p = a.lower, &q = b.lower;
  return same_stages(p, q) && same_stages(a.upper, b.upper) && same_stages(a.outer, b.outer) &&
         p.base == q.base && p.src_type == q.src_type && p.nch == q.nch && p.nv21 == q.nv21 &&
         p.conv_first == q.conv_first && p.limited == q.limited && p.width == q.width &&
         a.core == b.core && a.persp == b.persp && a.coef_off == b.coef_off &&
         a.border_off == b.border_off && a.tap_type == b.tap_type &&
         a.core_type == b.core_type && a.tap_ch == b.tap_ch && a.batch == b.batch &&
         a.in_n_ops == b.in_n_ops && a.in_ops_off == b.in_ops_off &&
         a.in_fp_off == b.in_fp_off && a.out_n_ops == b.out_n_ops &&
         a.out_ops_off == b.out_ops_off && a.out_fp_off == b.out_fp_off &&
         a.plane_stride == b.plane_stride && a.used_off == b.used_off &&
         a.default_off == b.default_off;
}

}  // namespace
