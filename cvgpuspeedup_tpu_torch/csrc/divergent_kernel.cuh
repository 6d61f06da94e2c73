// The divergent kernel's body and launch (divergent.cu has the design, the
// parameter block and the C entry). Two translation units instantiate it:
// divergent.cu for batches whose groups read uint8, float32 or float64
// sources (their loads branch on those three), divergent_any.cu for every
// other batch (the general instance: a group of any of the nine source
// types, one switch on the type around all of a thread's loads). The
// three types keep instances of their own so that their batches never pay
// the general instance's registers: a variant at 72 registers ran the ring
// read a fifth slower.

#pragma once

#include <type_traits>

#include "batch_resize.cuh"
#include "frame_resize.cuh"
#include "warp.cuh"

namespace {

// group kinds; keep in step with exec/cuda_divergent.py::KINDS
enum : int { K_IMAGE = 0, K_CIRC = 1, K_CROP = 2, K_STACK = 3, K_NV12 = 4, K_WARP = 5 };
// a group's source type (Desc::src); keep in step with
// exec/cuda_divergent.py::_SRC_WORDS. divergent.cu's instances read the
// first three; the general instance reads all nine.
enum : int {
  S_F32 = 0,
  S_U8 = 1,
  S_F64 = 2,
  S_I8 = 3,
  S_U16 = 4,
  S_I16 = 5,
  S_F16 = 6,
  S_I32 = 7,
  S_I64 = 8
};

// A group's descriptor, 16 int32 words in this order; keep in step with
// exec/cuda_divergent.py::prepare
struct Desc {
  int kind, src_h, src_w, nch;
  int src;     // S_F32 .. S_I64
  int n_src;   // planes of the ring or stack; 1 for an image group of one image per plane
  int first;   // circ: block offset of `first`; a ragged image, nv12 or warp group: of the
               // default (kMaxCh words: float32 values, int32's bits for an int32 read)
  int asc;     // circ: ascending
  int mode;    // crop, stack: aspect-ratio mode
  int used;    // crop, stack: block offset of used_planes; a ragged image, nv12 or warp
               // group: of its used_planes, else -1
  int op_off;  // first op row in the consts
  int n_ops;
  int fp_off;  // block offset of the chain scalars
  int data;    // crop, stack: rects; warp: coefficients (block); nv12: taps (consts)
  int flags;   // nv12: keep_edge | nv21 << 1 | limited << 2 | alpha << 3; warp: perspective
  int aux;     // crop, stack: background; warp: borders (block); nv12: weights (consts)
};
static_assert(sizeof(Desc) == 64, "four 16-byte words");

__device__ __forceinline__ Desc load_desc(const int* __restrict__ p) {
  const int4* q = reinterpret_cast<const int4*>(p);
  const int4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2), d = __ldg(q + 3);
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
}

// The adjacent output pixels a thread takes, from the launch's output
// count: 4 where a thread per 4 pixels still fills a third of the card's
// resident threads, else 1. On an H100 (360,448 outputs; profiler medians,
// 1 pixel against 4): a ring copy of 12 planes of 128x256 (393,216) 6.82
// against 5.90 us, of 8 planes 5.25 against 5.06; 40 planes of warp | crop |
// pass at 64x128 (327,680) 7.16 against 7.86, 48 planes 8.03 against 8.14;
// eight planes (65,536) 3.1 to 3.8 against 4.2 to 6.3. 2 pixels per thread
// lost everywhere (the 16-plane ring 14.8 against 6.7 us).
inline int pixels_per_thread(long long outputs) {
  return 3 * outputs >= 4 * resident_threads() ? 4 : 1;
}

// f(p) with p the group's source `base` as a pointer to its element type,
// for the general instance. A copy group (kSampled false) starts its chain
// in the source's own dtype: an int32 element is moved as float32's word
// and an int64 element as its low 32 bits (i64_bits), the bits an int32
// chain holds (a float32 conversion would round past 2^24). A sampled group
// reads every element into float32, as K1 and the warp kernel do: int32 by
// cvt.rn.f32.s32, int64 by its low 32 bits, then the same (chain.cuh::to_f32).
template <bool kSampled, typename F>
__device__ __forceinline__ void with_source(int src, const void* base, F&& f) {
  switch (src) {
    case S_U8: f(static_cast<const uint8_t*>(base)); break;
    case S_I8: f(static_cast<const int8_t*>(base)); break;
    case S_U16: f(static_cast<const uint16_t*>(base)); break;
    case S_I16: f(static_cast<const int16_t*>(base)); break;
    case S_F16: f(static_cast<const f16*>(base)); break;
    case S_I32:
      if constexpr (kSampled) {
        f(static_cast<const int32_t*>(base));
      } else {
        f(static_cast<const float*>(base));
      }
      break;
    case S_I64:
      if constexpr (kSampled) {
        f(static_cast<const long long*>(base));
      } else {
        f(static_cast<const i64_bits*>(base));
      }
      break;
    case S_F64: f(static_cast<const double*>(base)); break;
    default: f(static_cast<const float*>(base)); break;
  }
}

// Plane z's source address and its group's descriptor: the plane's uniform
// loads, the address beside the group, then the descriptor in four loads.
__device__ __forceinline__ void plane_loads(const int* __restrict__ blk, int ptr_off,
                                            int desc_off, int z, const void*& base, Desc& d) {
  const int group = __ldg(blk + z);
  base = reinterpret_cast<const void*>(
      __ldg(reinterpret_cast<const unsigned long long*>(blk + ptr_off) + z));
  d = load_desc(blk + desc_off + (int)(sizeof(Desc) / 4) * group);
}

// Plane blockIdx.z's pixels of one launch: kAny false for divergent.cu's
// instances (uint8, float32 and float64 sources), true for the general one.
template <bool kAny, typename OutT, int P>
__device__ __forceinline__ void divergent_body(const int* __restrict__ blk,
                                               const int* __restrict__ consts, int ptr_off,
                                               int desc_off, int dst_w, int dst_h,
                                               OutT* __restrict__ out, int out_ch, long long sn,
                                               long long sc, long long sy, long long sx) {
  const int x = (blockIdx.x * blockDim.x + threadIdx.x) * P;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= dst_w || y >= dst_h) return;
  const int n = min(P, dst_w - x);

  const float* fblk = reinterpret_cast<const float*>(blk);
  const float* fconsts = reinterpret_cast<const float*>(consts);
  // the plane's uniform loads: its source address beside its group, then
  // the group's descriptor in four loads
  const int group = __ldg(blk + z);
  const void* base = reinterpret_cast<const void*>(
      __ldg(reinterpret_cast<const unsigned long long*>(blk + ptr_off) + z));
  const Desc d = load_desc(blk + desc_off + (int)(sizeof(Desc) / 4) * group);
  const int src_h = d.src_h, src_w = d.src_w, nch = d.nch;

  float v[P][kMaxCh];
#include "divergent_read.cuh"

  // a group's table ends in the row that casts its values into the batch's
  // dtype (plane 0's group gave the batch its dtype), as the eager merge's
  // astype does, where that takes one (exec/cuda_batch_resize.py::store_cast)
  run_chain(v, ch, consts + 4 * d.op_off, d.n_ops, fblk + d.fp_off);

  store_any(out + (long long)z * sn + (long long)y * sy + (long long)x * sx, v, n, out_ch, sc, sx);
}

// The values v of the n (<= P) adjacent pixels from (x, y) of plane z,
// whose group is d and source `base` (plane_loads), after the group's
// chain, as divergent_body reads them: the split kernel's K6 part
// (divergent_split.cuh), which loads a plane's values once for its walk.
template <bool kAny, int P>
__device__ __forceinline__ void divergent_values(const int* __restrict__ blk,
                                                 const int* __restrict__ consts, int dst_w,
                                                 int dst_h, int x, int y, int z, int n,
                                                 const void* base, const Desc& d,
                                                 float (&v)[P][kMaxCh]) {
  const float* fblk = reinterpret_cast<const float*>(blk);
  const float* fconsts = reinterpret_cast<const float*>(consts);
  const int src_h = d.src_h, src_w = d.src_w, nch = d.nch;
#include "divergent_read.cuh"
  run_chain(v, ch, consts + 4 * d.op_off, d.n_ops, fblk + d.fp_off);
}

// a kernel instance of one output element type, as each translation unit
// defines its own over divergent_body
template <typename OutT>
using DivergentKernel = void (*)(const int*, const int*, int, int, int, int, OutT*, int,
                                 long long, long long, long long, long long);

}  // namespace

namespace cvgs {
// One launch's arguments, as the C entry takes them (divergent.cu)
struct DivergentArgs {
  const int* blk;
  const int* consts;
  int ptr_off, desc_off, n_planes, dst_w, dst_h;
  void* out;
  int out_type, out_ch;
  long long sn, sc, sy, sx;
  cudaStream_t stream;
};
// the general instance's launch (divergent_any.cu)
void divergent_any(const DivergentArgs& a);
}  // namespace cvgs

namespace {
// One launch of an instance: k4 where a thread takes 4 pixels, else k1.
template <typename OutT>
void launch_divergent(const cvgs::DivergentArgs& a, DivergentKernel<OutT> k4,
                      DivergentKernel<OutT> k1) {
  const int pix = pixels_per_thread((long long)a.n_planes * a.dst_w * a.dst_h);
  const dim3 block = group_block(a.dst_w, pix);
  const int tile_w = block.x * pix;
  const dim3 grid((a.dst_w + tile_w - 1) / tile_w, (a.dst_h + block.y - 1) / block.y, a.n_planes);
  (pix == 4 ? k4 : k1)<<<grid, block, 0, a.stream>>>(
      a.blk, a.consts, a.ptr_off, a.desc_off, a.dst_w, a.dst_h, static_cast<OutT*>(a.out),
      a.out_ch, a.sn, a.sc, a.sy, a.sx);
}
}  // namespace

// The launch of the kernel template KERNEL<OutT, P> by the output's element
// type: uint8_t for uint8 and int8, uint16_t for uint16 and int16, f16, and
// float for float32 and int32 (chain.cuh::to_out).
#define CVGS_DIVERGENT_LAUNCH(KERNEL, a)                                                   \
  switch ((a).out_type) {                                                                  \
    case PW_U8:                                                                            \
    case PW_I8: launch_divergent<uint8_t>(a, KERNEL<uint8_t, 4>, KERNEL<uint8_t, 1>); break; \
    case PW_U16:                                                                           \
    case PW_I16:                                                                           \
      launch_divergent<uint16_t>(a, KERNEL<uint16_t, 4>, KERNEL<uint16_t, 1>);             \
      break;                                                                               \
    case PW_F16: launch_divergent<f16>(a, KERNEL<f16, 4>, KERNEL<f16, 1>); break;          \
    default: launch_divergent<float>(a, KERNEL<float, 4>, KERNEL<float, 1>); break;        \
  }
