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
#pragma unroll
  for (int q = 0; q < P; ++q) {
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) v[q][c] = 0.f;
  }
  int ch = d.kind == K_NV12 ? ((d.flags >> 3) & 1 ? 4 : 3) : nch;
  // a ragged BatchRead group (images, NV12 reads or warps): its planes from
  // used_planes on hold its default, which then runs through the chain
  const bool held =
      d.kind != K_CROP && d.kind != K_STACK && d.used >= 0 && z >= __ldg(blk + d.used);
  if (held) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) v[q][c] = c < ch ? __ldg(fblk + d.first + c) : 0.f;
    }
  }
  switch (held ? -1 : d.kind) {
    case K_IMAGE:
    case K_CIRC: {
      int pz = d.n_src == 1 ? 0 : z;  // a stack's plane z, or the plane's own image
      if (d.kind == K_CIRC) {
        const int first = __ldg(blk + d.first);
        const int t = d.asc ? first + z : first - z;
        pz = t - floor_div(t, d.n_src) * d.n_src;  // floor modulo, as Python's %
      }
      const long long off = (((long long)pz * src_h + y) * src_w + x) * nch;
      if constexpr (kAny) {
        with_source<false>(d.src, base, [&](auto src) {
#pragma unroll
          for (int q = 0; q < P; ++q) {
            if (q < n) load_pixel(src + off + q * nch, nch, v[q]);
          }
        });
      } else {
#pragma unroll
        for (int q = 0; q < P; ++q) {
          if (q >= n) continue;
          if (d.src == S_U8) {
            load_pixel(static_cast<const uint8_t*>(base) + off + q * nch, nch, v[q]);
          } else if (d.src == S_F64) {
            load_pixel(static_cast<const double*>(base) + off + q * nch, nch, v[q]);
          } else {
            load_pixel(static_cast<const float*>(base) + off + q * nch, nch, v[q]);
          }
        }
      }
      break;
    }
    case K_CROP:
    case K_STACK: {
      const float* bg = fblk + d.aux;
      const bool used = z < __ldg(blk + d.used);
      const int* r = blk + d.data + 4 * z;
      const int rx = __ldg(r), ry = __ldg(r + 1), rw = __ldg(r + 2), rh = __ldg(r + 3);
      const long long plane = d.kind == K_STACK ? (long long)z * src_h * src_w * nch : 0;
      if constexpr (kAny) {
        bool sampled[P];
#pragma unroll
        for (int q = 0; q < P; ++q) sampled[q] = false;
        if (used) {
          with_source<true>(d.src, base, [&](auto src) {
#pragma unroll
            for (int q = 0; q < P; ++q) {
              if (q < n) {
                sampled[q] = sample_crop(src + plane, src_h, src_w, nch, rx, ry, rw, rh, dst_w,
                                         dst_h, d.mode, x + q, y, v[q]);
              }
            }
          });
        }
#pragma unroll
        for (int q = 0; q < P; ++q) {
          if (q < n && !sampled[q]) {
#pragma unroll
            for (int c = 0; c < kMaxCh; ++c) v[q][c] = c < nch ? __ldg(bg + c) : 0.f;
          }
        }
      } else {
#pragma unroll
        for (int q = 0; q < P; ++q) {
          if (q >= n) continue;
          bool sampled = false;
          if (used) {
            if (d.src == S_U8) {
              sampled = sample_crop(static_cast<const uint8_t*>(base) + plane, src_h, src_w, nch,
                                    rx, ry, rw, rh, dst_w, dst_h, d.mode, x + q, y, v[q]);
            } else if (d.src == S_F64) {
              sampled = sample_crop(static_cast<const double*>(base) + plane, src_h, src_w, nch,
                                    rx, ry, rw, rh, dst_w, dst_h, d.mode, x + q, y, v[q]);
            } else {
              sampled = sample_crop(static_cast<const float*>(base) + plane, src_h, src_w, nch,
                                    rx, ry, rw, rh, dst_w, dst_h, d.mode, x + q, y, v[q]);
            }
          }
          if (!sampled) {
#pragma unroll
            for (int c = 0; c < kMaxCh; ++c) v[q][c] = c < nch ? __ldg(bg + c) : 0.f;
          }
        }
      }
      break;
    }
    case K_NV12: {
      const float* wts = fconsts + d.aux;
      const float* cf = wts + dst_w + dst_h;
      const Conv conv{(d.flags >> 2) & 1, (d.flags >> 3) & 1, __ldg(cf),     __ldg(cf + 1),
                      __ldg(cf + 2),      __ldg(cf + 3),      __ldg(cf + 4), __ldg(cf + 5)};
      const int* taps = consts + d.data;
      nv12_pixels<P>(nv12_rows(static_cast<const uint8_t*>(base), src_h, src_w, taps, wts, dst_w,
                               dst_h, y),
                     (d.flags >> 1) & 1, taps, wts, dst_w, dst_h, x, n, (d.flags & 1) != 0, conv, v);
      break;
    }
    case K_WARP: {
      const float* c = fblk + d.data + kCoeffs * z;
      const float* b = fblk + d.aux + kMaxCh * z;
      const bool persp = (d.flags & 1) != 0;
      if constexpr (kAny) {
        with_source<true>(d.src, base, [&](auto src) {
          using SrcT = std::remove_cv_t<std::remove_pointer_t<decltype(src)>>;
#pragma unroll
          for (int q = 0; q < P; ++q) {
            if (q >= n) continue;
            if (persp) {
              sample_warp<SrcT, true>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
            } else {
              sample_warp<SrcT, false>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
            }
          }
        });
      } else {
#pragma unroll
        for (int q = 0; q < P; ++q) {
          if (q >= n) continue;
          if (d.src == S_U8) {
            const uint8_t* src = static_cast<const uint8_t*>(base);
            if (persp) {
              sample_warp<uint8_t, true>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
            } else {
              sample_warp<uint8_t, false>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
            }
          } else if (d.src == S_F64) {
            const double* src = static_cast<const double*>(base);
            if (persp) {
              sample_warp<double, true>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
            } else {
              sample_warp<double, false>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
            }
          } else {
            const float* src = static_cast<const float*>(base);
            if (persp) {
              sample_warp<float, true>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
            } else {
              sample_warp<float, false>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
            }
          }
        }
      }
      break;
    }
    default:
      break;
  }

  // a group's table ends in the row that casts its values into the batch's
  // dtype (plane 0's group gave the batch its dtype), as the eager merge's
  // astype does, where that takes one (exec/cuda_batch_resize.py::store_cast)
  run_chain(v, ch, consts + 4 * d.op_off, d.n_ops, fblk + d.fp_off);

  store_any(out + (long long)z * sn + (long long)y * sy + (long long)x * sx, v, n, out_ch, sc, sx);
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
