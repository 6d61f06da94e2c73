// The heads of the pointwise kernel: reads that take one source pixel per
// output pixel. A head is a base (a plane of an image stack, a plane of a
// ring from a runtime `first`, or an NV12/NV21 buffer) under up to kMaxStages
// re-indexing stages (crops at runtime origins, borders), outermost first, as
// Pipeline.lower() nests them.
//
// Every rule matches cvgpuspeedup_tpu_torch/ops bit for bit:
//   crop.py::crop_start    a negative origin counts from the far edge, then
//                          the start clamps to [0, length - size];
//   border.py              numpy.pad's index maps (edge, symmetric, reflect,
//                          wrap), periodic for a border wider than the
//                          source; CONSTANT holds `value` cast to the
//                          source's dtype (utils/dtypes.py::cast);
//   memory.py              ring plane floor_mod(first +- z, N), as Python's %;
//   nv12.py::ReadYUV       Y at (y, x), the chroma pair at (y / 2, x / 2).
//
// A head reads into L lanes per pixel (pointwise_chain.cuh), nch <= L, a
// thread's group of P adjacent pixels of one output row at a time: the
// stages are walked once for the group (the row once, the column per pixel)
// and the base's pixels read in one run of loads. Where the group lies whole
// in one row of a base with no stage above it, it is read as whole words: a
// one-channel source as 16-byte (or P-element) loads, an NV12/NV21 group of
// 4 as one 4-byte luma word and one 4-byte word of two chroma pairs; each
// where its address is aligned, else element by element. A one-lane
// group's run is stored as 16-byte (or P-element) words where aligned
// (store_run); a four-lane group as chain.cuh's store_any, as K6 stores.

#pragma once

#include "chain.cuh"
#include "frame_resize.cuh"
#include "pointwise_chain.cuh"

namespace {

// keep every code in step with exec/cuda_pointwise.py
enum : int { PW_IMAGE = 0, PW_CIRC = 1, PW_YUV = 2 };                         // bases
enum : int { PW_CROP = 0, PW_BORDER = 1 };                                    // stages
enum : int { PW_CONSTANT = 0, PW_REPLICATE = 1, PW_REFLECT = 2, PW_REFLECT_101 = 3, PW_WRAP = 4 };

constexpr int kMaxStages = 4;

// One stage, 8 words: its source's size, then
//   crop    a, b: block offsets of x and y; c, d: the crop's width and height
//   border  a, b: top and left; c: block offset of the value (nch floats)
struct PwStage {
  int kind, src_h, src_w, mode, a, b, c, d;
};

// The head of one launch, 12 words, the stages and the chain's width; the
// host fills it from the plan (exec/cuda_pointwise.py::PointwisePlan.head).
struct PwHead {
  int base, src_h, src_w, nch;
  int src_type;
  int n_src;       // planes of the stack or ring
  int first;       // circ: block offset of `first`
  int asc;         // circ: ascending
  int nv21;        // yuv: VU pairs
  int n_stages;
  int conv_first;  // YUV -> RGB (struct Conv) before the chain
  int limited;     // its colour range
  PwStage st[kMaxStages];
  int width;       // channels at the chain's widest point, the head's included
};
constexpr int kHeadWords = 12 + 8 * kMaxStages + 1;
static_assert(sizeof(PwHead) == kHeadWords * 4, "all int32 words");

__device__ __forceinline__ int floor_mod(int a, int n) { return a - floor_div(a, n) * n; }

// ops/crop.py::crop_start
__device__ __forceinline__ int crop_start(int start, int length, int size) {
  long long s = start;
  if (s < 0) s += length;
  return (int)min(max(s, 0ll), (long long)(length - size));
}

// The source index of position i (0 at the source's first element, negative
// before it) on an axis of n under a border mode.
__device__ __forceinline__ int fold_index(int i, int n, int mode) {
  switch (mode) {
    case PW_WRAP:
      return floor_mod(i, n);
    case PW_REFLECT: {  // dcba | abcd | dcba
      const int t = floor_mod(i, 2 * n);
      return t < n ? t : 2 * n - 1 - t;
    }
    case PW_REFLECT_101: {  // dcb | abcd | cba
      if (n == 1) return 0;
      const int t = floor_mod(i, 2 * n - 2);
      return t < n ? t : 2 * n - 2 - t;
    }
    default:  // REPLICATE; CONSTANT inside its source
      return clampi(i, 0, n - 1);
  }
}

// A CONSTANT border's float32 value cast to the source's element type as
// it is held in a register, as utils/dtypes.py::cast casts it: truncate,
// saturate, NaN to 0 (int32 as its bits); float16 rounds to nearest even.
// An int64 or float64 source is held as int32 or float32, its canonical
// type, so the value is cast to that.
__device__ __forceinline__ float cast_to_type(float v, int type) {
  switch (type) {
    case PW_U8: return (float)clampi(__float2int_rz(v), 0, 255);
    case PW_I8: return (float)clampi(__float2int_rz(v), -128, 127);
    case PW_U16: return (float)clampi(__float2int_rz(v), 0, 65535);
    case PW_I16: return (float)clampi(__float2int_rz(v), -32768, 32767);
    case PW_I32:
    case PW_I64: return __int_as_float(__float2int_rz(v));
    case PW_F16: return round_f16(v);
    case PW_F32:
    case PW_F64:
    default: return v;
  }
}

// The unsigned type of a load or store of B bytes.
template <int B>
struct Word;
template <>
struct Word<16> { using T = uint4; };
template <>
struct Word<8> { using T = uint2; };
template <>
struct Word<4> { using T = unsigned; };

// The n <= P adjacent elements of a one-channel row at p (0 past n): whole
// words of up to 16 bytes where all P are present and p is aligned to one,
// else element by element.
template <typename SrcT, int P>
__device__ __forceinline__ void load_run(const SrcT* __restrict__ p, int n, float (&v)[P][1]) {
  constexpr int kBytes = P * sizeof(SrcT) < 16 ? P * sizeof(SrcT) : 16;  // bytes per load
  constexpr int kPer = kBytes / sizeof(SrcT);
  if constexpr (kBytes >= 4) {
    if (n == P && (reinterpret_cast<unsigned long long>(p) & (kBytes - 1)) == 0) {
      using W = typename Word<kBytes>::T;
#pragma unroll
      for (int i = 0; i < P / kPer; ++i) {
        union {
          W w;
          SrcT e[kPer];
        } u;
        u.w = __ldg(reinterpret_cast<const W*>(p) + i);
#pragma unroll
        for (int j = 0; j < kPer; ++j) v[i * kPer + j][0] = to_f32(u.e[j]);
      }
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < P; ++q) v[q][0] = q < n ? ldf(p + q) : 0.f;
}

// load_run of a source of a runtime type at element offset off (int32 as
// float32's words: its bits; int64 as its low 32 bits). Every source type is
// a case by name: the host's range check refuses any other code, and a code
// without a case here would read nothing.
template <int P>
__device__ __forceinline__ void load_run_typed(const void* __restrict__ base, int type,
                                               long long off, int n, float (&v)[P][1]) {
  switch (type) {
    case PW_U8: load_run(static_cast<const uint8_t*>(base) + off, n, v); break;
    case PW_I8: load_run(static_cast<const int8_t*>(base) + off, n, v); break;
    case PW_U16: load_run(static_cast<const uint16_t*>(base) + off, n, v); break;
    case PW_I16: load_run(static_cast<const int16_t*>(base) + off, n, v); break;
    case PW_F16: load_run(static_cast<const f16*>(base) + off, n, v); break;
    case PW_F32:
    case PW_I32: load_run(static_cast<const float*>(base) + off, n, v); break;
    case PW_I64: load_run(static_cast<const i64_bits*>(base) + off, n, v); break;
    case PW_F64: load_run(static_cast<const double*>(base) + off, n, v); break;
  }
}

// The base plane that output plane z reads.
__device__ __forceinline__ int head_plane(const PwHead& h, const int* __restrict__ blk, int z) {
  if (h.base != PW_CIRC) return z;
  const int first = __ldg(blk + h.first);
  return floor_mod(h.asc ? first + z : first - z, h.n_src);
}

// The stages' walk for the thread's P pixels x .. x + P - 1 of output row y:
// each stage maps the positions inwards, outermost first, the row once for
// the group and the column per pixel; fill[q] is the block offset of the
// value of the first CONSTANT border pixel q lies outside of, else -1.
template <int P>
__device__ __forceinline__ void walk_stages(const PwHead& h, const int* __restrict__ blk,
                                            int (&xs)[P], int (&fill)[P], int& y) {
#pragma unroll
  for (int s = 0; s < kMaxStages; ++s) {
    if (s >= h.n_stages) break;
    const PwStage& st = h.st[s];
    if (st.kind == PW_CROP) {
      const int cx = crop_start(__ldg(blk + st.a), st.src_w, st.c);
      y += crop_start(__ldg(blk + st.b), st.src_h, st.d);
#pragma unroll
      for (int q = 0; q < P; ++q) xs[q] += cx;
    } else {
      const int j = y - st.a;
      const bool row_out = j < 0 || j >= st.src_h;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int i = xs[q] - st.b;
        if (st.mode == PW_CONSTANT && fill[q] < 0 && (row_out || i < 0 || i >= st.src_w)) {
          fill[q] = st.c;
        }
        xs[q] = fold_index(i, st.src_w, st.mode);
      }
      y = fold_index(j, st.src_h, st.mode);
    }
  }
}

// The 4 * kCh contiguous elements of 4 adjacent pixels at p as whole words
// (16 bytes where the run fills them, else 4), where p is aligned to one;
// returns false (and reads nothing) where not.
template <typename SrcT, int kCh>
__device__ __forceinline__ bool load_pixels4(const SrcT* __restrict__ p,
                                             float (&v)[4][kMaxCh]) {
  constexpr int kBytes = 4 * kCh * sizeof(SrcT);
  constexpr int kWord = kBytes % 16 == 0 ? 16 : 4;
  if ((reinterpret_cast<unsigned long long>(p) & (kWord - 1)) != 0) return false;
  using W = typename Word<kWord>::T;
  union {
    W w[kBytes / kWord];
    SrcT e[4 * kCh];
  } u;
#pragma unroll
  for (int i = 0; i < kBytes / kWord; ++i) u.w[i] = __ldg(reinterpret_cast<const W*>(p) + i);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) v[q][c] = c < kCh ? to_f32(u.e[q * kCh + c]) : 0.f;
  }
  return true;
}

// Pixels xs[q] of one row of elements of type SrcT with nch channels, for
// each q whose mask bit is set: all the group's loads first, in one
// straight run, then the conversions, so a thread waits for memory once and
// not once per pixel. Every lane of v is written: 0 where nothing is read.
// Four whole adjacent pixels of 3 or 4 channels of 1 or 4 bytes are one run
// of words where aligned (load_pixels4).
template <typename SrcT, int L, int P>
__device__ __forceinline__ void gather_row(const SrcT* __restrict__ row, int nch,
                                           const int (&xs)[P], unsigned mask, float (&v)[P][L]) {
  if constexpr (L == kMaxCh && P == 4 && sizeof(SrcT) != 2) {
    if (mask == 15 && xs[1] == xs[0] + 1 && xs[2] == xs[0] + 2 && xs[3] == xs[0] + 3) {
      const SrcT* p = row + xs[0] * nch;
      if (nch == 3 && load_pixels4<SrcT, 3>(p, v)) return;
      if (nch == 4 && load_pixels4<SrcT, 4>(p, v)) return;
    }
  }
  SrcT raw[P][L];
#pragma unroll
  for (int q = 0; q < P; ++q) {
#pragma unroll
    for (int c = 0; c < L; ++c) {
      if ((mask >> q & 1) && c < nch) raw[q][c] = ld_elem(row + xs[q] * nch + c);
    }
  }
#pragma unroll
  for (int q = 0; q < P; ++q) {
#pragma unroll
    for (int c = 0; c < L; ++c) v[q][c] = (mask >> q & 1) && c < nch ? to_f32(raw[q][c]) : 0.f;
  }
}

// The base's pixels xs[q] of row y of plane pz, for each q of mask: an
// NV12/NV21 buffer's luma and chroma pair, or nch elements of the source's
// runtime type (int32 as float32's words: its bits; int64 as its low 32
// bits). Every source type is a case by name. The four-lane 4-pixel
// instances, which the large launches of 3- and 4-channel chains take, leave
// the 64-bit types to a wide twin (kWide) that reads only them: their
// gathers in its code slowed P2's ring read by 5 % and P3's border by 3 to
// 8 % on an H100 (tools/kernel_variants_x64.json, pw_x64_in_every_instance);
// in the other instances they cost nothing measured.
template <int L, int P, bool kWide>
__device__ __forceinline__ void read_base_row(const PwHead& h, const void* __restrict__ src,
                                              int pz, int y, const int (&xs)[P], unsigned mask,
                                              float (&v)[P][L]) {
  if constexpr (L == kMaxCh) {  // an NV12 head has 3 channels: never a one-lane chain
    if (h.base == PW_YUV) {
      const uint8_t* buf = static_cast<const uint8_t*>(src);
      const uint8_t* lum = buf + (long long)y * h.src_w;
      const uint8_t* uv = buf + (long long)h.src_h * h.src_w + (long long)(y / 2) * h.src_w;
      const int iu = h.nv21 ? 1 : 0;
      uint8_t raw[P][3];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (!(mask >> q & 1)) continue;
        const int cx = 2 * (xs[q] / 2);
        raw[q][0] = __ldg(lum + xs[q]);
        raw[q][1] = __ldg(uv + cx + iu);
        raw[q][2] = __ldg(uv + cx + 1 - iu);
      }
#pragma unroll
      for (int q = 0; q < P; ++q) {
#pragma unroll
        for (int c = 0; c < kMaxCh; ++c) v[q][c] = (mask >> q & 1) && c < 3 ? (float)raw[q][c] : 0.f;
      }
      return;
    }
  }
  const long long row = ((long long)pz * h.src_h + y) * h.src_w * h.nch;
  constexpr bool kReads64 = kWide || !(L == kMaxCh && P == 4);
  if constexpr (kReads64) {
    switch (h.src_type) {
      case PW_I64:
        gather_row(static_cast<const i64_bits*>(src) + row, h.nch, xs, mask, v);
        return;
      case PW_F64:
        gather_row(static_cast<const double*>(src) + row, h.nch, xs, mask, v);
        return;
      default: break;
    }
  }
  if constexpr (kWide) return;
  switch (h.src_type) {
    case PW_U8: gather_row(static_cast<const uint8_t*>(src) + row, h.nch, xs, mask, v); break;
    case PW_I8: gather_row(static_cast<const int8_t*>(src) + row, h.nch, xs, mask, v); break;
    case PW_U16: gather_row(static_cast<const uint16_t*>(src) + row, h.nch, xs, mask, v); break;
    case PW_I16: gather_row(static_cast<const int16_t*>(src) + row, h.nch, xs, mask, v); break;
    case PW_F16: gather_row(static_cast<const f16*>(src) + row, h.nch, xs, mask, v); break;
    case PW_F32:
    case PW_I32: gather_row(static_cast<const float*>(src) + row, h.nch, xs, mask, v); break;
  }
}

// The Y, U, V values of the 4 pixels x .. x + 3 (x a multiple of 4) of row y
// of an NV12/NV21 buffer with no stage above it: one 4-byte luma word and one
// 4-byte word of the two chroma pairs, where both are aligned; returns false
// (and reads nothing) where not.
__device__ __forceinline__ bool nv12_words(const PwHead& h, const void* __restrict__ src, int x,
                                           int y, float (&v)[4][kMaxCh]) {
  const uint8_t* buf = static_cast<const uint8_t*>(src);
  const uint8_t* lum = buf + (long long)y * h.src_w + x;
  const uint8_t* uv = buf + (long long)h.src_h * h.src_w + (long long)(y / 2) * h.src_w + x;
  if (((reinterpret_cast<unsigned long long>(lum) | reinterpret_cast<unsigned long long>(uv)) &
       3) != 0) {
    return false;
  }
  const unsigned yw = __ldg(reinterpret_cast<const unsigned*>(lum));
  const unsigned cw = __ldg(reinterpret_cast<const unsigned*>(uv));
  const int iu = h.nv21 ? 1 : 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q][0] = byte_of(yw, q);
    v[q][1] = byte_of(cw, (q & 2) + iu);
    v[q][2] = byte_of(cw, (q & 2) + 1 - iu);
    v[q][3] = 0.f;
  }
  return true;
}

// The n <= P values of a one-lane group at o, elements sx apart: where they
// are contiguous, all P present and o aligned, as whole words of up to 16
// bytes; else element by element.
template <typename OutT, int P>
__device__ __forceinline__ void store_run(OutT* __restrict__ o, const float (&v)[P][1], int n,
                                          long long sx) {
  constexpr int kBytes = P * sizeof(OutT) < 16 ? P * sizeof(OutT) : 16;  // bytes per store
  constexpr int kPer = kBytes / sizeof(OutT);
  if constexpr (kBytes >= 4) {
    if (sx == 1 && n == P && (reinterpret_cast<unsigned long long>(o) & (kBytes - 1)) == 0) {
      using W = typename Word<kBytes>::T;
#pragma unroll
      for (int i = 0; i < P / kPer; ++i) {
        union {
          W w;
          OutT e[kPer];
        } u;
#pragma unroll
        for (int j = 0; j < kPer; ++j) u.e[j] = to_out<OutT>(v[i * kPer + j][0]);
        reinterpret_cast<W*>(o)[i] = u.w;
      }
      return;
    }
  }
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (q < n) o[q * sx] = to_out<OutT>(v[q][0]);
  }
}

}  // namespace
