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
//                          source's dtype;
//   memory.py              ring plane floor_mod(first +- z, N), as Python's %;
//   nv12.py::ReadYUV       Y at (y, x), the chroma pair at (y / 2, x / 2).

#pragma once

#include "chain.cuh"
#include "frame_resize.cuh"

namespace {

// keep every code in step with exec/cuda_pointwise.py
enum : int { PW_IMAGE = 0, PW_CIRC = 1, PW_YUV = 2 };                         // bases
enum : int { PW_CROP = 0, PW_BORDER = 1 };                                    // stages
enum : int { PW_CONSTANT = 0, PW_REPLICATE = 1, PW_REFLECT = 2, PW_REFLECT_101 = 3, PW_WRAP = 4 };
enum : int { PW_U8 = 0, PW_I8 = 1, PW_U16 = 2, PW_I16 = 3, PW_F32 = 4 };      // element types

constexpr int kMaxStages = 4;

// One stage, 8 words: its source's size, then
//   crop    a, b: block offsets of x and y; c, d: the crop's width and height
//   border  a, b: top and left; c: block offset of the value (nch floats)
struct PwStage {
  int kind, src_h, src_w, mode, a, b, c, d;
};

// The head of one launch, 12 words and the stages; the host fills it from
// the plan (exec/cuda_pointwise.py::PointwisePlan.head).
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
};
static_assert(sizeof(PwHead) == (12 + 8 * kMaxStages) * 4, "all int32 words");

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

// A float32 value cast to an element type and back, as Tensor.to does for a
// value in range (truncate).
__device__ __forceinline__ float cast_to_type(float v, int type) {
  switch (type) {
    case PW_U8: return cast_u8(v);
    case PW_I8: return cast_i8(v);
    case PW_U16: return cast_u16(v);
    case PW_I16: return cast_i16(v);
    default: return v;
  }
}

// nch elements at element offset off of a buffer of a runtime type.
__device__ __forceinline__ void load_typed(const void* __restrict__ base, int type, long long off,
                                           int nch, float (&v)[kMaxCh]) {
  switch (type) {
    case PW_U8: load_pixel(static_cast<const uint8_t*>(base) + off, nch, v); break;
    case PW_I8: load_pixel(static_cast<const int8_t*>(base) + off, nch, v); break;
    case PW_U16: load_pixel(static_cast<const uint16_t*>(base) + off, nch, v); break;
    case PW_I16: load_pixel(static_cast<const int16_t*>(base) + off, nch, v); break;
    default: load_pixel(static_cast<const float*>(base) + off, nch, v); break;
  }
}

// The base plane that output plane z reads.
__device__ __forceinline__ int head_plane(const PwHead& h, const int* __restrict__ blk, int z) {
  if (h.base != PW_CIRC) return z;
  const int first = __ldg(blk + h.first);
  return floor_mod(h.asc ? first + z : first - z, h.n_src);
}

// The value of output pixel (x, y) of plane pz, before the chain: the stages
// map (x, y) inwards, outermost first; a CONSTANT border ends the walk with
// its value; else the base is read.
__device__ __forceinline__ void head_read(const PwHead& h, const void* __restrict__ src,
                                          const int* __restrict__ blk, int pz, int x, int y,
                                          float (&v)[kMaxCh]) {
  const float* fblk = reinterpret_cast<const float*>(blk);
#pragma unroll
  for (int s = 0; s < kMaxStages; ++s) {
    if (s >= h.n_stages) break;
    const PwStage& st = h.st[s];
    if (st.kind == PW_CROP) {
      x += crop_start(__ldg(blk + st.a), st.src_w, st.c);
      y += crop_start(__ldg(blk + st.b), st.src_h, st.d);
    } else {
      const int i = x - st.b, j = y - st.a;
      if (st.mode == PW_CONSTANT && (i < 0 || i >= st.src_w || j < 0 || j >= st.src_h)) {
#pragma unroll
        for (int c = 0; c < kMaxCh; ++c) {
          if (c < h.nch) v[c] = cast_to_type(__ldg(fblk + st.c + c), h.src_type);
        }
        return;
      }
      x = fold_index(i, st.src_w, st.mode);
      y = fold_index(j, st.src_h, st.mode);
    }
  }
  if (h.base == PW_YUV) {
    const uint8_t* buf = static_cast<const uint8_t*>(src);
    const uint8_t* uv = buf + (long long)h.src_h * h.src_w + (long long)(y / 2) * h.src_w +
                        2 * (x / 2);
    v[0] = (float)__ldg(buf + (long long)y * h.src_w + x);
    v[1] = (float)__ldg(uv + (h.nv21 ? 1 : 0));
    v[2] = (float)__ldg(uv + (h.nv21 ? 0 : 1));
  } else {
    load_typed(src, h.src_type, (((long long)pz * h.src_h + y) * h.src_w + x) * h.nch, h.nch, v);
  }
}

}  // namespace
