// The pointwise chain interpreter and the helpers the port's kernels share.
//
// A chain is a table of rows [code, param offset, param stride, aux] built
// once per pipeline structure by exec/cuda_batch_resize.py::encode_chain,
// over a float32 parameter block. Values live in float32 registers, up to
// kMaxCh channels; the encoder tracks the running dtype and channel count
// statically, so a uint8 value is saturated after each op and a colour
// conversion may change the channel count.
//
// A kernel holds one pixel per thread (float v[1][kMaxCh]) or P adjacent
// ones (v[P][kMaxCh], P of 1 or 4); run_chain and store_pixels take either.
// What the kernels share of that scheme lives here too: the card's resident
// threads (each kernel sets its own pixels-per-thread threshold from them),
// the block shape of a pixel-group kernel and the packed layouts' group
// store (store_any).
//
// Numerics: every float op is an _rn intrinsic, so nothing is contracted
// into an FMA (the library is also built with -fmad=false).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxCh = 4;

// chain op codes; keep in step with exec/cuda_batch_resize.py
enum : int {
  OP_MUL = 1,
  OP_ADD = 2,
  OP_SUB = 3,
  OP_DIV = 4,
  OP_SAT_U8 = 5,     // round half to even, clamp to [0, 255]
  OP_CAST_U8 = 6,    // truncate, keep the low 8 bits
  OP_REORDER = 7,    // channel c takes channel (aux >> 4c) & 15; aux >> 16 channels remain
  OP_ALPHA = 8,      // append a channel holding aux (1 for float, 255 for uint8)
  OP_GRAY_U8 = 9,    // OpenCV's 15-bit fixed point; r, g, b at aux bits 0, 4, 8
  OP_GRAY_F32 = 10,  // r*0.299 + g*0.587 + b*0.114 in float32
  // the wide table, run only by the pointwise kernel (pointwise_chain.cuh):
  // int8, uint16 and int16 are exact in a float32 register, as uint8 is
  OP_SAT_I8 = 11,    // round half to even, clamp to [-128, 127]
  OP_SAT_U16 = 12,   // ... to [0, 65535]
  OP_SAT_I16 = 13,   // ... to [-32768, 32767]
  OP_CAST_I8 = 14,   // truncate, keep the low 8 bits, sign-extended
  OP_CAST_U16 = 15,  // truncate, keep the low 16 bits
  OP_CAST_I16 = 16,  // truncate, keep the low 16 bits, sign-extended
};

// float32(0.299), float32(0.587), float32(0.114), as ops/color.py rounds them
constexpr float kGrayR = 0x1.322d0ep-2f;
constexpr float kGrayG = 0x1.2c8b44p-1f;
constexpr float kGrayB = 0x1.d2f1aap-4f;

__device__ __forceinline__ int floor_div(int a, int b) {  // b > 0
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return min(max(v, lo), hi); }

// the register v[i] for a runtime i, without indexing the array (which
// would move it to local memory)
__device__ __forceinline__ float pick(const float (&v)[kMaxCh], int i) {
  float r = v[0];
  if (i == 1) r = v[1];
  if (i == 2) r = v[2];
  if (i == 3) r = v[3];
  return r;
}

// a*(1-w) + b*w, each product and the sum rounded once
__device__ __forceinline__ float lerp_rn(float a, float b, float w) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, w)), __fmul_rn(b, w));
}

// The threads the card keeps resident: SMs x threads per SM.
inline long long resident_threads() {
  static const long long resident = [] {
    int dev = 0, sms = 132, threads = 2048;  // an H100, should a query fail
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&threads, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
    return (long long)sms * threads;
  }();
  return resident;
}

// The block of 256 threads of a kernel whose threads own `pix` adjacent
// pixels of one row: 64 x 4 threads, narrowed (down to 16 x 16) while half
// as many threads across still cover an output row of dst_w pixels.
inline dim3 group_block(int dst_w, int pix) {
  int tx = 64;
  while (pix > 1 && tx > 16 && (tx / 2) * pix >= dst_w) tx /= 2;
  return dim3(tx, 256 / tx);
}

__device__ __forceinline__ float byte_of(unsigned w, int i) {
  return (float)((w >> (8 * i)) & 0xffu);
}

// One pixel's nch values at p, element by element.
template <typename SrcT>
__device__ __forceinline__ void load_pixel(const SrcT* __restrict__ p, int nch,
                                           float (&v)[kMaxCh]) {
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) {
    if (c < nch) v[c] = (float)__ldg(p + c);
  }
}

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ uint8_t to_out<uint8_t>(float v) {
  return (uint8_t)__float2int_rz(v);  // the chain left an exact value in [0, 255]
}
template <>
__device__ __forceinline__ int8_t to_out<int8_t>(float v) { return (int8_t)__float2int_rz(v); }
template <>
__device__ __forceinline__ uint16_t to_out<uint16_t>(float v) {
  return (uint16_t)__float2int_rz(v);
}
template <>
__device__ __forceinline__ int16_t to_out<int16_t>(float v) { return (int16_t)__float2int_rz(v); }

// The element types of an output buffer (and of the pointwise kernel's
// sources); keep in step with exec/cuda_batch_resize.py::TYPE_CODES
enum : int { PW_U8 = 0, PW_I8 = 1, PW_U16 = 2, PW_I16 = 3, PW_F32 = 4 };

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

// A float32 chain stored into an integer buffer (clamp_store, a ring slot
// of another dtype): each value clamped to the buffer's range here, then
// truncated by to_out, as utils/dtypes.py::astype casts. A float32 buffer
// is left as it is.
template <typename OutT, int P, int L>
__device__ __forceinline__ void clamp_to_range(float (&v)[P][L]) {
  if constexpr (sizeof(OutT) < 4) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
#pragma unroll
      for (int c = 0; c < L; ++c) v[q][c] = fminf(fmaxf(v[q][c], Range<OutT>::lo), Range<OutT>::hi);
    }
  }
}

// ops/cast.py::Cast of a float32 register to an integer type: truncate, keep
// the low bits (OP_CAST_U8's rule for every width)
__device__ __forceinline__ float cast_u8(float v) { return (float)(__float2int_rz(v) & 255); }
__device__ __forceinline__ float cast_i8(float v) { return (float)(int8_t)__float2int_rz(v); }
__device__ __forceinline__ float cast_u16(float v) { return (float)(__float2int_rz(v) & 65535); }
__device__ __forceinline__ float cast_i16(float v) { return (float)(int16_t)__float2int_rz(v); }

// ops/cast.py::SaturateCast: round half to even, clamp to [lo, hi]
__device__ __forceinline__ float saturate(float v, float lo, float hi) {
  const float r = rintf(v);
  return r < lo ? lo : (r > hi ? hi : r);
}

// Runs the chain on the P pixels of v, each holding ch channels; returns the
// channel count after the chain. An op row is decoded once for all P pixels
// and a per-channel scalar is loaded once per channel, so a kernel that
// gives a thread several pixels pays the table once. The wide table
// (OP_SAT_I8 and up) is the pointwise kernel's alone (pointwise_chain.cuh).
template <int P>
__device__ __forceinline__ int run_chain(float (&v)[P][kMaxCh], int ch,
                                         const int* __restrict__ ops, int n_ops,
                                         const float* __restrict__ fp) {
  for (int k = 0; k < n_ops; ++k) {
    const int code = __ldg(ops + 4 * k);
    const int off = __ldg(ops + 4 * k + 1);
    const int stride = __ldg(ops + 4 * k + 2);
    const int aux = __ldg(ops + 4 * k + 3);
    switch (code) {
      case OP_REORDER:
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float t[kMaxCh];
#pragma unroll
          for (int c = 0; c < kMaxCh; ++c) t[c] = v[p][c];
#pragma unroll
          for (int c = 0; c < kMaxCh; ++c) v[p][c] = pick(t, (aux >> (4 * c)) & 15);
        }
        ch = aux >> 16;
        break;
      case OP_ALPHA:
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
          for (int c = 0; c < kMaxCh; ++c) {
            if (c == ch) v[p][c] = (float)aux;
          }
        }
        ++ch;
        break;
      case OP_GRAY_U8:
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const int acc = (int)pick(v[p], aux & 15) * 9798 +
                          (int)pick(v[p], (aux >> 4) & 15) * 19235 +
                          (int)pick(v[p], (aux >> 8) & 15) * 3735 + (1 << 14);
          v[p][0] = (float)(acc >> 15);
        }
        ch = 1;
        break;
      case OP_GRAY_F32:
#pragma unroll
        for (int p = 0; p < P; ++p) {
          const float r = pick(v[p], aux & 15);
          const float g = pick(v[p], (aux >> 4) & 15);
          const float b = pick(v[p], (aux >> 8) & 15);
          v[p][0] = __fadd_rn(__fadd_rn(__fmul_rn(r, kGrayR), __fmul_rn(g, kGrayG)),
                              __fmul_rn(b, kGrayB));
        }
        ch = 1;
        break;
#define CVGS_ARITH(FN)                                   \
  _Pragma("unroll") for (int c = 0; c < kMaxCh; ++c) {   \
    if (c >= ch) continue;                               \
    const float q = __ldg(fp + off + c * stride);        \
    _Pragma("unroll") for (int p = 0; p < P; ++p) v[p][c] = FN(v[p][c], q); \
  }                                                      \
  break;
      case OP_MUL: CVGS_ARITH(__fmul_rn)
      case OP_ADD: CVGS_ARITH(__fadd_rn)
      case OP_SUB: CVGS_ARITH(__fsub_rn)
      case OP_DIV: CVGS_ARITH(__fdiv_rn)
#undef CVGS_ARITH
      case OP_SAT_U8:
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
          for (int c = 0; c < kMaxCh; ++c) {
            if (c >= ch) continue;
            const float r = rintf(v[p][c]);
            v[p][c] = r < 0.f ? 0.f : (r > 255.f ? 255.f : r);
          }
        }
        break;
      case OP_CAST_U8:
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
          for (int c = 0; c < kMaxCh; ++c) {
            if (c < ch) v[p][c] = cast_u8(v[p][c]);
          }
        }
        break;
      default:
        break;
    }
  }
  return ch;
}

// Four adjacent elements at an aligned p as one store: 16 bytes of float32, 8
// of a 16-bit type, 4 of an 8-bit one.
template <typename OutT>
__device__ __forceinline__ void store_vec4(OutT* __restrict__ p, float a, float b, float c,
                                           float d) {
  if constexpr (sizeof(OutT) == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
  } else if constexpr (sizeof(OutT) == 2) {
    *reinterpret_cast<ushort4*>(p) =
        make_ushort4((unsigned short)to_out<OutT>(a), (unsigned short)to_out<OutT>(b),
                     (unsigned short)to_out<OutT>(c), (unsigned short)to_out<OutT>(d));
  } else {
    *reinterpret_cast<uchar4*>(p) =
        make_uchar4((unsigned char)to_out<OutT>(a), (unsigned char)to_out<OutT>(b),
                    (unsigned char)to_out<OutT>(c), (unsigned char)to_out<OutT>(d));
  }
}

// Stores the thread's adjacent output pixels (x .. x + n - 1 of one row,
// n <= P) from v: `o` points at channel 0 of pixel x, channels lie sc
// elements apart and pixels sx. Where the pixels of a channel are contiguous
// (sx == 1), P is 4, all 4 are present and the address is aligned to the
// vector, a channel goes out as one store of 4 elements (store_vec4);
// anything else (packed layouts, a row's tail, a misaligned view) takes
// scalar stores.
template <typename OutT, int P>
__device__ __forceinline__ void store_pixels(OutT* __restrict__ o, const float (&v)[P][kMaxCh],
                                             int n, int out_ch, long long sc, long long sx) {
  constexpr unsigned kVecBytes = P * sizeof(OutT);
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) {
    if (c >= out_ch) continue;
    OutT* p = o + c * sc;
    if (P == 4 && sx == 1 && n == P &&
        (reinterpret_cast<unsigned long long>(p) & (kVecBytes - 1)) == 0) {
      if constexpr (P == 4) store_vec4(p, v[0][c], v[1][c], v[2][c], v[3][c]);
    } else {
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (q < n) p[q * sx] = to_out<OutT>(v[q][c]);
      }
    }
  }
}

// The 4 * kCh contiguous elements of 4 adjacent pixels of a packed layout at
// an aligned o, as kCh vector stores (store_vec4): element j is channel
// j % kCh of pixel j / kCh.
template <typename OutT, int kCh>
__device__ __forceinline__ void store_group(OutT* __restrict__ o, const float (&v)[4][kMaxCh]) {
#pragma unroll
  for (int k = 0; k < kCh; ++k) {
    const float a = v[(4 * k) / kCh][(4 * k) % kCh], b = v[(4 * k + 1) / kCh][(4 * k + 1) % kCh];
    const float c = v[(4 * k + 2) / kCh][(4 * k + 2) % kCh];
    const float d = v[(4 * k + 3) / kCh][(4 * k + 3) % kCh];
    store_vec4(o + 4 * k, a, b, c, d);
  }
}

// store_pixels for a kernel that also writes packed layouts in groups: where
// a pixel's channels are contiguous and its neighbour follows (sc == 1,
// sx == out_ch), P is 4, all 4 pixels are present and the address is aligned
// to the vector, the thread's 4 * out_ch contiguous elements go out as
// out_ch vector stores; anything else is store_pixels'. Scalar stores of a
// packed layout from 4 pixels per thread lie 4 * out_ch elements apart
// between neighbouring threads, which measured 2.6 times the whole kernel's
// time on a (16, 128, 256, 3) float32 batch.
template <typename OutT, int P>
__device__ __forceinline__ void store_any(OutT* __restrict__ o, const float (&v)[P][kMaxCh], int n,
                                          int out_ch, long long sc, long long sx) {
  if constexpr (P == 4) {
    if (sc == 1 && sx == out_ch && n == P &&
        (reinterpret_cast<unsigned long long>(o) & (4 * sizeof(OutT) - 1)) == 0) {
      switch (out_ch) {
        case 1: store_group<OutT, 1>(o, v); break;
        case 2: store_group<OutT, 2>(o, v); break;
        case 3: store_group<OutT, 3>(o, v); break;
        default: store_group<OutT, 4>(o, v); break;
      }
      return;
    }
  }
  store_pixels(o, v, n, out_ch, sc, sx);
}

}  // namespace
