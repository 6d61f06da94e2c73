// The pointwise chain interpreter and the helpers the port's kernels share.
//
// A chain is a table of rows [code, param offset, param stride, aux] built
// once per pipeline structure by exec/cuda_batch_resize.py::encode_chain,
// over a float32 parameter block. Values live in 32-bit float registers, up
// to kMaxCh channels; the encoder tracks the running dtype and channel count
// statically, so an integer value is saturated after each op, a float16
// value rounded, and a colour conversion may change the channel count.
// uint8, int8, uint16, int16, float16 and float32 values are exact in a
// float32 register, and one float32 +, -, * or / of two float16 values
// rounded to float16 is the float16 operation (24 >= 2 * 11 + 2 bits), so
// every kernel runs those chains in float32. An int32 value, which float32
// does not hold past 2^24, lives in the register as its 32 bits
// (__int_as_float): reorders and stores move the bits, and an op on it is
// three rows, as ops/arithmetic.py computes it: OP_I32_F32, the float32 op,
// OP_SAT_I32.
//
// Float -> integer rows convert as XLA does, whatever the value: NaN to 0,
// then saturated to the destination's range (cvt.rni / cvt.rzi saturate to
// int32 and map NaN to 0; a narrower range is an integer clamp after them).
// Integer -> integer Casts keep the low bits.
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

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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
  OP_SAT_I8 = 11,    // round half to even, clamp to [-128, 127]
  OP_SAT_U16 = 12,   // ... to [0, 65535]
  OP_SAT_I16 = 13,   // ... to [-32768, 32767]
  OP_CAST_I8 = 14,   // truncate, keep the low 8 bits, sign-extended
  OP_CAST_U16 = 15,  // truncate, keep the low 16 bits
  OP_CAST_I16 = 16,  // truncate, keep the low 16 bits, sign-extended
  OP_CAST_F16 = 17,  // round to the nearest float16, ties to even, overflow to +-inf
  OP_GRAY_F16 = 18,  // OP_GRAY_F32 in float16: constants, products and sums rounded
  // an op on a float16 value: its scalar rounded to float16 first, as
  // ops/arithmetic.py casts it to the value's dtype; an OP_CAST_F16 row
  // follows and rounds the result
  OP_MUL_F16 = 19,
  OP_ADD_F16 = 20,
  OP_SUB_F16 = 21,
  OP_DIV_F16 = 22,
  // a Cast of a float value: truncate, saturate to the range, NaN to 0
  OP_TRUNC_U8 = 23,
  OP_TRUNC_I8 = 24,
  OP_TRUNC_U16 = 25,
  OP_TRUNC_I16 = 26,
  OP_TRUNC_I32 = 27,  // ... into int32's bits; exact for a value of a narrower integer
  OP_SAT_I32 = 28,    // round half to even, saturate, NaN to 0, into int32's bits
  OP_I32_F32 = 29,    // int32's bits to the nearest float32
  // a Cast of int32's bits into a narrower integer: keep the low bits
  OP_WRAP_U8 = 30,
  OP_WRAP_I8 = 31,
  OP_WRAP_U16 = 32,
  OP_WRAP_I16 = 33,
  OP_GRAY_I32 = 34,   // OP_GRAY_U8 on int32's bits: products and sums wrap in int32
  OP_ALPHA_I32 = 35,  // append a channel holding aux's bits (int32's maximum)
};

// float32(0.299), float32(0.587), float32(0.114), as ops/color.py rounds them
constexpr float kGrayR = 0x1.322d0ep-2f;
constexpr float kGrayG = 0x1.2c8b44p-1f;
constexpr float kGrayB = 0x1.d2f1aap-4f;
// float16(0.299), float16(0.587), float16(0.114)
constexpr float kGrayR16 = 0x1.324p-2f;
constexpr float kGrayG16 = 0x1.2c8p-1f;
constexpr float kGrayB16 = 0x1.d3p-4f;

// v rounded to the nearest float16 (ties to even, overflow to +-inf), as a
// float32: Tensor.to(float16)
__device__ __forceinline__ float round_f16(float v) { return __half2float(__float2half_rn(v)); }

// A float16 element: its bits. Loads and stores convert through the
// cuda_fp16 intrinsics, so no kernel relies on __half's own conversions.
struct f16 {
  unsigned short bits;
};

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

// Byte i of w as an element of the 1-byte type SrcT: zero- or sign-extended.
template <typename SrcT>
__device__ __forceinline__ float byte_as(unsigned w, int i) {
  if constexpr (std::is_same_v<SrcT, int8_t>) {
    return (float)(int)(signed char)(w >> (8 * i));
  } else {
    return byte_of(w, i);
  }
}

// An int64 element as the pointwise kernel reads it: its low 32 bits as
// int32's bits, the register an int32 chain holds, so a copy keeps them.
struct i64_bits {
  long long v;
};

// An element's value as a float32 (exact for every element type of 32 bits
// or fewer), and one element at p loaded through the read-only cache and
// converted. A 64-bit source is read as its canonical 32-bit type (the
// reference runs with 64-bit values off, utils/dtypes.py::canonical_dtype):
// an int64 value keeps its low 32 bits, read as an int32 source is
// (cvt.rn.f32.s32), and a float64 value rounds to nearest (cvt.rn.f32.f64),
// keeping a float32 subnormal, as jnp.asarray does. That conversion is
// written in PTX: under -ftz=true the compiler would emit its .ftz form,
// which flushes the subnormal a copy must keep.
template <typename T>
__device__ __forceinline__ float to_f32(T e) {
  return (float)e;
}
__device__ __forceinline__ float to_f32(f16 e) { return __half2float(__ushort_as_half(e.bits)); }
__device__ __forceinline__ float to_f32(long long e) { return __int2float_rn((int)e); }
__device__ __forceinline__ float to_f32(double e) {
  float f;
  asm("cvt.rn.f32.f64 %0, %1;" : "=f"(f) : "d"(e));
  return f;
}
__device__ __forceinline__ float to_f32(i64_bits e) { return __int_as_float((int)e.v); }
template <typename T>
__device__ __forceinline__ T ld_elem(const T* __restrict__ p) {
  return __ldg(p);
}
__device__ __forceinline__ f16 ld_elem(const f16* __restrict__ p) {
  return f16{__ldg(reinterpret_cast<const unsigned short*>(p))};
}
__device__ __forceinline__ i64_bits ld_elem(const i64_bits* __restrict__ p) {
  return i64_bits{__ldg(reinterpret_cast<const long long*>(p))};
}
template <typename T>
__device__ __forceinline__ float ldf(const T* __restrict__ p) {
  return to_f32(ld_elem(p));
}

// One pixel's nch values at p, element by element.
template <typename SrcT>
__device__ __forceinline__ void load_pixel(const SrcT* __restrict__ p, int nch,
                                           float (&v)[kMaxCh]) {
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) {
    if (c < nch) v[c] = ldf(p + c);
  }
}

// The element types of a source or an output buffer; keep in step with
// exec/cuda_batch_resize.py::TYPE_CODES and SRC_CODES. PW_I64 and PW_F64
// are sources only: no kernel stores 64 bits.
enum : int {
  PW_U8 = 0,
  PW_I8 = 1,
  PW_U16 = 2,
  PW_I16 = 3,
  PW_F32 = 4,
  PW_F16 = 5,
  PW_I32 = 6,
  PW_I64 = 7,
  PW_F64 = 8
};

// A kernel stores through one of four element types: uint8_t for a uint8
// or an int8 buffer, uint16_t for a uint16 or an int16 one, f16, and float
// for a float32 or an int32 one (the register's 32 bits, which an int32
// chain holds as its bits). An integer store truncates the value and keeps
// its low bits, which is the integer itself for a value in the buffer's range
// and wraps one outside it, as an integer converts into a narrower one; a
// float16 store rounds to nearest even. What a buffer of another dtype needs
// first is one row after the chain (the store row,
// exec/cuda_batch_resize.py::store_cast).
template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ uint8_t to_out<uint8_t>(float v) { return (uint8_t)__float2int_rz(v); }
template <>
__device__ __forceinline__ uint16_t to_out<uint16_t>(float v) {
  return (uint16_t)__float2int_rz(v);
}
template <>
__device__ __forceinline__ f16 to_out<f16>(float v) {
  return f16{__half_as_ushort(__float2half_rn(v))};
}

// The bits of a 2-byte output element.
__device__ __forceinline__ unsigned short bits16(uint16_t e) { return e; }
__device__ __forceinline__ unsigned short bits16(f16 e) { return e.bits; }

// ops/cast.py::Cast of an integer value held as a float32 into uint8:
// truncate (exact), keep the low 8 bits (OP_CAST_U8)
__device__ __forceinline__ float cast_u8(float v) { return (float)(__float2int_rz(v) & 255); }

// ops/cast.py::SaturateCast: round half to even, saturate to [lo, hi], NaN
// to 0 (cvt.rni saturates to int32 and maps NaN to 0); the integer's float
// is never -0
__device__ __forceinline__ float saturate(float v, int lo, int hi) {
  return (float)clampi(__float2int_rn(v), lo, hi);
}

// A row that converts each lane on its own (every saturate, truncate, wrap
// and int32 row; run_chain runs OP_SAT_U8 and OP_CAST_U8 inline), also the
// store row a kernel runs before a store of another dtype, on every lane:
// one loop per kind of row, the row's range, width and sign as operands, so
// a one-lane instance of 16 pixels unrolls five loops, not fifteen. The wrapping loops keep a type's low bits by a shift left, then
// right (an arithmetic shift sign-extends the signed types). A lane at or
// above the value's channel count holds a value no store reads.
template <int P, int L>
__device__ __forceinline__ void run_integer_row(int code, float (&v)[P][L]) {
  enum { kSat, kTrunc, kWrap, kToBits, kFromBits };
  int kind = kSat, lo = 0, hi = 255, shift = 24;
  bool sign = false, bits = false, rn = false;
  switch (code) {
    case OP_SAT_U8: break;
    case OP_SAT_I8: lo = -128, hi = 127; break;
    case OP_SAT_U16: hi = 65535; break;
    case OP_SAT_I16: lo = -32768, hi = 32767; break;
    case OP_TRUNC_U8: kind = kTrunc; break;
    case OP_TRUNC_I8: kind = kTrunc, lo = -128, hi = 127; break;
    case OP_TRUNC_U16: kind = kTrunc, hi = 65535; break;
    case OP_TRUNC_I16: kind = kTrunc, lo = -32768, hi = 32767; break;
    case OP_CAST_U8: kind = kWrap; break;
    case OP_CAST_I8: kind = kWrap, sign = true; break;
    case OP_CAST_U16: kind = kWrap, shift = 16; break;
    case OP_CAST_I16: kind = kWrap, sign = true, shift = 16; break;
    case OP_WRAP_U8: kind = kWrap, bits = true; break;
    case OP_WRAP_I8: kind = kWrap, bits = true, sign = true; break;
    case OP_WRAP_U16: kind = kWrap, bits = true, shift = 16; break;
    case OP_WRAP_I16: kind = kWrap, bits = true, sign = true, shift = 16; break;
    case OP_TRUNC_I32: kind = kToBits; break;
    case OP_SAT_I32: kind = kToBits, rn = true; break;
    case OP_I32_F32: kind = kFromBits; break;
    default: return;  // not a row of this kind: the callers name each code
  }
  if (kind == kSat) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int c = 0; c < L; ++c) v[p][c] = saturate(v[p][c], lo, hi);
    }
  } else if (kind == kTrunc) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int c = 0; c < L; ++c) v[p][c] = (float)clampi(__float2int_rz(v[p][c]), lo, hi);
    }
  } else if (kind == kWrap) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int c = 0; c < L; ++c) {
        const int i = bits ? __float_as_int(v[p][c]) : __float2int_rz(v[p][c]);
        const unsigned t = (unsigned)i << shift;
        v[p][c] = sign ? (float)((int)t >> shift) : (float)(t >> shift);
      }
    }
  } else if (kind == kToBits) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int c = 0; c < L; ++c) {
        v[p][c] = __int_as_float(rn ? __float2int_rn(v[p][c]) : __float2int_rz(v[p][c]));
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int c = 0; c < L; ++c) v[p][c] = __int2float_rn(__float_as_int(v[p][c]));
    }
  }
}

// OP_GRAY_U8 (kBits false: channels held as float32 values) or OP_GRAY_I32
// (kBits: int32's bits) of the channels at aux bits 0, 4, 8, into v[0]:
// OpenCV's 15-bit fixed point in int32, whose products and sums wrap, as
// ops/color.py computes them, and an arithmetic shift.
template <bool kBits>
__device__ __forceinline__ void gray_int(float (&v)[kMaxCh], int aux) {
  const float r = pick(v, aux & 15), g = pick(v, (aux >> 4) & 15), b = pick(v, (aux >> 8) & 15);
  if constexpr (kBits) {
    const unsigned acc = (unsigned)__float_as_int(r) * 9798u +
                         (unsigned)__float_as_int(g) * 19235u +
                         (unsigned)__float_as_int(b) * 3735u + (1u << 14);
    v[0] = __int_as_float((int)acc >> 15);
  } else {
    const int acc = (int)r * 9798 + (int)g * 19235 + (int)b * 3735 + (1 << 14);
    v[0] = (float)(acc >> 15);
  }
}

// OP_GRAY_F32 (float32 constants, no rounding between ops) or OP_GRAY_F16
// (float16 constants, each product and sum rounded to float16) of the
// channels at aux bits 0, 4, 8, into v[0].
template <bool kHalf>
__device__ __forceinline__ void gray_float(float (&v)[kMaxCh], int aux) {
  const float r = pick(v, aux & 15), g = pick(v, (aux >> 4) & 15), b = pick(v, (aux >> 8) & 15);
  if constexpr (kHalf) {
    const float s = round_f16(__fadd_rn(round_f16(__fmul_rn(r, kGrayR16)),
                                        round_f16(__fmul_rn(g, kGrayG16))));
    v[0] = round_f16(__fadd_rn(s, round_f16(__fmul_rn(b, kGrayB16))));
  } else {
    v[0] = __fadd_rn(__fadd_rn(__fmul_rn(r, kGrayR), __fmul_rn(g, kGrayG)), __fmul_rn(b, kGrayB));
  }
}

// OP_CAST_F16 on every lane.
template <int P, int L>
__device__ __forceinline__ void round_row(float (&v)[P][L]) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int c = 0; c < L; ++c) v[p][c] = round_f16(v[p][c]);
  }
}

// Runs the chain on the P pixels of v, each holding ch channels; returns the
// channel count after the chain. An op row is decoded once for all P pixels
// and a per-channel scalar is loaded once per channel, so a kernel that
// gives a thread several pixels pays the table once.
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
      case OP_ALPHA_I32: {
        const float a = code == OP_ALPHA ? (float)aux : __int_as_float(aux);
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
          for (int c = 0; c < kMaxCh; ++c) {
            if (c == ch) v[p][c] = a;
          }
        }
        ++ch;
        break;
      }
      case OP_GRAY_U8:
#pragma unroll
        for (int p = 0; p < P; ++p) gray_int<false>(v[p], aux);
        ch = 1;
        break;
      case OP_GRAY_I32:
#pragma unroll
        for (int p = 0; p < P; ++p) gray_int<true>(v[p], aux);
        ch = 1;
        break;
      case OP_GRAY_F32:
#pragma unroll
        for (int p = 0; p < P; ++p) gray_float<false>(v[p], aux);
        ch = 1;
        break;
      case OP_GRAY_F16:
#pragma unroll
        for (int p = 0; p < P; ++p) gray_float<true>(v[p], aux);
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
#define CVGS_ARITH_F16(FN)                                                 \
  _Pragma("unroll") for (int c = 0; c < kMaxCh; ++c) {                     \
    if (c >= ch) continue;                                                 \
    const float q = round_f16(__ldg(fp + off + c * stride));               \
    _Pragma("unroll") for (int p = 0; p < P; ++p) v[p][c] = FN(v[p][c], q); \
  }                                                                        \
  break;
      case OP_MUL_F16: CVGS_ARITH_F16(__fmul_rn)
      case OP_ADD_F16: CVGS_ARITH_F16(__fadd_rn)
      case OP_SUB_F16: CVGS_ARITH_F16(__fsub_rn)
      case OP_DIV_F16: CVGS_ARITH_F16(__fdiv_rn)
#undef CVGS_ARITH_F16
      case OP_SAT_U8:
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
          for (int c = 0; c < kMaxCh; ++c) {
            if (c < ch) v[p][c] = saturate(v[p][c], 0, 255);
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
      case OP_SAT_I8:
      case OP_SAT_U16:
      case OP_SAT_I16:
      case OP_CAST_I8:
      case OP_CAST_U16:
      case OP_CAST_I16:
      case OP_TRUNC_U8:
      case OP_TRUNC_I8:
      case OP_TRUNC_U16:
      case OP_TRUNC_I16:
      case OP_TRUNC_I32:
      case OP_SAT_I32:
      case OP_I32_F32:
      case OP_WRAP_U8:
      case OP_WRAP_I8:
      case OP_WRAP_U16:
      case OP_WRAP_I16:
        run_integer_row(code, v);
        break;
      case OP_CAST_F16:
        round_row(v);
        break;
      default:  // every code of exec/cuda_batch_resize.py is named above
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
        make_ushort4(bits16(to_out<OutT>(a)), bits16(to_out<OutT>(b)), bits16(to_out<OutT>(c)),
                     bits16(to_out<OutT>(d)));
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
