// The pointwise chain interpreter and the helpers the port's kernels share.
//
// A chain is a table of rows [code, param offset, param stride, aux] built
// once per pipeline structure by exec/cuda_batch_resize.py::encode_chain,
// over a float32 parameter block. Values live in float32 registers, up to
// kMaxCh channels; the encoder tracks the running dtype and channel count
// statically, so a uint8 value is saturated after each op and a colour
// conversion may change the channel count.
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

template <typename OutT>
__device__ __forceinline__ OutT to_out(float v);
template <>
__device__ __forceinline__ float to_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ uint8_t to_out<uint8_t>(float v) {
  return (uint8_t)__float2int_rz(v);  // the chain left an exact value in [0, 255]
}

// Runs the chain on v, which holds ch channels; returns the channel count
// after the chain.
__device__ __forceinline__ int run_chain(float (&v)[kMaxCh], int ch, const int* __restrict__ ops,
                                         int n_ops, const float* __restrict__ fp) {
  for (int k = 0; k < n_ops; ++k) {
    const int code = __ldg(ops + 4 * k);
    const int off = __ldg(ops + 4 * k + 1);
    const int stride = __ldg(ops + 4 * k + 2);
    const int aux = __ldg(ops + 4 * k + 3);
    if (code == OP_REORDER) {
      float t[kMaxCh];
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) t[c] = v[c];
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) v[c] = pick(t, (aux >> (4 * c)) & 15);
      ch = aux >> 16;
      continue;
    }
    if (code == OP_ALPHA) {
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) {
        if (c == ch) v[c] = (float)aux;
      }
      ++ch;
      continue;
    }
    if (code == OP_GRAY_U8 || code == OP_GRAY_F32) {
      const float r = pick(v, aux & 15);
      const float g = pick(v, (aux >> 4) & 15);
      const float b = pick(v, (aux >> 8) & 15);
      if (code == OP_GRAY_U8) {
        const int acc = (int)r * 9798 + (int)g * 19235 + (int)b * 3735 + (1 << 14);
        v[0] = (float)(acc >> 15);
      } else {
        v[0] = __fadd_rn(__fadd_rn(__fmul_rn(r, kGrayR), __fmul_rn(g, kGrayG)),
                         __fmul_rn(b, kGrayB));
      }
      ch = 1;
      continue;
    }
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) {
      if (c >= ch) continue;
      float r = v[c];
      switch (code) {
        case OP_MUL: r = __fmul_rn(r, __ldg(fp + off + c * stride)); break;
        case OP_ADD: r = __fadd_rn(r, __ldg(fp + off + c * stride)); break;
        case OP_SUB: r = __fsub_rn(r, __ldg(fp + off + c * stride)); break;
        case OP_DIV: r = __fdiv_rn(r, __ldg(fp + off + c * stride)); break;
        case OP_SAT_U8:
          r = rintf(r);
          r = r < 0.f ? 0.f : (r > 255.f ? 255.f : r);
          break;
        case OP_CAST_U8: r = (float)(__float2int_rz(r) & 255); break;
        default: break;
      }
      v[c] = r;
    }
  }
  return ch;
}

}  // namespace
