// The pointwise kernel's own chain interpreter: the op table staged once per
// block through shared memory, then run from there by every thread.
//
// chain.cuh::run_chain decodes a row per thread from device memory: four
// loads of the row with 64-bit addresses, a 16-way switch, and per channel a
// predicate on the runtime channel count, an address and a load of the
// scalar, about 60 instructions for 4 useful ones. Here the block's threads
// resolve the rows together, once, into 32-byte records (PwRow): the code,
// the channel count the row sees, aux, and the row's four scalars already
// read from the block (lane c is fp[off + c * stride] for c < ch, 0 above).
// A thread then pays per row one or two broadcast shared loads and a
// warp-uniform branch, arithmetic codes first. Rows are staged in chunks of
// kStageRows, so a chain of any length runs.
//
// A thread holds L lanes per pixel: L = 1 for a chain whose widest point is
// one channel (exec/cuda_pointwise.py computes that width and each row's
// channel count; both ride the op table after its sentinel), else L = 4. The
// 4-lane form runs arithmetic, saturate and truncate rows on all four lanes
// with no per-channel predicate: a lane at or above the row's channel count
// holds a value no store reads, and OP_ALPHA overwrites it before it becomes
// live (a reorder and a gray row only read lanes below the count).
//
// Numerics: each row's ops in the table's order on the row's scalars, each
// an _rn intrinsic (the library is built with -fmad=false), as the plain
// version's ops round them.

#pragma once

#include "chain.cuh"

namespace {

// One staged row: 32 bytes. Lane 0's scalar sits beside the code, so a
// one-lane row is one 8-byte load; a four-lane row adds one 16-byte load for
// an arithmetic code.
struct alignas(16) PwRow {
  int code;
  float q0;
  int aux;
  int ch;  // channels of the value the row takes
  float q1, q2, q3;
  int pad;
};
static_assert(sizeof(PwRow) == 32, "two 16-byte words");

// rows per staging chunk: 8 KB of shared memory per block
constexpr int kStageRows = 256;

// Rows [k0, k0 + m) of the table into rows[0, m), by the block's `threads`
// threads together, this one `tid`. `ops` holds 4 * n_ops words, the sentinel, then
// each row's channel count; fp is the block's chain scalars.
__device__ __forceinline__ void stage_rows(PwRow* rows, const int* __restrict__ ops, int n_ops,
                                           int k0, int m, const float* __restrict__ fp, int tid,
                                           int threads) {
  const int* __restrict__ chs = ops + 4 * n_ops + 1;
  for (int k = tid; k < m; k += threads) {
    const int r = k0 + k;
    int code = __ldg(ops + 4 * r);
    const int off = __ldg(ops + 4 * r + 1);
    const int stride = __ldg(ops + 4 * r + 2);
    const int ch = __ldg(chs + r);
    float q[kMaxCh] = {0.f, 0.f, 0.f, 0.f};
    if (code >= OP_MUL_F16 && code <= OP_DIV_F16) {  // on a float16 value: its scalars rounded
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) {
        if (c < ch) q[c] = round_f16(__ldg(fp + off + c * stride));
      }
      code -= OP_MUL_F16 - OP_MUL;
    } else if (code >= OP_MUL && code <= OP_DIV) {
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) {
        if (c < ch) q[c] = __ldg(fp + off + c * stride);
      }
    }
    rows[k] = PwRow{code, q[0], __ldg(ops + 4 * r + 3), ch, q[1], q[2], q[3], 0};
  }
}

// Runs the m staged rows on the P pixels of v (L lanes each).
template <int P, int L>
__device__ __forceinline__ void run_rows(float (&v)[P][L], const PwRow* rows, int m) {
#pragma unroll 1  // one row's scalars live at a time
  for (int k = 0; k < m; ++k) {
    int code, aux = 0, ch = 0;
    float q[L];
    if constexpr (L == 1) {
      const int2 head = *reinterpret_cast<const int2*>(rows + k);
      code = head.x;
      q[0] = __int_as_float(head.y);
    } else {
      const int4 head = *reinterpret_cast<const int4*>(rows + k);
      code = head.x, aux = head.z, ch = head.w;
      q[0] = __int_as_float(head.y);
      if (code <= OP_DIV) {
        const float4 t = *reinterpret_cast<const float4*>(&rows[k].q1);
        q[1] = t.x, q[2] = t.y, q[3] = t.z;
      }
    }
#define CVGS_ROW(FN)                                                                   \
  _Pragma("unroll") for (int p = 0; p < P; ++p) {                                      \
    _Pragma("unroll") for (int c = 0; c < L; ++c) v[p][c] = FN(v[p][c], q[c]);         \
  }
    if (code == OP_MUL) {
      CVGS_ROW(__fmul_rn)
    } else if (code == OP_ADD) {
      CVGS_ROW(__fadd_rn)
    } else if (code == OP_SUB) {
      CVGS_ROW(__fsub_rn)
    } else if (code == OP_DIV) {
      CVGS_ROW(__fdiv_rn)
#undef CVGS_ROW
    } else if (code == OP_REORDER) {
      // a one-lane chain holds no reorder but the identity
      if constexpr (L == kMaxCh) {
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float t[kMaxCh];
#pragma unroll
          for (int c = 0; c < kMaxCh; ++c) t[c] = v[p][c];
#pragma unroll
          for (int c = 0; c < kMaxCh; ++c) v[p][c] = pick(t, (aux >> (4 * c)) & 15);
        }
      }
    } else if (code == OP_ALPHA || code == OP_ALPHA_I32) {
      if constexpr (L == kMaxCh) {
        const float a = code == OP_ALPHA ? (float)aux : __int_as_float(aux);
#pragma unroll
        for (int p = 0; p < P; ++p) {
#pragma unroll
          for (int c = 0; c < kMaxCh; ++c) {
            if (c == ch) v[p][c] = a;
          }
        }
      }
    } else if (code == OP_GRAY_U8) {
      if constexpr (L == kMaxCh) {
#pragma unroll
        for (int p = 0; p < P; ++p) gray_int<false>(v[p], aux);
      }
    } else if (code == OP_GRAY_I32) {
      if constexpr (L == kMaxCh) {
#pragma unroll
        for (int p = 0; p < P; ++p) gray_int<true>(v[p], aux);
      }
    } else if (code == OP_GRAY_F32) {
      if constexpr (L == kMaxCh) {
#pragma unroll
        for (int p = 0; p < P; ++p) gray_float<false>(v[p], aux);
      }
    } else if (code == OP_GRAY_F16) {
      if constexpr (L == kMaxCh) {
#pragma unroll
        for (int p = 0; p < P; ++p) gray_float<true>(v[p], aux);
      }
    } else if (code == OP_CAST_F16) {
      round_row(v);
    } else {
      // OP_SAT_U8 .. OP_SAT_I16, OP_CAST_U8 .. OP_CAST_I16, OP_TRUNC_U8 ..
      // OP_TRUNC_I32, OP_SAT_I32, OP_I32_F32, OP_WRAP_U8 .. OP_WRAP_I16: each
      // named in run_integer_row's switch, which leaves any other code alone
      run_integer_row(code, v);
    }
  }
}

}  // namespace
