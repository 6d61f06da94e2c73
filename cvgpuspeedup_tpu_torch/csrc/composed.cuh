// The composed-read kernel's head and its tap reader.
//
// A launch reads, from the output inwards: the outer stages (crops and
// borders above the core), the core (a resize over host tap tables, a warp
// whose coordinates are recomputed from the block's coefficients, or one
// pixel), the upper stages (between the core and a fused read), the lower
// stages (between the fused read and the base) and the base (one frame or
// an NV12/NV21 buffer). Each stage list rides a PwHead, so pointwise.cuh's
// walk_stages walks it as the pointwise kernel walks its own; the lower
// list's PwHead also describes the base, so read_base_row reads it, and
// carries the fused read's leading YUV -> RGB (conv_first, limited).
//
// Every rule matches exec/cuda_composed.py::composed_reference and the
// eager lowering bit for bit:
//   a tap's position walks the upper stages, then the lower ones; a lower
//   CONSTANT border gives its value cast to the source's type, which then
//   goes through the fused read's chain; an upper one gives its value cast
//   to the chain's type (tap_type), without the chain;
//   an outer CONSTANT border gives its value cast to the core's type
//   (core_type: float32 after a resample, else tap_type).

#pragma once

#include "chain.cuh"
#include "frame_resize.cuh"
#include "pointwise.cuh"
#include "pointwise_chain.cuh"
#include "warp.cuh"

namespace {

// keep every code in step with exec/cuda_composed.py
enum : int { CM_NONE = 0, CM_RESIZE = 1, CM_WARP = 2 };  // cores

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
  int batch;           // crop_batch: per-plane addresses at word 0, origins 2 words per plane
  int in_n_ops, in_ops_off, in_fp_off;    // the fused read's chain: rows, table, scalars
  int out_n_ops, out_ops_off, out_fp_off;  // the pipeline's chain
};
constexpr int kCmWords = 3 * kHeadWords + 20;
static_assert(sizeof(CmHead) == kCmWords * 4, "all int32 words");

// The T taps at positions (ys[k], xs[k]) of the core's source into t, before
// the fused read's chain (every lane written, 0 where nothing is read): the
// upper walk, the lower walk, the base's pixel (or a lower CONSTANT border's
// value cast to the source's type), a leading YUV -> RGB. fill_up[k] is the
// block offset of the upper CONSTANT border tap k lies outside of, else -1.
// A tap whose bit in `need` is clear, or that an upper border fills, reads
// nothing.
template <int T>
__device__ __forceinline__ void read_taps(const CmHead& h, const void* __restrict__ src,
                                          const int* __restrict__ blk, const Conv& conv,
                                          const int (&ys)[T], const int (&xs)[T], unsigned need,
                                          float (&t)[T][kMaxCh], int (&fill_up)[T]) {
  const float* fblk = reinterpret_cast<const float*>(blk);
#pragma unroll
  for (int k = 0; k < T; ++k) {
    int x[1] = {xs[k]}, fu[1] = {-1}, fl[1] = {-1};
    int y = ys[k];
    walk_stages(h.upper, blk, x, fu, y);
    walk_stages(h.lower, blk, x, fl, y);
    const unsigned read = (need >> k & 1u) && fl[0] < 0 && fu[0] < 0;
    float v[1][kMaxCh];
    read_base_row<kMaxCh, 1, false>(h.lower, src, 0, y, x, read, v);
    if (fl[0] >= 0) {
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) {
        if (c < h.lower.nch) v[0][c] = cast_to_type(__ldg(fblk + fl[0] + c), h.lower.src_type);
      }
    }
    if (h.lower.conv_first) yuv_to_rgb(v[0][0], v[0][1], v[0][2], conv, v[0]);
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) t[k][c] = v[0][c];
    fill_up[k] = fu[0];
  }
}

}  // namespace
