// The composed-read kernel's nested instances (composed_nested*.cu): a read
// with a second level above the core, from the output inwards
//
//   outer* [Resample2] above* [FusedRead2] below* core
//   core := Resample(upper* [FusedRead] lower* base)
//
// resize(warp(..)), warp(resize(..)), resize(resize(..)),
// resize(crop(resize(..))) and make_border(fuse(resize(..), op)) in one
// launch. composed_nested.cu instantiates it for uint8 images and holds
// the C entry (cvgs_composed_nested); composed_nested_f32.cu for float32
// and int32 images, composed_nested_nv12.cu for NV12/NV21 buffers and
// composed_nested_any.cu for the six other source types.
//
// The head (CmNested) is the one-level kernel's CmHead for the inner
// level (its lower and upper stage lists, the core, the fused read's chain;
// its outer list is the plane's outer stages, its core_type the read
// value's type, its pipeline chain and batch words the launch's), then
// the above and below stage lists and the second level's words. The 12
// one-level instances of composed.cuh and their CmHead are untouched.
//
// The design is the simple one: a thread takes one output pixel, walks it
// through the outer stages, computes Resample2's taps (host tables, or the
// warp's coordinates recomputed from the block's coefficients over the
// middle image) and, for each tap its result takes (one to four, in turn),
// walks the above and then the below stages to a position of the core's
// output and evaluates the core there with the one-level kernel's steps
// (walk_taps, load_taps, the fused read's chain, the bilerp or the warp's
// lerps): 1 to 16 base taps a pixel. Then FusedRead2's chain per tap, the
// second level's lerps, the pipeline's chain and the store. Staging a
// block's footprint of the core's output in shared memory is the later,
// fast design (ROADMAP §2).
//
// Every rule matches exec/cuda_composed.py::composed_reference and the
// eager lowering bit for bit: the core's value is float32 (int32 bits
// converted); a tap of the second level that lies outside a below CONSTANT
// border takes its value cast to float32, then FusedRead2's chain; outside
// an above one its value cast to that chain's type without the chain; a
// warp's tap outside its source reads the warp's border value; an outer
// CONSTANT border's value (and a held plane's default) is cast to the read
// value's type (core_type). Numerics as composed.cu: _rn intrinsics,
// -fmad=false, -ftz=true, a warp map's terms kept (warp.cuh::fmul_keep,
// fadd_keep).

#pragma once

#include "composed.cuh"

namespace cvgs {
void composed_nested_f32(const ComposedArgs& a);
void composed_nested_nv12(const ComposedArgs& a);
void composed_nested_any(const ComposedArgs& a);
}  // namespace cvgs

namespace {
namespace kc {

// The head of a nested launch; the host fills it from the plan
// (exec/cuda_composed.py::ComposedPlan.head, _MID_WORDS).
struct CmNested {
  CmHead h;       // the inner level, the outer stages, the pipeline's chain
  PwHead above;   // n_stages and st only: the stages between Resample2 and FusedRead2
  PwHead below;   // n_stages and st only: the stages between FusedRead2 and the core
  int core2;      // CM_RESIZE, CM_WARP, or CM_NONE: FusedRead2 alone
  int core2_h, core2_w;  // the second level's output
  int mid_h, mid_w;      // its source: the core's output through below, FusedRead2, above
  int keep_edge2;        // resize: the edge rule for its source's size
  int persp2;            // warp: a 3x3 map
  int coef2_off;         // warp: block offset of its 9 coefficients
  int border2_off;       // warp: block offset of its border (mid_ch floats)
  int taps2_off;         // resize: consts offset of x0 | x1 | y0 | y1 | wx | wy
  int mid_type, mid_ch;  // a second-level tap's type and channels after FusedRead2's chain
  int mid_n_ops, mid_ops_off, mid_fp_off;  // FusedRead2's chain: rows, table, scalars
};
constexpr int kNestedWords = kCmWords + 2 * kHeadWords + 15;
static_assert(sizeof(CmNested) == kNestedWords * 4, "all int32 words");

// A resample's taps at its output position (yc, xc): the columns xs and the
// rows ys of v00, v01, v10, v11 (column k & 1, row k >> 1), the weights,
// and the taps the result takes (need, bit k for tap k): a resize's from
// the host tables at `tp` (under the edge rule a weight of 0 keeps the
// first tap alone), a warp's from its coefficients `coef` over a source of
// in_w x in_h (a tap outside it is not taken: it reads the border). With
// `on` false no tap is taken and nothing is read.
struct Taps {
  int xs[2], ys[2];
  float wx, wy;
  unsigned need;
};

__device__ __forceinline__ void resample_taps(int core, const int* __restrict__ tp, int core_w,
                                              int core_h, bool keep,
                                              const float* __restrict__ coef, bool persp,
                                              int in_w, int in_h, int yc, int xc, bool on,
                                              Taps& t) {
  t.xs[0] = t.xs[1] = t.ys[0] = t.ys[1] = 0;
  t.wx = t.wy = 0.f;
  t.need = 0u;
  if (!on) return;
  if (core == CM_RESIZE) {
    const float* tw = reinterpret_cast<const float*>(tp + 2 * (core_w + core_h));
    t.xs[0] = __ldg(tp + xc);
    t.xs[1] = __ldg(tp + core_w + xc);
    t.ys[0] = __ldg(tp + 2 * core_w + yc);
    t.ys[1] = __ldg(tp + 2 * core_w + core_h + yc);
    t.wx = __ldg(tw + xc);
    t.wy = __ldg(tw + core_w + yc);
    const bool ux = !(keep && t.wx == 0.f), uy = !(keep && t.wy == 0.f);
    t.need = 1u | (ux ? 2u : 0u) | (uy ? 4u : 0u) | (ux && uy ? 8u : 0u);
  } else {
    const int xa[1] = {xc};
    float sx[1], sy[1];
    map_coords(coef, persp, xa, yc, sx, sy);
    const float fw = (float)in_w, fh = (float)in_h;  // exact: sides < 2^24
    const float x0f = floorf(sx[0]), y0f = floorf(sy[0]);
    t.wx = __fsub_rn(sx[0], x0f);
    t.wy = __fsub_rn(sy[0], y0f);
    const bool vx0 = x0f >= 0.f && x0f < fw, vx1 = x0f >= -1.f && x0f < fw - 1.f;
    const bool vy0 = y0f >= 0.f && y0f < fh, vy1 = y0f >= -1.f && y0f < fh - 1.f;
    t.xs[0] = vx0 ? (int)x0f : 0;
    t.xs[1] = vx1 ? (int)x0f + 1 : 0;
    t.ys[0] = vy0 ? (int)y0f : 0;
    t.ys[1] = vy1 ? (int)y0f + 1 : 0;
    t.need = (unsigned)(vy0 && vx0) | (unsigned)(vy0 && vx1) << 1 |
             (unsigned)(vy1 && vx0) << 2 | (unsigned)(vy1 && vx1) << 3;
  }
}

// The four taps' values, float32 (int32 bits converted), sampled: a
// resize's bilerp with its edge rule, or a warp's lerps with a tap it does
// not take reading `border` (ch channels).
__device__ __forceinline__ void sample_taps(int core, bool keep, int tap_type, const Taps& tp,
                                            float (&t)[4][1][kMaxCh],
                                            const float* __restrict__ border, int ch,
                                            float (&v)[kMaxCh]) {
  if (tap_type == PW_I32) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) t[k][0][c] = __int2float_rn(__float_as_int(t[k][0][c]));
    }
  }
  if (core == CM_RESIZE) {
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) {
      v[c] = bilerp_values(t[0][0][c], t[1][0][c], t[2][0][c], t[3][0][c], tp.wx, tp.wy, keep);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (tp.need >> k & 1u) continue;
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) {
      if (c < ch) t[k][0][c] = __ldg(border + c);
    }
  }
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) {
    v[c] = lerp_rn(lerp_rn(t[0][0][c], t[1][0][c], tp.wx), lerp_rn(t[2][0][c], t[3][0][c], tp.wx),
                   tp.wy);
  }
}

// The inner core's float32 value at its output position (yc, xc), into v,
// where `on`: the one-level kernel's steps for one pixel of a resample
// (composed.cuh::composed_kernel<Src, 4, 1>): the taps, both axes through
// the upper and the lower stages (walk_taps), every load in one run
// (load_taps), a lower border's value cast to the source's type, the
// leading YUV -> RGB, the fused read's chain, an upper border's value cast
// to the chain's type, the sample. Every thread calls it (the chain's
// table may be staged in chunks, at barriers).
template <typename Src>
__device__ __forceinline__ void core_value(const CmHead& h, const Conv& conv,
                                           const void* __restrict__ s,
                                           const int* __restrict__ zblk,
                                           const int* __restrict__ consts, PwRow* in_rows,
                                           bool in_once, int tid, int yc, int xc, bool on,
                                           float (&v)[kMaxCh]) {
  const float* zfblk = reinterpret_cast<const float*>(zblk);
  Taps tp;
  resample_taps(h.core, consts + h.taps_off, h.core_w, h.core_h, h.keep_edge != 0,
                zfblk + h.coef_off, h.persp != 0, h.in_w, h.in_h, yc, xc, on, tp);
  int fx[2], fy[2];
  walk_taps(h, zblk, tp.xs, fx, tp.ys, fy);
  int ty[4], tx[4], fl[4];
  unsigned rd = 0u;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int f = min(fx[k & 1], fy[k >> 1]);
    tx[k] = tp.xs[k & 1];
    ty[k] = tp.ys[k >> 1];
    fl[k] = f;
    if ((tp.need >> k & 1u) && f == kNone) rd |= 1u << k;
  }
  TapRegs<Src, 4> regs;
  load_taps<true>(h, s, ty, tx, rd, regs);
  float t[4][1][kMaxCh];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) t[k][0][c] = 0.f;
    if (!(tp.need >> k & 1u)) continue;
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) t[k][0][c] = regs.lane(k, c);
    if (fl[k] >= kMaxStages && fl[k] < kNone) {
      const int off = fill_offset(h, fl[k]);
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) {
        if (c < h.lower.nch) t[k][0][c] = cast_to_type(__ldg(zfblk + off + c), h.lower.src_type);
      }
    }
    if (h.lower.conv_first) yuv_to_rgb(t[k][0][0], t[k][0][1], t[k][0][2], conv, t[k][0]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    run_table(t[k], in_rows, in_once, consts + h.in_ops_off, h.in_n_ops, zfblk + h.in_fp_off, tid,
              tp.need >> k & 1u);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (!(tp.need >> k & 1u) || fl[k] >= kMaxStages) continue;
    const int off = fill_offset(h, fl[k]);
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) {
      if (c < h.tap_ch) t[k][0][c] = cast_to_type(__ldg(zfblk + off + c), h.tap_type);
    }
  }
  sample_taps(h.core, h.keep_edge != 0, h.tap_type, tp, t, zfblk + h.border_off, h.tap_ch, v);
}

// The block offset of the value of fill stage f of the second level: an
// above border's for f below kMaxStages, else a below one's (f < kNone).
__device__ __forceinline__ int mid_fill_offset(const CmNested& n, int f) {
  int off = 0;
#pragma unroll
  for (int k = 0; k < kMaxStages; ++k) {
    if (f == k) off = n.above.st[k].c;
    if (f == kMaxStages + k) off = n.below.st[k].c;
  }
  return off;
}

// The second level's tap at position (y, x) of Resample2's source (or, with
// no Resample2, at the pixel under the outer stages), into t where `on`:
// walked through the above and then the below stages; the core's value
// there, or a below CONSTANT border's value cast to float32; FusedRead2's
// chain; or an above CONSTANT border's value cast to that chain's type.
template <typename Src>
__device__ __forceinline__ void mid_value(const CmNested& n, const Conv& conv,
                                          const void* __restrict__ s,
                                          const int* __restrict__ zblk,
                                          const int* __restrict__ consts, PwRow* in_rows,
                                          PwRow* mid_rows, bool in_once, bool mid_once, int tid,
                                          int y, int x, bool on, float (&t)[1][kMaxCh]) {
  const float* zfblk = reinterpret_cast<const float*>(zblk);
  int xs[1] = {x}, ys[1] = {y}, fx[1] = {kNone}, fy[1] = {kNone};
  walk_axis<true>(n.above, zblk, 0, xs, fx);
  walk_axis<false>(n.above, zblk, 0, ys, fy);
  walk_axis<true>(n.below, zblk, kMaxStages, xs, fx);
  walk_axis<false>(n.below, zblk, kMaxStages, ys, fy);
  const int f = min(fx[0], fy[0]);
  core_value<Src>(n.h, conv, s, zblk, consts, in_rows, in_once, tid, ys[0], xs[0],
                  on && f == kNone, t[0]);
  if (on && f >= kMaxStages && f < kNone) {
    const int off = mid_fill_offset(n, f);
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) {
      if (c < n.h.tap_ch) t[0][c] = cast_to_type(__ldg(zfblk + off + c), PW_F32);
    }
  }
  run_table(t, mid_rows, mid_once, consts + n.mid_ops_off, n.mid_n_ops, zfblk + n.mid_fp_off, tid,
            on && f >= kMaxStages);
  if (on && f < kMaxStages) {
    const int off = mid_fill_offset(n, f);
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) {
      if (c < n.mid_ch) t[0][c] = cast_to_type(__ldg(zfblk + off + c), n.mid_type);
    }
  }
}

// The nested kernel for a source of kind Src, with a second resampling
// node (kR2) or a FusedRead2 alone above the core; one output pixel a
// thread.
template <typename Src, bool kR2>
__global__ void __launch_bounds__(kThreads) composed_kernel_nested(
    const void* __restrict__ src, CmNested n, Conv conv, const int* __restrict__ blk,
    const int* __restrict__ consts, int dst_w, int dst_h, void* __restrict__ out, int out_type,
    int out_ch, int store_op, long long sn, long long sc, long long sy, long long sx) {
  __shared__ PwRow in_rows[kStageRows];
  __shared__ PwRow mid_rows[kStageRows];
  __shared__ PwRow out_rows[kStageRows];
  const CmHead& h = n.h;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const bool live = x < dst_w && y < dst_h;
  const float* fblk = reinterpret_cast<const float*>(blk);
  const int zoff = z * h.plane_stride;
  const int* zblk = blk + zoff;
  // a plane past used_planes reads nothing: its pixels start with the
  // default's offset as their fill, as the one-level kernel's do
  const int held_fill =
      h.used_off >= 0 && z >= __ldg(blk + h.used_off) ? h.default_off - zoff : -1;
  const void* s = src;
  if (h.batch) {
    s = reinterpret_cast<const void*>(__ldg(reinterpret_cast<const unsigned long long*>(blk) + z));
  }

  // the op tables staged first where each fits in one chunk
  const bool in_once = h.in_n_ops <= kStageRows, mid_once = n.mid_n_ops <= kStageRows,
             out_once = h.out_n_ops <= kStageRows;
  if (in_once) {
    stage_rows(in_rows, consts + h.in_ops_off, h.in_n_ops, 0, h.in_n_ops,
               fblk + zoff + h.in_fp_off, tid, kThreads);
  }
  if (mid_once) {
    stage_rows(mid_rows, consts + n.mid_ops_off, n.mid_n_ops, 0, n.mid_n_ops,
               fblk + zoff + n.mid_fp_off, tid, kThreads);
  }
  if (out_once) {
    stage_rows(out_rows, consts + h.out_ops_off, h.out_n_ops, 0, h.out_n_ops,
               fblk + h.out_fp_off, tid, kThreads);
  }
  __syncthreads();

  // the outer walk: the pixel into the second level's output
  int xc[1] = {x}, fo[1] = {held_fill};
  int yc = y;
  if (live) walk_stages(h.outer, zblk, xc, fo, yc);
  const bool sample = live && fo[0] < 0;

  float v[1][kMaxCh];
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) v[0][c] = 0.f;
  if constexpr (kR2) {
    Taps tp;
    resample_taps(n.core2, consts + n.taps2_off, n.core2_w, n.core2_h, n.keep_edge2 != 0,
                  fblk + zoff + n.coef2_off, n.persp2 != 0, n.mid_w, n.mid_h, yc, xc[0], sample,
                  tp);
    // each tap the result takes, in turn (one tap's core evaluation live
    // at a time, the loop not unrolled); a tap it does not take costs
    // nothing, unless a chain's table is staged in chunks, whose barriers
    // every thread reaches (block-uniform)
    const bool every_tap = !(in_once && mid_once);
    float t[4][1][kMaxCh];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) t[k][0][c] = 0.f;
    }
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
      const bool take = tp.need >> k & 1u;
      if (!take && !every_tap) continue;
      float u[1][kMaxCh];
      mid_value<Src>(n, conv, s, zblk, consts, in_rows, mid_rows, in_once, mid_once, tid,
                     tp.ys[k >> 1], tp.xs[k & 1], take, u);
      // into tap k's registers: each select on a constant index, so that
      // t is not indexed at run time (local memory)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < kMaxCh; ++c) t[j][0][c] = j == k ? u[0][c] : t[j][0][c];
      }
    }
    if (sample) {
      sample_taps(n.core2, n.keep_edge2 != 0, n.mid_type, tp, t, fblk + zoff + n.border2_off,
                  n.mid_ch, v[0]);
    }
  } else {
    float u[1][kMaxCh];
    mid_value<Src>(n, conv, s, zblk, consts, in_rows, mid_rows, in_once, mid_once, tid, yc, xc[0],
                   sample, u);
    if (sample) {
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) v[0][c] = u[0][c];
    }
  }
  if (live && !sample) {
    // an outer CONSTANT border's value, or a held plane's default, cast to
    // the read value's type
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) {
      if (c < n.mid_ch) v[0][c] = cast_to_type(__ldg(fblk + zoff + fo[0] + c), h.core_type);
    }
  }

  // the pipeline's chain
  run_table(v, out_rows, out_once, consts + h.out_ops_off, h.out_n_ops, fblk + h.out_fp_off, tid,
            live);
  if (!live) return;
  if (store_op) run_integer_row(store_op, v);
  store_typed(out, out_type, (long long)z * sn + (long long)y * sy + (long long)x * sx, v, 1,
              out_ch, sc, sx);
}

// The nested launch for a source of kind Src: one pixel a thread, a block
// of 256 threads (group_block's shape for one pixel a thread).
template <typename Src>
void launch_nested(const ComposedArgs& a) {
  CmNested n;
  std::memcpy(&n, a.head, sizeof(CmNested));
  const dim3 block = group_block(a.dst_w, 1);
  const dim3 grid((a.dst_w + block.x - 1) / block.x, (a.dst_h + block.y - 1) / block.y,
                  a.n_planes);
#define CVGS_NESTED(R2)                                                                   \
  composed_kernel_nested<Src, R2><<<grid, block, 0, a.stream>>>(a.src, n, a.conv, a.blk, a.consts, \
                                                       a.dst_w, a.dst_h, a.out, a.out_type, \
                                                       a.out_ch, a.store_op, a.sn, a.sc, a.sy, \
                                                       a.sx)
  if (n.core2 == CM_NONE) {
    CVGS_NESTED(false);
  } else {
    CVGS_NESTED(true);
  }
#undef CVGS_NESTED
}

}  // namespace kc
}  // namespace
