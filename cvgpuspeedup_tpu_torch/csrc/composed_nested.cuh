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
// With a second resample whose taps a tile's pixels share (the plan's
// stage2 word, from the structure: a warp; a resize upscale), the staging
// instance (composed_kernel_nested_staged) gives a block kTile2W x kTile2H
// outputs (one a thread) and stages its footprint of the middle image.
// Beside the op tables'
// staging, a resize's footprint is built per axis by one warp each (warp
// 0 the tile's columns, warp 1 its rows): each column walked through the
// outer stages, its taps from the Resample2 tables, their span, flags and
// a ballot scan into a list of distinct positions and a map from a
// position to its index (resize_axis); a warp's is the box of the taps
// its pixels take (each thread's coordinates recomputed from the block's
// coefficients; every warp's extremes, then the box, box_axis). Each
// listed column and row is walked once through the above and the below
// stages, and for a resize core its own taps from the tables through the
// upper and the lower stages (walk_list). The block's threads evaluate
// every grid entry, listed row x listed column, once: the core's value
// (its base taps loaded, the fused read's chain, the bilerp or the warp's
// lerps), FusedRead2's chain, into shared memory as float32 lanes. After a
// barrier each thread takes its up to 4 taps from the grid through the
// maps, then the second level's lerps, the pipeline's chain and the
// store. Two to four barriers a block; each value of the core evaluated
// once a block: under a 3:1 resize one a pixel, a warp at scale 1 about
// 1.34, an upscale's taps shared (2.5x: a sixth), where each tap
// evaluated it anew (up to 4).
//
// What bounds the staging: a span of a resize's taps wider than kSpan2,
// more than kList2 positions on an axis or a grid of more than kGrid2
// floats (a warp's strong downscale, an outer fold that spreads the tile,
// a fold between the levels). Such a block evaluates the core at each of
// its pixels' taps in turn (the per-tap form) on the same loop, a
// block-uniform branch, each tap's value into the thread's slot of the
// grid; so does every block of the per-tap instance
// (composed_kernel_nested), which a plan whose stage2 word is 0 launches
// (a resize whose taps no two pixels share: staged, a 3:1 downscale took
// 1.5x as long on an H100). A held plane of a batch (z >= used_planes)
// skips both and stores the default. The host mirrors the rule
// (exec/cuda_composed.py::nested_tiles).
//
// A batch whose nested planes differ in geometry (the plan's batch word
// CM_MIXED) has each plane's CmNested in the consts, kNestedWords a plane
// from word 0; its instances (composed_kernel_nested_mixed*) copy the
// block's plane head into shared memory and run the same body over it,
// each plane with its own middle image, tap tables and stage2 (a plane
// whose stage2 is 0 takes the per-tap form in the staged instance).
//
// A divergent batch with a nested group (CM_DIVERGENT, exec/
// cuda_composed.py::build_divergent_plan) lays its planes out as such a
// batch does, each head its group's with absolute block offsets, each
// plane's store row after the heads: groups of one kind of source and one
// store row run that kind's mixed nested instances, any other batch of
// images the general ones (composed_nested_divergent.cu, AnyImage), whose
// block reads its plane's store row. Every head of one launch has one form
// (a second resample, or a FusedRead2 alone: the kR2 flag): a plane
// without a second resample beside one with it (a letterbox beside a top
// view) comes as an identity resize, weights 0 under the edge rule that
// keeps the first tap alone, stage2 0, so that its per-tap form evaluates
// its core once a pixel and the bilerp returns that value unchanged; a
// one-level plane beside FusedRead2s alone comes with an empty FusedRead2.
// The bodies are the mixed batch's, unchanged.
//
// Every rule matches exec/cuda_composed.py::composed_reference and the
// eager lowering bit for bit: the core's value is float32 (int32 bits
// converted); a tap of the second level that lies outside a below CONSTANT
// border takes its value cast to float32, then FusedRead2's chain; outside
// an above one its value cast to that chain's type without the chain; a
// warp's tap outside its source reads the warp's border value; an outer
// CONSTANT border's value (and a held plane's default) is cast to the read
// value's type (core_type). A staged value is the function of its position
// that the per-tap form computes there. Numerics as composed.cu: _rn
// intrinsics, -fmad=false, -ftz=true, a warp map's terms kept
// (warp.cuh::fmul_keep, fadd_keep).

#pragma once

#include <climits>
#include <cstddef>

#include "composed.cuh"

namespace cvgs {
void composed_nested_f32(const ComposedArgs& a);
void composed_nested_nv12(const ComposedArgs& a);
void composed_nested_any(const ComposedArgs& a);
void composed_nested_divergent(const ComposedArgs& a);
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
  int stage2;            // 1: a block stages its footprint where it fits; 0: per tap
};
constexpr int kNestedWords = kCmWords + 2 * kHeadWords + 16;
static_assert(sizeof(CmNested) == kNestedWords * 4, "all int32 words");

// The staging of a second resample; keep in step with
// exec/cuda_composed.py (TILE2, SPAN2, LIST2, GRID2) and
// tests/test_torch_composed_nested_tiling.py.
constexpr int kTile2W = 16, kTile2H = 16;  // a block's outputs, one a thread
static_assert(kTile2W * kTile2H == kThreads, "one output pixel a thread");
constexpr int kSpan2 = 256;  // the widest span of one axis's taps a block flags
constexpr int kList2 = 64;   // the most positions it lists on one axis
constexpr int kGrid2 = 4096;  // floats of its grid: listed rows x listed columns x mid_ch

// A block's footprint of the middle image and its values, in shared
// memory; axis 0 is x, 1 is y. 21.5 KB beside the three op tables' 24.
// In the per-tap form the grid holds each thread's four taps' values
// instead (slot).
struct Stage2 {
  int n[2];               // the positions listed (-1: past the budget)
  int lo[2];              // the first position of the span the map covers
  int part[kThreads / 32][4];  // a warp Resample2: each warp's least and most x, then y
  int map[2][kSpan2];     // position lo + i: its flag, then its index in the list (-1: none)
  int pos[2][kList2];     // listed position j: in the middle image, then in the core's output
  int fill[2][kList2];    // its first CONSTANT stage between the levels (kNone: none)
  int tap[2][kList2][2];  // a resize core's two taps there, walked to the base
  int tfill[2][kList2][2];  // their first CONSTANT stage under the core
  float w[2][kList2];     // the core's weight there
  float grid[kGrid2];     // the values, channel-planar: c * entries + row * n[0] + column
};
static_assert(kGrid2 >= 4 * kMaxCh * kThreads, "a slot for each thread's four taps");

// Where the per-tap form keeps channel c of tap k of thread tid.
__device__ __forceinline__ int slot(int k, int c, int tid) {
  return (k * kMaxCh + c) * kThreads + tid;
}

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

// Whether a weight is 0 as a flushed compare finds it (-ftz=true: a
// subnormal is 0; NaN is not), from its exponent's bits: compiled in the
// staging instances, `w == 0.f` here came out as 8 FSETP.NEU.OR without
// .FTZ, which chip_smoke.py's SASS census refuses.
__device__ __forceinline__ bool zero_weight(float w) {
  return (__float_as_uint(w) & 0x7f800000u) == 0u;
}

// The taps a resize takes from its weights: the first always; under the
// edge rule a weight of 0 drops the second column's or row's.
__device__ __forceinline__ unsigned resize_need(float wx, float wy, bool keep) {
  const bool ux = !(keep && zero_weight(wx)), uy = !(keep && zero_weight(wy));
  return 1u | (ux ? 2u : 0u) | (uy ? 4u : 0u) | (ux && uy ? 8u : 0u);
}

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
    t.need = resize_need(t.wx, t.wy, keep);
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

// The inner core's float32 value from its taps `tp`, whose positions are
// walked to the base already, and their fills (the first CONSTANT stage
// of each column, fx, and row, fy), into v: the one-level kernel's steps
// for one pixel of a resample (composed.cuh::composed_kernel<Src, 4, 1>):
// every load in one run (load_taps), a lower border's value cast to the
// source's type, the leading YUV -> RGB, the fused read's chain, an upper
// border's value cast to the chain's type, the sample. Every thread calls
// it (the chain's table may be staged in chunks, at barriers).
template <typename Src>
__device__ __forceinline__ void core_sample(const CmHead& h, const Conv& conv,
                                            const void* __restrict__ s,
                                            const int* __restrict__ zblk,
                                            const int* __restrict__ consts, PwRow* in_rows,
                                            bool in_once, int tid, const Taps& tp,
                                            const int (&fx)[2], const int (&fy)[2],
                                            float (&v)[kMaxCh]) {
  const float* zfblk = reinterpret_cast<const float*>(zblk);
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

// The inner core's float32 value at its output position (yc, xc), into v,
// where `on`: its taps, both axes walked through the upper and the lower
// stages (walk_taps), then core_sample. Every thread calls it.
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
  core_sample<Src>(h, conv, s, zblk, consts, in_rows, in_once, tid, tp, fx, fy, v);
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

// A second-level tap's value after the core's (in t where its fill f is
// kNone): a below CONSTANT border's value cast to float32, FusedRead2's
// chain, or an above CONSTANT border's value cast to that chain's type,
// where `on`. Every thread calls it (the chain's table may be staged in
// chunks).
__device__ __forceinline__ void mid_finish(const CmNested& n, const int* __restrict__ zblk,
                                           const int* __restrict__ consts, PwRow* mid_rows,
                                           bool mid_once, int tid, int f, bool on,
                                           float (&t)[1][kMaxCh]) {
  const float* zfblk = reinterpret_cast<const float*>(zblk);
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

// The second level's tap at position (y, x) of its source (with no
// Resample2, the pixel under the outer stages), into t where `on`: walked
// through the above and then the below stages; the core's value there,
// then mid_finish.
template <typename Src>
__device__ __forceinline__ void mid_value(const CmNested& n, const Conv& conv,
                                          const void* __restrict__ s,
                                          const int* __restrict__ zblk,
                                          const int* __restrict__ consts, PwRow* in_rows,
                                          PwRow* mid_rows, bool in_once, bool mid_once, int tid,
                                          int y, int x, bool on, float (&t)[1][kMaxCh]) {
  int xs[1] = {x}, ys[1] = {y}, fx[1] = {kNone}, fy[1] = {kNone};
  walk_axis<true>(n.above, zblk, 0, xs, fx);
  walk_axis<false>(n.above, zblk, 0, ys, fy);
  walk_axis<true>(n.below, zblk, kMaxStages, xs, fx);
  walk_axis<false>(n.below, zblk, kMaxStages, ys, fy);
  const int f = min(fx[0], fy[0]);
  core_value<Src>(n.h, conv, s, zblk, consts, in_rows, in_once, tid, ys[0], xs[0],
                  on && f == kNone, t[0]);
  mid_finish(n, zblk, consts, mid_rows, mid_once, tid, f, on, t);
}

// The listed positions n[a] of axis a (x where kX) walked by one warp,
// lane l taking entries l, l + 32, ..: through the above and then the
// below stages to the core's output, or its first CONSTANT stage there;
// for a resize core also its two taps from the host tables and the
// weight, the taps walked through the upper and the lower stages to the
// base (composed.cuh::walk_axis, as walk_taps walks them).
template <bool kX>
__device__ __forceinline__ void walk_list(Stage2& sg, const CmNested& n,
                                          const int* __restrict__ zblk,
                                          const int* __restrict__ consts, int lane, int count) {
  constexpr int a = kX ? 0 : 1;
  const CmHead& h = n.h;
  const int* tp = consts + h.taps_off;
  const float* tw = reinterpret_cast<const float*>(tp + 2 * (h.core_w + h.core_h));
  // a position's taps in the tables: x0 | x1 | y0 | y1, weights wx | wy
  const int t0 = kX ? 0 : 2 * h.core_w, t1 = kX ? h.core_w : 2 * h.core_w + h.core_h;
  const int tw0 = kX ? 0 : h.core_w;
  for (int j = lane; j < count; j += 32) {
    int p[1] = {sg.pos[a][j]}, f[1] = {kNone};
    int q[2] = {0, 0}, g[2] = {kNone, kNone};
    float w = 0.f;
    walk_axis<kX>(n.above, zblk, 0, p, f);
    walk_axis<kX>(n.below, zblk, kMaxStages, p, f);
    if (h.core == CM_RESIZE && f[0] == kNone) {
      q[0] = __ldg(tp + t0 + p[0]);
      q[1] = __ldg(tp + t1 + p[0]);
      w = __ldg(tw + tw0 + p[0]);
      walk_axis<kX>(h.upper, zblk, 0, q, g);
      walk_axis<kX>(h.lower, zblk, kMaxStages, q, g);
    }
    sg.pos[a][j] = p[0];
    sg.fill[a][j] = f[0];
    sg.tap[a][j][0] = q[0];
    sg.tap[a][j][1] = q[1];
    sg.tfill[a][j][0] = g[0];
    sg.tfill[a][j][1] = g[1];
    sg.w[a][j] = w;
  }
}

// Axis a (x where kX) of a resize Resample2's footprint, by one warp with
// no block barrier: lane l takes the tile's column (row) l inside the
// output, walks it through the outer stages (its position alone: where an
// outer CONSTANT border fills a pixel its taps are listed all the same, a
// superset) and takes its first tap and, where the edge rule keeps the
// weight, its second (the Resample2 tables); their span (a warp
// reduction), flags over it and a ballot scan list them in order and map
// each to its index; walk_list walks the list. sg.n[a] is the count, or -1
// past the budget (kSpan2, kList2).
template <bool kX>
__device__ __forceinline__ void resize_axis(Stage2& sg, const CmNested& n,
                                            const int* __restrict__ zblk,
                                            const int* __restrict__ consts, int lane, int start,
                                            int dim, int extent) {
  constexpr int a = kX ? 0 : 1;
  const int* tp = consts + n.taps2_off;
  const float* tw = reinterpret_cast<const float*>(tp + 2 * (n.core2_w + n.core2_h));
  const bool in = lane < dim && start + lane < extent;  // lane 0 always
  int q[1] = {start + lane}, f[1] = {kNone};
  walk_axis<kX>(n.h.outer, zblk, 0, q, f);
  int t0 = 0, t1 = 0;
  bool second = false;
  if (in) {
    t0 = __ldg(tp + (kX ? 0 : 2 * n.core2_w) + q[0]);
    t1 = __ldg(tp + (kX ? n.core2_w : 2 * n.core2_w + n.core2_h) + q[0]);
    second = !(n.keep_edge2 != 0 && zero_weight(__ldg(tw + (kX ? 0 : n.core2_w) + q[0])));
  }
  const int lo = __reduce_min_sync(0xffffffffu, in ? t0 : INT_MAX);
  const int span = __reduce_max_sync(0xffffffffu, in ? (second ? t1 : t0) : INT_MIN) - lo + 1;
  if (span > kSpan2) {  // positions < 2^24: no overflow
    if (lane == 0) sg.n[a] = -1;
    return;
  }
  for (int i = lane; i < span; i += 32) sg.map[a][i] = 0;
  __syncwarp();
  if (in) {
    sg.map[a][t0 - lo] = 1;
    if (second) sg.map[a][t1 - lo] = 1;
  }
  __syncwarp();
  int run = 0;
  for (int i0 = 0; i0 < span; i0 += 32) {
    const int i = i0 + lane;
    const bool flag = i < span && sg.map[a][i] != 0;
    const unsigned b = __ballot_sync(0xffffffffu, flag);
    const int j = run + __popc(b & ((1u << lane) - 1u));
    if (i < span) sg.map[a][i] = flag ? j : -1;
    if (flag && j < kList2) sg.pos[a][j] = lo + i;
    run += __popc(b);
  }
  __syncwarp();
  if (run <= kList2) walk_list<kX>(sg, n, zblk, consts, lane, run);
  if (lane == 0) {
    sg.n[a] = run <= kList2 ? run : -1;
    sg.lo[a] = lo;
  }
}

// Axis a (x where kX) of a warp Resample2's footprint, by one warp after
// the block's barrier: the box of the taps its results take, from each
// warp's minimum and maximum (sg.part), listed whole (its map the
// identity) and walked (walk_list). sg.n[a] is its side, 0 where no result
// takes a tap, -1 past kList2.
template <bool kX>
__device__ __forceinline__ void box_axis(Stage2& sg, const CmNested& n,
                                         const int* __restrict__ zblk,
                                         const int* __restrict__ consts, int lane) {
  constexpr int a = kX ? 0 : 1;
  int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    lo = min(lo, sg.part[w][2 * a]);
    hi = max(hi, sg.part[w][2 * a + 1]);
  }
  const int side = hi < lo ? 0 : hi - lo + 1;
  if (side > kList2) {
    if (lane == 0) sg.n[a] = -1;
    return;
  }
  for (int j = lane; j < side; j += 32) {
    sg.map[a][j] = j;
    sg.pos[a][j] = lo + j;
  }
  walk_list<kX>(sg, n, zblk, consts, lane, side);  // entry j: the lane that wrote it
  if (lane == 0) {
    sg.n[a] = side;
    sg.lo[a] = lo;
  }
}

// The nested kernels' body for a source of kind Src, with a second
// resampling node (kR2: staged where kStage and the footprint fits, else
// per tap) or a FusedRead2 alone above the core; one output pixel a
// thread. kMixed: `n` is the block's plane head of a mixed-geometry batch
// (in shared memory), whose stage2 word also picks the form.
template <typename Src, bool kR2, bool kStage, bool kMixed = false>
__device__ __forceinline__ void nested_body(
    const void* __restrict__ src, const CmNested& n, const Conv& conv, const int* __restrict__ blk,
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

  // the outer walk: the pixel into the second level's output
  int xc[1] = {x}, fo[1] = {held_fill};
  int yc = y;
  if (live) walk_stages(h.outer, zblk, xc, fo, yc);
  const bool sample = live && fo[0] < 0;

  float v[1][kMaxCh];
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) v[0][c] = 0.f;
  if constexpr (kR2) {
    __shared__ Stage2 sg;
    const float* zfblk = fblk + zoff;
    Taps tp;
    resample_taps(n.core2, consts + n.taps2_off, n.core2_w, n.core2_h, n.keep_edge2 != 0,
                  zfblk + n.coef2_off, n.persp2 != 0, n.mid_w, n.mid_h, yc, xc[0], sample, tp);
    // a chain's table staged in chunks holds barriers that every thread
    // reaches, so then every thread runs every round (block-uniform)
    const bool every_tap = !(in_once && mid_once);
    // the staged form in the staging instance where the footprint fits; a
    // held plane's block (block-uniform) takes neither form. The footprint
    // is built beside the tables' staging: a resize's lists by warps 0 (x)
    // and 1 (y) before the first barrier; a warp's box from each warp's
    // extremes, listed after it. A mixed batch's plane whose stage2 is 0
    // (a resize whose taps no two pixels share) goes per tap, as a block
    // past the budget does
    const bool stage = kStage && held_fill < 0 && (!kMixed || n.stage2 != 0);
    const int warp = tid >> 5, lane = tid & 31;
    if (stage) {
      if (n.core2 == CM_RESIZE) {
        if (warp == 0) {
          resize_axis<true>(sg, n, zblk, consts, lane, blockIdx.x * blockDim.x, blockDim.x, dst_w);
        } else if (warp == 1) {
          resize_axis<false>(sg, n, zblk, consts, lane, blockIdx.y * blockDim.y, blockDim.y,
                             dst_h);
        }
      } else {
        int ext[4] = {INT_MAX, INT_MIN, INT_MAX, INT_MIN};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!(tp.need >> k & 1u)) continue;
          ext[0] = min(ext[0], tp.xs[k & 1]);
          ext[1] = max(ext[1], tp.xs[k & 1]);
          ext[2] = min(ext[2], tp.ys[k >> 1]);
          ext[3] = max(ext[3], tp.ys[k >> 1]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ext[e] = e & 1 ? __reduce_max_sync(0xffffffffu, ext[e])
                         : __reduce_min_sync(0xffffffffu, ext[e]);
          if (lane == 0) sg.part[warp][e] = ext[e];
        }
      }
    }
    __syncthreads();  // the op tables, and the lists or each warp's extremes
    if (stage && n.core2 != CM_RESIZE) {
      if (warp == 0) {
        box_axis<true>(sg, n, zblk, consts, lane);
      } else if (warp == 1) {
        box_axis<false>(sg, n, zblk, consts, lane);
      }
      __syncthreads();
    }
    const int nx = stage ? sg.n[0] : -1, ny = stage ? sg.n[1] : -1;
    const bool staged = nx >= 0 && ny >= 0 && nx * ny * n.mid_ch <= kGrid2;
    const int entries = staged ? nx * ny : 0;
    const int rounds = staged ? (entries + kThreads - 1) / kThreads : held_fill < 0 ? 4 : 0;
    // one value of the middle image a round (one value's evaluation live
    // at a time, the loop not unrolled), into the grid: staged, entry r *
    // kThreads + tid at the block's walked lists; per tap, this thread's
    // tap r, walked here, into the thread's own slot (a tap its result
    // does not take costs nothing), so that no tap's value is held in
    // registers across the loop
#pragma unroll 1
    for (int r = 0; r < rounds; ++r) {
      int e = 0, xm[1], ym[1], fxm[1] = {kNone}, fym[1] = {kNone}, i = 0, j = 0;
      bool on;
      if (staged) {
        e = r * kThreads + tid;
        on = e < entries;
        i = on ? e / nx : 0;
        j = on ? e - i * nx : 0;
        xm[0] = sg.pos[0][j];
        ym[0] = sg.pos[1][i];
        fxm[0] = sg.fill[0][j];
        fym[0] = sg.fill[1][i];
      } else {
        on = tp.need >> r & 1u;
        xm[0] = tp.xs[r & 1];
        ym[0] = tp.ys[r >> 1];
        walk_axis<true>(n.above, zblk, 0, xm, fxm);
        walk_axis<false>(n.above, zblk, 0, ym, fym);
        walk_axis<true>(n.below, zblk, kMaxStages, xm, fxm);
        walk_axis<false>(n.below, zblk, kMaxStages, ym, fym);
      }
      if (!on && !every_tap) continue;
      const int f = min(fxm[0], fym[0]);
      const bool core_on = on && f == kNone;
      // the core's taps: a resize's from the block's lists where staged,
      // else from the position (walk_taps)
      Taps ct;
      int cfx[2], cfy[2];
      if (staged && h.core == CM_RESIZE) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          ct.xs[k] = sg.tap[0][j][k];
          ct.ys[k] = sg.tap[1][i][k];
          cfx[k] = sg.tfill[0][j][k];
          cfy[k] = sg.tfill[1][i][k];
        }
        ct.wx = sg.w[0][j];
        ct.wy = sg.w[1][i];
        ct.need = core_on ? resize_need(ct.wx, ct.wy, h.keep_edge != 0) : 0u;
      } else {
        resample_taps(h.core, consts + h.taps_off, h.core_w, h.core_h, h.keep_edge != 0,
                      zfblk + h.coef_off, h.persp != 0, h.in_w, h.in_h, ym[0], xm[0], core_on,
                      ct);
        walk_taps(h, zblk, ct.xs, cfx, ct.ys, cfy);
      }
      float u[1][kMaxCh];
      core_sample<Src>(h, conv, s, zblk, consts, in_rows, in_once, tid, ct, cfx, cfy, u[0]);
      mid_finish(n, zblk, consts, mid_rows, mid_once, tid, f, on, u);
      if (on) {
#pragma unroll
        for (int c = 0; c < kMaxCh; ++c) {
          if (c < n.mid_ch) sg.grid[staged ? c * entries + e : slot(r, c, tid)] = u[0][c];
        }
      }
    }
    if (staged) __syncthreads();
    // each tap the result takes: staged, from the grid through the axes'
    // maps; per tap, from the thread's slot; a tap it does not take holds 0
    float t[4][1][kMaxCh];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = staged && sample && (tp.need >> k & 1u)
                        ? sg.map[1][tp.ys[k >> 1] - sg.lo[1]] * nx +
                              sg.map[0][tp.xs[k & 1] - sg.lo[0]]
                        : 0;
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) {
        t[k][0][c] = 0.f;
        if (sample && (tp.need >> k & 1u) && c < n.mid_ch) {
          t[k][0][c] = sg.grid[staged ? c * entries + e : slot(k, c, tid)];
        }
      }
    }
    if (sample) {
      sample_taps(n.core2, n.keep_edge2 != 0, n.mid_type, tp, t, zfblk + n.border2_off, n.mid_ch,
                  v[0]);
    }
  } else {
    __syncthreads();  // the op tables
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

// The nested kernels: a FusedRead2 alone (kR2 false) and a second resample
// per tap, at the registers ptxas picks (the per-tap form 63 on an H100,
// 4 blocks an SM); a second resample staged (composed_kernel_nested_staged)
// bounded to 4 blocks an SM, 64 registers: left to itself ptxas gave the
// staging code 128 (2 blocks an SM), 30-55 % slower on N1-N3, N6 and N8
// (PERF.md, PR 19). Two instances with a second resample, so that the
// per-tap form pays nothing for the staging's registers.
#define CVGS_NESTED_PARAMS                                                                     \
  const void* __restrict__ src, CmNested n, Conv conv, const int* __restrict__ blk,            \
      const int* __restrict__ consts, int dst_w, int dst_h, void* __restrict__ out, int out_type, \
      int out_ch, int store_op, long long sn, long long sc, long long sy, long long sx
#define CVGS_NESTED_ARGS \
  src, n, conv, blk, consts, dst_w, dst_h, out, out_type, out_ch, store_op, sn, sc, sy, sx
template <typename Src, bool kR2>
__global__ void __launch_bounds__(kThreads) composed_kernel_nested(CVGS_NESTED_PARAMS) {
  nested_body<Src, kR2, false>(CVGS_NESTED_ARGS);
}
template <typename Src>
__global__ void __launch_bounds__(kThreads, 4) composed_kernel_nested_staged(CVGS_NESTED_PARAMS) {
  nested_body<Src, true, true>(CVGS_NESTED_ARGS);
}
#undef CVGS_NESTED_PARAMS
#undef CVGS_NESTED_ARGS

// A mixed-geometry batch's nested instances, the same three: the block's
// plane head (kNestedWords consts words at blockIdx.z * kNestedWords,
// 1056 bytes) copied into shared memory, then the body over it; the staged
// one (launched where any plane's stage2 is 1) takes the per-tap form on a
// plane whose stage2 is 0. Static shared memory of the staged one: the
// head, Stage2 and the three op tables, 47,792 bytes, under the 48 KB of a
// static allocation, 4 blocks an SM. A divergent batch's general instances
// (Src AnyImage, which runs no other batch) take their plane's store row,
// consts word gridDim.z * kNestedWords + blockIdx.z, as the launch's
// store_op, in a register: no shared memory more.
#define CVGS_NESTED_MIXED_PARAMS                                                              \
  const void* __restrict__ src, Conv conv, const int* __restrict__ blk,                        \
      const int* __restrict__ consts, int dst_w, int dst_h, void* __restrict__ out, int out_type, \
      int out_ch, int store_op, long long sn, long long sc, long long sy, long long sx
template <typename Src, bool kR2, bool kStage>
__device__ __forceinline__ void nested_mixed_body(CVGS_NESTED_MIXED_PARAMS) {
  __shared__ CmNested n;
  // composed.cuh::copy_plane_head's loop, kept here: called through it, these
  // instances compiled to other SASS (the split kernel's nested instances
  // call it)
  const int* rec = consts + (long long)blockIdx.z * kNestedWords;
  int* words = reinterpret_cast<int*>(&n);
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < kNestedWords;
       i += blockDim.x * blockDim.y) {
    words[i] = __ldg(rec + i);
  }
  if constexpr (std::is_same_v<Src, AnyImage>) {
    store_op = __ldg(consts + (long long)gridDim.z * kNestedWords + blockIdx.z);
  }
  __syncthreads();
  nested_body<Src, kR2, kStage, true>(src, n, conv, blk, consts, dst_w, dst_h, out, out_type,
                                      out_ch, store_op, sn, sc, sy, sx);
}
#define CVGS_NESTED_MIXED_ARGS \
  src, conv, blk, consts, dst_w, dst_h, out, out_type, out_ch, store_op, sn, sc, sy, sx
template <typename Src, bool kR2>
__global__ void __launch_bounds__(kThreads) composed_kernel_nested_mixed(
    CVGS_NESTED_MIXED_PARAMS) {
  nested_mixed_body<Src, kR2, false>(CVGS_NESTED_MIXED_ARGS);
}
template <typename Src>
__global__ void __launch_bounds__(kThreads, 4) composed_kernel_nested_mixed_staged(
    CVGS_NESTED_MIXED_PARAMS) {
  nested_mixed_body<Src, true, true>(CVGS_NESTED_MIXED_ARGS);
}
#undef CVGS_NESTED_MIXED_PARAMS
#undef CVGS_NESTED_MIXED_ARGS

// The nested launch for a source of kind Src: one pixel a thread, a block
// of 256 threads: a kTile2W x kTile2H tile with a second resample (its
// footprint's shape near scale 1 is square), staged where the plan's
// stage2 word asks for it (a mixed-geometry or divergent batch: any
// plane's), else group_block's shape for one pixel a thread.
template <typename Src>
void launch_nested(const ComposedArgs& a) {
  CmNested n;
  std::memcpy(&n, a.head, sizeof(CmNested));
  const dim3 block = n.core2 == CM_NONE ? group_block(a.dst_w, 1) : dim3(kTile2W, kTile2H);
  const dim3 grid((a.dst_w + block.x - 1) / block.x, (a.dst_h + block.y - 1) / block.y,
                  a.n_planes);
  if (n.h.batch == CM_MIXED || n.h.batch == CM_DIVERGENT) {  // each plane's head in the consts
    bool stage = false;
    for (int z = 0; z < a.n_planes; ++z) {
      stage = stage || a.head[(long long)z * kNestedWords + offsetof(CmNested, stage2) / 4] != 0;
    }
    auto* mixed = n.core2 == CM_NONE ? composed_kernel_nested_mixed<Src, false>
                  : stage            ? composed_kernel_nested_mixed_staged<Src>
                                     : composed_kernel_nested_mixed<Src, true>;
    mixed<<<grid, block, 0, a.stream>>>(a.src, a.conv, a.blk, a.consts, a.dst_w, a.dst_h, a.out,
                                        a.out_type, a.out_ch, a.store_op, a.sn, a.sc, a.sy, a.sx);
    return;
  }
  // a divergent batch's general instances are mixed ones alone
  if constexpr (!std::is_same_v<Src, AnyImage>) {
    auto* kernel = n.core2 == CM_NONE ? composed_kernel_nested<Src, false>
                   : n.stage2 != 0    ? composed_kernel_nested_staged<Src>
                                      : composed_kernel_nested<Src, true>;
    kernel<<<grid, block, 0, a.stream>>>(a.src, n, a.conv, a.blk, a.consts, a.dst_w, a.dst_h,
                                         a.out, a.out_type, a.out_ch, a.store_op, a.sn, a.sc, a.sy,
                                         a.sx);
  }
}

}  // namespace kc
}  // namespace

namespace {

// The C entries' checks of one plane's nested head (composed_nested.cu,
// divergent_split.cu), the words the launch does not set: the inner
// level's (head_ok), a resampling core, and the second level's words.
inline bool nested_ok(const kc::CmNested& n) {
  const CmHead& h = n.h;
  return head_ok(h) && (h.core == CM_RESIZE || h.core == CM_WARP) && n.above.n_stages >= 0 &&
         n.above.n_stages <= kMaxStages && n.below.n_stages >= 0 &&
         n.below.n_stages <= kMaxStages && n.core2 >= CM_NONE && n.core2 <= CM_WARP &&
         n.mid_ch >= 1 && n.mid_ch <= kMaxCh && n.mid_type >= PW_U8 && n.mid_type <= PW_I32 &&
         n.mid_n_ops >= 0 && n.core2_h >= 1 && n.core2_w >= 1 && n.mid_h >= 1 && n.mid_w >= 1 &&
         n.stage2 >= 0 && n.stage2 <= 1;
}

// Whether nested plane head b of a divergent batch runs in the launch of
// plane head a: what picks the instance alone (same_instance's words, and
// a second resample where a has one: the kR2 flag), not same_nested's
// structure.
inline bool same_nested_instance(const kc::CmNested& a, const kc::CmNested& b) {
  return same_instance(a.h, b.h) && (a.core2 == CM_NONE) == (b.core2 == CM_NONE);
}

}  // namespace
