// The split divergent kernel (divergent_split.cu): K6's body and the
// composed kernel's bodies in one grid, each block running the one its
// plane's part names. divergent_split.cu holds the C entry and the
// one-level instances of uint8 and int8 outputs; divergent_split_u16.cu,
// _f16.cu and _f32.cu the one-level instances of the other output element
// types; divergent_split_nested.cu, _nested_u16.cu, _nested_f16.cu and
// _nested_f32.cu the nested ones (exec/_build.py compiles every .cu file
// in a process of its own).
//
// A divergent batch whose groups neither K6 nor the composed kernel's
// divergent plan takes alone (a ring, an image stack or resize_batch beside
// letterboxes, ROI resizes, warps of crops or top views; K6's NV12 groups
// beside image groups) is split by plane (exec/cuda_divergent_split.py):
// K6's part, laid out as K6's own launch lays a batch out (its parameter
// block from `blk`: the plane -> group table, source addresses,
// descriptors; its consts), and the composed part, laid out as the
// composed kernel's divergent batch (its block from `cm_blk`: source
// addresses, each group's values; its consts from `cm_consts`: each
// plane's head, then each plane's store row, then the tables). K6's table
// marks a plane of the composed part FOREIGN (-1): that is the part table.
// Plane z is the batch's plane z in both parts, as each part's own launch
// reads it (a ring's `first + z`, a ragged group's used_planes, the store
// into plane z of the batch's buffer); both parts cast into the batch's
// dtype with their groups' store rows.
//
// The design: grid.z = plane, so a block is one plane and its branch on
// the plane's part is uniform; a block of K6's part runs divergent_body
// (divergent_kernel.cuh: the general instance's, a group of any of the
// nine source types, one pixel a thread) and returns, one of the composed
// part copies its plane's head and store row into shared memory
// (composed.cuh::copy_plane_head) and runs the composed body of the
// launch's form: composed_body (composed.cuh) over AnyImage, 1 tap or 4,
// or nested_body (composed_nested.cuh) over AnyImage with a FusedRead2
// alone, a second resample per tap, or staged. Both bodies run under one
// blockDim (the composed form's: 64 x 4, a 16 x 16 tile with a second
// resample) and one grid (x, y); K6's body reads its pixel from the block's
// index and shape whatever they are. Instances: an output element type
// (K6's store: uint8_t, uint16_t, f16, float) x the composed part's form
// (one pixel, a resample, a FusedRead2 alone, per tap, staged): 20 in
// eight files, each launch bounded as the composed form's instance is
// (kBlocks; the staged one at 4 blocks an SM), K6's body at one pixel a
// thread (48 registers in its own instance). The static shared memory is
// the composed body's alone: K6's body has none.
//
// Numerics: both bodies', unchanged: every float op an _rn intrinsic,
// built with -fmad=false and -ftz=true, never fast math.

#pragma once

#include "composed_nested.cuh"
#include "divergent_kernel.cuh"

namespace cvgs {
// One launch's arguments, as the C entry takes them; `form` is the
// composed part's (kc::SplitForm), `head` its host words (each plane's
// head, zeros at a plane of K6's part, then each plane's store row).
struct SplitArgs {
  const int* blk;
  const int* consts;
  int ptr_off, desc_off;
  const int* cm_blk;
  const int* cm_consts;
  Conv conv;
  int form;
  int n_planes, dst_w, dst_h;
  void* out;
  int out_type, out_ch;
  long long sn, sc, sy, sx;
  cudaStream_t stream;
};
// the one-level and the nested instances of each output element type
void divergent_split_u8(const SplitArgs& a);
void divergent_split_u16(const SplitArgs& a);
void divergent_split_f16(const SplitArgs& a);
void divergent_split_f32(const SplitArgs& a);
void divergent_split_nested_u8(const SplitArgs& a);
void divergent_split_nested_u16(const SplitArgs& a);
void divergent_split_nested_f16(const SplitArgs& a);
void divergent_split_nested_f32(const SplitArgs& a);
}  // namespace cvgs

namespace {
namespace kc {

// the composed part's form; keep in step with
// exec/cuda_divergent_split.py::FORMS
enum SplitForm : int {
  SPLIT_ONE_PIXEL = 0,
  SPLIT_RESAMPLE = 1,
  SPLIT_FUSED2 = 2,
  SPLIT_PER_TAP = 3,
  SPLIT_STAGED = 4
};

#define CVGS_SPLIT_PARAMS                                                                      \
  const int* __restrict__ blk, const int* __restrict__ consts, int ptr_off, int desc_off,       \
      const int* __restrict__ cm_blk, const int* __restrict__ cm_consts, Conv conv, int dst_w, \
      int dst_h, void* __restrict__ out, int out_type, int out_ch, long long sn, long long sc,  \
      long long sy, long long sx
#define CVGS_SPLIT_ARGS                                                                    \
  blk, consts, ptr_off, desc_off, cm_blk, cm_consts, conv, dst_w, dst_h, out, out_type, out_ch, \
      sn, sc, sy, sx

// A block of K6's part (its plane's entry in K6's table not FOREIGN): K6's
// body over the plane, true; a block of the composed part: false, nothing
// done.
template <typename OutT>
__device__ __forceinline__ bool k6_block(CVGS_SPLIT_PARAMS) {
  if (__ldg(blk + blockIdx.z) < 0) return false;
  divergent_body<true, OutT, 1>(blk, consts, ptr_off, desc_off, dst_w, dst_h,
                                static_cast<OutT*>(out), out_ch, sn, sc, sy, sx);
  return true;
}

// The one-level instances: K6's body, or the composed body of T taps over
// the block's plane head.
template <typename OutT, int T>
__global__ void __launch_bounds__(kThreads, (kBlocks<AnyImage, T>)) divergent_split_kernel(
    CVGS_SPLIT_PARAMS) {
  if (k6_block<OutT>(CVGS_SPLIT_ARGS)) return;
  __shared__ CmHead h;
  int store_op = 0;
  copy_plane_head<AnyImage, kCmWords>(reinterpret_cast<int*>(&h), cm_consts, store_op);
  composed_body<AnyImage, T, 1>(nullptr, h, conv, cm_blk, cm_consts, dst_w, dst_h, out,
                                out_type, out_ch, store_op, sn, sc, sy, sx);
}

// The nested instances: K6's body, or the nested body over the block's
// plane head (kMixed: a plane whose stage2 is 0 goes per tap in the staged
// instance); a FusedRead2 alone (kR2 false) and a second resample per tap
// at the registers ptxas picks, the staged one at 4 blocks an SM, as the
// nested mixed instances are bounded.
template <typename OutT, bool kR2, bool kStage>
__device__ __forceinline__ void split_nested_body(CVGS_SPLIT_PARAMS) {
  if (k6_block<OutT>(CVGS_SPLIT_ARGS)) return;
  __shared__ CmNested n;
  int store_op = 0;
  copy_plane_head<AnyImage, kNestedWords>(reinterpret_cast<int*>(&n), cm_consts, store_op);
  nested_body<AnyImage, kR2, kStage, true>(nullptr, n, conv, cm_blk, cm_consts, dst_w, dst_h, out,
                                           out_type, out_ch, store_op, sn, sc, sy, sx);
}
template <typename OutT, bool kR2>
__global__ void __launch_bounds__(kThreads) divergent_split_nested(CVGS_SPLIT_PARAMS) {
  split_nested_body<OutT, kR2, false>(CVGS_SPLIT_ARGS);
}
template <typename OutT>
__global__ void __launch_bounds__(kThreads, 4) divergent_split_nested_staged(CVGS_SPLIT_PARAMS) {
  split_nested_body<OutT, true, true>(CVGS_SPLIT_ARGS);
}
#undef CVGS_SPLIT_PARAMS
#undef CVGS_SPLIT_ARGS

// An instance's signature, and its launch: one pixel a thread; a block of
// 256 threads, group_block's shape, or a kTile2W x kTile2H tile with a
// second resample (the nested launch's).
using SplitKernel = void (*)(const int*, const int*, int, int, const int*, const int*, Conv, int,
                             int, void*, int, int, long long, long long, long long, long long);

inline void launch_split_kernel(const cvgs::SplitArgs& a, SplitKernel kernel) {
  const bool tile = a.form == SPLIT_PER_TAP || a.form == SPLIT_STAGED;
  const dim3 block = tile ? dim3(kTile2W, kTile2H) : group_block(a.dst_w, 1);
  const dim3 grid((a.dst_w + block.x - 1) / block.x, (a.dst_h + block.y - 1) / block.y,
                  a.n_planes);
  kernel<<<grid, block, 0, a.stream>>>(a.blk, a.consts, a.ptr_off, a.desc_off, a.cm_blk,
                                       a.cm_consts, a.conv, a.dst_w, a.dst_h, a.out, a.out_type,
                                       a.out_ch, a.sn, a.sc, a.sy, a.sx);
}

// The one-level forms' launch of output element type OutT
template <typename OutT>
void launch_split(const cvgs::SplitArgs& a) {
  launch_split_kernel(a, a.form == SPLIT_ONE_PIXEL ? divergent_split_kernel<OutT, 1>
                                                   : divergent_split_kernel<OutT, 4>);
}

// The nested forms' launch of output element type OutT
template <typename OutT>
void launch_split_nested(const cvgs::SplitArgs& a) {
  launch_split_kernel(a, a.form == SPLIT_FUSED2    ? divergent_split_nested<OutT, false>
                         : a.form == SPLIT_STAGED ? divergent_split_nested_staged<OutT>
                                                  : divergent_split_nested<OutT, true>);
}

}  // namespace kc
}  // namespace
