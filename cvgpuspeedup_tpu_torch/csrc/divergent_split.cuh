// The split divergent kernel (divergent_split.cu): K6's body and the
// composed kernel's bodies in one grid, each block running the one its
// part names. divergent_split.cu holds the C entry and the one-level
// instances whose composed part reads uint8 images; divergent_split_any.cu
// the one-level instances of any other composed part; divergent_split_nested.cu
// and divergent_split_nested_any.cu the nested ones (exec/_build.py compiles
// every .cu file in a process of its own).
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
// marks a plane of the composed part FOREIGN (-1). Plane z is the batch's
// plane z in both parts, as each part's own launch reads it (a ring's
// `first + z`, a ragged group's used_planes, the store into plane z of the
// batch's buffer); both parts cast into the batch's dtype with their
// groups' store rows.
//
// The design: each part runs as it runs in its own launch, in one grid.
//  - One grid of two block lists: a 1-D grid of 256-thread blocks, K6's
//    part's blocks first, then the composed part's (2.4-7.9 % faster on
//    DK1-DK4 than the composed part's first, PERF.md §6).
//    Each part has its own tiles (SplitPart): K6's part group_block's 64 x
//    4 at one pixel a thread, the composed part its form's tile (the same,
//    or kTile2W x kTile2H with a second resample). A block finds its part,
//    its plane and its tile by arithmetic on the counts (part_tile), reads
//    the plane's id from its part's plane list (`lists`: K6's planes in
//    order, then the composed part's) and runs its part's body at that
//    place (chain.cuh::Place, a tile width fixed by the instance): K6's
//    read (divergent_kernel.cuh::divergent_values), composed_body_at or
//    nested_body_at, each the text of its own launch's body included with
//    the place given (K6's and the composed kernel's instances compile from
//    their text as before).
//  - K6's part (k6_part) runs K6's general read (a group of any of the nine
//    source types) at one pixel a thread. Its own launch's 4 pixels, as a
//    walk of one-pixel steps, cost DK2 3.8 % (PERF.md §6). Its store
//    reads the output's element type at run time (composed.cuh::store_typed).
//  - The composed part copies its plane's head (and, over AnyImage, its
//    store row) into shared memory (split_plane_head) and runs the body of
//    the launch's form and source kind: the one-level body of 1 or 4 taps,
//    or the nested body with a FusedRead2 alone, a second resample per tap,
//    or staged; over uint8_t (packed taps, 4 blocks an SM, the launch's one
//    store row) where every group of the part reads uint8 images with one
//    store row, as composed.cu's C entry picks the uint8 mixed instances,
//    else over AnyImage.
// Instances: the composed part's form (one pixel, a resample, a FusedRead2
// alone, per tap, staged) x its source kind (uint8, AnyImage): 10 in four
// files, each launch bounded as the composed form's instance is (kBlocks;
// the staged one at 4 blocks an SM). The static shared memory is the
// composed body's alone: K6's body has none.
//
// Numerics: both bodies', unchanged: every float op an _rn intrinsic,
// built with -fmad=false and -ftz=true, never fast math.

#pragma once

#include "composed_nested.cuh"
#include "divergent_kernel.cuh"

namespace {
// One part's blocks in a launch: its planes (their ids at word `list` of
// the plane lists), each cut into `tiles` tiles, tiles_x of them across, of
// the part's block shape (K6's part group_block's 64 x 4, the composed part
// its form's). Keep in step with exec/cuda_divergent_split.py::SplitPlan.tiles.
struct SplitPart {
  int planes, tiles_x, tiles, list;
};
}  // namespace

namespace cvgs {
// One launch's arguments, as the C entry takes them; `form` is the
// composed part's (kc::SplitForm), `store_op` its one store row where it
// runs the uint8 body (else 0: the AnyImage body reads each plane's).
struct SplitArgs {
  const int* blk;
  const int* consts;
  int ptr_off, desc_off;
  const int* cm_blk;
  const int* cm_consts;
  const int* lists;
  SplitPart k6, cm;
  Conv conv;
  int form;
  int n_planes, dst_w, dst_h;
  void* out;
  int out_type, out_ch, store_op;
  long long sn, sc, sy, sx;
  cudaStream_t stream;
};
// the one-level and the nested instances of each composed source kind
void divergent_split_u8(const SplitArgs& a);
void divergent_split_any(const SplitArgs& a);
void divergent_split_nested_u8(const SplitArgs& a);
void divergent_split_nested_any(const SplitArgs& a);
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

// a tile's width in threads: group_block's 64 x 4 at one pixel a thread
// (K6's part, and the composed part but with a second resample)
constexpr unsigned kGroupW = 64;

#define CVGS_SPLIT_PARAMS                                                                       \
  const int* __restrict__ blk, const int* __restrict__ consts, int ptr_off, int desc_off,        \
      const int* __restrict__ cm_blk, const int* __restrict__ cm_consts,                         \
      const int* __restrict__ lists, SplitPart k6, SplitPart cm, Conv conv, int n_planes,        \
      int dst_w, int dst_h, void* __restrict__ out, int out_type, int out_ch, int store_op,      \
      long long sn, long long sc, long long sy, long long sx
#define CVGS_SPLIT_ARGS                                                                       \
  blk, consts, ptr_off, desc_off, cm_blk, cm_consts, lists, k6, cm, conv, n_planes, dst_w,    \
      dst_h, out, out_type, out_ch, store_op, sn, sc, sy, sx

// The plane and the tile of block `local` of part p: the plane's id from
// the part's list, the tile (bx, by) of its p.tiles_x x (p.tiles / p.tiles_x).
__device__ __forceinline__ void part_tile(const SplitPart& p, int local,
                                          const int* __restrict__ lists, unsigned& z,
                                          unsigned& bx, unsigned& by) {
  const int plane = local / p.tiles, t = local - plane * p.tiles;
  const int row = t / p.tiles_x;
  z = (unsigned)__ldg(lists + p.list + plane);
  bx = (unsigned)(t - row * p.tiles_x);
  by = (unsigned)row;
}

// The place of this thread of a 256-thread block in a tile of BW threads
// across, as a launch of that block shape gives it
template <unsigned BW>
__device__ __forceinline__ Place tile_place(unsigned z, unsigned bx, unsigned by) {
  return {z, bx, by, BW, kThreads / BW, threadIdx.x % BW, threadIdx.x / BW};
}

// K6's part at place pl: K6's general read of the thread's pixel
// (divergent_kernel.cuh::divergent_values), stored into the output's
// element type, read at run time (composed.cuh::store_typed).
__device__ __forceinline__ void k6_part(CVGS_SPLIT_PARAMS, const Place& pl) {
  const int x = pl.bx * pl.bw + pl.tx;
  const int y = pl.by * pl.bh + pl.ty;
  if (x >= dst_w || y >= dst_h) return;
  const void* base;
  Desc d;
  plane_loads(blk, ptr_off, desc_off, pl.z, base, d);
  float v[1][kMaxCh];
  divergent_values<true, 1>(blk, consts, dst_w, dst_h, x, y, pl.z, 1, base, d, v);
  store_typed(out, out_type, (long long)pl.z * sn + (long long)y * sy + (long long)x * sx, v, 1,
              out_ch, sc, sx);
}

// Block blockIdx.x's part: K6's (its pixels done, true) or the composed
// part's (false, its place in pl, in tiles of BW x (256 / BW) threads).
// K6's part's blocks come first in the grid.
template <unsigned BW>
__device__ __forceinline__ bool k6_block(CVGS_SPLIT_PARAMS, Place& pl) {
  const int b = blockIdx.x;
  const int k6_blocks = k6.planes * k6.tiles;
  unsigned z, bx, by;
  if (b < k6_blocks) {
    part_tile(k6, b, lists, z, bx, by);
    k6_part(CVGS_SPLIT_ARGS, tile_place<kGroupW>(z, bx, by));
    return true;
  }
  part_tile(cm, b - k6_blocks, lists, z, bx, by);
  pl = tile_place<BW>(z, bx, by);
  return false;
}

// The composed part's plane head at place pl, as composed.cuh's
// copy_plane_head copies it: its kWords consts words into `words`, in
// shared memory, by the block's threads, then a barrier; over AnyImage its
// store row, consts word n_planes * kWords + pl.z (a head and a row for
// each plane of the batch), as the launch's store_op.
template <typename Src, int kWords>
__device__ __forceinline__ void split_plane_head(int* words, const int* __restrict__ cm_consts,
                                                 int& store_op, const Place& pl, int n_planes) {
  const int* rec = cm_consts + (long long)pl.z * kWords;
  for (int i = threadIdx.x; i < kWords; i += kThreads) words[i] = __ldg(rec + i);
  if constexpr (std::is_same_v<Src, AnyImage>) {
    store_op = __ldg(cm_consts + (long long)n_planes * kWords + pl.z);
  }
  __syncthreads();
}

// The one-level instances: K6's part, or the composed body of T taps over
// the block's plane head.
template <typename Src, int T>
__global__ void __launch_bounds__(kThreads, (kBlocks<Src, T>)) divergent_split_kernel(
    CVGS_SPLIT_PARAMS) {
  Place pl;
  if (k6_block<kGroupW>(CVGS_SPLIT_ARGS, pl)) return;
  __shared__ CmHead h;
  split_plane_head<Src, kCmWords>(reinterpret_cast<int*>(&h), cm_consts, store_op, pl, n_planes);
  composed_body_at<Src, T, 1>(nullptr, h, conv, cm_blk, cm_consts, dst_w, dst_h, out, out_type,
                              out_ch, store_op, sn, sc, sy, sx, pl);
}

// The nested instances: K6's part, or the nested body over the block's
// plane head (kMixed: a plane whose stage2 is 0 goes per tap in the staged
// instance); a FusedRead2 alone (kR2 false) and a second resample per tap
// at the registers ptxas picks, the staged one at 4 blocks an SM, as the
// nested mixed instances are bounded.
template <typename Src, bool kR2, bool kStage>
__device__ __forceinline__ void split_nested_body(CVGS_SPLIT_PARAMS) {
  Place pl;
  if (k6_block<kR2 ? kTile2W : kGroupW>(CVGS_SPLIT_ARGS, pl)) return;
  __shared__ CmNested n;
  split_plane_head<Src, kNestedWords>(reinterpret_cast<int*>(&n), cm_consts, store_op, pl,
                                      n_planes);
  nested_body_at<Src, kR2, kStage, true>(nullptr, n, conv, cm_blk, cm_consts, dst_w, dst_h, out,
                                         out_type, out_ch, store_op, sn, sc, sy, sx, pl);
}
template <typename Src, bool kR2>
__global__ void __launch_bounds__(kThreads) divergent_split_nested(CVGS_SPLIT_PARAMS) {
  split_nested_body<Src, kR2, false>(CVGS_SPLIT_ARGS);
}
template <typename Src>
__global__ void __launch_bounds__(kThreads, 4) divergent_split_nested_staged(CVGS_SPLIT_PARAMS) {
  split_nested_body<Src, true, true>(CVGS_SPLIT_ARGS);
}
#undef CVGS_SPLIT_PARAMS
#undef CVGS_SPLIT_ARGS

// An instance's signature, and its launch: both parts' blocks in one 1-D
// grid of 256-thread blocks.
using SplitKernel = void (*)(const int*, const int*, int, int, const int*, const int*,
                             const int*, SplitPart, SplitPart, Conv, int, int, int, void*, int,
                             int, int, long long, long long, long long, long long);

inline void launch_split_kernel(const cvgs::SplitArgs& a, SplitKernel kernel) {
  const int blocks = a.k6.planes * a.k6.tiles + a.cm.planes * a.cm.tiles;
  kernel<<<blocks, kThreads, 0, a.stream>>>(a.blk, a.consts, a.ptr_off, a.desc_off, a.cm_blk,
                                            a.cm_consts, a.lists, a.k6, a.cm, a.conv, a.n_planes,
                                            a.dst_w, a.dst_h, a.out, a.out_type, a.out_ch,
                                            a.store_op, a.sn, a.sc, a.sy, a.sx);
}

// The one-level forms' launch over a composed part of source kind Src
template <typename Src>
void launch_split(const cvgs::SplitArgs& a) {
  launch_split_kernel(a, a.form == SPLIT_ONE_PIXEL ? divergent_split_kernel<Src, 1>
                                                   : divergent_split_kernel<Src, 4>);
}

// The nested forms' launch over a composed part of source kind Src
template <typename Src>
void launch_split_nested(const cvgs::SplitArgs& a) {
  launch_split_kernel(a, a.form == SPLIT_FUSED2    ? divergent_split_nested<Src, false>
                         : a.form == SPLIT_STAGED ? divergent_split_nested_staged<Src>
                                                  : divergent_split_nested<Src, true>);
}

}  // namespace kc
}  // namespace
