// A resize, a warp or a one-pixel read over crops, borders and a fused read,
// under crops and borders, in one launch: the composed-read kernel.
//
// Replaces the one jitted XLA program that cvgpuspeedup_tpu/exec/executor.py
// (_compiled) builds for a read tree no Pallas kernel takes: the reference's
// frame, batch and warp kernels read only an image or the commuted NV12 read
// (pallas_frame.py::_source_array, pallas_backend.py::supports,
// pallas_warp_universal.py), so resize(crop(4K)), resize(fuse(image,
// reorder, convert)), make_border(resize(..)) (a letterbox), warp(crop(..)),
// resize(make_border(..)), crop(fuse(image, gray)), resize(fuse(NV12,
// YUV -> RGB into uint8)), crop_batch and batch_read of such trees (N
// cameras resized, regions of interest, letterboxes, warps of crops, ragged
// with used_planes and a default) run there as XLA fuses them. Here one
// kernel interprets the read (composed.cuh) and both chains
// (pointwise_chain.cuh).
//
// What bounds it: bytes for most trees (a 1920 x 1080 crop of a 4K frame
// resized to 640 x 360 and written planar in float32 reads 2.1 MB of taps
// and writes 2.8 MB), the float32 operations for a fused chain that runs
// per tap (four taps per output pixel) or a long pipeline chain, and the
// launch itself for a small output.
//
// The design (composed.cuh):
//  - One instance per kind of source, so a tap's load is a typed __ldg
//    with no branch: uint8 images here, float32 and int32 images
//    (composed_f32.cu), NV12/NV21 buffers (composed_nv12.cu); int8,
//    uint16, int16, float16, int64 and float64 share one instance
//    (composed_any.cu) whose switch on the type lies around all of a
//    thread's loads, not inside each tap's. Each kind has a resample's
//    instance (4 taps a pixel, 1 pixel a thread) and a one-pixel read's of
//    1 or 4 adjacent pixels a thread (pixels_per_thread, the warp kernel's
//    rule): 12 instances in four files, built in parallel, and 8 more for
//    a batch whose planes differ in geometry (below). The output's element
//    type is a switch at the store.
//  - A thread walks its pixels through the outer stages once for its row,
//    then its taps' columns and rows through the stages below the core one
//    axis at a time (walk_axis): a resize's 2 columns and 2 rows, not its 4
//    taps in 2-D; a thread none of whose pixels samples the core (an outer
//    border's fill) reads nothing.
//  - A resize under the edge rule that keeps the first tap alone where a
//    weight is 0 (every output of an exact 3:1) does not load the second
//    tap, as K2's bilerp skips it, and does no work for it.
//  - All of a thread's tap loads are issued in one run before any
//    conversion, a uint8 row's two adjacent taps as three words (the warp
//    kernel's load_run), and the op tables are staged into shared memory
//    at the start; each tap is then converted, run through the fused
//    read's chain and sampled, and the pixels run the pipeline's chain and
//    store through store_any (16-byte stores of a planar float32 group of
//    4, packed groups, scalar stores at a ragged edge or an unaligned view).
//  - A batch is grid.z = plane over one plane's head: each plane's values
//    lie plane_stride block words apart, its source address in the block,
//    so N cameras are read in place with no staging copy; a plane past
//    used_planes reads nothing and stores the default through the chain.
//  - A batch whose planes share one shape but not one geometry (cameras of
//    mixed resolution, ROIs and letterboxes of their own sizes) has each
//    plane's head in the consts: its instances (a resample's and a
//    one-pixel read's, one pixel a thread) copy the block's plane head into
//    shared memory and run the same body over it; a batch of one geometry
//    keeps its head by value and its instances.
// Runtime values (crop origins, border values, warp coefficients and
// border, chain scalars, a batch's source addresses, used_planes and the
// default) come from one int32 block, so nothing of them keys a plan.
//
// Numerics: bit for bit the plain version: every float op is an _rn
// intrinsic, built with -fmad=false and -ftz=true, never fast math; a
// float64 source is read with chain.cuh::to_f32 (PTX cvt.rn.f32.f64); a
// warp map's terms are computed as the host computes them, a subnormal
// kept (warp.cuh::fmul_keep, fadd_keep).

#include "composed.cuh"

namespace {

// The checks of one plane's head that the launch does not set.
bool head_ok(const CmHead& h) {
  const PwHead& b = h.lower;
  const bool stages_ok = b.n_stages >= 0 && b.n_stages <= kMaxStages && h.upper.n_stages >= 0 &&
                         h.upper.n_stages <= kMaxStages && h.outer.n_stages >= 0 &&
                         h.outer.n_stages <= kMaxStages;
  return stages_ok && h.core >= CM_NONE && h.core <= CM_WARP && h.plane_stride >= 0 &&
         h.used_off >= -1 && (h.used_off >= 0) == (h.default_off >= 0) && b.base >= PW_IMAGE &&
         b.base <= PW_YUV && b.base != PW_CIRC && b.src_type >= PW_U8 && b.src_type <= PW_F64 &&
         b.nch >= 1 && b.nch <= kMaxCh && b.src_h >= 1 && b.src_w >= 1 &&
         !(b.base == PW_YUV && (b.src_type != PW_U8 || b.nch != 3)) &&
         !(b.conv_first && b.nch != 3) && h.tap_ch >= 1 && h.tap_ch <= kMaxCh &&
         h.tap_type >= PW_U8 && h.tap_type <= PW_I32 && h.core_type >= PW_U8 &&
         h.core_type <= PW_I32 && h.in_n_ops >= 0 && h.out_n_ops >= 0 && h.core_h >= 1 &&
         h.core_w >= 1 && h.in_h >= 1 && h.in_w >= 1;
}

// Whether two stage lists share their structure: counts, kinds, modes and
// block offsets (their sizes may differ).
bool same_stages(const PwHead& a, const PwHead& b) {
  if (a.n_stages != b.n_stages) return false;
  for (int s = 0; s < a.n_stages; ++s) {
    const PwStage &x = a.st[s], &y = b.st[s];
    const bool crop = x.kind == PW_CROP;
    if (x.kind != y.kind || x.mode != y.mode || (crop ? x.a != y.a || x.b != y.b : x.c != y.c)) {
      return false;
    }
  }
  return true;
}

// Whether plane heads a and b of a mixed-geometry batch differ in geometry
// alone: the base's and stages' sizes, the core's sizes, its edge rule and
// its tap tables.
bool same_structure(const CmHead& a, const CmHead& b) {
  const PwHead &p = a.lower, &q = b.lower;
  return same_stages(p, q) && same_stages(a.upper, b.upper) && same_stages(a.outer, b.outer) &&
         p.base == q.base && p.src_type == q.src_type && p.nch == q.nch && p.nv21 == q.nv21 &&
         p.conv_first == q.conv_first && p.limited == q.limited && p.width == q.width &&
         a.core == b.core && a.persp == b.persp && a.coef_off == b.coef_off &&
         a.border_off == b.border_off && a.tap_type == b.tap_type &&
         a.core_type == b.core_type && a.tap_ch == b.tap_ch && a.batch == b.batch &&
         a.in_n_ops == b.in_n_ops && a.in_ops_off == b.in_ops_off &&
         a.in_fp_off == b.in_fp_off && a.out_n_ops == b.out_n_ops &&
         a.out_ops_off == b.out_ops_off && a.out_fp_off == b.out_fp_off &&
         a.plane_stride == b.plane_stride && a.used_off == b.used_off &&
         a.default_off == b.default_off;
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `head` points at the kCmWords host words of a CmHead (a mixed-geometry
// batch's, batch == CM_MIXED: at n_planes such heads, plane 0's first,
// which the consts also hold from word 0 on); `blk` is the device
// block of runtime values; `consts` holds the fused read's op table at
// in_ops_off and the pipeline's at out_ops_off (each: the rows, a sentinel,
// each row's channel count) and a resize's tap tables at taps_off; `out`
// holds elements of type `out_type` (PW_U8 .. PW_I32) with out_ch channels
// and element strides (sn, sc, sy, sx) per (plane, channel, row, col). A
// store_op other than 0 is the row that converts the chain's values for the
// buffer's dtype (exec/cuda_batch_resize.py::store_cast).
extern "C" int cvgs_composed(const void* src, const int* head, float ys, float cs, float rv,
                             float gu, float gv, float bu, const int* blk, const int* consts,
                             int n_planes, int dst_w, int dst_h, void* out, int out_type,
                             int out_ch, int store_op, long long sn, long long sc, long long sy,
                             long long sx, void* stream) {
  CmHead h;
  std::memcpy(&h, head, sizeof(CmHead));
  const PwHead& b = h.lower;
  if (!head_ok(h) || h.batch < CM_ONE || h.batch > CM_MIXED || (!h.batch && n_planes != 1) ||
      n_planes < 1 || n_planes > 65535 || dst_w < 1 || dst_h < 1 || out_ch < 1 ||
      out_ch > kMaxCh || out_type < PW_U8 || out_type > PW_I32) {
    return (int)cudaErrorInvalidValue;
  }
  for (int z = 1; h.batch == CM_MIXED && z < n_planes; ++z) {
    CmHead p;
    std::memcpy(&p, head + (long long)z * kCmWords, sizeof(CmHead));
    if (!head_ok(p) || !same_structure(h, p)) return (int)cudaErrorInvalidValue;
  }
  const Conv conv{b.limited, 0, ys, cs, rv, gu, gv, bu};
  const cvgs::ComposedArgs a{src, head, conv, blk, consts, n_planes, dst_w, dst_h, out, out_type,
                             out_ch, store_op, sn, sc, sy, sx,
                             h.batch == CM_MIXED
                                 ? 1
                                 : kc::pixels_per_thread((long long)n_planes * dst_w * dst_h,
                                                         h.core == CM_NONE ? 1 : 4),
                             static_cast<cudaStream_t>(stream)};
  // one instance per kind of source: every source type is a case by name
  if (b.base == PW_YUV) {
    cvgs::composed_nv12(a);
  } else {
    switch (b.src_type) {
      case PW_U8: kc::launch_source<uint8_t>(a); break;
      case PW_F32:
      case PW_I32: cvgs::composed_f32(a); break;
      case PW_I8:
      case PW_U16:
      case PW_I16:
      case PW_F16:
      case PW_I64:
      case PW_F64: cvgs::composed_any(a); break;
    }
  }
  return (int)cudaGetLastError();
}
