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
//  - A divergent batch (launch_divergent_batch: each sequence on its own
//    planes, groups of different structure) lays its planes out as a mixed
//    batch does, each head its group's, with each plane's store row after
//    the heads: groups of one kind of source and one store row run that
//    kind's mixed instances, any other batch of images the general
//    instances (composed_divergent.cu), 2 more.
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

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `head` points at the kCmWords host words of a CmHead (a mixed-geometry
// batch's, batch == CM_MIXED: at n_planes such heads, plane 0's first,
// which the consts also hold from word 0 on; a divergent batch's, batch ==
// CM_DIVERGENT: those heads, then each plane's store row, also in the
// consts, and store_op 0); `blk` is the device
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
  if (!head_ok(h) || h.batch < CM_ONE || h.batch > CM_DIVERGENT || (!h.batch && n_planes != 1) ||
      n_planes < 1 || n_planes > 65535 || dst_w < 1 || dst_h < 1 || out_ch < 1 ||
      out_ch > kMaxCh || out_type < PW_U8 || out_type > PW_I32 ||
      (h.batch == CM_DIVERGENT && store_op != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int z = 1; h.batch == CM_MIXED && z < n_planes; ++z) {
    CmHead p;
    std::memcpy(&p, head + (long long)z * kCmWords, sizeof(CmHead));
    if (!head_ok(p) || !same_structure(h, p)) return (int)cudaErrorInvalidValue;
  }
  // a divergent batch: every plane's head in the launch's instances, its
  // store row after the heads; one kind of source and one store row keep
  // that kind's mixed instances, with the row as the launch's, any other
  // batch (of images alone) the general ones; a YUV -> RGB, of one range
  int limited = b.limited, kind = source_kind(b), store = store_op;
  bool one_kind = true, converts = false, yuv = false;
  for (int z = 0; h.batch == CM_DIVERGENT && z < n_planes; ++z) {
    CmHead p;
    std::memcpy(&p, head + (long long)z * kCmWords, sizeof(CmHead));
    const int row = head[(long long)n_planes * kCmWords + z];
    if (!head_ok(p) || !same_instance(h, p) || row < 0) return (int)cudaErrorInvalidValue;
    if (z == 0) store = row;
    one_kind = one_kind && source_kind(p.lower) == kind && row == store;
    yuv = yuv || p.lower.base == PW_YUV;
    if (p.lower.base == PW_YUV || p.lower.conv_first) {
      if (converts && p.lower.limited != limited) return (int)cudaErrorInvalidValue;
      limited = p.lower.limited, converts = true;
    }
  }
  const Conv conv{limited, 0, ys, cs, rv, gu, gv, bu};
  CmHead launch_head = h;  // launch_source chooses the mixed instances by this word
  if (h.batch == CM_DIVERGENT) launch_head.batch = CM_MIXED;
  const cvgs::ComposedArgs a{src, reinterpret_cast<const int*>(&launch_head), conv, blk, consts,
                             n_planes, dst_w, dst_h, out, out_type, out_ch, store, sn, sc, sy, sx,
                             h.batch >= CM_MIXED
                                 ? 1
                                 : kc::pixels_per_thread((long long)n_planes * dst_w * dst_h,
                                                         h.core == CM_NONE ? 1 : 4),
                             static_cast<cudaStream_t>(stream)};
  if (!one_kind) {
    if (yuv) return (int)cudaErrorInvalidValue;
    cvgs::composed_divergent(a);
    return (int)cudaGetLastError();
  }
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
