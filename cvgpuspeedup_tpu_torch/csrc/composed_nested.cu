// A second resampling node, or a fused read above the core, in one launch:
// the composed-read kernel's nested instances (composed_nested.cuh), here
// those of uint8 images and the C entry.
//
// Replaces, as composed.cu does, the one jitted XLA program that
// cvgpuspeedup_tpu/exec/executor.py (_compiled) builds for a read tree no
// Pallas kernel takes: ResizeRead.lower (ops/resize.py) and WarpRead.lower
// (ops/warp.py) lower any read-op source, so a top view resized to a
// detector's input (resize(warp)), a working frame rotated (warp(resize)),
// a two-level downscale (resize(resize)), a region of interest of a
// downscaled frame (resize(crop(resize))) and a letterbox whose pad value is
// already normalized (make_border(fuse(resize, convert_to))) run there as
// one fused program; batch_read of such planes (surround-view top views,
// ragged) too.
//
// What bounds it: the latency of a block's dependent steps (the tables,
// the base taps' loads, the barriers), with 4 blocks an SM resident. With
// a second resample that shares taps among a tile's pixels (a warp; an
// upscale), a block of 16 x 16 outputs stages its footprint of the middle
// image in shared memory, each value of the core there evaluated once
// (composed_nested.cuh: 1.34 a pixel under a warp at scale 1, a sixth
// under a 2.5x upscale); a block whose footprint passes the budget (a
// warp's strong downscale, a fold that spreads the tile) evaluates the
// core at each tap its pixels take, as the per-tap instance does for a
// resize whose taps no two pixels share (1 to 4 core values a pixel).
//
// Instances: {uint8 here, float32/int32 (composed_nested_f32.cu), NV12/NV21
// (composed_nested_nv12.cu), the six other source types
// (composed_nested_any.cu)} x {a second resampling node staged, the same
// per tap, a FusedRead2 alone} x {one geometry, the head by value; planes
// of their own geometry, each block's plane head copied from the consts
// into shared memory}: 24, in four files built in parallel. The plan's
// stage2 word picks the staged or the per-tap instance from the structure
// (exec/cuda_composed.py::build_plan): the per-tap one alone keeps the
// registers that hold 4 blocks an SM resident without spills. A batch of
// nested planes of their own geometry (cameras of mixed resolution warped
// to their top views, ROIs of their own sizes of a downscale) carries each
// plane's stage2: the staged mixed instance where any plane stages, its
// blocks of a plane whose stage2 is 0 per tap. A divergent batch with a
// nested group (surround-view top views beside letterboxes, groups of
// different sources) runs those mixed instances where its planes read one
// kind of source with one store row, else three general ones over AnyImage
// (composed_nested_divergent.cu): 27 in five files.

#include "composed_nested.cuh"

namespace {

// Whether nested plane heads a and b of a mixed-geometry batch differ in
// geometry alone: same_structure's, the middle image's and the second
// level's output sizes, the second resample's edge rule and tap tables,
// and its staging (stage2: a block takes the form its plane's asks for).
bool same_nested(const kc::CmNested& a, const kc::CmNested& b) {
  return same_structure(a.h, b.h) && same_stages(a.above, b.above) &&
         same_stages(a.below, b.below) && a.core2 == b.core2 && a.persp2 == b.persp2 &&
         a.coef2_off == b.coef2_off && a.border2_off == b.border2_off &&
         a.mid_type == b.mid_type && a.mid_ch == b.mid_ch && a.mid_n_ops == b.mid_n_ops &&
         a.mid_ops_off == b.mid_ops_off && a.mid_fp_off == b.mid_fp_off;
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// The arguments are cvgs_composed's (composed.cu), but `head` points at the
// kNestedWords host words of a CmNested (a mixed-geometry batch's, batch
// == CM_MIXED: at n_planes of them, plane 0's first, which the consts also
// hold from word 0 on; a divergent batch's, batch == CM_DIVERGENT: those
// heads, then each plane's store row, also in the consts, and store_op 0).
extern "C" int cvgs_composed_nested(const void* src, const int* head, float ys, float cs,
                                    float rv, float gu, float gv, float bu, const int* blk,
                                    const int* consts, int n_planes, int dst_w, int dst_h,
                                    void* out, int out_type, int out_ch, int store_op,
                                    long long sn, long long sc, long long sy, long long sx,
                                    void* stream) {
  kc::CmNested n;
  std::memcpy(&n, head, sizeof(kc::CmNested));
  const CmHead& h = n.h;
  const PwHead& b = h.lower;
  if (!nested_ok(n) || h.batch < CM_ONE || h.batch > CM_DIVERGENT ||
      (!h.batch && n_planes != 1) || n_planes < 1 || n_planes > 65535 || dst_w < 1 ||
      dst_h < 1 || out_ch < 1 || out_ch > kMaxCh || out_type < PW_U8 || out_type > PW_I32 ||
      (h.batch == CM_DIVERGENT && store_op != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int z = 1; h.batch == CM_MIXED && z < n_planes; ++z) {
    kc::CmNested p;
    std::memcpy(&p, head + (long long)z * kc::kNestedWords, sizeof(kc::CmNested));
    if (!nested_ok(p) || !same_nested(n, p)) return (int)cudaErrorInvalidValue;
  }
  // a divergent batch: every plane's head in the launch's instances, its
  // store row after the heads; one kind of source and one store row keep
  // that kind's mixed nested instances, with the row as the launch's, any
  // other batch (of images alone) the general ones; a YUV -> RGB, of one
  // range
  int limited = b.limited, kind = source_kind(b), store = store_op;
  bool one_kind = true, converts = false, yuv = false;
  for (int z = 0; h.batch == CM_DIVERGENT && z < n_planes; ++z) {
    kc::CmNested p;
    std::memcpy(&p, head + (long long)z * kc::kNestedWords, sizeof(kc::CmNested));
    const int row = head[(long long)n_planes * kc::kNestedWords + z];
    if (!nested_ok(p) || !same_nested_instance(n, p) || row < 0) {
      return (int)cudaErrorInvalidValue;
    }
    if (z == 0) store = row;
    one_kind = one_kind && source_kind(p.h.lower) == kind && row == store;
    yuv = yuv || p.h.lower.base == PW_YUV;
    if (p.h.lower.base == PW_YUV || p.h.lower.conv_first) {
      if (converts && p.h.lower.limited != limited) return (int)cudaErrorInvalidValue;
      limited = p.h.lower.limited, converts = true;
    }
  }
  const Conv conv{limited, 0, ys, cs, rv, gu, gv, bu};
  const cvgs::ComposedArgs a{src, head, conv, blk, consts, n_planes, dst_w, dst_h, out, out_type,
                             out_ch, store, sn, sc, sy, sx, 1,
                             static_cast<cudaStream_t>(stream)};
  if (!one_kind) {
    if (yuv) return (int)cudaErrorInvalidValue;
    cvgs::composed_nested_divergent(a);
    return (int)cudaGetLastError();
  }
  // one instance per kind of source: every source type is a case by name
  if (b.base == PW_YUV) {
    cvgs::composed_nested_nv12(a);
  } else {
    switch (b.src_type) {
      case PW_U8: kc::launch_nested<uint8_t>(a); break;
      case PW_F32:
      case PW_I32: cvgs::composed_nested_f32(a); break;
      case PW_I8:
      case PW_U16:
      case PW_I16:
      case PW_F16:
      case PW_I64:
      case PW_F64: cvgs::composed_nested_any(a); break;
    }
  }
  return (int)cudaGetLastError();
}
