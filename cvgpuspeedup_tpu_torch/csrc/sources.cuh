// The resampling kernels' launches by source element type. K1
// (batch_resize.cu), K2 (frame_resize.cu) and the warp kernel (warp.cu)
// instantiate their templates for uint8 and float32 sources in their own
// translation unit, beside their C entry; each other element type of a
// source (int8, uint16, int16, float16, int32, int64, float64) has a
// translation unit of its own, source_<type>.cu, that instantiates all three
// for it with CVGS_SOURCE. An int32 source is read into float32 at load
// (cvt.rn.f32.s32), as the reference's astype(float32) before the lerps; an
// int64 source keeps its low 32 bits first and a float64 source rounds to
// nearest (chain.cuh::to_f32), as the reference's jnp.asarray makes them
// int32 and float32 before anything else.
// exec/_build.py compiles every .cu file in a process of its own, so the
// instances compile in parallel and no one file holds them all.

#pragma once

#include "batch_resize_kernel.cuh"
#include "frame_resize_kernel.cuh"
#include "warp_kernel.cuh"

namespace cvgs {
#define CVGS_DECLARE(NAME)                         \
  void batch_resize_##NAME(const BatchResizeArgs& a); \
  void frame_resize_##NAME(const FrameResizeArgs& a); \
  void warp_##NAME(const WarpArgs& a);
CVGS_DECLARE(i8)
CVGS_DECLARE(u16)
CVGS_DECLARE(i16)
CVGS_DECLARE(f16)
CVGS_DECLARE(i32)
CVGS_DECLARE(i64)
CVGS_DECLARE(f64)
#undef CVGS_DECLARE
}  // namespace cvgs

// The three kernels' launches for a source of element type SrcT, under the
// names cvgs::batch_resize_NAME, frame_resize_NAME and warp_NAME.
#define CVGS_SOURCE(SrcT, NAME)                                                            \
  namespace cvgs {                                                                         \
  void batch_resize_##NAME(const BatchResizeArgs& a) { k1::launch_source<SrcT>(a); }       \
  void frame_resize_##NAME(const FrameResizeArgs& a) { k2::launch_source<SrcT>(a); }       \
  void warp_##NAME(const WarpArgs& a) { kw::launch_source<SrcT>(a); }                      \
  }
