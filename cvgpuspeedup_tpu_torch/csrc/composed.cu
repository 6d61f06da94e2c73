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
// YUV -> RGB into uint8)) and crop_batch run there as XLA fuses them. Here
// one kernel interprets the read (composed.cuh) and both chains
// (pointwise_chain.cuh).
//
// What bounds it: bytes for most trees (a 1920 x 1080 crop of a 4K frame
// resized to 640 x 360 and written planar in float32 reads 1.4 MB of taps
// and writes 2.8 MB), the float32 operations for a fused chain that runs
// per tap (four taps per output pixel) or a long pipeline chain, and the
// launch itself for a small output.
//
// The design, simple first: one thread per output pixel, blocks of 64 x 4,
// grid.z the plane. The thread walks the outer stages, finds its taps (the
// resize's host tables; the warp's coordinates, as warp.cuh recomputes
// them), reads each tap through the inner stages from global memory, runs
// the fused read's chain on its taps, samples (frame_resize.cuh's
// bilerp_values with the resize's edge rule; the warp's lerps with its
// border), runs the pipeline's chain and stores through store_any. The two
// op tables are staged through shared memory in chunks, one after the
// other, as the pointwise kernel stages its table. Runtime values (crop
// origins, border values, warp coefficients and border, chain scalars, a
// batch's source addresses) come from one int32 block, so nothing of them
// keys a plan. The source's element type is a runtime switch
// (read_base_row); the output's element type and the taps per pixel (1 for
// a one-pixel read, 4 for a resample) are template parameters: 8 instances.
//
// Numerics: bit for bit the plain version: every float op is an _rn
// intrinsic, built with -fmad=false and -ftz=true, never fast math; a
// float64 source is read with chain.cuh::to_f32 (PTX cvt.rn.f32.f64).

#include <cstring>

#include "composed.cuh"

namespace {

template <typename OutT, int T>
__global__ void __launch_bounds__(256) composed_kernel(
    const void* __restrict__ src, CmHead h, Conv conv, const int* __restrict__ blk,
    const int* __restrict__ consts, int dst_w, int dst_h, OutT* __restrict__ out, int out_ch,
    int store_op, long long sn, long long sc, long long sy, long long sx) {
  __shared__ PwRow rows[kStageRows];
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;  // blocks are 256 threads
  // every thread stages; one outside the output skips its reads, chains and
  // store
  const bool live = x < dst_w && y < dst_h;
  const float* fblk = reinterpret_cast<const float*>(blk);
  // a batch's plane: its source address, its crop origin two words apart
  const void* s = src;
  if (h.batch) {
    s = reinterpret_cast<const void*>(__ldg(reinterpret_cast<const unsigned long long*>(blk) + z));
  }

  // the outer walk: the output position into the core's output
  int xc[1] = {x}, fo[1] = {-1};
  int yc = y;
  if (live) walk_stages(h.outer, h.batch ? blk + 2 * z : blk, xc, fo, yc);
  const bool sample = live && fo[0] < 0;

  // the taps' positions in the core's source and the ones the result needs
  int ys[T], xs[T];
  unsigned need = 0;
  float wx = 0.f, wy = 0.f;
#pragma unroll
  for (int k = 0; k < T; ++k) ys[k] = xs[k] = 0;
  if (sample) {
    if constexpr (T == 1) {
      ys[0] = yc, xs[0] = xc[0], need = 1;
    } else if (h.core == CM_RESIZE) {
      const int* tp = consts + h.taps_off;
      const float* tw = reinterpret_cast<const float*>(tp + 2 * (h.core_w + h.core_h));
      const int x0 = __ldg(tp + xc[0]), x1 = __ldg(tp + h.core_w + xc[0]);
      const int y0 = __ldg(tp + 2 * h.core_w + yc), y1 = __ldg(tp + 2 * h.core_w + h.core_h + yc);
      wx = __ldg(tw + xc[0]);
      wy = __ldg(tw + h.core_w + yc);
      ys[0] = ys[1] = y0, ys[2] = ys[3] = y1;
      xs[0] = xs[2] = x0, xs[1] = xs[3] = x1;
      need = 15;
    } else {  // the warp: warp.cuh's coordinates and taps over the inner image
      const float* cf = fblk + h.coef_off;
      const float fx = (float)xc[0], fy = (float)yc;
      float px = affine_term(cf, fx, fy);
      float py = affine_term(cf + 3, fx, fy);
      if (h.persp) {
        float den = affine_term(cf + 6, fx, fy);
        if (den == 0.f) den = 1.f;
        px = __fdiv_rn(px, den);
        py = __fdiv_rn(py, den);
      }
      const float x0f = floorf(px), y0f = floorf(py);
      wx = __fsub_rn(px, x0f);
      wy = __fsub_rn(py, y0f);
      const float fw = (float)h.in_w, fh = (float)h.in_h;  // exact: sides < 2^24
      const bool vx0 = x0f >= 0.f && x0f < fw, vx1 = x0f >= -1.f && x0f < fw - 1.f;
      const bool vy0 = y0f >= 0.f && y0f < fh, vy1 = y0f >= -1.f && y0f < fh - 1.f;
      ys[0] = ys[1] = vy0 ? (int)y0f : 0;
      ys[2] = ys[3] = vy1 ? (int)y0f + 1 : 0;
      xs[0] = xs[2] = vx0 ? (int)x0f : 0;
      xs[1] = xs[3] = vx1 ? (int)x0f + 1 : 0;
      need = (unsigned)(vy0 && vx0) | (unsigned)(vy0 && vx1) << 1 | (unsigned)(vy1 && vx0) << 2 |
             (unsigned)(vy1 && vx1) << 3;
    }
  }
  float t[T][kMaxCh];
  int fu[T];
#pragma unroll
  for (int k = 0; k < T; ++k) {
    fu[k] = -1;
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) t[k][c] = 0.f;
  }
  if (sample) read_taps<T>(h, s, blk, conv, ys, xs, need, t, fu);

  // the fused read's chain on every tap
  for (int k0 = 0; k0 < h.in_n_ops; k0 += kStageRows) {
    const int m = min(kStageRows, h.in_n_ops - k0);
    if (k0 > 0) __syncthreads();  // every thread is done with the last chunk
    stage_rows(rows, consts + h.in_ops_off, h.in_n_ops, k0, m, fblk + h.in_fp_off, tid,
               kStageRows);
    __syncthreads();
    if (sample) run_rows(t, rows, m);
  }

  float v[1][kMaxCh] = {{0.f, 0.f, 0.f, 0.f}};
  if (sample) {
    // an upper CONSTANT border's value, cast to the chain's type, after it
#pragma unroll
    for (int k = 0; k < T; ++k) {
      if (fu[k] < 0) continue;
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) {
        if (c < h.tap_ch) t[k][c] = cast_to_type(__ldg(fblk + fu[k] + c), h.tap_type);
      }
    }
    if constexpr (T == 1) {
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) v[0][c] = t[0][c];
    } else {
      // a resample reads float32 values: int32's bits converted
      if (h.tap_type == PW_I32) {
#pragma unroll
        for (int k = 0; k < T; ++k) {
#pragma unroll
          for (int c = 0; c < kMaxCh; ++c) t[k][c] = __int2float_rn(__float_as_int(t[k][c]));
        }
      }
      if (h.core == CM_RESIZE) {
#pragma unroll
        for (int c = 0; c < kMaxCh; ++c) {
          v[0][c] = bilerp_values(t[0][c], t[1][c], t[2][c], t[3][c], wx, wy, h.keep_edge);
        }
      } else {
        // a tap outside the warp's source reads its border
#pragma unroll
        for (int k = 0; k < T; ++k) {
          if (need >> k & 1u) continue;
#pragma unroll
          for (int c = 0; c < kMaxCh; ++c) {
            if (c < h.tap_ch) t[k][c] = __ldg(fblk + h.border_off + c);
          }
        }
#pragma unroll
        for (int c = 0; c < kMaxCh; ++c) {
          v[0][c] = lerp_rn(lerp_rn(t[0][c], t[1][c], wx), lerp_rn(t[2][c], t[3][c], wx), wy);
        }
      }
    }
  } else if (live) {  // an outer CONSTANT border's value, cast to the core's type
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) {
      if (c < h.tap_ch) v[0][c] = cast_to_type(__ldg(fblk + fo[0] + c), h.core_type);
    }
  }

  // the pipeline's chain
  for (int k0 = 0; k0 < h.out_n_ops; k0 += kStageRows) {
    const int m = min(kStageRows, h.out_n_ops - k0);
    __syncthreads();  // every thread is done with the last rows staged
    stage_rows(rows, consts + h.out_ops_off, h.out_n_ops, k0, m, fblk + h.out_fp_off, tid,
               kStageRows);
    __syncthreads();
    if (live) run_rows(v, rows, m);
  }
  if (!live) return;

  // a value stored into a buffer of another dtype: the row that casts it as
  // utils/dtypes.py::astype does, where that takes one
  if (store_op) run_integer_row(store_op, v);
  store_any(out + (long long)z * sn + (long long)y * sy + (long long)x * sx, v, 1, out_ch, sc, sx);
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `head` points at the kCmWords host words of a CmHead; `blk` is the device
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
  const bool stages_ok = b.n_stages >= 0 && b.n_stages <= kMaxStages && h.upper.n_stages >= 0 &&
                         h.upper.n_stages <= kMaxStages && h.outer.n_stages >= 0 &&
                         h.outer.n_stages <= kMaxStages;
  if (!stages_ok || h.core < CM_NONE || h.core > CM_WARP || (h.batch && h.core != CM_NONE) ||
      n_planes < 1 || n_planes > 65535 || dst_w < 1 || dst_h < 1 || out_ch < 1 ||
      out_ch > kMaxCh || out_type < PW_U8 || out_type > PW_I32 || b.base < PW_IMAGE ||
      b.base > PW_YUV || b.base == PW_CIRC || b.src_type < PW_U8 || b.src_type > PW_F64 ||
      b.nch < 1 || b.nch > kMaxCh || b.src_h < 1 || b.src_w < 1 ||
      (b.base == PW_YUV && (b.src_type != PW_U8 || b.nch != 3)) || (b.conv_first && b.nch != 3) ||
      h.tap_ch < 1 || h.tap_ch > kMaxCh || h.tap_type < PW_U8 || h.tap_type > PW_I32 ||
      h.core_type < PW_U8 || h.core_type > PW_I32 || h.in_n_ops < 0 || h.out_n_ops < 0 ||
      h.core_h < 1 || h.core_w < 1 || h.in_h < 1 || h.in_w < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Conv conv{b.limited, 0, ys, cs, rv, gu, gv, bu};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block = group_block(dst_w, 1);
  const dim3 grid((dst_w + block.x - 1) / block.x, (dst_h + block.y - 1) / block.y, n_planes);
#define CVGS_KERNEL(OutT, T)                                                                   \
  composed_kernel<OutT, T><<<grid, block, 0, s>>>(src, h, conv, blk, consts, dst_w, dst_h,     \
                                                  static_cast<OutT*>(out), out_ch, store_op, sn, \
                                                  sc, sy, sx)
  // two instances per output type: one tap (no resample), four
#define CVGS_TYPE(OutT)        \
  if (h.core == CM_NONE) {     \
    CVGS_KERNEL(OutT, 1);      \
  } else {                     \
    CVGS_KERNEL(OutT, 4);      \
  }                            \
  break;
  switch (out_type) {
    case PW_U8:
    case PW_I8: CVGS_TYPE(uint8_t)
    case PW_U16:
    case PW_I16: CVGS_TYPE(uint16_t)
    case PW_F16: CVGS_TYPE(f16)
    default: CVGS_TYPE(float)
  }
#undef CVGS_TYPE
#undef CVGS_KERNEL
  return (int)cudaGetLastError();
}
