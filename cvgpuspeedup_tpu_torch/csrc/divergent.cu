// The divergent batch: a different op sequence on each plane of one batch,
// in one launch, with a strided write.
//
// Replaces cvgpuspeedup_tpu/exec/pallas_divergent.py::_emit, the TPU kernel
// of launch_divergent_batch (the reference's
// launchDivergentBatchTransformDPP_Kernel). Plane z runs the sequence of
// group table[z]; each group is one of six kinds, each reading with the
// device code of the kernel it shares a rule with:
//   image        plane z of an (N, H, W, C) stack
//   circ         plane floor_mod(first +- z, N) of a ring, `first` at runtime
//   crop_resize  a crop of one frame, resized by K1's rules (batch_resize.cuh)
//   resize       a whole plane of a stack, by K1's rules on (0, 0, w, h)
//   nv12         an NV12/NV21 buffer per plane, K2's tap tables and YUV->RGB
//                (frame_resize.cuh)
//   warp         a source per plane, 9 coefficients per plane (warp.cuh)
// then the group's chain (chain.cuh) and one strided store.
//
// What bounds it: memory traffic and launch overhead. One thread per output
// pixel (all channels), blocks of 64x4 threads so neighbouring threads store
// neighbouring addresses in every planar layout, grid.z = plane; every block
// of a plane takes the same branch, so the switch costs no divergence
// within a warp. Taps are read straight from global memory. The TPU
// kernel's scalar-prefetch ring, 2-slot DMA, interleaved lane coefficients,
// baked one-hot NV12 and warp matrices and VMEM/lane gates are not carried
// over: Hopper gathers, and runtime matrices, rects and `first`s come from
// the parameter block, so nothing is baked and nothing keys a cache.
//
// The parameter block (int32 words, exec/cuda_divergent.py::prepare):
//   [0, N)           the plane -> group table
//   ptr_off          N source addresses (8-byte words), one per plane
//   per group        first, used_planes, rects, background, warp
//                    coefficients and borders, chain scalars
//   desc_off         one descriptor of kDescInts words per group, fields D_*
// The consts (the plan's): every group's op rows, then each NV12 group's
// tap table, weights and 6 conversion floats.
//
// Numerics: bit for bit the samplers of K1, K2 and the warp kernel; every
// float op is an _rn intrinsic, built with -fmad=false, never fast math.

#include "batch_resize.cuh"
#include "frame_resize.cuh"
#include "warp.cuh"

namespace {

// group kinds; keep in step with exec/cuda_divergent.py::KINDS
enum : int { K_IMAGE = 0, K_CIRC = 1, K_CROP = 2, K_STACK = 3, K_NV12 = 4, K_WARP = 5 };

// descriptor fields; keep in step with exec/cuda_divergent.py::prepare
enum : int {
  D_KIND = 0,
  D_SRC_H = 1,
  D_SRC_W = 2,
  D_NCH = 3,
  D_SRC_U8 = 4,
  D_N_SRC = 5,    // planes of the ring or stack
  D_FIRST = 6,    // circ: block offset of `first`
  D_ASC = 7,      // circ: ascending
  D_MODE = 8,     // crop, stack: aspect-ratio mode
  D_USED = 9,     // crop, stack: block offset of used_planes
  D_OP_OFF = 10,  // first op row in the consts
  D_N_OPS = 11,
  D_FP_OFF = 12,  // block offset of the chain scalars
  D_DATA = 13,    // crop, stack: rects; warp: coefficients (block); nv12: taps (consts)
  D_FLAGS = 14,   // nv12: keep_edge | nv21 << 1 | limited << 2 | alpha << 3; warp: perspective
  D_AUX = 15,     // crop, stack: background; warp: borders (block); nv12: weights (consts)
  kDescInts = 16,
};

template <typename SrcT>
__device__ __forceinline__ void load_pixel(const SrcT* __restrict__ p, int nch,
                                           float (&v)[kMaxCh]) {
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) {
    if (c < nch) v[c] = (float)__ldg(p + c);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(256) divergent_kernel(
    const int* __restrict__ blk, const int* __restrict__ consts, int ptr_off, int desc_off,
    int dst_w, int dst_h, OutT* __restrict__ out, int out_ch, long long sn, long long sc,
    long long sy, long long sx) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= dst_w || y >= dst_h) return;

  const float* fblk = reinterpret_cast<const float*>(blk);
  const float* fconsts = reinterpret_cast<const float*>(consts);
  const int* d = blk + desc_off + kDescInts * __ldg(blk + z);
  const int kind = __ldg(d + D_KIND);
  const int src_h = __ldg(d + D_SRC_H), src_w = __ldg(d + D_SRC_W), nch = __ldg(d + D_NCH);
  const bool u8 = __ldg(d + D_SRC_U8) != 0;
  const void* base = reinterpret_cast<const void*>(
      __ldg(reinterpret_cast<const unsigned long long*>(blk + ptr_off) + z));

  float vv[1][kMaxCh] = {{0.f, 0.f, 0.f, 0.f}};
  float(&v)[kMaxCh] = vv[0];
  int ch = nch;
  switch (kind) {
    case K_IMAGE:
    case K_CIRC: {
      int pz = z;
      if (kind == K_CIRC) {
        const int n_src = __ldg(d + D_N_SRC);
        const int first = __ldg(blk + __ldg(d + D_FIRST));
        const int t = __ldg(d + D_ASC) ? first + z : first - z;
        pz = t - floor_div(t, n_src) * n_src;  // floor modulo, as Python's %
      }
      const long long off = (((long long)pz * src_h + y) * src_w + x) * nch;
      if (u8) {
        load_pixel(static_cast<const uint8_t*>(base) + off, nch, v);
      } else {
        load_pixel(static_cast<const float*>(base) + off, nch, v);
      }
      break;
    }
    case K_CROP:
    case K_STACK: {
      bool sampled = false;
      if (z < __ldg(blk + __ldg(d + D_USED))) {
        const int* r = blk + __ldg(d + D_DATA) + 4 * z;
        const int rx = __ldg(r), ry = __ldg(r + 1), rw = __ldg(r + 2), rh = __ldg(r + 3);
        const int mode = __ldg(d + D_MODE);
        const long long plane = kind == K_STACK ? (long long)z * src_h * src_w * nch : 0;
        if (u8) {
          sampled = sample_crop(static_cast<const uint8_t*>(base) + plane, src_h, src_w, nch, rx,
                                ry, rw, rh, dst_w, dst_h, mode, x, y, v);
        } else {
          sampled = sample_crop(static_cast<const float*>(base) + plane, src_h, src_w, nch, rx,
                                ry, rw, rh, dst_w, dst_h, mode, x, y, v);
        }
      }
      if (!sampled) {
        const float* bg = fblk + __ldg(d + D_AUX);
#pragma unroll
        for (int c = 0; c < kMaxCh; ++c) v[c] = c < nch ? __ldg(bg + c) : 0.f;
      }
      break;
    }
    case K_NV12: {
      const int flags = __ldg(d + D_FLAGS);
      const float* wts = fconsts + __ldg(d + D_AUX);
      const float* cf = wts + dst_w + dst_h;
      const Conv conv{(flags >> 2) & 1, (flags >> 3) & 1, __ldg(cf),     __ldg(cf + 1),
                      __ldg(cf + 2),    __ldg(cf + 3),    __ldg(cf + 4), __ldg(cf + 5)};
      sample_nv12(static_cast<const uint8_t*>(base), src_h, src_w, (flags >> 1) & 1,
                  consts + __ldg(d + D_DATA), wts, dst_w, dst_h, x, y, (flags & 1) != 0, conv, v);
      ch = conv.alpha ? 4 : 3;
      break;
    }
    case K_WARP: {
      const float* c = fblk + __ldg(d + D_DATA) + kCoeffs * z;
      const float* b = fblk + __ldg(d + D_AUX) + kMaxCh * z;
      const bool persp = (__ldg(d + D_FLAGS) & 1) != 0;
      if (u8) {
        const uint8_t* src = static_cast<const uint8_t*>(base);
        if (persp) {
          sample_warp<uint8_t, true>(src, src_h, src_w, nch, c, b, x, y, v);
        } else {
          sample_warp<uint8_t, false>(src, src_h, src_w, nch, c, b, x, y, v);
        }
      } else {
        const float* src = static_cast<const float*>(base);
        if (persp) {
          sample_warp<float, true>(src, src_h, src_w, nch, c, b, x, y, v);
        } else {
          sample_warp<float, false>(src, src_h, src_w, nch, c, b, x, y, v);
        }
      }
      break;
    }
    default:
      break;
  }

  run_chain(vv, ch, consts + 4 * __ldg(d + D_OP_OFF), __ldg(d + D_N_OPS),
            fblk + __ldg(d + D_FP_OFF));

  OutT* o = out + (long long)z * sn + (long long)y * sy + (long long)x * sx;
#pragma unroll
  for (int c = 0; c < kMaxCh; ++c) {
    if (c < out_ch) o[c * sc] = to_out<OutT>(v[c]);
  }
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `blk` is the parameter block and `consts` the plan's tables, laid out as
// above; `out` is uint8 (out_u8 = 1) or float32 with out_ch channels,
// element strides (sn, sc, sy, sx) per (plane, channel, row, col).
extern "C" int cvgs_divergent(const int* blk, const int* consts, int ptr_off, int desc_off,
                              int n_groups, int n_planes, int dst_w, int dst_h, void* out,
                              int out_u8, int out_ch, long long sn, long long sc, long long sy,
                              long long sx, void* stream) {
  if (out_ch < 1 || out_ch > kMaxCh || n_planes < 1 || n_planes > 65535 || n_groups < 1 ||
      dst_w < 1 || dst_h < 1 || ptr_off < n_planes || (ptr_off & 1) || desc_off <= ptr_off) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 block(64, 4);
  const dim3 grid((dst_w + 63) / 64, (dst_h + 3) / 4, n_planes);
  if (out_u8) {
    divergent_kernel<uint8_t><<<grid, block, 0, s>>>(blk, consts, ptr_off, desc_off, dst_w,
                                                     dst_h, static_cast<uint8_t*>(out), out_ch,
                                                     sn, sc, sy, sx);
  } else {
    divergent_kernel<float><<<grid, block, 0, s>>>(blk, consts, ptr_off, desc_off, dst_w, dst_h,
                                                   static_cast<float*>(out), out_ch, sn, sc, sy,
                                                   sx);
  }
  return (int)cudaGetLastError();
}
