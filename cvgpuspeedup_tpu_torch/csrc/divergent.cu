// The divergent batch: a different op sequence on each plane of one batch,
// in one launch, with a strided write.
//
// Replaces cvgpuspeedup_tpu/exec/pallas_divergent.py::_emit, the TPU kernel
// of launch_divergent_batch (the reference's
// launchDivergentBatchTransformDPP_Kernel). Plane z runs the sequence of
// group table[z]; each group is one of six kinds, each reading with the
// device code of the kernel it shares a rule with:
//   image        plane z of an (N, H, W, C) stack, or a plane's own image
//   circ         plane floor_mod(first +- z, N) of a ring, `first` at runtime
//   crop_resize  a crop of one frame, resized by K1's rules (batch_resize.cuh)
//   resize       a whole plane of a stack, by K1's rules on (0, 0, w, h)
//   nv12         an NV12/NV21 buffer per plane, K2's tap tables and YUV->RGB
//                (frame_resize.cuh)
//   warp         a source per plane, 9 coefficients per plane (warp.cuh)
// then the group's chain (chain.cuh) and one strided store. A ragged
// BatchRead group (image, nv12 or warp, `used_planes` at runtime) holds its
// default on its planes from used_planes on, as ops/memory.py::BatchRead
// does; the TPU kernel refuses such a group (pallas_divergent.py:166).
//
// What bounds it: bytes in a large batch, the launch itself in a small one.
// A (16, 128, 256, 3) u8 ring read into f32 moves 7.9 MB; a batch of eight
// 64x128 planes moves about 1 MB and takes the time of an almost empty
// kernel whatever it does. In practice a large batch was bound by its
// instruction count: one thread per pixel read its descriptor with a dozen
// scalar loads, its pixel byte by byte, decoded the chain per pixel and
// stored scalars.
//
// What the design does about it:
//  - grid.z = plane; a block's planes are one, so every thread of a block
//    takes the same branch and the switch costs no divergence. A thread
//    reads its plane's group, source address and the group's 16-word
//    descriptor once, the descriptor as four 16-byte loads, all started
//    before anything depends on them.
//  - Blocks of 256 threads, a thread owning P adjacent output pixels of one
//    row (pixels_per_thread: 4 in a large launch, 1 in a small one; the
//    block is 64 x 4 threads, narrowed for a narrow plane by group_block).
//  - The image and circ kinds copy: a thread's P pixels are P * nch
//    contiguous elements, read element by element. Fetching an aligned
//    group as nch 4-byte words of uint8 or 16-byte vectors of float32 was
//    built and measured slower on an H100 (a (16, 128, 256, 3) ring: uint8
//    6.75 against 6.59 us, float32 7.18 against 6.61): a word fetch trades
//    9 one-byte loads, which hit L1, for 12 byte extractions, and the
//    float32 vectors' 16 temporaries cost registers.
//  - The sampled kinds run the samplers their kernels share (batch_resize.cuh,
//    frame_resize.cuh, warp.cuh) for each of the thread's pixels; the NV12
//    kind reads its row's taps once per thread. Their unrolled code sets the
//    register count: at 64 registers four blocks fit an SM, and a variant
//    at 72 ran the ring read a fifth slower.
//  - The chain is decoded once per op for the thread's pixels, and each
//    channel of a planar output goes out as one 16-byte store (uint8: 4
//    bytes) where the address allows (chain.cuh).
// The TPU kernel's scalar-prefetch ring, 2-slot DMA, interleaved lane
// coefficients, baked one-hot NV12 and warp matrices and VMEM/lane gates
// are not carried over: Hopper gathers, and runtime matrices, rects and
// `first`s come from the parameter block, so nothing is baked and nothing
// keys a cache.
//
// The parameter block (int32 words, exec/cuda_divergent.py::prepare):
//   [0, N)           the plane -> group table
//   ptr_off          N source addresses (8-byte words), one per plane
//   per group        first, used_planes, rects, background, warp
//                    coefficients and borders, a ragged group's default,
//                    chain scalars
//   desc_off         one descriptor (struct Desc, 16 words) per group, at a
//                    multiple of 4 words
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

// A group's descriptor, 16 int32 words in this order; keep in step with
// exec/cuda_divergent.py::prepare
struct Desc {
  int kind, src_h, src_w, nch;
  int src_u8;
  int n_src;   // planes of the ring or stack; 1 for an image group of one image per plane
  int first;   // circ: block offset of `first`; a ragged image, nv12 or warp group: of the
               // default (kMaxCh floats)
  int asc;     // circ: ascending
  int mode;    // crop, stack: aspect-ratio mode
  int used;    // crop, stack: block offset of used_planes; a ragged image, nv12 or warp
               // group: of its used_planes, else -1
  int op_off;  // first op row in the consts
  int n_ops;
  int fp_off;  // block offset of the chain scalars
  int data;    // crop, stack: rects; warp: coefficients (block); nv12: taps (consts)
  int flags;   // nv12: keep_edge | nv21 << 1 | limited << 2 | alpha << 3; warp: perspective;
               // every kind: kClampStore
  int aux;     // crop, stack: background; warp: borders (block); nv12: weights (consts)
};
static_assert(sizeof(Desc) == 64, "four 16-byte words");

// The group's float32 values go into a uint8 batch (plane 0's group gave
// the batch its dtype): clamp to [0, 255], then truncate, as the eager
// merge's astype does, not the chain's round-half-even saturate.
constexpr int kClampStore = 1 << 8;

__device__ __forceinline__ Desc load_desc(const int* __restrict__ p) {
  const int4* q = reinterpret_cast<const int4*>(p);
  const int4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2), d = __ldg(q + 3);
  return {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, c.y, c.z, c.w, d.x, d.y, d.z, d.w};
}

// The adjacent output pixels a thread takes, from the launch's output
// count: 4 where a thread per 4 pixels still fills a third of the card's
// resident threads, else 1. On an H100 (360,448 outputs; profiler medians,
// 1 pixel against 4): a ring copy of 12 planes of 128x256 (393,216) 6.82
// against 5.90 us, of 8 planes 5.25 against 5.06; 40 planes of warp | crop |
// pass at 64x128 (327,680) 7.16 against 7.86, 48 planes 8.03 against 8.14;
// eight planes (65,536) 3.1 to 3.8 against 4.2 to 6.3. 2 pixels per thread
// lost everywhere (the 16-plane ring 14.8 against 6.7 us).
inline int pixels_per_thread(long long outputs) {
  return 3 * outputs >= 4 * resident_threads() ? 4 : 1;
}

template <typename OutT, int P>
__global__ void __launch_bounds__(256) divergent_kernel(
    const int* __restrict__ blk, const int* __restrict__ consts, int ptr_off, int desc_off,
    int dst_w, int dst_h, OutT* __restrict__ out, int out_ch, long long sn, long long sc,
    long long sy, long long sx) {
  const int x = (blockIdx.x * blockDim.x + threadIdx.x) * P;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int z = blockIdx.z;
  if (x >= dst_w || y >= dst_h) return;
  const int n = min(P, dst_w - x);

  const float* fblk = reinterpret_cast<const float*>(blk);
  const float* fconsts = reinterpret_cast<const float*>(consts);
  // the plane's uniform loads: its source address beside its group, then
  // the group's descriptor in four loads
  const int group = __ldg(blk + z);
  const void* base = reinterpret_cast<const void*>(
      __ldg(reinterpret_cast<const unsigned long long*>(blk + ptr_off) + z));
  const Desc d = load_desc(blk + desc_off + (int)(sizeof(Desc) / 4) * group);
  const bool u8 = d.src_u8 != 0;
  const int src_h = d.src_h, src_w = d.src_w, nch = d.nch;

  float v[P][kMaxCh];
#pragma unroll
  for (int q = 0; q < P; ++q) {
#pragma unroll
    for (int c = 0; c < kMaxCh; ++c) v[q][c] = 0.f;
  }
  int ch = d.kind == K_NV12 ? ((d.flags >> 3) & 1 ? 4 : 3) : nch;
  // a ragged BatchRead group (images, NV12 reads or warps): its planes from
  // used_planes on hold its default, which then runs through the chain
  const bool held =
      d.kind != K_CROP && d.kind != K_STACK && d.used >= 0 && z >= __ldg(blk + d.used);
  if (held) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) v[q][c] = c < ch ? __ldg(fblk + d.first + c) : 0.f;
    }
  }
  switch (held ? -1 : d.kind) {
    case K_IMAGE:
    case K_CIRC: {
      int pz = d.n_src == 1 ? 0 : z;  // a stack's plane z, or the plane's own image
      if (d.kind == K_CIRC) {
        const int first = __ldg(blk + d.first);
        const int t = d.asc ? first + z : first - z;
        pz = t - floor_div(t, d.n_src) * d.n_src;  // floor modulo, as Python's %
      }
      const long long off = (((long long)pz * src_h + y) * src_w + x) * nch;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (q >= n) continue;
        if (u8) {
          load_pixel(static_cast<const uint8_t*>(base) + off + q * nch, nch, v[q]);
        } else {
          load_pixel(static_cast<const float*>(base) + off + q * nch, nch, v[q]);
        }
      }
      break;
    }
    case K_CROP:
    case K_STACK: {
      const float* bg = fblk + d.aux;
      const bool used = z < __ldg(blk + d.used);
      const int* r = blk + d.data + 4 * z;
      const int rx = __ldg(r), ry = __ldg(r + 1), rw = __ldg(r + 2), rh = __ldg(r + 3);
      const long long plane = d.kind == K_STACK ? (long long)z * src_h * src_w * nch : 0;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (q >= n) continue;
        bool sampled = false;
        if (used) {
          if (u8) {
            sampled = sample_crop(static_cast<const uint8_t*>(base) + plane, src_h, src_w, nch,
                                  rx, ry, rw, rh, dst_w, dst_h, d.mode, x + q, y, v[q]);
          } else {
            sampled = sample_crop(static_cast<const float*>(base) + plane, src_h, src_w, nch, rx,
                                  ry, rw, rh, dst_w, dst_h, d.mode, x + q, y, v[q]);
          }
        }
        if (!sampled) {
#pragma unroll
          for (int c = 0; c < kMaxCh; ++c) v[q][c] = c < nch ? __ldg(bg + c) : 0.f;
        }
      }
      break;
    }
    case K_NV12: {
      const float* wts = fconsts + d.aux;
      const float* cf = wts + dst_w + dst_h;
      const Conv conv{(d.flags >> 2) & 1, (d.flags >> 3) & 1, __ldg(cf),     __ldg(cf + 1),
                      __ldg(cf + 2),      __ldg(cf + 3),      __ldg(cf + 4), __ldg(cf + 5)};
      const int* taps = consts + d.data;
      nv12_pixels<P>(nv12_rows(static_cast<const uint8_t*>(base), src_h, src_w, taps, wts, dst_w,
                               dst_h, y),
                     (d.flags >> 1) & 1, taps, wts, dst_w, dst_h, x, n, (d.flags & 1) != 0, conv, v);
      break;
    }
    case K_WARP: {
      const float* c = fblk + d.data + kCoeffs * z;
      const float* b = fblk + d.aux + kMaxCh * z;
      const bool persp = (d.flags & 1) != 0;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (q >= n) continue;
        if (u8) {
          const uint8_t* src = static_cast<const uint8_t*>(base);
          if (persp) {
            sample_warp<uint8_t, true>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
          } else {
            sample_warp<uint8_t, false>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
          }
        } else {
          const float* src = static_cast<const float*>(base);
          if (persp) {
            sample_warp<float, true>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
          } else {
            sample_warp<float, false>(src, src_h, src_w, nch, c, b, x + q, y, v[q]);
          }
        }
      }
      break;
    }
    default:
      break;
  }

  run_chain(v, ch, consts + 4 * d.op_off, d.n_ops, fblk + d.fp_off);

  if (d.flags & kClampStore) {
#pragma unroll
    for (int q = 0; q < P; ++q) {
#pragma unroll
      for (int c = 0; c < kMaxCh; ++c) v[q][c] = fminf(fmaxf(v[q][c], 0.f), 255.f);
    }
  }

  store_any(out + (long long)z * sn + (long long)y * sy + (long long)x * sx, v, n, out_ch, sc, sx);
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `blk` is the parameter block and `consts` the plan's tables, laid out as
// above; `out` is uint8 (out_u8 = 1) or float32 with out_ch channels,
// element strides (sn, sc, sy, sx) per (plane, channel, row, col). `blk`
// lies at a multiple of 16 bytes and `desc_off` is a multiple of 4.
extern "C" int cvgs_divergent(const int* blk, const int* consts, int ptr_off, int desc_off,
                              int n_groups, int n_planes, int dst_w, int dst_h, void* out,
                              int out_u8, int out_ch, long long sn, long long sc, long long sy,
                              long long sx, void* stream) {
  if (out_ch < 1 || out_ch > kMaxCh || n_planes < 1 || n_planes > 65535 || n_groups < 1 ||
      dst_w < 1 || dst_h < 1 || ptr_off < n_planes || (ptr_off & 1) || desc_off <= ptr_off ||
      (desc_off & 3) || (reinterpret_cast<unsigned long long>(blk) & 15ull)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pix = pixels_per_thread((long long)n_planes * dst_w * dst_h);
  const dim3 block = group_block(dst_w, pix);
  const int tile_w = block.x * pix;
  const dim3 grid((dst_w + tile_w - 1) / tile_w, (dst_h + block.y - 1) / block.y, n_planes);
#define CVGS_KERNEL(OutT, P)                                                                \
  divergent_kernel<OutT, P><<<grid, block, 0, s>>>(blk, consts, ptr_off, desc_off, dst_w,   \
                                                   dst_h, static_cast<OutT*>(out), out_ch,  \
                                                   sn, sc, sy, sx)
  if (out_u8 && pix == 4) {
    CVGS_KERNEL(uint8_t, 4);
  } else if (out_u8) {
    CVGS_KERNEL(uint8_t, 1);
  } else if (pix == 4) {
    CVGS_KERNEL(float, 4);
  } else {
    CVGS_KERNEL(float, 1);
  }
#undef CVGS_KERNEL
  return (int)cudaGetLastError();
}
