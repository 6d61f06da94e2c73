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
// A group's source is any of nine types: uint8 and float32, what the TPU
// kernel reads, and int8, uint16, int16, float16, int32, int64 and float64.
// This file's instances read uint8, float32 and float64 (float64 at load as
// float32, its canonical type); a batch with a group of another type runs
// the general instance of divergent_any.cu, over the same body
// (divergent_kernel.cuh). A copy group (image, circ) of int32 or int64
// moves int32's bits, an int64 element's low 32 bits, as an int32 chain
// holds them; a sampled group reads its source into float32 at load, as K1
// and the warp kernel do (sources.cuh).
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

#include "divergent_kernel.cuh"

namespace {

// the instances for groups of uint8, float32 and float64 sources
template <typename OutT, int P>
__global__ void __launch_bounds__(256) divergent_kernel(
    const int* __restrict__ blk, const int* __restrict__ consts, int ptr_off, int desc_off,
    int dst_w, int dst_h, OutT* __restrict__ out, int out_ch, long long sn, long long sc,
    long long sy, long long sx) {
  divergent_body<false, OutT, P>(blk, consts, ptr_off, desc_off, dst_w, dst_h, out, out_ch, sn,
                                 sc, sy, sx);
}

}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `blk` is the parameter block and `consts` the plan's tables, laid out as
// above; `out` holds elements of type `out_type` (PW_U8 .. PW_I32) with
// out_ch channels, element strides (sn, sc, sy, sx) per (plane, channel, row,
// col). `blk` lies at a multiple of 16 bytes and `desc_off` is a multiple of
// 4. `any_src` is 1 where a group reads a source type other than uint8,
// float32 and float64: the general instance (divergent_any.cu) runs the
// batch; 0 keeps this file's instances.
extern "C" int cvgs_divergent(const int* blk, const int* consts, int ptr_off, int desc_off,
                              int n_groups, int n_planes, int dst_w, int dst_h, void* out,
                              int out_type, int out_ch, long long sn, long long sc, long long sy,
                              long long sx, int any_src, void* stream) {
  if (out_ch < 1 || out_ch > kMaxCh || n_planes < 1 || n_planes > 65535 || n_groups < 1 ||
      dst_w < 1 || dst_h < 1 || ptr_off < n_planes || (ptr_off & 1) || desc_off <= ptr_off ||
      (desc_off & 3) || (reinterpret_cast<unsigned long long>(blk) & 15ull) ||
      out_type < PW_U8 || out_type > PW_I32 || (any_src != 0 && any_src != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const cvgs::DivergentArgs a{blk,  consts, ptr_off, desc_off, n_planes, dst_w, dst_h,
                              out,  out_type, out_ch, sn,     sc,       sy,    sx,
                              static_cast<cudaStream_t>(stream)};
  if (any_src) {
    cvgs::divergent_any(a);
  } else {
    CVGS_DIVERGENT_LAUNCH(divergent_kernel, a)
  }
  return (int)cudaGetLastError();
}
