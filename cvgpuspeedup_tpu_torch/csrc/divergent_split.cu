// A divergent batch split by plane between K6's body and the composed
// kernel's in one launch: the split divergent kernel (divergent_split.cuh
// has the design). Here the C entry and the one-level instances whose
// composed part reads uint8 images with one store row.
//
// Replaces, as divergent.cu and composed.cu do, the one jitted program of
// cvgpuspeedup_tpu/exec/executor.py's launch_divergent_batch (l.366-380:
// per-group region computations and a scatter merge, still one program)
// for a batch that neither K6 (pallas_divergent.py's kinds: rings, image
// stacks, resize_batch, NV12 reads, warps) nor the composed kernel's
// divergent plan (batch_reads of read trees) takes alone: a tracker's ring
// of recent frames beside fresh camera letterboxes, plain detector crops
// (resize_batch) beside warps of crops, NV12 decoder cameras beside RGB
// top views. The reference's model, FKL's
// launchDivergentBatchTransformDPP_Kernel, runs separate kernel programs per
// plane group within one launch; so does this kernel, by part, each part at
// its own launch's tiling.
//
// What bounds it: each part's own bound (K6's bytes in a large ring, the
// composed part's taps and its fixed work a pixel), in one launch in place
// of the eager merge's hundreds of kernels.

#include "divergent_split.cuh"

namespace cvgs {
void divergent_split_u8(const SplitArgs& a) { kc::launch_split<uint8_t>(a); }
}  // namespace cvgs

namespace {
// Part p's tiles over planes of dst_w x dst_h, in blocks of `block`
SplitPart part_tiles(int planes, int dst_w, int dst_h, dim3 block, int list) {
  const int tiles_x = (dst_w + block.x - 1) / block.x;
  return {planes, tiles_x, tiles_x * (int)((dst_h + block.y - 1) / block.y), list};
}
}  // namespace

// Launches on `stream` and returns the cudaError_t of the launch (0 = ok).
// `blk` is the launch's parameter block: K6's part's, laid out as
// cvgs_divergent takes it (the plane -> group table, FOREIGN (-1) at a plane
// of the composed part; ptr_off, desc_off, n_groups as there), then the
// composed part's from word cm_blk_off (a multiple of 4: the planes' source
// addresses, then its groups' values); `consts` K6's part's consts, then the
// plane lists (K6's planes in order, then the composed part's, n_planes
// words padded with zeros to a multiple of 4, ending at word
// cm_consts_off), then the composed part's from word cm_consts_off (a
// multiple of 4: each plane's head, then each plane's store row, then the
// tables). `head` points at the host's copy of the composed part's heads
// and store rows: n_planes heads of kCmWords words (kNestedWords where
// `nested`), zeros at a plane of K6's part, batch CM_DIVERGENT at a plane
// of the composed part, then n_planes store rows. (ys .. bu) is the
// composed part's YUV -> RGB. `out` holds elements of type `out_type`
// (PW_U8 .. PW_I32) with out_ch channels, element strides (sn, sc, sy, sx)
// per (plane, channel, row, col).
extern "C" int cvgs_divergent_split(const int* blk, const int* consts, int ptr_off, int desc_off,
                                    int n_groups, int cm_blk_off, int cm_consts_off,
                                    const int* head, int nested, float ys, float cs, float rv,
                                    float gu, float gv, float bu, int n_planes, int dst_w,
                                    int dst_h, void* out, int out_type, int out_ch, long long sn,
                                    long long sc, long long sy, long long sx, void* stream) {
  // K6's part, as cvgs_divergent checks it; the composed part's block
  // after K6's descriptors, its consts after the plane lists
  const int lists_words = (n_planes + 3) & ~3;
  if (out_ch < 1 || out_ch > kMaxCh || n_planes < 2 || n_planes > 65535 || n_groups < 1 ||
      dst_w < 1 || dst_h < 1 || ptr_off < n_planes || (ptr_off & 1) || desc_off <= ptr_off ||
      (desc_off & 3) || (reinterpret_cast<unsigned long long>(blk) & 15ull) ||
      out_type < PW_U8 || out_type > PW_I32 || (nested != 0 && nested != 1) || head == nullptr ||
      cm_blk_off < desc_off + (int)(sizeof(Desc) / 4) * n_groups || (cm_blk_off & 3) ||
      cm_consts_off < lists_words || (cm_consts_off & 3)) {
    return (int)cudaErrorInvalidValue;
  }
  // the composed part: each of its planes' head in the launch's instance
  // (the first's form), a store row, no NV12 buffer (the general instances
  // read images alone), a YUV -> RGB of one range; a plane of K6's part
  // holds zeros. Both parts hold a plane. Planes of uint8 images with one
  // store row run the uint8 body, with the row as the launch's (as
  // composed.cu's C entry picks the uint8 mixed instances), any other part
  // the AnyImage body, which reads each plane's row.
  const int width = nested ? kc::kNestedWords : kCmWords;
  kc::CmNested first{}, p{};
  int composed = 0, limited = 0, store = 0;
  bool converts = false, stage = false, u8 = true;
  for (int z = 0; z < n_planes; ++z) {
    std::memcpy(&p, head + (long long)z * width, sizeof(int) * width);
    const int row = head[(long long)n_planes * width + z];
    if (p.h.batch != CM_DIVERGENT) {
      if (p.h.batch != CM_ONE || row != 0) return (int)cudaErrorInvalidValue;
      continue;
    }
    const bool ok = nested ? nested_ok(p) && (!composed || same_nested_instance(first, p))
                           : head_ok(p.h) && (!composed || same_instance(first.h, p.h));
    if (!ok || row < 0 || p.h.lower.base == PW_YUV) return (int)cudaErrorInvalidValue;
    if (!composed) first = p, store = row;
    if (p.h.lower.conv_first) {
      if (converts && p.h.lower.limited != limited) return (int)cudaErrorInvalidValue;
      limited = p.h.lower.limited, converts = true;
    }
    stage = stage || (nested && p.stage2 != 0);
    u8 = u8 && source_kind(p.h.lower) == 0 && row == store;
    ++composed;
  }
  if (composed < 1 || composed >= n_planes) return (int)cudaErrorInvalidValue;
  const int form = !nested                 ? (first.h.core == CM_NONE ? kc::SPLIT_ONE_PIXEL
                                                                      : kc::SPLIT_RESAMPLE)
                   : first.core2 == CM_NONE ? kc::SPLIT_FUSED2
                   : stage                  ? kc::SPLIT_STAGED
                                            : kc::SPLIT_PER_TAP;
  // each part's tiles: K6's part group_block's 64 x 4 at one pixel a
  // thread, the composed part's its form's (the nested launch's tile with a
  // second resample)
  const int k6_planes = n_planes - composed;
  const bool tile = form == kc::SPLIT_PER_TAP || form == kc::SPLIT_STAGED;
  const dim3 group(kc::kGroupW, kc::kThreads / kc::kGroupW);
  const SplitPart k6 = part_tiles(k6_planes, dst_w, dst_h, group, 0);
  const SplitPart cm = part_tiles(composed, dst_w, dst_h,
                                  tile ? dim3(kc::kTile2W, kc::kTile2H) : group, k6_planes);
  if ((long long)k6.planes * k6.tiles + (long long)cm.planes * cm.tiles > INT_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  const cvgs::SplitArgs a{blk,
                          consts,
                          ptr_off,
                          desc_off,
                          blk + cm_blk_off,
                          consts + cm_consts_off,
                          consts + cm_consts_off - lists_words,
                          k6,
                          cm,
                          Conv{limited, 0, ys, cs, rv, gu, gv, bu},
                          form,
                          n_planes,
                          dst_w,
                          dst_h,
                          out,
                          out_type,
                          out_ch,
                          u8 ? store : 0,
                          sn,
                          sc,
                          sy,
                          sx,
                          static_cast<cudaStream_t>(stream)};
  // the instance of the form and the composed part's source kind; K6's
  // store reads out_type at run time
  if (u8) {
    nested ? cvgs::divergent_split_nested_u8(a) : cvgs::divergent_split_u8(a);
  } else {
    nested ? cvgs::divergent_split_nested_any(a) : cvgs::divergent_split_any(a);
  }
  return (int)cudaGetLastError();
}
