// The split divergent kernel's nested instances over a composed part of
// uint8 images with one store row (divergent_split.cuh; the C entry in
// divergent_split.cu): K6's part beside the composed part's nested body
// with a FusedRead2 alone, a second resample per tap, or staged.

#include "divergent_split.cuh"

namespace cvgs {
void divergent_split_nested_u8(const SplitArgs& a) { kc::launch_split_nested<uint8_t>(a); }
}  // namespace cvgs
