// The split divergent kernel's nested instances of float32 and int32 outputs
// (divergent_split.cuh; the C entry in divergent_split.cu): K6's body beside
// the composed part's nested body with a FusedRead2 alone, a second
// resample per tap, or staged.

#include "divergent_split.cuh"

namespace cvgs {
void divergent_split_nested_f32(const SplitArgs& a) { kc::launch_split_nested<float>(a); }
}  // namespace cvgs
