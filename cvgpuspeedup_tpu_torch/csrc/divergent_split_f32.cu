// The split divergent kernel's one-level instances of float32 and int32 outputs
// (divergent_split.cuh; the C entry in divergent_split.cu).

#include "divergent_split.cuh"

namespace cvgs {
void divergent_split_f32(const SplitArgs& a) { kc::launch_split<float>(a); }
}  // namespace cvgs
