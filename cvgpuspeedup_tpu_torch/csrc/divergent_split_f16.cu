// The split divergent kernel's one-level instances of float16 outputs
// (divergent_split.cuh; the C entry in divergent_split.cu).

#include "divergent_split.cuh"

namespace cvgs {
void divergent_split_f16(const SplitArgs& a) { kc::launch_split<f16>(a); }
}  // namespace cvgs
