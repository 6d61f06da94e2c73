// The split divergent kernel's nested instances over a composed part of
// any image sources or store rows (AnyImage), beside K6's part
// (divergent_split.cuh; the C entry in divergent_split.cu).

#include "divergent_split.cuh"

namespace cvgs {
void divergent_split_nested_any(const SplitArgs& a) { kc::launch_split_nested<kc::AnyImage>(a); }
}  // namespace cvgs
