// The split divergent kernel's one-level instances over a composed part of
// any image sources or store rows (AnyImage: the general body, which reads
// each plane's store row), beside K6's part (divergent_split.cuh; the C
// entry in divergent_split.cu).

#include "divergent_split.cuh"

namespace cvgs {
void divergent_split_any(const SplitArgs& a) { kc::launch_split<kc::AnyImage>(a); }
}  // namespace cvgs
