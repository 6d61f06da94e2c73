// The split divergent kernel's one-level instances of uint16 and int16 outputs
// (divergent_split.cuh; the C entry in divergent_split.cu).

#include "divergent_split.cuh"

namespace cvgs {
void divergent_split_u16(const SplitArgs& a) { kc::launch_split<uint16_t>(a); }
}  // namespace cvgs
