// The composed-read kernel's nested instances for NV12/NV21 buffers: an
// inner tap reads its luma byte and its chroma pair (composed_nested.cuh).

#include "composed_nested.cuh"

namespace cvgs {
void composed_nested_nv12(const ComposedArgs& a) { kc::launch_nested<kc::Nv12>(a); }
}  // namespace cvgs
