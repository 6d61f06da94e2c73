// The composed-read kernel for NV12/NV21 buffers: a tap reads its luma
// byte and its chroma pair (composed.cuh).

#include "composed.cuh"

namespace cvgs {
void composed_nv12(const ComposedArgs& a) { kc::launch_source<kc::Nv12>(a); }
}  // namespace cvgs
