// The composed-read kernel for float32 and int32 images (an int32 element
// read as float32's words: its bits), beside composed.cu's uint8 ones
// (composed.cuh).

#include "composed.cuh"

namespace cvgs {
void composed_f32(const ComposedArgs& a) { kc::launch_source<float>(a); }
}  // namespace cvgs
