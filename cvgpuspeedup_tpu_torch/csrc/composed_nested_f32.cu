// The composed-read kernel's nested instances for float32 and int32 images
// (an int32 element read as float32's words: its bits), beside
// composed_nested.cu's uint8 ones (composed_nested.cuh).

#include "composed_nested.cuh"

namespace cvgs {
void composed_nested_f32(const ComposedArgs& a) { kc::launch_nested<float>(a); }
}  // namespace cvgs
