// The composed-read kernel's nested instances for int8, uint16, int16,
// float16, int64 and float64 images, shared by all six: the inner taps'
// loads switch on the source type once around a core value's four taps
// (composed.cuh::load_taps), an int64 element read as its low 32 bits, a
// float64 one rounded to float32.

#include "composed_nested.cuh"

namespace cvgs {
void composed_nested_any(const ComposedArgs& a) { kc::launch_nested<kc::AnyType>(a); }
}  // namespace cvgs
