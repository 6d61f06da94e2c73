// The composed-read kernel for int8, uint16, int16, float16, int64 and
// float64 images, one instance for all six: its loads switch on the source
// type once around all of a thread's taps (composed.cuh::load_taps), an
// int64 element read as its low 32 bits, a float64 one rounded to float32.

#include "composed.cuh"

namespace cvgs {
void composed_any(const ComposedArgs& a) { kc::launch_source<kc::AnyType>(a); }
}  // namespace cvgs
