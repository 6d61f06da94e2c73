// The composed-read kernel's general instances for a divergent batch whose
// groups read images of different element types, or store into the batch
// with different rows: uint8 cameras beside a uint16 sensor, float32 beside
// int8. They are composed_kernel_mixed's AnyImage instances (composed.cuh):
// a block is one plane, copies its plane's head and store row from the
// consts and switches on its source type once around all of a thread's
// loads, so the switch is uniform over the block. Groups of one kind of
// source and one store row keep that kind's mixed instances (composed.cu's
// C entry chooses).

#include "composed.cuh"

namespace cvgs {
void composed_divergent(const ComposedArgs& a) { kc::launch_source<kc::AnyImage>(a); }
}  // namespace cvgs
