// The composed-read kernel's general nested instances for a divergent batch
// with a nested group whose groups read images of different element types,
// or store into the batch with different rows: letterboxes of uint8
// cameras beside regions of a uint16 sensor resized twice, float32 top
// views beside int8 ones. They are composed_kernel_nested_mixed*'s
// AnyImage instances (composed_nested.cuh), the three of a mixed nested
// batch: a block is one plane, copies its plane's head and store row from
// the consts and switches on its source type once around each core
// value's four taps (composed.cuh::load_taps), uniform over the block.
// Groups of one kind of source and one store row keep that kind's mixed
// nested instances (composed_nested.cu's C entry chooses).

#include "composed_nested.cuh"

namespace cvgs {
void composed_nested_divergent(const ComposedArgs& a) { kc::launch_nested<kc::AnyImage>(a); }
}  // namespace cvgs
