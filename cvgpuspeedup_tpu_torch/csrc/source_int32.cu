// K1, K2 and the warp kernel for a source of int32 elements (sources.cuh).

#include "sources.cuh"

CVGS_SOURCE(int32_t, i32)
