// K1, K2 and the warp kernel for a source of int8 elements (sources.cuh).

#include "sources.cuh"

CVGS_SOURCE(int8_t, i8)
