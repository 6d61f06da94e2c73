// K1, K2 and the warp kernel for a source of int16 elements (sources.cuh).

#include "sources.cuh"

CVGS_SOURCE(int16_t, i16)
