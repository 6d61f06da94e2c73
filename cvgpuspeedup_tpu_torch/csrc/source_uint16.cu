// K1, K2 and the warp kernel for a source of uint16 elements (sources.cuh).

#include "sources.cuh"

CVGS_SOURCE(uint16_t, u16)
