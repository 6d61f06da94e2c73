// K1, K2 and the warp kernel for a source of float16 elements (sources.cuh).

#include "sources.cuh"

CVGS_SOURCE(f16, f16)
