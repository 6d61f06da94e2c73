// K1, K2 and the warp kernel for a source of int64 elements, each read as
// its low 32 bits, then converted as an int32 source is (sources.cuh).

#include "sources.cuh"

CVGS_SOURCE(long long, i64)
