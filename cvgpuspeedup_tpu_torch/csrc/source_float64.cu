// K1, K2 and the warp kernel for a source of float64 elements, each rounded
// to the nearest float32 at load (sources.cuh).

#include "sources.cuh"

CVGS_SOURCE(double, f64)
