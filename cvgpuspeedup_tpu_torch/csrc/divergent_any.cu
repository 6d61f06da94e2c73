// The divergent kernel's general instance: a batch whose groups read any of
// the nine source types (uint8, int8, uint16, int16, float16, float32,
// int32, int64, float64), one switch on a group's type around all of a
// thread's loads (divergent_kernel.cuh::with_source). divergent.cu's C
// entry launches it where a group reads a type other than uint8, float32
// and float64; those batches keep divergent.cu's instances.

#include "divergent_kernel.cuh"

namespace {

template <typename OutT, int P>
__global__ void __launch_bounds__(256) divergent_kernel_any(
    const int* __restrict__ blk, const int* __restrict__ consts, int ptr_off, int desc_off,
    int dst_w, int dst_h, OutT* __restrict__ out, int out_ch, long long sn, long long sc,
    long long sy, long long sx) {
  divergent_body<true, OutT, P>(blk, consts, ptr_off, desc_off, dst_w, dst_h, out, out_ch, sn, sc,
                                sy, sx);
}

}  // namespace

namespace cvgs {
void divergent_any(const DivergentArgs& a) { CVGS_DIVERGENT_LAUNCH(divergent_kernel_any, a) }
}  // namespace cvgs
