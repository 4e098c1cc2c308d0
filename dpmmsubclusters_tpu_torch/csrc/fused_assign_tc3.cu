// Kernel A's assign pass on the tensor cores, the three-pass bf16 split
// (ll_precision "high", and "default" on float32 rows: the f32 cache and
// rows built from the points): the instantiations of fused_assign_tc.cuh
// with two planes (rows and phi each as hi + lo); at a pass width of 256
// they launch fused_assign_tc_ring.cuh's kernel.
#include "fused_assign_tc_ring.cuh"

namespace dpmm {
DPMM_TC_INSTANTIATE_ALL(2);
}  // namespace dpmm
