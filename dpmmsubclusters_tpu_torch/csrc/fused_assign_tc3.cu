// Kernel A's assign pass on the tensor cores, the three-pass bf16 split
// (ll_precision "high"): the instantiations of fused_assign_tc.cuh with two
// planes (rows and phi each as hi + lo).
#include "fused_assign_tc.cuh"

namespace dpmm {
DPMM_TC_INSTANTIATE_ALL(2);
}  // namespace dpmm
