// Kernel A's assign pass on the tensor cores, one bf16 pass (ll_precision
// "bf16", and "default" on a bf16 cache): the instantiations of
// fused_assign_tc.cuh with one
// plane, which holds the kernel and its note.  The three-pass split
// ("high") is fused_assign_tc3.cu, so the two build side by side.
#include "fused_assign_tc.cuh"

namespace dpmm {
DPMM_TC_INSTANTIATE_ALL(1);
}  // namespace dpmm

// bf16 elements of the ``phi_t`` scratch the tensor-core assign pass needs
// with ``planes`` planes of phi (1, or 2 for the three-pass split).
extern "C" long long dpmm_assign_tc_scratch(int f, int k, int planes) {
  using namespace dpmm;
  return static_cast<long long>(tc_passes(k)) * tc_width(k) * tc_padded(f) *
         planes;
}
