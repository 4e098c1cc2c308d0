// Kernel A's narrow tensor-core passes with phi resident in shared memory:
// the instantiations of fused_assign_tc_resident.cuh, which holds the
// kernel and its note, for one plane (one bf16 pass) and two (the
// three-pass split); fused_assign_tc.cuh's launcher takes them where
// resident_bufs is not 0.
#include "fused_assign_tc_resident.cuh"

namespace dpmm {
namespace resident {
#define DPMM_RESIDENT_INSTANTIATE(Planes)                                   \
  template cudaError_t launch<Planes>(                                      \
      TileRows, const __nv_bfloat16*, const float*, const int32_t*, int,    \
      int, int, int, int, int, int, int32_t*, int32_t*, cudaStream_t)
DPMM_RESIDENT_INSTANTIATE(1);
DPMM_RESIDENT_INSTANTIATE(2);
#undef DPMM_RESIDENT_INSTANTIATE
}  // namespace resident
}  // namespace dpmm

// The ring's buffers kernel A's tensor-core pass gives the resident kernel
// at (f, k, planes) over rows ``pitch`` bytes apart (4 d for rows built
// from the raw points, 4 f for the f32 cache, 2 ld for the bf16 cache); 0
// where the pass keeps fused_assign_tc.cuh's blocks.
extern "C" int dpmm_assign_tc_resident(int f, int k, int planes, int pitch) {
  return dpmm::resident_bufs(f, k, planes, pitch);
}
