// The register-blocked, exact float32 row x phi product that kernels A
// (fused_assign.cu, ll_precision "highest") and D (kernel_ablate.cu) share.
// Kernel A's other precisions take the tensor cores (fused_assign_tc.cuh).
//
// A block of ``Warps`` warps owns Warps * 8 points.  Each warp owns 8 points
// and each lane the columns lane + 32c, so a warp holds whole rows of the
// product in registers.  The product runs over 16-deep slices of F staged in
// shared memory, two stages so the next slice loads while this one is
// multiplied: phi slices and f32 cache rows by asynchronous copies
// (cp.async, 4 bytes each); built rows, read from x, and bf16 cache rows
// (2-byte loads, which cp.async cannot make) go into registers before the
// multiply and are converted and stored after it, so F needs no padding.
// Feature values are warp-broadcast reads, phi reads are conflict-free
// across lanes.  Every thread stages 4 of the block's rows of a slice
// (Warps * 8 points x 16 features over Warps * 32 threads) at any size.
#pragma once

#include "dpmm_kernels.cuh"

#include <type_traits>

namespace dpmm {

constexpr int kPointsPerWarp = 8;
constexpr int kDepth = 16;  // F slice per stage
constexpr int kAPad = 4;    // keeps the float4 reads aligned, spreads banks

template <int CPT, int Warps>
struct Stage {
  float a[2][kDepth][Warps * kPointsPerWarp + kAPad];  // rows, transposed
  float b[2][kDepth][32 * CPT];                        // phi columns
};

// 4-byte asynchronous global -> shared copy; ``ok`` false zero-fills (the
// source is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// acc[r][c] = row(row0 + 8 warp + r) . phi[:, col0 + lane + 32 c] for the
// phi columns col0 + [0, ncols) (leading dimension ldp); other columns and
// rows past n give 0.  Every thread of the block calls it.
template <int CPT, int Warps, class Rows>
__device__ __forceinline__ void row_products(
    const Rows& rows, const float* __restrict__ phi, int ldp, int col0,
    int ncols, int row0, int n, int f, Stage<CPT, Warps>& sm,
    float (&acc)[kPointsPerWarp][CPT]) {
  constexpr int kThreads = Warps * 32;
  constexpr int kCols = 32 * CPT;
  constexpr int kRowsPerThread =
      Warps * kPointsPerWarp * kDepth / kThreads;  // 4
  constexpr bool kCache = std::is_same<Rows, CacheRows>::value;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int kk = tid % kDepth;
  float built[kRowsPerThread];  // built rows of the next slice, in flight

  auto load_phi = [&](int stage, int k0) {
#pragma unroll
    for (int idx = tid; idx < kDepth * kCols; idx += kThreads) {
      const int kr = idx / kCols;
      const int c = idx % kCols;
      const int fr = k0 + kr;
      const bool ok = fr < f && c < ncols;
      cp_async4(&sm.b[stage][kr][c],
                ok ? phi + static_cast<size_t>(fr) * ldp + col0 + c : phi,
                ok);
    }
  };
  // rows [row0, row0 + 8 Warps) x features [k0, k0 + 16): f32 cache rows
  // copy straight into the stage; built and bf16 rows are read into
  // ``built`` and stored by store_built once the stage is free
  auto load_rows = [&](int stage, int k0) {
    const int fc = k0 + kk;
    if constexpr (kCache) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int r = tid / kDepth + i * (kThreads / kDepth);
        const int g = row0 + r;
        const bool ok = g < n && fc < f;
        cp_async4(&sm.a[stage][kk][r],
                  ok ? rows.feat + static_cast<size_t>(g) * f + fc
                     : rows.feat,
                  ok);
      }
    } else {
      const typename Rows::Col c = rows.col(fc < f ? fc : 0);
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        const int g = row0 + tid / kDepth + i * (kThreads / kDepth);
        built[i] = (g < n && fc < f) ? rows.at(c, g) : 0.0f;
      }
    }
  };
  auto store_built = [&](int stage) {
    if constexpr (!kCache) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        sm.a[stage][kk][tid / kDepth + i * (kThreads / kDepth)] = built[i];
    }
  };

#pragma unroll
  for (int r = 0; r < kPointsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.0f;

  const int slices = (f + kDepth - 1) / kDepth;
  __syncthreads();  // an earlier pass may still read the stages
  load_phi(0, 0);
  load_rows(0, 0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  store_built(0);
  for (int t = 0; t < slices; ++t) {
    const int cur = t & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // slice t is visible; everyone is done with slice t-1
    const bool next = t + 1 < slices;
    if (next) {
      load_phi(cur ^ 1, (t + 1) * kDepth);
      load_rows(cur ^ 1, (t + 1) * kDepth);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }
#pragma unroll
    for (int k2 = 0; k2 < kDepth; ++k2) {
      const float4 a0 = *reinterpret_cast<const float4*>(
          &sm.a[cur][k2][warp * kPointsPerWarp]);
      const float4 a1 = *reinterpret_cast<const float4*>(
          &sm.a[cur][k2][warp * kPointsPerWarp + 4]);
      const float a[kPointsPerWarp] = {a0.x, a0.y, a0.z, a0.w,
                                       a1.x, a1.y, a1.z, a1.w};
      float b[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) b[c] = sm.b[cur][k2][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kPointsPerWarp; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
    if (next) store_built(cur ^ 1);
  }
}

}  // namespace dpmm
