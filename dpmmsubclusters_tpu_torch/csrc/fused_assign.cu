// Kernel A: the per-sweep assignment + statistics pass.
//
// Replaces dpmmsubclusters_tpu/ops/pallas_sweep.py:518 fused_assign (kernel
// body _kernel, :264-385), "precomputed" variant.  Per point (a row of the
// f32 feature cache [N, F]):
//   ll    = feat @ phi                 phi [F, 2K]: [whole K | delta K]
//   label = argmax_j (ll_j + log_w_j + G_j)   NaN -> -inf, first max wins,
//           G_j zeroed in hard mode
//   side  = [ll_{K+label} + (G_r - G_l) + 1e-30 > 0]    (always sampled)
// then the [LEFT K | RIGHT K] x F statistics of the new labels, masked by
// ``valid`` (launch_stats, shared with kernel B and launched back to back).
// The Gumbel noise is the TPU kernel's counter hash, bit for bit: per hash
// tile of ``tile`` rows the seed is fmix32(seed + (tile_off + row / tile) *
// 0x9E3779B9) and the counter is (row % tile) * K + j (labels) or
// (row % tile) * 2 + {0, 1} with seed ^ 0xA5A5A5A5 (the sub-label pair).
// ``tile`` belongs to the hash only; the CUDA block size is independent.
//
// What bounds it on the H100: the ll product is F * 2K * 2 flop per point
// for 4F bytes read -- 128 flop/byte at K=128, so it is compute-bound in
// exact float32 (no tensor cores: 67 TFLOP/s peak, about 4.5 ms per sweep
// at 1M x 32-d).  The statistics pass is memory-bound (see
// stats_from_labels.cu).
//
// Design (right and simple first; no wgmma or TMA yet): a block of 8 warps
// owns 64 points and all 2K columns.  Each warp owns 8 points and each lane
// the columns lane + 32c, so a warp holds whole rows of ll in registers:
// the Gumbel argmax is a warp shuffle reduction and the sub-label's delta
// column is one shuffle away -- ll never touches device memory.  The
// product is a register-blocked SGEMM over 16-deep slices of F staged in
// shared memory by asynchronous copies (cp.async, two stages, so the next
// slice loads while this one is multiplied); feature values are
// warp-broadcast reads, phi reads are conflict-free across lanes.  Each
// block rereads phi (574 KB at K=128) from L2.
#include "dpmm_kernels.cuh"

#include <cmath>

namespace dpmm {
namespace {

constexpr int kWarps = 8;
constexpr int kPointsPerWarp = 8;
constexpr int kBlockPoints = kWarps * kPointsPerWarp;  // 64
constexpr int kDepth = 16;                             // F slice per stage
constexpr int kThreads = kWarps * 32;
constexpr int kAPad = 4;  // keeps the float4 reads aligned, spreads banks

// Draws the label and sub-label of row ``g`` from its ll row, spread over
// the warp's lanes (column lane + 32c in ll[c]).  Called by all 32 lanes.
template <int CPT>
__device__ __forceinline__ void sample_row(const float (&ll)[CPT], int g,
                                           uint32_t seed, int tile_off,
                                           int tile, int k, int lane,
                                           float noise,
                                           const float* __restrict__ log_w,
                                           int32_t* __restrict__ labels,
                                           int32_t* __restrict__ sub) {
  const uint32_t s = tile_seed(
      seed, static_cast<uint32_t>(tile_off) + static_cast<uint32_t>(g / tile));
  const uint32_t rit = static_cast<uint32_t>(g % tile);

  // lane-local Gumbel argmax over this lane's whole columns
  float best_v = -INFINITY;
  int best_j = 0x7fffffff;
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = lane + 32 * c;
    if (j < k) {
      float logit = ll[c] + log_w[j];
      if (isnan(logit)) logit = -INFINITY;
      const float v =
          logit + gumbel(s, rit * static_cast<uint32_t>(k) +
                                static_cast<uint32_t>(j)) * noise;
      if (v > best_v || (v == best_v && j < best_j)) {
        best_v = v;
        best_j = j;
      }
    }
  }
  // warp argmax; ties keep the smaller column (jnp.argmax's first max)
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, best_v, off);
    const int oj = __shfl_xor_sync(0xffffffffu, best_j, off);
    if (ov > best_v || (ov == best_v && oj < best_j)) {
      best_v = ov;
      best_j = oj;
    }
  }
  const int label = best_j;

  // the delta column K + label lives on lane (K + label) % 32, slot c
  const int jd = k + label;
  const int cd = jd / 32;
  float mine = 0.0f;
#pragma unroll
  for (int c = 0; c < CPT; ++c)
    if (c == cd) mine = ll[c];
  const float delta = __shfl_sync(0xffffffffu, mine, jd % 32);
  const uint32_t s2 = s ^ 0xA5A5A5A5u;
  const float g_l = gumbel(s2, rit * 2u);
  const float g_r = gumbel(s2, rit * 2u + 1u);
  if (lane == 0) {
    labels[g] = label;
    sub[g] = (delta + (g_r - g_l) + 1e-30f > 0.0f) ? 1 : 0;
  }
}

// 4-byte asynchronous global -> shared copy; ``ok`` false zero-fills (the
// source is then not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

template <int CPT>  // columns per lane: 2K <= 32 * CPT
__global__ void __launch_bounds__(kThreads)
assign_kernel(const float* __restrict__ feat, const float* __restrict__ phi,
              const float* __restrict__ log_w,
              const int32_t* __restrict__ seed_ptr, int tile_off, int hard,
              int tile, int n, int f, int k, int32_t* __restrict__ labels,
              int32_t* __restrict__ sub) {
  constexpr int kCols = 32 * CPT;
  // two stages: the copies of slice t+1 fly while slice t is multiplied
  __shared__ __align__(16) float a_s[2][kDepth][kBlockPoints + kAPad];
  __shared__ float b_s[2][kDepth][kCols];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kBlockPoints;
  const int two_k = 2 * k;

  // stage feat[row0:row0+64, k0:k0+16] (transposed) and phi[k0:k0+16, :],
  // zero-filled past the edges
  auto load_slice = [&](int stage, int k0) {
    const int kk = tid % kDepth;
    const int fc = k0 + kk;
#pragma unroll
    for (int i = 0; i < kBlockPoints * kDepth / kThreads; ++i) {
      const int r = tid / kDepth + i * (kThreads / kDepth);
      const int g = row0 + r;
      const bool ok = g < n && fc < f;
      cp_async4(&a_s[stage][kk][r],
                ok ? feat + static_cast<size_t>(g) * f + fc : feat, ok);
    }
#pragma unroll
    for (int idx = tid; idx < kDepth * kCols; idx += kThreads) {
      const int kr = idx / kCols;
      const int c = idx % kCols;
      const int fr = k0 + kr;
      const bool ok = fr < f && c < two_k;
      cp_async4(&b_s[stage][kr][c],
                ok ? phi + static_cast<size_t>(fr) * two_k + c : phi, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[kPointsPerWarp][CPT];
#pragma unroll
  for (int r = 0; r < kPointsPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[r][c] = 0.0f;

  const int slices = (f + kDepth - 1) / kDepth;
  load_slice(0, 0);
  for (int t = 0; t < slices; ++t) {
    const int cur = t & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // slice t is visible; everyone is done with slice t-1
    if (t + 1 < slices) load_slice(cur ^ 1, (t + 1) * kDepth);
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(
          &a_s[cur][kk][warp * kPointsPerWarp]);
      const float4 a1 = *reinterpret_cast<const float4*>(
          &a_s[cur][kk][warp * kPointsPerWarp + 4]);
      const float a[kPointsPerWarp] = {a0.x, a0.y, a0.z, a0.w,
                                       a1.x, a1.y, a1.z, a1.w};
      float b[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) b[c] = b_s[cur][kk][lane + 32 * c];
#pragma unroll
      for (int r = 0; r < kPointsPerWarp; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }

  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  const float noise = hard ? 0.0f : 1.0f;
#pragma unroll
  for (int r = 0; r < kPointsPerWarp; ++r) {
    const int g = row0 + warp * kPointsPerWarp + r;
    if (g < n) sample_row<CPT>(acc[r], g, seed, tile_off, tile, k, lane,
                               noise, log_w, labels, sub);
  }
}

template <int CPT>
cudaError_t launch_assign(const float* feat, const float* phi,
                          const float* log_w, const int32_t* seed,
                          int tile_off, int hard, int tile, int n, int f,
                          int k, int32_t* labels, int32_t* sub,
                          cudaStream_t stream) {
  const int blocks = (n + kBlockPoints - 1) / kBlockPoints;
  assign_kernel<CPT><<<blocks, kThreads, 0, stream>>>(
      feat, phi, log_w, seed, tile_off, hard, tile, n, f, k, labels, sub);
  return cudaGetLastError();
}

}  // namespace
}  // namespace dpmm

extern "C" int dpmm_fused_assign(const float* feat, const uint8_t* valid,
                                 const float* phi, const float* log_w,
                                 const int32_t* seed, int tile_off, int hard,
                                 int tile, int n, int f, int k,
                                 int32_t* labels, int32_t* sub,
                                 float* partial, float* stats, void* stream) {
  using namespace dpmm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  const int two_k = 2 * k;
  if (two_k <= 32) {
    err = launch_assign<1>(feat, phi, log_w, seed, tile_off, hard, tile, n, f,
                           k, labels, sub, st);
  } else if (two_k <= 64) {
    err = launch_assign<2>(feat, phi, log_w, seed, tile_off, hard, tile, n, f,
                           k, labels, sub, st);
  } else if (two_k <= 128) {
    err = launch_assign<4>(feat, phi, log_w, seed, tile_off, hard, tile, n, f,
                           k, labels, sub, st);
  } else if (two_k <= 256) {
    err = launch_assign<8>(feat, phi, log_w, seed, tile_off, hard, tile, n, f,
                           k, labels, sub, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_stats(feat, labels, sub, valid, n, f, k, partial, stats, st));
}
