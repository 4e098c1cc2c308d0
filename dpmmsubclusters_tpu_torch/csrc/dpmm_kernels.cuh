// Shared pieces of the sweep kernels: the counter-based Gumbel hash and the
// statistics launcher that both C entry points use.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//        -Xcompiler -fPIC (no --use_fast_math: the hash's float steps and
//        logf must round exactly as the plain versions do).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace dpmm {

// Points per statistics partial: the scatter kernel writes one [2K, F]
// partial per chunk, summed in chunk order by a second pass (deterministic,
// no float atomics).
constexpr int kStatsChunk = 16384;

// murmur3 finalizer (dpmmsubclusters_tpu/ops/pallas_sweep.py:60-67).
__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Per-tile seed: the tile index is global (tile_off + row / tile), so a
// point's draws depend only on its global row and the hash tile size.
__device__ __forceinline__ uint32_t tile_seed(uint32_t seed, uint32_t tile) {
  return fmix32(seed + tile * 0x9E3779B9u);
}

// Gumbel noise at counter ``ctr`` (pallas_sweep.py:70-87): 24-bit uniform
// u = bits * 2^-24 + 1e-12, G = -log(-log u).  The product is exact, so
// a contracted fma rounds exactly like the separate multiply and add.
__device__ __forceinline__ float gumbel(uint32_t s, uint32_t ctr) {
  const uint32_t bits = fmix32(fmix32(ctr + s) ^ (s * 0x9E3779B9u));
  const float u = static_cast<float>(bits >> 8) * (1.0f / 16777216.0f) + 1e-12f;
  return -logf(-logf(u));
}

// [LEFT K | RIGHT K] x F statistics of ``feat`` rows by (label, sub, valid)
// into ``stats``; ``partial`` is [ceil(n / kStatsChunk), 2K, F] scratch.
cudaError_t launch_stats(const float* feat, const int32_t* labels,
                         const int32_t* sub, const uint8_t* valid, int n,
                         int f, int k, float* partial, float* stats,
                         cudaStream_t stream);

}  // namespace dpmm
