// Kernel A: the per-sweep assignment + statistics pass, with the exact
// float32 ll product (ll_precision "highest").  Under "default" / "bf16"
// (one bf16 pass) and "high" (the three-pass bf16 split) the assign pass is
// fused_assign_tc.cuh's, on the tensor cores; the C entry points below
// choose by ``precision`` and launch the statistics pass after either.
//
// Replaces dpmmsubclusters_tpu/ops/pallas_sweep.py:518 fused_assign (kernel
// body _kernel, :264-385; the exact dot is :322-323) in all five variants:
// "precomputed", "gaussian", "multinomial", "bfloat16" and "hybrid".  Per
// point, with feat its feature row:
//   ll    = feat @ phi                 phi [F, 2K]: [whole K | delta K]
//   label = argmax_j (ll_j + log_w_j + G_j)   NaN -> -inf, first max wins,
//           G_j zeroed in hard mode
//   side  = [ll_{K+label} + (G_r - G_l) + 1e-30 > 0]    (always sampled)
// then the [LEFT K | RIGHT K] x F statistics of the new labels, masked by
// ``valid`` (launch_stats, shared with kernel B and launched back to back).
// The feature rows come from a compile-time source (dpmm_kernels.cuh): the
// f32 cache [N, F] ("precomputed"), rows built here from the raw points
// x [N, D] ("gaussian": [1, x, triu(x x^T)]; "multinomial": [1, x]), or the
// bf16 cache [N, F] ("bfloat16": it also feeds the statistics; "hybrid":
// the statistics are built in f32 from the raw points x [N, D] kept beside
// it, so the bf16 rounding never reaches them).  The TPU kernel's selector
// matmul with bf16 planes exists only to make Mosaic build the Gaussian
// rows exactly; here a column is one rounded product.  The TPU kernel casts
// phi to bf16 for a bf16 cache at every precision; here that happens under
// "default" only (fused_assign_tc.cuh), and in this file bf16 is storage:
// each value is upcast exactly and all arithmetic is f32.
// The Gumbel noise is the TPU kernel's counter hash, bit for bit: per hash
// tile of ``tile`` rows the seed is fmix32(seed + (tile_off + row / tile) *
// 0x9E3779B9) and the counter is (row % tile) * K + j (labels) or
// (row % tile) * 2 + {0, 1} with seed ^ 0xA5A5A5A5 (the sub-label pair).
// ``tile`` belongs to the hash only; the CUDA block size is independent.
//
// What bounds it on the H100: the ll product is F * 2K * 2 flop per point
// for at most 4F bytes read -- 128 flop/byte at K=128 from the cache, and
// 2 * 2145 * 512 flop for 256 bytes of x at D=64 and K=256 -- so it is
// compute-bound in exact float32 (outside the tensor cores: 67 TFLOP/s
// peak).  A
// built row costs one multiply per feature per block, not per column.  A
// bf16 cache halves the bytes read (2F per point), which does not move a
// compute bound; it halves the cache's memory (10M x 64-d: 42.9 GB against
// 86 GB), so a cache fits the card where the f32 one does not.  The
// statistics pass is cheaper (see stats_from_labels.cu).
//
// Design (the exact path: right and simple, CUDA cores only): a block of 8
// warps owns 64 points.  Each warp owns 8 points and each lane the columns
// lane + 32c, so a warp holds whole rows of ll in registers: the Gumbel
// argmax is a warp shuffle reduction and ll never touches device memory.
// The product is the register-blocked SGEMM of row_products.cuh (built rows
// read x from L1: a block's 64 points are 16 KB at D=64).  The block size
// is a template parameter of the one-pass kernel; the fits use 8 warps, and
// the tile study (benchmarks/kernel_tile_study.py) also times 4 and 16 warps
// (32 and 128 points a block) on the f32 cache.
// Up to 2K = 256 columns (K <= 128) one pass covers [whole | delta] and the
// delta column K + label is one shuffle away.  Above, for any K, the whole
// columns go in passes of 256 with a running Gumbel argmax (the noise of
// column j depends only on j, and later passes win only a strictly larger
// value, so the first max still wins); then each point's one delta column
// is an F-long dot with the row label of ``delta_t`` [K, F] (phi's delta
// columns, transposed by the wrapper so the read is coalesced), split over
// the lanes and summed by a butterfly.
#include "row_products.cuh"

#include <cmath>

namespace dpmm {
namespace {

constexpr int kWarps = 8;  // the main path's block: 8 warps, 64 points
constexpr int kBlockPoints = kWarps * kPointsPerWarp;  // 64
constexpr int kThreads = kWarps * 32;
constexpr int kWideCPT = 8;  // columns per lane of one pass: 256 per warp
// the ll product's ``precision`` at the C entry points
constexpr int kExactF32 = 0;     // this file's kernels
constexpr int kOneBf16Pass = 1;  // fused_assign_tc.cu
constexpr int kThreeBf16Passes = 2;  // fused_assign_tc3.cu

// Folds this lane's whole columns j = j0 + lane + 32 c < k of one row into
// the running Gumbel argmax (bv, bj), then takes the warp's argmax, so every
// lane returns the same (bv, bj).  Ties keep the smaller column.
template <int CPT>
__device__ __forceinline__ void gumbel_argmax(const float (&ll)[CPT], int j0,
                                              int k, uint32_t s, uint32_t rit,
                                              float noise,
                                              const float* __restrict__ log_w,
                                              int lane, float& bv, int& bj) {
#pragma unroll
  for (int c = 0; c < CPT; ++c) {
    const int j = j0 + lane + 32 * c;
    if (j < k) {
      float logit = ll[c] + log_w[j];
      if (isnan(logit)) logit = -INFINITY;
      const float v =
          logit + gumbel(s, rit * static_cast<uint32_t>(k) +
                                static_cast<uint32_t>(j)) * noise;
      if (better(v, j, bv, bj)) {
        bv = v;
        bj = j;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
    const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
    if (better(ov, oj, bv, bj)) {
      bv = ov;
      bj = oj;
    }
  }
}

// Writes row g's label and its sub-label, drawn from the label's delta
// logit (lane 0 writes).
__device__ __forceinline__ void write_row(int g, int label, float delta,
                                          uint32_t s, uint32_t rit, int lane,
                                          int32_t* __restrict__ labels,
                                          int32_t* __restrict__ sub) {
  const uint32_t s2 = s ^ 0xA5A5A5A5u;
  const float g_l = gumbel(s2, rit * 2u);
  const float g_r = gumbel(s2, rit * 2u + 1u);
  if (lane == 0) {
    labels[g] = label;
    sub[g] = (delta + (g_r - g_l) + 1e-30f > 0.0f) ? 1 : 0;
  }
}

// K <= 128: one pass over all 2K columns [whole | delta], in blocks of
// ``Warps`` warps (Warps * 8 points).  The stage is dynamic shared memory:
// at 16 warps and 2K = 256 it is 49.7 KB, above the 48 KB of a static one.
template <int CPT, int Warps, class Rows>  // columns per lane: 2K <= 32 CPT
__global__ void __launch_bounds__(Warps * 32)
assign_kernel(Rows rows, const float* __restrict__ phi,
              const float* __restrict__ log_w,
              const int32_t* __restrict__ seed_ptr, int tile_off, int hard,
              int tile, int n, int f, int k, int32_t* __restrict__ labels,
              int32_t* __restrict__ sub) {
  extern __shared__ __align__(16) unsigned char smem[];
  auto& sm = *reinterpret_cast<Stage<CPT, Warps>*>(smem);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * Warps * kPointsPerWarp;

  float acc[kPointsPerWarp][CPT];
  row_products<CPT, Warps>(rows, phi, 2 * k, 0, 2 * k, row0, n, f, sm, acc);

  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  const float noise = hard ? 0.0f : 1.0f;
#pragma unroll
  for (int r = 0; r < kPointsPerWarp; ++r) {
    const int g = row0 + warp * kPointsPerWarp + r;
    if (g >= n) continue;  // uniform across the warp
    const uint32_t s = tile_seed(
        seed, static_cast<uint32_t>(tile_off) + static_cast<uint32_t>(g / tile));
    const uint32_t rit = static_cast<uint32_t>(g % tile);
    float bv = -INFINITY;
    int bj = 0x7fffffff;
    gumbel_argmax<CPT>(acc[r], 0, k, s, rit, noise, log_w, lane, bv, bj);
    // the delta column K + label lives on lane (K + label) % 32, slot c
    const int jd = k + bj;
    const int cd = jd / 32;
    float mine = 0.0f;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (c == cd) mine = acc[r][c];
    const float delta = __shfl_sync(0xffffffffu, mine, jd % 32);
    write_row(g, bj, delta, s, rit, lane, labels, sub);
  }
}

// Any K: the whole columns in passes of 256, then one delta dot per point.
// Two blocks per SM: the running argmax (16 registers a thread) pushed the
// kernel to 154 registers and one block (8 warps) per SM, 25% slower
// (76 -> 57 ms at 1M x 64-d, K=256 on an H100).
template <class Rows>
__global__ void __launch_bounds__(kThreads, 2)
assign_wide_kernel(Rows rows, const float* __restrict__ phi,
                   const float* __restrict__ delta_t,
                   const float* __restrict__ log_w,
                   const int32_t* __restrict__ seed_ptr, int tile_off,
                   int hard, int tile, int n, int f, int k,
                   int32_t* __restrict__ labels, int32_t* __restrict__ sub) {
  constexpr int CPT = kWideCPT;
  __shared__ __align__(16) Stage<CPT, kWarps> sm;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * kBlockPoints;
  const int wrow0 = row0 + warp * kPointsPerWarp;

  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  const float noise = hard ? 0.0f : 1.0f;
  // row g's hash seed, recomputed where needed rather than held
  auto seed_of = [&](int g) {
    return tile_seed(seed, static_cast<uint32_t>(tile_off) +
                               static_cast<uint32_t>(g / tile));
  };
  float bv[kPointsPerWarp];
  int bj[kPointsPerWarp];
#pragma unroll
  for (int r = 0; r < kPointsPerWarp; ++r) {
    bv[r] = -INFINITY;
    bj[r] = 0x7fffffff;
  }

  float acc[kPointsPerWarp][CPT];
  for (int j0 = 0; j0 < k; j0 += 32 * CPT) {
    row_products<CPT, kWarps>(rows, phi, 2 * k, j0, min(32 * CPT, k - j0),
                              row0, n, f, sm, acc);
#pragma unroll
    for (int r = 0; r < kPointsPerWarp; ++r)
      gumbel_argmax<CPT>(acc[r], j0, k, seed_of(wrow0 + r),
                         static_cast<uint32_t>((wrow0 + r) % tile), noise,
                         log_w, lane, bv[r], bj[r]);
  }

  // delta_{label} = row . delta_t[label, :], lane l taking f = l + 32 t
  float dot[kPointsPerWarp];
#pragma unroll
  for (int r = 0; r < kPointsPerWarp; ++r) dot[r] = 0.0f;
  for (int fc = lane; fc < f; fc += 32) {
    const typename Rows::Col c = rows.col(fc);
#pragma unroll
    for (int r = 0; r < kPointsPerWarp; ++r) {
      const int g = wrow0 + r;
      if (g < n)
        dot[r] = fmaf(rows.at(c, g),
                      delta_t[static_cast<size_t>(bj[r]) * f + fc], dot[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < kPointsPerWarp; ++r) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
    const int g = wrow0 + r;
    if (g < n)
      write_row(g, bj[r], dot[r], seed_of(g),
                static_cast<uint32_t>(g % tile), lane, labels, sub);
  }
}

template <int CPT, int Warps, class Rows>
cudaError_t launch_narrow_cpt(Rows rows, const float* phi, const float* log_w,
                          const int32_t* seed, int tile_off, int hard,
                          int tile, int n, int f, int k, int32_t* labels,
                          int32_t* sub, cudaStream_t st) {
  constexpr int kBytes = sizeof(Stage<CPT, Warps>);
  auto kernel = assign_kernel<CPT, Warps, Rows>;
  if (kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
    if (err != cudaSuccess) return err;
  }
  constexpr int kPoints = Warps * kPointsPerWarp;
  kernel<<<(n + kPoints - 1) / kPoints, Warps * 32, kBytes, st>>>(
      rows, phi, log_w, seed, tile_off, hard, tile, n, f, k, labels, sub);
  return cudaGetLastError();
}

template <int Warps, class Rows>
cudaError_t launch_narrow(Rows rows, const float* phi, const float* log_w,
                          const int32_t* seed, int tile_off, int hard,
                          int tile, int n, int f, int k, int32_t* labels,
                          int32_t* sub, cudaStream_t st) {
  const int two_k = 2 * k;
#define DPMM_ASSIGN(CPT)                                                   \
  return launch_narrow_cpt<CPT, Warps>(rows, phi, log_w, seed, tile_off,  \
                                       hard, tile, n, f, k, labels, sub, st)
  if (two_k <= 32) DPMM_ASSIGN(1);
  if (two_k <= 64) DPMM_ASSIGN(2);
  if (two_k <= 128) DPMM_ASSIGN(4);
  DPMM_ASSIGN(8);
#undef DPMM_ASSIGN
}

// ``warps`` other than 8 (4 or 16: the tile study's block sizes) is taken
// only by the f32 cache at K <= 128.
template <class Rows>
cudaError_t launch_assign(Rows rows, const float* phi, const float* delta_t,
                          const float* log_w, const int32_t* seed,
                          int tile_off, int hard, int tile, int n, int f,
                          int k, int warps, int32_t* labels, int32_t* sub,
                          cudaStream_t st) {
  if (2 * k > 256) {
    if (warps != kWarps) return cudaErrorInvalidValue;
    assign_wide_kernel<Rows><<<(n + kBlockPoints - 1) / kBlockPoints,
                               kThreads, 0, st>>>(
        rows, phi, delta_t, log_w, seed, tile_off, hard, tile, n, f, k,
        labels, sub);
    return cudaGetLastError();
  }
  if (warps == kWarps)
    return launch_narrow<kWarps>(rows, phi, log_w, seed, tile_off, hard,
                                 tile, n, f, k, labels, sub, st);
  if constexpr (std::is_same<Rows, CacheRows>::value) {
    if (warps == 4)
      return launch_narrow<4>(rows, phi, log_w, seed, tile_off, hard, tile,
                              n, f, k, labels, sub, st);
    if (warps == 16)
      return launch_narrow<16>(rows, phi, log_w, seed, tile_off, hard, tile,
                               n, f, k, labels, sub, st);
  }
  return cudaErrorInvalidValue;
}

// The assign pass over ``rows``, then the statistics pass over
// ``stat_rows`` (the same rows, or for "hybrid" the rows built from x).
template <class Rows, class StatRows>
int assign_and_stats(Rows rows, StatRows stat_rows, const uint8_t* valid,
                     const float* phi, const float* delta_t, void* phi_t,
                     int precision, const float* log_w, const int32_t* seed,
                     int tile_off, int hard, int tile, int n, int f, int k,
                     int warps, int32_t* labels, int32_t* sub, float* partial,
                     float* stats, cudaStream_t st) {
  cudaError_t err;
  if (precision == kOneBf16Pass || precision == kThreeBf16Passes) {
    if (warps != kWarps || phi_t == nullptr) return cudaErrorInvalidValue;
    __nv_bfloat16* staged = static_cast<__nv_bfloat16*>(phi_t);
    err = precision == kOneBf16Pass
              ? launch_assign_tc<1>(rows, phi, staged, log_w, seed, tile_off,
                                    hard, tile, n, f, k, labels, sub, st)
              : launch_assign_tc<2>(rows, phi, staged, log_w, seed, tile_off,
                                    hard, tile, n, f, k, labels, sub, st);
  } else if (precision == kExactF32) {
    err = launch_assign(rows, phi, delta_t, log_w, seed, tile_off, hard, tile,
                        n, f, k, warps, labels, sub, st);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_stats(stat_rows, labels, sub, valid, n, f,
                                       k, partial, stats, st));
}

}  // namespace
}  // namespace dpmm

// rows: the cache [n, f] when ``pairs`` is null, else the raw points [n, d]
// with the column map pairs [f] (dpmm_kernels.cuh, BuiltRows).
// ``precision`` 0: the exact float32 product; delta_t [k, f] (phi's delta
// columns, transposed) is read only when k > 128, and ``warps`` is the block
// size of the assign pass: 8 (64 points), or 4 or 16 for the cache at
// k <= 128.  ``precision`` 1: one bf16 pass on the tensor cores, 2: the
// three-pass bf16 split there; phi_t is scratch of dpmm_assign_tc_scratch(f,
// k, precision) bf16 values, delta_t is not read and ``warps`` is 8.
extern "C" int dpmm_fused_assign(const float* rows, const int32_t* pairs,
                                 int d, const uint8_t* valid,
                                 const float* phi, const float* delta_t,
                                 void* phi_t, int precision,
                                 const float* log_w, const int32_t* seed,
                                 int tile_off, int hard, int tile, int n,
                                 int f, int k, int warps, int32_t* labels,
                                 int32_t* sub, float* partial, float* stats,
                                 void* stream) {
  using namespace dpmm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pairs != nullptr) {
    const BuiltRows built{rows, pairs, d};
    return assign_and_stats(built, built, valid, phi, delta_t, phi_t,
                            precision, log_w, seed, tile_off, hard, tile, n,
                            f, k, warps, labels, sub, partial, stats, st);
  }
  const CacheRows cache{rows, f};
  return assign_and_stats(cache, cache, valid, phi, delta_t, phi_t,
                          precision, log_w, seed, tile_off, hard, tile, n, f,
                          k, warps, labels, sub, partial, stats, st);
}

// feat: the bf16 cache [n, f].  raw null: "bfloat16", the statistics come
// from the same rows.  raw [n, d] with the Gaussian column map pairs [f]:
// "hybrid", the statistics come from the rows built from raw.
extern "C" int dpmm_fused_assign_bf16(const void* feat, const float* raw,
                                      const int32_t* pairs, int d,
                                      const uint8_t* valid, const float* phi,
                                      const float* delta_t, void* phi_t,
                                      int precision, const float* log_w,
                                      const int32_t* seed,
                                      int tile_off, int hard, int tile, int n,
                                      int f, int k, int32_t* labels,
                                      int32_t* sub, float* partial,
                                      float* stats, void* stream) {
  using namespace dpmm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Bf16Rows cache{static_cast<const __nv_bfloat16*>(feat), f};
  if (raw != nullptr)
    return assign_and_stats(cache, BuiltRows{raw, pairs, d}, valid, phi,
                            delta_t, phi_t, precision, log_w, seed, tile_off,
                            hard, tile, n, f, k, kWarps, labels, sub, partial,
                            stats, st);
  return assign_and_stats(cache, cache, valid, phi, delta_t, phi_t, precision,
                          log_w, seed, tile_off, hard, tile, n, f, k, kWarps,
                          labels, sub, partial, stats, st);
}
