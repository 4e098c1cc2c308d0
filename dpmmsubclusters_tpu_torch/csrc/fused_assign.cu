// Kernel A: the per-sweep assignment + statistics pass, with the exact
// float32 ll product (ll_precision "highest").  Under "bf16" and "default"
// on a bf16 cache (one bf16 pass) and under "high" and "default" on
// float32 rows (the three-pass bf16 split) the assign pass is
// fused_assign_tc.cuh's, on the tensor cores; the C entry points below
// choose by ``precision`` (ops/sweep_kernels.py's ll_route names it) and
// launch the statistics pass after either.
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
// "default" and "bf16" only (fused_assign_tc.cuh), and in this file bf16 is
// storage:
// each value is upcast exactly and all arithmetic is f32.
// The Gumbel noise is the TPU kernel's counter hash, bit for bit: per hash
// tile of ``tile`` rows the seed is fmix32(seed + (tile_off + row / tile) *
// 0x9E3779B9) and the counter is (row % tile) * K + j (labels) or
// (row % tile) * 2 + {0, 1} with seed ^ 0xA5A5A5A5 (the sub-label pair).
// ``tile`` belongs to the hash only; the CUDA block size is independent.
//
// What bounds it on the H100: the ll product a point needs is its K whole
// columns and its label's one delta column, F * (K + 1) * 2 flop for at
// most 4F bytes read -- 64 flop/byte at K=128 from the cache, and
// 2 * 2145 * 257 flop for 256 bytes of x at D=64 and K=256 -- so it is
// compute-bound in exact float32 (outside the tensor cores: 67 TFLOP/s
// peak).  A built row costs one multiply per feature per block, not per
// column.  A bf16 cache halves the bytes read (2F per point), which does
// not move a compute bound; it halves the cache's memory (10M x 64-d:
// 42.9 GB against 86 GB), so a cache fits the card where the f32 one does
// not.  The statistics pass is cheaper (see stats_from_labels.cu).
//
// Design (the exact path, CUDA cores only; exact_product.cuh has the
// product): a block of 2 BM threads owns BM points (the fits: 128; the tile
// study also times 64 and 256) and takes the K whole columns in passes of
// at most 128 (one pass at K <= 128), each a 16 x 4 register tile a thread
// (16 x 2, 16 x 1 at K <= 64, 32), so ll never touches device memory and
// phi is read from L2 once a pass per 128 points.  A pass folds each
// point's columns into a running Gumbel argmax: each lane over its columns,
// then the point's warp by shuffles, then lane 0 with the earlier passes'
// best, kept in shared memory.  The noise of column j depends only on j,
// and a column wins only by jnp.argmax's rule (larger value, then smaller
// column), so the order of folding does not matter.  (Drawing the noise
// only for columns that can win, as fused_assign_tc.cuh does, gave the
// same labels and no measurable gain here.)  Then each point's delta is
// one dot of its row with row ``label`` of delta_t [K, F] (phi's delta
// columns, transposed by the wrapper), summed as it always was, so the
// sub-labels keep their bits:
//  * K <= 128: one fmaf chain over f ascending from 0.0f, one thread a
//    point, over 16-feature tiles of the block's rows staged in shared
//    memory (the ring is free by then);
//  * K > 128: lane l of a warp chains the features l + 32 t, then a
//    butterfly sums the 32 lanes.
#include "exact_product.cuh"

#include <cmath>

namespace dpmm {
namespace {

constexpr int kWarps = 8;  // the main path's block: 8 warps, 128 points
constexpr int kPassCols = 128;     // whole columns a pass, K > 128
constexpr int kDeltaTile = 16;     // features a tile of the K <= 128 delta
// the ll product's ``precision`` at the C entry points
constexpr int kExactF32 = 0;     // this file's kernel
constexpr int kOneBf16Pass = 1;  // fused_assign_tc.cu
constexpr int kThreeBf16Passes = 2;  // fused_assign_tc3.cu

// Writes row g's label and its sub-label, drawn from the label's delta
// logit.
__device__ __forceinline__ void write_row(int g, int label, float delta,
                                          uint32_t s, uint32_t rit,
                                          int32_t* __restrict__ labels,
                                          int32_t* __restrict__ sub) {
  const uint32_t s2 = s ^ 0xA5A5A5A5u;
  const float g_l = gumbel(s2, rit * 2u);
  const float g_r = gumbel(s2, rit * 2u + 1u);
  labels[g] = label;
  sub[g] = (delta + (g_r - g_l) + 1e-30f > 0.0f) ? 1 : 0;
}

// Shared memory of a block: the product's ring, then the running argmax
// (value, column) of each of its BM points, then, for rows built from the
// points where they fit, the block's X = [1, x] (d + 1 floats a point).
constexpr int kSmemLimit = 232448;  // what a block may take of an SM
template <int BM, int BN>
constexpr int exact_smem_bytes() {
  return ExactShape<BM, BN>::kRingFloats * 4 + 8 * BM;
}
inline int x_stage_bytes(const BuiltRows& rows, int bm) {
  return bm * (rows.d + 1) * 4;
}
inline int x_stage_bytes(const CacheRows&, int) { return 0; }
inline int x_stage_bytes(const Bf16Rows&, int) { return 0; }

// Labels and sub-labels of the rows [BM blockIdx.x, + BM) under the exact
// float32 product; Wide: K > 128, passes of 128 whole columns.
// Two blocks an SM at 128 points (128 registers a thread), one at 256, and
// three at 64 (four spill).
template <int BM, int BN, bool Wide, class Rows>
__global__ void __launch_bounds__(ExactShape<BM, BN>::kThreads,
                                  BM == 64 ? 3 : 256 / BM)
exact_assign_kernel(Rows rows, const float* __restrict__ phi,
                    const float* __restrict__ delta_t,
                    const float* __restrict__ log_w,
                    const int32_t* __restrict__ seed_ptr, int tile_off,
                    int hard, int tile, int n, int f, int k, int stage_x,
                    int32_t* __restrict__ labels,
                    int32_t* __restrict__ sub) {
  using Shape = ExactShape<BM, BN>;
  constexpr int T = Shape::kThreads;
  constexpr int TN = Shape::kTN;
  extern __shared__ __align__(16) float smem[];
  float* best_v = smem + Shape::kRingFloats;
  int* best_j = reinterpret_cast<int*>(best_v + BM);
  const int tid = threadIdx.x;
  const int tx = tid % kExColThreads;
  const int ty = tid / kExColThreads;
  const int row0 = blockIdx.x * BM;
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  const float noise = hard ? 0.0f : 1.0f;
  // built rows: the block's points as X = [1, x] (a row of zeros past n),
  // so a feature is two shared reads and one product; visible after the
  // product's first barrier
  float* xs = nullptr;
  if constexpr (std::is_same<Rows, BuiltRows>::value) {
    if (stage_x) {
      xs = reinterpret_cast<float*>(best_j + BM);
      const int d = rows.d;
      for (int idx = tid; idx < BM * d; idx += T) {
        const int r = idx / d;
        const int c = idx - r * d;
        const int g = row0 + r;
        xs[r * (d + 1) + 1 + c] =
            g < n ? __ldg(rows.x + static_cast<size_t>(g) * d + c) : 0.0f;
      }
      if (tid < BM) xs[tid * (d + 1)] = row0 + tid < n ? 1.0f : 0.0f;
    }
  }
  // row g's hash seed and counter row
  auto seed_of = [&](int g) {
    return tile_seed(seed, static_cast<uint32_t>(tile_off) +
                               static_cast<uint32_t>(g / tile));
  };

  const int passes = Wide ? (k + BN - 1) / BN : 1;
  for (int p = 0; p < passes; ++p) {
    const int j0 = p * BN;
    float acc[kExPoints][TN];
    exact_product<BM, BN, Wide ? 2 : 1>(rows, phi, 2 * k, j0,
                                        min(BN, k - j0), row0, n, f, smem,
                                        xs, acc);
    float lw[TN];
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int col = j0 + own_col<TN>(tx, c);
      lw[c] = col < k ? log_w[col] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < kExPoints; ++i) {
      const int r = own_row(ty, i);
      const int g = row0 + r;
      const uint32_t s = seed_of(g);
      const uint32_t rit = static_cast<uint32_t>(g % tile);
      float bv = -INFINITY;
      int bj = 0x7fffffff;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int col = j0 + own_col<TN>(tx, c);
        if (col < k) {
          float logit = acc[i][c] + lw[c];
          if (isnan(logit)) logit = -INFINITY;
          const float v =
              logit + gumbel(s, rit * static_cast<uint32_t>(k) +
                                    static_cast<uint32_t>(col)) *
                          noise;
          if (better(v, col, bv, bj)) {
            bv = v;
            bj = col;
          }
        }
      }
#pragma unroll
      for (int off = kExColThreads / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
        if (better(ov, oj, bv, bj)) {
          bv = ov;
          bj = oj;
        }
      }
      if (tx == 0) {  // the same lane holds point r in every pass
        if (p > 0 && better(best_v[r], best_j[r], bv, bj)) {
          bv = best_v[r];
          bj = best_j[r];
        }
        best_v[r] = bv;
        best_j[r] = bj;
      }
    }
  }
  __syncthreads();  // every point's label is in best_j

  if constexpr (!Wide) {
    // one thread a point: delta = the fmaf chain over f ascending, from a
    // [16 features][BM points] tile of the rows in the free ring
    constexpr int kLd = BM + 1;  // conflict-free reads
    float* tile_s = smem;
    const bool mine = tid < BM;
    const float* dcol =
        delta_t + static_cast<size_t>(mine ? best_j[tid] : 0) * f;
    float delta = 0.0f;
    for (int f0 = 0; f0 < f; f0 += kDeltaTile) {
      // this point's delta values of the tile, in flight with the tile's
      // rows (zeros past f add +0.0f, which changes no sum's value)
      float dv[kDeltaTile];
#pragma unroll
      for (int e = 0; e < kDeltaTile; ++e)
        dv[e] = mine && f0 + e < f ? __ldg(dcol + f0 + e) : 0.0f;
      // point e / 16, feature f0 + e % 16: a warp reads 16 features of two
      // rows
#pragma unroll
      for (int m = 0; m < kDeltaTile * BM / T; ++m) {
        const int e = tid + m * T;
        const int pr = e / kDeltaTile;
        const int fe = e % kDeltaTile;
        const int fc = f0 + fe;
        const int g = row0 + pr;
        float v = 0.0f;
        if (g < n && fc < f) {
          const typename Rows::Col c = rows.col(fc);
          if constexpr (std::is_same<Rows, BuiltRows>::value) {
            const int at = pr * (rows.d + 1);
            v = xs ? __fmul_rn(xs[at + c.a], xs[at + c.b]) : rows.at(c, g);
          } else {
            v = rows.at(c, g);
          }
        }
        tile_s[fe * kLd + pr] = v;
      }
      __syncthreads();
      if (mine) {
#pragma unroll
        for (int e = 0; e < kDeltaTile; ++e)
          delta = fmaf(tile_s[e * kLd + tid], dv[e], delta);
      }
      __syncthreads();
    }
    const int g = row0 + tid;
    if (mine && g < n)
      write_row(g, best_j[tid], delta, seed_of(g),
                static_cast<uint32_t>(g % tile), labels, sub);
  } else {
    // a warp a point at a time, 8 points side by side: lane l chains the
    // features l + 32 t, a butterfly sums the lanes
    const int lane = tid & 31;
    const int warp = tid >> 5;
    constexpr int kWarpPoints = BM / (T / 32);  // 16
#pragma unroll 1
    for (int b0 = 0; b0 < kWarpPoints; b0 += 8) {
      const int wrow = warp * kWarpPoints + b0;
      float dot[8];
      const float* dcol[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        dot[r] = 0.0f;
        dcol[r] = delta_t + static_cast<size_t>(best_j[wrow + r]) * f;
      }
      for (int fc = lane; fc < f; fc += 32) {
        const typename Rows::Col c = rows.col(fc);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int g = row0 + wrow + r;
          if (g < n) dot[r] = fmaf(rows.at(c, g), __ldg(dcol[r] + fc), dot[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
        const int g = row0 + wrow + r;
        if (lane == 0 && g < n)
          write_row(g, best_j[wrow + r], dot[r], seed_of(g),
                    static_cast<uint32_t>(g % tile), labels, sub);
      }
    }
  }
}

template <int BM, int BN, bool Wide, class Rows>
cudaError_t launch_exact(Rows rows, const float* phi, const float* delta_t,
                         const float* log_w, const int32_t* seed,
                         int tile_off, int hard, int tile, int n, int f,
                         int k, int32_t* labels, int32_t* sub,
                         cudaStream_t st) {
  const int x_bytes = x_stage_bytes(rows, BM);
  const int stage_x =
      x_bytes > 0 && exact_smem_bytes<BM, BN>() + x_bytes <= kSmemLimit;
  const int bytes = exact_smem_bytes<BM, BN>() + (stage_x ? x_bytes : 0);
  constexpr auto kernel = exact_assign_kernel<BM, BN, Wide, Rows>;
  const cudaError_t err = allow_smem<kernel>(kSmemLimit);
  if (err != cudaSuccess) return err;
  kernel<<<(n + BM - 1) / BM, ExactShape<BM, BN>::kThreads, bytes, st>>>(
      rows, phi, delta_t, log_w, seed, tile_off, hard, tile, n, f, k,
      stage_x, labels, sub);
  return cudaGetLastError();
}

// K <= 128: one pass as wide as K needs.
template <int BM, class Rows>
cudaError_t launch_narrow(Rows rows, const float* phi, const float* delta_t,
                          const float* log_w, const int32_t* seed,
                          int tile_off, int hard, int tile, int n, int f,
                          int k, int32_t* labels, int32_t* sub,
                          cudaStream_t st) {
#define DPMM_EXACT(BN)                                                      \
  return launch_exact<BM, BN, false>(rows, phi, delta_t, log_w, seed,      \
                                     tile_off, hard, tile, n, f, k, labels, \
                                     sub, st)
  if (k <= 32) DPMM_EXACT(32);
  if (k <= 64) DPMM_EXACT(64);
  DPMM_EXACT(128);
#undef DPMM_EXACT
}

// ``warps`` other than 8 (4 or 16: the tile study's 64- and 256-point
// blocks) is taken only by the f32 cache at K <= 128.
template <class Rows>
cudaError_t launch_assign(Rows rows, const float* phi, const float* delta_t,
                          const float* log_w, const int32_t* seed,
                          int tile_off, int hard, int tile, int n, int f,
                          int k, int warps, int32_t* labels, int32_t* sub,
                          cudaStream_t st) {
  if (delta_t == nullptr) return cudaErrorInvalidValue;
  constexpr int kBM = kWarps * 16;
  if (k > kPassCols) {
    if (warps != kWarps) return cudaErrorInvalidValue;
    return launch_exact<kBM, kPassCols, true>(rows, phi, delta_t, log_w,
                                              seed, tile_off, hard, tile, n,
                                              f, k, labels, sub, st);
  }
  if (warps == kWarps)
    return launch_narrow<kBM>(rows, phi, delta_t, log_w, seed, tile_off,
                              hard, tile, n, f, k, labels, sub, st);
  if constexpr (std::is_same<Rows, CacheRows>::value) {
    if (warps == 4)
      return launch_narrow<64>(rows, phi, delta_t, log_w, seed, tile_off,
                               hard, tile, n, f, k, labels, sub, st);
    if (warps == 16)
      return launch_narrow<256>(rows, phi, delta_t, log_w, seed, tile_off,
                                hard, tile, n, f, k, labels, sub, st);
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
                     float* stats, unsigned long long* tally,
                     cudaStream_t st) {
  cudaError_t err;
  if (precision == kOneBf16Pass || precision == kThreeBf16Passes) {
    if (warps != kWarps || phi_t == nullptr) return cudaErrorInvalidValue;
    __nv_bfloat16* staged = static_cast<__nv_bfloat16*>(phi_t);
    err = precision == kOneBf16Pass
              ? launch_assign_tc<1>(rows, phi, staged, log_w, seed, tile_off,
                                    hard, tile, n, f, k, labels, sub, tally,
                                    st)
              : launch_assign_tc<2>(rows, phi, staged, log_w, seed, tile_off,
                                    hard, tile, n, f, k, labels, sub, tally,
                                    st);
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
// columns, transposed) holds each point's delta column, and ``warps`` is
// the block size of the assign pass: 8 (128 points), or 4 or 16 (64 or 256
// points) for the cache at k <= 128.  ``precision`` 1: one bf16 pass on the tensor cores, 2: the
// three-pass bf16 split there; phi_t is scratch of dpmm_assign_tc_scratch(f,
// k, precision) bf16 values, delta_t is not read and ``warps`` is 8.
// ``tally``: null, or int64 [2] on the card, to which the tensor-core pass
// at a pass width of 256 adds the passes it ran and the passes the table
// width calls for (launch_assign_tc).
extern "C" int dpmm_fused_assign(const float* rows, const int32_t* pairs,
                                 int d, const uint8_t* valid,
                                 const float* phi, const float* delta_t,
                                 void* phi_t, int precision,
                                 const float* log_w, const int32_t* seed,
                                 int tile_off, int hard, int tile, int n,
                                 int f, int k, int warps, int32_t* labels,
                                 int32_t* sub, float* partial, float* stats,
                                 void* tally, void* stream) {
  using namespace dpmm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* passes = static_cast<unsigned long long*>(tally);
  if (pairs != nullptr) {
    const BuiltRows built{rows, pairs, d};
    return assign_and_stats(built, built, valid, phi, delta_t, phi_t,
                            precision, log_w, seed, tile_off, hard, tile, n,
                            f, k, warps, labels, sub, partial, stats, passes,
                            st);
  }
  const CacheRows cache{rows, f};
  return assign_and_stats(cache, cache, valid, phi, delta_t, phi_t,
                          precision, log_w, seed, tile_off, hard, tile, n, f,
                          k, warps, labels, sub, partial, stats, passes, st);
}

// feat: the bf16 cache [n, f], rows ``ld`` values apart.  raw null:
// "bfloat16", the statistics come from the same rows.  raw [n, d] with the
// Gaussian column map pairs [f]: "hybrid", the statistics come from the rows
// built from raw.
extern "C" int dpmm_fused_assign_bf16(const void* feat, int ld,
                                      const float* raw,
                                      const int32_t* pairs, int d,
                                      const uint8_t* valid, const float* phi,
                                      const float* delta_t, void* phi_t,
                                      int precision, const float* log_w,
                                      const int32_t* seed,
                                      int tile_off, int hard, int tile, int n,
                                      int f, int k, int32_t* labels,
                                      int32_t* sub, float* partial,
                                      float* stats, void* tally,
                                      void* stream) {
  using namespace dpmm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  unsigned long long* passes = static_cast<unsigned long long*>(tally);
  const Bf16Rows cache{static_cast<const __nv_bfloat16*>(feat), f, ld};
  if (raw != nullptr)
    return assign_and_stats(cache, BuiltRows{raw, pairs, d}, valid, phi,
                            delta_t, phi_t, precision, log_w, seed, tile_off,
                            hard, tile, n, f, k, kWarps, labels, sub, partial,
                            stats, passes, st);
  return assign_and_stats(cache, cache, valid, phi, delta_t, phi_t, precision,
                          log_w, seed, tile_off, hard, tile, n, f, k, kWarps,
                          labels, sub, partial, stats, passes, st);
}
