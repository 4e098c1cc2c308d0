// Kernel D: the round-3 assignment kernel with each of its stages gated, for
// the stage ablation (benchmarks/kernel_ablate.py).
//
// Replaces benchmarks/kernel_ablate.py:141 variant (call :150; kernel body
// _kernel, :35-135).  Its layout is kernel A's before the delta columns:
// phi [F, 3K] = [whole K | left K | right K] and loglrw [2, K].  Per point,
// with x its row of the f32 cache [N, F]:
//   ll     = x @ phi
//   label  = argmax_j (ll_j + log_w_j [+ G_j under GUMBEL, NaN -> -inf first])
//            (first maximum; without GUMBEL a NaN counts as the maximum, as
//            in jnp.argmax)
//   side   = [ll_{2K+label} + loglrw[1, label] + g_r >
//             ll_{K+label} + loglrw[0, label] + g_l]   under SUB, else 0,
//            with (g_l, g_r) the pair drawn at width 2 from the tile's
//            seed ^ 0xA5A5A5A5 (this form, not kernel A's delta + 1e-30)
// The hash is kernel A's (dpmm_kernels.cuh) with tile_off = 0: per hash tile
// i of ``tile`` rows the seed is fmix32(seed + i * 0x9E3779B9).  The stages:
//   DMA_ONLY   stats row 0 = the column sums of x (kernel C, column_sum.cu)
//   DOT_ONLY   stats row 0, columns [0, 3K) = the column sums of x @ phi,
//              computed as what they are: colsum(x) @ phi
//   STATS_RAW  every one of the 2K stats rows = the column sums of x (the
//              TPU's ones-weight dot; here kernel C's reduction again)
//   STATS      stats = [LEFT K | RIGHT K] x F sums of the rows by (side,
//              label), masked by valid (kernel B's pass, stats_from_labels.cu)
//   GUMBEL, SUB  as above
//   WRITE      labels and sides written out as int32 (the TPU writes f32
//              streams, a Mosaic limitation); without it both stay zero
// Outputs a stage set does not write are zero (the wrapper allocates them
// so).  Where neither WRITE nor STATS keeps the labels, nvcc would delete
// the work they come from, so a store guarded by the runtime ``sink`` (always
// 0) keeps it live without changing an output.
//
// What bounds it on the H100: the ll product, 2 * N * F * (K + 2) flop for
// what the function needs (the K whole columns and the label's left and
// right columns): 1.53e11 flop at 1M x 561 and K = 128, 2.29 ms at the fp32
// peak of 67 TFLOP/s, against 0.70 ms for its bytes.  The product is the
// exact float32 one: the ablation is that of kernel A under ll_precision
// "highest".  DOT_ONLY and DMA_ONLY are bound by the one read of x.
//
// Design: kernel A's product (exact_product.cuh: a block of 128 points, a
// 16 x TN register tile a thread, a point's columns on the lanes of a warp)
// in two phases: the K whole columns, a Gumbel argmax by warp shuffles,
// then under SUB the 2K [left | right] columns in two calls of K, each
// point's pair one shuffle away.  It computes all 2K sub-columns, as the
// TPU kernel did, and draws the noise of every whole column.  DOT_ONLY launches no product over the points: its sums are
// linear in x, so kernel C's reduction (column_sum.cu) sums x's columns in
// one read and a small kernel multiplies the [F] sums by phi [F, 3K], each
// column's terms added in a fixed order.  K <= 128.
#include "exact_product.cuh"

#include <cmath>

namespace dpmm {
namespace {

enum : unsigned {
  kDmaOnly = 1u,
  kDotOnly = 2u,
  kStatsRaw = 4u,
  kStats = 8u,
  kGumbel = 16u,
  kSub = 32u,
  kWrite = 64u,
};

constexpr int kBlockPoints = 128;

// jnp.argmax's order with NaN as the maximum; ties keep the smaller column.
__device__ __forceinline__ bool better_nan(float v, int j, float bv, int bj) {
  const bool vn = isnan(v), bn = isnan(bv);
  if (vn || bn) return vn && (!bn || j < bj);
  return better(v, j, bv, bj);
}

// Column ``j`` of a point's row, whose columns lie on the lanes of a warp
// (slot c of lane l holds own_col(l, c)); every lane asks for the same j.
template <int TN>
__device__ __forceinline__ float column(const float (&row)[TN], int j) {
  float mine = 0.0f;
#pragma unroll
  for (int c = 0; c < TN; ++c)
    if (c == j % TN) mine = row[c];
  return __shfl_sync(0xffffffffu, mine, j / TN);
}

// Two blocks an SM.  The sets with SUB hold three products and spill 152
// bytes at K = 128; at one block an SM they do not, and run 30% slower.
template <unsigned Stages, int BN>  // K <= BN
__global__ void __launch_bounds__(ExactShape<kBlockPoints, BN>::kThreads, 2)
ablate_kernel(const float* __restrict__ x, const float* __restrict__ phi,
              const float* __restrict__ log_w,
              const float* __restrict__ loglrw,
              const int32_t* __restrict__ seed_ptr, int tile, int n, int f,
              int k, int sink, int32_t* __restrict__ labels,
              int32_t* __restrict__ sub) {
  constexpr int TN = BN / kExColThreads;
  extern __shared__ __align__(16) float smem[];
  // past the ring: each point's label and its left and right picks (kept
  // here, not in registers, across the products)
  int* lab = reinterpret_cast<int*>(
      smem + ExactShape<kBlockPoints, BN>::kRingFloats);
  float* pick = reinterpret_cast<float*>(lab + kBlockPoints);  // [2][128]
  const CacheRows rows{x, f};
  const int tx = threadIdx.x % kExColThreads;
  const int ty = threadIdx.x / kExColThreads;
  const int row0 = blockIdx.x * kBlockPoints;
  const int ldp = 3 * k;
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);

  {
    float ll[kExPoints][TN];
    exact_product<kBlockPoints, BN, 1>(rows, phi, ldp, 0, k, row0, n, f,
                                       smem, nullptr, ll);
#pragma unroll
    for (int i = 0; i < kExPoints; ++i) {
      const int r = own_row(ty, i);
      const int g = row0 + r;
      const uint32_t s = tile_seed(seed, static_cast<uint32_t>(g / tile));
      const uint32_t rit = static_cast<uint32_t>(g % tile);
      float bv = -INFINITY;
      int bj = 0x7fffffff;
#pragma unroll
      for (int c = 0; c < TN; ++c) {
        const int j = own_col<TN>(tx, c);
        if (j < k) {
          float v = ll[i][c] + log_w[j];
          if constexpr ((Stages & kGumbel) != 0) {
            if (isnan(v)) v = -INFINITY;
            v += gumbel(s, rit * static_cast<uint32_t>(k) +
                               static_cast<uint32_t>(j));
          }
          if (better_nan(v, j, bv, bj)) {
            bv = v;
            bj = j;
          }
        }
      }
#pragma unroll
      for (int off = kExColThreads / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oj = __shfl_xor_sync(0xffffffffu, bj, off);
        if (better_nan(ov, oj, bv, bj)) {
          bv = ov;
          bj = oj;
        }
      }
      if (tx == 0) lab[r] = bj;
    }
  }

  if constexpr ((Stages & kSub) != 0) {
    // the label's left column, then its right one: a call each (the call's
    // first barrier makes the labels visible)
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      float lr[kExPoints][TN];
      exact_product<kBlockPoints, BN, 1>(rows, phi, ldp, (1 + h) * k, k,
                                         row0, n, f, smem, nullptr, lr);
#pragma unroll
      for (int i = 0; i < kExPoints; ++i) {
        const int r = own_row(ty, i);
        const int j = lab[r];
        const float v = column<TN>(lr[i], j) + loglrw[h * k + j];
        if (tx == 0) pick[h * kBlockPoints + r] = v;
      }
    }
  }
  __syncthreads();

  // one thread a point: its side, then the writes
  const int r = threadIdx.x;
  const int g = row0 + r;
  if (r >= kBlockPoints || g >= n) return;
  int side = 0;
  if constexpr ((Stages & kSub) != 0) {
    const uint32_t s2 =
        tile_seed(seed, static_cast<uint32_t>(g / tile)) ^ 0xA5A5A5A5u;
    const uint32_t rit = static_cast<uint32_t>(g % tile);
    side = (pick[kBlockPoints + r] + gumbel(s2, rit * 2u + 1u) >
            pick[r] + gumbel(s2, rit * 2u))
               ? 1
               : 0;
  }
  if ((Stages & (kWrite | kStats)) != 0 || sink) {
    labels[g] = lab[r];
    sub[g] = side;
  }
}

constexpr int kDotCols = 32;  // phi columns per block of the DOT_ONLY product
constexpr int kDotWays = 32;  // features summed side by side

// out[col] = sum over r of w[r] * phi[r, col] for col < m (phi [rows, m]):
// way w adds the features w, w + 32, ... in order, then one thread adds the
// 32 ways in order.
__global__ void __launch_bounds__(kDotCols * kDotWays)
colsum_dot_kernel(const float* __restrict__ w, const float* __restrict__ phi,
                  int rows, int m, float* __restrict__ out) {
  __shared__ float part[kDotWays][kDotCols];
  const int col = blockIdx.x * kDotCols + threadIdx.x;
  const int way = threadIdx.y;
  float s = 0.0f;
  if (col < m) {
#pragma unroll 4
    for (int r = way; r < rows; r += kDotWays)
      s = fmaf(w[r], phi[static_cast<size_t>(r) * m + col], s);
  }
  part[way][threadIdx.x] = s;
  __syncthreads();
  if (way != 0 || col >= m) return;
  float t = 0.0f;
#pragma unroll
  for (int i = 0; i < kDotWays; ++i) t += part[i][threadIdx.x];
  out[col] = t;
}

template <unsigned Stages, int BN>
cudaError_t launch_ablate_bn(const float* x, const float* phi,
                             const float* log_w, const float* loglrw,
                             const int32_t* seed, int tile, int n, int f,
                             int k, int sink, int32_t* labels, int32_t* sub,
                             cudaStream_t st) {
  constexpr int kBytes =
      ExactShape<kBlockPoints, BN>::kRingFloats * 4 + 3 * 4 * kBlockPoints;
  constexpr auto kernel = ablate_kernel<Stages, BN>;
  const cudaError_t err = allow_smem<kernel>(kBytes);
  if (err != cudaSuccess) return err;
  kernel<<<(n + kBlockPoints - 1) / kBlockPoints,
           ExactShape<kBlockPoints, BN>::kThreads, kBytes, st>>>(
      x, phi, log_w, loglrw, seed, tile, n, f, k, sink, labels, sub);
  return cudaGetLastError();
}

template <unsigned Stages>
cudaError_t launch_ablate(const float* x, const float* phi,
                          const float* log_w, const float* loglrw,
                          const int32_t* seed, int tile, int n, int f, int k,
                          int sink, int32_t* labels, int32_t* sub,
                          cudaStream_t st) {
  if (k <= 32)
    return launch_ablate_bn<Stages, 32>(x, phi, log_w, loglrw, seed, tile, n,
                                        f, k, sink, labels, sub, st);
  return launch_ablate_bn<Stages, 128>(x, phi, log_w, loglrw, seed, tile, n,
                                       f, k, sink, labels, sub, st);
}

}  // namespace
}  // namespace dpmm

// One stage set (a bit mask of the stages above) over x [n, f].  labels and
// sub [n]: where the kernel writes the labels and sides (the outputs under
// WRITE, else scratch under STATS, else the outputs, written only if sink);
// partial: scratch of dpmm_ablate_scratch floats; stats [2k, f].  The
// caller zeroes what the set leaves unwritten.
extern "C" int dpmm_kernel_ablate(const float* x, const uint8_t* valid,
                                  const float* phi, const float* log_w,
                                  const float* loglrw, const int32_t* seed,
                                  int tile, int n, int f, int k, int stages,
                                  int sink, int32_t* labels, int32_t* sub,
                                  float* partial, float* stats,
                                  void* stream) {
  using namespace dpmm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k < 1 || k > 128 || tile < 1) return cudaErrorInvalidValue;
  const unsigned set = static_cast<unsigned>(stages);
  auto launch = [&](auto kernel_stages) {
    return launch_ablate<decltype(kernel_stages)::value>(
        x, phi, log_w, loglrw, seed, tile, n, f, k, sink, labels, sub, st);
  };
  using S0 = std::integral_constant<unsigned, 0u>;
  cudaError_t err;
  switch (set) {
    case kDmaOnly:
      return static_cast<int>(
          launch_column_sum(x, n, f, partial, stats, 1, st));
    case kDotOnly: {
      if (3 * k > f) return cudaErrorInvalidValue;
      // the column sums go behind the reduction's partial rows
      float* colsum = partial + static_cast<size_t>(column_partials(n)) * f;
      err = launch_column_sum(x, n, f, partial, colsum, 1, st);
      if (err != cudaSuccess) return static_cast<int>(err);
      const dim3 block(kDotCols, kDotWays);
      colsum_dot_kernel<<<(3 * k + kDotCols - 1) / kDotCols, block, 0, st>>>(
          colsum, phi, f, 3 * k, stats);
      return static_cast<int>(cudaGetLastError());
    }
    case 0u:
      return static_cast<int>(launch(S0{}));
    case kStatsRaw:  // the kernel of the empty set, then the sums
      err = launch(S0{});
      if (err != cudaSuccess) return static_cast<int>(err);
      return static_cast<int>(
          launch_column_sum(x, n, f, partial, stats, 2 * k, st));
    case kStats:
      err = launch(std::integral_constant<unsigned, kStats>{});
      break;
    case kStats | kGumbel:
      err = launch(std::integral_constant<unsigned, kStats | kGumbel>{});
      break;
    case kStats | kGumbel | kSub:
      err = launch(
          std::integral_constant<unsigned, kStats | kGumbel | kSub>{});
      break;
    case kStats | kGumbel | kSub | kWrite:
      err = launch(std::integral_constant<unsigned,
                                          kStats | kGumbel | kSub | kWrite>{});
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_stats(CacheRows{x, f}, labels, sub, valid, n,
                                       f, k, partial, stats, st));
}

// Floats of scratch a stage set needs (``partial`` above).
extern "C" long long dpmm_ablate_scratch(int n, int f, int k, int stages) {
  using namespace dpmm;
  switch (static_cast<unsigned>(stages)) {
    case kDmaOnly:
    case kStatsRaw:
      return static_cast<long long>(column_partials(n)) * f;
    case kDotOnly:
      return static_cast<long long>(column_partials(n)) * f + f;
    case 0u:
      return 1;
    default:  // the statistics pass's (launch_stats)
      return stats_scratch_floats(n, f, k);
  }
}
