// Shared pieces of the sweep kernels: the counter-based Gumbel hash, the
// argmax tie rule, the three sources of feature rows, and the launchers that
// the kernels' C entry points share.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -Xcompiler -fPIC,
//        one object per .cu, linked -shared (no --use_fast_math: the hash's
//        float steps and logf must round exactly as the plain versions do,
//        and denormals must survive the built rows' products).
#pragma once

#include <cstddef>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dpmm {

// Points per statistics partial: the statistics pass writes one [2K, F]
// partial per chunk, summed in chunk order by a last pass (deterministic,
// no float atomics).
constexpr int kStatsChunk = 16384;
// The statistics pass's key sort (stats_from_labels.cu): warps a chunk, and
// the most buckets (2K + 1) whose [warps + 1, 2K + 1] table it keeps in 48
// KB of shared memory; above that the table lives in the scratch.
constexpr int kSortWarps = 8;
constexpr int kSortSmemBuckets = 48 * 1024 / (4 * (kSortWarps + 1));

// The statistics pass's scratch, in floats: the partials [n_chunks, 2K, F],
// then stats_order_ints(n, k) int32: the key sort's perm [n], its offsets
// [n_chunks, 2K + 1] and, above kSortSmemBuckets buckets, its tables
// [n_chunks, kSortWarps + 1, 2K + 1].  (ops/sweep_kernels.py's
// stats_scratch_sizes computes the same.)
inline long long stats_partial_floats(int n, int f, int k) {
  const long long chunks = (n + kStatsChunk - 1) / kStatsChunk;
  return chunks * 2 * k * f;
}
inline long long stats_order_ints(int n, int k) {
  const long long chunks = (n + kStatsChunk - 1) / kStatsChunk;
  const long long nb = 2LL * k + 1;
  return n + chunks * nb +
         (nb > kSortSmemBuckets ? chunks * (kSortWarps + 1) * nb : 0);
}
inline long long stats_scratch_floats(int n, int f, int k) {
  return stats_partial_floats(n, f, k) + stats_order_ints(n, k);
}

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

// jnp.argmax's rule: the larger value wins, a tie keeps the smaller column.
__device__ __forceinline__ bool better(float v, int j, float bv, int bj) {
  return v > bv || (v == bv && j < bj);
}

// Where a kernel's feature rows come from, chosen at compile time.  A row
// source names a column once (``col``) and then reads that column of any
// point (``at``).  The reads are __ldg: the rows are read-only while a
// kernel runs, and saying so lets a kernel keep many reads in flight across
// its own stores.
//
// CacheRows, the "precomputed" variant: rows of the f32 feature cache
// [N, F] = [1, x, triu(x x^T)].
struct CacheRows {
  const float* feat;
  int f;
  struct Col {
    int c;
  };
  __device__ __forceinline__ Col col(int c) const { return {c}; }
  __device__ __forceinline__ float at(Col c, int p) const {
    return __ldg(feat + static_cast<size_t>(p) * f + c.c);
  }
};

// BuiltRows, the "gaussian" and "multinomial" variants: rows built from the
// raw points x [N, D].  Column c is X[a] * X[b] with X = [1, x_0 .. x_{D-1}]
// and pairs[c] = a << 16 | b.  The Gaussian map is (0, 0), (i+1, 0) for
// i < D, then (i+1, j+1) over the upper triangle in row-major order, i.e.
// the rows [1, x, triu(x x^T)] of GaussianFamily.features; the multinomial
// map stops after x: [1, x].  The product is __fmul_rn, which nvcc never
// contracts into a following add, so a built value is bit for bit the
// cache's fl(x_i * x_j) (and 1 * x == x), and a built row feeds the same
// FMA chain as a cached one.
struct BuiltRows {
  const float* x;
  const int32_t* pairs;
  int d;
  struct Col {
    int a, b;
  };
  __device__ __forceinline__ Col col(int c) const {
    const int32_t ab = __ldg(pairs + c);
    return {ab >> 16, ab & 0xffff};
  }
  __device__ __forceinline__ float at(Col c, int p) const {
    const float* row = x + static_cast<size_t>(p) * d;
    const float xa = c.a ? __ldg(row + c.a - 1) : 1.0f;
    const float xb = c.b ? __ldg(row + c.b - 1) : 1.0f;
    return __fmul_rn(xa, xb);
  }
};

// Bf16Rows, the "bfloat16" and "hybrid" variants: rows of the bf16 feature
// cache [N, F], ``ld`` values apart (the port builds it with ld a multiple
// of 8, zeros past F, so that the copy engine can take its rows; 2-byte
// loads take any ld).  The upcast is exact, so a bf16 row feeds the same
// FMA chain as the f32 cache holding the same values: on cache.float() the
// "precomputed" variant gives the same bits.
struct Bf16Rows {
  const __nv_bfloat16* feat;
  int f;
  int ld;
  struct Col {
    int c;
  };
  __device__ __forceinline__ Col col(int c) const { return {c}; }
  __device__ __forceinline__ float at(Col c, int p) const {
    return __bfloat162float(__ldg(feat + static_cast<size_t>(p) * ld + c.c));
  }
};

// A narrow pass's rows as fused_assign_tc_resident.cuh streams them: a
// tile of 64 rows is 64 x ``pitch`` contiguous bytes from ``src``, of which
// a row's first ``width`` values of ``elem`` bytes are read: the raw points
// (built rows, ``pairs`` their column map), the f32 cache, or the bf16
// cache with its row pitch.
enum TileKind { kTileF32 = 0, kTileBuilt = 1, kTileBf16 = 2 };
struct TileRows {
  const unsigned char* src;
  const int32_t* pairs;
  int pitch, width, elem, kind;
};
inline TileRows tile_rows(const CacheRows& r) {
  return {reinterpret_cast<const unsigned char*>(r.feat), nullptr, 4 * r.f,
          r.f, 4, kTileF32};
}
inline TileRows tile_rows(const BuiltRows& r) {
  return {reinterpret_cast<const unsigned char*>(r.x), r.pairs, 4 * r.d, r.d,
          4, kTileBuilt};
}
inline TileRows tile_rows(const Bf16Rows& r) {
  return {reinterpret_cast<const unsigned char*>(r.feat), nullptr, 2 * r.ld,
          r.f, 2, kTileBf16};
}

// [LEFT K | RIGHT K] x F statistics of the rows by (label, sub, valid) into
// ``stats``; ``scratch`` holds stats_scratch_floats(n, f, k) floats.
// Built rows must be the Gaussian or the multinomial column map.
// Instantiated for CacheRows, BuiltRows and Bf16Rows in stats_from_labels.cu.
template <class Rows>
cudaError_t launch_stats(Rows rows, const int32_t* labels, const int32_t* sub,
                         const uint8_t* valid, int n, int f, int k,
                         float* scratch, float* stats, cudaStream_t stream);

// fused_assign_tc.cuh.  Kernel A's assign pass with the ll product on the
// tensor cores: labels and sub-labels of the rows from phi [f, 2k].  One
// plane: rows and phi rounded to bf16, float32 sums (fused_assign_tc.cu);
// two planes: each split into a bf16 hi and lo, three products
// (fused_assign_tc3.cu).  ``phi_t`` is scratch of dpmm_assign_tc_scratch(f,
// k, Planes) bf16 values.  ``tally`` [2], where not null: the passes run
// and the passes the table width calls for are added to it by the launches
// at a pass width of 256 whose width calls for more than one pass.
// Instantiated for CacheRows, BuiltRows and Bf16Rows.
template <int Planes, class Rows>
cudaError_t launch_assign_tc(Rows rows, const float* phi,
                             __nv_bfloat16* phi_t, const float* log_w,
                             const int32_t* seed, int tile_off, int hard,
                             int tile, int n, int f, int k, int32_t* labels,
                             int32_t* sub, unsigned long long* tally,
                             cudaStream_t stream);

// column_sum.cu.  out rows [0, out_rows) (leading dimension ld_out) = the
// sums over r of partial [rows, m], in a fixed order.
cudaError_t launch_reduce_rows(const float* partial, int rows, int m,
                               float* out, int out_rows, int ld_out,
                               cudaStream_t stream);
// out [out_rows, f] = the column sums of x [n, f] (16-byte aligned) in
// every row; ``partial`` is [column_partials(n), f] scratch.
cudaError_t launch_column_sum(const float* x, int n, int f, float* partial,
                              float* out, int out_rows, cudaStream_t stream);
int column_partials(int n);

}  // namespace dpmm
