// Kernel A's assign pass on the tensor cores: the ll product from bf16
// planes of rows and phi, the products summed in float32.
//
// Replaces the ll product of dpmmsubclusters_tpu/ops/pallas_sweep.py:518
// fused_assign (kernel body _kernel) under its precisions: with one plane,
// the single bf16 pass of the JAX kernel's cast (:311-320), which it takes
// under ll_precision "bf16" and for a bf16 cache (so "default" there too);
// with two planes, "high" (:322-323 at Precision.HIGH, XLA's bf16x3) and
// "default" on float32 rows, where the JAX kernel's dot is
// float32-faithful: rows and phi each split into hi = bf16(v) and lo =
// bf16(v - hi), and hi x hi + hi x lo + lo x hi summed, float32-faithful to
// about 2^-17 of a term (why "default" needs it: ops/sweep_kernels.py's
// ll_route).  Everything after the product
// (the Gumbel argmax, the sub-label, the hash, the NaN and tie rules) is
// fused_assign.cu's, bit for bit.  fused_assign.cu keeps the exact float32
// product ("highest") and launches the statistics pass after either.
// fused_assign_tc.cu and fused_assign_tc3.cu instantiate the two plane
// counts.
//
// What bounds it on the H100: 2 * F * 2K flop a point at the tensor cores'
// 989 TFLOP/s (bf16, dense) against 4F bytes of an f32 cache row (2F of a
// bf16 one, 4D of raw points) at 3.35 TB/s.  At K = 128 an f32 cache row
// gives 128 flop a byte, under the card's 295: the cache's read bounds the
// pass; rows built from the raw points (D = 64: 8580 flop a byte at K = 256)
// leave it to the tensor cores.
//
// Design.  A block of two warpgroups owns 64 points and, a pass, N <= 256
// columns: warpgroup c multiplies the 64 x F rows by the c-th N / 2 columns
// and holds its 64 x N / 2 sums in registers (N / 4 a thread: 64 at N = 256,
// which leaves the other half of a thread's 128 registers to the staging
// and the argmax, so nothing spills and two blocks share an SM: one block's
// argmax overlaps the other's product).  ll never touches device memory.
// The product runs over slices of 64 features through a ring of stages in
// shared memory (wgmma.cuh gives the tile layout): per stage a 64 x 64 bf16
// tile of rows, which both warpgroups read, and an N x 64 bf16 tile of phi.
//  * phi is staged once a launch by stage_phi_kernel into ``phi_t``: bf16
//    (round to nearest even), cut into the ring's tiles as they lie in
//    shared memory (swizzle included), zero-padded to whole slices and whole
//    passes, and with the columns laid out so that a warpgroup's N / 2
//    columns are N / 4 whole columns beside their own delta columns: column
//    j's delta is N / 8 registers after it in the same thread.  A tile is
//    then one bulk copy (cp.async.bulk) by one thread, whose arrival the
//    stage's mbarrier counts: no thread spends instructions on phi, and the
//    copy engine's writes need no proxy fence before wgmma reads them.
//  * rows come through the row source's ``at`` (the f32 cache, rows built
//    as __fmul_rn(x[a], x[b]), or the bf16 cache), are rounded by
//    __float2bfloat16_rn and stored into the swizzled tile: a lane owns the
//    features i and i + 32 of a slice and a warp 8 rows, so a cache row is
//    read in coalesced 128-byte pieces at any F, no padding of the cache
//    needed, and the lane's pair is one 32-bit store (tile_place puts the
//    two side by side, in rows and phi alike); features past F and rows past
//    N are stored as zeros.  The 16 values a thread stages are loaded,
//    stored and fenced for wgmma's proxy while the tensor cores multiply
//    the step before.  A built row is the cache's row bit for bit and a
//    bf16 row rounds to itself, so "gaussian" equals "precomputed" and
//    "bfloat16" equals "precomputed" on cache.float(), as in the exact
//    kernel.
//  * where rows are built and the block's 64 points fit beside the ring
//    (D <= 123 at N = 256), the block first copies them to shared memory as
//    X = [1, x]: a feature is then two shared reads and one product.
//  * the ring runs on across passes (K > N / 2 re-reads the rows a pass):
//    step g is slice g % slices of pass g / slices.
//  * a row's columns sit in the four lanes of a quad of each warpgroup.
//    Each thread folds its columns into a running Gumbel argmax (value,
//    column, that column's delta), across passes; a quad shuffle and one
//    exchange between the two warpgroups through shared memory finish it.
//    The noise of column j depends only on j and a column wins only by
//    jnp.argmax's rule (larger value, then smaller column), so the order of
//    folding does not matter.  Every K takes this path: above 128 there is
//    no separate delta product.
//  * the noise is drawn only for columns that can win (see the fold).
//  * with two planes a stage holds both planes of both tiles, a step's phi
//    planes are still one bulk copy, and a step is three wgmma a 16
//    features instead of one.  Two planes at N = 256 (K > 64: the f32
//    cache's and the built rows' "default" at the fits' widths) take
//    fused_assign_tc_ring.cuh instead, whose design overlaps more there;
//    this one stays for one plane and the narrower passes, where its two
//    blocks an SM overlap one block's argmax with the other's product.
#pragma once

#include "dpmm_kernels.cuh"
#include "wgmma.cuh"

#include <cmath>
#include <type_traits>

namespace dpmm {
namespace {

constexpr int kTcPoints = 64;    // points a block: one 64-row tile
constexpr int kTcThreads = 256;  // two warpgroups, one a column half
constexpr int kTcWarps = kTcThreads / 32;
constexpr int kTcDepth = 64;    // features a slice: one 128-byte tile row
constexpr int kTcWarpRows = kTcPoints / kTcWarps;  // rows a warp stages: 8
constexpr int kTcHeld = 2 * kTcWarpRows;  // values a thread stages a slice
constexpr int kTcRowTile = kTcPoints * kTcDepth * 2;  // bytes
constexpr int kTcMaxDevices = 64;  // cards of one host the launcher tracks

// A stage holds, per plane (one for the single bf16 pass; hi and lo for the
// three-pass split), a rows tile, then per plane a phi tile.  Stages of the
// ring: two at N = 256 or with two planes, three otherwise; two blocks an SM
// but for two planes at N = 256 (160 KB a block).
template <int N, int Planes>
struct TcShape {
  static constexpr int kStages = (N == 256 || Planes == 2) ? 2 : 3;
  static constexpr int kPhiPlane = N * kTcDepth * 2;  // bytes
  static constexpr int kStageBytes = Planes * (kTcRowTile + kPhiPlane);
  // the stages, their barriers, and room to align the first tile
  static constexpr int kSmemBytes = kStages * kStageBytes + 64 + 1024;
  static constexpr int kBlocksPerSm = (N == 256 && Planes == 2) ? 1 : 2;
  // what a block may take of an SM's 227 KB (1 KB a block is the system's)
  static constexpr int kSmemLimit = 232448 / kBlocksPerSm - 1024;
};

// Columns a pass of width N holds for K clusters, and the passes needed.
__host__ __device__ inline int tc_width(int k) {
  return k <= 16 ? 32 : k <= 32 ? 64 : k <= 64 ? 128 : 256;
}
__host__ __device__ inline int tc_passes(int k) {
  const int half = tc_width(k) / 2;
  return (k + half - 1) / half;
}
__host__ __device__ inline int tc_padded(int f) {
  return (f + kTcDepth - 1) / kTcDepth * kTcDepth;
}

// Where feature i of a slice lies in a tile row: features i and i + 32 side
// by side, so the lane that reads both (coalesced with its neighbours)
// stores them as one 32-bit pair.  Rows and phi share the order, and a sum
// over the slice does not care.
__host__ __device__ inline int tile_place(int i) {
  return i < 32 ? 2 * i : 2 * (i - 32) + 1;
}

// phi [f, 2k] float32, columns [whole k | delta k] -> phi_t, the bf16 tiles
// of the ring as they lie in shared memory, one after the other: step
// (pass p, slice s) holds, per plane, N rows of 64 features, 128 bytes a row
// in the 128-byte swizzle.  Plane 0 is phi rounded to bf16 (to nearest
// even); plane 1, where there are two, the rounded rest.  Row h * N / 2 + c
// of pass p (column half h) is whole column p * N / 2 + h * N / 4 + c for
// c < N / 4, else the delta column of whole column ... + c - N / 4; columns
// past k and features past f are zero.
__global__ void stage_phi_kernel(const float* __restrict__ phi, int f, int k,
                                 int width, int f_pad, int total_rows,
                                 int planes,
                                 __nv_bfloat16* __restrict__ phi_t) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total_rows * f_pad) return;
  const int row = idx % total_rows;  // neighbours read neighbouring columns
  const int fc = idx / total_rows;
  const int quarter = width / 4;
  const int c = row % (2 * quarter);
  const int j = (row / (2 * quarter)) * quarter + c % quarter;
  float v = 0.0f;
  if (j < k && fc < f)
    v = phi[static_cast<size_t>(fc) * 2 * k + (c < quarter ? j : k + j)];
  const int r = row % width;  // the row and the feature's place in the tile
  const int fk = tile_place(fc % kTcDepth);
  const size_t step = static_cast<size_t>(row / width) * (f_pad / kTcDepth) +
                      fc / kTcDepth;
  const size_t at = (step * planes * width + r) * kTcDepth +
                    (((fk >> 3) ^ (r & 7)) << 3) + (fk & 7);
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  phi_t[at] = hi;
  if (planes == 2)
    phi_t[at + static_cast<size_t>(width) * kTcDepth] =
        __float2bfloat16_rn(v - __bfloat162float(hi));
}

// mbarrier and bulk-copy steps (shared addresses as 32-bit values)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// One arrival that also announces ``bytes`` of copies to come.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// Waits until the barrier's phase of the given parity is complete.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// ``bytes`` (a multiple of 16) from global to shared memory by the copy
// engine; their arrival counts on the barrier.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One row's best column so far: its noisy logit, its index, its delta.
struct Best {
  float v;
  int j;
  float d;
};

template <int N, int Planes, class Rows>
__global__ void __launch_bounds__(kTcThreads, TcShape<N, Planes>::kBlocksPerSm)
assign_tc_kernel(Rows rows, const __nv_bfloat16* __restrict__ phi_t,
                 const float* __restrict__ log_w,
                 const int32_t* __restrict__ seed_ptr, int tile_off, int hard,
                 int tile, int n, int f, int f_pad, int k, int passes,
                 int stage_x, int32_t* __restrict__ labels,
                 int32_t* __restrict__ sub) {
  using Shape = TcShape<N, Planes>;
  constexpr int S = Shape::kStages;
  constexpr int kPhiPlane = Shape::kPhiPlane;
  constexpr int kQuarter = N / 4;  // whole columns a warpgroup and pass
  extern __shared__ unsigned char smem_raw[];
  // tiles start at multiples of 1024 bytes
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col_half = warp >> 2;  // which N / 2 columns
  const int row0 = blockIdx.x * kTcPoints;
  const int slices = f_pad / kTcDepth;

  // Built rows, where the block's points fit beside the ring (stage_x):
  // the block keeps its 64 points as X = [1, x] in shared memory (a row of
  // zeros past N), so a feature is two shared reads and the product, with
  // no edge test and no address arithmetic on device memory.
  float* xs = reinterpret_cast<float*>(smem + S * Shape::kStageBytes + 64);
  int x_pitch = 0;
  if constexpr (std::is_same<Rows, BuiltRows>::value) {
    if (stage_x) {
      x_pitch = rows.d + 1;
      for (int idx = tid; idx < kTcPoints * rows.d; idx += kTcThreads) {
        const int r = idx / rows.d;
        const int c = idx - r * rows.d;
        const int g = row0 + r;
        xs[r * x_pitch + 1 + c] =
            g < n ? __ldg(rows.x + static_cast<size_t>(g) * rows.d + c) : 0.0f;
      }
      if (tid < kTcPoints) xs[tid * x_pitch] = row0 + tid < n ? 1.0f : 0.0f;
    }
  }

  // the rows tile of slice ``ks``: this thread's features 64 ks + lane and
  // + 32 of the warp's 8 rows, into ``out``; a block and slice that lie
  // wholly inside the rows and the features skip the edge tests
  const bool inner_rows = row0 + kTcPoints <= n;
  auto load_rows = [&](int ks, float (&out)[kTcHeld]) {
    const int fc = ks * kTcDepth + lane;
    if constexpr (std::is_same<Rows, BuiltRows>::value) {
      if (stage_x) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool in_f = fc + 32 * h < f;
          const BuiltRows::Col col = rows.col(in_f ? fc + 32 * h : 0);
          const float* xr = xs + warp * kTcWarpRows * x_pitch;
#pragma unroll
          for (int i = 0; i < kTcWarpRows; ++i, xr += x_pitch)
            out[2 * i + h] = in_f ? __fmul_rn(xr[col.a], xr[col.b]) : 0.0f;
        }
        return;
      }
    }
    if (inner_rows && fc - lane + kTcDepth <= f) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const typename Rows::Col col = rows.col(fc + 32 * h);
#pragma unroll
        for (int i = 0; i < kTcWarpRows; ++i)
          out[2 * i + h] = rows.at(col, row0 + warp * kTcWarpRows + i);
      }
      return;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in_f = fc + 32 * h < f;
      const typename Rows::Col col = rows.col(in_f ? fc + 32 * h : 0);
#pragma unroll
      for (int i = 0; i < kTcWarpRows; ++i) {
        const int g = row0 + warp * kTcWarpRows + i;
        out[2 * i + h] = (in_f && g < n) ? rows.at(col, g) : 0.0f;
      }
    }
  };
  // the pair (feature lane, feature lane + 32) of a row, rounded, is one
  // 32-bit store at tile places 2 lane and 2 lane + 1
  auto store_rows = [&](int stage, const float (&in)[kTcHeld]) {
    unsigned char* a = smem + stage * Shape::kStageBytes;
#pragma unroll
    for (int i = 0; i < kTcWarpRows; ++i) {
      const int r = warp * kTcWarpRows + i;
      unsigned char* at =
          a + r * 128 + (((lane >> 2) ^ (r & 7)) << 4) + (lane & 3) * 4;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
      *reinterpret_cast<__nv_bfloat162*>(at) = hi;
      if constexpr (Planes == 2)
        *reinterpret_cast<__nv_bfloat162*>(at + kTcRowTile) =
            __floats2bfloat162_rn(in[2 * i] - __low2float(hi),
                                  in[2 * i + 1] - __high2float(hi));
    }
  };
  // step g of the product is slice g % slices of pass g / slices, in stage
  // g % S.  Its phi tile is one bulk copy, started by thread 0, whose
  // arrival the stage's barrier counts (phase g / S).
  const int steps = passes * slices;
  const uint32_t bars = base + S * Shape::kStageBytes;
  auto load_phi = [&](int g) {
    if (tid != 0) return;
    const uint32_t bar = bars + 8 * (g % S);
    mbar_expect(bar, Planes * kPhiPlane);
    bulk_copy(base + (g % S) * Shape::kStageBytes + Planes * kTcRowTile,
              phi_t + static_cast<size_t>(g) * Planes * N * kTcDepth,
              Planes * kPhiPlane, bar);
  };
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) mbar_init(bars + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this thread's two rows: row 16 (warp % 4) + lane / 4 of the block's 64
  // (first_row), and the row 8 below
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  const int first_row = row0 + (warp & 3) * 16 + (lane >> 2);
  Best best[2];
  best[0] = best[1] = {-INFINITY, 0x7fffffff, 0.0f};

  // fill the ring but one stage, all loads in flight before any store
  {
    float pre[S - 1][kTcHeld];
#pragma unroll
    for (int g = 0; g < S - 1; ++g)
      if (g < steps) load_rows(g % slices, pre[g]);
#pragma unroll
    for (int g = 0; g < S - 1; ++g) {
      if (g < steps) {
        load_phi(g);
        store_rows(g, pre[g]);
      }
    }
    fence_async_proxy();
  }
  for (int pass = 0; pass < passes; ++pass) {
    float acc[N / 4];
#pragma unroll
    for (int i = 0; i < N / 4; ++i) acc[i] = 0.0f;

    for (int t = 0; t < slices; ++t) {
      const int g = pass * slices + t;
      mbar_wait(bars + 8 * (g % S), (g / S) & 1);
      __syncthreads();  // step g is in its stage; step g - 1 is multiplied
      const uint32_t st = base + (g % S) * Shape::kStageBytes;
      const uint64_t da = wgmma_desc(st);
      const uint64_t db =
          wgmma_desc(st + Planes * kTcRowTile + col_half * (kPhiPlane / 2));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kTcDepth / 16; ++kk) {
        if constexpr (Planes == 2) {
          // rows and phi as hi + lo planes: the two cross products, then
          // hi x hi (lo x lo, ~2^-18 of a term, is left out)
          wgmma_bf16(acc, da + 2 * kk, db + kPhiPlane / 16 + 2 * kk);
          wgmma_bf16(acc, da + kTcRowTile / 16 + 2 * kk, db + 2 * kk);
        }
        wgmma_bf16(acc, da + 2 * kk, db + 2 * kk);
      }
      wgmma_commit();
      // while it runs: step g + S - 1 into the stage step g - 1 left
      const int nx = g + S - 1;
      if (nx < steps) {
        float held[kTcHeld];
        load_rows(nx % slices, held);
        load_phi(nx);
        store_rows(nx % S, held);
        fence_async_proxy();
      }
      wgmma_wait<0>();
    }

    // Fold this pass's whole columns into the running Gumbel argmax.  The
    // noise lies in [-3.32, 16.64] (u in [1e-12, 1 - 2^-24]), so a column
    // whose logit is 24 below the largest this thread holds of the row
    // cannot win: its noise is not drawn.  Without noise (hard) only a
    // largest logit can win.  Where the largest logit is infinite or above
    // 1e6 (24 nears float32's spacing there) every column is drawn.
    const int col0 = pass * (N / 2) + col_half * kQuarter + 2 * (lane & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = first_row + 8 * h;
      const uint32_t row_seed =
          tile_seed(seed, static_cast<uint32_t>(tile_off) +
                              static_cast<uint32_t>(row / tile));
      const uint32_t rit = static_cast<uint32_t>(row % tile);
      float top = -INFINITY;
#pragma unroll
      for (int j = 0; j < N / 32; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * j + e;
          float l = acc[4 * j + 2 * h + e] + (col < k ? log_w[col] : 0.0f);
          if (isnan(l) || col >= k) l = -INFINITY;
          acc[4 * j + 2 * h + e] = l;
          top = fmaxf(top, l);
        }
      }
      const float least = hard                 ? top
                          : fabsf(top) < 1e6f ? top - 24.0f
                                              : -INFINITY;
#pragma unroll
      for (int j = 0; j < N / 32; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * j + e;
          const float l = acc[4 * j + 2 * h + e];
          if (col < k && l >= least) {
            // the noise is finite: zeroing it (hard) is not adding it, and
            // added to -inf it changes nothing
            const float v =
                (hard || l == -INFINITY)
                    ? l
                    : l + gumbel(row_seed, rit * static_cast<uint32_t>(k) +
                                               static_cast<uint32_t>(col));
            if (better(v, col, best[h].v, best[h].j))
              best[h] = {v, col, acc[4 * j + 2 * h + e + N / 8]};
          }
        }
      }
    }
  }

  // a row's best over its quad, then over its two warpgroups
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const Best o = {__shfl_xor_sync(0xffffffffu, best[h].v, off),
                      __shfl_xor_sync(0xffffffffu, best[h].j, off),
                      __shfl_xor_sync(0xffffffffu, best[h].d, off)};
      if (better(o.v, o.j, best[h].v, best[h].j)) best[h] = o;
    }
  }
  __syncthreads();  // the stages are free: the second column half's bests
  Best* other = reinterpret_cast<Best*>(smem);
  if (col_half == 1 && (lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) other[first_row + 8 * h - row0] = best[h];
  }
  __syncthreads();
  if (col_half == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = first_row + 8 * h;
      if (row >= n) continue;
      const Best o = other[row - row0];
      if (better(o.v, o.j, best[h].v, best[h].j)) best[h] = o;
      const uint32_t salt =
          tile_seed(seed, static_cast<uint32_t>(tile_off) +
                              static_cast<uint32_t>(row / tile)) ^
          0xA5A5A5A5u;
      const uint32_t rit = static_cast<uint32_t>(row % tile);
      const float g_l = gumbel(salt, rit * 2u);
      const float g_r = gumbel(salt, rit * 2u + 1u);
      labels[row] = best[h].j;
      sub[row] = (best[h].d + (g_r - g_l) + 1e-30f > 0.0f) ? 1 : 0;
    }
  }
}

// Floats a row of X = [1, x] takes in shared memory where the rows are built
// from the raw points; 0 for the caches.
inline int built_width(const BuiltRows& rows) { return rows.d + 1; }
inline int built_width(const CacheRows&) { return 0; }
inline int built_width(const Bf16Rows&) { return 0; }

template <int N, int Planes, class Rows>
cudaError_t launch_width(Rows rows, const __nv_bfloat16* phi_t,
                         const float* log_w, const int32_t* seed,
                         int tile_off, int hard, int tile, int n, int f,
                         int k, int32_t* labels, int32_t* sub,
                         cudaStream_t st) {
  using Shape = TcShape<N, Planes>;
  auto kernel = assign_tc_kernel<N, Planes, Rows>;
  // the block's points beside the ring, where rows are built and they fit
  const int x_bytes = kTcPoints * built_width(rows) * 4;
  const int stage_x =
      x_bytes > 0 && Shape::kSmemBytes + x_bytes <= Shape::kSmemLimit;
  const int smem_bytes = Shape::kSmemBytes + (stage_x ? x_bytes : 0);
  // the kernel's shared-memory allowance is set once a device, not a
  // launch: setting it waits for the card, and the sweep's host must run
  // ahead of it
  static bool allowed[kTcMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kTcMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[device]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Shape::kSmemLimit);
    if (err != cudaSuccess) return err;
    allowed[device] = true;
  }
  kernel<<<(n + kTcPoints - 1) / kTcPoints, kTcThreads, smem_bytes, st>>>(
      rows, phi_t, log_w, seed, tile_off, hard, tile, n, f, tc_padded(f), k,
      tc_passes(k), stage_x, labels, sub);
  return cudaGetLastError();
}

}  // namespace

namespace ring {
// fused_assign_tc_ring.cuh: the pass for two planes at a pass width of 256
// (K > 64), which fused_assign_tc3.cu builds.
template <class Rows>
cudaError_t launch(Rows rows, const float* phi, __nv_bfloat16* phi_t,
                   const float* log_w, const int32_t* seed, int tile_off,
                   int hard, int tile, int n, int f, int k, int32_t* labels,
                   int32_t* sub, cudaStream_t st);
}  // namespace ring

template <int Planes, class Rows>
cudaError_t launch_assign_tc(Rows rows, const float* phi,
                             __nv_bfloat16* phi_t, const float* log_w,
                             const int32_t* seed, int tile_off, int hard,
                             int tile, int n, int f, int k, int32_t* labels,
                             int32_t* sub, cudaStream_t st) {
  const int width = tc_width(k);
  if constexpr (Planes == 2) {
    if (width == 256)
      return ring::launch(rows, phi, phi_t, log_w, seed, tile_off, hard, tile,
                          n, f, k, labels, sub, st);
  }
  const int f_pad = tc_padded(f);
  const int total_rows = tc_passes(k) * width;
  const int total = total_rows * f_pad;
  stage_phi_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      phi, f, k, width, f_pad, total_rows, Planes, phi_t);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#define DPMM_TC(N)                                                          \
  return launch_width<N, Planes>(rows, phi_t, log_w, seed, tile_off, hard, \
                                 tile, n, f, k, labels, sub, st)
  if (width == 32) DPMM_TC(32);
  if (width == 64) DPMM_TC(64);
  if (width == 128) DPMM_TC(128);
  DPMM_TC(256);
#undef DPMM_TC
}

// The explicit instantiations of one plane count, for the three row sources.
#define DPMM_TC_INSTANTIATE(Planes, Rows)                                    \
  template cudaError_t launch_assign_tc<Planes, Rows>(                       \
      Rows, const float*, __nv_bfloat16*, const float*, const int32_t*, int, \
      int, int, int, int, int, int32_t*, int32_t*, cudaStream_t)
#define DPMM_TC_INSTANTIATE_ALL(Planes)      \
  DPMM_TC_INSTANTIATE(Planes, CacheRows);    \
  DPMM_TC_INSTANTIATE(Planes, BuiltRows);    \
  DPMM_TC_INSTANTIATE(Planes, Bf16Rows)

}  // namespace dpmm
