// Kernel A's assign pass on the tensor cores for two planes at a pass width
// of 256 (K > 64): the three-pass bf16 split of "high", and of "default" on
// float32 rows at the fits' widths.  fused_assign_tc.cuh's launcher hands
// those shapes here; one plane and the narrower passes keep its kernel.
//
// Replaces the ll product of dpmmsubclusters_tpu/ops/pallas_sweep.py:518
// fused_assign (kernel body _kernel :264, product :311-323) at
// Precision.HIGH (:322-323, XLA's bf16x3), which the JAX kernel's
// float32-faithful dot also meets under "default" on float32 rows: rows
// and phi each split into hi = bf16(v) and lo = bf16(v - hi), and hi x hi +
// hi x lo + lo x hi summed, float32-faithful to about 2^-17 of a term (why
// "default" needs it: ops/sweep_kernels.py's ll_route).  Everything after
// the product (the Gumbel argmax, the sub-label, the hash, the NaN and tie
// rules) is fused_assign.cu's, bit for bit; fused_assign.cu launches the
// statistics pass after it.  fused_assign_tc3.cu builds it.
//
// What bounds it on the H100: 2 * F * 2K flop a point (whole and delta
// columns) per plane product at the tensor cores' 989 TFLOP/s (bf16, dense)
// against 4F bytes of an f32 cache row (2F of a bf16 one, 4D of raw points)
// at 3.35 TB/s.  An f32 cache row at K = 128 gives 3 * 2 * 256 / 4 = 384
// flop a byte in three passes, over the card's 295, so the tensor cores and
// the cache's read come out even; rows built from the points (D = 64,
// K = 256: 24,000 flop a byte) leave it to the tensor cores.  Behind those
// two sit two on-chip limits: every tile of points streams the whole of
// phi from L2 (64 flop a byte of phi and plane at 64 points a tile:
// fused_assign_tc.cuh's blocks read 73 GB of phi from L2 a call at D = 64,
// K = 256), and
// loads, stores and products that do not overlap.
//
// Design, one cluster of two blocks on two SMs, each block persistent:
//  * a block walks 128-point tiles (tile 2 p + rank of pair p, the pairs
//    dealt to the clusters in turn); two consumer warpgroups each own 64
//    of a tile's rows over all N columns of a pass (m64nNk16, N / 2 sums a
//    thread: 128 at N = 256), so a row's columns sit in the four lanes of
//    a quad of one warp and the argmax needs no exchange between
//    warpgroups;
//  * phi reaches both blocks of a cluster by multicast: each block's
//    producer copies half of a step's phi tile into the same place of both
//    blocks (cp.async.bulk ... .multicast::cluster), so one read of phi
//    from L2 feeds 256 points, four times a 64-point block's;
//  * a producer warpgroup (the third) only starts copies: its thread 0
//    waits for a stage of the ring (2-6 stages in shared memory, a full
//    and an empty mbarrier each) to be empty and starts the block's half of
//    the step's phi copy, whose bytes the full barrier counts; the others
//    copy what the rows are made of into the producer's room by cp.async
//    ahead of need, a word a value (a cache's values into one or two raw
//    buffers of a step, or the tile's points X for built rows), each copy
//    counted on that buffer's full barrier as it lands, so no register
//    holds a load in flight.  A stage is empty when all eight consumer
//    warps of both blocks have released it (an arrive on the issuing
//    block's barrier, remote for the partner);
//  * the consumers keep one wgmma group in flight (wait_group 1); while
//    the tensor cores multiply step g, each consumer warpgroup rounds its
//    own 64 rows of step g + 1 to bf16 (hi and lo planes) into the next
//    stage and fences them for wgmma's proxy (eight warps share that work,
//    beside the products), releases the stage of step g - 1, and folds a
//    pass into the running Gumbel argmax at its end.  setmaxnreg gives the
//    consumers 216 registers a thread and the producer 72;
//  * phi is staged once a launch by stage_phi_kernel into ``phi_t``: bf16
//    (round to nearest even), cut into the ring's tiles as they lie in
//    shared memory (swizzle included), zero-padded to whole slices and whole
//    passes.  A pass holds N / 2 whole columns and then their N / 2 delta
//    columns, so a whole column's delta sits N / 4 registers after it in
//    the same thread (wgmma.cuh's layout);
//  * rows: a consumer lane owns the features 2 lane and 2 lane + 1 of a
//    slice, rounded as one 32-bit store a plane; features past F and rows
//    past N are zeros.  Built rows are __fmul_rn(X[a], X[b]) from the
//    tile's points in shared memory where they fit beside two stages
//    (D <= 67 at N = 256 with two planes), else from device memory.  A
//    built row is the cache's row bit for bit and a bf16 row rounds to
//    itself, so "gaussian" equals "precomputed" and "bfloat16" equals
//    "precomputed" on cache.float(), as in the exact kernel;
//  * the ring runs on across passes and tiles (K > N / 2 re-reads or
//    rebuilds the rows a pass): a tile's step s is slice s % slices of pass
//    s / slices.  The partner of a last, odd tile walks an empty tile (rows
//    of zeros, nothing written) so that both blocks take part in every
//    barrier, and a producer leaves only after every consumer of the
//    cluster has released its last stages;
//  * a launch runs the passes up to the highest live column only
//    (live_passes: each block reads log_w at its start), not every pass of
//    the table's width: a slot past it is inactive (log_w -inf), so its
//    logit is -inf and its index above every column that runs, and it wins
//    neither outright nor at a tie.  The labels are those of every pass;
//    every block reads the same log_w, so the partners walk the same steps;
//  * the noise is drawn only for columns that can win (fold_pass).  The
//    noise of column j depends only on j and the row's global index, and a
//    column wins only by jnp.argmax's rule (larger value, then smaller
//    column), so neither the order of folding nor the tile a block takes
//    matters.
#pragma once

#include "fused_assign_tc.cuh"

#include <algorithm>
#include <cmath>
#include <type_traits>

namespace dpmm {
namespace ring {
namespace {

constexpr int kTcPoints = 128;   // points a tile: 64 a consumer warpgroup
constexpr int kTcConsumerThreads = 256;  // two warpgroups
constexpr int kTcProducerThreads = 128;  // and the producer's
constexpr int kTcThreads = kTcConsumerThreads + kTcProducerThreads;
constexpr int kTcCluster = 2;    // blocks that share a phi tile
// warps that release a stage: every consumer warp of the cluster
constexpr int kTcReleases = kTcCluster * kTcConsumerThreads / 32;
constexpr int kTcDepth = 64;     // features a slice: one 128-byte tile row
// rows a producer warp copies, and a consumer warp stages
constexpr int kTcProducerRows = kTcPoints / (kTcProducerThreads / 32);
constexpr int kTcConsumerRows = kTcPoints / (kTcConsumerThreads / 32);
// registers a thread after setmaxnreg: 2 x 128 x 216 + 128 x 72 = 168 x
// 384, the launch's own (a consumer holds 128 sums at N = 256 and stages
// rows; the producer only starts copies)
constexpr int kTcConsumerRegs = 216;
constexpr int kTcProducerRegs = 72;
constexpr int kTcRowTile = kTcPoints * kTcDepth * 2;  // bytes a plane
constexpr int kTcMaxStages = 6;
constexpr int kTcMaxRaw = 2;  // a cache's raw buffers at most
// after the stages: the barriers (TcGrid), then the producer's room
constexpr int kTcBarBytes = 8 * (2 * kTcMaxStages + 2 * kTcMaxRaw + 2);
// a cache's raw buffer holds a step's 128 rows of 64 values: an f32
// cache's a 4-byte word each, a bf16 cache's as the 16-byte pieces of the
// row that hold them (the slice and the aligned bytes around it)
constexpr int kTcRawBytes = kTcPoints * kTcDepth * 4;
constexpr int kTcBf16Pitch = kTcDepth * 2 + 16;  // bytes a row
template <class Cache>
__host__ __device__ constexpr int raw_bytes() {
  return std::is_same<Cache, Bf16Rows>::value ? kTcPoints * kTcBf16Pitch
                                              : kTcRawBytes;
}
// a block's shared memory (227 KB) less the room to align the first tile
constexpr int kTcSmemMax = 232448;
constexpr int kTcSmemUsable = kTcSmemMax - 1024 - kTcBarBytes;
constexpr int kTcMaxDevices = 64;  // cards of one host the launcher tracks

// A stage holds, per plane (one for the single bf16 pass; hi and lo for the
// three-pass split), the tile's rows (two 64-row halves), then per plane a
// phi tile of N rows.
template <int N, int Planes>
struct TcShape {
  static constexpr int kPhiPlane = N * kTcDepth * 2;  // bytes
  static constexpr int kStageBytes = Planes * (kTcRowTile + kPhiPlane);
  static_assert(2 * kStageBytes + kTcRawBytes <= kTcSmemUsable,
                "two stages and a raw buffer must fit");
};

// phi [f, 2k] float32, columns [whole k | delta k] -> phi_t, the bf16 tiles
// of the ring as they lie in shared memory, one after the other: step
// (pass p, slice s) holds, per plane, N rows of 64 features, 128 bytes a row
// in the 128-byte swizzle.  Plane 0 is phi rounded to bf16 (to nearest
// even); plane 1, where there are two, the rounded rest.  Row c of pass p is
// whole column p * N / 2 + c for c < N / 2, else the delta column of whole
// column p * N / 2 + c - N / 2; columns past k and features past f are
// zero.
__global__ void stage_phi_kernel(const float* __restrict__ phi, int f, int k,
                                 int width, int f_pad, int total_rows,
                                 int planes,
                                 __nv_bfloat16* __restrict__ phi_t) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total_rows * f_pad) return;
  const int row = idx % total_rows;  // neighbours read neighbouring columns
  const int fc = idx / total_rows;
  const int half = width / 2;
  const int r = row % width;  // the row in the tile
  const int j = (row / width) * half + r % half;
  float v = 0.0f;
  if (j < k && fc < f)
    v = phi[static_cast<size_t>(fc) * 2 * k + (r < half ? j : k + j)];
  const int fk = fc % kTcDepth;  // its place in the tile row
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}
// One arrival on the barrier at the same place in block ``cta`` of the
// cluster (this block's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n"
      ".reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(cta)
      : "memory");
}
// ``bytes`` (a multiple of 16) from global memory to the same shared
// address of every block of the cluster by the copy engine; their arrival
// counts on each block's barrier at ``bar``.
__device__ __forceinline__ void bulk_copy_multicast(uint32_t dst,
                                                    const void* src,
                                                    uint32_t bytes,
                                                    uint32_t bar) {
  const uint16_t mask = (1u << kTcCluster) - 1;
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of both blocks of the cluster, with release and acquire.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// The passes of ``half`` whole columns a launch runs: those up to the pass
// of the highest column j < k whose log_w[j] is not -inf (NaN and +inf
// count as live), at least one (no live column: column 0 takes every row,
// as in a full walk), at most ``passes``, the table width's.  Every thread
// of the block calls it; the loop's turns are the block's, so it is
// uniform.
__device__ __forceinline__ int live_passes(const float* __restrict__ log_w,
                                           int k, int passes, int half) {
  int p = passes - 1;
  for (; p > 0; --p) {
    bool live = false;
    for (int j = p * half + static_cast<int>(threadIdx.x);
         j < min(k, (p + 1) * half); j += static_cast<int>(blockDim.x))
      live |= __ldg(log_w + j) != -INFINITY;
    if (__syncthreads_or(live)) break;
  }
  return p + 1;
}
// A launch's passes run and the passes its table width calls for, added to
// ``tally`` [2] by one thread of the launch where the width calls for more
// than one pass (the launches whose count can differ); plain adds: the
// launches of a stream run in turn.  No tally (null): nothing.
__device__ __forceinline__ void tally_passes(unsigned long long* tally,
                                             int run, int passes) {
  if (tally != nullptr && passes > 1 && blockIdx.x == 0 &&
      threadIdx.x == 0) {
    tally[0] += run;
    tally[1] += passes;
  }
}

// What a launch shares between the producer and the consumers: the ring,
// the walk over tiles and, after the ring, the barriers and the producer's
// room (a cache's raw buffers, or the tile's points X).
struct TcGrid {
  uint32_t base;    // shared address of stage 0
  uint32_t bars;    // shared address of the barriers
  uint32_t aux;     // shared address of the producer's room
  int stages;       // of the ring
  int nraw;         // a cache's raw buffers (1 or 2)
  int stage_x;      // built rows: the tile's points staged as X
  int rank;         // this block's in the cluster
  int cluster;      // the cluster's index, and their count
  int clusters;
  int pairs;        // pairs of 128-point tiles
  int slices;       // 64-feature slices of a pass
  int passes;       // a tile's: up to the highest live column
  int steps;        // a tile's: passes x slices
  int total;        // this block's: its tile pairs x steps
  // stage s is full (phi's bytes arrived) and empty (released by every
  // consumer warp of the cluster)
  __device__ uint32_t full_bar(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty_bar(int s) const {
    return bars + 8 * (kTcMaxStages + s);
  }
  // raw buffer b is full (the producer's copies landed) and empty (read by
  // every consumer warp of the block); X likewise
  __device__ uint32_t raw_full(int b) const {
    return bars + 8 * (2 * kTcMaxStages + b);
  }
  __device__ uint32_t raw_empty(int b) const {
    return bars + 8 * (2 * kTcMaxStages + kTcMaxRaw + b);
  }
  __device__ uint32_t x_full() const {
    return bars + 8 * (2 * kTcMaxStages + 2 * kTcMaxRaw);
  }
  __device__ uint32_t x_empty() const { return x_full() + 8; }
  // the first point of the tile of this block's step q
  __device__ int row0(int q) const {
    return (kTcCluster * (cluster + q / steps * clusters) + rank) *
           kTcPoints;
  }
  // the first feature of step q's slice
  __device__ int f0(int q) const { return q % steps % slices * kTcDepth; }
};

// cp.async of one 4-byte word (or 16 bytes) from global to shared memory,
// of which ``bytes`` are read and the rest are zeros; and one arrival on a barrier
// when all of this thread's earlier cp.async have landed (its count
// includes it).
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::
                   "r"(bar)
               : "memory");
}
// A consumer warpgroup's 128 threads alone.
__device__ __forceinline__ void consumer_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// Row r's features (2 lane, 2 lane + 1) of a slice, rounded to bf16, into
// the tile at ``a``: one 32-bit store (and the rounded rest into the second
// plane, where there are two).
template <int Planes>
__device__ __forceinline__ void store_pair(unsigned char* a, int r, int lane,
                                           float v0, float v1) {
  unsigned char* at =
      a + r * 128 + (((lane >> 2) ^ (r & 7)) << 4) + (lane & 3) * 4;
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v0, v1);
  *reinterpret_cast<__nv_bfloat162*>(at) = hi;
  if constexpr (Planes == 2)
    *reinterpret_cast<__nv_bfloat162*>(at + kTcRowTile) =
        __floats2bfloat162_rn(v0 - __low2float(hi), v1 - __high2float(hi));
}

// The producer warpgroup (module note): for a cache, every step's rows into
// the raw buffers by cp.async (a producer warp's 32 rows, a lane's two
// features: an f32 value is its word; a bf16 value at an odd 2-byte place is
// the high half of the word before it, at an even place the low half of
// its own word, of which only its 2 bytes are read; zeros past N and F);
// for built rows staged as X, each tile's points; and, by its thread 0,
// every step's phi.
template <int N, int Planes, class Rows>
__device__ __forceinline__ void produce(const TcGrid& grid, const Rows& rows,
                                        const __nv_bfloat16* phi_t, int n,
                                        int f) {
  using Shape = TcShape<N, Planes>;
  constexpr int kHalf = Planes * Shape::kPhiPlane / kTcCluster;  // bytes
  const int pt = threadIdx.x - kTcConsumerThreads;
  const int lane = pt & 31;
  const int r0 = (pt >> 5) * kTcProducerRows;  // the warp's first row
  int g = 0;
  for (; g < grid.total; ++g) {
    const int row0 = grid.row0(g);
    if constexpr (std::is_same<Rows, BuiltRows>::value) {
      if (grid.stage_x && g % grid.steps == 0) {
        // the tile's points (rows of zeros past N) once every consumer
        // warp is done with the last tile's: row pt, a word a thread
        mbar_wait(grid.x_empty(), ((g / grid.steps) & 1) ^ 1);
        const int gr = row0 + pt;
        const float* src = rows.x + static_cast<size_t>(gr) * rows.d;
        for (int c = 0; c < rows.d; ++c)
          cp_async4(grid.aux + (pt * rows.d + c) * 4,
                    gr < n ? src + c : rows.x, gr < n ? 4 : 0);
        cp_async_arrive(grid.x_full());
      }
    } else {
      const int b = g % grid.nraw;
      mbar_wait(grid.raw_empty(b), ((g / grid.nraw) & 1) ^ 1);
      const uint32_t buf = grid.aux + b * raw_bytes<Rows>();
      if constexpr (std::is_same<Rows, Bf16Rows>::value) {
        // row pt: the 16-byte pieces that hold its slice, nothing past the
        // cache's last byte, nothing of rows past N
        const int gr = row0 + pt;
        if (gr < n) {
          const char* start = reinterpret_cast<const char*>(
              rows.feat + static_cast<size_t>(gr) * rows.ld + grid.f0(g));
          const char* a0 = reinterpret_cast<const char*>(
              reinterpret_cast<uintptr_t>(start) & ~uintptr_t{15});
          const char* end = reinterpret_cast<const char*>(
              rows.feat + static_cast<size_t>(n - 1) * rows.ld + rows.f);
          const int len = min(kTcDepth, rows.f - grid.f0(g)) * 2;
          const int pieces = static_cast<int>((start + len - a0 + 15) >> 4);
          for (int j = 0; j < pieces; ++j) {
            const long room = end - (a0 + 16 * j);
            cp_async16(buf + pt * kTcBf16Pitch + 16 * j, a0 + 16 * j,
                       room < 16 ? static_cast<int>(room) : 16);
          }
        }
      } else {
        // a warp's 32 rows, a lane's two values a row, zeros past N and F
        const int c = grid.f0(g) + 2 * lane;
        const uint32_t dst = buf + (r0 * kTcDepth + 2 * lane) * 4;
        const float* p = rows.feat + static_cast<size_t>(row0 + r0) * rows.f + c;
#pragma unroll 4
        for (int i = 0; i < kTcProducerRows; ++i, p += rows.f) {
          const bool in_n = row0 + r0 + i < n;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool in = in_n && c + h < rows.f;
            cp_async4(dst + (i * kTcDepth + h) * 4, in ? p + h : rows.feat,
                      in ? 4 : 0);
          }
        }
      }
      cp_async_arrive(grid.raw_full(b));
    }
    if (pt == 0) {
      // phi: this block's half of the step's tile, into both blocks, once
      // the stage is empty
      const int s = g % grid.stages;
      mbar_wait(grid.empty_bar(s), ((g / grid.stages) & 1) ^ 1);
      mbar_expect(grid.full_bar(s), Planes * Shape::kPhiPlane);
      bulk_copy_multicast(
          grid.base + s * Shape::kStageBytes + Planes * kTcRowTile +
              grid.rank * kHalf,
          reinterpret_cast<const unsigned char*>(phi_t) +
              static_cast<size_t>(g % grid.steps) * Planes *
                  Shape::kPhiPlane +
              grid.rank * kHalf,
          kHalf, grid.full_bar(s));
    }
  }
  // stay until every consumer of the cluster has released this block's
  // last stages: their arrivals land in this block's shared memory
  if (pt == 0) {
    for (int i = 0; i < grid.stages; ++i, ++g)
      mbar_wait(grid.empty_bar(g % grid.stages),
                ((g / grid.stages) & 1) ^ 1);
  }
}

// A consumer warp's rows (16 of its warpgroup's 64) of this block's step q
// into stage q % stages, a lane's two features, rounded to bf16: from the
// raw buffer (a cache), the staged points X (built rows: X[a] * X[b] with
// X = [1, x], __fmul_rn as BuiltRows::at) or device memory (built rows
// whose points did not fit).  Then fenced for wgmma's proxy.
template <int N, int Planes, class Rows>
__device__ __forceinline__ void stage_rows(const TcGrid& grid,
                                           const Rows& rows,
                                           unsigned char* smem, int q, int rw,
                                           int lane, int n, int f) {
  using Shape = TcShape<N, Planes>;
  unsigned char* a = smem + q % grid.stages * Shape::kStageBytes;
  const int row0 = grid.row0(q);
  const int c = grid.f0(q) + 2 * lane;
  if constexpr (std::is_same<Rows, BuiltRows>::value) {
    const bool in0 = c < f, in1 = c + 1 < f;
    const BuiltRows::Col c0 = rows.col(in0 ? c : 0);
    const BuiltRows::Col c1 = rows.col(in1 ? c + 1 : 0);
    if (grid.stage_x) {
      const int ps = q % grid.steps;
      if (ps == 0) mbar_wait(grid.x_full(), (q / grid.steps) & 1);
      const float* xr = reinterpret_cast<const float*>(
                            smem + (grid.aux - grid.base)) +
                        rw * rows.d - 1;  // X[a] = xr[a] for a >= 1
#pragma unroll
      for (int i = 0; i < kTcConsumerRows; ++i, xr += rows.d)
        store_pair<Planes>(
            a, rw + i, lane,
            in0 ? __fmul_rn(c0.a ? xr[c0.a] : 1.0f, c0.b ? xr[c0.b] : 1.0f)
                : 0.0f,
            in1 ? __fmul_rn(c1.a ? xr[c1.a] : 1.0f, c1.b ? xr[c1.b] : 1.0f)
                : 0.0f);
      if (ps == grid.steps - 1 && lane == 0) mbar_arrive(grid.x_empty());
    } else {
      const float* xr = rows.x + static_cast<size_t>(row0 + rw) * rows.d - 1;
#pragma unroll 4
      for (int i = 0; i < kTcConsumerRows; ++i, xr += rows.d) {
        const bool in_n = row0 + rw + i < n;
        store_pair<Planes>(
            a, rw + i, lane,
            in0 && in_n ? __fmul_rn(c0.a ? __ldg(xr + c0.a) : 1.0f,
                                    c0.b ? __ldg(xr + c0.b) : 1.0f)
                        : 0.0f,
            in1 && in_n ? __fmul_rn(c1.a ? __ldg(xr + c1.a) : 1.0f,
                                    c1.b ? __ldg(xr + c1.b) : 1.0f)
                        : 0.0f);
      }
    }
  } else {
    const int b = q % grid.nraw;
    mbar_wait(grid.raw_full(b), (q / grid.nraw) & 1);
    const unsigned char* buf =
        smem + (grid.aux - grid.base) + b * raw_bytes<Rows>();
    if constexpr (std::is_same<Rows, Bf16Rows>::value) {
      // the slice's first value sits as far into the row's pieces as the
      // row's slice into its first 16 bytes; bf16 to float is its 16 bits
      // above 16 zeros; zeros past N and F
      const __nv_bfloat16* p =
          rows.feat + static_cast<size_t>(row0 + rw) * rows.ld + grid.f0(q);
#pragma unroll
      for (int i = 0; i < kTcConsumerRows; ++i, p += rows.ld) {
        const int off = reinterpret_cast<uintptr_t>(p) & 15;
        const unsigned char* v =
            buf + (rw + i) * kTcBf16Pitch + off + 4 * lane;
        uint32_t w;
        if (off & 3)
          w = *reinterpret_cast<const uint16_t*>(v) |
              static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(v + 2))
                  << 16;
        else
          w = *reinterpret_cast<const uint32_t*>(v);
        const bool in_n = row0 + rw + i < n;
        store_pair<Planes>(
            a, rw + i, lane,
            in_n && c < rows.f ? __uint_as_float(w << 16) : 0.0f,
            in_n && c + 1 < rows.f ? __uint_as_float(w & 0xffff0000u)
                                   : 0.0f);
      }
    } else {
      const uint2* raw = reinterpret_cast<const uint2*>(buf);
#pragma unroll
      for (int i = 0; i < kTcConsumerRows; ++i) {
        const uint2 w = raw[((rw + i) * kTcDepth + 2 * lane) / 2];
        store_pair<Planes>(a, rw + i, lane, __uint_as_float(w.x),
                           __uint_as_float(w.y));
      }
    }
    if (lane == 0) mbar_arrive(grid.raw_empty(b));
  }
  fence_async_proxy();
}

// Fold one pass of N columns into the running Gumbel argmax of a consumer
// thread's two rows (best[h] for row first_row + 8 h).  ``acc`` holds the
// m64nN accumulators of the pass: the thread's whole columns, then their
// delta columns N / 4 on; the whole columns' sums become their logits.  The
// noise lies in [-3.32, 16.64] (u in [1e-12, 1 - 2^-24]), so a column whose
// logit is 24 below the largest of the row in this pass cannot win: its
// noise is not drawn.  Without noise (hard) only a largest logit can win.
// Where the largest logit is infinite or above 1e6 (24 nears float32's
// spacing there) every column is drawn.  The kernels of both designs
// (this ring and fused_assign_tc_tma.cuh) fold through here.
template <int N>
__device__ __forceinline__ void fold_pass(float (&acc)[N / 2],
                                          Best (&best)[2], int pass,
                                          int first_row, int lane,
                                          const float* __restrict__ log_w,
                                          uint32_t seed, int tile_off,
                                          int hard, int tile, int k) {
  const int col0 = pass * (N / 2) + 2 * (lane & 3);
  // the logits of the thread's columns, both rows at once
#pragma unroll
  for (int j = 0; j < N / 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = col0 + 8 * j + e;
      const float lw = col < k ? __ldg(log_w + col) : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float l = acc[4 * j + 2 * h + e] + lw;
        acc[4 * j + 2 * h + e] = isnan(l) || col >= k ? -INFINITY : l;
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = first_row + 8 * h;
    const uint32_t row_seed =
        tile_seed(seed, static_cast<uint32_t>(tile_off) +
                            static_cast<uint32_t>(row / tile));
    const uint32_t rit = static_cast<uint32_t>(row % tile);
    float top = -INFINITY;
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) top = fmaxf(top, acc[4 * j + 2 * h + e]);
    }
    // the row's largest over its quad
    top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 1));
    top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 2));
    const float least = hard                 ? top
                        : fabsf(top) < 1e6f ? top - 24.0f
                                            : -INFINITY;
    // two columns at a time: where any lane of the warp has one that can
    // win, both noises are drawn side by side and kept where they count
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
      bool any = false;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        any |= col0 + 8 * j + e < k && acc[4 * j + 2 * h + e] >= least;
      if (!__any_sync(0xffffffffu, any)) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * j + e;
        const float l = acc[4 * j + 2 * h + e];
        // the noise is finite: zeroing it (hard) is not adding it, and
        // added to -inf it changes nothing
        const float noise =
            hard ? 0.0f
                 : gumbel(row_seed, rit * static_cast<uint32_t>(k) +
                                        static_cast<uint32_t>(col));
        const float v = (hard || l == -INFINITY) ? l : l + noise;
        if (col < k && l >= least && better(v, col, best[h].v, best[h].j))
          best[h] = {v, col, acc[4 * j + 2 * h + e + N / 4]};
      }
    }
  }
}

// A consumer thread's two rows' best over their quads, then each row's
// label and sub-label (written by the quad's first lane; rows past n are
// not written).
__device__ __forceinline__ void write_labels(Best (&best)[2], int first_row,
                                             int lane, uint32_t seed,
                                             int tile_off, int tile, int n,
                                             int32_t* __restrict__ labels,
                                             int32_t* __restrict__ sub) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const Best o = {__shfl_xor_sync(0xffffffffu, best[h].v, off),
                      __shfl_xor_sync(0xffffffffu, best[h].j, off),
                      __shfl_xor_sync(0xffffffffu, best[h].d, off)};
      if (better(o.v, o.j, best[h].v, best[h].j)) best[h] = o;
    }
    const int row = first_row + 8 * h;
    if ((lane & 3) == 0 && row < n) {
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

// A consumer warpgroup: the product of its 64 rows of each tile with every
// pass's N columns, folded into the Gumbel argmax, then the labels; it
// stages the rows of the step after the one the tensor cores multiply.
template <int N, int Planes, class Rows>
__device__ __forceinline__ void consume(const TcGrid& grid, const Rows& rows,
                                        unsigned char* smem,
                                        const float* __restrict__ log_w,
                                        uint32_t seed, int tile_off, int hard,
                                        int tile, int n, int f, int k,
                                        int32_t* __restrict__ labels,
                                        int32_t* __restrict__ sub) {
  using Shape = TcShape<N, Planes>;
  constexpr int kPhiPlane = Shape::kPhiPlane;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int rw = wg * 64 + warp * kTcConsumerRows;  // the warp's rows
  // a stage is released by lane 0 of each consumer warp, to both blocks
  auto release = [&](int g) {
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kTcCluster; ++c)
        mbar_arrive_cluster(grid.empty_bar(g % grid.stages), c);
    }
  };
  if (grid.total > 0) {
    stage_rows<N, Planes>(grid, rows, smem, 0, rw, lane, n, f);
    consumer_sync(wg);
  }
  int g = 0;
  for (int p = grid.cluster; p < grid.pairs; p += grid.clusters) {
    // this thread's two rows: row 16 warp + lane / 4 of the warpgroup's 64
    // (first_row), and the row 8 below
    const int first_row = (kTcCluster * p + grid.rank) * kTcPoints +
                          wg * 64 + warp * 16 + (lane >> 2);
    Best best[2];
    best[0] = best[1] = {-INFINITY, 0x7fffffff, 0.0f};
    for (int pass = 0; pass < grid.passes; ++pass) {
      float acc[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
      for (int t = 0; t < grid.slices; ++t, ++g) {
        const int s = g % grid.stages;
        mbar_wait(grid.full_bar(s), (g / grid.stages) & 1);
        const uint32_t st = grid.base + s * Shape::kStageBytes;
        const uint64_t da = wgmma_desc(st + wg * (kTcRowTile / 2));
        const uint64_t db = wgmma_desc(st + Planes * kTcRowTile);
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
        // the step before is multiplied: its stage goes back to the ring,
        // and this warpgroup's rows of the next step go into it (or, past
        // two stages, into the one after)
        wgmma_wait<1>();
        consumer_sync(wg);
        if (t > 0) release(g - 1);
        if (g + 1 < grid.total) {
          stage_rows<N, Planes>(grid, rows, smem, g + 1, rw, lane, n, f);
          consumer_sync(wg);
        }
      }
      wgmma_wait<0>();
      release(g - 1);

      fold_pass<N>(acc, best, pass, first_row, lane, log_w, seed, tile_off,
                   hard, tile, k);
    }
    write_labels(best, first_row, lane, seed, tile_off, tile, n, labels,
                 sub);
  }
}

template <int N, int Planes, class Rows>
__global__ void __cluster_dims__(kTcCluster, 1, 1)
    __launch_bounds__(kTcThreads, 1)
    assign_tc_kernel(Rows rows, const __nv_bfloat16* __restrict__ phi_t,
                     const float* __restrict__ log_w,
                     const int32_t* __restrict__ seed_ptr, int tile_off,
                     int hard, int tile, int n, int f, int f_pad, int k,
                     int passes, int stages, int aux_mode,
                     int32_t* __restrict__ labels,
                     int32_t* __restrict__ sub,
                     unsigned long long* __restrict__ tally) {
  using Shape = TcShape<N, Planes>;
  extern __shared__ unsigned char smem_raw[];
  // tiles start at multiples of 1024 bytes, at the same place in both
  // blocks (the multicast writes there)
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  TcGrid grid;
  grid.base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (grid.base - raw);
  grid.bars = grid.base + stages * Shape::kStageBytes;
  grid.aux = grid.bars + kTcBarBytes;
  grid.stages = stages;
  grid.nraw = std::is_same<Rows, BuiltRows>::value ? 1 : aux_mode;
  grid.stage_x = std::is_same<Rows, BuiltRows>::value && aux_mode;
  grid.rank = static_cast<int>(cluster_rank());
  grid.cluster = blockIdx.x / kTcCluster;
  grid.clusters = gridDim.x / kTcCluster;
  grid.pairs = ((n + kTcPoints - 1) / kTcPoints + kTcCluster - 1) /
               kTcCluster;
  grid.slices = f_pad / kTcDepth;
  // the passes up to the highest live column, of the width's ``passes``
  grid.passes = live_passes(log_w, k, passes, N / 2);
  tally_passes(tally, grid.passes, passes);
  grid.steps = grid.passes * grid.slices;
  grid.total = (grid.pairs - grid.cluster + grid.clusters - 1) /
               grid.clusters * grid.steps;
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(grid.full_bar(s), 1);  // the phi copy's issuer
      mbar_init(grid.empty_bar(s), kTcReleases);
    }
    for (int b = 0; b < kTcMaxRaw; ++b) {
      mbar_init(grid.raw_full(b), kTcProducerThreads);
      mbar_init(grid.raw_empty(b), kTcConsumerThreads / 32);
    }
    mbar_init(grid.x_full(), kTcProducerThreads);
    mbar_init(grid.x_empty(), kTcConsumerThreads / 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // both blocks' barriers are ready before either block's copies or
  // releases reach them
  cluster_sync();
  if (threadIdx.x >= kTcConsumerThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kTcProducerRegs));
    produce<N, Planes>(grid, rows, phi_t, n, f);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kTcConsumerRegs));
    consume<N, Planes>(grid, rows, smem, log_w,
                       static_cast<uint32_t>(seed_ptr[0]), tile_off, hard,
                       tile, n, f, k, labels, sub);
  }
}

// The producer's room after the ring (the kernel's aux_mode, and its
// bytes): built rows stage the tile's points X (its D words a row) where
// two stages still fit beside them (1), else none (0); a cache takes as many
// raw buffers (1 or 2) as fit beside two stages.
template <int StageBytes>
inline void aux_plan(const BuiltRows& rows, int& mode, int& bytes) {
  bytes = kTcPoints * rows.d * 4;
  mode = 2 * StageBytes + bytes <= kTcSmemUsable;
  if (!mode) bytes = 0;
}
template <int StageBytes, class Cache>
inline void aux_plan(const Cache&, int& mode, int& bytes) {
  mode = std::min(kTcMaxRaw,
                  (kTcSmemUsable - 2 * StageBytes) / raw_bytes<Cache>());
  bytes = mode * raw_bytes<Cache>();
}

template <int N, int Planes, class Rows>
cudaError_t launch_width(Rows rows, const __nv_bfloat16* phi_t,
                         const float* log_w, const int32_t* seed,
                         int tile_off, int hard, int tile, int n, int f,
                         int k, int32_t* labels, int32_t* sub,
                         unsigned long long* tally, cudaStream_t st) {
  using Shape = TcShape<N, Planes>;
  auto kernel = assign_tc_kernel<N, Planes, Rows>;
  // the ring's stages in what the producer's room leaves
  int aux_mode = 0, aux_bytes = 0;
  aux_plan<Shape::kStageBytes>(rows, aux_mode, aux_bytes);
  const int stages = std::min(
      kTcMaxStages, (kTcSmemUsable - aux_bytes) / Shape::kStageBytes);
  const int smem_bytes =
      stages * Shape::kStageBytes + 1024 + kTcBarBytes + aux_bytes;
  // the kernel's shared-memory allowance and how many of its clusters the
  // card holds at once are settled once a device, not a launch: both wait
  // for the card, and the sweep's host must run ahead of it
  static int resident[kTcMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kTcMaxDevices) return cudaErrorInvalidDevice;
  if (!resident[device]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcSmemMax);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(sms / kTcCluster * kTcCluster);
    cfg.blockDim = dim3(kTcThreads);
    cfg.dynamicSmemBytes = kTcSmemMax;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    resident[device] = clusters;
  }
  const int pairs =
      ((n + kTcPoints - 1) / kTcPoints + kTcCluster - 1) / kTcCluster;
  if (pairs == 0) return cudaSuccess;
  const int clusters = std::min(pairs, resident[device]);
  kernel<<<clusters * kTcCluster, kTcThreads, smem_bytes, st>>>(
      rows, phi_t, log_w, seed, tile_off, hard, tile, n, f, tc_padded(f), k,
      tc_passes(k), stages, aux_mode, labels, sub, tally);
  return cudaGetLastError();
}

}  // namespace

template <class Rows>
cudaError_t launch(Rows rows, const float* phi, __nv_bfloat16* phi_t,
                   const float* log_w, const int32_t* seed, int tile_off,
                   int hard, int tile, int n, int f, int k, int32_t* labels,
                   int32_t* sub, unsigned long long* tally, cudaStream_t st) {
  constexpr int kWidth = 256, kPlanes = 2;
  const int f_pad = tc_padded(f);
  const int total_rows = tc_passes(k) * kWidth;
  const int total = total_rows * f_pad;
  stage_phi_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      phi, f, k, kWidth, f_pad, total_rows, kPlanes, phi_t);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_width<kWidth, kPlanes>(rows, phi_t, log_w, seed, tile_off,
                                       hard, tile, n, f, k, labels, sub,
                                       tally, st);
}

}  // namespace ring
}  // namespace dpmm
