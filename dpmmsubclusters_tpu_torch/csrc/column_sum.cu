// Kernel C: the column sums of a row-major f32 matrix, and the fixed-order
// reduction of per-block partial rows that kernel D shares.
//
// Replaces benchmarks/kernel_tile_study.py:30 variant (call :58) in its
// ``dma_only`` mode, whose kernel (:38-51) adds every tile's rows of x into
// row 0 of its statistics output: the TPU study's measure of the rate at
// which a tile of feature rows streams in.  Kernel D's ``dma_only``,
// ``dot_only`` and ``stats_raw`` stages (kernel_ablate.cu) are the same sums.
//
// What bounds it on the H100: it reads N * F * 4 bytes once and adds each
// value once (N * F adds), so it is bound by memory: 2.68 GB at 1M x 640,
// 0.80 ms at 3.35 TB/s; 2.35 GB, 0.70 ms at 1M x 561.
//
// The walk.  x is read as 16-byte values whatever F is.  Four rows are 4F
// floats, so F float4 "slots", and slot q of every group of four rows holds
// the same four columns (the flat positions 4q .. 4q + 3 of the group: row
// (4q + e) / F, column (4q + e) % F).  The G = N / 4 whole groups are cut
// into B runs, run b the groups [b G / B, (b + 1) G / B), one run a block
// of a persistent grid (B from the card's SM count: column_blocks).  A run
// is one contiguous stretch of x, 16 F bytes a group, 16-byte aligned at
// any F, and its block reads every slot of it: no 4-row group is split
// between blocks, so each DRAM page is opened once.  Consumer thread t adds
// the slots t + 256 j (j < 4) of its run's groups, in group order, into one
// float4 a slot; slots from 1024 on are another block's (grid.y).  The last
// block then adds the part-group of the N % 4 last rows.  Each block writes
// its 4F sums as four partial rows of F, and reduce_rows_kernel sums the 4B
// partial rows in a fixed order, so two runs give the same bits without
// float atomics (tests/torch_column_walk.py models the walk in numpy).
//
// The copies.  One producer thread brings each step's groups (as many as
// fit 32 KB) into a ring of six shared-memory stages by one-dimensional
// bulk copies (cp.async.bulk: one copy a step where the block takes whole
// groups, one a group otherwise), each stage's full mbarrier counting the
// bytes in; the consumer warps read their slots from shared memory
// (consecutive threads, consecutive 16 bytes: no bank conflicts) and free
// the stage.  So 192 KB are in flight on each SM, one block an SM.  (On
// an H100 at 1M rows the same walk by plain float4 loads, four groups in
// flight a thread and two blocks an SM, took 2-6% longer.)
#include "exact_product.cuh"  // allow_smem, kMaxDevices

#include <algorithm>

namespace dpmm {
namespace {

constexpr int kSumWarps = 8;                   // consumer warps
constexpr int kSumThreads = 32 * kSumWarps;    // consumer threads
constexpr int kSlotsPerThread = 4;
constexpr int kChunkSlots = kSumThreads * kSlotsPerThread;  // grid.y chunk
constexpr int kSumStages = 6;
constexpr int kStageBytes = 32 * 1024;
constexpr int kStageSlots = kStageBytes / 16;  // float4 a stage
constexpr int kSumSmem = kSumStages * kStageBytes + 2 * kSumStages * 8;
constexpr int kMinRunGroups = 16;  // a run's least length where N allows it
constexpr int kSumBlocksPerSm = 1;

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
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void add4(float4& s, const float4 v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// A block's place in the walk: its run of groups [g0, g1) and its chunk of
// w slots from q0 on.
struct Run {
  long long groups, g0, g1;
  int q0, w;
  __device__ Run(int n, int f, int blocks) {
    groups = n / 4;
    g0 = groups * blockIdx.x / blocks;
    g1 = groups * (blockIdx.x + 1) / blocks;
    q0 = blockIdx.y * kChunkSlots;
    w = min(kChunkSlots, f - q0);
  }
};

// The last block adds the part-group of the N % 4 last rows, then every
// block stores its slots' sums into its four partial rows.
__device__ __forceinline__ void finish(const Run& run, const float* x, int n,
                                       int f, int blocks,
                                       float4 (&acc)[kSlotsPerThread],
                                       float* __restrict__ partial) {
  const int tail = (n % 4) * f;  // the part-group's floats
  const float* rest = x + static_cast<size_t>(run.groups) * 4 * f;
  float4* out =
      reinterpret_cast<float4*>(partial + static_cast<size_t>(blockIdx.x) *
                                              4 * f);
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) {
    const int j = threadIdx.x + i * kSumThreads;
    if (j >= run.w) continue;
    const int q = run.q0 + j;
    float4 s = acc[i];
    if (blockIdx.x == blocks - 1) {
      if (4 * q < tail) s.x += rest[4 * q];
      if (4 * q + 1 < tail) s.y += rest[4 * q + 1];
      if (4 * q + 2 < tail) s.z += rest[4 * q + 2];
      if (4 * q + 3 < tail) s.w += rest[4 * q + 3];
    }
    out[q] = s;
  }
}

__global__ void __launch_bounds__(kSumThreads + 32, 1)
column_partial_kernel(const float* __restrict__ x, int n, int f, int blocks,
                      float* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const uint32_t full = base + kSumStages * kStageBytes;  // a barrier a stage
  const uint32_t empty = full + 8 * kSumStages;
  const Run run(n, f, blocks);
  const int per = kStageSlots / run.w;  // groups a step: >= 2
  const long long steps = (run.g1 - run.g0 + per - 1) / per;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSumStages; ++s) {
      mbar_init(full + 8 * s, 1);  // the producer's expect-tx arrival
      mbar_init(empty + 8 * s, kSumWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  if (threadIdx.x >= kSumThreads) {  // the producer warp: one thread copies
    if (lane != 0) return;
    for (long long s = 0; s < steps; ++s) {
      const int st = static_cast<int>(s % kSumStages);
      const long long g = run.g0 + s * per;
      const int ng = static_cast<int>(min(static_cast<long long>(per),
                                          run.g1 - g));
      const uint32_t bar = full + 8 * st;
      const uint32_t dst = base + st * kStageBytes;
      const float* src = x + static_cast<size_t>(g) * 4 * f + 4 * run.q0;
      mbar_wait(empty + 8 * st,
                static_cast<uint32_t>((s / kSumStages) & 1) ^ 1u);
      mbar_expect(bar, 16u * run.w * ng);
      if (run.w == f) {  // whole groups: one stretch of x
        bulk_copy(dst, src, 16u * f * ng, bar);
      } else {
        for (int j = 0; j < ng; ++j)
          bulk_copy(dst + 16u * run.w * j, src + static_cast<size_t>(j) * 4 * f,
                    16u * run.w, bar);
      }
    }
    return;
  }
  float4 acc[kSlotsPerThread];
#pragma unroll
  for (int i = 0; i < kSlotsPerThread; ++i) acc[i] = make_float4(0, 0, 0, 0);
  for (long long s = 0; s < steps; ++s) {
    const int st = static_cast<int>(s % kSumStages);
    const int ng = static_cast<int>(
        min(static_cast<long long>(per), run.g1 - run.g0 - s * per));
    mbar_wait(full + 8 * st, static_cast<uint32_t>((s / kSumStages) & 1));
    const float4* stage =
        reinterpret_cast<const float4*>(smem + st * kStageBytes) +
        threadIdx.x;
#pragma unroll 2
    for (int j = 0; j < ng; ++j, stage += run.w) {
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i)
        if (threadIdx.x + i * kSumThreads < run.w)
          add4(acc[i], stage[i * kSumThreads]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }
  finish(run, x, n, f, blocks, acc, partial);
}

constexpr int kRedCols = 32;  // columns per reduction block
constexpr int kRedWays = 32;  // partial rows summed side by side

__global__ void __launch_bounds__(kRedCols * kRedWays)
reduce_rows_kernel(const float* __restrict__ partial, int rows, int m,
                   float* __restrict__ out, int out_rows, int ld_out) {
  __shared__ float part[kRedWays][kRedCols];
  const int col = blockIdx.x * kRedCols + threadIdx.x;
  const int way = threadIdx.y;
  float s = 0.0f;
  if (col < m) {
#pragma unroll 4
    for (int r = way; r < rows; r += kRedWays)
      s += partial[static_cast<size_t>(r) * m + col];
  }
  part[way][threadIdx.x] = s;
  __syncthreads();
  if (way != 0 || col >= m) return;
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kRedWays; ++w) t += part[w][threadIdx.x];
  for (int r = 0; r < out_rows; ++r) out[static_cast<size_t>(r) * ld_out + col] = t;
}

}  // namespace

// The walk's B: kSumBlocksPerSm blocks an SM of the current card, fewer
// where runs of kMinRunGroups groups would not fill them, at least one.
int column_blocks(int n) {
  static int sms[kMaxDevices] = {};
  int device = 0, count = 1;
  if (cudaGetDevice(&device) == cudaSuccess && device < kMaxDevices) {
    if (sms[device] == 0 &&
        cudaDeviceGetAttribute(&sms[device], cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess)
      sms[device] = 1;
    count = std::max(sms[device], 1);
  }
  const long long runs =
      (static_cast<long long>(n / 4) + kMinRunGroups - 1) / kMinRunGroups;
  return static_cast<int>(std::max(
      1LL, std::min(runs, static_cast<long long>(count) * kSumBlocksPerSm)));
}

int column_partials(int n) { return 4 * column_blocks(n); }

cudaError_t launch_reduce_rows(const float* partial, int rows, int m,
                               float* out, int out_rows, int ld_out,
                               cudaStream_t st) {
  const dim3 block(kRedCols, kRedWays);
  reduce_rows_kernel<<<(m + kRedCols - 1) / kRedCols, block, 0, st>>>(
      partial, rows, m, out, out_rows, ld_out);
  return cudaGetLastError();
}

cudaError_t launch_column_sum(const float* x, int n, int f, float* partial,
                              float* out, int out_rows, cudaStream_t st) {
  if (reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return cudaErrorMisalignedAddress;
  if (f == 0 || out_rows == 0) return cudaSuccess;  // nothing to write
  const int blocks = column_blocks(n);
  const dim3 grid(blocks, (f + kChunkSlots - 1) / kChunkSlots);
  const cudaError_t smem = allow_smem<column_partial_kernel>(kSumSmem);
  if (smem != cudaSuccess) return smem;
  column_partial_kernel<<<grid, kSumThreads + 32, kSumSmem, st>>>(
      x, n, f, blocks, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce_rows(partial, 4 * blocks, f, out, out_rows, f, st);
}

}  // namespace dpmm

// out [out_rows, f] = the column sums of x [n, f] (16-byte aligned), in
// every row; partial is [dpmm_column_partials(n), f] scratch.
extern "C" int dpmm_column_sum(const float* x, int n, int f, float* partial,
                               float* out, int out_rows, void* stream) {
  return static_cast<int>(dpmm::launch_column_sum(
      x, n, f, partial, out, out_rows, static_cast<cudaStream_t>(stream)));
}

extern "C" int dpmm_column_partials(int n) { return dpmm::column_partials(n); }
