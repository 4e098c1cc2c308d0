// Kernel A's assign pass on the tensor cores for one bf16 pass over a bf16
// cache ("bfloat16" and "hybrid" under ll_precision "bf16", and so
// "default") at a pass width of 256 (K > 64).  fused_assign_tc.cuh's
// launcher hands those shapes here; the narrower passes, and one bf16 pass
// over float32 rows (which must be rounded), keep its kernel.
//
// Replaces the ll product of dpmmsubclusters_tpu/ops/pallas_sweep.py:518
// fused_assign (kernel body _kernel :264) on its bf16-cache branch
// (:236-243, :311-320): the cache's values and phi rounded to bf16 (to
// nearest even), the exact products summed in float32.  Everything after
// the product (the Gumbel argmax, the sub-label, the hash, the NaN and tie
// rules) is fused_assign.cu's, bit for bit; fused_assign.cu launches the
// statistics pass after it.  fused_assign_tc.cu builds it.
//
// What bounds it on the H100: the cache's read, 2F bytes a point at 3.35
// TB/s, against 2 * F * 2K flop a point (whole and delta columns) at the
// tensor cores' 989 TFLOP/s: 256 flop a byte at K = 128, under the card's
// 295, so the read bounds the pass; 512 at K = 256, over it.  Behind those
// sit what the earlier kernels spent beside the products: every row value
// loaded into a register, rounded (a no-op here) and stored swizzled into
// the tile; every 64-point tile streaming the whole of phi from L2; and the
// Gumbel fold, which draws a noise for every column within 24 of a row's
// top.
//
// Design, one cluster of two blocks on two SMs, each block persistent, as
// fused_assign_tc_ring.cuh walks its tiles:
//  * the cache is a tensor map (TMA) of [N, F] bf16 values, rows ld values
//    apart (ld a multiple of 8: the map's row pitch must be a multiple of 16
//    bytes, and the port builds its caches so); a stage's rows are one copy
//    of a 64-feature x 128-point box, in the 128-byte swizzle that wgmma
//    reads: a bf16 value is already the product's operand, so no thread
//    touches a row.  The map's bounds give zeros past F and past N (a
//    ragged last tile, and the empty tile that the partner of a last, odd
//    tile walks), so features past F multiply phi's zero padding;
//  * phi is staged once a launch by ring::stage_phi_kernel into ``phi_t``
//    (bf16, cut into the ring's tiles as they lie in shared memory, natural
//    feature order, zero-padded to whole slices and passes: a pass holds 128
//    whole columns and then their 128 delta columns).  Each block's
//    producer copies half of a step's phi tile into the same place of both
//    blocks (cp.async.bulk ... .multicast::cluster), so one read of phi from
//    L2 feeds 256 points;
//  * one producer thread (of a third warpgroup, setmaxnreg 40) waits for a
//    stage of the ring (4 stages of 48 KB, a full and an empty mbarrier
//    each) to be empty, announces its 48 KB on the full barrier and starts
//    the rows' copy and its half of phi's.  A stage is empty when all eight
//    consumer warps of both blocks have released it (an arrive on the
//    issuing block's barrier, remote for the partner);
//  * two consumer warpgroups (setmaxnreg 232) each own 64 of a tile's rows
//    over all 256 columns of a pass (m64n256k16, 128 sums a thread), keep one
//    wgmma group in flight, release the stage of the step before, and fold
//    a pass into the running Gumbel argmax at its end; a row's columns sit
//    in the four lanes of a quad of one warp, so the argmax needs no
//    exchange between warpgroups;
//  * the ring runs on across passes and tiles (K > 128 re-reads the rows a
//    pass): a tile's step s is slice s % slices of pass s / slices, over the
//    passes up to the highest live column only (ring::live_passes, as the
//    ring walks them);
//  * the fold is the ring's (ring::fold_pass, ring::write_labels): the
//    noise is drawn only for columns that can win; the noise of column j
//    depends only on j and the row's global index, and a column wins only
//    by jnp.argmax's rule (larger value, then smaller column), so neither
//    the order of folding nor the tile a block takes matters.
#pragma once

#include "fused_assign_tc_ring.cuh"

#include <cuda.h>

namespace dpmm {
namespace tma {
namespace {

constexpr int kPoints = 128;             // a tile: 64 rows a consumer warpgroup
constexpr int kConsumerThreads = 256;    // two warpgroups
constexpr int kThreads = kConsumerThreads + 128;  // and the producer's
constexpr int kCluster = 2;              // blocks that share a phi tile
// warps that release a stage: every consumer warp of the cluster
constexpr int kReleases = kCluster * kConsumerThreads / 32;
constexpr int kDepth = 64;               // features a slice: 128-byte rows
constexpr int kWidth = 256;              // columns a pass: 128 whole + delta
constexpr int kRowTile = kPoints * kDepth * 2;    // bytes: 16 KB
constexpr int kPhiTile = kWidth * kDepth * 2;     // bytes: 32 KB
constexpr int kPhiHalf = kPhiTile / kCluster;     // a block's copy of it
constexpr int kStageBytes = kRowTile + kPhiTile;
constexpr int kStages = 4;
// the stages, their barriers, and room to align the first tile
constexpr int kSmemBytes = kStages * kStageBytes + 8 * 2 * kStages + 1024;
// registers a thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 = 168 x 384,
// the launch's own (a consumer holds 128 sums; the producer starts copies)
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
constexpr int kMaxDevices = 64;  // cards of one host the launcher tracks

// What the producer and the consumers share: the ring and the walk over
// tiles.
struct Walk {
  uint32_t base;    // shared address of stage 0
  uint32_t bars;    // shared address of the barriers
  int rank;         // this block's in the cluster
  int cluster;      // the cluster's index, and their count
  int clusters;
  int pairs;        // pairs of 128-point tiles
  int slices;       // 64-feature slices of a pass
  int steps;        // a tile's: passes run x slices
  int total;        // this block's: its tile pairs x steps
  // stage s is full (rows and phi arrived) and empty (released by every
  // consumer warp of the cluster)
  __device__ uint32_t full_bar(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty_bar(int s) const {
    return bars + 8 * (kStages + s);
  }
  // the first point of the tile of this block's step q
  __device__ int row0(int q) const {
    return (kCluster * (cluster + q / steps * clusters) + rank) * kPoints;
  }
  // the first feature of step q's slice
  __device__ int f0(int q) const { return q % steps % slices * kDepth; }
};

// The box of the tensor map ``map`` at (feature c0, point c1) into shared
// memory at ``dst`` by the copy engine, its bytes counted on ``bar``.
__device__ __forceinline__ void tma_load_rows(uint32_t dst,
                                              const CUtensorMap* map, int c0,
                                              int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// The producer thread (module note): every step's rows and its half of
// phi, into a stage once it is empty.
__device__ __forceinline__ void produce(const Walk& w, const CUtensorMap* rows,
                                        const __nv_bfloat16* phi_t) {
  int g = 0;
  for (; g < w.total; ++g) {
    const int s = g % kStages;
    const uint32_t st = w.base + s * kStageBytes;
    mbar_wait(w.empty_bar(s), ((g / kStages) & 1) ^ 1);
    mbar_expect(w.full_bar(s), kRowTile + kPhiTile);
    tma_load_rows(st, rows, w.f0(g), w.row0(g), w.full_bar(s));
    ring::bulk_copy_multicast(
        st + kRowTile + w.rank * kPhiHalf,
        reinterpret_cast<const unsigned char*>(phi_t) +
            static_cast<size_t>(g % w.steps) * kPhiTile + w.rank * kPhiHalf,
        kPhiHalf, w.full_bar(s));
  }
  // stay until every consumer of the cluster has released this block's
  // last stages: their arrivals land in this block's shared memory
  for (int i = 0; i < kStages; ++i, ++g)
    mbar_wait(w.empty_bar(g % kStages), ((g / kStages) & 1) ^ 1);
}

// A consumer warpgroup: the product of its 64 rows of each tile with every
// pass's 256 columns, folded into the Gumbel argmax, then the labels.
__device__ __forceinline__ void consume(const Walk& w,
                                        const float* __restrict__ log_w,
                                        uint32_t seed, int tile_off, int hard,
                                        int tile, int n, int k, int passes,
                                        int32_t* __restrict__ labels,
                                        int32_t* __restrict__ sub) {
  constexpr int N = kWidth;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  // a stage is released by lane 0 of each consumer warp, to both blocks
  auto release = [&](int g) {
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kCluster; ++c)
        ring::mbar_arrive_cluster(w.empty_bar(g % kStages), c);
    }
  };
  int g = 0;
  for (int p = w.cluster; p < w.pairs; p += w.clusters) {
    // this thread's two rows: row 16 warp + lane / 4 of the warpgroup's 64
    // (first_row), and the row 8 below
    const int first_row = (kCluster * p + w.rank) * kPoints + wg * 64 +
                          warp * 16 + (lane >> 2);
    Best best[2];
    best[0] = best[1] = {-INFINITY, 0x7fffffff, 0.0f};
    for (int pass = 0; pass < passes; ++pass) {
      float acc[N / 2];
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[i] = 0.0f;
      for (int t = 0; t < w.slices; ++t, ++g) {
        const int s = g % kStages;
        const uint32_t st = w.base + s * kStageBytes;
        mbar_wait(w.full_bar(s), (g / kStages) & 1);
        const uint64_t da = wgmma_desc(st + wg * (kRowTile / 2));
        const uint64_t db = wgmma_desc(st + kRowTile);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDepth / 16; ++kk)
          wgmma_bf16(acc, da + 2 * kk, db + 2 * kk);
        wgmma_commit();
        // the step before is multiplied: its stage goes back to the ring
        wgmma_wait<1>();
        if (t > 0) release(g - 1);
      }
      wgmma_wait<0>();
      release(g - 1);

      ring::fold_pass<N>(acc, best, pass, first_row, lane, log_w, seed,
                         tile_off, hard, tile, k);
    }
    ring::write_labels(best, first_row, lane, seed, tile_off, tile, n,
                       labels, sub);
  }
}

__global__ void __cluster_dims__(kCluster, 1, 1)
    __launch_bounds__(kThreads, 1)
    assign_tma_kernel(const __grid_constant__ CUtensorMap rows,
                      const __nv_bfloat16* __restrict__ phi_t,
                      const float* __restrict__ log_w,
                      const int32_t* __restrict__ seed_ptr, int tile_off,
                      int hard, int tile, int n, int slices, int k,
                      int passes, int32_t* __restrict__ labels,
                      int32_t* __restrict__ sub,
                      unsigned long long* __restrict__ tally) {
  extern __shared__ unsigned char smem_raw[];
  // tiles start at multiples of 1024 bytes (the swizzle's period), at the
  // same place in both blocks (the multicast writes there)
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  Walk w;
  w.base = (raw + 1023u) & ~1023u;
  w.bars = w.base + kStages * kStageBytes;
  w.rank = static_cast<int>(ring::cluster_rank());
  w.cluster = blockIdx.x / kCluster;
  w.clusters = gridDim.x / kCluster;
  w.pairs = ((n + kPoints - 1) / kPoints + kCluster - 1) / kCluster;
  w.slices = slices;
  // the passes up to the highest live column, of the width's ``passes``
  const int run = ring::live_passes(log_w, k, passes, kWidth / 2);
  ring::tally_passes(tally, run, passes);
  w.steps = run * slices;
  w.total = (w.pairs - w.cluster + w.clusters - 1) / w.clusters * w.steps;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(w.full_bar(s), 1);  // the producer's announcement
      mbar_init(w.empty_bar(s), kReleases);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // both blocks' barriers are ready before either block's copies or
  // releases reach them
  ring::cluster_sync();
  if (threadIdx.x >= kConsumerThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        kProducerRegs));
    if (threadIdx.x == kConsumerThreads) produce(w, &rows, phi_t);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
    consume(w, log_w, static_cast<uint32_t>(seed_ptr[0]), tile_off, hard,
            tile, n, k, run, labels, sub);
  }
}

// cuTensorMapEncodeTiled, a driver function, through the runtime (no link
// against the driver library); null where the driver lacks it.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

cudaError_t launch(Bf16Rows rows, const float* phi, __nv_bfloat16* phi_t,
                   const float* log_w, const int32_t* seed, int tile_off,
                   int hard, int tile, int n, int f, int k, int32_t* labels,
                   int32_t* sub, unsigned long long* tally, cudaStream_t st) {
  // the tensor map's rows start on a 16-byte boundary, 16-byte multiples
  // apart (the wrapper lays a cache out so)
  if ((reinterpret_cast<uintptr_t>(rows.feat) & 15) != 0 || rows.ld % 8 ||
      rows.ld < f)
    return cudaErrorMisalignedAddress;
  const int f_pad = tc_padded(f);
  const int passes = tc_passes(k);
  const int total_rows = passes * kWidth;
  const int total = total_rows * f_pad;
  ring::stage_phi_kernel<<<(total + 255) / 256, 256, 0, st>>>(
      phi, f, k, kWidth, f_pad, total_rows, 1, phi_t);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int pairs = ((n + kPoints - 1) / kPoints + kCluster - 1) / kCluster;
  if (pairs == 0) return cudaSuccess;

  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(f),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t pitch[1] = {static_cast<cuuint64_t>(rows.ld) * 2};
  const cuuint32_t box[2] = {kDepth, kPoints};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<__nv_bfloat16*>(rows.feat), dims, pitch, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;

  // the kernel's shared-memory allowance and how many of its clusters the
  // card holds at once are settled once a device, not a launch: both wait
  // for the card, and the sweep's host must run ahead of it
  static int resident[kMaxDevices] = {};
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!resident[device]) {
    err = cudaFuncSetAttribute(assign_tma_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return err;
    int sms = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(sms / kCluster * kCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = kSmemBytes;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, assign_tma_kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (clusters < 1) return cudaErrorInvalidConfiguration;
    resident[device] = clusters;
  }
  const int clusters = std::min(pairs, resident[device]);
  assign_tma_kernel<<<clusters * kCluster, kThreads, kSmemBytes, st>>>(
      map, phi_t, log_w, seed, tile_off, hard, tile, n, f_pad / kDepth, k,
      passes, labels, sub, tally);
  return cudaGetLastError();
}

}  // namespace tma
}  // namespace dpmm
