// Kernel A's narrow tensor-core passes (a pass width of 128 or less: K <=
// 64) with phi resident in shared memory: persistent blocks stream the
// points, 64-point tile after tile, past a phi that each block copies once.
// fused_assign_tc.cuh's launcher hands a narrow pass here wherever F is at
// most two 64-feature slices and the whole of the launch's staged phi fits
// in one SM beside this kernel's row tiles and ring (resident_bufs);
// elsewhere its own 64-point blocks run as before.
//
// Replaces the ll product of dpmmsubclusters_tpu/ops/pallas_sweep.py:518
// fused_assign (kernel body _kernel) at the narrow widths, under the same
// precisions as fused_assign_tc.cuh's kernel (one plane: one bf16 pass; two
// planes: the three-pass split of "high" and of "default" on float32
// rows).  Everything after the product (the Gumbel argmax, the sub-label,
// the hash, the NaN and tie rules) is fused_assign.cu's, bit for bit.
//
// What bounds it on the H100: the rows' bytes at 3.35 TB/s where they are
// read once (the 20M x 100-d counts: 8.18 GB, 2.44 ms), or 2 * F_pad * N
// flop a point and plane product at the tensor cores' 989 TFLOP/s (the
// same counts at N = 128, three products: 2.0 ms).  Neither is near: what
// sets the pace of both designs is the instructions a tile costs (the rows
// built and rounded, the Gumbel draws of the fold, the labels' draws) and
// the latency between them.  fused_assign_tc.cuh's 64-point blocks keep
// two blocks an SM, but each block's life is serial (rows loaded with at
// most one step in flight, multiplied, folded, written, then the block
// exits and the next copies phi again from L2: 64 KB for 25.6 KB of
// counts).
//
// Design, one block of 17 warps an SM, persistent:
//  * the block walks the 64-point tiles t = blockIdx.x + i * gridDim.x;
//  * phi is staged once a launch by stage_phi_kernel into ``phi_t``
//    (fused_assign_tc.cuh: bf16 tiles in the swizzled layout of a stage,
//    the column halves as there) and copied once into shared memory by the
//    producer, one bulk copy a step, on one mbarrier: no step copies phi
//    again;
//  * the producer warp (the last) streams each tile's source rows into a
//    ring of 3-8 buffers (as many as fit) with a full and an empty mbarrier
//    each: a tile's rows are contiguous in device memory (64 x 4D bytes of
//    raw points, 64 x 4F of an f32 cache, 64 x 2 ld of a bf16 cache), so
//    one bulk copy takes it; the last tile (ragged, or where the rows do
//    not start on 16 bytes) is copied by the warp's loads, zeros past N;
//  * two consumer pipelines of two warpgroups each take every other tile
//    of the walk (i % 2), so that one pipeline's rows, fold and labels
//    overlap the other's products, as two blocks an SM would, sharing one
//    phi.  In a pipeline, warpgroup c multiplies the 64 x F_pad rows by its
//    N / 2 columns as fused_assign_tc.cuh's does (m64n(N/2)k16, the same
//    wgmma sequence a 16 features: hi x phi_lo, lo x phi_hi, hi x hi), so
//    every sum is the earlier kernel's, bit for bit.  Each step (a tile's
//    64-feature slice) has its rows built from the buffer (X[a] * X[b] by
//    __fmul_rn with X = [1, x], or the cache's value; features past F
//    zeros), rounded to bf16 hi and lo planes into one of the pipeline's
//    two row tiles and fenced for wgmma's proxy; one named barrier of the
//    pipeline's 256 threads a step hands a row tile over, and while the
//    tensor cores multiply step g the pipeline builds step g + 1;
//  * at a tile's last step each thread folds its columns into the Gumbel
//    argmax (fused_assign_tc.cuh's fold, with fused_assign_tc_ring.cuh's
//    bound over the quad and a pair of columns' noises drawn only where a
//    lane of the warp can use one: the same winner); warpgroup 1 leaves its
//    rows' bests in one of two exchange slots, and warpgroup 0 merges them
//    and writes the labels and sub-labels after the next step's barrier,
//    while that step's products run.
#pragma once

#include "fused_assign_tc.cuh"

#include <algorithm>
#include <initializer_list>

namespace dpmm {
namespace resident {
namespace {

// two pipelines of two warpgroups (one a column half), each taking every
// other tile of the block's walk, and the producer warp
constexpr int kPipeThreads = 256;
constexpr int kConsumerThreads = kResidentPipes * kPipeThreads;
constexpr int kThreads = kConsumerThreads + 32;
constexpr int kPipeWarps = kPipeThreads / 32;  // release a tile's buffer

// Shared addresses of the parts of a block's shared memory (module note),
// from the shape alone, so that the launcher and the kernel agree.
template <int N, int Planes>
struct Layout {
  static constexpr int kPhiPlane = N * kTcDepth * 2;  // bytes
  int slices, tile_bytes, bufs;
  __host__ __device__ Layout(int f_pad, int pitch, int nbufs)
      : slices(f_pad / kTcDepth),
        tile_bytes(resident_tile_bytes(pitch)),
        bufs(nbufs) {}
  // phi's steps from 0 on, then each pipeline's two row tiles, the ring's
  // buffers, the exchange slots and the barriers
  __host__ __device__ int phi_bytes() const {
    return slices * Planes * kPhiPlane;
  }
  __host__ __device__ int row_tile(int pipe, int which) const {
    return phi_bytes() + (2 * pipe + which) * Planes * kTcRowTile;
  }
  __host__ __device__ int buf(int b) const {
    return row_tile(kResidentPipes, 0) + b * tile_bytes;
  }
  __host__ __device__ int exch_at() const { return buf(bufs); }
  __host__ __device__ int bars_at() const {
    return exch_at() + kResidentExchBytes;
  }
  // with the room to align the first tile
  __host__ __device__ int bytes() const {
    return bars_at() + kResidentBarBytes + 1024;
  }
};

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}
// The 256 threads of a pipeline alone.
__device__ __forceinline__ void pipe_sync(int pipe) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + pipe), "n"(kPipeThreads)
               : "memory");
}

// The producer warp: phi once, then each of the block's tiles into the
// ring.  A full tile whose rows start on 16 bytes is one bulk copy by lane
// 0, counted on the buffer's full barrier; the last tile is the warp's
// 2-byte loads of the ``width`` values of each row below n (zeros past n),
// then one arrival.
template <int N, int Planes>
__device__ __forceinline__ void produce(const TileRows& rows,
                                        const __nv_bfloat16* phi_t,
                                        const Layout<N, Planes>& lay,
                                        uint32_t base, unsigned char* smem,
                                        int n, int ntiles, int bulk) {
  const int lane = threadIdx.x & 31;
  const uint32_t bars = base + lay.bars_at();
  const int step_bytes = Planes * Layout<N, Planes>::kPhiPlane;
  if (lane == 0) {
    mbar_expect(bars, lay.phi_bytes());
    for (int s = 0; s < lay.slices; ++s)
      bulk_copy(base + s * step_bytes,
                reinterpret_cast<const unsigned char*>(phi_t) +
                    static_cast<size_t>(s) * step_bytes,
                step_bytes, bars);
  }
  const int tile_src = kTcPoints * rows.pitch;
  const int units = rows.width * rows.elem / 2;  // 2-byte units a row
  for (int i = 0; i < ntiles; ++i) {
    const int row0 = (blockIdx.x + i * gridDim.x) * kTcPoints;
    const int b = i % lay.bufs;
    const uint32_t full = bars + 8 + 8 * b;
    const uint32_t empty = bars + 8 + 8 * (kResidentMaxBufs + b);
    mbar_wait(empty, ((i / lay.bufs) & 1) ^ 1);
    const uint32_t dst = base + lay.buf(b);
    if (bulk && row0 + kTcPoints < n) {
      if (lane == 0) {
        mbar_expect(full, tile_src);
        bulk_copy(dst, rows.src + static_cast<size_t>(row0) * rows.pitch,
                  tile_src, full);
      }
    } else {
      unsigned char* buf = smem + (dst - base);
      for (int r = 0; r < kTcPoints; ++r) {
        const uint16_t* src = reinterpret_cast<const uint16_t*>(
            rows.src + static_cast<size_t>(row0 + r) * rows.pitch);
        uint16_t* out = reinterpret_cast<uint16_t*>(buf + r * rows.pitch);
        for (int u = lane; u < units; u += 32)
          out[u] = row0 + r < n ? __ldg(src + u) : uint16_t{0};
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(full);
    }
  }
}

// One 64-point tile's slice ``ks`` of rows, built from the tile's buffer as
// fused_assign_tc.cuh's load_rows builds them (this thread: features
// 64 ks + lane and + 32 of the warp's 8 rows).
__device__ __forceinline__ void load_rows(const TileRows& rows,
                                          const unsigned char* buf, int ks,
                                          int f, int warp, int lane,
                                          float (&out)[kTcHeld]) {
  const int fc = ks * kTcDepth + lane;
  const unsigned char* at = buf + warp * kTcWarpRows * rows.pitch;
  if (rows.kind == kTileBuilt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in_f = fc + 32 * h < f;
      const int32_t ab = in_f ? __ldg(rows.pairs + fc + 32 * h) : 0;
      const int a = ab >> 16, b = ab & 0xffff;
      const unsigned char* xr = at;
#pragma unroll
      for (int i = 0; i < kTcWarpRows; ++i, xr += rows.pitch) {
        const float* x = reinterpret_cast<const float*>(xr) - 1;  // X[a]
        out[2 * i + h] =
            in_f ? __fmul_rn(a ? x[a] : 1.0f, b ? x[b] : 1.0f) : 0.0f;
      }
    }
  } else if (rows.kind == kTileF32) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = fc + 32 * h;
      const unsigned char* xr = at;
#pragma unroll
      for (int i = 0; i < kTcWarpRows; ++i, xr += rows.pitch)
        out[2 * i + h] =
            c < f ? reinterpret_cast<const float*>(xr)[c] : 0.0f;
    }
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = fc + 32 * h;
      const unsigned char* xr = at;
#pragma unroll
      for (int i = 0; i < kTcWarpRows; ++i, xr += rows.pitch)
        out[2 * i + h] =
            c < f ? __bfloat162float(
                        reinterpret_cast<const __nv_bfloat16*>(xr)[c])
                  : 0.0f;
    }
  }
}

// The pair (feature lane, feature lane + 32) of each of the warp's rows,
// rounded (and the rounded rest into the second plane), as one 32-bit store
// a plane at tile places 2 lane and 2 lane + 1 (fused_assign_tc.cuh's
// store_rows).
template <int Planes>
__device__ __forceinline__ void store_rows(unsigned char* a, int warp,
                                           int lane,
                                           const float (&in)[kTcHeld]) {
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
}

// A row's label and sub-label from its best (fused_assign_tc.cuh's last
// step).
__device__ __forceinline__ void write_label(const Best& best, int row,
                                            uint32_t seed, int tile_off,
                                            int tile,
                                            int32_t* __restrict__ labels,
                                            int32_t* __restrict__ sub) {
  const uint32_t salt =
      tile_seed(seed, static_cast<uint32_t>(tile_off) +
                          static_cast<uint32_t>(row / tile)) ^
      0xA5A5A5A5u;
  const uint32_t rit = static_cast<uint32_t>(row % tile);
  const float g_l = gumbel(salt, rit * 2u);
  const float g_r = gumbel(salt, rit * 2u + 1u);
  labels[row] = best.j;
  sub[row] = (best.d + (g_r - g_l) + 1e-30f > 0.0f) ? 1 : 0;
}

template <int N, int Planes>
__global__ void __launch_bounds__(kThreads, 1)
assign_resident_kernel(TileRows rows, const __nv_bfloat16* __restrict__ phi_t,
                       const float* __restrict__ log_w,
                       const int32_t* __restrict__ seed_ptr, int tile_off,
                       int hard, int tile, int n, int f, int f_pad, int k,
                       int bufs, int bulk, int32_t* __restrict__ labels,
                       int32_t* __restrict__ sub) {
  using Lay = Layout<N, Planes>;
  constexpr int kPhiPlane = Lay::kPhiPlane;
  constexpr int kQuarter = N / 4;  // whole columns a warpgroup
  extern __shared__ unsigned char smem_raw[];
  // tiles start at multiples of 1024 bytes
  const uint32_t raw =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const Lay lay(f_pad, rows.pitch, bufs);
  const uint32_t bars = base + lay.bars_at();
  const int tiles = (n + kTcPoints - 1) / kTcPoints;
  const int ntiles = (tiles - static_cast<int>(blockIdx.x) +
                      static_cast<int>(gridDim.x) - 1) /
                     static_cast<int>(gridDim.x);

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bars, 1);  // phi's copies
    for (int b = 0; b < bufs; ++b) {
      mbar_init(bars + 8 + 8 * b, 1);  // the tile's copy, or the warp's loads
      mbar_init(bars + 8 + 8 * (kResidentMaxBufs + b), kPipeWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid >= kConsumerThreads) {
    produce<N, Planes>(rows, phi_t, lay, base, smem, n, ntiles, bulk);
    return;
  }

  const int lane = tid & 31;
  const int pipe = tid / kPipeThreads;  // tiles 2 j + pipe of the walk
  const int warp = (tid % kPipeThreads) >> 5;  // in the pipeline
  const int col_half = warp >> 2;  // which N / 2 columns
  const int slices = lay.slices;
  const int ptiles = (ntiles - pipe + kResidentPipes - 1) / kResidentPipes;
  const int steps = ptiles * slices;
  const uint32_t seed = static_cast<uint32_t>(seed_ptr[0]);
  Best* exch = reinterpret_cast<Best*>(smem + lay.exch_at()) +
               pipe * 2 * kTcPoints;
  // the first point of the pipeline's j-th tile
  auto tile_row0 = [&](int j) {
    return (blockIdx.x + (kResidentPipes * j + pipe) * gridDim.x) *
           kTcPoints;
  };

  // step g (slice g % slices of the pipeline's tile g / slices) into its
  // row tile g % 2; the tile's buffer is waited for at its first slice and
  // released after its last
  auto build = [&](int g) {
    const int i = kResidentPipes * (g / slices) + pipe;  // in the walk
    const int s = g % slices, b = i % bufs;
    if (s == 0) mbar_wait(bars + 8 + 8 * b, (i / bufs) & 1);
    float held[kTcHeld];
    load_rows(rows, smem + lay.buf(b), s, f, warp, lane, held);
    store_rows<Planes>(smem + lay.row_tile(pipe, g & 1), warp, lane, held);
    if (s == slices - 1) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 + 8 * (kResidentMaxBufs + b));
    }
    fence_async_proxy();
  };

  mbar_wait(bars, 0);  // phi is resident
  if (steps > 0) build(0);
  float acc[N / 4];
#pragma unroll
  for (int j = 0; j < N / 4; ++j) acc[j] = 0.0f;
  // this thread's two rows of a tile: row 16 (warp % 4) + lane / 4
  // (first_row) and the row 8 below; warpgroup 0 keeps the bests of the
  // tile before (pend) until warpgroup 1's are in the exchange
  const int quad_row = (warp & 3) * 16 + (lane >> 2);
  Best pend[2];
  for (int g = 0; g < steps; ++g) {
    const int i = g / slices, s = g % slices;  // the pipeline's tile
    pipe_sync(pipe);  // step g's rows are in place; step g - 1 multiplied
    const uint64_t da = wgmma_desc(base + lay.row_tile(pipe, g & 1));
    const uint64_t db = wgmma_desc(base + s * Planes * kPhiPlane +
                                   col_half * (kPhiPlane / 2));
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
    // while it runs: the labels of the tile before, and step g + 1's rows
    if (s == 0 && i > 0 && col_half == 0 && (lane & 3) == 0) {
      const int prev0 = tile_row0(i - 1);
      const Best* other = exch + ((i - 1) & 1) * kTcPoints;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = prev0 + quad_row + 8 * h;
        if (row >= n) continue;
        const Best o = other[quad_row + 8 * h];
        if (better(o.v, o.j, pend[h].v, pend[h].j)) pend[h] = o;
        write_label(pend[h], row, seed, tile_off, tile, labels, sub);
      }
    }
    if (g + 1 < steps) build(g + 1);
    wgmma_wait<0>();
    if (s < slices - 1) continue;

    // The tile's whole columns folded into a Gumbel argmax, as
    // fused_assign_tc.cuh folds a pass, with fewer noises drawn (as
    // fused_assign_tc_ring.cuh's fold_pass).  The noise lies in [-3.32,
    // 16.64] (u in [1e-12, 1 - 2^-24]), so a column whose logit is 24 below
    // the largest of the row over the quad's columns cannot win: its noise
    // is not drawn.  Without noise (hard) only a largest logit can win.
    // Where the largest logit is infinite or above 1e6 (24 nears float32's
    // spacing there) every column can.  A pair of columns' noises is drawn
    // only where a lane of the warp has a finite logit that can win.  The
    // winner and its noisy logit are the same as with every noise drawn.
    const int row0 = tile_row0(i);
    const int col0 = col_half * kQuarter + 2 * (lane & 3);
    Best best[2];
    best[0] = best[1] = {-INFINITY, 0x7fffffff, 0.0f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + quad_row + 8 * h;
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
      top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 1));
      top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, 2));
      const float least = hard                 ? top
                          : fabsf(top) < 1e6f ? top - 24.0f
                                              : -INFINITY;
#pragma unroll
      for (int j = 0; j < N / 32; ++j) {
        bool draw = false;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l = acc[4 * j + 2 * h + e];
          draw |= col0 + 8 * j + e < k && l >= least && l != -INFINITY;
        }
        float noise[2] = {0.0f, 0.0f};
        if (!hard && __any_sync(0xffffffffu, draw)) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            noise[e] = gumbel(row_seed, rit * static_cast<uint32_t>(k) +
                                            static_cast<uint32_t>(
                                                col0 + 8 * j + e));
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = col0 + 8 * j + e;
          const float l = acc[4 * j + 2 * h + e];
          if (col < k && l >= least) {
            // the noise is finite: zeroing it (hard) is not adding it, and
            // added to -inf it changes nothing
            const float v = (hard || l == -INFINITY) ? l : l + noise[e];
            if (better(v, col, best[h].v, best[h].j))
              best[h] = {v, col, acc[4 * j + 2 * h + e + N / 8]};
          }
        }
      }
    }
    // a row's best over its quad; warpgroup 1's to the exchange
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const Best o = {__shfl_xor_sync(0xffffffffu, best[h].v, off),
                        __shfl_xor_sync(0xffffffffu, best[h].j, off),
                        __shfl_xor_sync(0xffffffffu, best[h].d, off)};
        if (better(o.v, o.j, best[h].v, best[h].j)) best[h] = o;
      }
      if (col_half == 1 && (lane & 3) == 0)
        exch[(i & 1) * kTcPoints + quad_row + 8 * h] = best[h];
      pend[h] = best[h];
    }
#pragma unroll
    for (int j = 0; j < N / 4; ++j) acc[j] = 0.0f;
  }
  // the last tile's labels, once warpgroup 1's bests are in
  pipe_sync(pipe);
  if (steps > 0 && col_half == 0 && (lane & 3) == 0) {
    const int i = ptiles - 1;
    const int prev0 = tile_row0(i);
    const Best* other = exch + (i & 1) * kTcPoints;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = prev0 + quad_row + 8 * h;
      if (row >= n) continue;
      const Best o = other[quad_row + 8 * h];
      if (better(o.v, o.j, pend[h].v, pend[h].j)) pend[h] = o;
      write_label(pend[h], row, seed, tile_off, tile, labels, sub);
    }
  }
}

// The card's SMs, once every resident kernel of ``Planes`` may take all an
// SM gives a block in shared memory; both are settled once a device (the
// calls wait for the card, and the sweep's host must run ahead of it).  The
// state lives here, in this file's own namespace, so that each library
// built from these sources keeps its own.
template <int Planes>
cudaError_t card_sms(int& out) {
  static int sms[kTcMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kTcMaxDevices) return cudaErrorInvalidDevice;
  if (!sms[device]) {
    for (const void* kernel : {
             reinterpret_cast<const void*>(assign_resident_kernel<32, Planes>),
             reinterpret_cast<const void*>(assign_resident_kernel<64, Planes>),
             reinterpret_cast<const void*>(
                 assign_resident_kernel<128, Planes>)}) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kResidentSmemMax);
      if (err != cudaSuccess) return err;
    }
    err = cudaDeviceGetAttribute(&sms[device],
                                 cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  out = sms[device];
  return cudaSuccess;
}

}  // namespace

template <int Planes>
cudaError_t launch(TileRows rows, const __nv_bfloat16* phi_t,
                   const float* log_w, const int32_t* seed, int tile_off,
                   int hard, int tile, int n, int f, int k, int bufs,
                   int32_t* labels, int32_t* sub, cudaStream_t st) {
  const int tiles = (n + kTcPoints - 1) / kTcPoints;
  if (tiles == 0) return cudaSuccess;
  int sms = 0;
  const cudaError_t err = card_sms<Planes>(sms);
  if (err != cudaSuccess) return err;
  const int grid = std::min(tiles, sms);
  const int f_pad = tc_padded(f);
  // the bulk copies need the rows to start on 16 bytes
  const int bulk = reinterpret_cast<uintptr_t>(rows.src) % 16 == 0;
#define DPMM_RESIDENT(N)                                                     \
  assign_resident_kernel<N, Planes><<<grid, kThreads,                       \
                                      Layout<N, Planes>(f_pad, rows.pitch,  \
                                                        bufs).bytes(),      \
                                      st>>>(rows, phi_t, log_w, seed,       \
                                            tile_off, hard, tile, n, f,     \
                                            f_pad, k, bufs, bulk, labels,   \
                                            sub)
  const int width = tc_width(k);
  if (width == 32)
    DPMM_RESIDENT(32);
  else if (width == 64)
    DPMM_RESIDENT(64);
  else if (width == 128)
    DPMM_RESIDENT(128);
  else
    return cudaErrorInvalidValue;
#undef DPMM_RESIDENT
  return cudaGetLastError();
}

}  // namespace resident
}  // namespace dpmm
