// Kernel B: per-(slot, side) sufficient statistics from given labels.
//
// Replaces dpmmsubclusters_tpu/ops/pallas_sweep.py:439 stats_from_labels
// (kernel body _stats_kernel, :388-431) in its "precomputed", "gaussian",
// "multinomial" and "bfloat16" variants, and is kernel A's statistics pass
// (fused_assign.cu) and kernel D's (kernel_ablate.cu).  The output is
// [LEFT K | RIGHT K] x F in float32, rows masked by ``valid``.  The rows come
// from a compile-time source (dpmm_kernels.cuh): the f32 feature cache
// [N, F] ("precomputed"), rows built here from the raw points x [N, D]
// ("gaussian": [1, x, triu(x x^T)], F = 1 + D + D(D+1)/2; "multinomial":
// [1, x], F = 1 + D), or the bf16 feature cache [N, F] ("bfloat16", each
// value upcast exactly and summed in f32).  A "hybrid" container's
// statistics are the "gaussian" variant on its raw points.
//
// What bounds it on the H100: on the TPU this was a one-hot MXU matmul
// ([2K, T] @ [T, F]); here it is a scatter of feature rows, N * F adds.
// From a cache it is memory-bound: N * F * 4 bytes (2.4 GB at 1M x 561,
// about 0.7 ms at 3.35 TB/s; half that from the bf16 cache).  Built from x
// it reads only the points (256 B a point at D=64 against the row's 8.6 KB)
// and the N * F products and adds bound it (about 0.13 ms at 1M x 2145 on
// the FP32 pipes, counting the multiply and the add as two instructions).
// The dense one-hot product would spend 2K times the flops.
//
// Design: three kernels a launch, all over chunks of kStatsChunk points.
// 1. Key sort.  One block a chunk sorts the chunk's points by key
//    s * K + l, stably, into ``perm`` (global point indices, the chunk's
//    own segment) and ``offsets`` [n_chunks, 2K + 1] (where each key's
//    points start; entry 2K is where the dropped points start: invalid ones
//    and labels outside [0, K) or sub-labels outside {0, 1}, kept after the
//    keys in point order, so ``perm`` is a whole permutation).  Each of 8
//    warps counts one contiguous eighth of the chunk (__match_any_sync
//    groups equal keys; the group's first lane adds its size), the counts
//    are scanned into per-warp cursors, and each warp places its points in
//    order (rank within the group by __popc).  Integers only; the [8, 2K+1]
//    table lives in shared memory up to K = 682 and in the scratch above.
// 2. Walk.  Every point's row is read once per column, and no block scans
//    keys it does not own (the cost that bound the earlier design: every
//    column block of a chunk read all its keys, 272 times each at D=64).
//    * Built Gaussian rows ("tri"): a block owns (chunk, a group of 4 x 4
//      tiles of the upper triangle of [x, 1] (x) [x, 1], a part of the
//      chunk's keys) and walks its keys' points in sorted order.  Batches
//      of 32 sorted points' [x, 1] are staged in shared memory by 16-byte
//      cp.async, several rows a warp instruction, two stages deep; each
//      thread keeps its tile's 16 running sums in registers and reads two
//      float4 a point for 16 products, so one shared-memory load feeds 8
//      products.  At a key boundary (block-uniform, from the chunk's
//      offsets, kept in shared memory) the sums go to that key's partial
//      row.  Groups and parts are chosen so the card holds some 8 warps an
//      SM: at D=64, 5 groups and 4 parts at 1M points, 1 and 1 at 10M; a
//      part owns the keys that start in its share of the sorted points.
//    * Linear rows (both caches, multinomial [1, x]): a block of 4 warps
//      owns (chunk, 128 columns) -- or, below 257 columns, (chunk, 32
//      columns) with the 4 warps splitting the chunk's keys by where they
//      start in the sorted order -- and each lane owns one column.  A warp
//      walks each of its keys' points 32 at a time: it reads their indices
//      in one load, issues the 32 row reads, then adds them in order, so 32
//      reads a lane are in flight.
//    Only keys with points in the chunk write their partial row.
// 3. Reduction.  stats = the partials of each key summed in chunk order,
//    read only where the key has points (``offsets``); an absent key would
//    add +0.0f there, which changes no bit of a sum that starts at +0.0f.
//
// The result is deterministic and equals the earlier kernel's bit for bit:
// each statistic is the chunk's valid points of its key added in ascending
// point order from +0.0f (separate __fmul_rn and add, no contraction), then
// the chunks in order.  A built value is the cache's fl(x_i * x_j), so the
// variants agree bit for bit on the same points.  Scratch: the partials,
// n_chunks x 2K x F floats, only the present keys' rows written (2.7 GB at
// 10M x 64-d and K=256, 1.1 GB of it written at 200 present keys), then
// stats_order_ints of int32 (dpmm_kernels.cuh).
#include "dpmm_kernels.cuh"

namespace dpmm {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSortThreads = kSortWarps * 32;
constexpr int kLinWarps = 4;
constexpr int kLinThreads = kLinWarps * 32;
constexpr int kLinBatch = 32;         // points a warp reads at once (a lane each)
constexpr int kTriBatch = 32;         // points a shared-memory stage holds
constexpr int kTriMaxThreads = 256;
constexpr int kStageBytes = 40 * 1024;  // both stages (the offsets beside)

// 16- and 4-byte asynchronous global -> shared copies.
__device__ __forceinline__ void copy16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}

// A point's bucket: its key s * k + l, or 2k when it adds nothing.
__device__ __forceinline__ int bucket(const int32_t* __restrict__ labels,
                                      const int32_t* __restrict__ sub,
                                      const uint8_t* __restrict__ valid, int p,
                                      int k) {
  if (!valid[p]) return 2 * k;
  const int l = labels[p];
  const int s = sub[p];
  return (static_cast<unsigned>(l) < static_cast<unsigned>(k) &&
          static_cast<unsigned>(s) < 2u)
             ? s * k + l
             : 2 * k;
}

__global__ void __launch_bounds__(kSortThreads)
stats_sort_kernel(const int32_t* __restrict__ labels,
                  const int32_t* __restrict__ sub,
                  const uint8_t* __restrict__ valid, int n, int k,
                  int32_t* __restrict__ perm, int32_t* __restrict__ offsets,
                  int32_t* __restrict__ spill) {
  extern __shared__ int32_t sort_smem[];
  __shared__ int warp_sums[kSortWarps];
  const int nb = 2 * k + 1;
  const int chunk = blockIdx.x;
  const int p0 = chunk * kStatsChunk;
  const int len = min(n - p0, kStatsChunk);
  // [warps][nb] counts, then cursors; then [nb] bucket totals, then starts
  int32_t* table =
      spill ? spill + static_cast<size_t>(chunk) * (kSortWarps + 1) * nb
            : sort_smem;
  int32_t* total = table + kSortWarps * nb;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  for (int i = tid; i < kSortWarps * nb; i += kSortThreads) table[i] = 0;
  __syncthreads();

  // warp w owns the points [s0, s1) of the chunk, in order
  const int seg = ((len + kSortWarps - 1) / kSortWarps + 31) & ~31;
  const int s0 = warp * seg;
  const int s1 = min(len, s0 + seg);
  int32_t* mine = table + warp * nb;
  // the buckets of the next 32 points are read while these are counted
  auto bucket_at = [&](int base) {
    const int i = base + lane;
    return i < s1 ? bucket(labels, sub, valid, p0 + i, k) : -1;
  };
  int b_next = bucket_at(s0);
  for (int base = s0; base < s1; base += 32) {
    const int b = b_next;
    b_next = bucket_at(base + 32);
    const unsigned peers = __match_any_sync(kFull, b);
    if (b >= 0 && (peers & below) == 0) mine[b] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // each warp's start within each bucket, and the bucket's total
  for (int b = tid; b < nb; b += kSortThreads) {
    int run = 0;
    for (int w = 0; w < kSortWarps; ++w) {
      const int c = table[w * nb + b];
      table[w * nb + b] = run;
      run += c;
    }
    total[b] = run;
  }
  __syncthreads();
  // exclusive scan of the totals: thread t owns buckets [b0, b1)
  const int per = (nb + kSortThreads - 1) / kSortThreads;
  const int b0 = min(nb, tid * per);
  const int b1 = min(nb, b0 + per);
  int sum = 0;
  for (int b = b0; b < b1; ++b) sum += total[b];
  int incl = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  int start = incl - sum;
  for (int w = 0; w < warp; ++w) start += warp_sums[w];
  int32_t* off = offsets + static_cast<size_t>(chunk) * nb;
  for (int b = b0; b < b1; ++b) {
    const int c = total[b];
    off[b] = start;
    total[b] = start;
    start += c;
  }
  __syncthreads();
  for (int i = tid; i < kSortWarps * nb; i += kSortThreads)
    table[i] += total[i % nb];
  __syncthreads();

  // place the warp's points: bucket start + earlier warps' + rank in order
  b_next = bucket_at(s0);
  for (int base = s0; base < s1; base += 32) {
    const int b = b_next;
    b_next = bucket_at(base + 32);
    const unsigned peers = __match_any_sync(kFull, b);
    if (b >= 0) perm[p0 + mine[b] + __popc(peers & below)] = p0 + base + lane;
    __syncwarp();
    if (b >= 0 && (peers & below) == 0) mine[b] += __popc(peers);
    __syncwarp();
  }
}

// A lane's value of column ``c`` of point p, read without a condition
// (every address is valid), so that the compiler issues a batch's 32 reads
// before their adds.
__device__ __forceinline__ float walk_at(const CacheRows& r, CacheRows::Col c,
                                         int p) {
  return __ldg(r.feat + static_cast<size_t>(p) * r.f + c.c);
}
__device__ __forceinline__ float walk_at(const Bf16Rows& r, Bf16Rows::Col c,
                                         int p) {
  return __bfloat162float(__ldg(r.feat + static_cast<size_t>(p) * r.f + c.c));
}
// Built rows walk as linear rows only as [1, x] (launch_walk): b = 0, so
// the value is BuiltRows::at's X[a] * 1, from one read.
__device__ __forceinline__ float walk_at(const BuiltRows& r, BuiltRows::Col c,
                                         int p) {
  const float xa = __ldg(r.x + static_cast<size_t>(p) * r.d + max(c.a - 1, 0));
  return __fmul_rn(c.a ? xa : 1.0f, 1.0f);
}

// Linear rows: lane ``lane`` of warp ``warp`` owns one column; see the note.
template <class Rows>
__global__ void __launch_bounds__(kLinThreads)
stats_partial_lin_kernel(Rows rows, const int32_t* __restrict__ perm,
                         const int32_t* __restrict__ offsets, int f, int k,
                         int col_warps, float* __restrict__ partial) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int parts = kLinWarps / col_warps;
  const int part = warp / col_warps;
  const int col = (blockIdx.y * col_warps + warp % col_warps) * 32 + lane;
  if (col - lane >= f) return;  // a warp past the row (no block syncs here)
  const bool live = col < f;
  // a dead lane reads its row's last column: no sector the warp skips
  const typename Rows::Col c = rows.col(live ? col : f - 1);
  const int nk = 2 * k;
  const int chunk = blockIdx.x;
  const int32_t* off = offsets + static_cast<size_t>(chunk) * (nk + 1);
  const int32_t* order = perm + static_cast<size_t>(chunk) * kStatsChunk;
  float* out = partial + static_cast<size_t>(chunk) * nk * f + col;
  const int kept = __ldg(off + nk);
  for (int kb = 0; kb < nk; kb += 32) {
    const int key = kb + lane;
    const int s = key < nk ? __ldg(off + key) : kept;
    const int e = key < nk ? __ldg(off + key + 1) : kept;
    // this warp's keys: those that start in its share of the sorted points
    const bool own =
        e > s &&
        static_cast<int>(static_cast<long long>(s) * parts / kept) == part;
    unsigned mask = __ballot_sync(kFull, own);
    while (mask) {
      const int j = __ffs(mask) - 1;
      mask &= mask - 1;
      const int ks = __shfl_sync(kFull, s, j);
      const int ke = __shfl_sync(kFull, e, j);
      // past the key's end a lane holds its last point, read again (cached)
      float acc = 0.0f;
      int idx = __ldg(order + min(ks + lane, ke - 1));
      for (int b = ks; b < ke; b += kLinBatch) {
        const int next = __ldg(order + min(b + kLinBatch + lane, ke - 1));
        float v[kLinBatch];
#pragma unroll
        for (int u = 0; u < kLinBatch; ++u)
          v[u] = walk_at(rows, c, __shfl_sync(kFull, idx, u));
#pragma unroll
        for (int u = 0; u < kLinBatch; ++u)
          if (b + u < ke) acc = __fadd_rn(acc, v[u]);
        idx = next;
      }
      if (live) out[static_cast<size_t>(kb + j) * f] = acc;
    }
  }
}

// The column of the built Gaussian row for the staged positions q <= r of
// [x_0 .. x_{D-1}, 1] (position D is the 1), or -1 past the row.
__device__ __forceinline__ int tri_col(int q, int r, int d) {
  if (r > d) return -1;
  if (r == d) return q == d ? 0 : 1 + q;
  return 1 + d + q * d - q * (q - 1) / 2 + (r - q);
}

// Built Gaussian rows: each thread owns a 4 x 4 tile of the staged
// positions' upper triangle; see the note.  Block (chunk, group, part)
// walks the sorted points of the chunk's keys that start in its part of
// the sorted order.
__global__ void __launch_bounds__(kTriMaxThreads)
stats_partial_tri_kernel(const float* __restrict__ x, int d, int k,
                         const int32_t* __restrict__ perm,
                         const int32_t* __restrict__ offsets,
                         int tiles_per_group, int batch, int parts,
                         float* __restrict__ partial) {
  extern __shared__ float4 tri_smem[];
  __shared__ int range[2];
  const int dp = (d + 4) & ~3;   // [x, 1] padded to a multiple of 4
  const int nb4 = dp / 4;
  const int f = 1 + d + d * (d + 1) / 2;
  const int nk = 2 * k;
  float* stage = reinterpret_cast<float*>(tri_smem);  // [2][batch][dp]
  int32_t* soff = reinterpret_cast<int32_t*>(stage + 2 * batch * dp);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int threads = blockDim.x;
  const int warps = threads >> 5;
  int t = blockIdx.y * tiles_per_group + tid;
  const bool works = tid < tiles_per_group && t < nb4 * (nb4 + 1) / 2;
  int ta = 0;                    // tile t of the triangle, row by row
  if (works)
    while (t >= nb4 - ta) {
      t -= nb4 - ta;
      ++ta;
    }
  const int qa = 4 * ta;         // the tile's first row and column
  const int qb = 4 * (ta + t);
  int col[4][4];                 // the tile's columns of the row, or -1
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      col[r][c] = (works && qa + r <= qb + c) ? tri_col(qa + r, qb + c, d)
                                              : -1;

  const int chunk = blockIdx.x;
  const int32_t* off = offsets + static_cast<size_t>(chunk) * (nk + 1);
  const int32_t* order = perm + static_cast<size_t>(chunk) * kStatsChunk;
  float* out = partial + static_cast<size_t>(chunk) * nk * f;
  for (int i = tid; i <= nk; i += threads) soff[i] = __ldg(off + i);
  if (tid == 0) {
    range[0] = kStatsChunk;
    range[1] = 0;
  }
  // the 1 and the zero padding of both stages; copies write only [0, d)
  for (int i = tid; i < 2 * batch; i += threads)
    for (int q = d; q < dp; ++q) stage[i * dp + q] = q == d ? 1.0f : 0.0f;
  __syncthreads();
  const int kept = soff[nk];
  if (kept == 0) return;
  // this block's sorted points [lo, hi): its keys, contiguous in the order
  {
    int lo = kStatsChunk, hi = 0;
    for (int key = tid; key < nk; key += threads) {
      const int s = soff[key], e = soff[key + 1];
      if (e > s &&
          static_cast<int>(static_cast<long long>(s) * parts / kept) ==
              static_cast<int>(blockIdx.z)) {
        lo = min(lo, s);
        hi = max(hi, e);
      }
    }
    atomicMin(&range[0], lo);
    atomicMax(&range[1], hi);
  }
  __syncthreads();
  const int lo = range[0];
  const int hi = range[1];
  if (lo >= hi) return;

  // staging: rows of [x, 1] by 16-byte copies, 32 / (d / 4) rows a warp
  // instruction where that divides (D = 4, 8, 16, 32, 64, 128), else one
  // float a lane; the indices of 32 rows come in one read, a lane each
  const int q4 = d / 4;
  const bool vec = (d & 3) == 0 && q4 <= 32 && 32 % q4 == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int rpi = vec ? 32 / q4 : 0;
  const int my_row = vec ? lane / q4 : 0;
  const int my_q = vec ? 4 * (lane % q4) : 0;
  auto load = [&](int buf, int first) {
    const int cnt = min(batch, hi - first);
    float* dst = stage + buf * batch * dp;
    for (int i0 = 0; i0 < cnt; i0 += 32) {
      const int rows = min(32, cnt - i0);
      const int idx = lane < rows ? __ldg(order + first + i0 + lane) : 0;
      if (vec) {
        for (int j = (tid >> 5) * rpi; j < rows; j += warps * rpi) {
          const int r = j + my_row;
          const size_t p = __shfl_sync(kFull, idx, r);
          if (r < rows)
            copy16(dst + (i0 + r) * dp + my_q, x + p * d + my_q);
        }
      } else {
        for (int e0 = (tid >> 5) * 32; e0 < rows * d; e0 += threads) {
          const int e = e0 + lane;
          const int r = min(e / d, 31);
          const size_t p = __shfl_sync(kFull, idx, r);
          if (e < rows * d)
            copy4(dst + (i0 + r) * dp + e % d, x + p * d + e % d);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
  // the key of sorted position ``pos``: the first with points past it
  int key = -1;
  int kend = 0;
  auto seek = [&](int pos) {
    do {
      ++key;
      kend = soff[key + 1];
    } while (kend <= pos);
  };
  auto flush = [&]() {
    float* row = out + static_cast<size_t>(key) * f;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (col[r][c] >= 0) row[col[r][c]] = acc[r][c];
        acc[r][c] = 0.0f;
      }
  };
  seek(lo);

  const int batches = (hi - lo + batch - 1) / batch;
  load(0, lo);
  for (int bt = 0; bt < batches; ++bt) {
    const int first = lo + bt * batch;
    if (bt + 1 < batches) {
      load((bt + 1) & 1, first + batch);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();  // this batch is staged
    const float* rows = stage + (bt & 1) * batch * dp;
    const int last = min(hi, first + batch);
    int i = first;
    while (i < last) {
      const int stop = min(last, kend);
      if (works) {
#pragma unroll 4
        for (; i < stop; ++i) {
          const float* xr = rows + (i - first) * dp;
          const float4 a4 = *reinterpret_cast<const float4*>(xr + qa);
          const float4 b4 = *reinterpret_cast<const float4*>(xr + qb);
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
          const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[r][c] = __fadd_rn(acc[r][c], __fmul_rn(a[r], b[c]));
        }
      }
      i = stop;
      if (i == kend) {  // block-uniform: the key's last point is added
        flush();
        if (i < hi) seek(i);
      }
    }
    __syncthreads();  // everyone is done with this stage before its reload
  }
}

__global__ void stats_reduce_kernel(const float* __restrict__ partial,
                                    const int32_t* __restrict__ offsets,
                                    int n_chunks, int f, int k,
                                    float* __restrict__ stats) {
  const int key = blockIdx.y;
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= f) return;
  const int nk = 2 * k;
  float s = 0.0f;
#pragma unroll 8
  for (int c = 0; c < n_chunks; ++c) {
    const int32_t* o = offsets + static_cast<size_t>(c) * (nk + 1) + key;
    // an absent key's row is not written; it would add +0.0f, a no-op
    const bool present = __ldg(o + 1) > __ldg(o);
    s += present ? __ldg(partial + (static_cast<size_t>(c) * nk + key) * f +
                         col)
                 : 0.0f;
  }
  stats[static_cast<size_t>(key) * f + col] = s;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  return sms;
}

// Cache rows (f32 or bf16) walk as linear rows.
template <class Rows>
cudaError_t launch_walk(Rows rows, const int32_t* perm, const int32_t* offsets,
                        int n_chunks, int f, int k, float* partial,
                        cudaStream_t st) {
  const int col_warps = f > 256 ? kLinWarps : 1;
  const dim3 grid(n_chunks, (f + 32 * col_warps - 1) / (32 * col_warps));
  stats_partial_lin_kernel<Rows><<<grid, kLinThreads, 0, st>>>(
      rows, perm, offsets, f, k, col_warps, partial);
  return cudaGetLastError();
}

// Built rows: [1, x] (multinomial) walks as linear rows, the Gaussian
// triangle in 4 x 4 tiles; any other column map is refused.
cudaError_t launch_walk(BuiltRows rows, const int32_t* perm,
                        const int32_t* offsets, int n_chunks, int f, int k,
                        float* partial, cudaStream_t st) {
  const int d = rows.d;
  if (f == 1 + d)
    return launch_walk<BuiltRows>(rows, perm, offsets, n_chunks, f, k,
                                  partial, st);
  if (f != 1 + d + d * (d + 1) / 2) return cudaErrorInvalidValue;
  const int dp = (d + 4) & ~3;
  const int nb4 = dp / 4;
  const int tiles = nb4 * (nb4 + 1) / 2;
  // at least two blocks an SM where the tiles allow (a warp a group)
  const int most = (tiles + 31) / 32;
  const int least = (tiles + kTriMaxThreads - 1) / kTriMaxThreads;
  const int sms = sm_count();
  const int groups = max(least, min(most, (2 * sms + n_chunks - 1) / n_chunks));
  const int per = (tiles + groups - 1) / groups;
  const int threads = (per + 31) & ~31;
  // parts: split each chunk's keys so that the card holds about 8 warps
  // an SM (uniform and fit labels; one key stays one part's)
  const int warps = n_chunks * groups * (threads / 32);
  const int parts = max(1, min(4, (8 * sms + warps - 1) / warps));
  const int batch = max(1, min(kTriBatch, kStageBytes / (2 * 4 * dp)));
  const size_t smem = static_cast<size_t>(2) * batch * dp * sizeof(float) +
                      static_cast<size_t>(2 * k + 1) * sizeof(int32_t);
  if (smem > 48 * 1024) {  // the offsets of a large K: ask for more
    const cudaError_t err = cudaFuncSetAttribute(
        stats_partial_tri_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  stats_partial_tri_kernel<<<dim3(n_chunks, groups, parts), threads, smem,
                             st>>>(rows.x, d, k, perm, offsets, per, batch,
                                   parts, partial);
  return cudaGetLastError();
}

cudaError_t launch_sort(const int32_t* labels, const int32_t* sub,
                        const uint8_t* valid, int n, int k, int32_t* order,
                        cudaStream_t st) {
  const int n_chunks = (n + kStatsChunk - 1) / kStatsChunk;
  const int nb = 2 * k + 1;
  int32_t* perm = order;
  int32_t* offsets = order + n;
  int32_t* spill = nullptr;
  size_t smem = static_cast<size_t>(kSortWarps + 1) * nb * sizeof(int32_t);
  if (nb > kSortSmemBuckets) {
    spill = offsets + static_cast<size_t>(n_chunks) * nb;
    smem = 0;
  }
  stats_sort_kernel<<<n_chunks, kSortThreads, smem, st>>>(
      labels, sub, valid, n, k, perm, offsets, spill);
  return cudaGetLastError();
}

}  // namespace

template <class Rows>
cudaError_t launch_stats(Rows rows, const int32_t* labels, const int32_t* sub,
                         const uint8_t* valid, int n, int f, int k,
                         float* scratch, float* stats, cudaStream_t stream) {
  if (n == 0)
    return cudaMemsetAsync(stats, 0, sizeof(float) * 2 * k * f, stream);
  const int n_chunks = (n + kStatsChunk - 1) / kStatsChunk;
  int32_t* order = reinterpret_cast<int32_t*>(
      scratch + stats_partial_floats(n, f, k));
  cudaError_t err = launch_sort(labels, sub, valid, n, k, order, stream);
  if (err != cudaSuccess) return err;
  const int32_t* offsets = order + n;
  err = launch_walk(rows, order, offsets, n_chunks, f, k, scratch, stream);
  if (err != cudaSuccess) return err;
  const int threads = f >= 256 ? 256 : 128;
  stats_reduce_kernel<<<dim3((f + threads - 1) / threads, 2 * k), threads, 0,
                        stream>>>(scratch, offsets, n_chunks, f, k, stats);
  return cudaGetLastError();
}

template cudaError_t launch_stats<CacheRows>(CacheRows, const int32_t*,
                                             const int32_t*, const uint8_t*,
                                             int, int, int, float*, float*,
                                             cudaStream_t);
template cudaError_t launch_stats<BuiltRows>(BuiltRows, const int32_t*,
                                             const int32_t*, const uint8_t*,
                                             int, int, int, float*, float*,
                                             cudaStream_t);
template cudaError_t launch_stats<Bf16Rows>(Bf16Rows, const int32_t*,
                                            const int32_t*, const uint8_t*,
                                            int, int, int, float*, float*,
                                            cudaStream_t);

}  // namespace dpmm

// rows: the cache [n, f] when ``pairs`` is null, else the raw points [n, d]
// with the column map pairs [f] (dpmm_kernels.cuh, BuiltRows).  ``scratch``
// holds dpmm_stats_scratch(n, f, k) floats.
extern "C" int dpmm_stats_from_labels(const float* rows, const int32_t* pairs,
                                      int d, const int32_t* labels,
                                      const int32_t* sub, const uint8_t* valid,
                                      int n, int f, int k, float* scratch,
                                      float* stats, void* stream) {
  using namespace dpmm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pairs != nullptr)
    return static_cast<int>(launch_stats(BuiltRows{rows, pairs, d}, labels,
                                         sub, valid, n, f, k, scratch, stats,
                                         st));
  return static_cast<int>(launch_stats(CacheRows{rows, f}, labels, sub, valid,
                                       n, f, k, scratch, stats, st));
}

// feat: the bf16 cache [n, f] ("bfloat16").
extern "C" int dpmm_stats_from_labels_bf16(const void* feat,
                                           const int32_t* labels,
                                           const int32_t* sub,
                                           const uint8_t* valid, int n, int f,
                                           int k, float* scratch,
                                           float* stats, void* stream) {
  using namespace dpmm;
  return static_cast<int>(launch_stats(
      Bf16Rows{static_cast<const __nv_bfloat16*>(feat), f}, labels, sub,
      valid, n, f, k, scratch, stats, static_cast<cudaStream_t>(stream)));
}

// The key sort alone: ``order`` holds dpmm_stats_order_ints(n, k) int32,
// perm [n] then offsets [ceil(n / kStatsChunk), 2k + 1] (then its spill).
extern "C" int dpmm_stats_key_sort(const int32_t* labels, const int32_t* sub,
                                   const uint8_t* valid, int n, int k,
                                   int32_t* order, void* stream) {
  return static_cast<int>(dpmm::launch_sort(
      labels, sub, valid, n, k, order, static_cast<cudaStream_t>(stream)));
}

extern "C" long long dpmm_stats_scratch(int n, int f, int k) {
  return dpmm::stats_scratch_floats(n, f, k);
}

extern "C" long long dpmm_stats_order_ints(int n, int k) {
  return dpmm::stats_order_ints(n, k);
}

extern "C" int dpmm_stats_chunk() { return dpmm::kStatsChunk; }

extern "C" const char* dpmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
