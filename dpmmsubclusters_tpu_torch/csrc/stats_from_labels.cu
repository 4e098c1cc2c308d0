// Kernel B: per-(slot, side) sufficient statistics from given labels.
//
// Replaces dpmmsubclusters_tpu/ops/pallas_sweep.py:439 stats_from_labels
// (kernel body _stats_kernel, :388-431) in its "precomputed", "gaussian",
// "multinomial" and "bfloat16" variants.  The output is [LEFT K | RIGHT K] x
// F in float32, rows masked by ``valid``.  The rows come from a
// compile-time source (dpmm_kernels.cuh): the f32 feature cache [N, F]
// ("precomputed"), rows built here from the raw points x [N, D]
// ("gaussian": [1, x, triu(x x^T)], F = 1 + D + D(D+1)/2; "multinomial":
// [1, x], F = 1 + D), or the bf16 feature cache [N, F] ("bfloat16", each
// value upcast exactly and summed in f32).  A "hybrid" container's
// statistics are the "gaussian" variant on its raw points.
//
// What bounds it on the H100: on the TPU this was a one-hot MXU matmul
// ([2K, T] @ [T, F]); here it is a scatter of feature rows, N * F adds.
// From the cache it is memory-bound: N * F * 4 bytes (2.2 GB per pass at
// 1M x 32-d, about 0.7 ms at 3.35 TB/s; half that from the bf16 cache).
// Built from x it reads only the points (256 B per point at D=64 against
// the cache row's 8.6 KB) and the walk over the keys bounds it.  The dense one-hot product would spend 2K
// times the flops for the same answer.
//
// Design: a block owns one chunk of kStatsChunk points, 128 feature columns
// and 32 of the 2K (side, slot) keys.  Each thread owns one column and keeps
// that column's 32 running sums in its own slice of shared memory
// (bank-conflict-free, no syncs, no atomics), adding the chunk's points of
// its keys in order.  A warp reads 32 points' keys at once (coalesced) and
// walks only the points of its key group (ballot + find-first-set), so the
// points of other groups cost a fraction of an instruction each; cache rows
// are read 4 points at a time so that 4 reads are in flight.  Every point's
// row is read by exactly one key group, and the small 16 KB slab lets about
// a dozen blocks share an SM to hide the read latency.  A built column looks
// its (a, b) pair up once and then reads x[p, a-1] and x[p, b-1] of each of
// its points: the 128 threads of a block read the same x row, so those are
// L1 hits, and the scan of the keys (every column block of a chunk reads
// all its keys: 17 x 16 scans of each key at D=64, K=256) bounds the
// kernel.
// Each block writes its [32, 128] partial; a second kernel sums the partials
// in chunk order.  The result is deterministic: the same inputs give the
// same bits every run, and a built row adds exactly the cached row's values
// in the same order, so the variants agree bit for bit on the same points.
// The scratch is n_chunks x 2K x F floats: 611 x 512 x 2145 x 4 B = 2.7 GB
// at 10M x 64-d and K=256, beside the 2.6 GB of x.
#include "dpmm_kernels.cuh"

#include <type_traits>

namespace dpmm {
namespace {

constexpr int kStatsCols = 128;  // threads (= feature columns) per block
constexpr int kStatsKeys = 32;   // (side, slot) keys per block

template <class Rows>
__global__ void __launch_bounds__(kStatsCols)
stats_partial_kernel(Rows rows, const int32_t* __restrict__ labels,
                     const int32_t* __restrict__ sub,
                     const uint8_t* __restrict__ valid, int n, int f, int k,
                     float* __restrict__ partial) {
  // points of the key group read at once: cache rows (f32 or bf16) come
  // from device memory, so 4 reads in flight beat 1; built rows read x from
  // L1 and the scan of the keys bounds them, where the batching only adds
  // work
  constexpr int kWalk = std::is_same<Rows, BuiltRows>::value ? 1 : 4;
  __shared__ float acc[kStatsKeys][kStatsCols];
  const int tid = threadIdx.x;
  const int col = blockIdx.y * kStatsCols + tid;
  const bool live = col < f;
  const typename Rows::Col c = rows.col(live ? col : 0);
  const int n_keys = 2 * k;
  const int key0 = blockIdx.z * kStatsKeys;
  const int nkeys = min(kStatsKeys, n_keys - key0);
  for (int r = 0; r < kStatsKeys; ++r) acc[r][tid] = 0.0f;

  const int chunk = blockIdx.x;
  const int p0 = chunk * kStatsChunk;
  const int p1 = min(n, p0 + kStatsChunk);
  const int lane = tid & 31;
  // each warp reads 32 keys at a time and walks only the points of this
  // block's key group, in point order (ballot + find-first-set)
  for (int base = p0; base < p1; base += 32) {
    const int p = base + lane;
    unsigned r = 0xffffffffu;  // row within the key group, or "not mine"
    if (p < p1 && valid[p]) {
      const int l = labels[p];
      const int s = sub[p];
      // out-of-range labels are dropped rather than written out of bounds
      if (static_cast<unsigned>(l) < static_cast<unsigned>(k) &&
          static_cast<unsigned>(s) < 2u)
        r = static_cast<unsigned>(s * k + l - key0);
    }
    unsigned mine = __ballot_sync(0xffffffffu, r < static_cast<unsigned>(nkeys));
    // kWalk points at a time: their reads are issued together, then added
    // in point order (the same sums, bit for bit, as one at a time)
    while (mine) {
      int j[kWalk];
      unsigned rj[kWalk];
      float v[kWalk];
#pragma unroll
      for (int u = 0; u < kWalk; ++u) {
        j[u] = mine ? __ffs(mine) - 1 : -1;  // warp-uniform
        mine &= mine - 1;
        rj[u] = __shfl_sync(0xffffffffu, r, j[u] < 0 ? 0 : j[u]);
      }
#pragma unroll
      for (int u = 0; u < kWalk; ++u)
        v[u] = (live && j[u] >= 0) ? rows.at(c, base + j[u]) : 0.0f;
#pragma unroll
      for (int u = 0; u < kWalk; ++u)
        if (live && j[u] >= 0) acc[rj[u]][tid] += v[u];
    }
  }
  if (!live) return;
  float* out = partial + (static_cast<size_t>(chunk) * n_keys + key0) * f + col;
  for (int r = 0; r < nkeys; ++r) out[static_cast<size_t>(r) * f] = acc[r][tid];
}

__global__ void stats_reduce_kernel(const float* __restrict__ partial,
                                    int n_chunks, int m,
                                    float* __restrict__ stats) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  float s = 0.0f;
  for (int c = 0; c < n_chunks; ++c) s += partial[static_cast<size_t>(c) * m + i];
  stats[i] = s;
}

}  // namespace

template <class Rows>
cudaError_t launch_stats(Rows rows, const int32_t* labels, const int32_t* sub,
                         const uint8_t* valid, int n, int f, int k,
                         float* partial, float* stats, cudaStream_t stream) {
  const int n_chunks = (n + kStatsChunk - 1) / kStatsChunk;
  const dim3 grid(n_chunks, (f + kStatsCols - 1) / kStatsCols,
                  (2 * k + kStatsKeys - 1) / kStatsKeys);
  stats_partial_kernel<Rows><<<grid, kStatsCols, 0, stream>>>(
      rows, labels, sub, valid, n, f, k, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int m = 2 * k * f;
  stats_reduce_kernel<<<(m + 255) / 256, 256, 0, stream>>>(partial, n_chunks,
                                                          m, stats);
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
// with the column map pairs [f] (dpmm_kernels.cuh, BuiltRows).
extern "C" int dpmm_stats_from_labels(const float* rows, const int32_t* pairs,
                                      int d, const int32_t* labels,
                                      const int32_t* sub, const uint8_t* valid,
                                      int n, int f, int k, float* partial,
                                      float* stats, void* stream) {
  using namespace dpmm;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pairs != nullptr)
    return static_cast<int>(launch_stats(BuiltRows{rows, pairs, d}, labels,
                                         sub, valid, n, f, k, partial, stats,
                                         st));
  return static_cast<int>(launch_stats(CacheRows{rows, f}, labels, sub, valid,
                                       n, f, k, partial, stats, st));
}

// feat: the bf16 cache [n, f] ("bfloat16").
extern "C" int dpmm_stats_from_labels_bf16(const void* feat,
                                           const int32_t* labels,
                                           const int32_t* sub,
                                           const uint8_t* valid, int n, int f,
                                           int k, float* partial,
                                           float* stats, void* stream) {
  using namespace dpmm;
  return static_cast<int>(launch_stats(
      Bf16Rows{static_cast<const __nv_bfloat16*>(feat), f}, labels, sub,
      valid, n, f, k, partial, stats, static_cast<cudaStream_t>(stream)));
}

extern "C" int dpmm_stats_chunk() { return dpmm::kStatsChunk; }

extern "C" const char* dpmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
