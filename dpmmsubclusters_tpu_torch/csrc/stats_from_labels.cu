// Kernel B: per-(slot, side) sufficient statistics from given labels.
//
// Replaces dpmmsubclusters_tpu/ops/pallas_sweep.py:439 stats_from_labels
// (kernel body _stats_kernel, :388-431), "precomputed" variant: the input
// rows are the f32 feature cache [N, F] = [1, x, triu(x x^T)], and the
// output is [LEFT K | RIGHT K] x F in float32, rows masked by ``valid``.
//
// What bounds it on the H100: on the TPU this was a one-hot MXU matmul
// ([2K, T] @ [T, F]); here it is a scatter of feature rows, N * F adds for
// N * F * 4 bytes read -- memory-bound (2.2 GB per pass at 1M x 32-d, about
// 0.7 ms at 3.35 TB/s).  The dense one-hot product would spend 2K times the
// flops for the same answer.
//
// Design: a block owns one chunk of kStatsChunk points, 128 feature columns
// and 32 of the 2K (side, slot) keys.  Each thread owns one column and keeps
// that column's 32 running sums in its own slice of shared memory
// (bank-conflict-free, no syncs, no atomics), adding the chunk's points of
// its keys in order.  A warp reads 32 points' keys at once (coalesced) and
// walks only the points of its key group (ballot + find-first-set), so the
// points of other groups cost a fraction of an instruction each.  Every
// point's row is read by exactly one key group, and the small 16 KB slab
// lets about a dozen blocks share an SM to hide the read latency.
// Each block writes its [32, 128] partial; a second kernel sums the partials
// in chunk order.  The result is deterministic: the same inputs give the
// same bits every run.
#include "dpmm_kernels.cuh"

namespace dpmm {
namespace {

constexpr int kStatsCols = 128;  // threads (= feature columns) per block
constexpr int kStatsKeys = 32;   // (side, slot) keys per block

__global__ void __launch_bounds__(kStatsCols)
stats_partial_kernel(const float* __restrict__ feat,
                     const int32_t* __restrict__ labels,
                     const int32_t* __restrict__ sub,
                     const uint8_t* __restrict__ valid, int n, int f, int k,
                     float* __restrict__ partial) {
  __shared__ float acc[kStatsKeys][kStatsCols];
  const int tid = threadIdx.x;
  const int col = blockIdx.y * kStatsCols + tid;
  const int rows = 2 * k;
  const int key0 = blockIdx.z * kStatsKeys;
  const int nkeys = min(kStatsKeys, rows - key0);
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
    while (mine) {
      const int j = __ffs(mine) - 1;
      mine &= mine - 1;
      const unsigned rj = __shfl_sync(0xffffffffu, r, j);
      if (col < f) acc[rj][tid] += feat[static_cast<size_t>(base + j) * f + col];
    }
  }
  if (col >= f) return;
  float* out = partial + (static_cast<size_t>(chunk) * rows + key0) * f + col;
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

cudaError_t launch_stats(const float* feat, const int32_t* labels,
                         const int32_t* sub, const uint8_t* valid, int n,
                         int f, int k, float* partial, float* stats,
                         cudaStream_t stream) {
  const int n_chunks = (n + kStatsChunk - 1) / kStatsChunk;
  const dim3 grid(n_chunks, (f + kStatsCols - 1) / kStatsCols,
                  (2 * k + kStatsKeys - 1) / kStatsKeys);
  stats_partial_kernel<<<grid, kStatsCols, 0, stream>>>(
      feat, labels, sub, valid, n, f, k, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int m = 2 * k * f;
  stats_reduce_kernel<<<(m + 255) / 256, 256, 0, stream>>>(partial, n_chunks,
                                                          m, stats);
  return cudaGetLastError();
}

}  // namespace dpmm

extern "C" int dpmm_stats_from_labels(const float* feat, const int32_t* labels,
                                      const int32_t* sub, const uint8_t* valid,
                                      int n, int f, int k, float* partial,
                                      float* stats, void* stream) {
  return static_cast<int>(dpmm::launch_stats(
      feat, labels, sub, valid, n, f, k, partial, stats,
      static_cast<cudaStream_t>(stream)));
}

extern "C" int dpmm_stats_chunk() { return dpmm::kStatsChunk; }

extern "C" const char* dpmm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
