// Kernel C: the column sums of a row-major f32 matrix, and the fixed-order
// reduction of per-block partial rows that kernel D shares.
//
// Replaces benchmarks/kernel_tile_study.py:30 variant (call :58) in its
// ``dma_only`` mode, whose kernel (:38-51) adds every tile's rows of x into
// row 0 of its statistics output: the TPU study's measure of the rate at
// which a tile of feature rows streams in.  Kernel D's ``dma_only`` and
// ``stats_raw`` stages (kernel_ablate.cu) are the same sums.
//
// What bounds it on the H100: it reads N * F * 4 bytes once and adds each
// value once (N * F adds), so it is bound by memory: 2.68 GB at 1M x 640,
// 0.80 ms at 3.35 TB/s.
//
// Design: x is read as 16-byte values whatever F is.  Four rows are 4F
// floats, so F float4 "slots", and slot q of every group of four rows holds
// the same four columns (those of the flat positions 4q .. 4q + 3 in the
// group).  A block of 128 threads owns a chunk of kColChunk rows and 128
// slots, a thread one slot: a warp reads 512 contiguous, aligned bytes, and
// the thread adds its slot's four values group by group, 8 reads in
// flight.  Each block writes its 4 x 128 sums, which lie in four partial
// rows of F (row r of the group, column c at 4q + e = r F + c); a second
// kernel sums the partial rows in order (32 rows of threads each take every
// 32nd partial, then one thread adds the 32 sums in order), so the result
// is deterministic without float atomics.  The sums can be written to
// several output rows at once (kernel D's ``stats_raw``: all 2K rows).
#include "dpmm_kernels.cuh"

namespace dpmm {
namespace {

constexpr int kColChunk = 1024;  // rows per chunk: 256 groups of four
constexpr int kColSlots = 128;   // float4 slots (threads) per block

__global__ void __launch_bounds__(kColSlots)
column_partial_kernel(const float* __restrict__ x, int n, int f,
                      float* __restrict__ partial) {
  const int q = blockIdx.y * kColSlots + threadIdx.x;
  if (q >= f) return;
  const int p0 = blockIdx.x * kColChunk;
  const int rows = min(n, p0 + kColChunk) - p0;
  const int groups = rows / 4;
  const float4* src =
      reinterpret_cast<const float4*>(x + static_cast<size_t>(p0) * f) + q;
  float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
  for (int g = 0; g < groups; ++g, src += f) {
    const float4 v = *src;
    s[0] += v.x;
    s[1] += v.y;
    s[2] += v.z;
    s[3] += v.w;
  }
  // the chunk's last rows, where they are no whole group
  const float* tail = x + (static_cast<size_t>(p0) + 4 * groups) * f;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if ((4 * q + e) / f < rows - 4 * groups) s[e] += tail[4 * q + e];
  reinterpret_cast<float4*>(partial +
                            static_cast<size_t>(blockIdx.x) * 4 * f)[q] =
      make_float4(s[0], s[1], s[2], s[3]);
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

int column_partials(int n) {
  return (n + kColChunk - 1) / kColChunk * 4;
}

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
  const int chunks = (n + kColChunk - 1) / kColChunk;
  const dim3 grid(chunks, (f + kColSlots - 1) / kColSlots);
  column_partial_kernel<<<grid, kColSlots, 0, st>>>(x, n, f, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce_rows(partial, 4 * chunks, f, out, out_rows, f, st);
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
