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
// Design: a block of 128 threads owns a chunk of kColChunk rows and 128
// columns, a thread one column: each row's 128 values are one coalesced
// read of 512 bytes, and the thread adds its column's values in row order,
// 8 reads in flight.  Each block writes its partial row; a second kernel
// sums the partials in chunk order (32 rows of threads each take every
// 32nd partial, then one thread adds the 32 sums in order), so the result
// is deterministic without float atomics.  The sums can be written to
// several output rows at once (kernel D's ``stats_raw``: all 2K rows).
#include "dpmm_kernels.cuh"

namespace dpmm {
namespace {

constexpr int kColChunk = 1024;  // rows per partial
constexpr int kColCols = 128;    // columns (threads) per block

__global__ void __launch_bounds__(kColCols)
column_partial_kernel(const float* __restrict__ x, int n, int f,
                      float* __restrict__ partial) {
  const int col = blockIdx.y * kColCols + threadIdx.x;
  if (col >= f) return;
  const int p0 = blockIdx.x * kColChunk;
  const int p1 = min(n, p0 + kColChunk);
  const float* src = x + static_cast<size_t>(p0) * f + col;
  float s = 0.0f;
#pragma unroll 8
  for (int p = p0; p < p1; ++p, src += f) s += *src;
  partial[static_cast<size_t>(blockIdx.x) * f + col] = s;
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

int column_chunk() { return kColChunk; }

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
  const int chunks = (n + kColChunk - 1) / kColChunk;
  const dim3 grid(chunks, (f + kColCols - 1) / kColCols);
  column_partial_kernel<<<grid, kColCols, 0, st>>>(x, n, f, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce_rows(partial, chunks, f, out, out_rows, f, st);
}

}  // namespace dpmm

// out [out_rows, f] = the column sums of x [n, f], in every row; partial is
// [ceil(n / dpmm_column_chunk()), f] scratch.
extern "C" int dpmm_column_sum(const float* x, int n, int f, float* partial,
                               float* out, int out_rows, void* stream) {
  return static_cast<int>(dpmm::launch_column_sum(
      x, n, f, partial, out, out_rows, static_cast<cudaStream_t>(stream)));
}

extern "C" int dpmm_column_chunk() { return dpmm::column_chunk(); }
