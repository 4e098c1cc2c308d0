// The register-tiled, exact float32 row x phi product that kernels A
// (fused_assign.cu, ll_precision "highest") and D (kernel_ablate.cu) share,
// on the CUDA cores.  Kernel A's other precisions take the tensor cores
// (fused_assign_tc.cuh).
//
// The contract: every output is one fmaf chain over the features in
// ascending order, starting from 0.0f, so any tiling that keeps each
// output's chain gives the same bits.
//
// A block of 2 BM threads owns BM points and, a call, BN <= 128 columns.
// A thread holds a 16 x TN outer-product tile (TN = BN / 32): the 16
// points of its warp and the columns TN lane + [0, TN), so a warp holds
// whole rows of the product, and a row's argmax is five shuffles.  A step
// of the product reads the 16 row values as four 16-byte shared reads of
// one address for the whole warp (a broadcast) and the TN phi values as one
// read, consecutive across the lanes, and does 16 TN fmaf.  (On an H100:
// 8 x 8 tiles over half-warps ran as fast; 16 x 8 and 32 x 4 tiles, with
// their 8 warps an SM, 25-35% slower.)
// The product runs over 16-deep slices of F through a ring of kExStages
// stages, with one barrier a slice: phi by 16-byte cp.async where its rows
// and columns are 16-byte aligned (4-byte otherwise), f32 cache rows by
// 4-byte cp.async (a row of F = 561 floats is not 16-byte aligned, and the
// cache gets no padding), bf16 cache rows read into registers before the
// slice's multiply (two to a register) and stored after it, rows built
// from X = [1, x] of the block's points (kept in shared memory by the
// caller where they fit) built and stored after the multiply.
// Every thread stages one feature of 8 points a slice at any BM, so a warp
// reads 16 consecutive features of two rows an instruction.
#pragma once

#include "dpmm_kernels.cuh"

#include <type_traits>

namespace dpmm {

constexpr int kExDepth = 16;       // features a slice
constexpr int kExStages = 4;       // slices in the ring
constexpr int kExPoints = 16;      // points a thread: its warp's
constexpr int kExColThreads = 32;  // threads across a call's columns
constexpr int kExAPad = 4;         // keeps the 16-byte reads aligned

template <int BM, int BN>
struct ExactShape {
  static_assert(BM % 32 == 0 && (BN == 32 || BN == 64 || BN == 128), "");
  static constexpr int kThreads = BM / kExPoints * kExColThreads;  // 2 BM
  static constexpr int kTN = BN / kExColThreads;  // columns a thread
  static constexpr int kALd = BM + kExAPad;       // rows, transposed
  static constexpr int kStageFloats = kExDepth * (kALd + BN);
  static constexpr int kRingFloats = kExStages * kStageFloats;
};

// The block's point of a thread's slot i (ty: the thread's warp).
__device__ __forceinline__ int own_row(int ty, int i) {
  return kExPoints * ty + i;
}
// The call's column of a thread's slot c (tx: the thread's lane).
template <int TN>
__device__ __forceinline__ int own_col(int tx, int c) {
  return TN * tx + c;
}

// 4- and 16-byte asynchronous global -> shared copies; ``bytes`` < the
// size zero-fills the rest (0: the source is not read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Raw bf16 bits of cache value ``c`` of point p (the upcast is exact).
__device__ __forceinline__ uint32_t bf16_bits(const Bf16Rows& rows,
                                              Bf16Rows::Col c, int p) {
  return __ldg(reinterpret_cast<const unsigned short*>(rows.feat) +
               static_cast<size_t>(p) * rows.f + c.c);
}

// Lets ``Kernel`` take ``bytes`` of dynamic shared memory on the current
// card, set once a card and not at every launch: setting it waits for the
// card, and the sweep's host must run ahead of it.
constexpr int kMaxDevices = 64;  // cards of one host tracked
template <auto Kernel>
cudaError_t allow_smem(int bytes) {
  static bool allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!allowed[device]) {
    err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    allowed[device] = true;
  }
  return cudaSuccess;
}

// acc[i][c] = row(row0 + own_row(warp, i)) . phi[:, col0 + own_col(lane, c)]
// for the phi columns col0 + [0, ncols) (leading dimension ldp); other
// columns and rows past n give 0.  ``smem`` holds ExactShape's ring (16-byte
// aligned).  Built rows read X = [1, x] of the block's points from ``xs``
// (row pitch d + 1) where the caller staged it there, else from x.  Every
// thread of the block calls it; it returns with the ring free for the
// caller (no copy in flight, a barrier passed).  ``Unroll``: steps of the
// slice's loop unrolled (2 ran 8% faster than 1 or 16 at F=2145, and it
// spills where the block also holds the one-pass epilogue).
template <int BM, int BN, int Unroll, class Rows>
__device__ __forceinline__ void exact_product(
    const Rows& rows, const float* __restrict__ phi, int ldp, int col0,
    int ncols, int row0, int n, int f, float* smem,
    const float* __restrict__ xs, float (&acc)[kExPoints][BN / kExColThreads]) {
  using Shape = ExactShape<BM, BN>;
  constexpr int T = Shape::kThreads;
  constexpr int TN = Shape::kTN;
  constexpr int kALd = Shape::kALd;
  constexpr int kEach = BM * kExDepth / T;  // 8 points a thread stages
  constexpr int kStep = T / kExDepth;       // between them
  constexpr bool kCache = std::is_same<Rows, CacheRows>::value;
  constexpr bool kBf16 = std::is_same<Rows, Bf16Rows>::value;
  const int tid = threadIdx.x;
  const int tx = tid % kExColThreads;
  const int ty = tid / kExColThreads;
  // this thread stages feature kk of the points sr + i kStep: a warp reads
  // 16 consecutive features of two rows an instruction
  const int kk = tid % kExDepth;
  const int sr = tid / kExDepth;
  uint32_t held[kEach / 2];  // bf16 rows of a slice in flight, two a word
  // 16-byte phi copies need 16-byte aligned rows and columns
  const bool phi16 = ldp % 4 == 0 && col0 % 4 == 0 &&
                     (reinterpret_cast<uintptr_t>(phi) & 15) == 0;

  auto a_of = [&](int s) { return smem + s * Shape::kStageFloats; };
  auto b_of = [&](int s) { return a_of(s) + kExDepth * kALd; };
  auto load_phi = [&](int s, int k0) {
    float* b = b_of(s);
    if (phi16) {
      constexpr int kChunks = kExDepth * BN / 4;
#pragma unroll
      for (int it = 0; it < (kChunks + T - 1) / T; ++it) {
        const int idx = tid + it * T;
        if (kChunks % T == 0 || idx < kChunks) {
          const int kr = idx / (BN / 4);
          const int c = idx % (BN / 4) * 4;
          const int fr = k0 + kr;
          const int bytes = fr < f ? 4 * max(0, min(4, ncols - c)) : 0;
          cp_async16(b + kr * BN + c,
                     bytes ? phi + static_cast<size_t>(fr) * ldp + col0 + c
                           : phi,
                     bytes);
        }
      }
    } else {
      constexpr int kElems = kExDepth * BN;
#pragma unroll
      for (int it = 0; it < (kElems + T - 1) / T; ++it) {
        const int idx = tid + it * T;
        if (kElems % T == 0 || idx < kElems) {
          const int kr = idx / BN;
          const int c = idx % BN;
          const int fr = k0 + kr;
          const bool ok = fr < f && c < ncols;
          cp_async4(b + kr * BN + c,
                    ok ? phi + static_cast<size_t>(fr) * ldp + col0 + c : phi,
                    ok);
        }
      }
    }
  };
  // Rows [row0, row0 + BM) x features [k0, k0 + 16) of a slice.  f32 cache
  // rows are copied asynchronously (load_rows); bf16 rows are read into
  // ``held`` (load_rows) and stored after the multiply (store_rows); rows
  // built from the block's X in shared memory (or from x) are built and
  // stored after the multiply (store_rows).
  const float* block_rows = nullptr;
  if constexpr (kCache) block_rows = rows.feat + static_cast<size_t>(row0) * f;
  auto load_rows = [&](int s, int k0) {
    const int fc = k0 + kk;
    if constexpr (kCache) {
      float* a = a_of(s) + kk * kALd + sr;
#pragma unroll
      for (int i = 0; i < kEach; ++i) {
        const int r = sr + i * kStep;
        const bool ok = row0 + r < n && fc < f;
        cp_async4(a + i * kStep, ok ? block_rows + (r * f + fc) : rows.feat,
                  ok);
      }
    } else if constexpr (kBf16) {
      const Bf16Rows::Col c = rows.col(fc < f ? fc : 0);
#pragma unroll
      for (int i = 0; i < kEach; i += 2) {
        const int g = row0 + sr + i * kStep;
        const uint32_t lo =
            (g < n && fc < f) ? bf16_bits(rows, c, g) : 0u;
        const uint32_t hi = (g + kStep < n && fc < f)
                                ? bf16_bits(rows, c, g + kStep)
                                : 0u;
        held[i / 2] = lo | hi << 16;
      }
    }
  };
  auto store_rows = [&](int s, int k0) {
    float* a = a_of(s) + kk * kALd + sr;
    const int fc = k0 + kk;
    if constexpr (kBf16) {
#pragma unroll
      for (int i = 0; i < kEach; i += 2) {
        a[i * kStep] = __uint_as_float(held[i / 2] << 16);
        a[(i + 1) * kStep] = __uint_as_float(held[i / 2] & 0xffff0000u);
      }
    } else if constexpr (!kCache) {
      const bool in_f = fc < f;
      const typename Rows::Col c = rows.col(in_f ? fc : 0);
#pragma unroll
      for (int i = 0; i < kEach; ++i) {
        const int r = sr + i * kStep;
        float v = 0.0f;
        if (in_f && row0 + r < n) {
          if constexpr (std::is_same<Rows, BuiltRows>::value) {
            const int at = r * (rows.d + 1);
            v = xs ? __fmul_rn(xs[at + c.a], xs[at + c.b])
                   : rows.at(c, row0 + r);
          } else {
            v = rows.at(c, row0 + r);
          }
        }
        a[i * kStep] = v;
      }
    }
  };

#pragma unroll
  for (int i = 0; i < kExPoints; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.0f;

  const int slices = (f + kExDepth - 1) / kExDepth;
  __syncthreads();  // an earlier call or phase may still read the ring
#pragma unroll
  for (int s = 0; s < kExStages - 1; ++s) {
    if (s < slices) {
      load_phi(s, s * kExDepth);
      load_rows(s, s * kExDepth);
      store_rows(s, s * kExDepth);
    }
    cp_async_commit();
  }
  for (int t = 0; t < slices; ++t) {
    // slice t has landed (the groups after it may still be in flight);
    // after the barrier every thread is done with slice t - 1's stage
    cp_async_wait<kExStages - 2>();
    __syncthreads();
    const int nx = t + kExStages - 1;
    const bool more = nx < slices;
    if (more) {
      load_phi(nx % kExStages, nx * kExDepth);
      load_rows(nx % kExStages, nx * kExDepth);
    }
    cp_async_commit();  // empty past the last slice: keeps the count
    const float* a = a_of(t % kExStages);
    const float* b = b_of(t % kExStages);
#pragma unroll (Unroll)
    for (int k2 = 0; k2 < kExDepth; ++k2) {
      float av[kExPoints];
#pragma unroll
      for (int q = 0; q < kExPoints / 4; ++q) {
        const float4 a4 = *reinterpret_cast<const float4*>(
            a + k2 * kALd + kExPoints * ty + 4 * q);
        av[4 * q] = a4.x;
        av[4 * q + 1] = a4.y;
        av[4 * q + 2] = a4.z;
        av[4 * q + 3] = a4.w;
      }
      float bv[TN];
      if constexpr (TN == 4) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(b + k2 * BN + 4 * tx);
        bv[0] = b4.x;
        bv[1] = b4.y;
        bv[2] = b4.z;
        bv[3] = b4.w;
      } else if constexpr (TN == 2) {
        const float2 b2 =
            *reinterpret_cast<const float2*>(b + k2 * BN + 2 * tx);
        bv[0] = b2.x;
        bv[1] = b2.y;
      } else {
        bv[0] = b[k2 * BN + tx];
      }
#pragma unroll
      for (int i = 0; i < kExPoints; ++i)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
    if (more) store_rows(nx % kExStages, nx * kExDepth);
  }
  cp_async_wait<0>();
  __syncthreads();
}

}  // namespace dpmm
