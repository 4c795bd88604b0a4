// Shared pieces of the port's kernels (fact_fwd.cu, fact_bwd.cu,
// semiring_fwd.cu, semiring_bwd.cu): block shape, deterministic
// block-wide reductions and the sparse row product.
//
// Every kernel gives one thread block to one batch column (sequence)
// and runs that column's whole time loop inside the block; a thread owns
// the state rows s = threadIdx.x + k * FACT_THREADS.  Every sum is taken in a
// fixed order (rows in ascending column order, warp shuffles, then
// the warp partials in warp order), so the results do not change from
// run to run and no atomics are used.
#pragma once

#include <cuda_runtime.h>

#define FACT_THREADS 1024
#define FACT_WARPS (FACT_THREADS / 32)

// Sum NV values over the block.  Every thread receives the totals in v.
// red: shared scratch of FACT_WARPS * NV + NV values.  Contains two
// __syncthreads(), so it is also a barrier for everything before it.
template <int NV, typename F>
__device__ __forceinline__ void block_sum(F (&v)[NV], F* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    F x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) red[warp * NV + k] = x;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      F x = lane < FACT_WARPS ? red[lane * NV + k] : F(0);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_down_sync(0xffffffffu, x, off);
      if (lane == 0) red[FACT_WARPS * NV + k] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = red[FACT_WARPS * NV + k];
}

// The sum of s and the max of m over the block, every thread receiving
// both.  Every m must be >= 0 (0 is the identity of the max).  red:
// shared scratch of 2 * FACT_WARPS + 2 values.  Contains two
// __syncthreads(), so it is also a barrier for everything before it.
template <typename F>
__device__ __forceinline__ void block_sum_max(F& s, F& m, F* red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    m = fmax(m, __shfl_down_sync(0xffffffffu, m, off));
  }
  if (lane == 0) {
    red[2 * warp] = s;
    red[2 * warp + 1] = m;
  }
  __syncthreads();
  if (warp == 0) {
    F x = lane < FACT_WARPS ? red[2 * lane] : F(0);
    F y = lane < FACT_WARPS ? red[2 * lane + 1] : F(0);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      x += __shfl_down_sync(0xffffffffu, x, off);
      y = fmax(y, __shfl_down_sync(0xffffffffu, y, off));
    }
    if (lane == 0) {
      red[2 * FACT_WARPS] = x;
      red[2 * FACT_WARPS + 1] = y;
    }
  }
  __syncthreads();
  s = red[2 * FACT_WARPS];
  m = red[2 * FACT_WARPS + 1];
}

// Row r of a matrix in sliced ELL form times a vector v held in shared
// memory.  Rows come in slices of 32; slice i holds sptr[i+1] - sptr[i]
// entry columns of 32 values, entry k of row 32 i + l at index
// 32 k + l, each row in ascending column order and zero-padded (column
// 0, value 0) to the slice's longest row.  A warp's lanes own 32
// consecutive rows, so every col/val load of the warp is one 128-byte
// line.
__device__ __forceinline__ float sell_row_dot(const int* __restrict__ sptr,
                                              const int* __restrict__ col,
                                              const float* __restrict__ val,
                                              int r, const float* v) {
  const int lane = r & 31;
  const int slice = r >> 5;
  float acc = 0.0f;
  const int end = __ldg(sptr + slice + 1);
  for (int k = __ldg(sptr + slice); k < end; ++k) {
    const int i = k * 32 + lane;
    acc = fmaf(__ldg(val + i), v[__ldg(col + i)], acc);
  }
  return acc;
}

// Dynamic shared memory above 48 KB must be asked for per kernel.
template <typename K>
__host__ inline cudaError_t fact_set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}
