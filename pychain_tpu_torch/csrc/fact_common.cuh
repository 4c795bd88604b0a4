// Shared pieces of the port's kernels (fact_fwd.cu, fact_bwd.cu,
// stream_fwd.cu, stream_bwd.cu, semiring_fwd.cu, semiring_bwd.cu;
// viterbi.cu takes only fact_set_smem): block shape, deterministic
// block-wide and cluster-wide reductions and the sparse row products.
//
// Every kernel but the cluster pair gives one thread block to one batch
// column (sequence) and runs that column's whole time loop inside the
// block; a thread owns the state rows s = threadIdx.x + k * FACT_THREADS.
// The cluster pair (stream_*.cu) gives one thread-block cluster to one
// column: CTA r of the cluster owns the 32-row slices k = r (mod C) of
// the states, computes those rows, and each frame copies its peers' rows
// of the vectors its products gather into its own full copy, through
// distributed shared memory (DSMEM).  Every sum is
// taken in a fixed order (rows in ascending column order, warp shuffles,
// then the warp partials in warp order, then the CTAs' totals in rank
// order), so the results do not change from run to run and no atomics
// are used.
#pragma once

#include <cooperative_groups.h>
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

// The cluster kernels' rows.  CTA r of a cluster of C owns the 32-row
// slices k = r, r + C, r + 2C, ... of the S_pad states (interleaved, so
// that the rows of every role of the permuted numbering are spread over
// the CTAs), and keeps its own rows of a vector at local rows
// i = 32 (k / C) + (s mod 32).
__device__ __forceinline__ int cluster_own_rows(int s_pad, int rank, int C) {
  const int slices = s_pad >> 5;
  return rank < slices ? 32 * ((slices - rank + C - 1) / C) : 0;
}

__device__ __forceinline__ int cluster_row(int i, int rank, int C) {
  return (((i >> 5) * C + rank) << 5) | (i & 31);
}

// A state is named to a peer as (owner rank << CLUSTER_LOCAL_BITS) |
// (local row in the owner): local rows stay below 2^16 (a CTA's shared
// memory holds at most 58,112 floats).
#define CLUSTER_LOCAL_BITS 16
#define CLUSTER_LOCAL_MASK ((1 << CLUSTER_LOCAL_BITS) - 1)

// The value at the packed state id c of a vector kept by local row in
// each CTA (at the same shared memory offset in every CTA of the
// cluster): one 4-byte DSMEM load unless the owner is this CTA.  For
// values read once a frame (stream_bwd's posterior masses) this beats
// copying the peers' rows in whole, which costs another cluster barrier
// and the copy of every row (PERF.md); values read many times a frame,
// as the products read their vectors, are copied (cluster_gather).
__device__ __forceinline__ float cluster_load(const float* v, int c) {
  namespace cg = cooperative_groups;
  const float* p = cg::this_cluster().map_shared_rank(
      v + (c & CLUSTER_LOCAL_MASK), c >> CLUSTER_LOCAL_BITS);
  return *p;
}

// Fill the peers' rows of v, a full S_pad-float vector at the same shared
// memory offset in every CTA of the cluster whose owners have written
// their own rows: 16-byte DSMEM loads, consecutive threads on
// consecutive addresses (8 float4 a 32-row slice).  Reading a peer's
// scattered entries one 4-byte load at a time instead made the products
// 5x slower (PERF.md).  The caller puts a cluster barrier before
// (the owners' writes) and a block barrier after.
__device__ __forceinline__ void cluster_gather(float* v, int s_pad) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  if (C == 1) return;
  float4* v4 = reinterpret_cast<float4*>(v);
  for (int q = threadIdx.x; q < (s_pad >> 2); q += FACT_THREADS) {
    const int owner = (q >> 3) % C;
    if (owner != rank) v4[q] = *cluster.map_shared_rank(v4 + q, owner);
  }
}

// Sum each CTA's block totals v (every thread holds them, as block_sum
// leaves them) over the cluster, adding the CTAs' totals in rank order
// from 0, so that every thread of every CTA receives bit-identical sums.
// slot: NV floats of shared memory at the same offset in every CTA.
// Contains one cluster barrier, which is also a barrier for everything
// before it in every CTA.  The slot is written again only by the next
// call, so a cluster barrier must separate two calls (the callers' frame
// loops have one), and one must come before a CTA exits.
template <int NV>
__device__ __forceinline__ void cluster_sum(float (&v)[NV], float* slot) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) slot[k] = v[k];
  }
  cluster.sync();
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = 0.0f;
  const unsigned n = cluster.num_blocks();
  for (unsigned q = 0; q < n; ++q) {
    const float* s = cluster.map_shared_rank(slot, q);
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] += s[k];
  }
}

// Dynamic shared memory above 48 KB must be asked for per kernel.
template <typename K>
__host__ inline cudaError_t fact_set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Launch configuration of B clusters of `cluster` CTAs of FACT_THREADS
// threads (grid B * cluster: CTAs b * cluster .. b * cluster + cluster - 1
// form column b's cluster).  attr (one entry) must outlive the launch.
__host__ inline cudaLaunchConfig_t cluster_config(int B, int cluster,
                                                  size_t smem, void* stream,
                                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * cluster, 1, 1);
  cfg.blockDim = dim3(FACT_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}
