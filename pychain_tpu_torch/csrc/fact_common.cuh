// Shared pieces of the port's kernels (fact_fwd.cu, fact_bwd.cu,
// stream_fwd.cu, stream_bwd.cu, semiring_fwd.cu, semiring_bwd.cu;
// viterbi.cu takes only fact_set_smem): block shape, deterministic
// block-wide, warp-wide and cluster-wide reductions, the sparse row
// products and the TMA pieces (bulk copies, mbarriers, bulk groups).
//
// Every kernel but the cluster pair gives one thread block to one batch
// column (sequence) and runs that column's whole time loop inside the
// block; a thread owns the state rows s = threadIdx.x + k * FACT_THREADS
// (the semiring pair: k * blockDim.x, a block sized to the graph).
// The cluster pair (stream_*.cu) gives one thread-block cluster to a
// group of G columns: CTA r of the cluster owns the 32-row slices
// k = r (mod C) of the states, computes those rows in all G columns, and
// each frame copies its peers' rows of the one vector its W1 (W1^T)
// product gathers into its own whole copy, through distributed shared
// memory (DSMEM).  Every sum is
// taken in a fixed order (a row's entries in its slot order, warp
// shuffles, then the warp partials in warp order, then the CTAs' totals
// in rank order), so the results do not change from run to run and no
// atomics are used.
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
// slots of 32 values, slot k of row 32 i + l at index 32 k + l, each row
// zero-padded (column 0, value 0) to the slice's longest row.  A warp's
// lanes own 32 consecutive rows, so every col/val load of the warp is one
// 128-byte line, and each slot's gather v[col] is one shared-memory load
// of the warp, served in as many wavefronts as the fullest of the 32
// banks (word c in bank c mod 32) has distinct words.  The order of a
// row's entries among its slots is the sum's order, fixed by the host:
// B1/B2 (fact_fwd.cu, fact_bwd.cu) read each row in bank order
// (fact_kernels.bank_order: each slot's lanes on distinct banks as far
// as a greedy pass finds, 1.41 / 1.36 wavefronts a slot for W1 / W1^T at
// the headline graph against 2.87 / 3.10 in ascending order); the cluster
// pair reads them in ascending column order (sell_row_dot_cols), since
// its gathers are G columns wide (8 or 16 bytes a lane), which the banks
// serve by another rule (ROADMAP.md queues an order for them).
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

// The cluster pair's layout.  A cluster of C CTAs (C a power of two)
// serves G batch columns at once.  CTA r owns the 32-row slices
// k = r, r + C, r + 2C, ... of the S_pad states (interleaved, so that
// the rows of every role of the permuted numbering are spread over the
// CTAs) and keeps its own rows of a vector at local rows
// i = 32 (k / C) + (s mod 32).  Every per-state vector in shared memory
// holds the G columns side by side, v[s * G + g], so that one 4-, 8- or
// 16-byte access reads a state's value in every column of the group.
__device__ __forceinline__ int cluster_own_rows(int s_pad, int rank, int C) {
  const int slices = s_pad >> 5;
  return rank < slices ? 32 * ((slices - rank + C - 1) / C) : 0;
}

__device__ __forceinline__ int cluster_row(int i, int rank, int C) {
  return (((i >> 5) * C + rank) << 5) | (i & 31);
}

// The owner rank and local row of state s in a cluster of 1 << lc CTAs.
__device__ __forceinline__ int cluster_owner(int s, int lc) {
  return (s >> 5) & ((1 << lc) - 1);
}

__device__ __forceinline__ int cluster_local(int s, int lc) {
  return (((s >> 5) >> lc) << 5) | (s & 31);
}

// A state is named to a peer as (owner rank << CLUSTER_LOCAL_BITS) |
// (local row in the owner): local rows stay below 2^16 (a CTA's shared
// memory holds at most 58,112 floats).
#define CLUSTER_LOCAL_BITS 16
#define CLUSTER_LOCAL_MASK ((1 << CLUSTER_LOCAL_BITS) - 1)

// G consecutive floats (16-byte aligned for G = 4, 8-byte for G = 2) as
// one access; p may point into a peer's shared memory.
template <int G>
__device__ __forceinline__ void load_cols(const float* p, float (&v)[G]) {
  static_assert(G == 1 || G == 2 || G == 4, "G is 1, 2 or 4");
  if constexpr (G == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (G == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = *p;
  }
}

template <int G>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[G]) {
  if constexpr (G == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (G == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// load_cols / store_cols on device memory that other CTAs of the kernel
// write or read in the same launch: cached in L2 only (ld.global.cg,
// st.global.cg), never in an SM's L1, which is not kept coherent.
template <int G>
__device__ __forceinline__ void load_cols_l2(const float* p, float (&v)[G]) {
  if constexpr (G == 4) {
    const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else if constexpr (G == 2) {
    const float2 q = __ldcg(reinterpret_cast<const float2*>(p));
    v[0] = q.x, v[1] = q.y;
  } else {
    v[0] = __ldcg(p);
  }
}

template <int G>
__device__ __forceinline__ void store_cols_l2(float* p, const float (&v)[G]) {
  if constexpr (G == 4) {
    __stcg(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (G == 2) {
    __stcg(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    __stcg(p, v[0]);
  }
}

// store_cols for the streams a kernel writes once and its partner reads
// once (st.global.cs: evicted first, so that they do not push the sparse
// rows and px out of L1 and L2; 18% of stream_fwd at main path 4, PERF.md).
template <int G>
__device__ __forceinline__ void store_cols_stream(float* p,
                                                  const float (&v)[G]) {
  if constexpr (G == 4) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  } else if constexpr (G == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
    __stcs(p, v[0]);
  }
}

// sell_row_dot for G columns at once: row r of a sliced-ELL matrix times
// the G interleaved columns of v.  Each entry's column id and value,
// loaded once, feed G products (the graph is read once per G columns),
// each column's sum in sell_row_dot's order.
template <int G>
__device__ __forceinline__ void sell_row_dot_cols(
    const int* __restrict__ sptr, const int* __restrict__ col,
    const float* __restrict__ val, int r, const float* v, float (&acc)[G]) {
  const int lane = r & 31;
  const int slice = r >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.0f;
  const int end = __ldg(sptr + slice + 1);
  for (int k = __ldg(sptr + slice); k < end; ++k) {
    const int i = k * 32 + lane;
    const float w = __ldg(val + i);
    float x[G];
    load_cols<G>(v + __ldg(col + i) * G, x);
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = fmaf(w, x[g], acc[g]);
  }
}

// The G values at the packed state id c of a vector kept by local row in
// each CTA (at the same shared memory offset in every CTA of the
// cluster): one G-wide load, through DSMEM unless this CTA (rank) owns
// the state.  For values read once a frame (stream_bwd's posterior masses
// and its W2^T gathers of b: W2 has at most one entry a row in the
// repository's graphs) this beats copying the peers' rows in whole, which
// costs a cluster barrier and the copy of every row (PERF.md); the
// vector W1^T gathers many times a frame is copied (cluster_gather_cols).
template <int G>
__device__ __forceinline__ void cluster_load_cols(const float* v, int c,
                                                  int rank, float (&out)[G]) {
  namespace cg = cooperative_groups;
  const float* p = v + (c & CLUSTER_LOCAL_MASK) * G;
  const int owner = c >> CLUSTER_LOCAL_BITS;
  load_cols<G>(owner == rank ? p : cg::this_cluster().map_shared_rank(p, owner),
               out);
}

// Fill the peers' rows of v, a whole vector of S_pad x G interleaved
// floats at the same shared memory offset in every CTA of a cluster of
// 1 << lc, whose owners have written their own rows: 16-byte DSMEM
// loads, consecutive threads on consecutive addresses (8 G float4 a
// 32-row slice).  Reading a peer's scattered entries one load at a time
// instead made the products 5x slower (PERF.md).  The caller puts a
// cluster barrier before (the owners' writes) and a block barrier after.
template <int G>
__device__ __forceinline__ void cluster_gather_cols(float* v, int s_pad,
                                                    int rank, int lc) {
  namespace cg = cooperative_groups;
  if (lc == 0) return;
  cg::cluster_group cluster = cg::this_cluster();
  constexpr int kSliceShift = G == 4 ? 5 : G == 2 ? 4 : 3;  // log2(8 G)
  float4* v4 = reinterpret_cast<float4*>(v);
  const int mask = (1 << lc) - 1;
  for (int q = threadIdx.x; q < (s_pad * G) >> 2; q += FACT_THREADS) {
    const int owner = (q >> kSliceShift) & mask;
    if (owner != rank) v4[q] = *cluster.map_shared_rank(v4 + q, owner);
  }
}

// The sum over the cluster's CTAs, in rank order from 0, of the NV
// floats each CTA posted at `slot` (the same shared memory offset in
// every CTA): every thread of every CTA receives bit-identical sums.  No
// barrier inside: the caller posts, passes a cluster barrier, then sums,
// and posts to the slot again only after another cluster barrier.
template <int NV>
__device__ __forceinline__ void cluster_rank_sum(const float* slot,
                                                 float (&v)[NV]) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
  for (int k = 0; k < NV; ++k) v[k] = 0.0f;
  const unsigned n = cluster.num_blocks();
  for (unsigned q = 0; q < n; ++q) {
    const float* s = cluster.map_shared_rank(slot, q);
#pragma unroll
    for (int k = 0; k < NV; ++k) v[k] += s[k];
  }
}

// TMA pieces (fact_bwd.cu's ring, the semiring pair's rings and gamma
// rows): an mbarrier in shared memory that bulk copies complete, and the
// copies.  One thread arms the barrier with
// the bytes to expect and issues the copies (cp.async.bulk, one per
// contiguous row); every thread that reads the stage first waits for the
// barrier's phase (parity) to complete.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar,
                                          unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
  // make the initialised barrier visible to the copy engine
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// An L2 policy for data read once: evicted first.
__device__ __forceinline__ unsigned long long evict_first_policy() {
  unsigned long long policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(policy));
  return policy;
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// device memory to this CTA's shared memory; the copy engine completes
// that many bytes of the transaction count of `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar,
                                          unsigned long long policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
      : "memory");
}

// Order this CTA's earlier generic-proxy accesses to shared memory
// before later copy-engine (async-proxy) ones: a stage read by every
// thread, then (after a barrier) overwritten by a bulk copy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// this CTA's shared memory to device memory, as one bulk copy of the
// issuing thread's current bulk group.  The threads that wrote the
// source fence their writes (fence_proxy_async) before the barrier after
// which one thread issues the copy.
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(
          dst),
      "r"(smem_addr(src)), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// Wait until the issuing thread's bulk groups have read their shared
// memory sources (the buffers may then be rewritten) ...
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// ... or have completed (before the CTA exits).
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Sum and max over a warp, every lane receiving the same bits (a
// butterfly: lane l adds x_l and x_{l^off}, commutative in IEEE
// arithmetic).
template <typename F>
__device__ __forceinline__ F warp_sum_all(F x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename F>
__device__ __forceinline__ F warp_max_all(F x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmax(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Dynamic shared memory above 48 KB must be asked for per kernel.
template <typename K>
__host__ inline cudaError_t fact_set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Launch configuration of n clusters of `cluster` CTAs of FACT_THREADS
// threads (grid n * cluster: CTAs q * cluster .. q * cluster + cluster - 1
// form cluster q).  attr (one entry) must outlive the launch.
__host__ inline cudaLaunchConfig_t cluster_config(int n, int cluster,
                                                  size_t smem, void* stream,
                                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * cluster, 1, 1);
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
