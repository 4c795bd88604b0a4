// Shared pieces of the port's kernels (fact_fwd.cu, fact_bwd.cu,
// stream_fwd.cu, stream_bwd.cu, semiring_fwd.cu, semiring_bwd.cu;
// viterbi.cu takes only fact_set_smem): block shape, deterministic
// block-wide, warp-wide and cluster-wide reductions, the sparse row
// products and the TMA pieces (bulk copies, mbarriers, bulk groups).
//
// Every kernel but the cluster pair gives one thread block to one batch
// column (sequence) and runs that column's whole time loop inside the
// block (B1/B2 also run a column on a cluster of C CTAs, at the end of
// this file); a thread owns the state rows
// s = threadIdx.x + k * FACT_THREADS (the semiring pair: k * blockDim.x,
// a block sized to the graph).
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
#include <cuda_bf16.h>
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
// 128-byte line, and each slot's gather
// v[col] is one shared-memory load of the warp, served in as many
// wavefronts as the fullest of the 32 banks (word c in bank c mod 32) has
// distinct words.  The order of a row's entries among its slots is the
// sum's order, fixed by the host:
// B1/B2 (fact_fwd.cu, fact_bwd.cu) read each row in bank order
// (fact_kernels.bank_order: each slot's lanes on distinct banks as far
// as a greedy pass finds, 1.41 / 1.36 wavefronts a slot for W1 / W1^T at
// the headline graph against 2.87 / 3.10 in ascending order); the cluster
// pair reads them in ascending column order (sell_row_dot_cols), since
// its gathers are G columns wide (8 or 16 bytes a lane), which the banks
// serve by another rule (ROADMAP.md queues an order for them).
//
// The fast mode (bfloat16 tiles, pallas_fact.py:848-854) rounds the
// operand of every off-diagonal product to bfloat16, whose values are
// bfloat16 (_WK.apply :190, :201); the diagonal stratum stays float32 with
// an unrounded operand (:180-186).  B1/B2 then read the off-diagonal
// entries alone, their bfloat16 values held in float32 (loading 2-byte
// values and widening each in this loop made fact_fwd 4% and fact_bwd 8%
// slower at the headline size, PERF.md), and the caller adds the diagonal
// term.  The vector v holds values already rounded to bfloat16, kept as
// float32: each is rounded once, when its owner writes it, not at each of
// its gathers (two conversions a slot in this loop, which takes about 60%
// of each kernel), and the 4-byte words keep the bank rule and the host's
// bank order valid.  A product of two bfloat16 values is exact in
// float32, so each fmaf rounds once, as the float32 sum of the TPU's
// matrix unit does.  Each row's owner keeps the unrounded value it needs
// for the diagonal and the carry (fact_fwd.cu, fact_bwd.cu).
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

// The stream element types of B1/B2: float32, or bfloat16 in the fast
// mode (pallas_fact.py stores the fwd->bwd streams in the tile dtype).
// x rounded to bfloat16 (to nearest even) and kept as float32; identity
// for the float32 mode.
template <typename S>
__device__ __forceinline__ float round_to(float x) {
  if constexpr (sizeof(S) == 2) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

// A stream entry written once and read once by the partner kernel:
// st.global.cs (evicted first), bfloat16 entries rounded to nearest even.
__device__ __forceinline__ void stream_put(float* p, float v) {
  __stcs(p, v);
}

__device__ __forceinline__ void stream_put(__nv_bfloat16* p, float v) {
  __stcs(reinterpret_cast<unsigned short*>(p),
         __bfloat16_as_ushort(__float2bfloat16_rn(v)));
}

// A stream entry read from device memory once (ld.global.cs) ...
__device__ __forceinline__ float stream_get(const float* p) {
  return __ldcs(p);
}

__device__ __forceinline__ float stream_get(const __nv_bfloat16* p) {
  const unsigned short h = __ldcs(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(h) << 16);
}

// ... or from shared memory, where a TMA ring put it.
__device__ __forceinline__ float smem_get(const float* p) { return *p; }

__device__ __forceinline__ float smem_get(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
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

// The bits of x rounded to bfloat16 (to nearest even).
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// The same for a bfloat16 stream (the fast mode): G consecutive entries,
// each rounded to nearest even, as one 8-, 4- or 2-byte store (p aligned
// to it; element 0 at the lowest address).
template <int G>
__device__ __forceinline__ void store_cols_stream(__nv_bfloat16* p,
                                                  const float (&v)[G]) {
  if constexpr (G == 4) {
    __stcs(reinterpret_cast<uint2*>(p),
           make_uint2(bf16_bits(v[0]) | bf16_bits(v[1]) << 16,
                      bf16_bits(v[2]) | bf16_bits(v[3]) << 16));
  } else if constexpr (G == 2) {
    __stcs(reinterpret_cast<unsigned*>(p),
           bf16_bits(v[0]) | bf16_bits(v[1]) << 16);
  } else {
    stream_put(p, v[0]);
  }
}

// sell_row_dot for G columns at once: row r of a sliced-ELL matrix times
// the G interleaved columns of v.  Each entry's column id and value,
// loaded once, feed G products (the graph is read once per G columns),
// each column's sum in sell_row_dot's order.  S = __nv_bfloat16 (the fast
// mode): v holds unrounded float32 values (the row's owner reads them so
// for the diagonal), and each gathered value is rounded to bfloat16 here,
// so that each fmaf adds an exact product, as in sell_row_dot.
template <int G, typename S = float>
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
    for (int g = 0; g < G; ++g) acc[g] = fmaf(w, round_to<S>(x[g]), acc[g]);
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

// Launch configuration of n clusters of `cluster` CTAs of `threads`
// threads (grid n * cluster: CTAs q * cluster .. q * cluster + cluster - 1
// form cluster q).  attr (one entry) must outlive the launch.
__host__ inline cudaLaunchConfig_t cluster_config(int n, int cluster,
                                                  size_t smem, void* stream,
                                                  cudaLaunchAttribute* attr,
                                                  int threads = FACT_THREADS) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n * cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
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

// The clusters of C CTAs of `smem` bytes that the card holds at once for
// `kernel` (cudaOccupancyMaxActiveClusters), or minus the CUDA error: the
// group forms' query (fact_fwd_group_active_clusters,
// fact_bwd_group_active_clusters) and their launches' check.
template <typename K>
__host__ inline int group_active_clusters(K kernel, size_t smem, int C) {
  cudaError_t err = fact_set_smem(kernel, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(1, C, smem, nullptr, attr);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  return err == cudaSuccess ? active : -static_cast<int>(err);
}

// ----------------------------------------------------------------------
// B1/B2 on a cluster (every form at C > 1)
// ----------------------------------------------------------------------
//
// One batch column on a cluster of C CTAs (C = 2 or 4) of NT threads.
// The 1024-thread block of the C = 1 kernel becomes 1024 "virtual
// threads": CTA r owns the virtual warps w with w mod C = r, i.e. the
// virtual threads v = cluster_row(j, r, C) for j < 1024 / C, and with
// them the state rows v, v + 1024, v + 2048, ... (all of one virtual
// thread's rows lie in one CTA, since C divides 32), which are the
// 32-row slices k = r (mod C) of the cluster pair's layout.  Each sum
// that crosses rows is then taken in the C = 1 kernel's order: every
// virtual thread adds its rows in turn on the CTA that owns them, each
// virtual warp's shuffle tree runs there, its total goes to every CTA's
// scratch at the warp's own index, and after a cluster barrier every CTA
// runs block_sum's cross-warp tree on the 32 totals: bit for bit the
// C = 1 kernel's sums, the same in every CTA.

// A cluster barrier split in two: arrive (release: this thread's writes,
// DSMEM stores included, are seen by every thread past the wait) and
// wait (acquire).  Work that neither needs the peers' writes nor is read
// by them can go between.  Also a barrier of the CTA's own threads.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_barrier() {
  cluster_arrive();
  cluster_wait();
}

// The SM this thread runs on (a debug launch records it).
__device__ __forceinline__ int sm_id() {
  int id;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
  return id;
}

// x at p (an offset in this CTA's shared memory) in this CTA and in each
// of its C - 1 peers (DSMEM stores, seen by the peers after the next
// cluster barrier).
__device__ __forceinline__ void cluster_put(float* p, float x, int rank,
                                            int C) {
  namespace cg = cooperative_groups;
  *p = x;
  for (int q = 1; q < C; ++q)
    *cg::this_cluster().map_shared_rank(p, (rank + q) & (C - 1)) = x;
}

// Post this CTA's virtual warp totals of the NV sums v to every CTA of
// the cluster (1 << lc CTAs): threads tid < V (= 1024 / C, whole warps)
// are the virtual threads, each warp's shuffle tree is block_sum's, and
// its total lands at red[w * NV + k] in every CTA, w the virtual warp.
// The caller then passes a cluster barrier and calls cluster_warp_total.
template <int NV>
__device__ __forceinline__ void cluster_post(const float (&v)[NV],
                                             float* red, int V, int rank,
                                             int lc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (static_cast<int>(threadIdx.x) >= V) return;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0) cluster_put(red + ((warp << lc) | rank) * NV + k, x, rank,
                               1 << lc);
  }
}

// block_sum's cross-warp tree on the 32 posted totals: every thread of
// every CTA receives the C = 1 kernel's sums in v.  Contains a
// __syncthreads().
template <int NV>
__device__ __forceinline__ void cluster_warp_total(float (&v)[NV],
                                                   float* red) {
  const int lane = threadIdx.x & 31;
  if ((threadIdx.x >> 5) == 0) {
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      float x = red[lane * NV + k];
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

// Both, with a cluster barrier between.
template <int NV>
__device__ __forceinline__ void cluster_block_sum(float (&v)[NV], float* red,
                                                  int V, int rank, int lc) {
  cluster_post<NV>(v, red, V, rank, lc);
  cluster_barrier();
  cluster_warp_total<NV>(v, red);
}

// The exchange without cluster barriers: a value stored into a peer's
// shared memory by st.async, which completes its 4 bytes on an mbarrier
// of that peer (at the same offset as `bar` here).  The receiver arms the
// barrier with the bytes its peers send it in one exchange
// (mbar_expect_tx) and waits on the phase's parity (mbar_wait_cluster);
// the store's completion releases at cluster scope and the wait acquires
// there, so the values are seen after the wait.  A store may land before
// the receiver arms the phase (the transaction count then runs below 0
// until the arming adds the bytes).
__device__ __forceinline__ unsigned cluster_map(const void* p, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_async(const float* p, float x, int rank,
                                         unsigned long long* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(cluster_map(p, rank)),
      "r"(__float_as_uint(x)), "r"(cluster_map(bar, rank))
      : "memory");
}

__device__ __forceinline__ void mbar_wait_cluster(unsigned long long* bar,
                                                  unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// cluster_put whose peer stores complete on `bar` in each peer.
__device__ __forceinline__ void cluster_put_async(float* p, float x, int rank,
                                                  int C,
                                                  unsigned long long* bar) {
  *p = x;
  for (int q = 1; q < C; ++q) st_async(p, x, (rank + q) & (C - 1), bar);
}

// A warp's 32 lanes each hold x for p, 32 consecutive floats of one
// 32-row slice (lane l at the slice's float l, the slice 16-byte
// aligned): each lane stores its own here, and lanes 0-7 gather four
// lanes' values each and store them into every peer as one 16-byte
// st.async, completing on `bar` there: 8 transactions a slice a peer, a
// quarter of one store a value.  Every lane of the warp calls it.
__device__ __forceinline__ void warp_put_async(float* p, float x, int rank,
                                               int C,
                                               unsigned long long* bar) {
  *p = x;
  const int lane = threadIdx.x & 31;
  float q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    q[k] = __shfl_sync(0xffffffffu, x, (4 * lane + k) & 31);
  if (lane >= 8) return;
  const float* dst = p - lane + 4 * lane;
  for (int r = 1; r < C; ++r) {
    const int peer = (rank + r) & (C - 1);
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
        "{%1, %2, %3, %4}, [%5];" ::"r"(cluster_map(dst, peer)),
        "r"(__float_as_uint(q[0])), "r"(__float_as_uint(q[1])),
        "r"(__float_as_uint(q[2])), "r"(__float_as_uint(q[3])),
        "r"(cluster_map(bar, peer))
        : "memory");
  }
}

// cluster_post whose peer stores complete on `bar` in each peer: the
// caller then passes a block barrier (this CTA's own totals), waits on
// `bar` and calls cluster_warp_total.  A peer receives
// (32 / C) NV floats from each CTA.
template <int NV>
__device__ __forceinline__ void cluster_post_async(const float (&v)[NV],
                                                   float* red, int V,
                                                   int rank, int lc,
                                                   unsigned long long* bar) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (static_cast<int>(threadIdx.x) >= V) return;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float x = v[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    if (lane == 0)
      cluster_put_async(red + ((warp << lc) | rank) * NV + k, x, rank,
                        1 << lc, bar);
  }
}

// Threads of a cluster CTA: a full block (at most two rows a thread at
// the headline graph at C = 2, where C = 1 has three).  1024 / C keeps
// the one-block kernel's threads a column; it was 6-29% slower at main
// path 7 in the lean forms (kernel_ablation.py, PERF.md), so is not built.
#define LEAN_CLUSTER_THREADS(C) 1024

// A cluster CTA's dynamic shared memory is at least this: 233,472 bytes
// an SM hold two CTAs of 115,712 bytes (each also takes a 1 KB reserve),
// so two CTAs of a cluster cannot share an SM (which would undo the
// split; at the headline graph a CTA needs about 49-61 KB).
#define LEAN_CLUSTER_MIN_SMEM 118784

// ----------------------------------------------------------------------
// The fast pair's group form (fact_fwd_bf16 and fact_bwd_bf16 where B is
// past C = 2's reach)
// ----------------------------------------------------------------------
//
// A group of G batch columns (G = 1, 2 or 4) on a cluster of C CTAs: CTA
// r owns the 32-row slices k = r (mod C) (cluster_row) in all G columns,
// holds its rows of the two operators its products read in shared memory
// for the whole launch, and each frame sends its rows of the vectors
// those products gather to its peers.  Every vector a product gathers
// holds bfloat16 values (the fast mode rounds each operand), so it is
// kept packed: a state's G values in G / 2 words, column 2j in the low
// half of word j and 2j + 1 in the high half.  At G = 1 a state keeps a
// word of its own, the value's float32 bits (low half 0), not two states
// a word: the host's bank order places each slot's 32 gathers on
// distinct 4-byte banks, which two states a word would undo.  So at G = 1
// and G = 2 a state is one 4-byte word, and the bank order holds for the
// gathers as it does for the one-block kernels.

// The words a state of a packed vector of G columns takes.
__host__ __device__ constexpr int packed_words(int G) {
  return G > 1 ? G / 2 : 1;
}

// An operator's slot as the group form holds it (fact_kernels.pack_slots;
// the cluster pair's packed layout reads its slots so from L2): the
// column id in the low 16 bits (S_pad <= 46,368 on either tier), the
// bfloat16 value's bits in the high 16, so that the value is the word
// with its low half cleared.
__device__ __forceinline__ int slot_col(unsigned w) {
  return static_cast<int>(w & 0xffffu);
}

__device__ __forceinline__ float slot_val(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

// sell_row_dot with each slot one 4-byte word (fact_kernels.pack_slots of
// the operator's bank-ordered slots, read from L2 in place of a column id
// and a float value: half the bytes): the same products in the same
// order, so the same sum bit for bit.  The fast mode's chunk backward in
// the ckpt mode's pair kernel reads W1^T and W2^T so (fact_ckpt.cu).
__device__ __forceinline__ float sell_row_dot_words(
    const int* __restrict__ sptr, const int* __restrict__ words, int r,
    const float* v) {
  const int lane = r & 31;
  const int slice = r >> 5;
  float acc = 0.0f;
  const int end = __ldg(sptr + slice + 1);
  for (int k = __ldg(sptr + slice); k < end; ++k) {
    const unsigned w =
        __ldg(reinterpret_cast<const unsigned*>(words) + k * 32 + lane);
    acc = fmaf(slot_val(w), v[slot_col(w)], acc);
  }
  return acc;
}

// The G values of state s of a packed vector.
template <int G>
__device__ __forceinline__ void load_packed(const unsigned* v, int s,
                                            float (&x)[G]) {
  static_assert(G == 1 || G == 2 || G == 4, "G is 1, 2 or 4");
  if constexpr (G == 1) {
    x[0] = __uint_as_float(v[s]);
  } else if constexpr (G == 2) {
    const unsigned w = v[s];
    x[0] = __uint_as_float(w << 16);
    x[1] = __uint_as_float(w & 0xffff0000u);
  } else {
    const uint2 w = reinterpret_cast<const uint2*>(v)[s];
    x[0] = __uint_as_float(w.x << 16);
    x[1] = __uint_as_float(w.x & 0xffff0000u);
    x[2] = __uint_as_float(w.y << 16);
    x[3] = __uint_as_float(w.y & 0xffff0000u);
  }
}

// G values that are bfloat16 values already (rounded by round_to), packed
// exactly into packed_words(G) words.
template <int G>
__device__ __forceinline__ void pack_cols(const float (&x)[G],
                                          unsigned (&w)[packed_words(G)]) {
  if constexpr (G == 1) {
    w[0] = __float_as_uint(x[0]);
  } else {
#pragma unroll
    for (int j = 0; j < G / 2; ++j)
      w[j] = (__float_as_uint(x[2 * j]) >> 16) |
             (__float_as_uint(x[2 * j + 1]) & 0xffff0000u);
  }
}

// G values rounded to bfloat16 (to nearest even, as round_to) and packed
// as state s of a packed vector.
template <int G>
__device__ __forceinline__ void store_packed(unsigned* v, int s,
                                             const float (&x)[G]) {
  static_assert(G == 2 || G == 4, "G is 2 or 4");
  if constexpr (G == 2) {
    v[s] = bf16_bits(x[0]) | bf16_bits(x[1]) << 16;
  } else {
    reinterpret_cast<uint2*>(v)[s] =
        make_uint2(bf16_bits(x[0]) | bf16_bits(x[1]) << 16,
                   bf16_bits(x[2]) | bf16_bits(x[3]) << 16);
  }
}

// The cluster pair's packed layout (stream_fwd_bf16 and stream_bwd_bf16
// at G = 2 or 4): sell_row_dot_cols with each slot one 4-byte word read
// from L2 (half the bytes of a column id and a float value) and the
// vector v packed (a state's G bfloat16 values in G / 2 words, so that a
// CTA holds twice the columns of a float32 copy).  The same products in
// the same order as sell_row_dot_cols<G, __nv_bfloat16> on the float32
// copy of v: a packed value is round_to's.
template <int G>
__device__ __forceinline__ void sell_row_dot_packed(
    const int* __restrict__ sptr, const unsigned* __restrict__ pack, int r,
    const unsigned* v, float (&acc)[G]) {
  const int lane = r & 31;
  const int slice = r >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.0f;
  const int end = __ldg(sptr + slice + 1);
  for (int k = __ldg(sptr + slice); k < end; ++k) {
    const unsigned w = __ldg(pack + k * 32 + lane);
    const float val = slot_val(w);
    float x[G];
    load_packed<G>(v, slot_col(w), x);
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = fmaf(val, x[g], acc[g]);
  }
}

// cluster_load_cols for a packed vector kept by local row (G / 2 words a
// state).
template <int G>
__device__ __forceinline__ void cluster_load_packed(const unsigned* v, int c,
                                                    int rank,
                                                    float (&out)[G]) {
  namespace cg = cooperative_groups;
  const unsigned* p = v + (c & CLUSTER_LOCAL_MASK) * (G / 2);
  const int owner = c >> CLUSTER_LOCAL_BITS;
  load_packed<G>(
      owner == rank ? p : cg::this_cluster().map_shared_rank(p, owner), 0,
      out);
}

// Local row i of this CTA times the G columns of the packed vector v:
// the operator's slots of the row's slice, slice j = i / 32 of this CTA,
// at ops[32 k + (i mod 32)] for lp[j] <= k < lp[j + 1], in the host's slot
// order (sell_row_dot's sum: each slot's word, loaded once, feeds the G
// columns' products, each column's sum in that order).
template <int G>
__device__ __forceinline__ void group_row_dot(const unsigned* ops,
                                              const int* lp, int i,
                                              const unsigned* v,
                                              float (&acc)[G]) {
  const int lane = i & 31;
  const int j = i >> 5;
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = 0.0f;
  const int end = lp[j + 1];
  for (int k = lp[j]; k < end; ++k) {
    const unsigned w = ops[k * 32 + lane];
    const float val = slot_val(w);
    float x[G];
    load_packed<G>(v, slot_col(w), x);
#pragma unroll
    for (int g = 0; g < G; ++g) acc[g] = fmaf(val, x[g], acc[g]);
  }
}

// Load this CTA's slices of a packed operator (sptr: the sliced-ELL slice
// pointers; pack: its slots, 32 words a slot) into shared memory: the
// local slice pointers lp (own slices + 1 ints, thread 0) and the slots,
// one warp a slice, 16 bytes a lane.  Returns nothing; the caller passes
// a block barrier before reading either.  Each slice is 128-byte
// aligned in both places.
__device__ __forceinline__ void group_load_ops(
    const int* __restrict__ sptr, const unsigned* __restrict__ pack,
    int s_pad, int rank, int C, int* lp, unsigned* ops) {
  const int own_slices = cluster_own_rows(s_pad, rank, C) >> 5;
  if (threadIdx.x == 0) {
    int at = 0;
    for (int j = 0; j < own_slices; ++j) {
      lp[j] = at;
      const int k = j * C + rank;
      at += __ldg(sptr + k + 1) - __ldg(sptr + k);
    }
    lp[own_slices] = at;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int j = threadIdx.x >> 5; j < own_slices; j += FACT_WARPS) {
    const int k = j * C + rank;
    const int lo = __ldg(sptr + k);
    const int n = (__ldg(sptr + k + 1) - lo) * 8;   // 16-byte pieces
    const uint4* src = reinterpret_cast<const uint4*>(pack) + lo * 8;
    uint4* dst = reinterpret_cast<uint4*>(ops) + lp[j] * 8;
    for (int q = lane; q < n; q += 32) dst[q] = __ldg(src + q);
  }
}

// A warp's 32 lanes each hold the W words of one state of a 32-row slice
// of a packed vector (the slice at `slice`, 16-byte aligned; lane l's
// words at slice[W l .. W l + W - 1]): each lane stores its own here, and
// lanes q < 8 W gather the slice's words 4 q .. 4 q + 3 and store them
// into every peer as one 16-byte st.async, completing on `bar` there (a
// peer receives 128 W bytes a slice).  Every lane of the warp calls it.
template <int W>
__device__ __forceinline__ void warp_put_words_async(unsigned* slice,
                                                     const unsigned (&w)[W],
                                                     int rank, int C,
                                                     unsigned long long* bar) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < W; ++j) slice[lane * W + j] = w[j];
  unsigned q[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    q[k] = __shfl_sync(0xffffffffu, w[k % W], (4 * lane / W + k / W) & 31);
  if (lane >= 8 * W) return;
  const unsigned* dst = slice + 4 * lane;
  for (int r = 1; r < C; ++r) {
    const int peer = (rank + r) & (C - 1);
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], "
        "{%1, %2, %3, %4}, [%5];" ::"r"(cluster_map(dst, peer)),
        "r"(q[0]), "r"(q[1]), "r"(q[2]), "r"(q[3]),
        "r"(cluster_map(bar, peer))
        : "memory");
  }
}

// The words of the group form's scratch of NV sums: the 32 posted warp
// totals and block_sum's output (cluster_warp_total), a 16-byte multiple.
__host__ __device__ inline int group_red_words(int nv) {
  return (33 * nv + 3) & ~3;
}

// The ints of a CTA's local slice pointers of one operator: its slices
// (at most rank 0's) + 1, a 16-byte multiple.
__host__ __device__ inline int group_lp_words(int s_pad, int C) {
  return ((s_pad / 32 + C - 1) / C + 1 + 3) & ~3;
}

// Asynchronous copies from device memory to shared memory (cp.async,
// LDGSTS): the thread goes on; its copies land by cp_async_wait_all, and
// a block barrier after it shows them to the other threads.  4 bytes
// through L1 (a gather of x), 16 bytes through L2 alone (a stream read
// once); both addresses aligned to the size.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// cluster_warp_total with every warp taking block_sum's cross-warp tree
// on the 32 posted totals itself (the same bits in every warp): no block
// barrier.  The caller's next exchange may only follow every warp's
// reads of red (a peer's next post needs this CTA's sends that follow
// them).
template <int NV>
__device__ __forceinline__ void cluster_warp_total_all(float (&v)[NV],
                                                       const float* red) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float x = red[lane * NV + k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      x += __shfl_down_sync(0xffffffffu, x, off);
    v[k] = __shfl_sync(0xffffffffu, x, 0);
  }
}
