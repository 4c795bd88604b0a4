// Log-semiring alpha sweep of a batch of arbitrary graphs.
//
// Replaces the three TPU forward kernels that compute this recurrence:
// pychain_tpu/ops/pallas_semiring.py::_fwd_kernel (B5, dense one-hots),
// pychain_tpu/ops/semiring_xl.py::_fwd_kernel (B7, resident per-graph
// masks) and ::_fwd_kernel_stream (B9, masks per arc chunk).  They
// differ only in how TPU VMEM holds the arc incidence; here the arcs stay
// id lists, so one kernel serves every size.  Per frame t < T_b of
// sequence b, in the select-free normalised-linear form of
// pallas_semiring.py:18-36 (alpha n sums to 1):
//
//   a[d] = sum_{k in in(d)} n[src[k]] * warc[b, t, k]
//   raw  = sum_d a[d]              n = a * (1 / max(raw, TINY))
//
// with warc = exp(logp + x[pdf] - c_t) (float) computed outside (the JAX
// wrappers do the same outside pallas_call).  It writes n (the alpha
// stream the backward sweep reads), raw (the objective is log raw + c_t
// summed), and n at frame T_b - 1 (alpha(T_b)).  It stops at T_b: stream
// rows past it are never written, and raw reads exactly 1.0 there.
//
// Precision.  The TPU kernels carry alpha in float32.  On flat-start
// numerators at T = 500 the posterior's states sit so far below alpha's
// scale that float32 loses their mass: gamma was up to 1.7e-2 from a
// float64 run of the same recurrence, 2 of 32 sequences over 1e-4
// (PERF.md).  The H100 has the double rate this latency-bound
// sweep needs, so alpha, a and raw are double; the weights stay float.
//
// Design.  One block per sequence runs its whole time loop (at B = 128
// each sequence has an SM to itself, so packing sequences into a block
// would only idle SMs).  A frame is a chain of latencies, and the design
// shortens it (PERF.md):
// - the block is sized to the graph: the multiple of 32 threads that
//   covers S_pad, at most 1024 (semiring_kernels.plan); thread tid owns
//   the states d = tid + k * blockDim.x;
// - the unnormalised a lives in two parity buffers in shared memory, and
//   normalisation moves to the reader: frame t gathers
//   a_{t-1}[src] * inv_{t-1} (the parent's n[src], bit for bit), and the
//   owner writes the normalised row t - 1 of the stream off the critical
//   path.  Each warp posts its partial sum of raw into a parity slot;
//   after the frame's single __syncthreads every warp sums the slots
//   itself (warp_sum_all), in warp order, so every thread holds the same
//   raw and no second barrier or normalising pass is needed;
// - `resident`: the in-lists (offsets, and (source << 16 | arc) pairs by
//   destination, ascending arc order) are copied into shared memory
//   before the time loop, so no id is read from device memory inside it;
// - `stages` > 0: thread 0 fetches the warc rows `stages` frames ahead
//   into a ring in shared memory, one bulk copy (TMA, evicted first) a
//   row, completing on the stage's mbarrier (the row stride kw is a
//   multiple of 4 floats: the wrapper pads it).  After the frame's
//   barrier the stage is read, and thread 0 refills it behind a proxy
//   fence.
// The host picks the layout from the shapes (semiring_kernels.plan):
// the resident lists and the ring where they fit a block's shared
// memory, else the rows and lists from device memory.  Every sum has a
// fixed order (a state's in-arcs in ascending arc order, lanes by a
// butterfly, warps in order), so results do not change from run to run
// and no atomics are used.  A dead sequence (raw = 0) keeps exact zeros.
//
// Bound on an H100 (chip_smoke.py prints it for each size class): the
// sweep must read warc (B, T, K_pad) once and write the (B, T, S_pad)
// double stream, so it is bound by bytes; at the flat-start headline
// batch (B = 128, T = 500, K_pad = 300, S_pad = 151) that is about
// 0.16 GB, under 0.05 ms at 3.35 TB/s.  A frame of so small a graph is
// far below what fills an SM: the kernel runs a chain of shared-memory
// loads, one warp reduction pair and one barrier a frame, 500 times in a
// row.

#include "fact_common.cuh"

#define SR_TINY 1e-37

// RESIDENT: the in-lists in shared memory; RING: the warc rows through
// the TMA ring (`stages` > 0).  Templates, so that every shared-memory
// access compiles to a shared-memory load.
template <bool RESIDENT, bool RING>
__global__ void __launch_bounds__(FACT_THREADS, 1) semiring_fwd_kernel(
    const int* __restrict__ lengths,   // (B,)  1 <= T_b <= T
    const float* __restrict__ warc,    // (B, T, kw) arc weights, max-shifted
    const double* __restrict__ n0,     // (B, S) initial probs, sum 1
    const int* __restrict__ in_ptr,    // (B, S + 1) in-arc list offsets
    const int* __restrict__ in_pack,   // (B, K) src << 16 | arc, by dst
    int T, int K, int kw, int S, int sw, int stages,
    double* __restrict__ n_ys,         // (B, T, sw) alpha(t + 1), t < T_b
    double* __restrict__ raw_ys,       // (B, T) raw sums; 1 past T_b
    double* __restrict__ n_last) {     // (B, S) alpha(T_b)
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);     // stages x kw
  unsigned long long* bar =                          // one a stage
      reinterpret_cast<unsigned long long*>(ring + stages * kw);
  double* abuf = reinterpret_cast<double*>(bar + stages);  // 2 x S: a
  double* red = abuf + 2 * S;                        // 2 x 32 warp sums
  int* lptr = reinterpret_cast<int*>(red + 2 * 32);  // S + 1 (resident)
  int* lpack = lptr + S + 1;                         // K (resident)

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int b = blockIdx.x;
  const int Tb = lengths[b];
  const size_t row0 = static_cast<size_t>(b) * T;
  const int* ptr_g = in_ptr + static_cast<size_t>(b) * (S + 1);
  const int* pack_g = in_pack + static_cast<size_t>(b) * K;
  const int* ptr = ptr_g;
  const int* pack = pack_g;
  if (RESIDENT) {
    for (int i = tid; i <= S; i += nthr) lptr[i] = ptr_g[i];
    const int n_in = ptr_g[S];
    for (int i = tid; i < n_in; i += nthr) lpack[i] = pack_g[i];
    ptr = lptr;
    pack = lpack;
  }

  // frame t reads its warc row from stage t % stages
  const unsigned long long policy = RING ? evict_first_policy() : 0ull;
  const unsigned row_bytes = 4u * static_cast<unsigned>(kw);
  auto fetch = [&](int t) {
    const int k = t % stages;
    mbar_expect_tx(bar + k, row_bytes);
    bulk_load(ring + k * kw, warc + (row0 + t) * kw, row_bytes, bar + k,
              policy);
  };
  if (RING && tid == 0) {
    for (int k = 0; k < stages; ++k) mbar_init(bar + k, 1);
    for (int k = 0; k < stages && k < Tb; ++k) fetch(k);
  }
  // frame 0 gathers a_{-1} * inv_{-1} = n0 * 1.0 = n0
  for (int s = tid; s < S; s += nthr)
    abuf[S + s] = n0[static_cast<size_t>(b) * S + s];
  double inv = 1.0;
  __syncthreads();

  for (int t = 0; t < Tb; ++t) {
    const int cur = t & 1;
    const double* a_prev = abuf + (cur ^ 1) * S;
    double* a_cur = abuf + cur * S;
    const float* w;
    if (RING) {
      mbar_wait(bar + t % stages, (t / stages) & 1);
      w = ring + (t % stages) * kw;
    } else {
      w = warc + (row0 + t) * kw;
    }
    double* out_prev = t > 0 ? n_ys + (row0 + t - 1) * sw : nullptr;
    double part = 0.0;
    for (int d = tid; d < S; d += nthr) {
      double acc = 0.0;
      const int end = ptr[d + 1];
      for (int j = ptr[d]; j < end; ++j) {
        const int pk = pack[j];
        acc += (a_prev[pk >> 16] * inv) *
               static_cast<double>(w[pk & 0xffff]);
      }
      a_cur[d] = acc;
      part += acc;
      if (t > 0) __stcs(out_prev + d, a_prev[d] * inv);
    }
    part = warp_sum_all(part);
    if (lane == 0) red[cur * 32 + warp] = part;
    // the frame's one barrier: a_cur and the warp sums complete, a_prev
    // and the stage read
    __syncthreads();
    if (RING && tid == 0 && t + stages < Tb) {
      fence_proxy_async();
      fetch(t + stages);
    }
    const double raw =
        warp_sum_all(lane < nwarps ? red[cur * 32 + lane] : 0.0);
    if (tid == 0) raw_ys[row0 + t] = raw;
    inv = 1.0 / fmax(raw, SR_TINY);
  }
  // row T_b - 1 and alpha(T_b)
  const double* a_last = abuf + ((Tb - 1) & 1) * S;
  double* out = n_ys + (row0 + Tb - 1) * sw;
  for (int d = tid; d < S; d += nthr) {
    const double v = a_last[d] * inv;
    __stcs(out + d, v);
    n_last[static_cast<size_t>(b) * S + d] = v;
  }
  for (int t = Tb + tid; t < T; t += nthr) raw_ys[row0 + t] = 1.0;
}

extern "C" size_t semiring_fwd_smem_bytes(int S, int K, int kw, int stages,
                                          int resident) {
  return static_cast<size_t>(stages) * (4 * static_cast<size_t>(kw) + 8) +
         16 * static_cast<size_t>(S) + 2 * 32 * 8 +
         (resident ? 4 * (static_cast<size_t>(S) + 1 + K) : 0);
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int semiring_fwd_launch(
    const void* lengths, const void* warc, const void* n0,
    const void* in_ptr, const void* in_pack, int B, int T, int K, int kw,
    int S, int sw, int threads, int stages, int resident, void* n_ys,
    void* raw_ys, void* n_last, void* stream) {
  const size_t smem = semiring_fwd_smem_bytes(S, K, kw, stages, resident);
  auto kernel = resident ? (stages ? semiring_fwd_kernel<true, true>
                                   : semiring_fwd_kernel<true, false>)
                         : (stages ? semiring_fwd_kernel<false, true>
                                   : semiring_fwd_kernel<false, false>);
  cudaError_t err = fact_set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lengths), static_cast<const float*>(warc),
      static_cast<const double*>(n0), static_cast<const int*>(in_ptr),
      static_cast<const int*>(in_pack), T, K, kw, S, sw, stages,
      static_cast<double*>(n_ys), static_cast<double*>(raw_ys),
      static_cast<double*>(n_last));
  return static_cast<int>(cudaGetLastError());
}
