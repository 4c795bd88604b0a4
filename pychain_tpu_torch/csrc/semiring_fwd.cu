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
// Design.  One block per sequence runs its whole time loop; the carry n
// and the unnormalised a live in shared memory (2 S_pad doubles).  A
// thread owns the states d = tid + k * FACT_THREADS and sums each state's
// in-arcs over a host-built list in ascending arc order, then the block
// sums raw in a fixed order (block_sum): the result does not change from
// run to run, and no atomics are used.  A dead sequence (raw = 0) keeps
// exact zeros from then on.
//
// Bound on an H100 (chip_smoke.py prints it for each size class): the
// sweep must read warc (B, T, K_pad) once and write the (B, T, S_pad)
// double stream, so it is bound by bytes; at the flat-start headline
// batch (B = 128, T = 500, K_pad = 300, S_pad = 151) that is about
// 0.16 GB, under 0.05 ms at 3.35 TB/s.  A frame of so small a graph is
// far below what fills an SM: the kernel waits on the latency of each
// frame's warc loads and three barriers, 500 times in a row.  That is the
// first thing a faster version must attack (several sequences per block,
// or frames prefetched), not the bytes.

#include "fact_common.cuh"

#define SR_TINY 1e-37

__global__ void __launch_bounds__(FACT_THREADS, 1) semiring_fwd_kernel(
    const int* __restrict__ lengths,   // (B,)  1 <= T_b <= T
    const float* __restrict__ warc,    // (B, T, K) arc weights, max-shifted
    const double* __restrict__ n0,     // (B, S) initial probs, sum 1
    const int* __restrict__ src,       // (B, K) source state of each arc
    const int* __restrict__ in_ptr,    // (B, S + 1) in-arc list offsets
    const int* __restrict__ in_arcs,   // (B, K) arc ids by destination
    int T, int K, int S,
    double* __restrict__ n_ys,         // (B, T, S) alpha(t + 1), t < T_b
    double* __restrict__ raw_ys,       // (B, T) raw sums; 1 past T_b
    double* __restrict__ n_last) {     // (B, S) alpha(T_b)
  extern __shared__ double smem[];
  double* n = smem;        // normalised alpha carry, gathered by arcs
  double* a = n + S;       // unnormalised alpha, read by its owner only
  double* red = a + S;     // block_sum scratch

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int Tb = lengths[b];
  const int* src_b = src + static_cast<size_t>(b) * K;
  const int* ptr_b = in_ptr + static_cast<size_t>(b) * (S + 1);
  const int* arcs_b = in_arcs + static_cast<size_t>(b) * K;

  for (int s = tid; s < S; s += FACT_THREADS)
    n[s] = n0[static_cast<size_t>(b) * S + s];
  __syncthreads();

  for (int t = 0; t < Tb; ++t) {
    const size_t row = static_cast<size_t>(b) * T + t;
    const float* w = warc + row * K;
    double part[1] = {0.0};
    for (int d = tid; d < S; d += FACT_THREADS) {
      double acc = 0.0;
      const int end = __ldg(ptr_b + d + 1);
      for (int j = __ldg(ptr_b + d); j < end; ++j) {
        const int k = __ldg(arcs_b + j);
        acc += n[__ldg(src_b + k)] * static_cast<double>(__ldg(w + k));
      }
      a[d] = acc;
      part[0] += acc;
    }
    // also the barrier after which n may be overwritten
    block_sum<1>(part, red);
    const double raw = part[0];
    const double inv = 1.0 / fmax(raw, SR_TINY);
    double* out = n_ys + row * S;
    for (int d = tid; d < S; d += FACT_THREADS) {
      const double v = a[d] * inv;
      n[d] = v;
      out[d] = v;
      if (t == Tb - 1) n_last[static_cast<size_t>(b) * S + d] = v;
    }
    if (tid == 0) raw_ys[row] = raw;
    __syncthreads();   // n complete before the next frame gathers it
  }
  for (int t = Tb + tid; t < T; t += FACT_THREADS)
    raw_ys[static_cast<size_t>(b) * T + t] = 1.0;
}

extern "C" size_t semiring_fwd_smem_bytes(int S) {
  return (2 * static_cast<size_t>(S) + FACT_WARPS + 1) * sizeof(double);
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int semiring_fwd_launch(
    const void* lengths, const void* warc, const void* n0, const void* src,
    const void* in_ptr, const void* in_arcs, int B, int T, int K, int S,
    void* n_ys, void* raw_ys, void* n_last, void* stream) {
  const size_t smem = semiring_fwd_smem_bytes(S);
  cudaError_t err = fact_set_smem(semiring_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  semiring_fwd_kernel<<<B, FACT_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lengths), static_cast<const float*>(warc),
      static_cast<const double*>(n0), static_cast<const int*>(src),
      static_cast<const int*>(in_ptr), static_cast<const int*>(in_arcs),
      T, K, S, static_cast<double*>(n_ys), static_cast<double*>(raw_ys),
      static_cast<double*>(n_last));
  return static_cast<int>(cudaGetLastError());
}
