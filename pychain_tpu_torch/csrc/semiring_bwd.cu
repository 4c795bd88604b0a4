// Log-semiring beta sweep, arc occupancies and gamma of a batch of
// arbitrary graphs.
//
// Replaces the three TPU backward kernels that compute this recurrence:
// pychain_tpu/ops/pallas_semiring.py::_bwd_kernel (B6, dense one-hots),
// pychain_tpu/ops/semiring_xl.py::_bwd_kernel (B8, resident masks) and
// ::_bwd_kernel_stream (B10, masks per arc chunk), and the gamma
// contraction the JAX wrappers run after them (_gamma_from_occ,
// gamma_chunked).  Per frame u from T_b - 1 down to 0 of sequence b
// (pallas_semiring.py:149-188; beta r is normalised to max 1 and its log
// scale carried in m):
//
//   r_eff = rf at u = T_b - 1 (the final-frame injection), else r;
//   m_eff likewise mf, else m
//   vf[k] = warc[b, u, k] * r_eff[dst[k]]
//   b[s]  = sum_{k in out(s)} vf[k]
//   occ[k] = exp(min(log alpha_u[src[k]] + log vf[k] + m_eff + c_row[u], 80))
//   alpha_beta[u] = sum_k occ[k]                          (B8's form)
//   gamma[b, u, p] = sum_{k in arcs(p)} occ[k]
//   r = b / max(max_s b, TINY);  m = m_eff + cms[u] + log(max(max_s b, TINY))
//
// alpha_u is alpha(u): n0 at u = 0, else row u - 1 of the forward's
// stream (a row the forward wrote, since u - 1 < T_b - 1).  Frames u >= T_b
// get exact zeros without reading any stream row; pdfs no arc emits get
// exact zeros.  A dead sequence arrives with rf = 0 and keeps zeros.
//
// Precision.  As in semiring_fwd.cu the carries (r, b, m) and the
// occupancies are double, with float weights in and float gamma and
// trace out: in float32 the TPU form loses whole frames of gamma on long
// sequences, where alpha and beta each sit far below their own scale on
// the posterior's states and their product underflows
// (tests/test_torch_semiring.py,
// test_long_flat_start_keeps_every_frame_of_gamma), and the log scale m
// drifts.  occ is assembled in log space, as the JAX package's XLA engine
// does (semiring.py:222-225), so no range limit is left on the product;
// in exact arithmetic it is the TPU kernels' number.
//
// Design.  One block per sequence; r_eff, the new b and the frame's arc
// occupancies live in shared memory (2 S_pad + K_pad doubles).  A thread
// owns the states s = tid + k * FACT_THREADS and walks each state's
// out-arcs, so it computes vf, b[s], occ and its share of the trace
// without a separate per-arc pass (alpha_u[src[k]] = alpha_u[s] there,
// so log alpha is taken once per state).  After one block reduction (sum
// and max), gamma is summed per pdf over host-built per-graph pdf -> arc
// lists in ascending arc order: gamma is deterministic, with no atomics
// (docs/PARITY.md:52-55).
//
// Bound on an H100: the sweep must read warc (B, T, K_pad) and the alpha
// stream (B, T, S_pad) once and write gamma (B, T, P); at the flat-start
// headline batch (B = 128, T = 500, K_pad = 300, S_pad = 151, P = 3000)
// gamma's 0.77 GB dominate: about 0.93 GB, 0.28 ms at 3.35 TB/s.  As in
// the forward sweep, a frame is latency-bound long before that.

#include "fact_common.cuh"

#define SR_TINY 1e-37
#define SR_EXP_CLAMP 80.0

__global__ void __launch_bounds__(FACT_THREADS, 1) semiring_bwd_kernel(
    const int* __restrict__ lengths,   // (B,)  1 <= T_b <= T
    const float* __restrict__ warc,    // (B, T, K)
    const double* __restrict__ n_ys,   // (B, T, S) forward alpha stream
    const double* __restrict__ n0,     // (B, S) alpha(0)
    const int* __restrict__ dst,       // (B, K) destination of each arc
    const int* __restrict__ out_ptr,   // (B, S + 1) out-arc list offsets
    const int* __restrict__ out_arcs,  // (B, K) arc ids by source
    const int* __restrict__ pdf_ptr,   // (B, n_lists + 1) pdf list offsets
    const int* __restrict__ pdf_arcs,  // (B, K) arc ids by pdf
    const double* __restrict__ rf,     // (B, S) injected final beta
    const double* __restrict__ mf,     // (B,) its log scale
    const double* __restrict__ c_row,  // (B, T) c_u (+ lz0 at u = 0)
    const double* __restrict__ cms,    // (B, T) c_u - s_{u-1}
    int n_lists, int T, int K, int S, int P,
    float* __restrict__ gamma,         // (B, T, P)
    float* __restrict__ ab) {          // (B, T) alpha * beta trace
  extern __shared__ double smem[];
  double* r = smem;         // beta carry (max 1), gathered by arcs
  double* bl = r + S;       // this frame's b, read by its owner only
  double* occ = bl + S;     // this frame's arc occupancies, by arc id
  double* red = occ + K;    // block_sum_max scratch

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int Tb = lengths[b];
  const size_t rows = static_cast<size_t>(b) * T;
  const int* dst_b = dst + static_cast<size_t>(b) * K;
  const int* optr_b = out_ptr + static_cast<size_t>(b) * (S + 1);
  const int* oarcs_b = out_arcs + static_cast<size_t>(b) * K;
  const int* pptr_b = pdf_ptr + static_cast<size_t>(b) * (n_lists + 1);
  const int* parcs_b = pdf_arcs + static_cast<size_t>(b) * K;
  const int n_p = n_lists < P ? n_lists : P;

  // frames past the end: exact zeros
  const size_t past = static_cast<size_t>(T - Tb) * P;
  float* g_past = gamma + (rows + Tb) * P;
  for (size_t i = tid; i < past; i += FACT_THREADS) g_past[i] = 0.0f;
  for (int u = Tb + tid; u < T; u += FACT_THREADS) ab[rows + u] = 0.0f;

  for (int s = tid; s < S; s += FACT_THREADS)
    r[s] = rf[static_cast<size_t>(b) * S + s];
  double m_eff = mf[b];
  __syncthreads();

  for (int u = Tb - 1; u >= 0; --u) {
    const float* w = warc + (rows + u) * K;
    const double* a_u = u == 0 ? n0 + static_cast<size_t>(b) * S
                               : n_ys + (rows + u - 1) * S;
    const double scale = m_eff + c_row[rows + u];
    double trace = 0.0, mx = 0.0;
    for (int s = tid; s < S; s += FACT_THREADS) {
      const double la = log(a_u[s]);     // -inf where alpha is 0
      double acc = 0.0;
      const int end = __ldg(optr_b + s + 1);
      for (int j = __ldg(optr_b + s); j < end; ++j) {
        const int k = __ldg(oarcs_b + j);
        const double v =
            static_cast<double>(__ldg(w + k)) * r[__ldg(dst_b + k)];
        acc += v;
        const double o = exp(fmin(la + log(v) + scale, SR_EXP_CLAMP));
        occ[k] = o;
        trace += o;
      }
      bl[s] = acc;
      mx = fmax(mx, acc);
    }
    // also the barrier after which r may be overwritten and occ read
    block_sum_max(trace, mx, red);
    if (tid == 0) ab[rows + u] = static_cast<float>(trace);
    const double inv = 1.0 / fmax(mx, SR_TINY);
    for (int s = tid; s < S; s += FACT_THREADS) r[s] = bl[s] * inv;
    m_eff = m_eff + cms[rows + u] + log(fmax(mx, SR_TINY));

    float* g_u = gamma + (rows + u) * P;
    for (int p = tid; p < P; p += FACT_THREADS) {
      double acc = 0.0;
      if (p < n_p) {
        const int end = __ldg(pptr_b + p + 1);
        for (int j = __ldg(pptr_b + p); j < end; ++j)
          acc += occ[__ldg(parcs_b + j)];
      }
      g_u[p] = static_cast<float>(acc);
    }
    __syncthreads();   // r complete and occ read before the next frame
  }
}

extern "C" size_t semiring_bwd_smem_bytes(int S, int K) {
  return (2 * static_cast<size_t>(S) + K + 2 * FACT_WARPS + 2) *
         sizeof(double);
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int semiring_bwd_launch(
    const void* lengths, const void* warc, const void* n_ys, const void* n0,
    const void* dst, const void* out_ptr, const void* out_arcs,
    const void* pdf_ptr, const void* pdf_arcs, const void* rf,
    const void* mf, const void* c_row, const void* cms, int n_lists, int B,
    int T, int K, int S, int P, void* gamma, void* ab, void* stream) {
  const size_t smem = semiring_bwd_smem_bytes(S, K);
  cudaError_t err = fact_set_smem(semiring_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  semiring_bwd_kernel<<<B, FACT_THREADS, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lengths), static_cast<const float*>(warc),
      static_cast<const double*>(n_ys), static_cast<const double*>(n0),
      static_cast<const int*>(dst), static_cast<const int*>(out_ptr),
      static_cast<const int*>(out_arcs), static_cast<const int*>(pdf_ptr),
      static_cast<const int*>(pdf_arcs), static_cast<const double*>(rf),
      static_cast<const double*>(mf), static_cast<const double*>(c_row),
      static_cast<const double*>(cms), n_lists, T, K, S, P,
      static_cast<float*>(gamma), static_cast<float*>(ab));
  return static_cast<int>(cudaGetLastError());
}
