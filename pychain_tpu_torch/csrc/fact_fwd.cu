// Denominator alpha sweep on the factorized graph (float32).
//
// Replaces pychain_tpu/ops/pallas_fact.py::_fwd_kernel_factory (launched
// there by _fwd_pallas), in its float32 "parity" precision and "full"
// stream mode.  Per frame t of column b (the reference's "version 3"
// recurrence, chain-computation.h:109-155):
//
//   x_dst = px_t[f_dst]            x_src = px_t[g_src]  (= x_dst in
//                                                        identity mode)
//   alpha = (x_dst * (W1 alpha') + W2 (x_src * alpha')) / s_{t-1}
//   s_t = sum(alpha)               alpha' = alpha + c * s_t * leaky
//
// and it writes the streams the backward sweep reads: alpha'(t+1),
// W1 alpha'(t), x_dst(t) (and x_src(t) outside identity mode), all
// (B, T, S_pad), plus s_t (B, T) and alpha' at the column's last frame.
//
// Design.  The TPU kernel multiplied W1's dense block (1664 x 1536 at the
// headline graph, under 2% nonzero) on its matrix unit.  Here W1 and W2
// are sparse rows over their nonzeros (the graph's 49.5k arcs), so the
// arithmetic is that of the arcs, and the one-hot E_f / E_g products
// are gathers through f_dst / g_src.  The rows are stored as sliced ELL
// (sell_row_dot, fact_common.cuh) so that a warp's loads of them are
// whole 128-byte lines, each row's entries in bank order: the host
// orders them among their slots so that a slot's 32 gathers from
// shared memory hit distinct banks (1.41 wavefronts a slot for W1 at
// the headline graph, 2.87 in ascending order; 3-7% of the kernel's
// time, PERF.md).  One block owns one batch column
// and runs its whole time loop, stopping at the column's own length:
// nothing is computed or written for frames past it (the backward
// sweep never reads them).  The carry alpha' and the W2 operand live in
// shared memory; each thread sums its own rows in a fixed order.
//
// Bound on an H100 at the headline size (S_pad = 3072, P = 3000,
// B = 128, T = 500): the sweep must read px once (0.77 GB) and write
// three (T, S_pad, B) float32 streams (2.36 GB): about 3.1 GB, 0.94 ms
// at 3.35 TB/s.  The arc products are 2 * 49.5k * B * T = 6.3 GFLOP,
// 0.09 ms at 67 TFLOP/s (float32 without tensor cores).  So the bound
// is the bytes.  The stream writes are coalesced (consecutive threads,
// consecutive states), written once and evicted first (__stcs).  What
// the kernel spends (kernel_ablation.py, PERF.md): the sparse products
// 62%, the emission gathers 14-16%.  On the wavefront model (the SM's L1 /
// shared-memory pipe at one wavefront a clock) the products need about
// 6,400 wavefronts a frame: W1's and W2's rows (about 0.48 MB, read from
// L2 by every block at every frame, two 128-byte lines a slot-warp) and
// the gathers; they take about 5.8 us a frame where that is 3.6 us.  The
// bank order saved 0.36 ms where the model predicted 0.9, and a search
// that took off 491 more gather wavefronts a frame saved nothing, so the
// model is not the whole bound (PERF.md, open questions).  Fetching the
// next frame's px row by TMA and gathering from shared memory was 6%
// slower (PERF.md).

#include "fact_common.cuh"

__global__ void __launch_bounds__(FACT_THREADS, 1) fact_fwd_kernel(
    const float* __restrict__ px,        // (B, T, P) exp'd nnet output
    const int* __restrict__ lengths,     // (B,)  1 <= T_b <= T
    const int* __restrict__ f_dst,       // (S_pad,) pdf of each state's W1 term
    const int* __restrict__ g_src,       // (S_pad,) or null (identity mode)
    const int* __restrict__ w1_ptr, const int* __restrict__ w1_col,
    const float* __restrict__ w1_val,    // W1 by destination row
    const int* __restrict__ w2_ptr, const int* __restrict__ w2_col,
    const float* __restrict__ w2_val,    // W2 by destination row
    const float* __restrict__ ad0,       // (S_pad,) alpha'(0)
    const float* __restrict__ s0,        // (1,) sum of the initial probs
    const float* __restrict__ leaky,     // (S_pad,)
    float leaky_c, int T, int P, int s_pad,
    float* __restrict__ ad_ys,           // (B, T, S_pad) alpha'(t+1)
    float* __restrict__ w1ad_ys,         // (B, T, S_pad) W1 alpha'(t)
    float* __restrict__ xdst_ys,         // (B, T, S_pad)
    float* __restrict__ xsrc_ys,         // (B, T, S_pad) or null
    float* __restrict__ s_ys,            // (B, T) s_{t+1}; 1 past the end
    float* __restrict__ ad_last) {       // (B, S_pad) alpha'(T_b)
  extern __shared__ float smem[];
  float* ad = smem;            // alpha' carry: gathered by W1's rows
  float* u = ad + s_pad;       // x_src * alpha': gathered by W2's rows
  float* xd = u + s_pad;       // x_dst(t), read by the row's owner only
  float* a = xd + s_pad;       // alpha(t) before the leaky term, ditto
  float* red = a + s_pad;      // block_sum scratch

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int Tb = lengths[b];
  const size_t row0 = static_cast<size_t>(b) * T;

  for (int s = tid; s < s_pad; s += FACT_THREADS) ad[s] = ad0[s];
  float s_prev = *s0;

  for (int t = 0; t < Tb; ++t) {
    const float* px_t = px + (row0 + t) * P;
    const size_t o = (row0 + t) * s_pad;
    for (int s = tid; s < s_pad; s += FACT_THREADS) {
      const float x = __ldg(px_t + f_dst[s]);
      const float xs = g_src ? __ldg(px_t + g_src[s]) : x;
      xd[s] = x;
      u[s] = xs * ad[s];
      __stcs(xdst_ys + o + s, x);
      if (xsrc_ys) __stcs(xsrc_ys + o + s, xs);
    }
    __syncthreads();

    float part[1] = {0.0f};
    for (int d = tid; d < s_pad; d += FACT_THREADS) {
      const float w1a = sell_row_dot(w1_ptr, w1_col, w1_val, d, ad);
      const float w2u = sell_row_dot(w2_ptr, w2_col, w2_val, d, u);
      const float av = (xd[d] * w1a + w2u) / s_prev;
      a[d] = av;
      __stcs(w1ad_ys + o + d, w1a);
      part[0] += av;
    }
    // also the barrier after which ad and u may be overwritten
    block_sum<1>(part, red);
    const float s_t = part[0];
    const float cs = leaky_c * s_t;
    for (int d = tid; d < s_pad; d += FACT_THREADS) {
      const float v = a[d] + cs * leaky[d];
      ad[d] = v;
      __stcs(ad_ys + o + d, v);
      if (t == Tb - 1) ad_last[static_cast<size_t>(b) * s_pad + d] = v;
    }
    if (tid == 0) s_ys[row0 + t] = s_t;
    s_prev = s_t;
  }
  for (int t = Tb + tid; t < T; t += FACT_THREADS) s_ys[row0 + t] = 1.0f;
}

extern "C" size_t fact_fwd_smem_bytes(int s_pad) {
  return (4 * static_cast<size_t>(s_pad) + FACT_WARPS + 1) * sizeof(float);
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fact_fwd_launch(
    const void* px, const void* lengths, const void* f_dst,
    const void* g_src, const void* w1_ptr, const void* w1_col,
    const void* w1_val, const void* w2_ptr, const void* w2_col,
    const void* w2_val, const void* ad0, const void* s0, const void* leaky,
    float leaky_c, int B, int T, int P, int s_pad, void* ad_ys,
    void* w1ad_ys, void* xdst_ys, void* xsrc_ys, void* s_ys, void* ad_last,
    void* stream) {
  const size_t smem = fact_fwd_smem_bytes(s_pad);
  cudaError_t err = fact_set_smem(fact_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fact_fwd_kernel<<<B, FACT_THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(px), static_cast<const int*>(lengths),
      static_cast<const int*>(f_dst), static_cast<const int*>(g_src),
      static_cast<const int*>(w1_ptr), static_cast<const int*>(w1_col),
      static_cast<const float*>(w1_val), static_cast<const int*>(w2_ptr),
      static_cast<const int*>(w2_col), static_cast<const float*>(w2_val),
      static_cast<const float*>(ad0), static_cast<const float*>(s0),
      static_cast<const float*>(leaky), leaky_c, T, P, s_pad,
      static_cast<float*>(ad_ys), static_cast<float*>(w1ad_ys),
      static_cast<float*>(xdst_ys), static_cast<float*>(xsrc_ys),
      static_cast<float*>(s_ys), static_cast<float*>(ad_last));
  return static_cast<int>(cudaGetLastError());
}
