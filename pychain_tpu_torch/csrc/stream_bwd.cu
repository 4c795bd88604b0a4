// Denominator beta sweep and posteriors for graphs whose state vectors
// exceed one SM's shared memory: one thread-block cluster per batch
// column (float32).
//
// Replaces pychain_tpu/ops/pallas_stream.py::_bwd_kernel_factory
// (launched there by _bwd_stream), which computes what
// pallas_fact.py::_bwd_kernel_factory (B2, here fact_bwd.cu) computes, in
// "full" stream mode, with W1^T streamed.  It reads the streams
// stream_fwd.cu (or fact_fwd.cu) wrote and runs fact_bwd.cu's recurrence
// per frame u of column b, from u = T_b - 1 down to 0:
//
//   beta'(T_b) = final / tot                  (injected at u = T_b - 1)
//   b = beta'(u+1) + c * sum(beta'(u+1) * leaky)
//   xb = x_dst(u) * b
//   beta'(u) = (W1^T xb + x_src(u) * (W2^T b)) / s_u
//   c1 = xb * (W1 alpha'(u)) / s_u     c2 = x_src * (W2^T b) * alpha'(u) / s_u
//   gamma(u) = E_f^T c1 + E_g^T c2     (one E_f^T scatter of c1 + c2 in
//                                       identity mode)
//
// with the same outputs: gamma (B, T, P) and the traces
// sum_s alpha'(u) beta'(u) and sum_p gamma(u), at every frame when
// `debug`, else at frame 0 only with 1.0 at the other frames; past a
// column's end gamma is 0 and the traces 0 (debug) or 1.0.
//
// Design.  As in stream_fwd.cu: CTA r of column b's cluster owns the
// 32-row slices r, r + C, ... (R rows) and keeps the two vectors the
// products gather, b and xb, whole, copying its peers' rows of them each
// frame (cluster_gather), and beta', c1 (and c2) on its own rows only:
// 2 S_pad + 3 R floats (2 S_pad + 2 R in identity mode).  W1^T / W2^T are
// the sliced-ELL rows by source state of fact_bwd.cu.  Gamma stays
// deterministic without atomics (docs/PARITY.md:52-55): CTA r owns the
// pdf columns [r ceil(P / C), (r + 1) ceil(P / C)), and for each it sums
// c1 over the pdf's states in the host-built pdf -> states list (then c2
// over the E_g list), in fact_bwd.cu's order, reading each state's mass
// from the CTA that owns it (packed ids, cluster_load): each mass is read
// once, so scattered DSMEM loads (3.9 of 26.9 ms at main path 4) beat
// copying c1 and c2 in whole after another cluster barrier (+1.9 ms,
// PERF.md).  A frame:
//   1. b and xb on its rows;
//   2. cluster barrier; copy the peers' rows of b and xb; block barrier;
//   3. its rows' W1^T xb and W2^T b, beta', c1, c2 and the partials of
//      the next frame's leaky sum and of the alpha*beta trace;
//   4. cluster barrier (c1 and c2 complete in every CTA);
//   5. gamma on its pdf columns and the partial of the sum-gamma trace;
//   6. cluster_sum of the three partials in rank order.
// Three cluster barriers a frame; a last one before the CTAs exit.
//
// Bound on an H100 at main path 4 (S_pad = 12,032, P = 6,000, B = 128,
// T = 500, x_src "stream"): the sweep must read the four (T, S_pad, B)
// float32 streams (12.3 GB) and write gamma (1.5 GB): about 13.9 GB,
// 4.1 ms at 3.35 TB/s; the arc products, 2 * 198k * B * T = 25 GFLOP,
// 0.38 ms at 67 TFLOP/s.  The bound is the bytes.

#include "fact_common.cuh"

__global__ void __launch_bounds__(FACT_THREADS, 1) stream_bwd_kernel(
    const int* __restrict__ lengths,     // (B,)  1 <= T_b <= T
    const float* __restrict__ ad_ys,     // (B, T, S_pad) alpha'(u+1)
    const float* __restrict__ w1ad_ys,   // (B, T, S_pad) W1 alpha'(u)
    const float* __restrict__ xdst_ys,   // (B, T, S_pad)
    const float* __restrict__ xsrc_ys,   // (B, T, S_pad) or null (identity)
    const float* __restrict__ s_ys,      // (B, T) s_{u+1}
    const float* __restrict__ s0,        // (1,)
    const float* __restrict__ ad0,       // (S_pad,) alpha'(0)
    const float* __restrict__ final_p,   // (S_pad,)
    const float* __restrict__ tot,       // (B,) sum(alpha'(T_b) * final)
    const float* __restrict__ leaky,     // (S_pad,)
    const int* __restrict__ w1t_ptr, const int* __restrict__ w1t_col,
    const float* __restrict__ w1t_val,   // W1 by source row
    const int* __restrict__ w2t_ptr, const int* __restrict__ w2t_col,
    const float* __restrict__ w2t_val,   // W2 by source row
    const int* __restrict__ f_ptr,       // pdf -> states (packed ids)
    const int* __restrict__ f_states,
    const int* __restrict__ g_ptr,       // null in identity mode
    const int* __restrict__ g_states,
    int n_pdf_lists, float leaky_c, int T, int P, int s_pad, int rows,
    int debug,
    float* __restrict__ gamma,           // (B, T, P)
    float* __restrict__ ab,              // (B, T)
    float* __restrict__ gs) {            // (B, T)
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  const bool identity = xsrc_ys == nullptr;
  float* xb = smem;            // x_dst * b, whole: gathered by W1^T's rows
  float* bn = xb + s_pad;      // b, whole: gathered by W2^T's rows
  float* bd = bn + s_pad;      // beta' carry on this CTA's rows
  float* c1 = bd + rows;       // posterior mass per own state (E_f^T side)
  float* c2 = identity ? c1 : c1 + rows;   // E_g^T side
  float* red = c2 + rows;      // block_sum scratch
  float* slot = red + 3 * FACT_WARPS + 3;  // cluster_sum slot

  const int tid = threadIdx.x;
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int n = cluster_own_rows(s_pad, rank, C);
  const int p_per = (P + C - 1) / C;
  const int p0 = min(P, rank * p_per);
  const int p1 = min(P, p0 + p_per);             // this CTA's pdf columns
  const int Tb = lengths[b];
  const size_t row0 = static_cast<size_t>(b) * T;

  // frames past the column's end
  for (int u = Tb; u < T; ++u) {
    float* g_row = gamma + (row0 + u) * P;
    for (int p = p0 + tid; p < p1; p += FACT_THREADS) g_row[p] = 0.0f;
  }
  const float past_trace = debug ? 0.0f : 1.0f;
  if (rank == 0) {
    for (int u = Tb + tid; u < T; u += FACT_THREADS) {
      ab[row0 + u] = past_trace;
      gs[row0 + u] = past_trace;
    }
  }

  // injection at the last frame: beta'(T_b) = final / tot
  const float tot_b = tot[b];
  float inj[1] = {0.0f};
  for (int i = tid; i < n; i += FACT_THREADS) {
    const int d = cluster_row(i, rank, C);
    const float v = final_p[d] / tot_b;
    bd[i] = v;
    inj[0] += v * leaky[d];
  }
  block_sum<1>(inj, red);
  cluster_sum<1>(inj, slot);
  float leak_sum = inj[0];

  float part[3];
  for (int u = Tb - 1; u >= 0; --u) {
    const float s_u = u == 0 ? *s0 : s_ys[row0 + u - 1];
    const float inv_s = 1.0f / s_u;
    const size_t o = (row0 + u) * s_pad;
    const float* ad_u = u == 0 ? ad0 : ad_ys + o - s_pad;
    const float cl = leaky_c * leak_sum;
    for (int i = tid; i < n; i += FACT_THREADS) {
      const int d = cluster_row(i, rank, C);
      const float v = bd[i] + cl;
      bn[d] = v;
      xb[d] = xdst_ys[o + d] * v;
    }
    cluster.sync();
    cluster_gather(xb, s_pad);
    cluster_gather(bn, s_pad);
    __syncthreads();

    const bool traces = debug || u == 0;
    part[0] = part[1] = part[2] = 0.0f;
    for (int i = tid; i < n; i += FACT_THREADS) {
      const int d = cluster_row(i, rank, C);
      const float w1t = sell_row_dot(w1t_ptr, w1t_col, w1t_val, d, xb);
      const float w2t = sell_row_dot(w2t_ptr, w2t_col, w2t_val, d, bn);
      const float sw = (identity ? xdst_ys[o + d] : xsrc_ys[o + d]) * w2t;
      const float bdt = (w1t + sw) * inv_s;
      const float m1 = xb[d] * w1ad_ys[o + d] * inv_s;
      const float m2 = sw * ad_u[d] * inv_s;
      if (identity) {
        c1[i] = m1 + m2;
      } else {
        c1[i] = m1;
        c2[i] = m2;
      }
      bd[i] = bdt;
      part[0] += bdt * leaky[d];
      if (traces) part[1] += ad_u[d] * bdt;
    }
    cluster.sync();

    float* g_row = gamma + (row0 + u) * P;
    for (int p = p0 + tid; p < p1; p += FACT_THREADS) {
      float acc = 0.0f;
      if (p < n_pdf_lists) {
        const int fe = __ldg(f_ptr + p + 1);
        for (int k = __ldg(f_ptr + p); k < fe; ++k)
          acc += cluster_load(c1, __ldg(f_states + k));
        if (!identity) {
          const int ge = __ldg(g_ptr + p + 1);
          for (int k = __ldg(g_ptr + p); k < ge; ++k)
            acc += cluster_load(c2, __ldg(g_states + k));
        }
      }
      g_row[p] = acc;
      if (traces) part[2] += acc;
    }
    block_sum<3>(part, red);
    // also the barrier after which bn, xb, c1 and c2 may be overwritten
    cluster_sum<3>(part, slot);
    leak_sum = part[0];
    if (rank == 0 && tid == 0) {
      ab[row0 + u] = traces ? part[1] : 1.0f;
      gs[row0 + u] = traces ? part[2] : 1.0f;
    }
  }
  cluster.sync();
}

extern "C" size_t stream_bwd_smem_bytes(int s_pad, int rows, int identity) {
  return (2 * static_cast<size_t>(s_pad) +
          (identity ? 2 : 3) * static_cast<size_t>(rows) + 3 * FACT_WARPS +
          6) * sizeof(float);
}

// Returns 0 on success, a cudaError_t, or -1 when
// cudaOccupancyMaxActiveClusters says no cluster of this shape can be
// resident.
extern "C" int stream_bwd_launch(
    const void* lengths, const void* ad_ys, const void* w1ad_ys,
    const void* xdst_ys, const void* xsrc_ys, const void* s_ys,
    const void* s0, const void* ad0, const void* final_p, const void* tot,
    const void* leaky, const void* w1t_ptr, const void* w1t_col,
    const void* w1t_val, const void* w2t_ptr, const void* w2t_col,
    const void* w2t_val, const void* f_ptr, const void* f_states,
    const void* g_ptr, const void* g_states, int n_pdf_lists,
    float leaky_c, int B, int T, int P, int s_pad, int cluster, int rows,
    int debug, void* gamma, void* ab, void* gs, void* stream) {
  const size_t smem = stream_bwd_smem_bytes(s_pad, rows, xsrc_ys == nullptr);
  cudaError_t err = fact_set_smem(stream_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(B, cluster, smem, stream, attr);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, stream_bwd_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return -1;
  err = cudaLaunchKernelEx(
      &cfg, stream_bwd_kernel, static_cast<const int*>(lengths),
      static_cast<const float*>(ad_ys), static_cast<const float*>(w1ad_ys),
      static_cast<const float*>(xdst_ys), static_cast<const float*>(xsrc_ys),
      static_cast<const float*>(s_ys), static_cast<const float*>(s0),
      static_cast<const float*>(ad0), static_cast<const float*>(final_p),
      static_cast<const float*>(tot), static_cast<const float*>(leaky),
      static_cast<const int*>(w1t_ptr), static_cast<const int*>(w1t_col),
      static_cast<const float*>(w1t_val), static_cast<const int*>(w2t_ptr),
      static_cast<const int*>(w2t_col), static_cast<const float*>(w2t_val),
      static_cast<const int*>(f_ptr), static_cast<const int*>(f_states),
      static_cast<const int*>(g_ptr), static_cast<const int*>(g_states),
      n_pdf_lists, leaky_c, T, P, s_pad, rows, debug,
      static_cast<float*>(gamma), static_cast<float*>(ab),
      static_cast<float*>(gs));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
