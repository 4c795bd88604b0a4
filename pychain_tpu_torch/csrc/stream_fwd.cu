// Denominator alpha sweep for graphs whose working set exceeds one SM's
// shared memory: one thread-block cluster per batch column (float32).
//
// Replaces pychain_tpu/ops/pallas_stream.py::_fwd_kernel_factory
// (launched there by _fwd_stream), which computes what
// pallas_fact.py::_fwd_kernel_factory (B1, here fact_fwd.cu) computes, in
// "full" stream mode, for graphs past the TPU kernel's VMEM.  Per frame t
// of column b, the recurrence of fact_fwd.cu:
//
//   x_dst = px_t[f_dst]            x_src = px_t[g_src]  (= x_dst in
//                                                        identity mode)
//   alpha = (x_dst * (W1 alpha') + W2 (x_src * alpha')) / s_{t-1}
//   s_t = sum(alpha)               alpha' = alpha + c * s_t * leaky
//
// with the same outputs: the (B, T, S_pad) streams alpha'(t+1),
// W1 alpha'(t), x_dst(t) (and x_src(t) outside identity mode), s_t (B, T)
// and alpha' at the column's last frame.
//
// Design.  On the TPU the kernel streams W1's 128 x 128 tiles from HBM in
// chunks, because the graph's weights do not fit VMEM.  The port never
// holds the weights on chip (W1/W2 are sliced-ELL rows read through L2,
// as in fact_fwd.cu); what outgrows one SM here is the column's working
// set, 4 S_pad floats in fact_fwd.cu.  So the column runs on the C CTAs
// of a cluster.  CTA r owns the 32-row slices r, r + C, ... (R rows:
// cluster_row, fact_common.cuh) and keeps the two vectors the products
// gather, alpha' and u = x_src * alpha', whole, and x_dst and alpha on its
// own rows only: 2 S_pad + 2 R floats.  A frame:
//   1. gather its rows' emissions, write their stream entries, its rows
//      of u;
//   2. cluster barrier (every CTA's rows of alpha' and u written);
//   3. copy its peers' rows of alpha' and u into its copies
//      (cluster_gather: 16-byte DSMEM loads), block barrier;
//   4. its rows' W1 alpha' and W2 u from its own copies, alpha, the
//      block's partial of s_t;
//   5. cluster_sum: partials posted, a cluster barrier, every CTA adds
//      the C partials in rank order (s_t bit-identical in every CTA);
//   6. the leaky term on its own rows of alpha' (no peer copies them
//      until the next frame's barrier).
// All CTAs of a cluster share the column's length, so they pass the same
// barriers; a last cluster barrier keeps every CTA's shared memory alive
// until no peer can read it.
//
// Bound on an H100 at main path 4 (S_pad = 12,032, P = 6,000, B = 128,
// T = 500, x_src "stream"): the sweep must read px once (1.5 GB) and
// write four (T, S_pad, B) float32 streams (12.3 GB): about 13.9 GB,
// 4.1 ms at 3.35 TB/s; the arc products, 2 * 198k * B * T = 25 GFLOP, take
// 0.38 ms at 67 TFLOP/s.  The bound is the bytes.  Stream writes are
// coalesced (a warp's rows are one slice); the sparse rows are re-read
// from L2 by every cluster at every frame, and every CTA copies
// 2 S_pad (C - 1) / C floats from its peers a frame: the traffic this
// first design does not remove (PERF.md).

#include "fact_common.cuh"

__global__ void __launch_bounds__(FACT_THREADS, 1) stream_fwd_kernel(
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
    float leaky_c, int T, int P, int s_pad, int rows,
    float* __restrict__ ad_ys,           // (B, T, S_pad) alpha'(t+1)
    float* __restrict__ w1ad_ys,         // (B, T, S_pad) W1 alpha'(t)
    float* __restrict__ xdst_ys,         // (B, T, S_pad)
    float* __restrict__ xsrc_ys,         // (B, T, S_pad) or null
    float* __restrict__ s_ys,            // (B, T) s_{t+1}; 1 past the end
    float* __restrict__ ad_last) {       // (B, S_pad) alpha'(T_b)
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float smem[];
  float* ad = smem;            // alpha', whole: gathered by W1's rows
  float* u = ad + s_pad;       // x_src * alpha', whole: by W2's rows
  float* xd = u + s_pad;       // x_dst(t) on this CTA's rows
  float* a = xd + rows;        // alpha(t) before the leaky term, ditto
  float* red = a + rows;       // block_sum scratch
  float* slot = red + FACT_WARPS + 1;   // cluster_sum slot

  const int tid = threadIdx.x;
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const int n = cluster_own_rows(s_pad, rank, C);
  const int Tb = lengths[b];
  const size_t row0 = static_cast<size_t>(b) * T;

  for (int s = tid; s < s_pad; s += FACT_THREADS) ad[s] = ad0[s];
  float s_prev = *s0;

  for (int t = 0; t < Tb; ++t) {
    const float* px_t = px + (row0 + t) * P;
    const size_t o = (row0 + t) * s_pad;
    for (int i = tid; i < n; i += FACT_THREADS) {
      const int d = cluster_row(i, rank, C);
      const float x = __ldg(px_t + f_dst[d]);
      const float xs = g_src ? __ldg(px_t + g_src[d]) : x;
      xd[i] = x;
      u[d] = xs * ad[d];
      xdst_ys[o + d] = x;
      if (xsrc_ys) xsrc_ys[o + d] = xs;
    }
    cluster.sync();
    cluster_gather(ad, s_pad);
    cluster_gather(u, s_pad);
    __syncthreads();

    float part[1] = {0.0f};
    for (int i = tid; i < n; i += FACT_THREADS) {
      const int d = cluster_row(i, rank, C);
      const float w1a = sell_row_dot(w1_ptr, w1_col, w1_val, d, ad);
      const float w2u = sell_row_dot(w2_ptr, w2_col, w2_val, d, u);
      const float av = (xd[i] * w1a + w2u) / s_prev;
      a[i] = av;
      w1ad_ys[o + d] = w1a;
      part[0] += av;
    }
    block_sum<1>(part, red);
    // also the barrier after which ad and u may be overwritten
    cluster_sum<1>(part, slot);
    const float s_t = part[0];
    const float cs = leaky_c * s_t;
    for (int i = tid; i < n; i += FACT_THREADS) {
      const int d = cluster_row(i, rank, C);
      const float v = a[i] + cs * leaky[d];
      ad[d] = v;
      ad_ys[o + d] = v;
      if (t == Tb - 1) ad_last[static_cast<size_t>(b) * s_pad + d] = v;
    }
    if (rank == 0 && tid == 0) s_ys[row0 + t] = s_t;
    s_prev = s_t;
  }
  if (rank == 0)
    for (int t = Tb + tid; t < T; t += FACT_THREADS) s_ys[row0 + t] = 1.0f;
  cluster.sync();
}

extern "C" size_t stream_fwd_smem_bytes(int s_pad, int rows) {
  return (2 * static_cast<size_t>(s_pad) + 2 * static_cast<size_t>(rows) +
          FACT_WARPS + 2) * sizeof(float);
}

// Returns 0 on success, a cudaError_t, or -1 when
// cudaOccupancyMaxActiveClusters says no cluster of this shape can be
// resident.
extern "C" int stream_fwd_launch(
    const void* px, const void* lengths, const void* f_dst,
    const void* g_src, const void* w1_ptr, const void* w1_col,
    const void* w1_val, const void* w2_ptr, const void* w2_col,
    const void* w2_val, const void* ad0, const void* s0, const void* leaky,
    float leaky_c, int B, int T, int P, int s_pad, int cluster, int rows,
    void* ad_ys, void* w1ad_ys, void* xdst_ys, void* xsrc_ys, void* s_ys,
    void* ad_last, void* stream) {
  const size_t smem = stream_fwd_smem_bytes(s_pad, rows);
  cudaError_t err = fact_set_smem(stream_fwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(B, cluster, smem, stream, attr);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, stream_fwd_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return -1;
  err = cudaLaunchKernelEx(
      &cfg, stream_fwd_kernel, static_cast<const float*>(px),
      static_cast<const int*>(lengths), static_cast<const int*>(f_dst),
      static_cast<const int*>(g_src), static_cast<const int*>(w1_ptr),
      static_cast<const int*>(w1_col), static_cast<const float*>(w1_val),
      static_cast<const int*>(w2_ptr), static_cast<const int*>(w2_col),
      static_cast<const float*>(w2_val), static_cast<const float*>(ad0),
      static_cast<const float*>(s0), static_cast<const float*>(leaky),
      leaky_c, T, P, s_pad, rows, static_cast<float*>(ad_ys),
      static_cast<float*>(w1ad_ys), static_cast<float*>(xdst_ys),
      static_cast<float*>(xsrc_ys), static_cast<float*>(s_ys),
      static_cast<float*>(ad_last));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
