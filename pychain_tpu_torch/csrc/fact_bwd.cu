// Denominator beta sweep and posteriors on the factorized graph (float32).
//
// Replaces pychain_tpu/ops/pallas_fact.py::_bwd_kernel_factory (launched
// there by _bwd_pallas), in its float32 "parity" precision and "full"
// stream mode: it reads the streams fact_fwd.cu wrote.  Per frame u of
// column b, from u = T_b - 1 down to 0:
//
//   beta'(T_b) = final / tot                  (injected at u = T_b - 1)
//   b = beta'(u+1) + c * sum(beta'(u+1) * leaky)
//   xb = x_dst(u) * b
//   beta'(u) = (W1^T xb + x_src(u) * (W2^T b)) / s_u
//   c1 = xb * (W1 alpha'(u)) / s_u     c2 = x_src * (W2^T b) * alpha'(u) / s_u
//   gamma(u) = E_f^T c1 + E_g^T c2     (one E_f^T scatter of c1 + c2 in
//                                       identity mode)
//
// with s_0 = sum(initial) and s_u the forward sweep's sums.  It writes
// gamma (B, T, P) in the nnet output's own layout (the gradient's
// layout), and the invariant traces sum_s alpha'(u) beta'(u) and
// sum_p gamma(u): at every frame when `debug`, else at frame 0 only with
// 1.0 at the other frames.  Past a column's end gamma is 0 and the
// traces are 0 (debug) or 1.0; no stream row past the end is read.
//
// Design.  As in the forward kernel: one block per batch column running
// the whole reverse time loop, W1^T and W2^T as sliced-ELL rows by source
// state over the graph's arcs, each row's entries in bank order (the
// host's fixed order, chosen so that a slot's 32 gathers hit distinct
// shared-memory banks; sell_row_dot, fact_common.cuh), each thread
// summing its own rows in that order.  The E^T scatters become gathers:
// thread p sums c over the
// states whose pdf is p (a host-built pdf -> states list, ascending), so
// gamma is deterministic without atomics (docs/PARITY.md:52-55).  The
// per-frame reductions (the leaky sum for the next frame and both
// traces) share one block_sum.
//
// The stream rows.  A frame reads three rows of the forward sweep's
// streams (four outside identity mode), each a contiguous run of
// 4 S_pad bytes: x_dst(u), W1 alpha'(u), alpha'(u) (row u - 1; frame 0
// reads ad0) and x_src(u).  With one block an SM nothing else runs while
// the frame waits on device memory for them, so thread 0 fetches them
// `stages` frames ahead into a ring in shared memory, one bulk copy
// (TMA, evicted first from L2) a row, completing on the stage's mbarrier;
// every thread waits on that mbarrier before the frame's first read, and
// after the frame's last read (the barrier before the gamma stage)
// thread 0 refills the stage with frame u - stages.  No row past a
// column's end or before row 0 is fetched.  Depth: two stages where they
// fit a block's 232,448 bytes (the headline graph: 123,292 bytes), one
// where only one fits (S_pad 8,064), none past that, the rows then read
// where the frame needs them (__ldcs); the wrapper picks it
// (fact_kernels.ring_stages) and the resident tier's limits are those
// without a ring (S_pad 14,464 in identity mode, else 11,520).
//
// Bound on an H100 at the headline size (S_pad = 3072, P = 3000,
// B = 128, T = 500): the sweep must read the three (T, S_pad, B) float32
// streams (2.36 GB) and write gamma (0.77 GB): about 3.1 GB, 0.94 ms at
// 3.35 TB/s; the arc products, 2 * 49.5k * B * T = 6.3 GFLOP, take
// 0.09 ms at 67 TFLOP/s.  The bound is the bytes.  Stream reads and
// gamma writes are coalesced.  What the kernel spends (kernel_ablation.py,
// PERF.md): the sparse products 60-62%, the gamma stage 19-22%, the
// ring's copies and waits 4-8% (without the ring it is 8-11% slower).  On
// the wavefront model (the SM's L1 / shared-memory pipe at one wavefront
// a clock) the products need about 5,250 wavefronts a frame: the
// operator lines read from L2 by every block at every frame (two a
// slot-warp) and the gathers (1.4 a slot-warp in bank order, 3.1 in
// ascending order); the bank order saved 0.31 ms where that model
// predicted 0.85, so it is not the whole bound (PERF.md, open questions).

#include "fact_common.cuh"

// Stream rows a frame reads: x_dst(u), W1 alpha'(u), alpha'(u) (the
// forward sweep's row u - 1) and, outside identity mode, x_src(u).
#define RING_XDST 0
#define RING_W1AD 1
#define RING_AD 2
#define RING_XSRC 3

__global__ void __launch_bounds__(FACT_THREADS, 1) fact_bwd_kernel(
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
    const int* __restrict__ f_ptr, const int* __restrict__ f_states,
    const int* __restrict__ g_ptr,       // null in identity mode
    const int* __restrict__ g_states,
    int n_pdf_lists, float leaky_c, int T, int P, int s_pad, int debug,
    int stages,                          // ring depth: 0, 1 or 2
    float* __restrict__ gamma,           // (B, T, P)
    float* __restrict__ ab,              // (B, T)
    float* __restrict__ gs) {            // (B, T)
  extern __shared__ float smem[];
  const bool identity = xsrc_ys == nullptr;
  const int rows = identity ? 3 : 4;      // stream rows a frame
  float* ring = smem;          // stages x rows x S_pad: frames' stream rows
  unsigned long long* bar =    // one mbarrier a stage
      reinterpret_cast<unsigned long long*>(ring + stages * rows * s_pad);
  float* bd = ring + stages * (rows * s_pad + 2);  // beta' carry, own rows
  float* bn = bd + s_pad;      // b: gathered by W2^T's rows
  float* xb = bn + s_pad;      // x_dst * b: gathered by W1^T's rows
  float* c1 = xb + s_pad;      // posterior mass per state (E_f^T side)
  float* c2 = identity ? c1 : c1 + s_pad;   // E_g^T side
  float* red = c2 + s_pad;     // block_sum scratch

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int Tb = lengths[b];
  const size_t row0 = static_cast<size_t>(b) * T;

  // Frame u (the (Tb - 1 - u)-th of the column's reverse loop) reads its
  // stream rows from stage (Tb - 1 - u) % stages; thread 0 fetches them
  // `stages` frames ahead, one bulk copy a row.  Frame 0 reads alpha'(0)
  // from ad0, so no row before row 0 (or past T_b - 1) is fetched.
  const unsigned long long policy = stages ? evict_first_policy() : 0ull;
  const unsigned row_bytes = 4u * static_cast<unsigned>(s_pad);
  auto fetch = [&](int u) {
    const int k = (Tb - 1 - u) % stages;
    float* st = ring + k * rows * s_pad;
    const size_t o = (row0 + u) * s_pad;
    mbar_expect_tx(bar + k, (u > 0 ? rows : rows - 1) * row_bytes);
    bulk_load(st + RING_XDST * s_pad, xdst_ys + o, row_bytes, bar + k,
              policy);
    bulk_load(st + RING_W1AD * s_pad, w1ad_ys + o, row_bytes, bar + k,
              policy);
    if (u > 0)
      bulk_load(st + RING_AD * s_pad, ad_ys + o - s_pad, row_bytes, bar + k,
                policy);
    if (!identity)
      bulk_load(st + RING_XSRC * s_pad, xsrc_ys + o, row_bytes, bar + k,
                policy);
  };
  if (tid == 0 && stages > 0) {
    for (int k = 0; k < stages; ++k) mbar_init(bar + k, 1);
    for (int k = 0; k < stages && k < Tb; ++k) fetch(Tb - 1 - k);
  }

  // frames past the column's end
  const size_t n_past = static_cast<size_t>(T - Tb) * P;
  float* g_past = gamma + (row0 + Tb) * P;
  for (size_t i = tid; i < n_past; i += FACT_THREADS) g_past[i] = 0.0f;
  const float past_trace = debug ? 0.0f : 1.0f;
  for (int u = Tb + tid; u < T; u += FACT_THREADS) {
    ab[row0 + u] = past_trace;
    gs[row0 + u] = past_trace;
  }

  // injection at the last frame: beta'(T_b) = final / tot
  const float tot_b = tot[b];
  float inj[1] = {0.0f};
  for (int s = tid; s < s_pad; s += FACT_THREADS) {
    const float v = final_p[s] / tot_b;
    bd[s] = v;
    inj[0] += v * leaky[s];
  }
  // also the barrier after which the mbarriers may be waited on
  block_sum<1>(inj, red);
  float leak_sum = inj[0];

  float part[3];
  for (int u = Tb - 1; u >= 0; --u) {
    const float s_u = u == 0 ? *s0 : s_ys[row0 + u - 1];
    const float inv_s = 1.0f / s_u;
    const float *xd_u, *w1a_u, *ad_u, *xs_u;
    if (stages > 0) {
      const int i = Tb - 1 - u;
      const float* st = ring + (i % stages) * rows * s_pad;
      mbar_wait(bar + i % stages, (i / stages) & 1);
      xd_u = st + RING_XDST * s_pad;
      w1a_u = st + RING_W1AD * s_pad;
      ad_u = u == 0 ? ad0 : st + RING_AD * s_pad;
      xs_u = identity ? xd_u : st + RING_XSRC * s_pad;
    } else {
      const size_t o = (row0 + u) * s_pad;
      xd_u = xdst_ys + o;
      w1a_u = w1ad_ys + o;
      ad_u = u == 0 ? ad0 : ad_ys + o - s_pad;
      xs_u = identity ? xd_u : xsrc_ys + o;
    }
    // a stream row's entry: from the ring, else read once from device
    // memory, evicted first
    auto row = [&](const float* r, int s) {
      return stages > 0 ? r[s] : __ldcs(r + s);
    };
    const float cl = leaky_c * leak_sum;
    for (int s = tid; s < s_pad; s += FACT_THREADS) {
      const float v = bd[s] + cl;
      bn[s] = v;
      xb[s] = row(xd_u, s) * v;
    }
    __syncthreads();

    const bool traces = debug || u == 0;
    part[0] = part[1] = part[2] = 0.0f;
    for (int s = tid; s < s_pad; s += FACT_THREADS) {
      const float w1t = sell_row_dot(w1t_ptr, w1t_col, w1t_val, s, xb);
      const float w2t = sell_row_dot(w2t_ptr, w2t_col, w2t_val, s, bn);
      const float sw = row(xs_u, s) * w2t;
      const float bdt = (w1t + sw) * inv_s;
      const float ad = row(ad_u, s);
      const float m1 = xb[s] * row(w1a_u, s) * inv_s;
      const float m2 = sw * ad * inv_s;
      if (identity) {
        c1[s] = m1 + m2;
      } else {
        c1[s] = m1;
        c2[s] = m2;
      }
      bd[s] = bdt;
      part[0] += bdt * leaky[s];
      if (traces) part[1] += ad * bdt;
    }
    __syncthreads();
    // the stage is read: refill it with frame u - stages' rows
    if (tid == 0 && stages > 0 && u >= stages) {
      fence_proxy_async();
      fetch(u - stages);
    }

    float* g_row = gamma + (row0 + u) * P;
    for (int p = tid; p < P; p += FACT_THREADS) {
      float acc = 0.0f;
      if (p < n_pdf_lists) {
        const int fe = __ldg(f_ptr + p + 1);
        for (int k = __ldg(f_ptr + p); k < fe; ++k)
          acc += c1[__ldg(f_states + k)];
        if (!identity) {
          const int ge = __ldg(g_ptr + p + 1);
          for (int k = __ldg(g_ptr + p); k < ge; ++k)
            acc += c2[__ldg(g_states + k)];
        }
      }
      __stcs(g_row + p, acc);
      if (traces) part[2] += acc;
    }
    // also the barrier after which bn, xb, c1 and c2 may be overwritten
    block_sum<3>(part, red);
    leak_sum = part[0];
    if (tid == 0) {
      ab[row0 + u] = traces ? part[1] : 1.0f;
      gs[row0 + u] = traces ? part[2] : 1.0f;
    }
  }
}

extern "C" size_t fact_bwd_smem_bytes(int s_pad, int identity, int stages) {
  const size_t rows = identity ? 3 : 4;
  return ((identity ? 4 : 5) * static_cast<size_t>(s_pad) +
          3 * FACT_WARPS + 3 + stages * (rows * s_pad + 2)) * sizeof(float);
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int fact_bwd_launch(
    const void* lengths, const void* ad_ys, const void* w1ad_ys,
    const void* xdst_ys, const void* xsrc_ys, const void* s_ys,
    const void* s0, const void* ad0, const void* final_p, const void* tot,
    const void* leaky, const void* w1t_ptr, const void* w1t_col,
    const void* w1t_val, const void* w2t_ptr, const void* w2t_col,
    const void* w2t_val, const void* f_ptr, const void* f_states,
    const void* g_ptr, const void* g_states, int n_pdf_lists,
    float leaky_c, int B, int T, int P, int s_pad, int debug, int stages,
    void* gamma, void* ab, void* gs, void* stream) {
  const size_t smem =
      fact_bwd_smem_bytes(s_pad, xsrc_ys == nullptr, stages);
  cudaError_t err = fact_set_smem(fact_bwd_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fact_bwd_kernel<<<B, FACT_THREADS, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lengths), static_cast<const float*>(ad_ys),
      static_cast<const float*>(w1ad_ys), static_cast<const float*>(xdst_ys),
      static_cast<const float*>(xsrc_ys), static_cast<const float*>(s_ys),
      static_cast<const float*>(s0), static_cast<const float*>(ad0),
      static_cast<const float*>(final_p), static_cast<const float*>(tot),
      static_cast<const float*>(leaky), static_cast<const int*>(w1t_ptr),
      static_cast<const int*>(w1t_col), static_cast<const float*>(w1t_val),
      static_cast<const int*>(w2t_ptr), static_cast<const int*>(w2t_col),
      static_cast<const float*>(w2t_val), static_cast<const int*>(f_ptr),
      static_cast<const int*>(f_states), static_cast<const int*>(g_ptr),
      static_cast<const int*>(g_states), n_pdf_lists, leaky_c, T, P, s_pad,
      debug, stages, static_cast<float*>(gamma), static_cast<float*>(ab),
      static_cast<float*>(gs));
  return static_cast<int>(cudaGetLastError());
}
