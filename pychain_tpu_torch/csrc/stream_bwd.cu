// Denominator beta sweep and posteriors for graphs whose state vectors
// exceed one SM's shared memory: one thread-block cluster per group of G
// batch columns, float32 and fast mode.
//
// Replaces pychain_tpu/ops/pallas_stream.py::_bwd_kernel_factory
// (launched there by _bwd_stream), which computes what
// pallas_fact.py::_bwd_kernel_factory (B2, here fact_bwd.cu) computes, in
// "full" stream mode, with W1^T streamed, in both its precisions: float32
// (stream_bwd_launch) and the fast mode of bfloat16 tiles
// (stream_bwd_bf16_launch).  It reads the streams
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
// Design.  As in stream_fwd.cu: a cluster of C CTAs serves G columns, CTA
// r owns the 32-row slices r, r + C, ... (R rows) in all G columns, and
// every vector holds the G columns interleaved.  It holds whole only xb,
// the vector W1^T gathers (S_pad G floats), copying its peers' rows each
// frame (cluster_gather_cols), so one W1^T entry read from L2 feeds G
// products.  In shared memory it keeps besides only the posterior masses
// of its rows, c1 and c2, which the gamma stage reads (S_pad + 2 R floats
// a column; S_pad + R in identity mode).  b, which peers read for W2^T
// (at most one entry a row in the repository's graphs), and the beta'
// carry live in a device-memory scratch by state, (groups, S_pad, G)
// each, read and written through L2 only (load_cols_l2): that frees the
// shared memory for G = 2 at main path 4, where b and the carry on chip
// (S_pad + 4 R) allowed only G = 1 and took 28.4 ms against 21.5 on an
// H100 (PERF.md).  Gamma stays deterministic without atomics
// (docs/PARITY.md:52-55): CTA r owns
// the pdf columns [r ceil(P / C), (r + 1) ceil(P / C)), and for each it
// sums c1 over the pdf's states in the host-built pdf -> states list
// (then c2 over the E_g list), in fact_bwd.cu's order, reading each
// state's G masses from the CTA that owns it (packed ids).  A frame:
//   1. b and xb on its rows;
//   2. cluster barrier X1; the sum-gamma trace of frame u + 1 from the
//      CTAs' partials in rank order; copy the peers' rows of xb; block
//      barrier;
//   3. its rows' W1^T xb and W2^T b, beta', c1, c2 and the partials of
//      the next frame's leaky sum and of the alpha*beta trace, posted;
//   4. cluster barrier X2; the leaky sums and the alpha*beta trace in
//      rank order;
//   5. gamma on its pdf columns; the partial of the sum-gamma trace,
//      posted (read after the next X1).
// Two cluster barriers a frame, no double buffers: every array peers read is
// written again only after the barrier that follows its peers' reads
// (b and xb after X2, c1 / c2 and the leaky-sum slot after the next X1,
// the gamma slot after X2).  Columns of a group may differ in length: the
// group runs to its longest; a column joins at its own last frame with
// the injected carry and writes nothing past its end.  Two last cluster
// barriers: the frame-0 gamma trace, then no peer reads this CTA's
// shared memory any more.
// The per-column arithmetic is written with explicit rounding (fmaf,
// __fmul_rn, __fadd_rn, __fdiv_rn), so that no multiply-add the compiler
// would fuse differs between the G instantiations: a column's results
// are bit-identical at every G for a given C.
//
// Bound on an H100 at main path 4 (S_pad = 12,032, P = 6,000, B = 128,
// T = 500, x_src "stream"): the sweep must read the four (T, S_pad, B)
// float32 streams (12.3 GB) and write gamma (1.5 GB): about 13.9 GB,
// 4.1 ms at 3.35 TB/s; the arc products, 2 * 198k * B * T = 25 GFLOP,
// 0.38 ms at 67 TFLOP/s.  The bound is the bytes.  The streams, read
// once, are loaded evict-first (__ldcs) and gamma stored so (__stcs).
//
// The fast mode reads the bfloat16 streams stream_fwd.cu wrote in that
// mode and rounds where the Pallas kernel does (pallas_stream.py:481-571,
// the rounding points of fact_bwd.cu): the operands of W1^T's and W2^T's
// off-diagonal products, bfloat16(x_dst * b) gathered from the whole
// float32 copy of xb and bfloat16(b) from the float32 scratch bn (the
// diagonals apart in float32, with the row's unrounded xb and b); each
// state's mass, unscaled, before the pdf's sum (c1 and c2 hold bfloat16
// values as float32); gamma = bfloat16(1 / s_u times that sum), stored as
// float32 (the caller's gradient type); the sum-gamma trace is the unscaled
// sum over the CTAs, times 1 / s_u.  alpha'(0) is the float32 ad0.  Every
// product and sum is rounded on its own (no fused multiply-add but where
// it adds an exact product of two bfloat16 values), in the order of the
// plain version (ops/factorized.backward_prob_fast with cluster = C),
// which this kernel equals bit for bit.  Shared memory is the float32
// mode's (the float layout).  Its bytes bound at main path 4 falls to
// about 2.3 ms (four 2-byte streams of 1.54 GB each, gamma 1.54 GB).
//
// The fast mode's packed layout (G = 2 or 4), as in stream_fwd.cu: each
// W1^T / W2^T slot one 4-byte word (fact_kernels.pack_slots), x_dst * b
// held rounded and packed (S_pad G / 2 words; its peers' rows copied at
// half the bytes) beside the own rows' unrounded values (R G floats, the
// diagonal's), and the masses, bfloat16 values already, packed (R G / 2
// words each, read by the gamma stage at half the DSMEM bytes).  The
// same products and sums in the same order: the float layout's bits.  At
// main path 4 (C = G = 2) B4 fast falls 13% (18.34 -> 15.91 ms on an
// H100, PERF.md).

#include "fact_common.cuh"

// S: the stream type, float (float32 mode) or __nv_bfloat16 (fast mode).
// kPacked: the fast mode's packed layout (G = 2 or 4): the slots of W1^T
// and W2^T one word each (w1t_pack, w2t_pack), x_dst * b kept whole
// rounded and packed (S_pad G / 2 words) beside the own rows' unrounded
// values (R G floats, the diagonal's), the masses packed (R G / 2 words
// each).
template <typename S, int G, bool kPacked>
__global__ void __launch_bounds__(FACT_THREADS, 1) stream_bwd_kernel(
    const int* __restrict__ lengths,     // (B,)  1 <= T_b <= T
    const S* __restrict__ ad_ys,         // (B, T, S_pad) alpha'(u+1)
    const S* __restrict__ w1ad_ys,       // (B, T, S_pad) W1 alpha'(u)
    const S* __restrict__ xdst_ys,       // (B, T, S_pad)
    const S* __restrict__ xsrc_ys,       // (B, T, S_pad) or null (identity)
    const float* __restrict__ s_ys,      // (B, T) s_{u+1}
    const float* __restrict__ s0,        // (1,)
    const float* __restrict__ ad0,       // (S_pad,) alpha'(0)
    const float* __restrict__ final_p,   // (S_pad,)
    const float* __restrict__ tot,       // (B,) sum(alpha'(T_b) * final)
    const float* __restrict__ leaky,     // (S_pad,)
    const int* __restrict__ w1t_ptr, const int* __restrict__ w1t_col,
    const float* __restrict__ w1t_val,   // W1 by source row
    const unsigned* __restrict__ w1t_pack,  // its slots packed (kPacked)
    const int* __restrict__ w2t_ptr, const int* __restrict__ w2t_col,
    const float* __restrict__ w2t_val,   // W2 by source row
    const unsigned* __restrict__ w2t_pack,  // its slots packed (kPacked)
    const float* __restrict__ diag1,     // (S_pad,) W1's diagonal (fast mode)
    const float* __restrict__ diag2,     // (S_pad,) W2's diagonal (fast mode)
    const int* __restrict__ f_ptr,       // pdf -> states (packed ids)
    const int* __restrict__ f_states,
    const int* __restrict__ g_ptr,       // null in identity mode
    const int* __restrict__ g_states,
    int n_pdf_lists, float leaky_c, int B, int T, int P, int s_pad,
    int rows, int debug,
    float* __restrict__ carry,           // scratch: 2 x (groups, S_pad, G)
    float* __restrict__ gamma,           // (B, T, P)
    float* __restrict__ ab,              // (B, T)
    float* __restrict__ gs) {            // (B, T)
  constexpr bool kFast = sizeof(S) == 2;
  static_assert(!kPacked || (kFast && G >= 2), "packed: fast, G = 2 or 4");
  constexpr int W = kPacked ? G / 2 : G;   // words a state of xb, a mass
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  const bool identity = xsrc_ys == nullptr;
  float* xb = reinterpret_cast<float*>(smem4);  // x_dst * b, whole, (S_pad, G)
  unsigned* xbp = reinterpret_cast<unsigned*>(smem4);   // packed: (S_pad, W)
  float* xbo = xb + s_pad * W;    // packed: own rows' x_dst * b, (R, G)
  float* c1 = xbo + (kPacked ? rows * G : 0);   // mass per own state (E_f^T)
  float* c2 = identity ? c1 : c1 + rows * W;    // E_g^T side
  float* red = c2 + rows * W;     // block_sum scratch
  float* slot_la = red + 2 * FACT_WARPS * G + 2 * G;  // leaky, alpha*beta
  float* slot_gs = slot_la + 2 * G;                   // sum gamma

  const int tid = threadIdx.x;
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lc = __ffs(C) - 1;
  const int group = static_cast<int>(blockIdx.x) / C;
  const int b0 = group * G;
  // b (peers read it) and the beta' carry, by state, in device memory
  const size_t n_group = gridDim.x / C;
  float* bn = carry + group * static_cast<size_t>(s_pad) * G;
  float* bd = bn + n_group * s_pad * G;
  const int n = cluster_own_rows(s_pad, rank, C);
  const int p_per = (P + C - 1) / C;
  const int p0 = min(P, rank * p_per);
  const int p1 = min(P, p0 + p_per);             // this CTA's pdf columns
  int Tb[G];
  size_t row0[G];                  // (b, 0) row of the (B, T, ...) arrays
  int t_max = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int b = b0 + g;
    Tb[g] = b < B ? lengths[b] : 0;
    row0[g] = static_cast<size_t>(min(b, B - 1)) * T;
    t_max = max(t_max, Tb[g]);
  }

  // frames past each column's end
  const float past_trace = debug ? 0.0f : 1.0f;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (b0 + g >= B) continue;
    for (int u = Tb[g]; u < T; ++u) {
      float* g_row = gamma + (row0[g] + u) * P;
      for (int p = p0 + tid; p < p1; p += FACT_THREADS) g_row[p] = 0.0f;
    }
    if (rank == 0) {
      for (int u = Tb[g] + tid; u < T; u += FACT_THREADS) {
        ab[row0[g] + u] = past_trace;
        gs[row0[g] + u] = past_trace;
      }
    }
  }

  // the carry each column starts from at its last frame: final / tot.
  // A row is read and written by one thread only (i = tid + k * threads).
  float leak[G];
  {
    float tot_g[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      tot_g[g] = b0 + g < B ? tot[b0 + g] : 1.0f;
      leak[g] = 0.0f;
    }
    for (int i = tid; i < n; i += FACT_THREADS) {
      const int d = cluster_row(i, rank, C);
      const float lk = leaky[d];
      float v[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        v[g] = __fdiv_rn(final_p[d], tot_g[g]);
        leak[g] = kFast ? __fadd_rn(leak[g], __fmul_rn(v[g], lk))
                        : fmaf(v[g], lk, leak[g]);
      }
      store_cols_l2<G>(bd + d * G, v);
    }
    block_sum<G>(leak, red);
    if (tid == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) slot_la[g] = leak[g];
    }
    cluster.sync();
    cluster_rank_sum<G>(slot_la, leak);
  }

  for (int u = t_max - 1; u >= 0; --u) {
    // 1. b and xb on own rows
    float cl[G];
#pragma unroll
    for (int g = 0; g < G; ++g) cl[g] = __fmul_rn(leaky_c, leak[g]);
    for (int i = tid; i < n; i += FACT_THREADS) {
      const int d = cluster_row(i, rank, C);
      float v[G], x[G];
      load_cols_l2<G>(bd + d * G, v);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        v[g] = __fadd_rn(v[g], cl[g]);
        x[g] = __fmul_rn(stream_get(xdst_ys + (row0[g] + u) * s_pad + d),
                         v[g]);
      }
      store_cols_l2<G>(bn + d * G, v);
      if constexpr (kPacked) {
        store_cols<G>(xbo + i * G, x);
        store_packed<G>(xbp, d, x);
      } else {
        store_cols<G>(xb + d * G, x);
      }
    }
    cluster.sync();   // X1
    // 2. the sum-gamma trace of frame u + 1 (in the fast mode the sum of
    //    the unscaled masses, times 1 / s_{u+1}); the peers' rows of xb
    if (u + 1 < t_max && rank == 0 && tid == 0) {
      float s[G];
      cluster_rank_sum<G>(slot_gs, s);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (u + 1 >= Tb[g]) continue;
        if (kFast) s[g] = __fmul_rn(s[g], __fdiv_rn(1.0f, s_ys[row0[g] + u]));
        gs[row0[g] + u + 1] = debug ? s[g] : 1.0f;
      }
    }
    cluster_gather_cols<W>(xb, s_pad, rank, lc);
    __syncthreads();

    // 3. own rows: beta', c1, c2, partials
    const bool traces = debug || u == 0;
    float inv_s[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      inv_s[g] = __fdiv_rn(1.0f, u == 0 ? *s0 : s_ys[row0[g] + u - 1]);
    float part[2 * G];
#pragma unroll
    for (int g = 0; g < 2 * G; ++g) part[g] = 0.0f;
    for (int i = tid; i < n; i += FACT_THREADS) {
      const int d = cluster_row(i, rank, C);
      float w1t[G], w2t[G], xbd[G], bdv[G];
      if constexpr (kPacked)
        sell_row_dot_packed<G>(w1t_ptr, w1t_pack, d, xbp, w1t);
      else
        sell_row_dot_cols<G, S>(w1t_ptr, w1t_col, w1t_val, d, xb, w1t);
#pragma unroll
      for (int g = 0; g < G; ++g) w2t[g] = 0.0f;
      {
        const int lane = d & 31;
        const int slice = d >> 5;
        const int end = __ldg(w2t_ptr + slice + 1);
        for (int e = __ldg(w2t_ptr + slice); e < end; ++e) {
          int j;
          float w;
          if constexpr (kPacked) {
            const unsigned word = __ldg(w2t_pack + e * 32 + lane);
            j = slot_col(word);
            w = slot_val(word);
          } else {
            j = __ldg(w2t_col + e * 32 + lane);
            w = __ldg(w2t_val + e * 32 + lane);
          }
          float bj[G];
          load_cols_l2<G>(bn + j * G, bj);
#pragma unroll
          for (int g = 0; g < G; ++g)
            w2t[g] = fmaf(w, round_to<S>(bj[g]), w2t[g]);
        }
      }
      load_cols<G>(kPacked ? xbo + i * G : xb + d * G, xbd);
      load_cols_l2<G>(bd + d * G, bdv);
      const float lk = leaky[d];
      if constexpr (kFast) {
        // the diagonal stratum: float32 values, the row's unrounded
        // x_dst * b and b
        float bv[G];
        load_cols_l2<G>(bn + d * G, bv);
        const float d1 = __ldg(diag1 + d), d2 = __ldg(diag2 + d);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          w1t[g] = __fadd_rn(w1t[g], __fmul_rn(d1, xbd[g]));
          w2t[g] = __fadd_rn(w2t[g], __fmul_rn(d2, bv[g]));
        }
      }
      float m1v[G], m2v[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const size_t o = (row0[g] + u) * s_pad + d;
        const float xs = stream_get((identity ? xdst_ys : xsrc_ys) + o);
        const float sw = __fmul_rn(xs, w2t[g]);
        const float bdt = __fmul_rn(__fadd_rn(w1t[g], sw), inv_s[g]);
        const float adu = u == 0 ? ad0[d] : stream_get(ad_ys + o - s_pad);
        const float w1ad = stream_get(w1ad_ys + o);
        if constexpr (kFast) {
          // each state's mass unscaled, rounded before its pdf's sum
          const float m1 = __fmul_rn(xbd[g], w1ad);
          const float m2 = __fmul_rn(sw, adu);
          m1v[g] = round_to<S>(identity ? __fadd_rn(m1, m2) : m1);
          m2v[g] = round_to<S>(m2);
          if (u < Tb[g]) {
            bdv[g] = bdt;
            part[g] = __fadd_rn(part[g], __fmul_rn(bdt, lk));
            if (traces)
              part[G + g] = __fadd_rn(part[G + g], __fmul_rn(adu, bdt));
          }
        } else {
          const float m1 = __fmul_rn(__fmul_rn(xbd[g], w1ad), inv_s[g]);
          const float m2 = __fmul_rn(__fmul_rn(sw, adu), inv_s[g]);
          m1v[g] = identity ? __fadd_rn(m1, m2) : m1;
          m2v[g] = m2;
          if (u < Tb[g]) {
            bdv[g] = bdt;
            part[g] = fmaf(bdt, lk, part[g]);
            if (traces) part[G + g] = fmaf(adu, bdt, part[G + g]);
          }
        }
      }
      store_cols_l2<G>(bd + d * G, bdv);
      if constexpr (kPacked) {
        store_packed<G>(reinterpret_cast<unsigned*>(c1), i, m1v);
        if (!identity) store_packed<G>(reinterpret_cast<unsigned*>(c2), i, m2v);
      } else {
        store_cols<G>(c1 + i * G, m1v);
        if (!identity) store_cols<G>(c2 + i * G, m2v);
      }
    }
    block_sum<2 * G>(part, red);
    if (tid == 0) {
#pragma unroll
      for (int g = 0; g < 2 * G; ++g) slot_la[g] = part[g];
    }
    cluster.sync();   // X2
    // 4. the leaky sums and the alpha*beta trace, rank order
    cluster_rank_sum<2 * G>(slot_la, part);
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (u < Tb[g]) leak[g] = part[g];
    if (rank == 0 && tid == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (u < Tb[g]) ab[row0[g] + u] = traces ? part[G + g] : 1.0f;
    }

    // 5. gamma on this CTA's pdf columns
    float pg[G];
#pragma unroll
    for (int g = 0; g < G; ++g) pg[g] = 0.0f;
    for (int p = p0 + tid; p < p1; p += FACT_THREADS) {
      float acc[G];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g] = 0.0f;
      if (p < n_pdf_lists) {
        float m[G];
        const int fe = __ldg(f_ptr + p + 1);
        for (int k = __ldg(f_ptr + p); k < fe; ++k) {
          if constexpr (kPacked)
            cluster_load_packed<G>(reinterpret_cast<const unsigned*>(c1),
                                   __ldg(f_states + k), rank, m);
          else
            cluster_load_cols<G>(c1, __ldg(f_states + k), rank, m);
#pragma unroll
          for (int g = 0; g < G; ++g) acc[g] += m[g];
        }
        if (!identity) {
          const int ge = __ldg(g_ptr + p + 1);
          for (int k = __ldg(g_ptr + p); k < ge; ++k) {
            if constexpr (kPacked)
              cluster_load_packed<G>(reinterpret_cast<const unsigned*>(c2),
                                     __ldg(g_states + k), rank, m);
            else
              cluster_load_cols<G>(c2, __ldg(g_states + k), rank, m);
#pragma unroll
            for (int g = 0; g < G; ++g) acc[g] += m[g];
          }
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        if (u < Tb[g])
          __stcs(gamma + (row0[g] + u) * P + p,
                 kFast ? round_to<S>(__fmul_rn(acc[g], inv_s[g])) : acc[g]);
        if (traces) pg[g] += acc[g];
      }
    }
    block_sum<G>(pg, red);
    if (tid == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) slot_gs[g] = pg[g];
    }
  }
  cluster.sync();
  if (rank == 0 && tid == 0) {    // the sum-gamma trace of frame 0
    float s[G];
    cluster_rank_sum<G>(slot_gs, s);
#pragma unroll
    for (int g = 0; g < G; ++g)
      if (b0 + g < B)
        gs[row0[g]] = kFast ? __fmul_rn(s[g], __fdiv_rn(1.0f, *s0)) : s[g];
  }
  cluster.sync();
}

extern "C" size_t stream_bwd_smem_bytes(int s_pad, int rows, int identity,
                                        int columns, int packed) {
  const size_t G = static_cast<size_t>(columns);
  const size_t W = packed ? G / 2 : G;
  return (static_cast<size_t>(s_pad) * W +
          (packed ? static_cast<size_t>(rows) * G : 0) +
          (identity ? 1 : 2) * static_cast<size_t>(rows) * W +
          2 * FACT_WARPS * G + 5 * G) * sizeof(float);
}

// Ask for the kernel's shared memory and count the clusters of this shape
// the card can hold at once (cudaOccupancyMaxActiveClusters).
template <typename S, int G, bool kPacked>
static cudaError_t prepare(size_t smem, cudaLaunchConfig_t* cfg,
                           int* active) {
  cudaError_t err = fact_set_smem(stream_bwd_kernel<S, G, kPacked>, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(
      active, stream_bwd_kernel<S, G, kPacked>, cfg);
}

template <typename S, int G, bool kPacked>
static int launch(const void* lengths, const void* ad_ys,
                  const void* w1ad_ys, const void* xdst_ys,
                  const void* xsrc_ys, const void* s_ys, const void* s0,
                  const void* ad0, const void* final_p, const void* tot,
                  const void* leaky, const void* w1t_ptr,
                  const void* w1t_col, const void* w1t_val,
                  const void* w1t_pack, const void* w2t_ptr,
                  const void* w2t_col, const void* w2t_val,
                  const void* w2t_pack, const void* diag1, const void* diag2,
                  const void* f_ptr, const void* f_states, const void* g_ptr,
                  const void* g_states, int n_pdf_lists, float leaky_c,
                  int B, int T, int P, int s_pad, int cluster, int rows,
                  int debug, void* carry, void* gamma, void* ab, void* gs,
                  void* stream) {
  const size_t smem =
      stream_bwd_smem_bytes(s_pad, rows, xsrc_ys == nullptr, G, kPacked);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config((B + G - 1) / G, cluster, smem, stream, attr);
  int active = 0;
  cudaError_t err = prepare<S, G, kPacked>(smem, &cfg, &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return -1;
  err = cudaLaunchKernelEx(
      &cfg, stream_bwd_kernel<S, G, kPacked>,
      static_cast<const int*>(lengths),
      static_cast<const S*>(ad_ys), static_cast<const S*>(w1ad_ys),
      static_cast<const S*>(xdst_ys), static_cast<const S*>(xsrc_ys),
      static_cast<const float*>(s_ys), static_cast<const float*>(s0),
      static_cast<const float*>(ad0), static_cast<const float*>(final_p),
      static_cast<const float*>(tot), static_cast<const float*>(leaky),
      static_cast<const int*>(w1t_ptr), static_cast<const int*>(w1t_col),
      static_cast<const float*>(w1t_val),
      static_cast<const unsigned*>(w1t_pack),
      static_cast<const int*>(w2t_ptr), static_cast<const int*>(w2t_col),
      static_cast<const float*>(w2t_val),
      static_cast<const unsigned*>(w2t_pack),
      static_cast<const float*>(diag1), static_cast<const float*>(diag2),
      static_cast<const int*>(f_ptr), static_cast<const int*>(f_states),
      static_cast<const int*>(g_ptr), static_cast<const int*>(g_states),
      n_pdf_lists, leaky_c, B, T, P, s_pad, rows, debug,
      static_cast<float*>(carry), static_cast<float*>(gamma),
      static_cast<float*>(ab), static_cast<float*>(gs));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The clusters of this shape the card holds at once, or minus a
// cudaError_t; fast: the bfloat16 form's, packed (fast, G = 2 or 4): its
// packed layout's.
extern "C" int stream_bwd_active_clusters(int s_pad, int rows, int identity,
                                          int cluster, int columns,
                                          int fast, int packed) {
  const size_t smem =
      stream_bwd_smem_bytes(s_pad, rows, identity, columns, packed);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(1, cluster, smem, nullptr, attr);
  int active = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define STREAM_BWD_PREPARE(G)                                              \
  if (columns == G && !packed)                                             \
    err = fast ? prepare<__nv_bfloat16, G, false>(smem, &cfg, &active)     \
               : prepare<float, G, false>(smem, &cfg, &active);
  STREAM_BWD_PREPARE(1)
  STREAM_BWD_PREPARE(2)
  STREAM_BWD_PREPARE(4)
#undef STREAM_BWD_PREPARE
  if (packed && fast && columns == 2)
    err = prepare<__nv_bfloat16, 2, true>(smem, &cfg, &active);
  if (packed && fast && columns == 4)
    err = prepare<__nv_bfloat16, 4, true>(smem, &cfg, &active);
  return err == cudaSuccess ? active : -static_cast<int>(err);
}

template <typename S, bool kPacked>
static int run(const void* lengths, const void* ad_ys, const void* w1ad_ys,
               const void* xdst_ys, const void* xsrc_ys, const void* s_ys,
               const void* s0, const void* ad0, const void* final_p,
               const void* tot, const void* leaky, const void* w1t_ptr,
               const void* w1t_col, const void* w1t_val,
               const void* w1t_pack, const void* w2t_ptr,
               const void* w2t_col, const void* w2t_val,
               const void* w2t_pack, const void* diag1, const void* diag2,
               const void* f_ptr, const void* f_states, const void* g_ptr,
               const void* g_states, int n_pdf_lists, float leaky_c, int B,
               int T, int P, int s_pad, int cluster, int columns, int rows,
               int debug, void* carry, void* gamma, void* ab, void* gs,
               void* stream) {
  switch (columns) {
#define STREAM_BWD_CASE(G)                                                 \
  case G:                                                                  \
    if constexpr (!kPacked || G > 1)                        \
      return launch<S, G, kPacked>(                                        \
          lengths, ad_ys, w1ad_ys, xdst_ys, xsrc_ys, s_ys, s0, ad0,        \
          final_p, tot, leaky, w1t_ptr, w1t_col, w1t_val, w1t_pack,        \
          w2t_ptr, w2t_col, w2t_val, w2t_pack, diag1, diag2, f_ptr,        \
          f_states, g_ptr, g_states, n_pdf_lists, leaky_c, B, T, P,        \
          s_pad, cluster, rows, debug, carry, gamma, ab, gs, stream);      \
    return static_cast<int>(cudaErrorInvalidValue);
    STREAM_BWD_CASE(1)
    STREAM_BWD_CASE(2)
    STREAM_BWD_CASE(4)
#undef STREAM_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Returns 0 on success, a cudaError_t, or -1 when
// cudaOccupancyMaxActiveClusters says no cluster of this shape can be
// resident.  columns (G) is 1, 2 or 4; cluster (C) 1, 2, 4 or 8.
extern "C" int stream_bwd_launch(
    const void* lengths, const void* ad_ys, const void* w1ad_ys,
    const void* xdst_ys, const void* xsrc_ys, const void* s_ys,
    const void* s0, const void* ad0, const void* final_p, const void* tot,
    const void* leaky, const void* w1t_ptr, const void* w1t_col,
    const void* w1t_val, const void* w2t_ptr, const void* w2t_col,
    const void* w2t_val, const void* f_ptr, const void* f_states,
    const void* g_ptr, const void* g_states, int n_pdf_lists,
    float leaky_c, int B, int T, int P, int s_pad, int cluster, int columns,
    int rows, int debug, void* carry, void* gamma, void* ab, void* gs,
    void* stream) {
  return run<float, false>(
      lengths, ad_ys, w1ad_ys, xdst_ys, xsrc_ys, s_ys, s0, ad0, final_p, tot,
      leaky, w1t_ptr, w1t_col, w1t_val, nullptr, w2t_ptr, w2t_col, w2t_val,
      nullptr, nullptr, nullptr, f_ptr, f_states, g_ptr, g_states,
      n_pdf_lists, leaky_c, B, T, P, s_pad, cluster, columns, rows, debug,
      carry, gamma, ab, gs, stream);
}

// The fast mode: bfloat16 streams, the operators' off-diagonal entries
// alone (bfloat16 values held in float32, and the same slots packed a word
// each, fact_kernels.pack_slots), float32 diagonals diag1 (W1's) and diag2
// (W2's).  packed (G = 2 or 4): the packed layout, which reads the packed
// slots; else the float32 copy, which reads the column ids and values.
extern "C" int stream_bwd_bf16_launch(
    const void* lengths, const void* ad_ys, const void* w1ad_ys,
    const void* xdst_ys, const void* xsrc_ys, const void* s_ys,
    const void* s0, const void* ad0, const void* final_p, const void* tot,
    const void* leaky, const void* w1t_ptr, const void* w1t_col,
    const void* w1t_val, const void* w1t_pack, const void* w2t_ptr,
    const void* w2t_col, const void* w2t_val, const void* w2t_pack,
    const void* diag1, const void* diag2, const void* f_ptr,
    const void* f_states, const void* g_ptr, const void* g_states,
    int n_pdf_lists, float leaky_c, int B, int T, int P, int s_pad,
    int cluster, int columns, int rows, int packed, int debug, void* carry,
    void* gamma, void* ab, void* gs, void* stream) {
  return (packed ? run<__nv_bfloat16, true> : run<__nv_bfloat16, false>)(
      lengths, ad_ys, w1ad_ys, xdst_ys, xsrc_ys, s_ys, s0, ad0, final_p, tot,
      leaky, w1t_ptr, w1t_col, w1t_val, w1t_pack, w2t_ptr, w2t_col, w2t_val,
      w2t_pack, diag1, diag2, f_ptr, f_states, g_ptr, g_states, n_pdf_lists,
      leaky_c, B, T, P, s_pad, cluster, columns, rows, debug, carry, gamma,
      ab, gs, stream);
}
