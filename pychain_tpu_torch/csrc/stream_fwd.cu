// Denominator alpha sweep for graphs whose working set exceeds one SM's
// shared memory: one thread-block cluster per group of G batch columns,
// float32 and fast mode.
//
// Replaces pychain_tpu/ops/pallas_stream.py::_fwd_kernel_factory
// (launched there by _fwd_stream), which computes what
// pallas_fact.py::_fwd_kernel_factory (B1, here fact_fwd.cu) computes, in
// "full" stream mode, for graphs past the TPU kernel's VMEM, in both its
// precisions: float32 (stream_fwd_launch) and the fast mode of bfloat16
// tiles (stream_fwd_bf16_launch).  Per frame t
// of column b, the recurrence of fact_fwd.cu:
//
//   x_dst = px_t[f_dst]            x_src = px_t[g_src]  (= x_dst in
//                                                        identity mode)
//   alpha = (x_dst * (W1 alpha') + W2 (x_src * alpha')) / s_{t-1}
//   s_t = sum(alpha)               alpha' = alpha + c * s_t * leaky
//
// with the same outputs: the (B, T, S_pad) streams alpha'(t+1),
// W1 alpha'(t), x_dst(t) (and x_src(t) outside identity mode), s_t (B, T;
// 1 past the column's end) and alpha' at the column's last frame.
//
// Design.  On the TPU the kernel streams W1's 128 x 128 tiles from HBM in
// chunks, because the graph's weights do not fit VMEM.  The port never
// holds the weights on chip (W1/W2 are sliced-ELL rows read through L2,
// as in fact_fwd.cu); what outgrows one SM here is the working set.  A
// cluster of C CTAs serves G columns; CTA r owns the 32-row slices
// r, r + C, ... (R rows: cluster_row, fact_common.cuh) in all G columns.
// It holds whole only the vector W1 gathers, alpha' of the G columns
// interleaved (S_pad G floats), so that one entry's column id and value,
// loaded once from L2, and one G-wide shared-memory load feed G products
// (sell_row_dot_cols).  W2 has at most one entry a row in the
// repository's graphs; its product reads x_src * alpha' at the entry's
// source from the whole alpha' and a gather of px (the source's pdf per
// entry, w2_pdf), so no peer's u = x_src * alpha' is needed.  The rows'
// alpha before the leaky term sit in a (R, G) buffer that peers read,
// two of them by frame parity when C > 1.  A frame t:
//   head (t > 0; after the cluster barrier of frame t - 1):
//     1. s_{t-1} per column: the C CTAs' partials in rank order (bit-
//        identical in every CTA);
//     2. alpha'(t) = alpha + c s_{t-1} leaky for every state, each row
//        read from its owner's buffer (16-byte DSMEM loads), into the
//        whole copy; the owner writes its rows to the alpha' stream
//        (frame t - 1) and alpha'(T_b); block barrier;
//   tail (t < T_max):
//     3. its rows: emissions, x_dst / x_src streams, W1 alpha' and W2 u
//        for the G columns, alpha into the buffer of parity t, the W1
//        alpha' stream, the block's partials of s_t;
//     4. partials posted to the slot of parity t; one cluster barrier.
// One cluster barrier a frame: a CTA writes frame t + 1's buffer and slot
// only after the barrier of frame t + 1, which every peer passes after
// its reads of frame t's (head of frame t + 1 reads parity t; it writes
// parity t + 1 in its tail).  Columns of a group may differ in length:
// the group runs to its longest, T_max, and a finished column's outputs
// are not written (s_ys 1 past the end).  A last cluster barrier keeps
// every CTA's shared memory alive until no peer can read it.
// The per-column arithmetic is written with explicit rounding (fmaf,
// __fmul_rn, __fadd_rn, __fdiv_rn), so that no multiply-add the compiler
// would fuse differs between the G instantiations: a column's results
// are bit-identical at every G for a given C.
//
// Bound on an H100 at main path 4 (S_pad = 12,032, P = 6,000, B = 128,
// T = 500, x_src "stream"): the sweep must read px once (1.5 GB) and
// write four (T, S_pad, B) float32 streams (12.3 GB): about 13.9 GB,
// 4.1 ms at 3.35 TB/s; the arc products, 2 * 198k * B * T = 25 GFLOP, take
// 0.38 ms at 67 TFLOP/s.  The bound is the bytes.  Stream writes are
// coalesced (a warp's rows are one slice) and marked evict-first
// (__stcs); the sparse rows are read from L2 once per G columns a frame.
//
// The fast mode rounds where the Pallas kernel does with bfloat16 tiles
// (pallas_stream.py:318-460, the rounding points of fact_fwd.cu): px as it
// is read, the operands of W1's and W2's off-diagonal products (their
// entries bfloat16 values held in float32, the graph's fast form; the
// diagonals apart in float32 with unrounded operands) and the four
// streams, written as bfloat16.  The whole alpha' copy stays float32 and
// unrounded, since the diagonal and W2's operand x_src * alpha' need the
// unrounded value: each W1 gather rounds what it reads
// (sell_row_dot_cols<G, S>), and W2's operand is rounded after its
// product: the float layout, whose shared memory and limits are the
// float32 mode's.  alpha is scaled by 1 / s_{t-1}, the leaky term added
// unfused, each product and sum rounded on its own (__fmul_rn, __fadd_rn)
// in the order of the plain version (ops/factorized.forward_prob_fast with
// cluster = C: each row's slots, then the diagonal; each CTA's block_sum,
// then the CTAs in rank order), which this kernel equals bit for bit.
// Its bytes bound at main path 4 falls to about 2.3 ms (px 1.54 GB and
// four 2-byte streams of 1.54 GB each).
//
// The fast mode's packed layout (G = 2 or 4; stream_kernels.plan takes
// it where it fits, main path 4 at C = G = 2).  On an H100 the float
// layout's W1 product waits on its operator's reads from L2, and not on
// L2's bandwidth: at B = 8 (4 clusters) a launch takes 97% of B = 128's,
// with the operator in L1 41% less (PERF.md).  So the packed
// layout cuts what a slot costs: each slot is one 4-byte word (the
// column id in the low 16 bits, the bfloat16 value's bits in the high
// 16: fact_kernels.pack_slots; every id of the tier fits 16 bits and the
// fast values are bfloat16 values, so nothing rounds), and the whole
// alpha' copy is held rounded and packed (S_pad G / 2 words, G = 4 where
// the float layout holds 2), which round_to at each gather would give.
// The head packs each 16-byte read of a peer's alpha into 8 bytes.  W2's
// operand and the diagonal need alpha' unrounded: a row reads the
// source's alpha from its owner's buffer (DSMEM; W2 has at most one entry
// a row in the repository's graphs) and adds the leaky term as the head
// does, so two alpha buffers by parity at every C.  The same products in
// the same order: the float layout's bits.  At main path 4 (C = G = 2)
// B3 fast falls 12% (14.28 -> 12.61 ms); (4, 4) fits but takes two waves
// (an H100 holds 30 clusters of 4 CTAs this size).

#include "fact_common.cuh"

// S: the stream type, float (float32 mode) or __nv_bfloat16 (fast mode).
// kPacked: the fast mode's packed layout (G = 2 or 4): the slots of W1
// and W2 one word each (w1_pack, w2_pack), alpha' kept whole rounded and
// packed (S_pad G / 2 words), W2's operand and the diagonal's alpha'
// taken from the owner's alpha buffer.
template <typename S, int G, bool kPacked>
__global__ void __launch_bounds__(FACT_THREADS, 1) stream_fwd_kernel(
    const float* __restrict__ px,        // (B, T, P) exp'd nnet output
    const int* __restrict__ lengths,     // (B,)  1 <= T_b <= T
    const int* __restrict__ f_dst,       // (S_pad,) pdf of each state's W1 term
    const int* __restrict__ g_src,       // (S_pad,) or null (identity mode)
    const int* __restrict__ w1_ptr, const int* __restrict__ w1_col,
    const float* __restrict__ w1_val,    // W1 by destination row
    const unsigned* __restrict__ w1_pack,   // its slots packed (kPacked)
    const int* __restrict__ w2_ptr, const int* __restrict__ w2_col,
    const float* __restrict__ w2_val,    // W2 by destination row
    const unsigned* __restrict__ w2_pack,   // its slots packed (kPacked)
    const int* __restrict__ w2_pdf,      // x_src's pdf at each W2 entry's source
    const float* __restrict__ diag1,     // (S_pad,) W1's diagonal (fast mode)
    const float* __restrict__ diag2,     // (S_pad,) W2's diagonal (fast mode)
    const float* __restrict__ ad0,       // (S_pad,) alpha'(0)
    const float* __restrict__ s0,        // (1,) sum of the initial probs
    const float* __restrict__ leaky,     // (S_pad,)
    float leaky_c, int B, int T, int P, int s_pad, int rows,
    S* __restrict__ ad_ys,               // (B, T, S_pad) alpha'(t+1)
    S* __restrict__ w1ad_ys,             // (B, T, S_pad) W1 alpha'(t)
    S* __restrict__ xdst_ys,             // (B, T, S_pad)
    S* __restrict__ xsrc_ys,             // (B, T, S_pad) or null
    float* __restrict__ s_ys,            // (B, T) s_{t+1}; 1 past the end
    float* __restrict__ ad_last) {       // (B, S_pad) alpha'(T_b)
  constexpr bool kFast = sizeof(S) == 2;
  static_assert(!kPacked || (kFast && G >= 2), "packed: fast, G = 2 or 4");
  constexpr int W = kPacked ? G / 2 : G;   // words a state of the copy
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ float4 smem4[];
  const int tid = threadIdx.x;
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int lc = __ffs(C) - 1;
  // packed: frame t reads frame t - 1's buffer while it writes its own
  const int nbuf = C > 1 || kPacked ? 2 : 1;
  float* ad = reinterpret_cast<float*>(smem4);  // alpha', whole, (S_pad, G)
  unsigned* adp = reinterpret_cast<unsigned*>(smem4);   // packed: (S_pad, W)
  float* abuf = ad + s_pad * W;   // alpha on own rows, nbuf x (R, G)
  float* red = abuf + nbuf * rows * G;          // block_sum scratch
  float* slot = red + FACT_WARPS * G + G;       // partials, 2 x G

  const int b0 = static_cast<int>(blockIdx.x) / C * G;
  const int n = cluster_own_rows(s_pad, rank, C);
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

  for (int s = tid; s < s_pad; s += FACT_THREADS) {
    const float v = ad0[s];
    if constexpr (kPacked) {
      const unsigned h = bf16_bits(v);
#pragma unroll
      for (int j = 0; j < W; ++j) adp[s * W + j] = h | h << 16;
    } else {
#pragma unroll
      for (int g = 0; g < G; ++g) ad[s * G + g] = v;
    }
  }
  float s_prev[G];
  float cs[G];                     // leaky_c * s_{t-1}
#pragma unroll
  for (int g = 0; g < G; ++g) {
    s_prev[g] = *s0;
    cs[g] = 0.0f;
  }
  __syncthreads();

  for (int t = 0; t <= t_max; ++t) {
    if (t > 0) {
      const int par = (t - 1) & 1;
      float s_t[G];
      cluster_rank_sum<G>(slot + par * G, s_t);
#pragma unroll
      for (int g = 0; g < G; ++g) cs[g] = __fmul_rn(leaky_c, s_t[g]);
      const float* a_buf = abuf + (par % nbuf) * rows * G;
      const bool last = t == t_max;
      // 4 interleaved floats a thread: 4 / G rows of one slice, G columns
      for (int q = tid; q < (s_pad * G) >> 2; q += FACT_THREADS) {
        const int j0 = (q << 2) / G;
        const int owner = cluster_owner(j0, lc);
        if (last && owner != rank) continue;
        const float4* src = reinterpret_cast<const float4*>(
            a_buf + cluster_local(j0, lc) * G);
        const float4 a4 = owner == rank ? *src
                                        : *cluster.map_shared_rank(src, owner);
        float e[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float lk = __ldg(leaky + j0 + k / G);
          e[k] = kFast ? __fadd_rn(e[k], __fmul_rn(cs[k % G], lk))
                       : fmaf(cs[k % G], lk, e[k]);
        }
        if (!last) {
          if constexpr (kPacked)    // the 4 values' bfloat16 bits, 8 bytes
            reinterpret_cast<uint2*>(adp)[q] =
                make_uint2(bf16_bits(e[0]) | bf16_bits(e[1]) << 16,
                           bf16_bits(e[2]) | bf16_bits(e[3]) << 16);
          else
            reinterpret_cast<float4*>(ad)[q] =
                make_float4(e[0], e[1], e[2], e[3]);
        }
        if (owner != rank) continue;
        // own rows: the alpha' stream of frame t - 1 and alpha'(T_b)
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (t - 1 >= Tb[g]) continue;
          float v[4 / G];
#pragma unroll
          for (int k = 0; k < 4 / G; ++k) v[k] = e[k * G + g];
          store_cols_stream<4 / G>(ad_ys + (row0[g] + t - 1) * s_pad + j0,
                                   v);
          if (t == Tb[g])
            store_cols<4 / G>(ad_last + static_cast<size_t>(b0 + g) * s_pad + j0,
                              v);
        }
      }
      if (rank == 0 && tid == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g)
          if (t - 1 < Tb[g]) s_ys[row0[g] + t - 1] = s_t[g];
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (t - 1 < Tb[g]) s_prev[g] = s_t[g];
      if (last) break;
      __syncthreads();
    }

    float part[G], r[G];          // r: 1 / s_{t-1} (the fast mode's scale)
#pragma unroll
    for (int g = 0; g < G; ++g) {
      part[g] = 0.0f;
      r[g] = __fdiv_rn(1.0f, s_prev[g]);
    }
    float* a_out = abuf + ((t & 1) % nbuf) * rows * G;
    // packed: alpha of frame t - 1 by local row, in every CTA
    const float* a_in = abuf + (((t - 1) & 1) % nbuf) * rows * G;
    // packed: alpha'(t) at state j, unrounded (ad0 at t = 0, else the
    // owner's alpha plus the leaky term, as the head adds it)
    auto alpha_dash = [&](int j, float (&a)[G]) {
      if (t == 0) {
        const float v = __ldg(ad0 + j);
#pragma unroll
        for (int g = 0; g < G; ++g) a[g] = v;
        return;
      }
      const int owner = cluster_owner(j, lc);
      const float* p = a_in + cluster_local(j, lc) * G;
      load_cols<G>(owner == rank ? p : cluster.map_shared_rank(p, owner), a);
      const float lk = __ldg(leaky + j);
#pragma unroll
      for (int g = 0; g < G; ++g) a[g] = __fadd_rn(a[g], __fmul_rn(cs[g], lk));
    };
    for (int i = tid; i < n; i += FACT_THREADS) {
      const int d = cluster_row(i, rank, C);
      const int fd = f_dst[d];
      const int gd = g_src ? g_src[d] : fd;
      float x[G], xs[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* px_t = px + (row0[g] + t) * P;
        x[g] = round_to<S>(__ldg(px_t + fd));
        xs[g] = g_src ? round_to<S>(__ldg(px_t + gd)) : x[g];
      }
      float w1a[G];
      if constexpr (kPacked)
        sell_row_dot_packed<G>(w1_ptr, w1_pack, d, adp, w1a);
      else
        sell_row_dot_cols<G, S>(w1_ptr, w1_col, w1_val, d, ad, w1a);
      float w2u[G];
#pragma unroll
      for (int g = 0; g < G; ++g) w2u[g] = 0.0f;
      {
        const int lane = d & 31;
        const int slice = d >> 5;
        const int end = __ldg(w2_ptr + slice + 1);
        for (int k = __ldg(w2_ptr + slice); k < end; ++k) {
          const int e = k * 32 + lane;
          const int pdf = __ldg(w2_pdf + e);
          float w, a[G];
          if constexpr (kPacked) {
            const unsigned word = __ldg(w2_pack + e);
            w = slot_val(word);
            alpha_dash(slot_col(word), a);
          } else {
            w = __ldg(w2_val + e);
            load_cols<G>(ad + __ldg(w2_col + e) * G, a);
          }
#pragma unroll
          for (int g = 0; g < G; ++g) {
            // fast mode: bfloat16(bfloat16(x_src) * alpha'), exact in the
            // product with the bfloat16 entry w
            const float u = round_to<S>(__fmul_rn(
                round_to<S>(__ldg(px + (row0[g] + t) * P + pdf)), a[g]));
            w2u[g] = fmaf(w, u, w2u[g]);
          }
        }
      }
      float al[G];
      if constexpr (kFast) {
        // the diagonal stratum: float32 values, the row's unrounded
        // alpha' (the plain version's order, bit for bit)
        float own[G];
        if constexpr (kPacked)
          alpha_dash(d, own);
        else
          load_cols<G>(ad + d * G, own);
        const float d1 = __ldg(diag1 + d), d2 = __ldg(diag2 + d);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          w1a[g] = __fadd_rn(w1a[g], __fmul_rn(d1, own[g]));
          w2u[g] = __fadd_rn(w2u[g], __fmul_rn(d2, __fmul_rn(xs[g], own[g])));
          al[g] = __fmul_rn(__fadd_rn(__fmul_rn(x[g], w1a[g]), w2u[g]), r[g]);
        }
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g)
          al[g] = __fdiv_rn(fmaf(x[g], w1a[g], w2u[g]), s_prev[g]);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        part[g] += al[g];
        if (t < Tb[g]) {
          const size_t o = (row0[g] + t) * s_pad + d;
          stream_put(xdst_ys + o, x[g]);
          if (xsrc_ys) stream_put(xsrc_ys + o, xs[g]);
          stream_put(w1ad_ys + o, w1a[g]);
        }
      }
      store_cols<G>(a_out + i * G, al);
    }
    block_sum<G>(part, red);
    if (tid == 0) {
#pragma unroll
      for (int g = 0; g < G; ++g) slot[(t & 1) * G + g] = part[g];
    }
    cluster.sync();
  }
  if (rank == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (b0 + g >= B) continue;
      for (int t = Tb[g] + tid; t < T; t += FACT_THREADS)
        s_ys[row0[g] + t] = 1.0f;
    }
  }
  cluster.sync();
}

extern "C" size_t stream_fwd_smem_bytes(int s_pad, int rows, int cluster,
                                        int columns, int packed) {
  const size_t G = static_cast<size_t>(columns);
  const size_t W = packed ? G / 2 : G;
  const size_t nbuf = cluster > 1 || packed ? 2 : 1;
  return (static_cast<size_t>(s_pad) * W + nbuf * rows * G +
          FACT_WARPS * G + 3 * G) * sizeof(float);
}

// Ask for the kernel's shared memory and count the clusters of this shape
// the card can hold at once (cudaOccupancyMaxActiveClusters).
template <typename S, int G, bool kPacked>
static cudaError_t prepare(size_t smem, cudaLaunchConfig_t* cfg,
                           int* active) {
  cudaError_t err = fact_set_smem(stream_fwd_kernel<S, G, kPacked>, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveClusters(
      active, stream_fwd_kernel<S, G, kPacked>, cfg);
}

template <typename S, int G, bool kPacked>
static int launch(const void* px, const void* lengths, const void* f_dst,
                  const void* g_src, const void* w1_ptr, const void* w1_col,
                  const void* w1_val, const void* w1_pack,
                  const void* w2_ptr, const void* w2_col,
                  const void* w2_val, const void* w2_pack,
                  const void* w2_pdf, const void* diag1,
                  const void* diag2, const void* ad0, const void* s0,
                  const void* leaky, float leaky_c, int B, int T, int P,
                  int s_pad, int cluster, int rows, void* ad_ys,
                  void* w1ad_ys, void* xdst_ys, void* xsrc_ys, void* s_ys,
                  void* ad_last, void* stream) {
  const size_t smem = stream_fwd_smem_bytes(s_pad, rows, cluster, G, kPacked);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config((B + G - 1) / G, cluster, smem, stream, attr);
  int active = 0;
  cudaError_t err = prepare<S, G, kPacked>(smem, &cfg, &active);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return -1;
  err = cudaLaunchKernelEx(
      &cfg, stream_fwd_kernel<S, G, kPacked>, static_cast<const float*>(px),
      static_cast<const int*>(lengths), static_cast<const int*>(f_dst),
      static_cast<const int*>(g_src), static_cast<const int*>(w1_ptr),
      static_cast<const int*>(w1_col), static_cast<const float*>(w1_val),
      static_cast<const unsigned*>(w1_pack),
      static_cast<const int*>(w2_ptr), static_cast<const int*>(w2_col),
      static_cast<const float*>(w2_val),
      static_cast<const unsigned*>(w2_pack),
      static_cast<const int*>(w2_pdf),
      static_cast<const float*>(diag1), static_cast<const float*>(diag2),
      static_cast<const float*>(ad0), static_cast<const float*>(s0),
      static_cast<const float*>(leaky), leaky_c, B, T, P, s_pad, rows,
      static_cast<S*>(ad_ys), static_cast<S*>(w1ad_ys),
      static_cast<S*>(xdst_ys), static_cast<S*>(xsrc_ys),
      static_cast<float*>(s_ys), static_cast<float*>(ad_last));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The clusters of this shape the card holds at once, or minus a
// cudaError_t; fast: the bfloat16 form's, packed (fast, G = 2 or 4): its
// packed layout's.
extern "C" int stream_fwd_active_clusters(int s_pad, int rows, int cluster,
                                          int columns, int fast,
                                          int packed) {
  const size_t smem =
      stream_fwd_smem_bytes(s_pad, rows, cluster, columns, packed);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(1, cluster, smem, nullptr, attr);
  int active = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define STREAM_FWD_PREPARE(G)                                               \
  if (columns == G && !packed)                                              \
    err = fast ? prepare<__nv_bfloat16, G, false>(smem, &cfg, &active)      \
               : prepare<float, G, false>(smem, &cfg, &active);
  STREAM_FWD_PREPARE(1)
  STREAM_FWD_PREPARE(2)
  STREAM_FWD_PREPARE(4)
#undef STREAM_FWD_PREPARE
  if (packed && fast && columns == 2)
    err = prepare<__nv_bfloat16, 2, true>(smem, &cfg, &active);
  if (packed && fast && columns == 4)
    err = prepare<__nv_bfloat16, 4, true>(smem, &cfg, &active);
  return err == cudaSuccess ? active : -static_cast<int>(err);
}

template <typename S, bool kPacked>
static int run(const void* px, const void* lengths, const void* f_dst,
               const void* g_src, const void* w1_ptr, const void* w1_col,
               const void* w1_val, const void* w1_pack, const void* w2_ptr,
               const void* w2_col, const void* w2_val, const void* w2_pack,
               const void* w2_pdf, const void* diag1, const void* diag2,
               const void* ad0, const void* s0, const void* leaky,
               float leaky_c, int B, int T, int P, int s_pad, int cluster,
               int columns, int rows, void* ad_ys, void* w1ad_ys,
               void* xdst_ys, void* xsrc_ys, void* s_ys, void* ad_last,
               void* stream) {
  switch (columns) {
#define STREAM_FWD_CASE(G)                                                  \
  case G:                                                                   \
    if constexpr (!kPacked || G > 1)                         \
      return launch<S, G, kPacked>(                                         \
          px, lengths, f_dst, g_src, w1_ptr, w1_col, w1_val, w1_pack,       \
          w2_ptr, w2_col, w2_val, w2_pack, w2_pdf, diag1, diag2, ad0, s0,   \
          leaky, leaky_c, B, T, P, s_pad, cluster, rows, ad_ys, w1ad_ys,    \
          xdst_ys, xsrc_ys, s_ys, ad_last, stream);                         \
    return static_cast<int>(cudaErrorInvalidValue);
    STREAM_FWD_CASE(1)
    STREAM_FWD_CASE(2)
    STREAM_FWD_CASE(4)
#undef STREAM_FWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Returns 0 on success, a cudaError_t, or -1 when
// cudaOccupancyMaxActiveClusters says no cluster of this shape can be
// resident.  columns (G) is 1, 2 or 4; cluster (C) 1, 2, 4 or 8.
extern "C" int stream_fwd_launch(
    const void* px, const void* lengths, const void* f_dst,
    const void* g_src, const void* w1_ptr, const void* w1_col,
    const void* w1_val, const void* w2_ptr, const void* w2_col,
    const void* w2_val, const void* w2_pdf, const void* ad0, const void* s0,
    const void* leaky, float leaky_c, int B, int T, int P, int s_pad,
    int cluster, int columns, int rows, void* ad_ys, void* w1ad_ys,
    void* xdst_ys, void* xsrc_ys, void* s_ys, void* ad_last, void* stream) {
  return run<float, false>(
      px, lengths, f_dst, g_src, w1_ptr, w1_col, w1_val, nullptr, w2_ptr,
      w2_col, w2_val, nullptr, w2_pdf, nullptr, nullptr, ad0, s0, leaky,
      leaky_c, B, T, P, s_pad, cluster, columns, rows, ad_ys, w1ad_ys,
      xdst_ys, xsrc_ys, s_ys, ad_last, stream);
}

// The fast mode: bfloat16 streams, the operators' off-diagonal entries
// alone (bfloat16 values held in float32, and the same slots packed a word
// each, fact_kernels.pack_slots; w2_pdf in that W2's layout), float32
// diagonals diag1 (W1's) and diag2 (W2's).  packed (G = 2 or 4): the
// packed layout, which reads the packed slots; else the float32 copy,
// which reads the column ids and values.
extern "C" int stream_fwd_bf16_launch(
    const void* px, const void* lengths, const void* f_dst,
    const void* g_src, const void* w1_ptr, const void* w1_col,
    const void* w1_val, const void* w1_pack, const void* w2_ptr,
    const void* w2_col, const void* w2_val, const void* w2_pack,
    const void* w2_pdf, const void* diag1, const void* diag2,
    const void* ad0, const void* s0, const void* leaky, float leaky_c,
    int B, int T, int P, int s_pad, int cluster, int columns, int rows,
    int packed, void* ad_ys, void* w1ad_ys, void* xdst_ys, void* xsrc_ys,
    void* s_ys, void* ad_last, void* stream) {
  return (packed ? run<__nv_bfloat16, true> : run<__nv_bfloat16, false>)(
      px, lengths, f_dst, g_src, w1_ptr, w1_col, w1_val, w1_pack, w2_ptr,
      w2_col, w2_val, w2_pack, w2_pdf, diag1, diag2, ad0, s0, leaky,
      leaky_c, B, T, P, s_pad, cluster, columns, rows, ad_ys, w1ad_ys,
      xdst_ys, xsrc_ys, s_ys, ad_last, stream);
}
