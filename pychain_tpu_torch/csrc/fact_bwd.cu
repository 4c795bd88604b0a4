// Denominator beta sweep and posteriors on the factorized graph, float32
// and fast mode.
//
// Replaces pychain_tpu/ops/pallas_fact.py::_bwd_kernel_factory (launched
// there by _bwd_pallas) in its three stream modes and in both its
// precisions, float32 and the fast mode of bfloat16 tiles (the _bf16
// entry points): it reads the streams fact_fwd.cu wrote.  Per frame u of
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
// The stream modes (pallas_fact.py:475-545, :786-807):
//
// * fact_bwd ("full"): the rows of alpha', W1 alpha' and x_dst (x_src)
//   that fact_fwd wrote;
// * fact_bwd_lean ("lean", w1/ef/eg passed in, :488-492): alpha' rows
//   alone (fact_fwd_snap at C = 1); it gathers x_dst(u) and x_src(u) from
//   px itself, as fact_fwd does, and forms W1 alpha'(u) from W1's rows by
//   destination (fact_fwd's operator, in fact_fwd's row loop: the same
//   sums in the same order) over alpha'(u) held whole in shared memory.
//   In the fast mode that product is a float32 sum of bfloat16 products
//   plus the diagonal term of the stored (bfloat16) alpha', and is not
//   rounded (:597-601), where the full mode reads fact_fwd's bfloat16 row;
// * fact_bwd_chunk (the ckpt mode's chunks, ext_init and chunked,
//   :475-545, :563-575): frames t0 .. t0 + n - 1 on the streams of
//   fact_fwd_init for that chunk (local rows u - t0), alpha'(t0) from the
//   snapshot (ad_init) in place of ad0, beta' and its leaky sum carried
//   in from the chunk above (bd_io, leak_io) unless T_b - 1 lies in the
//   chunk, and out to the chunk below; gamma and the traces go to the
//   chunk's frames of the whole (B, T, P) / (B, T) outputs.
//
// Design.  As in the forward kernel: one block per batch column (or a
// cluster of C CTAs: fact_bwd_lean_cluster_kernel and
// fact_bwd_full_cluster_kernel below; G columns a cluster in the fast
// mode's group form, fact_bwd_group_kernel) running the whole reverse time
// loop, W1^T and W2^T as sliced-ELL rows by source state over the
// graph's arcs, each row's entries in bank order (the
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
// without a ring (S_pad 14,464 in identity mode, else 11,520).  The lean
// mode's ring holds alpha'(u) alone, and its frame holds alpha'(u),
// x_dst(u) and x_src(u) as float32 vectors besides, two or three S_pad
// floats more: its limit without a ring is S_pad 9,600 in identity mode,
// else 7,168; two stages to 7,168 / 5,760 (fast mode 8,192 / 6,400).
// fact_kernels.resolve_stream_mode takes the ckpt mode where "auto" would
// choose a lean kernel that does not fit.
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
// At bench.py --long --big (B = 64, T = 3,700, the headline graph,
// bfloat16 streams, gamma float32: 2.84 GB) fact_bwd_bf16 and the ckpt
// mode's 58 fact_bwd_chunk_bf16 together must move 7.2 GB (2.15 ms), the
// lean mode's fact_bwd_lean_bf16 the alpha' stream, px and gamma, 7.1 GB
// (2.13 ms), and do the W1 product once more (0.05 ms of operations).
//
// The fast mode reads the bfloat16 streams fact_fwd.cu wrote in that mode
// (through the ring, whose bulk copies are then rows of 2 S_pad bytes, or
// from device memory) and rounds where the Pallas kernel does
// (pallas_fact.py:567-628): the operands of W1^T's and W2^T's
// off-diagonal products (x_dst * b and b, gathered as bfloat16-rounded
// values; each row's owner recomputes its unrounded b for the float32
// diagonal and the masses), each state's posterior mass, unscaled, before
// the pdf's sum, and gamma = 1 / s_u times that sum, stored rounded to
// bfloat16 (as float32: the caller's gradient type).  alpha'(0) is the
// float32 ad0.  Its bytes bound at the headline size falls to about
// 0.58 ms (the streams at half the bytes, gamma as before).  As
// fact_fwd.cu in this mode, it computes what its plain version computes
// bit for bit (the same order of every sum, each product and sum rounded
// on its own).

#include "fact_common.cuh"

// 1: the lean cluster form fetches each frame's px row into its ring by
// TMA where fact_bwd_lean_px_ring allows; 0: never (it then gathers x_dst
// and x_src from px by __ldg; kernel_ablation.py times both).
#define LEAN_PX_RING 1

// The full and chunk forms' cluster form (fact_bwd_full_cluster_kernel)
// exchanges its rows and totals by 1: st.async stores completing on the
// receivers' mbarriers; 0: DSMEM stores and a cluster barrier
// (kernel_ablation.py times both; see the kernel).
#define FACT_BWD_ASYNC 1

// Stream rows a frame reads: x_dst(u), W1 alpha'(u), alpha'(u) (the
// forward sweep's row u - 1) and, outside identity mode, x_src(u); the
// lean mode reads alpha'(u) alone.
#define RING_XDST 0
#define RING_W1AD 1
#define RING_AD 2
#define RING_XSRC 3

// The forms of the entry points: fact_bwd, fact_bwd_lean, fact_bwd_chunk.
enum BwdForm { BWD_FULL, BWD_LEAN, BWD_CHUNK };

// S: the stream type, float (float32 mode) or __nv_bfloat16 (fast mode).
// kForm: BWD_LEAN reads alpha' rows and px, the others the full mode's
// streams; BWD_CHUNK runs frames t0 .. t0 + n - 1 with ad_init and the
// carry.  The other forms' frame range and rows are compile-time
// constants, so that fact_bwd compiles as it did before the other forms.
// The body runs column b on the calling block: fact_bwd_kernel below
// gives it block b, the ckpt mode's pair kernel (fact_ckpt.cu) a block of
// its backward role.  Its early return ends the block.  kWords: W1^T's
// and W2^T's slots as packed words (w1t_col / w2t_col hold
// fact_kernels.pack_slots' words, w1t_val / w2t_val are not read;
// sell_row_dot_words), the same bits; the pair's fast chunk role alone.
template <typename S, int kForm, bool kWords = false>
__device__ __forceinline__ void fact_bwd_column(
    const int b,                         // the batch column
    const int* __restrict__ lengths,     // (B,)  1 <= T_b <= T
    const S* __restrict__ ad_ys,         // (B, ad_rows, S_pad) alpha'(u+1)
    const S* __restrict__ w1ad_ys,       // (B, ad_rows, S_pad) W1 alpha'(u)
    const S* __restrict__ xdst_ys,       // (B, ad_rows, S_pad)
    const S* __restrict__ xsrc_ys,       // (B, ad_rows, S_pad) or null
    const float* __restrict__ px,        // (B, T, P) (lean mode)
    const float* __restrict__ s_ys,      // (B, T) s_{u+1}
    const float* __restrict__ s0,        // (1,)
    const float* __restrict__ ad0,       // (S_pad,) alpha'(0)
    const S* __restrict__ ad_init,       // column b's alpha'(t0) at
                                         // b * init_stride (BWD_CHUNK)
    const float* __restrict__ final_p,   // (S_pad,)
    const float* __restrict__ tot,       // (B,) sum(alpha'(T_b) * final)
    const float* __restrict__ leaky,     // (S_pad,)
    const int* __restrict__ w1t_ptr, const int* __restrict__ w1t_col,
    const float* __restrict__ w1t_val,       // W1 by source row
    const int* __restrict__ w2t_ptr, const int* __restrict__ w2t_col,
    const float* __restrict__ w2t_val,       // W2 by source row
    const int* __restrict__ w1_ptr, const int* __restrict__ w1_col,
    const float* __restrict__ w1_val,        // W1 by destination (lean)
    const int* __restrict__ f_dst,       // (S_pad,) (lean mode)
    const int* __restrict__ g_src,       // (S_pad,) or null (lean mode)
    const float* __restrict__ diag1,     // (S_pad,) W1's diagonal (fast mode)
    const float* __restrict__ diag2,     // (S_pad,) W2's diagonal (fast mode)
    const int* __restrict__ f_ptr, const int* __restrict__ f_states,
    const int* __restrict__ g_ptr,       // null in identity mode
    const int* __restrict__ g_states,
    int n_pdf_lists, float leaky_c, int T, int P, int s_pad, int debug,
    int stages,                          // ring depth: 0, 1 or 2
    int t0_arg, int n_arg, int rows_arg, int init_stride,
    float* __restrict__ gamma,           // (B, T, P)
    float* __restrict__ ab,              // (B, T)
    float* __restrict__ gs,              // (B, T)
    float* __restrict__ bd_io,           // (B, S_pad) beta' carry (BWD_CHUNK)
    float* __restrict__ leak_io) {       // (B,) its leaky sum (BWD_CHUNK)
  constexpr bool kFast = sizeof(S) == 2;
  constexpr bool kLean = kForm == BWD_LEAN;
  constexpr bool kChunk = kForm == BWD_CHUNK;
  const int t0 = kChunk ? t0_arg : 0;
  const int n_frames = kChunk ? n_arg : T;
  const int ad_rows = kChunk ? rows_arg : T;
  extern __shared__ float smem[];
  const bool identity = kLean ? g_src == nullptr : xsrc_ys == nullptr;
  const int rows = kLean ? 1 : identity ? 3 : 4;   // stream rows a frame
  // stages x rows x S_pad: frames' stream rows
  S* ring = reinterpret_cast<S*>(smem);
  unsigned long long* bar =    // one mbarrier a stage
      reinterpret_cast<unsigned long long*>(ring + stages * rows * s_pad);
  float* bd = reinterpret_cast<float*>(bar + stages);  // beta', own rows
  float* bn = bd + s_pad;      // b: gathered by W2^T's rows
  float* xb = bn + s_pad;      // x_dst * b: gathered by W1^T's rows
  float* c1 = xb + s_pad;      // posterior mass per state (E_f^T side)
  float* c2 = identity ? c1 : c1 + s_pad;   // E_g^T side
  // lean mode: alpha'(u) (gathered by W1's rows), x_dst(u) and x_src(u)
  // (read by the row's owner)
  float* av = c2 + s_pad;
  float* xdv = av + s_pad;
  float* xsv = identity ? xdv : xdv + s_pad;
  float* red = kLean ? xsv + s_pad : c2 + s_pad;   // block_sum scratch

  const int tid = threadIdx.x;
  const int Tb = lengths[b];
  const size_t row0 = static_cast<size_t>(b) * T;
  const int t_hi = min(t0 + n_frames, Tb);   // frames t0 .. t_hi - 1

  // Frame u (the (t_hi - 1 - u)-th of the column's reverse loop) reads
  // its stream rows from stage (t_hi - 1 - u) % stages; thread 0 fetches
  // them `stages` frames ahead, one bulk copy a row.  Frame t0 takes
  // alpha'(t0) from ad_init or ad0, so no row before the launch's first
  // (or past T_b - 1) is fetched; in the lean mode frame t0 fetches
  // nothing and does not wait.
  const unsigned long long policy = stages ? evict_first_policy() : 0ull;
  const unsigned row_bytes =
      static_cast<unsigned>(sizeof(S)) * static_cast<unsigned>(s_pad);
  auto fetches = [&](int u) { return !kLean || u > t0; };
  auto fetch = [&](int u) {
    const int k = (t_hi - 1 - u) % stages;
    S* st = ring + k * rows * s_pad;
    const size_t o = (static_cast<size_t>(b) * ad_rows + (u - t0)) * s_pad;
    if (kLean) {
      mbar_expect_tx(bar + k, row_bytes);
      bulk_load(st, ad_ys + o - s_pad, row_bytes, bar + k, policy);
      return;
    }
    mbar_expect_tx(bar + k, (u > t0 ? rows : rows - 1) * row_bytes);
    bulk_load(st + RING_XDST * s_pad, xdst_ys + o, row_bytes, bar + k,
              policy);
    bulk_load(st + RING_W1AD * s_pad, w1ad_ys + o, row_bytes, bar + k,
              policy);
    if (u > t0)
      bulk_load(st + RING_AD * s_pad, ad_ys + o - s_pad, row_bytes, bar + k,
                policy);
    if (!identity)
      bulk_load(st + RING_XSRC * s_pad, xsrc_ys + o, row_bytes, bar + k,
                policy);
  };
  if (tid == 0 && stages > 0) {
    for (int k = 0; k < stages; ++k) mbar_init(bar + k, 1);
    for (int k = 0; k < stages && k < t_hi - t0; ++k)
      if (fetches(t_hi - 1 - k)) fetch(t_hi - 1 - k);
  }

  // frames past the column's end
  const int past0 = max(Tb, t0), past1 = t0 + n_frames;
  const size_t n_past = static_cast<size_t>(max(past1 - past0, 0)) * P;
  float* g_past = gamma + (row0 + past0) * P;
  for (size_t i = tid; i < n_past; i += FACT_THREADS) g_past[i] = 0.0f;
  const float past_trace = debug ? 0.0f : 1.0f;
  for (int u = past0 + tid; u < past1; u += FACT_THREADS) {
    ab[row0 + u] = past_trace;
    gs[row0 + u] = past_trace;
  }
  if (t_hi <= t0) return;      // the column ends before this launch

  float leak_sum;
  if (!kChunk || Tb <= t0 + n_frames) {
    // injection at the last frame: beta'(T_b) = final / tot
    const float tot_b = tot[b];
    float inj[1] = {0.0f};
    for (int s = tid; s < s_pad; s += FACT_THREADS) {
      const float v = final_p[s] / tot_b;
      bd[s] = v;
      inj[0] = kFast ? __fadd_rn(inj[0], __fmul_rn(v, leaky[s]))
                     : inj[0] + v * leaky[s];
    }
    // also the barrier after which the mbarriers may be waited on
    block_sum<1>(inj, red);
    leak_sum = inj[0];
  } else {
    // beta'(t0 + n) and its leaky sum from the chunk above
    for (int s = tid; s < s_pad; s += FACT_THREADS)
      bd[s] = bd_io[static_cast<size_t>(b) * s_pad + s];
    leak_sum = leak_io[b];
    __syncthreads();
  }

  // alpha'(t0): the snapshot (stream type) or ad0
  const S* init =
      kChunk ? ad_init + static_cast<size_t>(b) * init_stride : nullptr;
  float part[3];
  for (int u = t_hi - 1; u >= t0; --u) {
    const float s_u = u == 0 ? *s0 : s_ys[row0 + u - 1];
    const float inv_s = 1.0f / s_u;
    // the frame's stream rows (the lean mode: alpha'(u) alone); ad_u is
    // null at u = t0
    const S *xd_u = nullptr, *w1a_u = nullptr, *ad_u = nullptr,
            *xs_u = nullptr;
    const int i = t_hi - 1 - u;
    if (stages > 0) {
      const S* st = ring + (i % stages) * rows * s_pad;
      if (fetches(u)) mbar_wait(bar + i % stages, (i / stages) & 1);
      if (u > t0) ad_u = kLean ? st : st + RING_AD * s_pad;
      if (!kLean) {
        xd_u = st + RING_XDST * s_pad;
        w1a_u = st + RING_W1AD * s_pad;
        xs_u = identity ? xd_u : st + RING_XSRC * s_pad;
      }
    } else {
      const size_t o = (static_cast<size_t>(b) * ad_rows + (u - t0)) * s_pad;
      if (u > t0) ad_u = ad_ys + o - s_pad;
      if (!kLean) {
        xd_u = xdst_ys + o;
        w1a_u = w1ad_ys + o;
        xs_u = identity ? xd_u : xsrc_ys + o;
      }
    }
    // a stream row's entry: from the ring, else read once from device
    // memory, evicted first
    auto row = [&](const S* r, int s) {
      return stages > 0 ? smem_get(r + s) : stream_get(r + s);
    };
    auto alpha_at = [&](int s) {
      return u != t0 ? row(ad_u, s) : kChunk ? stream_get(init + s) : ad0[s];
    };
    const float* px_u = kLean ? px + (row0 + u) * P : nullptr;
    // the leaky term rounded on its own, then added (never fused into a
    // multiply-add: the plain fast version rounds the product first)
    const float cl = __fmul_rn(leaky_c, leak_sum);
    for (int s = tid; s < s_pad; s += FACT_THREADS) {
      const float v = __fadd_rn(bd[s], cl);
      float x;
      if (kLean) {
        // x_dst and x_src as fact_fwd gathers them, and alpha'(u) for
        // W1's rows (rounded where fact_fwd rounds its carry)
        x = round_to<S>(__ldg(px_u + f_dst[s]));
        xdv[s] = x;
        if (!identity) xsv[s] = round_to<S>(__ldg(px_u + g_src[s]));
        av[s] = round_to<S>(alpha_at(s));
      } else {
        x = row(xd_u, s);
      }
      bn[s] = round_to<S>(v);
      xb[s] = round_to<S>(x * v);
    }
    __syncthreads();

    const bool traces = debug || u == 0;
    part[0] = part[1] = part[2] = 0.0f;
    for (int s = tid; s < s_pad; s += FACT_THREADS) {
      float w1t = kWords ? sell_row_dot_words(w1t_ptr, w1t_col, s, xb)
                         : sell_row_dot(w1t_ptr, w1t_col, w1t_val, s, xb);
      float w2t = kWords ? sell_row_dot_words(w2t_ptr, w2t_col, s, bn)
                         : sell_row_dot(w2t_ptr, w2t_col, w2t_val, s, bn);
      float xbs = xb[s];
      const float ad = alpha_at(s);
      // this row's x_dst(u), x_src(u) and W1 alpha'(u): the stream rows'
      // entries, read where the full form always read them, or the lean
      // form's own (W1 alpha'(u) by fact_fwd's row loop: the same rows,
      // the same order; in the fast mode plus the diagonal term of
      // alpha'(u), rounded on its own, and left unrounded)
      float w1a_lean = 0.0f;
      if (kLean) {
        w1a_lean = sell_row_dot(w1_ptr, w1_col, w1_val, s, av);
        if (kFast)
          w1a_lean = __fadd_rn(w1a_lean, __fmul_rn(__ldg(diag1 + s), ad));
      }
      auto xd_at = [&]() { return kLean ? xdv[s] : row(xd_u, s); };
      auto xs_at = [&]() { return kLean ? xsv[s] : row(xs_u, s); };
      auto w1a_at = [&]() { return kLean ? w1a_lean : row(w1a_u, s); };
      float bdt;
      if (kFast) {
        // this row's unrounded b and x_dst * b (as the loop above made
        // them) for the float32 diagonal stratum and the mass; each
        // product and sum rounded on its own, in the plain version's
        // order (ops/factorized.backward_prob_fast, bit for bit).  The
        // masses are unscaled: gamma is scaled by 1 / s_u after the pdf
        // sums (pallas_fact.py:620-628).
        const float v = __fadd_rn(bd[s], cl);
        xbs = xd_at() * v;
        w1t = __fadd_rn(w1t, __fmul_rn(__ldg(diag1 + s), xbs));
        w2t = __fadd_rn(w2t, __fmul_rn(__ldg(diag2 + s), v));
        const float sw = __fmul_rn(xs_at(), w2t);
        bdt = __fmul_rn(__fadd_rn(w1t, sw), inv_s);
        const float m1 = __fmul_rn(xbs, w1a_at());
        const float m2 = __fmul_rn(sw, ad);
        if (identity) {
          c1[s] = round_to<S>(__fadd_rn(m1, m2));
        } else {
          c1[s] = round_to<S>(m1);
          c2[s] = round_to<S>(m2);
        }
        part[0] = __fadd_rn(part[0], __fmul_rn(bdt, leaky[s]));
        if (traces) part[1] = __fadd_rn(part[1], __fmul_rn(ad, bdt));
      } else {
        const float sw = xs_at() * w2t;
        bdt = (w1t + sw) * inv_s;
        const float m1 = xbs * w1a_at() * inv_s;
        const float m2 = sw * ad * inv_s;
        if (identity) {
          c1[s] = m1 + m2;
        } else {
          c1[s] = m1;
          c2[s] = m2;
        }
        part[0] += bdt * leaky[s];
        if (traces) part[1] += ad * bdt;
      }
      bd[s] = bdt;
    }
    __syncthreads();
    // the stage is read: refill it with frame u - stages' rows
    if (tid == 0 && stages > 0 && u - stages >= t0 && fetches(u - stages)) {
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
      const float gv = kFast ? round_to<S>(acc * inv_s) : acc;
      __stcs(g_row + p, gv);
      if (traces) part[2] += acc;
    }
    // also the barrier after which bn, xb, c1 and c2 may be overwritten
    block_sum<3>(part, red);
    leak_sum = part[0];
    if (tid == 0) {
      ab[row0 + u] = traces ? part[1] : 1.0f;
      gs[row0 + u] = traces ? (kFast ? part[2] * inv_s : part[2]) : 1.0f;
    }
  }
  // beta'(t0) and its leaky sum for the chunk below (each thread its own
  // rows, as it wrote them)
  if (kChunk && t0 > 0) {
    for (int s = tid; s < s_pad; s += FACT_THREADS)
      bd_io[static_cast<size_t>(b) * s_pad + s] = bd[s];
    if (tid == 0) leak_io[b] = leak_sum;
  }
}

// Every form, one 1024-thread block a column.
template <typename S, int kForm>
__global__ void __launch_bounds__(FACT_THREADS, 1) fact_bwd_kernel(
    const int* __restrict__ lengths, const S* __restrict__ ad_ys,
    const S* __restrict__ w1ad_ys, const S* __restrict__ xdst_ys,
    const S* __restrict__ xsrc_ys, const float* __restrict__ px,
    const float* __restrict__ s_ys, const float* __restrict__ s0,
    const float* __restrict__ ad0, const S* __restrict__ ad_init,
    const float* __restrict__ final_p, const float* __restrict__ tot,
    const float* __restrict__ leaky, const int* __restrict__ w1t_ptr,
    const int* __restrict__ w1t_col, const float* __restrict__ w1t_val,
    const int* __restrict__ w2t_ptr, const int* __restrict__ w2t_col,
    const float* __restrict__ w2t_val, const int* __restrict__ w1_ptr,
    const int* __restrict__ w1_col, const float* __restrict__ w1_val,
    const int* __restrict__ f_dst, const int* __restrict__ g_src,
    const float* __restrict__ diag1, const float* __restrict__ diag2,
    const int* __restrict__ f_ptr, const int* __restrict__ f_states,
    const int* __restrict__ g_ptr, const int* __restrict__ g_states,
    int n_pdf_lists, float leaky_c, int T, int P, int s_pad, int debug,
    int stages, int t0_arg, int n_arg, int rows_arg, int init_stride,
    float* __restrict__ gamma, float* __restrict__ ab,
    float* __restrict__ gs, float* __restrict__ bd_io,
    float* __restrict__ leak_io) {
  fact_bwd_column<S, kForm>(
      blockIdx.x, lengths, ad_ys, w1ad_ys, xdst_ys, xsrc_ys, px, s_ys, s0,
      ad0, ad_init, final_p, tot, leaky, w1t_ptr, w1t_col, w1t_val, w2t_ptr,
      w2t_col, w2t_val, w1_ptr, w1_col, w1_val, f_dst, g_src, diag1, diag2,
      f_ptr, f_states, g_ptr, g_states, n_pdf_lists, leaky_c, T, P, s_pad,
      debug, stages, t0_arg, n_arg, rows_arg, init_stride, gamma, ab, gs,
      bd_io, leak_io);
}

// fact_bwd_lean on a cluster of C CTAs (C = 2 or 4) of NT threads a
// column, as fact_fwd_snap's cluster form (fact_fwd.cu): CTA r owns the
// virtual warps w = r (mod C) of the C = 1 block and their state rows
// (fact_common.cuh), computes their W1^T, W2^T and lean W1 products, their
// beta' and masses, and the pdfs p with p mod 1024 a virtual thread of
// its own (their gamma entries and their part of the sum-gamma trace).
// A frame:
//
//   own rows: b and x_dst * b to every CTA (DSMEM stores), x_dst(u) and
//   x_src(u) for the owner; alpha'(u) whole from this CTA's ring ->
//   cluster arrive (X1) -> own rows' W1 alpha'(u), which needs this
//   CTA's alpha'(u) alone -> cluster wait -> own rows' W1^T and W2^T
//   products, beta'(u) and masses c1 (c2) to every CTA -> the leaky sum's
//   and the alpha*beta trace's virtual warp totals to every CTA ->
//   cluster barrier X2 (the ring's stage read: refilled) -> the cross-warp
//   trees -> gamma of own pdfs -> (where the sum-gamma trace is taken:
//   its totals, cluster barrier X3, its tree).
//
// Two cluster barriers a frame off the trace frames (each exchange needs
// the one before: the leaky sum makes b, b the products, the products the
// masses and the masses gamma), three on them (frame 0, or every frame
// with debug).  Every vector a peer writes is written only after the
// barrier that follows the peers' last reads of it: the masses of frame
// u - 1 cross after X1 of frame u - 1, which a peer passes after its gamma
// stage of frame u.  Each CTA fetches the whole alpha'(u) row into its own
// ring by TMA, as the C = 1 kernel does: W1's gathers need it whole, and
// an L2 read of the row is cheaper than an exchange.  Where the ring has
// room (fact_bwd_lean_px_ring) it also fetches px's row u, from which the
// head gathers x_dst and x_src in shared memory (0.6-3.8% faster than
// __ldg from px in three runs at main path 7, within their spread).  The
// products are each row's own sell_row_dot and every sum is taken in the
// C = 1 kernel's order (each pdf's list ascending), so the results are
// that kernel's bit for bit.
//
// NT = 1024 (LEAN_CLUSTER_THREADS, see fact_fwd.cu): the products are
// spread over the CTA's threads and the virtual threads (tid < 1024 / C)
// then add their rows' leaky and trace terms in turn after a block
// barrier; the gamma stage runs on the virtual threads (spread over all
// threads where no trace is taken it was 16-19% slower).  At main path
// 7, C = 2: 1024 threads 55.3 ms, 1024 / C 60.3 ms, C = 1 62.7 ms; the
// products take about 22.6 ms against C = 1's 40.8, the rest of a frame
// grows from 5.9 to 8.9 us: the cluster barriers 1.57 us a frame, the
// DSMEM stores 0.65 us (PERF.md, kernel_ablation.py).  One CTA an SM: at least
// LEAN_CLUSTER_MIN_SMEM bytes.  Shared memory as the C = 1 lean kernel's
// (the vectors read whole are whole, the others indexed by state), and
// the ring's px rows.
template <typename S, int NT>
__global__ void __launch_bounds__(NT, 1) fact_bwd_lean_cluster_kernel(
    const int* __restrict__ lengths,     // (B,)  1 <= T_b <= T
    const S* __restrict__ ad_ys,         // (B, T, S_pad) alpha'(u+1)
    const float* __restrict__ px,        // (B, T, P)
    const float* __restrict__ s_ys,      // (B, T) s_{u+1}
    const float* __restrict__ s0,        // (1,)
    const float* __restrict__ ad0,       // (S_pad,) alpha'(0)
    const float* __restrict__ final_p,   // (S_pad,)
    const float* __restrict__ tot,       // (B,) sum(alpha'(T_b) * final)
    const float* __restrict__ leaky,     // (S_pad,)
    const int* __restrict__ w1t_ptr, const int* __restrict__ w1t_col,
    const float* __restrict__ w1t_val,       // W1 by source row
    const int* __restrict__ w2t_ptr, const int* __restrict__ w2t_col,
    const float* __restrict__ w2t_val,       // W2 by source row
    const int* __restrict__ w1_ptr, const int* __restrict__ w1_col,
    const float* __restrict__ w1_val,        // W1 by destination
    const int* __restrict__ f_dst,       // (S_pad,)
    const int* __restrict__ g_src,       // (S_pad,) or null (identity mode)
    const float* __restrict__ diag1,     // (S_pad,) W1's diagonal (fast mode)
    const float* __restrict__ diag2,     // (S_pad,) W2's diagonal (fast mode)
    const int* __restrict__ f_ptr, const int* __restrict__ f_states,
    const int* __restrict__ g_ptr,       // null in identity mode
    const int* __restrict__ g_states,
    int n_pdf_lists, float leaky_c, int T, int P, int s_pad, int debug,
    int stages,                          // ring depth: 0, 1 or 2
    int px_ring,                         // 1: px rows in the ring too
    float* __restrict__ gamma,           // (B, T, P)
    float* __restrict__ ab,              // (B, T)
    float* __restrict__ gs,              // (B, T)
    int* __restrict__ smid) {            // (B * C,) each CTA's SM, or null
  namespace cg = cooperative_groups;
  constexpr bool kFast = sizeof(S) == 2;
  const int C = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int lc = __ffs(C) - 1;
  const int V = FACT_THREADS >> lc;      // this CTA's virtual threads
  extern __shared__ float smem[];
  const bool identity = g_src == nullptr;
  // stages x (S_pad stream entries, and with px_ring P floats): frames'
  // alpha'(u) rows (and px rows)
  const unsigned row_bytes =
      static_cast<unsigned>(sizeof(S)) * static_cast<unsigned>(s_pad);
  const unsigned px_bytes = px_ring ? 4u * static_cast<unsigned>(P) : 0u;
  char* ring = reinterpret_cast<char*>(smem);
  unsigned long long* bar =    // one mbarrier a stage
      reinterpret_cast<unsigned long long*>(ring + stages *
                                            (row_bytes + px_bytes));
  float* bd = reinterpret_cast<float*>(bar + stages);  // beta', own rows
  float* bn = bd + s_pad;      // b, whole: gathered by W2^T's rows
  float* xb = bn + s_pad;      // x_dst * b, whole: gathered by W1^T's rows
  float* c1 = xb + s_pad;      // posterior mass per state, whole
  float* c2 = identity ? c1 : c1 + s_pad;   // E_g^T side, whole
  float* av = c2 + s_pad;      // alpha'(u), whole: gathered by W1's rows
  float* xdv = av + s_pad;     // x_dst(u), own rows
  float* xsv = identity ? xdv : xdv + s_pad;   // x_src(u), own rows
  float* red = xsv + s_pad;    // totals: the leaky sum and alpha*beta,
  float* red2 = red + 2 * FACT_WARPS + 2;   // and the sum-gamma trace

  const int tid = threadIdx.x;
  const int b = static_cast<int>(blockIdx.x) >> lc;
  if (smid && tid == 0) smid[blockIdx.x] = sm_id();
  const int Tb = lengths[b];
  const size_t row0 = static_cast<size_t>(b) * T;
  const int own = cluster_own_rows(s_pad, rank, C);
  cluster_barrier();   // every CTA has started: peers may be written

  // Frame u (the (T_b - 1 - u)-th of the reverse loop) reads alpha'(u),
  // the forward sweep's row u - 1 (and with px_ring px's row u), from
  // stage (T_b - 1 - u) % stages; thread 0 of each CTA fetches it `stages`
  // frames ahead.  Frame 0 takes ad0 (and fetches px's row 0 alone).
  const unsigned long long policy = stages ? evict_first_policy() : 0ull;
  auto fetches = [&](int u) { return px_ring || u > 0; };
  auto stage_ad = [&](int k) {
    return reinterpret_cast<S*>(ring + k * (row_bytes + px_bytes));
  };
  auto stage_px = [&](int k) {
    return reinterpret_cast<float*>(ring + k * (row_bytes + px_bytes) +
                                    row_bytes);
  };
  auto fetch = [&](int u) {
    const int k = (Tb - 1 - u) % stages;
    const size_t o = (static_cast<size_t>(b) * T + u) * s_pad;
    mbar_expect_tx(bar + k, (u > 0 ? row_bytes : 0u) + px_bytes);
    if (u > 0)
      bulk_load(stage_ad(k), ad_ys + o - s_pad, row_bytes, bar + k, policy);
    if (px_ring)
      bulk_load(stage_px(k), px + (row0 + u) * P, px_bytes, bar + k, policy);
  };
  if (tid == 0 && stages > 0) {
    for (int k = 0; k < stages; ++k) mbar_init(bar + k, 1);
    for (int k = 0; k < stages && k < Tb; ++k)
      if (fetches(Tb - 1 - k)) fetch(Tb - 1 - k);
  }

  // frames past the column's end, spread over the cluster
  const size_t n_past = static_cast<size_t>(T - Tb) * P;
  float* g_past = gamma + (row0 + Tb) * P;
  for (size_t i = rank * NT + tid; i < n_past; i += C * NT) g_past[i] = 0.0f;
  const float past_trace = debug ? 0.0f : 1.0f;
  for (int u = Tb + rank * NT + tid; u < T; u += C * NT) {
    ab[row0 + u] = past_trace;
    gs[row0 + u] = past_trace;
  }

  // injection at the last frame: beta'(T_b) = final / tot, the virtual
  // threads' rows
  const float tot_b = tot[b];
  float inj[1] = {0.0f};
  if (tid < V) {
    for (int s = cluster_row(tid, rank, C); s < s_pad; s += FACT_THREADS) {
      const float v = final_p[s] / tot_b;
      bd[s] = v;
      inj[0] = kFast ? __fadd_rn(inj[0], __fmul_rn(v, leaky[s]))
                     : inj[0] + v * leaky[s];
    }
  }
  // also the barrier after which the mbarriers may be waited on
  cluster_block_sum<1>(inj, red, V, rank, lc);
  float leak_sum = inj[0];

  float part[3];
  for (int u = Tb - 1; u >= 0; --u) {
    const float s_u = u == 0 ? *s0 : s_ys[row0 + u - 1];
    const float inv_s = 1.0f / s_u;
    const int fi = Tb - 1 - u;
    const S* ad_u = nullptr;   // alpha'(u)'s row; null at u = 0
    const float* px_u = px + (row0 + u) * P;
    if (stages > 0) {
      if (fetches(u)) mbar_wait(bar + fi % stages, (fi / stages) & 1);
      if (u > 0) ad_u = stage_ad(fi % stages);
      if (px_ring) px_u = stage_px(fi % stages);
    } else if (u > 0) {
      ad_u = ad_ys + (static_cast<size_t>(b) * T + u) * s_pad - s_pad;
    }
    auto alpha_at = [&](int s) {
      return u == 0 ? ad0[s] : stages > 0 ? smem_get(ad_u + s)
                                          : stream_get(ad_u + s);
    };
    // px's row u: from the ring, or read where a gather needs it
    auto px_at = [&](int pdf) {
      return px_ring ? px_u[pdf] : __ldg(px_u + pdf);
    };
    // the leaky term rounded on its own, then added
    const float cl = __fmul_rn(leaky_c, leak_sum);
    for (int i = tid; i < own; i += NT) {
      const int s = cluster_row(i, rank, C);
      const float v = __fadd_rn(bd[s], cl);
      const float x = round_to<S>(px_at(f_dst[s]));
      xdv[s] = x;
      if (!identity) xsv[s] = round_to<S>(px_at(g_src[s]));
      cluster_put(bn + s, round_to<S>(v), rank, C);
      cluster_put(xb + s, round_to<S>(x * v), rank, C);
    }
    for (int s = tid; s < s_pad; s += NT) av[s] = round_to<S>(alpha_at(s));
    __syncthreads();
    cluster_arrive();   // X1: b and x_dst * b to the peers
    // W1 alpha'(u) on own rows (fact_fwd's row loop, the C = 1 lean
    // kernel's sum; in the fast mode plus the diagonal term, rounded on
    // its own) needs this CTA's alpha'(u) alone: taken while the peers'
    // b arrive, and held in c1's own rows until the masses replace it
    for (int i = tid; i < own; i += NT) {
      const int s = cluster_row(i, rank, C);
      float w = sell_row_dot(w1_ptr, w1_col, w1_val, s, av);
      if (kFast) w = __fadd_rn(w, __fmul_rn(__ldg(diag1 + s), alpha_at(s)));
      c1[s] = w;
    }
    cluster_wait();

    const bool traces = debug || u == 0;
    for (int i = tid; i < own; i += NT) {
      const int s = cluster_row(i, rank, C);
      float w1t = sell_row_dot(w1t_ptr, w1t_col, w1t_val, s, xb);
      float w2t = sell_row_dot(w2t_ptr, w2t_col, w2t_val, s, bn);
      float xbs = xb[s];
      const float ad = alpha_at(s);
      const float w1a_lean = c1[s];
      float bdt;
      if (kFast) {
        // the C = 1 kernel's arithmetic, rounded where it rounds
        const float v = __fadd_rn(bd[s], cl);
        xbs = xdv[s] * v;
        w1t = __fadd_rn(w1t, __fmul_rn(__ldg(diag1 + s), xbs));
        w2t = __fadd_rn(w2t, __fmul_rn(__ldg(diag2 + s), v));
        const float sw = __fmul_rn(xsv[s], w2t);
        bdt = __fmul_rn(__fadd_rn(w1t, sw), inv_s);
        const float m1 = __fmul_rn(xbs, w1a_lean);
        const float m2 = __fmul_rn(sw, ad);
        if (identity) {
          cluster_put(c1 + s, round_to<S>(__fadd_rn(m1, m2)), rank, C);
        } else {
          cluster_put(c1 + s, round_to<S>(m1), rank, C);
          cluster_put(c2 + s, round_to<S>(m2), rank, C);
        }
      } else {
        const float sw = xsv[s] * w2t;
        bdt = (w1t + sw) * inv_s;
        const float m1 = xbs * w1a_lean * inv_s;
        const float m2 = sw * ad * inv_s;
        if (identity) {
          cluster_put(c1 + s, m1 + m2, rank, C);
        } else {
          cluster_put(c1 + s, m1, rank, C);
          cluster_put(c2 + s, m2, rank, C);
        }
      }
      bd[s] = bdt;
    }
    // each virtual thread adds its rows' leaky and trace terms in turn,
    // as the C = 1 kernel's row loop does
    __syncthreads();
    part[0] = part[1] = part[2] = 0.0f;
    if (tid < V) {
      for (int s = cluster_row(tid, rank, C); s < s_pad; s += FACT_THREADS) {
        const float bdt = bd[s];
        const float ad = alpha_at(s);
        if (kFast) {
          part[0] = __fadd_rn(part[0], __fmul_rn(bdt, leaky[s]));
          if (traces) part[1] = __fadd_rn(part[1], __fmul_rn(ad, bdt));
        } else {
          part[0] += bdt * leaky[s];
          if (traces) part[1] += ad * bdt;
        }
      }
    }
    // the leaky sum and the alpha*beta trace are complete: their totals
    // cross on X2, which also publishes the masses
    float rows2[2] = {part[0], part[1]};
    cluster_post<2>(rows2, red, V, rank, lc);
    cluster_barrier();   // X2
    // the stage is read: refill it with frame u - stages' row
    if (tid == 0 && stages > 0 && u - stages >= 0 && fetches(u - stages)) {
      fence_proxy_async();
      fetch(u - stages);
    }
    cluster_warp_total<2>(rows2, red);
    leak_sum = rows2[0];

    // gamma of own pdfs: virtual thread v sums pdfs v, v + 1024, ...
    // (spreading them over all of a whole block's threads where no trace
    // is taken was slower, PERF.md)
    float* g_row = gamma + (row0 + u) * P;
    if (tid < V) {
      for (int p = cluster_row(tid, rank, C); p < P; p += FACT_THREADS) {
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
        const float gv = kFast ? round_to<S>(acc * inv_s) : acc;
        __stcs(g_row + p, gv);
        if (traces) part[2] += acc;
      }
    }
    // the sum-gamma trace (at every frame with debug, else at frame 0):
    // a third barrier on those frames alone.  Without it a CTA may start
    // frame u - 1 while a peer still sums gamma: the next writes of c1
    // and c2 to a peer follow X1 of frame u - 1, which the peer passes
    // after its gamma stage.
    if (traces) {
      float g1[1] = {part[2]};
      cluster_block_sum<1>(g1, red2, V, rank, lc);   // X3
      part[2] = g1[0];
    }
    if (rank == 0 && tid == 0) {
      ab[row0 + u] = traces ? rows2[1] : 1.0f;
      gs[row0 + u] = traces ? (kFast ? part[2] * inv_s : part[2]) : 1.0f;
    }
  }
  cluster_barrier();   // no peer touches this CTA's shared memory after it
}

// fact_bwd and fact_bwd_chunk on a cluster of C CTAs (C = 2 or 4) of NT
// threads a column, where the caller asks for it (cluster=; the plan,
// fact_kernels.cluster_size, keeps these forms at C = 1).  CTA r owns the virtual warps w = r (mod C) of the
// C = 1 block and their state rows (fact_common.cuh): it computes their
// W1^T and W2^T products, beta' and masses, and the pdfs p with p mod
// 1024 a virtual thread of its own (their gamma entries and their part of
// the sum-gamma trace).
//
// One exchange a frame.  The lean cluster form (above) exchanges twice:
// b and x_dst * b (X1), then the masses and totals (X2); applied to these
// forms that was slower than C = 1 with either exchange.  Here every CTA
// holds beta' whole and reads x_dst(u) whole from its ring, so it forms b
// and x_dst * b for every row itself, as the C = 1 kernel's head does,
// and the frame's one exchange carries each CTA's rows of beta'(u), its
// rows of the masses and its warp totals.  A frame:
//
//   b and x_dst * b, whole, from beta'(u + 1) whole -> own rows' W1^T and
//   W2^T products, beta'(u) and masses c1 (c2) to every CTA -> the leaky
//   sum's and the alpha*beta trace's virtual warp totals to every CTA ->
//   X (the ring's stage read: refilled) -> the cross-warp trees -> gamma
//   of own pdfs -> (where the sum-gamma trace is taken: its totals, X3,
//   its tree).
//
// Without X1 a CTA may start frame u - 1 while a peer is still in frame
// u, so beta', the masses and the totals are double-buffered by frame
// parity: a peer writes a frame's values into the buffer that the
// receiver last read two frames before, and it can only be past the
// exchange of the frame between, which needs the receiver's values of
// that frame, sent after those reads.  FACT_BWD_ASYNC picks the exchange:
// 0, a cluster barrier (DSMEM stores before it); 1, st.async stores that
// complete on the receiver's mbarrier of the frame's parity (a warp's
// slice of a vector in 16-byte stores, warp_put_async; the totals one
// float a store), armed by the receiver's thread 0 at the frame's start
// with the bytes its peers send it and waited on at the parity of that
// mbarrier's own phase count.  A frame's bytes land on one mbarrier and
// the next frame's on the other, so a peer that runs ahead never adds to
// a phase still open.  The sums are the same either way.
//
// The stream rows.  A CTA needs x_dst(u) whole (b for every row) and its
// own rows of W1 alpha'(u), x_src(u) and alpha'(u) (the masses and the
// alpha*beta trace); it fetches the whole rows through the C = 1
// kernel's ring, one bulk copy a row (its own rows alone would be
// S_pad / (32 C) copies of 64 or 128 bytes a row; a copy multicast to
// the cluster would need every stage released by every peer before its
// refill).  The peers read the same rows from L2 at nearly the same time,
// so the card reads them from memory once.  Ring depth 0 reads each entry
// where it is needed (kernel_ablation.py times the ways).
//
// At main path 7 this form takes C = 1's time (kernel_ablation.py,
// PERF.md: 37.1 ms with st.async, 38.7 with the barrier, C = 1 37.5): its
// products halve (20.1 -> 12.5 ms), but the rest of a frame grows by
// about 2 us: the virtual threads' pass (3.1 ms of the kernel: each
// reads its rows' leaky entries from device memory in turn; a copy in
// shared memory gave no steady gain), the exchange, and the gamma stage
// and head, which a cluster does not split.  So the plan keeps C = 1
// (fact_kernels.PLAN_CLUSTERS).
//
// Each row's products are its own sell_row_dot and every sum is taken in
// the C = 1 kernel's order (each pdf's list ascending), so the results
// are that kernel's bit for bit.  One CTA an SM: at least
// LEAN_CLUSTER_MIN_SMEM bytes.  Shared memory: beta' whole in two
// buffers, b and x_dst * b whole, the masses in two buffers (one vector
// in identity mode, else two), the totals in two buffers and the
// sum-gamma trace's, the ring, its mbarriers and FACT_BWD_ASYNC's three,
// padded to 16 bytes: (6 or 8) S_pad + 165 floats besides, so its S_pad
// limit (9,600 in identity mode, else 7,168) lies below C = 1's.
template <typename S, int NT, int kForm>
__global__ void __launch_bounds__(NT, 1) fact_bwd_full_cluster_kernel(
    const int* __restrict__ lengths,     // (B,)  1 <= T_b <= T
    const S* __restrict__ ad_ys,         // (B, ad_rows, S_pad) alpha'(u+1)
    const S* __restrict__ w1ad_ys,       // (B, ad_rows, S_pad) W1 alpha'(u)
    const S* __restrict__ xdst_ys,       // (B, ad_rows, S_pad)
    const S* __restrict__ xsrc_ys,       // (B, ad_rows, S_pad) or null
    const float* __restrict__ s_ys,      // (B, T) s_{u+1}
    const float* __restrict__ s0,        // (1,)
    const float* __restrict__ ad0,       // (S_pad,) alpha'(0)
    const S* __restrict__ ad_init,       // column b's alpha'(t0) at
                                         // b * init_stride (BWD_CHUNK)
    const float* __restrict__ final_p,   // (S_pad,)
    const float* __restrict__ tot,       // (B,) sum(alpha'(T_b) * final)
    const float* __restrict__ leaky,     // (S_pad,)
    const int* __restrict__ w1t_ptr, const int* __restrict__ w1t_col,
    const float* __restrict__ w1t_val,       // W1 by source row
    const int* __restrict__ w2t_ptr, const int* __restrict__ w2t_col,
    const float* __restrict__ w2t_val,       // W2 by source row
    const float* __restrict__ diag1,     // (S_pad,) W1's diagonal (fast mode)
    const float* __restrict__ diag2,     // (S_pad,) W2's diagonal (fast mode)
    const int* __restrict__ f_ptr, const int* __restrict__ f_states,
    const int* __restrict__ g_ptr,       // null in identity mode
    const int* __restrict__ g_states,
    int n_pdf_lists, float leaky_c, int T, int P, int s_pad, int debug,
    int stages,                          // ring depth: 0, 1 or 2
    int t0_arg, int n_arg, int rows_arg, int init_stride,
    float* __restrict__ gamma,           // (B, T, P)
    float* __restrict__ ab,              // (B, T)
    float* __restrict__ gs,              // (B, T)
    float* __restrict__ bd_io,           // (B, S_pad) beta' carry (BWD_CHUNK)
    float* __restrict__ leak_io,         // (B,) its leaky sum (BWD_CHUNK)
    int* __restrict__ smid) {            // (B * C,) each CTA's SM, or null
  namespace cg = cooperative_groups;
  constexpr bool kFast = sizeof(S) == 2;
  constexpr bool kChunk = kForm == BWD_CHUNK;
  constexpr bool kAsync = FACT_BWD_ASYNC;
  constexpr int kTotals = 2 * FACT_WARPS + 2;   // a totals buffer's floats
  const int t0 = kChunk ? t0_arg : 0;
  const int n_frames = kChunk ? n_arg : T;
  const int ad_rows = kChunk ? rows_arg : T;
  const int C = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int lc = __ffs(C) - 1;
  const int V = FACT_THREADS >> lc;      // this CTA's virtual threads
  extern __shared__ float smem[];
  const bool identity = xsrc_ys == nullptr;
  const int rows = identity ? 3 : 4;     // stream rows a frame
  const int nm = identity ? 1 : 2;       // mass vectors
  // stages x rows x S_pad: frames' stream rows
  S* ring = reinterpret_cast<S*>(smem);
  unsigned long long* bar =    // one mbarrier a stage, then kAsync's
      reinterpret_cast<unsigned long long*>(ring + stages * rows * s_pad);
  unsigned long long* xbar = bar + stages;   // X (even, odd frames), X3
  const int n_bars = (stages + (kAsync ? 3 : 0) + 1) & ~1;
  float* bdv = reinterpret_cast<float*>(bar + n_bars);  // beta', 2 buffers
  float* bn = bdv + 2 * s_pad;   // b, whole: gathered by W2^T's rows
  float* xb = bn + s_pad;        // x_dst * b, whole: gathered by W1^T's rows
  float* cm = xb + s_pad;        // masses, 2 buffers of nm vectors, whole
  float* red = cm + 2 * nm * s_pad;   // totals, 2 buffers
  float* red2 = red + 2 * kTotals;    // the sum-gamma trace's totals

  const int tid = threadIdx.x;
  const int b = static_cast<int>(blockIdx.x) >> lc;
  if (smid && tid == 0) smid[blockIdx.x] = sm_id();
  const int Tb = lengths[b];
  const size_t row0 = static_cast<size_t>(b) * T;
  const int t_hi = min(t0 + n_frames, Tb);   // frames t0 .. t_hi - 1
  const int own = cluster_own_rows(s_pad, rank, C);

  // frames past the column's end, spread over the cluster
  const int past0 = max(Tb, t0), past1 = t0 + n_frames;
  const size_t n_past = static_cast<size_t>(max(past1 - past0, 0)) * P;
  float* g_past = gamma + (row0 + past0) * P;
  for (size_t i = rank * NT + tid; i < n_past; i += C * NT) g_past[i] = 0.0f;
  const float past_trace = debug ? 0.0f : 1.0f;
  for (int u = past0 + rank * NT + tid; u < past1; u += C * NT) {
    ab[row0 + u] = past_trace;
    gs[row0 + u] = past_trace;
  }
  // the column ends before this launch: every CTA of the cluster leaves
  // here, before any DSMEM access
  if (t_hi <= t0) return;

  if (kAsync && tid == 0)
    for (int k = 0; k < 3; ++k) mbar_init(xbar + k, 1);
  cluster_barrier();   // every CTA has started: peers may be written

  // Frame u (the (t_hi - 1 - u)-th of the reverse loop) reads its stream
  // rows from stage (t_hi - 1 - u) % stages; thread 0 of each CTA fetches
  // them `stages` frames ahead, one bulk copy a row.  Frame t0 takes
  // alpha'(t0) from ad_init or ad0.
  const unsigned long long policy = stages ? evict_first_policy() : 0ull;
  const unsigned row_bytes =
      static_cast<unsigned>(sizeof(S)) * static_cast<unsigned>(s_pad);
  auto fetch = [&](int u) {
    const int k = (t_hi - 1 - u) % stages;
    S* st = ring + k * rows * s_pad;
    const size_t o = (static_cast<size_t>(b) * ad_rows + (u - t0)) * s_pad;
    mbar_expect_tx(bar + k, (u > t0 ? rows : rows - 1) * row_bytes);
    bulk_load(st + RING_XDST * s_pad, xdst_ys + o, row_bytes, bar + k,
              policy);
    bulk_load(st + RING_W1AD * s_pad, w1ad_ys + o, row_bytes, bar + k,
              policy);
    if (u > t0)
      bulk_load(st + RING_AD * s_pad, ad_ys + o - s_pad, row_bytes, bar + k,
                policy);
    if (!identity)
      bulk_load(st + RING_XSRC * s_pad, xsrc_ys + o, row_bytes, bar + k,
                policy);
  };
  if (tid == 0 && stages > 0) {
    for (int k = 0; k < stages; ++k) mbar_init(bar + k, 1);
    for (int k = 0; k < stages && k < t_hi - t0; ++k) fetch(t_hi - 1 - k);
  }

  float leak_sum;
  if (!kChunk || Tb <= t0 + n_frames) {
    // injection at the last frame: beta'(T_b) = final / tot, whole in
    // every CTA; its leaky sum over the virtual threads' rows (on the
    // trace's totals: the first frame's go to the first buffer)
    const float tot_b = tot[b];
    for (int s = tid; s < s_pad; s += NT) bdv[s] = final_p[s] / tot_b;
    float inj[1] = {0.0f};
    if (tid < V) {
      for (int s = cluster_row(tid, rank, C); s < s_pad; s += FACT_THREADS) {
        const float v = final_p[s] / tot_b;
        inj[0] = kFast ? __fadd_rn(inj[0], __fmul_rn(v, leaky[s]))
                       : inj[0] + v * leaky[s];
      }
    }
    // also the barrier after which the mbarriers may be waited on
    cluster_block_sum<1>(inj, red2, V, rank, lc);
    leak_sum = inj[0];
  } else {
    // beta'(t0 + n), whole, and its leaky sum from the chunk above
    for (int s = tid; s < s_pad; s += NT)
      bdv[s] = bd_io[static_cast<size_t>(b) * s_pad + s];
    leak_sum = leak_io[b];
    __syncthreads();
  }

  // alpha'(t0): the snapshot (stream type) or ad0
  const S* init =
      kChunk ? ad_init + static_cast<size_t>(b) * init_stride : nullptr;
  // kAsync: the bytes a CTA's peers send it in X (their rows of beta'
  // and of the masses, (32 / C) warp totals of two sums from each) and in
  // X3 (one sum's)
  const unsigned peer_rows = static_cast<unsigned>(s_pad - own);
  const unsigned warp_bytes = (C - 1) * (32u >> lc) * 4u;
  const unsigned x_bytes = peer_rows * (1 + nm) * 4u + 2 * warp_bytes;
  unsigned phase3 = 0;
  float part[3];
  float* bd_out = bdv;   // beta'(t0) after the loop
  for (int u = t_hi - 1; u >= t0; --u) {
    const int fi = t_hi - 1 - u;
    const int k = fi & 1;        // this frame's buffers and mbarrier
    const float* bd = bdv + k * s_pad;       // beta'(u + 1), whole
    float* bd_new = bdv + (k ^ 1) * s_pad;   // beta'(u)
    float* c1 = cm + k * nm * s_pad;
    float* c2 = identity ? c1 : c1 + s_pad;
    float* rd = red + k * kTotals;
    bd_out = bd_new;
    const float s_u = u == 0 ? *s0 : s_ys[row0 + u - 1];
    const float inv_s = 1.0f / s_u;
    const bool traces = debug || u == 0;
    // the frame's stream rows; ad_u is null at u = t0
    const S *xd_u, *w1a_u, *xs_u, *ad_u = nullptr;
    if (stages > 0) {
      const S* st = ring + (fi % stages) * rows * s_pad;
      mbar_wait(bar + fi % stages, (fi / stages) & 1);
      if (u > t0) ad_u = st + RING_AD * s_pad;
      xd_u = st + RING_XDST * s_pad;
      w1a_u = st + RING_W1AD * s_pad;
      xs_u = identity ? xd_u : st + RING_XSRC * s_pad;
    } else {
      const size_t o = (static_cast<size_t>(b) * ad_rows + (u - t0)) * s_pad;
      if (u > t0) ad_u = ad_ys + o - s_pad;
      xd_u = xdst_ys + o;
      w1a_u = w1ad_ys + o;
      xs_u = identity ? xd_u : xsrc_ys + o;
    }
    // a stream row's entry: from the ring, else read once from device
    // memory, evicted first
    auto row = [&](const S* r, int s) {
      return stages > 0 ? smem_get(r + s) : stream_get(r + s);
    };
    auto alpha_at = [&](int s) {
      return u != t0 ? row(ad_u, s) : kChunk ? stream_get(init + s) : ad0[s];
    };
    // this frame's phases: armed once every thread passed their last
    // waits (two frames before; X3 at the last trace frame)
    if (kAsync && tid == 0) {
      mbar_expect_tx(xbar + k, x_bytes);
      if (traces) mbar_expect_tx(xbar + 2, warp_bytes);
    }
    // b and x_dst * b for every row (the C = 1 kernel's head; the leaky
    // term rounded on its own, then added)
    const float cl = __fmul_rn(leaky_c, leak_sum);
    for (int s = tid; s < s_pad; s += NT) {
      const float v = __fadd_rn(bd[s], cl);
      bn[s] = round_to<S>(v);
      xb[s] = round_to<S>(row(xd_u, s) * v);
    }
    __syncthreads();

    // own rows: the products, beta'(u) and the masses, to every CTA
    auto send = [&](float* p, float x) {
      if (kAsync) {
        warp_put_async(p, x, rank, C, xbar + k);
      } else {
        cluster_put(p, x, rank, C);
      }
    };
    for (int i = tid; i < own; i += NT) {
      const int s = cluster_row(i, rank, C);
      float w1t = sell_row_dot(w1t_ptr, w1t_col, w1t_val, s, xb);
      float w2t = sell_row_dot(w2t_ptr, w2t_col, w2t_val, s, bn);
      float xbs = xb[s];
      const float ad = alpha_at(s);
      float bdt;
      if (kFast) {
        // the C = 1 kernel's arithmetic, rounded where it rounds
        const float v = __fadd_rn(bd[s], cl);
        xbs = row(xd_u, s) * v;
        w1t = __fadd_rn(w1t, __fmul_rn(__ldg(diag1 + s), xbs));
        w2t = __fadd_rn(w2t, __fmul_rn(__ldg(diag2 + s), v));
        const float sw = __fmul_rn(row(xs_u, s), w2t);
        bdt = __fmul_rn(__fadd_rn(w1t, sw), inv_s);
        const float m1 = __fmul_rn(xbs, row(w1a_u, s));
        const float m2 = __fmul_rn(sw, ad);
        if (identity) {
          send(c1 + s, round_to<S>(__fadd_rn(m1, m2)));
        } else {
          send(c1 + s, round_to<S>(m1));
          send(c2 + s, round_to<S>(m2));
        }
      } else {
        const float sw = row(xs_u, s) * w2t;
        bdt = (w1t + sw) * inv_s;
        const float m1 = xbs * row(w1a_u, s) * inv_s;
        const float m2 = sw * ad * inv_s;
        if (identity) {
          send(c1 + s, m1 + m2);
        } else {
          send(c1 + s, m1);
          send(c2 + s, m2);
        }
      }
      send(bd_new + s, bdt);
    }
    // each virtual thread adds its rows' leaky and trace terms in turn,
    // as the C = 1 kernel's row loop does
    __syncthreads();
    part[0] = part[1] = part[2] = 0.0f;
    if (tid < V) {
      for (int s = cluster_row(tid, rank, C); s < s_pad; s += FACT_THREADS) {
        const float bdt = bd_new[s];
        const float ad = alpha_at(s);
        if (kFast) {
          part[0] = __fadd_rn(part[0], __fmul_rn(bdt, leaky[s]));
          if (traces) part[1] = __fadd_rn(part[1], __fmul_rn(ad, bdt));
        } else {
          part[0] += bdt * leaky[s];
          if (traces) part[1] += ad * bdt;
        }
      }
    }
    // the leaky sum and the alpha*beta trace are complete: their totals
    // cross on X with beta'(u) and the masses
    float rows2[2] = {part[0], part[1]};
    if (kAsync) {
      cluster_post_async<2>(rows2, rd, V, rank, lc, xbar + k);
      __syncthreads();   // this CTA's totals, and its stage reads, done
    } else {
      cluster_post<2>(rows2, rd, V, rank, lc);
      cluster_barrier();   // X
    }
    // the stage is read: refill it with frame u - stages' rows
    if (tid == 0 && stages > 0 && u - stages >= t0) {
      fence_proxy_async();
      fetch(u - stages);
    }
    if (kAsync) mbar_wait_cluster(xbar + k, (fi >> 1) & 1);
    cluster_warp_total<2>(rows2, rd);
    leak_sum = rows2[0];

    // gamma of own pdfs: virtual thread v sums pdfs v, v + 1024, ...
    float* g_row = gamma + (row0 + u) * P;
    if (tid < V) {
      for (int p = cluster_row(tid, rank, C); p < P; p += FACT_THREADS) {
        float acc = 0.0f;
        if (p < n_pdf_lists) {
          const int fe = __ldg(f_ptr + p + 1);
          for (int q = __ldg(f_ptr + p); q < fe; ++q)
            acc += c1[__ldg(f_states + q)];
          if (!identity) {
            const int ge = __ldg(g_ptr + p + 1);
            for (int q = __ldg(g_ptr + p); q < ge; ++q)
              acc += c2[__ldg(g_states + q)];
          }
        }
        const float gv = kFast ? round_to<S>(acc * inv_s) : acc;
        __stcs(g_row + p, gv);
        if (traces) part[2] += acc;
      }
    }
    // the sum-gamma trace (at every frame with debug, else at frame 0):
    // its own exchange on those frames alone
    if (traces) {
      float g1[1] = {part[2]};
      if (kAsync) {
        cluster_post_async<1>(g1, red2, V, rank, lc, xbar + 2);
        __syncthreads();
        mbar_wait_cluster(xbar + 2, phase3);
        phase3 ^= 1;
        cluster_warp_total<1>(g1, red2);
      } else {
        cluster_block_sum<1>(g1, red2, V, rank, lc);   // X3
      }
      part[2] = g1[0];
    }
    if (rank == 0 && tid == 0) {
      ab[row0 + u] = traces ? rows2[1] : 1.0f;
      gs[row0 + u] = traces ? (kFast ? part[2] * inv_s : part[2]) : 1.0f;
    }
  }
  // beta'(t0) on own rows and its leaky sum for the chunk below
  if (kChunk && t0 > 0) {
    for (int i = tid; i < own; i += NT) {
      const int s = cluster_row(i, rank, C);
      bd_io[static_cast<size_t>(b) * s_pad + s] = bd_out[s];
    }
    if (rank == 0 && tid == 0) leak_io[b] = leak_sum;
  }
  cluster_barrier();   // no peer touches this CTA's shared memory after it
}

// fact_bwd_bf16 (the full mode, bfloat16 tiles) as a group of G columns
// (G = 1, 2 or 4) on a cluster of C CTAs (C = 2 or 4)
// (fact_kernels.group_size): G = 1 where B C CTAs fit the card's SMs (B
// <= 66 on an H100 at C = 2, where one block a column leaves half the
// SMs idle), G = 2 past that; the forward sweep's group form (fact_fwd.cu)
// says why: a CTA loads its rows' slots of W1^T and W2^T into shared
// memory once, packed, and one load of a slot feeds the G columns'
// products; no frame reads the operator from device memory (the
// one-block kernel reads all of it from L2 at every frame).
//
// At G = 1 every packed vector keeps a word a state (packed_words in
// fact_common.cuh: the bfloat16 value's float32 bits, so the host's bank
// order still spreads a slot's gathers over the banks), and the loop is
// the G = 2 form's with one column: the products gather the same rounded
// values, and every sum keeps its order.
//
// CTA r owns the state rows of the cluster layout (cluster_row) and the
// pdfs p with p mod 1024 one of its virtual threads, in all G columns.
// It keeps beta' on its own rows alone, so a frame has two exchanges
// (the lean cluster form's order; each needs the one before):
//
//   own rows' b and x_dst * b, packed, to every CTA (X1) -> the gamma
//   stage of frame u + 1, deferred to here (its masses crossed in frame
//   u + 1's X2), while X1 crosses -> wait -> own rows' W1^T and W2^T
//   products, beta'(u) and the masses, packed, to every CTA, then the
//   leaky sum's and the alpha*beta trace's virtual warp totals (X2) ->
//   wait -> the cross-warp trees.  Frame 0's gamma stage follows the loop.
//
// Each exchange completes on an mbarrier of the receiver (st.async), one
// phase a frame.  A peer's stores of frame u - 1 into b and x_dst * b or
// the totals can only follow this CTA's reads of frame u (X1 of frame u -
// 1 follows this CTA's X2 of frame u; X2 of frame u - 1 follows this
// CTA's X1 sends of that frame).  The masses have two buffers by frame
// parity: a peer writes frame u's after its X1 wait of frame u, which
// may come while this CTA's deferred gamma stage reads frame u + 1's.
//
// The stream entries a frame reads on own rows (x_dst, W1 alpha', alpha',
// x_src) are copied by cp.async, 16 bytes (8 rows) a copy, into a stage
// of two buffers: frame u - 1's copies go out at frame u's start and land
// by frame u - 1's (where the one-block kernel's TMA ring holds whole
// rows).
//
// Each column runs from its own last frame, where beta'(T_b) = final /
// tot is injected (its leaky sum taken for every column at the launch's
// start), down to frame 0; gamma and the traces past a column's end are
// written at the start as the one-block kernel writes them.  Every sum of
// a column is taken in the one-block kernel's order (each row's slots in
// the host's order, then the diagonal; the virtual threads' rows and
// pdfs, the warp trees, the cross-warp tree; each pdf's states
// ascending), each product and sum rounded where it rounds, so the
// results are that kernel's bit for bit, and the plain fast version's.
// The pdf lists leave out the states whose mass is always exactly 0
// (fact_kernels.KernelGraph.group_lists: the padded states, 72 of pdf
// 0's 73 at the headline graph, a serial chain the one-block kernel
// walks every frame); adding +0 to a sum of terms >= +0 changes no bit.
//
// Shared memory: b and x_dst * b whole, packed, and the masses (one
// vector in identity mode, else two) whole, packed, in two buffers;
// beta' on rank 0's rows, G floats a row, and the stage (two buffers of
// 3 or 4 streams, G bfloat16 entries a row); the scratch of X2's 2 G sums
// and X3's G, three mbarriers, the local slice pointers of W1^T and W2^T
// and their slots; at least LEAN_CLUSTER_MIN_SMEM bytes
// (fact_bwd_group_smem_bytes).
template <int G>
__global__ void __launch_bounds__(FACT_THREADS, 1) fact_bwd_group_kernel(
    const int* __restrict__ lengths,     // (B,)  1 <= T_b <= T
    const __nv_bfloat16* __restrict__ ad_ys,     // (B, T, S_pad) alpha'(u+1)
    const __nv_bfloat16* __restrict__ w1ad_ys,   // (B, T, S_pad) W1 alpha'(u)
    const __nv_bfloat16* __restrict__ xdst_ys,   // (B, T, S_pad)
    const __nv_bfloat16* __restrict__ xsrc_ys,   // (B, T, S_pad) or null
    const float* __restrict__ s_ys,      // (B, T) s_{u+1}
    const float* __restrict__ s0,        // (1,)
    const float* __restrict__ ad0,       // (S_pad,) alpha'(0)
    const float* __restrict__ final_p,   // (S_pad,)
    const float* __restrict__ tot,       // (B,) sum(alpha'(T_b) * final)
    const float* __restrict__ leaky,     // (S_pad,)
    const int* __restrict__ w1t_ptr,     // W1^T's slice pointers
    const unsigned* __restrict__ w1t_pack,   // W1^T's packed slots
    const int* __restrict__ w2t_ptr, const unsigned* __restrict__ w2t_pack,
    const float* __restrict__ diag1,     // (S_pad,) W1's diagonal
    const float* __restrict__ diag2,     // (S_pad,) W2's diagonal
    const int* __restrict__ f_ptr, const int* __restrict__ f_states,
    const int* __restrict__ g_ptr,       // null in identity mode
    const int* __restrict__ g_states,
    int n_pdf_lists, float leaky_c, int B, int T, int P, int s_pad,
    int debug,
    float* __restrict__ gamma,           // (B, T, P)
    float* __restrict__ ab,              // (B, T)
    float* __restrict__ gs,              // (B, T)
    int* __restrict__ smid) {            // (ceil(B / G) C,) or null
  namespace cg = cooperative_groups;
  using S = __nv_bfloat16;
  constexpr int W = packed_words(G);   // words a state of a packed vector
  const int C = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int lc = __ffs(C) - 1;
  const int V = FACT_THREADS >> lc;      // this CTA's virtual threads
  const int own = cluster_own_rows(s_pad, rank, C);
  const int own_max = cluster_own_rows(s_pad, 0, C);
  const bool identity = xsrc_ys == nullptr;
  const int nm = identity ? 1 : 2;       // mass vectors
  const int n_streams = identity ? 3 : 4;
  extern __shared__ float smem[];
  unsigned* bn = reinterpret_cast<unsigned*>(smem);   // b, whole
  unsigned* xb = bn + s_pad * W;         // x_dst * b, whole
  unsigned* cm = xb + s_pad * W;         // masses, 2 buffers of nm, whole
  float* bd = reinterpret_cast<float*>(cm + 2 * nm * s_pad * W);  // beta'
  // own rows' stream entries as stored (bfloat16): two buffers by frame
  // parity, each [n_streams][G][own_max] (x_dst, W1 alpha', alpha', x_src)
  unsigned short* stage = reinterpret_cast<unsigned short*>(bd + own_max * G);
  float* red = reinterpret_cast<float*>(stage + 2 * n_streams * G * own_max);
  float* red2 = red + group_red_words(2 * G);   // X3's and the injection's
  unsigned long long* xbar =             // X1, X2, X3
      reinterpret_cast<unsigned long long*>(red2 + group_red_words(G));
  int* lp1 = reinterpret_cast<int*>(xbar + 4);
  int* lp2 = lp1 + group_lp_words(s_pad, C);
  unsigned* ops1 = reinterpret_cast<unsigned*>(lp2 + group_lp_words(s_pad, C));

  const int tid = threadIdx.x;
  const int b0 = (static_cast<int>(blockIdx.x) >> lc) * G;
  if (smid && tid == 0) smid[blockIdx.x] = sm_id();
  int Tb[G];
  int t_hi = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    Tb[g] = b0 + g < B ? lengths[b0 + g] : 0;
    t_hi = max(t_hi, Tb[g]);
  }

  // frames past each column's end, spread over the cluster
  const float past_trace = debug ? 0.0f : 1.0f;
  for (int g = 0; g < G; ++g) {
    if (b0 + g >= B) continue;
    const size_t row0 = static_cast<size_t>(b0 + g) * T;
    const size_t n_past = static_cast<size_t>(T - Tb[g]) * P;
    float* g_past = gamma + (row0 + Tb[g]) * P;
    for (size_t i = rank * FACT_THREADS + tid; i < n_past;
         i += C * FACT_THREADS)
      g_past[i] = 0.0f;
    for (int u = Tb[g] + rank * FACT_THREADS + tid; u < T;
         u += C * FACT_THREADS) {
      ab[row0 + u] = past_trace;
      gs[row0 + u] = past_trace;
    }
  }
  // no column has a frame: every CTA of the cluster leaves here, before
  // any DSMEM access
  if (t_hi == 0) return;

  group_load_ops(w1t_ptr, w1t_pack, s_pad, rank, C, lp1, ops1);
  __syncthreads();   // lp1
  unsigned* ops2 = ops1 + lp1[own >> 5] * 32;
  group_load_ops(w2t_ptr, w2t_pack, s_pad, rank, C, lp2, ops2);
  float tot_b[G];
#pragma unroll
  for (int g = 0; g < G; ++g) tot_b[g] = b0 + g < B ? tot[b0 + g] : 1.0f;
  for (int i = tid; i < own_max * G; i += FACT_THREADS) bd[i] = 0.0f;
  if (tid == 0)
    for (int k = 0; k < 3; ++k) mbar_init(xbar + k, 1);
  cluster_barrier();   // every CTA has started: peers may be written

  // each column's injection beta'(T_b) = final / tot: its leaky sum over
  // the virtual threads' rows
  float inj[G];
#pragma unroll
  for (int g = 0; g < G; ++g) inj[g] = 0.0f;
  if (tid < V)
    for (int i = tid; i < own; i += V) {
      const int d = cluster_row(i, rank, C);
#pragma unroll
      for (int g = 0; g < G; ++g)
        inj[g] = __fadd_rn(inj[g], __fmul_rn(final_p[d] / tot_b[g], leaky[d]));
    }
  // also the barrier after which the mbarriers and the slots may be used
  cluster_block_sum<G>(inj, red2, V, rank, lc);

  // issue the copies of own rows' stream entries of frame u in each
  // column's frames into frame u's stage, 16 bytes (8 rows of a slice) a
  // copy (alpha'(0) is ad0, read where it is needed); they land by
  // cp_async_wait_all
  const int pieces = own >> 3;
  auto fetch = [&](int u) {
    unsigned short* st = stage + (u & 1) * n_streams * G * own_max;
    for (int q = tid; q < n_streams * G * pieces; q += FACT_THREADS) {
      const int p = q % pieces;
      const int g = (q / pieces) % G;
      const int j = q / (pieces * G);
      if (u >= Tb[g] || (j == 2 && u == 0)) continue;
      const __nv_bfloat16* base = j == 0 ? xdst_ys : j == 1 ? w1ad_ys
                                  : j == 2 ? ad_ys : xsrc_ys;
      const size_t o = (static_cast<size_t>(b0 + g) * T + u - (j == 2)) *
                           s_pad + cluster_row(8 * p, rank, C);
      cp_async16(st + (j * G + g) * own_max + 8 * p, base + o);
    }
  };
  // stream j's entry of local row i in column g at frame u, and alpha'(u)
  auto staged = [&](int u, int j, int g, int i) {
    const unsigned short* st = stage + (u & 1) * n_streams * G * own_max;
    return __uint_as_float(
        static_cast<unsigned>(st[(j * G + g) * own_max + i]) << 16);
  };
  auto alpha_at = [&](int u, int g, int i, int d) {
    return u > 0 ? staged(u, 2, g, i) : ad0[d];
  };
  // the gamma stage of frame u (its masses whole in buffer u & 1, its
  // 1 / s_u in inv) on this CTA's pdfs (the 32-pdf slices k = rank mod
  // C): where the sum-gamma trace is taken (at every frame with debug,
  // else at frame 0) virtual thread v sums pdfs v, v + 1024, ... for its
  // order, the trace crossing on its own exchange (X3), rank 0 writing
  // it; elsewhere every thread takes pdfs in turn
  unsigned phase3 = 0;
  const int own_p = cluster_own_rows((P + 31) & ~31, rank, C);
  auto gamma_stage = [&](int u, const float (&inv)[G]) {
    const bool traces = debug || u == 0;
    const unsigned* c1 = cm + (u & 1) * nm * s_pad * W;
    const unsigned* c2 = identity ? c1 : c1 + s_pad * W;
    if (traces && tid == 0) mbar_expect_tx(xbar + 2, (C - 1) * (32u >> lc) *
                                                         4u * G);
    float pg[G];
#pragma unroll
    for (int g = 0; g < G; ++g) pg[g] = 0.0f;
    if (!traces || tid < V)
      for (int i = tid; i < own_p; i += traces ? V : FACT_THREADS) {
        const int p = cluster_row(i, rank, C);
        if (p >= P) continue;
        float acc[G];
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] = 0.0f;
        if (p < n_pdf_lists) {
          const int fe = __ldg(f_ptr + p + 1);
          for (int q = __ldg(f_ptr + p); q < fe; ++q) {
            float x[G];
            load_packed<G>(c1, __ldg(f_states + q), x);
#pragma unroll
            for (int g = 0; g < G; ++g) acc[g] += x[g];
          }
          if (!identity) {
            const int ge = __ldg(g_ptr + p + 1);
            for (int q = __ldg(g_ptr + p); q < ge; ++q) {
              float x[G];
              load_packed<G>(c2, __ldg(g_states + q), x);
#pragma unroll
              for (int g = 0; g < G; ++g) acc[g] += x[g];
            }
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          if (u < Tb[g])
            __stcs(gamma + (static_cast<size_t>(b0 + g) * T + u) * P + p,
                   round_to<S>(acc[g] * inv[g]));
          if (traces) pg[g] += acc[g];
        }
      }
    if (traces) {
      cluster_post_async<G>(pg, red2, V, rank, lc, xbar + 2);
      __syncthreads();
      mbar_wait_cluster(xbar + 2, phase3);
      phase3 ^= 1;
      cluster_warp_total_all<G>(pg, red2);
    }
    if (rank == 0 && tid == 0)
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (u < Tb[g])
          gs[static_cast<size_t>(b0 + g) * T + u] =
              traces ? pg[g] * inv[g] : 1.0f;
  };

  // the bytes a CTA's peers send it: in X1 their rows of b and x_dst * b,
  // in X2 their rows of the masses and (32 / C) warp totals of 2 G sums
  const unsigned peer_rows = static_cast<unsigned>(s_pad - own);
  const unsigned warp_bytes = (C - 1) * (32u >> lc) * 4u * G;
  const unsigned x1_bytes = peer_rows * 8u * W;
  const unsigned x2_bytes = peer_rows * 4u * W * nm + 2 * warp_bytes;
  fetch(t_hi - 1);
  float leak[G], inv[G], inv_next[G];
#pragma unroll
  for (int g = 0; g < G; ++g) leak[g] = inv_next[g] = 0.0f;
  for (int u = t_hi - 1; u >= 0; --u) {
    const unsigned parity = (t_hi - 1 - u) & 1;
    const bool traces = debug || u == 0;
    // frame u + 1's last reads are done, and frame u's stream entries
    // have landed: frame u - 1's copies go out
    cp_async_wait_all();
    __syncthreads();
    if (u > 0) fetch(u - 1);
    if (tid == 0) {
      mbar_expect_tx(xbar, x1_bytes);
      mbar_expect_tx(xbar + 1, x2_bytes);
    }
    float cl[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (u == Tb[g] - 1) leak[g] = inj[g];
      const float s_u = u == 0 ? *s0
                        : b0 + g < B ? s_ys[static_cast<size_t>(b0 + g) * T +
                                            u - 1]
                                     : 1.0f;
      inv[g] = 1.0f / s_u;
      // the leaky term rounded on its own, then added
      cl[g] = __fmul_rn(leaky_c, leak[g]);
    }
    // own rows: beta'(T_b) where a column starts, and b and x_dst * b to
    // every CTA
    for (int i = tid; i < own; i += FACT_THREADS) {
      const int d = cluster_row(i, rank, C);
      float bv[G], xv[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int k = i * G + g;
        if (u == Tb[g] - 1) bd[k] = final_p[d] / tot_b[g];
        const float v = __fadd_rn(bd[k], cl[g]);
        bv[g] = round_to<S>(v);
        xv[g] = round_to<S>(__fmul_rn(staged(u, 0, g, i), v));
      }
      unsigned w[W];
      pack_cols<G>(bv, w);
      warp_put_words_async<W>(bn + (d & ~31) * W, w, rank, C, xbar);
      pack_cols<G>(xv, w);
      warp_put_words_async<W>(xb + (d & ~31) * W, w, rank, C, xbar);
    }
    // frame u + 1's gamma stage while X1 crosses
    if (u + 1 < t_hi) gamma_stage(u + 1, inv_next);
    __syncthreads();   // this CTA's rows of b and x_dst * b
    mbar_wait_cluster(xbar, parity);

    // own rows: the products, beta'(u) and the masses to every CTA
    unsigned* c1 = cm + (u & 1) * nm * s_pad * W;
    unsigned* c2 = identity ? c1 : c1 + s_pad * W;
    for (int i = tid; i < own; i += FACT_THREADS) {
      const int d = cluster_row(i, rank, C);
      float w1t[G], w2t[G], m1v[G], m2v[G];
      group_row_dot<G>(ops1, lp1, i, xb, w1t);
      group_row_dot<G>(ops2, lp2, i, bn, w2t);
      const float dg1 = __ldg(diag1 + d), dg2 = __ldg(diag2 + d);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        // the one-block kernel's arithmetic, rounded where it rounds
        const int k = i * G + g;
        const float x = staged(u, 0, g, i);
        const float v = __fadd_rn(bd[k], cl[g]);
        const float xbs = __fmul_rn(x, v);
        const float t1 = __fadd_rn(w1t[g], __fmul_rn(dg1, xbs));
        const float t2 = __fadd_rn(w2t[g], __fmul_rn(dg2, v));
        const float sw = __fmul_rn(identity ? x : staged(u, 3, g, i), t2);
        bd[k] = __fmul_rn(__fadd_rn(t1, sw), inv[g]);
        const float m1 = __fmul_rn(xbs, staged(u, 1, g, i));
        const float m2 = __fmul_rn(sw, alpha_at(u, g, i, d));
        if (identity) {
          m1v[g] = round_to<S>(__fadd_rn(m1, m2));
        } else {
          m1v[g] = round_to<S>(m1);
          m2v[g] = round_to<S>(m2);
        }
      }
      unsigned w[W];
      pack_cols<G>(m1v, w);
      warp_put_words_async<W>(c1 + (d & ~31) * W, w, rank, C, xbar + 1);
      if (!identity) {
        pack_cols<G>(m2v, w);
        warp_put_words_async<W>(c2 + (d & ~31) * W, w, rank, C, xbar + 1);
      }
    }
    // each virtual thread adds its rows' leaky and trace terms in turn
    __syncthreads();
    float rows2[2 * G];
#pragma unroll
    for (int k = 0; k < 2 * G; ++k) rows2[k] = 0.0f;
    if (tid < V)
      for (int i = tid; i < own; i += V) {
        const int d = cluster_row(i, rank, C);
        const float lk = leaky[d];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float bdt = bd[i * G + g];
          rows2[g] = __fadd_rn(rows2[g], __fmul_rn(bdt, lk));
          if (traces)
            rows2[G + g] = __fadd_rn(rows2[G + g],
                                     __fmul_rn(alpha_at(u, g, i, d), bdt));
        }
      }
    cluster_post_async<2 * G>(rows2, red, V, rank, lc, xbar + 1);
    __syncthreads();   // this CTA's totals and masses
    mbar_wait_cluster(xbar + 1, parity);
    cluster_warp_total_all<2 * G>(rows2, red);
#pragma unroll
    for (int g = 0; g < G; ++g) {
      leak[g] = rows2[g];
      inv_next[g] = inv[g];
    }
    if (rank == 0 && tid == 0)
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (u < Tb[g])
          ab[static_cast<size_t>(b0 + g) * T + u] =
              traces ? rows2[G + g] : 1.0f;
  }
  gamma_stage(0, inv_next);
  cluster_barrier();   // no peer touches this CTA's shared memory after it
}

// The group form's request: b and x_dst * b whole, packed (S_pad
// packed_words words each), and the masses (1 or 2 vectors) whole,
// packed, in two buffers; beta' on rank 0's rows
// (G floats a row) and the stage of x_dst, W1 alpha', alpha' and (outside
// identity mode) x_src there in two buffers (G bfloat16 entries a row);
// the scratch of 2 G and of G sums, three mbarriers (four slots), two sets
// of local slice pointers and op_words words of slots (the most any CTA
// of the cluster holds of W1^T and W2^T together); at least
// LEAN_CLUSTER_MIN_SMEM.
extern "C" size_t fact_bwd_group_smem_bytes(int s_pad, int identity, int G,
                                            int C, int op_words) {
  const size_t own_max = 32 * ((s_pad / 32 + C - 1) / C);
  const size_t words =
      (identity ? 4 : 6) * static_cast<size_t>(s_pad) * packed_words(G) +
      own_max * G + (identity ? 3 : 4) * own_max * G +
      group_red_words(2 * G) +
      group_red_words(G) + 8 + 2 * group_lp_words(s_pad, C) + op_words;
  const size_t need = words * sizeof(float);
  return need > LEAN_CLUSTER_MIN_SMEM ? need : LEAN_CLUSTER_MIN_SMEM;
}

extern "C" size_t fact_bwd_smem_bytes(int s_pad, int identity, int stages,
                                      int fast, int lean) {
  const size_t rows = lean ? 1 : identity ? 3 : 4;
  const size_t entry = fast ? 2 : 4;   // a stream entry's bytes
  const size_t vectors =
      (identity ? 4 : 5) + (lean ? (identity ? 2 : 3) : 0);
  return (vectors * static_cast<size_t>(s_pad) + 3 * FACT_WARPS + 3) *
             sizeof(float) +
         stages * (rows * s_pad * entry + sizeof(unsigned long long));
}

// Whether the lean cluster form's ring also holds px's rows: a ring at
// all, P floats a 16-byte multiple (TMA), and the CTA's request with them
// within a block's 232,448 bytes (the ring's depth and the limits are
// C = 1's, chosen without px rows).
extern "C" int fact_bwd_lean_px_ring(int s_pad, int identity, int stages,
                                     int fast, int P) {
  return LEAN_PX_RING && stages > 0 && P % 4 == 0 &&
         fact_bwd_smem_bytes(s_pad, identity, stages, fast, 1) +
                 static_cast<size_t>(stages) * 4 * P <=
             232448;
}

// A cluster CTA's request (never less than LEAN_CLUSTER_MIN_SMEM: one CTA
// an SM).  lean: the C = 1 lean kernel's, plus a px row a stage
// (fact_bwd_lean_px_ring); else fact_bwd_full_cluster_kernel's layout.
extern "C" size_t fact_bwd_cluster_smem_bytes(int s_pad, int identity,
                                              int stages, int fast, int P,
                                              int lean) {
  size_t need;
  if (lean) {
    need = fact_bwd_smem_bytes(s_pad, identity, stages, fast, 1) +
           (fact_bwd_lean_px_ring(s_pad, identity, stages, fast, P)
                ? static_cast<size_t>(stages) * 4 * P
                : 0);
  } else {
    const size_t rows = identity ? 3 : 4;
    const size_t entry = fast ? 2 : 4;
    const size_t vectors = identity ? 6 : 8;
    const size_t bars = (stages + (FACT_BWD_ASYNC ? 3 : 0) + 1) & ~1;
    need = stages * rows * static_cast<size_t>(s_pad) * entry +
           bars * sizeof(unsigned long long) +
           (vectors * static_cast<size_t>(s_pad) + 2 * (2 * FACT_WARPS + 2) +
            FACT_WARPS + 1) *
               sizeof(float);
  }
  return need > LEAN_CLUSTER_MIN_SMEM ? need : LEAN_CLUSTER_MIN_SMEM;
}

// fact_ckpt.cu includes this file for fact_bwd_column and the requests
// above alone.
#ifndef FACT_COLUMNS_ONLY

template <typename S, int NT>
static int fact_bwd_lean_cluster_run(
    const void* lengths, const void* ad_ys, const void* px, const void* s_ys,
    const void* s0, const void* ad0, const void* final_p, const void* tot,
    const void* leaky, const void* w1t_ptr, const void* w1t_col,
    const void* w1t_val, const void* w2t_ptr, const void* w2t_col,
    const void* w2t_val, const void* w1_ptr, const void* w1_col,
    const void* w1_val, const void* f_dst, const void* g_src,
    const void* diag1, const void* diag2, const void* f_ptr,
    const void* f_states, const void* g_ptr, const void* g_states,
    int n_pdf_lists, float leaky_c, int B, int T, int P, int s_pad,
    int debug, int stages, int cluster, void* gamma, void* ab, void* gs,
    void* smid, void* stream) {
  auto kernel = fact_bwd_lean_cluster_kernel<S, NT>;
  const int identity = g_src == nullptr;
  const int px_ring =
      fact_bwd_lean_px_ring(s_pad, identity, stages, sizeof(S) == 2, P);
  const size_t smem = fact_bwd_cluster_smem_bytes(
      s_pad, identity, stages, sizeof(S) == 2, P, 1);
  cudaError_t err = fact_set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(B, cluster, smem, stream, attr, NT);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return -1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int*>(lengths),
      static_cast<const S*>(ad_ys), static_cast<const float*>(px),
      static_cast<const float*>(s_ys), static_cast<const float*>(s0),
      static_cast<const float*>(ad0), static_cast<const float*>(final_p),
      static_cast<const float*>(tot), static_cast<const float*>(leaky),
      static_cast<const int*>(w1t_ptr), static_cast<const int*>(w1t_col),
      static_cast<const float*>(w1t_val), static_cast<const int*>(w2t_ptr),
      static_cast<const int*>(w2t_col), static_cast<const float*>(w2t_val),
      static_cast<const int*>(w1_ptr), static_cast<const int*>(w1_col),
      static_cast<const float*>(w1_val), static_cast<const int*>(f_dst),
      static_cast<const int*>(g_src), static_cast<const float*>(diag1),
      static_cast<const float*>(diag2), static_cast<const int*>(f_ptr),
      static_cast<const int*>(f_states), static_cast<const int*>(g_ptr),
      static_cast<const int*>(g_states), n_pdf_lists, leaky_c, T, P, s_pad,
      debug, stages, px_ring, static_cast<float*>(gamma),
      static_cast<float*>(ab), static_cast<float*>(gs),
      static_cast<int*>(smid));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int NT, int kForm>
static int fact_bwd_full_cluster_run(
    const void* lengths, const void* ad_ys, const void* w1ad_ys,
    const void* xdst_ys, const void* xsrc_ys, const void* s_ys,
    const void* s0, const void* ad0, const void* ad_init,
    const void* final_p, const void* tot, const void* leaky,
    const void* w1t_ptr, const void* w1t_col, const void* w1t_val,
    const void* w2t_ptr, const void* w2t_col, const void* w2t_val,
    const void* diag1, const void* diag2, const void* f_ptr,
    const void* f_states, const void* g_ptr, const void* g_states,
    int n_pdf_lists, float leaky_c, int B, int T, int P, int s_pad,
    int debug, int stages, int t0, int n_frames, int ad_rows,
    int init_stride, int cluster, void* gamma, void* ab, void* gs,
    void* bd_io, void* leak_io, void* smid, void* stream) {
  auto kernel = fact_bwd_full_cluster_kernel<S, NT, kForm>;
  const size_t smem = fact_bwd_cluster_smem_bytes(
      s_pad, xsrc_ys == nullptr, stages, sizeof(S) == 2, P, 0);
  cudaError_t err = fact_set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(B, cluster, smem, stream, attr, NT);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return -1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int*>(lengths),
      static_cast<const S*>(ad_ys), static_cast<const S*>(w1ad_ys),
      static_cast<const S*>(xdst_ys), static_cast<const S*>(xsrc_ys),
      static_cast<const float*>(s_ys), static_cast<const float*>(s0),
      static_cast<const float*>(ad0), static_cast<const S*>(ad_init),
      static_cast<const float*>(final_p), static_cast<const float*>(tot),
      static_cast<const float*>(leaky), static_cast<const int*>(w1t_ptr),
      static_cast<const int*>(w1t_col), static_cast<const float*>(w1t_val),
      static_cast<const int*>(w2t_ptr), static_cast<const int*>(w2t_col),
      static_cast<const float*>(w2t_val), static_cast<const float*>(diag1),
      static_cast<const float*>(diag2), static_cast<const int*>(f_ptr),
      static_cast<const int*>(f_states), static_cast<const int*>(g_ptr),
      static_cast<const int*>(g_states), n_pdf_lists, leaky_c, T, P, s_pad,
      debug, stages, t0, n_frames, ad_rows, init_stride,
      static_cast<float*>(gamma), static_cast<float*>(ab),
      static_cast<float*>(gs), static_cast<float*>(bd_io),
      static_cast<float*>(leak_io), static_cast<int*>(smid));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int kForm>
static int fact_bwd_run(
    const void* lengths, const void* ad_ys, const void* w1ad_ys,
    const void* xdst_ys, const void* xsrc_ys, const void* px,
    const void* s_ys, const void* s0, const void* ad0, const void* ad_init,
    const void* final_p, const void* tot, const void* leaky,
    const void* w1t_ptr, const void* w1t_col, const void* w1t_val,
    const void* w2t_ptr, const void* w2t_col, const void* w2t_val,
    const void* w1_ptr, const void* w1_col, const void* w1_val,
    const void* f_dst, const void* g_src, const void* diag1,
    const void* diag2, const void* f_ptr, const void* f_states,
    const void* g_ptr, const void* g_states, int n_pdf_lists, float leaky_c,
    int B, int T, int P, int s_pad, int debug, int stages, int t0,
    int n_frames, int ad_rows, int init_stride, int cluster, void* gamma,
    void* ab, void* gs, void* bd_io, void* leak_io, void* smid,
    void* stream) {
  constexpr bool kLean = kForm == BWD_LEAN;
  if (cluster != 1) {
    // the cluster forms, C = 2 or 4
    if constexpr (kLean) {
#define FACT_BWD_LEAN_CLUSTER(C)                                              \
  if (cluster == C)                                                           \
    return fact_bwd_lean_cluster_run<S, LEAN_CLUSTER_THREADS(C)>(             \
        lengths, ad_ys, px, s_ys, s0, ad0, final_p, tot, leaky, w1t_ptr,      \
        w1t_col, w1t_val, w2t_ptr, w2t_col, w2t_val, w1_ptr, w1_col, w1_val,  \
        f_dst, g_src, diag1, diag2, f_ptr, f_states, g_ptr, g_states,         \
        n_pdf_lists, leaky_c, B, T, P, s_pad, debug, stages, C, gamma, ab,    \
        gs, smid, stream);
      FACT_BWD_LEAN_CLUSTER(2)
      FACT_BWD_LEAN_CLUSTER(4)
#undef FACT_BWD_LEAN_CLUSTER
    } else {
#define FACT_BWD_FULL_CLUSTER(C)                                              \
  if (cluster == C)                                                           \
    return fact_bwd_full_cluster_run<S, LEAN_CLUSTER_THREADS(C), kForm>(      \
        lengths, ad_ys, w1ad_ys, xdst_ys, xsrc_ys, s_ys, s0, ad0, ad_init,    \
        final_p, tot, leaky, w1t_ptr, w1t_col, w1t_val, w2t_ptr, w2t_col,     \
        w2t_val, diag1, diag2, f_ptr, f_states, g_ptr, g_states, n_pdf_lists, \
        leaky_c, B, T, P, s_pad, debug, stages, t0, n_frames, ad_rows,        \
        init_stride, C, gamma, ab, gs, bd_io, leak_io, smid, stream);
      FACT_BWD_FULL_CLUSTER(2)
      FACT_BWD_FULL_CLUSTER(4)
#undef FACT_BWD_FULL_CLUSTER
    }
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smid != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const bool identity = kLean ? g_src == nullptr : xsrc_ys == nullptr;
  const size_t smem =
      fact_bwd_smem_bytes(s_pad, identity, stages, sizeof(S) == 2, kLean);
  cudaError_t err = fact_set_smem(fact_bwd_kernel<S, kForm>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fact_bwd_kernel<S, kForm><<<B, FACT_THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(lengths), static_cast<const S*>(ad_ys),
      static_cast<const S*>(w1ad_ys), static_cast<const S*>(xdst_ys),
      static_cast<const S*>(xsrc_ys), static_cast<const float*>(px),
      static_cast<const float*>(s_ys), static_cast<const float*>(s0),
      static_cast<const float*>(ad0), static_cast<const S*>(ad_init),
      static_cast<const float*>(final_p), static_cast<const float*>(tot),
      static_cast<const float*>(leaky), static_cast<const int*>(w1t_ptr),
      static_cast<const int*>(w1t_col), static_cast<const float*>(w1t_val),
      static_cast<const int*>(w2t_ptr), static_cast<const int*>(w2t_col),
      static_cast<const float*>(w2t_val), static_cast<const int*>(w1_ptr),
      static_cast<const int*>(w1_col), static_cast<const float*>(w1_val),
      static_cast<const int*>(f_dst), static_cast<const int*>(g_src),
      static_cast<const float*>(diag1), static_cast<const float*>(diag2),
      static_cast<const int*>(f_ptr), static_cast<const int*>(f_states),
      static_cast<const int*>(g_ptr), static_cast<const int*>(g_states),
      n_pdf_lists, leaky_c, T, P, s_pad, debug, stages, t0, n_frames,
      ad_rows, init_stride, static_cast<float*>(gamma),
      static_cast<float*>(ab), static_cast<float*>(gs),
      static_cast<float*>(bd_io), static_cast<float*>(leak_io));
  return static_cast<int>(cudaGetLastError());
}

// Every entry point takes the same arguments and returns
// cudaGetLastError() after the launch (0 on success), or -1 when
// cudaOccupancyMaxActiveClusters says no cluster of the asked shape can
// be resident.  The float32 forms ignore diag1 and diag2; the fast forms
// (_bf16) take bfloat16 streams, the operators' off-diagonal entries
// alone (bfloat16 values held in float32) and the float32 diagonals
// diag1 (W1's) and diag2 (W2's).  fact_bwd: the full mode (t0 0,
// n_frames T, no ad_init, no carry); fact_bwd_chunk: one chunk of the
// ckpt mode; fact_bwd_lean: the lean mode (px, W1's rows by destination,
// f_dst and g_src; no W1 alpha' or emission streams).  cluster: 1 (one
// 1024-thread block a column, smid null), or 2 or 4 CTAs a column, each
// writing its SM's id to smid[CTA] unless smid is null.
#define FACT_BWD_ENTRY(NAME, S, FORM)                                         \
  extern "C" int NAME(                                                        \
      const void* lengths, const void* ad_ys, const void* w1ad_ys,            \
      const void* xdst_ys, const void* xsrc_ys, const void* px,               \
      const void* s_ys, const void* s0, const void* ad0, const void* ad_init, \
      const void* final_p, const void* tot, const void* leaky,                \
      const void* w1t_ptr, const void* w1t_col, const void* w1t_val,          \
      const void* w2t_ptr, const void* w2t_col, const void* w2t_val,          \
      const void* w1_ptr, const void* w1_col, const void* w1_val,             \
      const void* f_dst, const void* g_src, const void* diag1,                \
      const void* diag2, const void* f_ptr, const void* f_states,             \
      const void* g_ptr, const void* g_states, int n_pdf_lists,               \
      float leaky_c, int B, int T, int P, int s_pad, int debug, int stages,   \
      int t0, int n_frames, int ad_rows, int init_stride, int cluster,        \
      void* gamma, void* ab, void* gs, void* bd_io, void* leak_io,            \
      void* smid, void* stream) {                                             \
    return fact_bwd_run<S, FORM>(                                             \
        lengths, ad_ys, w1ad_ys, xdst_ys, xsrc_ys, px, s_ys, s0, ad0,         \
        ad_init, final_p, tot, leaky, w1t_ptr, w1t_col, w1t_val, w2t_ptr,     \
        w2t_col, w2t_val, w1_ptr, w1_col, w1_val, f_dst, g_src, diag1, diag2, \
        f_ptr, f_states, g_ptr, g_states, n_pdf_lists, leaky_c, B, T, P,      \
        s_pad, debug, stages, t0, n_frames, ad_rows, init_stride, cluster,    \
        gamma, ab, gs, bd_io, leak_io, smid, stream);                         \
  }

FACT_BWD_ENTRY(fact_bwd_launch, float, BWD_FULL)
FACT_BWD_ENTRY(fact_bwd_bf16_launch, __nv_bfloat16, BWD_FULL)
FACT_BWD_ENTRY(fact_bwd_lean_launch, float, BWD_LEAN)
FACT_BWD_ENTRY(fact_bwd_lean_bf16_launch, __nv_bfloat16, BWD_LEAN)
FACT_BWD_ENTRY(fact_bwd_chunk_launch, float, BWD_CHUNK)
FACT_BWD_ENTRY(fact_bwd_chunk_bf16_launch, __nv_bfloat16, BWD_CHUNK)

template <int G>
static int fact_bwd_group_run(
    const void* lengths, const void* ad_ys, const void* w1ad_ys,
    const void* xdst_ys, const void* xsrc_ys, const void* s_ys,
    const void* s0, const void* ad0, const void* final_p, const void* tot,
    const void* leaky, const void* w1t_ptr, const void* w1t_pack,
    const void* w2t_ptr, const void* w2t_pack, const void* diag1,
    const void* diag2, const void* f_ptr, const void* f_states,
    const void* g_ptr, const void* g_states, int n_pdf_lists, float leaky_c,
    int B, int T, int P, int s_pad, int debug, int C, int op_words,
    void* gamma, void* ab, void* gs, void* smid, void* stream) {
  auto kernel = fact_bwd_group_kernel<G>;
  const size_t smem =
      fact_bwd_group_smem_bytes(s_pad, xsrc_ys == nullptr, G, C, op_words);
  const int active = group_active_clusters(kernel, smem, C);
  if (active < 0) return -active;
  if (active < 1) return -1;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config((B + G - 1) / G, C, smem, stream, attr);
  using S = __nv_bfloat16;
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int*>(lengths),
      static_cast<const S*>(ad_ys), static_cast<const S*>(w1ad_ys),
      static_cast<const S*>(xdst_ys), static_cast<const S*>(xsrc_ys),
      static_cast<const float*>(s_ys), static_cast<const float*>(s0),
      static_cast<const float*>(ad0), static_cast<const float*>(final_p),
      static_cast<const float*>(tot), static_cast<const float*>(leaky),
      static_cast<const int*>(w1t_ptr),
      static_cast<const unsigned*>(w1t_pack),
      static_cast<const int*>(w2t_ptr),
      static_cast<const unsigned*>(w2t_pack),
      static_cast<const float*>(diag1), static_cast<const float*>(diag2),
      static_cast<const int*>(f_ptr), static_cast<const int*>(f_states),
      static_cast<const int*>(g_ptr), static_cast<const int*>(g_states),
      n_pdf_lists, leaky_c, B, T, P, s_pad, debug,
      static_cast<float*>(gamma), static_cast<float*>(ab),
      static_cast<float*>(gs), static_cast<int*>(smid));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The clusters of the group form at (G, C) that the card holds at once
// for this graph (cudaOccupancyMaxActiveClusters), or minus the CUDA error
// (cudaErrorInvalidValue for a (G, C) that is not built).
extern "C" int fact_bwd_group_active_clusters(int s_pad, int identity, int G,
                                              int C, int op_words) {
  if (C != 2 && C != 4) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      fact_bwd_group_smem_bytes(s_pad, identity, G, C, op_words);
  if (G == 1) return group_active_clusters(fact_bwd_group_kernel<1>, smem, C);
  if (G == 2) return group_active_clusters(fact_bwd_group_kernel<2>, smem, C);
  if (G == 4) return group_active_clusters(fact_bwd_group_kernel<4>, smem, C);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// fact_bwd_bf16's group form (counted as fact_bwd_bf16): G columns (1, 2
// or 4) a cluster of C CTAs (2 or 4), ceil(B / G) clusters, on fact_fwd's
// bfloat16 streams; w1t_pack / w2t_pack the packed slots of the operators
// whose slice pointers are w1t_ptr / w2t_ptr (B2's bank order); op_words
// as fact_bwd_group_smem_bytes; smid (ceil(B / G) C,) or null.  Returns
// as the other entry points, and cudaErrorInvalidValue for a (G, C) that
// is not built.
extern "C" int fact_bwd_group_launch(
    const void* lengths, const void* ad_ys, const void* w1ad_ys,
    const void* xdst_ys, const void* xsrc_ys, const void* s_ys,
    const void* s0, const void* ad0, const void* final_p, const void* tot,
    const void* leaky, const void* w1t_ptr, const void* w1t_pack,
    const void* w2t_ptr, const void* w2t_pack, const void* diag1,
    const void* diag2, const void* f_ptr, const void* f_states,
    const void* g_ptr, const void* g_states, int n_pdf_lists, float leaky_c,
    int B, int T, int P, int s_pad, int debug, int G, int C, int op_words,
    void* gamma, void* ab, void* gs, void* smid, void* stream) {
  if (C != 2 && C != 4) return static_cast<int>(cudaErrorInvalidValue);
  // G = 1 runs at C = 2 alone (kernel_ablation.py times C = 4)
  if (G == 1 && C != 2) return static_cast<int>(cudaErrorInvalidValue);
#define FACT_BWD_GROUP(GG)                                                    \
  if (G == GG)                                                                \
    return fact_bwd_group_run<GG>(                                            \
        lengths, ad_ys, w1ad_ys, xdst_ys, xsrc_ys, s_ys, s0, ad0, final_p,    \
        tot, leaky, w1t_ptr, w1t_pack, w2t_ptr, w2t_pack, diag1, diag2,       \
        f_ptr, f_states, g_ptr, g_states, n_pdf_lists, leaky_c, B, T, P,      \
        s_pad, debug, C, op_words, gamma, ab, gs, smid, stream);
  FACT_BWD_GROUP(1)
  FACT_BWD_GROUP(2)
  FACT_BWD_GROUP(4)
#undef FACT_BWD_GROUP
  return static_cast<int>(cudaErrorInvalidValue);
}

#endif  // FACT_COLUMNS_ONLY
