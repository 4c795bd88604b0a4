// Denominator alpha sweep on the factorized graph, float32 and fast mode.
//
// Replaces pychain_tpu/ops/pallas_fact.py::_fwd_kernel_factory (launched
// there by _fwd_pallas) in its three stream modes and in both its
// precisions: float32 ("parity") and the fast mode of bfloat16 tiles
// (the _bf16 entry points).  Per frame t of column b (the reference's
// "version 3" recurrence, chain-computation.h:109-155):
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
// The stream modes (pallas_fact.py:786-807), one kernel each entry point:
//
// * fact_fwd ("full"): all of the above (emit_aux, :223-230);
// * fact_fwd_snap ("lean" and the first sweep of "ckpt"): no W1 alpha' or
//   emission rows, and alpha' only at the frames t with (t + 1) % C == 0,
//   at row (t + 1) / C - 1 of a (B, ceil(T / C), S_pad) stream
//   (snap_every, :419-431): C = 1 is the lean mode's alpha' stream, C > 1
//   the ckpt mode's snapshots, alpha' at each chunk's last frame;
// * fact_fwd_init (the ckpt mode's replay of one chunk, ext_init,
//   :237-275): frames t0 .. t0 + n - 1 from the snapshot alpha'(t0) (the
//   stream type's values) and s_{t0} in place of alpha'(0) and s_0,
//   writing the full mode's streams for those frames alone, at local rows
//   t - t0 of (B, n, S_pad) streams, and neither s_t nor alpha'(T_b).
//
// A launch covers frames t0 .. min(t0 + n, T_b) - 1 of each column.  In
// float32 a replay from the snapshot computes what the full sweep
// computed (the same carry, the same s_{t0}, the same arithmetic); in the
// fast mode the snapshot is the bfloat16 alpha', whose unrounded carry
// the replay does not have, as in the Pallas kernel.
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
// time, PERF.md).  One block owns one batch column (a cluster of C
// CTAs where B C <= the card's SMs: fact_fwd_cluster_kernel below)
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
//
// The other stream modes do the same arithmetic and move fewer bytes.
// At bench.py --long --big (B = 64, T = 3,700, the headline graph,
// bfloat16 streams) px is 2.84 GB (0.85 ms at 3.35 TB/s) and a stream
// 1.45 GB: fact_fwd_bf16 must move 7.2 GB (2.15 ms), the lean mode's
// fact_fwd_snap_bf16 4.3 GB (1.28 ms), the ckpt mode's snapshot sweep px
// and 58 rows a column (0.86 ms), and its 58 replays (fact_fwd_init_bf16)
// together px and the three streams (2.15 ms).
//
// The fast mode rounds where the Pallas kernel does with bfloat16 tiles
// (pallas_fact.py:178-205, :283-313, :866): px to bfloat16 as it is read
// (so x_dst and x_src are bfloat16 values; no extra pass over x), the
// operands of the off-diagonal products (W1's and W2's entries are
// bfloat16 values, the diagonal stays float32 with an unrounded operand),
// and the three streams, which it writes as bfloat16: half the bytes, so its
// bytes bound at the headline size falls to about 0.58 ms.  The carry,
// s_t and alpha'(T_b) stay float32.  The vectors the products gather (the
// carry and x_src * alpha') hold bfloat16-rounded values, kept as
// float32, written once by their owner (sell_row_dot, fact_common.cuh);
// each owner keeps its unrounded carry in a and, outside identity mode,
// its x_src in one more vector, within B2's shared memory (5 S_pad), so
// the resident limits do not move.  alpha is scaled by 1 / s_{t-1} as
// the Pallas kernel does.  In this mode the kernel computes what its
// plain version (ops/factorized.forward_prob_fast) computes bit for bit:
// that version takes each sum in this kernel's order (each row's slots,
// then the diagonal; block_sum's tree), and the kernel rounds each
// product and sum on its own where the plain version does.  Two float32
// sums taken in different orders would, through the bfloat16 roundings
// they feed, drift apart over a sequence by far more than float32
// rounding (1e-2 in gamma at the headline size, PERF.md).

#include "fact_common.cuh"

// The full and init forms' cluster form exchanges its totals and carry
// rows by 1: st.async stores completing on the receivers' mbarriers; 0:
// DSMEM stores and cluster barriers, as the snap form (kernel_ablation.py
// times both).
#define FACT_FWD_ASYNC 1

// The forms of the entry points: fact_fwd, fact_fwd_snap, fact_fwd_init.
enum FwdForm { FWD_FULL, FWD_SNAP, FWD_INIT };

// S: the stream type, float (float32 mode) or __nv_bfloat16 (fast mode).
// kForm: FWD_FULL and FWD_INIT write W1 alpha' and the emission rows,
// FWD_SNAP alpha' alone at every snap-th frame; FWD_INIT starts from
// ad_init / s_init at frame t0 and writes neither s_t nor alpha'(T_b).
// The full form's frame range, rows and snap are compile-time constants,
// so that it compiles as it did before the other forms.
template <typename S, int kForm>
__global__ void __launch_bounds__(FACT_THREADS, 1) fact_fwd_kernel(
    const float* __restrict__ px,        // (B, T, P) exp'd nnet output
    const int* __restrict__ lengths,     // (B,)  1 <= T_b <= T
    const int* __restrict__ f_dst,       // (S_pad,) pdf of each state's W1 term
    const int* __restrict__ g_src,       // (S_pad,) or null (identity mode)
    const int* __restrict__ w1_ptr, const int* __restrict__ w1_col,
    const float* __restrict__ w1_val,        // W1 by destination row
    const int* __restrict__ w2_ptr, const int* __restrict__ w2_col,
    const float* __restrict__ w2_val,        // W2 by destination row
    const float* __restrict__ diag1,     // (S_pad,) W1's diagonal (fast mode)
    const float* __restrict__ diag2,     // (S_pad,) W2's diagonal (fast mode)
    const float* __restrict__ ad0,       // (S_pad,) alpha'(0)
    const float* __restrict__ s0,        // (1,) sum of the initial probs
    const S* __restrict__ ad_init,       // column b's alpha'(t0) at
                                         // b * init_stride (FWD_INIT)
    const float* __restrict__ s_init,    // column b's s_{t0} at
                                         // b * s_stride (FWD_INIT)
    const float* __restrict__ leaky,     // (S_pad,)
    float leaky_c, int T, int P, int s_pad, int t0_arg, int n_arg,
    int snap_arg, int rows_arg, int init_stride, int s_stride,
    S* __restrict__ ad_ys,               // (B, ad_rows, S_pad) alpha'(t+1)
    S* __restrict__ w1ad_ys,             // (B, ad_rows, S_pad) W1 alpha'(t)
    S* __restrict__ xdst_ys,             // (B, ad_rows, S_pad)
    S* __restrict__ xsrc_ys,             // (B, ad_rows, S_pad) or null
    float* __restrict__ s_ys,            // (B, T) s_{t+1}; 1 past the end
    float* __restrict__ ad_last) {       // (B, S_pad) alpha'(T_b)
  constexpr bool kFast = sizeof(S) == 2;
  constexpr bool kAux = kForm != FWD_SNAP;
  constexpr bool kInit = kForm == FWD_INIT;
  const int t0 = kInit ? t0_arg : 0;
  const int n_frames = kInit ? n_arg : T;
  const int snap = kForm == FWD_SNAP ? snap_arg : 1;
  const int ad_rows = kForm == FWD_FULL ? T : rows_arg;
  extern __shared__ float smem[];
  float* ad = smem;            // alpha' carry: gathered by W1's rows
  float* u = ad + s_pad;       // x_src * alpha': gathered by W2's rows
  float* xd = u + s_pad;       // x_dst(t), read by the row's owner only
  float* a = xd + s_pad;       // alpha(t) before the leaky term, ditto
  // fast mode outside identity mode: x_src(t), read by the row's owner
  const bool own_xs = kFast && g_src != nullptr;
  float* xs_own = own_xs ? a + s_pad : xd;
  float* red = a + (own_xs ? 2 : 1) * s_pad;   // block_sum scratch

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int Tb = lengths[b];
  const size_t row0 = static_cast<size_t>(b) * T;
  const int t_end = min(t0 + n_frames, Tb);

  float s_prev;
  if (kInit) {
    // re-entry from a snapshot: its values are the carry (rounded to the
    // stream type already, so the fast mode's gathered copy equals it)
    const S* init = ad_init + static_cast<size_t>(b) * init_stride;
    for (int s = tid; s < s_pad; s += FACT_THREADS) {
      const float v = stream_get(init + s);
      ad[s] = v;
      if (kFast) a[s] = v;
    }
    s_prev = s_init[static_cast<size_t>(b) * s_stride];
  } else {
    for (int s = tid; s < s_pad; s += FACT_THREADS) {
      ad[s] = round_to<S>(ad0[s]);
      // fast mode: a holds each row's unrounded carry between frames
      if (kFast) a[s] = ad0[s];
    }
    s_prev = *s0;
  }

  for (int t = t0; t < t_end; ++t) {
    const float* px_t = px + (row0 + t) * P;
    const size_t o = (static_cast<size_t>(b) * ad_rows + (t - t0)) * s_pad;
    for (int s = tid; s < s_pad; s += FACT_THREADS) {
      const float x = round_to<S>(__ldg(px_t + f_dst[s]));
      const float xs = g_src ? round_to<S>(__ldg(px_t + g_src[s])) : x;
      xd[s] = x;
      if (kFast) {
        if (own_xs) xs_own[s] = xs;
        u[s] = round_to<S>(xs * a[s]);
      } else {
        u[s] = xs * ad[s];
      }
      if (kAux) {
        stream_put(xdst_ys + o + s, x);
        if (xsrc_ys) stream_put(xsrc_ys + o + s, xs);
      }
    }
    __syncthreads();

    const float r = 1.0f / s_prev;
    float part[1] = {0.0f};
    for (int d = tid; d < s_pad; d += FACT_THREADS) {
      float w1a = sell_row_dot(w1_ptr, w1_col, w1_val, d, ad);
      float w2u = sell_row_dot(w2_ptr, w2_col, w2_val, d, u);
      float av;
      if (kFast) {
        // the diagonal stratum: float32 values, unrounded operands; each
        // product and sum rounded on its own (no fused multiply-add), in
        // the plain version's order, which this kernel matches bit for bit
        const float own = a[d];
        w1a = __fadd_rn(w1a, __fmul_rn(__ldg(diag1 + d), own));
        w2u = __fadd_rn(w2u, __fmul_rn(__ldg(diag2 + d),
                                       __fmul_rn(xs_own[d], own)));
        av = __fmul_rn(__fadd_rn(__fmul_rn(xd[d], w1a), w2u), r);
      } else {
        av = (xd[d] * w1a + w2u) / s_prev;
      }
      a[d] = av;
      if (kAux) stream_put(w1ad_ys + o + d, w1a);
      part[0] += av;
    }
    // also the barrier after which ad and u may be overwritten
    block_sum<1>(part, red);
    const float s_t = part[0];
    const float cs = leaky_c * s_t;
    // alpha' is written at every snap-th frame (each frame but in the
    // ckpt mode's snapshot sweep), at its row of ad_ys
    const bool put = (t + 1) % snap == 0;
    const size_t oa =
        (static_cast<size_t>(b) * ad_rows + ((t + 1) / snap - 1 - t0 / snap)) *
        s_pad;
    for (int d = tid; d < s_pad; d += FACT_THREADS) {
      const float v = kFast ? __fadd_rn(a[d], __fmul_rn(cs, leaky[d]))
                            : a[d] + cs * leaky[d];
      if (kFast) a[d] = v;
      ad[d] = round_to<S>(v);
      if (put) stream_put(ad_ys + oa + d, v);
      if (!kInit && t == Tb - 1)
        ad_last[static_cast<size_t>(b) * s_pad + d] = v;
    }
    if (!kInit && tid == 0) s_ys[row0 + t] = s_t;
    s_prev = s_t;
  }
  if (!kInit)
    for (int t = Tb + tid; t < T; t += FACT_THREADS) s_ys[row0 + t] = 1.0f;
}

// Every form on a cluster of C CTAs (C = 2 or 4) of NT threads a column,
// where B * C <= the card's SMs (fact_kernels.cluster_size): the lean
// mode's alpha' stream and the ckpt mode's snapshot sweep (FWD_SNAP), the
// full mode's sweep (FWD_FULL) and the ckpt mode's replays (FWD_INIT).
//
// Why.  The C = 1 kernel gives a column one block, so at bench.py --long
// --big (B = 64) 64 blocks run on 132 SMs and half the card idles for the
// whole 3,700-frame loop; a frame (about 9 us) is the serial work of one
// SM.  Here CTA r of a column's cluster owns the virtual warps w = r
// (mod C) of the C = 1 block and their rows (fact_common.cuh): it
// computes those rows' W1 and W2 products, the emissions and the carry,
// and writes the two vectors the products gather, alpha' (ad) and
// x_src * alpha' (u), into its own shared memory and each peer's (DSMEM
// stores), so that every CTA holds both whole.  A frame:
//
//   products on own rows (FWD_FULL, FWD_INIT: their W1 alpha' stream
//   row) -> alpha(t) -> virtual warp totals posted to every CTA ->
//   cluster arrive -> own rows' emissions of frame t + 1 gathered from px
//   (they need nothing of the peers; FWD_FULL, FWD_INIT: their x_dst and
//   x_src stream rows) -> cluster wait -> block_sum's cross-warp tree:
//   s_t, the same bits in every CTA -> own rows' carry alpha'(t + 1) and
//   u(t + 1) to every CTA -> cluster arrive -> own rows' alpha' stream
//   row and alpha'(T_b) -> cluster wait.
//
// A CTA writes its own rows of each stream: 32-row slices, runs of 64
// bytes in bfloat16 and 128 in float32, so the stores stay whole
// sectors.  FWD_INIT enters at frame t0 from ad_init and s_init as the
// C = 1 kernel does (every CTA reads the whole snapshot row into ad; in
// the fast mode the unrounded carry is the snapshot value) and writes
// neither s_t nor alpha'(T_b).
//
// The two exchanges of a frame.  FWD_SNAP passes cluster barriers: the
// split one around the emissions, and one after the carry's DSMEM
// stores (one more at a launch's start, before any DSMEM store, and one
// at its end, so that no CTA exits while a peer writes to it); every
// vector a peer writes is written only after the barrier that follows
// the peers' last reads of it.  FWD_FULL and FWD_INIT (FACT_FWD_ASYNC)
// pass none a frame: the totals and each warp's slice of the carry go to
// the peers by st.async (warp_put_async), completing on the receiver's
// mbarrier of that exchange, which waits on it.  Main path 7's
// fact_fwd_bf16 at C = 2 took 27.4 ms so, 28.7 with the cluster barriers
// (C = 1 33.3; its products 21.3 -> 12.5 ms; kernel_ablation.py,
// PERF.md); the snap form keeps its barriers, the design measured with
// it (a candidate for the same exchange).  At C = 4 (B = 32) every form is
// slower than at C = 1, so the plan takes at most 2
// (fact_kernels.PLAN_CLUSTERS).  Each row's products are
// its own sell_row_dot and every sum is taken in the C = 1 kernel's
// order, so the results are that kernel's bit for bit (the card tests
// hold float32 and the fast form to it, and the fast form to its plain
// version).
//
// Threads per CTA (LEAN_CLUSTER_THREADS): NT = 1024, a full block (at
// most two rows a thread at the headline graph, where C = 1 has three);
// the virtual threads (tid < 1024 / C) add their rows' alpha in turn
// after a block barrier.  At main path 7, C = 2, in the lean sweep
// (PERF.md, kernel_ablation.py): 1024 threads 27.5 ms, 1024 / C 35.4 ms,
// C = 1 33.2 ms.  The sparse products take half the time of C = 1's
// (10.9 against 21.0 ms: the SM's throughput bounds them, given 32
// warps), but the rest of a frame grows from 3.3 to 4.5 us: the two
// cluster barriers 0.71 us a frame (made block barriers, the kernel
// takes 24.9 ms), the DSMEM stores and the virtual threads' pass.
//
// Co-location.  Two CTAs of a cluster fit one SM when both fit its
// 228 KB (61 KB at the headline graph), which would undo the split: the
// launch asks for at least LEAN_CLUSTER_MIN_SMEM bytes, so one CTA an SM
// (%smid shows 128 CTAs on 128 SMs at main path 7).
//
// Shared memory: ad and u whole, x_dst and alpha on own rows (indexed by
// state), x_src on own rows outside identity mode in both precisions
// (frame t + 1's emissions are gathered before the new carry exists),
// the scratch: (4 or 5) S_pad + 33 floats, for every form.
template <typename S, int NT, int kForm>
__global__ void __launch_bounds__(NT, 1) fact_fwd_cluster_kernel(
    const float* __restrict__ px,        // (B, T, P) exp'd nnet output
    const int* __restrict__ lengths,     // (B,)  1 <= T_b <= T
    const int* __restrict__ f_dst,       // (S_pad,) pdf of each state's W1 term
    const int* __restrict__ g_src,       // (S_pad,) or null (identity mode)
    const int* __restrict__ w1_ptr, const int* __restrict__ w1_col,
    const float* __restrict__ w1_val,        // W1 by destination row
    const int* __restrict__ w2_ptr, const int* __restrict__ w2_col,
    const float* __restrict__ w2_val,        // W2 by destination row
    const float* __restrict__ diag1,     // (S_pad,) W1's diagonal (fast mode)
    const float* __restrict__ diag2,     // (S_pad,) W2's diagonal (fast mode)
    const float* __restrict__ ad0,       // (S_pad,) alpha'(0)
    const float* __restrict__ s0,        // (1,) sum of the initial probs
    const S* __restrict__ ad_init,       // column b's alpha'(t0) (FWD_INIT)
    const float* __restrict__ s_init,    // column b's s_{t0} (FWD_INIT)
    const float* __restrict__ leaky,     // (S_pad,)
    float leaky_c, int T, int P, int s_pad, int t0_arg, int n_arg,
    int snap_arg, int rows_arg, int init_stride, int s_stride,
    S* __restrict__ ad_ys,               // (B, ad_rows, S_pad) alpha'(t+1)
    S* __restrict__ w1ad_ys,             // (B, ad_rows, S_pad) W1 alpha'(t)
    S* __restrict__ xdst_ys,             // (B, ad_rows, S_pad)
    S* __restrict__ xsrc_ys,             // (B, ad_rows, S_pad) or null
    float* __restrict__ s_ys,            // (B, T) s_{t+1}; 1 past the end
    float* __restrict__ ad_last,         // (B, S_pad) alpha'(T_b)
    int* __restrict__ smid) {            // (B * C,) each CTA's SM, or null
  namespace cg = cooperative_groups;
  constexpr bool kFast = sizeof(S) == 2;
  constexpr bool kAux = kForm != FWD_SNAP;
  constexpr bool kInit = kForm == FWD_INIT;
  constexpr bool kAsync = kAux && FACT_FWD_ASYNC;
  const int t0 = kInit ? t0_arg : 0;
  const int n_frames = kInit ? n_arg : T;
  const int snap = kForm == FWD_SNAP ? snap_arg : 1;
  const int ad_rows = kForm == FWD_FULL ? T : rows_arg;
  const int C = static_cast<int>(cg::this_cluster().num_blocks());
  const int rank = static_cast<int>(cg::this_cluster().block_rank());
  const int lc = __ffs(C) - 1;
  const int V = FACT_THREADS >> lc;      // this CTA's virtual threads
  extern __shared__ float smem[];
  float* ad = smem;            // alpha' carry, whole: gathered by W1's rows
  float* u = ad + s_pad;       // x_src * alpha', whole: by W2's rows
  float* xd = u + s_pad;       // x_dst(t), own rows
  float* a = xd + s_pad;       // alpha(t) before the leaky term, own rows
  float* xs = g_src ? a + s_pad : xd;   // x_src(t), own rows
  float* red = a + (g_src ? 2 : 1) * s_pad;   // totals and scratch
  // kAsync: the mbarriers of the totals' exchange and the carry's, past
  // the scratch's FACT_WARPS + 1 floats rounded up to 16 bytes
  unsigned long long* xbar =
      reinterpret_cast<unsigned long long*>(red + FACT_WARPS + 4);

  const int tid = threadIdx.x;
  const int b = static_cast<int>(blockIdx.x) >> lc;
  if (smid && tid == 0) smid[blockIdx.x] = sm_id();
  const int Tb = lengths[b];
  const size_t row0 = static_cast<size_t>(b) * T;
  const int t_end = min(t0 + n_frames, Tb);
  const int own = cluster_own_rows(s_pad, rank, C);

  // own rows' x_dst(t) and x_src(t), rounded as the C = 1 kernel rounds
  // (the full and init forms: and their stream rows)
  auto gather = [&](int t) {
    const float* px_t = px + (row0 + t) * P;
    const size_t o = (static_cast<size_t>(b) * ad_rows + (t - t0)) * s_pad;
    for (int i = tid; i < own; i += NT) {
      const int s = cluster_row(i, rank, C);
      const float x = round_to<S>(__ldg(px_t + f_dst[s]));
      xd[s] = x;
      if (g_src) xs[s] = round_to<S>(__ldg(px_t + g_src[s]));
      if (kAux) {
        stream_put(xdst_ys + o + s, x);
        if (xsrc_ys) stream_put(xsrc_ys + o + s, xs[s]);
      }
    }
  };
  // x at p to every CTA (p in this CTA's rows of ad or u): by the frame's
  // exchange, a warp's slice at once with kAsync (every lane calls it)
  auto send = [&](float* p, float x) {
    if (kAsync) {
      warp_put_async(p, x, rank, C, xbar + 1);
    } else {
      cluster_put(p, x, rank, C);
    }
  };
  // own rows' W2 operand (the C = 1 kernel's head) to every CTA, from the
  // carry v (unrounded) of each row
  auto put_u = [&](int i, float v) {
    const int s = cluster_row(i, rank, C);
    send(u + s, kFast ? round_to<S>(xs[s] * v) : xs[s] * v);
  };

  float s_prev;
  if (kInit) {
    // re-entry from a snapshot: its values are the carry (rounded to the
    // stream type already, so the fast mode's gathered copy equals it)
    const S* init = ad_init + static_cast<size_t>(b) * init_stride;
    for (int s = tid; s < s_pad; s += NT) {
      const float v = stream_get(init + s);
      ad[s] = v;
      if (kFast) a[s] = v;
    }
    s_prev = s_init[static_cast<size_t>(b) * s_stride];
  } else {
    for (int s = tid; s < s_pad; s += NT) {
      ad[s] = round_to<S>(ad0[s]);
      // fast mode: a holds each own row's unrounded carry between frames
      if (kFast) a[s] = ad0[s];
    }
    s_prev = *s0;
  }
  if (t0 < t_end) gather(t0);
  if (kAsync && tid == 0) {
    mbar_init(xbar, 1);
    mbar_init(xbar + 1, 1);
  }
  cluster_barrier();   // every CTA has started: peers may be written
  if (t0 < t_end)
    for (int i = tid; i < own; i += NT) {
      const int d = cluster_row(i, rank, C);
      const float v = kInit ? ad[d] : ad0[d];
      cluster_put(u + d, kFast ? round_to<S>(xs[d] * v) : xs[d] * v, rank,
                  C);
    }
  cluster_barrier();
  // kAsync: the bytes a CTA's peers send it in the totals' exchange
  // ((32 / C) warp totals from each) and the carry's (their rows of ad
  // and u).  Each exchange needs the one before (the totals make s_t, s_t
  // the carry, the carry the products and the products the totals), so a
  // peer's store can only follow the receiver's last reads of what it
  // writes (its products of frame t for ad and u: it posts frame t's
  // totals after them; its tree of frame t's totals: it sends frame t's
  // carry after it), and the phases of an mbarrier never overlap: each is
  // armed by thread 0 at the frame's start, after every thread passed
  // the last wait on it, and waited on at the frame's parity.
  const unsigned warp_bytes = (C - 1) * (32u >> lc) * 4u;
  const unsigned carry_bytes = static_cast<unsigned>(s_pad - own) * 8u;

  for (int t = t0; t < t_end; ++t) {
    const float r = 1.0f / s_prev;
    const size_t o = (static_cast<size_t>(b) * ad_rows + (t - t0)) * s_pad;
    const unsigned parity = (t - t0) & 1;
    if (kAsync && tid == 0) {
      mbar_expect_tx(xbar, warp_bytes);
      if (t + 1 < t_end) mbar_expect_tx(xbar + 1, carry_bytes);
    }
    for (int i = tid; i < own; i += NT) {
      const int d = cluster_row(i, rank, C);
      float w1a = sell_row_dot(w1_ptr, w1_col, w1_val, d, ad);
      float w2u = sell_row_dot(w2_ptr, w2_col, w2_val, d, u);
      float av;
      if (kFast) {
        // the C = 1 kernel's arithmetic, rounded where it rounds
        const float own_a = a[d];
        w1a = __fadd_rn(w1a, __fmul_rn(__ldg(diag1 + d), own_a));
        w2u = __fadd_rn(w2u, __fmul_rn(__ldg(diag2 + d),
                                       __fmul_rn(xs[d], own_a)));
        av = __fmul_rn(__fadd_rn(__fmul_rn(xd[d], w1a), w2u), r);
      } else {
        av = (xd[d] * w1a + w2u) / s_prev;
      }
      a[d] = av;
      if (kAux) stream_put(w1ad_ys + o + d, w1a);
    }
    // each virtual thread adds its rows in turn
    __syncthreads();
    float part[1] = {0.0f};
    if (tid < V)
      for (int d = cluster_row(tid, rank, C); d < s_pad; d += FACT_THREADS)
        part[0] += a[d];
    if (kAsync) {
      cluster_post_async<1>(part, red, V, rank, lc, xbar);
    } else {
      cluster_post<1>(part, red, V, rank, lc);
      cluster_arrive();
    }
    // frame t + 1's emissions (each row's owner thread overwrites what it
    // alone read above) while the peers' totals arrive
    if (t + 1 < t_end) gather(t + 1);
    if (kAsync) {
      __syncthreads();   // this CTA's totals
      mbar_wait_cluster(xbar, parity);
    } else {
      cluster_wait();
    }
    cluster_warp_total<1>(part, red);
    const float s_t = part[0];
    const float cs = leaky_c * s_t;
    for (int i = tid; i < own; i += NT) {
      const int d = cluster_row(i, rank, C);
      const float v = kFast ? __fadd_rn(a[d], __fmul_rn(cs, leaky[d]))
                            : a[d] + cs * leaky[d];
      a[d] = v;
      if (kAsync && t + 1 == t_end) continue;   // no frame reads it
      send(ad + d, round_to<S>(v));
      if (t + 1 < t_end) put_u(i, v);
    }
    if (!kInit && rank == 0 && tid == 0) s_ys[row0 + t] = s_t;
    s_prev = s_t;
    if (!kAsync) cluster_arrive();
    // alpha' is written at every snap-th frame, at its row of ad_ys; the
    // carry is this CTA's own (no peer writes these rows of a)
    const bool put = (t + 1) % snap == 0;
    const size_t oa =
        (static_cast<size_t>(b) * ad_rows + ((t + 1) / snap - 1 - t0 / snap)) *
        s_pad;
    for (int i = tid; i < own; i += NT) {
      const int d = cluster_row(i, rank, C);
      if (put) stream_put(ad_ys + oa + d, a[d]);
      if (!kInit && t == Tb - 1)
        ad_last[static_cast<size_t>(b) * s_pad + d] = a[d];
    }
    if (!kAsync) {
      cluster_wait();
    } else if (t + 1 < t_end) {
      __syncthreads();   // this CTA's rows of the carry
      mbar_wait_cluster(xbar + 1, parity);
    }
  }
  if (!kInit && rank == 0)
    for (int t = Tb + tid; t < T; t += NT) s_ys[row0 + t] = 1.0f;
  cluster_barrier();   // no peer touches this CTA's shared memory after it
}

extern "C" size_t fact_fwd_smem_bytes(int s_pad, int identity, int fast) {
  const size_t vectors = fast && !identity ? 5 : 4;
  return (vectors * static_cast<size_t>(s_pad) + FACT_WARPS + 1) *
         sizeof(float);
}

// The cluster form's request, every form alike: x_src on own rows outside
// identity mode in both precisions, the scratch padded to 16 bytes and two
// mbarriers, and never less than LEAN_CLUSTER_MIN_SMEM (one CTA an SM).
extern "C" size_t fact_fwd_cluster_smem_bytes(int s_pad, int identity) {
  const size_t need = ((identity ? 4 : 5) * static_cast<size_t>(s_pad) +
                       FACT_WARPS + 4 + 4) * sizeof(float);
  return need > LEAN_CLUSTER_MIN_SMEM ? need : LEAN_CLUSTER_MIN_SMEM;
}

template <typename S, int NT, int kForm>
static int fact_fwd_cluster_run(
    const void* px, const void* lengths, const void* f_dst, const void* g_src,
    const void* w1_ptr, const void* w1_col, const void* w1_val,
    const void* w2_ptr, const void* w2_col, const void* w2_val,
    const void* diag1, const void* diag2, const void* ad0, const void* s0,
    const void* ad_init, const void* s_init, const void* leaky, float leaky_c,
    int B, int T, int P, int s_pad, int t0, int n_frames, int snap,
    int ad_rows, int init_stride, int s_stride, int cluster, void* ad_ys,
    void* w1ad_ys, void* xdst_ys, void* xsrc_ys, void* s_ys, void* ad_last,
    void* smid, void* stream) {
  auto kernel = fact_fwd_cluster_kernel<S, NT, kForm>;
  const size_t smem = fact_fwd_cluster_smem_bytes(s_pad, g_src == nullptr);
  cudaError_t err = fact_set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = cluster_config(B, cluster, smem, stream, attr, NT);
  int active = 0;
  err = cudaOccupancyMaxActiveClusters(&active, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (active < 1) return -1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(px),
      static_cast<const int*>(lengths), static_cast<const int*>(f_dst),
      static_cast<const int*>(g_src), static_cast<const int*>(w1_ptr),
      static_cast<const int*>(w1_col), static_cast<const float*>(w1_val),
      static_cast<const int*>(w2_ptr), static_cast<const int*>(w2_col),
      static_cast<const float*>(w2_val), static_cast<const float*>(diag1),
      static_cast<const float*>(diag2), static_cast<const float*>(ad0),
      static_cast<const float*>(s0), static_cast<const S*>(ad_init),
      static_cast<const float*>(s_init), static_cast<const float*>(leaky),
      leaky_c, T, P, s_pad, t0, n_frames, snap, ad_rows, init_stride,
      s_stride, static_cast<S*>(ad_ys), static_cast<S*>(w1ad_ys),
      static_cast<S*>(xdst_ys), static_cast<S*>(xsrc_ys),
      static_cast<float*>(s_ys), static_cast<float*>(ad_last),
      static_cast<int*>(smid));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, int kForm>
static int fact_fwd_run(
    const void* px, const void* lengths, const void* f_dst, const void* g_src,
    const void* w1_ptr, const void* w1_col, const void* w1_val,
    const void* w2_ptr, const void* w2_col, const void* w2_val,
    const void* diag1, const void* diag2, const void* ad0, const void* s0,
    const void* ad_init, const void* s_init, const void* leaky, float leaky_c,
    int B, int T, int P, int s_pad, int t0, int n_frames, int snap,
    int ad_rows, int init_stride, int s_stride, int cluster, void* ad_ys,
    void* w1ad_ys, void* xdst_ys, void* xsrc_ys, void* s_ys, void* ad_last,
    void* smid, void* stream) {
  if (cluster != 1) {
    // the cluster form, C = 2 or 4
#define FACT_FWD_CLUSTER(C)                                                   \
  if (cluster == C)                                                           \
    return fact_fwd_cluster_run<S, LEAN_CLUSTER_THREADS(C), kForm>(           \
        px, lengths, f_dst, g_src, w1_ptr, w1_col, w1_val, w2_ptr, w2_col,    \
        w2_val, diag1, diag2, ad0, s0, ad_init, s_init, leaky, leaky_c, B, T, \
        P, s_pad, t0, n_frames, snap, ad_rows, init_stride, s_stride, C,      \
        ad_ys, w1ad_ys, xdst_ys, xsrc_ys, s_ys, ad_last, smid, stream);
    FACT_FWD_CLUSTER(2)
    FACT_FWD_CLUSTER(4)
#undef FACT_FWD_CLUSTER
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smid != nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fact_fwd_smem_bytes(s_pad, g_src == nullptr,
                                          sizeof(S) == 2);
  cudaError_t err = fact_set_smem(fact_fwd_kernel<S, kForm>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fact_fwd_kernel<S, kForm><<<B, FACT_THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(px), static_cast<const int*>(lengths),
      static_cast<const int*>(f_dst), static_cast<const int*>(g_src),
      static_cast<const int*>(w1_ptr), static_cast<const int*>(w1_col),
      static_cast<const float*>(w1_val), static_cast<const int*>(w2_ptr),
      static_cast<const int*>(w2_col), static_cast<const float*>(w2_val),
      static_cast<const float*>(diag1), static_cast<const float*>(diag2),
      static_cast<const float*>(ad0), static_cast<const float*>(s0),
      static_cast<const S*>(ad_init), static_cast<const float*>(s_init),
      static_cast<const float*>(leaky), leaky_c, T, P, s_pad, t0, n_frames,
      snap, ad_rows, init_stride, s_stride, static_cast<S*>(ad_ys),
      static_cast<S*>(w1ad_ys), static_cast<S*>(xdst_ys),
      static_cast<S*>(xsrc_ys), static_cast<float*>(s_ys),
      static_cast<float*>(ad_last));
  return static_cast<int>(cudaGetLastError());
}

// Every entry point takes the same arguments and returns
// cudaGetLastError() after the launch (0 on success), or -1 when
// cudaOccupancyMaxActiveClusters says no cluster of the asked shape can
// be resident.  The float32 forms ignore diag1 and diag2; the fast forms
// (_bf16) take bfloat16 streams, the operators' off-diagonal entries
// alone (bfloat16 values held in float32) and the float32 diagonals
// diag1 (W1's) and diag2 (W2's).  fact_fwd reads neither ad_init, s_init
// nor the frame range; fact_fwd_init writes neither s_ys nor ad_last.
// cluster: 1 (one 1024-thread block a column, smid null), or 2 or 4 CTAs
// a column, each writing its SM's id to smid[CTA] unless smid is null.
#define FACT_FWD_ENTRY(NAME, S, FORM)                                         \
  extern "C" int NAME(                                                        \
      const void* px, const void* lengths, const void* f_dst,                 \
      const void* g_src, const void* w1_ptr, const void* w1_col,              \
      const void* w1_val, const void* w2_ptr, const void* w2_col,             \
      const void* w2_val, const void* diag1, const void* diag2,               \
      const void* ad0, const void* s0, const void* ad_init,                   \
      const void* s_init, const void* leaky, float leaky_c, int B, int T,     \
      int P, int s_pad, int t0, int n_frames, int snap, int ad_rows,          \
      int init_stride, int s_stride, int cluster, void* ad_ys,                \
      void* w1ad_ys, void* xdst_ys, void* xsrc_ys, void* s_ys,                \
      void* ad_last, void* smid, void* stream) {                              \
    return fact_fwd_run<S, FORM>(                                             \
        px, lengths, f_dst, g_src, w1_ptr, w1_col, w1_val, w2_ptr, w2_col,    \
        w2_val, diag1, diag2, ad0, s0, ad_init, s_init, leaky, leaky_c, B, T, \
        P, s_pad, t0, n_frames, snap, ad_rows, init_stride, s_stride,         \
        cluster, ad_ys, w1ad_ys, xdst_ys, xsrc_ys, s_ys, ad_last, smid,       \
        stream);                                                              \
  }

FACT_FWD_ENTRY(fact_fwd_launch, float, FWD_FULL)
FACT_FWD_ENTRY(fact_fwd_bf16_launch, __nv_bfloat16, FWD_FULL)
FACT_FWD_ENTRY(fact_fwd_snap_launch, float, FWD_SNAP)
FACT_FWD_ENTRY(fact_fwd_snap_bf16_launch, __nv_bfloat16, FWD_SNAP)
FACT_FWD_ENTRY(fact_fwd_init_launch, float, FWD_INIT)
FACT_FWD_ENTRY(fact_fwd_init_bf16_launch, __nv_bfloat16, FWD_INIT)
