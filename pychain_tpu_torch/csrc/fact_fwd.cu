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
// CTAs where B C <= the card's SMs: fact_fwd_cluster_kernel below; in
// the fast mode past that, G columns a cluster: fact_fwd_group_kernel)
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
// so that it compiles as it did before the other forms.  The body runs
// column b on the calling block: fact_fwd_kernel below gives it block b,
// the ckpt mode's pair kernel (fact_ckpt.cu) a block of its replay role.
template <typename S, int kForm>
__device__ __forceinline__ void fact_fwd_column(
    const int b,                         // the batch column
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

// Every form, one 1024-thread block a column.
template <typename S, int kForm>
__global__ void __launch_bounds__(FACT_THREADS, 1) fact_fwd_kernel(
    const float* __restrict__ px, const int* __restrict__ lengths,
    const int* __restrict__ f_dst, const int* __restrict__ g_src,
    const int* __restrict__ w1_ptr, const int* __restrict__ w1_col,
    const float* __restrict__ w1_val, const int* __restrict__ w2_ptr,
    const int* __restrict__ w2_col, const float* __restrict__ w2_val,
    const float* __restrict__ diag1, const float* __restrict__ diag2,
    const float* __restrict__ ad0, const float* __restrict__ s0,
    const S* __restrict__ ad_init, const float* __restrict__ s_init,
    const float* __restrict__ leaky, float leaky_c, int T, int P, int s_pad,
    int t0_arg, int n_arg, int snap_arg, int rows_arg, int init_stride,
    int s_stride, S* __restrict__ ad_ys, S* __restrict__ w1ad_ys,
    S* __restrict__ xdst_ys, S* __restrict__ xsrc_ys,
    float* __restrict__ s_ys, float* __restrict__ ad_last) {
  fact_fwd_column<S, kForm>(
      blockIdx.x, px, lengths, f_dst, g_src, w1_ptr, w1_col, w1_val, w2_ptr,
      w2_col, w2_val, diag1, diag2, ad0, s0, ad_init, s_init, leaky, leaky_c,
      T, P, s_pad, t0_arg, n_arg, snap_arg, rows_arg, init_stride, s_stride,
      ad_ys, w1ad_ys, xdst_ys, xsrc_ys, s_ys, ad_last);
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

// fact_fwd_bf16 (the full mode, bfloat16 tiles) as a group of G columns
// (G = 1, 2 or 4) on a cluster of C CTAs (C = 2 or 4)
// (fact_kernels.group_size): G = 1 where B C CTAs fit the card's SMs (B
// <= 66 on an H100 at C = 2, where the cluster form reads its rows of W1
// and W2 from L2 at every frame), G = 2 past that.  CTA r of cluster q
// serves columns q G .. q G + G - 1 on its rows (cluster_row, as
// fact_fwd_cluster_kernel).
//
// Why.  The one-block kernel reads each slot's column id and value from
// device memory once per column per frame: at the headline graph W1's
// and W2's slots are 0.45 MB, more than an SM's L1 holds beside the
// kernel's shared memory, so every block reads them from L2 every frame
// (28 GB a sweep at B = 128, T = 500).  Here a CTA loads its rows' slots
// of W1 and W2 into shared memory once, at the launch, packed 4 bytes a
// slot (group_load_ops), and one load of a slot feeds the G columns'
// products (group_row_dot): no frame reads the operator from device
// memory.
//
// A frame (the cluster form's async exchange, one row's G columns a
// thread):
//
//   own rows' products in the G columns (their W1 alpha' stream rows) ->
//   alpha(t) -> the virtual warps' totals of the G columns to every CTA
//   (cluster_post_async) -> own rows' emissions of frame t + 1 (their
//   x_dst and x_src stream rows) -> wait -> the cross-warp trees: s_t of
//   each column, the same bits in every CTA -> own rows' carry alpha'(t +
//   1) and u(t + 1) to every CTA, packed (warp_put_words_async) -> own
//   rows' alpha' stream rows and alpha'(T_b) -> wait.
//
// At G = 1 alpha' and u keep a word a state (packed_words in
// fact_common.cuh: the bfloat16 value's float32 bits, so the host's bank
// order still spreads a slot's gathers over the banks), and the loop is
// the G = 2 form's with one column.
//
// Each column runs to its own length: its stream rows, s_t and alpha'(T_b)
// are written for its frames alone, and a column past its end (or past B,
// whose px is never read) goes on with values no other column reads.
// Every sum of a column is taken in the one-block kernel's order (each
// row's slots in the host's order, then the diagonal; the virtual
// threads' rows, the warp trees, the cross-warp tree), each product and
// sum rounded where it rounds, so the results are that kernel's bit for
// bit, and the plain fast version's.
//
// Shared memory: alpha' and u whole, packed (2 S_pad packed_words words); the
// carry, x_dst and (outside identity mode) x_src on own rows (float32,
// G a row); the totals' scratch, two mbarriers, the local slice pointers
// of W1 and W2 and their slots (op_words: the most any CTA holds), at
// least LEAN_CLUSTER_MIN_SMEM bytes (fact_fwd_group_smem_bytes).
template <int G>
__global__ void __launch_bounds__(FACT_THREADS, 1) fact_fwd_group_kernel(
    const float* __restrict__ px,        // (B, T, P) exp'd nnet output
    const int* __restrict__ lengths,     // (B,)  1 <= T_b <= T
    const int* __restrict__ f_dst,       // (S_pad,)
    const int* __restrict__ g_src,       // (S_pad,) or null (identity mode)
    const int* __restrict__ w1_ptr,      // W1's slice pointers
    const unsigned* __restrict__ w1_pack,   // W1's packed slots
    const int* __restrict__ w2_ptr, const unsigned* __restrict__ w2_pack,
    const float* __restrict__ diag1,     // (S_pad,) W1's diagonal
    const float* __restrict__ diag2,     // (S_pad,) W2's diagonal
    const float* __restrict__ ad0,       // (S_pad,) alpha'(0)
    const float* __restrict__ s0,        // (1,)
    const float* __restrict__ leaky,     // (S_pad,)
    float leaky_c, int B, int T, int P, int s_pad,
    __nv_bfloat16* __restrict__ ad_ys,   // (B, T, S_pad) alpha'(t+1)
    __nv_bfloat16* __restrict__ w1ad_ys, // (B, T, S_pad) W1 alpha'(t)
    __nv_bfloat16* __restrict__ xdst_ys, // (B, T, S_pad)
    __nv_bfloat16* __restrict__ xsrc_ys, // (B, T, S_pad) or null
    float* __restrict__ s_ys,            // (B, T) s_{t+1}; 1 past the end
    float* __restrict__ ad_last,         // (B, S_pad) alpha'(T_b)
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
  extern __shared__ float smem[];
  unsigned* ad = reinterpret_cast<unsigned*>(smem);   // alpha', whole
  unsigned* u = ad + s_pad * W;                       // x_src * alpha'
  float* a = reinterpret_cast<float*>(u + s_pad * W); // carry, own rows
  // px's entries at f_dst and (outside identity mode) g_src of own rows,
  // unrounded, two buffers by frame parity: frame t + 1's land (cp.async)
  // while frame t's products read frame t's
  float* xd0 = a + own_max * G;
  float* xs0 = g_src ? xd0 + 2 * own_max * G : xd0;
  float* red = xs0 + 2 * own_max * G;    // the totals
  unsigned long long* xbar =             // the totals' and the carry's
      reinterpret_cast<unsigned long long*>(red + group_red_words(G));
  int* lp1 = reinterpret_cast<int*>(xbar + 2);
  int* lp2 = lp1 + group_lp_words(s_pad, C);
  unsigned* ops1 = reinterpret_cast<unsigned*>(lp2 + group_lp_words(s_pad, C));

  const int tid = threadIdx.x;
  const int b0 = (static_cast<int>(blockIdx.x) >> lc) * G;
  if (smid && tid == 0) smid[blockIdx.x] = sm_id();
  int Tb[G];
  int t_end = 0;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    Tb[g] = b0 + g < B ? lengths[b0 + g] : 0;
    t_end = max(t_end, Tb[g]);
  }

  group_load_ops(w1_ptr, w1_pack, s_pad, rank, C, lp1, ops1);
  __syncthreads();   // lp1
  unsigned* ops2 = ops1 + lp1[own >> 5] * 32;
  group_load_ops(w2_ptr, w2_pack, s_pad, rank, C, lp2, ops2);

  // issue the copies of own rows' px entries of frame t of each column in
  // its frames into frame t's buffers (they land by cp_async_wait_all)
  auto gather = [&](int t) {
    float* xd = xd0 + (t & 1) * own_max * G;
    float* xs = xs0 + (t & 1) * own_max * G;
    for (int k = tid; k < own * G; k += FACT_THREADS) {
      const int g = k % G;
      if (t >= Tb[g]) continue;
      const int s = cluster_row(k / G, rank, C);
      const float* px_t = px + (static_cast<size_t>(b0 + g) * T + t) * P;
      cp_async4(xd + k, px_t + __ldg(f_dst + s));
      if (g_src) cp_async4(xs + k, px_t + __ldg(g_src + s));
    }
  };

  // alpha'(0), the same in every column; the emissions of frame 0 (0 in a
  // column with no frame)
  for (int s = tid; s < s_pad; s += FACT_THREADS) {
    const float v = round_to<S>(ad0[s]);
    float x[G];
#pragma unroll
    for (int g = 0; g < G; ++g) x[g] = v;
    unsigned w[W];
    pack_cols<G>(x, w);
#pragma unroll
    for (int j = 0; j < W; ++j) ad[s * W + j] = w[j];
  }
  for (int i = tid; i < 2 * own_max * G; i += FACT_THREADS) {
    if (i < own_max * G)
      a[i] = i < own * G ? ad0[cluster_row(i / G, rank, C)] : 0.0f;
    xd0[i] = xs0[i] = 0.0f;
  }
  __syncthreads();
  gather(0);
  cp_async_wait_all();
  __syncthreads();
  if (tid == 0) {
    mbar_init(xbar, 1);
    mbar_init(xbar + 1, 1);
  }
  cluster_barrier();   // every CTA has started: peers may be written
  // own rows' u(0) to every CTA (DSMEM stores before a cluster barrier)
  for (int i = tid; i < own; i += FACT_THREADS) {
    const int d = cluster_row(i, rank, C);
    float x[G];
#pragma unroll
    for (int g = 0; g < G; ++g)
      x[g] = round_to<S>(round_to<S>(xs0[i * G + g]) * a[i * G + g]);
    unsigned w[W];
    pack_cols<G>(x, w);
#pragma unroll
    for (int j = 0; j < W; ++j)
      for (int q = 0; q < C; ++q)
        *cg::this_cluster().map_shared_rank(u + d * W + j, q) = w[j];
  }
  cluster_barrier();

  // the bytes a CTA's peers send it in the totals' exchange ((32 / C)
  // warp totals of G sums from each) and the carry's (their rows of ad
  // and u); the exchanges' order is the cluster form's (fact_fwd_cluster_
  // kernel), so the phases of an mbarrier never overlap
  const unsigned warp_bytes = (C - 1) * (32u >> lc) * 4u * G;
  const unsigned carry_bytes = static_cast<unsigned>(s_pad - own) * 8u * W;
  float s_prev[G];
#pragma unroll
  for (int g = 0; g < G; ++g) s_prev[g] = *s0;

  for (int t = 0; t < t_end; ++t) {
    const unsigned parity = t & 1;
    if (tid == 0) {
      mbar_expect_tx(xbar, warp_bytes);
      if (t + 1 < t_end) mbar_expect_tx(xbar + 1, carry_bytes);
    }
    // frame t + 1's emissions, into the other buffers
    if (t + 1 < t_end) gather(t + 1);
    float r[G];
#pragma unroll
    for (int g = 0; g < G; ++g) r[g] = 1.0f / s_prev[g];
    const float* xd = xd0 + (t & 1) * own_max * G;        // frame t's
    const float* xs = xs0 + (t & 1) * own_max * G;
    const float* xs_next = xs0 + (~t & 1) * own_max * G;
    for (int i = tid; i < own; i += FACT_THREADS) {
      const int d = cluster_row(i, rank, C);
      float w1a[G], w2u[G];
      group_row_dot<G>(ops1, lp1, i, ad, w1a);
      group_row_dot<G>(ops2, lp2, i, u, w2u);
      const float dg1 = __ldg(diag1 + d), dg2 = __ldg(diag2 + d);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        // the one-block kernel's arithmetic, rounded where it rounds
        const int k = i * G + g;
        const float x = round_to<S>(xd[k]);
        const float xsv = g_src ? round_to<S>(xs[k]) : x;
        const float own_a = a[k];
        const float v1 = __fadd_rn(w1a[g], __fmul_rn(dg1, own_a));
        const float v2 = __fadd_rn(w2u[g], __fmul_rn(dg2,
                                                     __fmul_rn(xsv, own_a)));
        a[k] = __fmul_rn(__fadd_rn(__fmul_rn(x, v1), v2), r[g]);
        if (t < Tb[g]) {
          const size_t o =
              (static_cast<size_t>(b0 + g) * T + t) * s_pad + d;
          stream_put(w1ad_ys + o, v1);
          stream_put(xdst_ys + o, x);
          if (g_src) stream_put(xsrc_ys + o, xsv);
        }
      }
    }
    // each virtual thread adds its rows in turn
    __syncthreads();
    float part[G];
#pragma unroll
    for (int g = 0; g < G; ++g) part[g] = 0.0f;
    if (tid < V)
      for (int i = tid; i < own; i += V)
#pragma unroll
        for (int g = 0; g < G; ++g) part[g] += a[i * G + g];
    cluster_post_async<G>(part, red, V, rank, lc, xbar);
    cp_async_wait_all();   // frame t + 1's emissions
    __syncthreads();       // this CTA's totals, and the emissions
    mbar_wait_cluster(xbar, parity);
    cluster_warp_total_all<G>(part, red);
    float cs[G];
#pragma unroll
    for (int g = 0; g < G; ++g) cs[g] = leaky_c * part[g];
    for (int i = tid; i < own; i += FACT_THREADS) {
      const int d = cluster_row(i, rank, C);
      const float lk = leaky[d];
      float vr[G], ur[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float v = __fadd_rn(a[i * G + g], __fmul_rn(cs[g], lk));
        a[i * G + g] = v;
        vr[g] = round_to<S>(v);
        ur[g] = round_to<S>(round_to<S>(xs_next[i * G + g]) * v);
        if (t < Tb[g]) {
          const size_t row = static_cast<size_t>(b0 + g) * T + t;
          stream_put(ad_ys + row * s_pad + d, v);
          if (t == Tb[g] - 1)
            ad_last[static_cast<size_t>(b0 + g) * s_pad + d] = v;
        }
      }
      if (t + 1 < t_end) {
        unsigned w[W];
        pack_cols<G>(vr, w);
        warp_put_words_async<W>(ad + (d & ~31) * W, w, rank, C, xbar + 1);
        pack_cols<G>(ur, w);
        warp_put_words_async<W>(u + (d & ~31) * W, w, rank, C, xbar + 1);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (rank == 0 && tid == 0 && t < Tb[g])
        s_ys[static_cast<size_t>(b0 + g) * T + t] = part[g];
      s_prev[g] = part[g];
    }
    if (t + 1 < t_end) {
      __syncthreads();   // this CTA's rows of the carry
      mbar_wait_cluster(xbar + 1, parity);
    }
  }
  if (rank == 0)
    for (int g = 0; g < G; ++g)
      if (b0 + g < B)
        for (int t = Tb[g] + tid; t < T; t += FACT_THREADS)
          s_ys[static_cast<size_t>(b0 + g) * T + t] = 1.0f;
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

// fact_ckpt.cu includes this file for fact_fwd_column and the request
// above alone.
#ifndef FACT_COLUMNS_ONLY

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

// The group form's request: alpha' and u whole, packed (S_pad
// packed_words words each); the carry, and
// px's entries at f_dst and (outside identity mode) g_src in two buffers,
// on rank 0's rows (the most a CTA owns), G floats a row; the totals'
// scratch, two mbarriers, two sets of local slice pointers and op_words
// words of slots (the most any CTA of the cluster holds of W1 and W2
// together); at least LEAN_CLUSTER_MIN_SMEM (one CTA an SM).
extern "C" size_t fact_fwd_group_smem_bytes(int s_pad, int identity, int G,
                                            int C, int op_words) {
  const size_t own_max = 32 * ((s_pad / 32 + C - 1) / C);
  const size_t words = 2 * static_cast<size_t>(s_pad) * packed_words(G) +
                       (identity ? 3 : 5) * own_max * G + group_red_words(G) +
                       4 + 2 * group_lp_words(s_pad, C) + op_words;
  const size_t need = words * sizeof(float);
  return need > LEAN_CLUSTER_MIN_SMEM ? need : LEAN_CLUSTER_MIN_SMEM;
}

template <int G>
static int fact_fwd_group_run(
    const void* px, const void* lengths, const void* f_dst, const void* g_src,
    const void* w1_ptr, const void* w1_pack, const void* w2_ptr,
    const void* w2_pack, const void* diag1, const void* diag2,
    const void* ad0, const void* s0, const void* leaky, float leaky_c, int B,
    int T, int P, int s_pad, int C, int op_words, void* ad_ys, void* w1ad_ys,
    void* xdst_ys, void* xsrc_ys, void* s_ys, void* ad_last, void* smid,
    void* stream) {
  auto kernel = fact_fwd_group_kernel<G>;
  const size_t smem =
      fact_fwd_group_smem_bytes(s_pad, g_src == nullptr, G, C, op_words);
  const int active = group_active_clusters(kernel, smem, C);
  if (active < 0) return -active;
  if (active < 1) return -1;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cluster_config((B + G - 1) / G, C, smem, stream, attr);
  cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const float*>(px),
      static_cast<const int*>(lengths), static_cast<const int*>(f_dst),
      static_cast<const int*>(g_src), static_cast<const int*>(w1_ptr),
      static_cast<const unsigned*>(w1_pack), static_cast<const int*>(w2_ptr),
      static_cast<const unsigned*>(w2_pack), static_cast<const float*>(diag1),
      static_cast<const float*>(diag2), static_cast<const float*>(ad0),
      static_cast<const float*>(s0), static_cast<const float*>(leaky),
      leaky_c, B, T, P, s_pad, static_cast<__nv_bfloat16*>(ad_ys),
      static_cast<__nv_bfloat16*>(w1ad_ys),
      static_cast<__nv_bfloat16*>(xdst_ys),
      static_cast<__nv_bfloat16*>(xsrc_ys), static_cast<float*>(s_ys),
      static_cast<float*>(ad_last), static_cast<int*>(smid));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The clusters of the group form at (G, C) that the card holds at once
// for this graph (cudaOccupancyMaxActiveClusters), or minus the CUDA error
// (cudaErrorInvalidValue for a (G, C) that is not built).
extern "C" int fact_fwd_group_active_clusters(int s_pad, int identity, int G,
                                              int C, int op_words) {
  if (C != 2 && C != 4) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      fact_fwd_group_smem_bytes(s_pad, identity, G, C, op_words);
  if (G == 1) return group_active_clusters(fact_fwd_group_kernel<1>, smem, C);
  if (G == 2) return group_active_clusters(fact_fwd_group_kernel<2>, smem, C);
  if (G == 4) return group_active_clusters(fact_fwd_group_kernel<4>, smem, C);
  return -static_cast<int>(cudaErrorInvalidValue);
}

// fact_fwd_bf16's group form (counted as fact_fwd_bf16): G columns (1, 2
// or 4) a cluster of C CTAs (2 or 4), ceil(B / G) clusters; w1_pack / w2_pack
// the packed slots of the operators whose slice pointers are w1_ptr /
// w2_ptr (B1's bank order); op_words as fact_fwd_group_smem_bytes; smid
// (ceil(B / G) C,) or null.  Returns as the other entry points, and
// cudaErrorInvalidValue for a (G, C) that is not built.
extern "C" int fact_fwd_group_launch(
    const void* px, const void* lengths, const void* f_dst, const void* g_src,
    const void* w1_ptr, const void* w1_pack, const void* w2_ptr,
    const void* w2_pack, const void* diag1, const void* diag2,
    const void* ad0, const void* s0, const void* leaky, float leaky_c, int B,
    int T, int P, int s_pad, int G, int C, int op_words, void* ad_ys,
    void* w1ad_ys, void* xdst_ys, void* xsrc_ys, void* s_ys, void* ad_last,
    void* smid, void* stream) {
  if (C != 2 && C != 4) return static_cast<int>(cudaErrorInvalidValue);
  // G = 1 runs at C = 2 alone, as fact_bwd's
  if (G == 1 && C != 2) return static_cast<int>(cudaErrorInvalidValue);
#define FACT_FWD_GROUP(GG)                                                    \
  if (G == GG)                                                                \
    return fact_fwd_group_run<GG>(px, lengths, f_dst, g_src, w1_ptr,          \
                                  w1_pack, w2_ptr, w2_pack, diag1, diag2,     \
                                  ad0, s0, leaky, leaky_c, B, T, P, s_pad, C, \
                                  op_words, ad_ys, w1ad_ys, xdst_ys, xsrc_ys, \
                                  s_ys, ad_last, smid, stream);
  FACT_FWD_GROUP(1)
  FACT_FWD_GROUP(2)
  FACT_FWD_GROUP(4)
#undef FACT_FWD_GROUP
  return static_cast<int>(cudaErrorInvalidValue);
}

#endif  // FACT_COLUMNS_ONLY
