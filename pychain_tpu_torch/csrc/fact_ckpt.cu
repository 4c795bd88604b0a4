// The ckpt stream mode's chunk scan, paired: one launch runs chunk k's
// backward and chunk k - 1's replay side by side.
//
// Replaces the order of pychain_tpu/ops/pallas_fact.py's chunk scan
// (_forward_backward_ckpt, :936-1000), which from the last chunk down
// replays a chunk's forward from the snapshot below it (_fwd_pallas with
// ext_init: fact_fwd_init here) and then runs its backward from the beta'
// carry above (_bwd_pallas with ext_init and chunked: fact_bwd_chunk).
// Those are the two TPU kernels of this file, pallas_fact.py:457 and :768
// as the scan launches them; their bodies are fact_fwd.cu's and
// fact_bwd.cu's (fact_fwd_column<S, FWD_INIT>, fact_bwd_column<S,
// BWD_CHUNK>), which fact_fwd_init and fact_bwd_chunk also launch.
//
// Why.  On a TPU's one core the scan's order costs nothing.  On an H100
// each form runs one 1024-thread block a column, one block an SM, so at
// B <= 66 one launch fills B of the 132 SMs (the replay 2 B on its cluster
// form) and the two forms of a chunk run one after the other: at main path
// 7 (B = 64, T = 3,700, 58 chunks of 64 frames) 29.2 ms of replays and
// 37.1 ms of backwards a call (PERF.md).  Only the backwards form a chain
// (the beta' carry); chunk k - 1's replay reads nothing that chunk k's
// backward writes (its snapshot comes from the snapshot sweep), so the
// two can share a grid.
//
// Design.  A grid of n_bwd + n_fwd blocks of FACT_THREADS threads: block
// i < n_bwd runs column i of the backward role (chunk k), block
// n_bwd <= i runs column i - n_bwd of the replay role (chunk k - 1).  At
// 2 B <= the card's SMs every block has an SM to itself (one block an SM:
// __launch_bounds__(FACT_THREADS, 1)), so a launch takes about the slower
// role's time, each SM doing the per-block work it did alone.  The roles
// share nothing but the launch: each lays out the dynamic shared memory
// from its start (the request is the larger of the two), a role's
// barriers and its early return stay in its own block, and no flag
// crosses roles.  The host (fact_kernels._ckpt) keeps two sets of one
// chunk's streams, chunk k in set k mod 2: a launch's replay writes the
// set that its backward does not read, and the next launch's backward
// reads it.  The first launch is the last chunk's replay alone
// (n_bwd = 0), the last chunk 0's backward alone (n_fwd = 0): T / C + 1
// launches where the unpaired scan makes 2 T / C.  Each column runs the
// same code on the same inputs in the same order as the unpaired scan, so
// the results are its bits.  The fast chunk role reads W1^T and W2^T as
// packed 4-byte words (sell_row_dot_words: half the L2 bytes of a
// column id and a float value, the same products), the one change to a
// role's code.
//
// Bound: the two forms' bytes together (px and the snapshots read, the
// chunk streams written and read back, gamma written), at main path 7
// 4.36 ms at 3.35 TB/s; the products, 2 x 2 x 49.5k arcs x B x T, are
// 0.7 ms of float32 operations.  What binds each SM is what bound the
// roles alone: the sparse products' reads of the operators from L2.  At
// main path 7 fast a call took 37.5 ms against 29.5 + 37.3 unpaired;
// the packed words took the chunk role from 40.3 to 34.7 ms in the grid,
// and the replay role, 36.7 ms in the grid against 33.8 alone, now sets
// the pace (PERF.md, kernel_ablation.py --only ckpt_pair).

#define FACT_COLUMNS_ONLY
#include "fact_fwd.cu"
#include "fact_bwd.cu"

// 1: the fast chunk role reads W1^T and W2^T as packed 4-byte words
// (sell_row_dot_words; the host passes fact_kernels.pack_slots' words as
// the column ids); 0: as column ids and float values, as fact_bwd_chunk
// does (kernel_ablation.py times both).
#define FACT_PAIR_WORDS 1

// The replay role's arguments (fact_fwd_init's, fact_fwd_column's
// parameters).
template <typename S>
struct ReplayArgs {
  const float* px;
  const int* lengths;
  const int* f_dst;
  const int* g_src;
  const int* w1_ptr;
  const int* w1_col;
  const float* w1_val;
  const int* w2_ptr;
  const int* w2_col;
  const float* w2_val;
  const float* diag1;
  const float* diag2;
  const float* ad0;
  const float* s0;
  const S* ad_init;
  const float* s_init;
  const float* leaky;
  float leaky_c;
  int T, P, s_pad, t0, n_frames, init_stride, s_stride;
  S* ad_ys;
  S* w1ad_ys;
  S* xdst_ys;
  S* xsrc_ys;
};

// The backward role's arguments (fact_bwd_chunk's, fact_bwd_column's
// parameters without the lean mode's).
template <typename S>
struct ChunkArgs {
  const int* lengths;
  const S* ad_ys;
  const S* w1ad_ys;
  const S* xdst_ys;
  const S* xsrc_ys;
  const float* s_ys;
  const float* s0;
  const float* ad0;
  const S* ad_init;
  const float* final_p;
  const float* tot;
  const float* leaky;
  const int* w1t_ptr;
  const int* w1t_col;
  const float* w1t_val;
  const int* w2t_ptr;
  const int* w2t_col;
  const float* w2t_val;
  const float* diag1;
  const float* diag2;
  const int* f_ptr;
  const int* f_states;
  const int* g_ptr;
  const int* g_states;
  int n_pdf_lists;
  float leaky_c;
  int T, P, s_pad, debug, stages, t0, n_frames, init_stride;
  float* gamma;
  float* ab;
  float* gs;
  float* bd_io;
  float* leak_io;
};

template <typename S>
__global__ void __launch_bounds__(FACT_THREADS, 1) fact_ckpt_pair_kernel(
    const ChunkArgs<S> c, const ReplayArgs<S> r, int n_bwd, int* smid) {
  if (smid && threadIdx.x == 0) smid[blockIdx.x] = sm_id();
  const int i = blockIdx.x;
  if (i < n_bwd) {
    fact_bwd_column<S, BWD_CHUNK, FACT_PAIR_WORDS && sizeof(S) == 2>(
        i, c.lengths, c.ad_ys, c.w1ad_ys, c.xdst_ys, c.xsrc_ys, nullptr,
        c.s_ys, c.s0, c.ad0, c.ad_init, c.final_p, c.tot, c.leaky,
        c.w1t_ptr, c.w1t_col, c.w1t_val, c.w2t_ptr, c.w2t_col, c.w2t_val,
        nullptr, nullptr, nullptr, nullptr, nullptr, c.diag1, c.diag2,
        c.f_ptr, c.f_states, c.g_ptr, c.g_states, c.n_pdf_lists, c.leaky_c,
        c.T, c.P, c.s_pad, c.debug, c.stages, c.t0, c.n_frames, c.n_frames,
        c.init_stride, c.gamma, c.ab, c.gs, c.bd_io, c.leak_io);
  } else {
    fact_fwd_column<S, FWD_INIT>(
        i - n_bwd, r.px, r.lengths, r.f_dst, r.g_src, r.w1_ptr, r.w1_col,
        r.w1_val, r.w2_ptr, r.w2_col, r.w2_val, r.diag1, r.diag2, r.ad0,
        r.s0, r.ad_init, r.s_init, r.leaky, r.leaky_c, r.T, r.P, r.s_pad,
        r.t0, r.n_frames, 1, r.n_frames, r.init_stride, r.s_stride, r.ad_ys,
        r.w1ad_ys, r.xdst_ys, r.xsrc_ys, nullptr, nullptr);
  }
}

// The pair's request: the larger of the two roles' (fact_fwd_smem_bytes,
// fact_bwd_smem_bytes at the backward's ring depth).
extern "C" size_t fact_ckpt_pair_smem_bytes(int s_pad, int identity,
                                            int stages, int fast) {
  const size_t f = fact_fwd_smem_bytes(s_pad, identity, fast);
  const size_t b = fact_bwd_smem_bytes(s_pad, identity, stages, fast, 0);
  return f > b ? f : b;
}

template <typename S>
static int fact_ckpt_pair_run(const ReplayArgs<S>& r, int n_fwd,
                              const ChunkArgs<S>& c, int n_bwd, int identity,
                              int* smid, void* stream) {
  if (n_fwd < 0 || n_bwd < 0 || n_fwd + n_bwd < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fact_ckpt_pair_smem_bytes(
      n_fwd ? r.s_pad : c.s_pad, identity, n_bwd ? c.stages : 0,
      sizeof(S) == 2);
  cudaError_t err = fact_set_smem(fact_ckpt_pair_kernel<S>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fact_ckpt_pair_kernel<S><<<n_bwd + n_fwd, FACT_THREADS, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      c, r, n_bwd, smid);
  return static_cast<int>(cudaGetLastError());
}

// Each entry point takes fact_fwd_init_launch's arguments from px to
// ad_last (the replay role, its B the role's columns: 0 for none), then
// fact_bwd_chunk_launch's from lengths to leak_io (the backward role, B
// likewise), then smid ((n_bwd + n_fwd,) int32: each block's SM) or null
// and the stream.  Both roles run one block a column (cluster 1), snap 1
// and ad_rows = n_frames; the roles' s_ys / ad_last of the replay and px
// / w1 / f_dst / g_src of the backward are not read.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for arguments the pair does not take.
#define FACT_CKPT_PAIR_ENTRY(NAME, S)                                         \
  extern "C" int NAME(                                                        \
      const void* px, const void* lengths, const void* f_dst,                 \
      const void* g_src, const void* w1_ptr, const void* w1_col,              \
      const void* w1_val, const void* w2_ptr, const void* w2_col,             \
      const void* w2_val, const void* diag1, const void* diag2,               \
      const void* ad0, const void* s0, const void* ad_init,                   \
      const void* s_init, const void* leaky, float leaky_c, int B, int T,     \
      int P, int s_pad, int t0, int n_frames, int snap, int ad_rows,          \
      int init_stride, int s_stride, int cluster, void* ad_ys,                \
      void* w1ad_ys, void* xdst_ys, void* xsrc_ys, void* s_ys_f,             \
      void* ad_last, const void* b_lengths, const void* b_ad_ys,              \
      const void* b_w1ad_ys, const void* b_xdst_ys, const void* b_xsrc_ys,    \
      const void* b_px, const void* s_ys, const void* b_s0,                   \
      const void* b_ad0, const void* b_ad_init, const void* final_p,          \
      const void* tot, const void* b_leaky, const void* w1t_ptr,              \
      const void* w1t_col, const void* w1t_val, const void* w2t_ptr,          \
      const void* w2t_col, const void* w2t_val, const void* b_w1_ptr,         \
      const void* b_w1_col, const void* b_w1_val, const void* b_f_dst,        \
      const void* b_g_src, const void* b_diag1, const void* b_diag2,          \
      const void* f_ptr, const void* f_states, const void* g_ptr,             \
      const void* g_states, int n_pdf_lists, float b_leaky_c, int b_B,        \
      int b_T, int b_P, int b_s_pad, int debug, int stages, int b_t0,         \
      int b_n_frames, int b_ad_rows, int b_init_stride, int b_cluster,        \
      void* gamma, void* ab, void* gs, void* bd_io, void* leak_io,            \
      void* smid, void* stream) {                                             \
    if ((B && (cluster != 1 || snap != 1 || ad_rows != n_frames)) ||          \
        (b_B && (b_cluster != 1 || b_ad_rows != b_n_frames)))                 \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    const ReplayArgs<S> r{                                                    \
        static_cast<const float*>(px), static_cast<const int*>(lengths),      \
        static_cast<const int*>(f_dst), static_cast<const int*>(g_src),       \
        static_cast<const int*>(w1_ptr), static_cast<const int*>(w1_col),     \
        static_cast<const float*>(w1_val), static_cast<const int*>(w2_ptr),   \
        static_cast<const int*>(w2_col), static_cast<const float*>(w2_val),   \
        static_cast<const float*>(diag1), static_cast<const float*>(diag2),   \
        static_cast<const float*>(ad0), static_cast<const float*>(s0),        \
        static_cast<const S*>(ad_init), static_cast<const float*>(s_init),    \
        static_cast<const float*>(leaky), leaky_c, T, P, s_pad, t0,           \
        n_frames, init_stride, s_stride, static_cast<S*>(ad_ys),              \
        static_cast<S*>(w1ad_ys), static_cast<S*>(xdst_ys),                   \
        static_cast<S*>(xsrc_ys)};                                            \
    const ChunkArgs<S> c{                                                     \
        static_cast<const int*>(b_lengths), static_cast<const S*>(b_ad_ys),   \
        static_cast<const S*>(b_w1ad_ys), static_cast<const S*>(b_xdst_ys),   \
        static_cast<const S*>(b_xsrc_ys), static_cast<const float*>(s_ys),    \
        static_cast<const float*>(b_s0), static_cast<const float*>(b_ad0),    \
        static_cast<const S*>(b_ad_init),                                     \
        static_cast<const float*>(final_p), static_cast<const float*>(tot),   \
        static_cast<const float*>(b_leaky),                                   \
        static_cast<const int*>(w1t_ptr), static_cast<const int*>(w1t_col),   \
        static_cast<const float*>(w1t_val),                                   \
        static_cast<const int*>(w2t_ptr), static_cast<const int*>(w2t_col),   \
        static_cast<const float*>(w2t_val),                                   \
        static_cast<const float*>(b_diag1),                                   \
        static_cast<const float*>(b_diag2), static_cast<const int*>(f_ptr),   \
        static_cast<const int*>(f_states), static_cast<const int*>(g_ptr),    \
        static_cast<const int*>(g_states), n_pdf_lists, b_leaky_c, b_T, b_P,  \
        b_s_pad, debug, stages, b_t0, b_n_frames, b_init_stride,              \
        static_cast<float*>(gamma), static_cast<float*>(ab),                  \
        static_cast<float*>(gs), static_cast<float*>(bd_io),                  \
        static_cast<float*>(leak_io)};                                        \
    const int identity = B ? g_src == nullptr : b_xsrc_ys == nullptr;         \
    return fact_ckpt_pair_run<S>(r, B, c, b_B, identity,                      \
                                 static_cast<int*>(smid), stream);            \
  }

FACT_CKPT_PAIR_ENTRY(fact_ckpt_pair_launch, float)
FACT_CKPT_PAIR_ENTRY(fact_ckpt_pair_bf16_launch, __nv_bfloat16)
