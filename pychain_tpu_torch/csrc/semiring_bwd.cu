// Log-semiring beta sweep, arc occupancies and gamma of a batch of
// arbitrary graphs.
//
// Replaces the three TPU backward kernels that compute this recurrence:
// pychain_tpu/ops/pallas_semiring.py::_bwd_kernel (B6, dense one-hots),
// pychain_tpu/ops/semiring_xl.py::_bwd_kernel (B8, resident masks) and
// ::_bwd_kernel_stream (B10, masks per arc chunk), and the gamma
// contraction the JAX wrappers run after them (_gamma_from_occ,
// gamma_chunked).  Per frame u from T_b - 1 down to 0 of sequence b
// (pallas_semiring.py:149-188; beta r is normalised to max 1 and its log
// scale carried in m):
//
//   r_eff = rf at u = T_b - 1 (the final-frame injection), else r;
//   m_eff likewise mf, else m
//   vf[k] = warc[b, u, k] * r_eff[dst[k]]
//   b[s]  = sum_{k in out(s)} vf[k]
//   occ[k] = exp(min(log alpha_u[src[k]] + log vf[k] + m_eff + c_row[u], 80))
//   alpha_beta[u] = sum_k occ[k]                          (B8's form)
//   gamma[b, u, p] = sum_{k in arcs(p)} occ[k]
//   r = b / max(max_s b, TINY);  m = m_eff + cms[u] + log(max(max_s b, TINY))
//
// alpha_u is alpha(u): n0 at u = 0, else row u - 1 of the forward's
// stream (a row the forward wrote, since u - 1 < T_b - 1).  Frames u >= T_b
// get exact zeros without reading any stream row; pdfs no arc emits get
// exact zeros.  A dead sequence arrives with rf = 0 and keeps zeros.
//
// Precision.  As in semiring_fwd.cu the carries (r, b, m) and the
// occupancies are double, with float weights in and float gamma and
// trace out: in float32 the TPU form loses whole frames of gamma on long
// sequences, where alpha and beta each sit far below their own scale on
// the posterior's states and their product underflows
// (tests/test_torch_semiring.py,
// test_long_flat_start_keeps_every_frame_of_gamma), and the log scale m
// drifts.  occ is assembled in log space, as the JAX package's XLA engine
// does (semiring.py:222-225), so no range limit is left on the product;
// in exact arithmetic it is the TPU kernels' number.
//
// Design.  One block per sequence (an SM each at B = 128), sized to the
// graph: the multiple of 32 threads that covers S_pad and K_pad, at most
// 1024 (semiring_kernels.plan).  A frame is a chain of latencies, and the
// design shortens it (PERF.md).  Frame j = T_b - 1 - u:
// - state pass, thread tid owning the states
//   s = blockDim.x - 1 - tid + i * blockDim.x (from the top, while the arc
//   pass and its extra arcs start at thread 0):
//   b[s] summed over s's out-list (arcs by source, ascending) into a
//   parity buffer; normalisation moves to the reader, which gathers
//   b_prev[dst] * inv_prev (the parent's r[dst], bit for bit); and, one
//   frame ahead, log alpha_{u-1}[s] into a parity buffer (log alpha taken
//   once a state, off the next frame's path);
// - arc pass, a thread an out-list slot: vf again (the same product),
//   then occ from log alpha[src], log vf and the scale, so the log and
//   exp of every arc run in parallel, not one after another per state;
// - each warp posts its partial trace and max into a parity slot; after
//   the frame's single __syncthreads every warp reduces the slots itself
//   (warp_sum_all / warp_max_all, in warp order): every thread holds the
//   same max, inv and m, with no second barrier and no normalising pass;
// - the gamma stage runs a frame late, from the top thread down too,
//   over the compact pdf list (only
//   the pdfs the graph emits, ascending, each with its arcs ascending:
//   semiring_kernels.kernel_lists), from the occupancies' parity buffer.
// Options, picked by the host from the shapes (semiring_kernels.plan):
// - RESIDENT: the out-lists (arc ids, and src << 16 | dst a slot) and the
//   compact pdf list live in shared memory for the whole sweep, so no id
//   is read from device memory inside the frame loop;
// - RING (`stages` > 0): thread 0 fetches, `stages` frames ahead, the
//   frame's warc row and the alpha-stream row the next frame's log alpha
//   needs (row u - 2), one bulk copy (TMA, evicted first) a row, into a
//   ring completing on the stage's mbarrier; the stage is refilled after
//   the frame's barrier, behind a proxy fence (row strides kw and sw are
//   padded by the wrappers to 16 bytes);
// - GROWS: gamma rows are assembled in two P-float rows in shared memory,
//   zeroed once (each frame rewrites only the compact list's pdfs, so the
//   others stay 0), and thread 0 stores each row with one bulk copy
//   (cp.async.bulk, a bulk group), waiting for the copy to have read the
//   row before the row is rewritten two frames later; frames past T_b
//   are stored from a zero row.  Without it the gamma stage stores its
//   pdfs itself and the wrapper zeroes gamma first;
// - PIPE off (the layout for shapes near the limit, 2 S_pad + K_pad <=
//   28,990 doubles): one occupancy buffer and one reduction slot, the
//   gamma stage in the frame itself behind a second barrier, log alpha
//   taken per arc from device memory.
// Every sum has a fixed order (a list in ascending arc order, lanes by a
// butterfly, warps in order), so gamma is deterministic, with no atomics
// (docs/PARITY.md:52-55).
//
// Bound on an H100: the sweep must read warc (B, T, K_pad) and the alpha
// stream (B, T, S_pad) once and write gamma (B, T, P); at the flat-start
// headline batch (B = 128, T = 500, K_pad = 300, S_pad = 151, P = 3000)
// gamma's 0.77 GB dominate: about 0.93 GB, 0.28 ms at 3.35 TB/s.  As in
// the forward sweep, a frame is latency-bound long before that.

#include "fact_common.cuh"

#define SR_TINY 1e-37
#define SR_EXP_CLAMP 80.0

template <bool RESIDENT, bool RING, bool PIPE, bool GROWS>
__global__ void __launch_bounds__(FACT_THREADS, 1) semiring_bwd_kernel(
    const int* __restrict__ lengths,   // (B,)  1 <= T_b <= T
    const float* __restrict__ warc,    // (B, T, kw)
    const double* __restrict__ n_ys,   // (B, T, sw) forward alpha stream
    const double* __restrict__ n0,     // (B, S) alpha(0)
    const int* __restrict__ out_ptr,   // (B, S + 1) out-arc list offsets
    const int* __restrict__ out_arcs,  // (B, K) arc ids by source
    const int* __restrict__ out_sd,    // (B, K) src << 16 | dst, a slot
    const int* __restrict__ emit_pdf,  // (B, E) emitted pdfs, ascending
    const int* __restrict__ emit_ptr,  // (B, E + 1) offsets in pdf_arcs
    const int* __restrict__ n_emit,    // (B,) emitted pdfs a graph
    const int* __restrict__ pdf_arcs,  // (B, K) arc ids by pdf
    const double* __restrict__ rf,     // (B, S) injected final beta
    const double* __restrict__ mf,     // (B,) its log scale
    const double* __restrict__ c_row,  // (B, T) c_u (+ lz0 at u = 0)
    const double* __restrict__ cms,    // (B, T) c_u - s_{u-1}
    int T, int K, int kw, int S, int sw, int P, int pw, int E, int stages,
    float* __restrict__ gamma,         // (B, T, pw)
    float* __restrict__ ab) {          // (B, T) alpha * beta trace
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NB = PIPE ? 2 : 1;     // occupancy buffers, reduction slots
  // a stage: the warc row (kw floats), then an alpha row (sw doubles)
  const int stage_words = kw + 2 * sw;
  float* ring = reinterpret_cast<float*>(smem);
  float* grow = ring + stages * stage_words;          // 2 x pw (GROWS)
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(
      grow + (GROWS ? 2 * pw : 0));                   // one a stage
  double* bb = reinterpret_cast<double*>(bar + stages);  // 2 x S: b
  double* la = bb + 2 * S;                            // 2 x S (PIPE)
  double* occ = la + (PIPE ? 2 * S : 0);              // NB x K
  double* red = occ + NB * K;                         // NB x 2 x 32
  int* l_optr = reinterpret_cast<int*>(red + NB * 64);  // RESIDENT lists
  int* l_oarcs = l_optr + S + 1;
  int* l_osd = l_oarcs + K;
  int* l_parcs = l_osd + K;
  int* l_epdf = l_parcs + K;
  int* l_eptr = l_epdf + E;

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthr >> 5;
  const int b = blockIdx.x;
  const int Tb = lengths[b];
  const size_t rows = static_cast<size_t>(b) * T;
  const int ne = n_emit[b];
  const int* optr = out_ptr + static_cast<size_t>(b) * (S + 1);
  const int* oarcs = out_arcs + static_cast<size_t>(b) * K;
  const int* osd = out_sd + static_cast<size_t>(b) * K;
  const int* parcs = pdf_arcs + static_cast<size_t>(b) * K;
  const int* epdf = emit_pdf + static_cast<size_t>(b) * E;
  const int* eptr = emit_ptr + static_cast<size_t>(b) * (E + 1);
  const int n_arcs = optr[S];
  if (RESIDENT) {
    for (int i = tid; i <= S; i += nthr) l_optr[i] = optr[i];
    for (int i = tid; i < n_arcs; i += nthr) {
      l_oarcs[i] = oarcs[i];
      l_osd[i] = osd[i];
      l_parcs[i] = parcs[i];
    }
    for (int i = tid; i < ne; i += nthr) l_epdf[i] = epdf[i];
    for (int i = tid; i <= ne; i += nthr) l_eptr[i] = eptr[i];
    optr = l_optr;
    oarcs = l_oarcs;
    osd = l_osd;
    parcs = l_parcs;
    epdf = l_epdf;
    eptr = l_eptr;
  }
  const double* n0_b = n0 + static_cast<size_t>(b) * S;
  // alpha(u) for u >= 0: n0, else the stream's row u - 1
  auto alpha_row = [&](int u) {
    return u == 0 ? n0_b : n_ys + (rows + u - 1) * sw;
  };

  // Frame j (u = T_b - 1 - j) reads stage j % stages: warc row u and,
  // for u >= 2, alpha row u - 2 (alpha(u - 1), the next frame's).
  const unsigned long long policy = RING ? evict_first_policy() : 0ull;
  auto fetch = [&](int j) {
    const int u = Tb - 1 - j;
    const int k = j % stages;
    float* st = ring + k * stage_words;
    const unsigned wbytes = 4u * kw, abytes = 8u * sw;
    mbar_expect_tx(bar + k, wbytes + (u >= 2 ? abytes : 0u));
    bulk_load(st, warc + (rows + u) * kw, wbytes, bar + k, policy);
    if (u >= 2)
      bulk_load(st + kw, n_ys + (rows + u - 2) * sw, abytes, bar + k,
                policy);
  };
  if (RING && tid == 0) {
    for (int k = 0; k < stages; ++k) mbar_init(bar + k, 1);
    for (int k = 0; k < stages && k < Tb; ++k) fetch(k);
  }

  // frames past the end: exact zeros
  for (int u = Tb + tid; u < T; u += nthr) ab[rows + u] = 0.0f;
  if (GROWS) {
    for (int i = tid; i < 2 * pw; i += nthr) grow[i] = 0.0f;
    fence_proxy_async();
  }
  // frame 0 gathers b_{-1} * inv_{-1} = rf * 1.0 = rf
  for (int s = tid; s < S; s += nthr) {
    bb[S + s] = rf[static_cast<size_t>(b) * S + s];
    if (PIPE) la[s] = log(alpha_row(Tb - 1)[s]);   // -inf where alpha is 0
  }
  double m_eff = mf[b];
  double inv = 1.0;
  double c_u = c_row[rows + Tb - 1], cm_u = cms[rows + Tb - 1];
  __syncthreads();
  if (GROWS && tid == 0) {
    for (int u = Tb; u < T; ++u)
      bulk_store(gamma + (rows + u) * pw, grow, 4u * pw);
    bulk_commit();
  }

  // gamma of frame jg (u = T_b - 1 - jg) from occupancies o: the compact
  // list's pdfs, into a gamma row in shared memory or straight to gamma
  auto gamma_stage = [&](int jg, const double* o) {
    const int u = Tb - 1 - jg;
    float* g = GROWS ? grow + (jg & 1) * pw : gamma + (rows + u) * pw;
    for (int e = nthr - 1 - tid; e < ne; e += nthr) {   // from the top
      double acc = 0.0;
      const int end = eptr[e + 1];
      for (int i = eptr[e]; i < end; ++i) acc += o[parcs[i]];
      if (GROWS) {
        g[epdf[e]] = static_cast<float>(acc);
      } else {
        __stcs(g + epdf[e], static_cast<float>(acc));
      }
    }
    if (GROWS) fence_proxy_async();
  };
  auto store_row = [&](int jg) {   // thread 0, after a barrier
    fence_proxy_async();
    bulk_store(gamma + (rows + Tb - 1 - jg) * pw, grow + (jg & 1) * pw,
               4u * pw);
    bulk_commit();
  };

  for (int j = 0; j < Tb; ++j) {
    const int u = Tb - 1 - j;
    const int cur = j & 1;
    const double* b_prev = bb + (cur ^ 1) * S;
    double* b_cur = bb + cur * S;
    double* o_cur = occ + (PIPE ? cur * K : 0);
    double* r_cur = red + (PIPE ? cur * 64 : 0);
    const float* w;
    const double* a_next = nullptr;   // alpha(u - 1), for u >= 1
    if (RING) {
      mbar_wait(bar + j % stages, (j / stages) & 1);
      const float* st = ring + (j % stages) * stage_words;
      w = st;
      if (u >= 2) a_next = reinterpret_cast<const double*>(st + kw);
    } else {
      w = warc + (rows + u) * kw;
      if (u >= 2) a_next = n_ys + (rows + u - 2) * sw;
    }
    if (u == 1) a_next = n0_b;
    // the next frame's scale terms, loaded a frame ahead
    const double c_nx = u >= 1 ? c_row[rows + u - 1] : 0.0;
    const double cm_nx = u >= 1 ? cms[rows + u - 1] : 0.0;
    const double scale = m_eff + c_u;

    if (PIPE && j > 0) gamma_stage(j - 1, occ + (cur ^ 1) * K);

    // states from the top thread down, arcs from thread 0 up: the
    // threads with a third arc get no second state or gamma list
    double mx = 0.0, trace = 0.0;
    for (int s = nthr - 1 - tid; s < S; s += nthr) {
      double acc = 0.0;
      const int end = optr[s + 1];
      for (int q = optr[s]; q < end; ++q)
        acc += static_cast<double>(w[oarcs[q]]) *
               (b_prev[osd[q] & 0xffff] * inv);
      b_cur[s] = acc;
      mx = fmax(mx, acc);
      if (PIPE && u >= 1) la[(cur ^ 1) * S + s] = log(a_next[s]);
    }
    const double* a_u = PIPE ? nullptr : alpha_row(u);
    for (int q = tid; q < n_arcs; q += nthr) {
      const int k = oarcs[q];
      const int sd = osd[q];
      const double v =
          static_cast<double>(w[k]) * (b_prev[sd & 0xffff] * inv);
      const double lsrc = PIPE ? la[cur * S + (sd >> 16)]
                               : log(a_u[sd >> 16]);
      const double o = exp(fmin(lsrc + log(v) + scale, SR_EXP_CLAMP));
      o_cur[k] = o;
      trace += o;
    }
    trace = warp_sum_all(trace);
    mx = warp_max_all(mx);
    if (lane == 0) {
      r_cur[2 * warp] = trace;
      r_cur[2 * warp + 1] = mx;
    }
    // the copy of gamma row j - 2 has read its buffer, which frame j's
    // gamma stage (in frame j + 1) rewrites
    if (GROWS && tid == 0) bulk_wait_read();
    // the frame's barrier: b_cur, occ, la and the slots complete; b_prev,
    // the stage and (PIPE) the occupancies of frame j - 1 read
    __syncthreads();
    if (RING && tid == 0 && j + stages < Tb) {
      fence_proxy_async();
      fetch(j + stages);
    }
    if (GROWS && tid == 0 && j > 0) store_row(j - 1);
    trace = warp_sum_all(lane < nwarps ? r_cur[2 * lane] : 0.0);
    mx = warp_max_all(lane < nwarps ? r_cur[2 * lane + 1] : 0.0);
    if (tid == 0) ab[rows + u] = static_cast<float>(trace);
    inv = 1.0 / fmax(mx, SR_TINY);
    m_eff = m_eff + cm_u + log(fmax(mx, SR_TINY));
    c_u = c_nx;
    cm_u = cm_nx;
    if (!PIPE) {
      gamma_stage(j, o_cur);
      __syncthreads();   // occ and the slots read before the next frame
    }
  }
  if (PIPE) {
    gamma_stage(Tb - 1, occ + ((Tb - 1) & 1) * K);
    if (GROWS) {
      __syncthreads();
      if (tid == 0) store_row(Tb - 1);
    }
  }
  if (GROWS && tid == 0) bulk_wait_all();
}

extern "C" size_t semiring_bwd_smem_bytes(int S, int K, int kw, int sw,
                                          int pw, int E, int stages,
                                          int resident, int pipe,
                                          int grows) {
  const size_t nb = pipe ? 2 : 1;
  return static_cast<size_t>(stages) * (4 * static_cast<size_t>(kw) +
                                        8 * static_cast<size_t>(sw) + 8) +
         (grows ? 8 * static_cast<size_t>(pw) : 0) +
         (pipe ? 32 : 16) * static_cast<size_t>(S) +
         nb * (8 * static_cast<size_t>(K) + 512) +
         (resident ? 4 * (static_cast<size_t>(S) + 1 + 3 * K + 2 * E + 1)
                   : 0);
}

template <bool RESIDENT, bool RING, bool PIPE, bool GROWS>
static int launch(dim3 grid, int threads, size_t smem, cudaStream_t stream,
                  const void* const* p, int T, int K, int kw, int S, int sw,
                  int P, int pw, int E, int stages, void* gamma, void* ab) {
  auto kernel = semiring_bwd_kernel<RESIDENT, RING, PIPE, GROWS>;
  cudaError_t err = fact_set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const int*>(p[0]), static_cast<const float*>(p[1]),
      static_cast<const double*>(p[2]), static_cast<const double*>(p[3]),
      static_cast<const int*>(p[4]), static_cast<const int*>(p[5]),
      static_cast<const int*>(p[6]), static_cast<const int*>(p[7]),
      static_cast<const int*>(p[8]), static_cast<const int*>(p[9]),
      static_cast<const int*>(p[10]), static_cast<const double*>(p[11]),
      static_cast<const double*>(p[12]), static_cast<const double*>(p[13]),
      static_cast<const double*>(p[14]), T, K, kw, S, sw, P, pw, E, stages,
      static_cast<float*>(gamma), static_cast<float*>(ab));
  return static_cast<int>(cudaGetLastError());
}

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a layout the kernel has no form of (PIPE off
// with any option on).
extern "C" int semiring_bwd_launch(
    const void* lengths, const void* warc, const void* n_ys, const void* n0,
    const void* out_ptr, const void* out_arcs, const void* out_sd,
    const void* emit_pdf, const void* emit_ptr, const void* n_emit,
    const void* pdf_arcs, const void* rf, const void* mf, const void* c_row,
    const void* cms, int B, int T, int K, int kw, int S, int sw, int P,
    int pw, int E, int threads, int stages, int resident, int pipe,
    int grows, void* gamma, void* ab, void* stream) {
  const void* p[] = {lengths, warc, n_ys, n0, out_ptr, out_arcs, out_sd,
                     emit_pdf, emit_ptr, n_emit, pdf_arcs, rf, mf, c_row,
                     cms};
  const size_t smem = semiring_bwd_smem_bytes(S, K, kw, sw, pw, E, stages,
                                              resident, pipe, grows);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B);
#define SR_BWD_ARGS \
  grid, threads, smem, st, p, T, K, kw, S, sw, P, pw, E, stages, gamma, ab
  if (!pipe) {
    if (resident || stages || grows)
      return static_cast<int>(cudaErrorInvalidValue);
    return launch<false, false, false, false>(SR_BWD_ARGS);
  }
  const int key = (resident ? 4 : 0) | (stages ? 2 : 0) | (grows ? 1 : 0);
  switch (key) {
    case 0: return launch<false, false, true, false>(SR_BWD_ARGS);
    case 1: return launch<false, false, true, true>(SR_BWD_ARGS);
    case 2: return launch<false, true, true, false>(SR_BWD_ARGS);
    case 3: return launch<false, true, true, true>(SR_BWD_ARGS);
    case 4: return launch<true, false, true, false>(SR_BWD_ARGS);
    case 5: return launch<true, false, true, true>(SR_BWD_ARGS);
    case 6: return launch<true, true, true, false>(SR_BWD_ARGS);
    default: return launch<true, true, true, true>(SR_BWD_ARGS);
  }
#undef SR_BWD_ARGS
}
