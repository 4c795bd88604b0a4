// Max-plus (Viterbi) sweep of a batch of log-domain graphs, with byte
// backpointers, the end scoring and the traceback.
//
// Replaces pychain_tpu/ops/viterbi.py::_vit_kernel (B11, launched by
// _pallas_sweep).  On a TPU that kernel runs a (B, T) grid: each graph's
// arcs become two (S_pad, K_pad) bf16 incidence masks in VMEM, the
// emissions a (B, T, K) table built outside, dead scores a finite -1e30
// (a mask multiply would turn -inf into NaN) and the backpointers are
// packed 128 frames to the lanes.  None of that carries over.  Per frame
// t < T_b of sequence b, for every state s:
//
//   delta'[s] = max_{k in in(s)} (delta[src[k]] + logp[k]) + clamp(x[b, t, pdf[k]])
//   bp[b, t, s] = the highest arc id k achieving it
//
// The graphs are the semiring engine's arc-id arrays (ops/semiring.py):
// in(s) is in_arcs[in_ptr[s] .. in_ptr[s+1]), a stable sort of the arcs by
// destination, so ascending ids, the same arcs in the same order as the
// JAX package's backward lists.  Slot j of state s is in_ptr[s] + j and
// names the arc in_arcs[in_ptr[s] + j].  The
// kernel only adds float32 in the plain version's order,
// (delta + logp) + x, and compares, so its scores and paths are
// bit-identical to the plain version (ops/viterbi.py); the build uses
// no fast-math flag, and no fmaxf hides the tie rule.  Dead scores are a
// true -inf.  x is clamped to [-30, 30] as it is read, with compares
// that let NaN through as torch.clamp does; a NaN candidate never wins.
//
// Design (viterbi_kernels.plan picks the layout; PERF.md has its steps):
// - L lanes a state: thread tid serves state group tid / L, and its
//   lane walks slots j = in_ptr[s] + lane, + L, ...  Each lane keeps its
//   best (value, slot) under the serial rule (`cand >= best`, ascending
//   slots: the last slot of the max), then the L lanes reduce by a
//   butterfly of __shfl_xor_sync: the larger value wins, then the larger
//   slot.  No NaN enters a pair and (-inf, -1) starts each lane, so this
//   max is associative and commutative, and every order of it gives the
//   serial walk's answer, bit for bit.  The compute warps are the
//   multiple of 32 threads that covers S_pad * L, at most 1024 with the
//   producer warp.
// - `resident`: the slot lists (offsets, and each slot's arc's
//   src | pdf << 16 and log weight, gathered through in_arcs) are copied
//   into shared memory before frame 0, in slot order, so a frame reads
//   nothing from device memory but x.  Without them a slot's arc is read
//   through in_arcs every frame.
// - x fetched ahead, whole rows x[b, t] by TMA bulk copies (16-byte
//   aligned rows: P a multiple of 4) into a ring of `stages` frames, by
//   a producer warp (the block's last, which serves no state): its lane
//   0 waits on the mbarrier of frame t + 1's stage before frame t's
//   barrier, which then publishes the row, and refills the stage frame t
//   read for frame t + stages after it, so the one barrier a frame also
//   guards the ring and the compute warps never touch its machinery.
//   Without a ring x[b, t, pdf] is read from device memory.
// - backpointers are the winner's position in its state's in-list, of
//   `bp_width` bytes (1 up to in-degree 256, else 2, else 4), held in
//   shared memory for the whole sweep (`bp_smem`) or written to a
//   (B, T, S_pad) device tensor.  Nothing reads a position of a state
//   whose score is -inf: a finite best path has a finite score at every
//   frame, and every other output is -1.
// - the tail: the block scores the end states (the LOWEST state of the
//   max, as jnp.argmax: a reduction of (value, state) pairs), then one
//   thread walks the positions back: slot in_ptr[c] + pos names the arc,
//   and so its source and pdf.  pdfs and states are -1 past T_b and wherever objf
//   is not finite (objf is -inf at T_b = 0).
// A shared graph is one row of arrays read by every block.
//
// Bound on an H100 (chip_smoke.py prints it for each size class): the
// function must read x at each graph's pdfs for its live frames, and
// write one backpointer (a byte here) per live state-frame only where a
// sequence's do not fit one block's shared memory.  At B = 128, T = 500,
// S = 512 (bench.py --viterbi), where they do not, that is about 0.16 GB,
// 0.047 ms at 3.35 TB/s.  A frame of these graphs is far below what fills an SM:
// the sweep waits on the latency of its shared-memory loads, the lanes'
// shuffles and one barrier, T_b times in a row.

#include <math_constants.h>

#include "fact_common.cuh"

#define VIT_MAX_THREADS 1024
#define VIT_CLAMP 30.0f  // as chain_function (loss.py)
#define VIT_SCRATCH 64   // floats of each delta buffer, at least

__device__ __forceinline__ void bp_put(unsigned char* p, size_t i, int w,
                                       int v) {
  if (w == 1)
    p[i] = static_cast<unsigned char>(v);
  else if (w == 2)
    reinterpret_cast<unsigned short*>(p)[i] = static_cast<unsigned short>(v);
  else
    reinterpret_cast<int*>(p)[i] = v;
}

__device__ __forceinline__ int bp_get(const unsigned char* p, size_t i,
                                      int w) {
  if (w == 1) return p[i];
  if (w == 2) return reinterpret_cast<const unsigned short*>(p)[i];
  return reinterpret_cast<const int*>(p)[i];
}

// (v, s) beats (top, c): a larger value, or the same value at a lower
// state.  NaN beats nothing.
__device__ __forceinline__ bool end_beats(float v, int s, float top, int c) {
  return v > top || (v == top && s < c);
}

// RESIDENT: the slot lists in shared memory; RING: x through the ring.
template <bool RESIDENT, bool RING>
__global__ void __launch_bounds__(VIT_MAX_THREADS, 1) viterbi_kernel(
    const int* __restrict__ lengths,    // (B,)  0 <= T_b <= T
    const float* __restrict__ x,        // (B, T, P) log-likelihoods
    const int* __restrict__ in_ptr,     // (G, S + 1) in-list offsets
    const int* __restrict__ in_arcs,    // (G, K) the arc of slot j
    const int* __restrict__ src,        // (G, K) arc sources
    const int* __restrict__ pdf,        // (G, K) arc pdfs
    const float* __restrict__ logp,     // (G, K) arc log weights
    const float* __restrict__ initial,  // (G, S) log initial probs
    const float* __restrict__ final_p,  // (G, S) log final probs
    int T, int P, int K, int S, int shared, int lg_lanes, int stages,
    int bp_smem, int bp_width,
    unsigned char* __restrict__ bp,     // (B, T, S) unless bp_smem
    float* __restrict__ objf,           // (B,)
    int* __restrict__ pdfs,             // (B, T)
    int* __restrict__ states) {         // (B, T)
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);  // stages x P
  unsigned long long* bar = reinterpret_cast<unsigned long long*>(
      ring + (RING ? stages * P : 0));            // one a stage
  // delta double-buffered, each buffer max(S, VIT_SCRATCH) floats: after
  // the sweep either may be the tail's scratch
  const int nbuf = S > VIT_SCRATCH ? S : VIT_SCRATCH;
  float* cur = reinterpret_cast<float*>(bar + (RING ? stages : 0));
  float* nxt = cur + nbuf;
  int* lptr = reinterpret_cast<int*>(nxt + nbuf);
  unsigned* lword = reinterpret_cast<unsigned*>(lptr + S + 1);  // K
  float* llogp = reinterpret_cast<float*>(lword + K);           // K
  unsigned char* bp_s =
      reinterpret_cast<unsigned char*>(RESIDENT ? llogp + K : nxt + nbuf);

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  // with a ring, the last warp is its producer: it fetches x ahead and
  // serves no state; the others compute
  const bool producer = RING && tid >= nthr - 32;
  const int lane = tid & 31;
  const int lanes = 1 << lg_lanes;
  const int sub = tid & (lanes - 1);    // this thread's lane of its state
  const int grp = tid >> lg_lanes;
  const int ngroups = (RING ? nthr - 32 : nthr) >> lg_lanes;
  const int b = blockIdx.x;
  const size_t g = shared ? 0 : static_cast<size_t>(b);
  const int Tb = lengths[b];
  const size_t row0 = static_cast<size_t>(b) * T;
  const int* ptr_g = in_ptr + g * (S + 1);
  const int* arcs_g = in_arcs + g * K;
  const int* src_g = src + g * K;
  const int* pdf_g = pdf + g * K;
  const float* logp_g = logp + g * K;
  const int* ptr = ptr_g;
  if (RESIDENT) {
    for (int i = tid; i <= S; i += nthr) lptr[i] = ptr_g[i];
    const int n_in = ptr_g[S];
    for (int j = tid; j < n_in; j += nthr) {
      const int a = arcs_g[j];
      lword[j] = static_cast<unsigned>(src_g[a]) |
                 (static_cast<unsigned>(pdf_g[a]) << 16);
      llogp[j] = logp_g[a];
    }
    ptr = lptr;
  }
  unsigned char* bpb =
      bp_smem ? bp_s
              : bp + row0 * S * static_cast<size_t>(bp_width);

  // frame t reads its x row from stage k = t % stages
  const unsigned long long policy = RING ? evict_first_policy() : 0ull;
  auto fetch_row = [&](int t, int k) {
    mbar_expect_tx(bar + k, 4u * P);
    bulk_load(ring + k * P, x + (row0 + t) * P, 4u * P, bar + k, policy);
  };
  // The producer fills the ring's first stages and waits for frame 0's
  // row; before each frame's barrier it waits for the next frame's, so
  // that the barrier publishes it, and after the barrier it refills the
  // stage the frame read.
  const bool fetcher = producer && lane == 0;
  if (RING && fetcher) {
    for (int k = 0; k < stages; ++k) mbar_init(bar + k, 1);
    for (int k = 0; k < stages && k < Tb; ++k) fetch_row(k, k);
    if (Tb > 0) mbar_wait(bar, 0);
  }
  for (int s = tid; s < S; s += nthr) cur[s] = initial[g * S + s];
  __syncthreads();
  // the in-list of this thread's first state, for every frame
  const int beg0 = !producer && grp < S ? ptr[grp] : 0;
  const int end0 = !producer && grp < S ? ptr[grp + 1] : 0;

  int st = 0;                 // the ring's stage of frame t: t % stages
  unsigned ph = 0;            // and its mbarrier's phase parity
  for (int t = 0; t < Tb; ++t) {
    const float* xr = RING ? ring + st * P : x + (row0 + t) * P;
    const size_t bp_row = static_cast<size_t>(t) * S;
    for (int base = 0; !producer && base < S; base += ngroups) {
      const int s = base + grp;
      float best = -CUDART_INF_F;
      int arg = -1;
      int beg = 0;
      if (s < S) {
        beg = base ? ptr[s] : beg0;
        const int end = base ? ptr[s + 1] : end0;
        // unrolled: later slots' loads issue before earlier compares
#pragma unroll 4
        for (int j = beg + sub; j < end; j += lanes) {
          int from, col;
          float lp;
          if (RESIDENT) {
            const unsigned w = lword[j];
            from = static_cast<int>(w & 0xffffu);
            col = static_cast<int>(w >> 16);
            lp = llogp[j];
          } else {
            const int a = __ldg(arcs_g + j);
            from = __ldg(src_g + a);
            col = __ldg(pdf_g + a);
            lp = __ldg(logp_g + a);
          }
          float e = RING ? xr[col] : __ldg(xr + col);
          // torch.clamp: NaN fails both compares and passes through
          e = e < -VIT_CLAMP ? -VIT_CLAMP : (e > VIT_CLAMP ? VIT_CLAMP : e);
          const float cand = (cur[from] + lp) + e;
          if (cand >= best) {   // ascending slots: the last of the max
            best = cand;
            arg = j;
          }
        }
      }
      // the lanes' pairs: the larger value, then the larger slot
      for (int off = lanes >> 1; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, best, off);
        const int oa = __shfl_xor_sync(0xffffffffu, arg, off);
        if (ov > best || (ov == best && oa > arg)) {
          best = ov;
          arg = oa;
        }
      }
      if (s < S && sub == 0) {
        nxt[s] = best;
        bp_put(bpb, bp_row + s, bp_width, arg >= 0 ? arg - beg : 0);
      }
    }
    // frame t + 1's x has landed; the barrier publishes it, as it does
    // every read of cur and write of nxt
    const int st1 = st + 1 == stages ? 0 : st + 1;
    const unsigned ph1 = st1 == 0 ? ph ^ 1u : ph;
    if (RING && fetcher && t + 1 < Tb) mbar_wait(bar + st1, ph1);
    __syncthreads();
    if (RING && fetcher && t + stages < Tb) {
      fence_proxy_async();
      fetch_row(t + stages, st);
    }
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
    st = st1;
    ph = ph1;
  }

  // the end state: the lowest state of the max of cur + final, as a
  // block reduction of (value, state) pairs (nxt is the scratch)
  const float* fin = final_p + g * S;
  float top = -CUDART_INF_F;
  int c = 0x7fffffff;
  for (int s = tid; s < S; s += nthr) {
    const float v = cur[s] + fin[s];
    if (end_beats(v, s, top, c)) {
      top = v;
      c = s;
    }
  }
  float* red_v = nxt;
  int* red_c = reinterpret_cast<int*>(nxt + 32);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, top, off);
    const int oc = __shfl_xor_sync(0xffffffffu, c, off);
    if (end_beats(ov, oc, top, c)) {
      top = ov;
      c = oc;
    }
  }
  if (lane == 0) {
    red_v[tid >> 5] = top;
    red_c[tid >> 5] = c;
  }
  __syncthreads();
  if (tid >= 32) {
    // positions past T_b (all of them on a failed sequence: below)
    for (int t = Tb + tid - 32; t < T; t += nthr - 32) {
      pdfs[row0 + t] = -1;
      states[row0 + t] = -1;
    }
    return;
  }
  top = lane < (nthr >> 5) ? red_v[lane] : -CUDART_INF_F;
  c = lane < (nthr >> 5) ? red_c[lane] : 0x7fffffff;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, top, off);
    const int oc = __shfl_xor_sync(0xffffffffu, c, off);
    if (end_beats(ov, oc, top, c)) {
      top = ov;
      c = oc;
    }
  }
  if (tid != 0) return;
  // the serial scan starts from state 0: a NaN there is the answer
  const float v0 = cur[0] + fin[0];
  if (v0 != v0) {
    top = v0;
    c = 0;
  }
  const float score = Tb > 0 ? top : -CUDART_INF_F;
  objf[b] = score;
  const bool ok = isfinite(score);
  if (nthr == 32) {
    for (int t = Tb; t < T; ++t) {
      pdfs[row0 + t] = -1;
      states[row0 + t] = -1;
    }
  }
  for (int t = Tb - 1; t >= 0; --t) {
    int out_pdf = -1, out_state = -1;
    if (ok) {
      const int j = ptr[c] + bp_get(bpb, static_cast<size_t>(t) * S + c,
                                    bp_width);
      out_state = c;
      if (RESIDENT) {
        const unsigned w = lword[j];
        out_pdf = static_cast<int>(w >> 16);
        c = static_cast<int>(w & 0xffffu);
      } else {
        const int a = arcs_g[j];
        out_pdf = pdf_g[a];
        c = src_g[a];
      }
    }
    pdfs[row0 + t] = out_pdf;
    states[row0 + t] = out_state;
  }
}

// Must equal viterbi_kernels.smem_bytes: the x ring (stages rows of P
// floats) and its mbarriers; delta double-buffered (each buffer at least
// VIT_SCRATCH floats, the tail's scratch); resident, the offsets, the
// packed slots and log weights; the backpointers where they are held.
extern "C" size_t viterbi_smem_bytes(int S, int K, int T, int P, int stages,
                                     int resident, int bp_smem,
                                     int bp_width) {
  size_t n = static_cast<size_t>(stages) * (4 * static_cast<size_t>(P) + 8);
  n += 8 * static_cast<size_t>(S > VIT_SCRATCH ? S : VIT_SCRATCH);
  if (resident)
    n += 4 * (static_cast<size_t>(S) + 1) + 8 * static_cast<size_t>(K);
  if (bp_smem)
    n += static_cast<size_t>(T) * S * static_cast<size_t>(bp_width);
  return n;
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int viterbi_launch(
    const void* lengths, const void* x, const void* in_ptr,
    const void* in_arcs, const void* src, const void* pdf, const void* logp,
    const void* initial, const void* final_p, int B, int T, int P, int K,
    int S, int shared, int threads, int lg_lanes, int stages, int resident,
    int bp_smem, int bp_width, void* bp, void* objf, void* pdfs,
    void* states, void* stream) {
  const size_t smem = viterbi_smem_bytes(S, K, T, P, stages, resident,
                                         bp_smem, bp_width);
  auto kernel = resident ? (stages ? viterbi_kernel<true, true>
                                   : viterbi_kernel<true, false>)
                         : (stages ? viterbi_kernel<false, true>
                                   : viterbi_kernel<false, false>);
  cudaError_t err = fact_set_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B > 0)
    kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(lengths), static_cast<const float*>(x),
        static_cast<const int*>(in_ptr), static_cast<const int*>(in_arcs),
        static_cast<const int*>(src), static_cast<const int*>(pdf),
        static_cast<const float*>(logp),
        static_cast<const float*>(initial),
        static_cast<const float*>(final_p), T, P, K, S, shared, lg_lanes,
        stages, bp_smem, bp_width, static_cast<unsigned char*>(bp),
        static_cast<float*>(objf), static_cast<int*>(pdfs),
        static_cast<int*>(states));
  return static_cast<int>(cudaGetLastError());
}
