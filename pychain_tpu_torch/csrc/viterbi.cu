// Max-plus (Viterbi) sweep of a batch of log-domain graphs, with int32
// arc backpointers, the end scoring and the traceback.
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
//   bp[b, t, s] = the highest arc id k achieving it, -1 where it is -inf
//
// The graphs are the semiring engine's arc-id arrays (ops/semiring.py):
// in(s) is in_arcs[in_ptr[s] .. in_ptr[s+1]), a stable sort of the arcs by
// destination, so ascending ids, the same arcs in the same order as the
// JAX package's backward lists.  Walked in order with `cand >= best`, the
// last arc achieving the max wins, the tie rule of every JAX sweep
// (viterbi.py:86-92).  The kernel only adds float32 in the plain
// version's order, (delta + logp) + x, and compares, so its scores and
// paths are bit-identical to the plain version (ops/viterbi.py); the
// build uses no fast-math flag, and no fmaxf hides the tie rule.  Dead
// scores are a true -inf: nothing multiplies them.  x is clamped to
// [-30, 30] as it is read, with compares that let NaN through as
// torch.clamp does, so the caller makes no clamped copy of x.
//
// Design.  One block per sequence runs its whole time loop.  delta is
// double-buffered in shared memory (2 S_pad floats, so S_pad <= 29,056),
// one barrier per frame; a thread owns the states s = tid + k * blockDim
// and walks each state's in-arc list, reading x[b, t, pdf] straight from
// (B, T, P): no (B, T, K) emission table is built (at the shared decode
// graph's 40k arcs it would hold 10 GB at B = 128, T = 500).  Frames at
// or past T_b are skipped and delta keeps frame T_b - 1.  Then thread 0
// scores the end states (the LOWEST state of the max, as jnp.argmax)
// and walks the backpointers back; pdfs and states are -1 past T_b and
// wherever objf is not finite (objf is -inf at T_b = 0).  A shared graph
// is one row of arrays read by every block.
//
// Bound on an H100 (chip_smoke.py prints it for each size class): the
// function must read x at each graph's pdfs for its live frames and
// write one backpointer per live state-frame, which needs only the
// winner's position in its state's in-arc list: ceil(log2(max in-degree))
// bits, a byte for every graph here (the kernel writes int32 arc ids,
// four times that).  At B = 128, T = 500, S = 512 (bench.py --viterbi)
// that is about 0.18 GB, 0.054 ms at 3.35 TB/s.  A frame of these graphs
// is far below what fills an SM, so the sweep waits on the latency of
// each frame's loads and its barrier, T_b times in a row, and the serial
// traceback adds T_b dependent loads; several sequences per block, byte
// backpointers and a parallel traceback are what a faster version would
// try first.

#include <math_constants.h>

#include "fact_common.cuh"

#define VIT_MAX_THREADS 1024
#define VIT_CLAMP 30.0f  // as chain_function (loss.py)

// (.., 1): one block an SM.  With the thread count alone ptxas held the
// kernel to 32 registers and spilled; this gives it 48 and no spill.
__global__ void __launch_bounds__(VIT_MAX_THREADS, 1) viterbi_kernel(
    const int* __restrict__ lengths,   // (B,)  0 <= T_b <= T
    const float* __restrict__ x,       // (B, T, P) log-likelihoods
    const int* __restrict__ src,       // (G, K) arc sources
    const int* __restrict__ pdf,       // (G, K)
    const float* __restrict__ logp,    // (G, K), -inf on padding
    const int* __restrict__ in_ptr,    // (G, S + 1) in-arc list offsets
    const int* __restrict__ in_arcs,   // (G, K) arc ids by destination
    const float* __restrict__ initial, // (G, S) log initial probs
    const float* __restrict__ final_p, // (G, S) log final probs
    int T, int P, int K, int S,
    int shared,                        // G = 1: one graph for every b
    int* __restrict__ bp,              // (B, T, S) written for t < T_b
    float* __restrict__ objf,          // (B,)
    int* __restrict__ pdfs,            // (B, T)
    int* __restrict__ states) {        // (B, T)
  extern __shared__ float smem[];
  float* cur = smem;       // delta after the previous frame
  float* nxt = smem + S;   // delta after this frame

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const size_t g = shared ? 0 : static_cast<size_t>(b);
  const int Tb = lengths[b];
  const int* src_g = src + g * K;
  const int* pdf_g = pdf + g * K;
  const float* logp_g = logp + g * K;
  const int* ptr_g = in_ptr + g * (S + 1);
  const int* arcs_g = in_arcs + g * K;

  for (int s = tid; s < S; s += blockDim.x) cur[s] = initial[g * S + s];
  __syncthreads();

  for (int t = 0; t < Tb; ++t) {
    const size_t row = static_cast<size_t>(b) * T + t;
    const float* xt = x + row * P;
    int* bpt = bp + row * S;
    for (int s = tid; s < S; s += blockDim.x) {
      float best = -CUDART_INF_F;
      int arg = -1;
      const int end = __ldg(ptr_g + s + 1);
      for (int j = __ldg(ptr_g + s); j < end; ++j) {
        const int k = __ldg(arcs_g + j);
        float e = __ldg(xt + __ldg(pdf_g + k));
        // torch.clamp: NaN fails both compares and passes through
        e = e < -VIT_CLAMP ? -VIT_CLAMP : (e > VIT_CLAMP ? VIT_CLAMP : e);
        const float cand = (cur[__ldg(src_g + k)] + __ldg(logp_g + k)) + e;
        if (cand >= best) {   // ascending ids: the highest id wins a tie
          best = cand;
          arg = k;
        }
      }
      nxt[s] = best;
      bpt[s] = best > -CUDART_INF_F ? arg : -1;
    }
    // every read of cur and write of nxt of this frame is done; the
    // barrier also makes this block's backpointer stores visible to the
    // traceback below
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  if (tid != 0) return;
  const float* fin = final_p + g * S;
  float top = cur[0] + fin[0];
  int c = 0;
  for (int s = 1; s < S; ++s) {
    const float v = cur[s] + fin[s];
    if (v > top) {          // strict: the lowest state of the max
      top = v;
      c = s;
    }
  }
  const float score = Tb > 0 ? top : -CUDART_INF_F;
  objf[b] = score;
  const bool ok = isfinite(score);
  int* pdfs_b = pdfs + static_cast<size_t>(b) * T;
  int* states_b = states + static_cast<size_t>(b) * T;
  for (int t = T - 1; t >= 0; --t) {
    int out_pdf = -1, out_state = -1;
    if (ok && t < Tb) {
      const int arc = bp[(static_cast<size_t>(b) * T + t) * S + c];
      if (arc >= 0) {
        out_pdf = pdf_g[arc];
        out_state = c;
        c = src_g[arc];
      }
    }
    pdfs_b[t] = out_pdf;
    states_b[t] = out_state;
  }
}

extern "C" size_t viterbi_smem_bytes(int S) {
  return 2 * static_cast<size_t>(S) * sizeof(float);
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int viterbi_launch(
    const void* lengths, const void* x, const void* src, const void* pdf,
    const void* logp, const void* in_ptr, const void* in_arcs,
    const void* initial, const void* final_p, int B, int T, int P, int K,
    int S, int shared,
    void* bp, void* objf, void* pdfs, void* states, void* stream) {
  const size_t smem = viterbi_smem_bytes(S);
  cudaError_t err = fact_set_smem(viterbi_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  // one thread per state up to a full block, in whole warps
  int threads = (S + 31) / 32 * 32;
  threads = threads < 32 ? 32 : threads;
  threads = threads > VIT_MAX_THREADS ? VIT_MAX_THREADS : threads;
  if (B > 0)
    viterbi_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(lengths), static_cast<const float*>(x),
        static_cast<const int*>(src), static_cast<const int*>(pdf),
        static_cast<const float*>(logp), static_cast<const int*>(in_ptr),
        static_cast<const int*>(in_arcs), static_cast<const float*>(initial),
        static_cast<const float*>(final_p),
        T, P, K, S, shared, static_cast<int*>(bp), static_cast<float*>(objf),
        static_cast<int*>(pdfs), static_cast<int*>(states));
  return static_cast<int>(cudaGetLastError());
}
