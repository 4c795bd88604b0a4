// The XL roofline probe's recurrence on the CUDA cores (xl_vpu) and on the
// tensor cores (xl_mxu, in a parity-grade three-term form and a one-pass
// bf16 form).
//
// Replaces tools/xl_roofline.py's two Pallas kernels: make_vpu's
// (pallas_call :72, kernel :50; T1) and make_mxu's (pallas_call :126,
// kernel :94; T2).  Both compute, for each batch row b, over random arc
// lists src, dst (B, K) on S states and weights w (K) shared by the rows:
//
//   nc = 1/S;  T times:  a[s] = sum_{k: dst[k] = s} nc[src[k]] * w[k]
//                        nc   = a * (1 / max(sum_s a[s], 1e-30))
//
// and return the last carry (B, S).  On a TPU both keep two (S, K) one-hot
// masks in VMEM, built at t = 0; T1 contracts them on the vector unit, T2
// as two dot_generals on the matrix unit.  The function needs K gathers
// and 2K flops a frame and row: at the default size (S = 1000, K = 3200,
// T = 512, B = 8) 26 MFLOP, under a microsecond at 67 TFLOP/s.  What
// bounds both kernels is the serial chain of T frames, each of which
// reads values that every other state wrote the frame before: a frame is
// a block barrier and the latency of what lies between two of them.  One
// block runs a row's whole time loop, so the rows run in parallel and a
// call takes about T frames of one row.
//
// Both kernels, and the plain versions, sum a in float64 and round the
// total to float32 once, so that sum a does not depend on the order of
// the sum.  It matters for the bf16 form: its sums of a few bf16 values
// are exact, so its carry is bit for bit the plain version's unless sum a
// differs, and a one-ulp difference there, from a float32 sum taken in
// another order, tips a bf16 rounding and grows to a 1.5e-2 relative
// difference of the carry after 512 frames on an H100 (PERF.md).  Every
// lane and warp takes the total in the same order (xor butterflies pair
// the same two values in every lane), and nothing is added by atomics:
// the carry is bit-identical from run to run.
//
// xl_vpu (CUDA cores): a short frame.  A block of W compute warps and one
// summing warp runs a row (W = 1 .. 16, chosen by the wrapper from K: 8 at the
// default size).  The arcs are in destination order (a stable sort by dst: a
// state's in-arcs in ascending arc id), a state with no in-arc given one arc
// of weight 0 from a zero slot, and the wrapper deals the states out to the
// compute threads in contiguous runs of about equal arc counts.  Where every
// run fits R = 24 slots (the default size's runs), a thread's arcs (source,
// weight, last-of-state flag) live in registers for the whole call and a frame
// issues its R gathers at once; else (a state of many in-arcs) they stay in
// shared memory and a thread walks its run.  Each state sums its in-arcs in
// that order, each product rounded, and scales the sum once: b_{t+1}[s] =
// (sum_k b_t[src] w) * c_t.  The scale c_t = 1 / sum b_{t-1} comes a frame
// late from the summing warp, which adds the compute threads' float64 partials
// of b_t while they compute b_{t+1}; c_0 = 1, and the carry is b_T * (1 / sum
// b_T).  The function is linear in the carry, so every positive scale gives
// the same last carry: only the rounding differs from the plain version's a *
// inv (about 4e-7 of it at the default size), and the stored vector's sum
// cycles through 1, g and g^2 for a growth g a frame (sum a over sum nc, about
// 2 here).  So the last carry is the plain version's only while g^2 stays a
// normal float32, 1e-19 <= g <= 1e19 (w >= 0 with K max w <= 1e19 keeps g
// under its top; the plain version renormalises every frame and has no such
// range).  No compute thread waits for a reduction: one barrier a frame, and
// what is left is the gathers, the products and the stores a thread issues,
// and the summing warp's chain of float64 adds beside them (PERF.md has the
// ablation).  The summing warp issues a batch of loads at once, so that it
// waits once, not once a load, behind the frame's gathers in the shared-memory
// queue.
//
// xl_mxu (tensor cores, mma.sync m16n8k16, bf16 in, f32 accumulate).  One
// block of 16 warps a row (fewer were slower at the default size: PERF.md).
// Both contractions are products with the {0,1} masks: asel (1, K) = nc (1, S)
// @ ohs (S, K), then a (1, S) = contrib (1, K) @ ohd^T (K, S), contrib = asel
// * w.  The kernel issues only the fragments whose mask tile holds a nonzero;
// a skipped fragment would add +0 to a nonnegative float32 sum, so no value
// changes.  The wrapper sorts the arcs stably by src for the first product and
// by dst for the second and lists, for each tile, the 16-wide k-slabs of its
// mask that hold a nonzero (one contiguous range each): some 260 fragments a
// frame and row in either product at the default size, where the dense form
// issues 50,400 of half the size.  Between the products, contrib moves from
// src to dst order through shared memory (the permutation, once a frame).  The
// masks are not stored: each mask fragment is made in registers by integer
// compares against the sorted ids.  Both products run transposed, so that the
// mask is the A tile with all its 16 rows used (16 src-sorted arcs by 16
// states: asel^T = ohs^T @ nc^T; 16 states by 16 dst-sorted arcs: a^T = ohd @
// contrib^T) and the operand's split bf16 terms are B's columns 0 .. split -
// 1: one mma a fragment whatever the split.  A warp takes XL_MXU_CHUNK tiles
// at a time, each with its own accumulator; the rounds of fragments that every
// tile of the chunk has go with no branch between them, the rest behind one.
// The terms' results are added in registers in a fixed order, (hi + mid) + lo:
//   split = 3 ("mxu_f32", the parity grade; Hopper has no plain-f32
//     tensor-core mode): each f32 operand is split into bf16 terms hi + mid
//     + lo, each the round-to-nearest-even of what the terms before it
//     left; with {0,1} masks every product is exact, so the first product
//     returns the carry exactly and only the second's sums round.
//   split = 1 ("mxu_bf16", the TPU's DEFAULT precision): the operand is
//     rounded to bf16 before each product, f32 accumulation.
// Two barriers a frame: after the first product (contrib in dst order), after
// the second (a and the warps' partial sums).  Each warp splits the carry of
// the state slabs its first-product tiles read (a * inv) before it needs them,
// so no pass and barrier of their own.  Two warps whose tiles read one slab
// both write its terms while either may read them: an intended race of equal
// values (both take inv from the same partials in the same order and round
// alike), which a race checker reports but which changes no bit.  mma.sync and
// not wgmma: wgmma's A tile is 64 rows where a tile here has 16 (its arcs or
// states span 1-5 slabs), and wgmma reads B from shared memory, where the
// operand's terms are made for each fragment.  What bounds it: not the
// products' operations (a few percent of the dense form's, microseconds of the
// tensor cores' peak a call) but the instructions: one mma.sync a fragment and
// some 25 more around it (tile list, operand loads, mask compares), between
// two barriers a frame (PERF.md has the ablation).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "fact_common.cuh"

#define XL_TINY 1e-30f
#define XL_SRC_MASK 0x7fffffff  // a slot's source; bit 31: last in-arc
#define XL_VPU_SLOTS 24    // register slots a thread (0: shared memory)
#define XL_VPU_MAX_THREADS 544  // 16 compute warps and the summing warp
#define XL_MXU_WARPS 16
#define XL_MXU_CHUNK 4     // tiles a warp keeps in flight
#define XL_MXU_BATCH 4     // arcs a lane loads before it stores
#define XL_BF16_ONE 0x3F80u

// ---------------------------------------------------------------------
// xl_vpu
// ---------------------------------------------------------------------

// The compute threads' partials double-buffered (2 x threads doubles,
// first: 8-byte aligned), the two scales (4 floats), b double-buffered
// with the zero slot (2 (S + 1) floats), and with no register slots the
// arcs (Kc sources, Kc weights).  Must equal
// pychain_tpu_torch.tools.xl_roofline.vpu_smem_bytes.
extern "C" size_t xl_vpu_smem_bytes(int S, int Kc, int threads, int slots) {
  return 16 * static_cast<size_t>(threads) + 16 +
         8 * (static_cast<size_t>(S) + 1) +
         (slots == 0 ? 8 * static_cast<size_t>(Kc) : 0);
}

// The total of the compute threads' float64 partials as a warp takes it:
// lane l adds the partials of threads l, l + 32, ... in order (issued 8 at
// once, so that the lane waits once for them behind the frame's gathers
// in the shared-memory queue, not once a load), then a butterfly; every
// lane returns the same total.
__device__ __forceinline__ double xl_vpu_total(const double* part,
                                               int nwarps, int lane) {
  double v = 0.0;
  for (int i0 = 0; i0 < nwarps; i0 += 8) {
    double x[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      x[i] = i0 + i < nwarps ? part[lane + 32 * (i0 + i)] : 0.0;
#pragma unroll
    for (int i = 0; i < 8; ++i) v += x[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Adds one arc to the running state; at a state's last in-arc stores
// b[s] = acc * c, adds it to the thread's partial and moves to s + 1.
__device__ __forceinline__ void xl_vpu_arc(int e, float v, float w, float c,
                                           float* b_next, float& acc, int& s,
                                           double& part) {
  acc = __fadd_rn(acc, __fmul_rn(v, w));
  if (e < 0) {
    const float x = __fmul_rn(acc, c);
    b_next[s] = x;
    part += x;
    ++s;
    acc = 0.0f;
  }
}

template <int R>
__global__ void __launch_bounds__(XL_VPU_MAX_THREADS, 1) xl_vpu_kernel(
    const int* __restrict__ arc_src,  // R > 0: (B, R, nt); else (B, Kc)
    const float* __restrict__ arc_w,  // the same shape: the arcs' weights
    const int* __restrict__ tbeg,     // (B, nt + 1) first state a thread
    const int* __restrict__ toff,     // (B, nt + 1) first arc (R = 0)
    int S, int Kc, int T, float init,  // init = float32(1 / S)
    float* __restrict__ out) {        // (B, S) the last carry
  extern __shared__ double smem_d[];
  const int nt = blockDim.x - 32;     // compute threads; the last warp sums
  const int tid = threadIdx.x, lane = tid & 31, nwarps = nt >> 5;
  const bool summer = tid >= nt;
  double* part_buf = smem_d;                      // 2 x nt
  float* c_buf = reinterpret_cast<float*>(part_buf + 2 * nt);  // 2 scales
  float* b_buf = c_buf + 4;                       // 2 (S + 1)
  int* s_src = reinterpret_cast<int*>(b_buf + 2 * (S + 1));  // R = 0: Kc
  float* s_w = reinterpret_cast<float*>(s_src + Kc);
  const int b = blockIdx.x;
  const size_t trow = static_cast<size_t>(b) * (nt + 1);
  const int s_first = summer ? 0 : tbeg[trow + tid];
  constexpr int RR = R > 0 ? R : 1;
  int e[RR];
  float wr[RR];
  int j0 = 0, j1 = 0;
  if constexpr (R > 0) {
    if (!summer) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const size_t i = (static_cast<size_t>(b) * R + r) * nt + tid;
        e[r] = arc_src[i];
        wr[r] = arc_w[i];
      }
    }
  } else {
    for (int i = tid; i < Kc; i += blockDim.x) {
      s_src[i] = arc_src[static_cast<size_t>(b) * Kc + i];
      s_w[i] = arc_w[static_cast<size_t>(b) * Kc + i];
    }
    if (!summer) {
      j0 = toff[trow + tid];
      j1 = toff[trow + tid + 1];
    }
  }
  // b_0 = 1/S (the zero slot b[S] = 0 in both buffers); frame 0's scale 1
  for (int s = tid; s <= S; s += blockDim.x) {
    b_buf[s] = s < S ? init : 0.0f;
    b_buf[S + 1 + s] = 0.0f;
  }
  // b_0's partials: a thread's states times 1/S, exact in float64
  if (!summer)
    part_buf[tid] = static_cast<double>(tbeg[trow + tid + 1] - s_first) *
                    static_cast<double>(init);
  if (tid == 0) c_buf[0] = 1.0f;
  __syncthreads();
  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const float* b_prev = b_buf + cur * (S + 1);
    float* b_next = b_buf + (cur ^ 1) * (S + 1);
    if (summer) {
      // sum b_t, which this frame reads: frame t + 1's scale
      const double v = xl_vpu_total(part_buf + cur * nt, nwarps, lane);
      if (lane == 0)
        c_buf[(t + 1) & 1] = 1.0f / fmaxf(static_cast<float>(v), XL_TINY);
    } else {
      const float c = c_buf[t & 1];
      float acc = 0.0f;
      int s = s_first;
      double part = 0.0;
      if constexpr (R > 0) {
        float v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = b_prev[e[r] & XL_SRC_MASK];
#pragma unroll
        for (int r = 0; r < R; ++r)
          xl_vpu_arc(e[r], v[r], wr[r], c, b_next, acc, s, part);
      } else {
#pragma unroll 4
        for (int j = j0; j < j1; ++j) {
          const int ej = s_src[j];
          xl_vpu_arc(ej, b_prev[ej & XL_SRC_MASK], s_w[j], c, b_next, acc,
                     s, part);
        }
      }
      part_buf[(cur ^ 1) * nt + tid] = part;
    }
    // the frame's one barrier: b_next, its partials and the next scale are
    // complete.  The next frame writes the other b buffer, partial and
    // scale slots, which no thread reads after this barrier.
    __syncthreads();
    cur ^= 1;
  }
  // the carry: b_T / sum b_T, every warp summing as the summing warp does
  const float* b_last = b_buf + cur * (S + 1);
  const float inv =
      T > 0 ? 1.0f / fmaxf(static_cast<float>(xl_vpu_total(
                               part_buf + cur * nt, nwarps, lane)),
                           XL_TINY)
            : 1.0f;
  for (int s = tid; s < S; s += blockDim.x)
    out[static_cast<size_t>(b) * S + s] = __fmul_rn(b_last[s], inv);
}

// slots is 0 or XL_VPU_SLOTS; threads (the compute threads) a multiple
// of 32 with threads + 32 up to XL_VPU_MAX_THREADS.  Returns
// cudaGetLastError() after the launch (0 on success;
// cudaErrorInvalidValue for another slots or threads).
extern "C" int xl_vpu_launch(const void* arc_src, const void* arc_w,
                             const void* tbeg, const void* toff, int B, int S,
                             int Kc, int threads, int slots, int T,
                             float init, void* out, void* stream) {
  if ((slots != 0 && slots != XL_VPU_SLOTS) || threads < 32 ||
      threads % 32 != 0 || threads + 32 > XL_VPU_MAX_THREADS)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = xl_vpu_smem_bytes(S, Kc, threads, slots);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* as = static_cast<const int*>(arc_src);
  const float* aw = static_cast<const float*>(arc_w);
  const int* tb = static_cast<const int*>(tbeg);
  const int* to = static_cast<const int*>(toff);
  float* o = static_cast<float*>(out);
  const int block = threads + 32;
  cudaError_t err = cudaSuccess;
#define XL_VPU_CASE(R)                                                     \
  case R:                                                                  \
    err = fact_set_smem(xl_vpu_kernel<R>, smem);                           \
    if (err == cudaSuccess && B > 0)                                       \
      xl_vpu_kernel<R><<<B, block, smem, st>>>(as, aw, tb, to, S, Kc, T,   \
                                               init, o);                   \
    break;
  switch (slots) {
    XL_VPU_CASE(0)
    XL_VPU_CASE(XL_VPU_SLOTS)
  }
#undef XL_VPU_CASE
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// xl_mxu
// ---------------------------------------------------------------------

// The warps' partials (32 doubles), the tile lists (an int2 for each tile
// of 16: K_pad / 16 of the first product, S_pad / 16 of the second), a
// (S_pad floats), the src-order sources, weights and dst-order positions
// and the dst-order destinations (K_pad each), the first product's asel
// (K_pad floats), the carry's bf16 terms (split x S_pad) and contrib's in
// dst order (split x K_pad).  S_pad and K_pad are multiples of 16, so
// every section starts 8-byte aligned.  Must equal
// pychain_tpu_torch.tools.xl_roofline.mxu_smem_bytes.
extern "C" size_t xl_mxu_smem_bytes(int S_pad, int K_pad, int split) {
  return 8 * 32 + static_cast<size_t>(K_pad) / 2 + S_pad / 2 +
         4 * static_cast<size_t>(S_pad) + 20 * static_cast<size_t>(K_pad) +
         2 * static_cast<size_t>(split) * (S_pad + K_pad);
}

// c += A B for one m16n8k16 fragment, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Two mask entries of a fragment: bf16 1.0 in the low half where hit0,
// in the high half where hit1.
__device__ __forceinline__ uint32_t mask_pair(bool hit0, bool hit1) {
  return (hit0 ? XL_BF16_ONE : 0u) | (hit1 ? (XL_BF16_ONE << 16) : 0u);
}

// The same where at most one of the two is hit, at column r of the pair
// (an arc's one source: r is 0, 1 or neither).
__device__ __forceinline__ uint32_t onehot_pair(int r) {
  return static_cast<unsigned>(r) < 2u ? (XL_BF16_ONE << (16 * r)) : 0u;
}

// x as SPLIT bf16 terms, each the round-to-nearest-even of what the terms
// before it left (exact differences: each rest has at most 24 - 8 i bits).
template <int SPLIT>
__device__ __forceinline__ void split_terms(float x,
                                            __nv_bfloat16 (&h)[SPLIT]) {
#pragma unroll
  for (int i = 0; i < SPLIT; ++i) {
    h[i] = __float2bfloat16_rn(x);
    x = __fsub_rn(x, __bfloat162float(h[i]));
  }
}

// A B fragment's registers for column g: term g of a 16-row slab, the
// bf16 pairs at rows 2 tig, 2 tig + 1 and 2 tig + 8, 2 tig + 9 (columns g
// >= SPLIT: zero).
template <int SPLIT>
__device__ __forceinline__ void b_frag(const __nv_bfloat16* terms, int n,
                                       int col, int g, uint32_t& b0,
                                       uint32_t& b1) {
  // every lane loads (columns past SPLIT read term SPLIT - 1's, a
  // broadcast), then selects: no branch before the mma
  const __nv_bfloat16* v = terms + min(g, SPLIT - 1) * n + col;
  b0 = *reinterpret_cast<const uint32_t*>(v);
  b1 = *reinterpret_cast<const uint32_t*>(v + 8);
  b0 = g < SPLIT ? b0 : 0u;
  b1 = g < SPLIT ? b1 : 0u;
}

// Rows g and g + 8 of a fragment's columns 0 .. SPLIT - 1 added in a fixed
// order, (hi + mid) + lo: lane tig 0 holds columns 0 and 1, lane tig 1
// column 2.  Right in the lanes of tig 0; every lane must call it.
template <int SPLIT>
__device__ __forceinline__ float2 fold_terms(const float (&c)[4]) {
  if (SPLIT == 1) return make_float2(c[0], c[2]);
  const float lo0 = __shfl_down_sync(0xffffffffu, c[0], 1);
  const float lo8 = __shfl_down_sync(0xffffffffu, c[2], 1);
  return make_float2(__fadd_rn(__fadd_rn(c[0], c[1]), lo0),
                     __fadd_rn(__fadd_rn(c[2], c[3]), lo8));
}

// 1 / max(sum of the warps' partials, 1e-30), by a butterfly over 32
// lanes (lanes past the warps add 0).
__device__ __forceinline__ float xl_mxu_inv(const double* red, int nwarps,
                                            int lane) {
  double v = lane < nwarps ? red[lane] : 0.0;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return 1.0f / fmaxf(static_cast<float>(v), XL_TINY);
}

template <int SPLIT>
__global__ void __launch_bounds__(32 * XL_MXU_WARPS, 1) xl_mxu_kernel(
    const int* __restrict__ src_s,   // (B, K_pad) sources in src order, -1 pad
    const float* __restrict__ w_s,   // (B, K_pad) weights in src order, 0 pad
    const int* __restrict__ perm,    // (B, K_pad) dst-order position of each
    const int* __restrict__ dst_d,   // (B, K_pad) dests in dst order, -1 pad
    const int2* __restrict__ tiles1,  // (B, K_pad / 16) first slab, count
    const int2* __restrict__ tiles2,  // (B, S_pad / 16) first slab, count
    int S, int S_pad, int K_pad, int T, float init,
    float* __restrict__ out) {        // (B, S)
  extern __shared__ double smem_d[];
  double* red = smem_d;                           // 32
  int2* s_t1 = reinterpret_cast<int2*>(red + 32);  // K_pad / 16
  int2* s_t2 = s_t1 + K_pad / 16;                 // S_pad / 16
  float* s_a = reinterpret_cast<float*>(s_t2 + S_pad / 16);
  int* s_src = reinterpret_cast<int*>(s_a + S_pad);
  float* s_w = reinterpret_cast<float*>(s_src + K_pad);
  int* s_perm = reinterpret_cast<int*>(s_w + K_pad);
  int* s_dst = s_perm + K_pad;
  float* s_asel = reinterpret_cast<float*>(s_dst + K_pad);
  __nv_bfloat16* nc_t = reinterpret_cast<__nv_bfloat16*>(s_asel + K_pad);
  __nv_bfloat16* ct_t = nc_t + SPLIT * S_pad;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nthreads >> 5;
  const int g = lane >> 2;          // the fragment's group (row / column)
  const int tig = lane & 3;         // the thread in the group
  const size_t row = static_cast<size_t>(b) * K_pad;
  const int n1 = K_pad / 16;        // m-tiles of the first product (arcs)
  const int n2 = S_pad / 16;        // m-tiles of the second (states)
  for (int i = tid; i < K_pad; i += nthreads) {
    s_src[i] = src_s[row + i];
    s_w[i] = w_s[row + i];
    s_perm[i] = perm[row + i];
    s_dst[i] = dst_d[row + i];
  }
  for (int i = tid; i < n1; i += nthreads)
    s_t1[i] = tiles1[static_cast<size_t>(b) * n1 + i];
  for (int i = tid; i < n2; i += nthreads)
    s_t2[i] = tiles2[static_cast<size_t>(b) * n2 + i];
  for (int s = tid; s < S_pad; s += nthreads) s_a[s] = s < S ? init : 0.0f;
  __syncthreads();
  // each warp's contiguous run of tiles in either product, and the
  // state slabs its first-product tiles read (sorted: first to last)
  const int p1_lo = warp * n1 / nwarps, p1_hi = (warp + 1) * n1 / nwarps;
  const int p2_lo = warp * n2 / nwarps, p2_hi = (warp + 1) * n2 / nwarps;
  int q_lo = 0, q_hi = 0;
  if (p1_hi > p1_lo) {
    q_lo = s_t1[p1_lo].x;
    q_hi = s_t1[p1_hi - 1].x + s_t1[p1_hi - 1].y;
  }
  float inv = 1.0f;                 // nc = a * inv; frame 0: a = 1/S
  for (int t = 0; t < T; ++t) {
    if (t > 0) inv = xl_mxu_inv(red, nwarps, lane);
    // -- the carry's terms of the warp's slabs (a warp that shares a slab
    // writes the same values: the intended race of the note above) ---------
    for (int s = 16 * q_lo + lane; s < 16 * q_hi; s += 32) {
      __nv_bfloat16 h[SPLIT];
      split_terms<SPLIT>(__fmul_rn(s_a[s], inv), h);
#pragma unroll
      for (int i = 0; i < SPLIT; ++i) nc_t[i * S_pad + s] = h[i];
    }
    __syncwarp();
    // -- asel^T = ohs^T @ nc^T over the listed fragments (the masks as A,
    // 16 arcs a tile; the carry's terms as B's columns), XL_MXU_CHUNK
    // tiles at once ---------------------------------------------------------
    for (int n0 = p1_lo; n0 < p1_hi; n0 += XL_MXU_CHUNK) {
      int2 tl[XL_MXU_CHUNK];
      int sr[XL_MXU_CHUNK], sr8[XL_MXU_CHUNK];
      float acc[XL_MXU_CHUNK][4];
      int jmin = 1 << 30, jmax = 0;
#pragma unroll
      for (int c = 0; c < XL_MXU_CHUNK; ++c) {
        const bool in = n0 + c < p1_hi;
        tl[c] = in ? s_t1[n0 + c] : make_int2(0, 0);
        sr[c] = in ? s_src[(n0 + c) * 16 + g] : -1;       // this lane's rows
        sr8[c] = in ? s_src[(n0 + c) * 16 + g + 8] : -1;  // (arcs)
        acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.0f;
        jmin = min(jmin, tl[c].y);
        jmax = max(jmax, tl[c].y);
      }
      // each tile's listed fragments (the tiles of a chunk independent):
      // the first jmin of every tile with no branch, the rest behind one
      auto frag1 = [&](int c, int j) {
        const int q = tl[c].x + j;
        uint32_t b0, b1;
        b_frag<SPLIT>(nc_t, S_pad, 16 * q + 2 * tig, g, b0, b1);
        const int r = sr[c] - 16 * q - 2 * tig;    // cols 2 tig + {0,1,8,9}
        const int r8 = sr8[c] - 16 * q - 2 * tig;
        mma_bf16_16816(acc[c], onehot_pair(r), onehot_pair(r8),
                       onehot_pair(r - 8), onehot_pair(r8 - 8), b0, b1);
      };
      for (int j = 0; j < jmin; ++j) {
#pragma unroll
        for (int c = 0; c < XL_MXU_CHUNK; ++c) frag1(c, j);
      }
      for (int j = jmin; j < jmax; ++j) {
#pragma unroll
        for (int c = 0; c < XL_MXU_CHUNK; ++c)
          if (j < tl[c].y) frag1(c, j);
      }
      // asel of arcs 16 n + g and + 8 (rows g, g + 8)
#pragma unroll
      for (int c = 0; c < XL_MXU_CHUNK; ++c) {
        const float2 x = fold_terms<SPLIT>(acc[c]);
        if (n0 + c < p1_hi && tig == 0) {
          s_asel[(n0 + c) * 16 + g] = x.x;
          s_asel[(n0 + c) * 16 + g + 8] = x.y;
        }
      }
    }
    __syncwarp();
    // the warp's arcs: contrib = asel * w, its terms to dst order;
    // XL_MXU_BATCH arcs a lane loaded before any store
    for (int k0 = 16 * p1_lo + lane; k0 < 16 * p1_hi;
         k0 += 32 * XL_MXU_BATCH) {
      float x[XL_MXU_BATCH];
      int d[XL_MXU_BATCH];
#pragma unroll
      for (int u = 0; u < XL_MXU_BATCH; ++u) {
        const int k = k0 + 32 * u;
        d[u] = -1;
        if (k < 16 * p1_hi) {
          x[u] = __fmul_rn(s_asel[k], s_w[k]);
          d[u] = s_perm[k];
        }
      }
#pragma unroll
      for (int u = 0; u < XL_MXU_BATCH; ++u) {
        if (d[u] >= 0) {
          __nv_bfloat16 h[SPLIT];
          split_terms<SPLIT>(x[u], h);
#pragma unroll
          for (int i = 0; i < SPLIT; ++i) ct_t[i * K_pad + d[u]] = h[i];
        }
      }
    }
    __syncthreads();
    // -- a^T = ohd @ contrib^T over the listed fragments (the masks as A,
    // 16 states a tile; contrib's terms as B's columns); a to shared
    // memory and the warp's sum of a, each lane of tig 0 its states in
    // order ------------------------------------------------------------------
    double part = 0.0;
    for (int m0 = p2_lo; m0 < p2_hi; m0 += XL_MXU_CHUNK) {
      int2 tl[XL_MXU_CHUNK];
      float acc[XL_MXU_CHUNK][4];
      int jmin = 1 << 30, jmax = 0;
#pragma unroll
      for (int c = 0; c < XL_MXU_CHUNK; ++c) {
        tl[c] = m0 + c < p2_hi ? s_t2[m0 + c] : make_int2(0, 0);
        acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.0f;
        jmin = min(jmin, tl[c].y);
        jmax = max(jmax, tl[c].y);
      }
      auto frag2 = [&](int c, int j) {       // as the first product's
        const int p = tl[c].x + j;
        uint32_t b0, b1;
        b_frag<SPLIT>(ct_t, K_pad, 16 * p + 2 * tig, g, b0, b1);
        // ohd[state, 16 p + 2 tig + {0,1,8,9}]: the destinations
        const int2 d01 =
            *reinterpret_cast<const int2*>(s_dst + 16 * p + 2 * tig);
        const int2 d89 =
            *reinterpret_cast<const int2*>(s_dst + 16 * p + 8 + 2 * tig);
        const int s = (m0 + c) * 16 + g, s8 = s + 8;  // this lane's rows
        mma_bf16_16816(acc[c], mask_pair(d01.x == s, d01.y == s),
                       mask_pair(d01.x == s8, d01.y == s8),
                       mask_pair(d89.x == s, d89.y == s),
                       mask_pair(d89.x == s8, d89.y == s8), b0, b1);
      };
      for (int j = 0; j < jmin; ++j) {
#pragma unroll
        for (int c = 0; c < XL_MXU_CHUNK; ++c) frag2(c, j);
      }
      for (int j = jmin; j < jmax; ++j) {
#pragma unroll
        for (int c = 0; c < XL_MXU_CHUNK; ++c)
          if (j < tl[c].y) frag2(c, j);
      }
#pragma unroll
      for (int c = 0; c < XL_MXU_CHUNK; ++c) {
        const float2 x = fold_terms<SPLIT>(acc[c]);  // states 16 m + g, + 8
        if (m0 + c < p2_hi && tig == 0) {
          s_a[(m0 + c) * 16 + g] = x.x;
          s_a[(m0 + c) * 16 + g + 8] = x.y;
          part += x.x;
          part += x.y;
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, off);
    if (lane == 0) red[warp] = part;
    // a and the partials are complete; the next frame's first product
    // reads a, its second writes red only after that frame's first barrier
    __syncthreads();
  }
  if (T > 0) inv = xl_mxu_inv(red, nwarps, lane);
  for (int s = tid; s < S; s += nthreads)
    out[static_cast<size_t>(b) * S + s] = __fmul_rn(s_a[s], inv);
}

// split is 3 (parity grade) or 1 (bf16).  Returns cudaGetLastError() after
// the launch (0 on success; cudaErrorInvalidValue for another split).
extern "C" int xl_mxu_launch(const void* src_s, const void* w_s,
                             const void* perm, const void* dst_d,
                             const void* tiles1, const void* tiles2, int B,
                             int S, int S_pad, int K_pad, int T, float init,
                             int split, void* out, void* stream) {
  if (split != 1 && split != 3) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = xl_mxu_smem_bytes(S_pad, K_pad, split);
  cudaError_t err = split == 3 ? fact_set_smem(xl_mxu_kernel<3>, smem)
                               : fact_set_smem(xl_mxu_kernel<1>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* a = static_cast<const int*>(src_s);
  const float* w = static_cast<const float*>(w_s);
  const int* pm = static_cast<const int*>(perm);
  const int* d = static_cast<const int*>(dst_d);
  const int2* t1 = static_cast<const int2*>(tiles1);
  const int2* t2 = static_cast<const int2*>(tiles2);
  float* o = static_cast<float*>(out);
  if (B > 0) {
    if (split == 3)
      xl_mxu_kernel<3><<<B, 32 * XL_MXU_WARPS, smem, st>>>(
          a, w, pm, d, t1, t2, S, S_pad, K_pad, T, init, o);
    else
      xl_mxu_kernel<1><<<B, 32 * XL_MXU_WARPS, smem, st>>>(
          a, w, pm, d, t1, t2, S, S_pad, K_pad, T, init, o);
  }
  return static_cast<int>(cudaGetLastError());
}
