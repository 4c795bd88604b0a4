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
// as two dot_generals on the matrix unit.  Here:
//
// xl_vpu (CUDA cores).  One block per row runs the whole time loop.  The
// row's arcs live in shared memory in destination order (a CSR the
// wrapper builds with a stable sort by dst: in-arc j of state s is
// ptr[s] <= j < ptr[s+1], ascending arc id), with the carry; a thread
// owns the states s = tid + i * blockDim and sums each one's in-arcs in
// CSR order, each product rounded before it is added (no fused
// multiply-add, as the plain version's index_select * w, index_add_).
// No atomics: the carry is bit-identical from run to run.  One barrier a
// frame: the block keeps the unnormalised a (double-buffered) and the
// scalar inv, and the next frame reads the carry as a[src] * inv, the
// very product the plain version stores.
//
// Both kernels, and the plain versions, sum a in float64 (per thread, a
// warp-shuffle tree, the warp partials in warp order) and round the total
// to float32 once, so that sum a does not depend on the order of the sum.
// It matters for the bf16 form: its sums of a few bf16 values are exact,
// so its carry is bit for bit the plain version's unless sum a differs,
// and a one-ulp difference there, from a float32 sum taken in another
// order, tips a bf16 rounding and grows to a 1.5e-2 relative difference of
// the carry after 512 frames on an H100 (PERF.md).
//
// xl_mxu (tensor cores, mma.sync m16n8k16, bf16 in, f32 accumulate).  One
// block of 16 warps per row.  Both contractions are dense products with the
// {0,1} masks, as on the TPU: asel (1, K) = nc (1, S_pad) @ ohs (S_pad,
// K_pad), then a (1, S_pad) = contrib (1, K_pad) @ ohd^T (K_pad, S_pad),
// contrib = asel * w.  The row operand sits in row 0 of the instruction's
// 16-row A tile; rows 1-15 are zero, so the product uses 1/16 of the
// tensor cores' rows.  That waste is what the probe measures, so it is
// not hidden by packing other rows in (every row has its own masks).
// The masks are exact in bf16.  They are not stored: at the default size
// they are B * 2 * S_pad * K_pad bf16 = 103 MB, 12.9 MB a row read again
// every frame, which one SM cannot pull from memory at the rate its tensor
// cores consume it, and they fit neither registers nor shared memory.
// Each B fragment is made in registers when it is used, from src and dst
// held in shared memory: one integer compare per element against the
// fragment's row or column, which costs less than loading it.
//   split = 3 ("mxu_f32", the parity grade; Hopper has no plain-f32
//     tensor-core mode): each f32 operand (the carry, contrib) is split
//     into bf16 terms hi + mid + lo, each the round-to-nearest-even of what
//     the terms before it left; the three terms hold all 24 bits of a
//     normal float, so with {0,1} masks every product is exact and only
//     the f32 accumulation rounds.  Three mma a fragment, one B fragment.
//   split = 1 ("mxu_bf16", the TPU's DEFAULT precision): the operand is
//     rounded to bf16 (round to nearest even) before each product, one
//     pass, f32 accumulation.
// Three barriers a frame: after the first product (contrib), after the
// second (a and the warps' partial sums), after the carry is normalised
// and split.
//
// Bound on an H100: the function itself needs K gathers and 2K flops a
// frame and row, and reads the ids and weights and writes the carry once:
// at the default size (S = 1000, K = 3200, T = 512, B = 8) 26 MFLOP, under
// a microsecond at 67 TFLOP/s.  The dense tensor-core form does 4 S_pad
// K_pad flops a frame and row (x3 split), 53 GFLOP (160) at the default
// size, 0.053 ms (0.16 ms) at 989 TFLOP/s.  What bounds all three is the
// serial chain: T frames in a row, each with at least one block barrier
// and dependent shared-memory loads; and xl_mxu does its dense products
// on one SM a row, its B fragments built by integer instructions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "fact_common.cuh"

#define XL_TINY 1e-30f
#define XL_VPU_MAX_THREADS 1024
#define XL_MXU_WARPS 16
#define XL_MXU_THREADS (XL_MXU_WARPS * 32)
#define XL_MXU_TILES 8     // n-tiles of 8 a warp keeps in flight
#define XL_BF16_ONE 0x3F80u

// ---------------------------------------------------------------------
// xl_vpu
// ---------------------------------------------------------------------

// The warp partials double-buffered (2 x 32 doubles, first: 8-byte
// aligned), ptr (S + 1) ints, the in-arcs' sources (K) ints and weights (K)
// floats, a double-buffered (2 S floats).  Must equal
// pychain_tpu_torch.tools.xl_roofline.vpu_smem_bytes.
extern "C" size_t xl_vpu_smem_bytes(int S, int K) {
  return 2 * 32 * 8 + 4 * (static_cast<size_t>(S) + 1) +
         8 * static_cast<size_t>(K) + 8 * static_cast<size_t>(S);
}

__global__ void __launch_bounds__(XL_VPU_MAX_THREADS, 1) xl_vpu_kernel(
    const int* __restrict__ ptr,      // (B, S + 1) CSR offsets by dst
    const int* __restrict__ in_src,   // (B, K) source of each in-arc
    const float* __restrict__ in_w,   // (B, K) its weight
    int S, int K, int T, float init,  // init = float32(1 / S)
    float* __restrict__ out) {        // (B, S) the last carry
  extern __shared__ double smem_d[];
  double* red = smem_d;             // 2 x 32 warp partials
  int* s_ptr = reinterpret_cast<int*>(red + 2 * 32);
  int* s_src = s_ptr + S + 1;
  float* s_w = reinterpret_cast<float*>(s_src + K);
  float* a_buf = s_w + K;           // 2 S: a of the frame before, this one
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  for (int i = tid; i <= S; i += nt)
    s_ptr[i] = ptr[static_cast<size_t>(b) * (S + 1) + i];
  for (int i = tid; i < K; i += nt) {
    s_src[i] = in_src[static_cast<size_t>(b) * K + i];
    s_w[i] = in_w[static_cast<size_t>(b) * K + i];
  }
  // frame -1: a = 1/S and inv = 1, so the first carry read is 1/S exactly
  for (int s = tid; s < S; s += nt) a_buf[s] = init;
  float inv = 1.0f;
  int cur = 0;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const float* a_prev = a_buf + cur * S;
    float* a_next = a_buf + (cur ^ 1) * S;
    double part = 0.0;
    for (int s = tid; s < S; s += nt) {
      float acc = 0.0f;
      const int end = s_ptr[s + 1];
      for (int j = s_ptr[s]; j < end; ++j) {
        const float nc = __fmul_rn(a_prev[s_src[j]], inv);
        acc = __fadd_rn(acc, __fmul_rn(nc, s_w[j]));
      }
      a_next[s] = acc;
      part += acc;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_down_sync(0xffffffffu, part, off);
    double* r = red + (t & 1) * 32;
    if (lane == 0) r[warp] = part;
    // the frame's one barrier: a_next and the partials are complete.  The
    // next frame writes the other a buffer and partial slot, which no
    // thread reads after this barrier.
    __syncthreads();
    double raw = 0.0;
    for (int i = 0; i < nwarps; ++i) raw += r[i];
    inv = 1.0f / fmaxf(static_cast<float>(raw), XL_TINY);
    cur ^= 1;
  }
  for (int s = tid; s < S; s += nt)
    out[static_cast<size_t>(b) * S + s] = __fmul_rn(a_buf[cur * S + s], inv);
}

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int xl_vpu_launch(const void* ptr, const void* in_src,
                             const void* in_w, int B, int S, int K, int T,
                             float init, void* out, void* stream) {
  const size_t smem = xl_vpu_smem_bytes(S, K);
  cudaError_t err = fact_set_smem(xl_vpu_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int threads = (S + 31) / 32 * 32;          // a thread per state, whole warps
  threads = threads < 32 ? 32 : threads;
  threads = threads > XL_VPU_MAX_THREADS ? XL_VPU_MAX_THREADS : threads;
  if (B > 0)
    xl_vpu_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ptr), static_cast<const int*>(in_src),
        static_cast<const float*>(in_w), S, K, T, init,
        static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------
// xl_mxu
// ---------------------------------------------------------------------

// src, dst (K_pad ints), w (K_pad floats), a (S_pad floats), the warp
// partials (32 doubles), then the bf16 terms of the carry (split x S_pad)
// and of contrib (split x K_pad).  S_pad and K_pad are multiples of 16, so
// every section starts 64-byte aligned.  Must equal
// pychain_tpu_torch.tools.xl_roofline.mxu_smem_bytes.
extern "C" size_t xl_mxu_smem_bytes(int S_pad, int K_pad, int split) {
  return 4 * (3 * static_cast<size_t>(K_pad) + S_pad) + 32 * 8 +
         2 * static_cast<size_t>(split) * (S_pad + K_pad);
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], uint32_t a0,
                                               uint32_t a2, uint32_t b0,
                                               uint32_t b1) {
  // A's registers 1 and 3 hold rows 8-15: zero here.
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

// Two mask entries of a B fragment: bf16 1.0 in the low half where hit0,
// in the high half where hit1.
__device__ __forceinline__ uint32_t mask_pair(bool hit0, bool hit1) {
  return (hit0 ? XL_BF16_ONE : 0u) | (hit1 ? (XL_BF16_ONE << 16) : 0u);
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

template <int SPLIT>
__global__ void __launch_bounds__(XL_MXU_THREADS, 1) xl_mxu_kernel(
    const int* __restrict__ src,     // (B, K_pad), -1 on padding
    const int* __restrict__ dst,     // (B, K_pad), -1 on padding
    const float* __restrict__ w,     // (K_pad,), 0 on padding
    int S, int S_pad, int K_pad, int T, float init,
    float* __restrict__ out) {       // (B, S)
  extern __shared__ float smem[];
  int* s_src = reinterpret_cast<int*>(smem);
  int* s_dst = s_src + K_pad;
  float* s_w = reinterpret_cast<float*>(s_dst + K_pad);
  float* s_a = s_w + K_pad;
  double* red = reinterpret_cast<double*>(s_a + S_pad);
  __nv_bfloat16* nc_t = reinterpret_cast<__nv_bfloat16*>(red + 32);
  __nv_bfloat16* ct_t = nc_t + SPLIT * S_pad;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2;          // the fragment's group (row / column)
  const int tig = lane & 3;         // the thread in the group
  for (int i = tid; i < K_pad; i += XL_MXU_THREADS) {
    s_src[i] = src[static_cast<size_t>(b) * K_pad + i];
    s_dst[i] = dst[static_cast<size_t>(b) * K_pad + i];
    s_w[i] = w[i];
  }
  for (int s = tid; s < S_pad; s += XL_MXU_THREADS) {
    __nv_bfloat16 h[SPLIT];
    split_terms<SPLIT>(s < S ? init : 0.0f, h);
#pragma unroll
    for (int i = 0; i < SPLIT; ++i) nc_t[i * S_pad + s] = h[i];
  }
  __syncthreads();
  const int n1 = K_pad / 8;         // n-tiles of the first product (arcs)
  const int n2 = S_pad / 8;         // n-tiles of the second (states)
  for (int t = 0; t < T; ++t) {
    // -- asel = nc @ ohs; contrib = asel * w, as bf16 terms ---------------
    for (int base = warp * XL_MXU_TILES; base < n1;
         base += XL_MXU_WARPS * XL_MXU_TILES) {
      float acc[XL_MXU_TILES][4] = {};
      int rs[XL_MXU_TILES];         // src of this lane's column - its rows
#pragma unroll
      for (int j = 0; j < XL_MXU_TILES; ++j)
        rs[j] = base + j < n1 ? s_src[(base + j) * 8 + g] - 2 * tig : -1000;
      for (int s0 = 0; s0 < S_pad; s0 += 16) {
        uint32_t a0[SPLIT], a2[SPLIT];
#pragma unroll
        for (int i = 0; i < SPLIT; ++i) {
          const __nv_bfloat16* v = nc_t + i * S_pad + s0 + 2 * tig;
          a0[i] = g == 0 ? *reinterpret_cast<const uint32_t*>(v) : 0u;
          a2[i] = g == 0 ? *reinterpret_cast<const uint32_t*>(v + 8) : 0u;
        }
#pragma unroll
        for (int j = 0; j < XL_MXU_TILES; ++j) {
          const int r = rs[j] - s0;   // ohs[s0 + 2 tig + {0,1,8,9}, arc]
          const uint32_t b0 = mask_pair(r == 0, r == 1);
          const uint32_t b1 = mask_pair(r == 8, r == 9);
#pragma unroll
          for (int i = 0; i < SPLIT; ++i)
            mma_bf16_16816(acc[j], a0[i], a2[i], b0, b1);
        }
      }
      if (g == 0) {                 // row 0: asel of arcs 8 tile + 2 tig + {0,1}
#pragma unroll
        for (int j = 0; j < XL_MXU_TILES; ++j) {
          if (base + j >= n1) break;
          const int k = (base + j) * 8 + 2 * tig;
          __nv_bfloat16 h0[SPLIT], h1[SPLIT];
          split_terms<SPLIT>(__fmul_rn(acc[j][0], s_w[k]), h0);
          split_terms<SPLIT>(__fmul_rn(acc[j][1], s_w[k + 1]), h1);
#pragma unroll
          for (int i = 0; i < SPLIT; ++i) {
            ct_t[i * K_pad + k] = h0[i];
            ct_t[i * K_pad + k + 1] = h1[i];
          }
        }
      }
    }
    __syncthreads();
    // -- a = contrib @ ohd^T, and the warps' partial sums of a ------------
    double part = 0.0;
    for (int base = warp * XL_MXU_TILES; base < n2;
         base += XL_MXU_WARPS * XL_MXU_TILES) {
      float acc[XL_MXU_TILES][4] = {};
      for (int k0 = 0; k0 < K_pad; k0 += 16) {
        // ohd^T[k0 + 2 tig + {0,1,8,9}, state]: the arcs' destinations
        const int2 d01 = *reinterpret_cast<const int2*>(s_dst + k0 + 2 * tig);
        const int2 d89 =
            *reinterpret_cast<const int2*>(s_dst + k0 + 8 + 2 * tig);
        uint32_t a0[SPLIT], a2[SPLIT];
#pragma unroll
        for (int i = 0; i < SPLIT; ++i) {
          const __nv_bfloat16* v = ct_t + i * K_pad + k0 + 2 * tig;
          a0[i] = g == 0 ? *reinterpret_cast<const uint32_t*>(v) : 0u;
          a2[i] = g == 0 ? *reinterpret_cast<const uint32_t*>(v + 8) : 0u;
        }
#pragma unroll
        for (int j = 0; j < XL_MXU_TILES; ++j) {
          const int s = (base + j) * 8 + g;   // this lane's column
          const uint32_t b0 = mask_pair(d01.x == s, d01.y == s);
          const uint32_t b1 = mask_pair(d89.x == s, d89.y == s);
#pragma unroll
          for (int i = 0; i < SPLIT; ++i)
            mma_bf16_16816(acc[j], a0[i], a2[i], b0, b1);
        }
      }
      if (g == 0) {                 // row 0: a of states 8 tile + 2 tig + {0,1}
#pragma unroll
        for (int j = 0; j < XL_MXU_TILES; ++j) {
          if (base + j >= n2) break;
          const int s = (base + j) * 8 + 2 * tig;
          s_a[s] = acc[j][0];
          s_a[s + 1] = acc[j][1];
          part += acc[j][0];
          part += acc[j][1];
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      part += __shfl_down_sync(0xffffffffu, part, off);
    if (lane == 0) red[warp] = part;
    __syncthreads();
    // -- nc = a * (1 / max(sum a, 1e-30)), as bf16 terms -----------------
    double raw = 0.0;
    for (int i = 0; i < XL_MXU_WARPS; ++i) raw += red[i];
    const float inv = 1.0f / fmaxf(static_cast<float>(raw), XL_TINY);
    for (int s = tid; s < S_pad; s += XL_MXU_THREADS) {
      const float nc = __fmul_rn(s_a[s], inv);
      if (t == T - 1) {
        if (s < S) out[static_cast<size_t>(b) * S + s] = nc;
      } else {
        __nv_bfloat16 h[SPLIT];
        split_terms<SPLIT>(nc, h);
#pragma unroll
        for (int i = 0; i < SPLIT; ++i) nc_t[i * S_pad + s] = h[i];
      }
    }
    __syncthreads();
  }
  if (T == 0)
    for (int s = tid; s < S; s += XL_MXU_THREADS)
      out[static_cast<size_t>(b) * S + s] = init;
}

// split is 3 (parity grade) or 1 (bf16).  Returns cudaGetLastError()
// after the launch (0 on success; cudaErrorInvalidValue for another split).
extern "C" int xl_mxu_launch(const void* src, const void* dst, const void* w,
                             int B, int S, int S_pad, int K_pad, int T,
                             float init, int split, void* out, void* stream) {
  if (split != 1 && split != 3) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = xl_mxu_smem_bytes(S_pad, K_pad, split);
  cudaError_t err = split == 3 ? fact_set_smem(xl_mxu_kernel<3>, smem)
                               : fact_set_smem(xl_mxu_kernel<1>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B > 0) {
    if (split == 3)
      xl_mxu_kernel<3><<<B, XL_MXU_THREADS, smem, st>>>(
          static_cast<const int*>(src), static_cast<const int*>(dst),
          static_cast<const float*>(w), S, S_pad, K_pad, T, init,
          static_cast<float*>(out));
    else
      xl_mxu_kernel<1><<<B, XL_MXU_THREADS, smem, st>>>(
          static_cast<const int*>(src), static_cast<const int*>(dst),
          static_cast<const float*>(w), S, S_pad, K_pad, T, init,
          static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
