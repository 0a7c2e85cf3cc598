// The 16-row `mma.sync` pieces shared by csrc/flash_decode_sm90.cu (K6)
// and csrc/batched_sm90.cu (K5) on the tensor cores (the m16n8k16 product
// itself is in sm90_mainloop.cuh): the small bf16 helpers, one contiguous
// row by the bulk-copy engine, and the verification of a 16 x 8·NT accumulator fragment per
// warp (frag16_add, frag16_sums) located by one warp (locate16) under the
// report rules of abft_block.cuh, and the stochastic SEU of seu_hook.cuh
// landed in a fragment (frag16_seu). A CTA of kWarps warps holds one 16-row
// block, each warp its own columns. What each kernel does with them is in
// the note at the head of its source.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "seu_hook.cuh"
#include "sm90_mainloop.cuh"

namespace {

constexpr int kBq = 16;                  // rows of one m16n8k16 fragment
constexpr int kWarps = 4;                // warps of a CTA, each its columns

__device__ __forceinline__ float bf(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 into one register, the first in the low half.
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// One contiguous global row into shared memory by the bulk-copy engine,
// completing on bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Adds v at (row, col) of a warp's 16 x 8·NT fragment (n-tile col / 8), in
// the lane that holds it; nothing when col is outside the warp's columns.
template <int NT>
__device__ __forceinline__ void frag16_add(float (&a)[NT][4], int row,
                                           int col, float v, int lane) {
  if (col < 0 || col >= 8 * NT || row < 0 || row >= kBq) return;
  const bool mine = lane == (row & 7) * 4 + ((col & 7) >> 1);
  const int nt = col >> 3, idx = (row >> 3) * 2 + (col & 1);
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[t][r] += (mine && t == nt && r == idx) ? v : 0.0f;
}

// The element at (row, col) of a warp's 16 x 8·NT fragment in the lane that
// holds it, 0 in the others and for a col outside the warp's columns.
template <int NT>
__device__ __forceinline__ float frag16_get(const float (&a)[NT][4], int row,
                                            int col, int lane) {
  if (col < 0 || col >= 8 * NT || row < 0 || row >= kBq) return 0.0f;
  const bool mine = lane == (row & 7) * 4 + ((col & 7) >> 1);
  const int nt = col >> 3, idx = (row >> 3) * 2 + (col & 1);
  float v = 0.0f;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) v = (mine && t == nt && r == idx) ? a[t][r] : v;
  return v;
}

// The stochastic SEU (seu_hook.cuh) at (row, col) of a warp's 16 x 8·NT
// fragment of a step's product: the element d becomes d +
// seu::magnitude(d, shift) in the lane that holds it; nothing for a col
// outside the warp's columns.
template <int NT>
__device__ __forceinline__ void frag16_seu(float (&a)[NT][4], int row, int col,
                                           int shift, int lane) {
  frag16_add<NT>(a, row, col,
                 seu::magnitude(frag16_get<NT>(a, row, col, lane), shift), lane);
}

// The column residuals of a warp's 16 x 8·NT fragment (its columns col0 ..)
// against ck into dcol, and its row sums into rowp[warp].
template <int NT>
__device__ __forceinline__ void frag16_sums(const float (&a)[NT][4],
                                            const float* ck, float* dcol,
                                            float (*rowp)[kBq], int col0,
                                            int warp, int lane) {
  float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float c = a[t][e] + a[t][2 + e];
      c += __shfl_xor_sync(kFull, c, 4);
      c += __shfl_xor_sync(kFull, c, 8);
      c += __shfl_xor_sync(kFull, c, 16);
      if (lane < 4) {
        const int col = col0 + 8 * t + 2 * lane + e;
        dcol[col] = c - ck[col];
      }
      r0 += a[t][e];
      r1 += a[t][2 + e];
    }
  r0 += __shfl_xor_sync(kFull, r0, 1);
  r0 += __shfl_xor_sync(kFull, r0, 2);
  r1 += __shfl_xor_sync(kFull, r1, 1);
  r1 += __shfl_xor_sync(kFull, r1, 2);
  if ((lane & 3) == 0) {
    rowp[warp][lane / 4] = r0;
    rowp[warp][lane / 4 + 8] = r1;
  }
}

// By warp 0: the row residuals (the warps' row sums against rowck, or the
// sum of the warps' partials rowck4), the first argmax of the column and
// row residuals, and abft::record into rep; the verdict into *out.
__device__ __forceinline__ void locate16(const float* dcol, int ncol,
                                         float* drow,
                                         const float (*rowp)[kBq],
                                         const float* rowck,
                                         const float (*rowck4)[kBq],
                                         float tau, float k_el, int corrects,
                                         int col_off, float* rep,
                                         abft::Verdict* out, int lane) {
  if (lane < kBq) {
    float r = 0.0f, c = rowck != nullptr ? rowck[lane] : 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      r += rowp[w][lane];
      if (rowck4 != nullptr) c += rowck4[w][lane];
    }
    drow[lane] = r - c;
  }
  __syncwarp();
  float bc, br;
  int ic, ir;
  abft::warp_argmax_abs(dcol, ncol, bc, ic);
  abft::warp_argmax_abs(drow, kBq, br, ir);
  if (lane == 0)
    *out = abft::record(dcol, bc, ic, br, ir, fmaxf(tau, 1e-30f), k_el,
                        corrects, 0, col_off, rep);
}

}  // namespace
