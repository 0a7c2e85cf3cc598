// The flash-attention pieces shared by csrc/flash_bwd_sm90.cu (K3, K4)
// and csrc/flash_fwd_sm90.cu (K2) on the tensor cores, bf16 over 64-row
// blocks at head dim 128 (K2 also at 64: the pieces that depend on the
// head dim take it as the template parameter DH, 128 by default): named
// barriers of a consumer warpgroup, the 128-byte-swizzled tiles TMA
// stages and the checksums read from them (col_reduce, row_dot), the hi /
// lo staging of an f32 operand, the wgmma products of the two block
// shapes (mma_abt, mma_ab), and the verification of a 64 x N accumulator
// from its wgmma fragment (verify_frag), and the stochastic SEU of
// seu_hook.cuh landed in a fragment (frag_seu). What each kernel does
// with them is in the note at the head of its source.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "seu_hook.cuh"
#include "sm90_mainloop.cuh"

namespace {

constexpr int kDh = 128;                 // head dim of the instances
constexpr int kB = 64;                   // q and kv block rows
// A 64 x DH bf16 tile: DH / 64 boxes.
template <int DH>
constexpr int kTileBytes = kB * DH * 2;
constexpr int kTile = kTileBytes<kDh>;   // a 64 x 128 bf16 tile: two boxes
constexpr int kHalf = kB * kB * 2;       // a 64 x 64 bf16 tile: one box
constexpr int kNT = 128;                 // threads of a consumer warpgroup
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void wg_sync(int bar) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(bar) : "memory");
}
// Both consumer warpgroups: sync waits for the other's arrival, arrive
// does not wait (each has release / acquire semantics on shared memory).
__device__ __forceinline__ void pair_sync(int bar) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void pair_arrive(int bar) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(bar) : "memory");
}

// Scratch of one fragment verification.
struct FragVerify {
  float colp[4][kDh];     // column sums by consumer warp
  float rowsum[kB];
  float dcol[kDh];        // column residuals (abft::record reads the mag)
  float wbest[6];         // per-warp first argmax: columns 0..3, rows 4..5
  int widx[6];
  Verdict verdict;
};

// ---------------------------------------------------------------------------
// staged tiles
// ---------------------------------------------------------------------------

// A 64 x DH tile (rows row0 .. row0 + 63 of head h) as its 64 x 64 boxes
// (dh 0..63, 64..127), 128-byte swizzled.
template <int DH = kDh>
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          int row0, int h, uint64_t* bar) {
  tma_load_3d(dst, map, 0, row0, h, bar);
  if constexpr (DH == 128) tma_load_3d(dst + kBoxBytes, map, 64, row0, h, bar);
}

// The 8 bf16 of a 16-byte chunk widened exactly to f32 (plain shifts, so
// the compiler schedules them with the loads and FMAs around them).
__device__ __forceinline__ void widen8(const uint4& c, float (&f)[8]) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// The 16-byte chunk of row r holding columns 8q .. 8q + 7.
__device__ __forceinline__ uint4 tile_chunk(const uint8_t* t, int r, int q) {
  return lds128(t + (q >> 3) * kBoxBytes + r * 128 + (((q & 7) ^ (r & 7)) << 4));
}

// Σ_c T[r][c]·w[c] over the NC columns of row r, with T = t (+ t2 when
// given: the hi and lo halves); Σ_c T[r][c] into *sum and max_c |T[r][c]|
// into *mx when given.
template <int NC>
__device__ __forceinline__ float row_dot(const uint8_t* t, const uint8_t* t2,
                                         int r, const float* w, float* sum,
                                         float* mx) {
  float d = 0.0f, s = 0.0f, m = 0.0f;
#pragma unroll
  for (int q = 0; q < NC / 8; ++q) {
    float f[8];
    widen8(tile_chunk(t, r, q), f);
    if (t2 != nullptr) {
      float f2[8];
      widen8(tile_chunk(t2, r, q), f2);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] += f2[e];
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (w != nullptr) d = fmaf(f[e], w[8 * q + e], d);
      s += f[e];
      m = fmaxf(m, fabsf(f[e]));
    }
  }
  if (sum != nullptr) *sum = s;
  if (mx != nullptr) *mx = m;
  return d;
}

// out[c] = Σ_r T[r][c]·w[r] over the 64 rows of a staged tile of NC
// columns (the plain column sum without w), T = t (+ t2: the hi and lo
// halves), by the 128 threads of a consumer warpgroup (named barrier bar,
// tid its own thread index) on 16-byte chunks: thread t sums chunk
// t % (NC / 8) of every (kNT / (NC / 8))-th row, the lanes of a warp that
// share the chunk fold by shuffles, the 4 warps through part[4][NC];
// out[c] is written by thread c after a consumer barrier, so two calls in
// a row take different halves of the partials. This thread's
// max |T| over its chunks into *mx when given.
template <int NC>
__device__ __forceinline__ void col_reduce(const uint8_t* t, const uint8_t* t2,
                                           const float* w, float* out,
                                           float* part, float* mx, int tid,
                                           int bar) {
  constexpr int Q = NC / 8, G = kNT / Q;
  const int q = tid % Q, rg = tid / Q, lane = tid & 31, warp = tid / 32;
  float acc[8], m = 0.0f;
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
#pragma unroll
  for (int i = 0; i < kB / G; ++i) {
    const int r = rg + G * i;
    float f[8];
    widen8(tile_chunk(t, r, q), f);
    if (t2 != nullptr) {
      float f2[8];
      widen8(tile_chunk(t2, r, q), f2);
#pragma unroll
      for (int e = 0; e < 8; ++e) f[e] += f2[e];
    }
    const float wr = w != nullptr ? w[r] : 1.0f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc[e] = fmaf(f[e], wr, acc[e]);
      m = fmaxf(m, fabsf(f[e]));
    }
  }
#pragma unroll
  for (int off = Q; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] += __shfl_xor_sync(kFull, acc[e], off);
  if (lane < Q)
#pragma unroll
    for (int e = 0; e < 8; ++e) part[warp * NC + 8 * q + e] = acc[e];
  if (mx != nullptr) *mx = m;
  wg_sync(bar);
  if (tid < NC)
    out[tid] = part[tid] + part[NC + tid] + part[2 * NC + tid] + part[3 * NC + tid];
}

// x0, x1 at (row i, columns 8j + 2(lane % 4) + {0, 1}) of two swizzled
// 64 x 64 tiles: hi = bf16(x), lo = bf16(x - hi). With KEEP returns hi +
// lo, the values as staged.
template <bool KEEP = false>
__device__ __forceinline__ float2 store_hilo(uint8_t* hi, uint8_t* lo, int i,
                                             int j, int lane, float x0,
                                             float x1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  const int off = i * 128 + ((j ^ (i & 7)) << 4) + 4 * (lane & 3);
  *reinterpret_cast<__nv_bfloat162*>(hi + off) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo + off) = l;
  if constexpr (KEEP) {
    const float2 lf = __bfloat1622float2(l);
    return make_float2(hf.x + lf.x, hf.y + lf.y);
  }
  return make_float2(0.0f, 0.0f);
}

// ---------------------------------------------------------------------------
// products
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void fence_frag(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x 64) += A·Bᵀ over dh: A and B staged 64 x DH tiles, both read
// K-major (S = Q·Kᵀ, dP = g·Vᵀ).
template <int DH = kDh>
__device__ __forceinline__ void mma_abt(float (&d)[32], const uint8_t* a,
                                        const uint8_t* b) {
  const uint32_t sa = smem_u32(a), sb = smem_u32(b);
#pragma unroll
  for (int kk = 0; kk < DH / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kBoxBytes + (kk & 3) * 32;
    wgmma_m64n64k16<0, 0>(d, make_desc(sa + off, 16), make_desc(sb + off, 16));
  }
}

// D(64 x DH) += A·B over 64: A a staged 64 x 64 tile read K-major (TA 0:
// dS in dS·K) or M-major (TA 1: Pᵀ, dSᵀ), B a staged 64 x DH tile whose
// rows are the k dim, read N-major (at DH 64 one 64-column swizzle atom,
// so the descriptor's atom stride is not read).
template <int TA, int DH = kDh>
__device__ __forceinline__ void mma_ab(float (&d)[DH / 2], const uint8_t* a,
                                       const uint8_t* b) {
  const uint32_t sa = smem_u32(a), sb = smem_u32(b);
#pragma unroll
  for (int kk = 0; kk < kB / 16; ++kk) {
    const uint64_t da = TA ? make_desc(sa + kk * 2048, kBoxBytes)
                           : make_desc(sa + kk * 32, 16);
    if constexpr (DH == 128)
      wgmma_m64n128k16<TA, 1>(d, da, make_desc(sb + kk * 2048, kBoxBytes));
    else
      wgmma_m64n64k16<TA, 1>(d, da, make_desc(sb + kk * 2048, kBoxBytes));
  }
}

// ---------------------------------------------------------------------------
// verification of a 64 x N accumulator held by one warpgroup
// ---------------------------------------------------------------------------

// Adds v at (row, col) of the 64 x N fragment, in the thread that holds it
// (branchless; v through a volatile move, as add_at does).
template <int N>
__device__ __forceinline__ void frag_add(float (&acc)[N / 2], int row, int col,
                                         float v_in, int tid) {
  float v;
  asm volatile("mov.b32 %0, %1;\n" : "=f"(v) : "f"(v_in));
  const int wl = tid / 32, lane = tid & 31, rr = row & 15;
  const bool mine = (row >> 4) == wl && lane == (rr & 7) * 4 + (col & 7) / 2;
  const int idx = (col >> 3) * 4 + (rr >> 3) * 2 + (col & 1);
#pragma unroll
  for (int r = 0; r < N / 2; ++r) acc[r] += (mine && r == idx) ? v : 0.0f;
}

// The element at (row, col) of the 64 x N fragment in the thread that
// holds it, 0 in the others.
template <int N>
__device__ __forceinline__ float frag_get(const float (&acc)[N / 2], int row,
                                          int col, int tid) {
  const int wl = tid / 32, lane = tid & 31, rr = row & 15;
  const bool mine = (row >> 4) == wl && lane == (rr & 7) * 4 + (col & 7) / 2;
  const int idx = (col >> 3) * 4 + (rr >> 3) * 2 + (col & 1);
  float v = 0.0f;
#pragma unroll
  for (int r = 0; r < N / 2; ++r) v = (mine && r == idx) ? acc[r] : v;
  return v;
}

// The stochastic SEU at (row, col) of a step's 64 x N product: the element
// d becomes d + seu::magnitude(d, shift), in the thread that holds it.
template <int N>
__device__ __forceinline__ void frag_seu(float (&acc)[N / 2], int row, int col,
                                         int shift, int tid) {
  frag_add<N>(acc, row, col,
              seu::magnitude(frag_get<N>(acc, row, col, tid), shift), tid);
}

// Max over a consumer warpgroup of a and b; every thread gets both.
__device__ __forceinline__ float2 wg_max2(float a, float b, float (*red)[4],
                                          int tid, int bar) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a = fmaxf(a, __shfl_xor_sync(kFull, a, off));
    b = fmaxf(b, __shfl_xor_sync(kFull, b, off));
  }
  if ((tid & 31) == 0) {
    red[0][tid / 32] = a;
    red[1][tid / 32] = b;
  }
  wg_sync(bar);
  const float2 r =
      make_float2(fmaxf(fmaxf(red[0][0], red[0][1]), fmaxf(red[0][2], red[0][3])),
                  fmaxf(fmaxf(red[1][0], red[1][1]), fmaxf(red[1][2], red[1][3])));
  wg_sync(bar);
  return r;
}

// Verify the 64 x N accumulator of a warpgroup against colck[N] and
// rowck[64]: residuals from the fragment's column sums (a transposing
// reduction over the rows of each warp, then the 4 warps) and row sums
// (over the 4 lanes of a row), the first argmax of each (per warp, then
// across warps in index order), the report update of abft::record into
// rep by thread 0, and the correction by the thread that holds (row,
// col). Returns the verdict.
template <int N>
__device__ __forceinline__ Verdict verify_frag(float (&acc)[N / 2],
                                               const float* colck,
                                               const float* rowck, float tau,
                                               float k_el, int corrects,
                                               int row_off, int col_off,
                                               FragVerify& sc, float* rep,
                                               int tid, int bar) {
  const int warp = tid / 32, lane = tid & 31;
  float cs[N / 4];
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      cs[2 * j + e] = acc[4 * j + e] + acc[4 * j + 2 + e];
  const int base = xreduce<N / 4, 8, 4>(cs, lane);
#pragma unroll
  for (int q = 0; q < N / 32; ++q) {
    const int ci = base + q;
    sc.colp[warp][8 * (ci / 2) + 2 * (lane & 3) + (ci & 1)] = cs[q];
  }
  float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      r0 += acc[4 * j + e];
      r1 += acc[4 * j + 2 + e];
    }
  r0 += __shfl_xor_sync(kFull, r0, 1);
  r0 += __shfl_xor_sync(kFull, r0, 2);
  r1 += __shfl_xor_sync(kFull, r1, 1);
  r1 += __shfl_xor_sync(kFull, r1, 2);
  if ((lane & 3) == 0) {
    const int m = warp * 16 + lane / 4;
    sc.rowsum[m] = r0;
    sc.rowsum[m + 8] = r1;
  }
  wg_sync(bar);
  // Columns: thread c; rows: threads [0, 64) at N 128, [64, 128) at N 64.
  const int c = tid, r = N == 128 ? tid : tid - kB;
  float best;
  int idx;
  if (c < N) {
    const float d =
        sc.colp[0][c] + sc.colp[1][c] + sc.colp[2][c] + sc.colp[3][c] - colck[c];
    sc.dcol[c] = d;
    warp_argmax(d, c, best, idx);
    if (lane == 0) {
      sc.wbest[warp] = best;
      sc.widx[warp] = idx;
    }
  }
  if (r >= 0 && r < kB) {
    warp_argmax(sc.rowsum[r] - rowck[r], r, best, idx);
    if (lane == 0) {
      sc.wbest[4 + r / 32] = best;
      sc.widx[4 + r / 32] = idx;
    }
  }
  wg_sync(bar);
  if (tid == 0) {
    float bc = sc.wbest[0], br = sc.wbest[4];
    int ic = sc.widx[0], ir = sc.widx[4];
    for (int w = 1; w < N / 32; ++w)
      if (sc.wbest[w] > bc) {
        bc = sc.wbest[w];
        ic = sc.widx[w];
      }
    if (sc.wbest[5] > br) {
      br = sc.wbest[5];
      ir = sc.widx[5];
    }
    sc.verdict = abft::record(sc.dcol, bc, ic, br, ir, fmaxf(tau, 1e-30f),
                              k_el, corrects, row_off, col_off, rep);
  }
  wg_sync(bar);
  const Verdict v = sc.verdict;
  if (corrects && v.det) frag_add<N>(acc, v.row, v.col, -v.mag, tid);
  return v;
}

// A 64 x 64 fragment into two swizzled tiles as its hi / lo halves; with
// KEEP each element of x becomes hi + lo, the operand the tensor cores
// consume.
template <bool KEEP = false>
__device__ __forceinline__ void store_frag_hilo(float (&x)[32], uint8_t* hi,
                                                uint8_t* lo, int tid) {
  const int lane = tid & 31, i0 = (tid / 32) * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int idx = 4 * j + 2 * hf;
      const float2 st = store_hilo<KEEP>(hi, lo, i0 + 8 * hf, j, lane,
                                         x[idx], x[idx + 1]);
      if constexpr (KEEP) {
        x[idx] = st.x;
        x[idx + 1] = st.y;
      }
    }
}

}  // namespace
