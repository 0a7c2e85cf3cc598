// Block-level ABFT helpers shared by the kernels of csrc/: warp and block
// reductions, first-argmax location, and the verification step that turns
// checksum residuals into a verdict and a report update.
//
// All helpers are called by every thread of a 256-thread block (they use
// __syncthreads()).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace abft {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// Max over the whole block; every thread gets the result.
__device__ inline float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < kWarps; ++w) r = fmaxf(r, red[w]);
  __syncthreads();
  return r;
}

// out[r] = sum_c x[r * stride + c] for r < rows, one warp per row. No
// barrier: the caller synchronises before reading out.
__device__ inline void row_sums(const float* x, int rows, int cols,
                                int stride, float* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    float s = 0.0f;
    for (int c = lane; c < cols; c += 32) s += x[r * stride + c];
    s = warp_sum(s);
    if (lane == 0) out[r] = s;
  }
}

// out[c] = sum_r x[r * stride + c] for c < COLS, with part[] holding
// kThreads partial sums. Ends with a barrier.
template <int COLS>
__device__ void col_sums(const float* x, int rows, int stride, float* part,
                         float* out) {
  static_assert(kThreads % COLS == 0, "COLS must divide the block");
  constexpr int P = kThreads / COLS;
  const int c = threadIdx.x % COLS, p = threadIdx.x / COLS;
  float s = 0.0f;
  for (int r = p; r < rows; r += P) s += x[r * stride + c];
  part[p * COLS + c] = s;
  __syncthreads();
  if (threadIdx.x < COLS) {
    float t = 0.0f;
    for (int q = 0; q < P; ++q) t += part[q * COLS + threadIdx.x];
    out[threadIdx.x] = t;
  }
  __syncthreads();
}

// First argmax of |x[0..n)| by one warp (ties go to the lower index, like
// jnp.argmax); lane 0 ends with (best, idx).
__device__ inline void warp_argmax_abs(const float* x, int n, float& best,
                                       int& idx) {
  const int lane = threadIdx.x & 31;
  best = -1.0f;
  idx = 0;
  for (int i = lane; i < n; i += 32) {
    const float v = fabsf(x[i]);
    if (v > best) { best = v; idx = i; }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_down_sync(kFull, best, off);
    const int oi = __shfl_down_sync(kFull, idx, off);
    if (ob > best || (ob == best && oi < idx)) { best = ob; idx = oi; }
  }
}

struct Verdict {
  int det, row, col;   // row/col local to the verified block
  float mag;
};

// The verdict of one verified block from its located residuals (the first
// argmax `col` of the column residual dcol, of value best_c, and `row` of
// the row residual, best_r) and the report update of the reference's
// _record, by one thread. rep[8] = [det, corr, row, col, mag,
// max_residual, tau, k]: det and corr add, row / col / mag are overwritten
// on a detection (the position reported at (row + row_off, col +
// col_off)), max_residual takes the max, tau and k are overwritten. The
// one report rule of every kernel.
__device__ inline Verdict record(const float* dcol, float best_c, int col,
                                 float best_r, int row, float tau,
                                 float k_el, bool corrects, int row_off,
                                 int col_off, float* rep) {
  const float resid = fmaxf(best_c, best_r);
  Verdict v;
  v.det = resid > tau;
  v.col = col;
  v.row = row;
  v.mag = v.det ? dcol[col] : 0.0f;
  rep[0] += v.det ? 1.0f : 0.0f;
  rep[1] += (v.det && corrects) ? 1.0f : 0.0f;
  if (v.det) {
    rep[2] = (float)(v.row + row_off);
    rep[3] = (float)(v.col + col_off);
    rep[4] = v.mag;
  }
  rep[5] = fmaxf(rep[5], resid);
  rep[6] = tau;
  rep[7] = k_el;
  return v;
}

// Merge the report r of a later piece of one block's walk (a range of the
// flash dK/dV walk, or one verification's own record) into rep: det and
// corr add, row / col / mag come from r when it detected (its last
// detection), max_residual takes the max, and tau and k come from r when
// it ran a verification (k >= 1 in every record that did). Merging the
// records of a walk's pieces in walk order gives the report of the whole
// walk.
__device__ inline void merge(float* rep, const float* r) {
  rep[0] += r[0];
  rep[1] += r[1];
  if (r[0] > 0.0f) {
    rep[2] = r[2];
    rep[3] = r[3];
    rep[4] = r[4];
  }
  rep[5] = fmaxf(rep[5], r[5]);
  if (r[7] > 0.0f) {
    rep[6] = r[6];
    rep[7] = r[7];
  }
}

// Scratch of one verification; MAXR/MAXC bound the verified block.
template <int MAXR, int MAXC>
struct VerifySmem {
  float dcol[MAXC];
  float drow[MAXR];
  float part[kThreads];
  float best[2];
  int idx[2];
  Verdict v;
};

// Verify a rows x COLS block held in c (row stride `stride`, rows <= MAXR
// at run time) against its checksums: residuals, first-argmax locate,
// detection (max residual > tau) and the report update (`record`), which
// thread 0 keeps in rep[8]. Every thread returns the verdict; the caller
// applies the correction.
template <int COLS, int MAXR, int MAXC>
__device__ Verdict verify_rows(const float* c, int rows, int stride,
                               const float* colck, const float* rowck,
                               float tau, float k_el, bool corrects,
                               int row_off, int col_off,
                               VerifySmem<MAXR, MAXC>& sm, float* rep) {
  static_assert(COLS <= MAXC, "");
  col_sums<COLS>(c, rows, stride, sm.part, sm.dcol);
  row_sums(c, rows, COLS, stride, sm.drow);
  __syncthreads();
  for (int i = threadIdx.x; i < COLS; i += kThreads) sm.dcol[i] -= colck[i];
  for (int i = threadIdx.x; i < rows; i += kThreads) sm.drow[i] -= rowck[i];
  __syncthreads();
  const int warp = threadIdx.x / 32;
  if (warp < 2) {
    float best;
    int idx;
    warp_argmax_abs(warp == 0 ? sm.dcol : sm.drow, warp == 0 ? COLS : rows,
                    best, idx);
    if ((threadIdx.x & 31) == 0) {
      sm.best[warp] = best;
      sm.idx[warp] = idx;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0)
    sm.v = record(sm.dcol, sm.best[0], sm.idx[0], sm.best[1], sm.idx[1], tau,
                  k_el, corrects, row_off, col_off, rep);
  __syncthreads();
  return sm.v;
}

// verify_rows for a block whose row count ROWS is known at compile time.
template <int ROWS, int COLS, int MAXR, int MAXC>
__device__ Verdict verify_block(const float* c, int stride,
                                const float* colck, const float* rowck,
                                float tau, float k_el, bool corrects,
                                int row_off, int col_off,
                                VerifySmem<MAXR, MAXC>& sm, float* rep) {
  static_assert(ROWS <= MAXR, "");
  return verify_rows<COLS>(c, ROWS, stride, colck, rowck, tau, k_el,
                           corrects, row_off, col_off, sm, rep);
}

// Scratch of one band-wise verification: NB bands of BAND rows x COLS.
template <int NB, int BAND, int COLS>
struct BandSmem {
  float dcol[NB][COLS];
  float drow[NB * BAND];
  float best[NB][2];
  int idx[NB][2];
  Verdict v[NB];
};

// Verify an (NB·BAND) x COLS block held in c (row stride `stride`) band by
// band: band t, rows [t·BAND, (t+1)·BAND), against its own column checksum
// colck[t·COLS ..] and the row checksums rowck of its rows. One warp
// locates each band (first argmax of its column and of its row residuals);
// thread 0 then records the bands in order with `record`, so det and corr
// add over the bands and row / col / mag are the last detecting band's.
// Every thread finds the NB verdicts (rows local to the block) in sm.v;
// the caller applies the corrections, one per band.
template <int NB, int BAND, int COLS>
__device__ void verify_bands(const float* c, int stride, const float* colck,
                             const float* rowck, float tau, float k_el,
                             bool corrects, int row_off, int col_off,
                             BandSmem<NB, BAND, COLS>& sm, float* rep) {
  for (int i = threadIdx.x; i < NB * COLS; i += kThreads) {
    const int t = i / COLS, col = i % COLS;
    float s = 0.0f;
    for (int r = 0; r < BAND; ++r) s += c[(t * BAND + r) * stride + col];
    sm.dcol[t][col] = s - colck[i];
  }
  row_sums(c, NB * BAND, COLS, stride, sm.drow);
  __syncthreads();
  for (int i = threadIdx.x; i < NB * BAND; i += kThreads) sm.drow[i] -= rowck[i];
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  for (int t = warp; t < NB; t += kWarps) {
    float bc, br;
    int ic, ir;
    warp_argmax_abs(sm.dcol[t], COLS, bc, ic);
    warp_argmax_abs(sm.drow + t * BAND, BAND, br, ir);
    if (lane == 0) {
      sm.best[t][0] = bc;
      sm.idx[t][0] = ic;
      sm.best[t][1] = br;
      sm.idx[t][1] = t * BAND + ir;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int t = 0; t < NB; ++t)
      sm.v[t] = record(sm.dcol[t], sm.best[t][0], sm.idx[t][0],
                       sm.best[t][1], sm.idx[t][1], tau, k_el, corrects,
                       row_off, col_off, rep);
  __syncthreads();
}

}  // namespace abft
