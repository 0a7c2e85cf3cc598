// Grouped transpose ABFT GEMM for Hopper (sm_90a), the MoE backward dw:
// dw[g] = X_g^T · G_g over two group-sorted buffers of one layout, output
// (G, K, N) in f32, with online Huang–Abraham checksums per group.
//
// Replaces the TPU kernel K8 of the JAX package:
//   src/repro/kernels/templates/emit.py:527 render_tgmm, launched by
//   templates/registry.py:411 tgmm_kernel_call.
// The TPU grid walks the buffer's row tiles in order and flushes its
// resident dw block when the tile's group changes. Here CTAs run in no
// order, so one CTA owns one (group, k-block, n-block) output block and
// loops over its group's row tiles itself:
//   * the group's tiles run from its aligned base (row_end[g-1] rounded up
//     to BM) to its aligned end, and for the last group on to the end of the
//     buffer (the layout clamps dead tiles to the last group, and the
//     reference verifies them too); an empty group's CTA writes its dw
//     block and its report as zeros (no row was routed to it);
//   * rows at or past row_end[g] are masked in X and G, so the checksums,
//     max|X| and max|G| are the group's; each tile stages X (BM x 64) and
//     G (BM x 64) in shared memory, each thread accumulates a 4 x 4
//     micro-tile of the 64 x 64 block in f32 registers;
//   * the running checksums ride the staged tiles: the column checksum
//     (X e_K)^T G and the row checksum X^T (G e_N), both from the operands;
//   * tau = rel_tau·eps32·rows·max|X|·max|G| with rows the live rows reduced
//     so far; verify="step" verifies after every tile, "final" after the
//     group's last; first-argmax location and branchless correction are
//     the shared ones of abft_block.cuh;
//   * once only dead tiles remain and no SEU is aimed at them, the block no
//     longer changes unless a verification corrects it: the remaining
//     verifications are run until one leaves the block as it is, and the
//     rest repeat its verdict, which is added to the report at once;
//   * LEVEL, the paper's threadblock / warp / thread granularities
//     (reference emit.py:658-711), a compile-time parameter:
//     0 block: the scheme above;
//     1 tile (warp level): one running column checksum per band of dw's K
//       rows, the 8 rows one warp owns in the thread layout (the reference
//       bands bk by its 128-row MXU edge), beside the row checksum of every
//       dw row; each band is verified, located and corrected on its own
//       (verify_bands), so one SEU per band per interval is corrected; the
//       group's final verification runs band by band too;
//     2 inner (thread level): each row tile's contribution Δ = X_tᵀ·G_t is
//       accumulated in a second register tile, verified alone against the
//       tile's own checksums, corrected in Δ and then added to the block;
//       no running checksums and no final verification. A dead tile's Δ is
//       zero and its verdict repeats the last live tile's record, so the
//       walk stops at the last live tile unless an SEU is aimed past it.
//     tau takes the live rows reduced so far and the running max|X|, max|G|
//     at every level.
// What bounds it on the H100: operations (2·T·K·N), with dw's f32 write
// second. This first version runs on the CUDA cores in f32 with a small
// block per CTA; PERF.md carries its times.
//
// Stochastic SEU campaigns (seu_hook.cuh): each CTA draws its dw block's
// SEU, uid (group·gk + k-block)·gn + n-block, over the group's row tiles
// that hold a live row (the reference's group-local tile step) and the
// 64 x 64 block; on the drawn tile the owning thread takes the tile's own
// product at the element from the staged X and G rows and adds the
// magnitude before the tile's verification.
//
// Report per (group, k-block, n-block), f32[8]: [detected, corrected, row,
// col, magnitude, max_residual, tau, rows_reduced], rows and cols in dw's
// (K, N) coordinates.
#include "abft_block.cuh"
#include "seu_hook.cuh"

namespace {

using namespace abft;

constexpr int kBK = 64, kBN = 64, kTM = 4, kTN = 4;

enum Level { kLevelBlock = 0, kLevelTile = 1, kLevelInner = 2 };

struct TgmmArgs {
  const void* x;           // (T, K), strides (sxr, sxk)
  const void* g;           // (T, N), strides (sgr, sgn)
  const int* row_end;      // (G,) first dead buffer row of each group
  float* out;              // (G, K, N) contiguous
  float* rep;              // (G, gk, gn, 8) contiguous
  int T, K, N, G, t_tiles;
  int sxr, sxk, sgr, sgn;
  int gk, gn;
  int verify_step, corrects;
  float tau_coef;          // rel_tau * eps32
  int inj_enable, inj_row, inj_col, inj_k;
  float inj_mag;
  seu::Args seu;           // the stochastic hook's campaign
};

template <typename T, bool FT, int BM, int LEVEL>
__global__ void __launch_bounds__(kThreads) tgmm_kernel(const TgmmArgs a) {
  constexpr int TX = kBN / kTN, TY = kBK / kTM;
  static_assert(TX * TY == kThreads, "thread tile must cover the block");
  constexpr bool TILE = FT && LEVEL == kLevelTile;
  constexpr bool INNER = FT && LEVEL == kLevelInner;
  // tile: NB bands of BAND dw rows, band t owned by warp t.
  constexpr int NB = TILE ? kWarps : 1;
  constexpr int BAND = TILE ? kBK / kWarps : 1;
  static_assert(!TILE || (32 % TX == 0 && BAND == (32 / TX) * kTM),
                "a tile-level band is the dw rows one warp owns");

  __shared__ float Xs[BM][kBK + 1];
  __shared__ float Gs[BM][kBN];
  __shared__ float Cs[kBK][kBN + 1];
  __shared__ float colck[kBN], rowck[kBK], xsum[BM], gsum[BM], red[kWarps];
  __shared__ VerifySmem<kBK, kBN> vs;
  // tile: each band's running column checksum and X e over its K rows.
  __shared__ float colck_t[NB][TILE ? kBN : 1], xsum_t[BM][TILE ? NB : 1];
  __shared__ BandSmem<NB, BAND, TILE ? kBN : 1> bs;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int ni = blockIdx.x, ki = blockIdx.y, grp = blockIdx.z;
  const int k0 = ki * kBK, n0 = ni * kBN;
  const int prev = grp > 0 ? a.row_end[grp - 1] : 0;
  const int base = (prev + BM - 1) / BM * BM;
  const int row_hi = a.row_end[grp];
  if (row_hi <= base) {                       // empty group: zeros
    float* out = a.out + (long long)grp * a.K * a.N;
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int gk = k0 + idx / kBN, gc = n0 + idx % kBN;
      if (gk < a.K && gc < a.N) out[(long long)gk * a.N + gc] = 0.0f;
    }
    if (FT && tid < 8)
      a.rep[(((long long)grp * a.gk + ki) * a.gn + ni) * 8 + tid] = 0.0f;
    return;
  }
  const int t_first = base / BM;
  const int t_live = (row_hi + BM - 1) / BM;  // tiles holding a live row
  const int t_end = grp == a.G - 1 ? a.t_tiles : t_live;
  const T* X = static_cast<const T*>(a.x);
  const T* Gm = static_cast<const T*>(a.g);
  const seu::Hit sh =
      FT ? seu::draw(a.seu, (uint32_t)(((long long)grp * a.gk + ki) * a.gn + ni),
                     t_live - t_first, kBK, kBN)
         : seu::Hit{false, 0, 0, 0};
  const bool inj_block = FT && a.inj_enable && a.inj_row >= k0 &&
                         a.inj_row < k0 + kBK && a.inj_col >= n0 &&
                         a.inj_col < n0 + kBN;

  float acc[kTM][kTN];
  float dlt[kTM][kTN];   // inner: this row tile's Δ
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  float amax = 0.0f, gmax = 0.0f;
  float rep[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (FT) {
    for (int i = tid; i < kBN; i += kThreads) colck[i] = 0.0f;
    for (int i = tid; i < kBK; i += kThreads) rowck[i] = 0.0f;
  }
  if constexpr (TILE)
    for (int i = tid; i < NB * kBN; i += kThreads)
      colck_t[i / kBN][i % kBN] = 0.0f;

  // One verification (all threads) of the block x: the accumulator, or Δ
  // at the inner level; applies the corrections and returns the number of
  // detections (over the bands at the tile level).
  auto verify = [&](int t, float (&x)[kTM][kTN]) -> int {
    const float rows = (float)max(min((t + 1) * BM, row_hi) - base, 1);
    const float am = block_max(amax, red), gm = block_max(gmax, red);
    const float tau = fmaxf(a.tau_coef * rows * am * gm, 1e-30f);
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) Cs[ty * kTM + i][tx * kTN + j] = x[i][j];
    __syncthreads();
    if constexpr (TILE) {
      verify_bands<NB, BAND, kBN>(&Cs[0][0], kBN + 1, &colck_t[0][0], rowck,
                                  tau, rows, a.corrects, k0, n0, bs, rep);
      int det = 0;
      for (int b = 0; b < NB; ++b) {
        const Verdict v = bs.v[b];
        det += v.det;
        if (a.corrects && v.det && v.row / kTM == ty && v.col / kTN == tx)
          x[v.row % kTM][v.col % kTN] -= v.mag;
      }
      return det;
    } else {
      const Verdict v = verify_block<kBK, kBN>(&Cs[0][0], kBN + 1, colck,
                                               rowck, tau, rows, a.corrects,
                                               k0, n0, vs, rep);
      if (a.corrects && v.det && v.row / kTM == ty && v.col / kTN == tx)
        x[v.row % kTM][v.col % kTN] -= v.mag;
      return v.det;
    }
  };

  for (int t = t_first; t < t_end; ++t) {
    const bool live = t < t_live;
    if (!live) {
      if (!FT) break;
      if (!(inj_block && a.inj_k >= t && a.inj_k < t_end)) {
        // Only dead tiles remain and no SEU comes. Inner: their Δ is zero
        // and each verdict repeats the last live tile's record. Block and
        // tile: verifications change the block only by correcting it; once
        // one leaves it as it is, the remaining ones repeat its verdict.
        if (INNER) break;
        const int nv = a.verify_step ? t_end - t : 1;
        for (int q = 0; q < nv; ++q) {
          const int det = verify(t_end - 1, acc);
          if (!(det && a.corrects)) {
            if (tid == 0) rep[0] += (float)(det * (nv - 1 - q));
            break;
          }
        }
        break;
      }
    }
    const int r0 = t * BM;
    if constexpr (INNER) {
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) dlt[i][j] = 0.0f;
      if (!live) {   // a dead tile's own checksums are zero
        __syncthreads();
        for (int i = tid; i < kBN; i += kThreads) colck[i] = 0.0f;
        for (int i = tid; i < kBK; i += kThreads) rowck[i] = 0.0f;
      }
    }
    if (live) {
      __syncthreads();
      for (int idx = tid; idx < BM * kBK; idx += kThreads) {
        const int r = idx / kBK, kk = idx % kBK;
        const int gr = r0 + r, gk = k0 + kk;
        const float v = (gr < row_hi && gk < a.K)
            ? to_f32(X[(long long)gr * a.sxr + (long long)gk * a.sxk]) : 0.0f;
        Xs[r][kk] = v;
        if (FT) amax = fmaxf(amax, fabsf(v));
      }
      for (int idx = tid; idx < BM * kBN; idx += kThreads) {
        const int r = idx / kBN, nn = idx % kBN;
        const int gr = r0 + r, gc = n0 + nn;
        const float v = (gr < row_hi && gc < a.N)
            ? to_f32(Gm[(long long)gr * a.sgr + (long long)gc * a.sgn]) : 0.0f;
        Gs[r][nn] = v;
        if (FT) gmax = fmaxf(gmax, fabsf(v));
      }
      __syncthreads();
      if constexpr (TILE) {
        // X e over each band's K rows
        for (int i = tid; i < BM * NB; i += kThreads) {
          const int r = i / NB, b = i % NB;
          float c = 0.0f;
          for (int q = 0; q < BAND; ++q) c += Xs[r][b * BAND + q];
          xsum_t[r][b] = c;
        }
        row_sums(&Gs[0][0], BM, kBN, kBN, gsum);       // G e_N
      } else if (FT) {
        row_sums(&Xs[0][0], BM, kBK, kBK + 1, xsum);   // X e_K
        row_sums(&Gs[0][0], BM, kBN, kBN, gsum);       // G e_N
      }
#pragma unroll 4
      for (int r = 0; r < BM; ++r) {
        float xv[kTM], gv[kTN];
#pragma unroll
        for (int i = 0; i < kTM; ++i) xv[i] = Xs[r][ty * kTM + i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) gv[j] = Gs[r][tx * kTN + j];
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            if constexpr (INNER) dlt[i][j] = fmaf(xv[i], gv[j], dlt[i][j]);
            else acc[i][j] = fmaf(xv[i], gv[j], acc[i][j]);
          }
      }
      if (FT) {
        __syncthreads();   // xsum / gsum complete
        // Column checksums: the block's (running), each band's (tile,
        // running) or this tile's alone (inner); row checksums likewise.
        if constexpr (TILE) {
          for (int i = tid; i < NB * kBN; i += kThreads) {
            const int b = i / kBN, n = i % kBN;
            float c = 0.0f;
            for (int r = 0; r < BM; ++r) c = fmaf(xsum_t[r][b], Gs[r][n], c);
            colck_t[b][n] += c;
          }
        } else {
          for (int n = tid; n < kBN; n += kThreads) {
            float c = 0.0f;
            for (int r = 0; r < BM; ++r) c = fmaf(xsum[r], Gs[r][n], c);
            if constexpr (INNER) colck[n] = c;
            else colck[n] += c;
          }
        }
        for (int k = tid; k < kBK; k += kThreads) {
          float c = 0.0f;
          for (int r = 0; r < BM; ++r) c = fmaf(Xs[r][k], gsum[r], c);
          if constexpr (INNER) rowck[k] = c;
          else rowck[k] += c;
        }
      }
    }
    if (!FT) continue;
    // Emulated SEU on this tile's contribution (deterministic injection),
    // in Δ at the inner level.
    if (inj_block && t == a.inj_k) {
      const int rl = a.inj_row - k0, cl = a.inj_col - n0;
      if (rl / kTM == ty && cl / kTN == tx) {
        if constexpr (INNER) dlt[rl % kTM][cl % kTN] += a.inj_mag;
        else acc[rl % kTM][cl % kTN] += a.inj_mag;
      }
    }
    // Stochastic SEU: this tile's own product at the element (a hit tile
    // holds a live row, so it was staged above).
    if (sh.hit && t == t_first + sh.step && sh.row / kTM == ty &&
        sh.col / kTN == tx) {
      float d = 0.0f;
      for (int r = 0; r < BM; ++r) d = fmaf(Xs[r][sh.row], Gs[r][sh.col], d);
      const float mag = seu::magnitude(d, a.seu.shift);
      if constexpr (INNER) dlt[sh.row % kTM][sh.col % kTN] += mag;
      else acc[sh.row % kTM][sh.col % kTN] += mag;
    }
    if constexpr (INNER) {
      // Verify Δ alone, correct it, then accumulate it.
      verify(t, dlt);
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] += dlt[i][j];
    } else if (a.verify_step || t == t_end - 1) {
      verify(t, acc);
    }
  }

  // ---- one write of the block and its report ---------------------------
  float* out = a.out + (long long)grp * a.K * a.N;
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gk = k0 + ty * kTM + i, gc = n0 + tx * kTN + j;
      if (gk < a.K && gc < a.N) out[(long long)gk * a.N + gc] = acc[i][j];
    }
  if (FT && tid == 0) {
    float* r = a.rep + (((long long)grp * a.gk + ki) * a.gn + ni) * 8;
    for (int q = 0; q < 8; ++q) r[q] = rep[q];
  }
}

template <typename T, bool FT, int BM, int LEVEL>
cudaError_t launch(TgmmArgs a, cudaStream_t stream) {
  a.gk = (a.K + kBK - 1) / kBK;
  a.gn = (a.N + kBN - 1) / kBN;
  if (a.gk > 65535 || a.G > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid(a.gn, a.gk, a.G);
  tgmm_kernel<T, FT, BM, LEVEL><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

// Row tiles (BM) per dtype; kernels/grouped_gemm.py:TGMM_TILES lists the
// same table.
template <typename T, bool FT, int LEVEL>
cudaError_t launch_bm(int bm, const TgmmArgs& a, cudaStream_t st) {
  if (bm == 16) return launch<T, FT, 16, LEVEL>(a, st);
  if constexpr (sizeof(T) == 4) {
    if (bm == 8) return launch<T, FT, 8, LEVEL>(a, st);
  }
  return cudaErrorInvalidValue;
}

// Every instance of one operand type: FT off, or FT at `level`.
template <typename T>
cudaError_t launch_ft(int ft, int level, int bm, const TgmmArgs& a,
                      cudaStream_t st) {
  if (!ft) return launch_bm<T, false, kLevelBlock>(bm, a, st);
  switch (level) {
    case kLevelBlock: return launch_bm<T, true, kLevelBlock>(bm, a, st);
    case kLevelTile: return launch_bm<T, true, kLevelTile>(bm, a, st);
    case kLevelInner: return launch_bm<T, true, kLevelInner>(bm, a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* tgmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x (T, K) and g (T, N) with element strides; row_end int32 (G,); out
// (G, K, N) f32 and report (G, ceil(K/64), ceil(N/64), 8) contiguous.
// dtype: 0 f32, 1 bf16. level: the FT Level (with ft = 1). bm: the
// layout's row tile (T a multiple of it). The injection's row and col index
// dw, inj_k is a buffer row tile. Returns the launch's cudaError_t.
int tgmm_launch(const void* x, const void* g, const int* row_end, float* out,
                float* rep, int T, int K, int N, int G, int sxr, int sxk,
                int sgr, int sgn, int dtype, int ft, int level, int bm,
                int verify_step,
                int corrects, float tau_coef, int inj_enable, int inj_row,
                int inj_col, int inj_k, float inj_mag, int seu_on,
                unsigned seu_seed, float seu_rate, int seu_shift,
                void* stream) {
  if (T <= 0 || K <= 0 || N <= 0 || G <= 0 || bm <= 0 || T % bm != 0)
    return cudaErrorInvalidValue;
  TgmmArgs a{};
  a.x = x; a.g = g; a.row_end = row_end; a.out = out; a.rep = rep;
  a.T = T; a.K = K; a.N = N; a.G = G; a.t_tiles = T / bm;
  a.sxr = sxr; a.sxk = sxk; a.sgr = sgr; a.sgn = sgn;
  a.verify_step = verify_step; a.corrects = corrects; a.tau_coef = tau_coef;
  a.inj_enable = inj_enable; a.inj_row = inj_row; a.inj_col = inj_col;
  a.inj_k = inj_k; a.inj_mag = inj_mag;
  a.seu = seu::Args{seu_on, seu_seed, seu_rate, seu_shift};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_ft<float>(ft, level, bm, a, st);
  if (dtype == 1) return launch_ft<__nv_bfloat16>(ft, level, bm, a, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
