// The SIMT ABFT GEMM kernel for Hopper (sm_90a), shared by the two sources
// that instantiate it: csrc/ft_gemm.cu (the compiled chains, the training
// walks, the batched and grouped bodies) and csrc/ft_gemm_chain.cu (every
// other chain, EPI = kEpiChain). C = epilogue(A·B) with online
// Huang–Abraham checksums, one located and corrected error per output block
// per verification.
//
// Replaces the TPU kernels K1, K5 and K7 of the JAX package:
//   src/repro/kernels/templates/emit.py:render (2-D, uniform-batched and
//   grouped bodies), launched by templates/registry.py:kernel_call and
//   templates/registry.py:batched_kernel_call (grouped=True for K7).
// The 2-D kernel is the batched kernel with batch 1. A 1-D grid walks
// (slice, row block, column block), in that order of majority, over every
// slice of up to two batch dims (b0, b1), so a batch is bounded by
// gridDim.x's 2^31 - 1 CTAs and not by gridDim.z's 65 535 (the order of a
// (gn, gm, batch) grid, kept); every operand dim has its own element stride
// (0 on the batch dims of a shared B), so a permuted view such as the
// transposed KV cache of decode attention is read in place, not copied.
//
// Design (simple and right first):
//   * one CTA of 256 threads per (BM x BN) output block; the k loop stages
//     the A tile (transposed, f32) and the B tile (f32) in shared memory and
//     each thread accumulates a TM x TN micro-tile in f32 registers;
//   * the checksums ride the staged tiles: the running column checksum
//     (e^T A_tile)·B_tile, the row checksum A_tile·(B_tile e), and the
//     running max|A|, max|B| over the tiles loaded so far for the threshold
//     tau = rel_tau·eps32·k_elapsed·max|A|·max|B|;
//   * verify="step" verifies on every non-last step; at the end the linear
//     epilogue prefix (bias, and the residual when no activation follows) is
//     applied and folded into the checksums, then verify, locate (first
//     argmax, ties to the lower index), branchless correction, the
//     nonlinear suffix, and one write of C;
//   * ragged edges are masked by bounds (loads past (M, N, K) read zero);
//     the bias is added to every tile row, padding rows included, like the
//     reference's fold, so the column residuals agree on the ragged edge;
//   * LAYOUT picks the walk of the tile loads: 0 row-major operands; 1 a
//     B whose k dim has unit stride (w.T in dx = g·Wᵀ); 2 an A whose m dim
//     has unit stride (x.T in dw = Xᵀ·g). Each walks along the unit-stride
//     dim, so transposed views load coalesced and are never copied; the
//     training layouts are compiled for the plain chain only;
//   * AG (training): the act_grad output, act'(pre-activation) of the
//     chain's activation, written from the verified, corrected block
//     beside C; compiled for the chains with an activation only;
//   * GROUPED (K7, the MoE expert GEMMs): A is a group-sorted buffer whose
//     row tiles never span two groups; the CTA of row tile i reads its
//     group gid[i] and that group's row_end from device int32 arrays,
//     takes B = w[gid[i]] (group stride, any k / n strides: LAYOUT 1 for
//     the transposed w of the dbuf product) and masks A's rows at or past
//     row_end, so the checksums and max|A| are the group's. A tile with no
//     live row reads no B: without an SEU aimed at it, it writes zeros and
//     the report of a clean all-zero block (tau 1e-30, k = K) at once.
//     Compiled for the plain chain, BM 16 (bf16) and 8 or 16 (f32), and in
//     csrc/ft_gemm_chain.cu at kEpiChain for K7's aux-free chains (the
//     all-zero shortcut writes 0, which every activation keeps). The
//     parameter is a compile-time one, so K1's and K5's instances carry no
//     branch of it;
//   * LEVEL, the paper's threadblock / warp / thread granularities
//     (reference emit.py:432-512), a compile-time parameter as well:
//     0 block: the scheme above;
//     1 tile (warp level): the column checksum is kept per band of the rows
//       one warp owns in the thread layout (BM / 8 rows: 8 of the 64-row
//       tile, 2 of the 16-row one), in shared memory, beside one row
//       checksum per row. Each band is verified, located and corrected on
//       its own (verify_bands: one warp locates each band, thread 0 records
//       them in order), so one SEU per band per interval is corrected. The
//       final verification runs on the raw accumulator, and the whole
//       chain is applied after it (no fold);
//     2 inner (thread level): each k-step's Δ = A_s·B_s is accumulated in a
//       second register tile beside acc, verified alone against the step's
//       own checksums (verify_block), corrected in Δ and then added to acc;
//       no running checksums and no final verification, so verify_step
//       changes nothing. Tau takes the elapsed k and the running max|A|,
//       max|B| as at the other levels (emit.py:369-378).
//     The tile and inner levels are compiled for the serving chains (none,
//     bias, silu, bias+silu) on the row-major walk, for the plain chain on
//     LAYOUT 1 (the transposed K cache of decode attention, w.T in dx) and
//     LAYOUT 2 (x.T in dw: the staged A tile is As[k][m] on every walk, so
//     a band's e^T A sums the same rows), for the training chains with an
//     activation (silu, bias+silu) with AG, written after the final
//     verification (tile) or the last step (inner) from the corrected
//     block, and for GROUPED on both B walks. A GROUPED tile's band is the
//     rows one warp owns, 2 of the 16-row tile and 1 of the f32 8-row one;
//     its all-zero shortcut writes the clean record at every level, the one
//     the walk would write (tau 1e-30 from max|A| = 0, k = K);
//   * EPI = kEpiChain (csrc/ft_gemm_chain.cu): the chain is a runtime list
//     of at most ten ops (chain_ops, 3 bits an op in an int32: kOpBias,
//     kOpResidual, kOpSilu, kOpGelu, kOpRelu), so one instance per (type,
//     level, tiles, AG) takes every chain of at most one bias, one residual
//     and any number of activations in any order (K1's, K5's with a batch,
//     and the GROUPED instances' of K7 without aux). Its leading run of
//     linear ops (chain_fold:
//     the reference's fold_split) is applied to the block after the
//     tile level's raw verification and, at the block level, folded into
//     the checksums before the final verification, as the compiled chains'
//     bias and residual are; the rest runs op by op in the single write,
//     act_grad stored at the activation's input.
// What bounds it on the H100: decode-shaped calls (M <= 16) are bound by
// the bytes of B (the weights), prefill-shaped calls by operations. This
// first version runs the MACs on the CUDA cores in f32 (no tensor cores, no
// TMA pipeline), so it is far from both bounds; PERF.md carries its times.
//
// Stochastic SEU campaigns (seu_hook.cuh): under FT each CTA draws its
// block's SEU at its start, uid (slice·gm + i)·gn + j (a GROUPED row tile
// is its i), over BM x BN and the ceil(K / BK) k-steps; on the drawn step
// the thread that owns the element takes its contribution as the dot of
// the staged A row and B column and adds the magnitude, to Δ at the inner
// level. A GROUPED tile with no live row walks its steps when its SEU hits.
//
// Report per output block, f32[8]: [detected, corrected, row, col,
// magnitude, max_residual, tau, k_elapsed], accumulated like the
// reference's _record: det/corr add, row/col/mag overwrite on detection,
// max_residual takes the max, tau and k are overwritten at every verify.
#pragma once

#include "abft_block.cuh"
#include "seu_hook.cuh"

namespace {

using namespace abft;

enum Level { kLevelBlock = 0, kLevelTile = 1, kLevelInner = 2 };

enum Epilogue {
  kEpiNone = 0, kEpiBias = 1, kEpiSilu = 2, kEpiBiasSilu = 3,
  kEpiGelu = 4, kEpiRelu = 5, kEpiResidual = 6,
  kEpiChain = 7   // the runtime op list of GemmArgs::chain_ops
};

// The ops of a runtime chain (kernels/ft_gemm.py:CHAIN_OPS).
enum ChainOp { kOpBias = 1, kOpResidual = 2, kOpSilu = 3, kOpGelu = 4,
               kOpRelu = 5 };

template <int EPI>
struct Chain {
  static constexpr bool bias = EPI == kEpiBias || EPI == kEpiBiasSilu;
  // 0 none, 1 silu, 2 gelu (tanh approximation), 3 relu
  static constexpr int act = (EPI == kEpiSilu || EPI == kEpiBiasSilu) ? 1
                             : EPI == kEpiGelu ? 2 : EPI == kEpiRelu ? 3 : 0;
  static constexpr bool residual = EPI == kEpiResidual;
};

template <int ACT>
__device__ __forceinline__ float activate(float y) {
  if (ACT == 1) return y * (1.0f / (1.0f + expf(-y)));
  if (ACT == 2) {
    const float c = 0.7978845608028654f;  // sqrt(2/pi)
    return 0.5f * y * (1.0f + tanhf(c * (y + 0.044715f * y * y * y)));
  }
  if (ACT == 3) return fmaxf(y, 0.0f);
  return y;
}

// The activation's derivative, the formulas of templates/epilogues.py.
template <int ACT>
__device__ __forceinline__ float activate_grad(float y) {
  if (ACT == 1) {
    const float s = 1.0f / (1.0f + expf(-y));
    return s * (1.0f + y * (1.0f - s));
  }
  if (ACT == 2) {
    const float c = 0.7978845608028654f;
    const float t = tanhf(c * (y + 0.044715f * y * y * y));
    const float du = c * (1.0f + 3.0f * 0.044715f * y * y);
    return 0.5f * (1.0f + t) + 0.5f * y * (1.0f - t * t) * du;
  }
  if (ACT == 3) return y > 0.0f ? 1.0f : 0.0f;
  return 1.0f;
}

// The activation of a runtime chain op (kOpSilu .. kOpRelu), or its
// derivative.
__device__ __forceinline__ float activate_op(int op, bool grad, float y) {
  switch (op) {
    case kOpSilu: return grad ? activate_grad<1>(y) : activate<1>(y);
    case kOpGelu: return grad ? activate_grad<2>(y) : activate<2>(y);
    case kOpRelu: return grad ? activate_grad<3>(y) : activate<3>(y);
    default: return grad ? 1.0f : y;
  }
}

struct GemmArgs {
  const void* a;
  const void* b;           // GROUPED: w (G, K, N), group stride sb0
  const int* gid;          // GROUPED: owning group of each row tile
  const int* row_end;      // GROUPED: first dead buffer row of each group
  const void* bias;
  const void* res;
  void* out;
  float* rep;
  void* act_grad;          // nullptr, or act'(pre-activation) (M, N)
  int M, N, K;
  int nb1;                 // inner batch count: z = b0 * nb1 + b1
  long long sa0, sa1;      // A batch strides in elements
  long long sb0, sb1;      // B batch strides (0, 0: one shared B)
  int sam, sak, sbk, sbn;  // A row / k, B k / column strides in elements
  int gm, gn, ksteps;
  int verify_step, corrects;
  float tau_coef;    // rel_tau * eps32
  int inj_enable, inj_batch, inj_row, inj_col, inj_k;
  float inj_mag;
  seu::Args seu;           // the stochastic hook's campaign
  // kEpiChain: ops i = 0 .. chain_len-1 in bits 3i..3i+2 of chain_ops; the
  // first chain_fold of them are the linear prefix.
  int chain_ops, chain_len, chain_fold;
};

// Element (r, c) of a matrix with strides (sr, sc). A unit column stride
// (the row-major case) takes one wide multiply, as a dense operand would.
template <typename T>
__device__ __forceinline__ float load_at(const T* p, int r, int c, int sr,
                                         int sc) {
  const long long rr = (long long)r * sr;
  return to_f32(p[sc == 1 ? rr + c : rr + (long long)c * sc]);
}

template <typename T, bool FT, int EPI, int LAYOUT, bool AG, int BM, int BN,
          int BK, int TM, int TN, bool GROUPED, int LEVEL>
__global__ void __launch_bounds__(kThreads)
ft_gemm_kernel(const GemmArgs g) {
  constexpr int TX = BN / TN, TY = BM / TM;
  static_assert(TX * TY == kThreads, "thread tile must cover the block");
  using Ch = Chain<EPI>;
  constexpr bool BLOCK = FT && LEVEL == kLevelBlock;
  constexpr bool TILE = FT && LEVEL == kLevelTile;
  constexpr bool INNER = FT && LEVEL == kLevelInner;
  // tile: NB bands of BAND rows, band t owned by warp t.
  constexpr int NB = TILE ? kWarps : 1;
  constexpr int BAND = TILE ? BM / kWarps : 1;
  static_assert(!TILE || (32 % TX == 0 && BAND * kWarps == BM &&
                          BAND == (32 / TX) * TM),
                "a tile-level band is the rows one warp owns");

  __shared__ float As[BK][BM + 1];   // A tile, transposed
  __shared__ float Bs[BK][BN];
  __shared__ float Cs[BM][BN + 1];   // block values at verification
  __shared__ float colck[BN], rowck[BM], asum[BK], bsum[BK], red[kWarps];
  __shared__ VerifySmem<BM, BN> vs;
  // tile: the running column checksum and e^T A of each band.
  __shared__ float colck_t[NB][TILE ? BN : 1], asum_t[NB][TILE ? BK : 1];
  __shared__ BandSmem<NB, BAND, TILE ? BN : 1> bs;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  // blockIdx.x: (slice, row block, column block), slice major
  const int bj = blockIdx.x % g.gn, bi = (blockIdx.x / g.gn) % g.gm;
  const int bz = blockIdx.x / (g.gn * g.gm);
  const int row0 = bi * BM, col0 = bj * BN;
  const int M = g.M, N = g.N, K = g.K;
  const int z0 = bz / g.nb1, z1 = bz % g.nb1;
  const T* A = static_cast<const T*>(g.a) + z0 * g.sa0 + z1 * g.sa1;
  const T* B = static_cast<const T*>(g.b) + z0 * g.sb0 + z1 * g.sb1;
  // Rows of A at or past m_hi are masked; GROUPED B streams only in a tile
  // with a live row.
  int m_hi = M;
  bool b_live = true;
  const seu::Hit sh =
      FT ? seu::draw(g.seu, (uint32_t)((bz * g.gm + bi) * g.gn + bj),
                     g.ksteps, BM, BN)
         : seu::Hit{false, 0, 0, 0};
  if constexpr (GROUPED) {
    const int grp = g.gid[bi];
    m_hi = min(g.row_end[grp], M);
    b_live = row0 < m_hi;
    B = static_cast<const T*>(g.b) + (long long)grp * g.sb0;
    const bool seu_here = FT && g.inj_enable && g.inj_k >= 0 &&
                          g.inj_k < g.ksteps &&
                          g.inj_row >= row0 && g.inj_row < row0 + BM &&
                          g.inj_col >= col0 && g.inj_col < col0 + BN;
    if (!b_live && !seu_here && !sh.hit) {
      T* out = static_cast<T*>(g.out);
      for (int idx = tid; idx < BM * BN; idx += kThreads) {
        const int gr = row0 + idx / BN, gc = col0 + idx % BN;
        if (gr < M && gc < N) store(&out[(long long)gr * N + gc], 0.0f);
      }
      if (FT && tid == 0) {
        float* r = g.rep + ((long long)bi * g.gn + bj) * 8;
        for (int q = 0; q < 6; ++q) r[q] = 0.0f;
        r[6] = 1e-30f;
        r[7] = (float)K;
      }
      return;
    }
  }

  float acc[TM][TN];
  float dlt[TM][TN];   // inner: this k-step's Δ
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  float amax = 0.0f, bmax = 0.0f;   // this thread's running max|A|, max|B|
  float rep[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (FT) {
    for (int i = tid; i < BN; i += kThreads) colck[i] = 0.0f;
    for (int i = tid; i < BM; i += kThreads) rowck[i] = 0.0f;
  }
  if constexpr (TILE)
    for (int i = tid; i < NB * BN; i += kThreads) colck_t[i / BN][i % BN] = 0.0f;
  const bool inj_here = FT && g.inj_enable &&
                        (g.inj_batch < 0 || g.inj_batch == bz);

  for (int s = 0; s < g.ksteps; ++s) {
    const int k0 = s * BK;
    __syncthreads();
    for (int idx = tid; idx < BM * BK; idx += kThreads) {
      const int m = LAYOUT == 2 ? idx % BM : idx / BK;
      const int kk = LAYOUT == 2 ? idx / BM : idx % BK;
      const int gr = row0 + m, gk = k0 + kk;
      const float v = (gr < m_hi && gk < K)
                          ? load_at(A, gr, gk, g.sam, g.sak) : 0.0f;
      As[kk][m] = v;
      if (FT) amax = fmaxf(amax, fabsf(v));
    }
    for (int idx = tid; idx < BK * BN; idx += kThreads) {
      const int kk = LAYOUT == 1 ? idx % BK : idx / BN;
      const int n = LAYOUT == 1 ? idx / BK : idx % BN;
      const int gk = k0 + kk, gc = col0 + n;
      const float v = (b_live && gk < K && gc < N)
                          ? load_at(B, gk, gc, g.sbk, g.sbn) : 0.0f;
      Bs[kk][n] = v;
      if (FT) bmax = fmaxf(bmax, fabsf(v));
    }
    __syncthreads();
    if constexpr (TILE) {
      // e^T A of each band's rows
      for (int i = tid; i < NB * BK; i += kThreads) {
        const int t = i / BK, kk = i % BK;
        float c = 0.0f;
        for (int r = 0; r < BAND; ++r) c += As[kk][t * BAND + r];
        asum_t[t][kk] = c;
      }
      row_sums(&Bs[0][0], BK, BN, BN, bsum);       // B_tile e
    } else if (FT) {
      row_sums(&As[0][0], BK, BM, BM + 1, asum);   // e^T A_tile
      row_sums(&Bs[0][0], BK, BN, BN, bsum);       // B_tile e
    }
    if constexpr (INNER) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) dlt[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          if constexpr (INNER) dlt[i][j] = fmaf(av[i], bv[j], dlt[i][j]);
          else acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
    }
    if (!FT) continue;
    __syncthreads();   // asum / bsum complete
    // Column checksums: the block's (running), each band's (tile, running)
    // or this step's alone (inner); row checksums likewise.
    if constexpr (TILE) {
      for (int i = tid; i < NB * BN; i += kThreads) {
        const int t = i / BN, n = i % BN;
        float c = 0.0f;
        for (int kk = 0; kk < BK; ++kk) c = fmaf(asum_t[t][kk], Bs[kk][n], c);
        colck_t[t][n] += c;
      }
    } else {
      for (int n = tid; n < BN; n += kThreads) {
        float c = 0.0f;
        for (int kk = 0; kk < BK; ++kk) c = fmaf(asum[kk], Bs[kk][n], c);
        if constexpr (INNER) colck[n] = c;
        else colck[n] += c;
      }
    }
    for (int m = tid; m < BM; m += kThreads) {
      float c = 0.0f;
      for (int kk = 0; kk < BK; ++kk) c = fmaf(As[kk][m], bsum[kk], c);
      if constexpr (INNER) rowck[m] = c;
      else rowck[m] += c;
    }
    // Emulated SEU on this step's accumulator (deterministic injection):
    // in Δ at the inner level.
    if (inj_here && s == g.inj_k) {
      const int rl = g.inj_row - row0, cl = g.inj_col - col0;
      if (rl >= 0 && rl < BM && cl >= 0 && cl < BN && rl / TM == ty &&
          cl / TN == tx) {
        if constexpr (INNER) dlt[rl % TM][cl % TN] += g.inj_mag;
        else acc[rl % TM][cl % TN] += g.inj_mag;
      }
    }
    // Stochastic SEU: the element's contribution of this step, from the
    // staged tiles, by the thread that owns it.
    if (sh.hit && s == sh.step && sh.row / TM == ty && sh.col / TN == tx) {
      float d = 0.0f;
      for (int kk = 0; kk < BK; ++kk)
        d = fmaf(As[kk][sh.row], Bs[kk][sh.col], d);
      const float mag = seu::magnitude(d, g.seu.shift);
      if constexpr (INNER) dlt[sh.row % TM][sh.col % TN] += mag;
      else acc[sh.row % TM][sh.col % TN] += mag;
    }
    if constexpr (INNER) {
      // Verify Δ alone, correct it, then accumulate it.
      const float k_el = (float)min((s + 1) * BK, K);
      const float am = block_max(amax, red), bm = block_max(bmax, red);
      const float tau = fmaxf(g.tau_coef * k_el * am * bm, 1e-30f);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) Cs[ty * TM + i][tx * TN + j] = dlt[i][j];
      __syncthreads();
      const Verdict v = verify_block<BM, BN>(
          &Cs[0][0], BN + 1, colck, rowck, tau, k_el, g.corrects, row0, col0,
          vs, rep);
      if (g.corrects && v.det && v.row / TM == ty && v.col / TN == tx)
        dlt[v.row % TM][v.col % TN] -= v.mag;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += dlt[i][j];
    } else if (g.verify_step && s != g.ksteps - 1) {
      const float k_el = (float)min((s + 1) * BK, K);
      const float am = block_max(amax, red), bm = block_max(bmax, red);
      const float tau = fmaxf(g.tau_coef * k_el * am * bm, 1e-30f);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) Cs[ty * TM + i][tx * TN + j] = acc[i][j];
      __syncthreads();
      if constexpr (TILE) {
        verify_bands<NB, BAND, BN>(&Cs[0][0], BN + 1, &colck_t[0][0], rowck,
                                   tau, k_el, g.corrects, row0, col0, bs,
                                   rep);
        if (g.corrects)
          for (int t = 0; t < NB; ++t) {
            const Verdict v = bs.v[t];
            if (v.det && v.row / TM == ty && v.col / TN == tx)
              acc[v.row % TM][v.col % TN] -= v.mag;
          }
      } else {
        const Verdict v = verify_block<BM, BN>(
            &Cs[0][0], BN + 1, colck, rowck, tau, k_el, g.corrects, row0,
            col0, vs, rep);
        if (g.corrects && v.det && v.row / TM == ty && v.col / TN == tx)
          acc[v.row % TM][v.col % TN] -= v.mag;
      }
    }
  }

  // ---- epilogue: fold, final verify, chain, cast, one write ------------
  const T* bias = static_cast<const T*>(g.bias);
  const T* res = static_cast<const T*>(g.res);
  float am = 0.0f, bm = 0.0f;
  if (FT) {
    am = block_max(amax, red);
    bm = block_max(bmax, red);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) Cs[ty * TM + i][tx * TN + j] = acc[i][j];
  __syncthreads();
  if constexpr (TILE) {
    // The final verification on the raw accumulator, band by band; the
    // whole chain follows.
    const float k_el = (float)K;
    const float tau = fmaxf(g.tau_coef * k_el * am * bm, 1e-30f);
    verify_bands<NB, BAND, BN>(&Cs[0][0], BN + 1, &colck_t[0][0], rowck, tau,
                               k_el, g.corrects, row0, col0, bs, rep);
    if (g.corrects && tid == 0)
      for (int t = 0; t < NB; ++t)
        if (bs.v[t].det) Cs[bs.v[t].row][bs.v[t].col] -= bs.v[t].mag;
    __syncthreads();
  }
  // Linear prefix (folded into the checksums at the block level): the
  // bias, then the residual when no activation follows it; a runtime
  // chain's first chain_fold ops.
  constexpr bool CHAIN = EPI == kEpiChain;
  bool pre_bias = Ch::bias;
  bool fold_res = Ch::residual && Ch::act == 0;
  if constexpr (CHAIN)
    for (int i = 0; i < g.chain_fold; ++i) {
      const int op = (g.chain_ops >> (3 * i)) & 7;
      pre_bias = pre_bias || op == kOpBias;
      fold_res = fold_res || op == kOpResidual;
    }
  if (pre_bias || fold_res) {
    for (int idx = tid; idx < BM * BN; idx += kThreads) {
      const int m = idx / BN, n = idx % BN;
      const int gr = row0 + m, gc = col0 + n;
      const float bv = (pre_bias && gc < N) ? to_f32(bias[gc]) : 0.0f;
      const float rv = (fold_res && gr < M && gc < N)
                           ? to_f32(res[(long long)gr * N + gc]) : 0.0f;
      float y = Cs[m][n];
      if constexpr (CHAIN) {
        // in the chain's order, as the plain version sums them
        for (int i = 0; i < g.chain_fold; ++i)
          y += ((g.chain_ops >> (3 * i)) & 7) == kOpBias ? bv : rv;
      } else {
        if (pre_bias) y += bv;
        if (fold_res) y += rv;
      }
      Cs[m][n] = y;
    }
  }
  if constexpr (BLOCK) {
    for (int n = tid; n < BN; n += kThreads) {
      const int gc = col0 + n;
      float add = 0.0f;
      if (pre_bias) add += (float)BM * (gc < N ? to_f32(bias[gc]) : 0.0f);
      if (fold_res && gc < N)
        for (int m = 0; m < BM && row0 + m < M; ++m)
          add += to_f32(res[(long long)(row0 + m) * N + gc]);
      colck[n] += add;
    }
    for (int m = tid; m < BM; m += kThreads) {
      const int gr = row0 + m;
      float add = 0.0f;
      if (pre_bias)
        for (int n = 0; n < BN && col0 + n < N; ++n)
          add += to_f32(bias[col0 + n]);
      if (fold_res && gr < M)
        for (int n = 0; n < BN && col0 + n < N; ++n)
          add += to_f32(res[(long long)gr * N + col0 + n]);
      rowck[m] += add;
    }
    __syncthreads();
    const float k_el = (float)K;
    const float tau = fmaxf(g.tau_coef * k_el * am * bm, 1e-30f);
    const Verdict v = verify_block<BM, BN>(&Cs[0][0], BN + 1, colck, rowck,
                                           tau, k_el, g.corrects, row0, col0,
                                           vs, rep);
    if (g.corrects && v.det && tid == 0) Cs[v.row][v.col] -= v.mag;
    __syncthreads();
  }
  // Nonlinear suffix, cast and the single write of C (and act_grad).
  T* out = static_cast<T*>(g.out) + (long long)bz * M * N;
  T* ag = static_cast<T*>(g.act_grad);
  for (int idx = tid; idx < BM * BN; idx += kThreads) {
    const int m = idx / BN, n = idx % BN;
    const int gr = row0 + m, gc = col0 + n;
    if (gr >= M || gc >= N) continue;
    if constexpr (CHAIN) {
      // the chain's suffix, op by op; act_grad at the activation's input
      float y = Cs[m][n];
      for (int i = g.chain_fold; i < g.chain_len; ++i) {
        const int op = (g.chain_ops >> (3 * i)) & 7;
        if (op == kOpBias) {
          y += to_f32(bias[gc]);
        } else if (op == kOpResidual) {
          y += to_f32(res[(long long)gr * N + gc]);
        } else {
          if (AG)
            store(&ag[(long long)bz * M * N + (long long)gr * N + gc],
                  activate_op(op, true, y));
          y = activate_op(op, false, y);
        }
      }
      store(&out[(long long)gr * N + gc], y);
      continue;
    }
    if (AG)
      store(&ag[(long long)bz * M * N + (long long)gr * N + gc],
            activate_grad<Ch::act>(Cs[m][n]));
    float y = activate<Ch::act>(Cs[m][n]);
    if (Ch::residual && !fold_res) y += to_f32(res[(long long)gr * N + gc]);
    store(&out[(long long)gr * N + gc], y);
  }
  if (FT && tid == 0) {
    float* r = g.rep + (((long long)bz * g.gm + bi) * g.gn + bj) * 8;
    for (int q = 0; q < 8; ++q) r[q] = rep[q];
  }
}

template <typename T, bool FT, int EPI, int LAYOUT, bool AG, int BM, int BN,
          int BK, int TM, int TN, bool GROUPED = false,
          int LEVEL = kLevelBlock>
cudaError_t launch(GemmArgs g, int batch, cudaStream_t stream) {
  g.gm = (g.M + BM - 1) / BM;
  g.gn = (g.N + BN - 1) / BN;
  g.ksteps = (g.K + BK - 1) / BK;
  if (g.gm > 65535 || (long long)g.gn * g.gm * batch > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  const dim3 grid(g.gn * g.gm * batch);
  ft_gemm_kernel<T, FT, EPI, LAYOUT, AG, BM, BN, BK, TM, TN, GROUPED, LEVEL>
      <<<grid, kThreads, 0, stream>>>(g);
  return cudaGetLastError();
}

// Tile configurations (BM, BN, BK); kernels/ft_gemm.py:TILES lists the
// same table in the same order (and BANDS the tile level's BM / 8).
template <typename T, bool FT, int EPI, int LAYOUT = 0, bool AG = false,
          int LEVEL = kLevelBlock>
cudaError_t launch_tiles(int tiles, const GemmArgs& g, int batch,
                         cudaStream_t st) {
  if (tiles == 0)
    return launch<T, FT, EPI, LAYOUT, AG, 64, 64, 32, 4, 4, false, LEVEL>(
        g, batch, st);
  if (tiles == 1)
    return launch<T, FT, EPI, LAYOUT, AG, 16, 128, 32, 2, 4, false, LEVEL>(
        g, batch, st);
  return cudaErrorInvalidValue;
}

}  // namespace
