// ABFT GEMM for Hopper on the tensor cores (sm_90a): K1's bf16 2-D
// instances at every FT level. C = act(A·B + bias) with online
// Huang–Abraham checksums. This header holds the kernels, templated on the
// level LV; csrc/ft_gemm_sm90.cu instantiates FT off and the threadblock
// ("block") level, csrc/ft_gemm_level_sm90.cu the warp ("tile") and thread
// ("inner") levels, so the two build in parallel.
//
// Replaces the TPU kernel K1 of the JAX package:
//   src/repro/kernels/templates/emit.py:render (2-D body), launched by
//   templates/registry.py:kernel_call; at "inner" its Δ verification
//   (emit.py:432-442), at "tile" its per-band running column checksums
//   (emit.py:443-453) and per-band _verify_raw (emit.py:456-481).
// The ring, the wgmma and TMA wrappers, the checksum operators and the
// verifications live in csrc/sm90_mainloop.cuh, shared with the grouped
// kernels K7 and K8 (csrc/grouped_sm90.cu).
// The SIMT kernel of csrc/ft_gemm.cu keeps f32, pinned tiles, the batched
// (K5) and grouped (K7) bodies and every chain or operand walk these
// sources do not instantiate; kernels/ft_gemm.py:plan picks between them
// by a written rule.
//
// What bounds it on the H100, and what the design does about it:
//   * prefill and training shapes (M >= 512) are bound by operations: the
//     MACs are bf16 `wgmma.mma_async` m64n128k16 with f32 accumulators in
//     registers, A and B read from shared memory (wgmma_m64n128k16,
//     sm90_mainloop.cuh), one stage's wgmmas kept in flight while the next
//     stage is waited for. The transpose bits take the three operand
//     walks, so the transposed views of training are never copied: LAYOUT 0
//     row-major A and B, LAYOUT 1 a B whose k dim has unit stride (w.T in
//     dx = g·Wᵀ), LAYOUT 2 an A whose m dim has unit stride (x.T in dw =
//     Xᵀ·g). CTA tile BM x 128 with one consumer warpgroup per 64 rows (BM
//     128 for M > 64, else 64), and a producer warpgroup;
//   * decode shapes (M <= 64) are bound by the bytes of B (the weights):
//     one thread of the producer warpgroup keeps a ring of kStages 64-deep
//     stages in flight with TMA (`cp.async.bulk.tensor`, tma_load; 128-byte
//     swizzle, full / empty mbarriers). The tensor maps are encoded on the
//     host through cudaGetDriverEntryPoint, so the library links no -lcuda;
//     TMA's zero fill replaces the masked loads of the ragged edge. When
//     the gm x gn output blocks number fewer than about two waves of the
//     132 SMs, each block's k-steps are cut into S contiguous, balanced
//     ranges, one CTA each (split-K, grid z; S from the wave model of
//     kernels/ft_gemm.py:split_count), and a second kernel, launched by
//     the same C entry, sums the f32 partials of the live rows and finishes
//     the block (ft_gemm_sm90_reduce).
// The FT algebra, per 256-deep k-step (the verification interval, the
// reference's bk at its (128, 128, 256) tiles): the consumer warpgroups
// issue a stage's wgmmas, then, while the tensor cores run, take e^T A_s,
// B_s e, max|A| and max|B| from the staged tiles in shared memory (the
// bytes wgmma reads, addressed through the swizzle) and add (e^T A_s)·B_s
// and A_s·(B_s e) to running per-thread checksum partials in f32 (RowOp /
// ColOp), and only then wait for the wgmmas. The checksums ride the CUDA
// cores beside the tensor cores rather than 8 spare columns of the B
// tile: B_s e would have to be rounded to bf16 to enter wgmma, too coarse
// for tau = rel_tau·eps32·k·max|A|·max|B|. Verification (verify_acc)
// reduces the column and row sums of the accumulator from the wgmma
// fragment layout with warp shuffles and a small exchange in shared memory
// (the block is never stored), locates the first argmax per warp and
// across warps, records with the shared abft::record, and the thread that
// owns (row, col) subtracts the magnitude. The three levels:
//   * "block": verify="step" verifies after every k-step but a split's
//     last; the epilogue folds the bias into the checksums (counted on
//     every tile row, padding rows included) and verifies at k = K;
//   * "tile": the band is the 16 rows one warp owns in the wgmma fragment
//     (warp wl of warpgroup wg: rows wg·64 + wl·16 ..; 8 bands at BM 128,
//     4 at BM 64). The stage's band sums e_b^T A_s come from the A chunks
//     the row checksum already loaded (RowOp / ColOp band_ksum), and the
//     running band column checksums (e_b^T A_s)·B_s from a small m16n8k16
//     product on the tensor cores over the staged B tile (BandOp: the band
//     sums enter as three bf16 parts, so the checksum keeps f32's
//     precision), issued beside the in-flight wgmmas and replacing the
//     block's CUDA-core column dot. Each warp verifies, locates and
//     corrects its own band (verify_bands: one SEU per band per interval),
//     and thread 0 records the bands in band order into the block's one
//     report. The final verification runs on the raw accumulator at
//     k = K; the bias is added after it, not folded;
//   * "inner": each k-step's Δ is verified on its own, with no running
//     checksum and no final verification. Δ's column and row sums are the
//     accumulator's sums at the step's end less its sums at the step
//     before (kept in shared memory, taken by verify_acc's own reduction,
//     so no second register tile); the checksum partials restart at each
//     step; the correction subtracts the magnitude from the accumulator,
//     and the kept sums are those after it, so an SEU left by detect-only
//     cancels out of the next step's Δ and is counted once.
//
// Split-K report rule: each split verifies after each of its k-steps but
// its last ("inner": after every one of its steps), with its own elapsed k
// and its own running maxima in tau; the reduce kernel merges the splits'
// reports in split order (abft::merge: det and corr add, row / col / mag
// from the last detection, max_residual the max, tau and k from the last
// verification), then, at "block" and "tile", verifies the sum at k = K
// with the maxima over all splits ("tile": each band against the sum of
// the splits' band checksums, which every split's record carries).
// kernels/ft_gemm.py:ft_gemm_plain walks the same split grid.
//
// Stochastic SEU campaigns (seu_hook.cuh) run their own block instances
// (template parameter SEU; the clean ones are unchanged): every CTA of a
// block (each split's, and the reduce kernel's) draws the block's SEU, uid
// i·gn + j, over BM x 128 and the ceil(K / 256) k-steps. The split that
// runs the drawn step lands it: the thread that owns the element keeps it
// at the end of the step before (where the wgmmas are drained; 0 at the
// split's first step), takes the difference after the step's wait as the
// contribution, and adds the magnitude before the step's verification. A hit in rows past M makes
// the split-K partials carry the block's padding rows, as a deterministic
// SEU there does.
//
// Report per output block, f32[8]: [detected, corrected, row, col,
// magnitude, max_residual, tau, k_elapsed].
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "seu_hook.cuh"
#include "sm90_mainloop.cuh"

namespace {

// One split's record in the split-K workspace (f32 words): the column
// checksums (one 128-wide row, or at "tile" one per band), the row
// checksums, max|A|, max|B| and the split's report.
constexpr int kRecRow = 8 * kBN;          // rowck[BM]
constexpr int kRecMax = kRecRow + 128;    // amax, bmax
constexpr int kRecRep = kRecMax + 2;      // rep[8]
constexpr int kRec = 1168;                // kRecRep + 8, padded to 16

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

struct Sm90Args {
  const __nv_bfloat16* bias;   // (N,) or nullptr
  __nv_bfloat16* out;          // (M, N) row-major
  __nv_bfloat16* act_grad;     // (M, N) row-major, or nullptr
  float* rep;                  // (gm, gn, 8)
  float* ws;                   // splits > 1: partials (S, Mp, Np), then the
                               // records (S, gm, gn, kRec)
  int M, N, K, gm, gn, splits, nstages, ksteps;
  int act, verify_step, corrects;
  float tau_coef;              // rel_tau * eps32
  int inj_enable, inj_row, inj_col, inj_k;
  float inj_mag;
  seu::Args seu;               // the stochastic hook's campaign
};

// The stochastic SEU of output block (bi, bj).
__device__ __forceinline__ seu::Hit block_seu(const Sm90Args& g, int bi,
                                              int bj, int bm) {
  return seu::draw(g.seu, (uint32_t)(bi * g.gn + bj), g.ksteps, bm, kBN);
}

// Whether the split-K partials of the block at (row0, col0) carry its rows
// past M: only when an injected SEU (deterministic, or the block's
// stochastic one `sh`) lands in one of them.
__device__ __forceinline__ bool pad_rows(const Sm90Args& g, int row0,
                                         int col0, int bm,
                                         const seu::Hit& sh) {
  return (g.inj_enable && g.inj_row >= g.M && g.inj_row >= row0 &&
          g.inj_row < row0 + bm && g.inj_col >= col0 &&
          g.inj_col < col0 + kBN) ||
         (sh.hit && row0 + sh.row >= g.M);
}

template <int LV, bool AK, bool BK, int BM, bool SEU>
__global__ void __launch_bounds__(BM * 2 + 128, 1)
ft_gemm_sm90_kernel(const __grid_constant__ CUtensorMap tma_a,
                    const __grid_constant__ CUtensorMap tma_b,
                    const Sm90Args g) {
  constexpr bool FT = LV != kLvOff;
  constexpr bool TILE = LV == kLvTile, INNER = LV == kLvInner;
  constexpr int NT = BM * 2;   // consumer threads: a warpgroup per 64 rows
  constexpr int A_BYTES = BM * kStageK * 2, B_BYTES = kBN * kStageK * 2;
  constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  using OpA = typename std::conditional<AK, RowOp<BM, NT>, ColOp<BM, NT>>::type;
  using OpB = typename std::conditional<BK, RowOp<kBN, NT>, ColOp<kBN, NT>>::type;

  extern __shared__ uint8_t smem_raw[];
  // The ring at a 1024-byte boundary (the swizzle atom), by pointer
  // arithmetic so loads through it stay shared-memory loads.
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Scratch<BM>& sc =
      *reinterpret_cast<Scratch<BM>*>(ring + kStages * STAGE_BYTES);
  // tile / inner only: the band scratch after Scratch<BM>
  BandScratch& bx = *reinterpret_cast<BandScratch*>(
      ring + kStages * STAGE_BYTES + sizeof(Scratch<BM>));

  const int tid = threadIdx.x;
  const int bi = blockIdx.x, bj = blockIdx.y, z = blockIdx.z;
  const int row0 = bi * BM, col0 = bj * kBN;
  const int s_lo = (int)((long long)z * g.ksteps / g.splits);
  const int s_hi = (int)((long long)(z + 1) * g.ksteps / g.splits);
  const int st_lo = s_lo * kStagesPerStep;
  const int nst = min(s_hi * kStagesPerStep, g.nstages) - st_lo;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sc.full[s], 1);
      mbar_init(&sc.empty[s], NT / 32);
    }
    for (int q = 0; q < 8; ++q) sc.rep[q] = 0.0f;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (TILE || INNER) {
    // band sums of the absent bands stay 0; inner's sums before step 0 are 0
    for (int i = tid; i < 2 * 8 * 64; i += blockDim.x) (&bx.ks[0][0][0])[i] = 0.0f;
    for (int i = tid; i < 8 * kBN; i += blockDim.x) (&bx.prevc[0][0])[i] = 0.0f;
    for (int i = tid; i < 128; i += blockDim.x) bx.prevr[i] = 0.0f;
  }
  __syncthreads();

  if (tid >= NT) {
    // ---- producer warpgroup: one thread keeps the TMA ring full ----------
    // (BM 128: setmaxnreg lends its registers to the two consumer
    // warpgroups, which hold a 64 x 128 f32 accumulator each; the pool is
    // counted by whole warpgroups, so the producer is a full one.)
    if constexpr (BM == 128) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == NT) {
      for (int it = 0; it < nst; ++it) {
        const int slot = it % kStages;
        if (it >= kStages) mbar_wait(&sc.empty[slot], ((it / kStages) & 1) ^ 1);
        uint64_t* bar = &sc.full[slot];
        mbar_expect_tx(bar, STAGE_BYTES);
        uint8_t* sa = ring + slot * STAGE_BYTES;
        uint8_t* sb = sa + A_BYTES;
        const int k0 = (st_lo + it) * kStageK;
        if (AK) {
          tma_load(sa, &tma_a, k0, row0, bar);
        } else {
#pragma unroll
          for (int b = 0; b < BM / 64; ++b)
            tma_load(sa + b * kBoxBytes, &tma_a, row0 + 64 * b, k0, bar);
        }
        if (BK) {
          tma_load(sb, &tma_b, k0, col0, bar);
        } else {
          tma_load(sb, &tma_b, col0, k0, bar);
          tma_load(sb + kBoxBytes, &tma_b, col0 + 64, k0, bar);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups -------------------------------------------------
  if constexpr (BM == 128) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid / 128, wl = (tid % 128) / 32, lane = tid & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  OpA opa;
  OpB opb;
  BandOp<NT, BK> opc;   // tile: the band column checksums
  opa.init();
  opb.init();
  opc.init();
  const bool inj_tile = FT && g.inj_enable && g.inj_row >= row0 &&
                        g.inj_row < row0 + BM && g.inj_col >= col0 &&
                        g.inj_col < col0 + kBN;
  const seu::Hit sh =
      SEU ? block_seu(g, bi, bj, BM) : seu::Hit{false, 0, 0, 0};
  // The hit element before its step: 0 at the split's first step, else
  // kept at the end of the step before (the wgmmas drained there).
  float seu_before = 0.0f;

  // ---- mainloop over this split's stages -------------------------------
  int pending = -1;   // a stage whose wgmmas may still run: released later
  for (int it = 0; it < nst; ++it) {
    const int slot = it % kStages;
    mbar_wait(&sc.full[slot], (it / kStages) & 1);
    const uint8_t* pa = ring + slot * STAGE_BYTES;
    const uint8_t* pb = pa + A_BYTES;
    const uint32_t sa = smem_u32(pa) + wg * kBoxBytes;
    const uint32_t sb = smem_u32(pb);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStageK / 16; ++kk) {
      const uint64_t da = make_desc(sa + (AK ? kk * 32 : kk * 2048), AK ? 16 : kBoxBytes);
      const uint64_t db = make_desc(sb + (BK ? kk * 32 : kk * 2048), BK ? 16 : kBoxBytes);
      wgmma_m64n128k16<AK ? 0 : 1, BK ? 0 : 1>(acc, da, db);
    }
    wgmma_commit();
    if constexpr (FT) {
      // While the tensor cores run: the stage's checksums from its tiles
      // (tile: the band column checksums instead of the block's).
      float* ka = sc.ks[it & 1][0];
      float* kb = sc.ks[it & 1][1];
      opa.load(pa, tid);
      opb.load(pb, tid);
      opa.ksum(ka, tid);
      if constexpr (TILE) opa.band_ksum(&bx.ks[it & 1][0][0], tid);
      opb.ksum(kb, tid);
      consumer_sync<NT>();
      opa.dot(kb, tid);
      if constexpr (TILE) opc.dot(pb, &bx.ks[it & 1][0][0], tid);
      else opb.dot(ka, tid);
    }
    // Keep this stage's wgmmas in flight while the next stage is waited
    // for and issued; wait for all of them where the accumulator is read
    // (a k-step's end under FT, the split's last stage).
    const int st = st_lo + it;
    const bool step_end = (st + 1) % kStagesPerStep == 0 || st + 1 == g.nstages;
    const bool drain = it + 1 == nst || (FT && step_end);
    if (drain) wgmma_wait<0>();
    else wgmma_wait<1>();
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) {
      if (pending >= 0) mbar_arrive(&sc.empty[pending]);
      if (drain) mbar_arrive(&sc.empty[slot]);
    }
    pending = drain ? -1 : slot;
    if constexpr (FT) {
      if (step_end) {
        const int s = st / kStagesPerStep;   // the global k-step just ended
        const float k_el = (float)(min((s + 1) * kStep, g.K) - s_lo * kStep);
        // Emulated SEU on this step's accumulator (deterministic injection).
        if (inj_tile && s == g.inj_k)
          add_at(acc, g.inj_row - row0, g.inj_col - col0, g.inj_mag, tid);
        if (SEU && sh.hit && s == sh.step)
          add_at(acc, sh.row, sh.col,
                 seu::magnitude(get_at(acc, sh.row, sh.col, tid) - seu_before,
                                g.seu.shift),
                 tid);
        if constexpr (INNER) {
          // Δ of this step alone, then the checksums restart.
          verify_acc<BM, NT, true>(acc, opa, opb, sc, g, tid, row0, col0,
                                   k_el, false, bx.prevc[0], bx.prevr);
          opa.reset();
          opb.reset();
        } else if (g.verify_step && it + 1 < nst) {
          if constexpr (TILE)
            verify_bands<BM, NT, false, false>(acc, opa, opb, opc, sc, bx, g,
                                               tid, row0, col0, k_el);
          else
            verify_acc<BM, NT>(acc, opa, opb, sc, g, tid, row0, col0, k_el,
                               false);
        }
        if (SEU && sh.hit && s + 1 == sh.step)
          seu_before = get_at(acc, sh.row, sh.col, tid);
      }
    }
  }

  if (g.splits > 1) {
    // ---- split-K: write the f32 partial and the split's record ----------
    // Rows past M are zero (TMA's fill) and are not written, unless the
    // injected SEU lands in one (pad_rows: then the whole block is).
    const long long Mp = (long long)g.gm * BM, Np = (long long)g.gn * kBN;
    float* part = g.ws + (long long)z * Mp * Np;
    const int rbase = row0 + wg * 64 + wl * 16 + lane / 4;
    const bool all_rows = pad_rows(g, row0, col0, BM, sh);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rbase + 8 * i >= g.M && !all_rows) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const long long off =
            (rbase + 8 * i) * Np + col0 + 8 * j + 2 * (lane & 3);
        *reinterpret_cast<float2*>(part + off) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
      }
    }
    if constexpr (FT) {
      if constexpr (TILE) opc.store(&bx.ck[0][0], tid);
      float am, bm;
      reduce_checks<BM, NT>(opa, opb, sc, tid, false, am, bm);
      consumer_sync<NT>();
      float* rec = g.ws + (long long)g.splits * Mp * Np +
                   (((long long)z * g.gm + bi) * g.gn + bj) * kRec;
      if constexpr (TILE)
        for (int i = tid; i < (BM / 16) * kBN; i += NT) rec[i] = (&bx.ck[0][0])[i];
      else
        for (int n = tid; n < kBN; n += NT) rec[n] = sc.dcol[n];
      for (int m = tid; m < BM; m += NT) rec[kRecRow + m] = sc.drow[m];
      if (tid == 0) {
        rec[kRecMax] = am;
        rec[kRecMax + 1] = bm;
        for (int q = 0; q < 8; ++q) rec[kRecRep + q] = sc.rep[q];
      }
    }
    return;
  }

  // ---- epilogue: (tile) final verify, bias, (block) fold and final ------
  // verify, activation, one store
  if constexpr (TILE)
    verify_bands<BM, NT, false, false>(acc, opa, opb, opc, sc, bx, g, tid,
                                       row0, col0, (float)g.K);
  if (g.bias != nullptr) {
    for (int n = tid; n < kBN; n += NT)
      sc.biasv[n] = col0 + n < g.N ? __bfloat162float(g.bias[col0 + n]) : 0.0f;
    consumer_sync<NT>();
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc[4 * j + r] += sc.biasv[8 * j + 2 * (lane & 3) + (r & 1)];
  }
  if constexpr (LV == kLvBlock)
    verify_acc<BM, NT>(acc, opa, opb, sc, g, tid, row0, col0, (float)g.K,
                       g.bias != nullptr);

  // Stage the bf16 tile in the (drained) ring, then 16-byte stores.
  constexpr int PITCH = kBN + 8;   // elements; 272-byte rows
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(ring);
  consumer_sync<NT>();
  stage_tile(acc, stage, PITCH, g.act, false, tid);
  consumer_sync<NT>();
  store_tile<BM, NT>(stage, PITCH, g.out, g.M, g.N, row0, col0, tid);
  if (g.act_grad != nullptr) {
    consumer_sync<NT>();
    stage_tile(acc, stage, PITCH, g.act, true, tid);
    consumer_sync<NT>();
    store_tile<BM, NT>(stage, PITCH, g.act_grad, g.M, g.N, row0, col0, tid);
  }
  if (FT && tid == 0) {
    float* r = g.rep + ((long long)bi * g.gn + bj) * 8;
    for (int q = 0; q < 8; ++q) r[q] = sc.rep[q];
  }
}

// Split-K, second kernel: per output block, the sum of the S f32 partials
// (in split order), the merged report, and by level: "block" the bias
// folded into the summed checksums and the final verification at k = K
// with the maxima over all splits; "tile" the final verification of each
// band against the sum of the splits' band checksums, then the bias;
// "inner" the bias alone. Then the correction, the activation (and
// act_grad) and one bf16 store.
template <int LV, int BM>
__global__ void __launch_bounds__(abft::kThreads)
ft_gemm_sm90_reduce(const Sm90Args g) {
  constexpr bool FT = LV != kLvOff;
  constexpr int P = kBN + 1;
  constexpr int NB = LV == kLvTile ? BM / 16 : 1;   // column checksums
  extern __shared__ float tile[];   // [BM][P]
  __shared__ float colck[NB][kBN], rowck[BM], biasv[kBN], rep[8], mx[2];
  __shared__ abft::VerifySmem<BM, kBN> vs;
  __shared__ abft::BandSmem<NB, 16, kBN> bs;
  const int tid = threadIdx.x;
  const int bi = blockIdx.x, bj = blockIdx.y;
  const int row0 = bi * BM, col0 = bj * kBN;
  const long long Mp = (long long)g.gm * BM, Np = (long long)g.gn * kBN;
  // the bias enters the sum at FT off and "block"; after the verification
  // at "tile", and at "inner"
  const bool bias_first = LV == kLvOff || LV == kLvBlock;
  for (int n = tid; n < kBN; n += abft::kThreads)
    biasv[n] = (g.bias != nullptr && col0 + n < g.N)
                   ? __bfloat162float(g.bias[col0 + n]) : 0.0f;
  __syncthreads();
  const bool all_rows =
      pad_rows(g, row0, col0, BM,
               g.seu.on ? block_seu(g, bi, bj, BM)
                        : seu::Hit{false, 0, 0, 0});
  for (int idx = tid; idx < BM * kBN; idx += abft::kThreads) {
    const int m = idx / kBN, n = idx % kBN;
    const float* p = g.ws + (row0 + m) * Np + col0 + n;
    float s = 0.0f;
    if (row0 + m < g.M || all_rows)
      for (int z = 0; z < g.splits; ++z) s += p[(long long)z * Mp * Np];
    tile[m * P + n] = s + (bias_first ? biasv[n] : 0.0f);
  }
  if constexpr (FT) {
    const float* recs = g.ws + (long long)g.splits * Mp * Np;
    auto rec = [&](int z) {
      return recs + (((long long)z * g.gm + bi) * g.gn + bj) * kRec;
    };
    float bsum = 0.0f;
    if (LV == kLvBlock)
      for (int n = 0; n < kBN; ++n) bsum += biasv[n];
    for (int i = tid; i < NB * kBN; i += abft::kThreads) {
      float c = LV == kLvBlock ? (float)BM * biasv[i % kBN] : 0.0f;
      for (int z = 0; z < g.splits; ++z) c += rec(z)[i];
      (&colck[0][0])[i] = c;
    }
    for (int m = tid; m < BM; m += abft::kThreads) {
      float c = bsum;
      for (int z = 0; z < g.splits; ++z) c += rec(z)[kRecRow + m];
      rowck[m] = c;
    }
    if (tid == 0) {
      float am = 0.0f, bm = 0.0f, r[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int z = 0; z < g.splits; ++z) {
        am = fmaxf(am, rec(z)[kRecMax]);
        bm = fmaxf(bm, rec(z)[kRecMax + 1]);
        abft::merge(r, rec(z) + kRecRep);
      }
      for (int i = 0; i < 8; ++i) rep[i] = r[i];
      mx[0] = am;
      mx[1] = bm;
    }
    __syncthreads();
    const float k_el = (float)g.K;
    const float tau = fmaxf(g.tau_coef * k_el * mx[0] * mx[1], 1e-30f);
    if constexpr (LV == kLvBlock) {
      const Verdict v = abft::verify_rows<kBN>(tile, BM, P, &colck[0][0],
                                               rowck, tau, k_el, g.corrects,
                                               row0, col0, vs, rep);
      if (g.corrects && v.det && tid == 0) tile[v.row * P + v.col] -= v.mag;
    } else if constexpr (LV == kLvTile) {
      abft::verify_bands<NB, 16, kBN>(tile, P, &colck[0][0], rowck, tau, k_el,
                                      g.corrects, row0, col0, bs, rep);
      if (g.corrects && tid < NB && bs.v[tid].det)
        tile[bs.v[tid].row * P + bs.v[tid].col] -= bs.v[tid].mag;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < BM * kBN; idx += abft::kThreads) {
    const int m = idx / kBN, n = idx % kBN;
    const int gr = row0 + m, gc = col0 + n;
    if (gr >= g.M || gc >= g.N) continue;
    const float y = tile[m * P + n] + (bias_first ? 0.0f : biasv[n]);
    const long long o = (long long)gr * g.N + gc;
    if (g.act_grad != nullptr)
      g.act_grad[o] = __float2bfloat16(activate_grad(g.act, y));
    g.out[o] = __float2bfloat16(activate(g.act, y));
  }
  if (FT && tid == 0) {
    float* r = g.rep + ((long long)bi * g.gn + bj) * 8;
    for (int q = 0; q < 8; ++q) r[q] = rep[q];
  }
}


template <int LV, bool AK, bool BK, int BM, bool SEU>
cudaError_t launch_main(const CUtensorMap& ta, const CUtensorMap& tb,
                        const Sm90Args& g, cudaStream_t st) {
  auto kern = ft_gemm_sm90_kernel<LV, AK, BK, BM, SEU>;
  constexpr int smem =
      smem_bytes<BM>() +
      (LV >= kLvTile ? (int)sizeof(BandScratch) : 0);
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  kern<<<dim3(g.gm, g.gn, g.splits), BM * 2 + 128, smem, st>>>(ta, tb, g);
  return cudaGetLastError();
}

template <int LV, int BM>
cudaError_t launch_reduce(const Sm90Args& g, cudaStream_t st) {
  auto kern = ft_gemm_sm90_reduce<LV, BM>;
  constexpr int smem = BM * (kBN + 1) * 4;
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  kern<<<dim3(g.gm, g.gn), abft::kThreads, smem, st>>>(g);
  return cudaGetLastError();
}

// One level's instances: clean / under a campaign (SEU: the hook is a
// template parameter, so the clean instances carry none of its registers)
// x the three operand walks, then (splits > 1) the reduce kernel.
template <int LV, int BM>
cudaError_t launch_level(int a_kmajor, int b_kmajor, const CUtensorMap& ta,
                         const CUtensorMap& tb, const Sm90Args& g,
                         cudaStream_t st) {
  constexpr bool HOOK = LV != kLvOff;
  cudaError_t e = cudaErrorInvalidValue;
  if (HOOK && g.seu.on) {
    if (a_kmajor && !b_kmajor) e = launch_main<LV, true, false, BM, HOOK>(ta, tb, g, st);
    else if (a_kmajor && b_kmajor) e = launch_main<LV, true, true, BM, HOOK>(ta, tb, g, st);
    else if (!b_kmajor) e = launch_main<LV, false, false, BM, HOOK>(ta, tb, g, st);
  } else {
    if (a_kmajor && !b_kmajor) e = launch_main<LV, true, false, BM, false>(ta, tb, g, st);
    else if (a_kmajor && b_kmajor) e = launch_main<LV, true, true, BM, false>(ta, tb, g, st);
    else if (!b_kmajor) e = launch_main<LV, false, false, BM, false>(ta, tb, g, st);
  }
  if (e != cudaSuccess || g.splits == 1) return e;
  return launch_reduce<LV, BM>(g, st);
}

// The launch arguments and tensor maps of a call (the C entries' common
// part); false for arguments the kernels do not take.
bool k1_setup(Sm90Args& g, CUtensorMap& ta, CUtensorMap& tb, const void* a,
              const void* b, const void* bias, void* out, void* act_grad,
              float* rep, float* ws, int M, int N, int K, long long lda,
              long long ldb, int a_kmajor, int b_kmajor, int bm, int splits,
              int act, int verify_step, int corrects, float tau_coef,
              int inj_enable, int inj_row, int inj_col, int inj_k,
              float inj_mag, int seu_on, unsigned seu_seed, float seu_rate,
              int seu_shift) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || (bm != 128 && bm != 64))
    return false;
  g = Sm90Args{};
  g.bias = static_cast<const __nv_bfloat16*>(bias);
  g.out = static_cast<__nv_bfloat16*>(out);
  g.act_grad = static_cast<__nv_bfloat16*>(act_grad);
  g.rep = rep;
  g.ws = ws;
  g.M = M; g.N = N; g.K = K;
  g.gm = (M + bm - 1) / bm;
  g.gn = (N + kBN - 1) / kBN;
  g.nstages = (K + kStageK - 1) / kStageK;
  g.ksteps = (K + kStep - 1) / kStep;
  g.splits = splits;
  g.act = act; g.verify_step = verify_step; g.corrects = corrects;
  g.tau_coef = tau_coef;
  g.inj_enable = inj_enable; g.inj_row = inj_row; g.inj_col = inj_col;
  g.inj_k = inj_k; g.inj_mag = inj_mag;
  g.seu = seu::Args{seu_on, seu_seed, seu_rate, seu_shift};
  if (splits > g.ksteps || g.gn > 65535 || (splits > 1 && ws == nullptr))
    return false;
  const bool ok_a = a_kmajor ? make_map(&ta, a, K, M, lda, kStageK, bm)
                             : make_map(&ta, a, M, K, lda, 64, kStageK);
  const bool ok_b = b_kmajor ? make_map(&tb, b, K, N, ldb, kStageK, kBN)
                             : make_map(&tb, b, N, K, ldb, 64, kStageK);
  return ok_a && ok_b;
}

}  // namespace
