// ABFT GEMM for Hopper on the tensor cores (sm_90a): K1's bf16 2-D
// instances at FT off and at the threadblock ("block") level. C =
// act(A·B + bias) with online Huang–Abraham checksums, one located and
// corrected error per output block per verification.
//
// Replaces the TPU kernel K1 of the JAX package:
//   src/repro/kernels/templates/emit.py:render (2-D body), launched by
//   templates/registry.py:kernel_call.
// The ring, the wgmma and TMA wrappers, the checksum operators and the
// verification live in csrc/sm90_mainloop.cuh, shared with the grouped
// kernels K7 and K8 (csrc/grouped_sm90.cu).
// The SIMT kernel of csrc/ft_gemm.cu keeps f32, the tile and inner levels,
// the batched (K5) and grouped (K7) bodies and every chain or operand walk
// this source does not instantiate; kernels/ft_gemm.py:plan picks between
// the two by a written rule.
//
// What bounds it on the H100, and what the design does about it:
//   * prefill and training shapes (M >= 512) are bound by operations: the
//     MACs are bf16 `wgmma.mma_async` m64n128k16 with f32 accumulators in
//     registers, A and B read from shared memory (wgmma_m64n128k16,
//     sm90_mainloop.cuh:147, issued at line 212), one stage's wgmmas kept
//     in flight
//     while the next stage is waited for. The transpose bits take the three
//     operand walks, so the transposed views of training are never copied:
//     LAYOUT 0 row-major A and B, LAYOUT 1 a B whose k dim has unit stride
//     (w.T in dx = g·Wᵀ), LAYOUT 2 an A whose m dim has unit stride (x.T in
//     dw = Xᵀ·g). CTA tile BM x 128 with one consumer warpgroup per 64 rows
//     (BM 128 for M > 64, else 64), and a producer warpgroup;
//   * decode shapes (M <= 64) are bound by the bytes of B (the weights):
//     one thread of the producer warpgroup keeps a ring of kStages 64-deep
//     stages in flight with TMA (`cp.async.bulk.tensor`, tma_load,
//     sm90_mainloop.cuh:85, issued at lines 166-176; 128-byte swizzle,
//     full / empty
//     mbarriers). The tensor maps are encoded on the host through
//     cudaGetDriverEntryPoint, so the library links no -lcuda; TMA's zero
//     fill replaces the masked loads of the ragged edge. When the gm x gn
//     output blocks number fewer than about two waves of the 132 SMs, each
//     block's k-steps are cut into S contiguous, balanced ranges, one CTA
//     each (split-K, grid z; S from the wave model of
//     kernels/ft_gemm.py:split_count), and a second kernel, launched by the
//     same C entry, sums the f32 partials of the live rows and finishes the
//     block (ft_gemm_sm90_reduce).
// The FT algebra, per 256-deep k-step (the verification interval, the
// reference's bk at its (128, 128, 256) tiles): the consumer warpgroups
// issue a stage's wgmmas, then, while the tensor cores run, take e^T A_s,
// B_s e, max|A| and max|B| from the staged tiles in shared memory (the bytes
// wgmma reads, addressed through the swizzle) and add (e^T A_s)·B_s and
// A_s·(B_s e) to running per-thread checksum partials in f32 (RowOp /
// ColOp), and only then wait for the wgmmas. The checksums ride the CUDA
// cores beside the tensor cores rather than 8 spare columns of the B tile:
// B_s e would have to be rounded to bf16 to enter wgmma, too coarse for
// tau = rel_tau·eps32·k·max|A|·max|B|. That CUDA-core work is what the FT
// instances pay over FT off. Verification (verify_acc) reduces the column
// and row sums of the accumulator from the wgmma fragment layout with warp
// shuffles and a small exchange in shared memory (the block is never
// stored), locates the first argmax per warp and across warps, records with
// the shared abft::record, and the thread that owns (row, col) subtracts
// the magnitude. verify="step" verifies after every k-step but a split's
// last; the epilogue folds the bias into the checksums (counted on every
// tile row, padding rows included), verifies at k = K, corrects, applies
// the activation (and writes act_grad), and stores C through shared memory
// with 16-byte stores.
//
// Split-K report rule: each split verifies after each of its k-steps but
// its last, with its own elapsed k and its own running maxima in tau; the
// reduce kernel merges the splits' reports in split order (det and corr
// add, row / col / mag from the last detection, max_residual the max), then
// verifies the sum at k = K with the maxima over all splits (tau and k from
// this final verification). kernels/ft_gemm.py:ft_gemm_plain walks the same
// split grid.
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "seu_hook.cuh"
#include "sm90_mainloop.cuh"

namespace {

constexpr int kRec = 272;                // split record: colck[128],
                                         // rowck[128], amax, bmax, rep[8]

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

template <bool FT, bool AK, bool BK, int BM, bool SEU>
__global__ void __launch_bounds__(BM * 2 + 128, 1)
ft_gemm_sm90_kernel(const __grid_constant__ CUtensorMap tma_a,
                    const __grid_constant__ CUtensorMap tma_b,
                    const Sm90Args g) {
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
  opa.init();
  opb.init();
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
      // While the tensor cores run: the stage's checksums from its tiles.
      float* ka = sc.ks[it & 1][0];
      float* kb = sc.ks[it & 1][1];
      opa.load(pa, tid);
      opb.load(pb, tid);
      opa.ksum(ka, tid);
      opb.ksum(kb, tid);
      consumer_sync<NT>();
      opa.dot(kb, tid);
      opb.dot(ka, tid);
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
        // Emulated SEU on this step's accumulator (deterministic injection).
        if (inj_tile && s == g.inj_k)
          add_at(acc, g.inj_row - row0, g.inj_col - col0, g.inj_mag, tid);
        if (SEU && sh.hit && s == sh.step)
          add_at(acc, sh.row, sh.col,
                 seu::magnitude(get_at(acc, sh.row, sh.col, tid) - seu_before,
                                g.seu.shift),
                 tid);
        if (g.verify_step && it + 1 < nst)
          verify_acc<BM, NT>(acc, opa, opb, sc, g, tid, row0, col0,
                             (float)(min((s + 1) * kStep, g.K) - s_lo * kStep),
                             false);
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
      float am, bm;
      reduce_checks<BM, NT>(opa, opb, sc, tid, false, am, bm);
      consumer_sync<NT>();
      float* rec = g.ws + (long long)g.splits * Mp * Np +
                   (((long long)z * g.gm + bi) * g.gn + bj) * kRec;
      for (int n = tid; n < kBN; n += NT) rec[n] = sc.dcol[n];
      for (int m = tid; m < BM; m += NT) rec[kBN + m] = sc.drow[m];
      if (tid == 0) {
        rec[2 * kBN] = am;
        rec[2 * kBN + 1] = bm;
        for (int q = 0; q < 8; ++q) rec[2 * kBN + 2 + q] = sc.rep[q];
      }
    }
    return;
  }

  // ---- epilogue: bias, fold, final verify, activation, one store --------
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
  if constexpr (FT)
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
// (in split order) and of their checksums, the bias fold, the final
// verification at k = K with the maxima over all splits, the correction,
// the activation (and act_grad), one bf16 store, and the merged report.
template <bool FT, int BM>
__global__ void __launch_bounds__(abft::kThreads)
ft_gemm_sm90_reduce(const Sm90Args g) {
  constexpr int P = kBN + 1;
  extern __shared__ float tile[];   // [BM][P]
  __shared__ float colck[kBN], rowck[BM], biasv[kBN], rep[8], mx[2];
  __shared__ abft::VerifySmem<BM, kBN> vs;
  const int tid = threadIdx.x;
  const int bi = blockIdx.x, bj = blockIdx.y;
  const int row0 = bi * BM, col0 = bj * kBN;
  const long long Mp = (long long)g.gm * BM, Np = (long long)g.gn * kBN;
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
    tile[m * P + n] = s + biasv[n];
  }
  if constexpr (FT) {
    const float* recs = g.ws + (long long)g.splits * Mp * Np;
    auto rec = [&](int z) {
      return recs + (((long long)z * g.gm + bi) * g.gn + bj) * kRec;
    };
    float bsum = 0.0f;
    for (int n = 0; n < kBN; ++n) bsum += biasv[n];
    for (int n = tid; n < kBN; n += abft::kThreads) {
      float c = (float)BM * biasv[n];
      for (int z = 0; z < g.splits; ++z) c += rec(z)[n];
      colck[n] = c;
    }
    for (int m = tid; m < BM; m += abft::kThreads) {
      float c = bsum;
      for (int z = 0; z < g.splits; ++z) c += rec(z)[kBN + m];
      rowck[m] = c;
    }
    if (tid == 0) {
      float am = 0.0f, bm = 0.0f, r[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      for (int z = 0; z < g.splits; ++z) {
        const float* q = rec(z) + 2 * kBN;
        am = fmaxf(am, q[0]);
        bm = fmaxf(bm, q[1]);
        r[0] += q[2];
        r[1] += q[3];
        if (q[2] > 0.0f) {
          r[2] = q[4];
          r[3] = q[5];
          r[4] = q[6];
        }
        r[5] = fmaxf(r[5], q[7]);
      }
      for (int i = 0; i < 8; ++i) rep[i] = r[i];
      mx[0] = am;
      mx[1] = bm;
    }
    __syncthreads();
    const float k_el = (float)g.K;
    const float tau = fmaxf(g.tau_coef * k_el * mx[0] * mx[1], 1e-30f);
    const Verdict v = abft::verify_rows<kBN>(tile, BM, P, colck, rowck, tau,
                                             k_el, g.corrects, row0, col0, vs,
                                             rep);
    if (g.corrects && v.det && tid == 0) tile[v.row * P + v.col] -= v.mag;
  }
  __syncthreads();
  for (int idx = tid; idx < BM * kBN; idx += abft::kThreads) {
    const int m = idx / kBN, n = idx % kBN;
    const int gr = row0 + m, gc = col0 + n;
    if (gr >= g.M || gc >= g.N) continue;
    const float y = tile[m * P + n];
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


template <bool FT, bool AK, bool BK, int BM, bool SEU>
cudaError_t launch_main(const CUtensorMap& ta, const CUtensorMap& tb,
                        const Sm90Args& g, cudaStream_t st) {
  auto kern = ft_gemm_sm90_kernel<FT, AK, BK, BM, SEU>;
  constexpr int smem = smem_bytes<BM>();
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

template <bool FT, int BM>
cudaError_t launch_reduce(const Sm90Args& g, cudaStream_t st) {
  auto kern = ft_gemm_sm90_reduce<FT, BM>;
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

// The instances: FT off / block / block under a campaign (SEU: the hook is a
// template parameter, so the clean instances carry none of its registers)
// x the three operand walks x BM 128 / 64.
template <bool FT, int BM, bool SEU = false>
cudaError_t launch_walk(int a_kmajor, int b_kmajor, const CUtensorMap& ta,
                        const CUtensorMap& tb, const Sm90Args& g,
                        cudaStream_t st) {
  if (a_kmajor && !b_kmajor)
    return launch_main<FT, true, false, BM, SEU>(ta, tb, g, st);
  if (a_kmajor && b_kmajor)
    return launch_main<FT, true, true, BM, SEU>(ta, tb, g, st);
  if (!a_kmajor && !b_kmajor)
    return launch_main<FT, false, false, BM, SEU>(ta, tb, g, st);
  return cudaErrorInvalidValue;
}

template <int BM>
cudaError_t launch_bm(int ft, int a_kmajor, int b_kmajor, const CUtensorMap& ta,
                      const CUtensorMap& tb, const Sm90Args& g,
                      cudaStream_t st) {
  cudaError_t e =
      g.seu.on ? launch_walk<true, BM, true>(a_kmajor, b_kmajor, ta, tb, g, st)
      : ft     ? launch_walk<true, BM>(a_kmajor, b_kmajor, ta, tb, g, st)
               : launch_walk<false, BM>(a_kmajor, b_kmajor, ta, tb, g, st);
  if (e != cudaSuccess || g.splits == 1) return e;
  return ft ? launch_reduce<true, BM>(g, st) : launch_reduce<false, BM>(g, st);
}

}  // namespace

extern "C" {

const char* ft_gemm_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// C = act(A·B + bias) with bf16 A (M, K) and B (K, N). a_kmajor: A's k dim
// has unit stride and its rows are lda elements apart (else its m dim has
// unit stride and k rows are lda apart); b_kmajor: B's k dim has unit
// stride and its n columns are ldb apart (else B is row-major with k rows
// ldb apart). bias: nullptr or (N,); out and act_grad (nullptr or (M, N))
// contiguous row-major; rep (gm, gn, 8) with ft; ws: with splits > 1, f32
// of splits·(gm·bm·gn·128 + gm·gn·272) elements. bm: 128 or 64. act: 0
// none, 1 silu. The injection (deterministic SEU) adds
// inj_mag at global (inj_row, inj_col) after 256-deep k-step inj_k;
// seu_*: the stochastic hook's campaign (seu_hook.cuh).
// Launches the main kernel and, with splits > 1, the reduce kernel;
// returns the first cudaError_t.
int ft_gemm_sm90_launch(const void* a, const void* b, const void* bias,
                        void* out, void* act_grad, float* rep, float* ws,
                        int M, int N, int K, long long lda, long long ldb,
                        int a_kmajor, int b_kmajor, int bm, int splits, int ft,
                        int act, int verify_step, int corrects, float tau_coef,
                        int inj_enable, int inj_row, int inj_col, int inj_k,
                        float inj_mag, int seu_on, unsigned seu_seed,
                        float seu_rate, int seu_shift, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || (bm != 128 && bm != 64))
    return cudaErrorInvalidValue;
  Sm90Args g{};
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
    return cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  const bool ok_a = a_kmajor ? make_map(&ta, a, K, M, lda, kStageK, bm)
                             : make_map(&ta, a, M, K, lda, 64, kStageK);
  const bool ok_b = b_kmajor ? make_map(&tb, b, K, N, ldb, kStageK, kBN)
                             : make_map(&tb, b, N, K, ldb, 64, kStageK);
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bm == 128 ? launch_bm<128>(ft, a_kmajor, b_kmajor, ta, tb, g, st)
                   : launch_bm<64>(ft, a_kmajor, b_kmajor, ta, tb, g, st);
}

}  // extern "C"