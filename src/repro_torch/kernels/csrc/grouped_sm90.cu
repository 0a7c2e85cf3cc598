// Grouped ABFT GEMMs of the MoE layer for Hopper on the tensor cores
// (sm_90a): K7's and K8's bf16 instances at every FT level, on the
// mainloop of csrc/ft_gemm_sm90.cuh, whose pieces they share through
// csrc/sm90_mainloop.cuh (so this source builds beside K1's in parallel
// and K1's instances carry no branch of the groups).
//
// Replaces the TPU kernels of the JAX package:
//   K7  src/repro/kernels/templates/emit.py:233 render (grouped body),
//       launched by templates/registry.py:520 batched_kernel_call with
//       grouped=True: y_buf = chain(buf @ w[gid]) over a group-sorted
//       buffer, the chain an aux-free runtime list of activations; at
//       "inner" its Δ verification (emit.py:432-442), at "tile" its
//       per-band column checksums and _verify_raw (emit.py:443-481);
//   K8  src/repro/kernels/templates/emit.py:527 render_tgmm, launched by
//       templates/registry.py:411 tgmm_kernel_call: dw[g] = X_g^T · G_g in
//       f32 over two buffers of one layout; at "tile" its per-band column
//       checksums of dw, at "inner" its Δ verification (emit.py:658-711).
// The SIMT kernels keep f32 and their pinned tiles (csrc/ft_gemm.cu
// GROUPED, csrc/tgmm.cu); kernels/grouped_gemm.py:plan_k7 / plan_k8 pick
// the instance by a written rule.
//
// The layout (kernels/grouped/layout.py) is unchanged: each group's
// region starts at row_end[g-1] rounded up to the 16-row layout tile and
// ends at row_end[g] rounded up (the last group's on to the end of the
// buffer); gid maps each 16-row tile to its group.
//
// K7 (grouped_sm90_kernel). What bounds it: the bytes of the expert
// weights at every main-path shape (decode 64 rows over 128 experts, the
// 8 192-row dbuf of training). The design reads each live expert's
// weight slab once per 64-row chunk of its group and keeps a TMA ring of it
// in flight:
//   * the grid is static over (16-row layout tile, 128-column block); the
//     CTA whose tile starts a chunk (its group's base, then every 64 rows)
//     owns the chunk's rows [row0, min(row0 + 64, region end)), every
//     other CTA exits at once. One consumer warpgroup, a 64 x 128 tile,
//     bf16 `wgmma.mma_async` m64n128k16 with f32 accumulators (issued at
//     line 274; the wrapper is sm90_mainloop.cuh:147), 256-deep k-steps
//     of four 64-deep ring stages;
//   * one producer thread feeds the ring with TMA (`cp.async.bulk.tensor`,
//     issued at lines 234-239; tma_load / tma_load_3d at
//     sm90_mainloop.cuh:85 / 97): the buffer through a
//     2-D map, the weights through ONE 3-D map over (G, K, N) (or over its
//     w^T view, the dbuf product) whose third coordinate is the group, so
//     one map serves every CTA; maps encoded on the host through
//     cudaGetDriverEntryPoint (no -lcuda);
//   * masking: the staged A tile's rows at or past the group's row_end
//     belong to the next group (TMA brings them in). The consumer threads
//     zero those rows of the staged tile in shared memory (`zero_rows`,
//     line 263, then `fence.proxy.async` and a consumer barrier) before
//     the stage's wgmmas, so the accumulator, e^T A, max|A|, the
//     verification and the store see only the group's rows, as K1 sees
//     TMA's zero fill on the ragged edge;
//   * the FT algebra is K1's (RowOp / ColOp take the checksums from the
//     staged tiles while the MACs run; verify_acc per 256-deep k-step with
//     verify="step", and at k = K), tau = rel_tau·eps32·k·max|A|·max|B|;
//   * the chunk stays 64 rows, the wgmma's M, at decode too (one or two
//     live rows a chunk there), with K1's 128 columns: the shared
//     checksum operators and verification are written for that tile, and
//     the decode launches already hold 4-13 waves of CTAs; a narrower N
//     side (more, smaller CTAs per expert) was not built or measured;
//   * a chunk with no live row (the buffer's dead tail) writes zeros and
//     the clean record (tau 1e-30, k = K) at once, unless an SEU is aimed at
//     it or drawn for one of its tiles; the chunk's record goes in its
//     first layout tile's report row, the clean record in the others, so
//     the report keeps its shape (T / 16, gn, 8);
//   * the tile level's band is one consumer warp's 16 rows, one layout
//     tile: the band column checksums (e_b^T A_s)·B_s run on the tensor
//     cores beside the wgmmas (BandOp, sm90_mainloop.cuh: the band sums
//     from the staged A tile's chunks, three bf16 parts of them against
//     the staged B tile by m16n8k16 `mma.sync`), and each band is
//     verified, located and corrected on its own at every interval and at
//     k = K (verify_bands), recording into its own tile's report row;
//   * the inner level verifies each k-step's Δ band by band: the band's
//     column and row sums of the accumulator less those at the step before
//     (kept in shared memory, no second register tile: K7 runs at over 200
//     registers a thread) against the step's own band checksums, which
//     restart each step; one SEU per layout tile per step is corrected, as
//     in the reference's per-tile grid, and an SEU left by detect-only
//     cancels out of the next step's Δ (counted once). No final
//     verification;
//   * stochastic SEU campaigns (seu_hook.cuh) run their own instances
//     (SEU): each layout tile draws its SEU as the reference's per-tile
//     block does, uid tile·gn + j, over 16 x 128 and the ceil(K / 256)
//     k-steps; the warp of its band keeps the element at the end of the
//     step before the drawn one (0 before the first) and adds the magnitude
//     of the difference after it. Four tiles' SEUs can share one interval
//     of a chunk, so a campaign at "block" runs the tile level's per-band
//     instance (the same function for K7, whose chain is aux-free: no
//     fold), and at "inner" the inner one with the hook;
//   * the chain (chain_ops, 3 bits an op, activate_chain in
//     sm90_mainloop.cuh) is applied to the f32 accumulator after the final
//     verification (after the last step's at "inner"; alone with FT off),
//     at every level and in the campaign instances, then the tile is
//     rounded to bf16 and stored, as the reference's render applies it
//     (emit.py:487-512). Rows past the group's row_end hold what the
//     reference's do: chain(0) = 0 for silu, gelu and relu, or the chain
//     of an SEU left there by detect-only; a chunk with no live row
//     writes zeros, chain(0).
//
// K8 (tgmm_sm90_kernel). What bounds it: the f32 write of dw (3.2 GB at
// the training shape, 128 experts x 4 096 x 1 536). One CTA per (group,
// 128-row block of K, 128-column block of N) on K1's LAYOUT 2 walk: A =
// X_g^T with unit stride in m, B = G_g row-major, two consumer warpgroups
// (`wgmma_m64n128k16<1, 1>` and the four TMA loads of a stage in
// tgmm_sm90_kernel), one kernel templated on the level as K1's is:
//   * the reduction runs over the group's rows from its aligned base to its
//     region end (the last group's on to the end of the buffer) in 64-row
//     ring stages; the rows at or past row_end are zeroed in both staged
//     tiles before the wgmmas. Only stages holding a live row are loaded:
//     the rest (the last group's dead tail) add nothing, so they are only
//     verified (the verifications repeat the last verdict unless one
//     corrects; the remaining ones are run until one leaves the block as it
//     is and the rest added to the report at once, as csrc/tgmm.cu does);
//   * the verification interval is one 64-row stage (four layout tiles):
//     verify="step" verifies after every stage, "final" after the last;
//     tau = rel_tau·eps32·rows·max|X|·max|G| with rows the live rows reduced
//     so far; the injection's k_step is the global layout row tile and
//     lands at the end of the stage that holds it;
//   * "tile": the band is the 16 dw rows one consumer warp owns in the
//     wgmma fragment (8 bands a 128-row block, spec.SM90_BAND). A band's
//     running column checksum is (X_g e_b)^T·G_g: the stage's band sums of
//     the staged X tile after its masking (ColOp::band_ksum) times the
//     staged G tile on the tensor cores (BandOp, `mma.sync`), in place of
//     the block's CUDA-core column dot; the row checksum stays the block's.
//     Each band is verified, located and corrected on its own
//     (verify_bands: one SEU per band per interval) after each stage under
//     verify="step" and after the last, and thread 0 records the bands in
//     band order into the block's one report (kernels/ft_gemm.py:
//     locate_bands). In the dead stages a band left by detect-only counts
//     at each later verification, as in the plain version's walk;
//   * "inner": each stage's Δ is verified alone against the stage's own
//     checksums, which restart every stage: Δ's column and row sums are the
//     accumulator's less those at the stage before, kept in shared memory
//     (verify_acc with DELTA, K1's form; no second register tile at 232
//     registers a thread); one SEU per block per stage is corrected, one
//     left by detect-only cancels out of the next Δ (counted once); no final
//     verification, and a dead stage's Δ, zero, is verified only when the
//     deterministic SEU is aimed at it;
//   * the f32 block is staged in the drained ring and stored with 16-byte
//     stores; an empty group's CTAs write a zero block and a
//     zero report, so the front door makes no pass over dw;
//   * stochastic SEU campaigns (seu_hook.cuh): each CTA draws its dw
//     block's SEU, uid (group·gk + k-block)·gn + n-block, over the group's
//     16-row tiles that hold a live row (the reference's group-local tile
//     step) and the 128 x 128 block; the magnitude comes from the hit
//     tile's own product at the element (a 16-term dot of the staged X and
//     G rows, `staged_at`) and lands at the end of the stage that holds
//     the tile, as the deterministic SEU does (at "tile" in the band that
//     holds its row, at "inner" in its stage's Δ). The hook is in every FT
//     instance: one hash a CTA and a 16-term dot in one stage.
//
// Registers (-Xptxas -v, the env phase of chip_smoke.py): K7's FT-off and
// block instances use 105 and 205-215 registers without spills (the
// band instances: PERF.md); K8's 384-thread CTA is held to 168 registers a thread
// (the register file of one SM over 384 threads; setmaxnreg then gives the
// consumer warpgroups 232), and its block instance spills 20 bytes there,
// as K1's 128-row LAYOUT 2 block instance spills 4: the verification's
// locals, once per 64-row interval, against a 64 KB store of the block
// (the level instances: PERF.md, from tools/ptxas_probe.py).
//
// Reports, f32[8]: [detected, corrected, row, col, magnitude,
// max_residual, tau, k_elapsed (K7) or rows_reduced (K8)]; K7's rows are
// global buffer rows, K8's rows and cols dw's (K, N).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "seu_hook.cuh"
#include "sm90_mainloop.cuh"

namespace {

constexpr int kTile = 16;    // the layout's row tile
constexpr int kChunk = 64;   // K7: rows a CTA owns

struct GroupedArgs {
  const int* gid;       // K7: (T / 16,) owning group of each layout tile
  const int* row_end;   // (G,) first dead buffer row of each group
  void* out;            // K7: y (T, N) bf16; K8: dw (G, K, N) f32
  float* rep;           // K7: (T / 16, gn, 8); K8: (G, gk, gn, 8)
  int T, N, K, G, gk, gn, nstages, ksteps;
  int verify_step, corrects;
  float tau_coef;       // rel_tau * eps32
  int inj_enable, inj_row, inj_col, inj_k;
  float inj_mag;
  seu::Args seu;        // the stochastic hook's campaign
  int chain_ops, chain_len;   // K7: the activations applied to y
};

__device__ __forceinline__ int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// A group's region of the buffer: [base, end), its live rows [base, row_hi).
struct Region {
  int base, row_hi, end;
};

__device__ __forceinline__ Region region_of(const GroupedArgs& g, int grp) {
  Region r;
  r.base = round_up(grp > 0 ? g.row_end[grp - 1] : 0, kTile);
  r.row_hi = g.row_end[grp];
  r.end = grp == g.G - 1 ? g.T : round_up(r.row_hi, kTile);
  return r;
}

// Zero the rows [lim, 64) of `boxes` consecutive staged boxes of 64 rows of
// 128 bytes (whole rows, so the swizzle does not matter), by NT threads,
// and order the writes before the wgmmas' reads (the caller's barrier
// follows).
template <int NT>
__device__ __forceinline__ void zero_rows(uint8_t* tile, int boxes, int lim,
                                          int tid) {
  const int per_box = (64 - lim) * 8;   // 16-byte chunks
  for (int c = tid; c < boxes * per_box; c += NT) {
    const int b = c / per_box, q = c % per_box;
    *reinterpret_cast<uint4*>(tile + b * kBoxBytes + lim * 128 + q * 16) =
        make_uint4(0, 0, 0, 0);
  }
  fence_proxy_async();
}

// K7's report row of a layout tile that verified nothing: a clean all-zero
// block (tau 1e-30, k = K), as the SIMT kernel writes for a dead tile.
__device__ __forceinline__ void clean_record(float* r, int K) {
  for (int q = 0; q < 6; ++q) r[q] = 0.0f;
  r[6] = 1e-30f;
  r[7] = (float)K;
}

// Element (k, x) of a staged 64-row stage tile whose x dim is contiguous
// (K8's X and G tiles: x / 64 selects the 64 x 64 box, 128-byte swizzle).
__device__ __forceinline__ float staged_at(const uint8_t* tile, int k, int x) {
  const uint8_t* p = tile + (x / 64) * kBoxBytes + k * 128 +
                     ((((x % 64) / 8) ^ (k % 8)) << 4) + (x % 8) * 2;
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}

// ---------------------------------------------------------------------------
// K7: y_buf = buf @ w[gid], one 64-row chunk of one group per CTA
// ---------------------------------------------------------------------------

template <int LV, bool BK, bool SEU>
__global__ void __launch_bounds__(256, 1)
grouped_sm90_kernel(const __grid_constant__ CUtensorMap tma_a,
                    const __grid_constant__ CUtensorMap tma_w,
                    const GroupedArgs g) {
  constexpr bool FT = LV != kLvOff;
  // BANDS: each 16-row band verified on its own (tile; a block campaign)
  constexpr bool BANDS = LV == kLvTile, INNER = LV == kLvInner;
  constexpr int BM = 64, NT = 128;
  constexpr int A_BYTES = BM * kStageK * 2, B_BYTES = kBN * kStageK * 2;
  constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  using OpA = RowOp<BM, NT>;
  using OpB = typename std::conditional<BK, RowOp<kBN, NT>, ColOp<kBN, NT>>::type;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Scratch<BM>& sc =
      *reinterpret_cast<Scratch<BM>*>(ring + kStages * STAGE_BYTES);
  BandScratch& bx = *reinterpret_cast<BandScratch*>(
      ring + kStages * STAGE_BYTES + sizeof(Scratch<BM>));

  const int tid = threadIdx.x;
  const int ti = blockIdx.x, bj = blockIdx.y;
  const int row0 = ti * kTile, col0 = bj * kBN;
  const int grp = g.gid[ti];
  const Region reg = region_of(g, grp);
  // Chunks start at the group's base, kChunk rows apart: the CTA of any
  // other layout tile has nothing to do.
  if ((row0 - reg.base) % kChunk != 0) return;
  const int m_hi = min(row0 + kChunk, reg.end);   // the chunk: [row0, m_hi)
  const int lim = min(max(reg.row_hi - row0, 0), BM);   // live staged rows
  const bool inj_tile = FT && g.inj_enable && g.inj_row >= row0 &&
                        g.inj_row < m_hi && g.inj_col >= col0 &&
                        g.inj_col < col0 + kBN;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(g.out);
  float* rep = FT ? g.rep + ((long long)ti * g.gn + bj) * 8 : nullptr;
  const int tiles = (m_hi - row0) / kTile;
  // The stochastic SEU of each layout tile of the chunk (its band).
  bool any_hit = false;
  if (SEU)
    for (int q = 0; q < tiles; ++q)
      any_hit |= seu::draw(g.seu, (uint32_t)((ti + q) * g.gn + bj),
                           g.ksteps, kTile, kBN).hit;

  if (lim == 0 && !(inj_tile && g.inj_k >= 0 && g.inj_k < g.ksteps) &&
      !any_hit) {
    // No live row and no SEU aimed here: zeros and the clean records.
    for (int c = tid; c < (m_hi - row0) * kBN; c += blockDim.x) {
      const int gr = row0 + c / kBN, gc = col0 + c % kBN;
      if (gc < g.N) out[(long long)gr * g.N + gc] = __float2bfloat16(0.0f);
    }
    if (FT)
      for (int q = tid; q < tiles; q += blockDim.x)
        clean_record(rep + (long long)q * g.gn * 8, g.K);
    return;
  }

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sc.full[s], 1);
      mbar_init(&sc.empty[s], NT / 32);
    }
    for (int q = 0; q < 8; ++q) sc.rep[q] = 0.0f;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (BANDS || INNER) {
    for (int i = tid; i < 2 * 8 * 64; i += blockDim.x) (&bx.ks[0][0][0])[i] = 0.0f;
    for (int i = tid; i < 8 * kBN; i += blockDim.x) (&bx.prevc[0][0])[i] = 0.0f;
    for (int i = tid; i < 128; i += blockDim.x) bx.prevr[i] = 0.0f;
    for (int i = tid; i < 8 * 8; i += blockDim.x) (&bx.rep[0][0])[i] = 0.0f;
  }
  __syncthreads();

  const int nst = g.nstages;
  if (tid >= NT) {
    // ---- producer warpgroup: one thread keeps the TMA ring full ----------
    if (tid == NT) {
      for (int it = 0; it < nst; ++it) {
        const int slot = it % kStages;
        if (it >= kStages) mbar_wait(&sc.empty[slot], ((it / kStages) & 1) ^ 1);
        uint64_t* bar = &sc.full[slot];
        mbar_expect_tx(bar, STAGE_BYTES);
        uint8_t* sa = ring + slot * STAGE_BYTES;
        uint8_t* sb = sa + A_BYTES;
        const int k0 = it * kStageK;
        tma_load(sa, &tma_a, k0, row0, bar);
        if (BK) {
          tma_load_3d(sb, &tma_w, k0, col0, grp, bar);
        } else {
          tma_load_3d(sb, &tma_w, col0, k0, grp, bar);
          tma_load_3d(sb + kBoxBytes, &tma_w, col0 + 64, k0, grp, bar);
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup --------------------------------------------------
  const int lane = tid & 31, wl = tid / 32;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  OpA opa;
  OpB opb;
  BandOp<NT, BK> opc;   // tile, inner: the band column checksums
  opa.init();
  opb.init();
  opc.init();
  // This warp's band: its tile's stochastic SEU, rows local to the chunk.
  seu::Hit sh = SEU && wl < tiles
                    ? seu::draw(g.seu, (uint32_t)((ti + wl) * g.gn + bj),
                                g.ksteps, kTile, kBN)
                    : seu::Hit{false, 0, 0, 0};
  sh.row += 16 * wl;
  // The hit element before its step: 0 at the first, else kept at the end
  // of the step before (the wgmmas drained there).
  float seu_before = 0.0f;

  int pending = -1;   // a stage whose wgmmas may still run: released later
  for (int it = 0; it < nst; ++it) {
    const int slot = it % kStages;
    mbar_wait(&sc.full[slot], (it / kStages) & 1);
    uint8_t* pa = ring + slot * STAGE_BYTES;
    const uint8_t* pb = pa + A_BYTES;
    if (lim < BM) {   // the next group's rows: masked before the MACs
      zero_rows<NT>(pa, 1, lim, tid);
      consumer_sync<NT>();
    }
    const uint32_t sa = smem_u32(pa);
    const uint32_t sb = smem_u32(pb);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStageK / 16; ++kk) {
      const uint64_t da = make_desc(sa + kk * 32, 16);
      const uint64_t db = make_desc(sb + (BK ? kk * 32 : kk * 2048), BK ? 16 : kBoxBytes);
      wgmma_m64n128k16<0, BK ? 0 : 1>(acc, da, db);
    }
    wgmma_commit();
    if constexpr (FT) {
      // While the tensor cores run: the stage's checksums from its tiles
      // (tile, inner: the column checksum per 16-row band).
      float* ka = sc.ks[it & 1][0];
      float* kb = sc.ks[it & 1][1];
      opa.load(pa, tid);
      opb.load(pb, tid);
      opa.ksum(ka, tid);
      if constexpr (BANDS || INNER) opa.band_ksum(&bx.ks[it & 1][0][0], tid);
      opb.ksum(kb, tid);
      consumer_sync<NT>();
      opa.dot(kb, tid);
      if constexpr (BANDS || INNER) opc.dot(pb, &bx.ks[it & 1][0][0], tid);
      else opb.dot(ka, tid);
    }
    const bool step_end = (it + 1) % kStagesPerStep == 0 || it + 1 == nst;
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
        const int s = it / kStagesPerStep;   // the k-step just ended
        const float k_el = (float)min((s + 1) * kStep, g.K);
        if (inj_tile && s == g.inj_k)
          add_at(acc, g.inj_row - row0, g.inj_col - col0, g.inj_mag, tid);
        if (SEU && sh.hit && s == sh.step)
          add_at(acc, sh.row, sh.col,
                 seu::magnitude(get_at(acc, sh.row, sh.col, tid) - seu_before,
                                g.seu.shift),
                 tid);
        if constexpr (INNER) {
          // each band's Δ of this step alone, then the checksums restart
          verify_bands<BM, NT, true, true>(acc, opa, opb, opc, sc, bx, g,
                                           tid, row0, col0, k_el);
          opa.reset();
          opc.init();
        } else if (g.verify_step && it + 1 < nst) {
          if constexpr (BANDS)
            verify_bands<BM, NT, true, false>(acc, opa, opb, opc, sc, bx, g,
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
  if constexpr (BANDS)
    verify_bands<BM, NT, true, false>(acc, opa, opb, opc, sc, bx, g, tid,
                                      row0, col0, (float)g.K);
  else if constexpr (LV == kLvBlock)
    verify_acc<BM, NT>(acc, opa, opb, sc, g, tid, row0, col0, (float)g.K,
                       false);

  // The chain on the verified accumulator; stage the bf16 tile in the
  // (drained) ring, then 16-byte stores of the chunk's rows.
  if (g.chain_len > 0) {
#pragma unroll
    for (int i = 0; i < 64; ++i)
      acc[i] = activate_chain(g.chain_ops, g.chain_len, acc[i]);
  }
  constexpr int PITCH = kBN + 8;
  __nv_bfloat16* stage = reinterpret_cast<__nv_bfloat16*>(ring);
  consumer_sync<NT>();
  stage_tile(acc, stage, PITCH, 0, false, tid);
  consumer_sync<NT>();
  store_tile<BM, NT>(stage, PITCH, out, m_hi, g.N, row0, col0, tid);
  if (BANDS || INNER) {
    for (int q = tid; q < tiles * 8; q += NT)
      rep[(long long)(q / 8) * g.gn * 8 + q % 8] = bx.rep[q / 8][q % 8];
  } else if (FT) {
    if (tid == 0)
      for (int q = 0; q < 8; ++q) rep[q] = sc.rep[q];
    for (int q = 1 + tid; q < tiles; q += NT)
      clean_record(rep + (long long)q * g.gn * 8, g.K);
  }
}

// ---------------------------------------------------------------------------
// K8: dw[g] = X_g^T · G_g, one (group, 128-row block of K, 128-column
// block of N) per CTA
// ---------------------------------------------------------------------------

// The f32 block of dw at (row0, col0), from `stage` (pitch floats a row) or
// zeros when stage is null, by NT threads with 16-byte stores (element
// stores where N is not a multiple of 4).
template <int NT>
__device__ __forceinline__ void store_block_f32(const float* stage, int pitch,
                                                float* dst, int row0, int col0,
                                                int M, int N, int tid) {
  const bool vec = (N % 4) == 0;
  for (int c = tid; c < 128 * (kBN / 4); c += NT) {
    const int r = c / (kBN / 4), q = c % (kBN / 4);
    const int gr = row0 + r, gc = col0 + q * 4;
    if (gr >= M || gc >= N) continue;
    float* d = dst + (long long)gr * N + gc;
    const float* s = stage + r * pitch + q * 4;
    if (vec) {
      *reinterpret_cast<float4*>(d) = stage != nullptr
          ? *reinterpret_cast<const float4*>(s) : make_float4(0, 0, 0, 0);
    } else {
      for (int e = 0; e < 4 && gc + e < N; ++e)
        d[e] = stage != nullptr ? s[e] : 0.0f;
    }
  }
}

// K8's verification of its dw block at `rows` reduced, by level: the
// block's running checksums (block), each 16-row band's (tile), or the
// stage's Δ, after which the stage checksums restart (inner). Returns the
// detections (the bands' at tile; 0 at inner).
template <int LV, typename OpA, typename OpB, typename OpC>
__device__ __forceinline__ int verify_dw(float (&acc)[64], OpA& opa,
                                         OpB& opb, const OpC& opc,
                                         Scratch<128>& sc, BandScratch& bx,
                                         const GroupedArgs& g, int tid,
                                         int m0, int col0, float rows) {
  if constexpr (LV == kLvInner) {
    verify_acc<128, 256, true>(acc, opa, opb, sc, g, tid, m0, col0, rows,
                               false, bx.prevc[0], bx.prevr);
    opa.reset();
    opb.reset();
    return 0;
  } else if constexpr (LV == kLvTile) {
    verify_bands<128, 256, false, false>(acc, opa, opb, opc, sc, bx, g, tid,
                                         m0, col0, rows);
    int det = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) det += bx.verdict[b].det;
    return det;
  } else {
    verify_acc<128, 256>(acc, opa, opb, sc, g, tid, m0, col0, rows, false);
    return sc.verdict.det;
  }
}

template <int LV>
__global__ void __launch_bounds__(384, 1)
tgmm_sm90_kernel(const __grid_constant__ CUtensorMap tma_x,
                 const __grid_constant__ CUtensorMap tma_g,
                 const GroupedArgs g) {
  constexpr bool FT = LV != kLvOff;
  constexpr bool TILE = LV == kLvTile, INNER = LV == kLvInner;
  constexpr int BM = 128, NT = 256;
  constexpr int A_BYTES = BM * kStageK * 2, B_BYTES = kBN * kStageK * 2;
  constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  using OpA = ColOp<BM, NT>;
  using OpB = ColOp<kBN, NT>;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  Scratch<BM>& sc =
      *reinterpret_cast<Scratch<BM>*>(ring + kStages * STAGE_BYTES);
  // tile / inner only: the band scratch after Scratch<BM>
  BandScratch& bx = *reinterpret_cast<BandScratch*>(
      ring + kStages * STAGE_BYTES + sizeof(Scratch<BM>));

  const int tid = threadIdx.x;
  const int bj = blockIdx.x, bi = blockIdx.y, grp = blockIdx.z;
  const int m0 = bi * BM, col0 = bj * kBN;
  const Region reg = region_of(g, grp);
  float* out = static_cast<float*>(g.out) + (long long)grp * g.K * g.N;
  float* rep = FT ? g.rep + (((long long)grp * g.gk + bi) * g.gn + bj) * 8
                  : nullptr;
  if (reg.row_hi <= reg.base) {
    // An empty group (no row routed to it): a zero block, a zero report.
    store_block_f32<BM * 2 + 128>(nullptr, 0, out, m0, col0, g.K, g.N, tid);
    if (FT && tid < 8) rep[tid] = 0.0f;
    return;
  }
  const int n_st = (reg.end - reg.base + kStageK - 1) / kStageK;
  const int n_live = (reg.row_hi - reg.base + kStageK - 1) / kStageK;
  const bool inj_block = FT && g.inj_enable && g.inj_row >= m0 &&
                         g.inj_row < m0 + BM && g.inj_col >= col0 &&
                         g.inj_col < col0 + kBN;
  const int inj_r = g.inj_k * kTile;   // the aimed layout tile's first row
  const int s_inj = inj_block && inj_r >= reg.base && inj_r < reg.end
                        ? (inj_r - reg.base) / kStageK : -1;
  // The stochastic SEU: a step is a live 16-row tile from the group's base.
  const seu::Hit sh =
      FT ? seu::draw(g.seu,
                     (uint32_t)(((long long)grp * g.gk + bi) * g.gn + bj),
                     (reg.row_hi - reg.base + kTile - 1) / kTile, BM, kBN)
         : seu::Hit{false, 0, 0, 0};
  const int s_seu = sh.hit ? sh.step * kTile / kStageK : -1;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sc.full[s], 1);
      mbar_init(&sc.empty[s], NT / 32);
    }
    for (int q = 0; q < 8; ++q) sc.rep[q] = 0.0f;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (INNER) {
    // the accumulator's sums before the first stage are 0
    for (int i = tid; i < kBN; i += blockDim.x) bx.prevc[0][i] = 0.0f;
    for (int i = tid; i < BM; i += blockDim.x) bx.prevr[i] = 0.0f;
  }
  __syncthreads();

  if (tid >= NT) {
    // ---- producer warpgroup: the stages that hold a live row -------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == NT) {
      for (int it = 0; it < n_live; ++it) {
        const int slot = it % kStages;
        if (it >= kStages) mbar_wait(&sc.empty[slot], ((it / kStages) & 1) ^ 1);
        uint64_t* bar = &sc.full[slot];
        mbar_expect_tx(bar, STAGE_BYTES);
        uint8_t* sa = ring + slot * STAGE_BYTES;
        uint8_t* sb = sa + A_BYTES;
        const int r0 = reg.base + it * kStageK;
        tma_load(sa, &tma_x, m0, r0, bar);
        tma_load(sa + kBoxBytes, &tma_x, m0 + 64, r0, bar);
        tma_load(sb, &tma_g, col0, r0, bar);
        tma_load(sb + kBoxBytes, &tma_g, col0 + 64, r0, bar);
      }
    }
    return;
  }

  // ---- consumer warpgroups -------------------------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = tid / 128, wl = (tid % 128) / 32, lane = tid & 31;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  OpA opa;
  OpB opb;
  BandOp<NT, false> opc;   // tile: the band column checksums
  opa.init();
  opb.init();
  opc.init();
  float seu_d = 0.0f;   // the hit tile's product at the hit element
  auto rows_at = [&](int s) {   // live rows reduced after stage s
    return (float)max(min(reg.base + (s + 1) * kStageK, reg.row_hi) -
                      reg.base, 1);
  };

  int pending = -1;
  for (int it = 0; it < n_live; ++it) {
    const int slot = it % kStages;
    mbar_wait(&sc.full[slot], (it / kStages) & 1);
    uint8_t* pa = ring + slot * STAGE_BYTES;
    const uint8_t* pb = pa + A_BYTES;
    const int lim = reg.row_hi - (reg.base + it * kStageK);
    if (lim < kStageK) {   // rows past row_end in X and G: masked
      zero_rows<NT>(pa, 4, lim, tid);
      consumer_sync<NT>();
    }
    const uint32_t sa = smem_u32(pa) + wg * kBoxBytes;
    const uint32_t sb = smem_u32(pb);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kStageK / 16; ++kk) {
      const uint64_t da = make_desc(sa + kk * 2048, kBoxBytes);
      const uint64_t db = make_desc(sb + kk * 2048, kBoxBytes);
      wgmma_m64n128k16<1, 1>(acc, da, db);
    }
    wgmma_commit();
    if constexpr (FT) {
      // While the tensor cores run: the stage's checksums from its masked
      // tiles (tile: each band's column checksum in place of the block's).
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
      if (it == s_seu) {
        // The hit tile's own product at the element, from its 16 staged
        // rows (masked past row_end above).
        const int r0 = (sh.step * kTile) % kStageK;
        for (int r = 0; r < kTile; ++r)
          seu_d = fmaf(staged_at(pa, r0 + r, sh.row),
                       staged_at(pb, r0 + r, sh.col), seu_d);
      }
    }
    // Every stage is a verification interval under FT: drain it.
    const bool drain = it + 1 == n_live || FT;
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
      if (it == s_inj)
        add_at(acc, g.inj_row - m0, g.inj_col - col0, g.inj_mag, tid);
      if (it == s_seu)
        add_at(acc, sh.row, sh.col, seu::magnitude(seu_d, g.seu.shift), tid);
      if (INNER || g.verify_step || it == n_st - 1)
        verify_dw<LV>(acc, opa, opb, opc, sc, bx, g, tid, m0, col0,
                      rows_at(it));
    }
  }
  if constexpr (FT) {
    // The dead stages (the last group's tail) add nothing: verified only.
    if (n_live < n_st) {
      const float rows = rows_at(n_st - 1);
      if (s_inj >= n_live) {
        for (int s = n_live; s < n_st; ++s) {
          if (s == s_inj)
            add_at(acc, g.inj_row - m0, g.inj_col - col0, g.inj_mag, tid);
          // inner: a dead stage's Δ is zero but the aimed one's
          if (INNER ? s == s_inj : (g.verify_step || s == n_st - 1))
            verify_dw<LV>(acc, opa, opb, opc, sc, bx, g, tid, m0, col0, rows);
        }
      } else if constexpr (!INNER) {
        // Each verification repeats the last verdict until one corrects:
        // run them until one leaves the block as it is, add the rest (a
        // band left by detect-only counts at each of them).
        const int nv = g.verify_step ? n_st - n_live : 1;
        for (int q = 0; q < nv; ++q) {
          const int det = verify_dw<LV>(acc, opa, opb, opc, sc, bx, g, tid,
                                        m0, col0, rows);
          if (!(det && g.corrects)) {
            if (tid == 0) sc.rep[0] += (float)(det * (nv - 1 - q));
            break;
          }
        }
      }
    }
  }

  // ---- the dw block: staged in the drained ring, 16-byte stores ----------
  constexpr int P = kBN + 8;   // floats; 544-byte rows, conflict-free float2
  float* stage = reinterpret_cast<float*>(ring);
  consumer_sync<NT>();
  const int rl = wg * 64 + wl * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(stage + (rl + 8 * i) * P + 8 * j +
                                 2 * (lane & 3)) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  consumer_sync<NT>();
  store_block_f32<NT>(stage, P, out, m0, col0, g.K, g.N, tid);
  if (FT && tid == 0)
    for (int q = 0; q < 8; ++q) rep[q] = sc.rep[q];
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename Kern>
cudaError_t set_smem(Kern kern, int smem, bool& ready) {
  if (ready) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) ready = true;
  return e;
}

template <int LV, bool BK, bool SEU = false>
cudaError_t launch_grouped(const CUtensorMap& ta, const CUtensorMap& tw,
                           const GroupedArgs& g, cudaStream_t st) {
  auto kern = grouped_sm90_kernel<LV, BK, SEU>;
  constexpr int smem =
      smem_bytes<64>() + (LV >= kLvTile ? (int)sizeof(BandScratch) : 0);
  static bool ready = false;
  const cudaError_t e = set_smem(kern, smem, ready);
  if (e != cudaSuccess) return e;
  kern<<<dim3(g.T / kTile, g.gn), 256, smem, st>>>(ta, tw, g);
  return cudaGetLastError();
}

template <int LV>
cudaError_t launch_tgmm(const CUtensorMap& tx, const CUtensorMap& tg,
                        const GroupedArgs& g, cudaStream_t st) {
  auto kern = tgmm_sm90_kernel<LV>;
  constexpr int smem =
      smem_bytes<128>() + (LV >= kLvTile ? (int)sizeof(BandScratch) : 0);
  static bool ready = false;
  const cudaError_t e = set_smem(kern, smem, ready);
  if (e != cudaSuccess) return e;
  kern<<<dim3(g.gn, g.gk, g.G), 384, smem, st>>>(tx, tg, g);
  return cudaGetLastError();
}

// K8's instance of a level (the stochastic hook is in every FT instance).
cudaError_t launch_k8(int level, const CUtensorMap& tx, const CUtensorMap& tg,
                      const GroupedArgs& g, cudaStream_t st) {
  switch (level) {
    case kLvOff: return launch_tgmm<kLvOff>(tx, tg, g, st);
    case kLvBlock: return launch_tgmm<kLvBlock>(tx, tg, g, st);
    case kLvTile: return launch_tgmm<kLvTile>(tx, tg, g, st);
    case kLvInner: return launch_tgmm<kLvInner>(tx, tg, g, st);
  }
  return cudaErrorInvalidValue;
}

// K7's instance of a level: a campaign ("block", "tile": the per-band
// instance with the hook; "inner": the inner one with it; seu_on only
// comes with FT on) or a clean one.
template <bool BK>
cudaError_t launch_k7(int level, const CUtensorMap& ta, const CUtensorMap& tw,
                      const GroupedArgs& g, cudaStream_t st) {
  switch (level) {
    case kLvOff:
      return launch_grouped<kLvOff, BK>(ta, tw, g, st);
    case kLvBlock:
      return g.seu.on ? launch_grouped<kLvTile, BK, true>(ta, tw, g, st)
                      : launch_grouped<kLvBlock, BK>(ta, tw, g, st);
    case kLvTile:
      return g.seu.on ? launch_grouped<kLvTile, BK, true>(ta, tw, g, st)
                      : launch_grouped<kLvTile, BK>(ta, tw, g, st);
    case kLvInner:
      return g.seu.on ? launch_grouped<kLvInner, BK, true>(ta, tw, g, st)
                      : launch_grouped<kLvInner, BK>(ta, tw, g, st);
  }
  return cudaErrorInvalidValue;
}

void set_common(GroupedArgs& g, int verify_step, int corrects, float tau_coef,
                int inj_enable, int inj_row, int inj_col, int inj_k,
                float inj_mag, int seu_on, unsigned seu_seed, float seu_rate,
                int seu_shift) {
  g.verify_step = verify_step; g.corrects = corrects; g.tau_coef = tau_coef;
  g.inj_enable = inj_enable; g.inj_row = inj_row; g.inj_col = inj_col;
  g.inj_k = inj_k; g.inj_mag = inj_mag;
  g.seu = seu::Args{seu_on, seu_seed, seu_rate, seu_shift};
}

}  // namespace

extern "C" {

const char* grouped_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K7. a: the (T, K) bf16 group-sorted buffer, rows lda elements apart (k
// unit stride); w: (G, K, N) bf16 with group stride sw_g and, with
// w_kmajor = 0, k rows ldw apart (n unit stride), with w_kmajor = 1 (the
// w^T view of the dbuf product) n columns ldw apart (k unit stride); gid
// int32 (T / 16,), row_end int32 (G,); out (T, N) bf16 and, with ft, rep
// (T / 16, ceil(N / 128), 8) contiguous. level: 0 FT off, 1 block, 2
// tile, 3 inner (kLv*; kernels/ft_gemm.py:SM90_LEVELS). chain_ops:
// chain_len (at most 10) activations applied to y in order, op i in bits
// 3i..3i+2 (kernels/ft_gemm.py:CHAIN_OPS: 3 silu, 4 gelu, 5 relu). The
// injection adds inj_mag at global buffer row inj_row, column inj_col
// after 256-deep k-step inj_k. Returns the launch's cudaError_t.
int grouped_sm90_launch(const void* a, const void* w, const int* gid,
                        const int* row_end, void* out, float* rep, int T,
                        int N, int K, int G, long long lda, long long ldw,
                        long long sw_g, int w_kmajor, int level,
                        int chain_ops, int chain_len, int verify_step,
                        int corrects, float tau_coef, int inj_enable,
                        int inj_row, int inj_col, int inj_k, float inj_mag,
                        int seu_on, unsigned seu_seed, float seu_rate,
                        int seu_shift, void* stream) {
  if (T <= 0 || N <= 0 || K <= 0 || G <= 0 || T % kTile != 0 ||
      !activation_chain_ok(chain_ops, chain_len))
    return cudaErrorInvalidValue;
  GroupedArgs g{};
  g.gid = gid; g.row_end = row_end; g.out = out; g.rep = rep;
  g.chain_ops = chain_ops; g.chain_len = chain_len;
  g.T = T; g.N = N; g.K = K; g.G = G;
  g.gn = (N + kBN - 1) / kBN;
  g.nstages = (K + kStageK - 1) / kStageK;
  g.ksteps = (K + kStep - 1) / kStep;
  set_common(g, verify_step, corrects, tau_coef, inj_enable, inj_row, inj_col,
             inj_k, inj_mag, seu_on, seu_seed, seu_rate, seu_shift);
  if (g.gn > 65535) return cudaErrorInvalidValue;
  CUtensorMap ta, tw;
  const bool ok = make_map(&ta, a, K, T, lda, kStageK, 64) &&
      (w_kmajor ? make_map3(&tw, w, K, N, G, ldw, sw_g, kStageK, kBN)
                : make_map3(&tw, w, N, K, G, ldw, sw_g, 64, kStageK));
  if (!ok) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return w_kmajor ? launch_k7<true>(level, ta, tw, g, st)
                  : launch_k7<false>(level, ta, tw, g, st);
}

// K8. x (T, K) and gm (T, N) bf16 buffers of one layout, rows ldx / ldg
// elements apart (unit stride along K / N); row_end int32 (G,); out (G, K,
// N) f32 and, with FT on, rep (G, ceil(K / 128), ceil(N / 128), 8)
// contiguous. level: 0 FT off, 1 block, 2 tile, 3 inner (kLv*;
// kernels/ft_gemm.py:SM90_LEVELS). The injection's row and col index dw,
// inj_k is a 16-row layout tile. Returns the launch's cudaError_t.
int tgmm_sm90_launch(const void* x, const void* gm, const int* row_end,
                     float* out, float* rep, int T, int K, int N, int G,
                     long long ldx, long long ldg, int level, int verify_step,
                     int corrects, float tau_coef, int inj_enable, int inj_row,
                     int inj_col, int inj_k, float inj_mag, int seu_on,
                     unsigned seu_seed, float seu_rate, int seu_shift,
                     void* stream) {
  if (T <= 0 || N <= 0 || K <= 0 || G <= 0 || T % kTile != 0)
    return cudaErrorInvalidValue;
  GroupedArgs g{};
  g.row_end = row_end; g.out = out; g.rep = rep;
  g.T = T; g.N = N; g.K = K; g.G = G;
  g.gk = (K + 127) / 128;
  g.gn = (N + kBN - 1) / kBN;
  set_common(g, verify_step, corrects, tau_coef, inj_enable, inj_row, inj_col,
             inj_k, inj_mag, seu_on, seu_seed, seu_rate, seu_shift);
  if (g.gk > 65535 || G > 65535) return cudaErrorInvalidValue;
  CUtensorMap tx, tg;
  if (!make_map(&tx, x, K, T, ldx, 64, kStageK) ||
      !make_map(&tg, gm, N, T, ldg, 64, kStageK))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_k8(level, tx, tg, g, st);
}

}  // extern "C"
