// Flash-attention backward with online ABFT on the tensor cores (sm_90a):
// K3 (dQ) and K4 (dK, dV) for bf16 operands at head dim 128.
//
// Replaces the TPU kernels K3 and K4 of the JAX package:
//   src/repro/kernels/flashft.py:_flash_dq_kernel (line 488, launched by
//   templates/registry.py:flash_dq_call) and
//   src/repro/kernels/flashft.py:_flash_dkv_kernel (line 569, launched by
//   templates/registry.py:flash_dkv_call).
// It computes what the SIMT kernels of csrc/flash_ft_bwd.cu compute, on
// the same 64 x 64 block grid with the same thresholds and 8-float
// report; that source keeps f32, head dim 64, pinned blocks and operands
// TMA cannot read, and kernels/flashft.py:plan_bwd picks between the two.
// P = exp(min(scale·S - m, 0)) / l comes from the saved (m, l) (rows with
// l = 0, among them every row past the true Sq, get p = 0), di =
// rowsum(g ∘ o) from the wrapper, dS = P ∘ (dP - di) · scale. Every
// product is verified with the Huang–Abraham checksums of its operand
// tiles, located and corrected per step:
//   S  = Q·Kᵀ   tau = rel_tau·eps32·round_up(dh, 128)·max|Q|·max|K|, k = 1
//   dP = g·Vᵀ   tau = rel_tau·eps32·round_up(dh, 128)·max|g|·max|V|, k = that dh
//   dQ += dS·K  tau = rel_tau·eps32·eff_kv·max|dS|·max|K|, k = eff_kv
//   dV += Pᵀ·g  tau = rel_tau·eps32·eff_q·max|P|·max|g|,   k = eff_q
//   dK += dSᵀ·Q tau = rel_tau·eps32·eff_q·max|dS|·max|Q|,  k = eff_q
// with eff_kv = min(Skv - kv_start, 64) and eff_q = max(min(Sq - q_start,
// 64), 1). Reports follow abft::record, in the reference's order (S, dP,
// then the deltas).
//
// What bounds them on the H100: at the training shapes (S 512, dh 128,
// causal) their bounds are a few microseconds (K3 by the bytes of q, k, v,
// g, K4 by its operations); what sets the pace is each step's chain of
// dependent work: two products, their verifications, P and dS, one or two
// delta products and theirs, most of it on the CUDA cores of one SM with
// few warps to hide its latency (PERF.md). The design:
//   * every product runs on the tensor cores: bf16 `wgmma` m64n64k16 for S
//     and dP (Q, g, K and V read K-major from their staged tiles),
//     m64n128k16 for the deltas with K, g or Q read N-major (their rows
//     the k dim) and dS or P read K-major (K3) or M-major (K4, the
//     transposes); f32 accumulators in registers;
//   * the streamed tiles come in by TMA (3-D tensor maps over (head, row,
//     dh), so rows past Sq or Skv read zero) into a ring of two stages
//     kept full by one producer warp, 128-byte swizzled as wgmma reads
//     them; the stationary tiles (K3: Q and g; K4: K and V) are loaded
//     once;
//   * P and dS are f32 values. One bf16 rounding would move each product
//     term by up to 2^-9 relative and leave a checksum taken from the f32
//     values about a hundred times tau off the product, a false detection
//     every step. So each is written to shared memory as hi = bf16(x) and
//     lo = bf16(x - hi) (hi + lo exact in f32, about 16 bits), each
//     product that reads them runs as two wgmmas into one accumulator, and
//     its checksums are taken from hi + lo as staged: from the operands the
//     tensor cores consumed. Q's, K's, g's and V's checksums come from
//     their staged bf16 tiles;
//   * two consumer warpgroups split each step, so that the two halves of
//     the chain overlap and the SM has eight warps to interleave: in both
//     kernels warpgroup 0 computes S and P and hands P to warpgroup 1
//     through shared memory (named barriers "P staged" / "P read");
//     warpgroup 1 computes dP and dS; the delta dS·K (K3) is warpgroup 1's,
//     the deltas Pᵀ·g and dSᵀ·Q (K4) one each. Each warpgroup records its
//     verifications in its own report with the walk position of its last
//     detection, and merge_pair combines them in the reference's order;
//   * the checksums run on the CUDA cores while the step's wgmmas run, on
//     16-byte chunks of the staged tiles (col_reduce, row_dot); the
//     verification reduces the accumulator's column and row sums from the
//     wgmma fragment with warp shuffles (verify_frag), locates the first
//     argmax, records with abft::record and corrects in the registers;
//   * the two warpgroups run one code path, their roles picked by
//     pointers (only P and dS branch), which keeps the kernels'
//     instructions few: with K4's four verifications and six column
//     reductions inlined as separate code, every phase of it ran slower
//     than the same code in K3 (the instruction cache);
//   * K3: one CTA per (query head, 64-row q block), the long causal blocks
//     (high q index) first; dQ stays in warpgroup 1's registers;
//   * K4: one CTA per (kv head, 64-row kv block, range of the walk): the
//     n_rep x live-q-block walk of each (kv head, kv block), query head
//     first, is cut into `ranges` contiguous, balanced ranges
//     (kernels/flashft.py:dkv_ranges fills about two waves of the 132
//     SMs); K and V stay in shared memory, Q, g and the statistics of each
//     step come through the ring, dV and dK stay in the warpgroups'
//     registers. At one range the kernel writes dK, dV and the report; at
//     more, each range writes f32 partials and its report, and
//     flash_dkv_sm90_reduce sums the partials in range order, casts them
//     and merges the reports with abft::merge (tau and k from the last
//     range that verified). No atomics, so sums and "the last detection"
//     do not depend on timing.
// Stochastic SEU campaigns (seu_hook.cuh, salts 0x52 and 0x53 reduced on
// the host) run in their own instances (SEU = true), so a clean call runs
// the code it ran before the hook: K3 draws each q block's SEU by its uid
// h·nqb + qi over its live kv steps and lands it in that step's dQ delta
// (warpgroup 1); K4 draws each kv block's SEU by its uid b·nkvb + kvi over
// its whole walk, every range the same draw, and the range whose steps
// hold the drawn one lands it in that step's dV delta (warpgroup 0); both
// after the two products of hi and lo and the deterministic SEU, before
// the verification (the reference's flashft.py:519-521, :555-556 and
// :609-616, :655-656).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

constexpr int kRing = 2;                 // ring stages
constexpr int kBwdThreads = 2 * kNT + 32;  // two, and a producer warp
constexpr int kStats = 1024;             // K4 stage: m, 1/l, di (64 each)
constexpr int kDkvStage = 2 * kTile + kStats;

enum Target { kDP = 0, kDQ = 1, kDV = 2, kDK = 3 };
// Named barriers: each consumer warpgroup's own (1, 2); between the two,
// "P staged" and "P read" (3, 4) and the end of the walk (5).
enum Bar { kBarWg0 = 1, kBarWg1 = 2, kBarP = 3, kBarPRead = 4, kBarEnd = 5 };

struct BwdArgs {
  const float* m;
  const float* l;
  const float* di;
  __nv_bfloat16* dq;   // K3: (bh, sq, 128)
  __nv_bfloat16* dk;   // K4: (bh / n_rep, skv, 128) each
  __nv_bfloat16* dv;
  float* rep;          // K3: (bh, nqb, 8); K4 at one range: (g, nkvb, 8)
  float* ws;           // K4 at ranges > 1: partials and range reports
  int bh, sq, skv, n_rep, nqb, nkvb, ranges, causal, corrects;
  float scale;
  float tau_qk_coef;   // rel_tau * eps32 * round_up(dh, 128)
  float tau_coef;      // rel_tau * eps32
  float tau_dh;        // round_up(dh, 128), the k field of the dP record
  int inj_enable, inj_target, inj_bh, inj_blk, inj_step, inj_row, inj_col;
  float inj_mag;
  seu::Args seu;       // the stochastic hook's campaign
};

// The deterministic SEU, when this step and this product are its target.
template <int N>
__device__ __forceinline__ void inject(float (&acc)[N / 2], const BwdArgs& g,
                                       bool hit, int target, int tid) {
  if (hit && g.inj_target == target && g.inj_row >= 0 && g.inj_row < kB &&
      g.inj_col >= 0 && g.inj_col < N)
    frag_add<N>(acc, g.inj_row, g.inj_col, g.inj_mag, tid);
}

// P of one step in place on the S accumulator (q rows q_start + i, kv
// columns kv_start + j) from the saved m and 1/l of the 64 q rows:
// exp(min(scale·S - m, 0)) / l on the live cells, 0 elsewhere. Returns
// this thread's max |P|.
__device__ __forceinline__ float probs(float (&s)[32], const BwdArgs& g,
                                       int q_start, int kv_start,
                                       const float* m_s, const float* linv_s,
                                       int tid) {
  const int lane = tid & 31, c_off = g.skv - g.sq;
  const int i0 = (tid / 32) * 16 + lane / 4;
  const float mr[2] = {m_s[i0], m_s[i0 + 8]};
  const float lr[2] = {linv_s[i0], linv_s[i0 + 8]};
  float pm = 0.0f;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gi = q_start + i0 + 8 * hf;
        const int kpos = kv_start + 8 * j + 2 * (lane & 3) + e;
        const int idx = 4 * j + 2 * hf + e;
        const bool live = kpos < g.skv && gi < g.sq &&
                          (!g.causal || gi + c_off >= kpos);
        s[idx] = live ? __expf(fminf(s[idx] * g.scale - mr[hf], 0.0f)) * lr[hf]
                      : 0.0f;
        pm = fmaxf(pm, fabsf(s[idx]));
      }
  return pm;
}

// dS = P ∘ (dP - di) · scale in place on the dP accumulator, with di of
// the 64 q rows. Returns this thread's max |dS|.
__device__ __forceinline__ float grads(const float (&p)[32], float (&dp)[32],
                                       const float* di_s, float scale,
                                       int tid) {
  const int i0 = (tid / 32) * 16 + (tid & 31) / 4;
  const float dr[2] = {di_s[i0], di_s[i0 + 8]};
  float dsm = 0.0f;
#pragma unroll
  for (int idx = 0; idx < 32; ++idx) {
    dp[idx] = p[idx] * (dp[idx] - dr[(idx >> 1) & 1]) * scale;
    dsm = fmaxf(dsm, fabsf(dp[idx]));
  }
  return dsm;
}

constexpr int kPbuf = 32 * kNT * 4;   // P in fragment order, 16 KB

// One consumer warpgroup's scratch: S or dP is its score product A·Bᵀ and
// X·B2 or Xᵀ·B2 its delta.
struct WgScratch {
  float part[2][4 * kDh];   // col_reduce's partials, two halves in turn
  float asum[kDh];          // e^T A
  float bsum[kDh];          // B^T e (K3; K4 keeps K's and V's)
  float ck_col[kDh], ck_row[kB];
  float brow[kB];           // B2 e (K4)
  float xrow[kB];           // e^T X (K3) or X e (K4)
  float red[2][4];
  FragVerify vf;
  float rep[8];
  float last;               // walk position of its last detection, -1 none
};

// The report of a step walk whose verifications two warpgroups record,
// each into its own rep with the walk position of its last detection: the
// second warpgroup records each step's last verification, so its tau and
// k are the walk's (abft::merge); row / col / mag come from the later of
// the two last detections.
__device__ __forceinline__ void merge_pair(const float* rep0, float last0,
                                           const float* rep1, float last1,
                                           float* out) {
  float r[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  abft::merge(r, rep0);
  abft::merge(r, rep1);
  if (last0 > last1)
    for (int f = 2; f < 5; ++f) r[f] = rep0[f];
  for (int f = 0; f < 8; ++f) out[f] = r[f];
}

// ---------------------------------------------------------------------------
// K3: dQ = Σ_kv dS·K
// ---------------------------------------------------------------------------

struct DqSmem {
  uint64_t full[kRing], empty[kRing], qg;
  float m[kB], linv[kB], di[kB];
  float krow[kB];           // K e (wg 1, the delta's row checksum)
  WgScratch wg[2];
};

constexpr int dq_smem_bytes() {
  return 1024 + 2 * kTile + kRing * 2 * kTile + 2 * kHalf + kPbuf +
         (int)sizeof(DqSmem);
}

// Two consumer warpgroups share each step: warpgroup 0 computes S = Q·Kᵀ
// and P, and hands P to warpgroup 1 through shared memory; warpgroup 1
// computes dP = g·Vᵀ, dS, the delta dS·K and keeps dQ in registers. Each
// keeps its own report; the two are merged at the end in the reference's
// order (S, dP, the delta a step). SEU: the instance of campaigns.
template <bool SEU>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tg,
                     const BwdArgs g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Gs = Qs + kTile;
  uint8_t* ring = Gs + kTile;                 // [kRing] x (K tile, V tile)
  uint8_t* ds_hi = ring + kRing * 2 * kTile;
  uint8_t* ds_lo = ds_hi + kHalf;
  float* pbuf = reinterpret_cast<float*>(ds_lo + kHalf);
  DqSmem& sc = *reinterpret_cast<DqSmem*>(pbuf + 32 * kNT);

  const int tid = threadIdx.x;
  const int h = blockIdx.x, qi = g.nqb - 1 - blockIdx.y;   // long blocks first
  const int kvh = h / g.n_rep, q_start = qi * kB, c_off = g.skv - g.sq;
  const int nkv = (g.skv + kB - 1) / kB, hi_row = q_start + kB - 1 + c_off;
  const int nsteps = !g.causal ? nkv : (hi_row < 0 ? 0 : min(nkv, hi_row / kB + 1));

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&sc.full[s], 1);
      mbar_init(&sc.empty[s], 2 * kNT / 32);
    }
    mbar_init(&sc.qg, 1);
    for (int w = 0; w < 2; ++w) {
      for (int f = 0; f < 8; ++f) sc.wg[w].rep[f] = 0.0f;
      sc.wg[w].last = -1.0f;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 2 * kNT) {
    // ---- producer warp: Q and g once, then the K and V ring ----------
    if (tid == 2 * kNT) {
      mbar_expect_tx(&sc.qg, 2 * kTile);
      load_tile(Qs, &tq, q_start, h, &sc.qg);
      load_tile(Gs, &tg, q_start, h, &sc.qg);
      for (int it = 0; it < nsteps; ++it) {
        const int slot = it % kRing;
        if (it >= kRing) mbar_wait(&sc.empty[slot], ((it / kRing) & 1) ^ 1);
        uint8_t* st = ring + slot * 2 * kTile;
        mbar_expect_tx(&sc.full[slot], 2 * kTile);
        load_tile(st, &tk, it * kB, kvh, &sc.full[slot]);
        load_tile(st + kTile, &tv, it * kB, kvh, &sc.full[slot]);
      }
    }
    return;
  }

  // ---- consumer warpgroups -----------------------------------------------
  // wg 0: A = Q, B = K (S); wg 1: A = g, B = V (dP).
  const int wg = tid / kNT, t = tid % kNT, bar = kBarWg0 + wg;
  WgScratch& w = sc.wg[wg];
  const uint8_t* at = wg ? Gs : Qs;
  const long long rbase = (long long)h * g.sq;
  if (t < kB) {   // the statistics of the 64 q rows; past Sq p = 0
    const int gi = q_start + t;
    const bool live = gi < g.sq;
    if (wg == 0) {
      const float l = live ? g.l[rbase + gi] : 0.0f;
      sc.m[t] = live ? g.m[rbase + gi] : kNegInf;
      sc.linv[t] = l > 0.0f ? 1.0f / fmaxf(l, 1e-30f) : 0.0f;
    } else {
      sc.di[t] = live ? g.di[rbase + gi] : 0.0f;
    }
  }
  mbar_wait(&sc.qg, 0);
  float am;
  col_reduce<kDh>(at, nullptr, nullptr, w.asum, w.part[0], &am, t, bar);
  const float amax = wg_max2(am, 0.0f, w.red, t, bar).x;   // max |Q|, |g|

  float dq[64];   // wg 1
#pragma unroll
  for (int i = 0; i < 64; ++i) dq[i] = 0.0f;
  const bool hit_blk = g.inj_enable && h == g.inj_bh && qi == g.inj_blk;
  const seu::Hit sh =
      SEU ? seu::draw(g.seu, (uint32_t)(h * g.nqb + qi), nsteps, kB, kDh)
          : seu::Hit{false, 0, 0, 0};

  for (int it = 0; it < nsteps; ++it) {
    const int slot = it % kRing, kv_start = it * kB;
    const bool hit = hit_blk && it == g.inj_step;
    mbar_wait(&sc.full[slot], (it / kRing) & 1);
    const uint8_t* Ks = ring + slot * 2 * kTile;
    const uint8_t* bt = wg ? Ks + kTile : Ks;

    // S = Q·Kᵀ or dP = g·Vᵀ on the tensor cores, while its checksums come
    // from the staged tiles: column (e^T A)·B[j], row A[i]·(B^T e); wg 1
    // also K e and max |K| for the delta.
    float sd[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sd[i] = 0.0f;
    fence_frag(sd);
    wgmma_fence();
    mma_abt(sd, at, bt);
    wgmma_commit();
    float bm, km = 0.0f;
    col_reduce<kDh>(bt, nullptr, nullptr, w.bsum, w.part[1], &bm, t, bar);
    if (t < kB) {
      w.ck_col[t] = row_dot<kDh>(bt, nullptr, t, w.asum, nullptr, nullptr);
    } else if (wg) {
      float x;
      row_dot<kDh>(Ks, nullptr, t - kB, nullptr, &x, &km);
      sc.krow[t - kB] = x;
    }
    wg_sync(bar);
    if (t < kB) w.ck_row[t] = row_dot<kDh>(at, nullptr, t, w.bsum, nullptr, nullptr);
    const float2 mx = wg_max2(bm, km, w.red, t, bar);   // max |B|, max |K|
    wgmma_wait<0>();
    fence_frag(sd);
    if (wg) inject<kB>(sd, g, hit, kDP, t);
    const Verdict vs = verify_frag<kB>(
        sd, w.ck_col, w.ck_row, g.tau_qk_coef * amax * mx.x,
        wg ? g.tau_dh : 1.0f, g.corrects, q_start, kv_start, w.vf, w.rep, t,
        bar);
    if (vs.det && t == 0) w.last = (float)(3 * it + wg);

    if (wg == 0) {
      // P, handed to wg 1 in fragment order.
      probs(sd, g, q_start, kv_start, sc.m, sc.linv, t);
      if (it > 0) pair_sync(kBarPRead);   // wg 1 has read the last P
#pragma unroll
      for (int i = 0; i < 32; ++i) pbuf[i * kNT + t] = sd[i];
      pair_arrive(kBarP);
    } else {
      // dS as hi / lo halves, then delta = dS·K: both halves into one
      // accumulator, K's tile read N-major.
      float pf[32];
      pair_sync(kBarP);
#pragma unroll
      for (int i = 0; i < 32; ++i) pf[i] = pbuf[i * kNT + t];
      pair_arrive(kBarPRead);
      const float dsm_t = grads(pf, sd, sc.di, g.scale, t);
      store_frag_hilo(sd, ds_hi, ds_lo, t);
      fence_proxy_async();
      const float dsm = wg_max2(dsm_t, 0.0f, w.red, t, bar).x;
      float dl[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) dl[i] = 0.0f;
      fence_frag(dl);
      wgmma_fence();
      mma_ab<0>(dl, ds_hi, Ks);
      mma_ab<0>(dl, ds_lo, Ks);
      wgmma_commit();
      // Its checksums from hi + lo as staged: column (e^T dS)·K, row
      // dS·(K e).
      if (t < kB)
        w.ck_row[t] = row_dot<kB>(ds_hi, ds_lo, t, sc.krow, nullptr, nullptr);
      col_reduce<kB>(ds_hi, ds_lo, nullptr, w.xrow, w.part[0], nullptr, t,
                     bar);
      wg_sync(bar);
      col_reduce<kDh>(Ks, nullptr, w.xrow, w.ck_col, w.part[1], nullptr, t,
                      bar);
      wgmma_wait<0>();
      fence_frag(dl);
      inject<kDh>(dl, g, hit, kDQ, t);
      if (SEU && sh.hit && it == sh.step)
        frag_seu<kDh>(dl, sh.row, sh.col, g.seu.shift, t);
      const float eff_kv = (float)min(g.skv - kv_start, kB);
      const Verdict vd = verify_frag<kDh>(
          dl, w.ck_col, w.ck_row, g.tau_coef * eff_kv * dsm * mx.y, eff_kv,
          g.corrects, q_start, 0, w.vf, w.rep, t, bar);
      if (vd.det && t == 0) w.last = (float)(3 * it + 2);
#pragma unroll
      for (int i = 0; i < 64; ++i) dq[i] += dl[i];
    }
    __syncwarp();
    if ((t & 31) == 0) mbar_arrive(&sc.empty[slot]);
  }
  if (wg == 0 && nsteps > 0) pair_sync(kBarPRead);   // wg 1's last arrival

  // dQ rows below Sq, bf16 (wg 1); the merged report.
  if (wg == 1) {
    __nv_bfloat16* dst = g.dq + (rbase + q_start) * kDh;
    const int wl = t / 32, lane = t & 31;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = wl * 16 + lane / 4 + 8 * hf;
      if (q_start + i >= g.sq) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + i * kDh + 8 * j + 2 * (lane & 3)) =
            __floats2bfloat162_rn(dq[4 * j + 2 * hf], dq[4 * j + 2 * hf + 1]);
    }
  }
  pair_sync(kBarEnd);
  if (tid == 0)
    merge_pair(sc.wg[0].rep, sc.wg[0].last, sc.wg[1].rep, sc.wg[1].last,
               g.rep + ((long long)h * g.nqb + qi) * 8);
}

// ---------------------------------------------------------------------------
// K4: dV = Σ Pᵀ·g and dK = Σ dSᵀ·Q over a range of the walk
// ---------------------------------------------------------------------------

struct DkvSmem {
  uint64_t full[kRing], empty[kRing], kv;
  float ksum[kDh], vsum[kDh];
  WgScratch wg[2];
};

constexpr int dkv_smem_bytes() {
  return 1024 + 2 * kTile + kRing * kDkvStage + 4 * kHalf + kPbuf +
         (int)sizeof(DkvSmem);
}

// The live walk of kv block kvi: q blocks [qi_lo, nqb) of each of the n_rep
// query heads (all of them unless causal: the bottom-right-aligned bound).
__device__ __forceinline__ void dkv_walk(const BwdArgs& g, int kv_start,
                                         int& qi_lo, int& nql) {
  qi_lo = 0;
  if (g.causal) {
    const int x = kv_start - (kB - 1) - (g.skv - g.sq);
    qi_lo = x > 0 ? min((x + kB - 1) / kB, g.nqb) : 0;
  }
  nql = g.nqb - qi_lo;
}

// Two consumer warpgroups share each step: warpgroup 0 computes S = Q·Kᵀ,
// P and the dV delta Pᵀ·g; warpgroup 1 dP = g·Vᵀ, dS (with P from
// warpgroup 0 through shared memory) and the dK delta dSᵀ·Q. Each keeps
// its gradient in registers and its own report; the two are merged at the
// end in the order the reference records them (S, dP, dV, dK a step).
// SEU: the instance of campaigns.
template <bool SEU>
__global__ void __launch_bounds__(kBwdThreads, 1)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tg,
                      const BwdArgs g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* Vs = Ks + kTile;
  uint8_t* ring = Vs + kTile;                 // [kRing] x (Q, g, statistics)
  uint8_t* p_hi = ring + kRing * kDkvStage;
  uint8_t* p_lo = p_hi + kHalf;
  uint8_t* ds_hi = p_lo + kHalf;
  uint8_t* ds_lo = ds_hi + kHalf;
  float* pbuf = reinterpret_cast<float*>(ds_lo + kHalf);
  DkvSmem& sc = *reinterpret_cast<DkvSmem*>(pbuf + 32 * kNT);

  const int tid = threadIdx.x;
  const int z = blockIdx.x, b = blockIdx.y, kvi = blockIdx.z;
  const int kv_start = kvi * kB;
  int qi_lo, nql;
  dkv_walk(g, kv_start, qi_lo, nql);
  const int walk = g.n_rep * nql;
  const int w_lo = (int)((long long)z * walk / g.ranges);
  const int nsteps = (int)((long long)(z + 1) * walk / g.ranges) - w_lo;

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&sc.full[s], 1 + 32);   // the TMA's arrival and 32 lanes'
      mbar_init(&sc.empty[s], 2 * kNT / 32);
    }
    mbar_init(&sc.kv, 1);
    for (int w = 0; w < 2; ++w) {
      for (int f = 0; f < 8; ++f) sc.wg[w].rep[f] = 0.0f;
      sc.wg[w].last = -1.0f;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 2 * kNT) {
    // ---- producer warp: K and V once, then per step Q, g (TMA) and the
    // statistics (the 32 lanes' loads), one stage each ------------------
    const int lane = tid - 2 * kNT;
    if (nsteps > 0 && lane == 0) {
      mbar_expect_tx(&sc.kv, 2 * kTile);
      load_tile(Ks, &tk, kv_start, b, &sc.kv);
      load_tile(Vs, &tv, kv_start, b, &sc.kv);
    }
    for (int it = 0; it < nsteps; ++it) {
      const int w = w_lo + it, hq = b * g.n_rep + w / nql;
      const int q_start = (qi_lo + w % nql) * kB, slot = it % kRing;
      if (it >= kRing && lane == 0)
        mbar_wait(&sc.empty[slot], ((it / kRing) & 1) ^ 1);
      __syncwarp();
      uint8_t* st = ring + slot * kDkvStage;
      if (lane == 0) {
        mbar_expect_tx(&sc.full[slot], 2 * kTile);
        load_tile(st, &tq, q_start, hq, &sc.full[slot]);
        load_tile(st + kTile, &tg, q_start, hq, &sc.full[slot]);
      }
      float* stats = reinterpret_cast<float*>(st + 2 * kTile);
      const long long rb = (long long)hq * g.sq;
      for (int i = lane; i < kB; i += 32) {
        const int gi = q_start + i;
        const bool live = gi < g.sq;
        const float l = live ? g.l[rb + gi] : 0.0f;
        stats[i] = live ? g.m[rb + gi] : kNegInf;
        stats[kB + i] = l > 0.0f ? 1.0f / fmaxf(l, 1e-30f) : 0.0f;
        stats[2 * kB + i] = live ? g.di[rb + gi] : 0.0f;
      }
      mbar_arrive(&sc.full[slot]);
    }
    return;
  }

  // ---- consumer warpgroups -----------------------------------------------
  // wg 0: A = Q, B = K for the scores, X = P, B2 = g for the delta;
  // wg 1: A = g, B = V, X = dS, B2 = Q.
  const int wg = tid / kNT, t = tid % kNT, bar = kBarWg0 + wg;
  WgScratch& w = sc.wg[wg];
  const uint8_t* bt = wg ? Vs : Ks;
  const float* bsum = wg ? sc.vsum : sc.ksum;
  uint8_t* xh = wg ? ds_hi : p_hi;
  uint8_t* xl = wg ? ds_lo : p_lo;
  float bmax = 0.0f;   // max |K| or max |V|
  if (nsteps > 0) {
    mbar_wait(&sc.kv, 0);
    float mx;
    col_reduce<kDh>(bt, nullptr, nullptr, wg ? sc.vsum : sc.ksum, w.part[0],
                    &mx, t, bar);   // K^T e or V^T e
    bmax = wg_max2(mx, 0.0f, w.red, t, bar).x;
  }
  float acc[64];   // dV (wg 0) or dK (wg 1)
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  const seu::Hit sh =
      SEU ? seu::draw(g.seu, (uint32_t)(b * g.nkvb + kvi), walk, kB, kDh)
          : seu::Hit{false, 0, 0, 0};

  for (int it = 0; it < nsteps; ++it) {
    const int wk = w_lo + it, hq = b * g.n_rep + wk / nql, qi = qi_lo + wk % nql;
    const int q_start = qi * kB, slot = it % kRing;
    const bool hit = g.inj_enable && hq == g.inj_bh && kvi == g.inj_blk &&
                     qi == g.inj_step;
    mbar_wait(&sc.full[slot], (it / kRing) & 1);
    const uint8_t* Qs = ring + slot * kDkvStage;
    const uint8_t* Gs = Qs + kTile;
    const float* stats = reinterpret_cast<const float*>(Gs + kTile);
    const uint8_t* at = wg ? Gs : Qs;
    const uint8_t* b2 = wg ? Qs : Gs;

    // S = Q·Kᵀ or dP = g·Vᵀ on the tensor cores, while its checksums come
    // from the staged tiles: column (e^T A)·B[j], row A[i]·(B^T e); and
    // B2 e, max |B2| for the delta.
    float sd[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sd[i] = 0.0f;
    fence_frag(sd);
    wgmma_fence();
    mma_abt(sd, at, bt);
    wgmma_commit();
    float am, b2m = 0.0f;
    col_reduce<kDh>(at, nullptr, nullptr, w.asum, w.part[0], &am, t, bar);
    if (t < kB) {
      w.ck_row[t] = row_dot<kDh>(at, nullptr, t, bsum, nullptr, nullptr);
    } else {
      float x;
      row_dot<kDh>(b2, nullptr, t - kB, nullptr, &x, &b2m);
      w.brow[t - kB] = x;
    }
    wg_sync(bar);
    if (t < kB) w.ck_col[t] = row_dot<kDh>(bt, nullptr, t, w.asum, nullptr, nullptr);
    const float2 mx = wg_max2(am, b2m, w.red, t, bar);   // max |A|, max |B2|
    wgmma_wait<0>();
    fence_frag(sd);
    if (wg) inject<kB>(sd, g, hit, kDP, t);
    const Verdict vs = verify_frag<kB>(
        sd, w.ck_col, w.ck_row, g.tau_qk_coef * mx.x * bmax,
        wg ? g.tau_dh : 1.0f, g.corrects, q_start, kv_start, w.vf, w.rep, t,
        bar);
    if (vs.det && t == 0) w.last = (float)(4 * it + wg);

    // P (wg 0, handed to wg 1 in fragment order) or dS (wg 1), staged as
    // hi / lo halves for the delta.
    float xm;
    if (wg == 0) {
      xm = probs(sd, g, q_start, kv_start, stats, stats + kB, t);
      if (it > 0) pair_sync(kBarPRead);   // wg 1 has read the last P
#pragma unroll
      for (int i = 0; i < 32; ++i) pbuf[i * kNT + t] = sd[i];
      pair_arrive(kBarP);
    } else {
      float pf[32];
      pair_sync(kBarP);
#pragma unroll
      for (int i = 0; i < 32; ++i) pf[i] = pbuf[i * kNT + t];
      pair_arrive(kBarPRead);
      xm = grads(pf, sd, stats + 2 * kB, g.scale, t);
    }
    store_frag_hilo(sd, xh, xl, t);
    fence_proxy_async();
    const float xmax = wg_max2(xm, 0.0f, w.red, t, bar).x;   // max |P|, |dS|

    // The delta Xᵀ·B2: X read M-major, B2 N-major, both halves into one
    // accumulator; checksums column (X e)ᵀ·B2 and row Xᵀ·(B2 e) from hi +
    // lo as staged.
    float dl[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dl[i] = 0.0f;
    fence_frag(dl);
    wgmma_fence();
    mma_ab<1>(dl, xh, b2);
    mma_ab<1>(dl, xl, b2);
    wgmma_commit();
    if (t < kB) {
      float x;
      row_dot<kB>(xh, xl, t, nullptr, &x, nullptr);
      w.xrow[t] = x;
    }
    col_reduce<kB>(xh, xl, w.brow, w.ck_row, w.part[0], nullptr, t, bar);
    wg_sync(bar);
    col_reduce<kDh>(b2, nullptr, w.xrow, w.ck_col, w.part[1], nullptr, t, bar);
    wgmma_wait<0>();
    fence_frag(dl);
    inject<kDh>(dl, g, hit, wg ? kDK : kDV, t);
    if (SEU && wg == 0 && sh.hit && wk == sh.step)
      frag_seu<kDh>(dl, sh.row, sh.col, g.seu.shift, t);
    const float eff_q = (float)max(min(g.sq - q_start, kB), 1);
    const Verdict vd = verify_frag<kDh>(
        dl, w.ck_col, w.ck_row, g.tau_coef * eff_q * xmax * mx.y, eff_q,
        g.corrects, kv_start, 0, w.vf, w.rep, t, bar);
    if (vd.det && t == 0) w.last = (float)(4 * it + 2 + wg);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += dl[i];
    __syncwarp();
    if ((t & 31) == 0) mbar_arrive(&sc.empty[slot]);
  }
  if (wg == 0 && nsteps > 0) pair_sync(kBarPRead);   // wg 1's last arrival

  // One range: dV (wg 0) or dK (wg 1) rows below Skv in bf16 and the
  // report. More: this range's f32 partials (all 64 rows) and its report.
  const int G = g.bh / g.n_rep, wl = t / 32, lane = t & 31;
  const long long blk = (long long)b * g.nkvb + kvi;
  const long long per = (long long)G * g.nkvb * kB * kDh;
  if (g.ranges == 1) {
    __nv_bfloat16* dst =
        (wg ? g.dk : g.dv) + ((long long)b * g.skv + kv_start) * kDh;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = wl * 16 + lane / 4 + 8 * hf;
      if (kv_start + i >= g.skv) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + i * kDh + 8 * j + 2 * (lane & 3)) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
    }
  } else {
    float* dst = g.ws + (wg ? 0 : (long long)g.ranges * per) +
                 ((long long)z * G * g.nkvb + blk) * kB * kDh;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = wl * 16 + lane / 4 + 8 * hf;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(dst + i * kDh + 8 * j + 2 * (lane & 3)) =
            make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
    }
  }
  pair_sync(kBarEnd);
  if (tid == 0)
    merge_pair(sc.wg[0].rep, sc.wg[0].last, sc.wg[1].rep, sc.wg[1].last,
               g.ranges == 1 ? g.rep + blk * 8
                             : g.ws + 2 * g.ranges * per +
                                   ((long long)z * G * g.nkvb + blk) * 8);
}

// The range reduce: per (kv head, kv block), the f32 partials of the
// ranges summed in range order, rows below Skv cast to bf16, and the
// ranges' reports merged in range order (abft::merge).
__global__ void __launch_bounds__(abft::kThreads)
flash_dkv_sm90_reduce(const float* ws, __nv_bfloat16* dk, __nv_bfloat16* dv,
                      float* rep, int G, int nkvb, int skv, int ranges) {
  const int kvi = blockIdx.x, b = blockIdx.y, kv_start = kvi * kB;
  const long long blk = (long long)b * nkvb + kvi;
  const long long per = (long long)G * nkvb * kB * kDh;
  const float* pk = ws + blk * kB * kDh;
  const float* pv = pk + ranges * per;
  for (int e = threadIdx.x * 4; e < kB * kDh; e += abft::kThreads * 4) {
    const int i = e / kDh;
    if (kv_start + i >= skv) continue;
    float4 sk = make_float4(0.0f, 0.0f, 0.0f, 0.0f), sv = sk;
    for (int z = 0; z < ranges; ++z) {
      const float4 a = *reinterpret_cast<const float4*>(pk + z * per + e);
      const float4 c = *reinterpret_cast<const float4*>(pv + z * per + e);
      sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
      sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
    }
    const long long o = ((long long)b * skv + kv_start) * kDh + e;
    *reinterpret_cast<__nv_bfloat162*>(dk + o) = __floats2bfloat162_rn(sk.x, sk.y);
    *reinterpret_cast<__nv_bfloat162*>(dk + o + 2) = __floats2bfloat162_rn(sk.z, sk.w);
    *reinterpret_cast<__nv_bfloat162*>(dv + o) = __floats2bfloat162_rn(sv.x, sv.y);
    *reinterpret_cast<__nv_bfloat162*>(dv + o + 2) = __floats2bfloat162_rn(sv.z, sv.w);
  }
  if (threadIdx.x == 0) {
    const float* rp = ws + 2 * ranges * per + blk * 8;
    float r[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int z = 0; z < ranges; ++z) abft::merge(r, rp + (long long)z * G * nkvb * 8);
    for (int f = 0; f < 8; ++f) rep[blk * 8 + f] = r[f];
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

cudaError_t set_smem(const void* kern, int bytes, bool& ready) {
  if (ready) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) ready = true;
  return e;
}

// The four tensor maps: q and g over (bh, sq, 128), k and v over
// (bh / n_rep, skv, 128); 64 x 64 boxes, rows past the true length read
// zero.
bool make_maps(CUtensorMap* m, const void* q, const void* k, const void* v,
               const void* gr, int bh, int sq, int skv, int n_rep) {
  const int kvh = bh / n_rep;
  return make_map3(&m[0], q, kDh, sq, bh, kDh, (long long)sq * kDh, 64, 64) &&
         make_map3(&m[1], k, kDh, skv, kvh, kDh, (long long)skv * kDh, 64, 64) &&
         make_map3(&m[2], v, kDh, skv, kvh, kDh, (long long)skv * kDh, 64, 64) &&
         make_map3(&m[3], gr, kDh, sq, bh, kDh, (long long)sq * kDh, 64, 64);
}

BwdArgs make_args(const float* m, const float* l, const float* di, float* rep,
                  int bh, int sq, int skv, int n_rep, int causal, int corrects,
                  float scale, float tau_qk_coef, float tau_coef, float tau_dh,
                  const int* inj, float inj_mag, const seu::Args& sa) {
  BwdArgs g{};
  g.m = m; g.l = l; g.di = di; g.rep = rep;
  g.bh = bh; g.sq = sq; g.skv = skv; g.n_rep = n_rep;
  g.nqb = (sq + kB - 1) / kB; g.nkvb = (skv + kB - 1) / kB; g.ranges = 1;
  g.causal = causal; g.corrects = corrects; g.scale = scale;
  g.tau_qk_coef = tau_qk_coef; g.tau_coef = tau_coef; g.tau_dh = tau_dh;
  g.inj_enable = inj[0]; g.inj_target = inj[1]; g.inj_bh = inj[2];
  g.inj_blk = inj[3]; g.inj_step = inj[4]; g.inj_row = inj[5];
  g.inj_col = inj[6]; g.inj_mag = inj_mag;
  g.seu = sa;
  return g;
}

template <bool SEU>
cudaError_t launch_dq(const CUtensorMap* maps, const BwdArgs& g,
                      cudaStream_t st) {
  static bool ready = false;
  const cudaError_t e = set_smem((const void*)flash_dq_sm90_kernel<SEU>,
                                 dq_smem_bytes(), ready);
  if (e != cudaSuccess) return e;
  flash_dq_sm90_kernel<SEU><<<dim3(g.bh, g.nqb), kBwdThreads, dq_smem_bytes(),
                              st>>>(maps[0], maps[1], maps[2], maps[3], g);
  return cudaGetLastError();
}

template <bool SEU>
cudaError_t launch_dkv(const CUtensorMap* maps, const BwdArgs& g,
                       cudaStream_t st) {
  static bool ready = false;
  const cudaError_t e = set_smem((const void*)flash_dkv_sm90_kernel<SEU>,
                                 dkv_smem_bytes(), ready);
  if (e != cudaSuccess) return e;
  flash_dkv_sm90_kernel<SEU><<<dim3(g.ranges, g.bh / g.n_rep, g.nkvb),
                               kBwdThreads, dkv_smem_bytes(), st>>>(
      maps[0], maps[1], maps[2], maps[3], g);
  return cudaGetLastError();
}

bool bad_call(int bh, int sq, int skv, int dh, int n_rep, int dtype) {
  return bh <= 0 || sq <= 0 || skv <= 0 || n_rep <= 0 || bh % n_rep != 0 ||
         dh != kDh || dtype != 1;
}

}  // namespace

extern "C" {

const char* flash_bwd_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K3 on the tensor cores, with flash_ft_bwd.cu's flash_dq_launch
// signature: q, g, dq (bh, sq, 128) and k, v (bh / n_rep, skv, 128) bf16
// (dtype 1), 16-byte aligned; m, l, di (bh, sq) f32; report (bh,
// ceil(sq / 64), 8); all contiguous. inj: [enable, target, bh, q block, kv
// step, row, col]; seu_*: the stochastic hook's campaign (seu_hook.cuh; on
// picks the campaign instance). Returns the launch's cudaError_t.
int flash_dq_sm90_launch(const void* q, const void* k, const void* v,
                         const void* gr, const float* m, const float* l,
                         const float* di, void* dq, float* rep, int bh, int sq,
                         int skv, int dh, int n_rep, int dtype, int causal,
                         int corrects, float scale, float tau_qk_coef,
                         float tau_coef, float tau_dh, int inj_enable,
                         int inj_target, int inj_bh, int inj_blk, int inj_step,
                         int inj_row, int inj_col, float inj_mag,
                         int seu_on, unsigned seu_seed, float seu_rate,
                         int seu_shift, void* stream) {
  if (bad_call(bh, sq, skv, dh, n_rep, dtype)) return cudaErrorInvalidValue;
  const int inj[7] = {inj_enable, inj_target, inj_bh, inj_blk, inj_step,
                      inj_row, inj_col};
  BwdArgs g = make_args(m, l, di, rep, bh, sq, skv, n_rep, causal, corrects,
                        scale, tau_qk_coef, tau_coef, tau_dh, inj, inj_mag,
                        seu::Args{seu_on, seu_seed, seu_rate, seu_shift});
  g.dq = static_cast<__nv_bfloat16*>(dq);
  if (g.nqb > 65535) return cudaErrorInvalidConfiguration;
  CUtensorMap maps[4];
  if (!make_maps(maps, q, k, v, gr, bh, sq, skv, n_rep))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return seu_on ? launch_dq<true>(maps, g, st) : launch_dq<false>(maps, g, st);
}

// K4 on the tensor cores: as flash_dq_sm90_launch, with dk, dv (bh /
// n_rep, skv, 128) bf16 and report (bh / n_rep, ceil(skv / 64), 8), the
// walk of each (kv head, kv block) in `ranges` ranges. ranges > 1: ws is
// f32 of ranges·(bh / n_rep)·ceil(skv / 64)·(2·64·128 + 8) elements; the
// kernel writes the partials and range reports there and
// flash_dkv_sm90_reduce_launch finishes dk, dv and the report. inj:
// [enable, target, query head, kv block, q block, row, col]; seu_* as
// flash_dq_sm90_launch's.
int flash_dkv_sm90_launch(const void* q, const void* k, const void* v,
                          const void* gr, const float* m, const float* l,
                          const float* di, void* dk, void* dv, float* rep,
                          float* ws, int ranges, int bh, int sq, int skv,
                          int dh, int n_rep, int dtype, int causal,
                          int corrects, float scale, float tau_qk_coef,
                          float tau_coef, float tau_dh, int inj_enable,
                          int inj_target, int inj_bh, int inj_blk,
                          int inj_step, int inj_row, int inj_col,
                          float inj_mag, int seu_on, unsigned seu_seed,
                          float seu_rate, int seu_shift, void* stream) {
  if (bad_call(bh, sq, skv, dh, n_rep, dtype) || ranges <= 0 ||
      (ranges > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  const int inj[7] = {inj_enable, inj_target, inj_bh, inj_blk, inj_step,
                      inj_row, inj_col};
  BwdArgs g = make_args(m, l, di, rep, bh, sq, skv, n_rep, causal, corrects,
                        scale, tau_qk_coef, tau_coef, tau_dh, inj, inj_mag,
                        seu::Args{seu_on, seu_seed, seu_rate, seu_shift});
  g.dk = static_cast<__nv_bfloat16*>(dk);
  g.dv = static_cast<__nv_bfloat16*>(dv);
  g.ws = ws;
  g.ranges = ranges;
  if (bh / n_rep > 65535 || g.nkvb > 65535) return cudaErrorInvalidConfiguration;
  CUtensorMap maps[4];
  if (!make_maps(maps, q, k, v, gr, bh, sq, skv, n_rep))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return seu_on ? launch_dkv<true>(maps, g, st)
                : launch_dkv<false>(maps, g, st);
}

// K4's range reduce (ranges > 1): ws as flash_dkv_sm90_launch left it;
// dk, dv (g, skv, 128) bf16 and report (g, ceil(skv / 64), 8).
int flash_dkv_sm90_reduce_launch(const float* ws, void* dk, void* dv,
                                 float* rep, int g, int skv, int ranges,
                                 void* stream) {
  if (g <= 0 || skv <= 0 || ranges <= 1 || g > 65535)
    return cudaErrorInvalidValue;
  const int nkvb = (skv + kB - 1) / kB;
  flash_dkv_sm90_reduce<<<dim3(nkvb, g), abft::kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      ws, static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv),
      rep, g, nkvb, skv, ranges);
  return cudaGetLastError();
}

}  // extern "C"
