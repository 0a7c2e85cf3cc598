// Flash-attention forward with online ABFT on the tensor cores (sm_90a):
// K2 for bf16 q, k, v at head dim 64 or 128, with and without the saved
// softmax statistics (m, l).
//
// Replaces the TPU kernel K2 of the JAX package:
//   src/repro/kernels/flashft.py:114 _flash_ft_kernel, launched by
//   templates/registry.py:178 flash_fwd_call.
// It computes what the SIMT kernel of csrc/flash_ft.cu computes, on the
// same 64 x 64 block grid with the same thresholds and 8-float report
// (one per (query head, 64-row q block)); that source keeps f32, pinned
// blocks and operands TMA cannot read, and kernels/flashft.py:plan_fwd
// picks between the two. Per live kv block:
//   S  = Q·Kᵀ  verified before scale and mask against (eᵀQ)·Kᵀ and
//              Q·(Kᵀe): tau = rel_tau·eps32·round_up(dh, 128)·max|Q|·max|K|,
//              k = step + 1, column reported at col + kv_start;
//   scale, then the kv-edge, dead-row and bottom-right-aligned causal masks
//   (NEG_INF = -1e30) and the online softmax with the reference's clamps
//   (exp(min(s - m, 0)); rows with m <= NEG_INF / 2 get p = 0);
//   Δ  = P·V   the deterministic SEU added here (or in S), verified
//              before the alpha-rescale against (eᵀP)·V and P·(Ve): tau =
//              rel_tau·eps32·eff_kv·max|V|, k = eff_kv = min(Skv -
//              kv_start, 64);
//   acc = alpha·acc + Δ.
// Flush: acc / l, rows with m degenerate or l = 0 as exact zeros; with
// save_stats each live row's (m, l), degenerate rows (NEG_INF, 0).
//
// What bounds it on the H100: at the prefill and training shapes (S 128
// to 512, dh 128, causal) its bound is a few microseconds (the bytes of q,
// k, v and the output); at whisper's encoder (64 heads x 1 500 x 1 500,
// dh 64) 37 GFLOP on the tensor cores, 0.04 ms. What sets the pace is each
// kv step's chain of two products, their checksums and verifications and
// the softmax, one chain a q block; at dh 64 the products halve and the
// rest (the 64 x 64 S verification, the softmax, P's staging, Δ's
// verification) does not. The design:
//   * both products on the tensor cores: bf16 `wgmma` m64n64k16 for S (Q
//     and K read K-major from their staged tiles, dh / 16 k-steps) and
//     m64n{dh}k16 for Δ (P K-major, V N-major), f32 accumulators in
//     registers (output, Δ and S: 64 + 64 + 32 floats at dh 128, 32 + 32
//     + 32 at dh 64); a 64-column row is one 128-byte swizzle box, so a
//     tile is dh / 64 boxes;
//   * a CTA holds NWG consumer warpgroups (`fwd_wgs`: 2 at dh 128, 3 at
//     dh 64, where the accumulators leave room for a third and the card
//     ran the encoder shape 1.25x faster with it; three ring stages in
//     place of two changed nothing), each owning one work unit (query
//     head, 64-row q block), and all its units read the same kv head, so
//     they share one TMA ring of K and V tiles (3-D tensor maps over
//     (head, row, dh), rows past Skv read zero, 128-byte swizzled, two
//     stages) kept full by one thread of a producer warpgroup; Q is loaded
//     once. The units are query heads of one GQA group at the same q
//     block (the last group's spare warpgroups leave at once), but at dh
//     64 and n_rep 1 (MHA: whisper) neighbouring q blocks of one head, so
//     no warpgroup idles while the head has q blocks left (BYQ, an
//     instance of its own: the dh-128 instances keep the code they had).
//     The ring runs the longest unit's walk (the first: under causal the
//     latest q block); a shorter walk passes the stages past its diagonal
//     on without reading them;
//   * the producer warpgroup gives registers up with `setmaxnreg` so the
//     consumers can hold the accumulators: the register pool counts whole
//     warpgroups, so the producer is a full one ((NWG + 1) x 128 threads);
//   * at dh 64, where the per-step work on the CUDA cores sets the pace,
//     the dh-64 instance masks only the blocks on an edge (kv, rows,
//     diagonal), spreads the row checksum Q·(Kᵀe) over all 128 threads,
//     and takes Δ's P-side checksums (P·(Ve), eᵀP) from the staged P in
//     the registers instead of rereading the hi / lo tiles (the dh-128
//     instances keep the code they had);
//   * P is f32. Staged as hi = bf16(P) and lo = bf16(P - hi) (the pieces
//     of csrc/flash_bwd_sm90.cu, csrc/flash_sm90.cuh), Δ is two wgmmas
//     into one accumulator and its checksums come from hi + lo as staged:
//     from the operands the tensor cores consumed. eᵀQ is taken once; Kᵀe,
//     V·e and the maxima from the staged bf16 tiles on the CUDA cores
//     while the wgmmas run; the verification reduces the accumulator's
//     column and row sums from the wgmma fragment (verify_frag), locates
//     the first argmax, records with abft::record and corrects in the
//     registers; the softmax runs in the registers (a row lives in the 4
//     lanes of one warp);
//   * the long causal q blocks launch first; dead kv blocks (past Skv,
//     above the diagonal) are skipped.
// Stochastic SEU campaigns (seu_hook.cuh, salt 0x51 reduced on the host)
// run in their own instance (SEU = true), so a clean call runs the code it
// ran before the hook: each consumer warpgroup draws its q block's SEU by
// its uid h·nqb + qi over its live kv steps, and at the drawn step the
// thread holding the element scales it in Δ after both products (hi and
// lo) and the deterministic SEU, before the verification (the
// reference's flashft.py:159-161, :223-224).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_sm90.cuh"

namespace {

constexpr int kRing = 2;                  // ring stages

// Consumer warpgroups a CTA at head dim DH.
template <int DH>
constexpr int fwd_wgs() { return DH == 64 ? 3 : 2; }

struct FwdArgs {
  __nv_bfloat16* out;  // (bh, sq, dh)
  float* rep;          // (bh, nqb, 8)
  float* m_out;        // nullptr, or (bh, sq) saved row max
  float* l_out;        // nullptr, or (bh, sq) saved row sum
  int sq, skv, n_rep, nqb, causal, corrects;
  int groups;          // CTAs a (kv head, q block) when units are heads
  float scale;
  float tau_qk_coef;   // rel_tau * eps32 * round_up(dh, 128)
  float tau_coef;      // rel_tau * eps32
  int inj_enable, inj_bh, inj_qb, inj_s, inj_row, inj_col;
  float inj_mag;
  seu::Args seu;       // the stochastic hook's campaign
};

// One consumer warpgroup's scratch.
template <int DH>
struct FwdWg {
  float part[2][4 * DH];    // col_reduce's partials, two halves in turn
  float qsum[DH];           // e^T Q
  float ksum[DH];           // K^T e
  float ck_col[DH], ck_row[kB];
  float vrow[kB];           // V e
  float psum[kB];           // e^T P
  float red[2][4];
  FragVerify vf;
  float rep[8];
};

template <int DH, int NWG>
struct FwdSmem {
  uint64_t full[kRing], empty[kRing], qb;
  FwdWg<DH> wg[NWG];
};

template <int DH, int NWG>
constexpr int fwd_smem_bytes() {
  return 1024 + NWG * kTileBytes<DH> + kRing * 2 * kTileBytes<DH> +
         NWG * 2 * kHalf + (int)sizeof(FwdSmem<DH, NWG>);
}

// The work unit of consumer warpgroup c of this CTA: query head h (-1 when
// the CTA has no unit for it) and q block qi. BYQ (n_rep 1 at dh 64): NWG
// neighbouring q blocks of head kvh = blockIdx.x, the latest (first =
// nqb - 1 - blockIdx.y·NWG) first; else query heads first + c of kv head
// kvh = blockIdx.x / groups (first = (blockIdx.x % groups)·NWG) at q
// block nqb - 1 - blockIdx.y. Either way unit 0 is live and walks the
// most kv blocks.
template <bool BYQ>
__device__ __forceinline__ int2 fwd_unit(const FwdArgs& g, int kvh,
                                         int first, int c) {
  if constexpr (BYQ) {
    const int qi = first - c;
    return make_int2(qi >= 0 ? kvh : -1, qi);
  }
  const int r = first + c;
  return make_int2(r < g.n_rep ? kvh * g.n_rep + r : -1,
                   g.nqb - 1 - (int)blockIdx.y);
}

// The kv steps q block qi walks: the kv edge and, causal, the bottom-
// right-aligned diagonal.
__device__ __forceinline__ int fwd_steps(const FwdArgs& g, int qi) {
  const int nkv = (g.skv + kB - 1) / kB;
  const int hi_row = qi * kB + kB - 1 + g.skv - g.sq;
  return !g.causal ? nkv : (hi_row < 0 ? 0 : min(nkv, hi_row / kB + 1));
}

// Scale, masks and the online softmax of one step in place on the S
// accumulator (q rows q_start + i, kv columns kv_start + j): P, this
// thread's two rows' running max and sum updated, their alpha returned.
__device__ __forceinline__ void softmax_step(float (&s)[32], const FwdArgs& g,
                                             int q_start, int kv_start,
                                             bool whole, float (&m_r)[2],
                                             float (&l_r)[2],
                                             float (&alpha)[2], int tid) {
  const int lane = tid & 31, c_off = g.skv - g.sq;
  const int i0 = (tid / 32) * 16 + lane / 4;
  float mx[2] = {kNegInf, kNegInf};
  if (whole) {   // every (row, column) of the block live: no masks
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * hf + e;
          s[idx] *= g.scale;
          mx[hf] = fmaxf(mx[hf], s[idx]);
        }
  } else {
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
          const float x = live ? s[idx] * g.scale : kNegInf;
          s[idx] = x;
          mx[hf] = fmaxf(mx[hf], x);
        }
  }
  float m_new[2], ls[2] = {0.0f, 0.0f};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFull, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFull, mx[hf], 2));
    m_new[hf] = fmaxf(m_r[hf], mx[hf]);
    alpha[hf] = expf(fminf(m_r[hf] - m_new[hf], 0.0f));
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * j + 2 * hf + e;
        const float p = m_new[hf] > 0.5f * kNegInf
                            ? expf(fminf(s[idx] - m_new[hf], 0.0f)) : 0.0f;
        s[idx] = p;
        ls[hf] += p;
      }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    ls[hf] += __shfl_xor_sync(kFull, ls[hf], 1);
    ls[hf] += __shfl_xor_sync(kFull, ls[hf], 2);
    l_r[hf] = l_r[hf] * alpha[hf] + ls[hf];
    m_r[hf] = m_new[hf];
  }
}

// The delta's P-side checksums from the staged P in the registers (the
// 64 x 64 fragment p): ck_row[i] = P[i]·(V e) over the 4 lanes of a row,
// psum[j] = (e^T P)[j] over the rows of each warp (a transposing
// reduction), then the 4 warps through part[4][64] after a consumer
// barrier.
__device__ __forceinline__ void p_checks(const float (&p)[32],
                                         const float* vrow, float* ck_row,
                                         float* psum, float* part, int tid,
                                         int bar) {
  const int warp = tid / 32, lane = tid & 31;
  float r0 = 0.0f, r1 = 0.0f, cs[16];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float vr = vrow[8 * j + 2 * (lane & 3) + e];
      r0 = fmaf(p[4 * j + e], vr, r0);
      r1 = fmaf(p[4 * j + 2 + e], vr, r1);
      cs[2 * j + e] = p[4 * j + e] + p[4 * j + 2 + e];
    }
  r0 += __shfl_xor_sync(kFull, r0, 1);
  r0 += __shfl_xor_sync(kFull, r0, 2);
  r1 += __shfl_xor_sync(kFull, r1, 1);
  r1 += __shfl_xor_sync(kFull, r1, 2);
  if ((lane & 3) == 0) {
    ck_row[warp * 16 + lane / 4] = r0;
    ck_row[warp * 16 + lane / 4 + 8] = r1;
  }
  const int base = xreduce<16, 8, 4>(cs, lane);   // as verify_frag's
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int ci = base + q;
    part[warp * kB + 8 * (ci / 2) + 2 * (lane & 3) + (ci & 1)] = cs[q];
  }
  wg_sync(bar);
  if (tid < kB)
    psum[tid] = part[tid] + part[kB + tid] + part[2 * kB + tid] +
                part[3 * kB + tid];
}

// One CTA per NWG work units that share a kv head (`fwd_unit`): consumer
// warpgroup c takes unit c. SEU: the instance of campaigns.
template <int DH, int NWG, bool BYQ, bool SEU>
__global__ void __launch_bounds__((NWG + 1) * kNT, 1)
flash_ft_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const FwdArgs g) {
  static_assert(DH == 64 || DH == 128, "head dim 64 or 128");
  static_assert(NWG == 2 || NWG == 3, "two or three consumer warpgroups");
  constexpr int kT = kTileBytes<DH>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = Qs + NWG * kT;              // [kRing] x (K tile, V tile)
  uint8_t* pbuf = ring + kRing * 2 * kT;      // [NWG] x (P hi, P lo)
  FwdSmem<DH, NWG>& sc =
      *reinterpret_cast<FwdSmem<DH, NWG>*>(pbuf + NWG * 2 * kHalf);

  const int tid = threadIdx.x, bx = blockIdx.x;
  const int kvh = BYQ ? bx : bx / g.groups;
  const int first = BYQ ? g.nqb - 1 - (int)blockIdx.y * NWG
                        : (bx - kvh * g.groups) * NWG;
  int n_live = 1;
#pragma unroll
  for (int c = 1; c < NWG; ++c)
    n_live += fwd_unit<BYQ>(g, kvh, first, c).x >= 0;
  const int nring = fwd_steps(g, fwd_unit<BYQ>(g, kvh, first, 0).y);

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&sc.full[s], 1);
      mbar_init(&sc.empty[s], n_live * kNT / 32);
    }
    mbar_init(&sc.qb, 1);
    for (int w = 0; w < NWG; ++w)
      for (int f = 0; f < 8; ++f) sc.wg[w].rep[f] = 0.0f;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NWG * kNT) {
    // ---- producer warpgroup: Q once, then the K and V ring -------------
    if constexpr (NWG == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    else
      asm volatile("setmaxnreg.dec.sync.aligned.u32 32;\n");
    if (tid == NWG * kNT) {
      mbar_expect_tx(&sc.qb, n_live * kT);
      for (int c = 0; c < n_live; ++c) {
        const int2 u = fwd_unit<BYQ>(g, kvh, first, c);
        load_tile<DH>(Qs + c * kT, &tq, u.y * kB, u.x, &sc.qb);
      }
      for (int it = 0; it < nring; ++it) {
        const int slot = it % kRing;
        if (it >= kRing) mbar_wait(&sc.empty[slot], ((it / kRing) & 1) ^ 1);
        uint8_t* st = ring + slot * 2 * kT;
        mbar_expect_tx(&sc.full[slot], 2 * kT);
        load_tile<DH>(st, &tk, it * kB, kvh, &sc.full[slot]);
        load_tile<DH>(st + kT, &tv, it * kB, kvh, &sc.full[slot]);
      }
    }
    return;
  }
  if constexpr (NWG == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  else
    asm volatile("setmaxnreg.inc.sync.aligned.u32 160;\n");

  // ---- consumer warpgroups ------------------------------------------------
  const int wg = tid / kNT, t = tid % kNT, bar = 1 + wg;
  if (wg >= n_live) return;
  FwdWg<DH>& w = sc.wg[wg];
  const int2 unit = fwd_unit<BYQ>(g, kvh, first, wg);
  const int h = unit.x, qi = unit.y, q_start = qi * kB;
  const int nsteps = fwd_steps(g, qi);
  const uint8_t* qs = Qs + wg * kT;
  uint8_t* p_hi = pbuf + wg * 2 * kHalf;
  uint8_t* p_lo = p_hi + kHalf;
  mbar_wait(&sc.qb, 0);
  float am;
  col_reduce<DH>(qs, nullptr, nullptr, w.qsum, w.part[0], &am, t, bar);
  const float qmax = wg_max2(am, 0.0f, w.red, t, bar).x;

  float acc[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.0f, 0.0f};
  const bool hit_blk = g.inj_enable && h == g.inj_bh && qi == g.inj_qb &&
                       g.inj_row >= 0 && g.inj_row < kB && g.inj_col >= 0;
  const seu::Hit sh =
      SEU ? seu::draw(g.seu, (uint32_t)(h * g.nqb + qi), nsteps, kB, DH)
          : seu::Hit{false, 0, 0, 0};

  for (int it = 0; it < nsteps; ++it) {
    const int slot = it % kRing, kv_start = it * kB;
    const bool hit = hit_blk && it == g.inj_s;
    mbar_wait(&sc.full[slot], (it / kRing) & 1);
    const uint8_t* Ks = ring + slot * 2 * kT;
    const uint8_t* Vs = Ks + kT;

    // S = Q·Kᵀ on the tensor cores, while its checksums come from the
    // staged tiles: column (e^T Q)·K[j], row Q[i]·(K^T e); and V e, max |V|
    // for the delta.
    float sd[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sd[i] = 0.0f;
    fence_frag(sd);
    wgmma_fence();
    mma_abt<DH>(sd, qs, Ks);
    wgmma_commit();
    float km, vm = 0.0f;
    col_reduce<DH>(Ks, nullptr, nullptr, w.ksum, w.part[1], &km, t, bar);
    if (t < kB) {
      w.ck_col[t] = row_dot<DH>(Ks, nullptr, t, w.qsum, nullptr, nullptr);
    } else {
      float x;
      row_dot<DH>(Vs, nullptr, t - kB, nullptr, &x, &vm);
      w.vrow[t - kB] = x;
    }
    wg_sync(bar);
    if constexpr (DH == 64) {
      // Q[i]·(K^T e) by a lane pair: row t / 2, columns 32·(t % 2) on
      const int r = t >> 1, half = t & 1;
      float d = 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float f[8];
        widen8(tile_chunk(qs, r, 4 * half + q), f);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          d = fmaf(f[e], w.ksum[8 * (4 * half + q) + e], d);
      }
      d += __shfl_xor_sync(kFull, d, 1);
      if (half == 0) w.ck_row[r] = d;
    } else {
      if (t < kB) w.ck_row[t] = row_dot<DH>(qs, nullptr, t, w.ksum, nullptr, nullptr);
    }
    const float2 mx = wg_max2(km, vm, w.red, t, bar);   // max |K|, max |V|
    wgmma_wait<0>();
    fence_frag(sd);
    if (hit && g.inj_enable == 2 && g.inj_col < kB)
      frag_add<kB>(sd, g.inj_row, g.inj_col, g.inj_mag, t);
    verify_frag<kB>(sd, w.ck_col, w.ck_row, g.tau_qk_coef * qmax * mx.x,
                    (float)(it + 1), g.corrects, q_start, kv_start, w.vf,
                    w.rep, t, bar);

    // P in the registers, staged as hi / lo halves for the delta.
    // At dh 64 only the edge blocks are masked, and P stays in the
    // registers as staged for its checksums.
    float alpha[2];
    const bool whole = DH == 64 && kv_start + kB <= g.skv &&
                       q_start + kB <= g.sq &&
                       (!g.causal || kv_start + kB - 1 <= q_start + g.skv - g.sq);
    softmax_step(sd, g, q_start, kv_start, whole, m_r, l_r, alpha, t);
    store_frag_hilo<DH == 64>(sd, p_hi, p_lo, t);
    fence_proxy_async();
    wg_sync(bar);

    // Δ = P·V: both halves into one accumulator, V's tile read N-major;
    // its checksums from hi + lo as staged: row P[i]·(V e), column
    // (e^T P)·V.
    float dl[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) dl[i] = 0.0f;
    fence_frag(dl);
    wgmma_fence();
    mma_ab<0, DH>(dl, p_hi, Vs);
    mma_ab<0, DH>(dl, p_lo, Vs);
    wgmma_commit();
    if constexpr (DH == 64) {
      p_checks(sd, w.vrow, w.ck_row, w.psum, w.part[0], t, bar);
    } else {
      if (t < kB) w.ck_row[t] = row_dot<kB>(p_hi, p_lo, t, w.vrow, nullptr, nullptr);
      col_reduce<kB>(p_hi, p_lo, nullptr, w.psum, w.part[0], nullptr, t, bar);
    }
    wg_sync(bar);
    col_reduce<DH>(Vs, nullptr, w.psum, w.ck_col, w.part[1], nullptr, t, bar);
    wgmma_wait<0>();
    fence_frag(dl);
    if (hit && g.inj_enable == 1 && g.inj_col < DH)
      frag_add<DH>(dl, g.inj_row, g.inj_col, g.inj_mag, t);
    if (SEU && sh.hit && it == sh.step)
      frag_seu<DH>(dl, sh.row, sh.col, g.seu.shift, t);
    const float eff_kv = (float)min(g.skv - kv_start, kB);
    verify_frag<DH>(dl, w.ck_col, w.ck_row, g.tau_coef * eff_kv * mx.y,
                    eff_kv, g.corrects, q_start, 0, w.vf, w.rep, t, bar);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * hf + e;
          acc[idx] = acc[idx] * alpha[hf] + dl[idx];
        }
    __syncwarp();
    if ((t & 31) == 0) mbar_arrive(&sc.empty[slot]);
  }

  // ---- flush: rows below Sq, degenerate rows as exact zeros ---------------
  const int lane = t & 31;
  const long long rbase = (long long)h * g.sq;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = (t / 32) * 16 + lane / 4 + 8 * hf, gi = q_start + i;
    if (gi >= g.sq) continue;
    const bool good = m_r[hf] > 0.5f * kNegInf && l_r[hf] > 0.0f;
    const float linv = good ? 1.0f / fmaxf(l_r[hf], 1e-30f) : 0.0f;
    __nv_bfloat16* dst = g.out + (rbase + gi) * DH + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) = __floats2bfloat162_rn(
          acc[4 * j + 2 * hf] * linv, acc[4 * j + 2 * hf + 1] * linv);
    if (g.m_out != nullptr && (lane & 3) == 0) {
      g.m_out[rbase + gi] = good ? m_r[hf] : kNegInf;
      g.l_out[rbase + gi] = good ? l_r[hf] : 0.0f;
    }
  }
  if (t == 0)
    for (int f = 0; f < 8; ++f)
      g.rep[((long long)h * g.nqb + qi) * 8 + f] = w.rep[f];

  // A walk shorter than the ring's (BYQ under causal) passes the stages
  // past its diagonal on: each is waited for (so no arrival runs ahead of
  // the stage's phase) and released unread.
  if constexpr (BYQ)
    for (int it = nsteps; it < nring; ++it) {
      const int slot = it % kRing;
      mbar_wait(&sc.full[slot], (it / kRing) & 1);
      __syncwarp();
      if ((t & 31) == 0) mbar_arrive(&sc.empty[slot]);
    }
}

template <int DH, bool BYQ, bool SEU>
cudaError_t launch_fwd(const CUtensorMap* maps, const FwdArgs& g, dim3 grid,
                       cudaStream_t stream) {
  constexpr int NWG = fwd_wgs<DH>();
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_ft_sm90_kernel<DH, NWG, BYQ, SEU>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        fwd_smem_bytes<DH, NWG>());
    if (e != cudaSuccess) return e;
    ready = true;
  }
  flash_ft_sm90_kernel<DH, NWG, BYQ, SEU><<<grid, (NWG + 1) * kNT,
                                            fwd_smem_bytes<DH, NWG>(),
                                            stream>>>(maps[0], maps[1],
                                                      maps[2], g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_fwd_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K2 on the tensor cores, with flash_ft.cu's flash_ft_launch signature: q,
// out (bh, sq, dh) and k, v (bh / n_rep, skv, dh) bf16 (dtype 1) at dh 64
// or 128, 16-byte aligned; report (bh, ceil(sq / 64), 8); m_out, l_out
// nullptr or (bh, sq) f32; all contiguous. inj: [enable (1 Δ, 2 S), bh, q
// block, kv step, row, col]; seu_*: the stochastic hook's campaign
// (seu_hook.cuh; on picks the campaign instance). Returns the launch's
// cudaError_t.
int flash_ft_sm90_launch(const void* q, const void* k, const void* v,
                         void* out, float* rep, float* m_out, float* l_out,
                         int bh, int sq, int skv, int dh, int n_rep,
                         int dtype, int causal, int corrects, float scale,
                         float tau_qk_coef, float tau_coef, int inj_enable,
                         int inj_bh, int inj_qb, int inj_s, int inj_row,
                         int inj_col, float inj_mag, int seu_on,
                         unsigned seu_seed, float seu_rate, int seu_shift,
                         void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0 || n_rep <= 0 || bh % n_rep != 0 ||
      (dh != 64 && dh != 128) || dtype != 1 ||
      (m_out == nullptr) != (l_out == nullptr))
    return cudaErrorInvalidValue;
  FwdArgs g{};
  g.out = static_cast<__nv_bfloat16*>(out);
  g.rep = rep; g.m_out = m_out; g.l_out = l_out;
  g.sq = sq; g.skv = skv; g.n_rep = n_rep; g.nqb = (sq + kB - 1) / kB;
  g.causal = causal; g.corrects = corrects; g.scale = scale;
  g.tau_qk_coef = tau_qk_coef; g.tau_coef = tau_coef;
  g.inj_enable = inj_enable; g.inj_bh = inj_bh; g.inj_qb = inj_qb;
  g.inj_s = inj_s; g.inj_row = inj_row; g.inj_col = inj_col;
  g.inj_mag = inj_mag;
  g.seu = seu::Args{seu_on, seu_seed, seu_rate, seu_shift};
  // Units of a CTA: q blocks of one head at dh 64 and n_rep 1, else
  // query heads of one GQA group (`fwd_unit`).
  const int kvh = bh / n_rep, nwg = dh == 64 ? fwd_wgs<64>() : fwd_wgs<128>();
  const bool by_q = dh == 64 && n_rep == 1;
  g.groups = by_q ? 1 : (n_rep + nwg - 1) / nwg;
  const dim3 grid = by_q ? dim3(bh, (g.nqb + nwg - 1) / nwg)
                         : dim3(kvh * g.groups, g.nqb);
  if (g.nqb > 65535 || (long long)kvh * g.groups > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  CUtensorMap maps[3];
  if (!make_map3(&maps[0], q, dh, sq, bh, dh, (long long)sq * dh, 64, 64) ||
      !make_map3(&maps[1], k, dh, skv, kvh, dh, (long long)skv * dh, 64, 64) ||
      !make_map3(&maps[2], v, dh, skv, kvh, dh, (long long)skv * dh, 64, 64))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (by_q)
    return seu_on ? launch_fwd<64, true, true>(maps, g, grid, st)
                  : launch_fwd<64, true, false>(maps, g, grid, st);
  if (dh == 64)
    return seu_on ? launch_fwd<64, false, true>(maps, g, grid, st)
                  : launch_fwd<64, false, false>(maps, g, grid, st);
  return seu_on ? launch_fwd<128, false, true>(maps, g, grid, st)
                : launch_fwd<128, false, false>(maps, g, grid, st);
}

}  // extern "C"
