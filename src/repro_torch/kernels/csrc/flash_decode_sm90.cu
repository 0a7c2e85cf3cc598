// Paged ragged flash decode with online ABFT on the tensor cores (sm_90a):
// K6 for bf16 q and pools at head dim 128, 16 query rows per (slot, kv
// head), pages of 32 or 64 tokens; and the combine of its ranges.
//
// Replaces the TPU kernel K6 of the JAX package:
//   src/repro/kernels/flashft.py:270 _flash_decode_kernel, launched by
//   src/repro/kernels/templates/registry.py:239 flash_decode_call.
// It computes what the SIMT kernel of csrc/flash_decode.cu computes, with
// the same thresholds and 8-float report per (slot, kv head) row; that
// source keeps f32, dh 256, pages of 16, 32 query rows and operands the
// bulk copies cannot read, and kernels/flashft.py:plan_decode picks
// between the two. Per live page of the slot (the whole page staged, its
// dead positions included, as the reference verifies S over it):
//   S  = Q·Kᵀ  verified before scale and mask against (eᵀQ)·Kᵀ and
//              Q·(Kᵀe): tau = rel_tau·eps32·dh·max|Q|·max|K_page|, k =
//              step + 1, column reported at col + step·PAGE;
//   scale, mask positions >= length (NEG_INF = -1e30), online softmax with
//   the reference's clamps;
//   Δ  = P·V   the deterministic SEU added here (or in S), verified
//              before the alpha-rescale against (eᵀP)·V and P·(Ve): tau =
//              rel_tau·eps32·eff_kv·max|V_page|, k = eff_kv =
//              min(length - step·PAGE, PAGE);
//   acc = alpha·acc + Δ.
//
// What bounds it on the H100: bytes -- each live page of K and V is read
// once for 4·16·PAGE·128 flops, far below the card's operations-per-byte
// balance. At the engines' 8 slots x 4 kv heads one CTA per row would put
// 32 CTAs on 132 SMs, each walking up to 16 pages in series. The design:
//   * split-KV: the grid is (row, range); a CTA reads its slot's length on
//     the device and takes its contiguous, balanced share [z·live /
//     ranges, (z + 1)·live / ranges) of the live pages
//     (kernels/flashft.py:decode_ranges brings the grid to about two waves
//     of the SMs), runs its own online softmax from an empty state and
//     writes f32 partials (acc, m, l) and its report to a workspace; a CTA
//     whose range is empty writes an empty partial (m = NEG_INF, l = 0, a
//     zero report). No host synchronisation: the call can be captured in
//     a CUDA graph. flash_decode_combine merges the partials of each row
//     (weights exp(m_z - max m) over the non-empty ranges, whose acc alone
//     it reads) and writes out = Σ w·acc / Σ w·l, exact zeros on
//     degenerate rows and length-0 slots, and merges the reports in range
//     order with abft::merge (det and corr add,
//     row / col / mag from the last detection, max_residual the max, tau
//     and k from the last range that verified). Each page's verification
//     depends on that page alone (tau_qk on max|K_page|, Δ's tau on
//     max|V_page| and no term in P), so every decision equals the unsplit
//     walk's; only max_residual and mag move, at rounding level, since P
//     is taken against a range's running max. No atomics;
//   * each (page, kv head) block of the pool is contiguous: its rows come
//     in by `cp.async.bulk` (one 256-byte row each, issued by the lanes of
//     warp 0, completing on an mbarrier) into a ring of two stages, bf16,
//     rows padded to 272 bytes so the fragment loads hit 32 banks; the
//     page id comes from the page table, and one outside the pool stops
//     the kernel with a device trap;
//   * both products on the tensor cores, `mma.sync` m16n8k16 bf16 -> f32:
//     the 16 query rows are exactly one m16 tile; S (16 x PAGE x 128) with
//     the 4 warps splitting the kv columns and Q's fragments loaded once,
//     Δ (16 x 128 x PAGE) with the warps splitting dh. P is f32: staged as
//     hi = bf16(P) and lo = bf16(P - hi), two MMAs into one accumulator,
//     and eᵀP and P·(Ve) taken from hi + lo, the operands the tensor cores
//     consumed. eᵀQ once per CTA, Kᵀe, V·e and the maxima from the staged
//     bf16 tiles on the CUDA cores; the residuals come from the
//     accumulator fragments with warp shuffles, warp 0 locates the first
//     argmax and records with abft::record, and the thread holding the
//     element corrects it in its registers.
// Stochastic SEU campaigns (seu_hook.cuh, salt 0x54 reduced on the host)
// run in their own instances (SEU = true), so a clean call runs the code it
// ran before the hook: every range's CTA of a (slot, kv head) row draws the
// row's SEU by its uid slot·kvh + head over the row's live pages, and the
// range holding the drawn page scales the element of that page's Δ in the
// lane that holds it, after both products (hi and lo) and the
// deterministic SEU, before the verification (the reference's
// flashft.py:310-315, :365-366); the combine counts it once. Its P is taken
// against the range's running max, so under ranges the SEU's δ (and its
// magnitude) is the range's.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma16_sm90.cuh"

namespace {

constexpr int kDh = 128;                 // head dim of the instance
constexpr int kThr = 32 * kWarps;        // four warps; kBq query rows
constexpr int kRow = kDh + 8;            // staged row pitch (bf16): 272 bytes
constexpr int kPageRing = 2;             // page ring stages
constexpr float kNegInf = -1e30f;
// f32 of one range's partial: acc (16 x 128), m, l (16 each), report
constexpr int kPartial = kBq * kDh + 2 * kBq + 8;

struct DecArgs {
  const __nv_bfloat16* q;   // (G, 16, 128), G = n_slots · kvh
  const __nv_bfloat16* k;   // (n_pages, kvh, PAGE, 128)
  const __nv_bfloat16* v;
  const int* lengths;       // (n_slots,)
  const int* table;         // (n_slots, max_pages)
  float* ws;                // (G, ranges, kPartial)
  int kvh, max_pages, n_pages, ranges, corrects;
  float scale;
  float tau_qk_coef;        // rel_tau * eps32 * dh
  float tau_coef;           // rel_tau * eps32
  int inj_enable, inj_g, inj_qi, inj_s, inj_row, inj_col;
  float inj_mag;
  seu::Args seu;            // the stochastic hook's campaign
};

template <int PAGE>
struct DecSmem {
  __nv_bfloat16 kv[kPageRing][2][PAGE][kRow];   // [stage][K, V][row][dh]
  __nv_bfloat16 q[kBq][kRow];
  __nv_bfloat16 phi[kBq][PAGE + 8], plo[kBq][PAGE + 8];   // P's halves
  uint64_t full[kPageRing];
  float qsum[kDh];            // e^T Q
  float ksum[kDh];            // K^T e
  float ckd[kDh];             // Δ's column check (e^T P)·V
  float dcol[kDh];            // column residuals (abft::record reads mag)
  float cks[PAGE];            // S's column check (e^T Q)·K[j]
  float vsum[PAGE];           // V e
  float psum[PAGE];           // e^T P
  float rck[kBq];             // S's row check Q·(K^T e)
  float drow[kBq];
  float m[kBq], l[kBq];       // running softmax statistics
  float rowp[kWarps][kBq];    // per-warp row sums of an accumulator
  float rowq[kWarps][kBq];    // per-warp P·(V e)
  float rmax[kWarps][kBq], lsum[kWarps][kBq];
  float red[kWarps][3];       // max |Q|, max |K|, max |V| by warp
  abft::Verdict verdict;
  float rep[8];
};

// Page s of the slot (kv head `head`) into stage `st`, by the 32 lanes of
// warp 0: lane 0 reads the page id (a trap outside the pool) and arms the
// stage's barrier, each lane copies its rows of K and V.
template <int PAGE>
__device__ __forceinline__ void load_page(DecSmem<PAGE>& sc, int st,
                                          const DecArgs& g, int slot,
                                          int head, int s, int lane) {
  int pid = 0;
  if (lane == 0) {
    pid = g.table[(long long)slot * g.max_pages + s];
    if (pid < 0 || pid >= g.n_pages) __trap();   // a corrupt page table
    mbar_expect_tx(&sc.full[st], 2 * PAGE * kDh * 2);
  }
  pid = __shfl_sync(kFull, pid, 0);
  __syncwarp();
  const long long base = ((long long)pid * g.kvh + head) * PAGE * kDh;
  for (int r = lane; r < 2 * PAGE; r += 32) {
    const int which = r / PAGE, j = r % PAGE;
    bulk_copy(&sc.kv[st][which][j][0], (which ? g.v : g.k) + base + j * kDh,
              kDh * 2, &sc.full[st]);
  }
}

// SEU: the instance of campaigns.
template <int PAGE, bool SEU>
__global__ void __launch_bounds__(kThr)
flash_decode_sm90_kernel(const DecArgs g) {
  constexpr int NTS = PAGE / 32;     // S n-tiles (8 kv columns) per warp
  constexpr int CW = PAGE / kWarps;  // S kv columns per warp
  extern __shared__ __align__(128) uint8_t smem_raw[];
  DecSmem<PAGE>& sc = *reinterpret_cast<DecSmem<PAGE>*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int gr = lane / 4, tq = lane & 3;       // fragment row / column pair
  const int gi = blockIdx.x, z = blockIdx.y;
  const int slot = gi / g.kvh, head = gi % g.kvh;
  const int len = g.lengths[slot];
  const int live = len > 0 ? min((len + PAGE - 1) / PAGE, g.max_pages) : 0;
  const int s_lo = (int)((long long)z * live / g.ranges);
  const int n = (int)((long long)(z + 1) * live / g.ranges) - s_lo;
  float* part = g.ws + ((long long)gi * g.ranges + z) * kPartial;
  if (n <= 0) {   // an empty range: an empty partial, its acc never written
    if (tid < kBq) {
      part[kBq * kDh + tid] = kNegInf;
      part[kBq * kDh + kBq + tid] = 0.0f;
    }
    if (tid < 8) part[kBq * kDh + 2 * kBq + tid] = 0.0f;
    return;
  }

  if (tid == 0) {
    for (int s = 0; s < kPageRing; ++s) mbar_init(&sc.full[s], 1);
    for (int f = 0; f < 8; ++f) sc.rep[f] = 0.0f;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0)
    for (int i = 0; i < min(n, kPageRing); ++i)
      load_page(sc, i, g, slot, head, s_lo + i, lane);

  // Q (16 x 128) into padded rows; e^T Q and max |Q|; Q's A fragments.
  const __nv_bfloat16* q = g.q + (long long)gi * kBq * kDh;
  for (int c = tid; c < kBq * kDh / 8; c += kThr) {
    const int i = c / (kDh / 8), d = 8 * (c % (kDh / 8));
    *reinterpret_cast<uint4*>(&sc.q[i][d]) =
        *reinterpret_cast<const uint4*>(q + i * kDh + d);
  }
  if (tid < kBq) {
    sc.m[tid] = kNegInf;
    sc.l[tid] = 0.0f;
  }
  __syncthreads();
  {
    float s = 0.0f, mq = 0.0f;
    for (int i = 0; i < kBq; ++i) {
      const float x = bf(sc.q[i][tid]);
      s += x;
      mq = fmaxf(mq, fabsf(x));
    }
    sc.qsum[tid] = s;
    mq = warp_max(mq);
    if (lane == 0) sc.red[warp][0] = mq;
  }
  uint32_t qa[kDh / 16][4];
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    qa[kk][0] = ld32(&sc.q[gr][16 * kk + 2 * tq]);
    qa[kk][1] = ld32(&sc.q[gr + 8][16 * kk + 2 * tq]);
    qa[kk][2] = ld32(&sc.q[gr][16 * kk + 8 + 2 * tq]);
    qa[kk][3] = ld32(&sc.q[gr + 8][16 * kk + 8 + 2 * tq]);
  }
  __syncthreads();
  const float qmax = fmaxf(fmaxf(sc.red[0][0], sc.red[1][0]),
                           fmaxf(sc.red[2][0], sc.red[3][0]));

  float acc[4][4];   // the output accumulator: dh columns 32·warp ..
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[t][r] = 0.0f;
  const bool hit_row = g.inj_enable && gi == g.inj_g && g.inj_qi == 0;
  const seu::Hit sh = SEU ? seu::draw(g.seu, (uint32_t)gi, live, kBq, kDh)
                          : seu::Hit{false, 0, 0, 0};

  for (int it = 0; it < n; ++it) {
    const int s = s_lo + it, st = it % kPageRing, kv_start = s * PAGE;
    const bool hit = hit_row && s == g.inj_s;
    mbar_wait(&sc.full[st], (it / kPageRing) & 1);
    const __nv_bfloat16(*Kp)[kRow] = sc.kv[st][0];
    const __nv_bfloat16(*Vp)[kRow] = sc.kv[st][1];

    // ---- S = Q·Kᵀ: this warp's kv columns, on the tensor cores ----------
    float sa[NTS][4];
#pragma unroll
    for (int t = 0; t < NTS; ++t) {
#pragma unroll
      for (int r = 0; r < 4; ++r) sa[t][r] = 0.0f;
      const int j = warp * CW + 8 * t + gr;
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk)
        mma16816(sa[t], qa[kk], ld32(&Kp[j][16 * kk + 2 * tq]),
                 ld32(&Kp[j][16 * kk + 8 + 2 * tq]));
    }
    // Checksums from the staged tiles: K^T e and max |K| (thread = dh
    // column); (e^T Q)·K[j], V e and max |V| (two threads a kv row).
    {
      float ks = 0.0f, km = 0.0f, vm = 0.0f;
      for (int j = 0; j < PAGE; ++j) {
        const float x = bf(Kp[j][tid]);
        ks += x;
        km = fmaxf(km, fabsf(x));
      }
      sc.ksum[tid] = ks;
      if (tid < 2 * PAGE) {          // whole warps
        const int j = tid / 2, hf = tid & 1;
        float c = 0.0f, vs = 0.0f;
        for (int d = 64 * hf; d < 64 * hf + 64; d += 2) {
          const float2 kf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&Kp[j][d]));
          const float2 vf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&Vp[j][d]));
          c = fmaf(sc.qsum[d], kf.x, c);
          c = fmaf(sc.qsum[d + 1], kf.y, c);
          vs += vf.x + vf.y;
          vm = fmaxf(vm, fmaxf(fabsf(vf.x), fabsf(vf.y)));
        }
        c += __shfl_xor_sync(kFull, c, 1);
        vs += __shfl_xor_sync(kFull, vs, 1);
        if (hf == 0) {
          sc.cks[j] = c;
          sc.vsum[j] = vs;
        }
      }
      km = warp_max(km);
      vm = warp_max(vm);
      if (lane == 0) {
        sc.red[warp][1] = km;
        sc.red[warp][2] = vm;
      }
    }
    __syncthreads();
    const float kmax = fmaxf(fmaxf(sc.red[0][1], sc.red[1][1]),
                             fmaxf(sc.red[2][1], sc.red[3][1]));
    const float vmax = fmaxf(fmaxf(sc.red[0][2], sc.red[1][2]),
                             fmaxf(sc.red[2][2], sc.red[3][2]));
    {   // S's row check Q[i]·(K^T e): eight threads a row
      const int i = tid / 8, p = tid & 7;
      float c = 0.0f;
#pragma unroll
      for (int d = 16 * p; d < 16 * p + 16; ++d)
        c = fmaf(bf(sc.q[i][d]), sc.ksum[d], c);
      c += __shfl_xor_sync(kFull, c, 1);
      c += __shfl_xor_sync(kFull, c, 2);
      c += __shfl_xor_sync(kFull, c, 4);
      if (p == 0) sc.rck[i] = c;
    }
    if (hit && g.inj_enable == 2)
      frag16_add<NTS>(sa, g.inj_row, g.inj_col - warp * CW, g.inj_mag, lane);
    frag16_sums<NTS>(sa, sc.cks, sc.dcol, sc.rowp, warp * CW, warp, lane);
    __syncthreads();
    if (warp == 0)
      locate16(sc.dcol, PAGE, sc.drow, sc.rowp, sc.rck, nullptr,
               g.tau_qk_coef * qmax * kmax, (float)(s + 1), g.corrects,
               kv_start, sc.rep, &sc.verdict, lane);
    __syncthreads();
    {
      const abft::Verdict v = sc.verdict;
      if (g.corrects && v.det)
        frag16_add<NTS>(sa, v.row, v.col - warp * CW, -v.mag, lane);
    }

    // ---- scale, mask, the rows' max over the page -------------------------
    const float m_prev[2] = {sc.m[gr], sc.m[gr + 8]};
    {
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int t = 0; t < NTS; ++t)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = kv_start + warp * CW + 8 * t + 2 * tq + e;
            const float x = kpos < len ? sa[t][2 * hf + e] * g.scale : kNegInf;
            sa[t][2 * hf + e] = x;
            mx[hf] = fmaxf(mx[hf], x);
          }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFull, mx[hf], 1));
        mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFull, mx[hf], 2));
      }
      if (tq == 0) {
        sc.rmax[warp][gr] = mx[0];
        sc.rmax[warp][gr + 8] = mx[1];
      }
    }
    __syncthreads();

    // ---- P, its hi / lo halves, l's partial, e^T P and P·(V e) -----------
    float m_new[2], alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = gr + 8 * hf;
      const float mm = fmaxf(fmaxf(sc.rmax[0][i], sc.rmax[1][i]),
                             fmaxf(sc.rmax[2][i], sc.rmax[3][i]));
      m_new[hf] = fmaxf(m_prev[hf], mm);
      alpha[hf] = expf(fminf(m_prev[hf] - m_new[hf], 0.0f));
    }
    {
      float ls[2] = {0.0f, 0.0f}, rq[2] = {0.0f, 0.0f};
#pragma unroll
      for (int t = 0; t < NTS; ++t) {
        const int jl = warp * CW + 8 * t + 2 * tq;   // this lane's kv columns
        float hl[4];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float p[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            p[e] = m_new[hf] > 0.5f * kNegInf
                       ? expf(fminf(sa[t][2 * hf + e] - m_new[hf], 0.0f))
                       : 0.0f;
            ls[hf] += p[e];
          }
          const __nv_bfloat162 h = __floats2bfloat162_rn(p[0], p[1]);
          const float2 hf2 = __bfloat1622float2(h);
          const __nv_bfloat162 lo = __floats2bfloat162_rn(p[0] - hf2.x,
                                                          p[1] - hf2.y);
          const float2 lf2 = __bfloat1622float2(lo);
          *reinterpret_cast<__nv_bfloat162*>(&sc.phi[gr + 8 * hf][jl]) = h;
          *reinterpret_cast<__nv_bfloat162*>(&sc.plo[gr + 8 * hf][jl]) = lo;
          hl[2 * hf] = hf2.x + lf2.x;
          hl[2 * hf + 1] = hf2.y + lf2.y;
          rq[hf] = fmaf(hl[2 * hf], sc.vsum[jl], rq[hf]);
          rq[hf] = fmaf(hl[2 * hf + 1], sc.vsum[jl + 1], rq[hf]);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float c = hl[e] + hl[2 + e];
          c += __shfl_xor_sync(kFull, c, 4);
          c += __shfl_xor_sync(kFull, c, 8);
          c += __shfl_xor_sync(kFull, c, 16);
          if (lane < 4) sc.psum[jl + e] = c;
        }
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        ls[hf] += __shfl_xor_sync(kFull, ls[hf], 1);
        ls[hf] += __shfl_xor_sync(kFull, ls[hf], 2);
        rq[hf] += __shfl_xor_sync(kFull, rq[hf], 1);
        rq[hf] += __shfl_xor_sync(kFull, rq[hf], 2);
      }
      if (tq == 0) {
        sc.lsum[warp][gr] = ls[0];
        sc.lsum[warp][gr + 8] = ls[1];
        sc.rowq[warp][gr] = rq[0];
        sc.rowq[warp][gr + 8] = rq[1];
      }
    }
    __syncthreads();
    if (tid < kBq) {
      const float mm = fmaxf(fmaxf(sc.rmax[0][tid], sc.rmax[1][tid]),
                             fmaxf(sc.rmax[2][tid], sc.rmax[3][tid]));
      const float mp = sc.m[tid], mn = fmaxf(mp, mm);
      const float al = expf(fminf(mp - mn, 0.0f));
      sc.l[tid] = sc.l[tid] * al + (sc.lsum[0][tid] + sc.lsum[1][tid] +
                                    sc.lsum[2][tid] + sc.lsum[3][tid]);
      sc.m[tid] = mn;
    }
    {   // Δ's column check (e^T P)·V[:, c], thread = dh column
      float c = 0.0f;
      for (int j = 0; j < PAGE; ++j) c = fmaf(sc.psum[j], bf(Vp[j][tid]), c);
      sc.ckd[tid] = c;
    }

    // ---- Δ = P·V: this warp's dh columns, both halves on the tensor cores -
    float da[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) da[t][r] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < PAGE / 16; ++kk) {
      const int j0 = 16 * kk + 2 * tq;
      const uint32_t ah[4] = {ld32(&sc.phi[gr][j0]), ld32(&sc.phi[gr + 8][j0]),
                              ld32(&sc.phi[gr][j0 + 8]),
                              ld32(&sc.phi[gr + 8][j0 + 8])};
      const uint32_t al[4] = {ld32(&sc.plo[gr][j0]), ld32(&sc.plo[gr + 8][j0]),
                              ld32(&sc.plo[gr][j0 + 8]),
                              ld32(&sc.plo[gr + 8][j0 + 8])};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int c = 32 * warp + 8 * t + gr;
        const uint32_t b0 = pack2(Vp[j0][c], Vp[j0 + 1][c]);
        const uint32_t b1 = pack2(Vp[j0 + 8][c], Vp[j0 + 9][c]);
        mma16816(da[t], ah, b0, b1);
        mma16816(da[t], al, b0, b1);
      }
    }
    if (hit && g.inj_enable == 1)
      frag16_add<4>(da, g.inj_row, g.inj_col - 32 * warp, g.inj_mag, lane);
    if (SEU && sh.hit && s == sh.step)
      frag16_seu<4>(da, sh.row, sh.col - 32 * warp, g.seu.shift, lane);
    __syncwarp();   // this warp's columns of ckd come from its own lanes
    frag16_sums<4>(da, sc.ckd, sc.dcol, sc.rowp, 32 * warp, warp, lane);
    __syncthreads();
    if (warp == 0) {
      // The stage is read: bring the page two ahead into it.
      if (it + kPageRing < n) load_page(sc, st, g, slot, head, s + kPageRing, lane);
      const float eff_kv = (float)min(len - kv_start, PAGE);
      locate16(sc.dcol, kDh, sc.drow, sc.rowp, nullptr, sc.rowq,
               g.tau_coef * eff_kv * vmax, eff_kv, g.corrects, 0, sc.rep,
               &sc.verdict, lane);
    }
    __syncthreads();
    {
      const abft::Verdict v = sc.verdict;
      if (g.corrects && v.det)
        frag16_add<4>(da, v.row, v.col - 32 * warp, -v.mag, lane);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc[t][r] = acc[t][r] * alpha[r >> 1] + da[t][r];
  }

  // ---- this range's partial: acc (all 16 rows), m, l, the report ----------
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int c = 32 * warp + 8 * t + 2 * tq;
    *reinterpret_cast<float2*>(part + gr * kDh + c) =
        make_float2(acc[t][0], acc[t][1]);
    *reinterpret_cast<float2*>(part + (gr + 8) * kDh + c) =
        make_float2(acc[t][2], acc[t][3]);
  }
  if (tid < kBq) {
    part[kBq * kDh + tid] = sc.m[tid];
    part[kBq * kDh + kBq + tid] = sc.l[tid];
  }
  if (tid < 8) part[kBq * kDh + 2 * kBq + tid] = sc.rep[tid];
}

// The ranges of each row merged: every (range, query row)'s m and l into
// shared memory at once; per query row (threads 0-15) the max m over the
// non-empty ranges, each range's weight w = exp(m_z - m) in place of m_z,
// l = Σ w_z·l_z and 1/l (0 where m is degenerate or l = 0); then each
// thread sums w_z·acc_z of its dh column over the non-empty ranges for the
// 16 rows at once (16 independent loads a range) and writes acc / l in
// bf16; warp 1 merges the reports in range order with abft::merge.
__global__ void __launch_bounds__(kThr)
flash_decode_combine(const float* ws, __nv_bfloat16* out, float* rep,
                     int ranges) {
  extern __shared__ float wsm[];   // m, then w [ranges][16]; l; 1/l; live
  float* ls = wsm + ranges * kBq;
  float* linv = ls + ranges * kBq;
  float* live = linv + kBq;        // [ranges]: the range holds pages
  const int gi = blockIdx.x, tid = threadIdx.x;
  const float* base = ws + (long long)gi * ranges * kPartial;
  for (int e = tid; e < ranges * kBq; e += kThr) {
    const float* p = base + (long long)(e / kBq) * kPartial + kBq * kDh;
    wsm[e] = p[e % kBq];
    ls[e] = p[kBq + e % kBq];
  }
  __syncthreads();
  if (tid < kBq) {
    float mm = kNegInf, ll = 0.0f;
    for (int z = 0; z < ranges; ++z) mm = fmaxf(mm, wsm[z * kBq + tid]);
    for (int z = 0; z < ranges; ++z) {
      const float mz = wsm[z * kBq + tid];
      const bool nonempty = mz > 0.5f * kNegInf;
      const float w = nonempty ? expf(fminf(mz - mm, 0.0f)) : 0.0f;
      ll += w * ls[z * kBq + tid];
      if (tid == 0) live[z] = nonempty ? 1.0f : 0.0f;
      wsm[z * kBq + tid] = w;
    }
    const bool good = mm > 0.5f * kNegInf && ll > 0.0f;
    linv[tid] = good ? 1.0f / fmaxf(ll, 1e-30f) : 0.0f;
  } else if (tid == 32) {
    float r[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int z = 0; z < ranges; ++z)
      abft::merge(r, base + (long long)z * kPartial + kBq * kDh + 2 * kBq);
    for (int f = 0; f < 8; ++f) rep[(long long)gi * 8 + f] = r[f];
  }
  __syncthreads();
  float a[kBq];
#pragma unroll
  for (int i = 0; i < kBq; ++i) a[i] = 0.0f;
  for (int z = 0; z < ranges; ++z) {
    if (live[z] == 0.0f) continue;   // an empty range's acc is never read
    const float* p = base + (long long)z * kPartial + tid;
#pragma unroll
    for (int i = 0; i < kBq; ++i) a[i] += wsm[z * kBq + i] * p[i * kDh];
  }
#pragma unroll
  for (int i = 0; i < kBq; ++i)
    out[((long long)gi * kBq + i) * kDh + tid] = __float2bfloat16(a[i] * linv[i]);
}

template <int PAGE, bool SEU>
cudaError_t launch(const DecArgs& g, int rows, cudaStream_t st) {
  constexpr int bytes = (int)sizeof(DecSmem<PAGE>);
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_sm90_kernel<PAGE, SEU>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  flash_decode_sm90_kernel<PAGE, SEU>
      <<<dim3(rows, g.ranges), kThr, bytes, st>>>(g);
  return cudaGetLastError();
}

template <int PAGE>
cudaError_t launch_page(const DecArgs& g, int rows, cudaStream_t st) {
  return g.seu.on ? launch<PAGE, true>(g, rows, st)
                  : launch<PAGE, false>(g, rows, st);
}

}  // namespace

extern "C" {

const char* flash_decode_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K6 on the tensor cores, with flash_decode.cu's flash_decode_launch
// arguments but the workspace ws in place of out and report, and the
// range count: q (n_slots·kvh, 16, 128) and k, v (n_pages, kvh, page, 128)
// bf16 (dtype 1), 16-byte aligned; lengths (n_slots) and table (n_slots,
// max_pages) int32; ws f32 of n_slots·kvh·ranges·(16·128 + 40) elements;
// all contiguous. page 32 or 64. inj: [enable (1 Δ, 2 S), g, 0, kv step,
// row, col]; seu_*: the stochastic hook's campaign (seu_hook.cuh; on picks
// the campaign instance). flash_decode_combine_launch then writes out and
// the report. Returns the launch's cudaError_t.
int flash_decode_sm90_launch(const void* q, const void* k, const void* v,
                             const int* lengths, const int* table, float* ws,
                             int ranges, int n_slots, int kvh, int bq, int dh,
                             int page, int max_pages, int n_pages, int dtype,
                             int corrects, float scale, float tau_qk_coef,
                             float tau_coef, int inj_enable, int inj_g,
                             int inj_qi, int inj_s, int inj_row, int inj_col,
                             float inj_mag, int seu_on, unsigned seu_seed,
                             float seu_rate, int seu_shift, void* stream) {
  if (n_slots <= 0 || kvh <= 0 || bq != kBq || dh != kDh || dtype != 1 ||
      max_pages <= 0 || n_pages <= 0 || ranges <= 0 || ranges > 65535 ||
      (long long)n_slots * kvh > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  DecArgs g{};
  g.q = static_cast<const __nv_bfloat16*>(q);
  g.k = static_cast<const __nv_bfloat16*>(k);
  g.v = static_cast<const __nv_bfloat16*>(v);
  g.lengths = lengths; g.table = table; g.ws = ws;
  g.kvh = kvh; g.max_pages = max_pages; g.n_pages = n_pages;
  g.ranges = ranges; g.corrects = corrects; g.scale = scale;
  g.tau_qk_coef = tau_qk_coef; g.tau_coef = tau_coef;
  g.inj_enable = inj_enable; g.inj_g = inj_g; g.inj_qi = inj_qi;
  g.inj_s = inj_s; g.inj_row = inj_row; g.inj_col = inj_col;
  g.inj_mag = inj_mag;
  g.seu = seu::Args{seu_on, seu_seed, seu_rate, seu_shift};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = n_slots * kvh;
  if (page == 32) return launch_page<32>(g, rows, st);
  if (page == 64) return launch_page<64>(g, rows, st);
  return cudaErrorInvalidValue;
}

// The combine: ws as flash_decode_sm90_launch left it for g rows and
// `ranges` ranges; out (g, 16, 128) bf16 and report (g, 8) f32.
int flash_decode_combine_launch(const float* ws, void* out, float* rep, int g,
                                int ranges, void* stream) {
  const int bytes = (ranges * (2 * kBq + 1) + kBq) * (int)sizeof(float);
  if (g <= 0 || ranges <= 0 || bytes > 48 * 1024) return cudaErrorInvalidValue;
  flash_decode_combine<<<g, kThr, bytes, static_cast<cudaStream_t>(stream)>>>(
      ws, static_cast<__nv_bfloat16*>(out), rep, ranges);
  return cudaGetLastError();
}

}  // extern "C"
