// Flash-attention forward with online ABFT on the tensor cores (sm_90a):
// K2 for bf16 q, k, v at head dim 128, with and without the saved softmax
// statistics (m, l).
//
// Replaces the TPU kernel K2 of the JAX package:
//   src/repro/kernels/flashft.py:114 _flash_ft_kernel, launched by
//   templates/registry.py:178 flash_fwd_call.
// It computes what the SIMT kernel of csrc/flash_ft.cu computes, on the
// same 64 x 64 block grid with the same thresholds and 8-float report
// (one per (query head, 64-row q block)); that source keeps f32, head dim
// 64, pinned blocks and operands TMA cannot read, and
// kernels/flashft.py:plan_fwd picks between the two. Per live kv block:
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
// k, v and the output); what sets the pace is each kv step's chain of two
// products, their checksums and verifications and the softmax. The design:
//   * both products on the tensor cores: bf16 `wgmma` m64n64k16 for S (Q
//     and K read K-major from their staged tiles) and m64n128k16 for Δ (P
//     K-major, V N-major), f32 accumulators in registers;
//   * a CTA holds two consumer warpgroups, each owning one 64-row q block:
//     two query heads of one GQA group at the same q block, so both walk
//     the same kv blocks and share one TMA ring of K and V tiles (3-D
//     tensor maps over (head, row, dh), rows past Skv read zero, 128-byte
//     swizzled, two stages) kept full by one thread of a producer
//     warpgroup; Q is loaded once. With an odd n_rep the last pair's
//     second warpgroup has no head and leaves at once;
//   * the producer warpgroup gives registers up with `setmaxnreg` so the
//     consumers can hold the output accumulator (64 floats), Δ (64) and
//     S (32): the register pool counts whole warpgroups, so the producer
//     is a full one (384 threads a CTA);
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
constexpr int kFwdThreads = 3 * kNT;      // two consumer warpgroups, a producer

struct FwdArgs {
  __nv_bfloat16* out;  // (bh, sq, 128)
  float* rep;          // (bh, nqb, 8)
  float* m_out;        // nullptr, or (bh, sq) saved row max
  float* l_out;        // nullptr, or (bh, sq) saved row sum
  int sq, skv, n_rep, nqb, pairs, causal, corrects;
  float scale;
  float tau_qk_coef;   // rel_tau * eps32 * round_up(dh, 128)
  float tau_coef;      // rel_tau * eps32
  int inj_enable, inj_bh, inj_qb, inj_s, inj_row, inj_col;
  float inj_mag;
  seu::Args seu;       // the stochastic hook's campaign
};

// One consumer warpgroup's scratch.
struct FwdWg {
  float part[2][4 * kDh];   // col_reduce's partials, two halves in turn
  float qsum[kDh];          // e^T Q
  float ksum[kDh];          // K^T e
  float ck_col[kDh], ck_row[kB];
  float vrow[kB];           // V e
  float psum[kB];           // e^T P
  float red[2][4];
  FragVerify vf;
  float rep[8];
};

struct FwdSmem {
  uint64_t full[kRing], empty[kRing], qb;
  FwdWg wg[2];
};

constexpr int fwd_smem_bytes() {
  return 1024 + 2 * kTile + kRing * 2 * kTile + 4 * kHalf +
         (int)sizeof(FwdSmem);
}

// Scale, masks and the online softmax of one step in place on the S
// accumulator (q rows q_start + i, kv columns kv_start + j): P, this
// thread's two rows' running max and sum updated, their alpha returned.
__device__ __forceinline__ void softmax_step(float (&s)[32], const FwdArgs& g,
                                             int q_start, int kv_start,
                                             float (&m_r)[2], float (&l_r)[2],
                                             float (&alpha)[2], int tid) {
  const int lane = tid & 31, c_off = g.skv - g.sq;
  const int i0 = (tid / 32) * 16 + lane / 4;
  float mx[2] = {kNegInf, kNegInf};
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

// One CTA per (kv head, pair of its query heads, 64-row q block): consumer
// warpgroup c takes query head 2·pair + c of the group. SEU: the instance
// of campaigns.
template <bool SEU>
__global__ void __launch_bounds__(kFwdThreads, 1)
flash_ft_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const FwdArgs g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = Qs + 2 * kTile;             // [kRing] x (K tile, V tile)
  uint8_t* pbuf = ring + kRing * 2 * kTile;   // [2] x (P hi, P lo)
  FwdSmem& sc = *reinterpret_cast<FwdSmem*>(pbuf + 4 * kHalf);

  const int tid = threadIdx.x;
  const int kvh = blockIdx.x / g.pairs, pr = blockIdx.x % g.pairs;
  const int h0 = kvh * g.n_rep + 2 * pr;
  const int n_live = min(2, g.n_rep - 2 * pr);
  const int qi = g.nqb - 1 - blockIdx.y;     // long causal blocks first
  const int q_start = qi * kB, c_off = g.skv - g.sq;
  const int nkv = (g.skv + kB - 1) / kB, hi_row = q_start + kB - 1 + c_off;
  const int nsteps =
      !g.causal ? nkv : (hi_row < 0 ? 0 : min(nkv, hi_row / kB + 1));

  if (tid == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(&sc.full[s], 1);
      mbar_init(&sc.empty[s], n_live * kNT / 32);
    }
    mbar_init(&sc.qb, 1);
    for (int w = 0; w < 2; ++w)
      for (int f = 0; f < 8; ++f) sc.wg[w].rep[f] = 0.0f;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 2 * kNT) {
    // ---- producer warpgroup: Q once, then the K and V ring -------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 2 * kNT) {
      mbar_expect_tx(&sc.qb, n_live * kTile);
      for (int c = 0; c < n_live; ++c)
        load_tile(Qs + c * kTile, &tq, q_start, h0 + c, &sc.qb);
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
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");

  // ---- consumer warpgroups ------------------------------------------------
  const int wg = tid / kNT, t = tid % kNT, bar = 1 + wg;
  if (wg >= n_live) return;
  FwdWg& w = sc.wg[wg];
  const int h = h0 + wg;
  const uint8_t* qs = Qs + wg * kTile;
  uint8_t* p_hi = pbuf + wg * 2 * kHalf;
  uint8_t* p_lo = p_hi + kHalf;
  mbar_wait(&sc.qb, 0);
  float am;
  col_reduce<kDh>(qs, nullptr, nullptr, w.qsum, w.part[0], &am, t, bar);
  const float qmax = wg_max2(am, 0.0f, w.red, t, bar).x;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.0f, 0.0f};
  const bool hit_blk = g.inj_enable && h == g.inj_bh && qi == g.inj_qb &&
                       g.inj_row >= 0 && g.inj_row < kB && g.inj_col >= 0;
  const seu::Hit sh =
      SEU ? seu::draw(g.seu, (uint32_t)(h * g.nqb + qi), nsteps, kB, kDh)
          : seu::Hit{false, 0, 0, 0};

  for (int it = 0; it < nsteps; ++it) {
    const int slot = it % kRing, kv_start = it * kB;
    const bool hit = hit_blk && it == g.inj_s;
    mbar_wait(&sc.full[slot], (it / kRing) & 1);
    const uint8_t* Ks = ring + slot * 2 * kTile;
    const uint8_t* Vs = Ks + kTile;

    // S = Q·Kᵀ on the tensor cores, while its checksums come from the
    // staged tiles: column (e^T Q)·K[j], row Q[i]·(K^T e); and V e, max |V|
    // for the delta.
    float sd[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sd[i] = 0.0f;
    fence_frag(sd);
    wgmma_fence();
    mma_abt(sd, qs, Ks);
    wgmma_commit();
    float km, vm = 0.0f;
    col_reduce<kDh>(Ks, nullptr, nullptr, w.ksum, w.part[1], &km, t, bar);
    if (t < kB) {
      w.ck_col[t] = row_dot<kDh>(Ks, nullptr, t, w.qsum, nullptr, nullptr);
    } else {
      float x;
      row_dot<kDh>(Vs, nullptr, t - kB, nullptr, &x, &vm);
      w.vrow[t - kB] = x;
    }
    wg_sync(bar);
    if (t < kB) w.ck_row[t] = row_dot<kDh>(qs, nullptr, t, w.ksum, nullptr, nullptr);
    const float2 mx = wg_max2(km, vm, w.red, t, bar);   // max |K|, max |V|
    wgmma_wait<0>();
    fence_frag(sd);
    if (hit && g.inj_enable == 2 && g.inj_col < kB)
      frag_add<kB>(sd, g.inj_row, g.inj_col, g.inj_mag, t);
    verify_frag<kB>(sd, w.ck_col, w.ck_row, g.tau_qk_coef * qmax * mx.x,
                    (float)(it + 1), g.corrects, q_start, kv_start, w.vf,
                    w.rep, t, bar);

    // P in the registers, staged as hi / lo halves for the delta.
    float alpha[2];
    softmax_step(sd, g, q_start, kv_start, m_r, l_r, alpha, t);
    store_frag_hilo(sd, p_hi, p_lo, t);
    fence_proxy_async();
    wg_sync(bar);

    // Δ = P·V: both halves into one accumulator, V's tile read N-major;
    // its checksums from hi + lo as staged: row P[i]·(V e), column
    // (e^T P)·V.
    float dl[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dl[i] = 0.0f;
    fence_frag(dl);
    wgmma_fence();
    mma_ab<0>(dl, p_hi, Vs);
    mma_ab<0>(dl, p_lo, Vs);
    wgmma_commit();
    if (t < kB) w.ck_row[t] = row_dot<kB>(p_hi, p_lo, t, w.vrow, nullptr, nullptr);
    col_reduce<kB>(p_hi, p_lo, nullptr, w.psum, w.part[0], nullptr, t, bar);
    wg_sync(bar);
    col_reduce<kDh>(Vs, nullptr, w.psum, w.ck_col, w.part[1], nullptr, t, bar);
    wgmma_wait<0>();
    fence_frag(dl);
    if (hit && g.inj_enable == 1 && g.inj_col < kDh)
      frag_add<kDh>(dl, g.inj_row, g.inj_col, g.inj_mag, t);
    if (SEU && sh.hit && it == sh.step)
      frag_seu<kDh>(dl, sh.row, sh.col, g.seu.shift, t);
    const float eff_kv = (float)min(g.skv - kv_start, kB);
    verify_frag<kDh>(dl, w.ck_col, w.ck_row, g.tau_coef * eff_kv * mx.y,
                     eff_kv, g.corrects, q_start, 0, w.vf, w.rep, t, bar);
#pragma unroll
    for (int j = 0; j < 16; ++j)
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
    __nv_bfloat16* dst = g.out + (rbase + gi) * kDh + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 16; ++j)
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
}

template <bool SEU>
cudaError_t launch_fwd(const CUtensorMap* maps, const FwdArgs& g, int kvh,
                       cudaStream_t stream) {
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_ft_sm90_kernel<SEU>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        fwd_smem_bytes());
    if (e != cudaSuccess) return e;
    ready = true;
  }
  flash_ft_sm90_kernel<SEU><<<dim3(kvh * g.pairs, g.nqb), kFwdThreads,
                              fwd_smem_bytes(), stream>>>(maps[0], maps[1],
                                                          maps[2], g);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* flash_fwd_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K2 on the tensor cores, with flash_ft.cu's flash_ft_launch signature: q,
// out (bh, sq, 128) and k, v (bh / n_rep, skv, 128) bf16 (dtype 1),
// 16-byte aligned; report (bh, ceil(sq / 64), 8); m_out, l_out nullptr or
// (bh, sq) f32; all contiguous. inj: [enable (1 Δ, 2 S), bh, q block, kv
// step, row, col]; seu_*: the stochastic hook's campaign (seu_hook.cuh; on
// picks the campaign instance). Returns the launch's cudaError_t.
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
      dh != kDh || dtype != 1 || (m_out == nullptr) != (l_out == nullptr))
    return cudaErrorInvalidValue;
  FwdArgs g{};
  g.out = static_cast<__nv_bfloat16*>(out);
  g.rep = rep; g.m_out = m_out; g.l_out = l_out;
  g.sq = sq; g.skv = skv; g.n_rep = n_rep; g.nqb = (sq + kB - 1) / kB;
  g.pairs = (n_rep + 1) / 2;
  g.causal = causal; g.corrects = corrects; g.scale = scale;
  g.tau_qk_coef = tau_qk_coef; g.tau_coef = tau_coef;
  g.inj_enable = inj_enable; g.inj_bh = inj_bh; g.inj_qb = inj_qb;
  g.inj_s = inj_s; g.inj_row = inj_row; g.inj_col = inj_col;
  g.inj_mag = inj_mag;
  g.seu = seu::Args{seu_on, seu_seed, seu_rate, seu_shift};
  const int kvh = bh / n_rep;
  if (g.nqb > 65535 || (long long)kvh * g.pairs > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  CUtensorMap maps[3];
  if (!make_map3(&maps[0], q, kDh, sq, bh, kDh, (long long)sq * kDh, 64, 64) ||
      !make_map3(&maps[1], k, kDh, skv, kvh, kDh, (long long)skv * kDh, 64, 64) ||
      !make_map3(&maps[2], v, kDh, skv, kvh, kDh, (long long)skv * kDh, 64, 64))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return seu_on ? launch_fwd<true>(maps, g, kvh, st)
                : launch_fwd<false>(maps, g, kvh, st);
}

}  // extern "C"
