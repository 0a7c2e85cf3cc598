// Flash-attention backward with online ABFT for Hopper (sm_90a): the dQ
// kernel and the dK/dV kernel over the forward's saved softmax statistics.
//
// Replaces the TPU kernels K3 and K4 of the JAX package:
//   src/repro/kernels/flashft.py:_flash_dq_kernel (launched by
//   templates/registry.py:flash_dq_call) and
//   src/repro/kernels/flashft.py:_flash_dkv_kernel (launched by
//   templates/registry.py:flash_dkv_call).
//
// Both recompute P = exp(min(scale·S - m, 0)) / l from the saved (m, l)
// (rows with l = 0, among them every row past the true Sq, get p = 0) and
// take di = rowsum(g ∘ o) from the wrapper. Every in-kernel GEMM is
// verified with the Huang–Abraham checksums of its operand tiles, located
// and corrected per step, with the thresholds of the reference:
//   S  = Q·Kᵀ   tau = rel_tau·eps32·round_up(dh, 128)·max|Q|·max|K|, k = 1
//   dP = g·Vᵀ   tau = rel_tau·eps32·round_up(dh, 128)·max|g|·max|V|, k = that dh
//   dQ += dS·K  tau = rel_tau·eps32·eff_kv·max|dS|·max|K|, k = eff_kv
//   dV += Pᵀ·g  tau = rel_tau·eps32·eff_q·max|P|·max|g|,   k = eff_q
//   dK += dSᵀ·Q tau = rel_tau·eps32·eff_q·max|dS|·max|Q|,  k = eff_q
// with dS = P ∘ (dP - di) · scale (the softmax scale rides dS, so dK needs
// none), eff_kv = min(Skv - kv_start, 64) and eff_q = max(min(Sq - q_start,
// 64), 1). The report (8 floats per stationary block) follows the forward's
// rules (det/corr add, row/col/mag overwrite on detection, max residual
// takes the max, tau and k overwrite).
//
// dQ: one CTA of 256 threads per (query head, q block of 64 rows); a loop
// over the live kv blocks of 64 (bottom-right-aligned causal bound) keeps
// Q, g, K and V (both transposed), P / dS, dP and the dQ delta in dynamic
// shared memory (f32, about 200 KB at dh = 128) and dQ in registers.
// dK/dV: one CTA per (kv head, kv block of 64); the loop walks the n_rep
// query heads of the kv head times their live q blocks, so dK and dV come
// back per kv head, summed in registers, with no atomics and K/V never
// repeated. A block that runs no step writes zeros.
// Stochastic SEU campaigns (seu_hook.cuh, salts 0x52 and 0x53 reduced on
// the host): each dQ CTA draws its block's SEU by its uid bh·nqb + qi over
// its live kv steps and lands it in that step's dQ delta; each dK/dV CTA
// draws by its uid b·nkvb + kvi over its walk of n_rep x live q blocks and
// lands it in the dV delta of that walk step (the reference's
// flashft.py:519-521, :555-556 and :609-616, :655-656); after the
// deterministic SEU, before the verification. Campaigns run in their own
// instances (SEU = true), so a clean call runs the code it ran before the
// hook.
// What bounds them on the H100: at the training shapes they are bound by
// operations (3 and 4 GEMMs of 2·64·64·dh per live block); this first
// version runs every product on the CUDA cores in f32, with one CTA per SM
// because of the shared-memory footprint. PERF.md carries their times.
#include "abft_block.cuh"
#include "seu_hook.cuh"

namespace {

using namespace abft;

constexpr int BQ = 64, BKV = 64, SP = BKV + 1;
constexpr float kNegInf = -1e30f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* g;
  const float* m;
  const float* l;
  const float* di;
  void* dq;            // dQ kernel: (bh, sq, dh)
  void* dk;            // dK/dV kernel: (bh / n_rep, skv, dh) each
  void* dv;
  float* rep;
  int sq, skv, n_rep, nqb, nkvb, causal, corrects;
  float scale;
  float tau_qk_coef;   // rel_tau * eps32 * round_up(dh, 128)
  float tau_coef;      // rel_tau * eps32
  float tau_dh;        // round_up(dh, 128), the k field of the dP record
  int inj_enable, inj_target, inj_bh, inj_blk, inj_step, inj_row, inj_col;
  float inj_mag;
  seu::Args seu;       // the stochastic hook's campaign
};

enum Target { kDP = 0, kDQ = 1, kDV = 2, kDK = 3 };

template <int DH>
constexpr int smem_floats() {
  return 2 * BQ * DH + 2 * DH * SP + 2 * BQ * SP + 64 * (DH + 1) + 6 * DH +
         8 * 64;
}

// rows x DH tile of a (len, DH) matrix starting at row0, rows past len read
// zero; returns this thread's max |x|.
template <typename T, int DH>
__device__ float load_rows(const T* src, int row0, int len, float* dst) {
  float mx = 0.0f;
  for (int idx = threadIdx.x; idx < 64 * DH; idx += kThreads) {
    const int i = idx / DH;
    const float x = row0 + i < len
                        ? to_f32(src[(long long)(row0 + i) * DH + idx % DH])
                        : 0.0f;
    dst[idx] = x;
    mx = fmaxf(mx, fabsf(x));
  }
  return mx;
}

// The same tile stored transposed, dst[d * SP + j].
template <typename T, int DH>
__device__ float load_rows_t(const T* src, int row0, int len, float* dst) {
  float mx = 0.0f;
  for (int idx = threadIdx.x; idx < 64 * DH; idx += kThreads) {
    const int j = idx / DH, d = idx % DH;
    const float x =
        row0 + j < len ? to_f32(src[(long long)(row0 + j) * DH + d]) : 0.0f;
    dst[d * SP + j] = x;
    mx = fmaxf(mx, fabsf(x));
  }
  return mx;
}

// The saved statistics of q rows [q_start, q_start + 64): rows past sq get
// the degenerate markers (m = NEG_INF, l = 0, so p = 0) and di = 0.
__device__ void load_stats(const BwdArgs& g, long long base, int q_start,
                           float* m_s, float* linv_s, float* di_s) {
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    const bool live = q_start + i < g.sq;
    const float l = live ? g.l[base + q_start + i] : 0.0f;
    m_s[i] = live ? g.m[base + q_start + i] : kNegInf;
    linv_s[i] = l > 0.0f ? 1.0f / fmaxf(l, 1e-30f) : 0.0f;
    di_s[i] = live ? g.di[base + q_start + i] : 0.0f;
  }
}

// a (BQ x DH, row-major) times bt (DH x BKV, transposed, stride SP) into
// dst (BQ x BKV, stride SP): rows ty*4 + i, columns tx + 16*jj. An SEU of
// the deterministic injection lands in the accumulator when `inj`.
template <int DH>
__device__ void gemm_abt(const float* a, const float* bt, float* dst,
                         bool inj, int row, int col, float mag) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.0f;
  for (int d = 0; d < DH; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * DH + d];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) bv[jj] = bt[d * SP + tx + 16 * jj];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
  }
  if (inj && row >= 0 && row < BQ && col >= 0 && col < BKV &&
      row / 4 == ty && col % 16 == tx)
    acc[row % 4][col / 16] += mag;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) dst[(ty * 4 + i) * SP + tx + 16 * jj] = acc[i][jj];
}

// Column checksum (eᵀA)·Bᵀ and row checksum A·(Bᵀe) of S = A·Bᵀ, from
// asum[d] = Σ_i A[i][d] and bsum[d] = Σ_j B[j][d].
template <int DH>
__device__ void checks_abt(const float* a, const float* bt, const float* asum,
                           const float* bsum, float* colck, float* rowck) {
  for (int j = threadIdx.x; j < BKV; j += kThreads) {
    float c = 0.0f;
    for (int d = 0; d < DH; ++d) c = fmaf(asum[d], bt[d * SP + j], c);
    colck[j] = c;
  }
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    float c = 0.0f;
    for (int d = 0; d < DH; ++d) c = fmaf(a[i * DH + d], bsum[d], c);
    rowck[i] = c;
  }
}

// P and dS of one (q block, kv block) step, in place: ps holds S on entry
// and dS on exit, dp holds dP. With keep_p (the dK/dV kernel needs both),
// ps gets P and dp gets dS instead. Returns this thread's (max |P|,
// max |dS|).
__device__ float2 softmax_grad(const BwdArgs& g, int q_start, int kv_start,
                               const float* m_s, const float* linv_s,
                               const float* di_s, float* ps, float* dp,
                               bool keep_p) {
  const int c_off = g.skv - g.sq;
  float pmax = 0.0f, dsmax = 0.0f;
  for (int idx = threadIdx.x; idx < BQ * BKV; idx += kThreads) {
    const int i = idx / BKV, j = idx % BKV;
    const int gi = q_start + i, kpos = kv_start + j;
    const bool live = kpos < g.skv && gi < g.sq &&
                      (!g.causal || gi + c_off >= kpos);
    const float s = ps[i * SP + j] * g.scale;
    const float p = live ? expf(fminf(s - m_s[i], 0.0f)) * linv_s[i] : 0.0f;
    const float ds = p * (dp[i * SP + j] - di_s[i]) * g.scale;
    if (keep_p) {
      ps[i * SP + j] = p;
      dp[i * SP + j] = ds;
    } else {
      ps[i * SP + j] = ds;
    }
    pmax = fmaxf(pmax, fabsf(p));
    dsmax = fmaxf(dsmax, fabsf(ds));
  }
  return make_float2(pmax, dsmax);
}

// S = Q·Kᵀ and dP = g·Vᵀ of one step, each verified and corrected. Q, G
// are (BQ, DH); Kt, Vt (DH, BKV) transposed; S goes to ps and dP to dp.
template <int DH>
__device__ void scores_and_dp(const BwdArgs& g, const float* Qs,
                              const float* Gs, const float* Kt,
                              const float* Vt, const float* qsum,
                              const float* gsum, const float* ksum,
                              const float* vsum, float qm, float gm, float km,
                              float vm, int q_start, int kv_start, bool hit,
                              float* ps, float* dp, float* colck, float* rowck,
                              VerifySmem<64, DH>& vs, float* rep) {
  gemm_abt<DH>(Qs, Kt, ps, false, 0, 0, 0.0f);
  gemm_abt<DH>(Gs, Vt, dp, hit && g.inj_target == kDP, g.inj_row, g.inj_col,
               g.inj_mag);
  checks_abt<DH>(Qs, Kt, qsum, ksum, colck, rowck);
  __syncthreads();
  const float tau_qk = fmaxf(g.tau_qk_coef * qm * km, 1e-30f);
  const Verdict vq = verify_block<BQ, BKV>(ps, SP, colck, rowck, tau_qk, 1.0f,
                                           g.corrects, q_start, kv_start, vs,
                                           rep);
  if (g.corrects && vq.det && threadIdx.x == 0) ps[vq.row * SP + vq.col] -= vq.mag;
  checks_abt<DH>(Gs, Vt, gsum, vsum, colck, rowck);
  __syncthreads();
  const float tau_dp = fmaxf(g.tau_qk_coef * gm * vm, 1e-30f);
  const Verdict vd = verify_block<BQ, BKV>(dp, SP, colck, rowck, tau_dp,
                                           g.tau_dh, g.corrects, q_start,
                                           kv_start, vs, rep);
  if (g.corrects && vd.det && threadIdx.x == 0) dp[vd.row * SP + vd.col] -= vd.mag;
  __syncthreads();
}

// ---------------------------------------------------------------------------
// dQ = Σ_kv dS·K
// ---------------------------------------------------------------------------

template <typename T, int DH, bool SEU>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const BwdArgs g) {
  static_assert(DH >= BKV && DH % 16 == 0, "");
  constexpr int CW = DH / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][DH]
  float* Gs = Qs + BQ * DH;          // [BQ][DH]
  float* Kt = Gs + BQ * DH;          // [DH][SP]  K block, transposed
  float* Vt = Kt + DH * SP;          // [DH][SP]  V block, transposed
  float* Ps = Vt + DH * SP;          // [BQ][SP]  S, then dS
  float* DPs = Ps + BQ * SP;         // [BQ][SP]  dP
  float* Ds = DPs + BQ * SP;         // [BQ][DH + 1] dQ delta
  float* qsum = Ds + BQ * (DH + 1);  // [DH] eᵀQ
  float* gsum = qsum + DH;           // [DH] eᵀg
  float* ksum = gsum + DH;           // [DH] Kᵀe
  float* vsum = ksum + DH;           // [DH] Vᵀe
  float* colck = vsum + DH;          // [DH]
  float* rowck = colck + DH;         // [BQ]
  float* dssum = rowck + BQ;         // [BKV] eᵀdS
  float* krow = dssum + BKV;         // [BKV] K e
  float* m_s = krow + BKV;           // [BQ]
  float* linv_s = m_s + BQ;          // [BQ]
  float* di_s = linv_s + BQ;         // [BQ]
  __shared__ float red[kWarps];
  __shared__ VerifySmem<64, DH> vs;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qi = blockIdx.x, bh = blockIdx.y, kvh = bh / g.n_rep;
  const int sq = g.sq, skv = g.skv, q_start = qi * BQ, c_off = skv - sq;
  const long long qbase = (long long)bh * sq;
  const T* k = static_cast<const T*>(g.k) + (long long)kvh * skv * DH;
  const T* v = static_cast<const T*>(g.v) + (long long)kvh * skv * DH;

  float qm = load_rows<T, DH>(static_cast<const T*>(g.q) + qbase * DH,
                              q_start, sq, Qs);
  float gm = load_rows<T, DH>(static_cast<const T*>(g.g) + qbase * DH,
                              q_start, sq, Gs);
  load_stats(g, qbase, q_start, m_s, linv_s, di_s);
  __syncthreads();
  col_sums<DH>(Qs, BQ, DH, vs.part, qsum);
  col_sums<DH>(Gs, BQ, DH, vs.part, gsum);
  qm = block_max(qm, red);
  gm = block_max(gm, red);
  const bool hit_blk = g.inj_enable && bh == g.inj_bh && qi == g.inj_blk;

  float acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc[i][c] = 0.0f;
  float rep[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const int nkv = (skv + BKV - 1) / BKV;
  const int kv_hi = g.causal ? min(skv, q_start + BQ + c_off) : skv;
  const seu::Hit sh =
      SEU ? seu::draw(g.seu, (uint32_t)(bh * g.nqb + qi),
                      kv_hi > 0 ? (kv_hi + BKV - 1) / BKV : 0, BQ, DH)
          : seu::Hit{false, 0, 0, 0};

  for (int s = 0; s < nkv; ++s) {
    const int kv_start = s * BKV;
    if (g.causal && kv_start > q_start + BQ - 1 + c_off) break;
    const bool hit = hit_blk && s == g.inj_step;
    __syncthreads();
    float km = load_rows_t<T, DH>(k, kv_start, skv, Kt);
    float vm = load_rows_t<T, DH>(v, kv_start, skv, Vt);
    __syncthreads();
    row_sums(Kt, DH, BKV, SP, ksum);
    row_sums(Vt, DH, BKV, SP, vsum);
    col_sums<BKV>(Kt, DH, SP, vs.part, krow);
    km = block_max(km, red);
    vm = block_max(vm, red);
    scores_and_dp<DH>(g, Qs, Gs, Kt, Vt, qsum, gsum, ksum, vsum, qm, gm, km,
                      vm, q_start, kv_start, hit, Ps, DPs, colck, rowck, vs,
                      rep);
    const float dsm = block_max(
        softmax_grad(g, q_start, kv_start, m_s, linv_s, di_s, Ps, DPs,
                     false).y, red);
    col_sums<BKV>(Ps, BQ, SP, vs.part, dssum);

    // ---- delta = dS·K: rows ty*4 + i, columns tx + 16*c ------------------
    float dr[4][CW];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CW; ++c) dr[i][c] = 0.0f;
    for (int j = 0; j < BKV; ++j) {
      float pa[4], kb[CW];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty * 4 + i) * SP + j];
#pragma unroll
      for (int c = 0; c < CW; ++c) kb[c] = Kt[(tx + 16 * c) * SP + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) dr[i][c] = fmaf(pa[i], kb[c], dr[i][c]);
    }
    if (hit && g.inj_target == kDQ) {
      const int r = g.inj_row, c = g.inj_col;
      if (r >= 0 && r < BQ && c >= 0 && c < DH && r / 4 == ty && c % 16 == tx)
        dr[r % 4][c / 16] += g.inj_mag;
    }
    if (SEU && sh.hit && s == sh.step && sh.row / 4 == ty &&
        sh.col % 16 == tx) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c)
          if (i == sh.row % 4 && c == sh.col / 16)
            dr[i][c] += seu::magnitude(dr[i][c], g.seu.shift);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CW; ++c) Ds[(ty * 4 + i) * (DH + 1) + tx + 16 * c] = dr[i][c];
    for (int c = tid; c < DH; c += kThreads) {
      float x = 0.0f;
      for (int j = 0; j < BKV; ++j) x = fmaf(dssum[j], Kt[c * SP + j], x);
      colck[c] = x;
    }
    for (int i = tid; i < BQ; i += kThreads) {
      float x = 0.0f;
      for (int j = 0; j < BKV; ++j) x = fmaf(Ps[i * SP + j], krow[j], x);
      rowck[i] = x;
    }
    __syncthreads();
    const float eff_kv = (float)min(skv - kv_start, BKV);
    const float tau = fmaxf(g.tau_coef * eff_kv * dsm * km, 1e-30f);
    const Verdict vd = verify_block<BQ, DH>(Ds, DH + 1, colck, rowck, tau,
                                            eff_kv, g.corrects, q_start, 0,
                                            vs, rep);
    if (g.corrects && vd.det && vd.row / 4 == ty && vd.col % 16 == tx)
      dr[vd.row % 4][vd.col / 16] -= vd.mag;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CW; ++c) acc[i][c] += dr[i][c];
  }

  T* dq = static_cast<T*>(g.dq) + qbase * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gi = q_start + ty * 4 + i;
    if (gi >= sq) continue;
#pragma unroll
    for (int c = 0; c < CW; ++c) store(&dq[(long long)gi * DH + tx + 16 * c], acc[i][c]);
  }
  if (tid == 0) {
    float* r = g.rep + ((long long)bh * g.nqb + qi) * 8;
    for (int f = 0; f < 8; ++f) r[f] = rep[f];
  }
}

// ---------------------------------------------------------------------------
// dV = Σ Pᵀ·g and dK = Σ dSᵀ·Q over the n_rep query heads x q blocks
// ---------------------------------------------------------------------------

// delta (BKV x DH) = aᵀ·b for a (BQ, BKV stride SP) and b (BQ, DH): rows
// ty*4 + jj, columns tx + 16*c, written to ds_out, returned in dr. The
// deterministic SEU lands when `inj`, then the stochastic one `sh` when
// `land`.
template <int DH>
__device__ void gemm_atb(const float* a, const float* b, float (*dr)[DH / 16],
                         float* ds_out, bool inj, int row, int col,
                         float mag, bool land, const seu::Hit& sh, int shift) {
  constexpr int CW = DH / 16;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int c = 0; c < CW; ++c) dr[jj][c] = 0.0f;
  for (int i = 0; i < BQ; ++i) {
    float av[4], bv[CW];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) av[jj] = a[i * SP + ty * 4 + jj];
#pragma unroll
    for (int c = 0; c < CW; ++c) bv[c] = b[i * DH + tx + 16 * c];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int c = 0; c < CW; ++c) dr[jj][c] = fmaf(av[jj], bv[c], dr[jj][c]);
  }
  if (inj && row >= 0 && row < BKV && col >= 0 && col < DH &&
      row / 4 == ty && col % 16 == tx)
    dr[row % 4][col / 16] += mag;
  if (land && sh.row / 4 == ty && sh.col % 16 == tx) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj)
#pragma unroll
      for (int c = 0; c < CW; ++c)
        if (jj == sh.row % 4 && c == sh.col / 16)
          dr[jj][c] += seu::magnitude(dr[jj][c], shift);
  }
#pragma unroll
  for (int jj = 0; jj < 4; ++jj)
#pragma unroll
    for (int c = 0; c < CW; ++c) ds_out[(ty * 4 + jj) * (DH + 1) + tx + 16 * c] = dr[jj][c];
}

// Checksums of delta = aᵀ·b: column colck[c] = Σ_i arow[i]·b[i][c] with
// arow[i] = Σ_j a[i][j]; row rowck[j] = Σ_i a[i][j]·brow[i] with
// brow[i] = Σ_c b[i][c].
template <int DH>
__device__ void checks_atb(const float* a, const float* b, const float* arow,
                           const float* brow, float* colck, float* rowck) {
  for (int c = threadIdx.x; c < DH; c += kThreads) {
    float x = 0.0f;
    for (int i = 0; i < BQ; ++i) x = fmaf(arow[i], b[i * DH + c], x);
    colck[c] = x;
  }
  for (int j = threadIdx.x; j < BKV; j += kThreads) {
    float x = 0.0f;
    for (int i = 0; i < BQ; ++i) x = fmaf(a[i * SP + j], brow[i], x);
    rowck[j] = x;
  }
}

template <typename T, int DH, bool SEU>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(const BwdArgs g) {
  static_assert(DH >= BKV && DH % 16 == 0, "");
  constexpr int CW = DH / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                  // [BQ][DH]
  float* Gs = Qs + BQ * DH;          // [BQ][DH]
  float* Kt = Gs + BQ * DH;          // [DH][SP]
  float* Vt = Kt + DH * SP;          // [DH][SP]
  float* Ps = Vt + DH * SP;          // [BQ][SP]  S, then P
  float* DSs = Ps + BQ * SP;         // [BQ][SP]  dP, then dS
  float* Ds = DSs + BQ * SP;         // [BKV][DH + 1] dV / dK delta
  float* qsum = Ds + BKV * (DH + 1); // [DH]
  float* gsum = qsum + DH;
  float* ksum = gsum + DH;
  float* vsum = ksum + DH;
  float* colck = vsum + DH;          // [DH]
  float* rowck = colck + DH;         // [64]
  float* prow = rowck + 64;          // [BQ] P e
  float* dsrow = prow + BQ;          // [BQ] dS e
  float* qrow = dsrow + BQ;          // [BQ] Q e
  float* grow = qrow + BQ;           // [BQ] g e
  float* m_s = grow + BQ;
  float* linv_s = m_s + BQ;
  float* di_s = linv_s + BQ;
  __shared__ float red[kWarps];
  __shared__ VerifySmem<64, DH> vs;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int kvi = blockIdx.x, b = blockIdx.y;
  const int sq = g.sq, skv = g.skv, kv_start = kvi * BKV, c_off = skv - sq;
  const long long kvbase = (long long)b * skv;
  float km = load_rows_t<T, DH>(static_cast<const T*>(g.k) + kvbase * DH,
                                kv_start, skv, Kt);
  float vm = load_rows_t<T, DH>(static_cast<const T*>(g.v) + kvbase * DH,
                                kv_start, skv, Vt);
  __syncthreads();
  row_sums(Kt, DH, BKV, SP, ksum);
  row_sums(Vt, DH, BKV, SP, vsum);
  km = block_max(km, red);
  vm = block_max(vm, red);

  float acc_k[4][CW], acc_v[4][CW], dr[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) acc_k[i][c] = acc_v[i][c] = 0.0f;
  float rep[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  // The live walk of this kv block: q blocks [qi_lo, nqb) of each query
  // head; its SEU is drawn over the n_rep x (nqb - qi_lo) steps.
  int qi_lo = 0;
  if (g.causal) {
    const int x = kv_start - (BQ - 1) - c_off;
    qi_lo = x > 0 ? min((x + BQ - 1) / BQ, g.nqb) : 0;
  }
  const int nql = g.nqb - qi_lo;
  const seu::Hit sh =
      SEU ? seu::draw(g.seu, (uint32_t)(b * g.nkvb + kvi), g.n_rep * nql,
                      BKV, DH)
          : seu::Hit{false, 0, 0, 0};

  for (int r = 0; r < g.n_rep; ++r) {
    const int h = b * g.n_rep + r;
    const long long qbase = (long long)h * sq;
    for (int qi = 0; qi < g.nqb; ++qi) {
      const int q_start = qi * BQ;
      if (g.causal && kv_start > q_start + BQ - 1 + c_off) continue;
      const bool hit = g.inj_enable && h == g.inj_bh && kvi == g.inj_blk &&
                       qi == g.inj_step;
      __syncthreads();
      float qm = load_rows<T, DH>(static_cast<const T*>(g.q) + qbase * DH,
                                  q_start, sq, Qs);
      float gm = load_rows<T, DH>(static_cast<const T*>(g.g) + qbase * DH,
                                  q_start, sq, Gs);
      load_stats(g, qbase, q_start, m_s, linv_s, di_s);
      __syncthreads();
      col_sums<DH>(Qs, BQ, DH, vs.part, qsum);
      col_sums<DH>(Gs, BQ, DH, vs.part, gsum);
      row_sums(Qs, BQ, DH, DH, qrow);
      row_sums(Gs, BQ, DH, DH, grow);
      qm = block_max(qm, red);
      gm = block_max(gm, red);
      scores_and_dp<DH>(g, Qs, Gs, Kt, Vt, qsum, gsum, ksum, vsum, qm, gm,
                        km, vm, q_start, kv_start, hit, Ps, DSs, colck,
                        rowck, vs, rep);
      const float2 mx = softmax_grad(g, q_start, kv_start, m_s, linv_s, di_s,
                                     Ps, DSs, true);
      __syncthreads();
      row_sums(Ps, BQ, BKV, SP, prow);
      row_sums(DSs, BQ, BKV, SP, dsrow);
      const float pm = block_max(mx.x, red);
      const float dsm = block_max(mx.y, red);
      const float eff_q = (float)max(min(sq - q_start, BQ), 1);

      // ---- dV delta = Pᵀ·g --------------------------------------------
      gemm_atb<DH>(Ps, Gs, dr, Ds, hit && g.inj_target == kDV, g.inj_row,
                   g.inj_col, g.inj_mag,
                   SEU && sh.hit && r * nql + qi - qi_lo == sh.step, sh,
                   g.seu.shift);
      checks_atb<DH>(Ps, Gs, prow, grow, colck, rowck);
      __syncthreads();
      const Verdict vv = verify_block<BKV, DH>(
          Ds, DH + 1, colck, rowck, fmaxf(g.tau_coef * eff_q * pm * gm, 1e-30f),
          eff_q, g.corrects, kv_start, 0, vs, rep);
      if (g.corrects && vv.det && vv.row / 4 == ty && vv.col % 16 == tx)
        dr[vv.row % 4][vv.col / 16] -= vv.mag;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc_v[i][c] += dr[i][c];

      // ---- dK delta = dSᵀ·Q -------------------------------------------
      gemm_atb<DH>(DSs, Qs, dr, Ds, hit && g.inj_target == kDK, g.inj_row,
                   g.inj_col, g.inj_mag, false, sh, 0);
      checks_atb<DH>(DSs, Qs, dsrow, qrow, colck, rowck);
      __syncthreads();
      const Verdict vk = verify_block<BKV, DH>(
          Ds, DH + 1, colck, rowck, fmaxf(g.tau_coef * eff_q * dsm * qm, 1e-30f),
          eff_q, g.corrects, kv_start, 0, vs, rep);
      if (g.corrects && vk.det && vk.row / 4 == ty && vk.col % 16 == tx)
        dr[vk.row % 4][vk.col / 16] -= vk.mag;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) acc_k[i][c] += dr[i][c];
    }
  }

  T* dk = static_cast<T*>(g.dk) + kvbase * DH;
  T* dv = static_cast<T*>(g.dv) + kvbase * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gj = kv_start + ty * 4 + i;
    if (gj >= skv) continue;
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      store(&dk[(long long)gj * DH + tx + 16 * c], acc_k[i][c]);
      store(&dv[(long long)gj * DH + tx + 16 * c], acc_v[i][c]);
    }
  }
  if (tid == 0) {
    float* rp = g.rep + ((long long)b * g.nkvb + kvi) * 8;
    for (int f = 0; f < 8; ++f) rp[f] = rep[f];
  }
}

template <typename T, int DH, bool DKV, bool SEU>
cudaError_t launch_instance(const BwdArgs& g, int bh, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH>() * (int)sizeof(float);
  auto kernel =
      DKV ? flash_dkv_kernel<T, DH, SEU> : flash_dq_kernel<T, DH, SEU>;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int rows = DKV ? bh / g.n_rep : bh;
  if (rows > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid(DKV ? g.nkvb : g.nqb, rows);
  kernel<<<grid, kThreads, bytes, stream>>>(g);
  return cudaGetLastError();
}

// The campaign instance when a campaign is armed, else the clean one.
template <typename T, int DH, bool DKV>
cudaError_t launch(const BwdArgs& g, int bh, cudaStream_t stream) {
  return g.seu.on ? launch_instance<T, DH, DKV, true>(g, bh, stream)
                  : launch_instance<T, DH, DKV, false>(g, bh, stream);
}

template <bool DKV>
int dispatch(const BwdArgs& g, int bh, int dh, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dh == 64) return launch<float, 64, DKV>(g, bh, st);
  if (dtype == 0 && dh == 128) return launch<float, 128, DKV>(g, bh, st);
  if (dtype == 1 && dh == 64) return launch<__nv_bfloat16, 64, DKV>(g, bh, st);
  if (dtype == 1 && dh == 128) return launch<__nv_bfloat16, 128, DKV>(g, bh, st);
  return cudaErrorInvalidValue;
}

BwdArgs make_args(const void* q, const void* k, const void* v, const void* gr,
                  const float* m, const float* l, const float* di, float* rep,
                  int sq, int skv, int n_rep, int causal, int corrects,
                  float scale, float tau_qk_coef, float tau_coef, float tau_dh,
                  const int* inj, float inj_mag, const seu::Args& sa) {
  BwdArgs g{};
  g.q = q; g.k = k; g.v = v; g.g = gr; g.m = m; g.l = l; g.di = di;
  g.rep = rep;
  g.sq = sq; g.skv = skv; g.n_rep = n_rep;
  g.nqb = (sq + BQ - 1) / BQ; g.nkvb = (skv + BKV - 1) / BKV;
  g.causal = causal; g.corrects = corrects; g.scale = scale;
  g.tau_qk_coef = tau_qk_coef; g.tau_coef = tau_coef; g.tau_dh = tau_dh;
  g.inj_enable = inj[0]; g.inj_target = inj[1]; g.inj_bh = inj[2];
  g.inj_blk = inj[3]; g.inj_step = inj[4]; g.inj_row = inj[5];
  g.inj_col = inj[6]; g.inj_mag = inj_mag;
  g.seu = sa;
  return g;
}

}  // namespace

extern "C" {

const char* flash_ft_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, g, dq (bh, sq, dh); k, v (bh / n_rep, skv, dh); m, l, di (bh, sq) f32;
// report (bh, ceil(sq / 64), 8) f32: all contiguous. dtype: 0 f32, 1 bf16
// (q, k, v, g, dq); dh 64 or 128. inj: [enable, target, bh, q block, kv
// step, row, col]; seu_*: the stochastic hook's campaign (seu_hook.cuh).
// Returns the launch's cudaError_t.
int flash_dq_launch(const void* q, const void* k, const void* v,
                    const void* gr, const float* m, const float* l,
                    const float* di, void* dq, float* rep, int bh, int sq,
                    int skv, int dh, int n_rep, int dtype, int causal,
                    int corrects, float scale, float tau_qk_coef,
                    float tau_coef, float tau_dh, int inj_enable,
                    int inj_target, int inj_bh, int inj_blk, int inj_step,
                    int inj_row, int inj_col, float inj_mag, int seu_on,
                    unsigned seu_seed, float seu_rate, int seu_shift,
                    void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0 || n_rep <= 0 || bh % n_rep != 0)
    return cudaErrorInvalidValue;
  const int inj[7] = {inj_enable, inj_target, inj_bh, inj_blk, inj_step,
                      inj_row, inj_col};
  BwdArgs g = make_args(q, k, v, gr, m, l, di, rep, sq, skv, n_rep, causal,
                        corrects, scale, tau_qk_coef, tau_coef, tau_dh, inj,
                        inj_mag,
                        seu::Args{seu_on, seu_seed, seu_rate, seu_shift});
  g.dq = dq;
  return dispatch<false>(g, bh, dh, dtype, stream);
}

// As flash_dq_launch, with dk, dv (bh / n_rep, skv, dh) and report
// (bh / n_rep, ceil(skv / 64), 8). inj: [enable, target, query head, kv
// block, q block, row, col].
int flash_dkv_launch(const void* q, const void* k, const void* v,
                     const void* gr, const float* m, const float* l,
                     const float* di, void* dk, void* dv, float* rep, int bh,
                     int sq, int skv, int dh, int n_rep, int dtype, int causal,
                     int corrects, float scale, float tau_qk_coef,
                     float tau_coef, float tau_dh, int inj_enable,
                     int inj_target, int inj_bh, int inj_blk, int inj_step,
                     int inj_row, int inj_col, float inj_mag, int seu_on,
                     unsigned seu_seed, float seu_rate, int seu_shift,
                     void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0 || n_rep <= 0 || bh % n_rep != 0)
    return cudaErrorInvalidValue;
  const int inj[7] = {inj_enable, inj_target, inj_bh, inj_blk, inj_step,
                      inj_row, inj_col};
  BwdArgs g = make_args(q, k, v, gr, m, l, di, rep, sq, skv, n_rep, causal,
                        corrects, scale, tau_qk_coef, tau_coef, tau_dh, inj,
                        inj_mag,
                        seu::Args{seu_on, seu_seed, seu_rate, seu_shift});
  g.dk = dk;
  g.dv = dv;
  return dispatch<true>(g, bh, dh, dtype, stream);
}

}  // extern "C"
