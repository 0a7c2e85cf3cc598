// Flash-attention forward with online ABFT for Hopper (sm_90a).
//
// Replaces the TPU kernel K2 of the JAX package:
//   src/repro/kernels/flashft.py:_flash_ft_kernel, launched by
//   templates/registry.py:flash_fwd_call (forward, with and without
//   save_stats).
//
// One CTA of 256 threads per (query head bh, q block of 64 rows); a loop
// over kv blocks of 64 keeps Q, K (transposed), V, the scores S and the
// PV delta in dynamic shared memory (f32; about 148 KB at dh = 128) and
// the output accumulator in registers. Per live kv block:
//   * S = Q·Kᵀ, verified against (eᵀQ)·Kᵀ and Q·(Kᵀe) before scale and
//     mask (tau_qk = rel_tau·eps32·round_up(dh, 128)·max|Q|·max|K_blk|,
//     k field = step + 1), located and corrected;
//   * scale, then the kv-edge, dead-row and bottom-right-aligned causal
//     masks (NEG_INF = -1e30), online softmax with the reference's clamps
//     (exp(min(s - m, 0)), degenerate rows m <= NEG_INF/2 get p = 0);
//   * delta = P·V, verified against (eᵀP)·V and P·(Ve) and corrected before
//     the alpha-rescale (tau = rel_tau·eps32·eff_kv·max|V_blk|, k field =
//     eff_kv = min(Skv - kv_start, 64));
//   * flush: rows with m degenerate or l = 0 write exact zeros; with
//     save_stats each live row also writes its softmax statistics (m, l),
//     f32, degenerate rows as (NEG_INF, 0), the residual the backward
//     kernels (flash_ft_bwd.cu) consume.
// Dead kv blocks (past the true Skv, or above the causal diagonal) are
// skipped. GQA reads kv head bh / n_rep; K and V are never repeated.
// Stochastic SEU campaigns (seu_hook.cuh, salt 0x51 reduced on the host):
// each CTA draws its block's SEU by its uid bh·nqb + qi over its live kv
// steps, and the hit lands in that step's Δ after the deterministic SEU
// and before its verification (the reference's flashft.py:159-161,
// :223-224). Campaigns run in their own instances (SEU = true), so a
// clean call runs the code it ran before the hook.
// What bounds it on the H100: at the prefill shapes it is bound by
// operations (4·Sq·Skv·dh per head, halved by the causal skip); this first
// version runs both products on the CUDA cores in f32, with one CTA per SM
// because of the shared-memory footprint. PERF.md carries its times.
#include "abft_block.cuh"
#include "seu_hook.cuh"

namespace {

using namespace abft;

constexpr int BQ = 64, BKV = 64;
constexpr float kNegInf = -1e30f;

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* out;
  float* rep;
  float* m_out;        // nullptr, or (bh, sq) saved row max
  float* l_out;        // nullptr, or (bh, sq) saved row sum
  int sq, skv, n_rep, nqb, causal, corrects;
  float scale;
  float tau_qk_coef;   // rel_tau * eps32 * round_up(dh, 128)
  float tau_coef;      // rel_tau * eps32
  int inj_enable, inj_bh, inj_qb, inj_s, inj_row, inj_col;
  float inj_mag;
  seu::Args seu;       // the stochastic hook's campaign
};

template <int DH>
constexpr int smem_floats() {
  return BQ * DH + DH * BKV + BKV * DH + BQ * (BKV + 1) + BQ * (DH + 1) +
         2 * DH + DH + BQ + 2 * BKV + 3 * BQ;
}

template <typename T, int DH, bool SEU>
__global__ void __launch_bounds__(kThreads) flash_ft_kernel(const FlashArgs g) {
  static_assert(DH >= BKV && DH % 16 == 0, "");
  constexpr int CW = DH / 16;             // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                        // [BQ][DH]
  float* Kt = Qs + BQ * DH;                // [DH][BKV]  K block, transposed
  float* Vs = Kt + DH * BKV;               // [BKV][DH]
  float* Ss = Vs + BKV * DH;               // [BQ][BKV + 1] scores, then P
  float* Ds = Ss + BQ * (BKV + 1);         // [BQ][DH + 1]  PV delta
  float* qsum = Ds + BQ * (DH + 1);        // [DH]  e^T Q
  float* ksum = qsum + DH;                 // [DH]  K^T e
  float* colck = ksum + DH;                // [DH]
  float* rowck = colck + DH;               // [BQ]
  float* psum = rowck + BQ;                // [BKV] e^T P
  float* vsum = psum + BKV;                // [BKV] V e
  float* m_s = vsum + BKV;                 // [BQ]
  float* l_s = m_s + BQ;                   // [BQ]
  float* alpha_s = l_s + BQ;               // [BQ]
  __shared__ float red[kWarps];
  __shared__ VerifySmem<BQ, DH> vs;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int qi = blockIdx.x, bh = blockIdx.y, kvh = bh / g.n_rep;
  const int sq = g.sq, skv = g.skv, q_start = qi * BQ;
  const int c_off = skv - sq;
  const T* q = static_cast<const T*>(g.q) + (long long)bh * sq * DH;
  const T* k = static_cast<const T*>(g.k) + (long long)kvh * skv * DH;
  const T* v = static_cast<const T*>(g.v) + (long long)kvh * skv * DH;

  float qmax = 0.0f;
  for (int idx = tid; idx < BQ * DH; idx += kThreads) {
    const int i = idx / DH, d = idx % DH;
    const float x = q_start + i < sq
                        ? to_f32(q[(long long)(q_start + i) * DH + d]) : 0.0f;
    Qs[idx] = x;
    qmax = fmaxf(qmax, fabsf(x));
  }
  for (int i = tid; i < BQ; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }
  __syncthreads();
  col_sums<DH>(Qs, BQ, DH, vs.part, qsum);
  qmax = block_max(qmax, red);

  float o[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CW; ++c) o[i][c] = 0.0f;
  float rep[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const int nkv = (skv + BKV - 1) / BKV;
  // This block's SEU, over its live kv steps (the kv edge and the causal
  // bound): the steps the loop below runs.
  const int kv_hi = g.causal ? min(skv, q_start + BQ + c_off) : skv;
  const seu::Hit sh =
      SEU ? seu::draw(g.seu, (uint32_t)(bh * g.nqb + qi),
                      kv_hi > 0 ? (kv_hi + BKV - 1) / BKV : 0, BQ, DH)
          : seu::Hit{false, 0, 0, 0};

  for (int s = 0; s < nkv; ++s) {
    const int kv_start = s * BKV;
    if (g.causal && kv_start > q_start + BQ - 1 + c_off) break;
    __syncthreads();
    float kmax = 0.0f, vmax = 0.0f;
    for (int idx = tid; idx < BKV * DH; idx += kThreads) {
      const int j = idx / DH, d = idx % DH;
      const bool live = kv_start + j < skv;
      const long long off = (long long)(kv_start + j) * DH + d;
      const float kx = live ? to_f32(k[off]) : 0.0f;
      const float vx = live ? to_f32(v[off]) : 0.0f;
      Kt[d * BKV + j] = kx;
      Vs[idx] = vx;
      kmax = fmaxf(kmax, fabsf(kx));
      vmax = fmaxf(vmax, fabsf(vx));
    }
    __syncthreads();

    // ---- S = Q·Kᵀ: rows ty*4 + i, columns tx + 16*jj -------------------
    float sr[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) sr[i][jj] = 0.0f;
    for (int d = 0; d < DH; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * DH + d];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) kb[jj] = Kt[d * BKV + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) sr[i][jj] = fmaf(qa[i], kb[jj], sr[i][jj]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        Ss[(ty * 4 + i) * (BKV + 1) + tx + 16 * jj] = sr[i][jj];
    row_sums(Kt, DH, BKV, BKV, ksum);
    __syncthreads();
    for (int j = tid; j < BKV; j += kThreads) {
      float c = 0.0f;
      for (int d = 0; d < DH; ++d) c = fmaf(qsum[d], Kt[d * BKV + j], c);
      colck[j] = c;
    }
    for (int i = tid; i < BQ; i += kThreads) {
      float c = 0.0f;
      for (int d = 0; d < DH; ++d) c = fmaf(Qs[i * DH + d], ksum[d], c);
      rowck[i] = c;
    }
    const float km = block_max(kmax, red);
    const float tau_qk = fmaxf(g.tau_qk_coef * qmax * km, 1e-30f);
    const Verdict vq = verify_block<BQ, BKV>(
        Ss, BKV + 1, colck, rowck, tau_qk, (float)(s + 1), g.corrects,
        q_start, kv_start, vs, rep);
    if (g.corrects && vq.det && tid == 0)
      Ss[vq.row * (BKV + 1) + vq.col] -= vq.mag;
    __syncthreads();

    // ---- scale, mask, online softmax: one thread per query row ---------
    if (tid < BQ) {
      const int i = tid, gi = q_start + i;
      float* srow = Ss + i * (BKV + 1);
      float mx = kNegInf;
      for (int j = 0; j < BKV; ++j) {
        const int kpos = kv_start + j;
        float x = srow[j] * g.scale;
        if (kpos >= skv || gi >= sq || (g.causal && gi + c_off < kpos))
          x = kNegInf;
        srow[j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_prev = m_s[i];
      const float m_new = fmaxf(m_prev, mx);
      const bool good = m_new > 0.5f * kNegInf;
      float lsum = 0.0f;
      for (int j = 0; j < BKV; ++j) {
        const float p = good ? expf(fminf(srow[j] - m_new, 0.0f)) : 0.0f;
        srow[j] = p;
        lsum += p;
      }
      const float alpha = expf(fminf(m_prev - m_new, 0.0f));
      alpha_s[i] = alpha;
      l_s[i] = l_s[i] * alpha + lsum;
      m_s[i] = m_new;
    }
    __syncthreads();

    // ---- delta = P·V: rows ty*4 + i, columns tx + 16*c ------------------
    float dr[4][CW];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CW; ++c) dr[i][c] = 0.0f;
    for (int j = 0; j < BKV; ++j) {
      float pa[4], vb[CW];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ss[(ty * 4 + i) * (BKV + 1) + j];
#pragma unroll
      for (int c = 0; c < CW; ++c) vb[c] = Vs[j * DH + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c) dr[i][c] = fmaf(pa[i], vb[c], dr[i][c]);
    }
    // Emulated SEU in the PV accumulator (deterministic injection).
    if (g.inj_enable && bh == g.inj_bh && qi == g.inj_qb && s == g.inj_s) {
      const int r = g.inj_row, c = g.inj_col;
      if (r >= 0 && r < BQ && c >= 0 && c < DH && r / 4 == ty && c % 16 == tx)
        dr[r % 4][c / 16] += g.inj_mag;
    }
    // The stochastic SEU of this block, at its drawn step.
    if (SEU && sh.hit && s == sh.step && sh.row / 4 == ty &&
        sh.col % 16 == tx) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CW; ++c)
          if (i == sh.row % 4 && c == sh.col / 16)
            dr[i][c] += seu::magnitude(dr[i][c], g.seu.shift);
    }
    // ---- ABFT on the PV product, before the alpha-rescale --------------
    col_sums<BKV>(Ss, BQ, BKV + 1, vs.part, psum);
    row_sums(Vs, BKV, DH, DH, vsum);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CW; ++c) Ds[(ty * 4 + i) * (DH + 1) + tx + 16 * c] = dr[i][c];
    __syncthreads();
    for (int d = tid; d < DH; d += kThreads) {
      float c = 0.0f;
      for (int j = 0; j < BKV; ++j) c = fmaf(psum[j], Vs[j * DH + d], c);
      colck[d] = c;
    }
    for (int i = tid; i < BQ; i += kThreads) {
      float c = 0.0f;
      for (int j = 0; j < BKV; ++j)
        c = fmaf(Ss[i * (BKV + 1) + j], vsum[j], c);
      rowck[i] = c;
    }
    const float vm = block_max(vmax, red);
    const float eff_kv = (float)min(skv - kv_start, BKV);
    const float tau = fmaxf(g.tau_coef * eff_kv * vm, 1e-30f);
    const Verdict vp = verify_block<BQ, DH>(Ds, DH + 1, colck, rowck, tau,
                                            eff_kv, g.corrects, q_start, 0,
                                            vs, rep);
    if (g.corrects && vp.det && vp.row / 4 == ty && vp.col % 16 == tx)
      dr[vp.row % 4][vp.col / 16] -= vp.mag;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < CW; ++c) o[i][c] = o[i][c] * a + dr[i][c];
    }
  }

  // ---- flush: degenerate rows write exact zeros ---------------------------
  __syncthreads();
  T* out = static_cast<T*>(g.out) + (long long)bh * sq * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = ty * 4 + i, gi = q_start + row;
    if (gi >= sq) continue;
    const float m = m_s[row], l = l_s[row];
    const bool good = m > 0.5f * kNegInf && l > 0.0f;
    const float linv = good ? 1.0f / fmaxf(l, 1e-30f) : 0.0f;
#pragma unroll
    for (int c = 0; c < CW; ++c)
      store(&out[(long long)gi * DH + tx + 16 * c], o[i][c] * linv);
  }
  if (g.m_out != nullptr && tid < BQ && q_start + tid < sq) {
    const float m = m_s[tid], l = l_s[tid];
    const bool good = m > 0.5f * kNegInf && l > 0.0f;
    const long long at = (long long)bh * sq + q_start + tid;
    g.m_out[at] = good ? m : kNegInf;
    g.l_out[at] = good ? l : 0.0f;
  }
  if (tid == 0) {
    float* r = g.rep + ((long long)bh * g.nqb + qi) * 8;
    for (int q8 = 0; q8 < 8; ++q8) r[q8] = rep[q8];
  }
}

template <typename T, int DH, bool SEU>
cudaError_t launch_instance(const FlashArgs& g, int bh, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH>() * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_ft_kernel<T, DH, SEU>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  if (bh > 65535) return cudaErrorInvalidConfiguration;
  dim3 grid(g.nqb, bh);
  flash_ft_kernel<T, DH, SEU><<<grid, kThreads, bytes, stream>>>(g);
  return cudaGetLastError();
}

// The campaign instance when a campaign is armed, else the clean one.
template <typename T, int DH>
cudaError_t launch(const FlashArgs& g, int bh, cudaStream_t stream) {
  return g.seu.on ? launch_instance<T, DH, true>(g, bh, stream)
                  : launch_instance<T, DH, false>(g, bh, stream);
}

}  // namespace

extern "C" {

const char* flash_ft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (bh, sq, dh); k, v (bh / n_rep, skv, dh); out (bh, sq, dh); report
// (bh, ceil(sq / 64), 8); m_out, l_out nullptr or (bh, sq) f32: contiguous.
// dtype: 0 f32, 1 bf16; dh 64 or 128. seu_*: the stochastic hook's
// campaign (seu_hook.cuh). Returns the launch's cudaError_t.
int flash_ft_launch(const void* q, const void* k, const void* v, void* out,
                    float* rep, float* m_out, float* l_out, int bh, int sq,
                    int skv, int dh, int n_rep,
                    int dtype, int causal, int corrects,
                    float scale, float tau_qk_coef, float tau_coef,
                    int inj_enable, int inj_bh, int inj_qb, int inj_s,
                    int inj_row, int inj_col, float inj_mag, int seu_on,
                    unsigned seu_seed, float seu_rate, int seu_shift,
                    void* stream) {
  if (bh <= 0 || sq <= 0 || skv <= 0 || n_rep <= 0 || bh % n_rep != 0)
    return cudaErrorInvalidValue;
  FlashArgs g{};
  g.q = q; g.k = k; g.v = v; g.out = out; g.rep = rep;
  g.m_out = m_out; g.l_out = l_out;
  g.sq = sq; g.skv = skv; g.n_rep = n_rep; g.nqb = (sq + BQ - 1) / BQ;
  g.causal = causal; g.corrects = corrects;
  g.scale = scale; g.tau_qk_coef = tau_qk_coef; g.tau_coef = tau_coef;
  g.inj_enable = inj_enable; g.inj_bh = inj_bh; g.inj_qb = inj_qb;
  g.inj_s = inj_s; g.inj_row = inj_row; g.inj_col = inj_col;
  g.inj_mag = inj_mag;
  g.seu = seu::Args{seu_on, seu_seed, seu_rate, seu_shift};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dh == 64) return launch<float, 64>(g, bh, st);
  if (dtype == 0 && dh == 128) return launch<float, 128>(g, bh, st);
  if (dtype == 1 && dh == 64) return launch<__nv_bfloat16, 64>(g, bh, st);
  if (dtype == 1 && dh == 128) return launch<__nv_bfloat16, 128>(g, bh, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
