// Paged ragged flash decode with online ABFT for Hopper (sm_90a).
//
// Replaces the TPU kernel K6 of the JAX package:
//   src/repro/kernels/flashft.py:270 _flash_decode_kernel, launched by
//   src/repro/kernels/templates/registry.py:239 flash_decode_call.
//
// One CTA of 256 threads per (serving slot, kv head): its bq query rows are
// the head's n_rep GQA queries at the slot's decode position, zero-padded
// to bq by the wrapper (the padded rows are not neutral in P·V: their P row
// is uniform over the live span, so they take part in the PV checksums as
// in the reference). The CTA reads lengths[slot] and walks page_table[slot,
// s] for s < ceil(length / PAGE) (at most max_pages), staging each page's K
// (transposed) and V in shared memory as f32 -- the WHOLE page, dead
// positions included, since the reference verifies S over the whole page
// before masking (they enter the checksums, max|k| and max|v|). Per page:
//   * S = Q·Kᵀ, verified against (eᵀQ)·Kᵀ and Q·(Kᵀe) before scale and mask
//     (tau_qk = rel_tau·eps32·dh·max|Q|·max|K_page|, k field = s + 1,
//     column reported at col + s·PAGE), located and corrected;
//   * scale, mask positions >= length (NEG_INF = -1e30), online softmax with
//     the reference's clamps (exp(min(s - m, 0)), degenerate rows p = 0);
//   * delta = P·V, the deterministic SEU added here, verified against
//     (eᵀP)·V and P·(Ve) and corrected before the alpha-rescale (tau =
//     rel_tau·eps32·eff_kv·max|V_page|, eff_kv = min(length - s·PAGE, PAGE),
//     k field = eff_kv, no column offset);
//   * the output accumulator stays in registers, f32.
// Flush: acc / l, rows with m degenerate or l = 0 as exact zeros; a slot of
// length 0 runs no step and writes zeros and a zero report row.
// Stochastic SEU campaigns (seu_hook.cuh, salt 0x54 reduced on the host):
// each CTA draws its row's SEU by its uid slot·kvh + head over its live
// pages and lands it in that page's Δ after the deterministic SEU (the
// reference's flashft.py:310-315, :365-366). Campaigns run in their own
// instances (SEU = true), so a clean call runs the code it ran before the
// hook.
// What bounds it on the H100: bytes -- each live page of K and V is read
// once (2·PAGE·dh elements per step) for only 4·bq·PAGE·dh flops, far below
// the card's operations-per-byte balance. This first version does one page
// at a time per CTA with plain loads, B·KVH CTAs (32 at qwen2-7b's 8 slots),
// products on the CUDA cores in f32; split-KV across CTAs and a cp.async /
// TMA page pipeline are the later steps. PERF.md carries its times.
#include "abft_block.cuh"
#include "seu_hook.cuh"

namespace {

using namespace abft;

constexpr int kMaxBq = 32;
constexpr float kNegInf = -1e30f;

struct DecodeArgs {
  const void* q;       // (G, bq, DH), G = n_slots · kvh
  const void* k;       // (n_pages, kvh, PAGE, DH)
  const void* v;
  const int* lengths;  // (n_slots,)
  const int* table;    // (n_slots, max_pages)
  void* out;           // (G, bq, DH)
  float* rep;          // (G, 8)
  int bq, kvh, max_pages, n_pages, corrects;
  float scale;
  float tau_qk_coef;   // rel_tau * eps32 * dh
  float tau_coef;      // rel_tau * eps32
  int inj_enable, inj_g, inj_qi, inj_s, inj_row, inj_col;
  float inj_mag;
  seu::Args seu;       // the stochastic hook's campaign
};

template <int DH, int PAGE>
constexpr int smem_floats() {
  return kMaxBq * DH + DH * (PAGE + 1) + PAGE * DH + kMaxBq * (PAGE + 1) +
         kMaxBq * (DH + 1) + 3 * DH + kMaxBq + 2 * PAGE + 3 * kMaxBq;
}

template <typename T, int DH, int PAGE, bool SEU>
__global__ void __launch_bounds__(kThreads)
    flash_decode_kernel(const DecodeArgs g) {
  static_assert(kThreads % DH == 0 && kThreads % PAGE == 0 && PAGE <= DH, "");
  constexpr int CROWS = kThreads / DH;          // row stride of a thread's Δ
  constexpr int E = kMaxBq / CROWS;             // Δ / acc rows per thread
  constexpr int SROWS = kThreads / PAGE;        // row stride of a thread's S
  constexpr int R = kMaxBq / SROWS;             // S rows per thread
  constexpr int KP = PAGE + 1;                  // padded row of Kt and Ss
  extern __shared__ float smem[];
  float* Qs = smem;                              // [kMaxBq][DH]
  float* Kt = Qs + kMaxBq * DH;                  // [DH][KP]  page K, transposed
  float* Vs = Kt + DH * KP;                      // [PAGE][DH]
  float* Ss = Vs + PAGE * DH;                    // [kMaxBq][KP] scores, then P
  float* Ds = Ss + kMaxBq * KP;                  // [kMaxBq][DH + 1] PV delta
  float* qsum = Ds + kMaxBq * (DH + 1);          // [DH]  e^T Q
  float* ksum = qsum + DH;                       // [DH]  K^T e
  float* colck = ksum + DH;                      // [DH]
  float* rowck = colck + DH;                     // [kMaxBq]
  float* psum = rowck + kMaxBq;                  // [PAGE] e^T P
  float* vsum = psum + PAGE;                     // [PAGE] V e
  float* m_s = vsum + PAGE;                      // [kMaxBq]
  float* l_s = m_s + kMaxBq;                     // [kMaxBq]
  float* alpha_s = l_s + kMaxBq;                 // [kMaxBq]
  __shared__ float red[kWarps];
  __shared__ VerifySmem<kMaxBq, DH> vs;

  const int tid = threadIdx.x;
  const int gi = blockIdx.x, slot = gi / g.kvh, head = gi % g.kvh;
  const int bq = g.bq;
  const int len = g.lengths[slot];
  const int steps = len > 0 ? min((len + PAGE - 1) / PAGE, g.max_pages) : 0;
  const int c0 = tid % DH, i0 = tid / DH;        // this thread's Δ column/rows
  const int j0 = tid % PAGE, si0 = tid / PAGE;   // this thread's S column/rows
  const T* q = static_cast<const T*>(g.q) + (long long)gi * bq * DH;

  float qmax = 0.0f;
  for (int idx = tid; idx < bq * DH; idx += kThreads) {
    const float x = to_f32(q[idx]);
    Qs[idx] = x;
    qmax = fmaxf(qmax, fabsf(x));
  }
  for (int i = tid; i < bq; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }
  __syncthreads();
  col_sums<DH>(Qs, bq, DH, vs.part, qsum);
  qmax = block_max(qmax, red);

  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.0f;
  float rep[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const seu::Hit sh = SEU ? seu::draw(g.seu, (uint32_t)gi, steps, bq, DH)
                          : seu::Hit{false, 0, 0, 0};

  for (int s = 0; s < steps; ++s) {
    const int kv_start = s * PAGE;
    const int pid = g.table[(long long)slot * g.max_pages + s];
    if (pid < 0 || pid >= g.n_pages) __trap();   // a corrupt page table
    const long long base = ((long long)pid * g.kvh + head) * PAGE * DH;
    const T* kp = static_cast<const T*>(g.k) + base;
    const T* vp = static_cast<const T*>(g.v) + base;
    __syncthreads();   // the previous step is done with Kt, Vs, Ss, Ds
    float kmax = 0.0f, vmax = 0.0f;
    for (int idx = tid; idx < PAGE * DH; idx += kThreads) {
      const int j = idx / DH, d = idx % DH;
      const float kx = to_f32(kp[idx]), vx = to_f32(vp[idx]);
      Kt[d * KP + j] = kx;
      Vs[idx] = vx;
      kmax = fmaxf(kmax, fabsf(kx));
      vmax = fmaxf(vmax, fabsf(vx));
    }
    __syncthreads();

    // ---- S = Q·Kᵀ: column j0, rows si0 + SROWS·r --------------------------
    float sr[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sr[r] = 0.0f;
    for (int d = 0; d < DH; ++d) {
      const float kb = Kt[d * KP + j0];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = si0 + SROWS * r;
        if (i < bq) sr[r] = fmaf(Qs[i * DH + d], kb, sr[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = si0 + SROWS * r;
      if (i < bq) Ss[i * KP + j0] = sr[r];
    }
    row_sums(Kt, DH, PAGE, KP, ksum);
    __syncthreads();
    for (int j = tid; j < PAGE; j += kThreads) {
      float c = 0.0f;
      for (int d = 0; d < DH; ++d) c = fmaf(qsum[d], Kt[d * KP + j], c);
      colck[j] = c;
    }
    for (int i = tid; i < bq; i += kThreads) {
      float c = 0.0f;
      for (int d = 0; d < DH; ++d) c = fmaf(Qs[i * DH + d], ksum[d], c);
      rowck[i] = c;
    }
    const float km = block_max(kmax, red);
    const float tau_qk = fmaxf(g.tau_qk_coef * qmax * km, 1e-30f);
    const Verdict qk = verify_rows<PAGE>(Ss, bq, KP, colck, rowck, tau_qk,
                                         (float)(s + 1), g.corrects, 0,
                                         kv_start, vs, rep);
    if (g.corrects && qk.det && tid == 0) Ss[qk.row * KP + qk.col] -= qk.mag;
    __syncthreads();

    // ---- scale, mask, online softmax: one thread per query row ----------
    if (tid < bq) {
      float* srow = Ss + tid * KP;
      float mx = kNegInf;
      for (int j = 0; j < PAGE; ++j) {
        float x = srow[j] * g.scale;
        if (kv_start + j >= len) x = kNegInf;
        srow[j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_prev = m_s[tid];
      const float m_new = fmaxf(m_prev, mx);
      const bool good = m_new > 0.5f * kNegInf;
      float lsum = 0.0f;
      for (int j = 0; j < PAGE; ++j) {
        const float p = good ? expf(fminf(srow[j] - m_new, 0.0f)) : 0.0f;
        srow[j] = p;
        lsum += p;
      }
      const float alpha = expf(fminf(m_prev - m_new, 0.0f));
      alpha_s[tid] = alpha;
      l_s[tid] = l_s[tid] * alpha + lsum;
      m_s[tid] = m_new;
    }
    __syncthreads();

    // ---- delta = P·V: column c0, rows i0 + CROWS·e -----------------------
    float dr[E];
#pragma unroll
    for (int e = 0; e < E; ++e) dr[e] = 0.0f;
    for (int j = 0; j < PAGE; ++j) {
      const float vb = Vs[j * DH + c0];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int i = i0 + CROWS * e;
        if (i < bq) dr[e] = fmaf(Ss[i * KP + j], vb, dr[e]);
      }
    }
    // Emulated SEU in the PV delta (deterministic injection).
    if (g.inj_enable && gi == g.inj_g && g.inj_qi == 0 && s == g.inj_s &&
        g.inj_row >= 0 && g.inj_row < bq && g.inj_col == c0) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (i0 + CROWS * e == g.inj_row) dr[e] += g.inj_mag;
    }
    if (SEU && sh.hit && s == sh.step && sh.col == c0) {
#pragma unroll
      for (int e = 0; e < E; ++e)
        if (i0 + CROWS * e == sh.row)
          dr[e] += seu::magnitude(dr[e], g.seu.shift);
    }
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = i0 + CROWS * e;
      if (i < bq) Ds[i * (DH + 1) + c0] = dr[e];
    }
    // ---- ABFT on the PV product, before the alpha-rescale --------------
    col_sums<PAGE>(Ss, bq, KP, vs.part, psum);
    row_sums(Vs, PAGE, DH, DH, vsum);
    __syncthreads();
    for (int d = tid; d < DH; d += kThreads) {
      float c = 0.0f;
      for (int j = 0; j < PAGE; ++j) c = fmaf(psum[j], Vs[j * DH + d], c);
      colck[d] = c;
    }
    for (int i = tid; i < bq; i += kThreads) {
      float c = 0.0f;
      for (int j = 0; j < PAGE; ++j) c = fmaf(Ss[i * KP + j], vsum[j], c);
      rowck[i] = c;
    }
    const float vm = block_max(vmax, red);
    const float eff_kv = (float)min(len - kv_start, PAGE);
    const float tau = fmaxf(g.tau_coef * eff_kv * vm, 1e-30f);
    const Verdict pv = verify_rows<DH>(Ds, bq, DH + 1, colck, rowck, tau,
                                       eff_kv, g.corrects, 0, 0, vs, rep);
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int i = i0 + CROWS * e;
      if (g.corrects && pv.det && pv.col == c0 && pv.row == i) dr[e] -= pv.mag;
      if (i < bq) acc[e] = acc[e] * alpha_s[i] + dr[e];
    }
  }

  // ---- flush: degenerate rows write exact zeros ---------------------------
  T* out = static_cast<T*>(g.out) + (long long)gi * bq * DH;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int i = i0 + CROWS * e;
    if (i >= bq) continue;
    const float m = m_s[i], l = l_s[i];
    const bool good = m > 0.5f * kNegInf && l > 0.0f;
    const float linv = good ? 1.0f / fmaxf(l, 1e-30f) : 0.0f;
    store(&out[i * DH + c0], acc[e] * linv);
  }
  if (tid == 0) {
    float* r = g.rep + (long long)gi * 8;
    for (int q8 = 0; q8 < 8; ++q8) r[q8] = rep[q8];
  }
}

template <typename T, int DH, int PAGE, bool SEU>
cudaError_t launch_instance(const DecodeArgs& g, int grid,
                            cudaStream_t stream) {
  constexpr int bytes = smem_floats<DH, PAGE>() * (int)sizeof(float);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_kernel<T, DH, PAGE, SEU>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  flash_decode_kernel<T, DH, PAGE, SEU><<<grid, kThreads, bytes, stream>>>(g);
  return cudaGetLastError();
}

// The campaign instance when a campaign is armed, else the clean one.
template <typename T, int DH, int PAGE>
cudaError_t launch(const DecodeArgs& g, int grid, cudaStream_t stream) {
  return g.seu.on ? launch_instance<T, DH, PAGE, true>(g, grid, stream)
                  : launch_instance<T, DH, PAGE, false>(g, grid, stream);
}

template <typename T, int DH>
cudaError_t launch_page(const DecodeArgs& g, int page, int grid,
                        cudaStream_t st) {
  if (page == 16) return launch<T, DH, 16>(g, grid, st);
  if (page == 32) return launch<T, DH, 32>(g, grid, st);
  if (page == 64) return launch<T, DH, 64>(g, grid, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* flash_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (n_slots·kvh, bq, dh); k, v (n_pages, kvh, page, dh); lengths (n_slots)
// and table (n_slots, max_pages) int32; out like q; report (n_slots·kvh, 8)
// f32: all contiguous. dtype: 0 f32, 1 bf16; dh 128 or 256; page 16, 32 or
// 64; 1 <= bq <= 32. seu_*: the stochastic hook's campaign
// (seu_hook.cuh). Returns the launch's cudaError_t.
int flash_decode_launch(const void* q, const void* k, const void* v,
                        const int* lengths, const int* table, void* out,
                        float* rep, int n_slots, int kvh, int bq, int dh,
                        int page, int max_pages, int n_pages, int dtype,
                        int corrects, float scale, float tau_qk_coef,
                        float tau_coef, int inj_enable, int inj_g, int inj_qi,
                        int inj_s, int inj_row, int inj_col, float inj_mag,
                        int seu_on, unsigned seu_seed, float seu_rate,
                        int seu_shift, void* stream) {
  if (n_slots <= 0 || kvh <= 0 || bq <= 0 || bq > kMaxBq || max_pages <= 0 ||
      n_pages <= 0 || (long long)n_slots * kvh > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  DecodeArgs g{};
  g.q = q; g.k = k; g.v = v; g.lengths = lengths; g.table = table;
  g.out = out; g.rep = rep;
  g.bq = bq; g.kvh = kvh; g.max_pages = max_pages; g.n_pages = n_pages;
  g.corrects = corrects; g.scale = scale;
  g.tau_qk_coef = tau_qk_coef; g.tau_coef = tau_coef;
  g.inj_enable = inj_enable; g.inj_g = inj_g; g.inj_qi = inj_qi;
  g.inj_s = inj_s; g.inj_row = inj_row; g.inj_col = inj_col;
  g.inj_mag = inj_mag;
  g.seu = seu::Args{seu_on, seu_seed, seu_rate, seu_shift};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = n_slots * kvh;
  if (dtype == 0 && dh == 128) return launch_page<float, 128>(g, page, grid, st);
  if (dtype == 0 && dh == 256) return launch_page<float, 256>(g, page, grid, st);
  if (dtype == 1 && dh == 128)
    return launch_page<__nv_bfloat16, 128>(g, page, grid, st);
  if (dtype == 1 && dh == 256)
    return launch_page<__nv_bfloat16, 256>(g, page, grid, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
