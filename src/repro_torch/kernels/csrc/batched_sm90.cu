// Uniform-batched ABFT GEMM on the tensor cores (sm_90a): K5 for bf16
// calls of at most 16 rows a slice, the products of decode attention
// against the KV cache.
//
// Replaces the TPU kernel K5 of the JAX package:
//   src/repro/kernels/templates/registry.py:518-520 batched_kernel_call,
//   which renders src/repro/kernels/templates/emit.py:233 render with a
//   leading batch grid axis.
// It computes what the batched instance of csrc/ft_gemm.cu computes, with
// the same thresholds and 8-float report per output block; that source
// (and csrc/ft_gemm_chain.cu for a call with a chain) keeps f32, more than
// 16 rows and operands the 16-byte copies cannot read, and
// kernels/ft_gemm.py:plan_k5 picks between them. C[z] = chain(A[z]·B[z])
// for every slice z of one or two batch dims (B may be shared; the chain
// an aux-free runtime list of activations, empty on the serving path),
// each operand read in place through its strides: A along k,
// B along k (decode attention's K cache permuted to (B, KVH, dh, S)) or
// along n (its V cache transposed to (B, KVH, S, dh)).
//
// What bounds it on the H100: bytes of B, and at the serving shapes not
// even those. qwen2-7b's decode with 4 requests and a 256-position cache
// reads about 1.1 MB of cache per product (0.34 µs at 3.35 TB/s) for
// 14.7 MFLOP, so the launch latency and the length of each CTA's chain of
// dependent steps set the pace. The SIMT kernel put 32 (QKᵀ) and 16 (PV)
// CTAs on 132 SMs, each walking 4 or 8 k-steps 32 deep with an f32
// widening pass, a barrier and a whole block verification each. The
// design:
//   * a grid that fills the card: one CTA of 4 warps per (slice, column
//     block) of 16 rows x 32 columns; the serving shapes launch 128 and 64
//     CTAs. Rows past M (7 of 16 at qwen2-7b) read as zero and are never
//     written;
//   * a 256-deep k-step, which is also the verification interval and the
//     unit of the injection's k_step (K1's tensor-core k-step, the
//     reference's small-class bk): both serving products take one step;
//   * staging by 16-byte `cp.async` with zero fill (rows, columns and k
//     past the operand's edge read as zero and touch no device memory)
//     into bf16 rows padded by 16 bytes, so the `ldmatrix` rows fall on
//     distinct banks; two stages, step s + 2 copied while step s runs;
//     B's rows are the cache's 256-byte runs, staged as [n][k] when k has
//     unit stride and as [k][n] when n has; no f32 widening pass;
//   * products on `mma.sync` m16n8k16, bf16 -> f32: the 16 rows are one
//     fragment. `wgmma` takes 64 rows, 48 of which would be dead at n_rep
//     up to 16, and its asynchrony buys nothing in a chain one or two
//     steps long. Each warp owns 8 columns (one n8 tile) over the whole
//     step; `ldmatrix` reads A and the k-major B, `ldmatrix.trans` the
//     n-major B;
//   * checksums on the CUDA cores: one pass over the staged step gives
//     eᵀA_s, B_s e and the maxima; inside the MMA loop each thread folds
//     the B fragment it feeds the tensor cores into (eᵀA_s)·B_s of its
//     column, and warp w its A fragments of the chunk pairs p ≡ w (mod 4)
//     into A_s·(B_s e) of its rows, kept per warp (locate16 adds them up).
//     Running over the steps in registers (block, tile), one step's alone
//     (inner);
//   * verification from the accumulator fragment: column sums by shuffles
//     within the warp, row sums across the warps through shared memory
//     (frag16_sums), the first argmax and abft::record by warp 0
//     (locate16, csrc/mma16_sm90.cuh), the correction by the lane that
//     holds the element.
// The levels (reference emit.py:432-512): block keeps one running pair of
// checksums a block, verified after every non-last step (verify_step) and
// at k = K; tile keeps one column checksum a band of 16 rows, the whole
// block here, and an aux-free chain has no linear prefix to fold, so the
// chain follows the final verification at both levels and tile runs the
// block level's code; inner keeps each
// step's Δ in a second fragment, verifies and corrects it against that
// step's checksums and then adds it to the accumulator, with no final
// verification. Tau takes the elapsed k and the running max|A|, max|B| of
// the block (emit.py:369-378). The chain (chain_ops, 3 bits an op,
// activate_chain in sm90_mainloop.cuh) is applied in f32 in the one write
// of C, after the final verification (after the last step's at inner, the
// chain alone with FT off), as the reference's render applies it
// (emit.py:487-512).
//
// Stochastic SEU campaigns (seu_hook.cuh): under FT every CTA draws its
// block's SEU, uid slice·gn + j (one 16-row block a slice), over 16 x 32
// and the ceil(K / 256) k-steps; on the drawn step the lane that holds the
// element keeps it from before the step's products (in Δ at the inner
// level, where it is 0) and adds the magnitude of the difference after
// them, before the step's verification.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma16_sm90.cuh"
#include "seu_hook.cuh"

namespace {

// kStep (sm90_mainloop.cuh, 256): the k-step and verification interval
constexpr int kThr = 32 * kWarps;        // four warps
constexpr int kBn = 32;                  // columns of a block
constexpr int kRowK = kStep + 8;         // a k-major staged row: 528 bytes

enum Mode { kOff = 0, kBlock = 1, kInner = 2 };

struct BArgs {
  const __nv_bfloat16* a;   // (nb0, nb1, M, K), unit stride along k
  const __nv_bfloat16* b;   // (nb0, nb1, K, N), unit stride along k or n
  __nv_bfloat16* out;       // (nb0, nb1, M, N) contiguous
  float* rep;               // (nb0, nb1, 1, gn, 8)
  int M, N, K, nb1, gn, ksteps;
  long long sa0, sa1, sb0, sb1;   // batch strides (sb 0, 0: a shared B)
  int sam;                  // A's row stride
  int ldb;                  // B's stride along its other dim
  int verify_step, corrects;
  float tau_coef;           // rel_tau * eps32
  int inj_enable, inj_batch, inj_row, inj_col, inj_k;
  float inj_mag;
  seu::Args seu;            // the stochastic hook's campaign
  int chain_ops, chain_len; // the activations applied in the write of C
};

// BK: B staged as [n][k] rows (its k dim has unit stride), else as [k][n].
template <bool BK>
struct Smem {
  __nv_bfloat16 a[2][kBq][kRowK];
  __nv_bfloat16 b[2][BK ? kBn : kStep][BK ? kRowK : kBn + 8];
  float asum[kStep];          // e^T A_s
  float bsum[kStep];          // B_s e
  float ck[kBn];               // column checks at a verification
  float dcol[kBn];             // column residuals
  float drow[kBq];
  float rowp[kWarps][kBq];    // per-warp row sums of the accumulator
  float rowq[kWarps][kBq];    // per-warp partial row checks
  float red[kWarps][2];       // max |A|, max |B| of a step by warp
  abft::Verdict verdict;
  float rep[8];
};

// 16 bytes from global to shared memory, the last 16 - bytes zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices, rows addressed by lanes 8i .. 8i + 7.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// The two bf16 of a register as floats, the low half first.
__device__ __forceinline__ float2 unpack2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// The k-step starting at k0 into stage st, kfill deep (a multiple of 32;
// whatever lies past M, N or K is zero-filled), as one cp.async group.
template <bool BK>
__device__ __forceinline__ void load_step(Smem<BK>& sm, int st,
                                          const BArgs& g,
                                          const __nv_bfloat16* A,
                                          const __nv_bfloat16* B, int col0,
                                          int k0, int kfill, int tid) {
  const int kc = kfill / 8;
  for (int i = tid; i < kBq * kc; i += kThr) {
    const int r = i / kc, c = 8 * (i % kc), gk = k0 + c;
    const int bytes = (r < g.M && gk < g.K) ? 2 * min(8, g.K - gk) : 0;
    cp_async16(&sm.a[st][r][c], bytes ? A + (long long)r * g.sam + gk : A,
               bytes);
  }
  if constexpr (BK) {
    for (int i = tid; i < kBn * kc; i += kThr) {
      const int n = i / kc, c = 8 * (i % kc), gn = col0 + n, gk = k0 + c;
      const int bytes = (gn < g.N && gk < g.K) ? 2 * min(8, g.K - gk) : 0;
      cp_async16(&sm.b[st][n][c],
                 bytes ? B + (long long)gn * g.ldb + gk : B, bytes);
    }
  } else {
    constexpr int nc = kBn / 8;
    for (int i = tid; i < kfill * nc; i += kThr) {
      const int kk = i / nc, c = 8 * (i % nc), gk = k0 + kk, gn = col0 + c;
      const int bytes = (gk < g.K && gn < g.N) ? 2 * min(8, g.N - gn) : 0;
      cp_async16(&sm.b[st][kk][c],
                 bytes ? B + (long long)gk * g.ldb + gn : B, bytes);
    }
  }
  cp_async_commit();
}

// Verify a warp's accumulator fragment a (its columns cw0 .. of the
// block) against the running column-check partials cpart (this thread's k
// of its column, per n8 tile) and row-check partials rpart (rows gr, gr +
// 8, this warp's chunk pairs); record into sm.rep and correct in place.
// Every thread of the CTA calls it.
template <int NT, bool BK>
__device__ __forceinline__ void verify_frag(float (&a)[NT][4],
                                            Smem<BK>& sm,
                                            const float (&cpart)[NT],
                                            const float (&rpart)[2],
                                            float tau, float k_el,
                                            int corrects, int col0, int cw0,
                                            int warp, int lane) {
  const int gr = lane / 4, tq = lane & 3;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    float c = cpart[t];
    c += __shfl_xor_sync(kFull, c, 1);
    c += __shfl_xor_sync(kFull, c, 2);
    if (tq == 0) sm.ck[cw0 + 8 * t + gr] = c;
  }
  float r0 = rpart[0], r1 = rpart[1];
  r0 += __shfl_xor_sync(kFull, r0, 1);
  r0 += __shfl_xor_sync(kFull, r0, 2);
  r1 += __shfl_xor_sync(kFull, r1, 1);
  r1 += __shfl_xor_sync(kFull, r1, 2);
  if (tq == 0) {
    sm.rowq[warp][gr] = r0;
    sm.rowq[warp][gr + 8] = r1;
  }
  __syncwarp();   // this warp's columns of ck come from its own lanes
  frag16_sums<NT>(a, sm.ck, sm.dcol, sm.rowp, cw0, warp, lane);
  __syncthreads();
  if (warp == 0)
    locate16(sm.dcol, kBn, sm.drow, sm.rowp, nullptr, sm.rowq, tau, k_el,
             corrects, col0, sm.rep, &sm.verdict, lane);
  __syncthreads();
  const abft::Verdict v = sm.verdict;
  if (corrects && v.det) frag16_add<NT>(a, v.row, v.col - cw0, -v.mag, lane);
}

template <bool BK, int MODE>
__global__ void __launch_bounds__(kThr) batched_sm90_kernel(const BArgs g) {
  constexpr int NT = kBn / (8 * kWarps);   // n8 tiles a warp
  constexpr int CW = kBn / kWarps;         // columns a warp
  constexpr bool FT = MODE != kOff, INNER = MODE == kInner;
  extern __shared__ __align__(128) uint8_t smem_raw[];
  Smem<BK>& sm = *reinterpret_cast<Smem<BK>*>(smem_raw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid & 31;
  const int gr = lane / 4, tq = lane & 3;
  const int bj = blockIdx.x % g.gn, bz = blockIdx.x / g.gn;
  const int z0 = bz / g.nb1, z1 = bz % g.nb1;
  const int col0 = bj * kBn, cw0 = warp * CW;
  const __nv_bfloat16* A = g.a + z0 * g.sa0 + z1 * g.sa1;
  const __nv_bfloat16* B = g.b + z0 * g.sb0 + z1 * g.sb1;

  if (FT && tid < 8) sm.rep[tid] = 0.0f;
  for (int s = 0; s < min(g.ksteps, 2); ++s)
    load_step(sm, s, g, A, B, col0, s * kStep,
              min(kStep, (g.K - s * kStep + 31) & ~31), tid);

  float acc[NT][4], dlt[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[t][r] = 0.0f;
  float (&d)[NT][4] = INNER ? dlt : acc;   // this step's products land here
  float cpart[NT], rpart[2] = {0.0f, 0.0f};
#pragma unroll
  for (int t = 0; t < NT; ++t) cpart[t] = 0.0f;
  float amax = 0.0f, bmax = 0.0f;   // the block's running maxima
  const bool inj_here = FT && g.inj_enable &&
                        (g.inj_batch < 0 || g.inj_batch == bz);
  const seu::Hit sh =
      FT ? seu::draw(g.seu, (uint32_t)(bz * g.gn + bj), g.ksteps, kBq, kBn)
         : seu::Hit{false, 0, 0, 0};
  float seu_before = 0.0f;   // the hit element before its step

  for (int s = 0; s < g.ksteps; ++s) {
    const int st = s & 1, k0 = s * kStep;
    const int kfill = min(kStep, (g.K - k0 + 31) & ~31);
    if (s + 1 < g.ksteps) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();
    const __nv_bfloat16(*As)[kRowK] = sm.a[st];
    const auto Bs = sm.b[st];

    if constexpr (FT) {
      // e^T A_s, B_s e and the maxima from the staged step, thread = k
      float am = 0.0f, bm = 0.0f;
      for (int k = tid; k < kfill; k += kThr) {
        float sa = 0.0f, sb = 0.0f;
#pragma unroll
        for (int r = 0; r < kBq; ++r) {
          const float x = bf(As[r][k]);
          sa += x;
          am = fmaxf(am, fabsf(x));
        }
        if constexpr (BK) {
#pragma unroll 8
          for (int n = 0; n < kBn; ++n) {
            const float x = bf(Bs[n][k]);
            sb += x;
            bm = fmaxf(bm, fabsf(x));
          }
        } else {
#pragma unroll
          for (int c = 0; c < kBn; c += 8) {
            const uint4 v = *reinterpret_cast<const uint4*>(&Bs[k][c]);
            const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float2 x = unpack2(w[i]);
              sb += x.x + x.y;
              bm = fmaxf(bm, fmaxf(fabsf(x.x), fabsf(x.y)));
            }
          }
        }
        sm.asum[k] = sa;
        sm.bsum[k] = sb;
      }
      am = warp_max(am);
      bm = warp_max(bm);
      if (lane == 0) {
        sm.red[warp][0] = am;
        sm.red[warp][1] = bm;
      }
      __syncthreads();
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        amax = fmaxf(amax, sm.red[w][0]);
        bmax = fmaxf(bmax, sm.red[w][1]);
      }
      if constexpr (INNER) {
#pragma unroll
        for (int t = 0; t < NT; ++t) cpart[t] = 0.0f;
        rpart[0] = rpart[1] = 0.0f;
      }
    }
    if constexpr (INNER) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) dlt[t][r] = 0.0f;
    }
    if (sh.hit && s == sh.step)
      seu_before = frag16_get<NT>(d, sh.row, sh.col - cw0, lane);

    // ---- the products, two k16 chunks at a time, and the checksums -------
    for (int p = 0; p < kfill / 32; ++p) {
      const int kb = 32 * p;
      uint32_t af[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        ldsm_x4(af[h], &As[(lane & 7) + ((lane >> 3) & 1) * 8]
                          [kb + 16 * h + (lane >> 4) * 8]);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        uint32_t bq[4];   // b0, b1 of chunk kb, then of chunk kb + 16
        if constexpr (BK)
          ldsm_x4(bq, &Bs[cw0 + 8 * t + (lane & 7)][kb + (lane >> 3) * 8]);
        else
          ldsm_x4_trans(bq, &Bs[kb + lane][cw0 + 8 * t]);
        mma16816(d[t], af[0], bq[0], bq[1]);
        mma16816(d[t], af[1], bq[2], bq[3]);
        if constexpr (FT) {
          // (e^T A_s)·B_s of column cw0 + 8t + gr: this lane's 8 k
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 bv = unpack2(bq[j]);
            const float2 as =
                *reinterpret_cast<const float2*>(&sm.asum[kb + 8 * j + 2 * tq]);
            cpart[t] = fmaf(as.x, bv.x, fmaf(as.y, bv.y, cpart[t]));
          }
        }
      }
      if (FT && (p & (kWarps - 1)) == warp) {
        // A_s·(B_s e) of rows gr (regs 0, 2) and gr + 8 (regs 1, 3)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 av = unpack2(af[h][j]);
            const float2 bs = *reinterpret_cast<const float2*>(
                &sm.bsum[kb + 16 * h + 8 * (j >> 1) + 2 * tq]);
            rpart[j & 1] = fmaf(av.x, bs.x, fmaf(av.y, bs.y, rpart[j & 1]));
          }
      }
    }

    if constexpr (FT) {
      // Emulated SEU on this step's products (deterministic injection).
      if (inj_here && s == g.inj_k)
        frag16_add<NT>(d, g.inj_row, g.inj_col - col0 - cw0, g.inj_mag, lane);
      if (sh.hit && s == sh.step)
        frag16_add<NT>(
            d, sh.row, sh.col - cw0,
            seu::magnitude(frag16_get<NT>(d, sh.row, sh.col - cw0, lane) -
                               seu_before,
                           g.seu.shift),
            lane);
      const float k_el = (float)min(k0 + kStep, g.K);
      if (INNER || (g.verify_step && s != g.ksteps - 1))
        verify_frag<NT>(d, sm, cpart, rpart,
                        g.tau_coef * k_el * amax * bmax, k_el, g.corrects,
                        col0, cw0, warp, lane);
      if constexpr (INNER) {
#pragma unroll
        for (int t = 0; t < NT; ++t)
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[t][r] += dlt[t][r];
      }
    }
    if (s + 2 < g.ksteps) {
      __syncthreads();   // every warp is done with stage st
      load_step(sm, st, g, A, B, col0, k0 + 2 * kStep,
                min(kStep, (g.K - k0 - 2 * kStep + 31) & ~31), tid);
    }
  }

  if constexpr (MODE == kBlock) {
    const float k_el = (float)g.K;
    verify_frag<NT>(acc, sm, cpart, rpart, g.tau_coef * k_el * amax * bmax,
                    k_el, g.corrects, col0, cw0, warp, lane);
  }

  // ---- the chain, one write of C (rows < M, columns < N), the report -----
  __nv_bfloat16* out = g.out + (long long)bz * g.M * g.N;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int c = col0 + cw0 + 8 * t + 2 * tq;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = gr + 8 * hf;
      if (r >= g.M) continue;
      __nv_bfloat16* o = out + (long long)r * g.N + c;
      if (c < g.N)
        o[0] = __float2bfloat16(
            activate_chain(g.chain_ops, g.chain_len, acc[t][2 * hf]));
      if (c + 1 < g.N)
        o[1] = __float2bfloat16(
            activate_chain(g.chain_ops, g.chain_len, acc[t][2 * hf + 1]));
    }
  }
  if (FT && tid < 8)
    g.rep[((long long)bz * g.gn + bj) * 8 + tid] = sm.rep[tid];
}

template <bool BK, int MODE>
cudaError_t launch(const BArgs& g, int ctas, cudaStream_t st) {
  constexpr int bytes = (int)sizeof(Smem<BK>);
  static bool ready = false;
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        batched_sm90_kernel<BK, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  batched_sm90_kernel<BK, MODE><<<ctas, kThr, bytes, st>>>(g);
  return cudaGetLastError();
}

template <bool BK>
cudaError_t launch_mode(int mode, const BArgs& g, int ctas, cudaStream_t st) {
  switch (mode) {
    case kOff: return launch<BK, kOff>(g, ctas, st);
    case kBlock: return launch<BK, kBlock>(g, ctas, st);
    case kInner: return launch<BK, kInner>(g, ctas, st);
    default: return cudaErrorInvalidValue;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

const char* batched_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K5 on the tensor cores. a (nb0, nb1, M, K) bf16 with batch strides sa0,
// sa1, row stride sam and unit k stride; b (nb0, nb1, K, N) bf16 with
// batch strides sb0, sb1 (0, 0: one B shared by every slice), unit stride
// along k (b_kmajor 1) or n (0) and stride ldb along the other dim; every
// stride but a unit one a multiple of 8 elements (sam may be anything
// when M is 1, ldb when that other dim is 1: only index 0 is read), both
// bases 16-byte aligned. out (nb0, nb1, M, N) bf16 and report (nb0, nb1,
// 1, ceil(N / 32), 8) f32 contiguous. M <= 16. level: 0 block, 1 tile, 2
// inner (with ft = 1). chain_ops: chain_len (at most 10) activations, op i
// in bits 3i..3i+2 (kernels/ft_gemm.py:CHAIN_OPS: 3 silu, 4 gelu, 5 relu),
// applied to C in order. inj: [enable, batch (< 0: every slice), row, col,
// k_step] in 256-deep steps; seu_*: the stochastic hook's campaign
// (seu_hook.cuh). Returns the launch's cudaError_t.
int batched_sm90_launch(const void* a, const void* b, void* out, float* rep,
                        int nb0, int nb1, int M, int N, int K,
                        long long sa0, long long sa1, int sam,
                        long long sb0, long long sb1, int ldb, int b_kmajor,
                        int ft, int level, int chain_ops, int chain_len,
                        int verify_step, int corrects, float tau_coef,
                        int inj_enable,
                        int inj_batch, int inj_row, int inj_col, int inj_k,
                        float inj_mag, int seu_on, unsigned seu_seed,
                        float seu_rate, int seu_shift, void* stream) {
  if (M <= 0 || M > kBq || N <= 0 || K <= 0 || nb0 <= 0 || nb1 <= 0 ||
      (ldb % 8 != 0 && (b_kmajor ? N : K) > 1) || (M > 1 && sam % 8 != 0) ||
      sa0 % 8 != 0 || sa1 % 8 != 0 || sb0 % 8 != 0 || sb1 % 8 != 0 ||
      !aligned16(a) || !aligned16(b) || (ft && rep == nullptr) ||
      level < 0 || level > 2 || !activation_chain_ok(chain_ops, chain_len))
    return cudaErrorInvalidValue;
  const long long gn = (N + kBn - 1) / kBn;
  const long long ctas = (long long)nb0 * nb1 * gn;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
  BArgs g{};
  g.a = static_cast<const __nv_bfloat16*>(a);
  g.b = static_cast<const __nv_bfloat16*>(b);
  g.out = static_cast<__nv_bfloat16*>(out);
  g.rep = rep;
  g.M = M; g.N = N; g.K = K; g.nb1 = nb1; g.gn = (int)gn;
  g.ksteps = (K + kStep - 1) / kStep;
  g.sa0 = sa0; g.sa1 = sa1; g.sb0 = sb0; g.sb1 = sb1;
  g.sam = sam; g.ldb = ldb;
  g.verify_step = verify_step; g.corrects = corrects; g.tau_coef = tau_coef;
  g.inj_enable = inj_enable; g.inj_batch = inj_batch; g.inj_row = inj_row;
  g.inj_col = inj_col; g.inj_k = inj_k; g.inj_mag = inj_mag;
  g.seu = seu::Args{seu_on, seu_seed, seu_rate, seu_shift};
  g.chain_ops = chain_ops; g.chain_len = chain_len;
  const int mode = !ft ? kOff : level == 2 ? kInner : kBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n = (int)ctas;
  return b_kmajor ? launch_mode<true>(mode, g, n, st)
                  : launch_mode<false>(mode, g, n, st);
}

}  // extern "C"
