// K1 on the tensor cores at FT off and at the threadblock ("block") level:
// the instances of the kernels in csrc/ft_gemm_sm90.cuh (whose note says
// what they replace, what bounds them and how) and their C entry. The
// warp ("tile") and thread ("inner") levels are csrc/ft_gemm_level_sm90.cu,
// built beside this source.
//
// Report per output block, f32[8]: [detected, corrected, row, col,
// magnitude, max_residual, tau, k_elapsed].
#include "ft_gemm_sm90.cuh"

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
// of splits·(gm·bm·gn·128 + gm·gn·1168) elements. bm: 128 or 64. level:
// the FT level code, 0 off, 1 block (kLvOff, kLvBlock;
// kernels/ft_gemm.py:SM90_LEVELS). act: 0 none, 1 silu, 2 gelu, 3 relu.
// The injection (deterministic SEU) adds inj_mag at global (inj_row,
// inj_col) after 256-deep k-step inj_k; seu_*: the stochastic hook's
// campaign (seu_hook.cuh).
// Launches the main kernel and, with splits > 1, the reduce kernel;
// returns the first cudaError_t.
int ft_gemm_sm90_launch(const void* a, const void* b, const void* bias,
                        void* out, void* act_grad, float* rep, float* ws,
                        int M, int N, int K, long long lda, long long ldb,
                        int a_kmajor, int b_kmajor, int bm, int splits,
                        int level, int act, int verify_step, int corrects,
                        float tau_coef,
                        int inj_enable, int inj_row, int inj_col, int inj_k,
                        float inj_mag, int seu_on, unsigned seu_seed,
                        float seu_rate, int seu_shift, void* stream) {
  Sm90Args g;
  CUtensorMap ta, tb;
  if ((level != kLvOff && level != kLvBlock) ||
      !k1_setup(g, ta, tb, a, b, bias, out, act_grad, rep, ws, M, N, K, lda,
                ldb, a_kmajor, b_kmajor, bm, splits, act, verify_step,
                corrects, tau_coef, inj_enable, inj_row, inj_col, inj_k,
                inj_mag, seu_on, seu_seed, seu_rate, seu_shift))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 128)
    return level == kLvBlock
               ? launch_level<kLvBlock, 128>(a_kmajor, b_kmajor, ta, tb, g, st)
               : launch_level<kLvOff, 128>(a_kmajor, b_kmajor, ta, tb, g, st);
  return level == kLvBlock
             ? launch_level<kLvBlock, 64>(a_kmajor, b_kmajor, ta, tb, g, st)
             : launch_level<kLvOff, 64>(a_kmajor, b_kmajor, ta, tb, g, st);
}

}  // extern "C"
