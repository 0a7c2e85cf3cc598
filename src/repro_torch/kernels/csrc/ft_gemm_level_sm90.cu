// K1 on the tensor cores at the warp ("tile") and thread ("inner") FT
// levels: the instances of the kernels in csrc/ft_gemm_sm90.cuh (whose
// note says what they replace, what bounds them and how each level
// verifies) and their C entry. A source of its own, so its instances build
// in parallel with FT off and "block" (csrc/ft_gemm_sm90.cu).
//
// Report per output block, f32[8]: [detected, corrected, row, col,
// magnitude, max_residual, tau, k_elapsed]; at "tile" the block's bands
// recorded in band order.
#include "ft_gemm_sm90.cuh"

extern "C" {

const char* ft_gemm_level_sm90_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The arguments of ft_gemm_sm90_launch (csrc/ft_gemm_sm90.cu), at the
// level codes 2 tile, 3 inner (kLvTile, kLvInner;
// kernels/ft_gemm.py:SM90_LEVELS). Returns the first cudaError_t.
int ft_gemm_level_sm90_launch(const void* a, const void* b, const void* bias,
                              void* out, void* act_grad, float* rep, float* ws,
                              int M, int N, int K, long long lda,
                              long long ldb, int a_kmajor, int b_kmajor,
                              int bm, int splits, int level, int act,
                              int verify_step, int corrects, float tau_coef,
                              int inj_enable, int inj_row, int inj_col,
                              int inj_k, float inj_mag, int seu_on,
                              unsigned seu_seed, float seu_rate, int seu_shift,
                              void* stream) {
  Sm90Args g;
  CUtensorMap ta, tb;
  if ((level != kLvTile && level != kLvInner) ||
      !k1_setup(g, ta, tb, a, b, bias, out, act_grad, rep, ws, M, N, K, lda,
                ldb, a_kmajor, b_kmajor, bm, splits, act, verify_step,
                corrects, tau_coef, inj_enable, inj_row, inj_col, inj_k,
                inj_mag, seu_on, seu_seed, seu_rate, seu_shift))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 128)
    return level == kLvTile
               ? launch_level<kLvTile, 128>(a_kmajor, b_kmajor, ta, tb, g, st)
               : launch_level<kLvInner, 128>(a_kmajor, b_kmajor, ta, tb, g, st);
  return level == kLvTile
             ? launch_level<kLvTile, 64>(a_kmajor, b_kmajor, ta, tb, g, st)
             : launch_level<kLvInner, 64>(a_kmajor, b_kmajor, ta, tb, g, st);
}

}  // extern "C"
