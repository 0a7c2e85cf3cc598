// K1's SIMT instance for every epilogue chain that csrc/ft_gemm.cu does
// not compile: the kernel of csrc/ft_gemm_simt.cuh (whose note says what it
// replaces, what bounds it and how each FT level verifies) at EPI =
// kEpiChain, the chain passed as a runtime op list. One instance per
// (operand type, FT off or level, tiles, act_grad) on the row-major walk,
// so a new chain adds no instance; a source of its own, so these build in
// parallel with csrc/ft_gemm.cu. kernels/ft_gemm.py:plan sends a call here
// when ft_gemm.cu has no instance for its (chain, level, act_grad).
//
// Report per output block, f32[8]: [detected, corrected, row, col,
// magnitude, max_residual, tau, k_elapsed].
#include "ft_gemm_simt.cuh"

namespace {

using namespace abft;

template <typename T, bool FT, int LEVEL>
cudaError_t launch_chain(bool ag, int tiles, const GemmArgs& g, int batch,
                         cudaStream_t st) {
  if (ag)
    return launch_tiles<T, FT, kEpiChain, 0, true, LEVEL>(tiles, g, batch, st);
  return launch_tiles<T, FT, kEpiChain, 0, false, LEVEL>(tiles, g, batch, st);
}

template <typename T>
cudaError_t launch_chain_ft(int ft, int level, bool ag, int tiles,
                            const GemmArgs& g, int batch, cudaStream_t st) {
  if (!ft) return launch_chain<T, false, kLevelBlock>(ag, tiles, g, batch, st);
  switch (level) {
    case kLevelBlock:
      return launch_chain<T, true, kLevelBlock>(ag, tiles, g, batch, st);
    case kLevelTile:
      return launch_chain<T, true, kLevelTile>(ag, tiles, g, batch, st);
    case kLevelInner:
      return launch_chain<T, true, kLevelInner>(ag, tiles, g, batch, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* ft_gemm_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The arguments of ft_gemm_launch (csrc/ft_gemm.cu) with the chain as a
// runtime op list in place of the epi code and the layout (row-major walk
// only): chain_ops holds op i (kOpBias 1, kOpResidual 2, kOpSilu 3, kOpGelu
// 4, kOpRelu 5) in bits 3i..3i+2, chain_len ops (at most 3), the first
// chain_fold of them the linear prefix. act_grad (with exactly one
// activation in the chain) is written at the activation's input. Returns
// the launch's cudaError_t.
int ft_gemm_chain_launch(const void* a, const void* b, const void* bias,
                         const void* res, void* out, float* rep,
                         void* act_grad, int nb0, int nb1, int M, int N,
                         int K, long long sa0, long long sa1, int sam,
                         int sak, long long sb0, long long sb1, int sbk,
                         int sbn, int dtype, int ft, int level, int chain_ops,
                         int chain_len, int chain_fold, int tiles,
                         int verify_step, int corrects, float tau_coef,
                         int inj_enable, int inj_batch, int inj_row,
                         int inj_col, int inj_k, float inj_mag, int seu_on,
                         unsigned seu_seed, float seu_rate, int seu_shift,
                         void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || nb0 <= 0 || nb1 <= 0 || chain_len < 1 ||
      chain_len > 3 || chain_fold < 0 || chain_fold > chain_len)
    return cudaErrorInvalidValue;
  const int batch = nb0 * nb1;
  GemmArgs g{};
  g.a = a; g.b = b; g.bias = bias; g.res = res; g.out = out; g.rep = rep;
  g.act_grad = act_grad;
  g.M = M; g.N = N; g.K = K; g.nb1 = nb1;
  g.sa0 = sa0; g.sa1 = sa1; g.sam = sam; g.sak = sak;
  g.sb0 = sb0; g.sb1 = sb1; g.sbk = sbk; g.sbn = sbn;
  g.verify_step = verify_step; g.corrects = corrects; g.tau_coef = tau_coef;
  g.inj_enable = inj_enable; g.inj_batch = inj_batch; g.inj_row = inj_row;
  g.inj_col = inj_col; g.inj_k = inj_k; g.inj_mag = inj_mag;
  g.seu = seu::Args{seu_on, seu_seed, seu_rate, seu_shift};
  g.chain_ops = chain_ops; g.chain_len = chain_len; g.chain_fold = chain_fold;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ag = act_grad != nullptr;
  if (dtype == 0)
    return launch_chain_ft<float>(ft, level, ag, tiles, g, batch, st);
  if (dtype == 1)
    return launch_chain_ft<__nv_bfloat16>(ft, level, ag, tiles, g, batch, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
