// The SIMT chain instances: the kernel of csrc/ft_gemm_simt.cuh (whose
// note says what it replaces, what bounds it and how each FT level
// verifies) at EPI = kEpiChain, the chain passed as a runtime op list of
// at most 10 ops. For K1 and K5, one instance per (operand type, FT off or
// level, tiles, act_grad) on the row-major walk; for K7, one per (operand
// type, FT off or level, row tile, walk of w) of the GROUPED body, whose
// chains are aux-free. A new chain adds no instance; a source of its own,
// so these build in parallel with csrc/ft_gemm.cu.
// kernels/ft_gemm.py:plan sends a 2-D call here when ft_gemm.cu has no
// instance for its (chain, level, act_grad), plan_k5 every batched SIMT
// call with a chain, and kernels/grouped_gemm.py:plan_k7 every SIMT K7
// call with a chain.
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

// K7 with a chain: the GROUPED instances of csrc/ft_gemm.cu's
// launch_grouped at kEpiChain, by row tile (BM) and the walk of B's loads.
template <typename T, bool FT, int LEVEL>
cudaError_t launch_grouped_chain(int bm, int layout, const GemmArgs& g,
                                 cudaStream_t st) {
  if (bm == 16 && layout == 0)
    return launch<T, FT, kEpiChain, 0, false, 16, 128, 32, 2, 4, true,
                  LEVEL>(g, 1, st);
  if (bm == 16 && layout == 1)
    return launch<T, FT, kEpiChain, 1, false, 16, 128, 32, 2, 4, true,
                  LEVEL>(g, 1, st);
  if constexpr (sizeof(T) == 4) {
    if (bm == 8 && layout == 0)
      return launch<T, FT, kEpiChain, 0, false, 8, 128, 32, 1, 4, true,
                    LEVEL>(g, 1, st);
    if (bm == 8 && layout == 1)
      return launch<T, FT, kEpiChain, 1, false, 8, 128, 32, 1, 4, true,
                    LEVEL>(g, 1, st);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_grouped_chain_ft(int ft, int level, int bm, int layout,
                                    const GemmArgs& g, cudaStream_t st) {
  if (!ft) return launch_grouped_chain<T, false, kLevelBlock>(bm, layout, g, st);
  switch (level) {
    case kLevelBlock:
      return launch_grouped_chain<T, true, kLevelBlock>(bm, layout, g, st);
    case kLevelTile:
      return launch_grouped_chain<T, true, kLevelTile>(bm, layout, g, st);
    case kLevelInner:
      return launch_grouped_chain<T, true, kLevelInner>(bm, layout, g, st);
    default: return cudaErrorInvalidValue;
  }
}

// A runtime op list of at most 10 ops, each a ChainOp; aux_free: no bias,
// no residual.
bool chain_ok(int ops, int len, int fold, bool aux_free) {
  if (len < 1 || len > 10 || fold < 0 || fold > len) return false;
  for (int i = 0; i < len; ++i) {
    const int op = (ops >> (3 * i)) & 7;
    if (op < kOpBias || op > kOpRelu || (aux_free && op < kOpSilu))
      return false;
  }
  return true;
}

}  // namespace

extern "C" {

const char* ft_gemm_chain_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The arguments of ft_gemm_launch (csrc/ft_gemm.cu) with the chain as a
// runtime op list in place of the epi code and the layout (row-major walk
// only): chain_ops holds op i (kOpBias 1, kOpResidual 2, kOpSilu 3, kOpGelu
// 4, kOpRelu 5) in bits 3i..3i+2, chain_len ops (at most 10), the first
// chain_fold of them the linear prefix. act_grad (with exactly one
// activation in the chain) is written at the activation's input. A batch
// (nb0 x nb1 slices, K5) takes no bias or residual. Returns the launch's
// cudaError_t.
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
  if (M <= 0 || N <= 0 || K <= 0 || nb0 <= 0 || nb1 <= 0 ||
      !chain_ok(chain_ops, chain_len, chain_fold, nb0 * nb1 > 1))
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

// K7 with an aux-free chain: the arguments of ft_gemm_grouped_launch
// (csrc/ft_gemm.cu) with the op list (chain_ops, chain_len, as above;
// activations only) after the layout. Returns the launch's cudaError_t.
int ft_gemm_grouped_chain_launch(const void* a, const void* w, const int* gid,
                                 const int* row_end, void* out, float* rep,
                                 int T, int N, int K, int G, int sam, int sak,
                                 long long swg, int swk, int swn, int dtype,
                                 int ft, int level, int bm, int layout,
                                 int chain_ops, int chain_len,
                                 int verify_step, int corrects,
                                 float tau_coef, int inj_enable, int inj_row,
                                 int inj_col, int inj_k, float inj_mag,
                                 int seu_on, unsigned seu_seed,
                                 float seu_rate, int seu_shift,
                                 void* stream) {
  if (T <= 0 || N <= 0 || K <= 0 || G <= 0 || bm <= 0 || T % bm != 0 ||
      !chain_ok(chain_ops, chain_len, 0, true))
    return cudaErrorInvalidValue;
  GemmArgs g{};
  g.a = a; g.b = w; g.gid = gid; g.row_end = row_end; g.out = out;
  g.rep = rep;
  g.M = T; g.N = N; g.K = K; g.nb1 = 1;
  g.sam = sam; g.sak = sak; g.sb0 = swg; g.sbk = swk; g.sbn = swn;
  g.verify_step = verify_step; g.corrects = corrects; g.tau_coef = tau_coef;
  g.inj_enable = inj_enable; g.inj_batch = 0; g.inj_row = inj_row;
  g.inj_col = inj_col; g.inj_k = inj_k; g.inj_mag = inj_mag;
  g.seu = seu::Args{seu_on, seu_seed, seu_rate, seu_shift};
  g.chain_ops = chain_ops; g.chain_len = chain_len; g.chain_fold = 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_grouped_chain_ft<float>(ft, level, bm, layout, g, st);
  if (dtype == 1)
    return launch_grouped_chain_ft<__nv_bfloat16>(ft, level, bm, layout, g,
                                                  st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
