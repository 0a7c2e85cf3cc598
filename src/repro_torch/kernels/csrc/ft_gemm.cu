// ABFT GEMM for Hopper (sm_90a), SIMT: the instances of the kernel in
// csrc/ft_gemm_simt.cuh (whose note says what it replaces, what bounds it
// and how each FT level verifies) for the compiled epilogue chains, the
// training walks, the batched (K5) and grouped (K7) bodies, and their C
// entries. Every other chain runs on csrc/ft_gemm_chain.cu, built beside
// this source.
#include "ft_gemm_simt.cuh"

namespace {

using namespace abft;

// The tile (1) and inner (2) levels: the serving chains on the row-major
// walk, the plain chain on LAYOUT 1 and 2, the training chains with AG.
template <typename T, int LEVEL>
cudaError_t launch_level(int epi, int layout, bool ag, int tiles,
                         const GemmArgs& g, int batch, cudaStream_t st) {
  if (ag && layout == 0 && epi == kEpiSilu)
    return launch_tiles<T, true, kEpiSilu, 0, true, LEVEL>(tiles, g, batch,
                                                            st);
  if (ag && layout == 0 && epi == kEpiBiasSilu)
    return launch_tiles<T, true, kEpiBiasSilu, 0, true, LEVEL>(tiles, g,
                                                                batch, st);
  if (ag) return cudaErrorInvalidValue;
  if (layout == 1 && epi == kEpiNone)
    return launch_tiles<T, true, kEpiNone, 1, false, LEVEL>(tiles, g, batch,
                                                             st);
  if (layout == 2 && epi == kEpiNone)
    return launch_tiles<T, true, kEpiNone, 2, false, LEVEL>(tiles, g, batch,
                                                             st);
  if (layout != 0) return cudaErrorInvalidValue;
  switch (epi) {
    case kEpiNone:
      return launch_tiles<T, true, kEpiNone, 0, false, LEVEL>(tiles, g, batch,
                                                              st);
    case kEpiBias:
      return launch_tiles<T, true, kEpiBias, 0, false, LEVEL>(tiles, g, batch,
                                                              st);
    case kEpiSilu:
      return launch_tiles<T, true, kEpiSilu, 0, false, LEVEL>(tiles, g, batch,
                                                              st);
    case kEpiBiasSilu:
      return launch_tiles<T, true, kEpiBiasSilu, 0, false, LEVEL>(tiles, g,
                                                                  batch, st);
    default: return cudaErrorInvalidValue;
  }
}

// The training variants: a transposed operand (plain chain) or the
// act_grad output (chains with an activation).
template <typename T, bool FT>
cudaError_t launch_train(int epi, int layout, bool ag, int tiles,
                         const GemmArgs& g, int batch, cudaStream_t st) {
  if (!ag && epi == kEpiNone && layout == 1)
    return launch_tiles<T, FT, kEpiNone, 1>(tiles, g, batch, st);
  if (!ag && epi == kEpiNone && layout == 2)
    return launch_tiles<T, FT, kEpiNone, 2>(tiles, g, batch, st);
  if (!ag || layout != 0) return cudaErrorInvalidValue;
  switch (epi) {
    case kEpiSilu: return launch_tiles<T, FT, kEpiSilu, 0, true>(tiles, g, batch, st);
    case kEpiBiasSilu:
      return launch_tiles<T, FT, kEpiBiasSilu, 0, true>(tiles, g, batch, st);
    case kEpiGelu: return launch_tiles<T, FT, kEpiGelu, 0, true>(tiles, g, batch, st);
    case kEpiRelu: return launch_tiles<T, FT, kEpiRelu, 0, true>(tiles, g, batch, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, bool FT>
cudaError_t launch_epi(int epi, int layout, bool ag, int tiles,
                       const GemmArgs& g, int batch, cudaStream_t st) {
  if (layout != 0 || ag)
    return launch_train<T, FT>(epi, layout, ag, tiles, g, batch, st);
  switch (epi) {
    case kEpiNone: return launch_tiles<T, FT, kEpiNone>(tiles, g, batch, st);
    case kEpiBias: return launch_tiles<T, FT, kEpiBias>(tiles, g, batch, st);
    case kEpiSilu: return launch_tiles<T, FT, kEpiSilu>(tiles, g, batch, st);
    case kEpiBiasSilu:
      return launch_tiles<T, FT, kEpiBiasSilu>(tiles, g, batch, st);
    case kEpiGelu: return launch_tiles<T, FT, kEpiGelu>(tiles, g, batch, st);
    case kEpiRelu: return launch_tiles<T, FT, kEpiRelu>(tiles, g, batch, st);
    case kEpiResidual:
      return launch_tiles<T, FT, kEpiResidual>(tiles, g, batch, st);
    default: return cudaErrorInvalidValue;
  }
}

// Every instance of one operand type: FT off, or FT at `level`.
template <typename T>
cudaError_t launch_ft(int ft, int level, int epi, int layout, bool ag,
                      int tiles, const GemmArgs& g, int batch,
                      cudaStream_t st) {
  if (!ft) return launch_epi<T, false>(epi, layout, ag, tiles, g, batch, st);
  switch (level) {
    case kLevelBlock:
      return launch_epi<T, true>(epi, layout, ag, tiles, g, batch, st);
    case kLevelTile:
      return launch_level<T, kLevelTile>(epi, layout, ag, tiles, g, batch, st);
    case kLevelInner:
      return launch_level<T, kLevelInner>(epi, layout, ag, tiles, g, batch,
                                          st);
    default: return cudaErrorInvalidValue;
  }
}

// K7: the grouped instances, by row tile (BM) and the walk of B's loads.
// kernels/grouped_gemm.py:GROUPED_TILES lists the same tiles.
template <typename T, bool FT, int LEVEL>
cudaError_t launch_grouped(int bm, int layout, const GemmArgs& g,
                           cudaStream_t st) {
  if (bm == 16 && layout == 0)
    return launch<T, FT, kEpiNone, 0, false, 16, 128, 32, 2, 4, true, LEVEL>(
        g, 1, st);
  if (bm == 16 && layout == 1)
    return launch<T, FT, kEpiNone, 1, false, 16, 128, 32, 2, 4, true, LEVEL>(
        g, 1, st);
  if constexpr (sizeof(T) == 4) {
    if (bm == 8 && layout == 0)
      return launch<T, FT, kEpiNone, 0, false, 8, 128, 32, 1, 4, true, LEVEL>(
          g, 1, st);
    if (bm == 8 && layout == 1)
      return launch<T, FT, kEpiNone, 1, false, 8, 128, 32, 1, 4, true, LEVEL>(
          g, 1, st);
  }
  return cudaErrorInvalidValue;
}

// Every grouped instance of one operand type: FT off, or FT at `level`.
template <typename T>
cudaError_t launch_grouped_ft(int ft, int level, int bm, int layout,
                              const GemmArgs& g, cudaStream_t st) {
  if (!ft) return launch_grouped<T, false, kLevelBlock>(bm, layout, g, st);
  switch (level) {
    case kLevelBlock:
      return launch_grouped<T, true, kLevelBlock>(bm, layout, g, st);
    case kLevelTile:
      return launch_grouped<T, true, kLevelTile>(bm, layout, g, st);
    case kLevelInner:
      return launch_grouped<T, true, kLevelInner>(bm, layout, g, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* ft_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// A (nb0, nb1, M, K) and B (nb0, nb1, K, N) with the element strides
// sa0..sak and sb0..sbn (sb0 = sb1 = 0: one B shared by every slice); out
// (nb0, nb1, M, N) and report (nb0, nb1, gm, gn, 8) contiguous row-major.
// bias (N,) and residual (M, N), contiguous, only with one slice. act_grad:
// nullptr, or (nb0, nb1, M, N) contiguous for a chain with an activation.
// dtype: 0 f32, 1 bf16. level: the FT Level (with ft = 1). epi: the
// Epilogue code. layout: the LAYOUT of the tile loads (1 and 2 with epi 0
// only). seu_*: the stochastic hook's campaign (seu_hook.cuh). Returns the
// launch's cudaError_t.
int ft_gemm_launch(const void* a, const void* b, const void* bias,
                   const void* res, void* out, float* rep, void* act_grad,
                   int nb0, int nb1,
                   int M, int N, int K, long long sa0, long long sa1, int sam,
                   int sak, long long sb0, long long sb1, int sbk, int sbn,
                   int dtype, int ft, int level,
                   int epi, int tiles, int layout, int verify_step,
                   int corrects,
                   float tau_coef, int inj_enable, int inj_batch, int inj_row,
                   int inj_col, int inj_k, float inj_mag, int seu_on,
                   unsigned seu_seed, float seu_rate, int seu_shift,
                   void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || nb0 <= 0 || nb1 <= 0)
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool ag = act_grad != nullptr;
  if (dtype == 0)
    return launch_ft<float>(ft, level, epi, layout, ag, tiles, g, batch, st);
  if (dtype == 1)
    return launch_ft<__nv_bfloat16>(ft, level, epi, layout, ag, tiles, g,
                                    batch, st);
  return cudaErrorInvalidValue;
}

// K7. a: the (T, K) group-sorted buffer with element strides (sam, sak);
// w: (G, K, N) with strides (swg, swk, swn); gid: int32 (T / bm,) the group
// of each row tile; row_end: int32 (G,). out (T, N) and report
// (T / bm, gn, 8) contiguous row-major. The injection row is a buffer row.
// dtype: 0 f32, 1 bf16. level: the FT Level (with ft = 1). layout: 1 when
// w's k stride is 1. Returns the launch's cudaError_t.
int ft_gemm_grouped_launch(const void* a, const void* w, const int* gid,
                           const int* row_end, void* out, float* rep, int T,
                           int N, int K, int G, int sam, int sak,
                           long long swg, int swk, int swn, int dtype,
                           int ft, int level, int bm, int layout,
                           int verify_step,
                           int corrects, float tau_coef, int inj_enable,
                           int inj_row, int inj_col, int inj_k,
                           float inj_mag, int seu_on, unsigned seu_seed,
                           float seu_rate, int seu_shift, void* stream) {
  if (T <= 0 || N <= 0 || K <= 0 || G <= 0 || bm <= 0 || T % bm != 0)
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_grouped_ft<float>(ft, level, bm, layout, g, st);
  if (dtype == 1)
    return launch_grouped_ft<__nv_bfloat16>(ft, level, bm, layout, g, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
