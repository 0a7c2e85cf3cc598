// Naive GEMM for Hopper (sm_90a): C = A·B with one thread per output
// element, the bottom rung of the paper's step-wise GEMM ladder (§3.1.1).
//
// Replaces the TPU kernel K9 of the JAX package:
//   src/repro/kernels/gemm.py:61 naive_gemm (body gemm.py:71), one program
//   per (<=128) x (<=128) output block over all of K, no k-tiling.
// On this card the rung is the textbook naive kernel: a 32 x 8 thread block
// covers 8 rows x 32 columns of C; each thread reads its row of A and its
// column of B straight from device memory and accumulates in f32 over all
// of K. No shared memory, no k-tiling, no register tile: neighbouring
// threads read neighbouring columns of B (coalesced) and one broadcast
// element of A. C is written in the operands' dtype (f32 or bf16).
// What bounds it on the H100: it is meant to be slow. Every multiply-add
// loads one element of A and one of B through L1/L2, so it runs at the
// caches' rate, far below both the f32 CUDA-core peak and the bytes bound;
// PERF.md carries its times beside K1 and the library's.
#include "abft_block.cuh"

namespace {

using abft::store;
using abft::to_f32;

template <typename T>
__global__ void naive_gemm_kernel(const T* __restrict__ a,
                                  const T* __restrict__ b, T* __restrict__ c,
                                  int M, int N, int K) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (row >= M || col >= N) return;
  const T* ar = a + (long long)row * K;
  float acc = 0.0f;
  for (int k = 0; k < K; ++k)
    acc = fmaf(to_f32(ar[k]), to_f32(b[(long long)k * N + col]), acc);
  store(&c[(long long)row * N + col], acc);
}

template <typename T>
cudaError_t launch(const void* a, const void* b, void* c, int M, int N,
                   int K, cudaStream_t st) {
  const dim3 block(32, 8);
  const dim3 grid((N + 31) / 32, (M + 7) / 8);
  if (grid.y > 65535) return cudaErrorInvalidConfiguration;
  naive_gemm_kernel<T><<<grid, block, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gemm_naive_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// a (M, K), b (K, N) and c (M, N), contiguous row-major, of one dtype:
// 0 f32, 1 bf16. Returns the launch's cudaError_t.
int gemm_naive_launch(const void* a, const void* b, void* c, int M, int N,
                      int K, int dtype, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, c, M, N, K, st);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, c, M, N, K, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
