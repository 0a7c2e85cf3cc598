// The pieces of the Hopper ABFT mainloop shared by csrc/ft_gemm_sm90.cuh
// (K1) and csrc/grouped_sm90.cu (K7, K8): the PTX wrappers (mbarrier, TMA,
// wgmma), the checksum operators that read the 128-byte-swizzled staged
// tiles (RowOp for a tile whose k dim is contiguous, ColOp for one whose
// m or n dim is), the tile level's per-band column checksums on the tensor
// cores (BandOp), the verification of the wgmma accumulator against the
// running checksums (verify_acc, and verify_bands band by band), the bf16
// epilogue through shared memory,
// and the host's tensor-map encoding through cudaGetDriverEntryPoint (no
// -lcuda). What each kernel does with them is in the note at the head of
// its source.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "abft_block.cuh"

namespace {

using abft::kFull;
using abft::Verdict;

constexpr int kBN = 128;                 // CTA tile width
constexpr int kStageK = 64;              // ring stage depth: one 128-byte row
constexpr int kStep = 256;               // k-step = verification interval
constexpr int kStagesPerStep = kStep / kStageK;
constexpr int kStages = 4;               // ring depth
constexpr int kBoxBytes = 64 * 128;      // one 64 x 64 bf16 box, 8 KB
constexpr int kSlots = 16;               // partial slots of a checksum

// The FT level of a tensor-core instance (template parameter LV): FT off,
// the threadblock ("block"), warp ("tile") and thread ("inner") levels.
constexpr int kLvOff = 0, kLvBlock = 1, kLvTile = 2, kLvInner = 3;

// ---------------------------------------------------------------------------
// PTX wrappers: mbarrier, TMA, wgmma, named barrier
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint64_t* bar, int parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the phase of `parity` to complete. A ring that does not fill
// within two seconds (a fault in the copy) stops the kernel with a trap
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint64_t t0 = 0;
  while (!mbar_try(bar, parity)) {
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (t0 == 0) t0 = now;
    else if (now - t0 > 2000000000ull) __trap();
  }
}

// 2-D TMA load of one box at element coordinates (c0 inner, c1 outer).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// 3-D TMA load of one box at element coordinates (c0 inner, c1, c2 outer):
// the grouped kernels' expert weights, c2 the group.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_u32(bar))
      : "memory");
}

// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operand: 8-row
// groups 1024 bytes apart (SBO); MN-major: 8-row k groups 1024 bytes apart
// (SBO) and 64-element MN atoms `lbo` bytes apart (LBO).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((1024 >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across an
// asynchronous wgmma boundary.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64x128, f32) += A(64x16) · B(16x128), bf16 operands in shared memory.
// TA = 1: A is M-major; TB = 1: B is N-major (row-major (K, N)).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, 1, 1, 1, %66, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "n"(TA), "n"(TB));
}

// D(64x64, f32) += A(64x16) · B(16x64), bf16 operands in shared memory
// (the flash backward's S and dP tiles, csrc/flash_bwd_sm90.cu).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db) {
  asm volatile(
      "{\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, 1, 1, 1, %34, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "n"(TA), "n"(TB));
}

// Barrier of the NT consumer threads (the producer warpgroup never joins).
template <int NT>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(NT) : "memory");
}

// D(16 x 8, f32) += A(16 x 16, bf16, row-major) · B(16 x 8, bf16).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory (lane l gives the address of
// row l % 8 of matrix l / 8), transposed with TRANS.
template <bool TRANS>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  if constexpr (TRANS)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(addr));
}

// ---------------------------------------------------------------------------
// epilogue ops (the formulas of csrc/ft_gemm.cu and templates/epilogues.py)
// ---------------------------------------------------------------------------

// act: 0 none, 1 silu, 2 gelu (the tanh approximation), 3 relu
// (kernels/ft_gemm.py:SM90_ACTS).
__device__ __forceinline__ float activate(int act, float y) {
  if (act == 1) return y * (1.0f / (1.0f + expf(-y)));
  if (act == 2) {
    const float c = 0.7978845608028654f;  // sqrt(2/pi)
    return 0.5f * y * (1.0f + tanhf(c * (y + 0.044715f * y * y * y)));
  }
  if (act == 3) return fmaxf(y, 0.0f);
  return y;
}

// The activation's derivative: relu's is 1 where y > 0, else 0.
__device__ __forceinline__ float activate_grad(int act, float y) {
  if (act == 1) {
    const float s = 1.0f / (1.0f + expf(-y));
    return s * (1.0f + y * (1.0f - s));
  }
  if (act == 2) {
    const float c = 0.7978845608028654f;
    const float t = tanhf(c * (y + 0.044715f * y * y * y));
    const float du = c * (1.0f + 3.0f * 0.044715f * y * y);
    return 0.5f * (1.0f + t) + 0.5f * y * (1.0f - t * t) * du;
  }
  if (act == 3) return y > 0.0f ? 1.0f : 0.0f;
  return 1.0f;
}

// A runtime chain of len activations (K5's and K7's aux-free chains), op i
// in bits 3i..3i+2 of ops as kernels/ft_gemm.py:CHAIN_OPS codes them (3
// silu, 4 gelu, 5 relu: the act codes above plus 2), applied in order.
__device__ __forceinline__ float activate_chain(int ops, int len, float y) {
  for (int i = 0; i < len; ++i) y = activate(((ops >> (3 * i)) & 7) - 2, y);
  return y;
}

// Whether (ops, len) is such a chain: at most 10 ops (3 bits an op in an
// int32), each an activation.
inline bool activation_chain_ok(int ops, int len) {
  if (len < 0 || len > 10) return false;
  for (int i = 0; i < len; ++i) {
    const int op = (ops >> (3 * i)) & 7;
    if (op < 3 || op > 5) return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// checksums from the staged tiles
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint4 lds128(const uint8_t* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// The 8 bf16 of a 16-byte chunk, widened exactly to f32. The shifts are
// volatile so the second pass over a chunk widens it again: the 16-byte
// chunks stay live across the stage barrier packed, not as 8 floats each.
__device__ __forceinline__ void unpack8(const uint4& c, float (&f)[8]) {
  const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t lo, hi;
    asm volatile("shl.b32 %0, %2, 16;\n\tand.b32 %1, %2, 0xffff0000;\n"
                 : "=r"(lo), "=r"(hi)
                 : "r"(w[i]));
    f[2 * i] = __uint_as_float(lo);
    f[2 * i + 1] = __uint_as_float(hi);
  }
}

// Sum each of V values over the lanes that differ in the lane bits OFF,
// OFF/2, ..., B (a transposing reduction): while more than one value is
// left, each step sends half of them to the partner lane and keeps the
// other half. On return v[0 .. max(V / L, 1)) hold the sums of the values
// whose indices start at `base`, L = 2·OFF / B being the lanes summed over.
template <int V, int OFF, int B>
struct XRed {
  static __device__ __forceinline__ void run(float* v, int lane, int& base) {
    if constexpr (OFF >= B) {
      if constexpr (V > 1) {
        const bool up = lane & OFF;
#pragma unroll
        for (int i = 0; i < V / 2; ++i) {
          const float send = up ? v[i] : v[i + V / 2];
          const float keep = up ? v[i + V / 2] : v[i];
          v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
        }
        if (up) base += V / 2;
        XRed<V / 2, OFF / 2, B>::run(v, lane, base);
      } else {
        v[0] += __shfl_xor_sync(kFull, v[0], OFF);
        XRed<1, OFF / 2, B>::run(v, lane, base);
      }
    }
  }
};

template <int V, int L, int B>
__device__ __forceinline__ int xreduce(float (&v)[V], int lane) {
  int base = 0;
  XRed<V, B * L / 2, B>::run(v, lane, base);
  return base;
}

// A stage tile whose k dim is contiguous: one box of X rows (m of A, or n
// of a transposed B) x 64 k, row r's 16-byte chunk c at r·128 + ((c ^ (r %
// 8)) · 16). Consumer warp w reads the chunk columns c = w + W·i and lane l
// the rows l + 32·j, so a quarter warp hits 8 distinct bank groups.
// ksum: the stage's sum over the X rows of each k (e^T A_s or B_s e);
// dot: xd[row] += Σ_k T[row][k]·other[k], the running checksum partial
// (A_s·(B_s e) or ((e^T A_s)·B_s)ᵀ) of the rows this thread reads.
template <int X, int NT>
struct RowOp {
  static constexpr int W = NT / 32, CI = 8 / W, RJ = X / 32, SLOTS = W;
  static_assert(CI >= 1 && RJ >= 1, "row-op geometry");
  uint4 ch[CI * RJ];
  float xd[RJ];
  float mx;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < RJ; ++j) xd[j] = 0.0f;
    mx = 0.0f;
  }
  __device__ __forceinline__ void load(const uint8_t* base, int tid) {
    const int warp = tid / 32, lane = tid & 31;
#pragma unroll
    for (int i = 0; i < CI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int r = lane + 32 * j, c = warp + W * i;
        ch[i * RJ + j] = lds128(base + r * 128 + ((c ^ (r & 7)) << 4));
      }
  }
  __device__ __forceinline__ void ksum(float* ks, int tid) {
    const int warp = tid / 32, lane = tid & 31;
#pragma unroll
    for (int i = 0; i < CI; ++i) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = 0.0f;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        float f[8];
        unpack8(ch[i * RJ + j], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          v[e] += f[e];
          mx = fmaxf(mx, fabsf(f[e]));
        }
      }
      const int base = xreduce<8, 32, 1>(v, lane);
      if ((lane & 3) == 0) ks[(warp + W * i) * 8 + base] = v[0];
    }
  }
  __device__ __forceinline__ void dot(const float* other, int tid) {
    const int warp = tid / 32;
#pragma unroll
    for (int i = 0; i < CI; ++i) {
      float o[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) o[e] = other[(warp + W * i) * 8 + e];
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        float f[8];
        unpack8(ch[i * RJ + j], f);
#pragma unroll
        for (int e = 0; e < 8; ++e) xd[j] = fmaf(f[e], o[e], xd[j]);
      }
    }
  }
  // part[SLOTS][X]: this thread's running partial of each of its rows.
  __device__ __forceinline__ void partials(float* part, int tid) const {
    const int warp = tid / 32, lane = tid & 31;
#pragma unroll
    for (int j = 0; j < RJ; ++j) part[warp * X + lane + 32 * j] = xd[j];
  }
  // The stage's sums over each 16-row band of the X rows, band-major in
  // bks[X / 16][64] (the tile level's e_b^T A_s): row lane + 32j lies in
  // band 2j + lane / 16, so a transposing sum over each half warp.
  __device__ __forceinline__ void band_ksum(float* bks, int tid) const {
    const int warp = tid / 32, lane = tid & 31;
#pragma unroll
    for (int i = 0; i < CI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        float v[8];
        unpack8(ch[i * RJ + j], v);
        const int base = xreduce<8, 16, 1>(v, lane);
        if ((lane & 1) == 0)
          bks[(2 * j + lane / 16) * 64 + (warp + W * i) * 8 + base] = v[0];
      }
  }
  // Zero the running partials, keep the maxima (the inner level's per-step
  // checksums).
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int j = 0; j < RJ; ++j) xd[j] = 0.0f;
  }
};

// A stage tile whose X dim is contiguous (m of a transposed A, or n of a
// row-major B): X / 64 boxes of 64 k x 64, element (k, x) in box x / 64 at
// k·128 + (((x % 64) / 8 ^ k % 8) · 16). Thread t reads the x chunk
// q = t % Q at the k rows g + G·j (g = t / Q), so the Q lanes sharing g
// form one transposing reduction for the stage's k sums.
template <int X, int NT>
struct ColOp {
  static constexpr int Q = X / 8, G = NT / Q, P = 64 / G, SLOTS = G;
  static_assert(P >= 1 && P <= Q && Q <= 32 && G <= kSlots, "col-op geometry");
  uint4 ch[P];
  float xd[8];
  float mx;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int e = 0; e < 8; ++e) xd[e] = 0.0f;
    mx = 0.0f;
  }
  __device__ __forceinline__ void load(const uint8_t* base, int tid) {
    const int q = tid % Q, g = tid / Q, b = q / 8, c = q % 8;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int p = g + G * j;
      ch[j] = lds128(base + b * kBoxBytes + p * 128 + ((c ^ (p & 7)) << 4));
    }
  }
  __device__ __forceinline__ void ksum(float* ks, int tid) {
    const int g = tid / Q, lane = tid & 31;
    float v[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float f[8];
      unpack8(ch[j], f);
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += f[e];
        mx = fmaxf(mx, fabsf(f[e]));
      }
      v[j] = s;
    }
    const int base = xreduce<P, Q, 1>(v, lane);
    if ((lane & (Q / P - 1)) == 0) ks[g + G * base] = v[0];
  }
  __device__ __forceinline__ void dot(const float* other, int tid) {
    const int g = tid / Q;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const float o = other[g + G * j];
      float f[8];
      unpack8(ch[j], f);
#pragma unroll
      for (int e = 0; e < 8; ++e) xd[e] = fmaf(f[e], o, xd[e]);
    }
  }
  __device__ __forceinline__ void partials(float* part, int tid) const {
    const int q = tid % Q, g = tid / Q;
#pragma unroll
    for (int e = 0; e < 8; ++e) part[g * X + q * 8 + e] = xd[e];
  }
  // The stage's sums over each 16-row band (two 8-row chunks q) of the X
  // rows, band-major in bks[X / 16][64].
  __device__ __forceinline__ void band_ksum(float* bks, int tid) const {
    const int q = tid % Q, g = tid / Q;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      float f[8];
      unpack8(ch[j], f);
      float s = 0.0f;
#pragma unroll
      for (int e = 0; e < 8; ++e) s += f[e];
      s += __shfl_xor_sync(kFull, s, 1);   // chunks 2b, 2b + 1: lanes l, l ^ 1
      if ((q & 1) == 0) bks[(q / 2) * 64 + g + G * j] = s;
    }
  }
  __device__ __forceinline__ void reset() {
#pragma unroll
    for (int e = 0; e < 8; ++e) xd[e] = 0.0f;
  }
};

// The tile level's per-band running column checksums, (e_b^T A_s)·B_s of
// each 16-row band b, as a small product on the tensor cores beside the
// stage's wgmmas: ckᵀ (128 n x 8 band slots) += B_sᵀ (the staged 64 x 128
// B tile, read by ldmatrix through its 128-byte swizzle: transposed for a
// row-major B, as it is for the k-major one) · Sᵀ (the stage's band sums
// bks[8][64]), m16n8k16 `mma.sync` in f32. S enters the tensor cores as
// three bf16 parts (hi, mid, lo: 24 bits of its f32 mantissa), so the
// checksum keeps f32's precision for tau; the B tile is bf16 already. Warp
// w takes the 16-column n-tiles w, w + W, ...; the product costs 3 x 2 048
// MACs per warp and k16 (a fifth of the stage's wgmma work at BM 128) and
// no CUDA-core FMA.
template <int NT, bool BK>
struct BandOp {
  static constexpr int W = NT / 32, TILES = 8 / W;
  static_assert(TILES >= 1 && TILES * W == 8, "band-op geometry");
  float c[TILES][4];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int t = 0; t < TILES; ++t)
#pragma unroll
      for (int r = 0; r < 4; ++r) c[t][r] = 0.0f;
  }
  __device__ __forceinline__ void dot(const uint8_t* pb, const float* bks,
                                      int tid) {
    const int warp = tid / 32, lane = tid & 31;
    const int j = lane & 7, mtx = lane >> 3;
    const uint32_t base = smem_u32(pb);
#pragma unroll
    for (int kk = 0; kk < kStageK / 16; ++kk) {
      // B fragment: S[band = lane / 4][k0, k0 + 1, k0 + 8, k0 + 9], split.
      const int k0 = kk * 16 + (lane & 3) * 2;
      const float* sb = bks + (lane >> 2) * 64 + k0;
      float r[4] = {sb[0], sb[1], sb[8], sb[9]};
      uint32_t b[3][2];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        __nv_bfloat16 h[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          h[e] = __float2bfloat16_rn(r[e]);
          r[e] -= __bfloat162float(h[e]);
        }
        b[p][0] = (uint32_t)__bfloat16_as_ushort(h[0]) |
                  ((uint32_t)__bfloat16_as_ushort(h[1]) << 16);
        b[p][1] = (uint32_t)__bfloat16_as_ushort(h[2]) |
                  ((uint32_t)__bfloat16_as_ushort(h[3]) << 16);
      }
#pragma unroll
      for (int t = 0; t < TILES; ++t) {
        const int n0 = (warp + W * t) * 16;
        uint32_t a[4];
        if constexpr (BK) {   // [n][k] rows of 128 bytes
          const int n = n0 + j + 8 * (mtx & 1), kc = kk * 2 + (mtx >> 1);
          ldsm4<false>(a, base + n * 128 + ((kc ^ (n & 7)) << 4));
        } else {              // [k][n] in boxes of 64 n
          const int k = kk * 16 + j + 8 * (mtx >> 1), n = n0 + 8 * (mtx & 1);
          ldsm4<true>(a, base + (n / 64) * kBoxBytes + k * 128 +
                             ((((n % 64) / 8) ^ (k & 7)) << 4));
        }
#pragma unroll
        for (int p = 0; p < 3; ++p) mma16816(c[t], a, b[p][0], b[p][1]);
      }
    }
  }
  // ck[8][kBN]: this thread's entries of the band checksums.
  __device__ __forceinline__ void store(float* ck, int tid) const {
    const int warp = tid / 32, lane = tid & 31;
    const int bd = (lane & 3) * 2;
#pragma unroll
    for (int t = 0; t < TILES; ++t) {
      const int n = (warp + W * t) * 16 + lane / 4;
      ck[bd * kBN + n] = c[t][0];
      ck[(bd + 1) * kBN + n] = c[t][1];
      ck[bd * kBN + n + 8] = c[t][2];
      ck[(bd + 1) * kBN + n + 8] = c[t][3];
    }
  }
};

template <int BM>
struct Scratch {
  uint64_t full[kStages], empty[kStages];
  float ks[2][2][64];          // [stage parity][A, B]: e^T A_s, B_s e
  float partA[kSlots][BM];     // running row-checksum partials
  float partB[kSlots][kBN];    // running column-checksum partials
  float colp[BM / 16][kBN];    // accumulator column sums by consumer warp
  float rowsum[BM];
  float dcol[kBN], drow[BM];
  float biasv[kBN];
  float red[BM / 16][2];
  float wbest[(kBN + BM) / 32];   // per-warp first argmax of |dcol|, |drow|
  int widx[(kBN + BM) / 32];
  Verdict verdict;
  float rep[8];
};

// The band-wise verification's scratch (after Scratch<BM> in shared
// memory): the stages' band sums, the band checksums and residuals, the
// inner level's sums of the accumulator at the step before, the bands'
// located residuals, verdicts and (K7) reports. 8 band slots: BM / 16
// live, the rest zero.
struct BandScratch {
  float ks[2][8][64];          // [stage parity][band][k]: e_b^T A_s
  float ck[8][kBN];            // band column checksums
  float dcol[8][kBN];          // band column residuals
  float prevc[8][kBN];         // inner: band column sums at the step before
  float prevr[128];            // inner: row sums at the step before
  float best[8][2];
  int idx[8][2];
  Verdict verdict[8];
  float rep[8][8];             // K7: each band's report
};

template <int BM>
constexpr int smem_bytes() {
  return 1024 + kStages * (BM * kStageK * 2 + kBN * kStageK * 2) +
         (int)sizeof(Scratch<BM>);
}

// Adds v to the accumulator element at (row, col) of the CTA tile, in the
// thread whose wgmma fragment holds it (branchless in the register file).
// v passes through a volatile move, so the 64 selects are made where the
// addition happens and not hoisted out of the k loop (64 values that would
// live in local memory).
__device__ __forceinline__ void add_at(float (&acc)[64], int row, int col,
                                       float v_in, int tid) {
  float v;
  asm volatile("mov.b32 %0, %1;\n" : "=f"(v) : "f"(v_in));
  const int wg = tid / 128, wl = (tid % 128) / 32, lane = tid & 31;
  const int rr = row % 16;
  const bool mine = row / 64 == wg && (row % 64) / 16 == wl &&
                    lane == (rr % 8) * 4 + (col % 8) / 2;
  const int idx = (col / 8) * 4 + (rr / 8) * 2 + (col % 2);
#pragma unroll
  for (int r = 0; r < 64; ++r) acc[r] += (mine && r == idx) ? v : 0.0f;
}

// The accumulator element at (row, col) of the CTA tile in the thread whose
// wgmma fragment holds it, 0 in the others (add_at's selects).
__device__ __forceinline__ float get_at(const float (&acc)[64], int row,
                                        int col, int tid) {
  const int wg = tid / 128, wl = (tid % 128) / 32, lane = tid & 31;
  const int rr = row % 16;
  const bool mine = row / 64 == wg && (row % 64) / 16 == wl &&
                    lane == (rr % 8) * 4 + (col % 8) / 2;
  const int idx = (col / 8) * 4 + (rr / 8) * 2 + (col % 2);
  float v = 0.0f;
#pragma unroll
  for (int r = 0; r < 64; ++r) v = (mine && r == idx) ? acc[r] : v;
  return v;
}

// The checksum entries a consumer thread finishes: columns [0, 128) go to
// threads [0, 128) and rows [0, BM) to the threads after them, or to
// threads [0, BM) after their column when there are not enough threads.
template <int BM, int NT>
struct Owner {
  static constexpr bool SPLIT = NT >= kBN + BM;
  __device__ static int col(int tid) { return tid < kBN ? tid : -1; }
  __device__ static int row(int tid) {
    if (SPLIT) return tid >= kBN && tid < kBN + BM ? tid - kBN : -1;
    return tid < BM ? tid : -1;
  }
};

// The checksums of the block: the threads' partials summed, plus the
// linear prefix's fold (with `fold`: the bias on every tile row). Leaves
// colck in sc.dcol and rowck in sc.drow (each entry written by the thread
// that finishes it, `Owner`) and returns the block's max|A|, max|B|.
template <int BM, int NT, typename OpA, typename OpB>
__device__ __forceinline__ void reduce_checks(const OpA& opa, const OpB& opb,
                                              Scratch<BM>& sc, int tid,
                                              bool fold, float& am,
                                              float& bm) {
  const int warp = tid / 32, lane = tid & 31;
  opa.partials(&sc.partA[0][0], tid);
  opb.partials(&sc.partB[0][0], tid);
  float ma = opa.mx, mb = opb.mx;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    ma = fmaxf(ma, __shfl_xor_sync(kFull, ma, off));
    mb = fmaxf(mb, __shfl_xor_sync(kFull, mb, off));
  }
  if (lane == 0) {
    sc.red[warp][0] = ma;
    sc.red[warp][1] = mb;
  }
  consumer_sync<NT>();
  am = 0.0f;
  bm = 0.0f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    am = fmaxf(am, sc.red[w][0]);
    bm = fmaxf(bm, sc.red[w][1]);
  }
  const int n = Owner<BM, NT>::col(tid), m = Owner<BM, NT>::row(tid);
  if (n >= 0) {
    float c = 0.0f;
#pragma unroll
    for (int s = 0; s < OpB::SLOTS; ++s) c += sc.partB[s][n];
    if (fold) c += (float)BM * sc.biasv[n];
    sc.dcol[n] = c;
  }
  if (m >= 0) {
    float c = 0.0f;
#pragma unroll
    for (int s = 0; s < OpA::SLOTS; ++s) c += sc.partA[s][m];
    if (fold)
      for (int q = 0; q < kBN; ++q) c += sc.biasv[q];
    sc.drow[m] = c;
  }
}

// First argmax of |v| over the 32 lanes of a warp (ties to the lower index,
// like jnp.argmax): every lane ends with (best, idx).
__device__ __forceinline__ void warp_argmax(float v, int i, float& best,
                                            int& idx) {
  best = fabsf(v);
  idx = i;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ob = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    if (ob > best || (ob == best && oi < idx)) {
      best = ob;
      idx = oi;
    }
  }
}

// The accumulator's column sums over each warp's 16 rows (sc.colp[warp])
// and its row sums (sc.rowsum), from the wgmma fragment with warp
// shuffles; the caller synchronises before reading another warp's.
template <int BM>
__device__ __forceinline__ void frag_sums(const float (&acc)[64],
                                          Scratch<BM>& sc, int tid) {
  const int warp = tid / 32, lane = tid & 31;
  float cs[32];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      cs[2 * j + e] = acc[4 * j + e] + acc[4 * j + 2 + e];
  const int base = xreduce<32, 8, 4>(cs, lane);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int ci = base + q;
    sc.colp[warp][8 * (ci / 2) + 2 * (lane & 3) + (ci & 1)] = cs[q];
  }
  float r0 = 0.0f, r1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      r0 += acc[4 * j + e];
      r1 += acc[4 * j + 2 + e];
    }
  r0 += __shfl_xor_sync(kFull, r0, 1);
  r0 += __shfl_xor_sync(kFull, r0, 2);
  r1 += __shfl_xor_sync(kFull, r1, 1);
  r1 += __shfl_xor_sync(kFull, r1, 2);
  if ((lane & 3) == 0) {
    const int m = warp * 16 + lane / 4;
    sc.rowsum[m] = r0;
    sc.rowsum[m + 8] = r1;
  }
}

// Verify the accumulator against the running checksums at k_el elapsed:
// residuals from the fragment's column and row sums, first-argmax locate
// (per warp by shuffles, then across warps in index order), abft::record
// into sc.rep, and the branchless correction. With DELTA (the inner
// level) the accumulator's column and row sums at the step before (prevc,
// prevr) are taken off first, so what is verified is the step's Δ against
// the step's own checksums; they are then set to the sums after the
// correction, so an SEU left in place cancels out of the next step's Δ.
template <int BM, int NT, bool DELTA = false, typename OpA, typename OpB,
          typename Args>
__device__ __forceinline__ void verify_acc(float (&acc)[64], const OpA& opa,
                                           const OpB& opb, Scratch<BM>& sc,
                                           const Args& g, int tid,
                                           int row0, int col0, float k_el,
                                           bool fold, float* prevc = nullptr,
                                           float* prevr = nullptr) {
  const int warp = tid / 32, lane = tid & 31;
  float am, bm;
  reduce_checks<BM, NT>(opa, opb, sc, tid, fold, am, bm);
  frag_sums<BM>(acc, sc, tid);
  consumer_sync<NT>();
  // Residuals, each by the thread that owns its checksum entry, and each
  // warp's first argmax of them. Warps [0, 4) own the columns; the row
  // warps follow (at NT 128 the same warps take the rows after the
  // columns).
  const int n = Owner<BM, NT>::col(tid), m = Owner<BM, NT>::row(tid);
  float best;
  int idx;
  float s = 0.0f;
  if (warp < kBN / 32) {
#pragma unroll
    for (int w = 0; w < NT / 32; ++w) s += sc.colp[w][n];
    const float d = s - (DELTA ? prevc[n] : 0.0f) - sc.dcol[n];
    sc.dcol[n] = d;
    warp_argmax(d, n, best, idx);
    if (lane == 0) {
      sc.wbest[warp] = best;
      sc.widx[warp] = idx;
    }
  }
  if (Owner<BM, NT>::SPLIT ? (warp >= kBN / 32 && warp < (kBN + BM) / 32)
                           : warp < BM / 32) {
    const float d = sc.rowsum[m] - (DELTA ? prevr[m] : 0.0f) - sc.drow[m];
    sc.drow[m] = d;
    warp_argmax(d, m, best, idx);
    if (lane == 0) {
      sc.wbest[kBN / 32 + m / 32] = best;
      sc.widx[kBN / 32 + m / 32] = idx;
    }
  }
  consumer_sync<NT>();
  if (tid == 0) {
    float bc = sc.wbest[0], br = sc.wbest[kBN / 32];
    int ic = sc.widx[0], ir = sc.widx[kBN / 32];
    for (int w = 1; w < kBN / 32; ++w)
      if (sc.wbest[w] > bc) { bc = sc.wbest[w]; ic = sc.widx[w]; }
    for (int w = 1; w < BM / 32; ++w)
      if (sc.wbest[kBN / 32 + w] > br) {
        br = sc.wbest[kBN / 32 + w];
        ir = sc.widx[kBN / 32 + w];
      }
    const float tau = fmaxf(g.tau_coef * k_el * am * bm, 1e-30f);
    sc.verdict = abft::record(sc.dcol, bc, ic, br, ir, tau, k_el,
                              g.corrects, row0, col0, sc.rep);
  }
  consumer_sync<NT>();
  const Verdict v = sc.verdict;
  const bool fix = g.corrects && v.det;
  if (fix) add_at(acc, v.row, v.col, -v.mag, tid);
  if constexpr (DELTA) {
    // The sums the next step's Δ is taken against: after a correction,
    // those of the corrected accumulator itself (the sums before it less
    // the magnitude round otherwise, and a later step would see that as a
    // residual).
    if (fix) {
      frag_sums<BM>(acc, sc, tid);
      consumer_sync<NT>();
      s = 0.0f;
#pragma unroll
      for (int w = 0; w < NT / 32; ++w) s += sc.colp[w][n < 0 ? 0 : n];
    }
    if (warp < kBN / 32) prevc[n] = s;
    if (Owner<BM, NT>::SPLIT ? (warp >= kBN / 32 && warp < (kBN + BM) / 32)
                             : warp < BM / 32)
      prevr[m] = sc.rowsum[m];
  }
  __syncwarp();
}

// Verify each 16-row band of the accumulator on its own at k_el elapsed
// (the tile level; K7 under a campaign): warp w's band (rows 16w ..), its
// column sums against the band's column checksum (bx.ck, from BandOp) and
// its rows' sums against the row checksums, the block's tau, the first
// argmax of each. With DELTA (K7's inner level) the band's sums at the
// step before are taken off first and reset after the correction, as in
// verify_acc. OWN_REP: each band records into its own report bx.rep[w]
// (K7's report row per layout tile); else thread 0 records the bands in
// band order into sc.rep (K1's one report per block: det and corr add,
// row / col / mag are the last detecting band's, the rule of
// kernels/ft_gemm.py:locate_bands). The thread that holds the located
// element subtracts the magnitude: one correction per band.
template <int BM, int NT, bool OWN_REP, bool DELTA, typename OpA,
          typename OpB, typename OpC, typename Args>
__device__ __forceinline__ void verify_bands(float (&acc)[64], const OpA& opa,
                                             const OpB& opb, const OpC& opc,
                                             Scratch<BM>& sc, BandScratch& bx,
                                             const Args& g, int tid, int row0,
                                             int col0, float k_el) {
  static_assert(NT / 32 == BM / 16, "one warp per band");
  const int warp = tid / 32, lane = tid & 31;
  opc.store(&bx.ck[0][0], tid);   // ordered by reduce_checks' barrier
  float am, bm;
  reduce_checks<BM, NT>(opa, opb, sc, tid, false, am, bm);
  frag_sums<BM>(acc, sc, tid);
  consumer_sync<NT>();
  // Band `warp`: column residuals (this lane's columns lane + 32c), rows.
  float lb = -1.0f, sc_col[kBN / 32];
  int li = 0;
#pragma unroll
  for (int c = 0; c < kBN / 32; ++c) {
    const int n = lane + 32 * c;
    sc_col[c] = sc.colp[warp][n];
    const float d = sc_col[c] - (DELTA ? bx.prevc[warp][n] : 0.0f) -
                    bx.ck[warp][n];
    bx.dcol[warp][n] = d;
    if (fabsf(d) > lb) {
      lb = fabsf(d);
      li = n;
    }
  }
  float bc, br;
  int ic, ir;
  warp_argmax(lb, li, bc, ic);
  const int m = warp * 16 + (lane & 15);
  const float sr = sc.rowsum[m];
  const float dr =
      lane < 16 ? sr - (DELTA ? bx.prevr[m] : 0.0f) - sc.drow[m] : 0.0f;
  warp_argmax(dr, lane < 16 ? lane : 64 + lane, br, ir);
  const float tau = fmaxf(g.tau_coef * k_el * am * bm, 1e-30f);
  if constexpr (OWN_REP) {
    __syncwarp();
    if (lane == 0)
      bx.verdict[warp] = abft::record(bx.dcol[warp], bc, ic, br, ir, tau, k_el,
                                      g.corrects, row0 + 16 * warp, col0,
                                      bx.rep[warp]);
    __syncwarp();
  } else {
    if (lane == 0) {
      bx.best[warp][0] = bc;
      bx.idx[warp][0] = ic;
      bx.best[warp][1] = br;
      bx.idx[warp][1] = ir;
    }
    consumer_sync<NT>();
    if (tid == 0)
      for (int b = 0; b < BM / 16; ++b)
        bx.verdict[b] = abft::record(bx.dcol[b], bx.best[b][0], bx.idx[b][0],
                                     bx.best[b][1], bx.idx[b][1], tau, k_el,
                                     g.corrects, row0 + 16 * b, col0, sc.rep);
    consumer_sync<NT>();
  }
  const Verdict v = bx.verdict[warp];
  const bool fix = g.corrects && v.det;
  if (fix) add_at(acc, 16 * warp + v.row, v.col, -v.mag, tid);
  if constexpr (DELTA) {
    // As in verify_acc: after a correction, the corrected band's own sums
    // (the band's column and row sums are this warp's alone).
    float pr = sr;
    if (fix) {
      __syncwarp();
      frag_sums<BM>(acc, sc, tid);
      __syncwarp();
#pragma unroll
      for (int c = 0; c < kBN / 32; ++c) sc_col[c] = sc.colp[warp][lane + 32 * c];
      pr = sc.rowsum[m];
    }
#pragma unroll
    for (int c = 0; c < kBN / 32; ++c) bx.prevc[warp][lane + 32 * c] = sc_col[c];
    if (lane < 16) bx.prevr[m] = pr;
  }
  __syncwarp();
}

// The activation (pass 0) or its derivative (pass 1) of the accumulator,
// staged as a bf16 tile in shared memory (row pitch `pitch` elements).
__device__ __forceinline__ void stage_tile(const float (&acc)[64],
                                           __nv_bfloat16* stage, int pitch,
                                           int act, bool grad, int tid) {
  const int wg = tid / 128, wl = (tid % 128) / 32, lane = tid & 31;
  const int rl = wg * 64 + wl * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float y0 = acc[4 * j + 2 * i], y1 = acc[4 * j + 2 * i + 1];
      const float o0 = grad ? activate_grad(act, y0) : activate(act, y0);
      const float o1 = grad ? activate_grad(act, y1) : activate(act, y1);
      *reinterpret_cast<__nv_bfloat162*>(
          stage + (rl + 8 * i) * pitch + 8 * j + 2 * (lane & 3)) =
          __floats2bfloat162_rn(o0, o1);
    }
}

// Copy the staged BM x 128 bf16 tile to the rows below m_hi of dst (M, N)
// with 16-byte stores (element stores where N is not a multiple of 8).
template <int BM, int NT>
__device__ __forceinline__ void store_tile(const __nv_bfloat16* stage,
                                           int pitch, __nv_bfloat16* dst,
                                           int m_hi, int N, int row0,
                                           int col0, int tid) {
  const bool vec = (N % 8) == 0;
  for (int c = tid; c < BM * (kBN / 8); c += NT) {
    const int r = c / (kBN / 8), q = c % (kBN / 8);
    const int gr = row0 + r, gc = col0 + q * 8;
    if (gr >= m_hi || gc >= N) continue;
    const __nv_bfloat16* src = stage + r * pitch + q * 8;
    __nv_bfloat16* d = dst + (long long)gr * N + gc;
    if (vec) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < 8 && gc + e < N; ++e) d[e] = src[e];
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                  cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 2-D bf16 tensor map: `d0` elements along the contiguous dim, `d1` rows
// `ld` elements apart; box (b0, b1), 128-byte swizzle, zero fill out of
// bounds.
bool make_map(CUtensorMap* map, const void* base, long long d0, long long d1,
              long long ld, int b0, int b1) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)d0, (cuuint64_t)d1};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)b0, (cuuint32_t)b1};
  const cuuint32_t es[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 3-D bf16 tensor map: `d0` elements along the contiguous dim, `d1` rows
// `ld` elements apart, `d2` slabs `ls` elements apart; box (b0, b1, 1).
bool make_map3(CUtensorMap* map, const void* base, long long d0, long long d1,
               long long d2, long long ld, long long ls, int b0, int b1) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d0, (cuuint64_t)d1, (cuuint64_t)d2};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * 2, (cuuint64_t)ls * 2};
  const cuuint32_t box[3] = {(cuuint32_t)b0, (cuuint32_t)b1, 1};
  const cuuint32_t es[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
            dims, strides, box, es, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
