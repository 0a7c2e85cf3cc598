// The in-kernel stochastic SEU hook of the GEMM family (K1, K5, K7, K8)
// and the flash family (K2, K3, K4, K6), every instance: the device side
// of kernels/templates/seu.py, which is the counterpart of
// src/repro/kernels/templates/emit.py:162-230 (stochastic_seu, apply_seu).
//
// A campaign hands each launch four arguments (kernels/ft_gemm.py:
// seu_args): on (a triple with enable = 1 and a rate above 0), the
// kernel's stream seed, seed0 ^ mix32(seed1 + salt·0x9E3779B9), reduced on
// the host from the campaign's triple and the kernel's salt, the rate and
// the bit shift. Each stationary output block hashes its uid into one
// Bernoulli(rate) SEU at a uniform (live step, row, col) with the uint32
// arithmetic of the reference bit for bit:
//   h0 = mix32(seed ^ uid·0x85EBCA6B), hit = (h0 >> 8)·2^-24 < rate,
//   step / row / col = (mix32(h0 + 1 / 2 / 3) & 0x7FFFFFFF) % max(n, 1).
// One draw per block, at its start: the hook costs one hash a CTA, and
// with `on` = 0 a uniform branch per step (or nothing, in the instances
// compiled without the hook). The hit lands on the step whose
// live index is `step`, on the element's contribution d of that step:
// d·(2^s − 1) is added, or 2^s where that is at most 1e-6 in magnitude.
#pragma once

#include <stdint.h>

namespace seu {

struct Args {
  int on;          // 1: a campaign is armed on this launch
  uint32_t seed;   // the kernel's stream seed
  float rate;      // Bernoulli rate per block
  int shift;       // bit shift of the magnitude model
};

struct Hit {
  bool hit;
  int step, row, col;
};

__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

__device__ __forceinline__ int bounded(uint32_t h, int n) {
  return (int)(h & 0x7FFFFFFFu) % (n > 1 ? n : 1);
}

// The SEU of the block `uid`, which runs n_live live steps over a (bm, bn)
// block. A block with no live step never hits.
__device__ __forceinline__ Hit draw(const Args& a, uint32_t uid, int n_live,
                                   int bm, int bn) {
  Hit h;
  const uint32_t h0 = mix32(a.seed ^ (uid * 0x85EBCA6Bu));
  const float u = (float)(h0 >> 8) * (1.0f / 16777216.0f);
  h.hit = a.on == 1 && u < a.rate && n_live > 0;
  h.step = bounded(mix32(h0 + 1u), n_live);
  h.row = bounded(mix32(h0 + 2u), bm);
  h.col = bounded(mix32(h0 + 3u), bn);
  return h;
}

// The SEU added to an element whose step contribution is d.
__device__ __forceinline__ float magnitude(float d, int shift) {
  const float p = ldexpf(1.0f, shift);
  const float m = d * (p - 1.0f);
  return fabsf(m) > 1e-6f ? m : p;
}

}  // namespace seu
