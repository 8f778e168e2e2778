// Field arithmetic on 8 x 32-bit limbs (R = 2^256), shared by the kernels.
//
// Layout: a batch [B, 8, n] of uint32 words, limb-major; element e of the
// flattened batch has limb k at (e / n) * 8n + (e % n) + k*n, so the 32
// threads of a warp read 32 neighbouring words per limb (coalesced).
//
// Contract (the same as legosnark_tpu_torch/fields/limb.py, so that the
// kernels and their plain PyTorch versions agree bit for bit):
//   * every input and output value lies in [0, 2p) with exact limbs;
//   * fadd returns a + b, minus 2p when a + b >= 2p (a + b < 4p < 2^256);
//   * fsub returns a - b, plus 2p when a < b;
//   * fmul returns (a*b + M*p) / R with M = -a*b*p^-1 mod R in [0, R),
//     computed word by word (CIOS), with no final subtraction. For
//     a, b < 2p: a*b/R < 4p^2/R = 4p/(R/p) < 0.76p since R/p > 5.29 for
//     both BN254 moduli, so the result is < 1.76p < 2p.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

struct Field {
  uint32_t p[8];
  uint32_t p2[8];  // 2p
  uint32_t pinv;   // -p^-1 mod 2^32
};

__device__ __forceinline__ int64_t elem_base(int64_t e, int64_t n) {
  return (e / n) * 8 * n + (e % n);
}

__device__ __forceinline__ void load8(uint32_t r[8], const uint32_t* __restrict__ src,
                                      int64_t base, int64_t n) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = src[base + k * n];
}

__device__ __forceinline__ void store8(uint32_t* __restrict__ dst, const uint32_t r[8],
                                       int64_t base, int64_t n) {
#pragma unroll
  for (int k = 0; k < 8; ++k) dst[base + k * n] = r[k];
}

// r = a*b/R (CIOS). r may alias a or b.
__device__ __forceinline__ void fmul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8],
                                     const Field& F) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    // t += a * b[i]; each step is at most (2^32-1)^2 + 2(2^32-1) < 2^64
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)a[j] * b[i] + t[j] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    // t = (t + m*p) / 2^32 with m chosen so that the low word vanishes
    uint32_t m = t[0] * F.pinv;
    s = (uint64_t)m * F.p[0] + t[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; ++j) {
      s = (uint64_t)m * F.p[j] + t[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  // the result is < 2p < 2^256, so t[8] == 0
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = t[j];
}

// r = a + b mod 2p. r may alias a or b.
__device__ __forceinline__ void fadd(uint32_t r[8], const uint32_t a[8], const uint32_t b[8],
                                     const Field& F) {
  uint32_t s[8], d[8];
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t v = (uint64_t)a[j] + b[j] + c;
    s[j] = (uint32_t)v;
    c = v >> 32;
  }
  uint64_t br = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t v = (uint64_t)s[j] - F.p2[j] - br;
    d[j] = (uint32_t)v;
    br = v >> 63;
  }
  // borrow out: s < 2p, keep s
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = br ? s[j] : d[j];
}

// r = a - b, plus 2p on borrow. r may alias a or b.
__device__ __forceinline__ void fsub(uint32_t r[8], const uint32_t a[8], const uint32_t b[8],
                                     const Field& F) {
  uint32_t d[8], e[8];
  uint64_t br = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t v = (uint64_t)a[j] - b[j] - br;
    d[j] = (uint32_t)v;
    br = v >> 63;
  }
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    uint64_t v = (uint64_t)d[j] + F.p2[j] + c;
    e[j] = (uint32_t)v;
    c = v >> 32;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = br ? e[j] : d[j];
}

static inline Field field_from_words(const uint32_t* w) {
  Field F;
  for (int k = 0; k < 8; ++k) {
    F.p[k] = w[k];
    F.p2[k] = w[8 + k];
  }
  F.pinv = w[16];
  return F;
}

static inline unsigned grid_for(long long total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}
