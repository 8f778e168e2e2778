// Fq2 = Fq[u]/(u^2 + 1) on field_cc.cuh, shared by K5/K6 (csrc/g2.cu) and
// K7/K8 (csrc/pairing.cu). Each Fq2 operation is built from exactly the Fq
// operations of `fields/ops.Fq2Ops`, so its value depends only on its
// operands, as the torch version's does:
//   * mul, Karatsuba: s0 = a0 + a1, s1 = b0 + b1, t0 = a0 b0, t1 = a1 b1,
//     t2 = s0 s1; c0 = t0 - t1, c1 = t2 - (t0 + t1);
//   * sqr: c0 = (a0 + a1)(a0 - a1), c1 = 2 a0 a1 (t + t);
//   * add, sub: the Fq operation on each coefficient.
// Layout: Fq2 batches [.., 2, 8, n]; element e has c0's limb k at
// (e / n) * 16n + k*n + e % n and c1's 8n further on.
#pragma once

#include "field_cc.cuh"

struct Fq2 {
  uint32_t c[2][8];
};

__device__ __forceinline__ void fq2_add(Fq2& r, const Fq2& a, const Fq2& b, const Field& F) {
  add_cc(r.c[0], a.c[0], b.c[0], F);
  add_cc(r.c[1], a.c[1], b.c[1], F);
}

__device__ __forceinline__ void fq2_sub(Fq2& r, const Fq2& a, const Fq2& b, const Field& F) {
  sub_cc(r.c[0], a.c[0], b.c[0], F);
  sub_cc(r.c[1], a.c[1], b.c[1], F);
}

// Karatsuba's products in mode 1: pass k = 0, 1 forms t_k = a_k b_k, pass 2
// t2 = (a0 + a1) s with s = b0 + b1 (bs null) or bs; the pass, the same for
// the whole warp, picks the operands, so one mul_cc's code serves all three.
__device__ __forceinline__ void karatsuba_loop(uint32_t t0[8], uint32_t t1[8], uint32_t t2[8],
                                               const uint32_t a0[8], const uint32_t a1[8],
                                               const uint32_t b0[8], const uint32_t b1[8],
                                               const uint32_t* bs, const Field& F) {
#pragma unroll
  for (int j = 0; j < 8; ++j) t0[j] = t1[j] = 0;
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    uint32_t x[8], y[8];
    if (k == 2) {
      add_cc(x, a0, a1, F);
      if (bs) {
#pragma unroll
        for (int j = 0; j < 8; ++j) y[j] = bs[j];
      } else {
        add_cc(y, b0, b1, F);
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        x[j] = k ? a1[j] : a0[j];
        y[j] = k ? b1[j] : b0[j];
      }
    }
    mul_cc(x, x, y, F);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      t0[j] = k == 0 ? x[j] : t0[j];
      t1[j] = k == 1 ? x[j] : t1[j];
      t2[j] = x[j];
    }
  }
}

// r = a * b (Karatsuba, above). r may alias a or b. MODE 0 runs the three
// products as three unrolled mul_cc (K6), MODE 1 as karatsuba_loop (K5).
template <int MODE>
__device__ __forceinline__ void fq2_mul(Fq2& r, const Fq2& a, const Fq2& b, const Field& F) {
  uint32_t t0[8], t1[8], t2[8];
  if constexpr (MODE == 1) {
    karatsuba_loop(t0, t1, t2, a.c[0], a.c[1], b.c[0], b.c[1], nullptr, F);
  } else {
    add_cc(t2, a.c[0], a.c[1], F);
    add_cc(t1, b.c[0], b.c[1], F);
    mul_cc(t2, t2, t1, F);
    mul_cc(t0, a.c[0], b.c[0], F);
    mul_cc(t1, a.c[1], b.c[1], F);
  }
  sub_cc(r.c[0], t0, t1, F);
  add_cc(t0, t0, t1, F);
  sub_cc(r.c[1], t2, t0, F);
}

// r = a^2: c0 = (a0 + a1)(a0 - a1), c1 = a0 a1 + a0 a1. r may alias a.
__device__ __forceinline__ void fq2_sqr(Fq2& r, const Fq2& a, const Field& F) {
  uint32_t s[8], d[8];
  add_cc(s, a.c[0], a.c[1], F);
  sub_cc(d, a.c[0], a.c[1], F);
  mul_cc(s, s, d, F);
  mul_cc(d, a.c[0], a.c[1], F);
  add_cc(r.c[1], d, d, F);
#pragma unroll
  for (int k = 0; k < 8; ++k) r.c[0][k] = s[k];
}

__device__ __forceinline__ int64_t elem_base16_cc(int64_t e, int64_t n, int64_t total) {
  if (total <= 0xFFFFFFFFll) {
    const uint32_t q = (uint32_t)e / (uint32_t)n;
    return (int64_t)q * 16 * n + ((uint32_t)e - q * (uint32_t)n);
  }
  return elem_base16(e, n);
}

__device__ __forceinline__ void load_fq2(Fq2& r, const uint32_t* __restrict__ src, int64_t base,
                                         int64_t n) {
  load8(r.c[0], src, base, n);
  load8(r.c[1], src, base + 8 * n, n);
}

__device__ __forceinline__ void store_fq2(uint32_t* __restrict__ dst, const Fq2& r, int64_t base,
                                          int64_t n) {
  store8(dst, r.c[0], base, n);
  store8(dst + 8 * n, r.c[1], base, n);
}

