// Fq arithmetic for the G1 kernels K2/K3 (csrc/g1.cu), written for the
// card's carry chains: every multi-word add, subtract and multiply-add is a
// PTX chain of add.cc / addc / sub.cc / subc / mad.lo.cc / madc.hi.cc on
// 32-bit words, with the carry in the flag instead of 64-bit temporaries.
// K1 and the probes keep field.cuh; this header takes the layout helpers
// (elem_base, load8, store8, grid_for) and the constant block (Field) from
// it.
//
// Contract: the one of field.cuh, so results are bit-identical to it and to
// the plain torch versions:
//   * every input and output value lies in [0, 2p) with exact limbs;
//   * add_cc returns a + b, minus 2p when a + b >= 2p;
//   * sub_cc returns a - b, plus 2p when a < b;
//   * mul_cc returns (a*b + M*p)/R with M = -a*b*p^-1 mod R in [0, R) and no
//     final subtraction. That value does not depend on the order in which
//     the word products are summed, so this schedule equals field.cuh's.
//
// mul_cc is CIOS with its running sum t split in two 8-word halves, E at
// word 0 and F one word up (t = E + 2^32 F). A row adds a[j] * y for even j
// into E's words (j, j + 1) and for odd j into F's words (j - 1, j): in
// each half the products' low and high words sit side by side and never
// overlap, so one chain per half takes a whole row, and the card runs each
// mad.lo.cc / madc.hi.cc pair of one product as a single wide multiply-add
// with carry (IMAD.WIDE.U32.X). m comes from E's word 0 alone. After the
// reduction E's word 0 is 0, and the one-word shift swaps the halves: the
// next E is F plus E's word 1 (whose carry enters the next F chain), the
// next F is E's words 2..7, moved while the next row's odd products go in.
//
// Why nine words suffice (BN254 Fq: p < 0.19 * 2^256, its top word
// 0x30644e72 < 2^30, so 2p < 2^255 and 3p < 2^256). After i rows
//   t_i = (a * (b mod 2^(32i)) + M_i * p) / 2^(32i) < a + p < 3p < 2^256,
// with M_i < 2^(32i) the first i words of M. Row i + 1 forms
//   t_i + a * b_i + m * p = 2^32 * t_(i+1) < 2^32 * 3p < 2^288
// before its shift: every partial sum fits in nine words (E's words 0..7
// and F's 0..7 cover words 0..8 of t). So F's chains never carry out of
// its word 7 (F <= t / 2^32 < 2^256), E's carry out of its word 7 lands in
// F's word 7 (word 8 of t), and field.cuh's tenth word and final t[8] add
// are gone. The result t_8 < a*b/R + p < 4p^2/R + p < 1.76p < 2p as in
// field.cuh.
// add_cc: a + b < 4p < 2^256, so the add leaves no carry; the borrow of
// s - 2p alone says whether s >= 2p. sub_cc: the borrow of a - b says a < b.
#pragma once

#include "field.cuh"

// Each helper is one PTX instruction. The carry flag lives between the
// asm statements of one chain: they are volatile, so they keep their order,
// and nothing else the compiler emits writes the flag.
__device__ __forceinline__ uint32_t add_cc_(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_cc_(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t addc_(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t sub_cc_(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_cc_(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint32_t subc_(uint32_t a, uint32_t b) {
  uint32_t r;
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
// lo(a*b) + c, and the same with the carry in
__device__ __forceinline__ uint32_t madlo_cc_(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madloc_cc_(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
// hi(a*b) + c with the carry in, with or without the carry out
__device__ __forceinline__ uint32_t madhic_cc_(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}
__device__ __forceinline__ uint32_t madhic_(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r;
  asm volatile("madc.hi.u32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(c));
  return r;
}

// E += x_even * y: x[j] (j even) into words (j, j + 1), one chain; the
// carry out of word 7 stays in the flag.
__device__ __forceinline__ void mad_even(uint32_t e[8], const uint32_t x[8], uint32_t y) {
  e[0] = madlo_cc_(x[0], y, e[0]);
  e[1] = madhic_cc_(x[0], y, e[1]);
#pragma unroll
  for (int j = 2; j < 8; j += 2) {
    e[j] = madloc_cc_(x[j], y, e[j]);
    e[j + 1] = madhic_cc_(x[j], y, e[j + 1]);
  }
}

// F += x_odd * y with F one word up: x[j] (j odd) into words (j - 1, j);
// no carry leaves word 7.
__device__ __forceinline__ void mad_odd(uint32_t f[8], const uint32_t x[8], uint32_t y) {
  f[0] = madlo_cc_(x[1], y, f[0]);
  f[1] = madhic_cc_(x[1], y, f[1]);
#pragma unroll
  for (int j = 3; j < 7; j += 2) {
    f[j - 1] = madloc_cc_(x[j], y, f[j - 1]);
    f[j] = madhic_cc_(x[j], y, f[j]);
  }
  f[6] = madloc_cc_(x[7], y, f[6]);
  f[7] = madhic_(x[7], y, f[7]);
}

// t += m * p with m = t[0] * pinv, which makes E's word 0 zero.
__device__ __forceinline__ void redc_eo(uint32_t e[8], uint32_t f[8], const Field& F) {
  const uint32_t m = e[0] * F.pinv;
  mad_odd(f, F.p, m);
  mad_even(e, F.p, m);
  f[7] = addc_(f[7], 0);
}

// r = a*b/R (even/odd CIOS, above). r may alias a or b.
__device__ __forceinline__ void mul_cc(uint32_t r[8], const uint32_t a[8], const uint32_t b[8],
                                       const Field& F) {
  uint32_t e[8], f[8];
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    e[j] = a[j] * b[0];
    e[j + 1] = __umulhi(a[j], b[0]);
    f[j] = a[j + 1] * b[0];
    f[j + 1] = __umulhi(a[j + 1], b[0]);
  }
  redc_eo(e, f, F);
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    // shift by one word: E' = F + e[1], F' = e[2..7], the odd products in
    uint32_t ne[8], nf[8];
    ne[0] = add_cc_(f[0], e[1]);
    nf[0] = madloc_cc_(a[1], b[i], e[2]);
    nf[1] = madhic_cc_(a[1], b[i], e[3]);
    nf[2] = madloc_cc_(a[3], b[i], e[4]);
    nf[3] = madhic_cc_(a[3], b[i], e[5]);
    nf[4] = madloc_cc_(a[5], b[i], e[6]);
    nf[5] = madhic_cc_(a[5], b[i], e[7]);
    nf[6] = madloc_cc_(a[7], b[i], 0);
    nf[7] = madhic_(a[7], b[i], 0);
#pragma unroll
    for (int j = 1; j < 8; ++j) ne[j] = f[j];
    mad_even(ne, a, b[i]);
    nf[7] = addc_(nf[7], 0);
    redc_eo(ne, nf, F);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      e[j] = ne[j];
      f[j] = nf[j];
    }
  }
  // t = E / 2^32 + F
  r[0] = add_cc_(f[0], e[1]);
#pragma unroll
  for (int j = 1; j < 7; ++j) r[j] = addc_cc_(f[j], e[j + 1]);
  r[7] = addc_(f[7], 0);
}

// r = a + b mod 2p: s = a + b, d = s - 2p, keep s where d borrowed.
// r may alias a or b.
__device__ __forceinline__ void add_cc(uint32_t r[8], const uint32_t a[8], const uint32_t b[8],
                                       const Field& F) {
  uint32_t s[8], d[8];
  s[0] = add_cc_(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < 7; ++j) s[j] = addc_cc_(a[j], b[j]);
  s[7] = addc_(a[7], b[7]);
  d[0] = sub_cc_(s[0], F.p2[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = subc_cc_(s[j], F.p2[j]);
  const uint32_t borrow = subc_(0, 0);  // all ones when s < 2p
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = borrow ? s[j] : d[j];
}

// r = a - b, plus 2p where the subtraction borrowed. r may alias a or b.
__device__ __forceinline__ void sub_cc(uint32_t r[8], const uint32_t a[8], const uint32_t b[8],
                                       const Field& F) {
  uint32_t d[8];
  d[0] = sub_cc_(a[0], b[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = subc_cc_(a[j], b[j]);
  const uint32_t mask = subc_(0, 0);  // all ones when a < b
  r[0] = add_cc_(d[0], F.p2[0] & mask);
#pragma unroll
  for (int j = 1; j < 7; ++j) r[j] = addc_cc_(d[j], F.p2[j] & mask);
  r[7] = addc_(d[7], F.p2[7] & mask);
}

// elem_base without 64-bit division where the batch has fewer than 2^32
// elements (every batch an 80 GB card can hold).
__device__ __forceinline__ int64_t elem_base_cc(int64_t e, int64_t n, int64_t total) {
  if (total <= 0xFFFFFFFFll) {
    const uint32_t q = (uint32_t)e / (uint32_t)n;
    return (int64_t)q * 8 * n + ((uint32_t)e - q * (uint32_t)n);
  }
  return elem_base(e, n);
}
