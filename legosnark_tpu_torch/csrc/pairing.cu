// K7 / K8: the BN254 optimal ate pairing of `curve/pairing.py`, one thread
// per pair (K7, the Miller loop) and one thread per product of pairings
// (K8, the group's product and the final exponentiation).
//
// Replaces no Pallas kernel: the JAX package's pairing
// (`legosnark_tpu/curve/pairing.py`) is jnp code. Added because that
// pairing, run as torch code (each Fq12 product one K1 launch and dozens of
// torch add / sub / stack ops, one statement wide), was nearly all of every
// verify: the host issued on the order of 10^5 launches per check and the
// card idled 94% of it.
//
// K7 takes the legs as the callers hold them, homogeneous projective: G1
// [.., 8, n] x, y, z and G2 [.., 2, 8, n] x, y, z. Each thread makes its
// legs affine (one Fermat inversion per leg), gives the Miller value 1 where
// either leg is the identity (z == 0), and otherwise runs `miller_loop`'s
// loop: CLN doubling and addition steps on the D-type twist, the lines
// folded in by `mul_by_034`, the two closing steps with pi(Q) and
// -pi^2(Q). Out: Fq12 [.., 2, 3, 2, 8, n].
// K8 takes Miller values (Fq12 [.., 2, 3, 2, 8, n], flattened over the
// batch) and a table idx [K, width] of their indices, where an index
// outside them stands for 1. Thread k multiplies its row's values and runs
// `final_exp`'s easy part and the hard part's x-adic chain. Out: Fq12 [K]
// laid out as [K / n_out, 2, 3, 2, 8, n_out].
// Both write canonical Montgomery form (every value below p).
//
// Equal to the torch versions (`miller_loop_plain`, `final_exp_plain`):
// every step is the same formula in the same tower (Fq2 = Fq[u]/(u^2 + 1),
// Fq6 = Fq2[v]/(v^3 - xi), xi = 9 + u, Fq12 = Fq6[w]/(w^2 - v)), so each
// result is the same field element, and a canonical output is that
// element's one representation. Intermediate values lie in [0, 2p) as in
// field_cc.cuh, not necessarily as the torch code leaves them.
//
// What bounds it on an H100, and what the design does about it:
// * At the cells' widths (4 pairs and 1 product in Groth16, about 10^2
//   pairs and 2 x 10^1 products in CPmmp's pairing_checks) a launch is one
//   or a few warps: the latency of one thread's chain of Fq products, about
//   10^4 in a Miller loop and 1.2 x 10^4 in a final exponentiation. The
//   design target is K7 + K8 <= 30 ms of device time per Groth16 check.
// * At 2^14 pairs, the 32-bit multiply rate: 264 multiplies per Fq product
//   against 16.7e12 per s (`portbench/roofline.py`).
// * Code size and build time. The values live in the thread's local memory
//   (an Fq12 is 96 words), and every operation from an Fq2 product up is a
//   called function (`__noinline__`), so a Montgomery product's code is
//   emitted a few times in all; the loops over the bits of 6x + 2 and of x
//   stay loops over a constant bit table.
// A multi-lane Fq12 product, which would cut the chain's latency further, is
// not done here.
#include "fq2_cc.cuh"

// 64 threads per block: 2^14 pairs fill 256 blocks over the 132 SMs.
#define LSK_PAIRING_THREADS 64

struct Fq6 {
  Fq2 c[3];
};

struct Fq12 {
  Fq6 c[2];
};

// The constant block, in the order `curve/pairing._words` writes it.
struct PairingConsts {
  Field F;
  uint32_t one[8];       // 1 in Montgomery form
  uint32_t two_inv[8];   // 1/2
  Fq2 b_twist;           // b' = 3 / xi
  Fq2 twist_qx;          // xi^((q - 1) / 3)
  Fq2 twist_qy;          // xi^((q - 1) / 2)
  Fq12 gamma[3];         // Frobenius factors of q, q^2, q^3: v^i w^j's at c[j].c[i]
  uint32_t ate[2];       // the bits of 6x + 2 below its top bit, low word first
  uint32_t ate_bits;
  uint32_t x[2];         // the bits of x below its top bit
  uint32_t x_bits;
};

__constant__ PairingConsts kC;

#define NOINLINE __device__ __noinline__
#define INLINE __device__ __forceinline__

INLINE bool bit_of(const uint32_t w[2], int i) { return (w[i >> 5] >> (i & 31)) & 1; }

// -- Fq ---------------------------------------------------------------------

INLINE void fq_copy(uint32_t r[8], const uint32_t a[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = a[k];
}

INLINE void fq_neg(uint32_t r[8], const uint32_t a[8]) {
  const uint32_t zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  sub_cc(r, zero, a, kC.F);
}

// The representative below p of a value below 2p.
INLINE void fq_canon(uint32_t r[8], const uint32_t a[8]) {
  uint32_t d[8];
  d[0] = sub_cc_(a[0], kC.F.p[0]);
#pragma unroll
  for (int j = 1; j < 8; ++j) d[j] = subc_cc_(a[j], kC.F.p[j]);
  const uint32_t borrow = subc_(0, 0);  // all ones when a < p
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = borrow ? a[j] : d[j];
}

INLINE bool fq_is_zero(const uint32_t a[8]) {
  uint32_t c[8], any = 0;
  fq_canon(c, a);
#pragma unroll
  for (int j = 0; j < 8; ++j) any |= c[j];
  return any == 0;
}

NOINLINE void fq_mul(uint32_t r[8], const uint32_t a[8], const uint32_t b[8]) {
  uint32_t x[8], y[8];
  fq_copy(x, a);
  fq_copy(y, b);
  mul_cc(x, x, y, kC.F);
  fq_copy(r, x);
}

// a^(p - 2) by square and multiply from the top bit (Fermat); 0 maps to 0.
NOINLINE void fq_inv(uint32_t r[8], const uint32_t a[8]) {
  uint32_t x[8], acc[8];
  fq_copy(x, a);
  fq_copy(acc, a);
  int top = 255;
  while (!((kC.F.p[top >> 5] >> (top & 31)) & 1)) --top;
#pragma unroll 1
  for (int i = top - 1; i >= 0; --i) {
    mul_cc(acc, acc, acc, kC.F);
    // p - 2 differs from p in word 0 alone (p is odd, its word 0 above 2)
    const uint32_t w = i < 32 ? kC.F.p[0] - 2 : kC.F.p[i >> 5];
    if ((w >> (i & 31)) & 1) mul_cc(acc, acc, x, kC.F);
  }
  fq_copy(r, acc);
}

// -- Fq2 --------------------------------------------------------------------

INLINE void f2_add(Fq2& r, const Fq2& a, const Fq2& b) { fq2_add(r, a, b, kC.F); }
INLINE void f2_sub(Fq2& r, const Fq2& a, const Fq2& b) { fq2_sub(r, a, b, kC.F); }

INLINE void f2_neg(Fq2& r, const Fq2& a) {
  fq_neg(r.c[0], a.c[0]);
  fq_neg(r.c[1], a.c[1]);
}

INLINE void f2_conj(Fq2& r, const Fq2& a) {
  fq_copy(r.c[0], a.c[0]);
  fq_neg(r.c[1], a.c[1]);
}

INLINE bool f2_is_zero(const Fq2& a) { return fq_is_zero(a.c[0]) && fq_is_zero(a.c[1]); }

NOINLINE void f2_mul(Fq2& r, const Fq2& a, const Fq2& b) {
  Fq2 x = a, y = b;
  fq2_mul<0>(x, x, y, kC.F);
  r = x;
}

NOINLINE void f2_sqr(Fq2& r, const Fq2& a) {
  Fq2 x = a;
  fq2_sqr(x, x, kC.F);
  r = x;
}

// r = a * s for s in Fq (`Fq2Ops.mul_base`).
NOINLINE void f2_mul_fq(Fq2& r, const Fq2& a, const uint32_t s[8]) {
  Fq2 x = a;
  uint32_t y[8];
  fq_copy(y, s);
  mul_cc(x.c[0], x.c[0], y, kC.F);
  mul_cc(x.c[1], x.c[1], y, kC.F);
  r = x;
}

// r = a * xi = (9 a0 - a1) + (a0 + 9 a1) u, 9a = 8a + a by three doublings.
NOINLINE void f2_mul_xi(Fq2& r, const Fq2& a) {
  Fq2 x = a, x9;
  f2_add(x9, x, x);
  f2_add(x9, x9, x9);
  f2_add(x9, x9, x9);
  f2_add(x9, x9, x);
  sub_cc(r.c[0], x9.c[0], x.c[1], kC.F);
  add_cc(r.c[1], x.c[0], x9.c[1], kC.F);
}

// conj(a) / (a0^2 + a1^2).
NOINLINE void f2_inv(Fq2& r, const Fq2& a) {
  uint32_t n0[8], n1[8];
  fq_mul(n0, a.c[0], a.c[0]);
  fq_mul(n1, a.c[1], a.c[1]);
  add_cc(n0, n0, n1, kC.F);
  fq_inv(n0, n0);
  fq_mul(n1, a.c[1], n0);
  fq_mul(r.c[0], a.c[0], n0);
  fq_neg(r.c[1], n1);
}

// -- Fq6 --------------------------------------------------------------------

INLINE void f6_add(Fq6& r, const Fq6& a, const Fq6& b) {
#pragma unroll
  for (int i = 0; i < 3; ++i) f2_add(r.c[i], a.c[i], b.c[i]);
}

INLINE void f6_sub(Fq6& r, const Fq6& a, const Fq6& b) {
#pragma unroll
  for (int i = 0; i < 3; ++i) f2_sub(r.c[i], a.c[i], b.c[i]);
}

INLINE void f6_neg(Fq6& r, const Fq6& a) {
#pragma unroll
  for (int i = 0; i < 3; ++i) f2_neg(r.c[i], a.c[i]);
}

// v * (a0 + a1 v + a2 v^2) = xi a2 + a0 v + a1 v^2. r may alias a.
INLINE void f6_mul_by_v(Fq6& r, const Fq6& a) {
  Fq2 t;
  f2_mul_xi(t, a.c[2]);
  r.c[2] = a.c[1];
  r.c[1] = a.c[0];
  r.c[0] = t;
}

// Karatsuba over the three coefficients (`Fq6Ops.mul`): 6 Fq2 products.
NOINLINE void f6_mul(Fq6& r, const Fq6& a, const Fq6& b) {
  Fq2 t0, t1, t2, u1, u2, u3, x, y;
  f2_mul(t0, a.c[0], b.c[0]);
  f2_mul(t1, a.c[1], b.c[1]);
  f2_mul(t2, a.c[2], b.c[2]);
  f2_add(x, a.c[1], a.c[2]);
  f2_add(y, b.c[1], b.c[2]);
  f2_mul(u1, x, y);
  f2_add(x, a.c[0], a.c[1]);
  f2_add(y, b.c[0], b.c[1]);
  f2_mul(u2, x, y);
  f2_add(x, a.c[0], a.c[2]);
  f2_add(y, b.c[0], b.c[2]);
  f2_mul(u3, x, y);
  f2_add(x, t1, t2);
  f2_sub(u1, u1, x);  // a1 b2 + a2 b1
  f2_add(x, t0, t1);
  f2_sub(u2, u2, x);  // a0 b1 + a1 b0
  f2_add(x, t0, t2);
  f2_sub(u3, u3, x);  // a0 b2 + a2 b0
  f2_mul_xi(u1, u1);
  f2_mul_xi(t2, t2);
  f2_add(r.c[0], t0, u1);
  f2_add(r.c[1], u2, t2);
  f2_add(r.c[2], u3, t1);
}

// r = a (e + d v) for Fq2 e, d: the line's w-part in `mul_by_034`.
NOINLINE void f6_mul_by_01(Fq6& r, const Fq6& a, const Fq2& e, const Fq2& d) {
  Fq2 p, q, r0, r1;
  f2_mul(p, a.c[2], d);
  f2_mul_xi(p, p);
  f2_mul(q, a.c[0], e);
  f2_add(r0, q, p);
  f2_mul(p, a.c[1], e);
  f2_mul(q, a.c[0], d);
  f2_add(r1, p, q);
  f2_mul(p, a.c[2], e);
  f2_mul(q, a.c[1], d);
  f2_add(r.c[2], p, q);
  r.c[0] = r0;
  r.c[1] = r1;
}

NOINLINE void f6_inv(Fq6& r, const Fq6& a) {
  Fq2 c0, c1, c2, t, u;
  f2_sqr(c0, a.c[0]);
  f2_mul(t, a.c[1], a.c[2]);
  f2_mul_xi(t, t);
  f2_sub(c0, c0, t);  // a0^2 - xi a1 a2
  f2_sqr(c1, a.c[2]);
  f2_mul_xi(c1, c1);
  f2_mul(t, a.c[0], a.c[1]);
  f2_sub(c1, c1, t);  // xi a2^2 - a0 a1
  f2_sqr(c2, a.c[1]);
  f2_mul(t, a.c[0], a.c[2]);
  f2_sub(c2, c2, t);  // a1^2 - a0 a2
  f2_mul(t, a.c[2], c1);
  f2_mul(u, a.c[1], c2);
  f2_add(t, t, u);
  f2_mul_xi(t, t);
  f2_mul(u, a.c[0], c0);
  f2_add(t, u, t);
  f2_inv(t, t);
  f2_mul(r.c[0], c0, t);
  f2_mul(r.c[1], c1, t);
  f2_mul(r.c[2], c2, t);
}

// -- Fq12 -------------------------------------------------------------------

INLINE void f12_one(Fq12& r) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int k = 0; k < 8; ++k) r.c[j].c[i].c[0][k] = r.c[j].c[i].c[1][k] = 0;
  fq_copy(r.c[0].c[0].c[0], kC.one);
}

INLINE void f12_conj(Fq12& r, const Fq12& a) {
  r.c[0] = a.c[0];
  f6_neg(r.c[1], a.c[1]);
}

// Karatsuba over w (`Fq12Ops.mul`): 3 Fq6 products.
NOINLINE void f12_mul(Fq12& r, const Fq12& a, const Fq12& b) {
  Fq6 t0, t1, t2, x, y;
  f6_mul(t0, a.c[0], b.c[0]);
  f6_mul(t1, a.c[1], b.c[1]);
  f6_add(x, a.c[0], a.c[1]);
  f6_add(y, b.c[0], b.c[1]);
  f6_mul(t2, x, y);
  f6_add(x, t0, t1);
  f6_sub(r.c[1], t2, x);
  f6_mul_by_v(t1, t1);
  f6_add(r.c[0], t0, t1);
}

// Complex squaring (`Fq12Ops.sqr`): c0 = (a0 + a1)(a0 + v a1) - t - v t,
// c1 = 2t with t = a0 a1; 2 Fq6 products.
NOINLINE void f12_sqr(Fq12& r, const Fq12& a) {
  Fq6 s, u, x, t;
  f6_add(s, a.c[0], a.c[1]);
  f6_mul_by_v(u, a.c[1]);
  f6_add(u, a.c[0], u);
  f6_mul(x, s, u);
  f6_mul(t, a.c[0], a.c[1]);
  f6_mul_by_v(u, t);
  f6_add(u, t, u);
  f6_sub(r.c[0], x, u);
  f6_add(r.c[1], t, t);
}

// (a0 - a1 w) / (a0^2 - v a1^2).
NOINLINE void f12_inv(Fq12& r, const Fq12& a) {
  Fq6 s0, s1;
  f6_mul(s0, a.c[0], a.c[0]);
  f6_mul(s1, a.c[1], a.c[1]);
  f6_mul_by_v(s1, s1);
  f6_sub(s0, s0, s1);
  f6_inv(s0, s0);
  f6_mul(s1, a.c[1], s0);
  f6_mul(r.c[0], a.c[0], s0);
  f6_neg(r.c[1], s1);
}

// f *= e0 + (e3 + e4 v) w, the D-twist line (`Fq12Ops.mul_by_034`): 15 Fq2
// products.
NOINLINE void f12_mul_by_034(Fq12& f, const Fq2& e0, const Fq2& e3, const Fq2& e4) {
  Fq6 t0, t1, s;
  Fq2 e03;
#pragma unroll
  for (int i = 0; i < 3; ++i) f2_mul(t0.c[i], f.c[0].c[i], e0);
  f6_mul_by_01(t1, f.c[1], e3, e4);
  f2_add(e03, e0, e3);
  f6_add(s, f.c[0], f.c[1]);
  f6_mul_by_01(s, s, e03, e4);
  f6_add(f.c[1], t0, t1);
  f6_sub(f.c[1], s, f.c[1]);
  f6_mul_by_v(t1, t1);
  f6_add(f.c[0], t0, t1);
}

// The q^n-power Frobenius (`curve/pairing.frobenius`): conjugate every Fq2
// coefficient for odd n, then scale the coefficient of v^i w^j by gamma_n's.
NOINLINE void f12_frob(Fq12& r, const Fq12& a, int n) {
#pragma unroll 1
  for (int j = 0; j < 2; ++j) {
#pragma unroll 1
    for (int i = 0; i < 3; ++i) {
      Fq2 c, g = kC.gamma[n - 1].c[j].c[i];
      if (n & 1) {
        f2_conj(c, a.c[j].c[i]);
      } else {
        c = a.c[j].c[i];
      }
      f2_mul(r.c[j].c[i], c, g);
    }
  }
}

INLINE void load_f12(Fq12& r, const uint32_t* __restrict__ src, int64_t base, int64_t n) {
#pragma unroll 1
  for (int c = 0; c < 12; ++c) load8(r.c[c / 6].c[(c / 2) % 3].c[c % 2], src, base + c * 8 * n, n);
}

INLINE void store_f12_canon(uint32_t* __restrict__ dst, const Fq12& a, int64_t base, int64_t n) {
#pragma unroll 1
  for (int c = 0; c < 12; ++c) {
    uint32_t v[8];
    fq_canon(v, a.c[c / 6].c[(c / 2) % 3].c[c % 2]);
    store8(dst, v, base + c * 8 * n, n);
  }
}

// -- Miller loop ------------------------------------------------------------

// CLN doubling step on the twist (`_dbl_step`): R <- 2R and the line
// (c0, c3, c4), c0 to be scaled by P.y and c3 by P.x.
NOINLINE void dbl_step(Fq2 R[3], Fq2 L[3]) {
  Fq2 s, xy, b, c, j, hh, e, a, f, h, g, t;
  const Fq2 bt = kC.b_twist;
  uint32_t half[8];
  fq_copy(half, kC.two_inv);
  f2_add(s, R[1], R[2]);
  f2_mul(xy, R[0], R[1]);
  f2_sqr(b, R[1]);
  f2_sqr(c, R[2]);
  f2_sqr(j, R[0]);
  f2_sqr(hh, s);
  f2_add(t, c, c);
  f2_add(t, t, c);
  f2_mul(e, bt, t);      // b' 3c
  f2_mul_fq(a, xy, half);
  f2_add(f, e, e);
  f2_add(f, f, e);       // 3e
  f2_add(t, b, c);
  f2_sub(h, hh, t);
  f2_add(t, b, f);
  f2_mul_fq(g, t, half);
  f2_sub(t, b, f);
  f2_mul(R[0], a, t);    // x
  f2_mul(R[2], b, h);    // z
  f2_sqr(g, g);
  f2_sqr(s, e);
  f2_add(t, s, s);
  f2_add(t, t, s);
  f2_sub(R[1], g, t);    // y = g^2 - 3e^2
  f2_neg(L[0], h);
  f2_add(t, j, j);
  f2_add(L[1], t, j);
  f2_sub(L[2], e, b);
}

// CLN mixed addition step R += Q, Q affine on the twist (`_add_step`).
NOINLINE void add_step(Fq2 R[3], const Fq2& qx, const Fq2& qy, Fq2 L[3]) {
  Fq2 theta, lam, c, d, e, f, g, h, t, u;
  f2_mul(t, qy, R[2]);
  f2_sub(theta, R[1], t);
  f2_mul(t, qx, R[2]);
  f2_sub(lam, R[0], t);
  f2_sqr(c, theta);
  f2_sqr(d, lam);
  f2_mul(e, lam, d);
  f2_mul(f, R[2], c);
  f2_mul(g, R[0], d);
  f2_add(t, e, f);
  f2_add(h, g, g);
  f2_sub(h, t, h);       // e + f - 2g
  f2_mul(t, theta, qx);
  f2_mul(u, lam, qy);
  f2_sub(L[2], t, u);
  f2_sub(t, g, h);
  f2_mul(t, theta, t);
  f2_mul(u, e, R[1]);
  f2_sub(R[1], t, u);    // y
  f2_mul(R[0], lam, h);  // x
  f2_mul(R[2], R[2], e); // z
  L[0] = lam;
  f2_neg(L[1], theta);
}

// f *= (c0 P.y) + (c3 P.x + c4 v) w (`_ell`).
NOINLINE void ell(Fq12& f, const Fq2 L[3], const uint32_t px[8], const uint32_t py[8]) {
  Fq2 s0, s3;
  f2_mul_fq(s0, L[0], py);
  f2_mul_fq(s3, L[1], px);
  f12_mul_by_034(f, s0, s3, L[2]);
}

// The untwist-Frobenius-twist endomorphism on an affine twist point.
NOINLINE void mul_by_char(Fq2& rx, Fq2& ry, const Fq2& qx, const Fq2& qy) {
  Fq2 c, k = kC.twist_qx;
  f2_conj(c, qx);
  f2_mul(rx, c, k);
  k = kC.twist_qy;
  f2_conj(c, qy);
  f2_mul(ry, c, k);
}

NOINLINE void miller(Fq12& f, const uint32_t px[8], const uint32_t py[8], const Fq2& qx,
                     const Fq2& qy) {
  Fq2 R[3], L[3];
  R[0] = qx;
  R[1] = qy;
#pragma unroll
  for (int k = 0; k < 8; ++k) R[2].c[0][k] = R[2].c[1][k] = 0;
  fq_copy(R[2].c[0], kC.one);
  f12_one(f);
#pragma unroll 1
  for (int i = (int)kC.ate_bits - 1; i >= 0; --i) {
    f12_sqr(f, f);
    dbl_step(R, L);
    ell(f, L, px, py);
    if (bit_of(kC.ate, i)) {
      add_step(R, qx, qy, L);
      ell(f, L, px, py);
    }
  }
  // the last two addition steps, with q1 = pi(Q) and q2 = -pi^2(Q)
  Fq2 q1x, q1y, q2x, q2y;
  mul_by_char(q1x, q1y, qx, qy);
  mul_by_char(q2x, q2y, q1x, q1y);
  add_step(R, q1x, q1y, L);
  ell(f, L, px, py);
  f2_neg(q2y, q2y);
  add_step(R, q2x, q2y, L);
  ell(f, L, px, py);
}

// -- final exponentiation ---------------------------------------------------

// r = a^(-x) for a in the cyclotomic subgroup, where the inverse is the
// conjugate.
NOINLINE void exp_by_neg_x(Fq12& r, const Fq12& a) {
  Fq12 x = a, acc = a;
#pragma unroll 1
  for (int i = (int)kC.x_bits - 1; i >= 0; --i) {
    f12_sqr(acc, acc);
    if (bit_of(kC.x, i)) f12_mul(acc, acc, x);
  }
  f12_conj(r, acc);
}

// The easy part f^((q^6 - 1)(q^2 + 1)), then the hard part's x-adic chain
// (`final_exp_plain`, step for step).
NOINLINE void final_exp(Fq12& f) {
  Fq12 r, t, y1, y3, y4, y8, y9;
  f12_inv(t, f);
  f12_conj(f, f);
  f12_mul(f, f, t);
  f12_frob(t, f, 2);
  f12_mul(r, t, f);
  exp_by_neg_x(t, r);        // y0
  f12_sqr(y1, t);
  f12_sqr(t, y1);            // y2
  f12_mul(y3, t, y1);
  exp_by_neg_x(y4, y3);
  f12_sqr(t, y4);            // y5
  exp_by_neg_x(t, t);
  f12_conj(t, t);            // y6
  f12_conj(y3, y3);
  f12_mul(t, t, y4);         // y7
  f12_mul(y8, t, y3);
  f12_mul(y9, y8, y1);
  f12_mul(t, y8, y4);        // y10
  f12_mul(y4, t, r);         // y11
  f12_frob(t, y9, 1);
  f12_mul(y4, t, y4);        // y13
  f12_frob(t, y8, 2);
  f12_mul(y4, t, y4);        // y14
  f12_conj(t, r);
  f12_mul(t, t, y9);
  f12_frob(t, t, 3);         // y15
  f12_mul(f, t, y4);
}

// -- kernels ----------------------------------------------------------------

__global__ void __launch_bounds__(LSK_PAIRING_THREADS)
    pairing_miller_kernel(const uint32_t* __restrict__ px, const uint32_t* __restrict__ py,
                          const uint32_t* __restrict__ pz, const uint32_t* __restrict__ qx,
                          const uint32_t* __restrict__ qy, const uint32_t* __restrict__ qz,
                          uint32_t* __restrict__ out, int64_t n, int64_t total) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t q = e / n, i = e % n;
  const int64_t b1 = q * 8 * n + i, b2 = q * 16 * n + i;
  uint32_t x[8], y[8], z[8];
  Fq2 X, Y, Z;
  load8(x, px, b1, n);
  load8(y, py, b1, n);
  load8(z, pz, b1, n);
  load_fq2(X, qx, b2, n);
  load_fq2(Y, qy, b2, n);
  load_fq2(Z, qz, b2, n);
  Fq12 f;
  if (fq_is_zero(z) || f2_is_zero(Z)) {
    f12_one(f);
  } else {
    fq_inv(z, z);
    fq_mul(x, x, z);
    fq_mul(y, y, z);
    f2_inv(Z, Z);
    f2_mul(X, X, Z);
    f2_mul(Y, Y, Z);
    miller(f, x, y, X, Y);
  }
  store_f12_canon(out, f, q * 96 * n + i, n);
}

__global__ void __launch_bounds__(LSK_PAIRING_THREADS)
    pairing_final_exp_kernel(const uint32_t* __restrict__ fs, int64_t n_in, int64_t total_in,
                             const int64_t* __restrict__ idx, int64_t products, int64_t width,
                             uint32_t* __restrict__ out, int64_t n_out) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= products) return;
  Fq12 acc, t;
  bool first = true;
#pragma unroll 1
  for (int64_t w = 0; w < width; ++w) {
    const int64_t e = idx[k * width + w];
    if (e < 0 || e >= total_in) continue;  // stands for 1
    load_f12(t, fs, (e / n_in) * 96 * n_in + e % n_in, n_in);
    if (first) {
      acc = t;
    } else {
      f12_mul(acc, acc, t);
    }
    first = false;
  }
  if (first) f12_one(acc);
  final_exp(acc);
  store_f12_canon(out, acc, (k / n_out) * 96 * n_out + k % n_out, n_out);
}

static int set_consts(const uint32_t* consts, cudaStream_t stream) {
  return (int)cudaMemcpyToSymbolAsync(kC, consts, sizeof(PairingConsts), 0,
                                      cudaMemcpyHostToDevice, stream);
}

// consts: the PairingConsts block (375 words).
extern "C" int lsk_pairing_miller(const void* px, const void* py, const void* pz, const void* qx,
                                  const void* qy, const void* qz, void* out, long long n,
                                  long long total, const uint32_t* consts, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = set_consts(consts, s);
  if (err) return err;
  pairing_miller_kernel<<<grid_for(total, LSK_PAIRING_THREADS), LSK_PAIRING_THREADS, 0, s>>>(
      (const uint32_t*)px, (const uint32_t*)py, (const uint32_t*)pz, (const uint32_t*)qx,
      (const uint32_t*)qy, (const uint32_t*)qz, (uint32_t*)out, n, total);
  return (int)cudaGetLastError();
}

extern "C" int lsk_pairing_final_exp(const void* fs, long long n_in, long long total_in,
                                     const void* idx, long long products, long long width,
                                     void* out, long long n_out, const uint32_t* consts,
                                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const int err = set_consts(consts, s);
  if (err) return err;
  pairing_final_exp_kernel<<<grid_for(products, LSK_PAIRING_THREADS), LSK_PAIRING_THREADS, 0,
                             s>>>((const uint32_t*)fs, n_in, total_in, (const int64_t*)idx,
                                  products, width, (uint32_t*)out, n_out);
  return (int)cudaGetLastError();
}

extern "C" const char* lsk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
