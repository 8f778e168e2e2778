// K2 / K3: the complete projective G1 addition and doubling on BN254
// (Renes-Costello-Batina, eprint 2015/1060, Algorithms 7 and 9, a = 0,
// b3 = 3b = 9). K2 is one addition per launch; K3 runs `times` >= 1
// doublings of each point in one launch.
//
// Replaces the Pallas kernels `legosnark_tpu/curve/pallas_group.py`
// (`_mk_add_kernel`, `_mk_double_kernel`, built by `_build`, wrappers
// `add_points` / `double_point`); K3's `times` is the counterpart of the JAX
// MSM's `jax.lax.fori_loop(0, c, lambda _, a: C.double(a), acc)`.
//
// The TPU kernels' lazy reduction (values up to 3.62p between products,
// loose 13-bit limbs, fsub offsets D_K, int8 MXU Toeplitz reduction) rests
// on R/p ~ 84. With 32-bit limbs R/p ~ 5.29: a product of inputs < jp and
// < kp is < p(0.19jk + 1), so that budget is gone. Here every intermediate
// stays in [0, 2p): add/sub reduce modulo 2p and the product returns < 1.76p
// for inputs < 2p (field_cc.cuh). Outputs obey the same [0, 2p) contract as
// the torch field code at every width. Each field operation's value depends
// only on its operands, and the operations are those of `add_plain` /
// `double_plain` in curve/cuda_group.py, in another order (below), so
// kernel and plain version agree bit for bit.
//
// What bounds it on an H100, and what the design does about it:
// * At 2^20 points, integer multiplies. An add is 14 Montgomery products
//   (12 + 2 by b3), a double 9 (8 + 1). Each product takes 264 32-bit
//   multiply instructions (128 word products, low and high word, and 8
//   low-word m = t[0] * pinv), i.e. 3696 / 2376 per point against 192 / 96
//   bytes read and 96 written. The field arithmetic (field_cc.cuh) is PTX
//   carry chains in an even/odd CIOS schedule, which the card runs as one
//   wide multiply-add with carry (IMAD.WIDE.U32.X) per word product, low
//   and high word together, with no separate adds; the product keeps nine
//   words, not ten. The operations are ordered so that values die early
//   (a search over the orders the formulas allow), so K2 fits 128
//   registers and K3 96 (__launch_bounds__), which leaves 16 and 20 warps
//   per SM to hide the latency of the carry chains.
// * At widths <= 32 (the MSM's Horner tails, the fixed-base table's chain of
//   doublings, scalar multiplication at the verifier's widths): one warp or
//   less, so the latency of one thread's chain of products and the host's
//   launch. K3 runs `times` doublings with the point in registers between
//   them: one launch, one load and one store for the c doublings of a
//   Horner step instead of c of each.
#include "field_cc.cuh"

// Block size: of 128 and 256 threads, 256 read 1-3% slower at 2^20 and 30-50%
// slower at width 2^10 (PERF.md, the kernel table's notes).
#define LSK_G1_THREADS 128
// At most 128 registers for K2 and 96 for K3 (65536 per SM).
#define K2_MIN_BLOCKS (65536 / (LSK_G1_THREADS * 128))
#define K3_MIN_BLOCKS (65536 / (LSK_G1_THREADS * 96))

struct G1Consts {
  Field F;
  uint32_t b3[8];  // 3b in Montgomery form
};

__global__ void __launch_bounds__(LSK_G1_THREADS, K2_MIN_BLOCKS)
    g1_add_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                  const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                  const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                  uint32_t* __restrict__ xo, uint32_t* __restrict__ yo,
                  uint32_t* __restrict__ zo, int64_t n, int64_t total, G1Consts C) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const Field& F = C.F;
  const int64_t base = elem_base_cc(e, n, total);
  // RCB Algorithm 7 in the order that keeps the fewest 8-word values live
  // (inputs loaded at first use, outputs stored at once).
  uint32_t X1[8], Y1[8], Z1[8], X2[8], Y2[8], Z2[8], u[8], v[8];
  uint32_t t0[8], t1[8], t2[8], t3[8], t4[8], X3[8], Y3[8], Z3[8];
  load8(X1, x1, base, n);
  load8(Y1, y1, base, n);
  load8(X2, x2, base, n);
  load8(Y2, y2, base, n);
  add_cc(u, X1, Y1, F);
  add_cc(v, X2, Y2, F);
  mul_cc(t3, u, v, F);             // (X1 + Y1)(X2 + Y2)
  mul_cc(t0, X1, X2, F);
  load8(Z1, z1, base, n);
  load8(Z2, z2, base, n);
  add_cc(u, X1, Z1, F);
  add_cc(v, X2, Z2, F);
  mul_cc(X3, u, v, F);             // (X1 + Z1)(X2 + Z2)
  add_cc(u, Y1, Z1, F);            // Y1 + Z1
  mul_cc(t2, Z1, Z2, F);
  add_cc(v, t0, t2, F);
  sub_cc(Y3, X3, v, F);            // Y3 = X1 Z2 + X2 Z1
  mul_cc(t1, Y1, Y2, F);
  add_cc(X3, t0, t0, F);
  add_cc(v, Y2, Z2, F);            // Y2 + Z2
  mul_cc(Y3, C.b3, Y3, F);
  add_cc(Z3, t0, t1, F);
  sub_cc(t3, t3, Z3, F);           // t3 = X1 Y2 + X2 Y1
  mul_cc(t4, u, v, F);
  add_cc(u, t1, t2, F);
  sub_cc(t4, t4, u, F);            // t4 = Y1 Z2 + Y2 Z1
  add_cc(t0, X3, t0, F);           // 3 t0
  mul_cc(t2, C.b3, t2, F);
  add_cc(Z3, t1, t2, F);
  sub_cc(t1, t1, t2, F);
  mul_cc(X3, t4, Y3, F);
  mul_cc(u, t3, t1, F);
  sub_cc(X3, u, X3, F);
  store8(xo, X3, base, n);
  mul_cc(Y3, Y3, t0, F);
  mul_cc(t1, t1, Z3, F);
  add_cc(Y3, t1, Y3, F);
  store8(yo, Y3, base, n);
  mul_cc(t0, t0, t3, F);
  mul_cc(Z3, Z3, t4, F);
  add_cc(Z3, Z3, t0, F);
  store8(zo, Z3, base, n);
}

__global__ void __launch_bounds__(LSK_G1_THREADS, K3_MIN_BLOCKS)
    g1_double_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                     const uint32_t* __restrict__ z, uint32_t* __restrict__ xo,
                     uint32_t* __restrict__ yo, uint32_t* __restrict__ zo, int64_t n,
                     int64_t total, int times, G1Consts C) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const Field& F = C.F;
  const int64_t base = elem_base_cc(e, n, total);
  uint32_t X[8], Y[8], Z[8];
  load8(X, x, base, n);
  load8(Y, y, base, n);
  load8(Z, z, base, n);
  // RCB Algorithm 9, `times` times in registers, in the order that keeps
  // the fewest 8-word values live.
#pragma unroll 1
  for (int k = 0; k < times; ++k) {
    uint32_t t0[8], t1[8], t2[8], t3[8];
    mul_cc(t3, X, Y, F);
    mul_cc(t0, Y, Y, F);
    mul_cc(t1, Y, Z, F);
    mul_cc(t2, Z, Z, F);
    mul_cc(t2, C.b3, t2, F);
    add_cc(Z, t0, t0, F);
    add_cc(Z, Z, Z, F);
    add_cc(Y, Z, Z, F);            // 8 t0
    mul_cc(Z, t1, Y, F);           // Z3
    mul_cc(X, t2, Y, F);           // t2 * 8 t0
    add_cc(Y, t0, t2, F);
    add_cc(t1, t2, t2, F);
    add_cc(t1, t1, t2, F);
    sub_cc(t0, t0, t1, F);         // t0 - 3 t2
    mul_cc(Y, t0, Y, F);
    add_cc(Y, X, Y, F);            // Y3
    mul_cc(X, t0, t3, F);
    add_cc(X, X, X, F);            // X3
  }
  store8(xo, X, base, n);
  store8(yo, Y, base, n);
  store8(zo, Z, base, n);
}

static G1Consts g1_consts(const uint32_t* w) {
  G1Consts C;
  C.F = field_from_words(w);
  for (int k = 0; k < 8; ++k) C.b3[k] = w[17 + k];
  return C;
}

// consts: p[8], 2p[8], -p^-1 mod 2^32, b3 (Montgomery)[8].
extern "C" int lsk_g1_add(const void* x1, const void* y1, const void* z1, const void* x2,
                          const void* y2, const void* z2, void* xo, void* yo, void* zo,
                          long long n, long long total, const uint32_t* consts, void* stream) {
  g1_add_kernel<<<grid_for(total, LSK_G1_THREADS), LSK_G1_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
      (const uint32_t*)y2, (const uint32_t*)z2, (uint32_t*)xo, (uint32_t*)yo, (uint32_t*)zo, n,
      total, g1_consts(consts));
  return (int)cudaGetLastError();
}

// times >= 1 doublings of each point (the wrapper checks it).
extern "C" int lsk_g1_double(const void* x, const void* y, const void* z, void* xo, void* yo,
                             void* zo, long long n, long long total, int times,
                             const uint32_t* consts, void* stream) {
  g1_double_kernel<<<grid_for(total, LSK_G1_THREADS), LSK_G1_THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, (uint32_t*)xo, (uint32_t*)yo,
      (uint32_t*)zo, n, total, times, g1_consts(consts));
  return (int)cudaGetLastError();
}

extern "C" const char* lsk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
