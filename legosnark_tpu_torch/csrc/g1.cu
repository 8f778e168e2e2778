// K2 / K3: the complete projective G1 addition and doubling on BN254
// (Renes-Costello-Batina, eprint 2015/1060, Algorithms 7 and 9, a = 0,
// b3 = 3b = 9), one launch per group operation.
//
// Replaces the Pallas kernels `legosnark_tpu/curve/pallas_group.py`
// (`_mk_add_kernel`, `_mk_double_kernel`, built by `_build`, wrappers
// `add_points` / `double_point`).
//
// The TPU kernels' lazy reduction (values up to 3.62p between products,
// loose 13-bit limbs, fsub offsets D_K, int8 MXU Toeplitz reduction) rests
// on R/p ~ 84. With 32-bit limbs R/p ~ 5.29: a product of inputs < jp and
// < kp is < p(0.19jk + 1), so that budget is gone. Here every intermediate
// stays in [0, 2p): fadd/fsub reduce modulo 2p and fmul returns < 1.76p
// for inputs < 2p (field.cuh). Outputs obey the same [0, 2p) contract as
// the torch field code at every width, and the operation sequence is the
// one of `add_plain` / `double_plain` in curve/cuda_group.py, so kernel and
// plain version agree bit for bit.
//
// What bounds it on an H100: integer multiplies. An add is 14 Montgomery
// products (12 + 2 by b3), a double 9 (8 + 1). Each product takes 264
// 32-bit multiply instructions (128 word products, low and high word, and
// 8 low-word m = t[0] * pinv), i.e. 3696 / 2376 per point against 192 / 96
// bytes read and 96 written.
//
// Design: one thread per point, all coordinates and temporaries in
// registers, limb-major coalesced loads and stores.
#include "field.cuh"

struct G1Consts {
  Field F;
  uint32_t b3[8];  // 3b in Montgomery form
};

__global__ void g1_add_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                              const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                              const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                              uint32_t* __restrict__ xo, uint32_t* __restrict__ yo,
                              uint32_t* __restrict__ zo, int64_t n, int64_t total, G1Consts C) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const Field& F = C.F;
  int64_t base = elem_base(e, n);
  uint32_t X1[8], Y1[8], Z1[8], X2[8], Y2[8], Z2[8];
  load8(X1, x1, base, n);
  load8(Y1, y1, base, n);
  load8(Z1, z1, base, n);
  load8(X2, x2, base, n);
  load8(Y2, y2, base, n);
  load8(Z2, z2, base, n);

  uint32_t t0[8], t1[8], t2[8], t3[8], t4[8], X3[8], Y3[8], Z3[8], u[8], v[8];
  fmul(t0, X1, X2, F);
  fmul(t1, Y1, Y2, F);
  fmul(t2, Z1, Z2, F);
  fadd(u, X1, Y1, F);
  fadd(v, X2, Y2, F);
  fmul(t3, u, v, F);
  fadd(u, t0, t1, F);
  fsub(t3, t3, u, F);
  fadd(u, Y1, Z1, F);
  fadd(v, Y2, Z2, F);
  fmul(t4, u, v, F);
  fadd(u, t1, t2, F);
  fsub(t4, t4, u, F);
  fadd(u, X1, Z1, F);
  fadd(v, X2, Z2, F);
  fmul(X3, u, v, F);
  fadd(u, t0, t2, F);
  fsub(Y3, X3, u, F);
  fadd(X3, t0, t0, F);
  fadd(t0, X3, t0, F);
  fmul(t2, C.b3, t2, F);
  fadd(Z3, t1, t2, F);
  fsub(t1, t1, t2, F);
  fmul(Y3, C.b3, Y3, F);
  fmul(X3, t4, Y3, F);
  fmul(u, t3, t1, F);
  fsub(X3, u, X3, F);
  fmul(Y3, Y3, t0, F);
  fmul(t1, t1, Z3, F);
  fadd(Y3, t1, Y3, F);
  fmul(t0, t0, t3, F);
  fmul(Z3, Z3, t4, F);
  fadd(Z3, Z3, t0, F);

  store8(xo, X3, base, n);
  store8(yo, Y3, base, n);
  store8(zo, Z3, base, n);
}

__global__ void g1_double_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                                 const uint32_t* __restrict__ z, uint32_t* __restrict__ xo,
                                 uint32_t* __restrict__ yo, uint32_t* __restrict__ zo,
                                 int64_t n, int64_t total, G1Consts C) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const Field& F = C.F;
  int64_t base = elem_base(e, n);
  uint32_t X[8], Y[8], Z[8];
  load8(X, x, base, n);
  load8(Y, y, base, n);
  load8(Z, z, base, n);

  uint32_t t0[8], t1[8], t2[8], X3[8], Y3[8], Z3[8];
  fmul(t0, Y, Y, F);
  fadd(Z3, t0, t0, F);
  fadd(Z3, Z3, Z3, F);
  fadd(Z3, Z3, Z3, F);
  fmul(t1, Y, Z, F);
  fmul(t2, Z, Z, F);
  fmul(t2, C.b3, t2, F);
  fmul(X3, t2, Z3, F);
  fadd(Y3, t0, t2, F);
  fmul(Z3, t1, Z3, F);
  fadd(t1, t2, t2, F);
  fadd(t2, t1, t2, F);
  fsub(t0, t0, t2, F);
  fmul(Y3, t0, Y3, F);
  fadd(Y3, X3, Y3, F);
  fmul(t1, X, Y, F);
  fmul(X3, t0, t1, F);
  fadd(X3, X3, X3, F);

  store8(xo, X3, base, n);
  store8(yo, Y3, base, n);
  store8(zo, Z3, base, n);
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
  const int threads = 128;
  g1_add_kernel<<<grid_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
      (const uint32_t*)y2, (const uint32_t*)z2, (uint32_t*)xo, (uint32_t*)yo, (uint32_t*)zo, n,
      total, g1_consts(consts));
  return (int)cudaGetLastError();
}

extern "C" int lsk_g1_double(const void* x, const void* y, const void* z, void* xo, void* yo,
                             void* zo, long long n, long long total, const uint32_t* consts,
                             void* stream) {
  const int threads = 128;
  g1_double_kernel<<<grid_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, (uint32_t*)xo, (uint32_t*)yo,
      (uint32_t*)zo, n, total, g1_consts(consts));
  return (int)cudaGetLastError();
}

extern "C" const char* lsk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
