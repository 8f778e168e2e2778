// K5 / K6: the complete projective G2 addition and doubling on BN254 over
// Fq2 = Fq[u]/(u^2 + 1) (Renes-Costello-Batina, eprint 2015/1060,
// Algorithms 7 and 9, a = 0, b3 = 3b' with b' = 3 / (9 + u)). K5 is one
// addition per launch; K6 runs `times` >= 1 doublings of each point in one
// launch, the point in registers between them, as K3 does on G1.
//
// Replaces no Pallas kernel: the JAX package's G2 group law
// (`legosnark_tpu/curve/group.py`, `rcb_add` / `rcb_double` over its Fq2
// ops) is jnp code. Added because that law, run op by op in torch code (an
// Fq2 product as one stacked K1 launch, each Fq add or sub a dozen int64
// launches), was most of Groth16's prove: the G2 MSM's scans, bucket sums
// and Horner combine.
//
// Layout: coordinates [.., 2, 8, n] of uint32 words; element e has c0's
// limb k at (e / n) * 16n + k*n + e % n and c1's 8n further on, so a warp
// reads 32 neighbouring words per limb.
//
// Bit-identity with the plain versions (`g2_add_points_plain` /
// `g2_double_point_plain` in curve/cuda_group.py: `rcb_add` / `rcb_double`
// over `Fq2Ops`): every Fq operation is field_cc.cuh's, whose value depends
// only on its operands and equals the torch field code's under the [0, 2p)
// contract, and each Fq2 operation is built from exactly the Fq operations
// of `fields/ops.Fq2Ops` (csrc/fq2_cc.cuh). A product's value does not
// depend on the order of its operands, so b3 * t may run as t * b3, with
// b3's s (b3_0 + b3_1, reduced as add_cc reduces) in the constant block.
// The group law's Fq2 operations are those of `rcb_add` / `rcb_double`, in
// K2/K3's order (the same values, reordered so that values die early).
//
// What bounds it on an H100, and what the design does about it:
// * At 2^20 points, integer multiplies: an addition is 14 Fq2 products (42
//   Montgomery products), a doubling 7 products and 2 squares (25), each
//   product 264 multiply instructions, against 576 / 384 bytes per point.
// * Registers and code. An Fq2 value is 16 words, so RCB addition's live
//   set is about twice K2's (about 9 Fq2 values at its peak beside a
//   product's own words): both kernels run one thread per point under
//   launch bounds that allow up to 255 registers (2 blocks of 128 threads
//   per SM). K6's loop body, 25 unrolled products (6.2k SASS
//   instructions), then takes 214 registers and runs at 78-86% of its
//   bound. K5 unrolled is 42 products, 10.6k instructions, 254 registers
//   and 50% of its bound whatever the occupancy (3 and 4 blocks per SM,
//   with spills, read the same): the size of its code, not its registers,
//   holds it back, as an overflowing instruction cache would. So K5 runs
//   each Fq2 product's three Karatsuba products as a loop of three passes
//   over one product's code (`karatsuba_loop`; the pass is the same for
//   the whole warp and picks the operands): 6.9k instructions, 188
//   registers, no spills, 65% of its bound. Rolling each product's rows
//   into a loop as well (b's words shifted down a place per row) cut K5
//   to 7.5k instructions but took K6 to 54%, so neither kernel does it.
// * At widths <= 32 (the MSM's Horner combine, the fixed-base table's
//   chain of doublings, the key's scalar multiplications): one warp or
//   less, so the latency of one thread's chain of products and the
//   host's launch; K6's `times` makes a Horner step's c = 17 doublings one
//   launch.
#include "fq2_cc.cuh"

#define LSK_G2_THREADS 128
// Blocks per SM the launch bounds ask for: as many as leave a thread 255
// registers (ptxas's cap), 2 of 128 threads.
#define G2_MIN_BLOCKS (65536 / (LSK_G2_THREADS * 256))

struct G2Consts {
  Field F;
  uint32_t b3[2][8];  // 3b' in Montgomery form, (c0, c1)
  uint32_t b3s[8];    // b3's c0 + c1, as add_cc forms it
};

// r = a * b3 = b3 * a, the same Fq operations as fq2_mul(b3, a). r may alias a.
template <int MODE>
__device__ __forceinline__ void fq2_mul_b3(Fq2& r, const Fq2& a, const G2Consts& C) {
  const Field& F = C.F;
  uint32_t t0[8], t1[8], t2[8];
  if constexpr (MODE == 1) {
    karatsuba_loop(t0, t1, t2, a.c[0], a.c[1], C.b3[0], C.b3[1], C.b3s, F);
  } else {
    add_cc(t2, a.c[0], a.c[1], F);
    mul_cc(t2, C.b3s, t2, F);
    mul_cc(t0, C.b3[0], a.c[0], F);
    mul_cc(t1, C.b3[1], a.c[1], F);
  }
  sub_cc(r.c[0], t0, t1, F);
  add_cc(t0, t0, t1, F);
  sub_cc(r.c[1], t2, t0, F);
}

__global__ void __launch_bounds__(LSK_G2_THREADS, G2_MIN_BLOCKS)
    g2_add_kernel(const uint32_t* __restrict__ x1, const uint32_t* __restrict__ y1,
                  const uint32_t* __restrict__ z1, const uint32_t* __restrict__ x2,
                  const uint32_t* __restrict__ y2, const uint32_t* __restrict__ z2,
                  uint32_t* __restrict__ xo, uint32_t* __restrict__ yo,
                  uint32_t* __restrict__ zo, int64_t n, int64_t total, G2Consts C) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const Field& F = C.F;
  const int64_t base = elem_base16_cc(e, n, total);
  // RCB Algorithm 7 in K2's order (inputs loaded at first use, outputs
  // stored at once).
  Fq2 X1, Y1, Z1, X2, Y2, Z2, u, v, t0, t1, t2, t3, t4, X3, Y3, Z3;
  load_fq2(X1, x1, base, n);
  load_fq2(Y1, y1, base, n);
  load_fq2(X2, x2, base, n);
  load_fq2(Y2, y2, base, n);
  fq2_add(u, X1, Y1, F);
  fq2_add(v, X2, Y2, F);
  fq2_mul<1>(t3, u, v, F);            // (X1 + Y1)(X2 + Y2)
  fq2_mul<1>(t0, X1, X2, F);
  load_fq2(Z1, z1, base, n);
  load_fq2(Z2, z2, base, n);
  fq2_add(u, X1, Z1, F);
  fq2_add(v, X2, Z2, F);
  fq2_mul<1>(X3, u, v, F);            // (X1 + Z1)(X2 + Z2)
  fq2_add(u, Y1, Z1, F);           // Y1 + Z1
  fq2_mul<1>(t2, Z1, Z2, F);
  fq2_add(v, t0, t2, F);
  fq2_sub(Y3, X3, v, F);           // Y3 = X1 Z2 + X2 Z1
  fq2_mul<1>(t1, Y1, Y2, F);
  fq2_add(X3, t0, t0, F);
  fq2_add(v, Y2, Z2, F);           // Y2 + Z2
  fq2_mul_b3<1>(Y3, Y3, C);
  fq2_add(Z3, t0, t1, F);
  fq2_sub(t3, t3, Z3, F);          // t3 = X1 Y2 + X2 Y1
  fq2_mul<1>(t4, u, v, F);
  fq2_add(u, t1, t2, F);
  fq2_sub(t4, t4, u, F);           // t4 = Y1 Z2 + Y2 Z1
  fq2_add(t0, X3, t0, F);          // 3 t0
  fq2_mul_b3<1>(t2, t2, C);
  fq2_add(Z3, t1, t2, F);
  fq2_sub(t1, t1, t2, F);
  fq2_mul<1>(X3, t4, Y3, F);
  fq2_mul<1>(u, t3, t1, F);
  fq2_sub(X3, u, X3, F);
  store_fq2(xo, X3, base, n);
  fq2_mul<1>(Y3, Y3, t0, F);
  fq2_mul<1>(t1, t1, Z3, F);
  fq2_add(Y3, t1, Y3, F);
  store_fq2(yo, Y3, base, n);
  fq2_mul<1>(t0, t0, t3, F);
  fq2_mul<1>(Z3, Z3, t4, F);
  fq2_add(Z3, Z3, t0, F);
  store_fq2(zo, Z3, base, n);
}

__global__ void __launch_bounds__(LSK_G2_THREADS, G2_MIN_BLOCKS)
    g2_double_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ y,
                     const uint32_t* __restrict__ z, uint32_t* __restrict__ xo,
                     uint32_t* __restrict__ yo, uint32_t* __restrict__ zo, int64_t n,
                     int64_t total, int times, G2Consts C) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const Field& F = C.F;
  const int64_t base = elem_base16_cc(e, n, total);
  Fq2 X, Y, Z;
  load_fq2(X, x, base, n);
  load_fq2(Y, y, base, n);
  load_fq2(Z, z, base, n);
  // RCB Algorithm 9, `times` times in registers, in K3's order.
#pragma unroll 1
  for (int k = 0; k < times; ++k) {
    Fq2 t0, t1, t2, t3;
    fq2_mul<0>(t3, X, Y, F);
    fq2_sqr(t0, Y, F);
    fq2_mul<0>(t1, Y, Z, F);
    fq2_sqr(t2, Z, F);
    fq2_mul_b3<0>(t2, t2, C);
    fq2_add(Z, t0, t0, F);
    fq2_add(Z, Z, Z, F);
    fq2_add(Y, Z, Z, F);           // 8 t0
    fq2_mul<0>(Z, t1, Y, F);          // Z3
    fq2_mul<0>(X, t2, Y, F);          // t2 * 8 t0
    fq2_add(Y, t0, t2, F);
    fq2_add(t1, t2, t2, F);
    fq2_add(t1, t1, t2, F);
    fq2_sub(t0, t0, t1, F);        // t0 - 3 t2
    fq2_mul<0>(Y, t0, Y, F);
    fq2_add(Y, X, Y, F);           // Y3
    fq2_mul<0>(X, t0, t3, F);
    fq2_add(X, X, X, F);           // X3
  }
  store_fq2(xo, X, base, n);
  store_fq2(yo, Y, base, n);
  store_fq2(zo, Z, base, n);
}

static G2Consts g2_consts(const uint32_t* w) {
  G2Consts C;
  C.F = field_from_words(w);
  for (int k = 0; k < 8; ++k) {
    C.b3[0][k] = w[17 + k];
    C.b3[1][k] = w[25 + k];
    C.b3s[k] = w[33 + k];
  }
  return C;
}

// consts: p[8], 2p[8], -p^-1 mod 2^32, b3 c0 and c1 (Montgomery)[8 + 8],
// their sum b3s[8].
extern "C" int lsk_g2_add(const void* x1, const void* y1, const void* z1, const void* x2,
                          const void* y2, const void* z2, void* xo, void* yo, void* zo,
                          long long n, long long total, const uint32_t* consts, void* stream) {
  g2_add_kernel<<<grid_for(total, LSK_G2_THREADS), LSK_G2_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)x1, (const uint32_t*)y1, (const uint32_t*)z1, (const uint32_t*)x2,
      (const uint32_t*)y2, (const uint32_t*)z2, (uint32_t*)xo, (uint32_t*)yo, (uint32_t*)zo, n,
      total, g2_consts(consts));
  return (int)cudaGetLastError();
}

// times >= 1 doublings of each point (the wrapper checks it).
extern "C" int lsk_g2_double(const void* x, const void* y, const void* z, void* xo, void* yo,
                             void* zo, long long n, long long total, int times,
                             const uint32_t* consts, void* stream) {
  g2_double_kernel<<<grid_for(total, LSK_G2_THREADS), LSK_G2_THREADS, 0,
                     (cudaStream_t)stream>>>(
      (const uint32_t*)x, (const uint32_t*)y, (const uint32_t*)z, (uint32_t*)xo, (uint32_t*)yo,
      (uint32_t*)zo, n, total, times, g2_consts(consts));
  return (int)cudaGetLastError();
}

extern "C" const char* lsk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
