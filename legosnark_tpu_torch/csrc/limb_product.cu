// P2: the exact 512-bit product of two 256-bit operands, [8, n] x [8, n] ->
// [16, n] words with no reduction, in three formulations: the probe of where
// a Montgomery product's time goes.
//
// Replaces the Pallas kernel `scripts/probe_conv.py` (`run`, launching the
// kernel bodies `k_mul`, `k_scratch`, `k_pad`, `k_rows`, `k_roll` and
// `k_dot` on the TPU's 20 x 13-bit limbs). Variants (argument `variant`):
//   0 floor   <- k_mul: one multiply per output word (out[k], out[8+k] =
//                low, high word of a[k]*b[k]); the bandwidth floor, not a
//                product;
//   1 operand <- k_scratch, k_pad, k_roll: three TPU spellings of one
//                row-shifted accumulation, here one operand-scanning loop,
//                a row a*b[i] added per step with mad.lo.cc / madc.hi carry
//                chains;
//   2 product <- k_rows: column-wise (Comba) accumulation, every product of
//                a column into a three-word accumulator.
// k_dot, the TPU's inexact f32 tensor-unit variant, has its exact card
// counterpart in P1b's u8 tensor-core path (csrc/mont_tc.cu).
//
// What bounds it on an H100: bytes. 64 bytes read and 64 written per
// element against 128 multiply instructions (64 word products, low and
// high word; 16 for floor).
//
// Design: one thread per element, operands and the 16-word result in
// registers, limb-major coalesced loads and stores.
#include "field.cuh"

namespace {

// t[0..8] += a * b as two carry chains: the low words into t[0..7] (the
// carry into t[8], which is 0 before), then the high words into t[1..8].
__device__ __forceinline__ void row_mac(uint32_t& t0, uint32_t& t1, uint32_t& t2, uint32_t& t3,
                                        uint32_t& t4, uint32_t& t5, uint32_t& t6, uint32_t& t7,
                                        uint32_t& t8, const uint32_t a[8], uint32_t b) {
  asm("mad.lo.cc.u32  %0, %9,  %17, %0;\n\t"
      "madc.lo.cc.u32 %1, %10, %17, %1;\n\t"
      "madc.lo.cc.u32 %2, %11, %17, %2;\n\t"
      "madc.lo.cc.u32 %3, %12, %17, %3;\n\t"
      "madc.lo.cc.u32 %4, %13, %17, %4;\n\t"
      "madc.lo.cc.u32 %5, %14, %17, %5;\n\t"
      "madc.lo.cc.u32 %6, %15, %17, %6;\n\t"
      "madc.lo.cc.u32 %7, %16, %17, %7;\n\t"
      "addc.u32       %8, %8, 0;\n\t"
      "mad.hi.cc.u32  %1, %9,  %17, %1;\n\t"
      "madc.hi.cc.u32 %2, %10, %17, %2;\n\t"
      "madc.hi.cc.u32 %3, %11, %17, %3;\n\t"
      "madc.hi.cc.u32 %4, %12, %17, %4;\n\t"
      "madc.hi.cc.u32 %5, %13, %17, %5;\n\t"
      "madc.hi.cc.u32 %6, %14, %17, %6;\n\t"
      "madc.hi.cc.u32 %7, %15, %17, %7;\n\t"
      "madc.hi.u32    %8, %16, %17, %8;"
      : "+r"(t0), "+r"(t1), "+r"(t2), "+r"(t3), "+r"(t4), "+r"(t5), "+r"(t6), "+r"(t7),
        "+r"(t8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]), "r"(a[6]),
        "r"(a[7]), "r"(b));
}

__device__ __forceinline__ void product_operand(uint32_t t[16], const uint32_t a[8],
                                                const uint32_t b[8]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    row_mac(t[i], t[i + 1], t[i + 2], t[i + 3], t[i + 4], t[i + 5], t[i + 6], t[i + 7],
            t[i + 8], a, b[i]);
}

// (c0, c1, c2) += x * y
__device__ __forceinline__ void mac3(uint32_t& c0, uint32_t& c1, uint32_t& c2, uint32_t x,
                                     uint32_t y) {
  asm("mad.lo.cc.u32  %0, %3, %4, %0;\n\t"
      "madc.hi.cc.u32 %1, %3, %4, %1;\n\t"
      "addc.u32       %2, %2, 0;"
      : "+r"(c0), "+r"(c1), "+r"(c2)
      : "r"(x), "r"(y));
}

__device__ __forceinline__ void product_comba(uint32_t t[16], const uint32_t a[8],
                                              const uint32_t b[8]) {
  uint32_t c0 = 0, c1 = 0, c2 = 0;
#pragma unroll
  for (int k = 0; k < 15; ++k) {
#pragma unroll
    for (int i = (k < 8 ? 0 : k - 7); i <= (k < 8 ? k : 7); ++i) mac3(c0, c1, c2, a[i], b[k - i]);
    t[k] = c0;
    c0 = c1;
    c1 = c2;
    c2 = 0;
  }
  t[15] = c0;
}

__device__ __forceinline__ void product_floor(uint32_t t[16], const uint32_t a[8],
                                              const uint32_t b[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    t[k] = a[k] * b[k];
    t[8 + k] = __umulhi(a[k], b[k]);
  }
}

template <int VARIANT>
__global__ void limb_product_kernel(const uint32_t* __restrict__ a,
                                    const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                                    int64_t n, int64_t total) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  int64_t base = elem_base(e, n);
  uint32_t x[8], y[8], t[16];
  load8(x, a, base, n);
  load8(y, b, base, n);
  if (VARIANT == 0) product_floor(t, x, y);
  if (VARIANT == 1) product_operand(t, x, y);
  if (VARIANT == 2) product_comba(t, x, y);
  int64_t ob = elem_base16(e, n);
#pragma unroll
  for (int k = 0; k < 16; ++k) out[ob + k * n] = t[k];
}

}  // namespace

// variant: 0 floor, 1 operand, 2 product. Returns the launch's cudaError_t
// (cudaErrorInvalidValue for an unknown variant).
extern "C" int lsk_limb_product(const void* a, const void* b, void* out, long long n,
                                long long total, int variant, void* stream) {
  const int threads = 256;
  const unsigned grid = grid_for(total, threads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* x = (const uint32_t*)a;
  const uint32_t* y = (const uint32_t*)b;
  uint32_t* o = (uint32_t*)out;
  switch (variant) {
    case 0: limb_product_kernel<0><<<grid, threads, 0, s>>>(x, y, o, n, total); break;
    case 1: limb_product_kernel<1><<<grid, threads, 0, s>>>(x, y, o, n, total); break;
    case 2: limb_product_kernel<2><<<grid, threads, 0, s>>>(x, y, o, n, total); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* lsk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
