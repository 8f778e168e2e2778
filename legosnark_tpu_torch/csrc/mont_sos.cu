// P1a: the Montgomery product by separated operand scanning (SOS), a probe
// of K1's design beside its CIOS form (csrc/mont_mul.cu).
//
// Replaces the Pallas kernel `scripts/probe_mxu.py` (`mm_kernel_vpu`, built
// by `build("vpu")`): t = a*b, m = t_lo * ninv mod R, u = t + m*p, return
// u_hi, on the TPU's vector unit.
//
// What bounds it on an H100: integer multiplies, as in K1. One product is
// 64 word products for t = a*b and 64 for m*p, each needing its low and
// high word, plus the truncated m = t_lo * ninv mod R (36 word products,
// 28 of them needing their high word): 320 multiply instructions against
// 64 bytes read and 32 written. SOS needs the whole 256-bit ninv = -p^-1
// mod R where CIOS needs one word of it, and 56 more multiplies than CIOS.
//
// Design: one thread per element, everything in registers. M is the unique
// value in [0, R) with ab + Mp = 0 (mod R), the one CIOS computes word by
// word, so the result (ab + Mp)/R is the same integer K1 returns, bit for
// bit, in [0, 2p) for inputs in [0, 2p).
#include "field.cuh"

struct SosField {
  uint32_t p[8];
  uint32_t ninv[8];  // -p^-1 mod 2^256
};

__device__ __forceinline__ void mont_sos(uint32_t r[8], const uint32_t a[8],
                                         const uint32_t b[8], const SosField& F) {
  uint32_t t[16], m[8];
  mul_wide(t, a, b);
  // m = t_lo * ninv mod 2^256: only the products landing below word 8
#pragma unroll
  for (int k = 0; k < 8; ++k) m[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; i + j < 8; ++j) {
      uint64_t s = (uint64_t)t[j] * F.ninv[i] + m[i + j] + c;
      m[i + j] = (uint32_t)s;
      c = s >> 32;
    }
  }
  // u = t + m*p; the low 8 words vanish, the carry out of word 15 is 0
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint64_t s = (uint64_t)m[i] * F.p[j] + t[i + j] + c;
      t[i + j] = (uint32_t)s;
      c = s >> 32;
    }
#pragma unroll
    for (int k = i + 8; k < 16; ++k) {
      uint64_t s = (uint64_t)t[k] + c;
      t[k] = (uint32_t)s;
      c = s >> 32;
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) r[k] = t[8 + k];
}

__global__ void mont_sos_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, int64_t n, int64_t total,
                                SosField F) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  int64_t base = elem_base(e, n);
  uint32_t x[8], y[8], r[8];
  load8(x, a, base, n);
  load8(y, b, base, n);
  mont_sos(r, x, y, F);
  store8(out, r, base, n);
}

// consts: p[8], ninv[8] (-p^-1 mod 2^256). Returns the launch's cudaError_t.
extern "C" int lsk_mont_mul_sos(const void* a, const void* b, void* out, long long n,
                                long long total, const uint32_t* consts, void* stream) {
  SosField F;
  for (int k = 0; k < 8; ++k) {
    F.p[k] = consts[k];
    F.ninv[k] = consts[8 + k];
  }
  const int threads = 256;
  mont_sos_kernel<<<grid_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, total, F);
  return (int)cudaGetLastError();
}

extern "C" const char* lsk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
