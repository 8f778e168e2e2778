// K1: batched Montgomery product a*b/R over Fr or Fq.
//
// Replaces the Pallas kernel `legosnark_tpu/fields/pallas_limb.py`
// (`_mk_kernel`, launched by `_build_call` / `mont_mul`), which runs the
// 20 x 13-bit schoolbook product and reduction as sublane-shifted tile
// multiplies in VMEM.
//
// What bounds it on an H100: integer multiplies. One product is 64 32x32
// multiplies for a*b and 64 for the reduction, each needing its low and
// high word (two IMADs), against 64 bytes read and 32 written; so the
// kernel is bound by the SMs' integer multiply rate, not by HBM, once the
// batch fills the card.
//
// Design: one thread per element, CIOS over 8 x 32-bit words with 64-bit
// accumulators (field.cuh), the operands and the 10-word accumulator in
// registers, limb-major loads so a warp reads 128 contiguous bytes per
// limb. The field (p, -p^-1 mod 2^32) arrives as a kernel parameter.
// Output contract: [0, 2p) for inputs in [0, 2p) (see field.cuh).
#include "field.cuh"

__global__ void mont_mul_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                uint32_t* __restrict__ out, int64_t n, int64_t total, Field F) {
  int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  int64_t base = elem_base(e, n);
  uint32_t x[8], y[8], r[8];
  load8(x, a, base, n);
  load8(y, b, base, n);
  fmul(r, x, y, F);
  store8(out, r, base, n);
}

// consts: p[8], 2p[8], -p^-1 mod 2^32. Returns the cudaError_t of the launch.
extern "C" int lsk_mont_mul(const void* a, const void* b, void* out, long long n,
                            long long total, const uint32_t* consts, void* stream) {
  const int threads = 256;
  mont_mul_kernel<<<grid_for(total, threads), threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, total,
      field_from_words(consts));
  return (int)cudaGetLastError();
}

extern "C" const char* lsk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
