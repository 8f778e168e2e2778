// K4: the MiMC-5 permutation over Fr of the Fiat-Shamir transcript
// (utils/transcript.py): `rounds` = 110 rounds of x <- (x + c_i)^5 on every
// lane of a batch, in one launch.
//
// Replaces no Pallas kernel: the JAX package's MiMC
// (`legosnark_tpu/utils/transcript.py`, `permute`) is plain jnp, which XLA
// compiles into one loop. In torch ops a permutation is ~2,000 launches
// (per round an `fl.add` of some fifteen int64 ops and three K1 products),
// most of them one element wide; this kernel is the whole permutation.
//
// One launch computes, for lanes j < n_out,
//   out[j] = permute(a[j] + b[j])   for j < n_add,
//   out[j] = permute(b[j])          for n_add <= j < n_out,
// with a and b limb-major rows of one stride ld (limb k of lane j at
// a[k * ld + j]) and out a contiguous [8, n_out]. The transcript uses it
// three ways (`transcript.permute`, `transcript.combine`):
//   * permute(x): n_add = 0, b = x;
//   * permute(x + y), the absorb's state + digest: a = x, b = y;
//   * one level of the digest tree over h [8, m]: a = h, b = h + m / 2,
//     ld = m, n_add = m / 2, n_out = ceil(m / 2). When m is odd
//     the last lane reads b[m / 2] = h[m - 1] and permutes it alone.
//
// Contract: field_cc.cuh's, over Fr. r, like q, has the top word 0x30644e72,
// so r < 0.19 * 2^256 and that file's nine-word bound holds. Every value
// stays in [0, 2r): add_cc subtracts 2r when the sum reaches it, mul_cc has
// no final subtraction, as `fl.add` and K1 do, so every output equals the
// torch loop's (`transcript.permute_plain`) bit for bit.
//
// What bounds it on an H100, and what the design does about it:
// * At 2^20 lanes (the digest of a public 1024 x 1024 matrix), integer
//   multiplies: 330 products of 264 32-bit multiplies per lane, 5.47 ms at
//   16.7e12 per s, against 32-64 bytes read and 32 written (0.03 ms). One
//   thread per lane keeps x in registers through all 110 rounds, so the
//   lane is loaded once and stored once, and each product is field_cc.cuh's
//   carry chain (one IMAD.WIDE.U32.X per word product) as in K2/K3. At most
//   96 registers a thread leaves 20 warps per SM to hide the chains'
//   latency.
// * At width 1 (the absorb's state + digest, every squeeze, the tree's top
//   levels): the latency of one thread's 330 dependent products, and the
//   launch. One launch replaces ~2,000 host dispatches. The round constants
//   are the same for every lane: two 16-byte loads per round through the
//   read-only cache, one address for the whole warp.
#include "field_cc.cuh"

#define MIMC_THREADS 128
// At most 96 registers a thread (65536 per SM).
#define MIMC_MIN_BLOCKS (65536 / (MIMC_THREADS * 96))

__global__ void __launch_bounds__(MIMC_THREADS, MIMC_MIN_BLOCKS)
    mimc_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, int64_t ld,
                uint32_t* __restrict__ out, int64_t n_add, int64_t n_out,
                const uint4* __restrict__ rc, int rounds, Field F) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n_out) return;
  uint32_t x[8];
  load8(x, b, j, ld);
  if (j < n_add) {
    uint32_t y[8];
    load8(y, a, j, ld);
    add_cc(x, y, x, F);
  }
#pragma unroll 1
  for (int i = 0; i < rounds; ++i) {
    const uint4 lo = __ldg(rc + 2 * i), hi = __ldg(rc + 2 * i + 1);
    const uint32_t c[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
    uint32_t t[8], t4[8];
    add_cc(t, x, c, F);
    mul_cc(t4, t, t, F);
    mul_cc(t4, t4, t4, F);
    mul_cc(x, t4, t, F);
  }
  store8(out, x, j, n_out);
}

// consts: r[8], 2r[8], -r^-1 mod 2^32; rc: `rounds` Montgomery constants,
// 8 words each, on the device (16-byte aligned). a may be null when
// n_add = 0. Returns the cudaError_t of the launch.
extern "C" int lsk_mimc(const void* a, const void* b, long long ld, void* out, long long n_add,
                        long long n_out, const void* rc, int rounds, const uint32_t* consts,
                        void* stream) {
  mimc_kernel<<<grid_for(n_out, MIMC_THREADS), MIMC_THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, ld, (uint32_t*)out, n_add, n_out,
      (const uint4*)rc, rounds, field_from_words(consts));
  return (int)cudaGetLastError();
}

extern "C" const char* lsk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
