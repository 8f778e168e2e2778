// P1b: the SOS Montgomery product with its two constant convolutions on the
// tensor cores, a probe of whether a tensor-core reduction pays on Hopper.
//
// Replaces the Pallas kernel `scripts/probe_mxu.py:143` (`mk_mxu_kernel`,
// built by `build("mxu")`), which contracts the 7/6-bit pieces of t_lo and m
// against the Toeplitz matrices of ninv and p as int8 matmuls on the MXU.
// It also covers `scripts/probe_conv.py` `k_dot`, the TPU's inexact f32
// tensor-unit convolution: this is its exact counterpart on the card.
//
// What computes what: t = a*b stays on the CUDA cores. t_lo and then m are
// split into 32 unsigned 8-bit digits; m's columns are N @ t_lo_digits with
// N[k][i] = ninv_byte[k-i], contracted by
// mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 with the constant matrix
// as A (16 rows per tile) and the digits of 8 elements as B. A column sums
// at most 32 * 255^2 < 2^21, so the int32 sums are exact; carry chains on
// the CUDA cores recombine them. M is the unique value in [0, R) with
// ab + Mp = 0 (mod R), so the result is bit-identical to K1's.
//
// Only 33 of m*p's 64 columns are needed. u = t + m*p has a low half of
// exactly 0 mod R, so u / R = t_hi + (m*p columns 32..63) + c with c the
// carry out of t_lo + low, low = sum_{k<32} col_k 2^(8k). With
// H = col_30 2^240 + col_31 2^248 and L the columns below 30, L < 2^254, and
// c * 2^256 = t_lo + H + L gives c = ceil((t_lo + H) / 2^256). So P's tiles
// are its rows for columns 30..61, column 62 is the one byte product
// m_31 * p_31 on the CUDA cores, and column 63 is 0: 4 mma tiles per 8
// elements, not 6.
//
// What bounds it on an H100, per element: 96 bytes of HBM traffic (0.0300
// ms at 2^20 and 3.35 TB/s); 129 32-bit multiplies (t = a*b's 64 word
// products with their high words, one wide multiply-add with carry each,
// and column 62); 4096 u8 tensor-core operations (0.0022 ms at 2^20 and
// the data sheet's 1979 TOP/s). The bytes bound it. The rest is integer
// work: carry chains, addressing and the shared-memory traffic below.
//
// Design: a warp owns 32 consecutive elements, one per lane for the CUDA-core
// work. Per warp two buffers in shared memory, both free of bank conflicts:
// * digits, 8 words per element: word w of element e at 8e + (w ^ (e & 4)).
//   A lane stores its 8 words as two 16-byte stores (a quarter warp hits 8
//   distinct 16-byte bank groups), and a B fragment's read of word 4h + t
//   by lanes (g, t) hits bank 8(g & 3) + 4(h ^ (g >> 2)) + t, 32 distinct
//   banks;
// * pair words, 16 per element. The host orders each constant tile's rows
//   so that lane (g, t) receives slots 4g..4g+3 (one slot group) of its
//   elements 8j + 2t + c; it packs them as p0 = s_4g + 2^8 s_4g+1 and
//   p1 = s_4g+2 + 2^8 s_4g+3 (each < 2^30) and stores both with one 8-byte
//   store, words 2g, 2g + 1 of the element (`pair_word`: each half warp on
//   32 distinct banks). The element's lane reads its 16 words as four
//   16-byte loads (each quarter warp on 32 distinct banks).
// P's slot s holds column 32 + s for s < 30 and column s for s = 30, 31, so
// one buffer serves both contractions. Per warp of 32 elements: 96
// shared-memory wavefronts (16 digit stores, 16 B-fragment reads, 32 pair
// stores, 32 pair reads), 3 per element. 3,072 bytes per warp; 12,288 per
// block of 4 warps, so registers, not shared memory, set the occupancy.
// The A fragments come from a table in register order, one 16-byte load
// per tile and lane.
//
// Why the sums still cross shared memory, and not warp shuffles with the
// digits as A and the column sums kept in registers: that design's quad
// sums take about 144 shuffles per warp, and a shuffle costs the
// shared-memory pipe what a wavefront costs, more than the 64 pair
// wavefronts they would replace. PERF.md section 6 has the times beside
// K1's, ptxas's report and the compute per product.
#include "field_cc.cuh"

namespace {

constexpr int kWarps = 4;             // warps per block
constexpr int kDigWords = 32 * 8;     // digit buffer words per warp
constexpr int kPairWords = 32 * 16;   // pair buffer words per warp
constexpr int kP31 = 4 * 32 * 4;      // fragment table word of p_byte[31]

__device__ __forceinline__ int dig_word(int e, int w) { return 8 * e + (w ^ (e & 4)); }

// Word q (0..15) of element e (0..31) in the pair buffer: bank bits 0-1 q's,
// bit 2 e0 ^ q2, bits 3-4 e1, e2; line e0 + 2 q3 + 4 (e >> 3).
__device__ __forceinline__ int pair_word(int e, int q) {
  const int line = (e & 1) | ((q >> 3) << 1) | ((e >> 3) << 2);
  const int bank = (q & 3) | (((e ^ (q >> 2)) & 1) << 2) | (((e >> 1) & 3) << 3);
  return 32 * line + bank;
}

__device__ __forceinline__ void mma_u8(uint32_t d[4], const uint32_t a[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
}

// Lane (g, t)'s A fragment of constant tile `tile` (N's 0, 1; P's 2, 3),
// laid out by the host in register order (`tc_fragments`).
__device__ __forceinline__ void load_a(uint32_t a[4], const uint32_t* __restrict__ frag, int tile,
                                       int lane) {
  const uint4 v = reinterpret_cast<const uint4*>(frag)[32 * tile + lane];
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
}

// The 8 digit words of the lane's element e, as two 16-byte stores.
__device__ __forceinline__ void store_digits(uint32_t* dig, int e, const uint32_t v[8]) {
  uint4* row = reinterpret_cast<uint4*>(dig + 8 * e);
  const int h = (e >> 2) & 1;
  row[h] = make_uint4(v[0], v[1], v[2], v[3]);
  row[h ^ 1] = make_uint4(v[4], v[5], v[6], v[7]);
}

// The pair words of the warp's 32 elements: tile row r of tile mt holds slot
// 4(r % 8) + 2mt + r / 8, so lane (g, t) gets slots 4g..4g+3 of elements
// 8j + 2t + c and packs them as p0 = s_4g + 2^8 s_4g+1, p1 = s_4g+2 +
// 2^8 s_4g+3 (each < 2^30) into words 2g, 2g + 1: one 8-byte store.
__device__ __forceinline__ void contract(uint32_t* pairs, const uint32_t* dig,
                                         uint32_t (*afrag)[4], int g, int t) {
  uint32_t b[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    b[j][0] = dig[dig_word(8 * j + g, t)];
    b[j][1] = dig[dig_word(8 * j + g, 4 + t)];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    uint32_t d0[4], d1[4];
    mma_u8(d0, afrag[0], b[j][0], b[j][1]);
    mma_u8(d1, afrag[1], b[j][0], b[j][1]);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      *reinterpret_cast<uint2*>(pairs + pair_word(8 * j + 2 * t + c, 2 * g)) =
          make_uint2(d0[c] + (d0[2 + c] << 8), d1[c] + (d1[2 + c] << 8));
    }
  }
}

// t = a*b, 16 words, in two carry chains per row of b: E takes the products
// a[j] b[i] of even j at words (i + j, i + j + 1), F those of odd j, so in
// each chain a product's low and high words sit side by side (one
// IMAD.WIDE.U32.X each, as in field_cc.cuh). Neither chain carries out of
// its top word: after row i, E <= (a's even words) * (b mod 2^(32(i+1))) <
// 2^224 2^(32(i+1)), so E has no word above i + 7, and F none above i + 8.
__device__ __forceinline__ void mul_wide_cc(uint32_t t[16], const uint32_t a[8],
                                           const uint32_t b[8]) {
  uint32_t e[16], f[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) e[k] = f[k] = 0;
#pragma unroll
  for (int j = 0; j < 8; j += 2) {
    e[j] = a[j] * b[0];
    e[j + 1] = __umulhi(a[j], b[0]);
    f[j + 1] = a[j + 1] * b[0];
    f[j + 2] = __umulhi(a[j + 1], b[0]);
  }
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    e[i] = madlo_cc_(a[0], b[i], e[i]);
    e[i + 1] = madhic_cc_(a[0], b[i], e[i + 1]);
#pragma unroll
    for (int j = 2; j < 6; j += 2) {
      e[i + j] = madloc_cc_(a[j], b[i], e[i + j]);
      e[i + j + 1] = madhic_cc_(a[j], b[i], e[i + j + 1]);
    }
    e[i + 6] = madloc_cc_(a[6], b[i], e[i + 6]);
    e[i + 7] = madhic_(a[6], b[i], e[i + 7]);
    f[i + 1] = madlo_cc_(a[1], b[i], f[i + 1]);
    f[i + 2] = madhic_cc_(a[1], b[i], f[i + 2]);
#pragma unroll
    for (int j = 3; j < 7; j += 2) {
      f[i + j] = madloc_cc_(a[j], b[i], f[i + j]);
      f[i + j + 1] = madhic_cc_(a[j], b[i], f[i + j + 1]);
    }
    f[i + 7] = madloc_cc_(a[7], b[i], f[i + 7]);
    f[i + 8] = madhic_(a[7], b[i], f[i + 8]);
  }
  t[0] = e[0];
  t[1] = add_cc_(e[1], f[1]);
#pragma unroll
  for (int k = 2; k < 15; ++k) t[k] = addc_cc_(e[k], f[k]);
  t[15] = addc_(e[15], f[15]);
}

// Slot group w of one contraction, p0 + 2^16 p1 (< 2^46), as lo + 2^32 hi.
__device__ __forceinline__ void split_group(uint32_t p0, uint32_t p1, uint32_t& lo,
                                            uint32_t& hi) {
  lo = add_cc_(p0, p1 << 16);
  hi = addc_(p1 >> 16, 0);
}

// The lane's 8 slot groups: pair words 4u..4u+3 (groups 2u, 2u + 1) are one
// 16-byte load.
__device__ __forceinline__ void read_groups(const uint32_t* pairs, int lane, uint32_t p[16]) {
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const uint4 v = *reinterpret_cast<const uint4*>(pairs + pair_word(lane, 4 * u));
    p[4 * u] = v.x;
    p[4 * u + 1] = v.y;
    p[4 * u + 2] = v.z;
    p[4 * u + 3] = v.w;
  }
}

}  // namespace

__global__ void __launch_bounds__(32 * kWarps)
mont_tc_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, int64_t n, int64_t total,
               const uint32_t* __restrict__ frag) {
  __shared__ __align__(16) uint32_t s_dig[kWarps][kDigWords];
  __shared__ __align__(16) uint32_t s_pair[kWarps][kPairWords];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  uint32_t* dig = s_dig[warp];
  uint32_t* pairs = s_pair[warp];
  int64_t e = ((int64_t)blockIdx.x * kWarps + warp) * 32 + lane;
  const bool valid = e < total;  // every lane takes part in the mma

  uint32_t x[8], y[8];
  int64_t base = valid ? elem_base(e, n) : 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    x[k] = valid ? a[base + k * n] : 0;
    y[k] = valid ? b[base + k * n] : 0;
  }
  uint32_t tt[16];
  mul_wide_cc(tt, x, y);  // t = a*b on the CUDA cores

  // m = t_lo * ninv mod R: columns on the tensor cores, carries here
  uint32_t af[2][4], p[16], lo[8], hi[8];
  load_a(af[0], frag, 0, lane);
  load_a(af[1], frag, 1, lane);
  store_digits(dig, lane, tt);
  __syncwarp();
  contract(pairs, dig, af, g, t);
  __syncwarp();
  read_groups(pairs, lane, p);
#pragma unroll
  for (int w = 0; w < 8; ++w) split_group(p[2 * w], p[2 * w + 1], lo[w], hi[w]);
  uint32_t m[8];
  m[0] = lo[0];
  m[1] = add_cc_(lo[1], hi[0]);
#pragma unroll
  for (int w = 2; w < 7; ++w) m[w] = addc_cc_(lo[w], hi[w - 1]);
  m[7] = addc_(lo[7], hi[6]);  // mod R

  // u = t + m*p: columns 30..61 on the tensor cores, then the high half
  load_a(af[0], frag, 2, lane);
  load_a(af[1], frag, 3, lane);
  store_digits(dig, lane, m);
  __syncwarp();
  contract(pairs, dig, af, g, t);
  __syncwarp();
  read_groups(pairs, lane, p);
  // group 7 is slots 28..31: columns 60, 61, 30, 31. The carry out of the
  // low half, ceil((t_lo + H) / 2^256), from p1 = col_30 + 2^8 col_31:
  uint32_t c_lo, c_hi;
  split_group(0, p[15], c_lo, c_hi);
  c_lo = add_cc_(c_lo, tt[7]);
  c_hi = addc_(c_hi, 0);
  const uint32_t rest = c_lo | tt[0] | tt[1] | tt[2] | tt[3] | tt[4] | tt[5] | tt[6];
  const uint32_t carry = c_hi + (rest != 0);
  // columns 32..63: groups 0..6, then columns 60, 61, 62 = m_31 p_31, 63 = 0
#pragma unroll
  for (int w = 0; w < 7; ++w) split_group(p[2 * w], p[2 * w + 1], lo[w], hi[w]);
  split_group(p[14], (m[7] >> 24) * frag[kP31], lo[7], hi[7]);
  uint32_t r[8];  // t_hi + lo, then + 2^32 hi + carry; u / R < 2p leaves no carry out
  r[0] = add_cc_(tt[8], lo[0]);
#pragma unroll
  for (int w = 1; w < 7; ++w) r[w] = addc_cc_(tt[8 + w], lo[w]);
  r[7] = addc_(tt[15], lo[7]);
  r[0] = add_cc_(r[0], carry);
#pragma unroll
  for (int w = 1; w < 7; ++w) r[w] = addc_cc_(r[w], hi[w - 1]);
  r[7] = addc_(r[7], hi[6]);
  if (valid) store8(out, r, base, n);
}

// frag: device pointer to the 516-word fragment table (`tc_fragments`).
// Returns the launch's cudaError_t.
extern "C" int lsk_mont_mul_tc(const void* a, const void* b, void* out, long long n,
                               long long total, const void* frag, void* stream) {
  const int per_block = 32 * kWarps;
  mont_tc_kernel<<<grid_for(total, per_block), per_block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, total,
      (const uint32_t*)frag);
  return (int)cudaGetLastError();
}

extern "C" const char* lsk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
