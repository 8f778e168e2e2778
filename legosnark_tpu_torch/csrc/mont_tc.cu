// P1b: the SOS Montgomery product with its two constant convolutions on the
// tensor cores, a probe of whether a tensor-core reduction pays on Hopper.
//
// Replaces the Pallas kernel `scripts/probe_mxu.py` (`mk_mxu_kernel`, built
// by `build("mxu")`), which contracts the 7/6-bit pieces of t_lo and m
// against the Toeplitz matrices of ninv and p as int8 matmuls on the MXU.
// It also covers `scripts/probe_conv.py` `k_dot`, the TPU's inexact f32
// tensor-unit convolution: this is its exact counterpart on the card.
//
// What computes what: t = a*b stays on the CUDA cores (128 multiply
// instructions per element). t_lo and then m are split into 32 unsigned
// 8-bit digits; m's columns are N @ t_lo_digits with N[k][i] = ninv_byte[k-i]
// (32 x 32) and u's are P @ m_digits with P[k][i] = p_byte[k-i] (64 x 32),
// contracted by mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 with the
// constant matrix as A (16 rows per tile) and the digits of 8 elements as B.
// A column sums at most 32 * 255^2 < 2^21, so the int32 sums are exact;
// carry passes on the CUDA cores recombine them. M is the unique value in
// [0, R) with ab + Mp = 0 (mod R), so the result is bit-identical to K1's.
//
// What bounds it on an H100: per element 96 bytes of HBM traffic, 128
// integer multiplies and 6 mma tiles / 8 elements = 3072 u8 multiply-adds
// (6144 tensor-core operations, zeros of the Toeplitz matrices included);
// at the data sheet's 1979 TOP/s int8 rate the tensor-core work is the
// smallest of the three, so the bytes bound it.
//
// Design: a warp owns 32 consecutive elements, one per lane for the CUDA-core
// work. The digits go through shared memory (one 8-word row per element, with
// a padded stride) to reach the mma B-fragment layout, the int32 column sums
// come back through shared memory to the element's lane. The Toeplitz
// matrices are built once per field on the host (a [96, 32] byte table,
// N's rows then P's) and each lane loads its A fragments from it once.
#include "field.cuh"

namespace {

constexpr int kWarps = 4;        // warps per block
constexpr int kTStride = 9;      // words per element row of the digit buffer
constexpr int kCStride = 65;     // words per element row of the column buffer

__device__ __forceinline__ void mma_u8(uint32_t d[4], const uint32_t a[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
}

// A fragment of rows [row0, row0 + 16) of a [*, 32] byte matrix for lane
// (g, t) = (lane / 4, lane % 4): rows g and g + 8, bytes 4t..4t+3 and
// 16+4t..16+4t+3, byte q of a register at bits 8q.
__device__ __forceinline__ void load_a(uint32_t a[4], const uint8_t* __restrict__ mat, int row0,
                                       int g, int t) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(mat);
  a[0] = w[(row0 + g) * 8 + t];
  a[1] = w[(row0 + g + 8) * 8 + t];
  a[2] = w[(row0 + g) * 8 + 4 + t];
  a[3] = w[(row0 + g + 8) * 8 + 4 + t];
}

// cols[e][k] = (row k of the constant matrix) . (digits of element e) for
// the warp's 32 elements: MTILES tiles of 16 rows, 4 tiles of 8 elements.
template <int MTILES>
__device__ __forceinline__ void contract(uint32_t* cols, const uint32_t* digits,
                                         uint32_t (*afrag)[4], int g, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t* row = digits + (8 * j + g) * kTStride;
    uint32_t b0 = row[t], b1 = row[4 + t];
#pragma unroll
    for (int mt = 0; mt < MTILES; ++mt) {
      uint32_t d[4];
      mma_u8(d, afrag[mt], b0, b1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int e = 8 * j + 2 * t + (i & 1);
        int k = 16 * mt + g + 8 * (i >> 1);
        cols[e * kCStride + k] = d[i];
      }
    }
  }
}

}  // namespace

__global__ void __launch_bounds__(32 * kWarps)
mont_tc_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
               uint32_t* __restrict__ out, int64_t n, int64_t total,
               const uint8_t* __restrict__ toep) {
  __shared__ uint32_t s_dig[kWarps][32 * kTStride];
  __shared__ uint32_t s_col[kWarps][32 * kCStride];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  uint32_t* dig = s_dig[warp];
  uint32_t* col = s_col[warp];
  int64_t e = ((int64_t)blockIdx.x * kWarps + warp) * 32 + lane;
  const bool valid = e < total;  // every lane takes part in the mma

  uint32_t na[2][4], pa[4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) load_a(na[mt], toep, 16 * mt, g, t);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) load_a(pa[mt], toep, 32 + 16 * mt, g, t);

  uint32_t x[8], y[8], tt[16];
  int64_t base = valid ? elem_base(e, n) : 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    x[k] = valid ? a[base + k * n] : 0;
    y[k] = valid ? b[base + k * n] : 0;
  }
  mul_wide(tt, x, y);  // t = a*b on the CUDA cores

  // m = t_lo * ninv mod R: columns on the tensor cores, carries here
#pragma unroll
  for (int k = 0; k < 8; ++k) dig[lane * kTStride + k] = tt[k];
  __syncwarp();
  contract<2>(col, dig, na, g, t);
  __syncwarp();
  uint32_t m[8];
  uint64_t c = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    const uint32_t* cw = col + lane * kCStride + 4 * w;
    uint64_t acc = c + (uint64_t)cw[0] + ((uint64_t)cw[1] << 8) + ((uint64_t)cw[2] << 16) +
                   ((uint64_t)cw[3] << 24);
    m[w] = (uint32_t)acc;
    c = acc >> 32;
  }

  // u = t + m*p: columns on the tensor cores, then the high half
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) dig[lane * kTStride + k] = m[k];
  __syncwarp();
  contract<4>(col, dig, pa, g, t);
  __syncwarp();
  c = 0;
#pragma unroll
  for (int w = 0; w < 16; ++w) {
    const uint32_t* cw = col + lane * kCStride + 4 * w;
    uint64_t acc = c + tt[w] + (uint64_t)cw[0] + ((uint64_t)cw[1] << 8) +
                   ((uint64_t)cw[2] << 16) + ((uint64_t)cw[3] << 24);
    tt[w] = (uint32_t)acc;
    c = acc >> 32;
  }
  if (valid) {
#pragma unroll
    for (int k = 0; k < 8; ++k) out[base + k * n] = tt[8 + k];
  }
}

// toep: device pointer to the [96, 32] uint8 Toeplitz table (N then P).
// Returns the launch's cudaError_t.
extern "C" int lsk_mont_mul_tc(const void* a, const void* b, void* out, long long n,
                               long long total, const void* toep, void* stream) {
  const int per_block = 32 * kWarps;
  mont_tc_kernel<<<grid_for(total, per_block), per_block, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, total,
      (const uint8_t*)toep);
  return (int)cudaGetLastError();
}

extern "C" const char* lsk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
