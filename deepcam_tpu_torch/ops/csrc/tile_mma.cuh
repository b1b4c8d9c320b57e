// Shared machinery of the fused-sepconv kernels: the deterministic partial-sum
// reduction, the bf16 rounding of the folded BN apply, and one 64x128 output tile
// per block of 256 threads, K consumed in chunks of 32, bf16 operands staged
// in shared memory and multiplied on the tensor cores through nvcuda::wmma
// with fp32 accumulators.  8 warps form a 2 (rows) x 4 (cols) grid; each
// warp owns a 32x32 sub-tile, i.e. 2x2 fragments of 16x16.
//
// Operand tiles may sit in shared memory in either orientation, so that each
// kernel can copy its global operand without transposing it:
//   A row:  As[m][k], leading dimension BK + PAD
//   A col:  As[k][m], leading dimension BM + PAD
//   B row:  Bs[k][n], leading dimension BN + PAD
//   B col:  Bs[n][k], leading dimension BK + PAD
// The 8-element pad keeps every wmma leading dimension a multiple of 8 and
// every fragment pointer 32-byte aligned, and breaks shared-memory bank
// conflicts between rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace dsc {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int PAD = 8;
constexpr int CS_LD = BN + 4;  // fp32 staging tile for the epilogue

constexpr int A_ELEMS = (BM * (BK + PAD) > BK * (BM + PAD)) ? BM * (BK + PAD) : BK * (BM + PAD);
constexpr int B_ELEMS = (BK * (BN + PAD) > BN * (BK + PAD)) ? BK * (BN + PAD) : BN * (BK + PAD);
constexpr int OPERAND_BYTES = (A_ELEMS + B_ELEMS) * 2;
constexpr int STAGE_BYTES = BM * CS_LD * 4;
// The epilogue's fp32 staging tile reuses the operand tiles' memory.
constexpr int SMEM_BYTES = OPERAND_BYTES > STAGE_BYTES ? OPERAND_BYTES : STAGE_BYTES;

using Acc = nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ void zero_acc(Acc (&acc)[2][2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);
}

// acc += A[BM x BK] * B[BK x BN] for this warp's 32x32 sub-tile.
template <bool A_ROW, bool B_ROW>
__device__ __forceinline__ void mma_chunk(const bf16* As, const bf16* Bs, Acc (&acc)[2][2]) {
  using namespace nvcuda;
  using LA = typename std::conditional<A_ROW, wmma::row_major, wmma::col_major>::type;
  using LB = typename std::conditional<B_ROW, wmma::row_major, wmma::col_major>::type;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4;
  const int wn = warp % 4;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a[2];
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m0 = wm * 32 + i * 16;
      if (A_ROW)
        wmma::load_matrix_sync(a[i], As + m0 * (BK + PAD) + kk, BK + PAD);
      else
        wmma::load_matrix_sync(a[i], As + kk * (BM + PAD) + m0, BM + PAD);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n0 = wn * 32 + j * 16;
      if (B_ROW)
        wmma::load_matrix_sync(b[j], Bs + kk * (BN + PAD) + n0, BN + PAD);
      else
        wmma::load_matrix_sync(b[j], Bs + n0 * (BK + PAD) + kk, BK + PAD);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
  }
}

// Writes the accumulators to the fp32 staging tile Cs[BM][CS_LD].
__device__ __forceinline__ void stage_acc(float* Cs, Acc (&acc)[2][2]) {
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4;
  const int wn = warp % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      nvcuda::wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * CS_LD + wn * 32 + j * 16,
                                      acc[i][j], CS_LD, nvcuda::wmma::mem_row_major);
}

// 8 bf16 values travel as one 16-byte vector.
union Vec8 {
  uint4 u;
  bf16 h[8];
};

__device__ __forceinline__ void unpack8(const uint4 v, float (&f)[8]) {
  Vec8 t;
  t.u = v;
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = __bfloat162float(t.h[e]);
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  Vec8 t;
#pragma unroll
  for (int e = 0; e < 8; ++e) t.h[e] = __float2bfloat16_rn(f[e]);
  return t.u;
}

// f rounded to bf16 and back (round to nearest even, as PyTorch rounds)
__device__ __forceinline__ float bf16_round(float f) {
  return __bfloat162float(__float2bfloat16_rn(f));
}

// (a, b) rounded to bf16 and back as a pair: one packed conversion
__device__ __forceinline__ float2 bf16_round2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// The prologue of a unit whose preceding BatchNorm apply is folded in, with
// PyTorch's bf16 rounding at each op and no FMA contraction:
//   u = bf16(bf16(x * a) + b), then with skip u = bf16(u + skip)
__device__ __forceinline__ void affine8(float (&u)[8], const float* a, const float* b) {
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const float2 m = bf16_round2(__fmul_rn(u[e], a[e]), __fmul_rn(u[e + 1], a[e + 1]));
    const float2 t = bf16_round2(__fadd_rn(m.x, b[e]), __fadd_rn(m.y, b[e + 1]));
    u[e] = t.x;
    u[e + 1] = t.y;
  }
}

__device__ __forceinline__ void add_round8(float (&u)[8], const uint4 skip) {
  float s[8];
  unpack8(skip, s);
#pragma unroll
  for (int e = 0; e < 8; e += 2) {
    const float2 t = bf16_round2(__fadd_rn(u[e], s[e]), __fadd_rn(u[e + 1], s[e + 1]));
    u[e] = t.x;
    u[e + 1] = t.y;
  }
}

// ---- out[y][i] = sum of part[k][i] over k in chunk y, in a fixed order ----
// Chunk y is k in [y * chunk, min((y + 1) * chunk, S)).  Block (32 outputs,
// blockIdx.x) x (8 lanes): lane l adds k = start + l, start + l + 8, ... in
// order, then lane 0 adds the 8 lane sums in order.  No atomics, so the sum
// is the same on every run.
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int S, long M,
              int chunk) {
  __shared__ float red[8][32];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const long i = (long)blockIdx.x * 32 + tx;
  const int k0 = blockIdx.y * chunk;
  const int k1 = min(k0 + chunk, S);
  float s = 0.0f;
  if (i < M)
    for (int k = k0 + ty; k < k1; k += 8) s += part[(long)k * M + i];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && i < M) {
    float t = 0.0f;
#pragma unroll
    for (int l = 0; l < 8; ++l) t += red[l][tx];
    out[(long)blockIdx.y * M + i] = t;
  }
}

constexpr int RED_CHUNK = 256;

// out[i] = sum over the S partials part[k][i] (M outputs).  One pass; or,
// when `scratch` is given and S > RED_CHUNK, two: chunks of RED_CHUNK
// partials into scratch (ceil(S / RED_CHUNK) x M floats), then those.
// Returns the first non-zero cudaGetLastError(), else 0.
inline int reduce_partials(const float* part, float* out, float* scratch, int S, long M,
                           cudaStream_t st) {
  const unsigned gx = (unsigned)((M + 31) / 32);
  if (scratch != nullptr && S > RED_CHUNK) {
    const int s1 = (S + RED_CHUNK - 1) / RED_CHUNK;
    reduce_kernel<<<dim3(gx, (unsigned)s1), THREADS, 0, st>>>(part, scratch, S, M, RED_CHUNK);
    const int err = (int)cudaGetLastError();
    if (err) return err;
    part = scratch;
    S = s1;
  }
  reduce_kernel<<<dim3(gx, 1), THREADS, 0, st>>>(part, out, S, M, S);
  return (int)cudaGetLastError();
}

}  // namespace dsc
