// Shared tile machinery of the fused-sepconv kernels: one 64x128 output tile
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

}  // namespace dsc
