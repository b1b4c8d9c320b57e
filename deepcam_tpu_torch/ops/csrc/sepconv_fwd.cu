// Forward of the fused [ReLU ->] depthwise 3x3 -> pointwise 1x1 unit.
//
// Replaces the TPU kernel `_fwd_pallas` of
// deepcam_tpu/ops/pallas/fused_sepconv.py in its base form: no folded BN
// affine, no residual operand, no emitted statistics; the depthwise output
// d is written when the backward will need it (EMIT_D).
//
//   h = relu(x) if pre_relu else x                     (bf16)
//   d[p, c] = sum_ij h[r+(i-1)dil, w+(j-1)dil, c] * k[i,j,c]
//             fp32 products and sums in tap order (i, j), zero 'same' edges,
//             rounded once to bf16
//   y[p, f] = sum_c d[p, c] * pw[c, f]                 fp32 accumulator, bf16 out
//
// Layouts: x (N,H,W,C), y (N,H,W,F), d (N,H,W,C) bf16 NHWC; dwk (3,3,C) and
// pwk (C,F) bf16.  C and F must be multiples of 8 (16-byte vectors).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// middle-flow shape, batch 4, 728->728 at 48x72, the GEMM is 14.7 GFLOP
// (14.8 us of tensor-core time) against 60 MB of x, y and d (17.9 us), so the
// unit sits close to both roofs.  At the entry shape 64->128 at 384x576 it
// moves about 450 MB for 14.5 GFLOP: clearly bound by memory.
//
// What the design does about it: d never makes a round trip through device
// memory on the way to the GEMM.  Each block owns 64 output pixels x 128
// output channels, walks C in chunks of 32, builds the chunk of d in shared
// memory from the 9 taps of x (reads that neighbouring pixels share, so they
// hit L1/L2), and feeds it straight to the tensor cores.  d is written to
// device memory once, by the blocks of the first F tile only.  This is the
// simple first form: operands are staged through registers without cp.async
// or TMA, wmma instead of wgmma, and the depthwise is recomputed once per
// F tile (F/128 times).
#include "tile_mma.cuh"

namespace dsc {

__global__ void __launch_bounds__(THREADS)
sepconv_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dwk,
                   const bf16* __restrict__ pwk, bf16* __restrict__ y,
                   bf16* __restrict__ dout, int N, int H, int W, int C, int F,
                   int dil, int pre_relu) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* As = reinterpret_cast<bf16*>(smem);  // row layout [m][k]
  bf16* Bs = As + A_ELEMS;                   // row layout [k][n]
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const long P = (long)N * H * W;
  const long p0 = (long)blockIdx.x * BM;
  const int f0 = blockIdx.y * BN;

  // depthwise mapping: one pixel row of the tile, 8 consecutive channels
  const int am = tid >> 2;
  const int av = tid & 3;
  const long p = p0 + am;
  const bool pv = p < P;
  int n = 0, r = 0, w = 0;
  if (pv) {
    n = (int)(p / ((long)H * W));
    const int rem = (int)(p - (long)n * H * W);
    r = rem / W;
    w = rem - r * W;
  }
  const bool write_d = dout != nullptr && blockIdx.y == 0;

  Acc acc[2][2];
  zero_acc(acc);

  for (int c0 = 0; c0 < C; c0 += BK) {
    // ---- A: the chunk's depthwise output, rounded to bf16 ----
    {
      const int c = c0 + av * 8;
      float s[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = 0.0f;
      const bool cv = pv && c < C;
      if (cv) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int rr = r + (i - 1) * dil;
          if (rr < 0 || rr >= H) continue;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int ww = w + (j - 1) * dil;
            if (ww < 0 || ww >= W) continue;
            float xv[8], kv[8];
            unpack8(*reinterpret_cast<const uint4*>(x + (((long)n * H + rr) * W + ww) * C + c), xv);
            unpack8(*reinterpret_cast<const uint4*>(dwk + (i * 3 + j) * C + c), kv);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float h = pre_relu ? fmaxf(xv[e], 0.0f) : xv[e];
              // no FMA contraction: the same rounding as the plain version
              s[e] = __fadd_rn(s[e], __fmul_rn(h, kv[e]));
            }
          }
        }
      }
      const uint4 dv = pack8(s);  // zeros outside the image / channel range
      *reinterpret_cast<uint4*>(As + am * (BK + PAD) + av * 8) = dv;
      if (write_d && cv) *reinterpret_cast<uint4*>(dout + p * C + c) = dv;
    }
    // ---- B: pwk[c0:c0+32, f0:f0+128] ----
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int idx = tid + q * THREADS;
      const int kr = idx >> 4;
      const int nv = idx & 15;
      const int cc = c0 + kr;
      const int ff = f0 + nv * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (cc < C && ff < F) v = *reinterpret_cast<const uint4*>(pwk + (long)cc * F + ff);
      *reinterpret_cast<uint4*>(Bs + kr * (BN + PAD) + nv * 8) = v;
    }
    __syncthreads();
    mma_chunk<true, true>(As, Bs, acc);
    __syncthreads();
  }

  stage_acc(Cs, acc);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int idx = tid + q * THREADS;
    const int row = idx >> 4;
    const int nv = idx & 15;
    const long pp = p0 + row;
    const int ff = f0 + nv * 8;
    if (pp < P && ff < F) {
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = Cs[row * CS_LD + nv * 8 + e];
      *reinterpret_cast<uint4*>(y + pp * F + ff) = pack8(v);
    }
  }
}

}  // namespace dsc

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int sepconv_fwd(const void* x, const void* dwk, const void* pwk, void* y, void* d,
                           int N, int H, int W, int C, int F, int dil, int pre_relu,
                           void* stream) {
  using namespace dsc;
  const long P = (long)N * H * W;
  const dim3 grid((unsigned)((P + BM - 1) / BM), (unsigned)((F + BN - 1) / BN));
  sepconv_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const bf16*)x, (const bf16*)dwk, (const bf16*)pwk, (bf16*)y, (bf16*)d, N, H, W, C, F,
      dil, pre_relu);
  return (int)cudaGetLastError();
}
