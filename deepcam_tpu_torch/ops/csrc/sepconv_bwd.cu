// Backward of the fused [ReLU ->] depthwise 3x3 -> pointwise 1x1 unit.
//
// Replaces the TPU kernel `_bwd_pallas` of
// deepcam_tpu/ops/pallas/fused_sepconv.py in its base form with the
// forward's emitted depthwise output d (EMIT_D): no folded BN affine, no
// residual operand, no statistics cotangent.
//
//   dd[p, c]    = sum_f g[p, f] * pw[c, f]                          fp32
//   dh[p, c]    = sum_ij dd[r+(i-1)dil, w+(j-1)dil, c] * k[2-i,2-j,c]  fp32
//   dx          = bf16(dh * (x > 0))   (the mask only when pre_relu)
//   d_dw[i,j,c] = sum_p h[r+(i-1)dil, w+(j-1)dil, c] * dd[p, c]     fp32
//   d_pw[c, f]  = sum_p d[p, c] * g[p, f]                           fp32
// with h = relu(x) when pre_relu, else x, and zero 'same' edges.
//
// The TPU kernel summed d_dw and d_pw across its sequential grid.  Blocks on
// the GPU run in no order, so each block writes a partial sum and a second
// pass adds the partials in a fixed order: the result is deterministic.
// Five launches:
//   1. dd_kernel      dd = g . pw^T into an fp32 scratch tensor (tensor cores)
//   2. dx_ddw_kernel  dx from the flipped taps of dd, and per-block partial
//                     sums of d_dw
//   3. reduce_kernel  d_dw = sum of the partials
//   4. dpw_kernel     d^T . g over one slice of the pixels per block (tensor
//                     cores) into per-slice partials of d_pw
//   5. reduce_kernel  d_pw = sum of the partials
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): two
// GEMMs of 2.P.C.F operations each against reads of x, g, d and writes of dx
// (4 tensors of the unit's width).  At the middle-flow shape, batch 4,
// 728->728 at 48x72, that is 29.3 GFLOP (29.6 us) against 80 MB (23.9 us): both
// roofs are close.  The entry shapes move far more bytes than they compute.
//
// What the design does about it: dd stays fp32 (as the TPU kernel kept it)
// and makes one round trip through device memory between the two passes that
// need it (dd is P.C.4 bytes; the taps that re-read it hit L1/L2).  The
// d_dw partials are reduced inside each block with warp shuffles before
// they are written, so the partial buffer is small.  d_pw splits the pixel
// axis only as far as needed to give the card about four blocks per SM, so
// its partial buffer stays within tens of MB (12.6 MB per slice at
// 1536x2048).  This is the simple first form: no cp.async or TMA pipelining,
// wmma instead of wgmma.
#include "tile_mma.cuh"

namespace dsc {

// ---- 1. dd = g . pw^T :  M = pixels, N = C, K = F ----
__global__ void __launch_bounds__(THREADS)
dd_kernel(const bf16* __restrict__ g, const bf16* __restrict__ pwk, float* __restrict__ dd,
          long P, int C, int F) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* As = reinterpret_cast<bf16*>(smem);  // row layout [m][k]
  bf16* Bs = As + A_ELEMS;                   // col layout [n][k]
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const long p0 = (long)blockIdx.x * BM;
  const int cbase = blockIdx.y * BN;

  Acc acc[2][2];
  zero_acc(acc);
  for (int k0 = 0; k0 < F; k0 += BK) {
    {
      const int row = tid >> 2;
      const int kv = tid & 3;
      const long p = p0 + row;
      const int ff = k0 + kv * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (p < P && ff < F) v = *reinterpret_cast<const uint4*>(g + p * F + ff);
      *reinterpret_cast<uint4*>(As + row * (BK + PAD) + kv * 8) = v;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int idx = tid + q * THREADS;
      const int nr = idx >> 2;
      const int kv = idx & 3;
      const int cc = cbase + nr;
      const int ff = k0 + kv * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (cc < C && ff < F) v = *reinterpret_cast<const uint4*>(pwk + (long)cc * F + ff);
      *reinterpret_cast<uint4*>(Bs + nr * (BK + PAD) + kv * 8) = v;
    }
    __syncthreads();
    mma_chunk<true, false>(As, Bs, acc);
    __syncthreads();
  }
  stage_acc(Cs, acc);
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int idx = tid + q * THREADS;
    const int row = idx >> 4;
    const int nv = idx & 15;
    const long p = p0 + row;
    const int cc = cbase + nv * 8;
    if (p < P && cc < C) {
      const float* src = Cs + row * CS_LD + nv * 8;
      float4* dst = reinterpret_cast<float4*>(dd + p * C + cc);
      dst[0] = make_float4(src[0], src[1], src[2], src[3]);
      dst[1] = make_float4(src[4], src[5], src[6], src[7]);
    }
  }
}

__device__ __forceinline__ void load8f(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// ---- 2. dx and per-block partial sums of d_dw ----
// Block: 8 channel vectors (64 channels, blockIdx.y) x 32 pixel lanes; the
// block walks `ppb` consecutive pixels (blockIdx.x).  Partial layout:
// part[blockIdx.x][tap][C].
constexpr int DX_CT = 64;

__global__ void __launch_bounds__(THREADS)
dx_ddw_kernel(const bf16* __restrict__ x, const float* __restrict__ dd,
              const bf16* __restrict__ dwk, bf16* __restrict__ dx, float* __restrict__ part,
              int N, int H, int W, int C, int dil, int pre_relu, int ppb) {
  __shared__ float ks[9][DX_CT];
  __shared__ float red[THREADS / 32][9][DX_CT];

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // channel vector
  const int ty = tid >> 3;  // pixel lane
  const int cl = tx * 8;
  const int c = blockIdx.y * DX_CT + cl;
  const bool cv = c < C;
  const long P = (long)N * H * W;

  for (int i = tid; i < 9 * DX_CT; i += THREADS) {
    const int t = i / DX_CT;
    const int ch = blockIdx.y * DX_CT + i % DX_CT;
    ks[t][i % DX_CT] = ch < C ? __bfloat162float(dwk[t * C + ch]) : 0.0f;
  }
  __syncthreads();

  float acc[9][8];
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[t][e] = 0.0f;

  const long pb0 = (long)blockIdx.x * ppb;
  const long pend = min(pb0 + ppb, P);
  if (cv) {
    for (long p = pb0 + ty; p < pend; p += 32) {
      const int n = (int)(p / ((long)H * W));
      const int rem = (int)(p - (long)n * H * W);
      const int r = rem / W;
      const int w = rem - r * W;
      float ddc[8];
      load8f(dd + p * C + c, ddc);
      float dh[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) dh[e] = 0.0f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const int rr = r + (i - 1) * dil;
        if (rr < 0 || rr >= H) continue;
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const int ww = w + (j - 1) * dil;
          if (ww < 0 || ww >= W) continue;
          const long q = ((long)n * H + rr) * W + ww;
          // depthwise dgrad: flipped kernel against the tap of dd
          float dv[8];
          load8f(dd + q * C + c, dv);
          // depthwise wgrad: the tap of h against the centre of dd
          float hv[8];
          unpack8(*reinterpret_cast<const uint4*>(x + q * C + c), hv);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            dh[e] += dv[e] * ks[(2 - i) * 3 + (2 - j)][cl + e];
            const float h = pre_relu ? fmaxf(hv[e], 0.0f) : hv[e];
            acc[i * 3 + j][e] += h * ddc[e];
          }
        }
      }
      if (pre_relu) {
        float xc[8];
        unpack8(*reinterpret_cast<const uint4*>(x + p * C + c), xc);
#pragma unroll
        for (int e = 0; e < 8; ++e) dh[e] = xc[e] > 0.0f ? dh[e] : 0.0f;
      }
      *reinterpret_cast<uint4*>(dx + p * C + c) = pack8(dh);
    }
  }

  // lanes of one warp that share a channel vector differ by 8 and 16
#pragma unroll
  for (int t = 0; t < 9; ++t)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float v = acc[t][e];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[t][e] = v;
    }
  const int warp = tid >> 5;
  if ((tid & 31) < 8) {
#pragma unroll
    for (int t = 0; t < 9; ++t)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[warp][t][cl + e] = acc[t][e];
  }
  __syncthreads();
  for (int i = tid; i < 9 * DX_CT; i += THREADS) {
    const int t = i / DX_CT;
    const int ch = blockIdx.y * DX_CT + i % DX_CT;
    if (ch < C) {
      float s = 0.0f;
#pragma unroll
      for (int wi = 0; wi < THREADS / 32; ++wi) s += red[wi][t][i % DX_CT];
      part[((long)blockIdx.x * 9 + t) * C + ch] = s;
    }
  }
}

// ---- 4. per-slice partials of d_pw = d^T . g :  M = C, N = F, K = pixels ----
__global__ void __launch_bounds__(THREADS)
dpw_kernel(const bf16* __restrict__ d, const bf16* __restrict__ g, float* __restrict__ part,
           long P, int C, int F, long chunk) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  bf16* As = reinterpret_cast<bf16*>(smem);  // col layout [k][m]
  bf16* Bs = As + A_ELEMS;                   // row layout [k][n]
  float* Cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int fbase = blockIdx.x * BN;
  const int cbase = blockIdx.y * BM;
  const long kbeg = (long)blockIdx.z * chunk;
  const long kend = min(kbeg + chunk, P);

  Acc acc[2][2];
  zero_acc(acc);
  for (long k0 = kbeg; k0 < kend; k0 += BK) {
    {
      const int kr = tid >> 3;
      const int mv = tid & 7;
      const long p = k0 + kr;
      const int cc = cbase + mv * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (p < kend && cc < C) v = *reinterpret_cast<const uint4*>(d + p * C + cc);
      *reinterpret_cast<uint4*>(As + kr * (BM + PAD) + mv * 8) = v;
    }
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int idx = tid + q * THREADS;
      const int kr = idx >> 4;
      const int nv = idx & 15;
      const long p = k0 + kr;
      const int ff = fbase + nv * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (p < kend && ff < F) v = *reinterpret_cast<const uint4*>(g + p * F + ff);
      *reinterpret_cast<uint4*>(Bs + kr * (BN + PAD) + nv * 8) = v;
    }
    __syncthreads();
    mma_chunk<false, true>(As, Bs, acc);
    __syncthreads();
  }
  stage_acc(Cs, acc);
  __syncthreads();
  float* out = part + (long)blockIdx.z * C * F;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int idx = tid + q * THREADS;
    const int row = idx >> 4;
    const int nv = idx & 15;
    const int cc = cbase + row;
    const int ff = fbase + nv * 8;
    if (cc < C && ff < F) {
      const float* src = Cs + row * CS_LD + nv * 8;
      float4* dst = reinterpret_cast<float4*>(out + (long)cc * F + ff);
      dst[0] = make_float4(src[0], src[1], src[2], src[3]);
      dst[1] = make_float4(src[4], src[5], src[6], src[7]);
    }
  }
}

// ---- 3, 5. out[i] = sum_s part[s][i], in a fixed order ----
// Block (32 outputs) x (8 lanes): lane l adds the partials s = l, l+8, ...
// in order, then lane 0 adds the 8 lane sums in order.
__global__ void __launch_bounds__(THREADS)
reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int S, long M) {
  __shared__ float red[8][32];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const long i = (long)blockIdx.x * 32 + tx;
  float s = 0.0f;
  if (i < M)
    for (int k = ty; k < S; k += 8) s += part[(long)k * M + i];
  red[ty][tx] = s;
  __syncthreads();
  if (ty == 0 && i < M) {
    float t = 0.0f;
#pragma unroll
    for (int l = 0; l < 8; ++l) t += red[l][tx];
    out[i] = t;
  }
}

}  // namespace dsc

// Launches the five kernels on `stream`; returns the first non-zero
// cudaGetLastError(), else 0.  Scratch: dd (P.C fp32), ddw_part
// (ceil(P/ppb).9.C fp32), dpw_part (splits.C.F fp32), allocated by the caller.
extern "C" int sepconv_bwd(const void* x, const void* g, const void* dwk, const void* pwk,
                           const void* d, void* dx, void* ddw, void* dpw, void* dd,
                           void* ddw_part, void* dpw_part, int N, int H, int W, int C, int F,
                           int dil, int pre_relu, int ppb, int splits, long chunk,
                           void* stream) {
  using namespace dsc;
  cudaStream_t st = (cudaStream_t)stream;
  const long P = (long)N * H * W;
  int err;

  dd_kernel<<<dim3((unsigned)((P + BM - 1) / BM), (C + BN - 1) / BN), THREADS, 0, st>>>(
      (const bf16*)g, (const bf16*)pwk, (float*)dd, P, C, F);
  if ((err = (int)cudaGetLastError())) return err;

  const unsigned nblk = (unsigned)((P + ppb - 1) / ppb);
  dx_ddw_kernel<<<dim3(nblk, (C + DX_CT - 1) / DX_CT), THREADS, 0, st>>>(
      (const bf16*)x, (const float*)dd, (const bf16*)dwk, (bf16*)dx, (float*)ddw_part, N, H, W,
      C, dil, pre_relu, ppb);
  if ((err = (int)cudaGetLastError())) return err;

  const long mdw = 9L * C;
  reduce_kernel<<<(unsigned)((mdw + 31) / 32), THREADS, 0, st>>>(
      (const float*)ddw_part, (float*)ddw, (int)nblk, mdw);
  if ((err = (int)cudaGetLastError())) return err;

  dpw_kernel<<<dim3((F + BN - 1) / BN, (C + BM - 1) / BM, splits), THREADS, 0, st>>>(
      (const bf16*)d, (const bf16*)g, (float*)dpw_part, P, C, F, chunk);
  if ((err = (int)cudaGetLastError())) return err;

  const long mpw = (long)C * F;
  reduce_kernel<<<(unsigned)((mpw + 31) / 32), THREADS, 0, st>>>(
      (const float*)dpw_part, (float*)dpw, splits, mpw);
  return (int)cudaGetLastError();
}
