// Forward of the fused [BN-apply ->] [+skip ->] [ReLU ->] depthwise 3x3 ->
// pointwise 1x1 unit.
//
// Replaces the TPU kernel `_fwd_pallas` of
// deepcam_tpu/ops/pallas/fused_sepconv.py in all its forms: the base form,
// the folded BN apply (affine), the residual operand of the block boundary
// (skip, emitting r), and the emitted BN statistics (stats); the depthwise
// output d is written when the backward will need it (EMIT_D).
//
//   u = x                                             (bf16)
//   u = bf16(bf16(x * a) + b)      with the affine    (a, b per-channel bf16)
//   u = bf16(u + skip)             with skip          (skip requires the affine)
//   h = relu(u) if pre_relu else u;   r = h           (r only with skip)
//   d[p, c] = sum_ij h[r+(i-1)dil, w+(j-1)dil, c] * k[i,j,c]
//             fp32 products and sums in tap order (i, j), rounded once to
//             bf16; taps outside the image are zero AFTER the affine
//   y[p, f] = sum_c d[p, c] * pw[c, f]                fp32 accumulator, bf16 out
//   stats   = (sum_p y[p, f], sum_p y[p, f]^2)        fp32, of the bf16-rounded y
//
// Layouts: x, skip, d, r (N,H,W,C) and y (N,H,W,F) bf16 NHWC; dwk (3,3,C),
// pwk (C,F), a, b (C) bf16; stats (2,F) fp32.  C and F must be multiples of 8
// (16-byte vectors).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// middle-flow shape, batch 4, 728->728 at 48x72, the GEMM is 14.7 GFLOP
// (14.8 us of tensor-core time) against 60 MB of x, y and d (17.9 us; the
// boundary form adds skip and r, 80 MB), so the unit sits close to both
// roofs.  At the entry shape 64->128 at 384x576 it moves about 450 MB for
// 14.5 GFLOP: clearly bound by memory.
//
// What the design does about it: d never makes a round trip through device
// memory on the way to the GEMM.  Each block owns 64 output pixels x 128
// output channels, walks C in chunks of 32, builds the chunk of d in shared
// memory from the 9 taps of x (reads that neighbouring pixels share, so they
// hit L1/L2), applying the folded affine and the residual add to each tap as
// it is read, and feeds it straight to the tensor cores.  d and r are written
// to device memory once, by the blocks of the first F tile only.  The
// statistics come from the fp32 tile the epilogue already stages in shared
// memory: each block writes the sums of its 64 rows, and a second launch adds
// those partials in a fixed order (no atomics: the same sums on every run).
// This is the simple first form: operands are staged through registers
// without cp.async or TMA, wmma instead of wgmma, and the depthwise (with its
// prologue) is recomputed once per F tile (F/128 times).
#include "tile_mma.cuh"

namespace dsc {

// The prologue's operands are template parameters, so the base form runs the
// same code as without them; 2 blocks per SM (at most 128 registers).
template <bool AFFINE, bool SKIP>
__global__ void __launch_bounds__(THREADS, 2)
sepconv_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dwk,
                   const bf16* __restrict__ pwk, const bf16* __restrict__ av,
                   const bf16* __restrict__ bv, const bf16* __restrict__ skip,
                   bf16* __restrict__ y, bf16* __restrict__ dout, bf16* __restrict__ rout,
                   float* __restrict__ spart, int N, int H, int W, int C, int F, int dil,
                   int pre_relu) {
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
  const int av8 = tid & 3;
  const long p = p0 + am;
  const bool pv = p < P;
  int n = 0, r = 0, w = 0;
  if (pv) {
    n = (int)(p / ((long)H * W));
    const int rem = (int)(p - (long)n * H * W);
    r = rem / W;
    w = rem - r * W;
  }
  const bool first_ftile = blockIdx.y == 0;
  const bool write_d = dout != nullptr && first_ftile;
  const bool write_r = SKIP && first_ftile;

  Acc acc[2][2];
  zero_acc(acc);

  for (int c0 = 0; c0 < C; c0 += BK) {
    // ---- A: the chunk's depthwise output, rounded to bf16 ----
    {
      const int c = c0 + av8 * 8;
      float s[8], hc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) s[e] = hc[e] = 0.0f;
      const bool cv = pv && c < C;
      if (cv) {
        float ka[8], kb[8];
        if (AFFINE) {
          unpack8(*reinterpret_cast<const uint4*>(av + c), ka);
          unpack8(*reinterpret_cast<const uint4*>(bv + c), kb);
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const int rr = r + (i - 1) * dil;
          if (rr < 0 || rr >= H) continue;
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int ww = w + (j - 1) * dil;
            if (ww < 0 || ww >= W) continue;
            const long q = (((long)n * H + rr) * W + ww) * C + c;
            float u[8], kv[8];
            unpack8(*reinterpret_cast<const uint4*>(x + q), u);
            unpack8(*reinterpret_cast<const uint4*>(dwk + (i * 3 + j) * C + c), kv);
            if (AFFINE) affine8(u, ka, kb);
            if (SKIP) add_round8(u, *reinterpret_cast<const uint4*>(skip + q));
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float h = pre_relu ? fmaxf(u[e], 0.0f) : u[e];
              if (SKIP && i == 1 && j == 1) hc[e] = h;
              // no FMA contraction: the same rounding as the plain version
              s[e] = __fadd_rn(s[e], __fmul_rn(h, kv[e]));
            }
          }
        }
      }
      const uint4 dv = pack8(s);  // zeros outside the image / channel range
      *reinterpret_cast<uint4*>(As + am * (BK + PAD) + av8 * 8) = dv;
      if (write_d && cv) *reinterpret_cast<uint4*>(dout + p * C + c) = dv;
      if (write_r && cv) *reinterpret_cast<uint4*>(rout + p * C + c) = pack8(hc);
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
  // ---- statistics of the rounded y: threads 0-127 sum y, 128-255 y^2 ----
  // part layout: spart[blockIdx.x][0 or 1][F]
  if (spart != nullptr) {
    const int col = tid & (BN - 1);
    const int sq = tid / BN;
    const int ff = f0 + col;
    if (ff < F) {
      const int rows = (int)min((long)BM, P - p0);
      float s = 0.0f;
      for (int row = 0; row < rows; ++row) {
        const float v = bf16_round(Cs[row * CS_LD + col]);
        s += sq ? v * v : v;
      }
      spart[((long)blockIdx.x * 2 + sq) * F + ff] = s;
    }
  }
}

}  // namespace dsc

// Launches on `stream`; returns the first non-zero cudaGetLastError(), else
// 0.  a, b, skip, d, r and the statistics are optional (null): skip needs a
// and b; with `stats` (2,F fp32) the caller gives `spart` (ceil(P/64) x 2 x F
// fp32) and `sscratch` (ceil(ceil(P/64)/256) x 2 x F fp32, or null when
// ceil(P/64) <= 256).
extern "C" int sepconv_fwd(const void* x, const void* dwk, const void* pwk, const void* a,
                           const void* b, const void* skip, void* y, void* d, void* r,
                           void* spart, void* sscratch, void* stats, int N, int H, int W,
                           int C, int F, int dil, int pre_relu, void* stream) {
  using namespace dsc;
  cudaStream_t st = (cudaStream_t)stream;
  const long P = (long)N * H * W;
  const unsigned nbx = (unsigned)((P + BM - 1) / BM);
  const dim3 grid(nbx, (unsigned)((F + BN - 1) / BN));
  auto kernel = a == nullptr ? sepconv_fwd_kernel<false, false>
                : skip == nullptr ? sepconv_fwd_kernel<true, false>
                                  : sepconv_fwd_kernel<true, true>;
  kernel<<<grid, THREADS, 0, st>>>(
      (const bf16*)x, (const bf16*)dwk, (const bf16*)pwk, (const bf16*)a, (const bf16*)b,
      (const bf16*)skip, (bf16*)y, (bf16*)d, (bf16*)r, stats ? (float*)spart : nullptr, N, H,
      W, C, F, dil, pre_relu);
  const int err = (int)cudaGetLastError();
  if (err || stats == nullptr) return err;
  return reduce_partials((const float*)spart, (float*)stats, (float*)sscratch, (int)nbx,
                         2L * F, st);
}
