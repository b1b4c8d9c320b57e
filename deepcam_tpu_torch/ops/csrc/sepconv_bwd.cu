// Backward of the fused [BN-apply ->] [+skip ->] [ReLU ->] depthwise 3x3 ->
// pointwise 1x1 unit.
//
// Replaces the TPU kernel `_bwd_pallas` of
// deepcam_tpu/ops/pallas/fused_sepconv.py in all its forms, with the
// forward's emitted depthwise output d (EMIT_D): the base form, the folded BN
// apply (affine: da, db, dx = du.a), the block boundary (skip: the outside
// cotangent gr of r, d_skip = du) and the in-kernel fold of the statistics
// cotangent (stats).
//
//   g'          = bf16(g + (gs1 + 2.y.gs2))   with stats (gs1, gs2 per-channel
//                                             fp32, y the forward output)
//   dd[p, c]    = sum_f g'[p, f] * pw[c, f]                         fp32
//   dh[p, c]    = sum_ij dd[r+(i-1)dil, w+(j-1)dil, c] * k[2-i,2-j,c] [+ gr]
//   du          = dh * (u > 0)                (the mask only when pre_relu)
//   d_skip      = bf16(du)                    with skip
//   da, db      = sum_p du * x, sum_p du      fp32, with the affine
//   dx          = bf16(du * a)                (bf16(du) without the affine)
//   d_dw[i,j,c] = sum_p h[r+(i-1)dil, w+(j-1)dil, c] * dd[p, c]     fp32
//   d_pw[c, f]  = sum_p d[p, c] * g'[p, f]                          fp32
// with u and h = relu(u) (or u) formed from x, a, b and skip exactly as the
// forward forms them, and zero 'same' edges after the affine.
//
// The TPU kernel summed d_dw, d_pw, da and db across its sequential grid.
// Blocks on the GPU run in no order, so each block writes a partial sum and a
// second pass adds the partials in a fixed order: the result is
// deterministic.  Five launches:
//   1. dd_kernel      dd = g' . pw^T into an fp32 scratch tensor (wgmma)
//   2. dx_ddw_kernel  dx (and d_skip) from the flipped taps of dd, and
//                     per-block partial sums of d_dw (and da, db)
//   3. reduce_kernel  d_dw (and da, db) = sum of the partials
//   4. dpw_kernel     d^T . g' over one slice of the pixels per block (wgmma)
//                     into per-slice partials of d_pw
//   5. reduce_kernel  d_pw = sum of the partials
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): two
// GEMMs of 2.P.C.F operations each against reads of x, g, d and writes of dx
// (4 tensors of the unit's width; the boundary form adds skip, gr and d_skip,
// the stats form y).  At the middle-flow shape, batch 4, 728->728 at 48x72,
// that is 29.3 GFLOP (29.6 us) against 80 MB (23.9 us): both roofs are close.
// The entry shapes move far more bytes than they compute.
//
// What the design does about it: both GEMMs run on the shared Hopper
// mainloop: a producer warp keeps a ring of TMA-loaded, 128-byte-swizzled
// boxes full, two consumer warpgroups multiply them with wgmma m64n64k16.
// dd reads g (K-major) and pw (K-major: its rows are C); d_pw reads d and g
// with the pixel axis down the rows (both MN-major), so nothing is
// transposed in memory.  g' is formed where it is used: with the statistics
// fold the producer also loads the matching boxes of y, and the consumers
// rewrite g into g' in place in shared memory (zero past F and past the
// pixels), so no g' tensor is written or read.  dd stays fp32 (as the TPU
// kernel kept it) and makes one round trip through device memory.  dx_ddw
// stages a tile of 8 x 18 pixels x 32 channels of dd (cp.async), x and u (u
// formed once per element as the tile loads), with the 3x3 halo at the
// unit's dilation, in shared memory, and reads every tap there: each thread
// keeps 2 channels' 9 (or 11) partial sums, within 128 registers, two or
// more blocks per SM.  d_pw splits the pixel axis only as far as needed to
// give the card about four blocks per SM, so its partial buffer stays within
// tens of MB.  Work splits: `bwd_plan` in ops/fused_sepconv.py.
#include "tile_mma.cuh"

namespace dsc {

// g' = bf16(g + (gs1 + (2.y).gs2)) for 8 channels f..f+7, no FMA contraction
// (the plain version's order and rounding).
__device__ __forceinline__ uint4 fold_g8(const uint4 gv, const uint4 yv, const float* gs1,
                                         const float* gs2) {
  float gf[8], yf[8];
  unpack8(gv, gf);
  unpack8(yv, yf);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float t = __fmul_rn(__fmul_rn(2.0f, yf[e]), gs2[e]);
    gf[e] = __fadd_rn(gf[e], __fadd_rn(gs1[e], t));
  }
  return pack8(gf);
}

// Unit u (of 512) of a box of g whose rows are pixels from `prow0` (valid
// below `pend`) and whose columns are output channels from `f0` (valid below
// F): g' in place, from the same unit of the box of y; zero where invalid.
__device__ __forceinline__ void fold_unit(unsigned char* gbox, const unsigned char* ybox, int u,
                                          long prow0, long pend, int f0, int F,
                                          const float* __restrict__ gs1,
                                          const float* __restrict__ gs2) {
  const int row = u >> 3;
  const int pu = u & 7;
  const int f = f0 + ((pu ^ (row & 7)) << 3);
  const int off = row * 128 + (pu << 4);
  uint4 v = make_uint4(0, 0, 0, 0);
  if (prow0 + row < pend && f < F)
    v = fold_g8(*reinterpret_cast<const uint4*>(gbox + off),
                *reinterpret_cast<const uint4*>(ybox + off), gs1 + f, gs2 + f);
  *reinterpret_cast<uint4*>(gbox + off) = v;
}

// The ring (stages of `stage_bytes`, then the barriers) in a GEMM kernel's
// dynamic shared memory, 1024-byte aligned.
__device__ __forceinline__ Ring gemm_ring(unsigned char* smem_raw, int stages, int stage_bytes,
                                          unsigned char*& ring_mem) {
  ring_mem = smem_raw + ((SMEM_ALIGN - (smem_u32(smem_raw) & (SMEM_ALIGN - 1))) &
                         (SMEM_ALIGN - 1));
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring_mem + stages * stage_bytes);
  return Ring{bars, bars + stages, stages};
}

inline int gemm_smem_bytes(int stages, int boxes) {
  return SMEM_ALIGN + stages * (boxes * BOX_BYTES + 16);
}

// The consumers' mainloop over nk >= 1 stages of [A box][B box 0][B box 1]
// [...]: warpgroup g multiplies A by B box g.  `prep(stage, k)` may rewrite
// the stage's boxes first (it returns whether it did).  The first stage
// overwrites the accumulators; each later one keeps one wgmma batch in
// flight and hands the stage before it back to the producer.
template <bool A_MN, bool B_MN, typename Prep>
__device__ __forceinline__ void gemm_consume(Acc& acc, Ring& ring, unsigned char* ring_mem,
                                             int stage_bytes, int nk, Prep prep) {
  const int wg = threadIdx.x >> 7;
#pragma unroll 1
  for (int k = 0; k < nk; ++k) {
    unsigned char* st = ring_mem + ring.wait(k) * stage_bytes;
    if (prep(st, k)) {
      fence_async_smem();
      consumer_sync(GEMM_CONSUMERS);
    }
    acc_fence(acc);
    wgmma_fence();
    wgmma_box<A_MN, B_MN>(acc, st, st + (1 + wg) * BOX_BYTES, k > 0);
    wgmma_commit();
    wgmma_wait<1>();
    acc_fence(acc);
    if (k > 0) ring.release(k - 1);
  }
  wgmma_wait<0>();
  acc_fence(acc);
  ring.release(nk - 1);
}

// fp32 stores of this thread's accumulators into out[row][col] (row stride
// ld): rows from row0 (valid below rows), columns from col0 (valid below
// cols).
__device__ __forceinline__ void store_acc_f32(const Acc& acc, float* __restrict__ out, long ld,
                                              long row0, long rows, int col0, int cols) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long r = row0 + acc_row(h);
    if (r >= rows) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = col0 + acc_col(i);
      if (c < cols)
        *reinterpret_cast<float2*>(out + r * ld + c) =
            make_float2(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
    }
  }
}

// ---- 1. dd = g' . pw^T :  M = pixels (64), N = C (128), K = F ----
// Stage: [g box (pixels x f)][pw box (c0.. x f)][pw box (c0+64.. x f)][y box].
template <bool FOLD>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
dd_kernel(const __grid_constant__ CUtensorMap g_map, const __grid_constant__ CUtensorMap y_map,
          const __grid_constant__ CUtensorMap pw_map, const float* __restrict__ gs1,
          const float* __restrict__ gs2, float* __restrict__ dd, long P, int C, int F,
          int stages) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int STAGE = (FOLD ? 4 : 3) * BOX_BYTES;
  unsigned char* ring_mem;
  Ring ring = gemm_ring(smem_raw, stages, STAGE, ring_mem);
  const int tid = threadIdx.x;
  if (tid == 0) ring.init();
  __syncthreads();
  const long p0 = (long)blockIdx.x * BOX;
  const int c0 = blockIdx.y * 2 * BOX;
  const int nk = (F + BOX - 1) / BOX;

  if (tid >= GEMM_CONSUMERS) {  // the producer warp
    if (tid == GEMM_CONSUMERS) {
      for (int k = 0; k < nk; ++k) {
        const int s = ring.acquire(k, STAGE);
        unsigned char* st = ring_mem + s * STAGE;
        tma_load_2d(st, &g_map, &ring.full[s], k * BOX, (int)p0);
        tma_load_2d(st + BOX_BYTES, &pw_map, &ring.full[s], k * BOX, c0);
        tma_load_2d(st + 2 * BOX_BYTES, &pw_map, &ring.full[s], k * BOX, c0 + BOX);
        if (FOLD) tma_load_2d(st + 3 * BOX_BYTES, &y_map, &ring.full[s], k * BOX, (int)p0);
      }
    }
    return;
  }
  Acc acc;
  gemm_consume<false, false>(acc, ring, ring_mem, STAGE, nk, [&](unsigned char* st, int k) {
    if (!FOLD) return false;
#pragma unroll
    for (int q = 0; q < 2; ++q)
      fold_unit(st, st + 3 * BOX_BYTES, tid + q * GEMM_CONSUMERS, p0, P, k * BOX, F, gs1, gs2);
    return true;
  });
  store_acc_f32(acc, dd, C, p0, P, c0 + (tid >> 7) * BOX, C);
}

// ---- 2. dx (and d_skip), and per-block partial sums of d_dw (and da, db) ----
// A block walks `tiles` spatial tiles of DX_TH x DX_TW pixels (blockIdx.x)
// for DX_CT channels (blockIdx.y).  Each tile is staged with its halo at the
// dilation: dd (fp32, by cp.async), x and u (bf16; u = the prologue of x,
// zero outside the image).  Thread: channels 2*(tid%16) and +1 of the
// slice, pixels tid/16, tid/16 + 16, ... of the tile.  Partial layout:
// part[blockIdx.x][row][C], rows 0-8 the taps of d_dw, with the affine rows
// 9 (da) and 10 (db).
constexpr int DX_TH = 8;
constexpr int DX_TW = 18;
constexpr int DX_CT = 32;
constexpr int DX_LANES = THREADS / (DX_CT / 2);  // 16 pixel lanes

inline int dx_smem_bytes(int dil) {
  return (DX_TH + 2 * dil) * (DX_TW + 2 * dil) * DX_CT * (4 + 2 + 2);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

template <bool AFFINE, bool SKIP>
__global__ void __launch_bounds__(THREADS, 2)
dx_ddw_kernel(const bf16* __restrict__ x, const float* __restrict__ dd,
              const bf16* __restrict__ dwk, const bf16* __restrict__ av,
              const bf16* __restrict__ bv, const bf16* __restrict__ skip,
              const bf16* __restrict__ gr, bf16* __restrict__ dx, bf16* __restrict__ dskip,
              float* __restrict__ part, int N, int H, int W, int C, int dil, int pre_relu,
              int tiles) {
  constexpr int ROWS = AFFINE ? 11 : 9;
  extern __shared__ float4 dx_smem[];
  __shared__ float ks[9][DX_CT];
  __shared__ float ab[2][DX_CT];
  const int HW = DX_TW + 2 * dil;
  const int HP = (DX_TH + 2 * dil) * HW;
  float* dds = reinterpret_cast<float*>(dx_smem);        // [HP][DX_CT] fp32
  bf16* xs = reinterpret_cast<bf16*>(dds + HP * DX_CT);  // [HP][DX_CT]
  bf16* us = xs + HP * DX_CT;                            // [HP][DX_CT]

  const int tid = threadIdx.x;
  const int cbase = blockIdx.y * DX_CT;
  for (int i = tid; i < 9 * DX_CT; i += THREADS) {
    const int ch = cbase + i % DX_CT;
    ks[i / DX_CT][i % DX_CT] = ch < C ? __bfloat162float(dwk[(i / DX_CT) * C + ch]) : 0.0f;
  }
  if (AFFINE) {
    for (int i = tid; i < 2 * DX_CT; i += THREADS) {
      const int ch = cbase + i % DX_CT;
      ab[i / DX_CT][i % DX_CT] = ch < C ? __bfloat162float((i < DX_CT ? av : bv)[ch]) : 0.0f;
    }
  }
  __syncthreads();

  const int cl = 2 * (tid % (DX_CT / 2));
  const int lane = tid / (DX_CT / 2);
  const int c = cbase + cl;
  float kf[9][2];  // flipped: tap (i, j) takes k[2-i][2-j]
#pragma unroll
  for (int t = 0; t < 9; ++t) {
    kf[t][0] = ks[8 - t][cl];
    kf[t][1] = ks[8 - t][cl + 1];
  }
  const float a0 = AFFINE ? ab[0][cl] : 1.0f;
  const float a1 = AFFINE ? ab[0][cl + 1] : 1.0f;
  float acc[ROWS][2];
#pragma unroll
  for (int t = 0; t < ROWS; ++t) acc[t][0] = acc[t][1] = 0.0f;

  const int tiles_h = (H + DX_TH - 1) / DX_TH;
  const int tiles_w = (W + DX_TW - 1) / DX_TW;
  const int ntiles = N * tiles_h * tiles_w;
  for (int tt = 0; tt < tiles; ++tt) {
    const int tile = blockIdx.x * tiles + tt;
    if (tile >= ntiles) break;
    const int n = tile / (tiles_h * tiles_w);
    const int rem = tile - n * tiles_h * tiles_w;
    const int r0 = rem / tiles_w * DX_TH - dil;  // the halo's first row and column
    const int w0 = rem % tiles_w * DX_TW - dil;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < HP * (DX_CT / 4); i += THREADS) {
      const int pos = i / (DX_CT / 4);
      const int cc = cbase + (i % (DX_CT / 4)) * 4;
      const int rr = r0 + pos / HW;
      const int ww = w0 + pos % HW;
      float* dst = dds + pos * DX_CT + (i % (DX_CT / 4)) * 4;
      if (rr >= 0 && rr < H && ww >= 0 && ww < W && cc < C)
        cp_async16(dst, dd + (((long)n * H + rr) * W + ww) * C + cc);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    for (int i = tid; i < HP * (DX_CT / 8); i += THREADS) {
      const int pos = i / (DX_CT / 8);
      const int v = i % (DX_CT / 8);
      const int cc = cbase + v * 8;
      const int rr = r0 + pos / HW;
      const int ww = w0 + pos % HW;
      uint4 xv = make_uint4(0, 0, 0, 0), uv = make_uint4(0, 0, 0, 0);
      if (rr >= 0 && rr < H && ww >= 0 && ww < W && cc < C) {
        const long q = (((long)n * H + rr) * W + ww) * C + cc;
        xv = *reinterpret_cast<const uint4*>(x + q);
        uv = xv;
        if (AFFINE) {
          float u[8];
          unpack8(xv, u);
          affine8(u, &ab[0][v * 8], &ab[1][v * 8]);
          if (SKIP) add_round8(u, *reinterpret_cast<const uint4*>(skip + q));
          uv = pack8(u);
        }
      }
      *reinterpret_cast<uint4*>(xs + pos * DX_CT + v * 8) = xv;
      *reinterpret_cast<uint4*>(us + pos * DX_CT + v * 8) = uv;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    if (c < C) {
      for (int m = lane; m < DX_TH * DX_TW; m += DX_LANES) {
        const int ty = m / DX_TW;
        const int tx = m - ty * DX_TW;
        const int r = r0 + dil + ty;
        const int w = w0 + dil + tx;
        if (r >= H || w >= W) continue;
        const int cpos = (ty + dil) * HW + tx + dil;
        const float2 ddc = *reinterpret_cast<const float2*>(dds + cpos * DX_CT + cl);
        float dh0 = 0.0f, dh1 = 0.0f;
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const int pos = (ty + i * dil) * HW + tx + j * dil;
            // depthwise dgrad: flipped kernel against the tap of dd
            const float2 dv = *reinterpret_cast<const float2*>(dds + pos * DX_CT + cl);
            dh0 += dv.x * kf[i * 3 + j][0];
            dh1 += dv.y * kf[i * 3 + j][1];
            // depthwise wgrad: the tap of h against the centre of dd
            float2 h = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(us + pos * DX_CT + cl));
            if (pre_relu) h = make_float2(fmaxf(h.x, 0.0f), fmaxf(h.y, 0.0f));
            acc[i * 3 + j][0] += h.x * ddc.x;
            acc[i * 3 + j][1] += h.y * ddc.y;
          }
        const long q = (((long)n * H + r) * W + w) * C + c;
        if (gr != nullptr) {
          const float2 gv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(gr + q));
          dh0 += gv.x;
          dh1 += gv.y;
        }
        if (pre_relu) {
          const float2 uc = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(us + cpos * DX_CT + cl));
          dh0 = uc.x > 0.0f ? dh0 : 0.0f;
          dh1 = uc.y > 0.0f ? dh1 : 0.0f;
        }
        // dh is now du, the cotangent of u
        if (dskip != nullptr)
          *reinterpret_cast<__nv_bfloat162*>(dskip + q) = __floats2bfloat162_rn(dh0, dh1);
        if (AFFINE) {
          const float2 xc = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(xs + cpos * DX_CT + cl));
          acc[ROWS - 2][0] += dh0 * xc.x;
          acc[ROWS - 2][1] += dh1 * xc.y;
          acc[ROWS - 1][0] += dh0;
          acc[ROWS - 1][1] += dh1;
          dh0 *= a0;
          dh1 *= a1;
        }
        *reinterpret_cast<__nv_bfloat162*>(dx + q) = __floats2bfloat162_rn(dh0, dh1);
      }
    }
  }

  // lanes 16 apart share their channels; then the 8 warps, in order
#pragma unroll
  for (int t = 0; t < ROWS; ++t) {
    acc[t][0] += __shfl_xor_sync(0xffffffffu, acc[t][0], 16);
    acc[t][1] += __shfl_xor_sync(0xffffffffu, acc[t][1], 16);
  }
  __syncthreads();
  float* red = dds;  // [8 warps][ROWS][DX_CT]
  const int warp = tid >> 5;
  if ((tid & 31) < 16) {
#pragma unroll
    for (int t = 0; t < ROWS; ++t) {
      red[(warp * ROWS + t) * DX_CT + cl] = acc[t][0];
      red[(warp * ROWS + t) * DX_CT + cl + 1] = acc[t][1];
    }
  }
  __syncthreads();
  for (int i = tid; i < ROWS * DX_CT; i += THREADS) {
    const int ch = cbase + i % DX_CT;
    if (ch < C) {
      float s = 0.0f;
#pragma unroll
      for (int wi = 0; wi < THREADS / 32; ++wi) s += red[wi * ROWS * DX_CT + i];
      part[((long)blockIdx.x * ROWS + i / DX_CT) * C + ch] = s;
    }
  }
}

// ---- 4. per-slice partials of d_pw = d^T . g' :  M = C (64), N = F (128),
// K = the slice's pixels ----
// Stage: [d box (pixels x c0..)][g box (pixels x f0..)][g box (f0+64..)]
// [y box][y box]; the slices start at multiples of 64 pixels.
template <bool FOLD>
__global__ void __launch_bounds__(GEMM_THREADS, 2)
dpw_kernel(const __grid_constant__ CUtensorMap d_map, const __grid_constant__ CUtensorMap g_map,
           const __grid_constant__ CUtensorMap y_map, const float* __restrict__ gs1,
           const float* __restrict__ gs2, float* __restrict__ part, long P, int C, int F,
           long chunk, int stages) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int STAGE = (FOLD ? 5 : 3) * BOX_BYTES;
  unsigned char* ring_mem;
  Ring ring = gemm_ring(smem_raw, stages, STAGE, ring_mem);
  const int tid = threadIdx.x;
  if (tid == 0) ring.init();
  __syncthreads();
  const int f0 = blockIdx.x * 2 * BOX;
  const int c0 = blockIdx.y * BOX;
  const long kbeg = (long)blockIdx.z * chunk;
  const long kend = min(kbeg + chunk, P);
  const int nk = (int)((kend - kbeg + BOX - 1) / BOX);

  if (tid >= GEMM_CONSUMERS) {  // the producer warp
    if (tid == GEMM_CONSUMERS) {
      for (int k = 0; k < nk; ++k) {
        const int s = ring.acquire(k, STAGE);
        unsigned char* st = ring_mem + s * STAGE;
        const int pix = (int)(kbeg + (long)k * BOX);
        tma_load_2d(st, &d_map, &ring.full[s], c0, pix);
        tma_load_2d(st + BOX_BYTES, &g_map, &ring.full[s], f0, pix);
        tma_load_2d(st + 2 * BOX_BYTES, &g_map, &ring.full[s], f0 + BOX, pix);
        if (FOLD) {
          tma_load_2d(st + 3 * BOX_BYTES, &y_map, &ring.full[s], f0, pix);
          tma_load_2d(st + 4 * BOX_BYTES, &y_map, &ring.full[s], f0 + BOX, pix);
        }
      }
    }
    return;
  }
  Acc acc;
  gemm_consume<true, true>(acc, ring, ring_mem, STAGE, nk, [&](unsigned char* st, int k) {
    if (!FOLD) return false;
    const long pix = kbeg + (long)k * BOX;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int u = tid + q * GEMM_CONSUMERS;
      const int b = u >> 9;
      fold_unit(st + (1 + b) * BOX_BYTES, st + (3 + b) * BOX_BYTES, u & 511, pix, kend,
                f0 + b * BOX, F, gs1, gs2);
    }
    return true;
  });
  store_acc_f32(acc, part + (long)blockIdx.z * C * F, F, c0, C, f0 + (tid >> 7) * BOX, F);
}

}  // namespace dsc

// Launches the five kernels on `stream`; returns the first non-zero CUDA
// error, else 0.  Optional operands are null when absent: a and b (the
// affine; then `ddw` holds 11 x C floats, d_dw then da then db, else 9 x C),
// skip and gr (the boundary; skip needs a and b, and then dskip is written),
// y with gs1 and gs2 (the statistics cotangent).  Scratch, allocated by the
// caller: dd (P.C fp32), ddw_part (dx blocks x rows x C fp32), dpw_part
// (splits.C.F fp32).  The work split is bwd_plan's: dx_tiles spatial tiles
// per dx block, the two GEMMs' ring stages, `splits` slices of `chunk`
// pixels (a multiple of 64).
extern "C" int sepconv_bwd(const void* x, const void* g, const void* dwk, const void* pwk,
                           const void* d, const void* a, const void* b, const void* skip,
                           const void* gr, const void* y, const void* gs1, const void* gs2,
                           void* dx, void* dskip, void* ddw, void* dpw, void* dd,
                           void* ddw_part, void* dpw_part, int N, int H, int W, int C, int F,
                           int dil, int pre_relu, int dx_tiles, int dd_stages, int dpw_stages,
                           int splits, long chunk, void* stream) {
  using namespace dsc;
  cudaStream_t st = (cudaStream_t)stream;
  const long P = (long)N * H * W;
  const bool fold = y != nullptr;
  if (dd_stages < 2 || dpw_stages < 2 || dx_tiles < 1 || splits < 1 || chunk % BOX)
    return (int)cudaErrorInvalidValue;  // the ring needs two stages
  int err;
  CUtensorMap g_map, y_map, pw_map, d_map;
  if ((err = make_box_map(&g_map, g, P, F, F))) return err;
  if ((err = make_box_map(&y_map, fold ? y : g, P, F, F))) return err;
  if ((err = make_box_map(&pw_map, pwk, C, F, F))) return err;
  if ((err = make_box_map(&d_map, d, P, C, C))) return err;

  auto dd_k = fold ? dd_kernel<true> : dd_kernel<false>;
  const int dd_smem = gemm_smem_bytes(dd_stages, fold ? 4 : 3);
  if ((err = allow_smem((const void*)dd_k))) return err;
  dd_k<<<dim3((unsigned)((P + BOX - 1) / BOX), (C + 2 * BOX - 1) / (2 * BOX)), GEMM_THREADS,
         dd_smem, st>>>(g_map, y_map, pw_map, (const float*)gs1, (const float*)gs2, (float*)dd,
                        P, C, F, dd_stages);
  if ((err = (int)cudaGetLastError())) return err;

  const int ntiles = N * ((H + DX_TH - 1) / DX_TH) * ((W + DX_TW - 1) / DX_TW);
  const unsigned nblk = (unsigned)((ntiles + dx_tiles - 1) / dx_tiles);
  auto dx_ddw = a == nullptr ? dx_ddw_kernel<false, false>
                : skip == nullptr ? dx_ddw_kernel<true, false>
                                  : dx_ddw_kernel<true, true>;
  const int dx_smem = dx_smem_bytes(dil);
  if ((err = allow_smem((const void*)dx_ddw))) return err;
  dx_ddw<<<dim3(nblk, (C + DX_CT - 1) / DX_CT), THREADS, dx_smem, st>>>(
      (const bf16*)x, (const float*)dd, (const bf16*)dwk, (const bf16*)a, (const bf16*)b,
      (const bf16*)skip, (const bf16*)gr, (bf16*)dx, (bf16*)dskip, (float*)ddw_part, N, H, W,
      C, dil, pre_relu, dx_tiles);
  if ((err = (int)cudaGetLastError())) return err;

  const long rows = a != nullptr ? 11 : 9;
  if ((err = reduce_partials((const float*)ddw_part, (float*)ddw, nullptr, (int)nblk,
                             rows * C, st)))
    return err;

  auto dpw_k = fold ? dpw_kernel<true> : dpw_kernel<false>;
  const int dpw_smem = gemm_smem_bytes(dpw_stages, fold ? 5 : 3);
  if ((err = allow_smem((const void*)dpw_k))) return err;
  dpw_k<<<dim3((F + 2 * BOX - 1) / (2 * BOX), (C + BOX - 1) / BOX, splits), GEMM_THREADS,
          dpw_smem, st>>>(d_map, g_map, y_map, (const float*)gs1, (const float*)gs2,
                          (float*)dpw_part, P, C, F, chunk, dpw_stages);
  if ((err = (int)cudaGetLastError())) return err;

  return reduce_partials((const float*)dpw_part, (float*)dpw, nullptr, splits, (long)C * F,
                         st);
}
