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
// (16-byte vectors and TMA row strides).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at the
// middle-flow shape, batch 4, 728->728 at 48x72, the GEMM is 14.7 GFLOP
// (14.8 us of tensor-core time) against 60 MB of x, y and d (17.9 us; the
// boundary form adds skip and r, 80 MB): close to both roofs.  At the entry
// shape 64->128 at 384x576 it moves about 450 MB for 14.5 GFLOP: memory.
//
// What the design does about it: a block owns 64 pixels and all of F, and
// builds d for its pixels once: 64 x ceil64(C) bf16, resident in shared
// memory in the swizzled K-major layout that wgmma's A descriptor reads (the
// channels past C written as zeros).  Where it fits (all C but 1536) the 64
// pixels are an 8 x 8 tile of one image: for each 64-channel chunk the
// prologue (affine, residual add, ReLU) runs once per element of the tile
// and its halo, into a shared buffer of h, and the 9 taps are read from
// there (r is written from it too); else the pixels are 64 in a row and
// the taps, with their prologue, come from L1/L2.  The block then walks the
// F tiles of 128: two consumer warpgroups each multiply d by one 64-wide
// half of the tile with wgmma m64n64k16, the pointwise weights coming by
// TMA (MN-major boxes, zero past C and F) through a ring of stages that a
// producer warp keeps full.  During the first F tile the depthwise of chunk
// k+1 (CUDA cores) runs while the wgmma of chunk k is in flight.  d and r
// go to device memory once, as they are built.  In the epilogue the staged
// kernel rounds y into a shared tile, stores it in 16-byte row vectors and
// sums each column (Σy, Σy² of the bf16-rounded y) over the 64 rows in
// order: one partial per tile; the unstaged one stores y from the
// registers and sums each warp's 16 rows by shuffles: four partials per
// tile.  A second launch adds the partials in a fixed order: no atomics,
// the same sums on every run.  The plan (staging, stages, blocks per SM)
// comes from `fwd_plan` in ops/fused_sepconv.py.
#include <chrono>

#include "tile_mma.cuh"

namespace dsc {

constexpr int FWD_BN = 2 * BOX;  // output channels per F tile
constexpr int FWD_TILE = 8;      // a staged block's pixels: FWD_TILE x FWD_TILE

// Launch modes (fwd_plan's): the taps from L1/L2, one block per SM; staged,
// one or two blocks per SM; staged, two blocks per SM, all the pw boxes
// loaded at the start (when they fit the ring: no producer warp, 256
// threads, so up to 128 registers).
enum FwdMode { UNSTAGED = 0, STAGED_1 = 1, STAGED_2 = 2, PRELOADED_2 = 3 };
constexpr int BAR_BYTES = 16;    // one full and one empty barrier per stage

constexpr int YT_LD = BOX + 8;    // row stride of a staged y tile (no bank conflicts)

// The staged block's buffer: h of the tile with its halo for one 64-channel
// chunk while d is built, then the two warpgroups' bf16 y tiles [64][YT_LD]
// in each epilogue (1024-aligned).
__host__ __device__ inline int fwd_halo_bytes(int dil) {
  const int hw = FWD_TILE + 2 * dil;
  const int bytes = hw * hw * 128 > 2 * BOX * YT_LD * 2 ? hw * hw * 128 : 2 * BOX * YT_LD * 2;
  return (bytes + SMEM_ALIGN - 1) / SMEM_ALIGN * SMEM_ALIGN;
}

inline int fwd_smem_bytes(int C, int dil, int staged, int stages) {
  return SMEM_ALIGN + (C + BOX - 1) / BOX * BOX_BYTES + (staged ? fwd_halo_bytes(dil) : 0) +
         stages * (2 * BOX_BYTES + BAR_BYTES);
}

// The depthwise of 8 channels c..c+7 of one pixel (n, r, w), with the
// prologue on each tap; hc gets the centre tap's h (r, for the boundary
// form).  The unstaged kernel's taps.
template <bool AFFINE, bool SKIP>
__device__ __forceinline__ void depthwise8(const bf16* __restrict__ x,
                                           const bf16* __restrict__ dwk,
                                           const bf16* __restrict__ av,
                                           const bf16* __restrict__ bv,
                                           const bf16* __restrict__ skip, int n, int r, int w,
                                           int c, int H, int W, int C, int dil, int pre_relu,
                                           float (&s)[8], float (&hc)[8]) {
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

// The pixels of a block: with STAGED an 8 x 8 spatial tile of one image
// (row m of the GEMM is pixel (r0 + m / 8, w0 + m % 8)), else 64 pixels in a
// row of the flattened N*H*W axis.
template <bool STAGED>
struct PixelTile {
  int n, r0, w0, H, W;
  long p0, P;
  __device__ __forceinline__ PixelTile(int N, int H_, int W_)
      : n(0), r0(0), w0(0), H(H_), W(W_), p0(0) {
    P = (long)N * H * W;
    if (STAGED) {
      const int tw = (W + FWD_TILE - 1) / FWD_TILE;
      const int th = (H + FWD_TILE - 1) / FWD_TILE;
      n = blockIdx.x / (tw * th);
      const int rem = blockIdx.x - n * tw * th;
      r0 = rem / tw * FWD_TILE;
      w0 = rem % tw * FWD_TILE;
    } else {
      p0 = (long)blockIdx.x * BOX;
    }
  }
  // the flattened pixel of GEMM row m, and whether it exists
  __device__ __forceinline__ bool pixel(int m, long& p) const {
    if (STAGED) {
      const int r = r0 + m / FWD_TILE, w = w0 + m % FWD_TILE;
      p = ((long)n * H + r) * W + w;
      return r < H && w < W;
    }
    p = p0 + m;
    return p < P;
  }
};

// Threads 0-255: two consumer warpgroups (warpgroup g multiplies into
// output columns [t*128 + 64g, t*128 + 64g + 64) of F tile t); threads
// 256-287: the producer warp (none when preloaded: thread 0 issues every
// load at the start).  Dynamic shared memory: the d tile
// (ceil(C/64) boxes of [64 pixels][64 channels]); with STAGED the halo
// buffer, h of the tile's (8 + 2 dil)^2 pixels for one 64-channel chunk;
// the ring (per stage two boxes of pw, [64 channels][64 outputs]); the
// ring's barriers.
template <bool AFFINE, bool SKIP, int MODE, bool STAGED = MODE != UNSTAGED,
          bool PRE = MODE == PRELOADED_2, int MINB = MODE >= STAGED_2 ? 2 : 1>
__global__ void __launch_bounds__(PRE ? GEMM_CONSUMERS : GEMM_THREADS, MINB)
sepconv_fwd_kernel(const __grid_constant__ CUtensorMap pw_map, const bf16* __restrict__ x,
                   const bf16* __restrict__ dwk, const bf16* __restrict__ av,
                   const bf16* __restrict__ bv, const bf16* __restrict__ skip,
                   bf16* __restrict__ y, bf16* __restrict__ dout, bf16* __restrict__ rout,
                   float* __restrict__ spart, int N, int H, int W, int C, int F, int dil,
                   int pre_relu, int stages) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* dtile = smem_raw + ((SMEM_ALIGN - (smem_u32(smem_raw) & (SMEM_ALIGN - 1))) &
                                     (SMEM_ALIGN - 1));
  const int nk = (C + BOX - 1) / BOX;
  unsigned char* halo = dtile + nk * BOX_BYTES;
  unsigned char* ring_mem = halo + (STAGED ? fwd_halo_bytes(dil) : 0);
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring_mem + stages * 2 * BOX_BYTES);
  Ring ring{bars, bars + stages, stages};

  const int tid = threadIdx.x;
  if (tid == 0) ring.init();
  __syncthreads();

  const PixelTile<STAGED> tile(N, H, W);
  const int nf = (F + FWD_BN - 1) / FWD_BN;

  if (PRE) {  // every box at once: the ring has a stage for each
    if (tid == 0)
      for (int t = 0, i = 0; t < nf; ++t)
        for (int k = 0; k < nk; ++k, ++i) {
          mbar_expect_tx(&ring.full[i], 2 * BOX_BYTES);
          unsigned char* st = ring_mem + i * 2 * BOX_BYTES;
          tma_load_2d(st, &pw_map, &ring.full[i], t * FWD_BN, k * BOX);
          tma_load_2d(st + BOX_BYTES, &pw_map, &ring.full[i], t * FWD_BN + BOX, k * BOX);
        }
  } else if (tid >= GEMM_CONSUMERS) {  // the producer warp
    if (tid == GEMM_CONSUMERS) {
      prefetch_map(&pw_map);
      int i = 0;
      for (int t = 0; t < nf; ++t)
        for (int k = 0; k < nk; ++k, ++i) {
          const int s = ring.acquire(i, 2 * BOX_BYTES);
          unsigned char* st = ring_mem + s * 2 * BOX_BYTES;
          tma_load_2d(st, &pw_map, &ring.full[s], t * FWD_BN, k * BOX);
          tma_load_2d(st + BOX_BYTES, &pw_map, &ring.full[s], t * FWD_BN + BOX, k * BOX);
        }
    }
    return;
  }

  // depthwise mapping: channel vector v of a chunk, GEMM rows row0, row0+32
  const int v = tid & 7;
  const int row0 = tid >> 3;
  long pp[2];
  bool pv[2];
  int pn[2], pr[2], pc[2];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    pv[q] = tile.pixel(row0 + 32 * q, pp[q]);
    const long p = pv[q] ? pp[q] : 0;
    pn[q] = (int)(p / ((long)H * W));
    const int rem = (int)(p - (long)pn[q] * H * W);
    pr[q] = rem / W;
    pc[q] = rem - pr[q] * W;
  }
  const int wg = tid >> 7;
  const int hw = FWD_TILE + 2 * dil;  // halo width

  Acc acc;
  int it = 0;
  for (int t = 0; t < nf; ++t) {
    for (int k = 0; k < nk; ++k, ++it) {
      if (t == 0) {
        // ---- chunk k of d: channels k*64 .. k*64+63, zeros past C ----
        const int c = k * BOX + v * 8;
        if (STAGED) {
          // h = the prologue of x, once per element of the haloed tile (zero
          // outside the image); r is h on the tile itself
#pragma unroll (PRE ? 4 : 2)
          for (int u = tid; u < hw * hw * 8; u += GEMM_CONSUMERS) {
            const int pos = u >> 3, vv = u & 7;
            const int hr = pos / hw, hcol = pos - hr * hw;
            const int rr = tile.r0 - dil + hr, ww = tile.w0 - dil + hcol;
            const int cc = k * BOX + vv * 8;
            uint4 hv = make_uint4(0, 0, 0, 0);
            if (rr >= 0 && rr < H && ww >= 0 && ww < W && cc < C) {
              const long q = (((long)tile.n * H + rr) * W + ww) * C + cc;
              float h[8];
              unpack8(*reinterpret_cast<const uint4*>(x + q), h);
              if (AFFINE) {
                float ka[8], kb[8];
                unpack8(*reinterpret_cast<const uint4*>(av + cc), ka);
                unpack8(*reinterpret_cast<const uint4*>(bv + cc), kb);
                affine8(h, ka, kb);
              }
              if (SKIP) add_round8(h, *reinterpret_cast<const uint4*>(skip + q));
              if (pre_relu) {
#pragma unroll
                for (int e = 0; e < 8; ++e) h[e] = fmaxf(h[e], 0.0f);
              }
              hv = pack8(h);  // exact: h is a bf16 value
              if (SKIP && hr >= dil && hr < dil + FWD_TILE && hcol >= dil &&
                  hcol < dil + FWD_TILE)
                *reinterpret_cast<uint4*>(rout + q) = hv;
            }
            *reinterpret_cast<uint4*>(halo + pos * 128 + vv * 16) = hv;
          }
          consumer_sync(GEMM_CONSUMERS);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          float s[8], hc[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) s[e] = hc[e] = 0.0f;
          const bool cv = pv[q] && c < C;
          const int row = row0 + 32 * q;
          if (cv && STAGED) {
            // the 9 taps from the halo buffer, fp32 products and sums in tap
            // order (a tap outside the image adds an exact zero)
            const int ty = row / FWD_TILE, tx = row % FWD_TILE;
#pragma unroll
            for (int i = 0; i < 3; ++i)
#pragma unroll
              for (int j = 0; j < 3; ++j) {
                float h[8], kv[8];
                unpack8(*reinterpret_cast<const uint4*>(
                            halo + ((ty + i * dil) * hw + tx + j * dil) * 128 + v * 16), h);
                unpack8(*reinterpret_cast<const uint4*>(dwk + (i * 3 + j) * C + c), kv);
#pragma unroll
                for (int e = 0; e < 8; ++e) s[e] = __fadd_rn(s[e], __fmul_rn(h[e], kv[e]));
              }
          } else if (cv) {
            depthwise8<AFFINE, SKIP>(x, dwk, av, bv, skip, pn[q], pr[q],
                                                         pc[q], c, H, W, C, dil, pre_relu, s,
                                                         hc);
          }
          const uint4 dv = pack8(s);
          *reinterpret_cast<uint4*>(dtile + k * BOX_BYTES + swz(row, v)) = dv;
          const long off = pp[q] * C + c;
          if (dout != nullptr && cv) *reinterpret_cast<uint4*>(dout + off) = dv;
          if (SKIP && !STAGED && cv) *reinterpret_cast<uint4*>(rout + off) = pack8(hc);
        }
        fence_async_smem();
        consumer_sync(GEMM_CONSUMERS);
      }
      const int s = ring.wait(it);
      acc_fence(acc);
      wgmma_fence();
      wgmma_box<false, true>(acc, dtile + k * BOX_BYTES, ring_mem + (s * 2 + wg) * BOX_BYTES,
                             k > 0);
      wgmma_commit();
      if (k > 0) {
        wgmma_wait<1>();
        acc_fence(acc);
        ring.release(it - 1);
      }
    }
    wgmma_wait<0>();
    acc_fence(acc);
    ring.release(it - 1);

    // ---- epilogue: y, and the statistics partials of the bf16-rounded y ----
    const int fb = t * FWD_BN + wg * BOX;
    bool rv[2];
    long rp[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) rv[h] = tile.pixel(acc_row(h), rp[h]);
    if (STAGED) {
      // through this warpgroup's y tile: 16-byte stores of whole rows, and
      // each column's sums over the 64 rows in order (missing pixels are 0)
      bf16* yt = reinterpret_cast<bf16*>(halo) + wg * BOX * YT_LD;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<__nv_bfloat162*>(yt + acc_row(h) * YT_LD + acc_col(i)) =
              __floats2bfloat162_rn(rv[h] ? acc[4 * i + 2 * h] : 0.0f,
                                    rv[h] ? acc[4 * i + 2 * h + 1] : 0.0f);
      warpgroup_sync(wg);
      const int j = tid & 127;
#pragma unroll
      for (int u = j; u < BOX * 8; u += 128) {
        const int row = u >> 3, col = fb + (u & 7) * 8;
        long p;
        if (tile.pixel(row, p) && col < F)
          *reinterpret_cast<uint4*>(y + p * F + col) =
              *reinterpret_cast<const uint4*>(yt + row * YT_LD + (u & 7) * 8);
      }
      if (spart != nullptr && fb + (j & (BOX - 1)) < F) {
        // rows r, r+8, ... into part[r % 8], then the 8 parts in order
        const int col = j & (BOX - 1);
        float part[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) part[e] = 0.0f;
#pragma unroll
        for (int row = 0; row < BOX; ++row) {
          const float v = __bfloat162float(yt[row * YT_LD + col]);
          part[row % 8] += j < BOX ? v : v * v;
        }
        const float sum = ((part[0] + part[1]) + (part[2] + part[3])) +
                          ((part[4] + part[5]) + (part[6] + part[7]));
        spart[((long)blockIdx.x * 2 + j / BOX) * F + fb + col] = sum;
      }
      warpgroup_sync(wg);
      continue;
    }
    // unstaged: y from the registers; the sums of each warp's 16 rows by
    // shuffles in a fixed order, one partial per warp
    const int wq = (tid >> 5) & 3;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int col = fb + acc_col(i);
      const bool colv = col < F;
      float2 vr[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 pair =
            __floats2bfloat162_rn(acc[4 * i + 2 * h], acc[4 * i + 2 * h + 1]);
        if (rv[h] && colv) *reinterpret_cast<__nv_bfloat162*>(y + rp[h] * F + col) = pair;
        vr[h] = rv[h] ? __bfloat1622float2(pair) : make_float2(0.0f, 0.0f);
      }
      if (spart != nullptr) {
        float s1a = vr[0].x + vr[1].x, s1b = vr[0].y + vr[1].y;
        float s2a = vr[0].x * vr[0].x + vr[1].x * vr[1].x;
        float s2b = vr[0].y * vr[0].y + vr[1].y * vr[1].y;
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          s1a += __shfl_xor_sync(0xffffffffu, s1a, m);
          s1b += __shfl_xor_sync(0xffffffffu, s1b, m);
          s2a += __shfl_xor_sync(0xffffffffu, s2a, m);
          s2b += __shfl_xor_sync(0xffffffffu, s2b, m);
        }
        if ((tid & 31) < 4 && colv) {
          float* o = spart + ((long)blockIdx.x * 4 + wq) * 2 * F + col;
          *reinterpret_cast<float2*>(o) = make_float2(s1a, s1b);
          *reinterpret_cast<float2*>(o + F) = make_float2(s2a, s2b);
        }
      }
    }
  }
}

using FwdKernel = decltype(&sepconv_fwd_kernel<false, false, UNSTAGED>);

// The kernel for a form (0 base, 1 affine, 2 boundary) and mode.
inline FwdKernel fwd_kernel(int form, int mode) {
  static const FwdKernel k[12] = {
      sepconv_fwd_kernel<false, false, UNSTAGED>,    sepconv_fwd_kernel<true, false, UNSTAGED>,
      sepconv_fwd_kernel<true, true, UNSTAGED>,      sepconv_fwd_kernel<false, false, STAGED_1>,
      sepconv_fwd_kernel<true, false, STAGED_1>,     sepconv_fwd_kernel<true, true, STAGED_1>,
      sepconv_fwd_kernel<false, false, STAGED_2>,    sepconv_fwd_kernel<true, false, STAGED_2>,
      sepconv_fwd_kernel<true, true, STAGED_2>,      sepconv_fwd_kernel<false, false, PRELOADED_2>,
      sepconv_fwd_kernel<true, false, PRELOADED_2>,  sepconv_fwd_kernel<true, true, PRELOADED_2>};
  return k[form + 3 * mode];
}

}  // namespace dsc

// Launches on `stream`; returns the first non-zero CUDA error, else 0.  a,
// b, skip, d, r and the statistics are optional (null): skip needs a and b;
// with `stats` (2,F fp32) the caller gives `spart` (S x 2 x F fp32, S the
// partials: one per tile when staged, else 4) and `sscratch` (ceil(S / 256)
// x 2 x F fp32, or null when S <= 256).  `tiles`, `mode` (FwdMode) and
// `stages` are fwd_plan's; a preloaded ring holds every box of pw.
extern "C" int sepconv_fwd(const void* x, const void* dwk, const void* pwk, const void* a,
                           const void* b, const void* skip, void* y, void* d, void* r,
                           void* spart, void* sscratch, void* stats, int N, int H, int W,
                           int C, int F, int dil, int pre_relu, int tiles, int mode,
                           int stages, void* stream) {
  using namespace dsc;
  cudaStream_t st = (cudaStream_t)stream;
  const int boxes = (C + BOX - 1) / BOX * ((F + FWD_BN - 1) / FWD_BN);
  if (tiles < 1 || mode < UNSTAGED || mode > PRELOADED_2 ||
      (mode == PRELOADED_2 ? stages < boxes : stages < 2))
    return (int)cudaErrorInvalidValue;  // a ring of two stages, or of all the boxes
  CUtensorMap pw_map;
  int err = make_box_map(&pw_map, pwk, C, F, F);
  if (err) return err;
  const FwdKernel kernel = fwd_kernel(a == nullptr ? 0 : skip == nullptr ? 1 : 2, mode);
  const bool staged = mode != UNSTAGED;
  const int smem = fwd_smem_bytes(C, dil, staged, stages);
  if ((err = allow_smem((const void*)kernel))) return err;
  kernel<<<(unsigned)tiles, mode == PRELOADED_2 ? GEMM_CONSUMERS : GEMM_THREADS, smem, st>>>(
      pw_map, (const bf16*)x, (const bf16*)dwk, (const bf16*)a, (const bf16*)b,
      (const bf16*)skip, (bf16*)y, (bf16*)d, (bf16*)r, stats ? (float*)spart : nullptr, N, H,
      W, C, F, dil, pre_relu, stages);
  if ((err = (int)cudaGetLastError()) || stats == nullptr) return err;
  return reduce_partials((const float*)spart, (float*)stats, (float*)sscratch,
                         (staged ? 1 : 4) * tiles, 2L * F, st);
}

// Host microseconds per tensor map encoded (make_box_map over a 4096 x 1024
// bf16 matrix at `ptr`, averaged over `reps`), or -1 on failure: the host
// cost the kernels' maps add to each call (one per forward, four per
// backward).
extern "C" double box_map_encode_us(const void* ptr, int reps) {
  CUtensorMap map;
  if (dsc::make_box_map(&map, ptr, 4096, 1024, 1024)) return -1.0;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i)
    if (dsc::make_box_map(&map, ptr, 4096, 1024, 1024)) return -1.0;
  const std::chrono::duration<double, std::micro> dt = std::chrono::steady_clock::now() - t0;
  return dt.count() / reps;
}
