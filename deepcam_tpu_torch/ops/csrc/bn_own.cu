// Train-mode BatchNorm (+ReLU) over its own input: the per-channel
// statistics of x, the apply, and the backward's two passes, on the bf16
// channels_last input viewed as `rows` = N·H·W rows of C channels.
//
//   stats      (Σx, Σx²) per channel, fp32, for the glue (bn_glue.cu) with
//              div = rows, as the fused units' statistics are.
//   apply      y = relu?(bf16(bf16(x·a) + b)): each operation rounded where
//              the composed bf16 `x * a + b` rounds, so the same (a, b) give
//              the same bits.
//   grad stats g = dy·[y > 0] (dy without ReLU; `y <= 0 ? 0 : dy` as
//              PyTorch's threshold_backward), and (Σg, Σg·x) per channel in
//              fp32: the cotangents of b and a for the glue's backward,
//              which returns d(Σx) and d(Σx²).
//   dx         dx = bf16(g·a + d(Σx) + 2·x·d(Σx²)), in fp32 and rounded once.
//
// Layout: each thread owns 8 channels (one 16-byte vector of the row) for
// every row it visits: a block is `lanes` x `gthreads` threads, thread
// (lane, i) takes the channel groups i, i + gthreads, ... and the rows
// block·lanes + lane, then every gridDim·lanes-th row after it, so each
// block iteration reads `lanes` whole consecutive rows.  The grid is as many
// blocks as the card keeps resident at once (bn_own_plan), at least 16 rows
// for each lane.  Each input is read once and each output written once.
//
// The reductions: each thread sums its rows in order, the block sums its
// lanes in order in shared memory and writes one fp32 partial row per block
// ([blocks, 2, C]), and a second small kernel sums the partials in block
// order, 16 slices of them at a time and those in order: no float atomics,
// so two runs give the same bits.
//
// Replaces no TPU kernel: XLA fuses train-mode BatchNorm into its
// neighbours on the TPU, where eager PyTorch ran it as an fp32 copy of x,
// its square, two means and separate bf16 multiplies and adds, and an
// fp32 backward through broadcast, strided kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;      // threads a block aims at
constexpr int kMaxGroups = 256;    // channel groups a block spans at once
constexpr int kMinRows = 16;       // rows a lane visits at least
constexpr int kSumCols = 32;       // the partials' sum: columns a block
constexpr int kSumSlices = 16;     // and slices of the partials

__device__ __forceinline__ void unpack(const uint4& v, float f[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float f[8]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return v;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// the gradient through the ReLU, as threshold_backward(dy, y, 0)
template <bool RELU>
__device__ __forceinline__ void relu_grad(float g[8], const uint4& yv) {
  if (RELU) {
    float y[8];
    unpack(yv, y);
#pragma unroll
    for (int i = 0; i < 8; ++i) g[i] = y[i] <= 0.0f ? 0.0f : g[i];
  }
}

struct Grid {
  long r0, stride;
  int lane, gi, lanes;
};

__device__ __forceinline__ Grid grid_of(int gthreads) {
  Grid p;
  p.lanes = blockDim.x / gthreads;
  p.lane = threadIdx.x / gthreads;
  p.gi = threadIdx.x % gthreads;
  p.stride = (long)gridDim.x * p.lanes;
  p.r0 = (long)blockIdx.x * p.lanes + p.lane;
  return p;
}

// The block's lanes summed in order into its partial row: sh is [lanes][2][C].
__device__ __forceinline__ void block_partial(const float* sh, float* __restrict__ partial,
                                              int lanes, int C) {
  __syncthreads();
  for (int c = threadIdx.x; c < 2 * C; c += blockDim.x) {
    float t = 0.0f;
    for (int l = 0; l < lanes; ++l) t += sh[l * 2 * C + c];
    partial[(long)blockIdx.x * 2 * C + c] = t;
  }
}

// Per channel Σx and Σx² of the block's rows.
__global__ void __launch_bounds__(kThreads)
bn_own_stats_kernel(const uint4* __restrict__ x, float* __restrict__ partial, long rows, int G,
                    int gthreads) {
  extern __shared__ float sh[];
  const Grid p = grid_of(gthreads);
  const int C = 8 * G;
  for (int g = p.gi; g < G; g += gthreads) {
    float s[8], q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = q[i] = 0.0f;
    long r = p.r0;
    for (; r + 3 * p.stride < rows; r += 4 * p.stride) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = x[(r + u * p.stride) * G + g];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float f[8];
        unpack(v[u], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i] += f[i];
          q[i] = fmaf(f[i], f[i], q[i]);
        }
      }
    }
    for (; r < rows; r += p.stride) {
      float f[8];
      unpack(x[r * G + g], f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i] += f[i];
        q[i] = fmaf(f[i], f[i], q[i]);
      }
    }
    float* out = sh + p.lane * 2 * C + 8 * g;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      out[i] = s[i];
      out[C + i] = q[i];
    }
  }
  block_partial(sh, partial, p.lanes, C);
}

// Per channel Σg and Σg·x of the block's rows, g = dy·[y > 0].
template <bool RELU>
__global__ void __launch_bounds__(kThreads)
bn_own_grad_stats_kernel(const uint4* __restrict__ dy, const uint4* __restrict__ y,
                         const uint4* __restrict__ x, float* __restrict__ partial, long rows,
                         int G, int gthreads) {
  extern __shared__ float sh[];
  const Grid p = grid_of(gthreads);
  const int C = 8 * G;
  for (int g = p.gi; g < G; g += gthreads) {
    float s[8], q[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) s[i] = q[i] = 0.0f;
    long r = p.r0;
    for (; r + p.stride < rows; r += 2 * p.stride) {
      uint4 dv[2], yv[2] = {}, xv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const long k = (r + u * p.stride) * G + g;
        dv[u] = dy[k];
        if (RELU) yv[u] = y[k];
        xv[u] = x[k];
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float gr[8], f[8];
        unpack(dv[u], gr);
        relu_grad<RELU>(gr, yv[u]);
        unpack(xv[u], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          s[i] += gr[i];
          q[i] = fmaf(gr[i], f[i], q[i]);
        }
      }
    }
    if (r < rows) {
      const long k = r * G + g;
      float gr[8], f[8];
      unpack(dy[k], gr);
      if (RELU) relu_grad<RELU>(gr, y[k]);
      unpack(x[k], f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s[i] += gr[i];
        q[i] = fmaf(gr[i], f[i], q[i]);
      }
    }
    float* out = sh + p.lane * 2 * C + 8 * g;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      out[i] = s[i];
      out[C + i] = q[i];
    }
  }
  block_partial(sh, partial, p.lanes, C);
}

// out[c] = Σ_p partial[p][c] over the `blocks` partial rows of width W:
// slice k of a column sums the rows k, k + 16, ... in order, then the 16
// slices are summed in order.
__global__ void __launch_bounds__(kSumCols * kSumSlices)
bn_own_sum_kernel(const float* __restrict__ partial, float* __restrict__ out, int blocks,
                  int W) {
  __shared__ float sh[kSumSlices][kSumCols + 1];
  const int cx = threadIdx.x % kSumCols, k = threadIdx.x / kSumCols;
  const int c = blockIdx.x * kSumCols + cx;
  float t = 0.0f;
  if (c < W) {
#pragma unroll 4
    for (int p = k; p < blocks; p += kSumSlices) t += partial[(long)p * W + c];
  }
  sh[k][cx] = t;
  __syncthreads();
  if (k == 0 && c < W) {
    float s = sh[0][cx];
#pragma unroll
    for (int j = 1; j < kSumSlices; ++j) s += sh[j][cx];
    out[c] = s;
  }
}

// y = relu?(bf16(bf16(x·a) + b)) with a, b the glue's bf16 coefficients.
template <bool RELU>
__global__ void __launch_bounds__(kThreads)
bn_own_apply_kernel(const uint4* __restrict__ x, const uint4* __restrict__ a,
                    const uint4* __restrict__ b, uint4* __restrict__ y, long rows, int G,
                    int gthreads) {
  const Grid p = grid_of(gthreads);
  for (int g = p.gi; g < G; g += gthreads) {
    float av[8], bv[8];
    unpack(a[g], av);
    unpack(b[g], bv);
    long r = p.r0;
    for (; r + 3 * p.stride < rows; r += 4 * p.stride) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = x[(r + u * p.stride) * G + g];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float f[8];
        unpack(v[u], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float t = bf16_round(__fadd_rn(bf16_round(__fmul_rn(f[i], av[i])), bv[i]));
          f[i] = RELU && t < 0.0f ? 0.0f : t;
        }
        y[(r + u * p.stride) * G + g] = pack(f);
      }
    }
    for (; r < rows; r += p.stride) {
      float f[8];
      unpack(x[r * G + g], f);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float t = bf16_round(__fadd_rn(bf16_round(__fmul_rn(f[i], av[i])), bv[i]));
        f[i] = RELU && t < 0.0f ? 0.0f : t;
      }
      y[r * G + g] = pack(f);
    }
  }
}

// dx = bf16(g·a + d1 + 2·x·d2), d1 = d(Σx) and d2 = d(Σx²) per channel.
template <bool RELU>
__global__ void __launch_bounds__(kThreads)
bn_own_dx_kernel(const uint4* __restrict__ dy, const uint4* __restrict__ y,
                 const uint4* __restrict__ x, const uint4* __restrict__ a,
                 const float* __restrict__ d1, const float* __restrict__ d2,
                 uint4* __restrict__ dx, long rows, int G, int gthreads) {
  const Grid p = grid_of(gthreads);
  for (int g = p.gi; g < G; g += gthreads) {
    float av[8], c1[8], c2[8];
    unpack(a[g], av);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      c1[i] = d1[8 * g + i];
      c2[i] = 2.0f * d2[8 * g + i];
    }
    long r = p.r0;
    for (; r + p.stride < rows; r += 2 * p.stride) {
      uint4 dv[2], yv[2] = {}, xv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const long k = (r + u * p.stride) * G + g;
        dv[u] = dy[k];
        if (RELU) yv[u] = y[k];
        xv[u] = x[k];
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float gr[8], f[8];
        unpack(dv[u], gr);
        relu_grad<RELU>(gr, yv[u]);
        unpack(xv[u], f);
#pragma unroll
        for (int i = 0; i < 8; ++i) f[i] = fmaf(gr[i], av[i], fmaf(f[i], c2[i], c1[i]));
        dx[(r + u * p.stride) * G + g] = pack(f);
      }
    }
    if (r < rows) {
      const long k = r * G + g;
      float gr[8], f[8];
      unpack(dy[k], gr);
      if (RELU) relu_grad<RELU>(gr, y[k]);
      unpack(x[k], f);
#pragma unroll
      for (int i = 0; i < 8; ++i) f[i] = fmaf(gr[i], av[i], fmaf(f[i], c2[i], c1[i]));
      dx[k] = pack(f);
    }
  }
}

struct Shape {
  int G, gthreads, lanes, threads;
  size_t smem;  // the reductions' [lanes][2][C] floats
};

Shape shape_of(int C) {
  Shape s;
  s.G = C / 8;
  s.gthreads = s.G < kMaxGroups ? s.G : kMaxGroups;
  s.lanes = kThreads / s.gthreads > 1 ? kThreads / s.gthreads : 1;
  s.threads = s.lanes * s.gthreads;
  s.smem = (size_t)s.lanes * 2 * C * sizeof(float);
  return s;
}

int resident(const void* kernel, const Shape& s, size_t smem, long rows, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, s.threads, smem);
  if (e != cudaSuccess) return (int)e;
  const long want = (rows + (long)s.lanes * kMinRows - 1) / ((long)s.lanes * kMinRows);
  const long most = (long)(per_sm > 0 ? per_sm : 1) * sms;
  *blocks = (int)(want < most ? (want > 0 ? want : 1) : most);
  return 0;
}

void sum_partials(const float* partial, float* out, int blocks, int C, cudaStream_t st) {
  const int W = 2 * C;
  bn_own_sum_kernel<<<(W + kSumCols - 1) / kSumCols, kSumCols * kSumSlices, 0, st>>>(
      partial, out, blocks, W);
}

}  // namespace

// The launch plan for `rows` rows of C channels (C a multiple of 8, at most
// 4096): out = {lanes, gthreads, stats blocks, apply blocks, grad stats
// blocks, dx blocks}, each grid as many blocks as the current device keeps
// resident (at least 16 rows a lane).  The reductions' scratch is
// [blocks, 2, C] fp32 then their (2, C) result.
extern "C" int bn_own_plan(long rows, int C, int relu, int* out) {
  const Shape s = shape_of(C);
  out[0] = s.lanes;
  out[1] = s.gthreads;
  int rc = resident((const void*)bn_own_stats_kernel, s, s.smem, rows, &out[2]);
  if (!rc)
    rc = resident(relu ? (const void*)bn_own_apply_kernel<true>
                       : (const void*)bn_own_apply_kernel<false>, s, 0, rows, &out[3]);
  if (!rc)
    rc = resident(relu ? (const void*)bn_own_grad_stats_kernel<true>
                       : (const void*)bn_own_grad_stats_kernel<false>, s, s.smem, rows, &out[4]);
  if (!rc)
    rc = resident(relu ? (const void*)bn_own_dx_kernel<true>
                       : (const void*)bn_own_dx_kernel<false>, s, 0, rows, &out[5]);
  return rc;
}

// x: rows x C bf16; scratch: [blocks, 2, C] fp32 partials then the (2, C)
// result (Σx, Σx²).
extern "C" int bn_own_stats(const void* x, void* scratch, long rows, int C, int blocks,
                            void* stream) {
  const Shape s = shape_of(C);
  const auto st = (cudaStream_t)stream;
  float* partial = (float*)scratch;
  bn_own_stats_kernel<<<blocks, s.threads, s.smem, st>>>((const uint4*)x, partial, rows, s.G,
                                                         s.gthreads);
  sum_partials(partial, partial + (long)blocks * 2 * C, blocks, C, st);
  return (int)cudaGetLastError();
}

// x, y: rows x C bf16; a, b: (C,) bf16.
extern "C" int bn_own_apply(const void* x, const void* a, const void* b, void* y, long rows,
                            int C, int relu, int blocks, void* stream) {
  const Shape s = shape_of(C);
  const auto st = (cudaStream_t)stream;
  if (relu)
    bn_own_apply_kernel<true><<<blocks, s.threads, 0, st>>>(
        (const uint4*)x, (const uint4*)a, (const uint4*)b, (uint4*)y, rows, s.G, s.gthreads);
  else
    bn_own_apply_kernel<false><<<blocks, s.threads, 0, st>>>(
        (const uint4*)x, (const uint4*)a, (const uint4*)b, (uint4*)y, rows, s.G, s.gthreads);
  return (int)cudaGetLastError();
}

// dy, y, x: rows x C bf16 (y unread without ReLU); scratch as bn_own_stats',
// its result (Σg, Σg·x).
extern "C" int bn_own_grad_stats(const void* dy, const void* y, const void* x, void* scratch,
                                 long rows, int C, int relu, int blocks, void* stream) {
  const Shape s = shape_of(C);
  const auto st = (cudaStream_t)stream;
  float* partial = (float*)scratch;
  if (relu)
    bn_own_grad_stats_kernel<true><<<blocks, s.threads, s.smem, st>>>(
        (const uint4*)dy, (const uint4*)y, (const uint4*)x, partial, rows, s.G, s.gthreads);
  else
    bn_own_grad_stats_kernel<false><<<blocks, s.threads, s.smem, st>>>(
        (const uint4*)dy, (const uint4*)y, (const uint4*)x, partial, rows, s.G, s.gthreads);
  sum_partials(partial, partial + (long)blocks * 2 * C, blocks, C, st);
  return (int)cudaGetLastError();
}

// dy, y, x, dx: rows x C bf16; a: (C,) bf16; d1, d2: (C,) fp32.
extern "C" int bn_own_dx(const void* dy, const void* y, const void* x, const void* a,
                         const void* d1, const void* d2, void* dx, long rows, int C, int relu,
                         int blocks, void* stream) {
  const Shape s = shape_of(C);
  const auto st = (cudaStream_t)stream;
  if (relu)
    bn_own_dx_kernel<true><<<blocks, s.threads, 0, st>>>(
        (const uint4*)dy, (const uint4*)y, (const uint4*)x, (const uint4*)a, (const float*)d1,
        (const float*)d2, (uint4*)dx, rows, s.G, s.gthreads);
  else
    bn_own_dx_kernel<false><<<blocks, s.threads, 0, st>>>(
        (const uint4*)dy, (const uint4*)y, (const uint4*)x, (const uint4*)a, (const float*)d1,
        (const float*)d2, (uint4*)dx, rows, s.G, s.gthreads);
  return (int)cudaGetLastError();
}
