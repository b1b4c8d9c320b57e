// Train-mode BatchNorm's per-channel glue, forward and backward: from one
// call's batch moments of each channel to the apply's coefficients, and
// back from their cotangents to the moments', the weight's and the bias's.
//
// Forward, per channel c (fp32, each operation rounded on its own):
//
//   mean = m1 * s, ex2 = m2 * s        s = 1/div (1 for moments already
//                                      averaged; PyTorch's division of a
//                                      tensor by a Python number on the card
//                                      is this reciprocal multiply)
//   dv   = ex2 - mean*mean, var = max(dv, 0) (NaN kept, as clamp_min)
//   running_mean = running_mean*keep + mean*mom           (when update)
//   running_var  = running_var*keep + (var*unbias)*mom
//   r    = rsqrt(var + eps), inv = r * weight
//   a    = inv, b = bias - mean*inv, both rounded to the compute type
//
// and it keeps (mean, inv, r, dv) for the backward.  The backward repeats
// what autograd computes through those operations, in autograd's order:
//
//   g_inv  = (-gb)*mean + ga,    g_weight = g_inv*r,   g_bias = gb
//   g_var  = ((g_inv*weight) * -0.5) * (r*r*r)
//   g_dv   = dv >= 0 ? g_var : 0
//   g_mean = ((-gb)*inv + (-g_dv)*mean) + (-g_dv)*mean
//   g_m1   = g_mean * s,         g_m2 = g_dv * s
//
// __fmul_rn / __fadd_rn / __fsub_rn keep nvcc from contracting a product
// and a sum into one FMA where PyTorch's separate kernels round twice;
// rsqrtf is the function PyTorch's rsqrt kernel calls.
//
// Replaces no TPU kernel: XLA fuses this arithmetic into its neighbours on
// the TPU, while PyTorch's eager dispatch ran it as 22 launches forward and
// about 20 backward, each on C <= 2048 floats.  What bounds it on an H100 is
// launch latency, not bytes (at most 2048 x 44 bytes) nor operations: the
// host's enqueue of each launch (~27 us) and the card's ~2-3 us per tiny
// kernel.  The design: one launch each way, one thread per channel, every
// output written from registers; the wrapper plans nothing and allocates
// only the outputs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float load(const float* p, int i) { return p[i]; }
__device__ __forceinline__ float load(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, int i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, int i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_glue_fwd_kernel(const float* __restrict__ m1, const float* __restrict__ m2,
                   const float* __restrict__ weight, const float* __restrict__ bias,
                   float* __restrict__ running_mean, float* __restrict__ running_var,
                   T* __restrict__ a, T* __restrict__ b, float* __restrict__ saved, int C,
                   float s, float unbias, float keep, float mom, float eps, int update) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const float mean = __fmul_rn(m1[c], s);
  const float ex2 = __fmul_rn(m2[c], s);
  const float dv = __fsub_rn(ex2, __fmul_rn(mean, mean));
  const float var = isnan(dv) ? dv : fmaxf(dv, 0.0f);
  if (update) {
    running_mean[c] = __fadd_rn(__fmul_rn(running_mean[c], keep), __fmul_rn(mean, mom));
    running_var[c] =
        __fadd_rn(__fmul_rn(running_var[c], keep), __fmul_rn(__fmul_rn(var, unbias), mom));
  }
  const float r = rsqrtf(__fadd_rn(var, eps));
  const float inv = __fmul_rn(r, weight[c]);
  store(a, c, inv);
  store(b, c, __fsub_rn(bias[c], __fmul_rn(mean, inv)));
  saved[c] = mean;
  saved[C + c] = inv;
  saved[2 * C + c] = r;
  saved[3 * C + c] = dv;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
bn_glue_bwd_kernel(const T* __restrict__ ga, const T* __restrict__ gb,
                   const float* __restrict__ saved, const float* __restrict__ weight,
                   float* __restrict__ out, int C, float s) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const float mean = saved[c], inv = saved[C + c], r = saved[2 * C + c];
  const float dv = saved[3 * C + c];
  const float gbias = load(gb, c);
  const float gmi = -gbias;
  const float ginv = __fadd_rn(__fmul_rn(gmi, mean), load(ga, c));
  const float gvar = __fmul_rn(__fmul_rn(__fmul_rn(ginv, weight[c]), -0.5f),
                               __fmul_rn(__fmul_rn(r, r), r));
  const float gdv = dv >= 0.0f ? gvar : 0.0f;
  const float gmm = __fmul_rn(-gdv, mean);
  const float gmean = __fadd_rn(__fadd_rn(__fmul_rn(gmi, inv), gmm), gmm);
  out[c] = __fmul_rn(ginv, r);
  out[C + c] = gbias;
  out[2 * C + c] = __fmul_rn(gmean, s);
  out[3 * C + c] = __fmul_rn(gdv, s);
}

unsigned blocks(int C) { return (unsigned)((C + kThreads - 1) / kThreads); }

}  // namespace

// m1, m2, weight, bias, running_mean, running_var, (C,) fp32; a, b: (C,) in
// the compute type (bf16 if out_bf16, else fp32); saved: (4, C) fp32 (mean,
// inv, r, dv).  `div` is the count the moments are sums over (1 for
// means), `unbias` the running variance's n/(n-1).  Launches on `stream`;
// returns cudaGetLastError().
extern "C" int bn_glue_fwd(const void* m1, const void* m2, const void* weight,
                           const void* bias, void* running_mean, void* running_var, void* a,
                           void* b, void* saved, int C, long div, float unbias, float keep,
                           float mom, float eps, int update, int out_bf16, void* stream) {
  const float s = 1.0f / (float)div;
  const auto st = (cudaStream_t)stream;
  if (out_bf16)
    bn_glue_fwd_kernel<__nv_bfloat16><<<blocks(C), kThreads, 0, st>>>(
        (const float*)m1, (const float*)m2, (const float*)weight, (const float*)bias,
        (float*)running_mean, (float*)running_var, (__nv_bfloat16*)a, (__nv_bfloat16*)b,
        (float*)saved, C, s, unbias, keep, mom, eps, update);
  else
    bn_glue_fwd_kernel<float><<<blocks(C), kThreads, 0, st>>>(
        (const float*)m1, (const float*)m2, (const float*)weight, (const float*)bias,
        (float*)running_mean, (float*)running_var, (float*)a, (float*)b, (float*)saved, C, s,
        unbias, keep, mom, eps, update);
  return (int)cudaGetLastError();
}

// ga, gb: (C,) in the compute type; saved as the forward wrote it; out:
// (4, C) fp32 (d weight, d bias, d m1, d m2).
extern "C" int bn_glue_bwd(const void* ga, const void* gb, const void* saved,
                           const void* weight, void* out, int C, long div, int in_bf16,
                           void* stream) {
  const float s = 1.0f / (float)div;
  const auto st = (cudaStream_t)stream;
  if (in_bf16)
    bn_glue_bwd_kernel<__nv_bfloat16><<<blocks(C), kThreads, 0, st>>>(
        (const __nv_bfloat16*)ga, (const __nv_bfloat16*)gb, (const float*)saved,
        (const float*)weight, (float*)out, C, s);
  else
    bn_glue_bwd_kernel<float><<<blocks(C), kThreads, 0, st>>>(
        (const float*)ga, (const float*)gb, (const float*)saved, (const float*)weight,
        (float*)out, C, s);
  return (int)cudaGetLastError();
}
