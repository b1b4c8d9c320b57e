// Shared machinery of the fused-sepconv kernels on Hopper (sm_90a):
//
// * the GEMM pieces: 64x64 bf16 operand boxes in shared memory in the
//   128-byte-swizzled layout that both TMA (CU_TENSOR_MAP_SWIZZLE_128B) and
//   wgmma's B128 descriptors use, a ring of such boxes fed by TMA and guarded
//   by mbarriers (full: the bytes arrived; empty: the consumers are done),
//   and `wgmma` m64n64k16 with fp32 accumulators in registers.  A GEMM block
//   has two consumer warpgroups (threads 0-255), each owning one 64-wide
//   half of the block's 128 output columns, and one producer warp (threads
//   256-287) whose lane 0 issues the TMA loads.
// * the epilogue's view of the accumulators: thread t of a warpgroup holds
//   rows 16*(t/32) + (t%32)/4 (+8) and columns 8i + 2*(t%4) (+1), i < 8.
// * the deterministic partial-sum reduction, and the bf16 rounding of the
//   folded BN apply and the residual add, as PyTorch rounds them.
//
// A box is 64 rows of 128 bytes (64 bf16), 8 KB, 1024-byte aligned.  The 16-
// byte unit u of row r sits at unit u ^ (r % 8) of that row (the swizzle).
// Row-major [rows][64] tiles are K-major operands when the 64 columns are
// the K axis and MN-major ("transposed") operands when the rows are; wgmma
// reads both for 16-bit types, so no operand is ever transposed in memory.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dsc {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;          // elementwise and reduction kernels
constexpr int GEMM_CONSUMERS = 256;   // two warpgroups
constexpr int GEMM_THREADS = GEMM_CONSUMERS + 32;  // + the producer warp
constexpr int BOX = 64;               // rows and bf16 columns of a box
constexpr int BOX_BYTES = BOX * BOX * 2;
constexpr int SMEM_ALIGN = 1024;      // swizzle atom: 8 rows of 128 bytes

// ---- 16-byte vectors of 8 bf16 ----
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

// ---- shared-memory addresses, fences, mbarriers, TMA ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of the 16-byte unit u of row r inside a box.
__device__ __forceinline__ int swz(int r, int u) { return r * 128 + ((u ^ (r & 7)) << 4); }

// Generic-proxy writes to shared memory made visible to wgmma / TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier among the first `n` threads (the consumers), id 1.
__device__ __forceinline__ void consumer_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// Barrier among the 128 threads of consumer warpgroup `wg` (ids 2 and 3).
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase differs from `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// One box of a 2-D tensor map at element coordinates (inner, outer) into
// shared memory, completing `bytes` on `bar`.  Out-of-range elements are
// written as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner), "r"(outer)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---- wgmma ----
// Descriptor of a swizzled (B128) operand starting at `p`: `sbo` bytes
// between groups of 8 rows; the leading offset is unused (one box wide).
__device__ __forceinline__ uint64_t desc_b128(const void* p, uint32_t sbo = 1024) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(sbo >> 4) << 32) |
         (uint64_t(1) << 62);
}

// K step k (16 deep) of a box: K-major boxes advance 32 bytes along the row,
// MN-major boxes 16 rows.
template <bool MN_MAJOR>
__device__ __forceinline__ const unsigned char* kstep(const unsigned char* box, int k) {
  return box + (MN_MAJOR ? k * 16 * 128 : k * 32);
}

using Acc = float[32];

__device__ __forceinline__ void acc_fence(Acc& d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// d[64 x 64] = A[64 x 16] . B[16 x 64] (+ d when `accumulate`), bf16
// operands from shared memory; TA / TB: the operand is MN-major (its 16-deep
// K slice runs down the rows).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_64x64x16(Acc& d, uint64_t da, uint64_t db,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %36, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %34, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "n"(TA), "n"(TB), "r"(accumulate));
}

// The four K steps of one box pair into d (a box is 64 deep; the operands
// are zero past the end of K); `accumulate` 0 overwrites d (the first box of
// a tile: the accumulators need no zeroing).
template <bool A_MN, bool B_MN>
__device__ __forceinline__ void wgmma_box(Acc& d, const unsigned char* a, const unsigned char* b,
                                          int accumulate) {
#pragma unroll
  for (int k = 0; k < BOX / 16; ++k)
    wgmma_64x64x16<A_MN, B_MN>(d, desc_b128(kstep<A_MN>(a, k)), desc_b128(kstep<B_MN>(b, k)),
                               k > 0 || accumulate);
}

// Row and column of accumulator element 4i + 2h + j of this thread, within
// its warpgroup's 64 x 64 tile.
__device__ __forceinline__ int acc_row(int h) {
  const int t = threadIdx.x & 127;
  return (t >> 5) * 16 + ((t & 31) >> 2) + 8 * h;
}
__device__ __forceinline__ int acc_col(int i) { return 8 * i + 2 * (threadIdx.x & 3); }

// ---- the ring of TMA-fed stages ----
// Stage s holds `bytes` of boxes; full[s] completes when they arrived,
// empty[s] when the 8 consumer warps are done with them.  Iteration i uses
// stage i % S in round i / S.
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  int stages;
  __device__ __forceinline__ void init() {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], GEMM_CONSUMERS / 32);
    }
    fence_barrier_init();
  }
  // producer: wait for the slot, announce the bytes
  __device__ __forceinline__ int acquire(int i, uint32_t bytes) {
    const int s = i % stages;
    mbar_wait(&empty[s], ((i / stages) & 1) ^ 1);
    mbar_expect_tx(&full[s], bytes);
    return s;
  }
  // consumers: wait for the bytes
  __device__ __forceinline__ int wait(int i) {
    const int s = i % stages;
    mbar_wait(&full[s], (i / stages) & 1);
    return s;
  }
  // consumers: lane 0 of each warp hands the slot back
  __device__ __forceinline__ void release(int i) {
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[i % stages]);
  }
};

// ---- host: 2-D bf16 tensor maps ----
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Map of a row-major bf16 matrix [rows][cols] (row stride `ld` elements),
// read in 64 x 64 swizzled boxes.  Returns 0, or a CUDA error number.
inline int make_box_map(CUtensorMap* map, const void* ptr, long rows, long cols, long ld) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {BOX, BOX};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use

// Lets `kernel` use all the dynamic shared memory that its static shared
// memory leaves of SMEM_MAX on the current device.  The attribute is set
// once per kernel and device: setting it costs tens of microseconds of host
// time, on every call otherwise.
inline int allow_smem(const void* kernel) {
  static const void* done_kernel[64];
  static int done_device[64];
  static int ndone = 0;
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  for (int i = 0; i < ndone; ++i)
    if (done_kernel[i] == kernel && done_device[i] == dev) return 0;
  cudaFuncAttributes attr;
  if ((err = (int)cudaFuncGetAttributes(&attr, kernel))) return err;
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SMEM_MAX - (int)attr.sharedSizeBytes);
  if (!err && ndone < 64) {
    done_kernel[ndone] = kernel;
    done_device[ndone++] = dev;
  }
  return err;
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
