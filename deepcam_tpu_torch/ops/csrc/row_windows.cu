// Overlapping row windows of an NHWC tensor:
//
//   out[n, t, r, w, c] = x[n, t * TH + r, w, c]      t < T, r < WIN
//
// Replaces the module-level TPU kernel of
// analysis/archive/probe_element_window.py (a pallas_call whose input
// BlockSpec takes pl.Element row windows of TH + 2D rows at row offsets
// t * TH, the halo'd row tiles a depthwise conv reads), at any shape: there
// (2, 18, 72, 728) fp32, TH 4, D 1, so T 4 and WIN 6.
//
// What bounds it on an H100 SXM: it is a copy.  It reads each input row at
// most twice (windows overlap by 2D rows) and writes the output once, so
// the least time is the bytes moved over 3.35 TB/s.  The design: each
// window row is one contiguous run of W * C floats in both tensors; a block
// copies 16-byte vectors of one output row (blockIdx.y), consecutive threads
// on consecutive vectors, so loads and stores are coalesced and no index is
// recomputed per element beyond one division per row.
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256)
row_windows_kernel(const float4* __restrict__ x, float4* __restrict__ out, int rows_in,
                   long row_vecs, int th, int win, int nwin) {
  const int orow = blockIdx.y;  // (n, t, r) flattened
  const int r = orow % win;
  const int t = (orow / win) % nwin;
  const int n = orow / (win * nwin);
  const float4* src = x + ((long)n * rows_in + (long)t * th + r) * row_vecs;
  float4* dst = out + (long)orow * row_vecs;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < row_vecs;
       i += (long)gridDim.x * blockDim.x)
    dst[i] = src[i];
}

// x: (N, rows_in, W, C) fp32 with W * C a multiple of 4; out: (N, nwin,
// win, W, C) fp32.  Launches on `stream`; returns cudaGetLastError().
extern "C" int row_windows(const void* x, void* out, int N, int rows_in, int W, int C, int th,
                           int win, int nwin, void* stream) {
  const long row_vecs = (long)W * C / 4;
  const unsigned gx = (unsigned)((row_vecs + 255) / 256 < 64 ? (row_vecs + 255) / 256 : 64);
  row_windows_kernel<<<dim3(gx, (unsigned)(N * nwin * win)), 256, 0, (cudaStream_t)stream>>>(
      (const float4*)x, (float4*)out, rows_in, row_vecs, th, win, nwin);
  return (int)cudaGetLastError();
}
