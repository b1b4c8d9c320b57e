// Native host-side data-pipeline routines of the PyTorch port (a copy of
// deepcam_tpu's ops/native/preprocess.cpp; the port imports nothing of the
// JAX package).
//
// The reference's data loader leans on native code through h5py (HDF5 C) and
// torch's pinned-memory multiprocess DataLoader (cam_hdf5_dataset.py:117-131,
// train_hdf5_ddp.py:285-289).  Here the per-sample hot path — min-max
// normalization `scale * (x - shift)` over ~54 MB per (768,1152,16) sample,
// channel selection, and batch assembly — runs in C++ with OpenMP threads,
// releasing the Python GIL so reader threads overlap with the training step.
//
// Layout: channels-last (HWC), the HDF5 on-disk layout and the model's NHWC
// input; the normalization vectorizes over the contiguous channel axis.
//
// Exposed via a plain C ABI for ctypes (no pybind11 dependency).

#include <cstdint>
#include <cstring>

extern "C" {

// dst[i, c] = scale[c] * (src[i, c] - shift[c]) for i in [0, n_pixels)
// src/dst are (n_pixels, n_channels) fp32, contiguous.
void normalize_hwc_f32(float* dst, const float* src, const float* shift,
                       const float* scale, int64_t n_pixels,
                       int64_t n_channels) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_pixels; ++i) {
    const float* s = src + i * n_channels;
    float* d = dst + i * n_channels;
    for (int64_t c = 0; c < n_channels; ++c) {
      d[c] = scale[c] * (s[c] - shift[c]);
    }
  }
}

// Channel-select + normalize in one pass:
// dst[i, k] = scale[k] * (src[i, channels[k]] - shift[k])
void select_normalize_hwc_f32(float* dst, const float* src,
                              const int32_t* channels, const float* shift,
                              const float* scale, int64_t n_pixels,
                              int64_t src_channels, int64_t dst_channels) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_pixels; ++i) {
    const float* s = src + i * src_channels;
    float* d = dst + i * dst_channels;
    for (int64_t k = 0; k < dst_channels; ++k) {
      d[k] = scale[k] * (s[channels[k]] - shift[k]);
    }
  }
}

// fp32 -> bf16 with round-to-nearest-even (the same rounding numpy/XLA
// use; NaN payloads may not round-trip — climate inputs are finite).
static inline uint16_t f32_to_bf16_rne(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  x += 0x7fffu + ((x >> 16) & 1u);
  return static_cast<uint16_t>(x >> 16);
}

// normalize + cast in ONE pass: dst[i, c] = bf16(scale[c] * (src[i, c] -
// shift[c])).  Bit-identical to normalize_hwc_f32 followed by an fp32->bf16
// cast (the host-side input cast of bf16 training), but without
// materializing the fp32 intermediate — one less full pass over ~54 MB per
// sample, and the assembled batch/hbm transfer halves.
void normalize_hwc_f32_to_bf16(uint16_t* dst, const float* src,
                               const float* shift, const float* scale,
                               int64_t n_pixels, int64_t n_channels) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_pixels; ++i) {
    const float* s = src + i * n_channels;
    uint16_t* d = dst + i * n_channels;
    for (int64_t c = 0; c < n_channels; ++c) {
      d[c] = f32_to_bf16_rne(scale[c] * (s[c] - shift[c]));
    }
  }
}

// Stack n_samples contiguous samples into a batch buffer (memcpy fan-in,
// parallel over samples).  sample_bytes must be equal for all samples.
void assemble_batch(uint8_t* dst, const uint8_t** srcs, int64_t n_samples,
                    int64_t sample_bytes) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n_samples; ++i) {
    std::memcpy(dst + i * sample_bytes, srcs[i], sample_bytes);
  }
}

// int64 -> int32 label narrowing (HDF5 labels are int64 on disk; the model
// takes int32), parallel.
void narrow_labels_i64_i32(int32_t* dst, const int64_t* src, int64_t n) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    dst[i] = static_cast<int32_t>(src[i]);
  }
}

}  // extern "C"
