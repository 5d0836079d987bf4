// Helpers shared by the port's hand-written CUDA kernels (sm_90a).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace repro_torch {

// Finite "minus infinity": a fully masked row then gives exp(0) garbage that
// the next real block's rescale exp(-1e30 - m) wipes out, where -inf would
// give NaN (same sentinel as the reference kernels).
constexpr float kNegBig = -1e30f;

// dtype codes shared with the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Elements of T in one 16-byte load.
template <typename T>
struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};

// Loads 16 bytes at `src` (16-byte aligned) and widens them to float.
__device__ __forceinline__ void load16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

// Copies `rows` rows of D elements into shared memory as float, scaled by
// `scale`, with a row stride of `ld` floats. Row r is read from
// src + row_off(r); rows for which row_off returns -1 are zero-filled.
// D * sizeof(T) must be a multiple of 16 and every row 16-byte aligned.
template <typename T, int D, typename RowOff>
__device__ __forceinline__ void load_rows(const T* __restrict__ src,
                                          float* dst, int ld, int rows,
                                          float scale, RowOff row_off) {
  constexpr int N = Vec16<T>::N;
  constexpr int VR = D / N;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < rows * VR; i += blockDim.x) {
    const int r = i / VR;
    const int c = (i - r * VR) * N;
    float tmp[N];
    const int64_t off = row_off(r);
    if (off >= 0) {
      load16(src + off + c, tmp);
    } else {
#pragma unroll
      for (int u = 0; u < N; ++u) tmp[u] = 0.f;
    }
#pragma unroll
    for (int u = 0; u < N; ++u) dst[r * ld + c + u] = tmp[u] * scale;
  }
}

// Raises the dynamic shared-memory limit of `kernel` to `bytes` the first
// time it is launched on the current device (one bit of `done` a device).
inline cudaError_t allow_smem(const void* kernel, size_t bytes,
                              std::atomic<uint64_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint64_t bit = uint64_t{1} << (dev & 63);
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

}  // namespace repro_torch
