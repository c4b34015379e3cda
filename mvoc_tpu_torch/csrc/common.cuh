// Shared helpers for the hand-written Hopper kernels of mvoc_tpu_torch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mvoc {

// Masked logits take a large FINITE negative, never -inf: a fully masked
// tile then gives exp(-1e30 - m) == 0 instead of exp(-inf + inf) == NaN.
constexpr float kNegBig = -1e30f;

// dtype codes shared with the Python wrappers (ops/attention.py _DTYPE_CODE)
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

// round a float through the storage type (what a cast to the input dtype does)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f<T>(from_f<T>(x));
}

// Launch with `smem` bytes of dynamic shared memory, raising the per-kernel
// opt-in limit first when more than the default 48 KB is asked for.
template <typename Kernel>
inline cudaError_t prepare_smem(Kernel kernel, size_t smem) {
  if (smem > 48 * 1024) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(smem));
  }
  return cudaSuccess;
}

}  // namespace mvoc

// Every library built from csrc/ exports this, so the Python wrappers can
// name the error a C entry point returned.
extern "C" const char* mvoc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
