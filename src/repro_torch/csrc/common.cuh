// Shared by the port's CUDA kernels: each source exposes a plain C
// entry point `<name>_launch(..., void* stream)` that enqueues its kernel
// on the caller's stream (PyTorch's current stream) and returns
// cudaGetLastError() as an int, so the Python wrapper (loaded through
// ctypes) can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define REPRO_EXTERN extern "C" __attribute__((visibility("default")))

static inline cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}

// Loads and stores of float32 or bfloat16 tensors, math in float32.
namespace {
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
}  // namespace
