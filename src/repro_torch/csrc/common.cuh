// Shared by the port's CUDA kernels: each source exposes a plain C
// entry point `<name>_launch(..., void* stream)` that enqueues its kernel
// on the caller's stream (PyTorch's current stream) and returns
// cudaGetLastError() as an int, so the Python wrapper (loaded through
// ctypes) can raise on a refused launch.
#pragma once

#include <cuda_runtime.h>

#define REPRO_EXTERN extern "C" __attribute__((visibility("default")))

static inline cudaStream_t as_stream(void* stream) {
  return static_cast<cudaStream_t>(stream);
}
