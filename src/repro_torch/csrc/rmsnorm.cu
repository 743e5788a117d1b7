// Fused RMSNorm over rows.
//
// Replaces the TPU kernel `rmsnorm_rows` (body `_rmsnorm_kernel`) in
// src/repro/kernels/rmsnorm/rmsnorm.py.
//
// x [T, D] float32 or bfloat16, weight [D] float32 -> [T, D] in x's type:
//   out = x * (1 / sqrt(mean(x^2) + eps)) * weight     (float32 math)
// The inverse root is 1.0f / sqrtf(.), both correctly rounded (rsqrtf is
// approximate).
//
// What bounds it on an H100: bytes. At stablelm-3b's width (x [8, 4096,
// 2560] f32) one call reads and writes 671 MB, ~0.20 ms at 3.35 TB/s,
// against 4 operations per element. One block of 256 threads per row: a
// pass over the row sums x^2 (warp shuffles, then one shared slot per
// warp), a second pass re-reads the row (10 KB at D = 2560, from L1/L2)
// and writes the scaled values, so x crosses device memory once each way.
// The TPU version sized its row blocks to VMEM; here a row is one block
// and any D fits.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) rmsnorm_kernel(
    const T* __restrict__ x, const float* __restrict__ weight,
    T* __restrict__ out, int d, float eps) {
  __shared__ float s_part[kThreads / 32];
  __shared__ float s_inv;
  const T* row = x + static_cast<size_t>(blockIdx.x) * d;
  T* orow = out + static_cast<size_t>(blockIdx.x) * d;
  float sum = 0.0f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float xi = to_f32(row[i]);
    sum += xi * xi;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  }
  if (threadIdx.x % 32 == 0) s_part[threadIdx.x / 32] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.0f;
    for (int i = 0; i < kThreads / 32; ++i) total += s_part[i];
    s_inv = 1.0f / sqrtf(total / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float inv = s_inv;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    store(orow + i, to_f32(row[i]) * inv * weight[i]);
  }
}

}  // namespace

REPRO_EXTERN int rmsnorm_launch(const void* x, const float* weight,
                                void* out, int rows, int d, float eps,
                                int is_bf16, void* stream) {
  if (rows == 0 || d == 0) return 0;
  if (is_bf16) {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, as_stream(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), weight,
        static_cast<__nv_bfloat16*>(out), d, eps);
  } else {
    rmsnorm_kernel<float><<<rows, kThreads, 0, as_stream(stream)>>>(
        static_cast<const float*>(x), weight, static_cast<float*>(out), d,
        eps);
  }
  return static_cast<int>(cudaGetLastError());
}
