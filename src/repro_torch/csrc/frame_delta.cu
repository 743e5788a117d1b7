// Per-tile frame-delta encoder (paper §3.3, "Transmitting images").
//
// Replaces the TPU kernel `frame_delta_tiles` (body `_delta_kernel`) in
// src/repro/kernels/frame_delta/frame_delta.py.
//
// cur/prev [H, W, C] float32 cut into (tile_h, tile_w, C) tiles, the
// frame read as zero-padded up to whole tiles (as the wrapper's padding
// did on the TPU):
//   d        = cur - prev
//   changed  = mean over the whole tile of |d| > tau   (int32 per tile)
//   delta_q  = int8(clip(rint(d / scale), -127, 127)), 0 where unchanged
// `rint` rounds half to even like jnp.round; d / scale is an IEEE
// division, as in the plain version.
//
// What bounds it on an H100: bytes. A 1080p frame moves ~56 MB (two f32
// frames read, one int8 frame written), ~0.017 ms at 3.35 TB/s, against
// a few operations per element. One block per tile: a first pass sums
// |d| (warp shuffles, then one shared slot per warp), a second pass
// re-reads the tile (from L2: 48 KB at the default 16 x 128 x 3) and
// writes the quantized residual. Rows of a tile are contiguous runs of
// tile_w * C floats, so the loads are coalesced. Out-of-frame elements
// of an edge tile count as zero in the mean and are never written, so
// no padded copy of the frame is made.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) frame_delta_kernel(
    const float* __restrict__ cur, const float* __restrict__ prev,
    int8_t* __restrict__ delta_q, int* __restrict__ changed, int h, int w,
    int c, int tile_h, int tile_w, float tau, float scale) {
  __shared__ float s_part[kThreads / 32];
  __shared__ int s_changed;
  const int gw = gridDim.x;
  const int y0 = blockIdx.y * tile_h;
  const int x0 = blockIdx.x * tile_w;
  const int run = tile_w * c;                  // floats per tile row
  const int n = tile_h * run;
  const int run_valid = (min(x0 + tile_w, w) - x0) * c;
  const int rows_valid = min(y0 + tile_h, h) - y0;

  float sum = 0.0f;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / run;
    const int e = i - r * run;
    if (r < rows_valid && e < run_valid) {
      const size_t off = (static_cast<size_t>(y0 + r) * w + x0) * c + e;
      sum += fabsf(cur[off] - prev[off]);
    }
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
    const int flag = total / static_cast<float>(n) > tau;
    s_changed = flag;
    changed[blockIdx.y * gw + blockIdx.x] = flag;
  }
  __syncthreads();
  const bool keep = s_changed != 0;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / run;
    const int e = i - r * run;
    if (r < rows_valid && e < run_valid) {
      const size_t off = (static_cast<size_t>(y0 + r) * w + x0) * c + e;
      int8_t qv = 0;
      if (keep) {
        const float qf = rintf((cur[off] - prev[off]) / scale);
        qv = static_cast<int8_t>(fminf(fmaxf(qf, -127.0f), 127.0f));
      }
      delta_q[off] = qv;
    }
  }
}

}  // namespace

REPRO_EXTERN int frame_delta_launch(const float* cur, const float* prev,
                                    int8_t* delta_q, int* changed, int h,
                                    int w, int c, int tile_h, int tile_w,
                                    float tau, float scale, void* stream) {
  if (tile_h < 1 || tile_w < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (h == 0 || w == 0 || c == 0) return 0;
  const int gh = (h + tile_h - 1) / tile_h;
  const int gw = (w + tile_w - 1) / tile_w;
  if (gh > 65535) return static_cast<int>(cudaErrorInvalidValue);
  frame_delta_kernel<<<dim3(gw, gh), kThreads, 0, as_stream(stream)>>>(
      cur, prev, delta_q, changed, h, w, c, tile_h, tile_w, tau, scale);
  return static_cast<int>(cudaGetLastError());
}
