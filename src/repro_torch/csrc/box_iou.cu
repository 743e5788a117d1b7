// Dense pairwise IoU of cxcywh boxes, the matrix under NMS and matching.
//
// Replaces the TPU kernel `box_iou_matrix` (body `_iou_kernel`) in
// src/repro/kernels/box_iou/box_iou.py.
//
// a [N, 4], b [M, 4] cxcywh -> iou [N, M] float32,
//   iou = inter / max(area_a + area_b - inter, 1e-9)
// with corners cx -/+ w * 0.5, cy -/+ h * 0.5, each op rounded as the
// plain version rounds it (the library is built with -fmad=false).
//
// What bounds it on an H100: the bytes written. At N = M = 9216 (one
// step's detections of 16 cameras, 18 crops, 32 boxes each) the output
// is 340 MB, ~0.10 ms at 3.35 TB/s. But each pair also costs ~20
// instructions (IEEE division included), ~0.05-0.10 ms of issue over
// 132 SMs, so the design cuts the instructions per pair as much as it
// streams the stores:
// - a thread owns 4 consecutive columns of B, their corners and areas in
//   registers, and walks rows of A: a row's corners come from shared
//   memory as one broadcast float4 plus its area, and its 4 results
//   leave as one 16-byte streaming store (st.global.cs: the output is
//   ~7x the 50 MB L2, so evict-first);
// - blocks of 1024 columns walk slabs of 16 rows in a grid-stride loop,
//   four waves of as many blocks as fit the card at once: B's corners
//   are computed once per block, the barriers run once per slab, and
//   the last wave's tail stays short (one wave of blocks walking many
//   slabs each, or one block per slab, are slower:
//   tools/box_iou_schedules.py times the schedules side by side);
// - where inter == 0 the division is skipped: union >= 1e-9, so
//   inter / union is inter itself (+0 or -0, as the plain version's
//   division gives it) for finite boxes.
// A row starts 16 bytes aligned only when M % 4 == 0; other widths take
// the instance with four scalar streaming stores per row, nothing read
// or written past M. The TPU's padding of N and M to 128-row blocks
// becomes a bounds check.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                     // columns of B per thread
constexpr int kCols = kPer * kThreads;      // columns per block
constexpr int kRows = 16;                   // rows of A per slab
constexpr int kWaves = 4;                   // waves of resident blocks

__device__ __forceinline__ float4 corners(const float* box) {
  return make_float4(box[0] - box[2] * 0.5f, box[1] - box[3] * 0.5f,
                     box[0] + box[2] * 0.5f, box[1] + box[3] * 0.5f);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) box_iou_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, int n, int m, int n_slabs) {
  __shared__ float4 s_box[kRows];   // x0, y0, x1, y1
  __shared__ float s_area[kRows];
  const int c0 = blockIdx.x * kCols + kPer * threadIdx.x;
  float4 bc[kPer];
  float area_b[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    bc[j] = c0 + j < m ? corners(b + static_cast<size_t>(c0 + j) * 4)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    area_b[j] = (bc[j].z - bc[j].x) * (bc[j].w - bc[j].y);
  }
  for (int slab = blockIdx.y; slab < n_slabs; slab += gridDim.y) {
    const int r0 = slab * kRows;
    __syncthreads();   // every thread is done with the last slab's rows
    if (threadIdx.x < kRows && r0 + threadIdx.x < n) {
      const float4 c = corners(a + static_cast<size_t>(r0 + threadIdx.x) * 4);
      s_box[threadIdx.x] = c;
      s_area[threadIdx.x] = (c.z - c.x) * (c.w - c.y);
    }
    __syncthreads();
    if (c0 >= m) continue;
    const int rows = min(kRows, n - r0);
    for (int r = 0; r < rows; ++r) {
      const float4 ac = s_box[r];
      const float area_a = s_area[r];
      float v[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const float iw =
            fmaxf(fminf(ac.z, bc[j].z) - fmaxf(ac.x, bc[j].x), 0.0f);
        const float ih =
            fmaxf(fminf(ac.w, bc[j].w) - fmaxf(ac.y, bc[j].y), 0.0f);
        const float inter = iw * ih;
        v[j] = inter;
        if (inter != 0.0f) {
          v[j] = inter / fmaxf(area_a + area_b[j] - inter, 1e-9f);
        }
      }
      float* row = out + static_cast<size_t>(r0 + r) * m + c0;
      if constexpr (kVec) {
        __stcs(reinterpret_cast<float4*>(row),
               make_float4(v[0], v[1], v[2], v[3]));
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          if (c0 + j < m) __stcs(row + j, v[j]);
        }
      }
    }
  }
}

template <bool kVec>
cudaError_t launch(const float* a, const float* b, float* out, int n, int m,
                   cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, box_iou_kernel<kVec>, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  const int col_blocks = (m + kCols - 1) / kCols;
  const int n_slabs = (n + kRows - 1) / kRows;
  // four waves of the row blocks that fit the card beside the column
  // blocks
  const int fit = max(1, kWaves * sms * max(per_sm, 1) / col_blocks);
  const dim3 grid(col_blocks, min(min(n_slabs, fit), 65535));
  box_iou_kernel<kVec><<<grid, kThreads, 0, stream>>>(a, b, out, n, m,
                                                     n_slabs);
  return cudaGetLastError();
}

}  // namespace

REPRO_EXTERN int box_iou_launch(const float* a, const float* b, float* out,
                                int n, int m, void* stream) {
  if (n == 0 || m == 0) return 0;
  if (m > 0x7fffffff - kCols) return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte row stores need every row start aligned: M % 4 == 0 and an
  // aligned base
  const bool vec = m % kPer == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const cudaError_t err = vec ? launch<true>(a, b, out, n, m,
                                             as_stream(stream))
                              : launch<false>(a, b, out, n, m,
                                              as_stream(stream));
  return static_cast<int>(err);
}
