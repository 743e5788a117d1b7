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
// is 340 MB against ~20 operations per pair, ~0.10 ms at 3.35 TB/s. So
// the design is a store stream: a block owns 16 rows of A (their corners
// and areas in shared memory) and 256 columns of B (one per thread, in
// registers); each thread writes its column of the 16 rows, so every
// row store of a warp is 128 contiguous bytes. The TPU's padding of N
// and M to 128-row blocks becomes a bounds check.
#include "common.cuh"

namespace {

constexpr int kRows = 16;       // rows of A per block
constexpr int kCols = 256;      // columns of B per block (one per thread)

__global__ void __launch_bounds__(kCols) box_iou_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    float* __restrict__ out, int n, int m) {
  __shared__ float s_a[kRows][5];   // x0, y0, x1, y1, area
  const int r0 = blockIdx.y * kRows;
  const int col = blockIdx.x * kCols + threadIdx.x;
  if (threadIdx.x < kRows && r0 + threadIdx.x < n) {
    const float* box = a + static_cast<size_t>(r0 + threadIdx.x) * 4;
    const float x0 = box[0] - box[2] * 0.5f;
    const float y0 = box[1] - box[3] * 0.5f;
    const float x1 = box[0] + box[2] * 0.5f;
    const float y1 = box[1] + box[3] * 0.5f;
    s_a[threadIdx.x][0] = x0;
    s_a[threadIdx.x][1] = y0;
    s_a[threadIdx.x][2] = x1;
    s_a[threadIdx.x][3] = y1;
    s_a[threadIdx.x][4] = (x1 - x0) * (y1 - y0);
  }
  __syncthreads();
  if (col >= m) return;
  const float* box = b + static_cast<size_t>(col) * 4;
  const float bx0 = box[0] - box[2] * 0.5f;
  const float by0 = box[1] - box[3] * 0.5f;
  const float bx1 = box[0] + box[2] * 0.5f;
  const float by1 = box[1] + box[3] * 0.5f;
  const float area_b = (bx1 - bx0) * (by1 - by0);
  const int rows = min(kRows, n - r0);
  for (int r = 0; r < rows; ++r) {
    const float iw = fmaxf(fminf(s_a[r][2], bx1) - fmaxf(s_a[r][0], bx0),
                           0.0f);
    const float ih = fmaxf(fminf(s_a[r][3], by1) - fmaxf(s_a[r][1], by0),
                           0.0f);
    const float inter = iw * ih;
    const float uni = s_a[r][4] + area_b - inter;
    out[static_cast<size_t>(r0 + r) * m + col] = inter / fmaxf(uni, 1e-9f);
  }
}

}  // namespace

REPRO_EXTERN int box_iou_launch(const float* a, const float* b, float* out,
                                int n, int m, void* stream) {
  if (n == 0 || m == 0) return 0;
  const int row_blocks = (n + kRows - 1) / kRows;
  if (row_blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((m + kCols - 1) / kCols, row_blocks);
  box_iou_kernel<<<grid, kCols, 0, as_stream(stream)>>>(a, b, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
