// Candidate-neighbor scoring for the fleet shape search (paper §3.3).
//
// Replaces the TPU kernel `neighbor_score_batch` (body `_score_kernel`)
// in src/repro/kernels/neighbor_score/neighbor_score.py.
//
// For camera b and grid cell c:
//   score[b, c] = sum_o w * d_center[c, o] / max(|cell_c - centroid_o|,
//                 1e-6) / sum_o w,   w = overlap[c, o] * member_has[b, o]
// and 1.0 where sum_o w == 0.
//
// What bounds it on an H100: launch latency. At B = 64 cameras and N =
// 25 cells one call reads ~13 KB and does ~0.4 MFLOP — nanoseconds of
// bandwidth or arithmetic against a launch of a few microseconds. One
// block per camera, one thread per cell, the camera's [N] strips staged
// in shared memory and the static [N, N] geometry read from L2. The
// formula is neighbor_score.cuh's, which the fused shape_search kernel
// (shape_search.cu) evaluates inline: the controller step no longer
// launches this kernel, which stays as the kernel API (and the plain
// shape search's scorer on the card), up to 512 cells like the fused
// kernels.
#include "common.cuh"
#include "neighbor_score.cuh"

namespace {

constexpr int kMaxCells = 512;   // as the fused search kernels' cell sets

__global__ void neighbor_score_kernel(
    const float* __restrict__ member_has, const float* __restrict__ cent_x,
    const float* __restrict__ cent_y, const float* __restrict__ d_center,
    const float* __restrict__ overlap, const float* __restrict__ cell_x,
    const float* __restrict__ cell_y, float* __restrict__ out, int n) {
  __shared__ float s_mh[kMaxCells];
  __shared__ float s_cx[kMaxCells];
  __shared__ float s_cy[kMaxCells];
  const int b = blockIdx.x;
  for (int o = threadIdx.x; o < n; o += blockDim.x) {
    s_mh[o] = member_has[b * n + o];
    s_cx[o] = cent_x[b * n + o];
    s_cy[o] = cent_y[b * n + o];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    out[b * n + c] = neighbor_score_at(c, n, s_mh, s_cx, s_cy, d_center,
                                       overlap, cell_x[c], cell_y[c]);
  }
}

}  // namespace

REPRO_EXTERN int neighbor_score_launch(
    const float* member_has, const float* cent_x, const float* cent_y,
    const float* d_center, const float* overlap, const float* cell_x,
    const float* cell_y, float* out, int batch, int n_cells,
    void* stream) {
  if (n_cells > kMaxCells) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const int threads = ((n_cells + 31) / 32) * 32;
  neighbor_score_kernel<<<batch, threads, 0, as_stream(stream)>>>(
      member_has, cent_x, cent_y, d_center, overlap, cell_x, cell_y, out,
      n_cells);
  return static_cast<int>(cudaGetLastError());
}

REPRO_EXTERN const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
