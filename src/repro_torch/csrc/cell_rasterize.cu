// Fleet-batched boxes -> (cell x zoom) window rasterization: the kernel
// API `kernels/cell_rasterize/ops.cell_rasterize`. The main path runs the
// same per-window body inside the fused oracle_pass kernel.
//
// Replaces the TPU kernel `cell_rasterize_batch` (body `_make_kernel`)
// in src/repro/kernels/cell_rasterize/cell_rasterize.py.
//
// For camera b, pair channel p and window c, over objects m: clip the
// object box to the window; it is visible when clipped area / box area
// >= min_visible; channel p detects it when draw[b, p, m] <
// clip((apparent - a0[p]) / max(a1[p] - a0[p], 1e-6), 0, 1), apparent =
// max(clipped w / fw, clipped h / fh). Outputs the detection count and
// summed normalized area per (b, p, c) and, over the first n_moment
// channels (the student ones), the multiplicity-weighted center moments
// sum cx, sum cy, sum (cx^2 + cy^2) and the max clipped side per (b, c).
// The per-window body is csrc/cell_rasterize.cuh.
//
// What bounds it on an H100: latency. At the main path's shapes (64
// cameras x 8 channels x 22 objects x 75 windows) one call reads ~60 KB,
// writes ~0.4 MB and does ~10 MFLOP — under a microsecond of either at
// the card's rates — so the time is the chain of dependent operations
// each thread runs. The design shortens that chain and fills the card:
// one warp per window and one lane per object (the clip computed once
// for every channel, the channel tests in parallel across lanes), the
// counts and areas then walked in object order with one lane per
// channel, the moments summed by a warp butterfly, every accumulator in
// a register; blocks of 8 windows, so a camera spreads
// over ceil(C / 8) blocks (640 blocks for 64 cameras x 75 windows). Each
// block stages its camera's object strips and draws in dynamic shared
// memory sized by M (up to 256 objects, 20 KB at 16 channels). The
// moments are absolute: measured from the origin (0, 0).
#include "cell_rasterize.cuh"
#include "common.cuh"

namespace {

constexpr int kWarps = 8;                  // windows per block
constexpr int kMaxChannels = 16;

__global__ void __launch_bounds__(kWarps * raster::kWarp)
    cell_rasterize_kernel(
        const float* __restrict__ ox, const float* __restrict__ oy,
        const float* __restrict__ ow, const float* __restrict__ oh,
        const float* __restrict__ draw, const float* __restrict__ a0,
        const float* __restrict__ a1, const float* __restrict__ windows,
        float* __restrict__ cnt, float* __restrict__ area,
        float* __restrict__ wcx, float* __restrict__ wcy,
        float* __restrict__ wc2, float* __restrict__ ext, int n_obj,
        int n_chan, int n_win, int n_moment, float min_visible) {
  extern __shared__ float s_obj[];   // ox, oy, ow, oh [M]; draw [P][M]
  float* s_ox = s_obj;
  float* s_oy = s_ox + n_obj;
  float* s_ow = s_oy + n_obj;
  float* s_oh = s_ow + n_obj;
  float* s_draw = s_oh + n_obj;
  __shared__ float s_a0[kMaxChannels], s_span[kMaxChannels];
  __shared__ float2 s_stage[kWarps][raster::kWarp];
  const int b = blockIdx.x;
  for (int m = threadIdx.x; m < n_obj; m += blockDim.x) {
    s_ox[m] = ox[b * n_obj + m];
    s_oy[m] = oy[b * n_obj + m];
    s_ow[m] = ow[b * n_obj + m];
    s_oh[m] = oh[b * n_obj + m];
  }
  for (int i = threadIdx.x; i < n_chan * n_obj; i += blockDim.x) {
    s_draw[i] = draw[b * n_chan * n_obj + i];
  }
  for (int p = threadIdx.x; p < n_chan; p += blockDim.x) {
    s_a0[p] = a0[p];
    s_span[p] = fmaxf(a1[p] - a0[p], 1e-6f);
  }
  __syncthreads();

  const int warp = threadIdx.x / raster::kWarp;
  const int lane = threadIdx.x % raster::kWarp;
  const int c = blockIdx.y * kWarps + warp;
  if (c >= n_win) return;
  const float4 win = make_float4(windows[4 * c], windows[4 * c + 1],
                                 windows[4 * c + 2], windows[4 * c + 3]);
  const raster::WindowSums s = raster::rasterize_window(
      s_ox, s_oy, s_ow, s_oh, s_draw, s_a0, s_span, n_obj, n_chan, n_moment,
      win, make_float2(0.0f, 0.0f), min_visible, s_stage[warp]);
  if (lane < n_chan) {
    cnt[(b * n_chan + lane) * n_win + c] = s.cnt;
    area[(b * n_chan + lane) * n_win + c] = s.area;
  }
  const int bc = b * n_win + c;
  if (lane == 0) wcx[bc] = s.sx;
  if (lane == 1) wcy[bc] = s.sy;
  if (lane == 2) wc2[bc] = s.s2;
  if (lane == 3) ext[bc] = s.ext;
}

}  // namespace

REPRO_EXTERN int cell_rasterize_launch(
    const float* ox, const float* oy, const float* ow, const float* oh,
    const float* draw, const float* a0, const float* a1,
    const float* windows, float* cnt, float* area, float* wcx, float* wcy,
    float* wc2, float* ext, int batch, int n_obj, int n_chan, int n_win,
    int n_moment, float min_visible, void* stream) {
  const int win_blocks = (n_win + kWarps - 1) / kWarps;
  if (n_obj > raster::kMaxObjects || n_chan > kMaxChannels ||
      win_blocks > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || n_win == 0) return 0;
  const dim3 grid(batch, win_blocks);
  const size_t smem = sizeof(float) * (4 + n_chan) * n_obj;
  cell_rasterize_kernel<<<grid, kWarps * raster::kWarp, smem,
                          as_stream(stream)>>>(
      ox, oy, ow, oh, draw, a0, a1, windows, cnt, area, wcx, wcy, wc2, ext,
      n_obj, n_chan, n_win, n_moment, min_visible);
  return static_cast<int>(cudaGetLastError());
}
