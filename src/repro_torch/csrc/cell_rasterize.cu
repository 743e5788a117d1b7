// Fleet-batched boxes -> (cell x zoom) window rasterization: the oracle
// pass of every controller step (scene/observe.observe_all_cells).
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
//
// What bounds it on an H100: launch latency. At the main path's shapes
// (64 cameras x 8 channels x 22 objects x 75 windows) one call reads
// ~60 KB, writes ~0.4 MB and does ~1 MFLOP of compares and adds — well
// under a microsecond of either at the card's rates — against a launch
// of a few microseconds; it runs once per step. The design is one launch
// with no padding: one block per camera with the camera's object strips
// and draws staged in shared memory, one thread per window looping over
// objects (and channels inside) in the reference's order, so the
// per-(object, window) clipping is computed once for all channels.
// Geometry is compiled without FMA contraction (-fmad=false), so the
// visibility cut and the detection test round exactly like the plain
// PyTorch version and the counts match it exactly.
#include "common.cuh"

namespace {

constexpr int kMaxObjects = 128;
constexpr int kMaxChannels = 16;

__global__ void cell_rasterize_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ ow, const float* __restrict__ oh,
    const float* __restrict__ draw, const float* __restrict__ a0,
    const float* __restrict__ a1, const float* __restrict__ windows,
    float* __restrict__ cnt, float* __restrict__ area,
    float* __restrict__ wcx, float* __restrict__ wcy,
    float* __restrict__ wc2, float* __restrict__ ext, int n_obj,
    int n_chan, int n_win, int n_moment, float min_visible) {
  __shared__ float s_ox[kMaxObjects], s_oy[kMaxObjects];
  __shared__ float s_ow[kMaxObjects], s_oh[kMaxObjects];
  __shared__ float s_draw[kMaxChannels * kMaxObjects];
  __shared__ float s_a0[kMaxChannels], s_span[kMaxChannels];
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

  for (int c = threadIdx.x; c < n_win; c += blockDim.x) {
    const float x0 = windows[c * 4 + 0];
    const float y0 = windows[c * 4 + 1];
    const float fw = windows[c * 4 + 2];
    const float fh = windows[c * 4 + 3];
    float acc_cnt[kMaxChannels];
    float acc_area[kMaxChannels];
    for (int p = 0; p < n_chan; ++p) {
      acc_cnt[p] = 0.0f;
      acc_area[p] = 0.0f;
    }
    float sx = 0.0f, sy = 0.0f, s2 = 0.0f, e = 0.0f;
    for (int m = 0; m < n_obj; ++m) {
      const float ox0 = s_ox[m] - s_ow[m] / 2.0f;
      const float ox1 = s_ox[m] + s_ow[m] / 2.0f;
      const float oy0 = s_oy[m] - s_oh[m] / 2.0f;
      const float oy1 = s_oy[m] + s_oh[m] / 2.0f;
      const float ix0 = fmaxf(ox0, x0);
      const float ix1 = fminf(ox1, x0 + fw);
      const float iy0 = fmaxf(oy0, y0);
      const float iy1 = fminf(oy1, y0 + fh);
      const float iw = fmaxf(ix1 - ix0, 0.0f);
      const float ih = fmaxf(iy1 - iy0, 0.0f);
      const float vis = (iw * ih) / fmaxf(s_ow[m] * s_oh[m], 1e-9f);
      const bool visible = vis >= min_visible;
      const float nw = iw / fw;
      const float nh = ih / fh;
      const float apparent = fmaxf(nw, nh);
      const float a_norm = nw * nh;
      const float ccx = (ix0 + ix1) / 2.0f;
      const float ccy = (iy0 + iy1) / 2.0f;
      float mult = 0.0f;
      for (int p = 0; p < n_chan; ++p) {
        const float x = fminf(
            fmaxf((apparent - s_a0[p]) / s_span[p], 0.0f), 1.0f);
        const float det =
            (visible && s_draw[p * n_obj + m] < x) ? 1.0f : 0.0f;
        acc_cnt[p] += det;
        acc_area[p] += det * a_norm;
        if (p < n_moment) mult += det;
      }
      sx += mult * ccx;
      sy += mult * ccy;
      s2 += mult * (ccx * ccx + ccy * ccy);
      e = fmaxf(e, mult > 0.0f ? fmaxf(iw, ih) : 0.0f);
    }
    for (int p = 0; p < n_chan; ++p) {
      cnt[(b * n_chan + p) * n_win + c] = acc_cnt[p];
      area[(b * n_chan + p) * n_win + c] = acc_area[p];
    }
    wcx[b * n_win + c] = sx;
    wcy[b * n_win + c] = sy;
    wc2[b * n_win + c] = s2;
    ext[b * n_win + c] = e;
  }
}

}  // namespace

REPRO_EXTERN int cell_rasterize_launch(
    const float* ox, const float* oy, const float* ow, const float* oh,
    const float* draw, const float* a0, const float* a1,
    const float* windows, float* cnt, float* area, float* wcx, float* wcy,
    float* wc2, float* ext, int batch, int n_obj, int n_chan, int n_win,
    int n_moment, float min_visible, void* stream) {
  if (n_obj > kMaxObjects || n_chan > kMaxChannels) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
  cell_rasterize_kernel<<<batch, 128, 0, as_stream(stream)>>>(
      ox, oy, ow, oh, draw, a0, a1, windows, cnt, area, wcx, wcy, wc2, ext,
      n_obj, n_chan, n_win, n_moment, min_visible);
  return static_cast<int>(cudaGetLastError());
}
