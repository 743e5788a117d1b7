// Fused crop rasterization -> ViT patch embedding for the shortlisted
// candidate windows of the detector path (fleet/runner._score_fused).
//
// Replaces the TPU kernel `crop_patchify_batch` (body `_make_kernel`) in
// src/repro/kernels/crop_patchify/crop_patchify.py.
//
// For camera f and window k it paints up to M <= 32 object boxes into a
// res x res x 3 crop over the background-plus-noise plane (last painter
// wins; only boxes with visibility >= min_visible paint), clips to
// [0, 1], cuts the crop into (res/p)^2 patches of p*p*3 pixels in
// (row, col, channel) order, and multiplies by the [p*p*3, D] patch-embed
// weights plus bias: tokens [F, K, (res/p)^2, D].
//
// What bounds it on an H100: arithmetic. At the main path's shapes
// (F*K = 1152 crops, 196 patches, p*p*3 = 768, D = 192) the product is
// 66.6 GFLOP against ~175 MB of tokens written, ~1 ms at the card's
// float32 (non-tensor-core) rate. The TPU kernel held the whole crop and
// an [M, res, res] ownership cube in VMEM; at res = 224 one crop alone
// (588 KB) exceeds a block's 227 KB of shared memory. So this design
// never materializes a crop: it is a shared-memory-tiled GEMM
// (64 patches x 64 features per block, 16-deep K tiles, 4 x 4 outputs
// per thread) whose A tile is painted on the fly from packed ownership
// masks — per (camera, window) one uint32 row mask and one column mask
// per pixel line, built once per block, so a pixel's owner is
// 31 - clz(rowbits & colbits). Pixels never reach device memory; only
// the background-plus-noise plane (computed outside, shared by the
// camera's K windows) and the weights are read. The geometry is compiled
// without FMA contraction so pixel bounds and visibility round exactly
// like the plain PyTorch version; the token product uses explicit FMAs.
// Tensor cores (TF32 or bf16) and a pipelined load are later work.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMaxObjects = 32;   // one uint32 ownership lane per object
constexpr int kMaxRes = 1024;
constexpr int kBM = 64;           // patches per block tile
constexpr int kBN = 64;           // features per block tile
constexpr int kBK = 16;           // reduction depth per stage
constexpr int kTM = 4;
constexpr int kTN = 4;
constexpr int kThreads = (kBM / kTM) * (kBN / kTN);   // 256

__global__ void __launch_bounds__(kThreads) crop_patchify_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ ow, const float* __restrict__ oh,
    const float* __restrict__ colors, const float* __restrict__ windows,
    const float* __restrict__ bgn, const float* __restrict__ w,
    const float* __restrict__ bias, float* __restrict__ out, int n_obj,
    int n_win, int per_camera_windows, int res, int patch, int d_model,
    float min_visible) {
  __shared__ uint32_t s_rowbits[kMaxRes];
  __shared__ uint32_t s_colbits[kMaxRes];
  __shared__ int s_px0[kMaxObjects], s_px1[kMaxObjects];
  __shared__ int s_py0[kMaxObjects], s_py1[kMaxObjects];
  __shared__ int s_keep[kMaxObjects];
  __shared__ float s_color[kMaxObjects * 3];
  __shared__ float s_a[kBK][kBM];
  __shared__ float s_w[kBK][kBN];

  const int crop = blockIdx.x;            // f * n_win + k
  const int f = crop / n_win;
  const int tid = threadIdx.x;
  const int g = res / patch;
  const int n_patch = g * g;
  const int depth = patch * patch * 3;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.z * kBN;

  // ---- object geometry for this (camera, window) ----------------------
  const float* win =
      windows + (per_camera_windows ? crop : crop % n_win) * 4;
  const float x0 = win[0], y0 = win[1], fw = win[2], fh = win[3];
  if (tid < n_obj) {
    const int i = f * n_obj + tid;
    const float ox0 = ox[i] - ow[i] / 2.0f;
    const float ox1 = ox[i] + ow[i] / 2.0f;
    const float oy0 = oy[i] - oh[i] / 2.0f;
    const float oy1 = oy[i] + oh[i] / 2.0f;
    const float ix0 = fmaxf(ox0, x0);
    const float ix1 = fminf(ox1, x0 + fw);
    const float iy0 = fmaxf(oy0, y0);
    const float iy1 = fminf(oy1, y0 + fh);
    const float inter = fmaxf(ix1 - ix0, 0.0f) * fmaxf(iy1 - iy0, 0.0f);
    const float box = (ox1 - ox0) * (oy1 - oy0);
    s_keep[tid] = (inter / fmaxf(box, 1e-9f)) >= min_visible;
    const float r = static_cast<float>(res);
    const float top = static_cast<float>(res - 1);
    // clip first, then truncate (all values non-negative)
    s_px0[tid] = static_cast<int>(fminf(fmaxf((ix0 - x0) / fw * r, 0.0f),
                                        top));
    s_px1[tid] = static_cast<int>(
        fminf(fmaxf((ix1 - x0) / fw * r + 1.0f, 1.0f), r));
    s_py0[tid] = static_cast<int>(fminf(fmaxf((iy0 - y0) / fh * r, 0.0f),
                                        top));
    s_py1[tid] = static_cast<int>(
        fminf(fmaxf((iy1 - y0) / fh * r + 1.0f, 1.0f), r));
    for (int ch = 0; ch < 3; ++ch) {
      s_color[tid * 3 + ch] = colors[i * 3 + ch];
    }
  }
  __syncthreads();
  for (int t = tid; t < res; t += kThreads) {
    uint32_t rb = 0u, cb = 0u;
    for (int m = 0; m < n_obj; ++m) {
      if (!s_keep[m]) continue;
      if (t >= s_py0[m] && t < s_py1[m]) rb |= 1u << m;
      if (t >= s_px0[m] && t < s_px1[m]) cb |= 1u << m;
    }
    s_rowbits[t] = rb;
    s_colbits[t] = cb;
  }
  __syncthreads();

  // ---- tiled product: tokens[m0:m0+BM, n0:n0+BN] ----------------------
  const float* plane = bgn + static_cast<size_t>(f) * res * res * 3;
  const int ty = tid / (kBN / kTN);
  const int tx = tid % (kBN / kTN);
  float acc[kTM][kTN];
  for (int i = 0; i < kTM; ++i)
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < depth; k0 += kBK) {
    for (int idx = tid; idx < kBK * kBM; idx += kThreads) {
      const int i = idx % kBM;             // patch within the tile
      const int kq = idx / kBM;
      const int p = m0 + i;
      const int k = k0 + kq;
      float v = 0.0f;
      if (p < n_patch && k < depth) {
        const int kr = k / (patch * 3);
        const int rem = k - kr * patch * 3;
        const int kc = rem / 3;
        const int ch = rem - kc * 3;
        const int row = (p / g) * patch + kr;
        const int col = (p % g) * patch + kc;
        const uint32_t bits = s_rowbits[row] & s_colbits[col];
        v = bits ? s_color[(31 - __clz(bits)) * 3 + ch]
                 : plane[(row * res + col) * 3 + ch];
        v = fminf(fmaxf(v, 0.0f), 1.0f);
      }
      s_a[kq][i] = v;
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int j = idx % kBN;
      const int kq = idx / kBN;
      const int k = k0 + kq;
      const int n = n0 + j;
      s_w[kq][j] = (k < depth && n < d_model) ? w[k * d_model + n] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kq = 0; kq < kBK; ++kq) {
      float a[kTM], bw[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = s_a[kq][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) bw[j] = s_w[kq][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j)
          acc[i][j] = __fmaf_rn(a[i], bw[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* dst = out + static_cast<size_t>(crop) * n_patch * d_model;
  for (int i = 0; i < kTM; ++i) {
    const int p = m0 + ty * kTM + i;
    if (p >= n_patch) continue;
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx * kTN + j;
      if (n < d_model) dst[p * d_model + n] = acc[i][j] + bias[n];
    }
  }
}

}  // namespace

REPRO_EXTERN int crop_patchify_launch(
    const float* ox, const float* oy, const float* ow, const float* oh,
    const float* colors, const float* windows, const float* bgn,
    const float* w, const float* bias, float* out, int n_cam, int n_obj,
    int n_win, int per_camera_windows, int res, int patch, int d_model,
    float min_visible, void* stream) {
  if (n_obj > kMaxObjects || n_obj > kThreads || res > kMaxRes ||
      patch <= 0 || res % patch != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_cam == 0 || n_win == 0) return 0;
  const int g = res / patch;
  const dim3 grid(n_cam * n_win, (g * g + kBM - 1) / kBM,
                  (d_model + kBN - 1) / kBN);
  crop_patchify_kernel<<<grid, kThreads, 0, as_stream(stream)>>>(
      ox, oy, ow, oh, colors, windows, bgn, w, bias, out, n_obj, n_win,
      per_camera_windows, res, patch, d_model, min_visible);
  return static_cast<int>(cudaGetLastError());
}
