// One (cell x zoom) window of one camera rasterized by one warp: shared
// by the standalone cell_rasterize kernel and the fused oracle_pass
// kernel, so the clip, the visibility cut, the detection ramp and the
// order of every sum exist once.
//
// For object m and window (x0, y0, fw, fh): clip the box to the window;
// it is visible when clipped area / box area >= min_visible; channel p
// detects it when draw[p, m] < clip((apparent - a0[p]) / span[p], 0, 1),
// apparent = max(clipped w / fw, clipped h / fh), span = max(a1 - a0,
// 1e-6). Every operation rounds as the plain PyTorch version's separate
// operations do: the library is built with -fmad=false and the divisions
// are IEEE divisions (a product by a reciprocal would move objects across
// the cut and change the counts).
//
// The warp works in chunks of 32 objects. Lane j clips object base + j
// once for all channels, packs its detections into a bit word and stages
// the word and the normalized area in the warp's shared slots; then
// every lane walks the chunk's objects in index order, lane p summing
// channel p's count and area. The moments over the first n_moment
// channels are summed across the warp by a butterfly (a pairwise tree
// over the chunk's 32 objects, every lane ending with the same sums),
// chunks in order: the spread E[c^2] - |E[c]|^2 cancels, so its sums
// take the more accurate order. The moments are of the centers taken
// from an origin the caller gives: (0, 0) for the absolute moments of
// the cell_rasterize API; the window's center in the oracle pass, where
// the centers lie within half a window of it, so the variance E[d^2] -
// |E[d]|^2 of d = c - origin cancels little. Every accumulator lives in
// a register; the chunk loop runs as many 32-object chunks as M needs.
#pragma once

#include <cuda_runtime.h>

namespace raster {

constexpr int kMaxObjects = 256;
constexpr int kWarp = 32;

struct Clip {
  bool visible;
  float apparent;   // max(clipped w / fw, clipped h / fh)
  float a_norm;     // clipped w / fw * clipped h / fh
  float ccx, ccy;   // center of the clipped box (degrees)
  float side;       // max(clipped w, clipped h) (degrees)
};

__device__ __forceinline__ Clip clip_to_window(float ox, float oy, float ow,
                                               float oh, float x0, float y0,
                                               float fw, float fh,
                                               float min_visible) {
  const float ox0 = ox - ow / 2.0f;
  const float ox1 = ox + ow / 2.0f;
  const float oy0 = oy - oh / 2.0f;
  const float oy1 = oy + oh / 2.0f;
  const float ix0 = fmaxf(ox0, x0);
  const float ix1 = fminf(ox1, x0 + fw);
  const float iy0 = fmaxf(oy0, y0);
  const float iy1 = fminf(oy1, y0 + fh);
  const float iw = fmaxf(ix1 - ix0, 0.0f);
  const float ih = fmaxf(iy1 - iy0, 0.0f);
  Clip g;
  g.visible = (iw * ih) / fmaxf(ow * oh, 1e-9f) >= min_visible;
  const float nw = iw / fw;
  const float nh = ih / fh;
  g.apparent = fmaxf(nw, nh);
  g.a_norm = nw * nh;
  g.ccx = (ix0 + ix1) / 2.0f;
  g.ccy = (iy0 + iy1) / 2.0f;
  g.side = fmaxf(iw, ih);
  return g;
}

// The teacher response ramp against the draw (2.0 never detects).
__device__ __forceinline__ bool ramp_detects(float draw, float apparent,
                                             float a0, float span) {
  return draw < fminf(fmaxf((apparent - a0) / span, 0.0f), 1.0f);
}

struct WindowSums {
  float cnt, area;  // channel `lane` (meaningful on lanes < n_chan)
  float nbox;       // sum over objects of the moment multiplicity
  float sx, sy, s2; // multiplicity-weighted sum dx, dy, dx^2 + dy^2 of
                    // the centers d = c - origin
  float ext;        // max clipped side over objects with multiplicity
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

// Called by all 32 lanes of a warp. s_ox/s_oy/s_ow/s_oh [n_obj] and
// s_draw [n_chan][n_obj], s_a0/s_span [n_chan]: the camera's objects,
// draws and ramps in shared memory. stage: the warp's 32 float2 of
// shared memory. n_chan <= 32 (one lane per channel). origin: where the
// moments' centers are measured from.
__device__ __forceinline__ WindowSums rasterize_window(
    const float* s_ox, const float* s_oy, const float* s_ow,
    const float* s_oh, const float* s_draw, const float* s_a0,
    const float* s_span, int n_obj, int n_chan, int n_moment, float4 win,
    float2 origin, float min_visible, float2* stage) {
  const int lane = threadIdx.x % kWarp;
  const unsigned moment_bits =
      n_moment >= kWarp ? 0xffffffffu : (1u << n_moment) - 1u;
  WindowSums s = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  for (int base = 0; base < n_obj; base += kWarp) {
    const int m = base + lane;
    unsigned bits = 0u;
    float a_norm = 0.0f, mult = 0.0f, wx = 0.0f, wy = 0.0f, w2 = 0.0f;
    float side = 0.0f;
    if (m < n_obj) {
      const Clip g = clip_to_window(s_ox[m], s_oy[m], s_ow[m], s_oh[m],
                                    win.x, win.y, win.z, win.w,
                                    min_visible);
      if (g.visible) {
#pragma unroll 4
        for (int p = 0; p < n_chan; ++p) {
          if (ramp_detects(s_draw[p * n_obj + m], g.apparent, s_a0[p],
                           s_span[p])) {
            bits |= 1u << p;
          }
        }
      }
      a_norm = g.a_norm;
      mult = static_cast<float>(__popc(bits & moment_bits));
      const float dx = g.ccx - origin.x;
      const float dy = g.ccy - origin.y;
      wx = mult * dx;
      wy = mult * dy;
      w2 = mult * (dx * dx + dy * dy);
      side = mult > 0.0f ? g.side : 0.0f;
    }
    stage[lane] = make_float2(__uint_as_float(bits), a_norm);
    s.nbox += warp_sum(mult);
    s.sx += warp_sum(wx);
    s.sy += warp_sum(wy);
    s.s2 += warp_sum(w2);
    s.ext = fmaxf(s.ext, warp_max(side));
    __syncwarp();
    const int n = min(kWarp, n_obj - base);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float2 a = stage[j];
      const float det = ((__float_as_uint(a.x) >> lane) & 1u) ? 1.0f : 0.0f;
      s.cnt += det;
      s.area += det * a.y;
    }
    __syncwarp();
  }
  return s;
}

}  // namespace raster
