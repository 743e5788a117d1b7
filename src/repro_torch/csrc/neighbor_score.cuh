// The candidate-neighbor score of one cell (paper §3.3), shared by the
// standalone neighbor_score kernel and the fused shape_search kernel, so
// the formula and its float32 operation order exist once:
//
//   score[c] = sum_o w * d_center[c, o] / max(|cell_c - centroid_o|,
//              1e-6) / sum_o w,   w = overlap[c, o] * member_has[o]
//
// and 1.0 where sum_o w == 0. The sum over members runs in index order;
// the library is built with -fmad=false, so each product and sum rounds
// as the plain version's separate operations do.
#pragma once

// mh/cx/cy: the camera's [n] member_has and centroid strips (shared
// memory); d_center/overlap: the grid's [n, n] tables; (gx, gy): the
// center of cell c.
__device__ __forceinline__ float neighbor_score_at(
    int c, int n, const float* mh, const float* cx, const float* cy,
    const float* __restrict__ d_center, const float* __restrict__ overlap,
    float gx, float gy) {
  float total = 0.0f;
  float total_w = 0.0f;
  for (int o = 0; o < n; ++o) {
    const float w = overlap[c * n + o] * mh[o];
    const float dx = gx - cx[o];
    const float dy = gy - cy[o];
    const float d_box = sqrtf(dx * dx + dy * dy);
    const float ratio = d_center[c * n + o] / fmaxf(d_box, 1e-6f);
    total += w * ratio;
    total_w += w;
  }
  return total_w > 0.0f ? total / fmaxf(total_w, 1e-9f) : 1.0f;
}
