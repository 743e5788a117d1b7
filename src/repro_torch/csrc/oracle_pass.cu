// The oracle pass of one controller step in one launch: detection
// draws, rasterization into every (cell x zoom) window and the
// observation tables in their final layouts
// (kernels/oracle_pass/ops.oracle_pass, called by
// scene/observe.observe_all_cells).
//
// Replaces, on the main path, the TPU kernel `cell_rasterize_batch`
// (body `_make_kernel`) in src/repro/kernels/cell_rasterize/
// cell_rasterize.py together with the jnp code around it in
// src/repro/scene_jax/observe.py::observe_all_cells.
//
// Per camera f (one block), over objects m, pairs p and windows c:
//   u(keys)  = the uint32 hash of observe.hash01 (wrap-around multiplies,
//              logical shifts), converted by __uint2float_rn x 2^-32
//   draw     = ((1 - flicker[p]) u(oid, salt[p], cam, BASE)
//              + flicker[p] u(oid, salt[p], cam, t // bucket))
//              / max(pmax[p], 1e-6)
//   live     = enabled[f, m] and class of pair p == kind of slot m
//              (PERSON = 0 for m < max_people, then CAR = 1: the wrapper
//              checks that scene.kind_mask lays the slots out so)
//   keep     = u(oid, t, cam, MISS) >= miss_rate
// (BASE and MISS are the wrapper's salts, passed in)
//   student  = draw where live and keep, else 2.0 (never detects)
//   teacher  = draw where live, else 2.0
// then the 2P channels (students, then teachers) go through the shared
// window body (csrc/cell_rasterize.cuh), and per window: counts/areas of
// the student channels, nbox, centroid and spread from the moments of
// the centers d = c - o about the window's center o (centroid o + E[d];
// variance E[d^2] - |E[d]|^2 as numerics.fma_f32 takes it: the float32
// product exact in double, one double add, one rounding to float —
// __dmul_rn/__dadd_rn, not __fmaf_rn). The centers lie within half a
// window of o, so the variance lands within ~1e-4 of a float64 sum,
// where the plain version's absolute moments (the reference's float32
// formula, E[c^2] up to ~3e4 deg^2) land up to ~8.5e-3 from it; extent, and
// the oracle accuracy: for each query q, the teacher count of its pair
// against that pair's max over the camera's windows (binary: > 0;
// counts: ratio; 1.0 when the camera sees none), summed in query order
// and multiplied by the float32 reciprocal of Q (as the plain version
// and the reference's compiled program take the mean).
//
// What bounds it on an H100: latency. The pass reads ~20 KB and writes
// ~0.3 MB at the main path's 64 cameras x 22 objects x 4 pairs x 75
// windows; the plain PyTorch version is ~430 operators dispatched from
// the host. One block per camera keeps every per-camera reduction (the
// max over windows, the query loop) inside the block: its objects,
// draws and teacher counts live in shared memory, the workload's queries
// ride in the kernel's parameters, 32 warps rasterize its windows (one
// warp per window, csrc/cell_rasterize.cuh), and the outputs are written
// once, in the layouts observe_all_cells returns.
#include <stdint.h>

#include "cell_rasterize.cuh"
#include "common.cuh"

namespace {

constexpr int kWarps = 32;
constexpr int kThreads = kWarps * raster::kWarp;
constexpr int kMaxPairs = 16;
constexpr int kMaxQueries = 64;
constexpr int kStageBytes = kWarps * raster::kWarp * sizeof(float2);
constexpr int kMaxSharedBytes = 200 * 1024;

// The workload's queries, passed by value (kernel parameter space).
struct Queries {
  int task_id[kMaxQueries];   // 0: binary, else a count-like task
  int pair_idx[kMaxQueries];  // the pair column the query reads
};

__device__ __forceinline__ uint32_t hash_mix(uint32_t h) {
  h *= 0x9E3779B1u;
  h ^= h >> 15;
  h *= 0x85EBCA77u;
  h ^= h >> 13;
  return h;
}

// observe.hash01 of four keys (each already cut to its low 32 bits).
__device__ __forceinline__ float hash01(uint32_t a, uint32_t b, uint32_t c,
                                        uint32_t d) {
  uint32_t h = hash_mix(0x811C9DC5u ^ a);
  h = hash_mix(h ^ b);
  h = hash_mix(h ^ c);
  h = hash_mix(h ^ d);
  return __uint2float_rn(h) * 0x1p-32f;
}

// Python's a // b for b > 0.
__device__ __forceinline__ int64_t floor_div(int64_t a, int64_t b) {
  const int64_t q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// numerics.fma_f32: a * b + c with the float32 product exact in double.
__device__ __forceinline__ float fma_f32(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(
      __dmul_rn(static_cast<double>(a), static_cast<double>(b)),
      static_cast<double>(c)));
}

__global__ void __launch_bounds__(kThreads) oracle_pass_kernel(
    const float* __restrict__ pos, const float* __restrict__ size,
    const int64_t* __restrict__ oid, const uint8_t* __restrict__ enabled,
    const int64_t* __restrict__ t, const int64_t* __restrict__ cam_salt,
    const float* __restrict__ a0, const float* __restrict__ a1,
    const float* __restrict__ pmax, const float* __restrict__ flicker,
    const int64_t* __restrict__ cls, const int64_t* __restrict__ salt,
    const float* __restrict__ windows, const Queries queries,
    float* __restrict__ counts, float* __restrict__ areas,
    float* __restrict__ centroid, float* __restrict__ spread,
    float* __restrict__ extent, int64_t* __restrict__ nbox,
    float* __restrict__ acc_true, int n_obj, int n_pair, int n_win,
    int n_query, int salt_stride, int max_people, int flicker_bucket,
    uint32_t base_salt, uint32_t miss_salt, float min_visible,
    float miss_rate) {
  extern __shared__ float2 smem[];
  float2* s_stage = smem;                         // [kWarps][32]
  float* s_ox = reinterpret_cast<float*>(smem + kWarps * raster::kWarp);
  float* s_oy = s_ox + n_obj;
  float* s_ow = s_oy + n_obj;
  float* s_oh = s_ow + n_obj;
  float* s_draw = s_oh + n_obj;                   // [2P][M]
  float* s_cnt_t = s_draw + 2 * n_pair * n_obj;   // [P][C] teacher counts
  uint8_t* s_keep = reinterpret_cast<uint8_t*>(s_cnt_t + n_pair * n_win);
  __shared__ float s_a0[2 * kMaxPairs], s_span[2 * kMaxPairs];
  __shared__ float s_max[kMaxPairs];

  const int f = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid / raster::kWarp;
  const int lane = tid % raster::kWarp;
  const int64_t tf = t[f];
  const uint32_t cam = cam_salt == nullptr
      ? 0u
      : static_cast<uint32_t>(cam_salt[static_cast<int64_t>(f) *
                                       salt_stride]);
  const uint32_t bucket = static_cast<uint32_t>(floor_div(tf,
                                                          flicker_bucket));
  const int fm = f * n_obj;

  for (int m = tid; m < n_obj; m += kThreads) {
    s_ox[m] = pos[2 * (fm + m)];
    s_oy[m] = pos[2 * (fm + m) + 1];
    s_ow[m] = size[2 * (fm + m)];
    s_oh[m] = size[2 * (fm + m) + 1];
    s_keep[m] = hash01(static_cast<uint32_t>(oid[fm + m]),
                       static_cast<uint32_t>(tf), cam, miss_salt) >=
                miss_rate;
  }
  for (int p = tid; p < 2 * n_pair; p += kThreads) {
    const int q = p % n_pair;                     // teachers repeat a0/a1
    s_a0[p] = a0[q];
    s_span[p] = fmaxf(a1[q] - a0[q], 1e-6f);
  }
  __syncthreads();
  for (int i = tid; i < n_pair * n_obj; i += kThreads) {
    const int p = i / n_obj;
    const int m = i - p * n_obj;
    const uint32_t o = static_cast<uint32_t>(oid[fm + m]);
    const uint32_t s = static_cast<uint32_t>(salt[p]);
    const float fl = flicker[p];
    const float draw = ((1.0f - fl) * hash01(o, s, cam, base_salt) +
                        fl * hash01(o, s, cam, bucket)) /
                       fmaxf(pmax[p], 1e-6f);
    const int64_t kind = m < max_people ? 0 : 1;  // PERSON slots, then CAR
    const bool live = enabled[fm + m] != 0 && cls[p] == kind;
    s_draw[p * n_obj + m] = (live && s_keep[m]) ? draw : 2.0f;
    s_draw[(n_pair + p) * n_obj + m] = live ? draw : 2.0f;
  }
  __syncthreads();

  for (int c = warp; c < n_win; c += kWarps) {
    const float4 win = make_float4(windows[4 * c], windows[4 * c + 1],
                                   windows[4 * c + 2], windows[4 * c + 3]);
    const float2 o = make_float2(win.x + win.z * 0.5f, win.y + win.w * 0.5f);
    const raster::WindowSums ws = raster::rasterize_window(
        s_ox, s_oy, s_ow, s_oh, s_draw, s_a0, s_span, n_obj, 2 * n_pair,
        n_pair, win, o, min_visible, s_stage + warp * raster::kWarp);
    const int fc = f * n_win + c;
    if (lane < n_pair) {
      counts[fc * n_pair + lane] = ws.cnt;
      areas[fc * n_pair + lane] = ws.area;
    } else if (lane < 2 * n_pair) {
      s_cnt_t[(lane - n_pair) * n_win + c] = ws.cnt;
    }
    if (lane == 0) {
      const float nb = fmaxf(ws.nbox, 1e-9f);
      const float dx = ws.sx / nb;
      const float dy = ws.sy / nb;
      const bool has = ws.nbox > 0.0f;
      const float var = fma_f32(-dy, dy, fma_f32(-dx, dx, ws.s2 / nb));
      centroid[2 * fc] = has ? o.x + dx : 0.0f;
      centroid[2 * fc + 1] = has ? o.y + dy : 0.0f;
      spread[fc] = has ? sqrtf(fmaxf(var, 0.0f)) : 0.0f;
      extent[fc] = ws.ext;
      nbox[fc] = static_cast<int64_t>(ws.nbox);
    }
  }
  __syncthreads();

  // each pair's max teacher count over the camera's windows (counts are
  // >= 0, so 0 starts the max)
  for (int p = warp; p < n_pair; p += kWarps) {
    float mx = 0.0f;
    for (int c = lane; c < n_win; c += raster::kWarp) {
      mx = fmaxf(mx, s_cnt_t[p * n_win + c]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    }
    if (lane == 0) s_max[p] = mx;
  }
  __syncthreads();

  const float inv_query = 1.0f / static_cast<float>(n_query);
  for (int c = tid; c < n_win; c += kThreads) {
    float acc = 0.0f;
    for (int q = 0; q < n_query; ++q) {
      const int p = queries.pair_idx[q];
      const float cq = s_cnt_t[p * n_win + c];
      const float mx = s_max[p];
      float a;
      if (queries.task_id[q] == 0) {  // binary: "no" is right when empty
        a = mx > 0.0f ? (cq > 0.0f ? 1.0f : 0.0f) : 1.0f;
      } else {                        // count / detect / agg_count
        a = mx > 0.0f ? cq / fmaxf(mx, 1e-9f) : 1.0f;
      }
      acc = q == 0 ? a : acc + a;
    }
    acc_true[f * n_win + c] = acc * inv_query;
  }
}

}  // namespace

REPRO_EXTERN int oracle_pass_launch(
    const float* pos, const float* size, const int64_t* oid,
    const uint8_t* enabled, const int64_t* t, const int64_t* cam_salt,
    const float* a0, const float* a1, const float* pmax,
    const float* flicker, const int64_t* cls, const int64_t* salt,
    const float* windows, const int* queries, float* counts, float* areas,
    float* centroid, float* spread, float* extent, int64_t* nbox,
    float* acc_true, int n_cam, int n_obj, int n_pair, int n_win,
    int n_query, int salt_stride, int max_people, int flicker_bucket,
    int base_salt, int miss_salt, float min_visible, float miss_rate,
    void* stream) {
  const long smem = kStageBytes +
      4L * (4L * n_obj + 2L * n_pair * n_obj + static_cast<long>(n_pair) *
                                                   n_win) + n_obj;
  if (n_obj > raster::kMaxObjects || n_pair > kMaxPairs || n_pair < 1 ||
      n_query < 1 || n_query > kMaxQueries || flicker_bucket < 1 ||
      smem > kMaxSharedBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // queries: the host's [2, Q] (task ids, then pair columns)
  Queries qs = {};
  for (int q = 0; q < n_query; ++q) {
    qs.task_id[q] = queries[q];
    qs.pair_idx[q] = queries[n_query + q];
  }
  if (n_cam == 0 || n_win == 0) return 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        oracle_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSharedBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  oracle_pass_kernel<<<n_cam, kThreads, smem, as_stream(stream)>>>(
      pos, size, oid, enabled, t, cam_salt, a0, a1, pmax, flicker, cls,
      salt, windows, qs, counts, areas, centroid, spread, extent, nbox,
      acc_true, n_obj, n_pair, n_win, n_query, salt_stride, max_people,
      flicker_bucket, static_cast<uint32_t>(base_salt),
      static_cast<uint32_t>(miss_salt), min_visible, miss_rate);
  return static_cast<int>(cudaGetLastError());
}
