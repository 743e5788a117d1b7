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
// division, as in the plain version. Out-of-frame elements of an edge
// tile count as zero in the mean and are never written.
//
// What bounds it on an H100: bytes. A 1080p frame moves ~56 MB (two f32
// frames read, one int8 frame written), ~0.017 ms at 3.35 TB/s, against
// a few operations per element. So the tile crosses HBM once: one block
// per tile, each thread loads its share of the tile's rows as items of
// kVec consecutive floats, keeps d in registers while the block sums
// |d|, then quantizes from the registers. A tile row is a contiguous run
// of tile_w * C floats; where every row starts on a 64-byte boundary
// (W * C and tile_w * C multiples of 16, aligned pointers: every 1080p
// and 720p RGB frame at the default tiles) an item is 16 floats, read as
// four 16-byte loads and written as one 16-byte int8 store; other frames
// take the generic scalar path (kVec = 1, kIter = 0) in the same
// kernel: the sum pass, then a second read of the tile (from L2) to
// quantize, as do aligned tiles larger than the register stash (more
// than 8192 floats). Threads walk (row, item) by adding a fixed step, so
// no element pays a division.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <int kVec>
struct Vec {
  float v[kVec];
};

template <int kVec>
__device__ __forceinline__ Vec<kVec> load_d(const float* __restrict__ cur,
                                            const float* __restrict__ prev,
                                            size_t off) {
  Vec<kVec> d;
  if constexpr (kVec == 16) {
    const float4* c4 = reinterpret_cast<const float4*>(cur + off);
    const float4* p4 = reinterpret_cast<const float4*>(prev + off);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 a = c4[i];
      const float4 b = p4[i];
      d.v[4 * i + 0] = a.x - b.x;
      d.v[4 * i + 1] = a.y - b.y;
      d.v[4 * i + 2] = a.z - b.z;
      d.v[4 * i + 3] = a.w - b.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) d.v[i] = cur[off + i] - prev[off + i];
  }
  return d;
}

__device__ __forceinline__ uint32_t quantize(float d, float scale,
                                             bool keep) {
  if (!keep) return 0u;
  const float q = fminf(fmaxf(rintf(d / scale), -127.0f), 127.0f);
  return static_cast<uint32_t>(static_cast<uint8_t>(
      static_cast<int8_t>(q)));
}

template <int kVec>
__device__ __forceinline__ void store_q(int8_t* __restrict__ dq, size_t off,
                                        const Vec<kVec>& d, float scale,
                                        bool keep) {
  if constexpr (kVec == 16) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = quantize(d.v[4 * i], scale, keep) |
             quantize(d.v[4 * i + 1], scale, keep) << 8 |
             quantize(d.v[4 * i + 2], scale, keep) << 16 |
             quantize(d.v[4 * i + 3], scale, keep) << 24;
    }
    *reinterpret_cast<uint4*>(dq + off) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      dq[off + i] = static_cast<int8_t>(quantize(d.v[i], scale, keep));
    }
  }
}

// One block per tile. kVec floats per item; kIter items per thread kept
// in registers (the launch guarantees kThreads * kIter cover the tile),
// or kIter = 0 for any tile size with a second read.
template <int kVec, int kIter>
__global__ void __launch_bounds__(kThreads) frame_delta_kernel(
    const float* __restrict__ cur, const float* __restrict__ prev,
    int8_t* __restrict__ delta_q, int* __restrict__ changed, int h, int w,
    int c, int tile_h, int tile_w, float tau, float scale) {
  __shared__ float s_part[kThreads / 32];
  __shared__ int s_changed;
  const int y0 = blockIdx.y * tile_h;
  const int x0 = blockIdx.x * tile_w;
  const int items_row = tile_w * c / kVec;    // a whole tile row
  const int items_valid = (min(x0 + tile_w, w) - x0) * c / kVec;
  const int rows_valid = min(y0 + tile_h, h) - y0;
  const size_t row_stride = static_cast<size_t>(w) * c;
  const size_t base = (static_cast<size_t>(y0) * w + x0) * c;
  // the thread's first (row, item) and the step kThreads as (rows, items)
  const int r0 = threadIdx.x / items_row;
  const int j0 = threadIdx.x - r0 * items_row;
  const int dr = kThreads / items_row;
  const int dj = kThreads - dr * items_row;
  auto next = [&](int& r, int& j) {
    r += dr;
    j += dj;
    if (j >= items_row) {
      j -= items_row;
      ++r;
    }
  };
  auto offset = [&](int r, int j) {
    return base + r * row_stride + static_cast<size_t>(j) * kVec;
  };

  float sum = 0.0f;
  Vec<kVec> stash[kIter > 0 ? kIter : 1];
  {
    int r = r0, j = j0;
    if constexpr (kIter > 0) {
#pragma unroll
      for (int k = 0; k < kIter; ++k) {
        if (r < rows_valid && j < items_valid) {
          stash[k] = load_d<kVec>(cur, prev, offset(r, j));
#pragma unroll
          for (int i = 0; i < kVec; ++i) sum += fabsf(stash[k].v[i]);
        }
        next(r, j);
      }
    } else {
      for (; r < rows_valid; next(r, j)) {
        if (j < items_valid) {
          const Vec<kVec> d = load_d<kVec>(cur, prev, offset(r, j));
#pragma unroll
          for (int i = 0; i < kVec; ++i) sum += fabsf(d.v[i]);
        }
      }
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
    const int flag = total / static_cast<float>(tile_h * tile_w * c) > tau;
    s_changed = flag;
    changed[blockIdx.y * gridDim.x + blockIdx.x] = flag;
  }
  __syncthreads();
  const bool keep = s_changed != 0;

  int r = r0, j = j0;
  if constexpr (kIter > 0) {
#pragma unroll
    for (int k = 0; k < kIter; ++k) {
      if (r < rows_valid && j < items_valid) {
        store_q<kVec>(delta_q, offset(r, j), stash[k], scale, keep);
      }
      next(r, j);
    }
  } else {
    for (; r < rows_valid; next(r, j)) {
      if (j < items_valid) {
        store_q<kVec>(delta_q, offset(r, j),
                      load_d<kVec>(cur, prev, offset(r, j)), scale, keep);
      }
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
  const dim3 grid(gw, gh);
  cudaStream_t st = as_stream(stream);
  const long tile = static_cast<long>(tile_h) * tile_w * c;
  const bool aligned =
      (static_cast<long>(w) * c) % 16 == 0 && (tile_w * c) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(cur) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(prev) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(delta_q) % 16 == 0;
  if (aligned && tile <= 16L * 4 * kThreads) {
    frame_delta_kernel<16, 4><<<grid, kThreads, 0, st>>>(
        cur, prev, delta_q, changed, h, w, c, tile_h, tile_w, tau, scale);
  } else {
    frame_delta_kernel<1, 0><<<grid, kThreads, 0, st>>>(
        cur, prev, delta_q, changed, h, w, c, tile_h, tile_w, tau, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
