// Fused crop rasterization -> ViT patch embedding for the shortlisted
// candidate windows of the detector path (fleet/runner._score_fused).
//
// Replaces the TPU kernel `crop_patchify_batch` (body `_make_kernel`) in
// src/repro/kernels/crop_patchify/crop_patchify.py.
//
// For camera f and window k it paints up to M <= 256 object boxes into a
// res x res x 3 crop over the background-plus-noise plane (last painter
// wins; only boxes with visibility >= min_visible paint), clips to
// [0, 1], cuts the crop into (res/p)^2 patches of p*p*3 pixels in
// (row, col, channel) order, and multiplies by the [p*p*3, D] patch-embed
// weights plus bias: tokens [F, K, (res/p)^2, D].
//
// What bounds it on an H100: arithmetic. At the main path's shapes
// (F*K = 1152 crops, 196 patches, p*p*3 = 768, D = 192) the product is
// 66.6 GFLOP against ~175 MB of tokens written. Plain TF32 keeps too few
// bits for the 1e-4 tolerance, so the product runs in split TF32
// (wgmma.cuh: three TF32 products per k-step), 200 GFLOP of tensor-core
// work, ~0.40 ms at the dense TF32 rate.
//
// Design. The TPU kernel held a whole crop and an [M, res, res]
// ownership cube in VMEM; at res = 224 one crop (588 KB) exceeds a
// block's shared memory, so a crop is never materialized:
// - Rows are the flattened [F*K*P] patch axis, cut in 128-row tiles (two
//   warpgroups of 64). At the main path's shapes 225,792 rows are 1,764
//   tiles exactly, where 64-row tiles cut per crop would pad 196 rows to
//   256 (23% wasted work). A tile straddles crops, so it builds the
//   ownership masks of every crop it touches (at most 128 / P + 2):
//   per crop a row mask and a column mask of W = ceil(M / 32) uint32
//   words per pixel line (slot 32 w + j is bit j of word w), so a
//   pixel's owner is the highest set bit of the highest nonzero word of
//   rowbits & colbits: 31 - clz(rowbits & colbits) at W = 1. W is a
//   template parameter (1, 2, 4, 8), picked at launch: the main path's
//   22 slots run the one-word instance.
// - One block computes its rows against N tile = all D features (192;
//   64 for D <= 64), so each pixel is painted once.
// - A comes from registers: each thread paints exactly the pixels of
//   its wgmma A fragment (2 rows x 4 k per k-step), splits them into
//   TF32 hi and lo, and issues `wgmma m64nNk8` RS three times (hi.hi',
//   hi.lo', lo.hi'). Painting step s + 1 overlaps the tensor cores on
//   step s (two fragment register sets), and the plane values under a
//   chunk's pixels are loaded into registers during the chunk before,
//   so their latency never stalls the painting. A chunk's K columns are
//   decoded once per block into a shared table (pixel row, column,
//   channel, plane offset), not by every thread.
// - B is the weight matrix split into hi and lo once by the wrapper
//   (ops.tf32_split_weights) and laid out in the K-major core-matrix
//   order wgmma reads, chunk by chunk, so a 64-deep K chunk of both
//   halves is one contiguous block: cp.async streams it into a 2-stage
//   ring while the previous chunk is multiplied.
// Shared memory holds the ring and, per crop a tile touches, its masks,
// its objects' packed pixel bounds and (W <= 4) their colours; at W = 8
// the colours are read from global memory (L1), so 256 slots fit beside
// the 192-wide ring at 224 px. Crops so small that a 128-row tile spans
// dozens of them (res = 32 at p = 16 with D > 64), or masks past the
// opt-in budget, do not fit and the launch is refused.
// The geometry is compiled without FMA contraction so pixel bounds and
// visibility round exactly like the plain PyTorch version.
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kWord = 32;         // object slots per ownership word
constexpr int kMaxWords = 8;      // up to 256 object slots
constexpr int kMaxRes = 1024;
constexpr int kBM = 128;          // rows per block: two warpgroups of 64
constexpr int kKC = 64;           // K depth of one ring stage
constexpr int kStages = 2;
constexpr int kThreads = 256;
constexpr int kSmemLimit = 232448;

// per crop of a tile and object slot: the packed row and column bounds
// (lo | hi << 16, empty where the object does not paint), and 3 colours
// where they live in shared memory
template <int W>
__host__ __device__ constexpr bool colors_in_smem() {
  return W <= 4;
}

// per K column of two chunks: (plane offset, pixel row, pixel col,
// channel) within the patch
constexpr int kKTabBytes = 2 * kKC * 16;

__host__ __device__ constexpr int ring_bytes(int nt) {
  return kStages * 2 * nt * kKC * 4;
}

__host__ __device__ inline int crops_per_tile(int n_patch, int n_crops) {
  const int c = (kBM - 1) / n_patch + 2;
  return c < n_crops ? c : n_crops;
}

// dynamic shared memory of one block: the ring, the K table, and per
// crop of the tile its masks and object geometry
template <int NT, int W>
constexpr size_t shared_bytes(int n_cmax, int res) {
  return static_cast<size_t>(ring_bytes(NT)) + kKTabBytes +
         static_cast<size_t>(n_cmax) *
             (2 * res * W * 4 +
              kWord * W * (2 + (colors_in_smem<W>() ? 3 : 0)) * 4);
}

struct RowInfo {
  int ci;           // crop within the tile; -1 past the last row
  int prow, pcol;   // top-left pixel of the patch
  const float* plane;
};

template <int NT, int W>
__global__ void __launch_bounds__(kThreads, 1) crop_patchify_kernel(
    const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ ow, const float* __restrict__ oh,
    const float* __restrict__ colors, const float* __restrict__ windows,
    const float* __restrict__ bgn, const float* __restrict__ wsplit,
    const float* __restrict__ bias, float* __restrict__ out, int n_obj,
    int n_win, int per_camera_windows, int res, int patch, int d_model,
    float min_visible, int n_crops, int n_cmax, int n_chunks) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* s_ring = reinterpret_cast<float*>(smem);
  int4* s_ktab = reinterpret_cast<int4*>(smem + ring_bytes(NT));
  // [crop][row, col][pixel line][W]
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(
      smem + ring_bytes(NT) + kKTabBytes);
  uint32_t* s_geo = s_bits + n_cmax * 2 * res * W;
  constexpr int kObj = kWord * W;   // object slots per crop

  const int tid = threadIdx.x;
  const int g = res / patch;
  const int n_patch = g * g;
  const int depth = patch * patch * 3;
  const int p3 = patch * 3;
  const long long n_rows = static_cast<long long>(n_crops) * n_patch;
  const long long row0 = static_cast<long long>(blockIdx.x) * kBM;
  const int c_first = static_cast<int>(row0 / n_patch);
  const int ntile = blockIdx.y;

  // ---- B chunk loader: 2 * NT * kKC floats, contiguous ---------------
  const float* wtile = wsplit + static_cast<size_t>(ntile) * n_chunks * 2 *
                                    NT * kKC;
  auto load_chunk = [&](int c) {
    const float* src = wtile + static_cast<size_t>(c) * 2 * NT * kKC;
    float* dst = s_ring + (c % kStages) * 2 * NT * kKC;
    for (int i = tid * 4; i < 2 * NT * kKC; i += kThreads * 4) {
      tc::cp_async16(dst + i, src + i);
    }
  };
  load_chunk(0);
  tc::cp_async_commit();

  // ---- object geometry of every crop the tile touches ----------------
  uint32_t* s_rows = s_geo;                     // [crop][slot]
  uint32_t* s_cols = s_rows + n_cmax * kObj;
  float* s_color = reinterpret_cast<float*>(s_cols + n_cmax * kObj);
  for (int idx = tid; idx < n_cmax * n_obj; idx += kThreads) {
    const int ci = idx / n_obj;
    const int m = idx - ci * n_obj;
    const int crop = c_first + ci;
    if (crop >= n_crops) continue;
    const int f = crop / n_win;
    const int slot = ci * kObj + m;
    const float* win =
        windows + (per_camera_windows ? crop : crop % n_win) * 4;
    const float x0 = win[0], y0 = win[1], fw = win[2], fh = win[3];
    const int i = f * n_obj + m;
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
    const bool keep = (inter / fmaxf(box, 1e-9f)) >= min_visible;
    const float r = static_cast<float>(res);
    const float top = static_cast<float>(res - 1);
    // clip first, then truncate (all values non-negative)
    const uint32_t px0 = static_cast<uint32_t>(
        fminf(fmaxf((ix0 - x0) / fw * r, 0.0f), top));
    const uint32_t px1 = static_cast<uint32_t>(
        fminf(fmaxf((ix1 - x0) / fw * r + 1.0f, 1.0f), r));
    const uint32_t py0 = static_cast<uint32_t>(
        fminf(fmaxf((iy0 - y0) / fh * r, 0.0f), top));
    const uint32_t py1 = static_cast<uint32_t>(
        fminf(fmaxf((iy1 - y0) / fh * r + 1.0f, 1.0f), r));
    s_rows[slot] = keep ? py0 | py1 << 16 : 0u;
    s_cols[slot] = keep ? px0 | px1 << 16 : 0u;
    if constexpr (colors_in_smem<W>()) {
      for (int ch = 0; ch < 3; ++ch) {
        s_color[slot * 3 + ch] = colors[i * 3 + ch];
      }
    }
  }
  __syncthreads();
  // word w of line t: the slots 32 w .. 32 w + 31 that cover it
  for (int idx = tid; idx < n_cmax * res * W; idx += kThreads) {
    const int ci = idx / (res * W);
    const int rem = idx - ci * res * W;
    const int t = rem / W;
    const int w = rem - t * W;
    uint32_t rb = 0u, cb = 0u;
    if (c_first + ci < n_crops) {
      const int m_end = min(n_obj - kWord * w, kWord);
      for (int j = 0; j < m_end; ++j) {
        const int slot = ci * kObj + kWord * w + j;
        const uint32_t rr = s_rows[slot];
        const uint32_t cc = s_cols[slot];
        const uint32_t line = static_cast<uint32_t>(t);
        if (line >= (rr & 0xffffu) && line < (rr >> 16)) rb |= 1u << j;
        if (line >= (cc & 0xffffu) && line < (cc >> 16)) cb |= 1u << j;
      }
    }
    s_bits[((ci * 2) * res + t) * W + w] = rb;
    s_bits[((ci * 2 + 1) * res + t) * W + w] = cb;
  }
  __syncthreads();

  // ---- this thread's two A-fragment rows -----------------------------
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int wrow = (warp / 4) * 64 + (warp % 4) * 16 + gq;
  RowInfo rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = row0 + wrow + 8 * h;
    rows[h].ci = -1;
    rows[h].prow = rows[h].pcol = 0;
    rows[h].plane = bgn;
    if (r < n_rows) {
      const int crop = static_cast<int>(r / n_patch);
      const int pidx = static_cast<int>(r - static_cast<long long>(crop) *
                                                n_patch);
      rows[h].ci = crop - c_first;
      rows[h].prow = (pidx / g) * patch;
      rows[h].pcol = (pidx % g) * patch;
      rows[h].plane = bgn + static_cast<size_t>(crop / n_win) * res * res * 3;
    }
  }

  // K columns of chunk c -> table half c % 2 (pixel row -1 past the
  // depth), written by the first kKC threads
  auto fill_ktab = [&](int c) {
    if (tid < kKC) {
      const int k = c * kKC + tid;
      int4 e = make_int4(0, -1, 0, 0);
      if (k < depth) {
        const int kr = k / p3;
        const int rem = k - kr * p3;
        const int kc = rem / 3;
        e = make_int4((kr * res + kc) * 3 + rem - kc * 3, kr, kc,
                      rem - kc * 3);
      }
      s_ktab[(c % 2) * kKC + tid] = e;
    }
  };
  // per fragment row: its crop's row and column masks, colours and plane
  // at the patch's top-left pixel
  const uint32_t* rmask[2];
  const uint32_t* cmask[2];
  const float* rcolor[2];
  const float* rplane[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int ci = rows[h].ci < 0 ? 0 : rows[h].ci;
    rmask[h] = s_bits + ((ci * 2) * res + rows[h].prow) * W;
    cmask[h] = s_bits + ((ci * 2 + 1) * res + rows[h].pcol) * W;
    if constexpr (colors_in_smem<W>()) {
      rcolor[h] = s_color + ci * kObj * 3;
    } else {
      const int crop = c_first + ci < n_crops ? c_first + ci : 0;
      rcolor[h] = colors + static_cast<size_t>(crop / n_win) * n_obj * 3;
    }
    rplane[h] = rows[h].plane + (rows[h].prow * res + rows[h].pcol) * 3;
  }
  // the background-plus-noise plane under the fragment's pixels of chunk
  // c, loaded one chunk ahead so the loads' latency hides behind a
  // chunk of tensor-core work
  constexpr int kSteps = kKC / 8;
  float plane_cur[kSteps][2][2], plane_nxt[kSteps][2][2];
  auto load_plane = [&](int c, float (&dst)[kSteps][2][2]) {
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int4 e = s_ktab[(c % 2) * kKC + s * 8 + tq + 4 * j];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          dst[s][j][h] = (rows[h].ci < 0 || e.y < 0)
                             ? 0.0f : __ldg(rplane[h] + e.x);
        }
      }
    }
  };
  // the pixel: the owner's colour where an object paints it, else the
  // plane, clipped to [0, 1]
  auto paint = [&](int h, const int4& e, float plane) -> float {
    if (rows[h].ci < 0 || e.y < 0) return 0.0f;
    float v;
    if constexpr (W == 1) {
      const uint32_t bits = rmask[h][e.y] & cmask[h][e.z];
      v = bits ? rcolor[h][(31 - __clz(bits)) * 3 + e.w] : plane;
    } else {
      // the highest nonzero word, then its highest set bit
      uint32_t bits = 0u;
      int word = 0;
#pragma unroll
      for (int w = W - 1; w >= 0; --w) {
        const uint32_t b = rmask[h][e.y * W + w] & cmask[h][e.z * W + w];
        if (bits == 0u && b != 0u) {
          bits = b;
          word = w;
        }
      }
      v = bits ? rcolor[h][(kWord * word + 31 - __clz(bits)) * 3 + e.w]
               : plane;
    }
    return fminf(fmaxf(v, 0.0f), 1.0f);
  };
  fill_ktab(0);
  __syncthreads();
  load_plane(0, plane_cur);

  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  uint32_t a_frag[2][2][4];   // [register set][hi, lo][fragment]

  for (int c = 0; c < n_chunks; ++c) {
    // the previous chunk's products are done in both warpgroups, so its
    // stage may be refilled with chunk c + 1
    tc::wait<0>();
    tc::fence_regs(acc);
    __syncthreads();
    if (c + 1 < n_chunks) load_chunk(c + 1);
    tc::cp_async_commit();
    if (c + 1 < n_chunks) fill_ktab(c + 1);
    tc::cp_async_wait<1>();
    tc::fence_proxy_async();
    __syncthreads();

    const float* stage = s_ring + (c % kStages) * 2 * NT * kKC;
    if (c + 1 < n_chunks) load_plane(c + 1, plane_nxt);
#pragma unroll
    for (int s = 0; s < kSteps; ++s) {
      if (s >= 2) tc::wait<1>();     // frees register set s % 2
      uint32_t(&a)[2][4] = a_frag[s % 2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int4 e = s_ktab[(c % 2) * kKC + s * 8 + tq + 4 * j];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // fragment order: (row, k t), (row + 8, k t), (row, k t + 4),
          // (row + 8, k t + 4)
          tc::tf32_split(paint(h, e, plane_cur[s][j][h]), a[0][2 * j + h],
                         a[1][2 * j + h]);
        }
      }
      tc::fence_regs(a[0]);
      tc::fence_regs(a[1]);
      tc::fence();
      const uint64_t b_hi = tc::desc(stage + s * 64, 128, 128 * (kKC / 4));
      const uint64_t b_lo =
          tc::desc(stage + NT * kKC + s * 64, 128, 128 * (kKC / 4));
      tc::Wgmma<true, true, NT>::mma(acc, a[1], b_hi, 1);
      tc::Wgmma<true, true, NT>::mma(acc, a[0], b_lo, 1);
      tc::Wgmma<true, true, NT>::mma(acc, a[0], b_hi, 1);
      tc::commit();
    }
#pragma unroll
    for (int s = 0; s < kSteps; ++s)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) plane_cur[s][j][h] = plane_nxt[s][j][h];
  }
  tc::wait<0>();
  tc::fence_regs(acc);

  // ---- epilogue: + bias, straight from the accumulator ---------------
  const int n0 = ntile * NT;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long r = row0 + wrow + 8 * h;
    if (r >= n_rows) continue;
    float* dst = out + static_cast<size_t>(r) * d_model;
#pragma unroll
    for (int q = 0; q < NT / 8; ++q) {
      const int col = n0 + 8 * q + 2 * tq;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (col + e < d_model) {
          dst[col + e] = acc[4 * q + 2 * h + e] + bias[col + e];
        }
      }
    }
  }
}

template <int NT, int W>
cudaError_t launch_tiles(const float* ox, const float* oy, const float* ow,
                         const float* oh, const float* colors,
                         const float* windows, const float* bgn,
                         const float* wsplit, const float* bias, float* out,
                         int n_crops, int n_obj, int n_win,
                         int per_camera_windows, int res, int patch,
                         int d_model, float min_visible,
                         cudaStream_t stream) {
  const int g = res / patch;
  const int n_patch = g * g;
  const int n_cmax = crops_per_tile(n_patch, n_crops);
  const size_t smem = shared_bytes<NT, W>(n_cmax, res);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  // set on every launch: the attribute is per device
  const cudaError_t err = cudaFuncSetAttribute(
      crop_patchify_kernel<NT, W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long n_rows = static_cast<long long>(n_crops) * n_patch;
  const long long tiles = (n_rows + kBM - 1) / kBM;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int depth = patch * patch * 3;
  const dim3 grid(static_cast<unsigned>(tiles), (d_model + NT - 1) / NT);
  crop_patchify_kernel<NT, W><<<grid, kThreads, smem, stream>>>(
      ox, oy, ow, oh, colors, windows, bgn, wsplit, bias, out, n_obj, n_win,
      per_camera_windows, res, patch, d_model, min_visible, n_crops, n_cmax,
      (depth + kKC - 1) / kKC);
  return cudaGetLastError();
}

}  // namespace

// `w` is the weight matrix as ops.tf32_split_weights lays it out for
// N tile NT (64 when D <= 64, else 192): [D tiles][K chunks of 64][hi,
// lo][NT / 8][8 cores along K][8 rows][4], zero past D and p*p*3.
REPRO_EXTERN int crop_patchify_launch(
    const float* ox, const float* oy, const float* ow, const float* oh,
    const float* colors, const float* windows, const float* bgn,
    const float* w, const float* bias, float* out, int n_cam, int n_obj,
    int n_win, int per_camera_windows, int res, int patch, int d_model,
    float min_visible, void* stream) {
  if (n_obj > kWord * kMaxWords || res > kMaxRes || patch <= 0 ||
      res % patch != 0 || d_model < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_cam == 0 || n_win == 0) return 0;
  const long long n_crops = static_cast<long long>(n_cam) * n_win;
  if (n_crops > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // the narrowest ownership word count for M slots, and the feature tile
  const int words = n_obj <= 32 ? 1 : n_obj <= 64 ? 2 : n_obj <= 128 ? 4 : 8;
#define REPRO_TILES(NT, W)                                                 \
  launch_tiles<NT, W>(ox, oy, ow, oh, colors, windows, bgn, w, bias, out,   \
                      static_cast<int>(n_crops), n_obj, n_win,              \
                      per_camera_windows, res, patch, d_model, min_visible, \
                      as_stream(stream))
#define REPRO_WORDS(NT)                                                    \
  (words == 1 ? REPRO_TILES(NT, 1)                                         \
   : words == 2 ? REPRO_TILES(NT, 2)                                       \
   : words == 4 ? REPRO_TILES(NT, 4) : REPRO_TILES(NT, 8))
  const cudaError_t err = d_model <= 64 ? REPRO_WORDS(64) : REPRO_WORDS(192);
#undef REPRO_WORDS
#undef REPRO_TILES
  return static_cast<int>(err);
}
