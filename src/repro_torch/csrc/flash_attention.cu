// Tiled online-softmax attention (flash attention), BSHD layout, GQA.
//
// Replaces the TPU kernel `flash_attention_bhsd` (body `_flash_kernel`)
// in src/repro/kernels/flash_attention/flash_attention.py, together with
// the layout work of its wrapper (ops.py: BSHD -> BHSD transposes, the
// GQA `repeat` of K/V, padding S to blocks and D to 128 lanes).
//
// q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (Hq % Hkv == 0, D <= 128),
// float32 or bfloat16 in, float32 math, output [B, Sq, Hq, D] in q's
// type:
//   s[i, j] = (q_i . k_j) * scale, masked to -inf where j >= Sk or, with
//   `causal`, where j > i + q_offset; out_i = softmax_j(s) . v, and 0 for
//   a row with no unmasked key.
//
// What bounds it on an H100: arithmetic. At the ViT detector's shapes
// (B = 1152 crops, S = 197, H = 6, D = 32) one layer is 34 GFLOP against
// 0.7 GB of q/k/v/out, ~0.5 ms at the card's float32 (non-tensor-core)
// rate, while the plain version writes and reads 1.07 GB of f32 logits
// per layer. This design never writes a logit: one block per
// (batch, query head, 64-query tile); K/V tiles of 32 keys are staged in
// shared memory (converted to f32, zero beyond Sk and D) and streamed
// past the queries; each query row is held by LANES = 1, 2 or 4 threads,
// each owning DT of its padded head dims (in float4 chunks interleaved
// across the lanes, so the lanes of a row read neighbouring shared words
// and the rows of a warp read the same ones: no bank conflicts), with
// its running max, denominator and accumulator in registers. Partial
// dot products are summed across the lanes with warp shuffles. K/V heads
// are indexed as h / (Hq / Hkv), so GQA never copies K/V; ragged S and D
// are bounds checks, not padding passes. Causal tiles wholly above the
// diagonal are never loaded (the TPU kernel's block skip). The library
// is built with -fmad=false; the two products use explicit FMAs.
// Tensor cores (wgmma, bf16/TF32) and a pipelined TMA load are later
// work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;      // query rows per block
constexpr int kBK = 32;      // keys per shared-memory tile
constexpr int kMaxD = 128;

template <typename T, int LANES, int DT>
__global__ void __launch_bounds__(kBQ * LANES) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int sq, int sk, int hq,
    int hkv, int d, float scale, int causal, int q_offset, int n_qtiles) {
  constexpr int DP = DT * LANES;     // padded head dim held by one row
  constexpr int NC = DT / 4;         // float4 chunks per lane
  __shared__ __align__(16) float s_k[kBK][DP];
  __shared__ __align__(16) float s_v[kBK][DP];

  const int tile = blockIdx.x % n_qtiles;
  const int bh = blockIdx.x / n_qtiles;
  const int b = bh / hq;
  const int h = bh % hq;
  const int hk = h / (hq / hkv);
  const int lane = threadIdx.x % LANES;
  const int q0 = tile * kBQ;
  const int row = q0 + threadIdx.x / LANES;
  const bool row_ok = row < sq;
  const int qpos = row + q_offset;

  // this thread's dims: chunk c = i * LANES + lane holds dims 4c .. 4c+3
  float qr[DT];
  float acc[DT];
  const T* qrow = q + ((static_cast<size_t>(b) * sq + row) * hq + h) * d;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int dim = (i * LANES + lane) * 4 + c;
      qr[i * 4 + c] = (row_ok && dim < d) ? to_f32(qrow[dim]) : 0.0f;
      acc[i * 4 + c] = 0.0f;
    }
  }
  float m = -INFINITY;
  float l = 0.0f;

  int k_end = sk;
  if (causal) {
    const int last = min(q0 + kBQ, sq) - 1 + q_offset;
    k_end = min(sk, max(last + 1, 0));
  }
  const size_t kv_base = static_cast<size_t>(b) * sk * hkv + hk;
  for (int kt = 0; kt < k_end; kt += kBK) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBK * DP; idx += blockDim.x) {
      const int j = idx / DP;
      const int dim = idx - j * DP;
      const int key = kt + j;
      float kx = 0.0f, vx = 0.0f;
      if (key < sk && dim < d) {
        const size_t off = (kv_base + static_cast<size_t>(key) * hkv) * d
                           + dim;
        kx = to_f32(k[off]);
        vx = to_f32(v[off]);
      }
      s_k[j][dim] = kx;
      s_v[j][dim] = vx;
    }
    __syncthreads();

    float s[kBK];
    float m_cur = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float4* kr = reinterpret_cast<const float4*>(s_k[j]);
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const float4 kk = kr[i * LANES + lane];
        part = __fmaf_rn(qr[i * 4 + 0], kk.x, part);
        part = __fmaf_rn(qr[i * 4 + 1], kk.y, part);
        part = __fmaf_rn(qr[i * 4 + 2], kk.z, part);
        part = __fmaf_rn(qr[i * 4 + 3], kk.w, part);
      }
#pragma unroll
      for (int off = LANES / 2; off > 0; off >>= 1) {
        part += __shfl_xor_sync(0xffffffffu, part, off);
      }
      const int key = kt + j;
      const bool ok = key < sk && (!causal || key <= qpos);
      s[j] = ok ? part * scale : -INFINITY;
      m_cur = fmaxf(m_cur, s[j]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float m_safe = m_new == -INFINITY ? 0.0f : m_new;
    const float alpha = m == -INFINITY ? 0.0f : expf(m - m_safe);
#pragma unroll
    for (int i = 0; i < DT; ++i) acc[i] *= alpha;
    float p_sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float p = s[j] == -INFINITY ? 0.0f : expf(s[j] - m_safe);
      p_sum += p;
      const float4* vr = reinterpret_cast<const float4*>(s_v[j]);
#pragma unroll
      for (int i = 0; i < NC; ++i) {
        const float4 vv = vr[i * LANES + lane];
        acc[i * 4 + 0] = __fmaf_rn(p, vv.x, acc[i * 4 + 0]);
        acc[i * 4 + 1] = __fmaf_rn(p, vv.y, acc[i * 4 + 1]);
        acc[i * 4 + 2] = __fmaf_rn(p, vv.z, acc[i * 4 + 2]);
        acc[i * 4 + 3] = __fmaf_rn(p, vv.w, acc[i * 4 + 3]);
      }
    }
    l = alpha * l + p_sum;
    m = m_new;
  }

  if (!row_ok) return;
  const float denom = l > 0.0f ? l : 1.0f;
  T* orow = out + ((static_cast<size_t>(b) * sq + row) * hq + h) * d;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int dim = (i * LANES + lane) * 4 + c;
      if (dim < d) store(orow + dim, acc[i * 4 + c] / denom);
    }
  }
}

template <typename T, int LANES, int DT>
cudaError_t launch_one(const void* q, const void* k, const void* v,
                       void* out, int batch, int sq, int sk, int hq,
                       int hkv, int d, float scale, int causal,
                       int q_offset, cudaStream_t stream) {
  const int n_qtiles = (sq + kBQ - 1) / kBQ;
  const long long blocks = static_cast<long long>(batch) * hq * n_qtiles;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  flash_attention_kernel<T, LANES, DT>
      <<<static_cast<unsigned>(blocks), kBQ * LANES, 0, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), sq, sk, hq, hkv,
          d, scale, causal, q_offset, n_qtiles);
  return cudaGetLastError();
}

// The narrowest (LANES, DT) whose padded width DT * LANES covers D.
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     void* out, int batch, int sq, int sk, int hq, int hkv,
                     int d, float scale, int causal, int q_offset,
                     cudaStream_t stream) {
#define REPRO_FLASH(LANES, DT)                                             \
  return launch_one<T, LANES, DT>(q, k, v, out, batch, sq, sk, hq, hkv, d, \
                                  scale, causal, q_offset, stream)
  if (d <= 16) REPRO_FLASH(1, 16);
  if (d <= 32) REPRO_FLASH(1, 32);
  if (d <= 48) REPRO_FLASH(2, 24);
  if (d <= 64) REPRO_FLASH(2, 32);
  if (d <= 96) REPRO_FLASH(4, 24);
  REPRO_FLASH(4, 32);
#undef REPRO_FLASH
}

}  // namespace

REPRO_EXTERN int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int batch,
    int sq, int sk, int hq, int hkv, int d, float scale, int causal,
    int q_offset, int is_bf16, void* stream) {
  if (d < 1 || d > kMaxD || hkv < 1 || hq % hkv != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || sq == 0 || hq == 0) return 0;
  const cudaError_t err =
      is_bf16 ? dispatch<__nv_bfloat16>(q, k, v, out, batch, sq, sk, hq,
                                        hkv, d, scale, causal, q_offset,
                                        as_stream(stream))
              : dispatch<float>(q, k, v, out, batch, sq, sk, hq, hkv, d,
                                scale, causal, q_offset, as_stream(stream));
  return static_cast<int>(err);
}
