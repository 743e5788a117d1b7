// Tiled online-softmax attention (flash attention), BSHD layout, GQA, on
// the H100's tensor cores.
//
// Replaces the TPU kernel `flash_attention_bhsd` (body `_flash_kernel`)
// in src/repro/kernels/flash_attention/flash_attention.py, together with
// the layout work of its wrapper (ops.py: BSHD -> BHSD transposes, the
// GQA `repeat` of K/V, padding S to blocks and D to 128 lanes).
//
// q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D] (Hq % Hkv == 0, D <= 256),
// float32 or bfloat16 in, float32 softmax, output [B, Sq, Hq, D] in q's
// type:
//   s[i, j] = (q_i . k_j) * scale, masked to -inf where j >= Sk or, with
//   `causal`, where j > i + q_offset; out_i = softmax_j(s) . v, and 0 for
//   a row with no unmasked key.
//
// What bounds it on an H100: arithmetic. At the ViT detector's shapes
// (B = 1152 crops, S = 197, H = 6, D = 32) one layer is 34 GFLOP of
// products against 0.7 GB of q/k/v/out; float32 inputs take split TF32
// (wgmma.cuh), three TF32 products each, ~0.21 ms at the dense TF32
// rate, while plain TF32 would break the 3e-5 tolerance.
//
// Design. One block is two warpgroups (256 threads) and owns a (batch,
// query head, 128-query tile); each warpgroup computes 64 of the rows
// and both share each K/V tile's load and split. No logit is written to
// device memory.
// - Q is read once and written to shared memory as TF32 hi and lo
//   halves (bf16: as it is), in the K-major core-matrix layout wgmma
//   reads; its loads overlap the first K/V tile's.
// - K/V tiles of BC keys (64; 32 in float32 below D = 64 and where 64
//   would not fit) arrive by cp.async
//   into a staging buffer while the block works on the previous tile,
//   then are split into hi and lo and written in wgmma's layout: K as
//   [keys, D], V transposed to [D, keys], whole core matrices per warp.
//   Head dims pad with zeros in shared memory only, to a multiple of the
//   MMA depth (8 for TF32, 16 for bf16); ragged S is masked.
// - S = Q.K^T is `wgmma m64nBCk8` SS, three per k-step (lo.hi', hi.lo',
//   hi.hi'); bf16 takes one `m64nBCk16` per step.
// - Online softmax in registers, in base 2 (exp2f): each thread holds 2
//   rows x BC/4 logits of the accumulator, row maxima meet in two
//   shuffles.
// - O += P.V is `wgmma m64nDk8` RS: P is split in registers and fed as
//   the A fragment. The accumulator holds keys (2t, 2t + 1) of each
//   8-key group where a TF32 A fragment wants keys (t, t + 4), so V's
//   keys are stored permuted within each group of 8 (key k at position
//   (k & 1) * 4 + k / 2), which leaves the sum over keys unchanged.
//   bf16 rounds P to bf16 (FlashAttention-2) and needs no permutation.
// K/V heads are indexed as h / (Hq / Hkv), so GQA never copies K/V.
// Causal tiles wholly above the diagonal are never loaded (the TPU
// kernel's block skip).
// Head dims past 128 (192 and 256, the MLA configs' query/key width):
// the output's columns are cut in two slices of DP / 2, one block each.
// Each slice computes the whole S = Q.K^T over all DP (more k-steps of
// the same loop) and the softmax statistics identically, so the result
// is exact, at the cost of S computed once per slice. In float32 a block
// is one warpgroup of 64 rows (the split Q tile of 128 rows would not
// fit), with 32 keys per tile at 192 and 16 at 256.
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxD = 256;

template <typename T, int DP>
struct Cfg {
  static constexpr bool kTf32 = sizeof(T) == 4;
  // output columns per block: all of them up to 128, else half
  static constexpr int DV = DP <= 128 ? DP : DP / 2;
  static constexpr int kSlices = DP / DV;
  // two warpgroups of 64 query rows share each K/V tile's load and split
  // (one in float32 past 128 dims)
  static constexpr int WG = kTf32 && DP > 128 ? 1 : 2;
  static constexpr int BQ = 64 * WG;             // query rows per block
  static constexpr int kThreads = 128 * WG;
  static constexpr int NH = kTf32 ? 2 : 1;        // hi, lo halves
  using E = typename std::conditional<kTf32, uint32_t, __nv_bfloat16>::type;
  static constexpr int SP = DP + 16 / sizeof(T);  // staging row stride
  // bytes at 64 and 32 keys per tile
  static constexpr int kSmem64 = NH * (BQ * DP + 64 * DP + DV * 64) *
                                     sizeof(E) + 2 * 64 * SP * sizeof(T);
  static constexpr int kSmem32 = NH * (BQ * DP + 32 * DP + DV * 32) *
                                     sizeof(E) + 2 * 32 * SP * sizeof(T);
  // keys per tile: 64, except float32 below D = 64 (where the last tile
  // of a short sequence wastes less and more blocks fit an SM) or where
  // 64 (then 32) would not fit a block's shared memory
  static constexpr int BC =
      (!kTf32 || DP >= 64) && kSmem64 <= 232448 ? 64
      : kSmem32 <= 232448                       ? 32
                                                : 16;
  static constexpr int EPC = kTf32 ? 4 : 8;       // values per core row
  static constexpr int KSTEP = 2 * EPC;           // MMA depth
  static constexpr int kQ = NH * BQ * DP;         // elements of E
  static constexpr int kK = NH * BC * DP;
  static constexpr int kV = NH * DV * BC;
  // staging rows are padded by 16 bytes, so the reads of one core
  // matrix's 8 rows fall in distinct banks
  static constexpr int kStage = 2 * BC * SP;      // elements of T
  static constexpr int kSmem = (kQ + kK + kV) * sizeof(E) +
                               kStage * sizeof(T);
};

// element i of a K-major tile with `kx` values along K, in wgmma's order
// (core matrices of 8 rows x EPC values, K fastest) -> (row, k); one
// thread per 16-byte core row, so 8 consecutive threads write a whole
// core matrix, conflict-free
template <int EPC>
__device__ __forceinline__ void core_pos(int i, int kx, int& row, int& k) {
  const int core = i / (8 * EPC);
  const int w = i - core * (8 * EPC);
  row = (core / (kx / EPC)) * 8 + w / EPC;
  k = (core % (kx / EPC)) * EPC + w % EPC;
}

// one core-matrix row: EPC values, 16 bytes of E per half
template <int EPC>
__device__ __forceinline__ void put_row(uint32_t* hi, uint32_t* lo, int i,
                                        const float (&x)[EPC]) {
  uint4 h, l;
  tc::tf32_split(x[0], h.x, l.x);
  tc::tf32_split(x[1], h.y, l.y);
  tc::tf32_split(x[2], h.z, l.z);
  tc::tf32_split(x[3], h.w, l.w);
  *reinterpret_cast<uint4*>(hi + i) = h;
  *reinterpret_cast<uint4*>(lo + i) = l;
}
template <int EPC>
__device__ __forceinline__ void put_row(__nv_bfloat16* hi, __nv_bfloat16*,
                                        int i, const float (&x)[EPC]) {
  union {
    uint4 u;
    __nv_bfloat16 b[8];
  } r;
#pragma unroll
  for (int e = 0; e < 8; ++e) r.b[e] = __float2bfloat16(x[e]);   // exact
  *reinterpret_cast<uint4*>(hi + i) = r.u;
}

// 16 bytes of T from shared or global memory, as float
template <typename T, int EPC>
__device__ __forceinline__ void load_row(const T* p, float (&x)[EPC]) {
  union {
    uint4 u;
    T t[EPC];
  } r;
  r.u = *reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int e = 0; e < EPC; ++e) x[e] = to_f32(r.t[e]);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);   // a -> low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <typename T, int DP>
__global__ void __launch_bounds__(Cfg<T, DP>::kThreads)
flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int sq, int sk, int hq,
    int hkv, int d, float scale, int causal, int q_offset, int n_qtiles,
    int vec16) {
  using C = Cfg<T, DP>;
  constexpr int DV = C::DV;
  using E = typename C::E;
  constexpr int BC = C::BC;
  constexpr int EPC = C::EPC;
  constexpr int SP = C::SP;
  constexpr int kBQ = C::BQ;
  constexpr int kThreads = C::kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  E* s_q = reinterpret_cast<E*>(smem);           // [NH][kBQ x DP]
  E* s_k = s_q + C::kQ;                          // [NH][BC x DP]
  E* s_v = s_k + C::kK;                          // [NH][DV x BC]
  T* s_stage = reinterpret_cast<T*>(s_v + C::kV);   // [K, V][BC][SP]

  // the slice of output columns [v0, v0 + DV) innermost, so the slices
  // of one query tile run side by side and share K/V in L2
  const int v0 = (blockIdx.x % C::kSlices) * DV;
  const int qt = blockIdx.x / C::kSlices;
  const int tile = qt % n_qtiles;
  const int bh = qt / n_qtiles;
  const int b = bh / hq;
  const int h = bh % hq;
  const int hk = h / (hq / hkv);
  const int tid = threadIdx.x;
  const int q0 = tile * kBQ;

  int k_end = sk;
  if (causal) {
    const int last = min(q0 + kBQ, sq) - 1 + q_offset;
    k_end = min(sk, max(last + 1, 0));
  }
  const size_t kv_base = static_cast<size_t>(b) * sk * hkv + hk;

  // raw K/V rows of the tile at key kt into the staging buffer
  auto stage_tile = [&](int kt) {
    if (vec16) {
      constexpr int kPer = 16 / sizeof(T);
      const int chunks = d / kPer;
      for (int idx = tid; idx < 2 * BC * chunks; idx += kThreads) {
        const int which = idx / (BC * chunks);
        const int rem = idx - which * BC * chunks;
        const int j = rem / chunks;
        const int c = rem - j * chunks;
        if (kt + j >= sk) continue;
        const size_t off =
            (kv_base + static_cast<size_t>(kt + j) * hkv) * d + c * kPer;
        tc::cp_async16(s_stage + (which * BC + j) * SP + c * kPer,
                       (which ? v : k) + off);
      }
    } else {
      for (int idx = tid; idx < 2 * BC * d; idx += kThreads) {
        const int which = idx / (BC * d);
        const int rem = idx - which * BC * d;
        const int j = rem / d;
        const int dim = rem - j * d;
        if (kt + j >= sk) continue;
        const size_t off =
            (kv_base + static_cast<size_t>(kt + j) * hkv) * d + dim;
        s_stage[(which * BC + j) * SP + dim] = (which ? v : k)[off];
      }
    }
    tc::cp_async_commit();
  };

  if (k_end > 0) stage_tile(0);
  // Q tile in wgmma's layout, zero past Sq and D (its loads overlap the
  // first K/V tile's cp.async)
  const size_t q_base = (static_cast<size_t>(b) * sq + q0) * hq + h;
#pragma unroll 4
  for (int u = tid; u < kBQ * DP / EPC; u += kThreads) {
    int r, k0;
    core_pos<EPC>(u * EPC, DP, r, k0);             // one core row each
    float x[EPC];
    if (q0 + r < sq) {
      const T* src = q + (q_base + static_cast<size_t>(r) * hq) * d + k0;
      if (vec16 && k0 + EPC <= d) {
        load_row<T, EPC>(src, x);
      } else {
#pragma unroll
        for (int e = 0; e < EPC; ++e) {
          x[e] = k0 + e < d ? to_f32(src[e]) : 0.0f;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e) x[e] = 0.0f;
    }
    put_row<EPC>(s_q, s_q + kBQ * DP, u * EPC, x);
  }

  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int wg = warp / 4;                       // this warpgroup's rows
  const int rloc = wg * 64 + (warp % 4) * 16 + gq;   // rloc, rloc + 8
  int qpos[2];
  qpos[0] = q0 + rloc + q_offset;
  qpos[1] = qpos[0] + 8;

  float o_acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o_acc[i] = 0.0f;
  float s_acc[BC / 2];
#pragma unroll
  for (int i = 0; i < BC / 2; ++i) s_acc[i] = 0.0f;
  // logits in base 2: exp(x) = exp2(x log2(e)), one MUFU.EX2 each
  const float scale_log2 = scale * 1.4426950408889634f;
  float m_run[2] = {-INFINITY, -INFINITY};
  // keys this warpgroup needs: none past Sq, causal ones up to its last row
  int wg_end = q0 + wg * 64 < sq ? sk : 0;
  if (causal && wg_end > 0) {
    const int last = min(q0 + wg * 64 + 64, sq) - 1 + q_offset;
    wg_end = min(sk, max(last + 1, 0));
  }
  float l_run[2] = {0.0f, 0.0f};   // this thread's share of the row sum

  for (int kt = 0; kt < k_end; kt += BC) {
    // staging holds this tile; every warp is done with the last tile
    tc::cp_async_wait<0>();
    __syncthreads();
#pragma unroll 2
    for (int u = tid; u < BC * DP / EPC; u += kThreads) {
      int j, k0;
      core_pos<EPC>(u * EPC, DP, j, k0);         // K as [keys, D]
      float x[EPC];
      load_row<T, EPC>(s_stage + j * SP + k0, x);
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        if (kt + j >= sk || k0 + e >= d) x[e] = 0.0f;
      }
      put_row<EPC>(s_k, s_k + BC * DP, u * EPC, x);
    }
#pragma unroll 2
    for (int u = tid; u < DV * BC / EPC; u += kThreads) {
      int dim, p0;
      core_pos<EPC>(u * EPC, BC, dim, p0);       // V's slice as [DV, keys]
      float x[EPC];
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        // TF32: position p of each 8-key group holds key 2 (p % 4) + p / 4
        const int pos = p0 + e;
        const int key = C::kTf32 ? (pos & ~7) | ((pos & 3) << 1) |
                                       ((pos >> 2) & 1)
                                 : pos;
        x[e] = kt + key < sk && v0 + dim < d
                   ? to_f32(s_stage[(BC + key) * SP + v0 + dim]) : 0.0f;
      }
      put_row<EPC>(s_v, s_v + DV * BC, u * EPC, x);
    }
    tc::fence_proxy_async();
    __syncthreads();
    if (kt + BC < k_end) stage_tile(kt + BC);
    if (kt >= wg_end) continue;     // uniform across the warpgroup

    // ---- S = Q.K^T ----------------------------------------------------
    tc::fence_regs(s_acc);
    tc::fence();
#pragma unroll
    for (int s = 0; s < DP / C::KSTEP; ++s) {
      const uint64_t qh = tc::desc(s_q + wg * 64 * DP + s * 2 * 8 * EPC,
                                   128, 128 * (DP / EPC));
      const uint64_t kh = tc::desc(s_k + s * 2 * 8 * EPC, 128,
                                   128 * (DP / EPC));
      if constexpr (C::kTf32) {
        const uint64_t ql = tc::desc(s_q + (kBQ + wg * 64) * DP + s * 64,
                                     128, 128 * (DP / EPC));
        const uint64_t kl = tc::desc(s_k + BC * DP + s * 64, 128,
                                     128 * (DP / EPC));
        tc::Wgmma<true, false, BC>::mma(s_acc, ql, kh, s > 0);
        tc::Wgmma<true, false, BC>::mma(s_acc, qh, kl, 1);
        tc::Wgmma<true, false, BC>::mma(s_acc, qh, kh, 1);
      } else {
        tc::Wgmma<false, false, BC>::mma(s_acc, qh, kh, s > 0);
      }
    }
    tc::commit();
    tc::wait<0>();
    tc::fence_regs(s_acc);

    // ---- online softmax over this tile -------------------------------
    float m_new[2], m_safe[2], alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) m_new[hh] = m_run[hh];
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) {
      const int hh = (i / 2) % 2;
      const int key = kt + 8 * (i / 4) + 2 * tq + i % 2;
      const bool ok = key < sk && (!causal || key <= qpos[hh]);
      s_acc[i] = ok ? s_acc[i] * scale_log2 : -INFINITY;
      m_new[hh] = fmaxf(m_new[hh], s_acc[i]);
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      m_new[hh] = fmaxf(m_new[hh],
                        __shfl_xor_sync(0xffffffffu, m_new[hh], 1));
      m_new[hh] = fmaxf(m_new[hh],
                        __shfl_xor_sync(0xffffffffu, m_new[hh], 2));
      m_safe[hh] = m_new[hh] == -INFINITY ? 0.0f : m_new[hh];
      alpha[hh] =
          m_run[hh] == -INFINITY ? 0.0f : exp2f(m_run[hh] - m_safe[hh]);
      m_run[hh] = m_new[hh];
      l_run[hh] *= alpha[hh];
    }
#pragma unroll
    for (int i = 0; i < BC / 2; ++i) {
      const int hh = (i / 2) % 2;
      const float p =
          s_acc[i] == -INFINITY ? 0.0f : exp2f(s_acc[i] - m_safe[hh]);
      l_run[hh] += p;
      s_acc[i] = p;
    }
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o_acc[i] *= alpha[(i / 2) % 2];

    // ---- O += P.V ------------------------------------------------------
    constexpr int NSTEP = BC / C::KSTEP;
    uint32_t p_hi[NSTEP][4], p_lo[NSTEP][4];
#pragma unroll
    for (int j = 0; j < NSTEP; ++j) {
      if constexpr (C::kTf32) {
        // fragment (row, key t), (row + 8, t), (row, t + 4), (row + 8,
        // t + 4) <- accumulator keys 2t, 2t, 2t + 1, 2t + 1
        const int ord[4] = {0, 2, 1, 3};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tc::tf32_split(s_acc[4 * j + ord[e]], p_hi[j][e], p_lo[j][e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p_hi[j][e] = pack_bf16(s_acc[8 * j + 2 * e],
                                 s_acc[8 * j + 2 * e + 1]);
        }
      }
      tc::fence_regs(p_hi[j]);
      if constexpr (C::kTf32) tc::fence_regs(p_lo[j]);
    }
    tc::fence_regs(o_acc);
    tc::fence();
#pragma unroll
    for (int j = 0; j < NSTEP; ++j) {
      const uint64_t vh = tc::desc(s_v + j * 2 * 8 * EPC, 128,
                                   128 * (BC / EPC));
      if constexpr (C::kTf32) {
        const uint64_t vl = tc::desc(s_v + DV * BC + j * 64, 128,
                                     128 * (BC / EPC));
        tc::Wgmma<true, true, DV>::mma(o_acc, p_lo[j], vh, 1);
        tc::Wgmma<true, true, DV>::mma(o_acc, p_hi[j], vl, 1);
        tc::Wgmma<true, true, DV>::mma(o_acc, p_hi[j], vh, 1);
      } else {
        tc::Wgmma<false, true, DV>::mma(o_acc, p_hi[j], vh, 1);
      }
    }
    tc::commit();
    tc::wait<0>();
    tc::fence_regs(o_acc);
  }

  // ---- epilogue ----------------------------------------------------------
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 2);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + rloc + 8 * hh;
    if (row >= sq) continue;
    const float denom = l_run[hh] > 0.0f ? l_run[hh] : 1.0f;
    T* orow = out + ((static_cast<size_t>(b) * sq + row) * hq + h) * d;
#pragma unroll
    for (int qd = 0; qd < DV / 8; ++qd) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int dim = v0 + 8 * qd + 2 * tq + e;
        if (dim < d) store(orow + dim, o_acc[4 * qd + 2 * hh + e] / denom);
      }
    }
  }
}

template <typename T, int DP>
cudaError_t launch_one(const void* q, const void* k, const void* v,
                       void* out, int batch, int sq, int sk, int hq,
                       int hkv, int d, float scale, int causal,
                       int q_offset, cudaStream_t stream) {
  using C = Cfg<T, DP>;
  constexpr int kSmem = C::kSmem;
  // set on every launch: the attribute is per device
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const int n_qtiles = (sq + C::BQ - 1) / C::BQ;
  const long long blocks =
      static_cast<long long>(batch) * hq * n_qtiles * C::kSlices;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // 16-byte cp.async needs 16-byte aligned rows and bases
  const int vec16 = (d * sizeof(T)) % 16 == 0 &&
                                    (reinterpret_cast<uintptr_t>(k) % 16) == 0 &&
                    (reinterpret_cast<uintptr_t>(v) % 16) == 0;
  flash_attention_kernel<T, DP>
      <<<static_cast<unsigned>(blocks), C::kThreads, kSmem, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(out), sq, sk, hq, hkv,
          d, scale, causal, q_offset, n_qtiles, vec16);
  return cudaGetLastError();
}

// The narrowest padded head dim DP >= D with an instance: a multiple of
// the MMA depth (8 for TF32, 16 for bf16).
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     void* out, int batch, int sq, int sk, int hq, int hkv,
                     int d, float scale, int causal, int q_offset,
                     cudaStream_t stream) {
#define REPRO_FLASH(DP)                                                   \
  return launch_one<T, DP>(q, k, v, out, batch, sq, sk, hq, hkv, d, scale, \
                           causal, q_offset, stream)
  if (d <= 16) REPRO_FLASH(16);
  if constexpr (sizeof(T) == 4) {
    if (d <= 24) REPRO_FLASH(24);
  }
  if (d <= 32) REPRO_FLASH(32);
  if (d <= 48) REPRO_FLASH(48);
  if (d <= 64) REPRO_FLASH(64);
  if (d <= 80) REPRO_FLASH(80);
  if (d <= 96) REPRO_FLASH(96);
  if (d <= 128) REPRO_FLASH(128);
  if (d <= 192) REPRO_FLASH(192);
  REPRO_FLASH(256);
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
