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
// Two paths, chosen by the launcher from Sk, D and the type; the split,
// the wgmma layouts and the base-2 softmax are the same in both.
//
// Resident K/V (D <= 64 and Sk <= 256 where an instance fits: float32
// up to 32 dims at 256 keys, 64 dims at 128; bf16 the same). The whole
// padded key range of a (batch, head) sits in shared memory, so at the
// ViT's 197 tokens each head's K/V is read and split once, not once per
// query tile, and no key tile waits on a load. A persistent block (one
// an SM) of three warpgroups takes items, a (batch, query head) and up
// to four 64-row query tiles each: warpgroup 0 reads and splits each
// item's K/V into one of two stages of shared memory while warpgroups 1
// and 2 compute on the other, two tiles each (named barriers hand the
// stages over; setmaxnreg gives the computing warpgroups the registers).
// - Keys are padded to one of a few instances (64, 128, the ViT's 197
//   tokens at the MMA depth: 200 in float32, 208 in bf16, or 256) with
//   zeros; K's rows and (float32) V's rows are read as 16-byte rows.
// - Q's A fragments are read straight into registers, the next tile's
//   while this one computes, and split there, so S = Q.K^T is an RS
//   chain of `m64n64k8` wgmmas (and one narrower for the instance's last
//   keys) over every key at once. No wgmma is issued conditionally:
//   ptxas serializes a chain with branches in it.
// - The softmax is exact in one pass: each thread holds its two rows'
//   whole share of the logits, so there is no running maximum and no
//   rescale of the output; maxima and sums run four ways.
// - O = P.V as below (RS, P split in registers by its bits), 32 keys of
//   P a group of wgmmas.
//
// Tiled (longer sequences, wider heads). One block is two warpgroups
// (256 threads) and owns a (batch, query head, 128-query tile); each
// warpgroup computes 64 of the rows and both share each K/V tile's load
// and split. No logit is written to device memory, on either path.
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

// two neighbouring outputs, one 8- (float32) or 4-byte (bf16) store
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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


// ---------------------------------------------------------------------------
// Resident K/V: every key of a (batch, head) in shared memory at once
// ---------------------------------------------------------------------------

// An item is a (batch, query head) and up to kTiles query tiles of 64
// rows; its padded key range NK (a compile-time instance) fits a stage
// of shared memory whole, K and V^T split and in wgmma's layout. A
// persistent block of three warpgroups takes every gridDim.x-th item:
// one loads items into the stages, two compute on them.
template <typename T, int DP, int NK>
struct Res {
  static constexpr bool kTf32 = sizeof(T) == 4;
  using E = typename std::conditional<kTf32, uint32_t, __nv_bfloat16>::type;
  static constexpr int NH = kTf32 ? 2 : 1;        // hi, lo halves
  static constexpr int EPC = kTf32 ? 4 : 8;       // values per core row
  static constexpr int KSTEP = 2 * EPC;           // MMA depth
  static constexpr int kK = NH * NK * DP;         // K as [keys, DP]
  static constexpr int kV = NH * DP * NK;         // V^T as [DP, keys]
  static constexpr int kSmem = (kK + kV) * sizeof(E);    // a stage
  // two stages where they fit: one is filled while the other is used
  static constexpr int kStages = 2 * kSmem <= 232448 ? 2 : 1;
  static constexpr int kTiles = 4;                // query tiles an item
  static constexpr int GK = 32;                   // keys of P a wgmma group
  static constexpr int kGroups = (NK + GK - 1) / GK;
  // a computing thread's registers, estimated: the logits (NK / 2), the
  // output and the next tile's Q (DP / 2 each), Q's fragments or a group
  // of P, and 24 more (addresses, partial maxima and sums)
  static constexpr int kQFrag = kTf32 ? DP : DP / 4;
  static constexpr int kPGroup = kTf32 ? GK : GK / 4;
  static constexpr int kRegs =
      NK / 2 + DP + (kQFrag > kPGroup ? kQFrag : kPGroup) + 24;
  // setmaxnreg: the computing warpgroups take what they need (at least
  // 192), the loading one the rest of the block's 384 x 168 (its launch
  // bound; asking for more would wait forever)
  static constexpr int kMathRegs = kRegs < 192 ? 192 : (kRegs + 7) / 8 * 8;
  static constexpr int kLoadRegs =
      (384 * 168 - 256 * kMathRegs) / 128 / 8 * 8;
  // core rows of K and of V^T the loading warpgroup holds at once: what
  // its registers allow past the addresses (more for bf16's gathers)
  static constexpr int kLoadBatch =
      (kLoadRegs - (kTf32 ? 40 : 64)) / (2 * EPC);
  // an instance whose loads would come a row at a time loses to the
  // tiled loop (on an H100: bf16 [64, 256, 8, 64] 0.19 ms against 0.11)
  static constexpr bool kFits = NK % KSTEP == 0 && NK <= 256 &&
                                kStages * kSmem <= 232448 &&
                                kRegs <= 232 && kLoadBatch >= 2;
};

// x as it is, but computed from here on: a bound that holds for every
// tile would otherwise be compared with each key once, outside the tile
// loop, and the results held in registers the wgmma chains need
__device__ __forceinline__ int fresh(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// S = Q.K^T for the keys [0, N) of kb: Q's fragments in registers (RS),
// K from shared memory; float32 as lo.hi' + hi.lo' + hi.hi'
template <typename T, int DP, int NK, int N>
__device__ __forceinline__ void qk_chain(
    float (&acc)[N / 2], const uint32_t (&qh)[DP / Res<T, DP, NK>::KSTEP][4],
    const uint32_t (&ql)[DP / Res<T, DP, NK>::KSTEP][4],
    const typename Res<T, DP, NK>::E* kb) {
  using R = Res<T, DP, NK>;
  constexpr int EPC = R::EPC;
#pragma unroll
  for (int s = 0; s < DP / R::KSTEP; ++s) {
    const uint64_t kh = tc::desc(kb + s * 2 * 8 * EPC, 128, 128 * (DP / EPC));
    if constexpr (R::kTf32) {
      const uint64_t kl = tc::desc(kb + NK * DP + s * 2 * 8 * EPC, 128,
                                   128 * (DP / EPC));
      tc::Wgmma<true, true, N>::mma(acc, ql[s], kh, s > 0);
      tc::Wgmma<true, true, N>::mma(acc, qh[s], kl, 1);
      tc::Wgmma<true, true, N>::mma(acc, qh[s], kh, 1);
    } else {
      tc::Wgmma<false, true, N>::mma(acc, qh[s], kh, s > 0);
    }
  }
}

// x = hi + lo as tc::tf32_split, in integer ops: hi rounds to nearest
// (ties away) by its bits, lo = x - hi exactly, its low bits left to the
// tensor cores (which read TF32 operands by truncation); NaN and inf as
// tc::tf32_split gives them
__device__ __forceinline__ void split_bits(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const uint32_t u = __float_as_uint(x);
  hi = (u & 0x7fffffffu) >= 0x7f800000u ? u : (u + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ float ex2(float x) {   // 2^x; 2^-inf = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// named barriers between the producer and consumer warpgroups (0 is
// __syncthreads'): bar.arrive signals without waiting, bar.sync waits
// until the count of threads has arrived or synced
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

template <typename T, int DP, int NK>
__global__ void __launch_bounds__(384, 1)
flash_attention_kernel_resident(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ out, int sq, int sk, int hq,
    int hkv, int d, float scale, int causal, int q_offset, int n_groups,
    int n_items, int vec) {
  using R = Res<T, DP, NK>;
  using E = typename R::E;
  constexpr int EPC = R::EPC;
  constexpr int KSTEP = R::KSTEP;
  constexpr int QS = DP / KSTEP;                  // k-steps of Q.K^T
  constexpr int NP = R::kTf32 ? 1 : 2;            // Q values a fragment word
  constexpr int GS = R::GK / KSTEP;               // k-steps of a P group
  constexpr int kFull = 1, kEmpty = 1 + R::kStages;   // barrier ids
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x % 128;
  const int wg = threadIdx.x / 128;               // 0 loads, 1 and 2 compute
  // this block's items: blockIdx.x, then every gridDim.x-th
  const int n_mine = (n_items - blockIdx.x + gridDim.x - 1) / gridDim.x;
  // item -> batch, query head, first query row
  auto item_at = [&](int i, int& b, int& h, int& r_first) {
    const int item = blockIdx.x + i * gridDim.x;
    const int bh = item / n_groups;
    b = bh / hq;
    h = bh % hq;
    r_first = (item % n_groups) * R::kTiles * 64;
  };

  if (wg == 0) {
    // ---- producer: K and V^T of each item into the next free stage ------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R::kLoadRegs));
    // An item is a core row of K: EPC dims of a key, the same dims of the
    // key 128 / KC further on at the next item (so each thread's
    // addresses step by a constant). Float32 V comes as the same rows and
    // is scattered into V^T's core matrices, its four dims in an order
    // turned by item so a warp's stores fall in more banks; bf16 V^T
    // gathers its core rows. A batch's loads are all in flight before it
    // is split and written as whole core matrices.
    constexpr int KC = DP / EPC;                  // core rows along a key
    static_assert(16 % KC == 0, "items must step by whole keys");
    constexpr int kStep = 128 / KC;               // keys an item further
    constexpr int kItems = NK * KC;               // core rows of K, of V^T
    constexpr int kIters = (kItems + 127) / 128;
    constexpr int kBatch = R::kLoadBatch;         // items held at once
    int j0, k0;
    core_pos<EPC>(tid * EPC, DP, j0, k0);
    const size_t kv_step = static_cast<size_t>(kStep) * hkv * d;
    // TF32: key j sits at position (j & 1) * 4 + (j & 7) / 2 of its 8-key
    // group, so the S accumulator's keys (2t, 2t + 1) feed P.V's (t, t + 4)
    const int pos0 = (j0 & ~7) | ((j0 & 1) << 2) | ((j0 & 7) >> 1);
    int v_at[4];                                  // V^T words at item 0
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int dim = k0 + ((r + (k0 >> 3)) & 3);
      v_at[r] = ((dim / 8) * (NK / 4) + pos0 / 4) * 32 + (dim % 8) * 4 +
                pos0 % 4;
    }
    for (int i = 0; i < n_mine; ++i) {
      const int stage = i % R::kStages;
      E* s_k = reinterpret_cast<E*>(smem) + stage * (R::kK + R::kV);
      E* s_v = s_k + R::kK;
      int b, h, r_first;
      item_at(i, b, h, r_first);
      const int hk = h / (hq / hkv);
      const int r_last = min(sq, r_first + R::kTiles * 64) - 1;
      // keys some row of the item reads; zero from there to NK
      const int k_need =
          causal ? min(sk, max(r_last + q_offset + 1, 0)) : sk;
      const size_t kv_base = static_cast<size_t>(b) * sk * hkv + hk;
      const T* k_row =
          k + (kv_base + static_cast<size_t>(j0) * hkv) * d + k0;
      const T* v_row = v + (k_row - k);
      if (i >= R::kStages) bar_sync(kEmpty + stage, 384);
      for (int i0 = 0; i0 < kIters; i0 += kBatch) {
        float xk[kBatch][EPC], xv[kBatch][EPC];
#pragma unroll
        for (int n = 0; n < kBatch; ++n) {
#pragma unroll
          for (int e = 0; e < EPC; ++e) xk[n][e] = xv[n][e] = 0.0f;
          const int j = j0 + kStep * (i0 + n);
          if (i0 + n >= kIters || j >= k_need) continue;
          const size_t at = kv_step * (i0 + n);
          if ((vec & 1) && k0 + EPC <= d) {
            load_row<T, EPC>(k_row + at, xk[n]);
            if constexpr (R::kTf32) load_row<T, EPC>(v_row + at, xv[n]);
          } else {
#pragma unroll
            for (int e = 0; e < EPC; ++e) {
              if (k0 + e < d) {
                xk[n][e] = to_f32(k_row[at + e]);
                if constexpr (R::kTf32) xv[n][e] = to_f32(v_row[at + e]);
              }
            }
          }
        }
        if constexpr (!R::kTf32) {
#pragma unroll
          for (int n = 0; n < kBatch; ++n) {
            const int u = tid + 128 * (i0 + n);
            if (i0 + n >= kIters || u >= kItems) continue;
            int dim, p0;
            core_pos<EPC>(u * EPC, NK, dim, p0);  // V^T: dim, keys p0..
#pragma unroll
            for (int e = 0; e < EPC; ++e) {
              if (p0 + e < k_need && dim < d) {
                xv[n][e] = to_f32(
                    v[(kv_base + static_cast<size_t>(p0 + e) * hkv) * d +
                      dim]);
              }
            }
          }
        }
#pragma unroll
        for (int n = 0; n < kBatch; ++n) {
          const int u = tid + 128 * (i0 + n);
          if (i0 + n >= kIters || u >= kItems) continue;
          if constexpr (R::kTf32) {
            uint4 h, l;
            split_bits(xk[n][0], h.x, l.x);
            split_bits(xk[n][1], h.y, l.y);
            split_bits(xk[n][2], h.z, l.z);
            split_bits(xk[n][3], h.w, l.w);
            *reinterpret_cast<uint4*>(s_k + u * EPC) = h;
            *reinterpret_cast<uint4*>(s_k + NK * DP + u * EPC) = l;
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              // selects, not xv[n][e]: a register array indexed at run
              // time would live in local memory
              const int e = (r + (k0 >> 3)) & 3;
              const float x = e == 0   ? xv[n][0]
                              : e == 1 ? xv[n][1]
                              : e == 2 ? xv[n][2]
                                       : xv[n][3];
              uint32_t hi, lo;
              split_bits(x, hi, lo);
              const int w = v_at[r] + 8 * kStep * (i0 + n);
              s_v[w] = hi;
              s_v[DP * NK + w] = lo;
            }
          } else {
            put_row<EPC>(s_k, s_k + NK * DP, u * EPC, xk[n]);
            put_row<EPC>(s_v, s_v + DP * NK, u * EPC, xv[n]);
          }
        }
      }
      tc::fence_proxy_async();
      bar_arrive(kFull + stage, 384);
    }
    return;
  }

  // ---- consumers: warpgroup cw takes tiles cw and cw + 2 of each item -----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R::kMathRegs));
  const int cw = wg - 1;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  // logits in base 2: exp(x) = exp2(x log2(e)), one MUFU.EX2 each; float32
  // takes the factor into Q before its split, bf16 (whose Q would round)
  // onto the logits
  const float scale_log2 = scale * 1.4426950408889634f;

  // Q's A fragments, as values: TF32 k8 (row, k t), (row + 8, k t), (row,
  // k t + 4), (row + 8, t + 4); bf16 k16 the pairs (2t, 2t + 1) and (2t +
  // 8, 2t + 9) in the same order. The next tile's are read while this
  // tile's products and softmax run.
  float qr[QS][4][NP];
  auto read_q = [&](size_t q_head, int q0) {
    const int rw = q0 + 16 * warp + gq;
#pragma unroll
    for (int s = 0; s < QS; ++s) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = rw + 8 * (e & 1);
        const T* src = q + (q_head + static_cast<size_t>(row) * hq) * d;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int dim = R::kTf32 ? 8 * s + tq + 4 * (e >> 1)
                                   : 16 * s + 2 * tq + 8 * (e >> 1) + p;
          qr[s][e][p] = row < sq && dim < d ? to_f32(src[dim]) : 0.0f;
        }
      }
    }
  };
  // the tiles this warpgroup takes, in order: (item i, tile t)
  auto has_tile = [&](int i, int t) {
    if (n_groups == 1) return 64 * t < sq;        // every item alike
    int b, h, r_first;
    item_at(i, b, h, r_first);
    return r_first + 64 * t < sq;
  };
  auto advance = [&](int& i, int& t) {
    do {
      t += 2;
      if (t >= R::kTiles || !has_tile(i, t)) {
        ++i;
        t = cw;
      }
    } while (i < n_mine && !has_tile(i, t));
  };
  auto tile_q = [&](int i, int t, size_t& q_head, int& q0) {
    int b, h, r_first;
    item_at(i, b, h, r_first);
    q_head = static_cast<size_t>(b) * sq * hq + h;
    q0 = r_first + 64 * t;
  };

  int next_i = 0, next_t = cw;
  if (!has_tile(0, cw)) advance(next_i, next_t);
  if (next_i < n_mine) {
    size_t q_head;
    int q0;
    tile_q(next_i, next_t, q_head, q0);
    read_q(q_head, q0);
  }
  for (int it = 0; it < n_mine; ++it) {
    const int stage = it % R::kStages;
    const E* s_k = reinterpret_cast<const E*>(smem) +
                   stage * (R::kK + R::kV);
    const E* s_v = s_k + R::kK;
    bar_sync(kFull + stage, 384);
    while (next_i == it) {
      size_t q_head;
      int q0;
      tile_q(next_i, next_t, q_head, q0);
      advance(next_i, next_t);
      const int rw = q0 + 16 * warp + gq;   // this thread's rows rw, rw + 8
      const int k_t =
          causal ? min(sk, max(min(q0 + 64, sq) - 1 + q_offset + 1, 0)) : sk;
      uint32_t qh[QS][4], ql[QS][4];
#pragma unroll
      for (int s = 0; s < QS; ++s) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (R::kTf32) {
            split_bits(qr[s][e][0] * scale_log2, qh[s][e], ql[s][e]);
          } else {
            qh[s][e] = pack_bf16(qr[s][e][0], qr[s][e][1]);
            ql[s][e] = 0u;
          }
        }
        tc::fence_regs(qh[s]);
        if constexpr (R::kTf32) tc::fence_regs(ql[s]);
      }

      // ---- S = Q.K^T: one chain of 64-key wgmmas over every key ----------
      // (no wgmma here or below is issued conditionally: ptxas serializes
      // a chain with branches in it; padded keys are zero and masked)
      float s_acc[NK / 2];
#pragma unroll
      for (int i = 0; i < NK / 2; ++i) s_acc[i] = 0.0f;
      tc::fence_regs(s_acc);
      tc::fence();
#pragma unroll
      for (int c = 0; c < NK / 64; ++c) {
        qk_chain<T, DP, NK, 64>(
            reinterpret_cast<float(&)[32]>(s_acc[32 * c]), qh, ql,
            s_k + 64 * c * DP);
      }
      if constexpr (NK % 64 != 0) {
        constexpr int c = NK / 64;
        qk_chain<T, DP, NK, NK % 64>(
            reinterpret_cast<float(&)[NK % 64 / 2]>(s_acc[32 * c]), qh, ql,
            s_k + 64 * c * DP);
      }
      tc::commit();
      tc::wait<0>();
      tc::fence_regs(s_acc);
      if (next_i < n_mine) {
        size_t qh_next;
        int q0_next;
        tile_q(next_i, next_t, qh_next, q0_next);
        read_q(qh_next, q0_next);
      }

      // ---- exact softmax in registers: the whole row is here --------------
      // each thread holds 2 rows x NK / 4 logits; rows meet in two shuffles;
      // maxima and sums run four ways, so their chains are short
      float l_row[2] = {0.0f, 0.0f};
      if (q0 + 16 * warp < sq) {      // a warp of padding rows skips it
        // key < lim[row]: the keys present, and with a causal mask those
        // up to the row's position; the thread's keys 2t, 2t + 1 of each
        // group of 8 compare as 8 (i / 4) + i % 2 < lim - 2t
        int lim[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          lim[hh] = fresh(causal ? min(k_t, rw + 8 * hh + q_offset + 1) : k_t)
                    - 2 * tq;
        }
        float mp[2][4], lp[2][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          mp[i / 4][i % 4] = -INFINITY;
          lp[i / 4][i % 4] = 0.0f;
        }
        if (!causal && k_t > NK - 8) {
          // every key present but some of the last 8 (Sk padded to NK
          // inside one group, the usual case): only those are compared
#pragma unroll
          for (int i = 0; i < NK / 2; ++i) {
            const int hh = (i / 2) % 2;
            const float x = R::kTf32 ? s_acc[i] : s_acc[i] * scale_log2;
            s_acc[i] = i < NK / 2 - 4 || 8 * (i / 4) + i % 2 < lim[hh]
                           ? x : -INFINITY;
            mp[hh][(i / 4) % 4] = fmaxf(mp[hh][(i / 4) % 4], s_acc[i]);
          }
        } else {
#pragma unroll
          for (int i = 0; i < NK / 2; ++i) {
            const int hh = (i / 2) % 2;
            const float x = R::kTf32 ? s_acc[i] : s_acc[i] * scale_log2;
            s_acc[i] = 8 * (i / 4) + i % 2 < lim[hh] ? x : -INFINITY;
            mp[hh][(i / 4) % 4] = fmaxf(mp[hh][(i / 4) % 4], s_acc[i]);
          }
        }
        float m[2];
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          m[hh] = fmaxf(fmaxf(mp[hh][0], mp[hh][1]),
                        fmaxf(mp[hh][2], mp[hh][3]));
          m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
          m[hh] = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 2));
          if (m[hh] == -INFINITY) m[hh] = 0.0f;     // no key: p = 0
        }
#pragma unroll
        for (int i = 0; i < NK / 2; ++i) {
          const int hh = (i / 2) % 2;
          s_acc[i] = ex2(s_acc[i] - m[hh]);
          lp[hh][(i / 4) % 4] += s_acc[i];
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          l_row[hh] = (lp[hh][0] + lp[hh][1]) + (lp[hh][2] + lp[hh][3]);
          l_row[hh] += __shfl_xor_sync(0xffffffffu, l_row[hh], 1);
          l_row[hh] += __shfl_xor_sync(0xffffffffu, l_row[hh], 2);
        }
      }

      // ---- O = P.V: P split in registers (RS), GK keys a group of wgmmas
      float o_acc[DP / 2];
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o_acc[i] = 0.0f;
      tc::fence_regs(o_acc);
      uint32_t ph[R::kGroups][GS][4], pl[R::kGroups][GS][4];
#pragma unroll
      for (int g = 0; g < R::kGroups; ++g) {
#pragma unroll
        for (int j = 0; j < GS; ++j) {
          const int st = g * GS + j;                // k-step: keys st * KSTEP..
          if (st * KSTEP >= NK) continue;
          if constexpr (R::kTf32) {
            // fragment (row, key t), (row + 8, t), (row, t + 4), (row + 8,
            // t + 4) <- accumulator keys 2t, 2t, 2t + 1, 2t + 1. P in [0, 1]:
            // hi is P's TF32 part (truncated), lo = P - hi exactly, and the
            // tensor cores take lo's TF32 part: 2^-20 of P at worst
            const int ord[4] = {0, 2, 1, 3};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float x = s_acc[4 * st + ord[e]];
              const uint32_t hi = __float_as_uint(x) & 0xffffe000u;
              ph[g][j][e] = hi;
              pl[g][j][e] = __float_as_uint(x - __uint_as_float(hi));
            }
            tc::fence_regs(pl[g][j]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              ph[g][j][e] = pack_bf16(s_acc[8 * st + 2 * e],
                                      s_acc[8 * st + 2 * e + 1]);
            }
          }
          tc::fence_regs(ph[g][j]);
        }
        tc::fence();
#pragma unroll
        for (int j = 0; j < GS; ++j) {
          const int st = g * GS + j;
          if (st * KSTEP >= NK) continue;
          const uint64_t vh = tc::desc(s_v + st * 2 * 8 * EPC, 128,
                                       128 * (NK / EPC));
          if constexpr (R::kTf32) {
            const uint64_t vl = tc::desc(s_v + DP * NK + st * 2 * 8 * EPC, 128,
                                         128 * (NK / EPC));
            tc::Wgmma<true, true, DP>::mma(o_acc, pl[g][j], vh, 1);
            tc::Wgmma<true, true, DP>::mma(o_acc, ph[g][j], vl, 1);
            tc::Wgmma<true, true, DP>::mma(o_acc, ph[g][j], vh, 1);
          } else {
            tc::Wgmma<false, true, DP>::mma(o_acc, ph[g][j], vh, 1);
          }
        }
        tc::commit();
        // the group has read its registers before the next is split (two
        // groups in flight ran no faster on an H100, held more registers)
        tc::wait<0>();
#pragma unroll
        for (int j = 0; j < GS; ++j) {
          tc::fence_regs(ph[g][j]);
          if constexpr (R::kTf32) tc::fence_regs(pl[g][j]);
        }
      }
      tc::fence_regs(o_acc);

      // ---- epilogue --------------------------------------------------------
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = rw + 8 * hh;
        if (row >= sq) continue;
        const float inv = 1.0f / (l_row[hh] > 0.0f ? l_row[hh] : 1.0f);
        T* orow = out + (q_head + static_cast<size_t>(row) * hq) * d;
#pragma unroll
        for (int qd = 0; qd < DP / 8; ++qd) {
          const int dim = 8 * qd + 2 * tq;
          const float a = o_acc[4 * qd + 2 * hh] * inv;
          const float c = o_acc[4 * qd + 2 * hh + 1] * inv;
          if ((vec & 2) && dim + 1 < d) {
            store2(orow + dim, a, c);
          } else {
            if (dim < d) store(orow + dim, a);
            if (dim + 1 < d) store(orow + dim + 1, c);
          }
        }
      }
    }
    // its wgmmas have all been waited for: the stage may be refilled
    if (it + R::kStages < n_mine) bar_arrive(kEmpty + stage, 384);
  }
}

// The padded key count of the resident instance that takes Sk keys at
// head width DP, or 0 (the tiled loop): one 64-key wgmma, two, the
// ViT's 197 tokens (196 patches and the CLS token) at the MMA depth, or
// the widest wgmma, the first that holds Sk and fits (Res::kFits).
template <typename T, int DP>
constexpr int vit_keys() {
  return (197 + Res<T, DP, 64>::KSTEP - 1) / Res<T, DP, 64>::KSTEP *
         Res<T, DP, 64>::KSTEP;
}

template <typename T, int DP>
int resident_keys(int sk) {
  constexpr int kVit = vit_keys<T, DP>();
  if (sk < 1) return 0;
  if (sk <= 64 && Res<T, DP, 64>::kFits) return 64;
  if (sk <= 128 && Res<T, DP, 128>::kFits) return 128;
  if (sk <= kVit && Res<T, DP, kVit>::kFits) return kVit;
  if (sk <= 256 && Res<T, DP, 256>::kFits) return 256;
  return 0;
}

template <typename T, int DP, int NK>
cudaError_t launch_resident(const void* q, const void* k, const void* v,
                            void* out, int batch, int sq, int sk, int hq,
                            int hkv, int d, float scale, int causal,
                            int q_offset, cudaStream_t stream) {
  using R = Res<T, DP, NK>;
  if constexpr (!R::kFits) {
    return cudaErrorInvalidValue;
  } else {
    constexpr int kSmem = R::kStages * R::kSmem;
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel_resident<T, DP, NK>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    int dev = 0, n_sm = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return err;
    const int n_tiles = (sq + 63) / 64;
    const int n_groups = (n_tiles + R::kTiles - 1) / R::kTiles;
    const long long n_items = static_cast<long long>(batch) * hq * n_groups;
    if (n_items > 0x7fffffffLL) return cudaErrorInvalidValue;
    // bit 0: K and V rows as 16-byte loads; bit 1: outputs in pairs
    const int vec =
        ((d * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(v) % 16 == 0) |
        (d % 2 == 0 && reinterpret_cast<uintptr_t>(out) % (2 * sizeof(T)) == 0)
            << 1;
    // persistent: one block an SM, each taking every n_sm-th item
    const int blocks = static_cast<int>(n_items < n_sm ? n_items : n_sm);
    flash_attention_kernel_resident<T, DP, NK>
        <<<blocks, 384, kSmem, stream>>>(
            static_cast<const T*>(q), static_cast<const T*>(k),
            static_cast<const T*>(v), static_cast<T*>(out), sq, sk, hq, hkv,
            d, scale, causal, q_offset, n_groups,
            static_cast<int>(n_items), vec);
    return cudaGetLastError();
  }
}

template <typename T, int DP>
cudaError_t dispatch_resident(int nk, const void* q, const void* k,
                              const void* v, void* out, int batch, int sq,
                              int sk, int hq, int hkv, int d, float scale,
                              int causal, int q_offset,
                              cudaStream_t stream) {
#define REPRO_RESIDENT(NK)                                                  \
  return launch_resident<T, DP, NK>(q, k, v, out, batch, sq, sk, hq, hkv, d, \
                                    scale, causal, q_offset, stream)
  constexpr int kVit = vit_keys<T, DP>();
  switch (nk) {
    case 64: REPRO_RESIDENT(64);
    case 128: REPRO_RESIDENT(128);
    case kVit: REPRO_RESIDENT(kVit);
    case 256: REPRO_RESIDENT(256);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_RESIDENT
}

// the resident instance's head width for D, or 0 (tiled past 64)
inline int resident_dp(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : 0; }

template <typename T>
int resident_keys_for(int sk, int d) {
  const int dp = resident_dp(d);
  return dp == 32 ? resident_keys<T, 32>(sk)
         : dp == 64 ? resident_keys<T, 64>(sk) : 0;
}

// The resident instance where one takes Sk and D; else the tiled loop
// at the narrowest padded head dim DP >= D with an instance: a multiple
// of the MMA depth (8 for TF32, 16 for bf16).
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v,
                     void* out, int batch, int sq, int sk, int hq, int hkv,
                     int d, float scale, int causal, int q_offset,
                     cudaStream_t stream) {
  const int nk = resident_keys_for<T>(sk, d);
  if (nk > 0) {
    return resident_dp(d) == 32
               ? dispatch_resident<T, 32>(nk, q, k, v, out, batch, sq, sk,
                                          hq, hkv, d, scale, causal,
                                          q_offset, stream)
               : dispatch_resident<T, 64>(nk, q, k, v, out, batch, sq, sk,
                                          hq, hkv, d, scale, causal,
                                          q_offset, stream);
  }
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

// The padded key count the launcher holds resident for Sk keys at head
// dim D (0: the tiled loop), so a caller can see which path it took.
REPRO_EXTERN int flash_attention_resident_keys(int sk, int d, int is_bf16) {
  if (d < 1 || d > kMaxD) return 0;
  return is_bf16 ? resident_keys_for<__nv_bfloat16>(sk, d)
                 : resident_keys_for<float>(sk, d);
}
