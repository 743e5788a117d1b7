// The float32 linears of the port's models as one kernel:
// y = act(x @ w + b) for x [M, K], w [K, N], b [N] or none, and act the
// identity or the tanh GELU (models/layers.linear, and the MLP's
// up-projection with its GELU).
//
// Replaces no `pallas_call`: the JAX package left these dots to XLA,
// and the port ran them as cuBLAS's float32 SIMT GEMMs (TF32 off), a
// separate broadcast add for the bias and a separate GELU pass.
//
// What bounds it on an H100: at Swin-B's shapes (K 128-4,096, N
// 128-4,096, M ~10^5 rows) arithmetic, by far; at the ViT's d = 192
// (K = N = 192) operations and bytes nearly balance (M = 907,776: 0.41 ms
// of split-TF32 work, 0.42 ms of x read and y written). Plain TF32 keeps
// too few bits for the detector's 1e-4 limit, so the product runs in
// split TF32 (wgmma.cuh: hi.hi' + hi.lo' + lo.hi', three TF32 products
// per k-step), a third of the TF32 rate, and never in one TF32 product.
//
// Design:
// - A pre-pass (`dense_split_kernel`, one launch) rounds w into TF32 hi
//   and lo halves, transposed into the K-major 8 x 4 core matrices wgmma
//   reads (TF32 wgmma takes K-major operands only; w is N-major), tile
//   by tile and 16-deep K chunk by chunk, zero past K and N, so one
//   (N tile, K chunk) of both halves is one contiguous block. The buffer
//   (2 |w| rounded up to whole tiles) belongs to the call.
// - Persistent blocks, one per SM, walk the 128 x NT output tiles with
//   the N tile fastest, so the blocks in flight share x's rows in L2.
//   Each block is two consumer warpgroups (64 rows each) and one
//   producer warp, over a ring of shared-memory stages, each guarded by
//   a full and an empty mbarrier. The producer's one thread asks the TMA
//   unit for each stage: x's 128 x 16 tile by a 2-d tensor map (zero
//   past M and K, rows swizzled in 16-byte chunks so the fragment reads
//   meet no bank conflicts) and the weight block by one bulk copy; where
//   x's rows are not 16-byte aligned (K % 4 != 0) the producer's lanes
//   copy x in 4-byte cp.asyncs to the same swizzled places. It runs
//   ahead into the next tile while the consumers finish the last one, so
//   a tile's epilogue overlaps the next tile's loads.
// - A comes from registers: each consumer thread reads its wgmma A
//   fragment from the stage, splits it into TF32 hi and lo and runs
//   `wgmma m64nNk8` RS three times per k-step; one group stays in flight
//   while the next fragment is read.
// - The tensor cores' accumulating adds truncate, so one running sum over
//   K = 4,096 drifts by ~2e-4 on outputs of order 1. Each warpgroup sums
//   a slab of kSlab K chunks on the tensor cores (the first product of a
//   slab overwrites the accumulators), then adds it to the tile's sum in
//   registers, rounding to nearest; the two warpgroups end their slabs
//   half a slab apart, so one drains while the other keeps the tensor
//   cores busy. The two register sums cap the N tile at 128.
// - The N tile (64, 96 or 128; ops.n_tile) is chosen from N by the
//   wrapper: the fewest padded columns, then the widest tile (the ViT's
//   192 columns are two tiles of 96, Swin's 128-4,096 tiles of 128).
// - The epilogue adds the bias and applies the GELU to the sums and
//   writes y once, straight from registers.
// Sums run over K in a fixed order for each half of a tile: the two
// warpgroups end their slabs at different chunks, so a row's rounding
// depends on the half of its 128-row tile it falls in (its index mod
// 128 below or above 64), and on nothing else of M or of the tile.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kBM = 128;              // rows per tile: two warpgroups of 64
constexpr int kKC = 16;               // K depth of one stage: two k8 steps
constexpr int kConsumerWarps = 8;
constexpr int kThreads = kConsumerWarps * 32 + 32;   // + the producer
constexpr int kSlab = 4;              // K chunks summed on the tensor cores
constexpr int kMaxStages = 8;
constexpr int kSmemLimit = 232448;
constexpr int kAlign = 1024;          // the swizzle's period and more

// a stage: kBM rows of x's K chunk (64 bytes a row, its 16-byte chunk c
// at c ^ (row / 2 % 4): the TMA's 64-byte swizzle), then the weight block
// ([hi, lo][NT / 8][kKC / 4][8][4]); a multiple of kAlign bytes
constexpr int kAFloats = kBM * kKC;
template <int NT>
__host__ __device__ constexpr int b_floats() {
  return 2 * NT * kKC;
}
template <int NT>
__host__ __device__ constexpr int stage_floats() {
  return kAFloats + b_floats<NT>();
}
// the stages that fit beside the alignment slack, each with its full and
// empty barrier (16 bytes)
template <int NT>
__host__ __device__ constexpr int n_stages() {
  constexpr int fit = (kSmemLimit - kAlign) / (4 * stage_floats<NT>() + 16);
  return fit < kMaxStages ? fit : kMaxStages;
}
template <int NT>
constexpr size_t smem_bytes() {
  return kAlign +
         static_cast<size_t>(n_stages<NT>()) * (4 * stage_floats<NT>() + 16);
}
// the float of (row, k) in a stage's x tile
__host__ __device__ constexpr int a_index(int row, int k) {
  return row * kKC + (((k / 4) ^ ((row >> 1) & 3)) * 4) + k % 4;
}

// ---- mbarriers (CUTLASS's cutlass/arch/barrier.h) ----------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   tc::smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   tc::smem_addr(bar)) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(tc::smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}
// until the phase of parity `parity` has completed; a wait past ~10 s
// at the card's clock is a fault in the pipeline, and traps (the launch
// fails) rather than hang the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - start > 20000000000LL) __trap();
  }
  __syncwarp();
}
// arrive on `bar` once all of this thread's cp.async so far have landed
// (the barrier's count includes the arrival: .noinc)
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   tc::smem_addr(bar)) : "memory");
}
// arrive on `bar` and expect `bytes` more to land through the async
// proxy (a bulk copy's complete_tx) before its phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(tc::smem_addr(bar)), "r"(bytes) : "memory");
}
// one bulk copy (the TMA unit, 1-d) of `bytes` (a multiple of 16, both
// ends 16-byte aligned), global -> shared, completing on `bar`
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(tc::smem_addr(dst)), "l"(src),
      "r"(bytes), "r"(tc::smem_addr(bar)) : "memory");
}
// one 2-d tile through a tensor map, at (column c0, row c1), completing
// on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(tc::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(tc::smem_addr(bar)) : "memory");
}
// cp.async of `bytes` (4 or 0) bytes, the rest zero-filled
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   tc::smem_addr(dst)), "l"(src), "r"(bytes) : "memory");
}

// F.gelu(x, approximate="tanh") as PyTorch computes it
__device__ __forceinline__ float gelu_tanh(float x) {
  const float kBeta = 0.7978845608028654f;   // sqrt(2 / pi)
  const float kKappa = 0.044715f;
  const float inner = kBeta * (x + kKappa * (x * x * x));
  return 0.5f * x * (1.0f + tanhf(inner));
}

// ---- the pre-pass: w -> [N tiles][K chunks][hi, lo][NT/8][kKC/4][8][4] --
template <int NT>
__global__ void dense_split_kernel(const float* __restrict__ w,
                                   float* __restrict__ wsplit, int K, int N,
                                   int k_chunks, int n_pad) {
  // one thread per (4 consecutive k, n): reads coalesced along n, writes
  // 16 bytes of each half (8 threads fill one core matrix)
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= static_cast<long long>(k_chunks) * (kKC / 4) * n_pad) return;
  const int n = static_cast<int>(idx % n_pad);
  const int k4 = static_cast<int>(idx / n_pad);
  float hi[4], lo[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int k = 4 * k4 + c;
    const float v =
        (k < K && n < N) ? w[static_cast<size_t>(k) * N + n] : 0.0f;
    uint32_t h, l;
    tc::tf32_split(v, h, l);
    hi[c] = __uint_as_float(h);
    lo[c] = __uint_as_float(l);
  }
  const int nl = n % NT;
  float* dst = wsplit +
               static_cast<size_t>(n / NT * k_chunks + k4 / (kKC / 4)) *
                   b_floats<NT>() +
               ((nl / 8) * (kKC / 4) + k4 % (kKC / 4)) * 32 + (nl % 8) * 4;
  *reinterpret_cast<float4*>(dst) = make_float4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<float4*>(dst + NT * kKC) =
      make_float4(lo[0], lo[1], lo[2], lo[3]);
}

// ---- the producer warp --------------------------------------------------
template <int NT>
__device__ __forceinline__ void produce(
    const CUtensorMap* xmap, const float* __restrict__ x,
    const float* __restrict__ wsplit, float* ring, uint64_t* full,
    uint64_t* empty, long long M, int K, int k_chunks, int n_tiles,
    long long n_work, bool tma_x, int lane) {
  constexpr int S = n_stages<NT>();
  constexpr uint32_t kBBytes = 4 * b_floats<NT>();
  int s = 0, phase = 0;
  for (long long tile = blockIdx.x; tile < n_work; tile += gridDim.x) {
    const long long m0 = tile / n_tiles * kBM;
    const float* wt = wsplit + static_cast<size_t>(tile % n_tiles) *
                                   k_chunks * b_floats<NT>();
    for (int c = 0; c < k_chunks; ++c) {
      // a fresh barrier's phase of parity 1 counts as completed
      mbar_wait(&empty[s], phase ^ 1);
      float* st = ring + s * stage_floats<NT>();
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[s], kBBytes + (tma_x ? 4 * kAFloats : 0));
        bulk_copy(st + kAFloats, wt + static_cast<size_t>(c) * b_floats<NT>(),
                  kBBytes, &full[s]);
        if (tma_x) {
          tma_load_2d(st, xmap, c * kKC, static_cast<int>(m0), &full[s]);
        }
      }
      if (!tma_x) {
        for (int i = lane; i < kAFloats; i += 32) {
          const int r = i / kKC;
          const int col = c * kKC + i % kKC;
          const bool in = m0 + r < M && col < K;
          cp_async4_zfill(st + a_index(r, i % kKC),
                          in ? x + (m0 + r) * K + col : x, in ? 4 : 0);
        }
        cp_async_arrive(&full[s]);
      }
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
    }
  }
}

// ---- the consumer warpgroups --------------------------------------------
template <int NT, bool kGelu>
__device__ __forceinline__ void consume(
    const float* __restrict__ bias, float* __restrict__ out,
    const float* ring, uint64_t* full, uint64_t* empty, long long M, int N,
    int k_chunks, int n_tiles, long long n_work, int warp, int lane) {
  constexpr int S = n_stages<NT>();
  const int g = lane / 4;
  const int t = lane % 4;
  // the thread's first fragment row within the tile (the other is + 8)
  const int wrow = (warp / 4) * 64 + (warp % 4) * 16 + g;
  // the warpgroups flush half a slab apart, so one drains while the
  // other's products keep the tensor cores busy (the index through a
  // shuffle: the compiler then knows it is the same across the warp, and
  // the wgmmas stay pipelined past the slab's branch)
  const int offset = __shfl_sync(0xffffffffu, warp / 4, 0) * (kSlab / 2);
  auto release = [&](int stage) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  };
  int s = 0, phase = 0;
  int pending = -1;   // the stage the newest in-flight products read
  float part[NT / 2];             // the slab's sum, on the tensor cores
  float sum[NT / 2];              // the tile's, by round-to-nearest adds
  uint32_t frag[kKC / 8][2][4];   // [k step][hi, lo][fragment]
  for (long long tile = blockIdx.x; tile < n_work; tile += gridDim.x) {
    const long long m0 = tile / n_tiles * kBM;
    const int n0 = static_cast<int>(tile % n_tiles) * NT;
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) sum[i] = 0.0f;
    int fresh = 1;    // the next product starts a slab: it overwrites part
    for (int c = 0; c < k_chunks; ++c) {
      mbar_wait(&full[s], phase);
      const float* st = ring + s * stage_floats<NT>();
      const float* sb = st + kAFloats;
#pragma unroll
      for (int ks = 0; ks < kKC / 8; ++ks) {
        uint32_t(&a)[2][4] = frag[ks];
        // fragment order: (row, k t), (row + 8, k t), (row, k t + 4),
        // (row + 8, k t + 4)
        const float v[4] = {st[a_index(wrow, 8 * ks + t)],
                            st[a_index(wrow + 8, 8 * ks + t)],
                            st[a_index(wrow, 8 * ks + t + 4)],
                            st[a_index(wrow + 8, 8 * ks + t + 4)]};
#pragma unroll
        for (int j = 0; j < 4; ++j) tc::tf32_split(v[j], a[0][j], a[1][j]);
        tc::fence_regs(a[0]);
        tc::fence_regs(a[1]);
        tc::fence();
        const uint64_t b_hi = tc::desc(sb + 64 * ks, 128, 128 * (kKC / 4));
        const uint64_t b_lo =
            tc::desc(sb + NT * kKC + 64 * ks, 128, 128 * (kKC / 4));
        // small terms first
        tc::Wgmma<true, true, NT>::mma(part, a[1], b_hi, ks > 0 || !fresh);
        tc::Wgmma<true, true, NT>::mma(part, a[0], b_lo, 1);
        tc::Wgmma<true, true, NT>::mma(part, a[0], b_hi, 1);
        tc::commit();
        // all but this k-step's products are done: the other fragment
        // registers are free, and at ks = 0 the previous stage is too
        tc::wait<1>();
        if (ks == 0 && pending >= 0) release(pending);
      }
      fresh = 0;
      pending = s;
      if (++s == S) {
        s = 0;
        phase ^= 1;
      }
      // the slab ends: its products done, its sum added to the tile's.
      // The tensor cores' adds truncate; a slab of kSlab chunks keeps
      // that error to a slab's partial sums (K = 4,096: ~1e-5 on outputs
      // of order 1, where one running sum drifts by ~2e-4).
      if ((c + offset) % kSlab == kSlab - 1 || c == k_chunks - 1) {
        tc::wait<0>();
        tc::fence_regs(part);
        release(pending);
        pending = -1;
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) sum[i] += part[i];
        fresh = 1;
      }
    }

    // ---- epilogue: + bias, GELU, straight from the registers ----------
    // element 4 q + 2 h + e sits at row wrow + 8 h, column 8 q + 2 t + e
#pragma unroll
    for (int q = 0; q < NT / 8; ++q) {
      const int col = n0 + 8 * q + 2 * t;
      if (col >= N) continue;
      const bool pair = col + 1 < N;
      float b0 = 0.0f, b1 = 0.0f;
      if (bias != nullptr) {
        b0 = __ldg(bias + col);
        if (pair) b1 = __ldg(bias + col + 1);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = m0 + wrow + 8 * h;
        if (r >= M) continue;
        float v0 = sum[4 * q + 2 * h] + b0;
        float v1 = sum[4 * q + 2 * h + 1] + b1;
        if (kGelu) {
          v0 = gelu_tanh(v0);
          v1 = gelu_tanh(v1);
        }
        float* dst = out + r * N + col;
        if (pair && N % 2 == 0) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          dst[0] = v0;
          if (pair) dst[1] = v1;
        }
      }
    }
  }
}

template <int NT, bool kGelu>
__global__ void __launch_bounds__(kThreads, 1) dense_kernel(
    const __grid_constant__ CUtensorMap xmap, const float* __restrict__ x,
    const float* __restrict__ wsplit, const float* __restrict__ bias,
    float* __restrict__ out, long long M, int K, int N, int k_chunks,
    int n_tiles, long long n_work, int tma_x) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int S = n_stages<NT>();
  unsigned char* smem = smem_raw + ((kAlign - tc::smem_addr(smem_raw) %
                                     kAlign) % kAlign);
  float* ring = reinterpret_cast<float*>(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + static_cast<size_t>(S) * 4 * stage_floats<NT>());
  uint64_t* empty = full + S;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      // the TMA's arrival, or the producer's lanes' cp.asyncs beside it
      mbar_init(&full[i], tma_x ? 1 : 33);
      mbar_init(&empty[i], kConsumerWarps);    // one arrival per warp
    }
    fence_barrier_init();
  }
  __syncthreads();
  if (warp == kConsumerWarps) {
    produce<NT>(&xmap, x, wsplit, ring, full, empty, M, K, k_chunks,
                n_tiles, n_work, tma_x != 0, lane);
  } else {
    consume<NT, kGelu>(bias, out, ring, full, empty, M, N, k_chunks,
                       n_tiles, n_work, warp, lane);
  }
}

// x [M, K] as a 2-d tensor map of 128 x 16 tiles, swizzled in 64-byte
// rows; false where cuTensorMapEncodeTiled is missing or refuses the map
bool x_tensor_map(CUtensorMap* map, const float* x, long long M, int K) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess || fn == nullptr) {
      return false;
    }
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 4};
  const cuuint32_t box[2] = {kKC, kBM};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(x), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  return n;
}

template <int NT>
cudaError_t launch_tiles(const float* x, const float* w, const float* bias,
                         float* wsplit, float* out, long long M, int K,
                         int N, int gelu, int vec, cudaStream_t stream) {
  CUtensorMap xmap = {};
  if (vec && !x_tensor_map(&xmap, x, M, K)) return cudaErrorInvalidValue;
  const int k_chunks = (K + kKC - 1) / kKC;
  const int n_tiles = (N + NT - 1) / NT;
  const long long n_split = static_cast<long long>(k_chunks) * (kKC / 4) *
                            n_tiles * NT;
  if (n_split > 0) {
    const long long blocks = (n_split + 255) / 256;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    dense_split_kernel<NT><<<static_cast<unsigned>(blocks), 256, 0,
                             stream>>>(w, wsplit, K, N, k_chunks,
                                       n_tiles * NT);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long n_work = (M + kBM - 1) / kBM * n_tiles;
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const int grid = static_cast<int>(n_work < sms ? n_work : sms);
  auto kernel = gelu ? dense_kernel<NT, true> : dense_kernel<NT, false>;
  const size_t smem = smem_bytes<NT>();
  // set on every launch: the attribute is per device
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, stream>>>(xmap, x, wsplit, bias, out, M, K,
                                           N, k_chunks, n_tiles, n_work,
                                           vec);
  return cudaGetLastError();
}

}  // namespace

// x [M, K], w [K, N], bias [N] or null, out [M, N], all float32 and
// C-contiguous; wsplit scratch of ops.split_floats(K, N, n_tile) floats,
// which the pre-pass fills; n_tile 64, 96 or 128; gelu 0 or 1; vec
// 1 where K % 4 == 0 and x is 16-byte aligned (x streams through the TMA
// unit; else in 4-byte cp.asyncs).
REPRO_EXTERN int dense_launch(const float* x, const float* w,
                              const float* bias, float* wsplit, float* out,
                              long long M, int K, int N, int n_tile,
                              int gelu, int vec, void* stream) {
  if (M < 0 || K < 0 || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
#define REPRO_TILES(NT)                                                   \
  launch_tiles<NT>(x, w, bias, wsplit, out, M, K, N, gelu, vec,           \
                   as_stream(stream))
  cudaError_t err;
  switch (n_tile) {
    case 64: err = REPRO_TILES(64); break;
    case 96: err = REPRO_TILES(96); break;
    case 128: err = REPRO_TILES(128); break;
    default: err = cudaErrorInvalidValue;
  }
#undef REPRO_TILES
  return static_cast<int>(err);
}
