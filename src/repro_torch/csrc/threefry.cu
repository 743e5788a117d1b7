// Threefry-2x32 draws, one launch per call of scene/prng.py on the card:
// fold_in, split, random_bits, uniform, randint and normal.
//
// Replaces no TPU kernel: the reference draws through jax.random, whose
// threefry XLA fuses into the surrounding program. The port's plain
// version (scene/prng.py) evaluates the 20-round block function as ~171
// separate int64 PyTorch ops, each a launch of its own, so a scene step's
// [64, 22] draws left the card waiting on the host's dispatch.
//
// Semantics (jax_threefry_partitionable, as the plain version): a call
// over `rows` key rows draws n elements a row; element j of row b is the
// block function on key b with counter (0, j):
//   fold_in      [n, 2] keys (y0, y1), element j on key row j with
//                counter (0, data[j]) (the wrapper passes rows = 1)
//   split        [rows, n, 2] keys (y0, y1)
//   random_bits  [rows, n] int64 y0 ^ y1
//   uniform      [rows, n] float32 max(lo, fma_f32(f, hi - lo, lo)), f the
//                bits' top 23 as a float in [0, 1)
//   randint      [rows, n] int64 in [minval, minval + span): the key's two
//                split(key, 2) subkeys drawn in the thread, their bits
//                combined by the reference's double-width modulus
//   normal       [rows, n] float32 sqrt(2) * erfinv(uniform(lo, hi)),
//                Giles' polynomial as the plain version evaluates it
// fma_f32 is the plain version's: the float32 product exact in double,
// the sum rounded to double, then to float (not __fmaf_rn, which rounds
// once). Built under -fmad=false without fast math, every float step
// rounds as PyTorch's separate ops do, so the draws are bit-equal.
//
// Layout: blockIdx.y walks key rows, x the elements of a row, so no
// element pays an integer division. Keys are int64 [.., 2] words read
// through a row stride and a word stride (a slice such as ks[:, 0] of
// [F, 8, 2], or one key broadcast over data with row stride 0);
// fold_in's data is a strided int64 tensor or one scalar argument, so a
// call copies nothing from the host.
//
// What bounds it on an H100: the scene's draws (64 x 22 to 64 x 44
// elements) are one launch each, bound by launch latency; the render
// noise (64 x 224 x 224 x 3 = 9.6M samples) by integer operations: ~80
// 32-bit ops of the block function a sample, against 38.5 MB of float32
// written once. The grid grows with rows x n: one warp a key row for a
// scene draw, the whole card for the noise.

#include <cfloat>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocksX = 1 << 16;
constexpr int64_t kMaxBlocksY = 65535;
// float32 sqrt(2), scene/prng.py's _SQRT2
constexpr float kSqrt2 = 1.4142135381698608f;

enum Mode : int {
  kFoldIn = 0,
  kSplit = 1,
  kBits = 2,
  kUniform = 3,
  kRandint = 4,
  kNormal = 5,
};

struct Args {
  const int64_t* key;    // word 0 of key row 0
  int64_t key_row;       // elements between key rows (0: one key for all)
  int64_t key_word;      // elements between a key's two words
  const int64_t* data;   // fold_in's data, or null for data_word
  int64_t data_row;
  uint32_t data_word;
  void* out;
  int64_t rows;
  int64_t n;
  float lo, hi;          // uniform's and normal's bounds
  uint32_t span, mult;   // randint's modulus and 2^32 mod span
  int64_t minval;
};

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = __funnelshift_l(x1, x1, r) ^ x0;
}

// The Threefry-2x32 block function, 20 rounds, on counter (x0, x1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k1;
  x1 += k2 + 1u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k2;
  x1 += k0 + 2u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k0;
  x1 += k1 + 3u;
  mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
  x0 += k1;
  x1 += k2 + 4u;
  mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
  x0 += k2;
  x1 += k0 + 5u;
}

__device__ __forceinline__ uint32_t bits(uint32_t k0, uint32_t k1,
                                         uint32_t j) {
  uint32_t x0 = 0u, x1 = j;
  threefry2x32(k0, k1, x0, x1);
  return x0 ^ x1;
}

__device__ __forceinline__ float fma_f32(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn(static_cast<double>(a), static_cast<double>(b)),
                static_cast<double>(c)));
}

__device__ __forceinline__ float uniform(uint32_t b, float lo, float width) {
  const float f = __fsub_rn(__uint_as_float((b >> 9) | 0x3F800000u), 1.0f);
  return fmaxf(lo, fma_f32(f, width, lo));
}

// Giles' single-precision erfinv (w < 5 and w >= 5 branches), as
// scene/prng.py's _erfinv evaluates it.
__device__ __forceinline__ float erfinv(float x) {
  float w = -log1pf(__fmul_rn(-x, x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  // the float32 values of scene/prng.py's _ERFINV_LT5 : _ERFINV_GE5
  float p = lt ? 2.810226362726098e-08f : -0.0002002142573473975f;
  p = fma_f32(p, w, lt ? 3.432739390518691e-07f : 0.0001009505576803349f);
  p = fma_f32(p, w, lt ? -3.523387704262859e-06f : 0.0013493432197719812f);
  p = fma_f32(p, w, lt ? -4.391506536194356e-06f : -0.003673428436741233f);
  p = fma_f32(p, w, lt ? 0.00021858086984138936f : 0.005739507731050253f);
  p = fma_f32(p, w, lt ? -0.001253725029528141f : -0.007622461300343275f);
  p = fma_f32(p, w, lt ? -0.004177681636065245f : 0.00943887047469616f);
  p = fma_f32(p, w, lt ? 0.24664072692394257f : 1.0016740560531616f);
  p = fma_f32(p, w, lt ? 1.5014094114303589f : 2.832976818084717f);
  return fabsf(x) == 1.0f ? __fmul_rn(x, FLT_MAX) : __fmul_rn(p, x);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) threefry_kernel(const Args a) {
  const float width = __fsub_rn(a.hi, a.lo);
  const int64_t step = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * blockDim.x
                     + threadIdx.x;
  for (int64_t b = blockIdx.y; b < a.rows; b += gridDim.y) {
    uint32_t k0 = 0u, k1 = 0u, h0 = 0u, h1 = 0u, l0 = 0u, l1 = 0u;
    if (kMode != kFoldIn) {
      const int64_t* key = a.key + b * a.key_row;
      k0 = static_cast<uint32_t>(key[0]);
      k1 = static_cast<uint32_t>(key[a.key_word]);
    }
    if (kMode == kRandint) {  // split(key, 2): the two subkeys
      h0 = 0u; h1 = 0u;
      threefry2x32(k0, k1, h0, h1);
      l0 = 0u; l1 = 1u;
      threefry2x32(k0, k1, l0, l1);
    }
    for (int64_t j = j0; j < a.n; j += step) {
      const int64_t i = b * a.n + j;
      const uint32_t c = static_cast<uint32_t>(j);
      if (kMode == kFoldIn) {  // one key row an element
        const int64_t* key = a.key + j * a.key_row;
        uint32_t x0 = 0u;
        uint32_t x1 = a.data != nullptr
                          ? static_cast<uint32_t>(a.data[j * a.data_row])
                          : a.data_word;
        threefry2x32(static_cast<uint32_t>(key[0]),
                     static_cast<uint32_t>(key[a.key_word]), x0, x1);
        int64_t* o = static_cast<int64_t*>(a.out) + 2 * i;
        o[0] = x0;
        o[1] = x1;
      } else if (kMode == kSplit) {
        uint32_t x0 = 0u, x1 = c;
        threefry2x32(k0, k1, x0, x1);
        int64_t* o = static_cast<int64_t*>(a.out) + 2 * i;
        o[0] = x0;
        o[1] = x1;
      } else if (kMode == kBits) {
        static_cast<int64_t*>(a.out)[i] = bits(k0, k1, c);
      } else if (kMode == kUniform) {
        static_cast<float*>(a.out)[i] = uniform(bits(k0, k1, c), a.lo, width);
      } else if (kMode == kRandint) {
        const uint64_t hi = bits(h0, h1, c) % a.span;
        const uint64_t lo = bits(l0, l1, c) % a.span;
        const uint64_t off = ((hi * a.mult) & 0xFFFFFFFFull) + lo;
        static_cast<int64_t*>(a.out)[i] =
            a.minval + static_cast<int64_t>((off & 0xFFFFFFFFull) % a.span);
      } else {
        const float u = uniform(bits(k0, k1, c), a.lo, width);
        static_cast<float*>(a.out)[i] = __fmul_rn(kSqrt2, erfinv(u));
      }
    }
  }
}

template <int kMode>
void launch(const Args& a, dim3 grid, int threads, cudaStream_t stream) {
  threefry_kernel<kMode><<<grid, threads, 0, stream>>>(a);
}

}  // namespace

REPRO_EXTERN int threefry_launch(int mode, const int64_t* key,
                                 int64_t key_row, int64_t key_word,
                                 const int64_t* data, int64_t data_row,
                                 uint32_t data_word, void* out, int64_t rows,
                                 int64_t n, float lo, float hi, uint32_t span,
                                 uint32_t mult, int64_t minval,
                                 void* stream) {
  if (rows <= 0 || n <= 0) return 0;
  if (mode == kRandint && span == 0u) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{key, key_row, key_word, data, data_row, data_word, out,
               rows, n, lo, hi, span, mult, minval};
  // a warp's multiple of threads up to kThreads, so a [64, 22] draw
  // runs 64 blocks of one warp
  const int threads = n >= kThreads ? kThreads
                                    : static_cast<int>((n + 31) / 32 * 32);
  const int64_t bx = (n + threads - 1) / threads;
  const dim3 grid(static_cast<unsigned>(bx < kMaxBlocksX ? bx : kMaxBlocksX),
                  static_cast<unsigned>(rows < kMaxBlocksY ? rows
                                                           : kMaxBlocksY));
  cudaStream_t s = as_stream(stream);
  switch (mode) {
    case kFoldIn: launch<kFoldIn>(a, grid, threads, s); break;
    case kSplit: launch<kSplit>(a, grid, threads, s); break;
    case kBits: launch<kBits>(a, grid, threads, s); break;
    case kUniform: launch<kUniform>(a, grid, threads, s); break;
    case kRandint: launch<kRandint>(a, grid, threads, s); break;
    case kNormal: launch<kNormal>(a, grid, threads, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
