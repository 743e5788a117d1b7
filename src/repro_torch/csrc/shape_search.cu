// The shape search of one controller step (paper §3.3) as two
// per-camera kernels, one warp per camera:
//
//   shape_search  resize_shape(evolve_shape(prev), target=max_cells): the
//                 head/tail swap loop (or the 1-member drift/jump), then
//                 grow/shrink to the budgeted cell count
//   budget_walk   drop cells (first_removable) until the induced-MST
//                 preorder walk of the shape fits the exploration budget
//
// Replaces the TPU kernel `neighbor_score_batch` (src/repro/kernels/
// neighbor_score/neighbor_score.py) where the main path ran it, inside
// the shape-search loops of src/repro/fleet/shape_ops.py, together with
// those loops and src/repro/fleet/step.py::_shrink_to_budget (XLA while
// loops on the TPU). Their plain versions (kernels/shape_search/ops.py)
// dispatch ~74,000 small PyTorch operations per step, 92 of them
// neighbor_score launches.
//
// What bounds it on an H100: latency, not bytes (~25 KB per call at 64
// cameras) or operations. A camera's search is a serial chain of small
// decisions, so one warp runs one camera and keeps what the chain touches
// in registers and shared memory: cell sets are W 64-bit words held
// warp-uniform in every lane, W = 2, 4 or 8 picked at launch from N (so
// N <= 128, 256 or 512: the default 25-cell grid runs the 2-word
// instance, the 7.5-degree grid's 200 cells the 4-word one); the
// 8-neighbor, MST and walk-tree adjacencies are bit rows in dynamic
// shared memory sized by N (at 512 cells budget_walk's three take 96 KB);
// the grid's float tables
// (d_center, overlap, dist) and DFS push order are read from L2. Each
// loop runs until its camera is done, under the plain version's static
// bound. The lanes share what is parallel inside one decision:
//   - stable orders: ranks by counting, one lane per cell;
//   - neighbor scores: one lane per candidate cell;
//   - first_removable: every member's removal tested at once, one lane
//     per rank, each a serial flood fill over bit rows;
//   - argmax/argmin: a butterfly that keeps the first extremum;
//   - the walk's stitch: one lane per source row; its DFS pushes by a
//     ballot prefix.
//
// Bit parity with the plain versions (the decisions must be identical;
// tests/test_torch_shape_search.py holds a Python model of this code to
// them on the CPU):
//   ties     stable sorts -> ranks by counting over all N cells, the
//                           non-members' INF keys included, as
//                           torch.sort(stable=True) orders them
//                           (stable_order);
//            argmax/argmin -> (value, index) pairs that prefer the lower
//                           index on equal values, seeded with
//                           (sentinel, 0), so an empty candidate set
//                           gives index 0 as torch.argmax over an all
//                           -INF row does (Best, warp_best);
//            stitch edge  -> the row-major first cheapest (u, v) (walk);
//            DFS pushes   -> the static nbr_order, pushed in its order
//                           (walk).
//   float32  each comparison and product in the plain version's order
//            and rounding (-fmad=false; scalars as float32, as PyTorch
//            applies them to float32 tensors): lab_h / max(lab_t, 1e-9)
//            > thresh; thresh * growth; lab_bg > (lab_h * 2) * base;
//            lab_best > lab_h * base; best_score > 1.05f; t_deg /
//            rotation_speed; t + per_cell * cnt <= budget. The neighbor
//            score is neighbor_score.cuh's, shared with the standalone
//            kernel.
//   hop sum  t_deg adds the hops in path order; the plain version's
//            torch.sum has no specified order (hops that are multiples
//            of the grid's steps sum exactly in any order). t is compared
//            within 1e-6 relative: on the card the plain version's
//            t_deg / rotation_speed may round as a product by the
//            reciprocal (PyTorch's CUDA division by a Python scalar),
//            where this kernel and the CPU divide.
//   free     "member with a free neighbor" reads the member's own row of
//            neighbor8, the plain version its column: the lattice
//            adjacency is symmetric.
// Labels, centroids and the tables are finite (no NaN rules).
#include <math_constants.h>

#include "common.cuh"
#include "neighbor_score.cuh"

namespace {

constexpr int kMaxWords = 8;      // cells per set: up to 512
constexpr unsigned kFull = 0xffffffffu;

// A set of grid cells: cell i is bit (i & 63) of w[i >> 6]. W (2, 4 or
// 8 words) is picked at launch from N; every word loop below unrolls,
// so a set lives in registers (a word is selected, never indexed).
template <int W>
struct Cells {
  unsigned long long w[W];
};

template <int W>
__device__ __forceinline__ Cells<W> none() {
  Cells<W> s;
#pragma unroll
  for (int k = 0; k < W; ++k) s.w[k] = 0ull;
  return s;
}

template <int W>
__device__ __forceinline__ Cells<W> one(int i) {
  Cells<W> s;
#pragma unroll
  for (int k = 0; k < W; ++k) s.w[k] = k == (i >> 6) ? 1ull << (i & 63) : 0ull;
  return s;
}

template <int W>
__device__ __forceinline__ Cells<W> all_cells(int n) {
  Cells<W> s;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    const int left = n - 64 * k;
    s.w[k] = left >= 64 ? ~0ull : left <= 0 ? 0ull : (1ull << left) - 1ull;
  }
  return s;
}

template <int W>
__device__ __forceinline__ Cells<W> operator&(Cells<W> a, Cells<W> b) {
#pragma unroll
  for (int k = 0; k < W; ++k) a.w[k] &= b.w[k];
  return a;
}
template <int W>
__device__ __forceinline__ Cells<W> operator|(Cells<W> a, Cells<W> b) {
#pragma unroll
  for (int k = 0; k < W; ++k) a.w[k] |= b.w[k];
  return a;
}
template <int W>
__device__ __forceinline__ Cells<W> operator~(Cells<W> a) {
#pragma unroll
  for (int k = 0; k < W; ++k) a.w[k] = ~a.w[k];
  return a;
}
template <int W>
__device__ __forceinline__ bool operator==(Cells<W> a, Cells<W> b) {
  unsigned long long diff = 0ull;
#pragma unroll
  for (int k = 0; k < W; ++k) diff |= a.w[k] ^ b.w[k];
  return diff == 0ull;
}
template <int W>
__device__ __forceinline__ bool any(Cells<W> a) {
  unsigned long long x = 0ull;
#pragma unroll
  for (int k = 0; k < W; ++k) x |= a.w[k];
  return x != 0ull;
}
template <int W>
__device__ __forceinline__ int count(Cells<W> a) {
  int c = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) c += __popcll(a.w[k]);
  return c;
}
template <int W>
__device__ __forceinline__ bool has(Cells<W> a, int i) {
  unsigned long long x = 0ull;
#pragma unroll
  for (int k = 0; k < W; ++k) x = k == (i >> 6) ? a.w[k] : x;
  return ((x >> (i & 63)) & 1ull) != 0;
}
// the lowest cell of a non-empty set
template <int W>
__device__ __forceinline__ int lowest(Cells<W> a) {
  int low = 0;
#pragma unroll
  for (int k = W - 1; k >= 0; --k) {
    if (a.w[k]) low = 64 * k + __ffsll(static_cast<long long>(a.w[k])) - 1;
  }
  return low;
}

__device__ __forceinline__ int lane_id() { return threadIdx.x; }

// The set of cells i < n where pred(i) holds, one ballot per 32 cells;
// every lane gets the same set.
template <int W, class Pred>
__device__ __forceinline__ Cells<W> collect(int n, Pred pred) {
  Cells<W> s = none<W>();
#pragma unroll
  for (int k = 0; k < W; ++k) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int base = 64 * k + 32 * half;
      if (base < n) {
        const int i = base + lane_id();
        const unsigned long long b = __ballot_sync(kFull, i < n && pred(i));
        s.w[k] |= b << (32 * half);
      }
    }
  }
  return s;
}

// An [n, n] bool matrix -> n bit rows in shared memory. The bytes are
// read flat, all loads independent (latency overlaps across the row).
template <int W>
__device__ void load_rows(const unsigned char* __restrict__ adj, int n,
                          Cells<W>* rows) {
  for (int i = lane_id(); i < n; i += 32) rows[i] = none<W>();
  __syncwarp();
  for (int k = lane_id(); k < n * n; k += 32) {
    if (adj[k]) {
      const int i = k / n;
      const int j = k - i * n;
      atomicOr(&rows[i].w[j >> 6], 1ull << (j & 63));
    }
  }
  __syncwarp();
}

// (value, index) of an argmax or argmin.
struct Best {
  float v;
  int i;
};

// Reduce the lanes' pairs to the first maximum (kMax) or minimum: the
// better value wins, an equal one the lower index. Every lane returns the
// same pair.
template <bool kMax>
__device__ __forceinline__ Best warp_best(Best b) {
  for (int off = 16; off > 0; off >>= 1) {
    const float v = __shfl_xor_sync(kFull, b.v, off);
    const int i = __shfl_xor_sync(kFull, b.i, off);
    const bool better = kMax ? v > b.v : v < b.v;
    if (better || (v == b.v && i < b.i)) {
      b.v = v;
      b.i = i;
    }
  }
  return b;
}

// ord[r] = the cell of rank r by ascending key, ties toward the lower
// cell: the rank of cell i counts the cells j with k_j < k_i, or k_j ==
// k_i and j < i. The caller has written key[0..n).
__device__ void stable_order(const float* key, int n, int* ord) {
  __syncwarp();
  for (int i = lane_id(); i < n; i += 32) {
    const float ki = key[i];
    int r = 0;
    for (int j = 0; j < n; ++j) {
      const float kj = key[j];
      r += (kj < ki) || (kj == ki && j < i);
    }
    ord[r] = i;
  }
  __syncwarp();
}

// Cells of `mask` reachable from `seed` over the bit rows: the flood
// fill's fixpoint, each reached cell's row taken once.
template <int W>
__device__ Cells<W> flood(Cells<W> mask, Cells<W> seed, const Cells<W>* rows) {
  Cells<W> reach = seed & mask;
  Cells<W> front = reach;
  while (any(front)) {
    const int i = lowest(front);
    front = front & ~one<W>(i);
    const Cells<W> add = rows[i] & mask & ~reach;
    reach = reach | add;
    front = front | add;
  }
  return reach;
}

// empty and 1-cell sets are contiguous
template <int W>
__device__ bool contiguous(Cells<W> mask, const Cells<W>* rows) {
  return !any(mask) || flood(mask, one<W>(lowest(mask)), rows) == mask;
}

// Lowest-label member whose removal keeps the shape 8-connected, else the
// lowest-label member: every member's removal is tested at once, one lane
// per rank, and the first success in rank order is taken by ballot.
template <int W>
__device__ int first_removable(Cells<W> mask, int n, const float* labels,
                               const Cells<W>* nbr, float* key, int* ord) {
  for (int i = lane_id(); i < n; i += 32) {
    key[i] = has(mask, i) ? labels[i] : CUDART_INF_F;
  }
  stable_order(key, n, ord);
  const int m = count(mask);
  int pick = ord[0];
  for (int base = 0; base < m; base += 32) {
    const int r = base + lane_id();
    const bool ok = r < m && contiguous(mask & ~one<W>(ord[r]), nbr);
    const unsigned b = __ballot_sync(kFull, ok);
    if (b) {
      pick = ord[base + __ffs(b) - 1];
      break;
    }
  }
  __syncwarp();  // key and ord are rewritten by the next order
  return pick;
}

// ---------------------------------------------------------------------------
// shape_search
// ---------------------------------------------------------------------------

// One camera's search: its strips in shared memory, the grid's tables in
// global memory, the search constants.
template <int W>
struct Search {
  int n;
  const Cells<W>* nbr;        // [n] 8-neighbor bit rows
  const float* labels;        // [n]
  const float* cx;            // [n] centroids
  const float* cy;
  const unsigned char* boxes;  // [n] has_boxes
  float* mh;                  // [n] member_has scratch
  float* key;                 // [n] sort keys scratch
  int* ord;                   // [n] order scratch
  const float* d_center;      // [n, n]
  const float* overlap;       // [n, n]
  const float* cell_x;        // [n]
  const float* cell_y;
  float base;
  float growth;
  int max_swaps;
};

// First argmax of the labels over the cells of s; (-INF, 0) when none.
template <int W>
__device__ Best label_max(const Search<W>& p, Cells<W> s) {
  Best b{-CUDART_INF_F, 0};
  for (int i = lane_id(); i < p.n; i += 32) {
    const float v = p.labels[i];
    if (has(s, i) && (v > b.v || (v == b.v && i < b.i))) b = Best{v, i};
  }
  return warp_best<true>(b);
}

// First argmax of the neighbor score over the candidate cells, with
// member_has from the current mask; (-INF, 0) when there is none.
template <int W>
__device__ Best best_candidate(const Search<W>& p, Cells<W> cand,
                               Cells<W> mask) {
  for (int i = lane_id(); i < p.n; i += 32) {
    p.mh[i] = has(mask, i) && p.boxes[i] ? 1.0f : 0.0f;
  }
  __syncwarp();
  Best b{-CUDART_INF_F, 0};
  for (int i = lane_id(); i < p.n; i += 32) {
    if (!has(cand, i)) continue;
    const float s = neighbor_score_at(i, p.n, p.mh, p.cx, p.cy, p.d_center,
                                      p.overlap, p.cell_x[i], p.cell_y[i]);
    if (s > b.v || (s == b.v && i < b.i)) b = Best{s, i};
  }
  b = warp_best<true>(b);
  __syncwarp();  // every lane has read mh before the next call writes it
  return b;
}

// The >= 2-member head/tail swap loop.
template <int W>
__device__ Cells<W> evolve_multi(const Search<W>& p, Cells<W> mask) {
  const int n = p.n;
  // members by descending label, ties toward the lower cell; frozen
  for (int i = lane_id(); i < n; i += 32) {
    p.key[i] = has(mask, i) ? -p.labels[i] : CUDART_INF_F;
  }
  stable_order(p.key, n, p.ord);
  int h = 0;
  int t = max(count(mask) - 1, 0);
  int swaps = 0;
  float thresh = p.base;
  bool failed = false;
  for (int it = 0; it < 2 * n + 2 * p.max_swaps; ++it) {
    if (h >= t || swaps >= p.max_swaps) break;
    const int H = p.ord[min(h, n - 1)];
    const int T = p.ord[min(max(t, 0), n - 1)];
    // parity: one IEEE division, then the float32 comparison
    if (!(p.labels[H] / fmaxf(p.labels[T], 1e-9f) > thresh)) break;
    const Cells<W> cand = p.nbr[H] & ~mask;
    if (!any(cand)) {
      if (failed) break;  // second failure ends the loop
      ++h;
      thresh = p.base;
      failed = true;
      continue;
    }
    const int best = best_candidate(p, cand, mask).i;
    const Cells<W> trial = (mask | one<W>(best)) & ~one<W>(T);
    if (contiguous(trial, p.nbr)) {
      mask = trial;
      failed = false;
      ++swaps;
      thresh = thresh * p.growth;  // parity: one float32 product
    }
    --t;  // the tail is swapped out or structural
  }
  return mask;
}

// The 1-member drift/jump branch.
template <int W>
__device__ Cells<W> evolve_single(const Search<W>& p, Cells<W> mask) {
  const int H = lowest(mask);
  const float lab_h = p.labels[H];
  const Best g = label_max(p, all_cells<W>(p.n));
  // parity: (lab_h * 2) * base, two roundings in this order
  const bool jump = g.i != H && g.v > (lab_h * 2.0f) * p.base;
  const Cells<W> cand = p.nbr[H] & ~mask;
  // parity: no candidate gives (-INF, 0), so lab_best reads cell 0 as
  // the plain version's argmax over an all -INF row does
  const Best b = best_candidate(p, cand, mask);
  const bool moving_away = b.v > 1.05f;
  const bool promising = p.labels[b.i] > lab_h * p.base;
  const bool drift = !jump && any(cand) && (moving_away || promising);
  if (jump || drift) mask = (mask & ~one<W>(H)) | one<W>(jump ? g.i : b.i);
  return mask;
}

// Grow to / shrink to the target cell count.
template <int W>
__device__ Cells<W> resize(const Search<W>& p, Cells<W> mask,
                           long long max_cells) {
  const int n = p.n;
  const int target =
      static_cast<int>(min(max(max_cells, 1LL), static_cast<long long>(n)));
  // grow: the best-scored free neighbor of the highest-label member that
  // has one; stuck when no member has a free neighbor
  for (int it = 0; it < n && count(mask) < target; ++it) {
    const Cells<W> eligible = collect<W>(
        n, [&](int i) { return has(mask, i) && any(p.nbr[i] & ~mask); });
    if (!any(eligible)) break;
    const int H = label_max(p, eligible).i;
    mask = mask | one<W>(best_candidate(p, p.nbr[H] & ~mask, mask).i);
  }
  // shrink: the lowest-label member whose removal keeps the shape whole
  for (int it = 0; it < n - 1 && count(mask) > target; ++it) {
    mask = mask & ~one<W>(first_removable(mask, n, p.labels, p.nbr, p.key,
                                       p.ord));
  }
  return mask;
}

template <int W>
__global__ void __launch_bounds__(32) shape_search_kernel(
    const unsigned char* __restrict__ prev, const float* __restrict__ labels,
    const float* __restrict__ centroids,
    const unsigned char* __restrict__ has_boxes,
    const long long* __restrict__ max_cells,
    const float* __restrict__ d_center, const float* __restrict__ overlap,
    const float* __restrict__ cell_x, const float* __restrict__ cell_y,
    const unsigned char* __restrict__ neighbor8,
    unsigned char* __restrict__ out, int n, float base, float growth,
    int max_swaps) {
  // dynamic shared memory sized by N (shape_search_bytes)
  extern __shared__ __align__(16) unsigned char smem[];
  Cells<W>* s_nbr = reinterpret_cast<Cells<W>*>(smem);
  float* s_labels = reinterpret_cast<float*>(s_nbr + n);
  float* s_cx = s_labels + n;
  float* s_cy = s_cx + n;
  float* s_mh = s_cy + n;
  float* s_key = s_mh + n;
  int* s_ord = reinterpret_cast<int*>(s_key + n);
  unsigned char* s_boxes = reinterpret_cast<unsigned char*>(s_ord + n);
  const size_t row = static_cast<size_t>(blockIdx.x) * n;
  load_rows(neighbor8, n, s_nbr);
  for (int i = lane_id(); i < n; i += 32) {
    s_labels[i] = labels[row + i];
    s_cx[i] = centroids[2 * (row + i)];
    s_cy[i] = centroids[2 * (row + i) + 1];
    s_boxes[i] = has_boxes[row + i];
  }
  Cells<W> mask = collect<W>(n, [&](int i) { return prev[row + i] != 0; });
  __syncwarp();
  const Search<W> p{n,        s_nbr,   s_labels, s_cx,   s_cy, s_boxes,
                 s_mh,     s_key,   s_ord,    d_center, overlap,
                 cell_x,   cell_y,  base,     growth, max_swaps};
  const int m = count(mask);
  if (m == 1) {
    mask = evolve_single(p, mask);
  } else if (m >= 2) {
    mask = evolve_multi(p, mask);
  }
  mask = resize(p, mask, max_cells[blockIdx.x]);
  for (int i = lane_id(); i < n; i += 32) out[row + i] = has(mask, i);
}

// ---------------------------------------------------------------------------
// budget_walk
// ---------------------------------------------------------------------------

template <int W>
struct Walk {
  int n;
  const Cells<W>* mst;          // [n] MST bit rows (shared)
  Cells<W>* tree;               // [n] the walk's tree (shared)
  int* stack;                   // [n + 1] (shared)
  int* path;                    // [n] preorder cells (shared)
  const float* dist;            // [n, n] rotation distance
  const long long* nbr_order;   // [n, n] DFS push order
};

// Preorder walk of the shape's induced MST, its components stitched by
// their cheapest edges: writes path[0..cnt), returns cnt and the hop sum
// in degrees from `start` along the path.
template <int W>
__device__ int walk(const Walk<W>& w, Cells<W> mask, int start, float* t_deg) {
  const int n = w.n;
  const int lane = lane_id();
  int start2 = start;
  if (!has(mask, start)) {  // the nearest member: first argmin
    Best b{CUDART_INF_F, 0};
    for (int i = lane; i < n; i += 32) {
      const float d = w.dist[start * n + i];
      if (has(mask, i) && (d < b.v || (d == b.v && i < b.i))) b = Best{d, i};
    }
    start2 = warp_best<false>(b).i;
  }
  for (int i = lane; i < n; i += 32) {
    w.tree[i] = has(mask, i) ? (w.mst[i] & mask) : none<W>();
  }
  __syncwarp();

  // stitch the induced forest's components to start2's by the cheapest
  // (row-major first) edge from the stitched part, one per component
  Cells<W> done = flood(mask, one<W>(start2), w.mst);
  for (int it = 0; it < n - 1; ++it) {
    const Cells<W> rest = mask & ~done;
    if (!any(rest)) break;
    // parity: (distance, u * n + v), each lane's pairs in ascending flat
    // order, so the first cheapest edge in row-major order wins
    Best b{CUDART_INF_F, 0};
    for (int u = lane; u < n; u += 32) {
      if (!has(done, u)) continue;
      for (Cells<W> r = rest; any(r);) {
        const int v = lowest(r);
        r = r & ~one<W>(v);
        const float d = w.dist[u * n + v];
        if (d < b.v) b = Best{d, u * n + v};
      }
    }
    b = warp_best<false>(b);
    const int u = b.i / n;
    const int v = b.i - u * n;
    done = done | (flood(mask, one<W>(v), w.mst) & rest);
    if (lane == 0) {
      w.tree[u] = w.tree[u] | one<W>(v);
      w.tree[v] = w.tree[v] | one<W>(u);
    }
    __syncwarp();
  }

  // preorder DFS: pop, then push the unseen tree neighbors in the static
  // push order (farthest first, so the nearest is visited next)
  if (lane == 0) w.stack[0] = start2;
  __syncwarp();
  int top = any(mask) ? 1 : 0;
  int cnt = 0;
  Cells<W> seen = none<W>();
  for (int it = 0; it < n && top > 0; ++it) {
    const int u = w.stack[top - 1];
    const int top2 = top - 1;
    seen = seen | one<W>(u);
    if (lane == 0) w.path[cnt] = u;
    ++cnt;
    // parity: unseen tree neighbors pushed in nbr_order's order, slots
    // by a ballot prefix (the plain version's cumsum)
    const Cells<W> kids = w.tree[u] & ~seen;
    int pushed = 0;
    if (any(kids)) {
      // every lane has read u before the first ballot; pushes follow it
      for (int base = 0; base < n; base += 32) {
        const int k = base + lane;
        const int c = k < n ? static_cast<int>(w.nbr_order[u * n + k]) : 0;
        const bool push = k < n && has(kids, c);
        const unsigned b = __ballot_sync(kFull, push);
        const int slot = top2 + pushed + __popc(b & ((1u << lane) - 1u));
        if (push && slot <= n) w.stack[slot] = c;
        pushed += __popc(b);
      }
    }
    top = top2 + pushed;
    __syncwarp();
  }

  // parity: the hops in path order (the plain version's torch.sum order
  // is unspecified: the tests hold t to 1e-6 relative)
  float t = 0.0f;
  int prev = start;
  for (int k = 0; k < cnt; ++k) {
    const int c = w.path[k];
    t += w.dist[prev * n + c];
    prev = c;
  }
  *t_deg = t;
  return cnt;
}

__device__ void store_walk(const int* path, int cnt, float t, int n,
                           long long* order, long long* cnt_out,
                           float* t_out) {
  for (int k = lane_id(); k < n; k += 32) order[k] = k < cnt ? path[k] : -1;
  if (lane_id() == 0) {
    *cnt_out = cnt;
    *t_out = t;
  }
}

template <int W>
__global__ void __launch_bounds__(32) budget_walk_kernel(
    const unsigned char* __restrict__ mask_in,
    const long long* __restrict__ start, const float* __restrict__ labels,
    const float* __restrict__ budget_s, const float* __restrict__ dist,
    const unsigned char* __restrict__ mst_adj,
    const long long* __restrict__ nbr_order,
    const unsigned char* __restrict__ neighbor8,
    unsigned char* __restrict__ mask_out, long long* __restrict__ order,
    long long* __restrict__ cnt_out, float* __restrict__ t_out, int n,
    float per_cell, float rotation_speed) {
  // dynamic shared memory sized by N (budget_walk_bytes)
  extern __shared__ __align__(16) unsigned char smem[];
  Cells<W>* s_nbr = reinterpret_cast<Cells<W>*>(smem);
  Cells<W>* s_mst = s_nbr + n;
  Cells<W>* s_tree = s_mst + n;
  float* s_labels = reinterpret_cast<float*>(s_tree + n);
  float* s_key = s_labels + n;
  int* s_ord = reinterpret_cast<int*>(s_key + n);
  int* s_path = s_ord + n;
  int* s_stack = s_path + n;                    // [n + 1]
  const int f = blockIdx.x;
  const size_t row = static_cast<size_t>(f) * n;
  load_rows(neighbor8, n, s_nbr);
  load_rows(mst_adj, n, s_mst);
  for (int i = lane_id(); i < n; i += 32) s_labels[i] = labels[row + i];
  Cells<W> mask = collect<W>(n, [&](int i) { return mask_in[row + i] != 0; });
  __syncwarp();
  const Walk<W> w{n, s_mst, s_tree, s_stack, s_path, dist, nbr_order};
  const int st = static_cast<int>(start[f]);
  const float budget = budget_s[f];
  // parity: per_cell * cnt, then + t, each a float32 rounding (no FMA)
  const auto feasible = [&](Cells<W> mk, int cnt, float t) {
    return t + per_cell * static_cast<float>(cnt) <= budget || count(mk) <= 1;
  };

  float t_deg;
  int cnt = walk(w, mask, st, &t_deg);
  float t = t_deg / rotation_speed;  // parity: IEEE division
  store_walk(s_path, cnt, t, n, order + row, cnt_out + f, t_out + f);
  // each pass removes one member and a single cell always fits, so n - 1
  // passes suffice
  bool done = feasible(mask, cnt, t);
  for (int it = 0; it < n - 1 && !done; ++it) {
    mask = mask & ~one<W>(first_removable(mask, n, s_labels, s_nbr, s_key,
                                       s_ord));
    cnt = walk(w, mask, st, &t_deg);
    t = t_deg / rotation_speed;
    if (feasible(mask, cnt, t)) {
      store_walk(s_path, cnt, t, n, order + row, cnt_out + f, t_out + f);
      done = true;
    }
  }
  for (int i = lane_id(); i < n; i += 32) mask_out[row + i] = has(mask, i);
}

// shared memory of one camera's block: bit rows, float and int strips
constexpr size_t shape_search_bytes(int w, int n) {
  return static_cast<size_t>(n) * (8 * w + 6 * 4 + 1);
}
constexpr size_t budget_walk_bytes(int w, int n) {
  return static_cast<size_t>(n) * (3 * 8 * w + 5 * 4) + 4;
}

// the narrowest set for N cells: 2, 4 or 8 words (N <= 512)
int words_for(int n) { return n <= 128 ? 2 : n <= 256 ? 4 : 8; }

template <class Kernel>
cudaError_t fit_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int W>
cudaError_t launch_search(const unsigned char* prev, const float* labels,
                          const float* centroids,
                          const unsigned char* has_boxes,
                          const long long* max_cells, const float* d_center,
                          const float* overlap, const float* cell_x,
                          const float* cell_y,
                          const unsigned char* neighbor8, unsigned char* out,
                          int batch, int n, float base, float growth,
                          int max_swaps, cudaStream_t stream) {
  const size_t smem = shape_search_bytes(W, n);
  const cudaError_t err = fit_smem(shape_search_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  shape_search_kernel<W><<<batch, 32, smem, stream>>>(
      prev, labels, centroids, has_boxes, max_cells, d_center, overlap,
      cell_x, cell_y, neighbor8, out, n, base, growth, max_swaps);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_walk(const unsigned char* mask, const long long* start,
                        const float* labels, const float* budget_s,
                        const float* dist, const unsigned char* mst_adj,
                        const long long* nbr_order,
                        const unsigned char* neighbor8,
                        unsigned char* mask_out, long long* order,
                        long long* cnt, float* t, int batch, int n,
                        float per_cell, float rotation_speed,
                        cudaStream_t stream) {
  const size_t smem = budget_walk_bytes(W, n);
  const cudaError_t err = fit_smem(budget_walk_kernel<W>, smem);
  if (err != cudaSuccess) return err;
  budget_walk_kernel<W><<<batch, 32, smem, stream>>>(
      mask, start, labels, budget_s, dist, mst_adj, nbr_order, neighbor8,
      mask_out, order, cnt, t, n, per_cell, rotation_speed);
  return cudaGetLastError();
}

}  // namespace

REPRO_EXTERN int shape_search_launch(
    const unsigned char* prev, const float* labels, const float* centroids,
    const unsigned char* has_boxes, const long long* max_cells,
    const float* d_center, const float* overlap, const float* cell_x,
    const float* cell_y, const unsigned char* neighbor8, unsigned char* out,
    int batch, int n_cells, float base_threshold, float threshold_growth,
    int max_swaps, void* stream) {
  if (n_cells < 1 || n_cells > 64 * kMaxWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
#define REPRO_SEARCH(W)                                                     \
  launch_search<W>(prev, labels, centroids, has_boxes, max_cells, d_center, \
                   overlap, cell_x, cell_y, neighbor8, out, batch, n_cells, \
                   base_threshold, threshold_growth, max_swaps,             \
                   as_stream(stream))
  const int w = words_for(n_cells);
  const cudaError_t err = w == 2   ? REPRO_SEARCH(2)
                          : w == 4 ? REPRO_SEARCH(4)
                                   : REPRO_SEARCH(8);
#undef REPRO_SEARCH
  return static_cast<int>(err);
}

REPRO_EXTERN int budget_walk_launch(
    const unsigned char* mask, const long long* start, const float* labels,
    const float* budget_s, const float* dist, const unsigned char* mst_adj,
    const long long* nbr_order, const unsigned char* neighbor8,
    unsigned char* mask_out, long long* order, long long* cnt, float* t,
    int batch, int n_cells, float per_cell, float rotation_speed,
    void* stream) {
  if (n_cells < 1 || n_cells > 64 * kMaxWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0) return 0;
#define REPRO_WALK(W)                                                       \
  launch_walk<W>(mask, start, labels, budget_s, dist, mst_adj, nbr_order,   \
                 neighbor8, mask_out, order, cnt, t, batch, n_cells,        \
                 per_cell, rotation_speed, as_stream(stream))
  const int w = words_for(n_cells);
  const cudaError_t err = w == 2   ? REPRO_WALK(2)
                          : w == 4 ? REPRO_WALK(4)
                                   : REPRO_WALK(8);
#undef REPRO_WALK
  return static_cast<int>(err);
}
