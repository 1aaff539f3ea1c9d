// Closest-hit traversal of the scene's binary SAH tree, a few triangles a
// leaf, for Hopper (sm_90a), called through a plain C interface (ctypes).
//
// Replaces the TPU kernel of luisarender_tpu/ops/trace_pallas.py:
// _traverse_kernel (trace_pallas.py:83, trace_closest_pallas). The contract
// is its answer over the tables of ops/trace.py pack_tables (nodes (N, 16):
// box, skip link, count, first row; triangles (P, 16): v0, e1, e2, original
// index; node i's left child i + 1, its right child skip[i + 1]): t_max
// clamped to 3e38, a lane whose t_min is not below it dead on entry; a
// leaf's first min(count, leaf_size) rows tested with the reference's
// Moller-Trumbore (|det| > 1e-12, u, v >= 0, u + v <= 1, t_min < t, index
// >= 0); a hit's prim the row first + j; a miss returning t = inf, prim =
// -1, u = v = 0. No router reaches it, as in the reference.
//
// The tree arrives as ops/trace.py's child-pair table (build_pairs, made
// once a tree from the node table): a 64-byte row for each interior node,
// in preorder, holding both children's boxes and codes, after row 0, which
// holds the root (and an empty slot). A child's code is its pair row (>= 0,
// an interior node), ~(first << 6 | (rows - 1)) for a leaf, kNone for an
// empty slot, or a value past the table for a child index or leaf rows out
// of range in the node table (its box is all of space, so entering its
// parent enters it and the walk raises).
//
// Visit order. The walk keeps the reference's: left child first, a leaf's
// rows in order, the first hit of least t (a strict t < best_t). A walk
// that enters the nearer child first can return another row where two
// leaves hold hits of equal t: with the tie in the plane of the entry face
// of the box met second, its slab entry can round a step above the
// Moller-Trumbore t and the walk culls it (tests/test_torch_trace.py
// face_tie_tree). This order meets the boxes as the reference does, so it
// keeps the reference's answer on every ray.
//
// What bounds it: the bytes. A ray visits tens of pair rows (two boxes, 40
// float operations) and tests a few leaves of at most 4 rows (46 operations
// a row); the rays in and out (48 B a ray) and the pair and triangle rows
// the walk touches, read once, take the card longer than those operations
// (the times and bounds are in PERF.md).
//
// Design: the "while-while" walk of the cluster, wide8 and subpacket
// kernels, on the binary tree. Each lane walks its own ray until it parks
// on a leaf or ends: a visit loads one pair row, tests both children's
// boxes against the lane's best t, goes on to child 0 when it is hit and
// pushes child 1, with its entry t, when both are hit. A popped entry whose
// entry t lies past the lane's best t is dropped unvisited: that is the
// reference's slab test of its box against the current best t, whose other
// terms do not change. When every lane of the warp has
// parked or ended, the warp tests the parked lanes' leaves (warp_leaves):
// 8 leaves a batch, lane 4 g + j taking row j of the g-th parked lane's
// leaf (a leaf's 4 rows are 256 contiguous bytes), its ray and best t by
// __shfl_sync from that lane, the group's least (t, row) by
// __shfl_xor_sync, (u, v) from the lane that holds the winner. The lane
// stack holds the tree's bound (ops/trace.py tree_stack: the tree's depth
// + 1; this walk pushes at most one entry a level) in the least of
// kStackSmall, kStackMid and kStackLarge entries. The walk stops with a bit
// of the error word after 4 P + 64 visits of a P-row pair table, on a stack
// deeper than the bound or on a code out of range; the wrapper raises.
// A walk is a chain of dependent pair-row loads, so the kernel wants many
// warps in flight: its launch bounds ask for eight 128-thread blocks an SM;
// the lane stack stays in local memory; pair rows go through the read-only
// cache, triangle rows through L2 only. Lane counters are built into
// separate kernels, taken only when a caller asks for them. The designs
// timed against this one (trace_ab.py) are in PERF.md with their times.
//
// Build with --fmad=false and without fast math: the plain PyTorch version
// (ops/trace.py walk_plain) then does the same IEEE operations in the same
// per-lane order and the two agree bit for bit, the walk counts included.

#include <climits>

#include "trace_common.cuh"

namespace {

using lrt::kBig;
using lrt::kErrIndex;
using lrt::kErrStack;
using lrt::kErrSteps;
using lrt::kFull;
using lrt::Ray;

constexpr int kThreads = 128;
constexpr int kBlocksPerSm = 8;
constexpr int kCounters = lrt::kWalkCounters;  // lane counters, trace_common.cuh CTR_*
// the stack builds (ops/trace.py STACKS); the tree of the 512k-triangle
// mesh-heavy scene needs 23 entries
constexpr int kStackSmall = 32, kStackMid = 64, kStackLarge = 512;
constexpr int kNone = INT_MIN;  // an empty child slot; nothing parked; pop next
constexpr int kLeafBits = 6;    // a leaf code: ~(first << 6 | (rows - 1))
constexpr int kGroup = 4;       // lanes a leaf in warp_leaves

// The stack build that holds a tree's bound, 0 if none does.
inline int stack_build(int bound) {
  if (bound < 1 || bound > kStackLarge) return 0;
  return bound <= kStackSmall ? kStackSmall : (bound <= kStackMid ? kStackMid : kStackLarge);
}

struct Args {
  const float* __restrict__ o;
  const float* __restrict__ d;
  const float* __restrict__ t_min;
  const float* __restrict__ t_max;
  const float4* __restrict__ pairs;
  const float4* __restrict__ tris;
  float* __restrict__ t_out;
  int* __restrict__ prim_out;
  float* __restrict__ u_out;
  float* __restrict__ v_out;
  int* __restrict__ stats;
  unsigned long long* __restrict__ counters;
  int* __restrict__ err;
  int n_pairs, n_rows, cap, n;
};

// One lane's walk of one ray, but for its stack.
struct Walk {
  Ray r;
  float best_t, best_u, best_v;
  int best_p, pops, leaves, rows, sp;
  int cur;    // the pair row to visit next; kNone: the stack's top
  bool live;  // the walk has visits left (or a parked leaf)
};

// A lane's stack of (code, entry t as int bits), in local memory.
template <int kCap>
struct Stack {
  int2 e[kCap];
  __device__ __forceinline__ int2& at(int k) { return e[k]; }
};

__device__ __forceinline__ void begin(Walk& w, int i, const Args& a) {
  w.r = lrt::load_ray(i, a.o, a.d, a.t_min);
  const float tmx = a.t_max[i];
  w.best_t = tmx < kBig ? tmx : kBig;
  w.best_p = -1;
  w.best_u = w.best_v = 0.0f;
  w.pops = w.leaves = w.rows = w.sp = 0;
  w.live = w.r.tmin < w.best_t;  // rays dead on entry never visit
  w.cur = w.live ? 0 : kNone;    // row 0 holds the root
}

// A lane without a ray: it only takes part in the warp's leaf stage.
__device__ __forceinline__ void idle(Walk& w) {
  w.r = Ray{};
  w.best_t = w.best_u = w.best_v = 0.0f;
  w.best_p = -1;
  w.pops = w.leaves = w.rows = w.sp = 0;
  w.cur = kNone;
  w.live = false;
}

__device__ __forceinline__ void write(const Walk& w, int i, const Args& a) {
  a.t_out[i] = w.best_p >= 0 ? w.best_t : __int_as_float(0x7f800000);
  a.prim_out[i] = w.best_p;
  a.u_out[i] = w.best_u;
  a.v_out[i] = w.best_v;
  if (a.stats != nullptr) {
    a.stats[3 * i] = w.pops;
    a.stats[3 * i + 1] = w.leaves;
    a.stats[3 * i + 2] = w.rows;
  }
}

// A hit child's code names a pair row or rows of the triangle table.
__device__ __forceinline__ bool valid(int c, const Args& a) {
  if (c >= 0) return c < a.n_pairs;
  const int x = ~c;
  return (x >> kLeafBits) + (x & ((1 << kLeafBits) - 1)) + 1 <= a.n_rows;
}

// Visits pair rows until a leaf is entered (returns its code: the lane
// parks) or the walk ends (returns kNone, w.live false).
template <class S>
__device__ __forceinline__ int to_leaf(Walk& w, S& st, const Args& a) {
  const int max_steps = 4 * a.n_pairs + 64;
  while (w.live) {
    int node = w.cur;
    if (node == kNone) {
      if (w.sp == 0) break;
      const int2 e = st.at(--w.sp);
      if (__int_as_float(e.y) > w.best_t) continue;  // its box now lies past the best hit
      if (e.x < 0) {
        ++w.leaves;
        return e.x;
      }
      node = e.x;
    }
    if (w.pops >= max_steps) {
      atomicOr(a.err, kErrSteps);
      break;
    }
    ++w.pops;
    // row = (box 0 min.xyz, max.x), (box 0 max.yz, code 0, code 1),
    //       (box 1 min.xyz, max.x), (box 1 max.yz, ..)
    const float4* p = a.pairs + 4 * node;
    const float4 p0 = __ldg(p), p1 = __ldg(p + 1), p2 = __ldg(p + 2), p3 = __ldg(p + 3);
    const int c0 = __float_as_int(p1.z), c1 = __float_as_int(p1.w);
    float n1;
    const bool h0 = lrt::slab(p0, p1, w.r, w.best_t) && c0 != kNone;
    const bool h1 = lrt::slab_near(p2, p3, w.r, w.best_t, n1) && c1 != kNone;
    if ((h0 && !valid(c0, a)) || (h1 && !valid(c1, a))) {
      atomicOr(a.err, kErrIndex);
      break;
    }
    int next = h0 ? c0 : (h1 ? c1 : kNone);
    if (h0 && h1) {
      if (w.sp >= a.cap) {
        atomicOr(a.err, kErrStack);
        break;
      }
      st.at(w.sp++) = make_int2(c1, __float_as_int(n1));
    }
    w.cur = next < 0 ? kNone : next;
    if (next < 0 && next != kNone) {
      ++w.leaves;
      return next;
    }
  }
  w.live = false;
  return kNone;
}

// Row `row` against ray q: true, with its (t, u, v), when it is a hit
// nearer than bt.
__device__ __forceinline__ bool row_hit(const float4* __restrict__ tris, int row, const Ray& q,
                                        float bt, float& t, float& u, float& v) {
  // row = (v0.xyz, e1.x), (e1.yz, e2.xy), (e2.z, index, ..)
  const float4* p = tris + 4 * row;
  const float4 f0 = __ldcg(p), f1 = __ldcg(p + 1), f2 = __ldcg(p + 2);
  bool big_det;
  const bool inside = lrt::moller_trumbore(f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w, f2.x,
                                           q, t, u, v, big_det);
  return big_det && inside && t > q.tmin && f2.y >= 0.0f && t < bt;
}

__device__ __forceinline__ void leaf_rows(int code, int& first, int& m) {
  const int x = ~code;
  first = x >> kLeafBits;
  m = (x & ((1 << kLeafBits) - 1)) + 1;
}

// The leaf stage of the warp: the parked lanes' leaves in batches of
// 32 / kGroup, group g (lanes kGroup g + j) serving the g-th parked lane of
// the batch, lane j taking rows j, j + kGroup, .. of its leaf; the group
// keeps its least (t, row), which is the first hit of least t in row order.
// Returns
// false, having changed nothing, when no lane parked. Called by all 32
// lanes.
template <class Ctr>
__device__ __forceinline__ bool warp_leaves(Walk& w, int leaf, const Args& a, Ctr& ctr) {
  const int lane = threadIdx.x & 31;
  unsigned parked = __ballot_sync(kFull, leaf != kNone);
  if (!parked) return false;
  if (ctr.on) {
    ++ctr.c[lrt::CTR_ROUNDS];
    ctr.c[lrt::CTR_PARKED] += __popc(parked);
  }
  const int g = lane / kGroup, j = lane % kGroup;
  while (parked) {
    int src = -1;  // the lane group g serves
    unsigned rest = parked;
#pragma unroll
    for (int k = 0; k < 32 / kGroup; ++k) {
      if (k == g) src = __ffs(rest) - 1;
      rest &= rest - 1;
    }
    const unsigned batch = parked & ~rest;
    parked = rest;
    const int s = src >= 0 ? src : lane;
    const Ray q = lrt::shfl_ray(w.r, s);
    const float bt = __shfl_sync(kFull, w.best_t, s);
    const int code = __shfl_sync(kFull, leaf, s);
    int first = 0, m = 0;
    if (src >= 0) leaf_rows(code, first, m);
    const int m_max = static_cast<int>(__reduce_max_sync(kFull, static_cast<unsigned>(m)));
    // this lane's best row, then its group's
    float wt = __int_as_float(0x7f800000), wu = 0.0f, wv = 0.0f;
    int wrow = INT_MAX;
    for (int base = 0; base < m_max; base += kGroup) {
      const int row = first + base + j;
      float t, u, v;
      if (base + j < m && row_hit(a.tris, row, q, bt, t, u, v) &&
          (t < wt || (t == wt && row < wrow))) {
        wt = t;
        wrow = row;
        wu = u;
        wv = v;
      }
    }
#pragma unroll
    for (int off = 1; off < kGroup; off <<= 1) {
      const float ot = __shfl_xor_sync(kFull, wt, off);
      const int orow = __shfl_xor_sync(kFull, wrow, off);
      if (ot < wt || (ot == wt && orow < wrow)) {
        wt = ot;
        wrow = orow;
      }
    }
    // the served lane takes its group's winner: (t, row) from the group's
    // first lane, (u, v) from the lane that tested the row
    const bool served = (batch >> lane) & 1u;
    const int mine = __popc(batch & ((1u << lane) - 1u));
    const float rt = __shfl_sync(kFull, wt, served ? kGroup * mine : lane);
    const int rrow = __shfl_sync(kFull, wrow, served ? kGroup * mine : lane);
    int own_first = 0, own_m = 0;
    if (served) leaf_rows(leaf, own_first, own_m);
    const bool won = served && rrow != INT_MAX;
    const int holder = won ? kGroup * mine + (rrow - own_first) % kGroup : lane;
    const float ru = __shfl_sync(kFull, wu, holder);
    const float rv = __shfl_sync(kFull, wv, holder);
    if (served) w.rows += own_m;
    if (won) {
      w.best_t = rt;
      w.best_p = rrow;
      w.best_u = ru;
      w.best_v = rv;
    }
    if (ctr.on) {
      ++ctr.c[lrt::CTR_LOADS];
      ctr.c[lrt::CTR_ROWS] += __reduce_add_sync(kFull, static_cast<unsigned>(j == 0 ? m : 0));
      ctr.c[lrt::CTR_ROW_SLOTS] += 32ull * ((m_max + kGroup - 1) / kGroup);
    }
  }
  return true;
}

template <bool kCount, class S>
__device__ __forceinline__ void run(const Args& a, S& st) {
  const int lane = threadIdx.x & 31;
  lrt::Counters<kCount, kCounters> ctr = {};
  Walk w;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < a.n) {
    begin(w, i, a);
  } else {
    idle(w);
  }
  for (;;) {
    const int pops0 = w.pops;
    const int leaf = to_leaf(w, st, a);
    if (ctr.on) {
      const unsigned longest = __reduce_max_sync(kFull, static_cast<unsigned>(w.pops - pops0));
      ctr.c[lrt::CTR_POP_SLOTS] += 32ull * longest;
    }
    if (!warp_leaves(w, leaf, a, ctr)) break;
  }
  if (i < a.n) write(w, i, a);
  if (kCount) {
    ctr.c[lrt::CTR_POPS] += __reduce_add_sync(kFull, static_cast<unsigned>(i < a.n ? w.pops : 0));
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kCounters; ++k)
        if (ctr.c[k]) atomicAdd(a.counters + k, ctr.c[k]);
    }
  }
}

template <bool kCount, int kCap>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) trace_closest_kernel(const Args a) {
  Stack<kCap> st;
  run<kCount>(a, st);
}

using Kernel = void (*)(Args);

template <int kCap>
Kernel pick(bool counted) {
  return counted ? trace_closest_kernel<true, kCap> : trace_closest_kernel<false, kCap>;
}

}  // namespace

extern "C" {

// The number of uint64 counters a launch adds to when `counters` is given.
int trace_counters() { return kCounters; }

// The stack entries of the build a launch takes for a tree whose stack
// bound is `bound` (0: beyond the largest build).
int trace_stack_build(int bound) { return stack_build(bound); }

// Launches on `stream` of device `device`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 = success). `pairs` is the
// (n_pairs, 16) child-pair table (ops/trace.py build_pairs), `tris` the
// (n_rows, 16) triangle table; `stack` is the tree's stack bound
// (ops/trace.py tree_stack), at most the largest build's. `stats` (N, 3)
// int32 and `counters` (trace_counters() uint64) may be null; `err` is one
// int on the card that the walk ORs its error bits into.
int trace_closest(const float* o, const float* d, const float* t_min,
                  const float* t_max, const float* pairs, int n_pairs,
                  const float* tris, int n_rows, int stack, int n, float* t_out,
                  int* prim_out, float* u_out, float* v_out, int* stats,
                  unsigned long long* counters, int* err, int device, void* stream) {
  const int build = stack_build(stack);
  if (n <= 0 || n_pairs <= 0 || build == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a = {o, d, t_min, t_max, reinterpret_cast<const float4*>(pairs),
                  reinterpret_cast<const float4*>(tris), t_out, prim_out, u_out, v_out,
                  stats, counters, err, n_pairs, n_rows, stack, n};
  const bool counted = counters != nullptr;
  const Kernel kernel = build == kStackSmall ? pick<kStackSmall>(counted)
                        : build == kStackMid ? pick<kStackMid>(counted)
                                             : pick<kStackLarge>(counted);
  kernel<<<lrt::blocks_for(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
