// Closest-hit and any-hit traversal of the 8-wide cluster tree with Woop
// triangle tests, for Hopper (sm_90a), called through a plain C interface
// (ctypes): the opt-in subpacket route (LR_SUBPACKET=1).
//
// Replaces the TPU kernel of luisarender_tpu/ops/subpacket_pallas.py:
// _subpacket_kernel (subpacket_pallas.py:322), in its closest and any-hit
// modes (trace_closest_subpacket / trace_any_subpacket). The contract is
// its: the 8-wide tables (slab8 (N8, 8, 128), meta8 (N8, 16)) and the Woop
// blocks (C, 8, 1024) of ops/subpacket.py; t_max clamped to 3e38; no
// re-test of a leaf cluster's box: every hit leaf child of a pop is tested,
// in visit order, each against the best t the leaves before it left; each
// triangle j of a leaf cluster tested with the ray features [ox, oy, oz, 1,
// dx, dy, dz, 0]: o' and d' the dot products of the block's columns with
// them in row order as fused multiply-adds (the TPU kernel's Woop matmul as
// XLA compiles it on the CPU, where its results are checked; the terms on
// the rows the block holds zero in are left out, since adding an exact zero
// changes no result), t = -o'z / d'z, u = fma(t, d'x, o'x), v = fma(t,
// d'y, o'y), a hit needing u, v >= 0, u + v <= 1, t_min < t < best_t (best_t
// as it stood when the cluster began), slot >= 0 and, any-hit, an opacity
// above 0.5; within a cluster the least t wins and on equal t the least
// slot, across clusters a strict t < best_t; any-hit stops at the first
// occluder in row order. It returns (t, slot); the wrapper returns u = v =
// NaN (scene/geometry.py recomputes them from the shade row, as in the
// reference). build_woop_table writes the same float32 W[g] into rows 0-2
// of group g (o') and rows 4-6 of group g + 3 (d'), here and in the
// reference, so d' is taken from the o' rows: a row reads 12 coefficients
// and its slot (ops/subpacket.py woop_tests reads the same columns).
//
// What bounds it: the rays' bytes and the Woop columns. A pop tests 8
// child boxes (~20 float operations each), and a cluster's rows cost 39
// operations each (a fused multiply-add counted as 2); the bytes are the
// rays in and out (40 B a ray), the nodes the walk pops and, read once, 13
// columns of every row of the clusters it tests (~20-23 us on the
// mesh-heavy scene's rays; PERF.md). The walk is short (one to three pops
// a ray on that scene's 1,809-node tree) and the leaf stage takes the
// time: the first port of this kernel, one thread a ray testing its
// clusters' 128 rows in a serial loop (23 words a row read one at a time,
// the lanes that were done waiting for the slowest loop), read ~100x its
// bound.
//
// Design: the wide8 kernel's (csrc/wide8.cu), on the shared per-lane walk
// of trace_common.cuh (Lane8, trace8) without the box re-test, with a Woop
// leaf stage. Each lane walks its own ray: a pop tests the node's 8 child
// boxes against the lane's best_t, pushes the hit interior children in
// reverse visit order and keeps the hit leaf children as a pending mask,
// taken in visit order; the lane parks on one pending leaf at a time and
// pops again only when none is left. When every lane of the warp has
// parked or finished, the warp tests the parked lanes' clusters together
// (trace_common.cuh warp_leaves with WoopRows below): lane k loads rows k,
// k + 32, k + 64 and k + 96 of a parked cluster (12 coefficients and the
// slot a row into registers; each column of a row group one coalesced
// 128-byte load through L2 only), one load for the lanes that share a
// cluster; for each parked lane the warp receives its ray and best_t by
// __shfl_sync, tests the rows and reduces (t, slot) with __shfl_xor_sync to
// the least t and then the least slot, or, for any-hit, takes the first
// occluder in row order from a ballot over the rows that hit and are
// opaque (opacity read only for rows that hit). Outputs and the per-ray
// pops, leaves and rows equal the plain version's (ops/subpacket.py
// subpacket_plain). All 32 lanes stay in the loop until the warp is done.
// The stack is sized to the tree: a 48-int build for trees whose bound
// (ops/subpacket.py stack8_need; 34 on the mesh-heavy scene) fits, a
// 2,048-int one otherwise; a launch takes the least that holds the bound
// it is given. 128-thread blocks; the lane counters are built into
// separate kernels, taken only when a caller asks for them. The walk stops
// with a bit of the error word after 4 N8 + 64 pops, on a stack deeper
// than the bound or a child code out of range; the wrapper reads it and
// raises. The TPU kernel's packet mechanics (128-ray subpackets sharing one
// SMEM stack, four pops a step, the Woop matmul, the leaf queue and its DMA
// pipeline) are not carried over.
//
// Build with --fmad=false and without fast math: the plain PyTorch version
// (ops/subpacket.py walk8_plain, woop_tests, its fma32 a correctly rounded
// fused multiply-add) then does the same IEEE operations in the same
// per-lane order and the two agree bit for bit. Designs measured against
// this one and dropped are in PERF.md with their times (subpacket_ab.py).

#include "trace_common.cuh"

namespace {

using lrt::block_word;
using lrt::kCluster;
using lrt::kGroups;
using lrt::Ray;

constexpr int kThreads = 128;
// resident blocks an SM asked of ptxas for each mode: five (96 registers),
// the faster in subpacket_ab.py's turns of four to seven (any-hit at six
// spilled 226 B and lost 5-10%)
constexpr int kBlocksPerSmClosest = 5, kBlocksPerSmAny = 5;
// the per-lane stacks of the two builds (ops/subpacket.py STACKS8)
constexpr int kStackSmall = lrt::kStack8Small, kStackLarge = lrt::kStack8Large;
constexpr int kCounters = lrt::kWalkCounters;  // lane counters, trace_common.cuh CTR_*
constexpr int kWoopCols = 8 * kCluster;         // a feature row of a Woop block
constexpr int kWoopBlock = 8 * kWoopCols;       // a cluster's Woop block

// The launch arguments; the lane walk (trace_common.cuh begin8, to_leaf8)
// reads the rays, the tables, n8, n_clusters, cap and err.
struct Args {
  const float* __restrict__ o;
  const float* __restrict__ d;
  const float* __restrict__ t_min;
  const float* __restrict__ t_max;
  const float4* __restrict__ slab8;
  const float* __restrict__ meta8;
  const float* __restrict__ woop;
  float* __restrict__ t_out;
  int* __restrict__ slot_out;
  int* __restrict__ occ_out;
  int* __restrict__ stats;
  unsigned long long* __restrict__ counters;
  int* __restrict__ err;
  int n8, n_clusters, cap, n;
};

// The Woop row-test policy of warp_leaves: lane k holds rows k + 32 j of a
// cluster's Woop block, for each the coefficients W(f, g) of features f =
// ox, oy, oz, 1 (rows 0-3) in groups g = 0-2 (o'x, o'y, o'z; d' takes rows
// 0-2 of the same groups) and the slot (row 3, group 6; valid when >= 0).
// Closest hits keep the least t and then the least slot.
struct WoopRows {
  const float* __restrict__ woop;
  const float* blk;
  float cf[kGroups][12];  // W(f, g) at 4 g + f
  int slot[kGroups];
  bool valid[kGroups];

  __device__ __forceinline__ explicit WoopRows(const float* table) : woop(table), blk(table) {}

  // feature row f, column group g of triangle j
  __device__ __forceinline__ const float* at(int f, int g, int j) const {
    return blk + f * kWoopCols + g * kCluster + j;
  }
  __device__ __forceinline__ void load(int c, int lane) {
    blk = woop + static_cast<size_t>(c) * kWoopBlock;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int j = lane + 32 * k;
      const float s = block_word(at(3, 6, j));
      valid[k] = s >= 0.0f;  // not padding, not a degenerate triangle
      slot[k] = static_cast<int>(s);
#pragma unroll
      for (int g = 0; g < 3; ++g) {
#pragma unroll
        for (int f = 0; f < 4; ++f) cf[k][4 * g + f] = block_word(at(f, g, j));
      }
    }
  }
  // row lane + 32 k hit with tmin < t < bt: the reference's matmul as a
  // chain of fused multiply-adds in row order, and u, v as fused
  // multiply-adds (explicit fmaf: --fmad=false contracts nothing else)
  __device__ __forceinline__ bool hit(int k, const Ray& q, float bt, float& t, float& u,
                                      float& v) const {
    const float* c = cf[k];
    const float opx = fmaf(c[2], q.oz, fmaf(c[1], q.oy, c[0] * q.ox)) + c[3];
    const float opy = fmaf(c[6], q.oz, fmaf(c[5], q.oy, c[4] * q.ox)) + c[7];
    const float opz = fmaf(c[10], q.oz, fmaf(c[9], q.oy, c[8] * q.ox)) + c[11];
    const float dpx = fmaf(c[2], q.dz, fmaf(c[1], q.dy, c[0] * q.dx));
    const float dpy = fmaf(c[6], q.dz, fmaf(c[5], q.dy, c[4] * q.dx));
    const float dpz = fmaf(c[10], q.dz, fmaf(c[9], q.dy, c[8] * q.dx));
    t = -opz / dpz;
    u = fmaf(t, dpx, opx);
    v = fmaf(t, dpy, opy);
    return u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > q.tmin && t < bt;
  }
  __device__ __forceinline__ bool opaque(int k, int lane) const {
    return block_word(at(3, 7, lane + 32 * k)) > 0.5f;
  }
  __device__ __forceinline__ int key(int k, int) const { return slot[k]; }
  static __device__ __forceinline__ bool better(float t, int key, float wt, int wkey) {
    return t < wt || (t == wt && key < wkey);
  }
  // the warp's winner (t, slot) into the lane that owns the ray; no (u, v)
  template <class W>
  __device__ __forceinline__ void win(W& w, bool mine, float wt, int wkey, float,
                                      float) const {
    if (mine) {
      w.best_t = wt;
      w.best_s = wkey;
    }
  }
};

template <bool kAny>
__device__ __forceinline__ void write(const lrt::Lane8& w, int i, const Args& a) {
  if (kAny) {
    a.occ_out[i] = w.occ;
  } else {
    a.t_out[i] = w.best_s >= 0 ? w.best_t : __int_as_float(0x7f800000);
    a.slot_out[i] = w.best_s;
  }
  if (a.stats != nullptr) {
    a.stats[3 * i] = w.pops;
    a.stats[3 * i + 1] = w.leaves;
    a.stats[3 * i + 2] = w.rows;
  }
}

template <bool kAny, bool kCount, int kCap>
__device__ __forceinline__ void trace(const Args& a) {
  lrt::trace8<kAny, false, WoopRows, kCount, kCounters, kThreads, kCap>(
      a, a.woop, [&](const lrt::Lane8& w, int i) { write<kAny>(w, i, a); });
}

template <int kCap>
__global__ void __launch_bounds__(kThreads, kBlocksPerSmClosest)
    subpacket_closest_kernel(const Args a) {
  trace<false, false, kCap>(a);
}
template <int kCap>
__global__ void __launch_bounds__(kThreads, kBlocksPerSmAny)
    subpacket_any_kernel(const Args a) {
  trace<true, false, kCap>(a);
}
template <int kCap>
__global__ void __launch_bounds__(kThreads, kBlocksPerSmClosest)
    subpacket_closest_counted_kernel(const Args a) {
  trace<false, true, kCap>(a);
}
template <int kCap>
__global__ void __launch_bounds__(kThreads, kBlocksPerSmAny)
    subpacket_any_counted_kernel(const Args a) {
  trace<true, true, kCap>(a);
}

using Kernel = void (*)(Args);

template <int kCap>
Kernel pick(bool any_hit, bool counted) {
  if (any_hit) return counted ? subpacket_any_counted_kernel<kCap> : subpacket_any_kernel<kCap>;
  return counted ? subpacket_closest_counted_kernel<kCap> : subpacket_closest_kernel<kCap>;
}

int launch(bool any_hit, const Args& a, int device, void* stream) {
  const int build = lrt::stack8_build(a.cap);
  if (a.n <= 0 || a.n8 <= 0 || build == 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const bool counted = a.counters != nullptr;
  const Kernel kernel = build == kStackSmall ? pick<kStackSmall>(any_hit, counted)
                                             : pick<kStackLarge>(any_hit, counted);
  kernel<<<lrt::blocks_for(a.n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The number of uint64 counters a launch adds to when `counters` is given.
int subpacket_counters() { return kCounters; }

// The per-lane stack entries of the build a launch takes for a tree whose
// stack bound is `bound` (0: beyond the largest build).
int subpacket_stack_build(int bound) { return lrt::stack8_build(bound); }

// Both entry points launch on `stream` of device `device`, do not
// synchronise, and return cudaGetLastError() after the launch (0 = success).
// `stack` is the tree's stack bound (ops/subpacket.py stack8_need), at most
// the larger build's; the launch takes the least build that holds it.
// `stats` (N, 3) int32 and `counters` (subpacket_counters() uint64) may be
// null; `err` is one int on the card that the walk ORs its error bits into.
int subpacket_closest(const float* o, const float* d, const float* t_min,
                      const float* t_max, const float* slab8, const float* meta8,
                      int n8, const float* woop, int n_clusters, int stack, int n,
                      float* t_out, int* slot_out, int* stats,
                      unsigned long long* counters, int* err, int device, void* stream) {
  const Args a = {o, d, t_min, t_max, reinterpret_cast<const float4*>(slab8), meta8, woop,
                  t_out, slot_out, nullptr, stats, counters, err, n8, n_clusters, stack, n};
  return launch(false, a, device, stream);
}

int subpacket_any(const float* o, const float* d, const float* t_min,
                  const float* t_max, const float* slab8, const float* meta8, int n8,
                  const float* woop, int n_clusters, int stack, int n, int* occ_out,
                  int* stats, unsigned long long* counters, int* err, int device,
                  void* stream) {
  const Args a = {o, d, t_min, t_max, reinterpret_cast<const float4*>(slab8), meta8, woop,
                  nullptr, nullptr, occ_out, stats, counters, err, n8, n_clusters, stack, n};
  return launch(true, a, device, stream);
}

}  // extern "C"
