// Closest-hit and any-hit traversal of the 8-wide cluster tree with
// Moller-Trumbore triangle tests, for Hopper (sm_90a), called through a
// plain C interface (ctypes): the opt-in wide8 route (LR_WIDE8=1).
//
// Replaces the TPU kernel of luisarender_tpu/ops/wide8_pallas.py:
// _wide_kernel (wide8_pallas.py:84), in its closest and any-hit modes
// (trace_closest_wide8 / trace_any_wide8). The contract is its: the 8-wide
// tables of ops/subpacket.py build_slab_meta (slab8 (N8, 8, 128), meta8
// (N8, 16)), the cluster boxes (C, 8) of ops/wide8.py build_cluster_boxes
// and the cluster kernel's triangle blocks (C, 16, 128); t_max clamped to
// 3e38; each leaf cluster's box re-tested against the ray's current best t
// (the TPU kernel's slab_rows form, (bound - o) * inv); the cluster's rows
// tested in order with the cluster kernel's Moller-Trumbore and a strict
// t < best_t; a miss returning t = inf, slot = -1, u = v = 0. So its hits
// equal the cluster kernel's except for exact ties across clusters.
//
// What bounds it: as the cluster kernel, the triangle rows and the rays'
// bytes. A pop tests 8 child boxes (~20 float operations each), and the
// rows of a cluster cost 46 operations each; the bytes are the rays in and
// out (48 B a ray) and the nodes and blocks the walk touches, read once
// (~15-19 us on the mesh-heavy scene's rays; PERF.md). The walk is short
// (one to three pops a ray on that scene's 1,809-node, 6-level tree) and
// the leaf stage takes the time: the first port of this kernel, one thread
// a ray testing its clusters' 128 rows in a serial loop, read 70-127x its
// bound, as the cluster kernel's first port did.
//
// Design: the cluster kernel's "while-while" loop (csrc/cluster.cu) carried
// over to the 8-wide tree, as trace_common.cuh's per-lane 8-wide walk
// (Lane8, pop8, to_leaf8, trace8), which the subpacket kernel shares; this
// kernel takes it with the box re-test and the Moller-Trumbore rows
// (MtRows). Each lane walks its own ray: a pop tests the
// node's 8 child boxes against the lane's best_t (planes bound * inv +
// (-o * inv), 12 float4 loads through the read-only cache), pushes the hit
// interior children in reverse visit order and keeps the hit leaf children
// as a pending mask, taken in visit order (ascending along the node's axis
// when the ray's component there is >= 0). Before it parks on a pending
// leaf the lane re-tests that cluster's box against its current best_t; a
// leaf that fails is dropped and does not count. The lane pops again only
// when no leaf is pending, so each of the up to 8 leaves of a pop sees the
// best_t that the leaves before it left. When every lane of the warp has
// parked or finished, the warp tests the parked lanes' clusters together
// (trace_common.cuh warp_leaves: lane k loads rows k + 32 j, one load for
// the lanes that share a cluster, the least t and lowest row from a
// shuffle reduction, the first occluder from a ballot). Outputs and the
// per-ray pops, leaves and rows equal the plain version's (ops/wide8.py
// wide8_plain). All 32 lanes stay in the loop until the warp is done. The
// stack is sized to the tree: a 48-int build for trees whose bound
// (ops/subpacket.py stack8_need; 34 on the mesh-heavy scene) fits, a
// 2,048-int one otherwise; a launch takes the least that holds the bound
// it is given. 128-thread blocks, five (closest) or six (any-hit) an SM
// asked of ptxas; the block rows go through L2 only, leaving L1 to the
// tree and the stacks. The lane counters are built into separate kernels,
// taken only when a caller asks for them. The walk stops with a bit of the
// error word after 4 N8 + 64 pops, on a stack deeper than the bound (where
// the plain version raises: after the pop's pending leaves, unless one
// occluded the ray) or a child code out of range; the wrapper reads it and
// raises. The TPU kernel's packet mechanics (2,048 rays sharing one SMEM
// stack, two pops a step, the slab matmul, the leaf queue and its DMA
// ring) are not carried over.
//
// Build with --fmad=false and without fast math: the plain PyTorch version
// then does the same IEEE operations in the same per-lane order and the
// two agree bit for bit. Designs measured against this one and dropped are
// in PERF.md with their times (wide8_ab.py).

#include "trace_common.cuh"

namespace {

constexpr int kThreads = 128;
// resident blocks an SM asked of ptxas: closest hits at five (96
// registers), any-hit at six (80, a few bytes of spill), the faster of
// four to eight in wide8_ab.py's turns for each mode
constexpr int kBlocksPerSmClosest = 5, kBlocksPerSmAny = 6;
// the per-lane stacks of the two builds (ops/subpacket.py STACKS8)
constexpr int kStackSmall = lrt::kStack8Small, kStackLarge = lrt::kStack8Large;

// lane counters: trace_common.cuh CTR_*, then CTR_CULLED
constexpr int kCounters = lrt::CTR_CULLED + 1;

// The launch arguments; the lane walk (trace_common.cuh begin8, to_leaf8)
// reads the rays, the tables, n8, n_clusters, cap and err.
struct Args {
  const float* __restrict__ o;
  const float* __restrict__ d;
  const float* __restrict__ t_min;
  const float* __restrict__ t_max;
  const float4* __restrict__ slab8;
  const float* __restrict__ meta8;
  const float4* __restrict__ cboxes;
  const float* __restrict__ tris;
  float* __restrict__ t_out;
  int* __restrict__ slot_out;
  float* __restrict__ u_out;
  float* __restrict__ v_out;
  int* __restrict__ occ_out;
  int* __restrict__ stats;
  unsigned long long* __restrict__ counters;
  int* __restrict__ err;
  int n8, n_clusters, cap, n;
};

using Walk = lrt::Lane8;

template <bool kAny>
__device__ __forceinline__ void write(const Walk& w, int i, const Args& a) {
  if (kAny) {
    a.occ_out[i] = w.occ;
  } else {
    a.t_out[i] = w.best_s >= 0 ? w.best_t : __int_as_float(0x7f800000);
    a.slot_out[i] = w.best_s;
    a.u_out[i] = w.best_u;
    a.v_out[i] = w.best_v;
  }
  if (a.stats != nullptr) {
    a.stats[3 * i] = w.pops;
    a.stats[3 * i + 1] = w.leaves;
    a.stats[3 * i + 2] = w.rows;
  }
}

template <bool kAny, bool kCount, int kCap>
__device__ __forceinline__ void trace(const Args& a) {
  lrt::trace8<kAny, true, lrt::MtRows, kCount, kCounters, kThreads, kCap>(
      a, a.tris, [&](const Walk& w, int i) { write<kAny>(w, i, a); });
}

template <int kCap>
__global__ void __launch_bounds__(kThreads, kBlocksPerSmClosest)
    wide8_closest_kernel(const Args a) {
  trace<false, false, kCap>(a);
}
template <int kCap>
__global__ void __launch_bounds__(kThreads, kBlocksPerSmAny) wide8_any_kernel(const Args a) {
  trace<true, false, kCap>(a);
}
template <int kCap>
__global__ void __launch_bounds__(kThreads, kBlocksPerSmClosest)
    wide8_closest_counted_kernel(const Args a) {
  trace<false, true, kCap>(a);
}
template <int kCap>
__global__ void __launch_bounds__(kThreads, kBlocksPerSmAny)
    wide8_any_counted_kernel(const Args a) {
  trace<true, true, kCap>(a);
}

using Kernel = void (*)(Args);

template <int kCap>
Kernel pick(bool any_hit, bool counted) {
  if (any_hit) return counted ? wide8_any_counted_kernel<kCap> : wide8_any_kernel<kCap>;
  return counted ? wide8_closest_counted_kernel<kCap> : wide8_closest_kernel<kCap>;
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
int wide8_counters() { return kCounters; }

// The per-lane stack entries of the build a launch takes for a tree whose
// stack bound is `bound` (0: beyond the largest build).
int wide8_stack_build(int bound) { return lrt::stack8_build(bound); }

// Both entry points launch on `stream` of device `device`, do not
// synchronise, and return cudaGetLastError() after the launch (0 = success).
// `stack` is the tree's stack bound (ops/subpacket.py stack8_need), at most
// the larger build's; the launch takes the least build that holds it.
// `stats` (N, 3) int32 and `counters` (wide8_counters() uint64) may be
// null; `err` is one int on the card that the walk ORs its error bits into.
int wide8_closest(const float* o, const float* d, const float* t_min,
                  const float* t_max, const float* slab8, const float* meta8,
                  int n8, const float* cboxes, const float* tris,
                  int n_clusters, int stack, int n, float* t_out,
                  int* slot_out, float* u_out, float* v_out, int* stats,
                  unsigned long long* counters, int* err, int device, void* stream) {
  const Args a = {o, d, t_min, t_max, reinterpret_cast<const float4*>(slab8), meta8,
                  reinterpret_cast<const float4*>(cboxes), tris, t_out, slot_out, u_out,
                  v_out, nullptr, stats, counters, err, n8, n_clusters, stack, n};
  return launch(false, a, device, stream);
}

int wide8_any(const float* o, const float* d, const float* t_min,
              const float* t_max, const float* slab8, const float* meta8,
              int n8, const float* cboxes, const float* tris, int n_clusters,
              int stack, int n, int* occ_out, int* stats,
              unsigned long long* counters, int* err, int device, void* stream) {
  const Args a = {o, d, t_min, t_max, reinterpret_cast<const float4*>(slab8), meta8,
                  reinterpret_cast<const float4*>(cboxes), tris, nullptr, nullptr, nullptr,
                  nullptr, occ_out, stats, counters, err, n8, n_clusters, stack, n};
  return launch(true, a, device, stream);
}

}  // extern "C"
