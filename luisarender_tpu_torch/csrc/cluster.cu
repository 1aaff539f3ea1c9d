// Closest-hit and any-hit traversal of a SAH tree of triangle clusters, for
// scenes above the brute-force size, for Hopper (sm_90a), called through a
// plain C interface (ctypes).
//
// Replaces the TPU kernel of luisarender_tpu/ops/cluster_pallas.py:
// _traverse_kernel (cluster_pallas.py:339), in its closest and any-hit modes
// (trace_closest_cluster / trace_any_cluster). The contract is its: the
// same node table (N, 8) (box, right child with the near-child hint in its
// fraction, leaf cluster id) and triangle blocks (C, 16, 128)
// (attribute-major v0 / e1 / e2, valid, opaque, slot), the same slab test
// and safe inverse, the same Moller-Trumbore, t_max clamped to 3e38, the
// first row of least t in a leaf winning (the reference's in-order strict
// t < best_t), a hit's slot read from the block, and a miss returning
// t = inf, slot = -1, u = v = 0. The reference's wrapper sorts the rays into
// coherent packets before the launch; ops/cluster.py ports its keys
// (coherence_order). This kernel walks each ray on its own and gives the
// same answer in any order, and its wrappers launch in caller order: on the
// H100 it is slower on sorted closest-hit rays and gains at most 12 us on
// sorted shadow rays (PERF.md).
//
// What bounds it: the triangle rows. A ray pops ~10-60 nodes (~20 float
// operations each) and visits a few leaves of up to 128 rows (46 operations
// a row). At the main path's shapes (921,600 rays, 512k triangles) those
// operations and the bytes the walk must move (rays in and hits out, the
// 0.4 MB node table, and the columns it reads of the blocks some ray
// visits, once) take the card ~15-20 us; the times are in PERF.md.
// One thread walking a leaf's 128 rows in a serial loop (the first port of
// this kernel) left that far behind: a warp's lanes reach their leaves at
// different pops, each lane read its own 5 KB block one word at a time,
// and the lanes that were not in a leaf waited for the slowest loop.
//
// Design: Aila & Laine's "while-while" loop with the leaf stage done by the
// whole warp (trace_common.cuh warp_leaves, shared with wide8.cu). Each lane walks its own ray's coarse tree (a per-lane stack
// of 64 ints, the near child first along the ray's own direction, the slab
// test against the lane's own best_t) until its pop hits a leaf; there it
// parks with the leaf's cluster id. When every lane of the warp has parked
// or finished, the warp serves the parked lanes: lane k loads rows k, k+32,
// k+64 and k+96 of the block into registers (an attribute column of 128
// floats is four coalesced 128-byte loads), then for each parked lane whose
// leaf it is the warp receives that lane's ray and best_t by __shfl_sync,
// tests its four rows, and reduces with __shfl_xor_sync to the least t,
// the lowest row on a tie (= the serial loop's strict t < best_t), or, for
// any-hit, takes the first occluder from a ballot. Parked lanes that share
// a cluster (__match_any_sync) are served from one load of its rows. A
// lane resumes its walk only after its leaf was served, so every pop culls
// against the best_t the serial walk had there: the outputs and the
// per-ray walk counts equal walk_plain's. All 32 lanes stay in the loop
// until the warp is done (no early return before a *_sync call). The walk
// stops at a stack deeper than 64 or after 4 N + 64 pops and sets a bit of
// the error word, which the wrapper reads and raises on: neither happens on
// a well-formed tree. A walk is a chain of dependent node loads, so the
// kernel wants many warps in flight: its launch bounds ask for six
// 128-thread blocks an SM (80 registers, a few bytes of spill), and the
// blocks' rows, read once into registers, go through L2 only and leave L1
// to the node table and the stacks. The lane counters are built into
// separate kernels, taken only when a caller asks for them.
//
// Build with --fmad=false and without fast math: the plain PyTorch version
// (ops/cluster.py walk_plain) then does the same IEEE operations in the same
// per-lane order and the two agree bit for bit.
//
// Designs measured against this one and dropped (persistent warps, a block
// load per parked lane, the top of the tree in shared memory, more registers
// a thread, blocks through L1) are in PERF.md with their times.

#include "trace_common.cuh"

namespace {

using lrt::kBig;
using lrt::kCluster;
using lrt::kErrIndex;
using lrt::kErrStack;
using lrt::kErrSteps;
using lrt::kFull;
using lrt::kTriCols;
using lrt::Ray;

constexpr int kThreads = 128;
constexpr int kStack = 64;
constexpr int kBlocksPerSm = 6;  // resident blocks an SM asked of ptxas
constexpr int kCounters = lrt::kWalkCounters;  // lane counters, trace_common.cuh CTR_*

struct Args {
  const float* __restrict__ o;
  const float* __restrict__ d;
  const float* __restrict__ t_min;
  const float* __restrict__ t_max;
  const float4* __restrict__ nodes;
  const float* __restrict__ tris;
  float* __restrict__ t_out;
  int* __restrict__ slot_out;
  float* __restrict__ u_out;
  float* __restrict__ v_out;
  int* __restrict__ occ_out;
  int* __restrict__ stats;
  unsigned long long* __restrict__ counters;
  int* __restrict__ err;
  int n_nodes, n_clusters, n;
};

// One lane's walk of one ray, but for its stack (kept apart, so that these
// stay in registers while the stack is in local memory).
struct Walk {
  Ray r;
  float best_t, best_u, best_v;
  int best_s, occ, pops, leaves, rows, sp;
  bool live;  // the walk has pops left (or a parked leaf)
};

__device__ __forceinline__ void begin(Walk& w, int* stack, int i, const Args& a) {
  w.r = lrt::load_ray(i, a.o, a.d, a.t_min);
  const float tmx = a.t_max[i];
  w.best_t = tmx < kBig ? tmx : kBig;
  w.best_s = -1;
  w.best_u = w.best_v = 0.0f;
  w.occ = w.pops = w.leaves = w.rows = w.sp = 0;
  w.live = w.r.tmin < w.best_t;  // rays dead on entry never pop
  if (w.live) stack[w.sp++] = 0;
}

// A lane without a ray: it only takes part in the warp's leaf stage.
__device__ __forceinline__ void idle(Walk& w) {
  w.r = Ray{};
  w.best_t = w.best_u = w.best_v = 0.0f;
  w.best_s = -1;
  w.occ = w.pops = w.leaves = w.rows = w.sp = 0;
  w.live = false;
}

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

// Pops until a leaf's box is hit (returns its cluster: the lane parks) or
// the walk ends (returns -1, w.live false).
__device__ __forceinline__ int to_leaf(Walk& w, int* stack, const Args& a) {
  const int max_steps = 4 * a.n_nodes + 64;
  while (w.live) {
    if (w.sp == 0) break;
    if (w.pops >= max_steps) {
      atomicOr(a.err, kErrSteps);
      break;
    }
    ++w.pops;
    const int node = stack[--w.sp];
    const float4 na = __ldg(a.nodes + 2 * node);
    const float4 nb = __ldg(a.nodes + 2 * node + 1);
    if (!lrt::slab(na, nb, w.r, w.best_t)) continue;
    const float rf = floorf(nb.z);
    const int first = static_cast<int>(nb.w);
    if (first >= 0) {
      if (first >= a.n_clusters) {
        atomicOr(a.err, kErrIndex);
        break;
      }
      ++w.leaves;
      return first;
    }
    // interior: push the far child, then the near one
    const int right = static_cast<int>(rf);
    const int left = node + 1;
    if (right < 0 || right >= a.n_nodes || left >= a.n_nodes) {
      atomicOr(a.err, kErrIndex);
      break;
    }
    if (w.sp + 2 > kStack) {
      atomicOr(a.err, kErrStack);
      break;
    }
    const float frac4 = (nb.z - rf) * 4.0f;
    const float axf = floorf(frac4 + 0.25f);
    const bool left_high = (frac4 - axf) > 0.125f;
    const int axis = static_cast<int>(axf);
    const float dax = axis == 0 ? w.r.dx : (axis == 1 ? w.r.dy : w.r.dz);
    const bool left_near = (dax >= 0.0f) != left_high;
    stack[w.sp] = left_near ? right : left;
    stack[w.sp + 1] = left_near ? left : right;
    w.sp += 2;
  }
  w.live = false;
  return -1;
}

// One round of the warp: every lane walks to its next leaf or its end, then
// the warp tests the parked lanes' leaves (lrt::warp_leaves). Returns false,
// having changed nothing, when no lane parked. Called by all 32 lanes.
template <bool kAny, class Ctr>
__device__ __forceinline__ bool warp_round(Walk& w, int* stack, const Args& a, Ctr& ctr) {
  const int pops0 = w.pops;
  const int cl = to_leaf(w, stack, a);
  if (ctr.on) {
    const unsigned run = __reduce_max_sync(kFull, static_cast<unsigned>(w.pops - pops0));
    ctr.c[lrt::CTR_POP_SLOTS] += 32ull * run;
  }
  return lrt::warp_leaves<kAny, lrt::MtRows>(w, cl, a.tris, ctr);
}

template <bool kAny, bool kCount>
__device__ __forceinline__ void trace(const Args& a) {
  const int lane = threadIdx.x & 31;
  lrt::Counters<kCount, kCounters> ctr = {};
  Walk w;
  int stack[kStack];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < a.n) {
    begin(w, stack, i, a);
  } else {
    idle(w);
  }
  while (warp_round<kAny>(w, stack, a, ctr)) {
  }
  if (i < a.n) write<kAny>(w, i, a);
  if (kCount) {
    ctr.c[lrt::CTR_POPS] += __reduce_add_sync(kFull, static_cast<unsigned>(i < a.n ? w.pops : 0));
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kCounters; ++k)
        if (ctr.c[k]) atomicAdd(a.counters + k, ctr.c[k]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm) cluster_closest_kernel(const Args a) {
  trace<false, false>(a);
}
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) cluster_any_kernel(const Args a) {
  trace<true, false>(a);
}
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) cluster_closest_counted_kernel(const Args a) {
  trace<false, true>(a);
}
__global__ void __launch_bounds__(kThreads, kBlocksPerSm) cluster_any_counted_kernel(const Args a) {
  trace<true, true>(a);
}

int launch(void (*kernel)(Args), const Args& a, int device, void* stream) {
  if (a.n <= 0 || a.n_nodes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<lrt::blocks_for(a.n, kThreads), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The number of uint64 counters a launch adds to when `counters` is given.
int cluster_counters() { return kCounters; }

// Both entry points launch on `stream` of device `device`, do not
// synchronise, and return cudaGetLastError() after the launch (0 = success).
// `stats` (N, 3) int32 and `counters` (cluster_counters() uint64) may be
// null; `err` is one int on the card that the walk ORs its error bits into.
int cluster_closest(const float* o, const float* d, const float* t_min,
                    const float* t_max, const float* nodes, int n_nodes,
                    const float* tris, int n_clusters, int n, float* t_out,
                    int* slot_out, float* u_out, float* v_out, int* stats,
                    unsigned long long* counters, int* err, int device,
                    void* stream) {
  const Args a = {o, d, t_min, t_max, reinterpret_cast<const float4*>(nodes), tris,
                  t_out, slot_out, u_out, v_out, nullptr, stats, counters, err, n_nodes,
                  n_clusters, n};
  return launch(counters ? cluster_closest_counted_kernel : cluster_closest_kernel, a, device,
                stream);
}

int cluster_any(const float* o, const float* d, const float* t_min,
                const float* t_max, const float* nodes, int n_nodes,
                const float* tris, int n_clusters, int n, int* occ_out,
                int* stats, unsigned long long* counters, int* err, int device,
                void* stream) {
  const Args a = {o, d, t_min, t_max, reinterpret_cast<const float4*>(nodes), tris,
                  nullptr, nullptr, nullptr, nullptr, occ_out, stats, counters, err, n_nodes,
                  n_clusters, n};
  return launch(counters ? cluster_any_counted_kernel : cluster_any_kernel, a, device, stream);
}

}  // extern "C"
