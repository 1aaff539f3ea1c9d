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
// over to the 8-wide tree. Each lane walks its own ray: a pop tests the
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

using lrt::kBig;
using lrt::kErrIndex;
using lrt::kErrStack;
using lrt::kErrSteps;
using lrt::kFull;
using lrt::Ray;

constexpr int kThreads = 128;
// resident blocks an SM asked of ptxas: closest hits at five (96
// registers), any-hit at six (80, a few bytes of spill), the faster of
// four to eight in wide8_ab.py's turns for each mode
constexpr int kBlocksPerSmClosest = 5, kBlocksPerSmAny = 6;
// the per-lane stacks of the two builds (ops/wide8.py STACKS)
constexpr int kStackSmall = 48, kStackLarge = lrt::kStack8Large;

// lane counters: trace_common.cuh CTR_*, then
enum {
  CTR_CULLED = lrt::kWalkCounters,  // pending leaves dropped by the box re-test
  kCounters
};

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

// One lane's walk of one ray, but for its stack (kept apart, so that these
// stay in registers while the stack is in local memory).
struct Walk {
  Ray r;
  float nox, noy, noz;  // -o * inv, the planes' offsets
  float best_t, best_u, best_v;
  int best_s, occ, pops, leaves, rows, sp;
  int node;          // the last node popped
  unsigned pending;  // its hit leaf children not yet taken (child bits)
  bool asc;          // its children's visit order: ascending child index
  bool overflow;     // its interior children did not fit the stack
  bool live;         // the walk has pops or leaves left (or a parked leaf)
};

__device__ __forceinline__ void begin(Walk& w, int* stack, int i, const Args& a) {
  w.r = lrt::load_ray(i, a.o, a.d, a.t_min);
  w.nox = (-w.r.ox) * w.r.ix;
  w.noy = (-w.r.oy) * w.r.iy;
  w.noz = (-w.r.oz) * w.r.iz;
  const float tmx = a.t_max[i];
  w.best_t = tmx < kBig ? tmx : kBig;
  w.best_s = -1;
  w.best_u = w.best_v = 0.0f;
  w.occ = w.pops = w.leaves = w.rows = w.sp = w.node = 0;
  w.pending = 0;
  w.asc = w.overflow = false;
  w.live = w.r.tmin < w.best_t;  // rays dead on entry never pop
  if (w.live) stack[w.sp++] = 0;
}

// A lane without a ray: it only takes part in the warp's leaf stage.
__device__ __forceinline__ void idle(Walk& w) {
  w.r = Ray{};
  w.nox = w.noy = w.noz = 0.0f;
  w.best_t = w.best_u = w.best_v = 0.0f;
  w.best_s = -1;
  w.occ = w.pops = w.leaves = w.rows = w.sp = w.node = 0;
  w.pending = 0;
  w.asc = w.overflow = w.live = false;
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

// Pops the top of the stack: tests its 8 child boxes against best_t as it
// stands, checks every hit child's code, keeps the hit leaf children as
// the pending mask and pushes the hit interior children in reverse visit
// order, so the nearest pops next (or marks the overflow, raised once the
// pending leaves are done). Returns false on a code out of range.
__device__ __forceinline__ bool pop(Walk& w, int* stack, const Args& a) {
  const int node = stack[--w.sp];
  // row a of the node's slab block holds, at float4 36 a + q, the low
  // plane of axis a for children 0-3 (q = 0) and 4-7 (q = 1), the high
  // plane for children 0-3 (q = 2) and 4-7 (q = 3)
  const float4* s = a.slab8 + static_cast<size_t>(node) * (8 * 128 / 4);
  const float4* m = reinterpret_cast<const float4*>(a.meta8) + static_cast<size_t>(node) * 4;
  const float4 m0 = __ldg(m), m1 = __ldg(m + 1), m2 = __ldg(m + 2);
  const float enc[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
  const int packed = static_cast<int>(m2.x);
  const int axis = packed & 3;
  const unsigned leafmask = static_cast<unsigned>(packed >> 2);
  float lo[3][8], hi[3][8];
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float4 l = __ldg(s + 36 * ax + q);
      const float4 h = __ldg(s + 36 * ax + 2 + q);
      lo[ax][4 * q] = l.x;
      lo[ax][4 * q + 1] = l.y;
      lo[ax][4 * q + 2] = l.z;
      lo[ax][4 * q + 3] = l.w;
      hi[ax][4 * q] = h.x;
      hi[ax][4 * q + 1] = h.y;
      hi[ax][4 * q + 2] = h.z;
      hi[ax][4 * q + 3] = h.w;
    }
  }
  const Ray& r = w.r;
  unsigned hits = 0;
  bool bad = false;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float t0x = lo[0][c] * r.ix + w.nox;
    const float t1x = hi[0][c] * r.ix + w.nox;
    const float t0y = lo[1][c] * r.iy + w.noy;
    const float t1y = hi[1][c] * r.iy + w.noy;
    const float t0z = lo[2][c] * r.iz + w.noz;
    const float t1z = hi[2][c] * r.iz + w.noz;
    const float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                             fmaxf(fminf(t0z, t1z), r.tmin));
    const float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                            fminf(fmaxf(t0z, t1z), w.best_t));
    if (near <= far && enc[c] != 0.0f) {
      hits |= 1u << c;
      if ((leafmask >> c) & 1u) {
        const int blk = static_cast<int>(-enc[c] - 1.0f);
        bad |= blk < 0 || blk >= a.n_clusters;
      } else {
        const int idx = static_cast<int>(enc[c]);
        bad |= idx < 1 || idx >= a.n8;
      }
    }
  }
  if (bad) return false;
  const float dax = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
  const bool asc = dax >= 0.0f;
  const unsigned inner = hits & ~leafmask;
  w.node = node;
  w.asc = asc;
  w.pending = hits & leafmask;
  if (w.sp + __popc(inner) > a.cap) {
    w.overflow = true;
    return true;
  }
  // reverse visit order: ascending, child 7 is pushed first; descending,
  // child 0
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if ((inner >> c) & 1u) {
      const unsigned before = asc ? inner >> (c + 1) : inner & ((1u << c) - 1u);
      stack[w.sp + __popc(before)] = static_cast<int>(enc[c]);
    }
  }
  w.sp += __popc(inner);
  return true;
}

// Takes the pending leaves in visit order, each re-tested against the
// current best_t, and pops when none is left, until a leaf's box holds
// (returns its cluster: the lane parks) or the walk ends (returns -1,
// w.live false). `culled` counts the pending leaves the re-test dropped.
__device__ __forceinline__ int to_leaf(Walk& w, int* stack, const Args& a, int& culled) {
  const int max_steps = 4 * a.n8 + 64;
  while (w.live) {
    if (w.pending) {
      const int c = w.asc ? __ffs(w.pending) - 1 : 31 - __clz(w.pending);
      w.pending &= ~(1u << c);
      const int blk = static_cast<int>(-__ldg(a.meta8 + 16 * w.node + c) - 1.0f);
      if (lrt::slab(__ldg(a.cboxes + 2 * blk), __ldg(a.cboxes + 2 * blk + 1), w.r, w.best_t)) {
        ++w.leaves;
        return blk;
      }
      ++culled;
      continue;
    }
    if (w.overflow) {
      atomicOr(a.err, kErrStack);
      break;
    }
    if (w.sp == 0) break;
    if (w.pops >= max_steps) {
      atomicOr(a.err, kErrSteps);
      break;
    }
    ++w.pops;
    if (!pop(w, stack, a)) {
      atomicOr(a.err, kErrIndex);
      break;
    }
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
  int culled = 0;
  const int cl = to_leaf(w, stack, a, culled);
  if (ctr.on) {
    const unsigned run = __reduce_max_sync(kFull, static_cast<unsigned>(w.pops - pops0));
    ctr.c[lrt::CTR_POP_SLOTS] += 32ull * run;
    ctr.c[CTR_CULLED] += __reduce_add_sync(kFull, static_cast<unsigned>(culled));
  }
  return lrt::warp_leaves<kAny>(w, cl, a.tris, ctr);
}

template <bool kAny, bool kCount, int kCap>
__device__ __forceinline__ void trace(const Args& a) {
  const int lane = threadIdx.x & 31;
  lrt::Counters<kCount, kCounters> ctr = {};
  Walk w;
  int stack[kCap];
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
    ctr.c[lrt::CTR_POPS] +=
        __reduce_add_sync(kFull, static_cast<unsigned>(i < a.n ? w.pops : 0));
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kCounters; ++k)
        if (ctr.c[k]) atomicAdd(a.counters + k, ctr.c[k]);
    }
  }
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

// The entries of the build whose stack holds `bound`, 0 if none does.
int stack_build(int bound) {
  if (bound < 1 || bound > kStackLarge) return 0;
  return bound <= kStackSmall ? kStackSmall : kStackLarge;
}

int launch(bool any_hit, const Args& a, int device, void* stream) {
  const int build = stack_build(a.cap);
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
int wide8_stack_build(int bound) { return stack_build(bound); }

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
