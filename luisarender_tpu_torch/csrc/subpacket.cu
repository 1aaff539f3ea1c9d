// Closest-hit and any-hit traversal of the 8-wide cluster tree with Woop
// triangle tests, for Hopper (sm_90a), called through a plain C interface
// (ctypes): the opt-in subpacket route (LR_SUBPACKET=1).
//
// Replaces the TPU kernel of luisarender_tpu/ops/subpacket_pallas.py:
// _subpacket_kernel (subpacket_pallas.py:322), in its closest and any-hit
// modes (trace_closest_subpacket / trace_any_subpacket). The contract is
// its: the 8-wide tables (slab8 (N8, 8, 128), meta8 (N8, 16)) and the Woop
// blocks (C, 8, 1024) of ops/subpacket.py; t_max clamped to 3e38; each
// triangle j of a leaf cluster tested with the ray features [ox, oy, oz, 1,
// dx, dy, dz, 0]: o' and d' the dot products of the block's columns with
// them in row order as fused multiply-adds (the TPU kernel's Woop matmul as
// XLA compiles it on the CPU, where its results are checked; the terms on
// the rows the block holds zero in are left out, since adding an exact zero
// changes no result), t = -o'z / d'z, u = fma(t, d'x, o'x), v = fma(t,
// d'y, o'y), a hit needing
// u, v >= 0, u + v <= 1, t_min < t < best_t, slot >= 0 and, any-hit, an
// opacity above 0.5; within a cluster the least t wins and on equal t the
// least slot, across clusters a strict t < best_t. It returns (t, slot); the
// wrapper returns u = v = NaN (scene/geometry.py recomputes them from the
// shade row, as in the reference).
//
// What bounds it: the rays' bytes and the Woop rows. A pop tests 8 child
// boxes (~20 float operations each), and a cluster's rows cost 39
// operations each (a fused multiply-add counted as 2); the bytes are the rays in and out (40 B a ray) and the
// nodes and Woop columns the walk touches, read once. This simple kernel,
// in divergent per-ray loops, takes far longer than either (its times and
// bounds are in PERF.md).
// Design, per thread where the TPU kernel worked per 128-ray subpacket: one
// thread a ray, 128 threads a block; the walk of trace_common.cuh walk8
// with a per-thread stack in local memory of 128 ints, or 2,048 for a tree
// whose bound needs more (the TPU kernel kept a 2,176-entry SMEM stack a
// subpacket and popped four nodes at a time);
// near-first along the ray's own direction (the TPU kernel used the
// subpacket's summed direction); a cluster's Woop columns read from global
// memory through the read-only cache, padding rows (slot -1) skipped; an
// any-hit ray stops at its first opaque occluder. The walk stops with a bit
// of the error word after 4 N8 + 64 pops, on a stack deeper than the
// tree's bound or a child code out of range; the wrapper reads it and raises. The TPU
// kernel's ray sort, leaf queue, DMA pipeline and matmuls are TPU mechanics
// and are not carried over.
//
// Build with --fmad=false and without fast math: the plain PyTorch version
// (ops/subpacket.py walk8_plain, woop_tests, its fma32 a correctly rounded
// fused multiply-add) then does the same IEEE operations in the same
// per-lane order and the two agree bit for bit.

#include "trace_common.cuh"

namespace {

using lrt::kBig;
using lrt::kCluster;
using lrt::Ray;

constexpr int kThreads = 128;
constexpr int kWoopCols = 8 * kCluster;

// A leaf cluster's Woop rows, for walk8.
template <bool kAny>
struct WoopLeaf {
  const Ray& r;
  const float* __restrict__ woop;
  int best_s = -1;
  int occ = 0;
  int leaves = 0, rows = 0;

  __device__ WoopLeaf(const Ray& ray, const float* w) : r(ray), woop(w) {}

  __device__ __forceinline__ bool operator()(int blk, float& best_t) {
    ++leaves;
    const float* w = woop + static_cast<size_t>(blk) * (8 * kWoopCols);
    // coefficient of feature row k in column group g, triangle j
#define W(k, g) __ldg(w + (k) * kWoopCols + (g) * kCluster + j)
    bool found = false;
    float ct = 0.0f, cs = 0.0f;
    for (int j = 0; j < kCluster; ++j) {
      const float slot = W(3, 6);
      if (!(slot >= 0.0f)) continue;  // padding or a degenerate triangle
      ++rows;
      // the reference's matmul as a chain of fused multiply-adds in row
      // order, and u, v as fused multiply-adds (explicit fmaf: --fmad=false
      // contracts nothing else)
      const float opx = fmaf(W(2, 0), r.oz, fmaf(W(1, 0), r.oy, W(0, 0) * r.ox)) + W(3, 0);
      const float opy = fmaf(W(2, 1), r.oz, fmaf(W(1, 1), r.oy, W(0, 1) * r.ox)) + W(3, 1);
      const float opz = fmaf(W(2, 2), r.oz, fmaf(W(1, 2), r.oy, W(0, 2) * r.ox)) + W(3, 2);
      const float dpx = fmaf(W(6, 3), r.dz, fmaf(W(5, 3), r.dy, W(4, 3) * r.dx));
      const float dpy = fmaf(W(6, 4), r.dz, fmaf(W(5, 4), r.dy, W(4, 4) * r.dx));
      const float dpz = fmaf(W(6, 5), r.dz, fmaf(W(5, 5), r.dy, W(4, 5) * r.dx));
      const float t = -opz / dpz;
      const float u = fmaf(t, dpx, opx);
      const float v = fmaf(t, dpy, opy);
      if (!(u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > r.tmin && t < best_t))
        continue;
      if (kAny) {
        if (W(3, 7) > 0.5f) {
          occ = 1;
          return true;
        }
      } else if (!found || t < ct || (t == ct && slot < cs)) {
        found = true;
        ct = t;
        cs = slot;
      }
    }
#undef W
    if (found) {
      best_t = ct;
      best_s = static_cast<int>(cs);
    }
    return false;
  }
};

template <bool kAny, int kCap>
__device__ __forceinline__ void trace_ray(
    int i, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_min, const float* __restrict__ t_max,
    const float4* __restrict__ slab8, const float4* __restrict__ meta8, int n8,
    const float* __restrict__ woop, int n_clusters, int cap,
    float* __restrict__ t_out, int* __restrict__ slot_out,
    int* __restrict__ occ_out, int* __restrict__ stats,
    int* __restrict__ err) {
  const Ray r = lrt::load_ray(i, o, d, t_min);
  const float tmx = t_max[i];
  float best_t = tmx < kBig ? tmx : kBig;
  WoopLeaf<kAny> leaf(r, woop);
  int pops = 0;
  if (r.tmin < best_t) {  // lanes dead on entry leave at once
    lrt::walk8<kCap>(r, best_t, slab8, meta8, n8, n_clusters, cap, leaf, pops,
                     err);
  }
  if (kAny) {
    occ_out[i] = leaf.occ;
  } else {
    t_out[i] = leaf.best_s >= 0 ? best_t : __int_as_float(0x7f800000);
    slot_out[i] = leaf.best_s;
  }
  if (stats != nullptr) {
    stats[3 * i] = pops;
    stats[3 * i + 1] = leaf.leaves;
    stats[3 * i + 2] = leaf.rows;
  }
}

template <int kCap>
__global__ void __launch_bounds__(kThreads)
    subpacket_closest_kernel(const float* __restrict__ o,
                             const float* __restrict__ d,
                             const float* __restrict__ t_min,
                             const float* __restrict__ t_max,
                             const float4* __restrict__ slab8,
                             const float4* __restrict__ meta8, int n8,
                             const float* __restrict__ woop, int n_clusters,
                             int cap, int n, float* __restrict__ t_out,
                             int* __restrict__ slot_out,
                             int* __restrict__ stats, int* __restrict__ err) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  trace_ray<false, kCap>(i, o, d, t_min, t_max, slab8, meta8, n8, woop,
                         n_clusters, cap, t_out, slot_out, nullptr, stats, err);
}

template <int kCap>
__global__ void __launch_bounds__(kThreads)
    subpacket_any_kernel(const float* __restrict__ o,
                         const float* __restrict__ d,
                         const float* __restrict__ t_min,
                         const float* __restrict__ t_max,
                         const float4* __restrict__ slab8,
                         const float4* __restrict__ meta8, int n8,
                         const float* __restrict__ woop, int n_clusters,
                         int cap, int n, int* __restrict__ occ_out,
                         int* __restrict__ stats, int* __restrict__ err) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  trace_ray<true, kCap>(i, o, d, t_min, t_max, slab8, meta8, n8, woop,
                        n_clusters, cap, nullptr, nullptr, occ_out, stats, err);
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` of device `device`, do not
// synchronise, and return cudaGetLastError() after the launch (0 = success).
// `stack` is the tree's stack bound (ops/cluster.py stack_need), at most
// lrt::kStack8Large; the launch takes the least stack that holds it.
// `stats` may be null; `err` is one int on the card that the walk ORs its
// error bits into.
int subpacket_closest(const float* o, const float* d, const float* t_min,
                      const float* t_max, const float* slab8,
                      const float* meta8, int n8, const float* woop,
                      int n_clusters, int stack, int n, float* t_out,
                      int* slot_out, int* stats, int* err, int device,
                      void* stream) {
  if (n <= 0 || n8 <= 0 || stack < 1 || stack > lrt::kStack8Large)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = stack <= lrt::kStack8Small
                    ? subpacket_closest_kernel<lrt::kStack8Small>
                    : subpacket_closest_kernel<lrt::kStack8Large>;
  kernel<<<lrt::blocks_for(n, kThreads), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      o, d, t_min, t_max, reinterpret_cast<const float4*>(slab8),
      reinterpret_cast<const float4*>(meta8), n8, woop, n_clusters, stack, n,
      t_out, slot_out, stats, err);
  return static_cast<int>(cudaGetLastError());
}

int subpacket_any(const float* o, const float* d, const float* t_min,
                  const float* t_max, const float* slab8, const float* meta8,
                  int n8, const float* woop, int n_clusters, int stack, int n,
                  int* occ_out, int* stats, int* err, int device,
                  void* stream) {
  if (n <= 0 || n8 <= 0 || stack < 1 || stack > lrt::kStack8Large)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = stack <= lrt::kStack8Small
                    ? subpacket_any_kernel<lrt::kStack8Small>
                    : subpacket_any_kernel<lrt::kStack8Large>;
  kernel<<<lrt::blocks_for(n, kThreads), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      o, d, t_min, t_max, reinterpret_cast<const float4*>(slab8),
      reinterpret_cast<const float4*>(meta8), n8, woop, n_clusters, stack, n,
      occ_out, stats, err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
