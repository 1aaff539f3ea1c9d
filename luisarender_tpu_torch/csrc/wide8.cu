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
// out (48 B a ray) and the nodes and blocks the walk touches, read once.
// This simple kernel, in divergent per-ray loops, takes far longer than
// either (its times and bounds are in PERF.md).
// Design, per thread where the TPU kernel worked per packet: one thread a
// ray, 128 threads a block; the walk of trace_common.cuh walk8 with a
// per-thread stack in local memory of 128 ints, or 2,048 for a tree whose
// bound needs more (the TPU kernel shared one SMEM stack of 2,176 entries
// across a 2,048-ray packet and popped two nodes at a time); a node's 8 child boxes as 12 float4 loads through the
// read-only cache, near-first along the ray's own direction (the TPU kernel
// used the packet's summed direction); a leaf's rows read from global
// memory through the read-only cache, padding rows skipped; an any-hit ray
// stops at its first opaque occluder. The walk stops with a bit of the
// error word after 4 N8 + 64 pops, on a stack deeper than the tree's bound
// or a child code out of range; the wrapper reads it and raises. The TPU kernel's ray
// sort, leaf queue, DMA pipeline and slab matmul are TPU mechanics and are
// not carried over.
//
// Build with --fmad=false and without fast math: the plain PyTorch version
// (ops/wide8.py wide8_plain) then does the same IEEE operations in the same
// per-lane order and the two agree bit for bit.

#include "trace_common.cuh"

namespace {

using lrt::kBig;
using lrt::kCluster;
using lrt::kTriCols;
using lrt::Ray;

constexpr int kThreads = 128;

// A leaf cluster's box re-test and rows, for walk8.
template <bool kAny>
struct MtLeaf {
  const Ray& r;
  const float4* __restrict__ cboxes;
  const float* __restrict__ tris;
  int best_s = -1;
  float best_u = 0.0f, best_v = 0.0f;
  int occ = 0;
  int leaves = 0, rows = 0;

  __device__ MtLeaf(const Ray& ray, const float4* cb, const float* tr)
      : r(ray), cboxes(cb), tris(tr) {}

  __device__ __forceinline__ bool operator()(int blk, float& best_t) {
    if (!lrt::slab(__ldg(cboxes + 2 * blk), __ldg(cboxes + 2 * blk + 1), r, best_t))
      return false;
    ++leaves;
    const float* b = tris + static_cast<size_t>(blk) * (kTriCols * kCluster);
    for (int j = 0; j < kCluster; ++j) {
      if (!(__ldg(b + 9 * kCluster + j) > 0.0f)) continue;  // padding
      ++rows;
      float t, u, v;
      const bool inside = lrt::block_row_mt(b, j, r, t, u, v);
      if (!(inside && t > r.tmin && t < best_t)) continue;
      if (kAny) {
        if (__ldg(b + 10 * kCluster + j) > 0.0f) {
          occ = 1;
          return true;
        }
      } else {
        best_t = t;
        best_s = static_cast<int>(__ldg(b + 11 * kCluster + j));
        best_u = u;
        best_v = v;
      }
    }
    return false;
  }
};

template <bool kAny, int kCap>
__device__ __forceinline__ void trace_ray(
    int i, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_min, const float* __restrict__ t_max,
    const float4* __restrict__ slab8, const float4* __restrict__ meta8, int n8,
    const float4* __restrict__ cboxes, const float* __restrict__ tris,
    int n_clusters, int cap, float* __restrict__ t_out,
    int* __restrict__ slot_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ occ_out,
    int* __restrict__ stats, int* __restrict__ err) {
  const Ray r = lrt::load_ray(i, o, d, t_min);
  const float tmx = t_max[i];
  float best_t = tmx < kBig ? tmx : kBig;
  MtLeaf<kAny> leaf(r, cboxes, tris);
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
    u_out[i] = leaf.best_u;
    v_out[i] = leaf.best_v;
  }
  if (stats != nullptr) {
    stats[3 * i] = pops;
    stats[3 * i + 1] = leaf.leaves;
    stats[3 * i + 2] = leaf.rows;
  }
}

template <int kCap>
__global__ void __launch_bounds__(kThreads)
    wide8_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                         const float* __restrict__ t_min,
                         const float* __restrict__ t_max,
                         const float4* __restrict__ slab8,
                         const float4* __restrict__ meta8, int n8,
                         const float4* __restrict__ cboxes,
                         const float* __restrict__ tris, int n_clusters,
                         int cap, int n, float* __restrict__ t_out,
                         int* __restrict__ slot_out, float* __restrict__ u_out,
                         float* __restrict__ v_out, int* __restrict__ stats,
                         int* __restrict__ err) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  trace_ray<false, kCap>(i, o, d, t_min, t_max, slab8, meta8, n8, cboxes, tris,
                         n_clusters, cap, t_out, slot_out, u_out, v_out,
                         nullptr, stats, err);
}

template <int kCap>
__global__ void __launch_bounds__(kThreads)
    wide8_any_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ t_min,
                     const float* __restrict__ t_max,
                     const float4* __restrict__ slab8,
                     const float4* __restrict__ meta8, int n8,
                     const float4* __restrict__ cboxes,
                     const float* __restrict__ tris, int n_clusters, int cap,
                     int n, int* __restrict__ occ_out, int* __restrict__ stats,
                     int* __restrict__ err) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  trace_ray<true, kCap>(i, o, d, t_min, t_max, slab8, meta8, n8, cboxes, tris,
                        n_clusters, cap, nullptr, nullptr, nullptr, nullptr,
                        occ_out, stats, err);
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` of device `device`, do not
// synchronise, and return cudaGetLastError() after the launch (0 = success).
// `stack` is the tree's stack bound (ops/cluster.py stack_need), at most
// lrt::kStack8Large; the launch takes the least stack that holds it.
// `stats` may be null; `err` is one int on the card that the walk ORs its
// error bits into.
int wide8_closest(const float* o, const float* d, const float* t_min,
                  const float* t_max, const float* slab8, const float* meta8,
                  int n8, const float* cboxes, const float* tris,
                  int n_clusters, int stack, int n, float* t_out,
                  int* slot_out, float* u_out, float* v_out, int* stats,
                  int* err, int device, void* stream) {
  if (n <= 0 || n8 <= 0 || stack < 1 || stack > lrt::kStack8Large)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = stack <= lrt::kStack8Small ? wide8_closest_kernel<lrt::kStack8Small>
                                           : wide8_closest_kernel<lrt::kStack8Large>;
  kernel<<<lrt::blocks_for(n, kThreads), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      o, d, t_min, t_max, reinterpret_cast<const float4*>(slab8),
      reinterpret_cast<const float4*>(meta8), n8,
      reinterpret_cast<const float4*>(cboxes), tris, n_clusters, stack, n,
      t_out, slot_out, u_out, v_out, stats, err);
  return static_cast<int>(cudaGetLastError());
}

int wide8_any(const float* o, const float* d, const float* t_min,
              const float* t_max, const float* slab8, const float* meta8,
              int n8, const float* cboxes, const float* tris, int n_clusters,
              int stack, int n, int* occ_out, int* stats, int* err, int device,
              void* stream) {
  if (n <= 0 || n8 <= 0 || stack < 1 || stack > lrt::kStack8Large)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = stack <= lrt::kStack8Small ? wide8_any_kernel<lrt::kStack8Small>
                                           : wide8_any_kernel<lrt::kStack8Large>;
  kernel<<<lrt::blocks_for(n, kThreads), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      o, d, t_min, t_max, reinterpret_cast<const float4*>(slab8),
      reinterpret_cast<const float4*>(meta8), n8,
      reinterpret_cast<const float4*>(cboxes), tris, n_clusters, stack, n,
      occ_out, stats, err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
