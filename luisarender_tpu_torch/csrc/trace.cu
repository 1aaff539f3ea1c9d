// Closest-hit traversal of the scene's binary SAH tree, a few triangles a
// leaf, for Hopper (sm_90a), called through a plain C interface (ctypes).
//
// Replaces the TPU kernel of luisarender_tpu/ops/trace_pallas.py:
// _traverse_kernel (trace_pallas.py:83, trace_closest_pallas). The contract
// is its: the tables of ops/trace.py pack_tables (nodes (N, 16): box, skip
// link, count, first row; triangles (P, 16): v0, e1, e2, original index);
// the preorder walk (left child node + 1, right child skip[node + 1], the
// right one pushed first); t_max clamped to 3e38; a leaf's first
// min(count, leaf_size) rows tested in order with the reference's
// Moller-Trumbore (|det| > 1e-12, u, v >= 0, u + v <= 1, t_min < t < best_t,
// index >= 0) and a strict t < best_t; a hit's prim the row first + j; a
// miss returning t = inf, prim = -1, u = v = 0. No router reaches it, as in
// the reference.
//
// What bounds it: a ray pops tens of nodes (~20 float operations each) and
// tests a few rows a leaf (46 operations each); the bytes are the rays in
// and out (48 B a ray) and the node and triangle rows the walk touches,
// read once. This simple kernel, in divergent per-ray loops, takes far
// longer than either (its times and bounds are in PERF.md).
// Design, per thread where the TPU kernel worked per 1,024-ray packet: one
// thread a ray, 128 threads a block; a per-thread stack in local memory of
// 64 ints, or 512 for a tree whose bound needs more (the tree of the
// 512k-triangle scene needs 23; the TPU kernel shared one SMEM stack of 96
// entries across the packet and entered a node when any of its rays hit
// the box); node and triangle rows as float4 loads
// through the read-only cache (the TPU kernel fetched rows by one-hot
// matmuls). The walk stops with a bit of the error word after 4 N + 64
// pops, on a stack deeper than the tree's bound or an index out of range;
// the wrapper reads it and raises.
//
// Build with --fmad=false and without fast math: the plain PyTorch version
// (ops/trace.py walk_plain) then does the same IEEE operations in the same
// per-lane order and the two agree bit for bit.

#include "trace_common.cuh"

namespace {

using lrt::kBig;
using lrt::kErrIndex;
using lrt::kErrStack;
using lrt::kErrSteps;
using lrt::Ray;

constexpr int kThreads = 128;

// kCap: the entries of the per-thread stack; cap (<= kCap): the tree's
// bound, which the walk checks
template <int kCap>
__global__ void __launch_bounds__(kThreads)
    trace_closest_kernel(const float* __restrict__ o,
                         const float* __restrict__ d,
                         const float* __restrict__ t_min,
                         const float* __restrict__ t_max,
                         const float4* __restrict__ nodes, int n_nodes,
                         const float4* __restrict__ tris, int n_rows,
                         int leaf_size, int cap, int n,
                         float* __restrict__ t_out,
                         int* __restrict__ prim_out, float* __restrict__ u_out,
                         float* __restrict__ v_out, int* __restrict__ stats,
                         int* __restrict__ err) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Ray r = lrt::load_ray(i, o, d, t_min);
  const float tmx = t_max[i];
  float best_t = tmx < kBig ? tmx : kBig;
  int best_p = -1;
  float best_u = 0.0f, best_v = 0.0f;
  int pops = 0, leaves = 0, rows = 0;
  const int max_steps = 4 * n_nodes + 64;

  if (r.tmin < best_t) {  // lanes dead on entry leave at once
    int stack[kCap];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      if (pops >= max_steps) {
        atomicOr(err, kErrSteps);
        break;
      }
      ++pops;
      const int node = stack[--sp];
      // row = (min.xyz, max.x), (max.yz, skip, count), (first, ..)
      const float4 a = __ldg(nodes + 4 * node);
      const float4 b = __ldg(nodes + 4 * node + 1);
      if (!lrt::slab(a, b, r, best_t)) continue;
      const int cnt = static_cast<int>(b.w);
      if (cnt > 0) {  // leaf: its rows, in order
        const int first = static_cast<int>(__ldg(nodes + 4 * node + 2).x);
        const int m = cnt < leaf_size ? cnt : leaf_size;
        if (first < 0 || first + m > n_rows) {
          atomicOr(err, kErrIndex);
          break;
        }
        ++leaves;
        rows += m;
        for (int j = 0; j < m; ++j) {
          // row = (v0.xyz, e1.x), (e1.yz, e2.xy), (e2.z, index, ..)
          const float4 f0 = __ldg(tris + 4 * (first + j));
          const float4 f1 = __ldg(tris + 4 * (first + j) + 1);
          const float4 f2 = __ldg(tris + 4 * (first + j) + 2);
          float t, u, v;
          bool big_det;
          const bool inside = lrt::moller_trumbore(
              f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, f1.z, f1.w, f2.x, r, t, u, v,
              big_det);
          if (big_det && inside && t > r.tmin && t < best_t && f2.y >= 0.0f) {
            best_t = t;
            best_p = first + j;
            best_u = u;
            best_v = v;
          }
        }
      } else {  // interior: push the right child, then the left
        const int left = node + 1;
        if (left >= n_nodes) {
          atomicOr(err, kErrIndex);
          break;
        }
        const int right = static_cast<int>(__ldg(nodes + 4 * left + 1).z);
        if (right < 0 || right >= n_nodes) {
          atomicOr(err, kErrIndex);
          break;
        }
        if (sp + 2 > cap) {
          atomicOr(err, kErrStack);
          break;
        }
        stack[sp] = right;
        stack[sp + 1] = left;
        sp += 2;
      }
    }
  }
  t_out[i] = best_p >= 0 ? best_t : __int_as_float(0x7f800000);
  prim_out[i] = best_p;
  u_out[i] = best_u;
  v_out[i] = best_v;
  if (stats != nullptr) {
    stats[3 * i] = pops;
    stats[3 * i + 1] = leaves;
    stats[3 * i + 2] = rows;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` of device `device`, does not synchronise, and returns
// cudaGetLastError() after the launch (0 = success). `stack` is the tree's
// stack bound (ops/cluster.py stack_need), at most lrt::kStack2Large; the
// launch takes the least stack that holds it. `stats` may be null; `err` is
// one int on the card that the walk ORs its error bits into.
int trace_closest(const float* o, const float* d, const float* t_min,
                  const float* t_max, const float* nodes, int n_nodes,
                  const float* tris, int n_rows, int leaf_size, int stack,
                  int n, float* t_out, int* prim_out, float* u_out,
                  float* v_out, int* stats, int* err, int device,
                  void* stream) {
  if (n <= 0 || n_nodes <= 0 || stack < 1 || stack > lrt::kStack2Large)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  auto kernel = stack <= lrt::kStack2Small
                    ? trace_closest_kernel<lrt::kStack2Small>
                    : trace_closest_kernel<lrt::kStack2Large>;
  kernel<<<lrt::blocks_for(n, kThreads), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      o, d, t_min, t_max, reinterpret_cast<const float4*>(nodes), n_nodes,
      reinterpret_cast<const float4*>(tris), n_rows, leaf_size, stack, n,
      t_out, prim_out, u_out, v_out, stats, err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
