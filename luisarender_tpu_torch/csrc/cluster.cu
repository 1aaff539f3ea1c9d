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
// and safe inverse, the same Moller-Trumbore, t_max clamped to 3e38, a leaf's
// rows tested in order with a strict t < best_t (so ties inside a cluster
// resolve as the reference's), a hit's slot read from the block, and a miss
// returning t = inf, slot = -1, u = v = 0.
//
// What bounds it: the triangle rows. A ray pops ~20-60 nodes (~20 float
// operations each) and visits a few leaves of up to 128 rows (46 operations
// a row). At the main path's shapes (921,600 rays, 512k triangles) those
// operations and the bytes the walk must move (rays in and hits out, 48 B a
// ray, the 0.4 MB node table, and the attributes it reads of the blocks some
// ray visits, read once) would take the card about the same least time;
// this simple kernel, in divergent per-ray loops, takes far longer (its
// times and bounds are in PERF.md).
// Design, per thread where the TPU kernel worked per packet: one thread a
// ray, 128 threads a block; a per-thread stack of 64 ints in local memory
// (the TPU kernel shared one SMEM stack across a 2048-ray packet, a
// speculative-packet mechanism); the node table and blocks read from global
// memory through the read-only cache (a node row is two float4 loads; the
// node table stays in L2, the blocks do not fit shared memory); near child
// first along the ray's own direction (the TPU kernel used the packet's
// mean direction); padding rows skipped. The walk stops at a stack deeper
// than 64 or after 4 N + 64 pops, and sets a bit of the error word, which
// the wrapper reads and raises on: neither happens on a well-formed tree.
// The TPU kernel's ray sort, DMA pipeline and speculative packets are TPU
// mechanics and are not carried over.
//
// Build with --fmad=false and without fast math: the plain PyTorch version
// (ops/cluster.py walk_plain) then does the same IEEE operations in the same
// per-lane order and the two agree bit for bit.

#include "trace_common.cuh"

namespace {

using lrt::kBig;
using lrt::kCluster;
using lrt::kErrIndex;
using lrt::kErrStack;
using lrt::kErrSteps;
using lrt::kTriCols;
using lrt::Ray;

constexpr int kThreads = 128;
constexpr int kStack = 64;

// One ray's walk; the two kernels below are its two modes.
template <bool kAny>
__device__ __forceinline__ void walk(
    int i, const float* __restrict__ o, const float* __restrict__ d,
    const float* __restrict__ t_min, const float* __restrict__ t_max,
    const float4* __restrict__ nodes, int n_nodes,
    const float* __restrict__ tris, int n_clusters, float* __restrict__ t_out,
    int* __restrict__ slot_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int* __restrict__ occ_out,
    int* __restrict__ stats, int* __restrict__ err) {
  const Ray r = lrt::load_ray(i, o, d, t_min);
  const float tmx = t_max[i];
  float best_t = tmx < kBig ? tmx : kBig;
  int best_s = -1;
  float best_u = 0.0f, best_v = 0.0f;
  int occ = 0;
  int pops = 0, leaves = 0, rows = 0;
  const int max_steps = 4 * n_nodes + 64;

  if (r.tmin < best_t) {  // lanes dead on entry leave at once
    int stack[kStack];
    int sp = 0;
    stack[sp++] = 0;
    while (sp > 0) {
      if (pops >= max_steps) {
        atomicOr(err, kErrSteps);
        break;
      }
      ++pops;
      const int node = stack[--sp];
      const float4 a = __ldg(nodes + 2 * node);
      const float4 b = __ldg(nodes + 2 * node + 1);
      if (!lrt::slab(a, b, r, best_t)) continue;
      const float rf = floorf(b.z);
      const int first = static_cast<int>(b.w);
      if (first >= 0) {  // leaf: its block's rows, in order
        if (first >= n_clusters) {
          atomicOr(err, kErrIndex);
          break;
        }
        ++leaves;
        const float* blk =
            tris + static_cast<size_t>(first) * (kTriCols * kCluster);
        for (int j = 0; j < kCluster; ++j) {
          if (!(__ldg(blk + 9 * kCluster + j) > 0.0f)) continue;  // padding
          ++rows;
          float t, u, v;
          const bool inside = lrt::block_row_mt(blk, j, r, t, u, v);
          if (!(inside && t > r.tmin && t < best_t)) continue;
          if (kAny) {
            if (__ldg(blk + 10 * kCluster + j) > 0.0f) {
              occ = 1;
              break;
            }
          } else {
            best_t = t;
            best_s = static_cast<int>(__ldg(blk + 11 * kCluster + j));
            best_u = u;
            best_v = v;
          }
        }
        if (kAny && occ) break;
      } else {  // interior: push the far child, then the near one
        const int right = static_cast<int>(rf);
        const int left = node + 1;
        if (right < 0 || right >= n_nodes || left >= n_nodes) {
          atomicOr(err, kErrIndex);
          break;
        }
        if (sp + 2 > kStack) {
          atomicOr(err, kErrStack);
          break;
        }
        const float frac4 = (b.z - rf) * 4.0f;
        const float axf = floorf(frac4 + 0.25f);
        const bool left_high = (frac4 - axf) > 0.125f;
        const int axis = static_cast<int>(axf);
        const float dax = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
        const bool left_near = (dax >= 0.0f) != left_high;
        stack[sp] = left_near ? right : left;
        stack[sp + 1] = left_near ? left : right;
        sp += 2;
      }
    }
  }
  if (kAny) {
    occ_out[i] = occ;
  } else {
    t_out[i] = best_s >= 0 ? best_t : __int_as_float(0x7f800000);
    slot_out[i] = best_s;
    u_out[i] = best_u;
    v_out[i] = best_v;
  }
  if (stats != nullptr) {
    stats[3 * i] = pops;
    stats[3 * i + 1] = leaves;
    stats[3 * i + 2] = rows;
  }
}

__global__ void __launch_bounds__(kThreads)
    cluster_closest_kernel(const float* __restrict__ o,
                           const float* __restrict__ d,
                           const float* __restrict__ t_min,
                           const float* __restrict__ t_max,
                           const float4* __restrict__ nodes, int n_nodes,
                           const float* __restrict__ tris, int n_clusters,
                           int n, float* __restrict__ t_out,
                           int* __restrict__ slot_out,
                           float* __restrict__ u_out,
                           float* __restrict__ v_out, int* __restrict__ stats,
                           int* __restrict__ err) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  walk<false>(i, o, d, t_min, t_max, nodes, n_nodes, tris, n_clusters, t_out,
              slot_out, u_out, v_out, nullptr, stats, err);
}

__global__ void __launch_bounds__(kThreads)
    cluster_any_kernel(const float* __restrict__ o,
                       const float* __restrict__ d,
                       const float* __restrict__ t_min,
                       const float* __restrict__ t_max,
                       const float4* __restrict__ nodes, int n_nodes,
                       const float* __restrict__ tris, int n_clusters, int n,
                       int* __restrict__ occ_out, int* __restrict__ stats,
                       int* __restrict__ err) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  walk<true>(i, o, d, t_min, t_max, nodes, n_nodes, tris, n_clusters, nullptr,
             nullptr, nullptr, nullptr, occ_out, stats, err);
}

int blocks_for(int n) { return lrt::blocks_for(n, kThreads); }

}  // namespace

extern "C" {

// Both entry points launch on `stream` of device `device`, do not
// synchronise, and return cudaGetLastError() after the launch (0 = success).
// `stats` may be null; `err` is one int on the card that the walk ORs its
// error bits into.
int cluster_closest(const float* o, const float* d, const float* t_min,
                    const float* t_max, const float* nodes, int n_nodes,
                    const float* tris, int n_clusters, int n, float* t_out,
                    int* slot_out, float* u_out, float* v_out, int* stats,
                    int* err, int device, void* stream) {
  if (n <= 0 || n_nodes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cluster_closest_kernel<<<blocks_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      o, d, t_min, t_max, reinterpret_cast<const float4*>(nodes), n_nodes,
      tris, n_clusters, n, t_out, slot_out, u_out, v_out, stats, err);
  return static_cast<int>(cudaGetLastError());
}

int cluster_any(const float* o, const float* d, const float* t_min,
                const float* t_max, const float* nodes, int n_nodes,
                const float* tris, int n_clusters, int n, int* occ_out,
                int* stats, int* err, int device, void* stream) {
  if (n <= 0 || n_nodes <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cluster_any_kernel<<<blocks_for(n), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      o, d, t_min, t_max, reinterpret_cast<const float4*>(nodes), n_nodes,
      tris, n_clusters, n, occ_out, stats, err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
