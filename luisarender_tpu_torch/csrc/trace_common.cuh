// Device code shared by the trace kernels of csrc/ (cluster.cu, wide8.cu,
// subpacket.cu, trace.cu): the ray, its safe inverse direction, the slab
// test of a box and Moller-Trumbore over a cluster's attribute-major
// triangle block, each in the reference's order of operations
// (luisarender_tpu/ops/cluster_pallas.py), the 8-wide tree walk of the
// subpacket kernel, and the warp leaf stage of the cluster and wide8
// kernels (warp_leaves).
//
// Built with --fmad=false and without fast math: the plain PyTorch versions
// then do the same IEEE operations in the same per-lane order and the
// kernels agree with them bit for bit.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace lrt {

constexpr int kCluster = 128;
constexpr int kTriCols = 16;
constexpr float kBig = 3.0e38f;
constexpr int kErrStack = 1, kErrSteps = 2, kErrIndex = 4;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz, tmin;
};

__device__ __forceinline__ float safe_inv(float v) {
  const float tiny = 1e-12f;
  return 1.0f / (fabsf(v) < tiny ? (v < 0.0f ? -tiny : tiny) : v);
}

__device__ __forceinline__ Ray load_ray(int i, const float* __restrict__ o,
                                        const float* __restrict__ d,
                                        const float* __restrict__ t_min) {
  Ray r;
  r.ox = o[3 * i];
  r.oy = o[3 * i + 1];
  r.oz = o[3 * i + 2];
  r.dx = d[3 * i];
  r.dy = d[3 * i + 1];
  r.dz = d[3 * i + 2];
  r.ix = safe_inv(r.dx);
  r.iy = safe_inv(r.dy);
  r.iz = safe_inv(r.dz);
  r.tmin = t_min[i];
  return r;
}

// A box as two float4: a = (min.x, min.y, min.z, max.x), b = (max.y, max.z,
// ..): the first 6 columns of a cluster-tree node row, a cluster box row or
// a binary-tree node row. NaN-ignoring min / max (fminf / fmaxf).
__device__ __forceinline__ bool slab(const float4 a, const float4 b,
                                     const Ray& r, float t_far) {
  const float t0x = (a.x - r.ox) * r.ix;
  const float t1x = (a.w - r.ox) * r.ix;
  const float t0y = (a.y - r.oy) * r.iy;
  const float t1y = (b.x - r.oy) * r.iy;
  const float t0z = (a.z - r.oz) * r.iz;
  const float t1z = (b.y - r.oz) * r.iz;
  const float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fmaxf(fminf(t0z, t1z), r.tmin));
  const float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                          fminf(fmaxf(t0z, t1z), t_far));
  return near <= far;
}

// Moller-Trumbore of the ray against the triangle (v0, e1, e2), in the
// reference's order of operations: true when the hit lies inside the
// triangle (the t-range test is the caller's); big_det is |det| > 1e-12
// (else 1 / det is taken as 0).
__device__ __forceinline__ bool moller_trumbore(
    float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
    float e2x, float e2y, float e2z, const Ray& r, float& t, float& u,
    float& v, bool& big_det) {
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  big_det = fabsf(det) > 1e-12f;
  const float inv_det = big_det ? 1.0f / det : 0.0f;
  const float tx = r.ox - v0x;
  const float ty = r.oy - v0y;
  const float tz = r.oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
}

// Row j of an attribute-major (16, 128) triangle block against the ray, as
// moller_trumbore.
__device__ __forceinline__ bool block_row_mt(const float* __restrict__ blk,
                                             int j, const Ray& r, float& t,
                                             float& u, float& v) {
  bool big_det;
  return moller_trumbore(
      __ldg(blk + 0 * kCluster + j), __ldg(blk + 1 * kCluster + j),
      __ldg(blk + 2 * kCluster + j), __ldg(blk + 3 * kCluster + j),
      __ldg(blk + 4 * kCluster + j), __ldg(blk + 5 * kCluster + j),
      __ldg(blk + 6 * kCluster + j), __ldg(blk + 7 * kCluster + j),
      __ldg(blk + 8 * kCluster + j), r, t, u, v, big_det);
}

// The per-ray stacks the tree kernels are built with: a launch takes the
// least that holds its tree's bound (ops/cluster.py stack_need), which the
// caller passes in and the walk checks. A one-pop depth-first walk pushes
// each node of a tree at most once, so the larger 8-wide stack holds any
// tree of at most MAX_SLAB8_NODES = 2048 nodes (ops/subpacket.py STACKS8,
// ops/wide8.py STACKS; ops/trace.py STACKS for the binary tree). The
// larger builds' local memory (8 KB a thread for 2,048 entries) is
// reserved only by a launch of a tree that needs them.
constexpr int kStack8Small = 128, kStack8Large = 2048;
constexpr int kStack2Small = 64, kStack2Large = 512;

// One ray's walk of the 8-wide tree (the subpacket kernel's) (ops/subpacket.py build_slab_meta:
// slab8 (N8, 8, 128), meta8 (N8, 16)). Each pop tests the node's 8 child
// boxes against best_t as it stands at the pop (planes bound * inv +
// (-o * inv), the TPU kernel's slab matmul less its exact-zero terms; a
// child coded 0 is an empty slot and never hit), checks every hit child's
// code, hands the hit leaf children to `leaf(cluster, best_t)` in visit
// order (ascending along the node's axis when the ray's direction component
// there is >= 0, else descending) and pushes the hit interior children in
// reverse visit order, so the nearest pops next. `leaf` returns true when
// the ray is done (an any-hit occluder). Stops with an error bit after
// 4 N8 + 64 pops, on a stack deeper than `cap` (<= kCap, the entries of the
// per-thread array) or on a code out of range.
template <int kCap, class Leaf>
__device__ __forceinline__ void walk8(const Ray& r, float& best_t,
                                      const float4* __restrict__ slab8,
                                      const float4* __restrict__ meta8, int n8,
                                      int n_clusters, int cap, Leaf& leaf,
                                      int& pops, int* __restrict__ err) {
  const float nox = (-r.ox) * r.ix;
  const float noy = (-r.oy) * r.iy;
  const float noz = (-r.oz) * r.iz;
  const int max_steps = 4 * n8 + 64;
  int stack[kCap];
  int sp = 0;
  stack[sp++] = 0;
  while (sp > 0) {
    if (pops >= max_steps) {
      atomicOr(err, kErrSteps);
      return;
    }
    ++pops;
    const int node = stack[--sp];
    // row a of the node's slab block holds, at float4 36 a + q, the low
    // plane of axis a for children 0-3 (q = 0) and 4-7 (q = 1), the high
    // plane for children 0-3 (q = 2) and 4-7 (q = 3)
    const float4* s = slab8 + static_cast<size_t>(node) * (8 * 128 / 4);
    const float4* m = meta8 + static_cast<size_t>(node) * 4;
    const float4 m0 = __ldg(m), m1 = __ldg(m + 1), m2 = __ldg(m + 2);
    const float enc[8] = {m0.x, m0.y, m0.z, m0.w, m1.x, m1.y, m1.z, m1.w};
    const int packed = static_cast<int>(m2.x);
    const int axis = packed & 3;
    const int leafmask = packed >> 2;
    float lo[3][8], hi[3][8];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float4 l = __ldg(s + 36 * a + q);
        const float4 h = __ldg(s + 36 * a + 2 + q);
        lo[a][4 * q] = l.x;
        lo[a][4 * q + 1] = l.y;
        lo[a][4 * q + 2] = l.z;
        lo[a][4 * q + 3] = l.w;
        hi[a][4 * q] = h.x;
        hi[a][4 * q + 1] = h.y;
        hi[a][4 * q + 2] = h.z;
        hi[a][4 * q + 3] = h.w;
      }
    }
    unsigned hits = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float t0x = lo[0][c] * r.ix + nox;
      const float t1x = hi[0][c] * r.ix + nox;
      const float t0y = lo[1][c] * r.iy + noy;
      const float t1y = hi[1][c] * r.iy + noy;
      const float t0z = lo[2][c] * r.iz + noz;
      const float t1z = hi[2][c] * r.iz + noz;
      const float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                               fmaxf(fminf(t0z, t1z), r.tmin));
      const float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                              fminf(fmaxf(t0z, t1z), best_t));
      if (near <= far && enc[c] != 0.0f) {
        hits |= 1u << c;
        if ((leafmask >> c) & 1) {
          const int blk = static_cast<int>(-enc[c] - 1.0f);
          if (blk < 0 || blk >= n_clusters) {
            atomicOr(err, kErrIndex);
            return;
          }
        } else {
          const int idx = static_cast<int>(enc[c]);
          if (idx < 1 || idx >= n8) {
            atomicOr(err, kErrIndex);
            return;
          }
        }
      }
    }
    const float dax = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
    const bool asc = dax >= 0.0f;
    const unsigned leaf_hits = hits & static_cast<unsigned>(leafmask);
    const unsigned inner_hits = hits & ~static_cast<unsigned>(leafmask);
    for (int k = 0; k < 8; ++k) {  // leaves, in visit order
      const int c = asc ? k : 7 - k;
      if ((leaf_hits >> c) & 1) {
        if (leaf(static_cast<int>(-enc[c] - 1.0f), best_t)) return;
      }
    }
    if (sp + __popc(inner_hits) > cap) {
      atomicOr(err, kErrStack);
      return;
    }
    for (int k = 0; k < 8; ++k) {  // interiors, in reverse visit order
      const int c = asc ? 7 - k : k;
      if ((inner_hits >> c) & 1) stack[sp++] = static_cast<int>(enc[c]);
    }
  }
}

inline int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

// ---------------------------------------------------------------------------
// The warp leaf stage of the "while-while" kernels (cluster.cu, wide8.cu):
// each lane walks its own ray until it parks on a leaf cluster (or ends);
// then the warp tests the parked lanes' clusters together (warp_leaves).
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroups = kCluster / 32;  // rows lane + 32 k, k < kGroups

// Per-launch lane counters (optional; null on the main path), summed over
// the grid; a kernel may keep more after kWalkCounters.
enum {
  CTR_ROUNDS,     // leaf rounds: a warp's ballots with some lane parked
  CTR_PARKED,     // parked lanes, summed over the rounds
  CTR_LOADS,      // block loads (clusters served; one per parked lane
                  // unless lanes share a cluster)
  CTR_ROWS,       // valid rows tested, summed over the served lanes
  CTR_ROW_SLOTS,  // 32 x row groups a warp tested, over the served lanes
  CTR_POPS,       // node pops
  CTR_POP_SLOTS,  // 32 x the longest run of pops in a warp, per round
  kWalkCounters
};

// The counters are warp-uniform: every lane keeps them, lane 0 adds them.
// A launch without them runs a build of the kernel that has none (kOn is
// a template argument), so they take no registers there.
template <bool kOn, int kN>
struct Counters {
  static constexpr bool on = kOn;
  unsigned long long c[kN];
};

// A word of a triangle block, through L2 only: a block's rows are read
// once a leaf round, and L1 is left to the tree and the stacks.
__device__ __forceinline__ float block_word(const float* p) { return __ldcg(p); }

__device__ __forceinline__ Ray shfl_ray(const Ray& r, int src) {
  Ray q;
  q.ox = __shfl_sync(kFull, r.ox, src);
  q.oy = __shfl_sync(kFull, r.oy, src);
  q.oz = __shfl_sync(kFull, r.oz, src);
  q.dx = __shfl_sync(kFull, r.dx, src);
  q.dy = __shfl_sync(kFull, r.dy, src);
  q.dz = __shfl_sync(kFull, r.dz, src);
  q.ix = q.iy = q.iz = 0.0f;  // Moller-Trumbore reads no inverse
  q.tmin = __shfl_sync(kFull, r.tmin, src);
  return q;
}

// The leaf stage of one warp round: `cl` is the cluster this lane parked on
// (-1: not parked). Lane k loads rows k, k + 32, k + 64 and k + 96 of a
// parked cluster's block (each attribute column four coalesced 128-byte
// loads); for each lane parked there the warp receives its ray and best_t
// by __shfl_sync, tests the rows and reduces with __shfl_xor_sync to the
// least t, the lowest row on a tie (= a serial loop's strict t < best_t
// over the rows in order), or, for any-hit, takes the first occluder in
// row order from a ballot. Lanes parked on one cluster (__match_any_sync)
// are served from one load. The lane's rows count the valid rows, up to
// and including the first occluder for any-hit; an occluded lane's walk
// ends. Returns false, having changed nothing, when no lane parked.
// Called by all 32 lanes. W is the kernel's lane state: the fields r,
// best_t, best_u, best_v, best_s, occ, rows and live.
template <bool kAny, class W, class Ctr>
__device__ __forceinline__ bool warp_leaves(W& w, int cl, const float* __restrict__ tris,
                                            Ctr& ctr) {
  const int lane = threadIdx.x & 31;
  unsigned parked = __ballot_sync(kFull, cl >= 0);
  if (!parked) return false;
  if (ctr.on) {
    ++ctr.c[CTR_ROUNDS];
    ctr.c[CTR_PARKED] += __popc(parked);
  }
  const unsigned same = __match_any_sync(kFull, cl);  // lanes of one cluster
  while (parked) {
    const int first_src = __ffs(parked) - 1;
    const unsigned group = __shfl_sync(kFull, same, first_src);
    parked &= ~group;
    // rows lane + 32 k of the group's block, into registers
    const int c = __shfl_sync(kFull, cl, first_src);
    const float* blk = tris + static_cast<size_t>(c) * (kTriCols * kCluster);
    float attr[kGroups][9];
    bool valid[kGroups];
    unsigned vb[kGroups];
    int n_valid = 0;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int j = lane + 32 * k;
      valid[k] = block_word(blk + 9 * kCluster + j) > 0.0f;
#pragma unroll
      for (int q = 0; q < 9; ++q) attr[k][q] = block_word(blk + q * kCluster + j);
      vb[k] = __ballot_sync(kFull, valid[k]);
      n_valid += __popc(vb[k]);
    }
    if (ctr.on) ++ctr.c[CTR_LOADS];

    for (unsigned g = group; g; g &= g - 1) {  // each lane of the group
      const int src = __ffs(g) - 1;
      const Ray q = shfl_ray(w.r, src);
      const float bt = __shfl_sync(kFull, w.best_t, src);
      if (kAny) {
        // the valid rows up to and including the first occluder
        int tested = n_valid, groups = kGroups, before = 0;
        bool found = false;
#pragma unroll
        for (int k = 0; k < kGroups; ++k) {
          bool hit = false;
          if (valid[k]) {
            float t, u, v;
            bool big_det;
            const bool inside = moller_trumbore(
                attr[k][0], attr[k][1], attr[k][2], attr[k][3], attr[k][4], attr[k][5],
                attr[k][6], attr[k][7], attr[k][8], q, t, u, v, big_det);
            hit = inside && t > q.tmin && t < bt &&
                  block_word(blk + 10 * kCluster + lane + 32 * k) > 0.0f;
          }
          const unsigned hb = __ballot_sync(kFull, hit);
          if (hb) {
            tested = before + __popc(vb[k] & ((2u << (__ffs(hb) - 1)) - 1u));
            groups = k + 1;
            found = true;
            break;
          }
          before += __popc(vb[k]);
        }
        if (lane == src) {
          w.rows += tested;
          if (found) {
            w.occ = 1;
            w.live = false;  // an occluded ray leaves the walk
          }
        }
        if (ctr.on) {
          ctr.c[CTR_ROWS] += tested;
          ctr.c[CTR_ROW_SLOTS] += 32ull * groups;
        }
      } else {
        // this lane's first row of least t, then the warp's
        float wt = __int_as_float(0x7f800000), wu = 0.0f, wv = 0.0f;
        int wrow = kCluster;
#pragma unroll
        for (int k = 0; k < kGroups; ++k) {
          if (!valid[k]) continue;
          float t, u, v;
          bool big_det;
          const bool inside = moller_trumbore(
              attr[k][0], attr[k][1], attr[k][2], attr[k][3], attr[k][4], attr[k][5],
              attr[k][6], attr[k][7], attr[k][8], q, t, u, v, big_det);
          if (inside && t > q.tmin && t < bt && t < wt) {
            wt = t;
            wu = u;
            wv = v;
            wrow = lane + 32 * k;
          }
        }
        if (lane == src) w.rows += n_valid;
        if (__any_sync(kFull, wrow < kCluster)) {  // some row beat best_t
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const float ot = __shfl_xor_sync(kFull, wt, off);
            const int orow = __shfl_xor_sync(kFull, wrow, off);
            if (ot < wt || (ot == wt && orow < wrow)) {
              wt = ot;
              wrow = orow;
            }
          }
          const float bu = __shfl_sync(kFull, wu, wrow & 31);
          const float bv = __shfl_sync(kFull, wv, wrow & 31);
          if (lane == src) {
            w.best_t = wt;
            w.best_s = static_cast<int>(block_word(blk + 11 * kCluster + wrow));
            w.best_u = bu;
            w.best_v = bv;
          }
        }
        if (ctr.on) {
          ctr.c[CTR_ROWS] += n_valid;
          ctr.c[CTR_ROW_SLOTS] += 32ull * kGroups;
        }
      }
    }
  }
  return true;
}

}  // namespace lrt
