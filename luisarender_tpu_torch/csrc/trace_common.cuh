// Device code shared by the trace kernels of csrc/ (cluster.cu, wide8.cu,
// subpacket.cu, trace.cu): the ray, its safe inverse direction, the slab
// test of a box (with its entry t) and Moller-Trumbore, each in the
// reference's order of operations
// (luisarender_tpu/ops/cluster_pallas.py); the warp leaf stage of the
// "while-while" kernels (warp_leaves, with a row-test policy: MtRows here
// for the cluster and wide8 kernels, subpacket.cu's Woop rows); and the
// per-lane walk of the 8-wide tree that the wide8 and subpacket kernels
// share (Lane8, begin8, pop8, to_leaf8; the counterpart of
// ops/subpacket.py walk8_plain).
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
// either half of a binary-tree child-pair row (ops/trace.py build_pairs).
// NaN-ignoring min / max (fminf / fmaxf). `near` receives the entry t, the
// box's clamped to t_min.
__device__ __forceinline__ bool slab_near(const float4 a, const float4 b,
                                          const Ray& r, float t_far, float& near) {
  const float t0x = (a.x - r.ox) * r.ix;
  const float t1x = (a.w - r.ox) * r.ix;
  const float t0y = (a.y - r.oy) * r.iy;
  const float t1y = (b.x - r.oy) * r.iy;
  const float t0z = (a.z - r.oz) * r.iz;
  const float t1z = (b.y - r.oz) * r.iz;
  near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), r.tmin));
  const float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                          fminf(fmaxf(t0z, t1z), t_far));
  return near <= far;
}

__device__ __forceinline__ bool slab(const float4 a, const float4 b,
                                     const Ray& r, float t_far) {
  float near;
  return slab_near(a, b, r, t_far, near);
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

// The per-lane stacks of the 8-wide kernels (wide8.cu, subpacket.cu): a
// launch takes the least build that holds its tree's bound
// (ops/subpacket.py stack8_need), which the caller passes in and the walk
// checks. A one-pop depth-first walk pushes each node of a tree at most
// once, so the larger stack holds any tree of at most MAX_SLAB8_NODES =
// 2048 nodes (ops/subpacket.py STACKS8). The larger build's local memory
// (8 KB a thread) is reserved only by a launch of a tree that needs it.
// The binary tree kernel's stacks are trace.cu's.
constexpr int kStack8Small = 48, kStack8Large = 2048;

// The entries of the 8-wide build whose stack holds `bound`, 0 if none does.
inline int stack8_build(int bound) {
  if (bound < 1 || bound > kStack8Large) return 0;
  return bound <= kStack8Small ? kStack8Small : kStack8Large;
}

inline int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

// ---------------------------------------------------------------------------
// The warp leaf stage of the "while-while" kernels (cluster.cu, wide8.cu,
// subpacket.cu): each lane walks its own ray until it parks on a leaf
// cluster (or ends); then the warp tests the parked lanes' clusters
// together (warp_leaves).
// ---------------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kGroups = kCluster / 32;  // rows lane + 32 k, k < kGroups
constexpr int kNoKey = 0x7fffffff;      // a lane without a closest-hit candidate

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

// A word of a leaf table, through L2 only: a block's rows are read once a
// leaf round, and L1 is left to the tree and the stacks.
__device__ __forceinline__ float block_word(const float* p) { return __ldcg(p); }

__device__ __forceinline__ Ray shfl_ray(const Ray& r, int src) {
  Ray q;
  q.ox = __shfl_sync(kFull, r.ox, src);
  q.oy = __shfl_sync(kFull, r.oy, src);
  q.oz = __shfl_sync(kFull, r.oz, src);
  q.dx = __shfl_sync(kFull, r.dx, src);
  q.dy = __shfl_sync(kFull, r.dy, src);
  q.dz = __shfl_sync(kFull, r.dz, src);
  q.ix = q.iy = q.iz = 0.0f;  // the row tests read no inverse
  q.tmin = __shfl_sync(kFull, r.tmin, src);
  return q;
}

// The row-test policy of the cluster and wide8 kernels: Moller-Trumbore
// over a cluster's attribute-major (16, 128) triangle block. Lane k holds
// rows k + 32 j (v0 / e1 / e2 and valid, in registers); a row's slot and
// opacity are read only where it won or hit. Closest hits keep the first
// row of least t (a serial loop's strict t < best_t over the rows in
// order) and return exact (u, v).
struct MtRows {
  const float* __restrict__ tris;
  const float* blk;
  float attr[kGroups][9];
  bool valid[kGroups];

  __device__ __forceinline__ explicit MtRows(const float* table) : tris(table), blk(table) {}

  __device__ __forceinline__ void load(int c, int lane) {
    blk = tris + static_cast<size_t>(c) * (kTriCols * kCluster);
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      const int j = lane + 32 * k;
      valid[k] = block_word(blk + 9 * kCluster + j) > 0.0f;
#pragma unroll
      for (int q = 0; q < 9; ++q) attr[k][q] = block_word(blk + q * kCluster + j);
    }
  }
  // row lane + 32 k inside the triangle with tmin < t < bt
  __device__ __forceinline__ bool hit(int k, const Ray& q, float bt, float& t, float& u,
                                      float& v) const {
    bool big_det;
    const bool inside =
        moller_trumbore(attr[k][0], attr[k][1], attr[k][2], attr[k][3], attr[k][4],
                        attr[k][5], attr[k][6], attr[k][7], attr[k][8], q, t, u, v, big_det);
    return inside && t > q.tmin && t < bt;
  }
  __device__ __forceinline__ bool opaque(int k, int lane) const {
    return block_word(blk + 10 * kCluster + lane + 32 * k) > 0.0f;
  }
  // closest hits: the candidate's key is its row; a lane meets its rows in
  // row order, so a strict t decides there
  __device__ __forceinline__ int key(int k, int lane) const { return lane + 32 * k; }
  static __device__ __forceinline__ bool better(float t, int key, float wt, int wkey) {
    return t < wt;
  }
  // the warp's winner (t, row) into the lane that owns the ray (mine);
  // (u, v) from the lane that holds the row. Called by all 32 lanes.
  template <class W>
  __device__ __forceinline__ void win(W& w, bool mine, float wt, int wkey, float wu,
                                      float wv) const {
    const float bu = __shfl_sync(kFull, wu, wkey & 31);
    const float bv = __shfl_sync(kFull, wv, wkey & 31);
    if (mine) {
      w.best_t = wt;
      w.best_s = static_cast<int>(block_word(blk + 11 * kCluster + wkey));
      w.best_u = bu;
      w.best_v = bv;
    }
  }
};

// The leaf stage of one warp round: `cl` is the cluster this lane parked on
// (-1: not parked). The row-test policy `Rows` (MtRows, or subpacket.cu's
// Woop rows), made from `table`, loads a parked cluster's rows: lane k takes
// rows k, k + 32, k + 64 and k + 96 (each column of a row group one
// coalesced 128-byte load). For each lane parked there the warp receives its
// ray and best_t by __shfl_sync, tests the rows against that best_t and
// reduces with __shfl_xor_sync to the least t, on equal t the least key
// (the policy's: the row, or the slot), or, for any-hit, takes the first
// occluder in row order (a row that hits and is opaque) from a ballot.
// Lanes parked on one cluster (__match_any_sync) are served from one load.
// The lane's rows count the valid rows, up to and including the first
// occluder for any-hit; an occluded lane's walk ends. Returns false, having
// changed nothing, when no lane parked. Called by all 32 lanes. W is the
// kernel's lane state: the fields r, best_t, best_s, occ, rows and live,
// and what the policy's win writes.
template <bool kAny, class Rows, class W, class Ctr>
__device__ __forceinline__ bool warp_leaves(W& w, int cl, const float* __restrict__ table,
                                            Ctr& ctr) {
  const int lane = threadIdx.x & 31;
  unsigned parked = __ballot_sync(kFull, cl >= 0);
  if (!parked) return false;
  if (ctr.on) {
    ++ctr.c[CTR_ROUNDS];
    ctr.c[CTR_PARKED] += __popc(parked);
  }
  const unsigned same = __match_any_sync(kFull, cl);  // lanes of one cluster
  Rows rows(table);
  while (parked) {
    const int first_src = __ffs(parked) - 1;
    const unsigned group = __shfl_sync(kFull, same, first_src);
    parked &= ~group;
    // rows lane + 32 k of the group's cluster
    rows.load(__shfl_sync(kFull, cl, first_src), lane);
    unsigned vb[kGroups];
    int n_valid = 0;
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      vb[k] = __ballot_sync(kFull, rows.valid[k]);
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
          if (rows.valid[k]) {
            float t, u, v;
            hit = rows.hit(k, q, bt, t, u, v) && rows.opaque(k, lane);
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
        // this lane's best row, then the warp's
        float wt = __int_as_float(0x7f800000), wu = 0.0f, wv = 0.0f;
        int wkey = kNoKey;
#pragma unroll
        for (int k = 0; k < kGroups; ++k) {
          if (!rows.valid[k]) continue;
          float t, u, v;
          const int key = rows.key(k, lane);
          if (rows.hit(k, q, bt, t, u, v) && Rows::better(t, key, wt, wkey)) {
            wt = t;
            wu = u;
            wv = v;
            wkey = key;
          }
        }
        if (lane == src) w.rows += n_valid;
        if (__any_sync(kFull, wkey != kNoKey)) {  // some row beat best_t
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            const float ot = __shfl_xor_sync(kFull, wt, off);
            const int okey = __shfl_xor_sync(kFull, wkey, off);
            if (ot < wt || (ot == wt && okey < wkey)) {
              wt = ot;
              wkey = okey;
            }
          }
          rows.win(w, lane == src, wt, wkey, wu, wv);
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

// ---------------------------------------------------------------------------
// The per-lane walk of the 8-wide tree (wide8.cu, subpacket.cu; the tables
// of ops/subpacket.py build_slab_meta: slab8 (N8, 8, 128), meta8 (N8, 16)).
// A pop tests the node's 8 child boxes against the lane's best_t (planes
// bound * inv + (-o * inv), 12 float4 loads through the read-only cache; a
// child coded 0 is an empty slot and never hit), checks every hit child's
// code, pushes the hit interior children in reverse visit order (so the
// nearest pops next) and keeps the hit leaf children as a pending mask,
// taken in visit order (ascending along the node's axis when the ray's
// direction component there is >= 0, else descending). The lane parks on
// one pending leaf at a time and pops again only when none is left, so each
// leaf of a pop sees the best_t that the leaves before it left. With
// kRetest (the wide8 kernel) a pending leaf's cluster box is first
// re-tested against the current best_t and dropped if it fails; without
// (the subpacket kernel) every pending leaf is tested. The walk stops with
// a bit of the error word after 4 N8 + 64 pops, on a stack deeper than the
// bound `cap` (raised once the pop's pending leaves are done, unless one
// occluded the ray: where walk8_plain raises) or on a child code out of
// range. The kernel's launch arguments `A` carry o, d, t_min, t_max, slab8
// (float4), meta8 (float), n8, n_clusters, cap and err, and with kRetest
// cboxes (float4).
// ---------------------------------------------------------------------------

// One lane's walk of one ray, but for its stack (kept apart, so that these
// stay in registers while the stack is in local memory).
struct Lane8 {
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

template <class A>
__device__ __forceinline__ void begin8(Lane8& w, int* stack, int i, const A& a) {
  w.r = load_ray(i, a.o, a.d, a.t_min);
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
__device__ __forceinline__ void idle8(Lane8& w) {
  w.r = Ray{};
  w.nox = w.noy = w.noz = 0.0f;
  w.best_t = w.best_u = w.best_v = 0.0f;
  w.best_s = -1;
  w.occ = w.pops = w.leaves = w.rows = w.sp = w.node = 0;
  w.pending = 0;
  w.asc = w.overflow = w.live = false;
}

// Pops the top of the stack: tests its 8 child boxes against best_t as it
// stands, checks every hit child's code, keeps the hit leaf children as
// the pending mask and pushes the hit interior children in reverse visit
// order (or marks the overflow, raised once the pending leaves are done).
// Returns false on a code out of range.
template <class A>
__device__ __forceinline__ bool pop8(Lane8& w, int* stack, const A& a) {
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

// Takes the pending leaves in visit order (with kRetest, each re-tested
// against the current best_t) and pops when none is left, until the lane
// parks on a leaf (returns its cluster) or the walk ends (returns -1,
// w.live false). `culled` counts the pending leaves the re-test dropped.
template <bool kRetest, class A>
__device__ __forceinline__ int to_leaf8(Lane8& w, int* stack, const A& a, int& culled) {
  const int max_steps = 4 * a.n8 + 64;
  while (w.live) {
    if (w.pending) {
      const int c = w.asc ? __ffs(w.pending) - 1 : 31 - __clz(w.pending);
      w.pending &= ~(1u << c);
      const int blk = static_cast<int>(-__ldg(a.meta8 + 16 * w.node + c) - 1.0f);
      if constexpr (kRetest) {
        if (!slab(__ldg(a.cboxes + 2 * blk), __ldg(a.cboxes + 2 * blk + 1), w.r, w.best_t)) {
          ++culled;
          continue;
        }
      }
      ++w.leaves;
      return blk;
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
    if (!pop8(w, stack, a)) {
      atomicOr(a.err, kErrIndex);
      break;
    }
  }
  w.live = false;
  return -1;
}

// Pending leaves dropped by the box re-test: a counter after kWalkCounters
// of the 8-wide walk with kRetest.
enum { CTR_CULLED = kWalkCounters };

// One lane's ray through the 8-wide tree, as a 8-wide kernel runs it: lane
// i of a grid of kThreads-thread blocks walks ray i (a lane past n only
// takes part in the leaf stages), in rounds: every lane walks to its next
// leaf or its end (to_leaf8), then the warp tests the parked lanes' leaves
// (warp_leaves with the row policy Rows over `table`), until no lane
// parks. `write(w, i)` stores ray i's outputs; with kCount the kCounters
// lane counters are added to a.counters. Called by all threads of the
// block (no early return before a *_sync).
template <bool kAny, bool kRetest, class Rows, bool kCount, int kCounters, int kThreads,
          int kCap, class A, class Write>
__device__ __forceinline__ void trace8(const A& a, const float* __restrict__ table,
                                       const Write& write) {
  const int lane = threadIdx.x & 31;
  Counters<kCount, kCounters> ctr = {};
  Lane8 w;
  int stack[kCap];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < a.n) {
    begin8(w, stack, i, a);
  } else {
    idle8(w);
  }
  for (;;) {
    const int pops0 = w.pops;
    int culled = 0;
    const int cl = to_leaf8<kRetest>(w, stack, a, culled);
    if (ctr.on) {
      const unsigned run = __reduce_max_sync(kFull, static_cast<unsigned>(w.pops - pops0));
      ctr.c[CTR_POP_SLOTS] += 32ull * run;
      if constexpr (kRetest) {
        ctr.c[CTR_CULLED] += __reduce_add_sync(kFull, static_cast<unsigned>(culled));
      }
    }
    if (!warp_leaves<kAny, Rows>(w, cl, table, ctr)) break;
  }
  if (i < a.n) write(w, i);
  if (kCount) {
    ctr.c[CTR_POPS] += __reduce_add_sync(kFull, static_cast<unsigned>(i < a.n ? w.pops : 0));
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < kCounters; ++k)
        if (ctr.c[k]) atomicAdd(a.counters + k, ctr.c[k]);
    }
  }
}

}  // namespace lrt
