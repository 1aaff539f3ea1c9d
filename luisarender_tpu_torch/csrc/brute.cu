// Brute-force closest-hit and any-hit ray/triangle kernels for small scenes,
// for Hopper (sm_90a), called through a plain C interface (ctypes).
//
// Replaces the TPU kernels of luisarender_tpu/ops/brute_pallas.py:
// _closest_kernel (brute_pallas.py:79) and _any_kernel (brute_pallas.py:101).
// The contract is theirs: the same (P, 16) triangle table (cols 0-8 v0/e1/e2,
// 9 valid, 10 opaque), Moller-Trumbore in the same operation order, closest
// hit taken with a strict t < best_t so the lowest row wins an exact tie,
// t_max clamped to 3e38, a miss returning t = inf, slot = -1, u = v = 0, and
// occlusion by any valid opaque row with t_min < t < t_max.
//
// What bounds it: operations. On the main path (the general fork's
// 352-triangle scene, 262,144 lanes a bounce) every live lane tests every
// row. A test needs 24 float operations up to u and 46 in all, and most
// rows fail at u: 262,144 live camera rays x 352 rows need 34 us at 67
// TFLOP/s against 3.8 us of bytes at 3.35 TB/s (chip_smoke.py brute_work
// counts each test to its first failed check). Without contraction
// (--fmad=false) a whole test issues about 60 instructions, so instruction
// issue is what the card runs out of.
//
// Design (what each part answers):
// - Live-lane compaction. The general fork launches every bounce over all
//   lanes and marks finished paths dead (t_max = 0): after the camera
//   bounce a minority of lanes lives, scattered, and one thread a lane kept
//   nearly every warp in the row loop. A block takes kThreads lanes in
//   caller order, writes the dead lanes' outputs at once and queues the
//   live lanes in shared memory in lane order (ballot + popc), so camera
//   rays stay coherent; a block without live lanes stops there.
// - Lane groups. The queued rays are traced G lanes a ray, G the largest
//   power of two up to 32 with G x rays <= kThreads: lane g of a group tests
//   rows g, g + G, ... in order keeping the first least t, and the group
//   reduces to the least t, the lower row on a tie, which is the row the
//   serial loop keeps. A block with few live rays spreads their rows over
//   its lanes instead of each ray running all rows on one lane.
// - The table is staged in shared memory, row k at slot k, three float4s a
//   row; a row is one broadcast load for a one-lane-a-ray warp, and 48 B
//   rows put the 8 rows an 8-lane phase of a group reads on distinct
//   banks. A row that cannot count (closest: not valid; any-hit: not valid
//   and opaque) is staged with a NaN v0, so that its test fails at the u
//   check and the row loop needs no valid / opaque compare.
// - Warp-uniform early outs. After u, and again after v, the warp skips the
//   rest of the test when no lane can still hit the row; one lane a ray
//   (coherent neighbours) also skips the division when every lane certainly
//   misses (see row_test). Coherent camera rays go past u on 8% of their
//   rows. Only work whose result would be thrown away is skipped.
// - One block of 1024 threads an SM (launch bounds: at most 64 registers):
//   blocks of 256 and 512 threads were slower summed over a sample of the
//   general fork (brute_ab.py; PERF.md section 6 has the A/B).
// Every (ray, row) test that counts is the plain version's arithmetic in
// its order, so both kernels stay bit-equal with closest_plain / any_plain
// (ops/brute.py). The TPU kernel's (SUB, 128) blocking and static unroll
// are TPU mechanics and are not carried over.
//
// Build with --fmad=false and without fast math: the plain PyTorch version
// then does the same IEEE operations in the same order and the two agree
// bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 16;      // table columns (ops/brute.py TRI_COLS)
constexpr int kMaxRows = 512;  // ops/brute.py MAX_TRIS
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3e38f;

// Per-launch counters (optional; null on the main path), summed over the
// grid: the row loop's lane use.
enum {
  CTR_RAYS,        // live rays traced
  CTR_TESTS,       // row tests of live rays (lane-slots with a test)
  CTR_SLOTS,       // 32 x the row steps of the warps that traced
  CTR_DEEP_SLOTS,  // 32 x the row steps where some lane went past the u test
  kCounters
};

struct Args {
  const float* __restrict__ o;
  const float* __restrict__ d;
  const float* __restrict__ t_min;
  const float* __restrict__ t_max;
  const float* __restrict__ tab;
  float* __restrict__ t_out;
  int* __restrict__ slot_out;
  float* __restrict__ u_out;
  float* __restrict__ v_out;
  unsigned char* __restrict__ occ_out;
  unsigned long long* __restrict__ counters;
  int n, p;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, tmn;
};

__device__ __forceinline__ Ray load_ray(const Args& a, int i) {
  return Ray{a.o[3 * i], a.o[3 * i + 1], a.o[3 * i + 2], a.d[3 * i], a.d[3 * i + 1],
             a.d[3 * i + 2], a.t_min[i]};
}

// Stage the table in shared memory, row k at slots 3k..3k+2 as three
// float4s: (v0, e1.x), (e1.yz, e2.xy), (e2.z, 0, 0, 0). A row that cannot
// count (closest: not valid; any-hit: not valid and opaque) gets a NaN v0:
// its u is NaN, so its test fails at the u check, as the plain version
// rejects it.
template <bool kAny>
__device__ __forceinline__ void stage_rows(const Args& a, float4* rows) {
  for (int j = threadIdx.x; j < a.p; j += kThreads) {
    const float* r = a.tab + static_cast<size_t>(j) * kCols;
    const bool keep = r[9] > 0.0f && (!kAny || r[10] > 0.0f);
    const float nan = __int_as_float(0x7fc00000);
    rows[3 * j] = keep ? make_float4(r[0], r[1], r[2], r[3]) : make_float4(nan, nan, nan, r[3]);
    rows[3 * j + 1] = make_float4(r[4], r[5], r[6], r[7]);
    rows[3 * j + 2] = make_float4(r[8], 0.0f, 0.0f, 0.0f);
  }
}

// Moller-Trumbore of ray y against staged row k, in the reference's order of
// operations, with warp-uniform early outs. Returns whether the lane (`has`,
// a test to make) hits the row inside the triangle with t in (y.tmn, t_hi);
// t, u, v are the plain version's values where it does. kPre adds an early
// out before the division (see below).
template <bool kCount, bool kPre>
__device__ __forceinline__ bool row_test(const float4* rows, int k, const Ray& y, bool has,
                                         float t_hi, float& t, float& u, float& v,
                                         unsigned long long& deep) {
  const float4 A = rows[3 * k], B = rows[3 * k + 1], C = rows[3 * k + 2];
  const float v0x = A.x, v0y = A.y, v0z = A.z;
  const float e1x = A.w, e1y = B.x, e1z = B.y;
  const float e2x = B.z, e2y = B.w, e2z = C.x;
  const float px = y.dy * e2z - y.dz * e2y;
  const float py = y.dz * e2x - y.dx * e2z;
  const float pz = y.dx * e2y - y.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float tx = y.ox - v0x;
  const float ty = y.oy - v0y;
  const float tz = y.oz - v0z;
  const float nu = tx * px + ty * py + tz * pz;
  // Certain misses before the division: with |det| > 1e-12, u = nu * (1 /
  // det) rounded lies below 0 when nu / det < -1e-20 (no underflow to -0)
  // and above 1 when nu / det > 1.0001 (rounding moves it by ~1e-7), and
  // u > 1 with v >= 0 gives u + v > 1.
  const float ad = fabsf(det);
  if (kPre) {
    const float sn = det > 0.0f ? nu : -nu;
    const bool out = ad > 1e-12f && (sn < -(ad * 1e-20f) || sn > ad * 1.0001f);
    if (!__any_sync(kFull, has && !out)) return false;
  }
  const float inv_det = ad > 1e-12f ? 1.0f / det : 0.0f;
  u = nu * inv_det;
  const bool pu = has && u >= 0.0f && u <= 1.0f;
  if (!__any_sync(kFull, pu)) return false;
  if (kCount) deep += 32;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (y.dx * qx + y.dy * qy + y.dz * qz) * inv_det;
  const bool pv = pu && v >= 0.0f && u + v <= 1.0f;
  if (!__any_sync(kFull, pv)) return false;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return pv && t > y.tmn && t < t_hi;
}

__device__ __forceinline__ void write_closest(const Args& a, int i, float t, int s, float u,
                                              float v) {
  a.t_out[i] = s >= 0 ? t : __int_as_float(0x7f800000);
  a.slot_out[i] = s;
  a.u_out[i] = u;
  a.v_out[i] = v;
}

// Closest hit of ray i (has_ray) by a group of G lanes: lane g of the group
// tests rows g, g + G, ... in order, keeping the first least t, and the
// group reduces to the least t, the lower row on a tie. That is the row the
// serial loop keeps, with its t, u and v.
template <bool kCount, int G>
__device__ __forceinline__ void closest_group(const Args& a, const float4* rows, int nrows,
                                              bool has_ray, int i, int g,
                                              unsigned long long* ctr) {
  Ray y{};
  float best_t = 0.0f, best_u = 0.0f, best_v = 0.0f;
  int best_s = -1;
  if (has_ray) {
    y = load_ray(a, i);
    const float tmx = a.t_max[i];
    best_t = tmx < kBig ? tmx : kBig;
  }
  unsigned long long deep = 0;
  const int steps = (nrows + G - 1) / G;
#pragma unroll 2
  for (int s = 0; s < steps; ++s) {
    const int k = s * G + g;
    const bool has = has_ray && k < nrows;
    if (kCount) {
      ctr[CTR_TESTS] += __popc(__ballot_sync(kFull, has));
      ctr[CTR_SLOTS] += 32;
    }
    float t, u, v;
    if (row_test<kCount, G == 1>(rows, has ? k : 0, y, has, best_t, t, u, v, deep)) {
      best_t = t;
      best_s = k;
      best_u = u;
      best_v = v;
    }
  }
#pragma unroll
  for (int off = G >> 1; off > 0; off >>= 1) {
    const float ot = __shfl_xor_sync(kFull, best_t, off);
    const int os = __shfl_xor_sync(kFull, best_s, off);
    const float ou = __shfl_xor_sync(kFull, best_u, off);
    const float ov = __shfl_xor_sync(kFull, best_v, off);
    // a miss keeps best_t at the clamped t_max, above every hit; -1 as
    // unsigned is above every row
    if (ot < best_t ||
        (ot == best_t && static_cast<unsigned>(os) < static_cast<unsigned>(best_s))) {
      best_t = ot;
      best_s = os;
      best_u = ou;
      best_v = ov;
    }
  }
  if (has_ray && g == 0) write_closest(a, i, best_t, best_s, best_u, best_v);
  if (kCount) ctr[CTR_DEEP_SLOTS] += deep;
}

// Occlusion of ray i (has_ray) by a group of G lanes, rows as in
// closest_group; the group stops at the step where one of its lanes finds an
// occluder.
template <bool kCount, int G>
__device__ __forceinline__ void any_group(const Args& a, const float4* rows, int nrows,
                                          bool has_ray, int i, int g,
                                          unsigned long long* ctr) {
  const int lane = threadIdx.x & 31;
  const unsigned gmask = G == 32 ? kFull : ((1u << G) - 1u) << (lane & ~(G - 1));
  Ray y{};
  float tmx = 0.0f;
  if (has_ray) {
    y = load_ray(a, i);
    tmx = a.t_max[i];
  }
  bool open = has_ray;
  unsigned char occ = 0;
  unsigned long long deep = 0;
  const int steps = (nrows + G - 1) / G;
#pragma unroll 2
  for (int s = 0; s < steps; ++s) {
    if (!__any_sync(kFull, open)) break;
    const int k = s * G + g;
    const bool has = open && k < nrows;
    if (kCount) {
      ctr[CTR_TESTS] += __popc(__ballot_sync(kFull, has));
      ctr[CTR_SLOTS] += 32;
    }
    float t, u, v;
    const bool hit = row_test<kCount, G == 1>(rows, has ? k : 0, y, has, tmx, t, u, v, deep);
    if (__ballot_sync(kFull, hit) & gmask) {
      occ = 1;
      open = false;
    }
  }
  if (has_ray && g == 0) a.occ_out[i] = occ;
  if (kCount) ctr[CTR_DEEP_SLOTS] += deep;
}

// The block's m live rays, G lanes a ray (ray threadIdx.x / G).
template <bool kAny, bool kCount, int G>
__device__ __forceinline__ void trace_rays(const Args& a, const float4* rows, int nrows,
                                           const int* live, int m, unsigned long long* ctr) {
  const int lane = threadIdx.x & 31;
  const int k = threadIdx.x / G;
  const bool has_ray = k < m;
  if (!__any_sync(kFull, has_ray)) return;
  const int i = has_ray ? live[k] : 0;
  if (kCount) ctr[CTR_RAYS] += __popc(__ballot_sync(kFull, has_ray && lane % G == 0));
  if (kAny) {
    any_group<kCount, G>(a, rows, nrows, has_ray, i, lane % G, ctr);
  } else {
    closest_group<kCount, G>(a, rows, nrows, has_ray, i, lane % G, ctr);
  }
}

// A block takes kThreads lanes of the input in caller order. It writes the
// dead lanes' outputs at once and queues the live lanes in shared memory in
// lane order (ballot + popc); a block without live lanes stops there. Then
// it stages the rows and traces its m live rays G lanes a ray, G the largest
// power of two up to 32 with G x m <= kThreads.
template <bool kAny, bool kCount>
__device__ __forceinline__ void trace(const Args& a) {
  __shared__ float4 s_rows[3 * kMaxRows];
  __shared__ int s_warp[kWarps];
  __shared__ int s_live[kThreads];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  stage_rows<kAny>(a, s_rows);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  bool live = false;
  if (i < a.n) {
    const float tmx = a.t_max[i];
    const float tmn = a.t_min[i];
    live = kAny ? tmn < tmx : tmn < (tmx < kBig ? tmx : kBig);
    if (!live) {
      if (kAny) {
        a.occ_out[i] = 0;
      } else {
        write_closest(a, i, 0.0f, -1, 0.0f, 0.0f);
      }
    }
  }
  const unsigned b = __ballot_sync(kFull, live);
  if (lane == 0) s_warp[warp] = __popc(b);
  __syncthreads();
  int pos = __popc(b & lt), m = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) pos += s_warp[w];
    m += s_warp[w];
  }
  if (live) s_live[pos] = i;
  __syncthreads();
  if (m == 0) return;
  unsigned long long ctr[kCounters] = {};
  if (2 * m > kThreads) {
    trace_rays<kAny, kCount, 1>(a, s_rows, a.p, s_live, m, ctr);
  } else if (4 * m > kThreads) {
    trace_rays<kAny, kCount, 2>(a, s_rows, a.p, s_live, m, ctr);
  } else if (8 * m > kThreads) {
    trace_rays<kAny, kCount, 4>(a, s_rows, a.p, s_live, m, ctr);
  } else if (16 * m > kThreads) {
    trace_rays<kAny, kCount, 8>(a, s_rows, a.p, s_live, m, ctr);
  } else if (32 * m > kThreads) {
    trace_rays<kAny, kCount, 16>(a, s_rows, a.p, s_live, m, ctr);
  } else {
    trace_rays<kAny, kCount, 32>(a, s_rows, a.p, s_live, m, ctr);
  }
  if (kCount && lane == 0) {
#pragma unroll
    for (int k = 0; k < kCounters; ++k)
      if (ctr[k]) atomicAdd(a.counters + k, ctr[k]);
  }
}

__global__ void __launch_bounds__(kThreads, 1) closest_kernel(const Args a) {
  trace<false, false>(a);
}
__global__ void __launch_bounds__(kThreads, 1) any_kernel(const Args a) { trace<true, false>(a); }
__global__ void __launch_bounds__(kThreads, 1) closest_counted_kernel(const Args a) {
  trace<false, true>(a);
}
__global__ void __launch_bounds__(kThreads, 1) any_counted_kernel(const Args a) {
  trace<true, true>(a);
}

int launch(void (*kernel)(Args), const Args& a, int device, void* stream) {
  if (a.p < 0 || a.p > kMaxRows || a.n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (a.n == 0) return 0;
  const int blocks = (a.n + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The number of uint64 counters a launch adds to when `counters` is given.
int brute_counters() { return kCounters; }

// Both entry points launch on `stream` of device `device`, do not
// synchronise, and return cudaGetLastError() after the launch (0 = success).
// `counters` (brute_counters() uint64) may be null. `occ_out` takes 0 / 1
// bytes (a torch.bool tensor).
int brute_closest(const float* o, const float* d, const float* t_min, const float* t_max,
                  const float* tab, int n, int p, float* t_out, int* slot_out, float* u_out,
                  float* v_out, unsigned long long* counters, int device, void* stream) {
  const Args a = {o, d, t_min, t_max, tab, t_out, slot_out, u_out, v_out, nullptr, counters,
                  n, p};
  return launch(counters ? closest_counted_kernel : closest_kernel, a, device, stream);
}

int brute_any(const float* o, const float* d, const float* t_min, const float* t_max,
              const float* tab, int n, int p, unsigned char* occ_out,
              unsigned long long* counters, int device, void* stream) {
  const Args a = {o, d, t_min, t_max, tab, nullptr, nullptr, nullptr, nullptr, occ_out,
                  counters, n, p};
  return launch(counters ? any_counted_kernel : any_kernel, a, device, stream);
}

}  // extern "C"
