// The fused whole-path kernel for Hopper (sm_90a), called through a plain C
// interface (ctypes): one launch renders a sample (megapath mode) or a pass
// of n_samples samples (persistent mode) of every pixel of pixel_xy.
//
// Replaces the TPU kernel luisarender_tpu/ops/fused_path.py _fused_kernel
// (fused_path.py:742, pl.pallas_call at :1631) with its BSDF closures from
// luisarender_tpu/ops/fused_bsdf.py, in its camgen and persistent modes, its
// environment mode (has_env, fused_path.py:746-760) and its ray-input mode
// (cam is None, fused_path.py:748-750 and :777-789).
// Per path: the camera ray and the independent sampler's xxhash seed made
// in the kernel; per bounce the closest trace over the triangle rows, then
// the analytic spheres (strict t < best_t, so the lowest row wins an exact
// tie); the interaction; the emissive-hit MIS; NEE with the uniform light
// pick, the alias triangle pick and a shadow ray; BSDF evaluation and
// sampling over matte / mirror / metal / plastic / glass / reflective
// disney; Russian roulette; 7 LCG draws a bounce in the reference's order.
// The plain PyTorch version is ops/fused_path.py paths_plain, with the
// BSDF math of ops/fused_bsdf.py; both follow the reference's operation
// order term by term.
//
// What bounds it on the H100: divergence, not the arithmetic at the card's
// rate nor memory. The work is arithmetic (every bounce tests every
// triangle row, ~46 operations, and sphere, ~17, for its closest hit and
// again for its shadow ray, and shades: 400 operations on matte to ~1,000
// on glass); device memory traffic is the pixel ids in and 16 B out per
// pixel, and the scene tables (<= 14.2 KB) are read from shared memory.
// One thread a pixel ran a warp until its longest path ended (a third of
// its lane-slots carried a live path) and through every surface type its
// lanes hit (two on average on scenes/materials.json).
//
// Design: persistent blocks over a pool of path slots in shared memory.
// The grid is as many blocks as the card holds at once (the occupancy
// query times the SM count, capped at what n needs). A block stages the
// scene tables once, column-major, so that the reads of one column at
// per-lane rows (the hit's triangle, sphere, instance and light rows) fall
// in distinct banks; the closest loop's reads at one row are broadcasts.
// It owns kSlots path slots, structure of arrays in dynamic shared memory:
// a path's ray, throughput, radiance, pdf, eta scale, RNG state and depth;
// its pixel, sample, iteration count, running sum and ray count; its
// closest hit and shade key. A round of the block loop:
//   1. refill: the empty slots take the next pixels from a global work
//      counter, one atomicAdd a block, offsets from a block scan;
//   2. compact: a block scan lists the live slots, so whole warps run on
//      live paths down to the tail;
//   3. trace: thread k traces live entries k, k + kThreads, ...: the
//      closest hit, and the key of what shades it (the hit instance's
//      surface type, or kKeyEnd for an escape or a hit without surface);
//   4. group: a counting sort of the live list by key (warp-aggregated
//      shared-memory atomics), so most warps shade one surface type;
//   5. shade: the rest of the bounce, on the sorted list;
//   6. retire: a path that ends adds to its pixel's sum; in persistent mode
//      the pixel's next sample starts in the same slot, so a pixel's
//      samples are summed in the plain version's order; a pixel that is
//      done writes rgb_out and rays_out at its own index and empties its
//      slot.
// The block leaves when the counter has passed n and no slot is live.
// Larger pools group better (more warps per key, the same few warps that
// straddle two keys): 1,536 slots under 512 threads, one block an SM, the
// pool 190 KB of its shared memory.
//
// Only who computes which path when changes. Every path runs the plain
// version's arithmetic in its order, its state round-trips through shared
// memory as bits, and a pixel's result does not depend on the lanes beside
// it, so each lane stays bit-equal with paths_plain whatever the grouping.
// The persistent mode's cap of n_samples * max_depth + 8 iterations counts
// per pixel, as in the plain version (it never binds: a path takes at most
// max_depth bounces).
//
// The work counter is one int of scratch from the caller; fused_path
// zeroes it with cudaMemsetAsync on the launch's stream before every
// launch, so launches queued back to back each start from pixel 0.
//
// Not used: tensor cores (wgmma), since the work is per-lane scalar fp32
// whose rounding must match the plain version, not a matrix product; TMA,
// since the tables are at most 14.2 KB, staged once per persistent block.
//
// The environment mode (fused_path_kernel<true>, megapath only) reads no
// environment table, as in the reference. The caller pre-samples each
// pixel's environment NEE candidate of every bounce, [wi.xyz, pdf * p_env,
// L.rgb] as (max_depth, 7, n) floats (consecutive pixels in consecutive
// words), from the pixel's own sampler stream (ops/fused_path.py
// env_nee_candidates); NEE picks the environment when u_sel < p_env, reads
// the candidate at (pixel, depth) and aims its shadow ray at p + wi *
// env_distance with normal -wi; the area lights take u_sel's rest, (u_sel -
// p_env) / (1 - p_env). A path that escapes ends there, so the slot's state
// when its pixel retires is the escape state: the kernel writes it, 7 words
// at the pixel's index (beta.rgb, pdf_bsdf, dir.xyz; dir (0, 0, 1) and the
// rest 0 for a path that never escaped), and the caller adds the
// environment's radiance in a dense pass. No per-slot state is added: beta,
// pdf_bsdf and the direction are already in the slot. The non-environment
// instantiation compiles the mode away.
//
// The ray-input mode (fused_path_kernel<kEnv, true>, megapath only, with or
// without an environment) starts each path from a ray the caller made (any
// camera, filter or clip plane; ops/fused_path.py trace_paths_fused): rays_in
// holds RAY_WORDS = 10 floats a pixel as (10, n), consecutive pixels in
// consecutive words: origin, direction, t_min, t_max, the camera weight
// (beta's three channels; negative under a filter's negative lobe) and the
// sampler state's bits, already past the camera's draws. The refill loads
// the path's 8 words of it into the slot in place of the camera ray. The
// first bounce's t range (t_min, min(t_max, 3e38)) is read from rays_in
// again in the trace phase while the slot's depth is 0, so the pool keeps
// its size (two more slot words would take it from 190,464 to 202,752 B);
// every later bounce, as in the camgen mode, tests (0, 3e38). The
// candidates of the environment mode come from the given states, which
// the kernel does not see: it reads them as it does in the camgen mode.
// The camgen instantiations compile the mode away.
//
// Build with --fmad=false and without fast math: the arithmetic rounds like
// the plain version, except the transcendentals (sinf, cosf, powf, expf,
// logf), which neither side rounds correctly; PyTorch's CUDA kernels call
// the same functions, so on the card the two agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxTris = 64;
constexpr int kMaxSpheres = 16;
constexpr int kMaxInst = 32;
constexpr int kMaxEntries = 4;
constexpr int kMaxLightTris = 8;
constexpr int kRowCols = 16;
constexpr int kInstCols = 32;
constexpr int kEntryCols = 8;
constexpr int kLightCols = 24;

// float32 roundings of the reference's double constants
constexpr float kPi = (float)3.14159265358979323846;
constexpr float kInvPi = (float)(1.0 / 3.14159265358979323846);
constexpr float kTwoPi = (float)(2.0 * 3.14159265358979323846);
constexpr float kBig = 3e38f;
constexpr float kOneMinusEps = (float)(1.0 - 1.0 / 16777216.0);
constexpr float kInvU32 = 2.3283064365386963e-10f;
constexpr float kShadowShrink = (float)(1.0 - 1e-3);

enum { ST_MATTE = 0, ST_MIRROR = 1, ST_METAL = 2, ST_PLASTIC = 3, ST_GLASS = 4,
       ST_DISNEY = 6 };
enum { EV_REFLECT = 0, EV_ENTER = 1, EV_EXIT = 2 };

}  // namespace

struct FusedParams {
  float cam[12];  // camera-to-world, row-major 3x4
  float s, radius, resx, resy;
  float rr_threshold, p_light;
  uint32_t seed;
  int sample_index, n_samples, max_depth, rr_depth;
  int n, n_tri, n_sph, n_inst, n_entry, n_light_tri;
  int flat_normals;
  int has_env;           // launch fused_path_kernel<true, *>: megapath only
  float p_env;           // NEE picks the environment when u_sel < p_env
  float env_area_scale;  // float32 of 1 / max(1 - p_env, 1e-8)
  float env_distance;    // an environment shadow ray ends this far away
  int has_rays;          // launch fused_path_kernel<*, true>: the paths start from rays_in
};

namespace {

// The scene tables in shared memory, column-major: column c of row j at
// [c * rows + j]. A warp whose lanes read one column at per-lane rows
// (the hit's triangle, sphere, instance or light row) then hits distinct
// banks; the closest loop's reads at one row for every lane are
// broadcasts either way.
struct Smem {
  float tri[kRowCols * kMaxTris];
  float shade[kRowCols * kMaxTris];  // ng, n0, n1, n2, tangent, instance
  float sph[kRowCols * kMaxSpheres];
  float inst[kInstCols * kMaxInst];
  float entry[kEntryCols * kMaxEntries];
  float light[kLightCols * kMaxLightTris];
};

// One row of a column-major table: r[c] reads column c.
template <int kRows>
struct Row {
  const float* p;  // the table's first column at this row
  __device__ __forceinline__ float operator[](int c) const { return p[c * kRows]; }
};
using TriRow = Row<kMaxTris>;
using SphRow = Row<kMaxSpheres>;
using InstRow = Row<kMaxInst>;
using EntryRow = Row<kMaxEntries>;
using LightRow = Row<kMaxLightTris>;

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ float dot3(V3 a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V3 neg3(V3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ V3 normalize3(V3 v) {
  const float inv = 1.0f / fmaxf(sqrtf(v.x * v.x + v.y * v.y + v.z * v.z), 1e-20f);
  return {v.x * inv, v.y * inv, v.z * inv};
}
__device__ __forceinline__ float safe_div(float a, float b) {
  return fabsf(b) > 1e-20f ? a / b : 0.0f;
}
__device__ __forceinline__ float balance(float a, float b) {
  return a / fmaxf(a + b, 1e-20f);
}

// --- the independent sampler (core/rng.py) ---------------------------------

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ uint32_t xxhash32_4(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3) {
  const uint32_t P2 = 2246822519u, P3 = 3266489917u, P4 = 668265263u,
                 P5 = 374761393u;
  uint32_t h = P5 + 16u;
  const uint32_t w[4] = {w0, w1, w2, w3};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    h = h + w[k] * P3;
    h = rotl(h, 17) * P4;
  }
  h = (h ^ (h >> 15)) * P2;
  h = (h ^ (h >> 13)) * P3;
  return h ^ (h >> 16);
}

__device__ __forceinline__ float lcg(uint32_t& st) {
  st = st * 0x0019660Du + 0x3C6EF35Fu;
  // (float)uint32 rounds to nearest, as the reference's conversion does
  return fminf(__uint2float_rn(st) * kInvU32, kOneMinusEps);
}

// --- sampling and frames -----------------------------------------------------

__device__ void concentric_disk(float u0, float u1, float& dx, float& dy) {
  const float ux = 2.0f * u0 - 1.0f;
  const float uy = 2.0f * u1 - 1.0f;
  const bool zero = ux == 0.0f && uy == 0.0f;
  const bool use_x = fabsf(ux) > fabsf(uy);
  const float r = use_x ? ux : uy;
  const float theta =
      use_x ? (kPi / 4.0f) * (uy / (ux == 0.0f ? 1.0f : ux))
            : (kPi / 2.0f) - (kPi / 4.0f) * (ux / (uy == 0.0f ? 1.0f : uy));
  dx = zero ? 0.0f : r * cosf(theta);
  dy = zero ? 0.0f : r * sinf(theta);
}

// core/types.py offset_ray_origin, one component
__device__ __forceinline__ float offset1(float p, float n) {
  const int of_i = (int)(256.0f * n);
  const int p_bits = __float_as_int(p);
  const float p_i = __int_as_float(p < 0.0f ? p_bits - of_i : p_bits + of_i);
  return fabsf(p) < (1.0f / 32.0f) ? p + (1.0f / 65536.0f) * n : p_i;
}

struct Frame {
  V3 s, t, n;
};

__device__ Frame frame_from_z_and_hint(V3 n, V3 h) {
  const float d = dot3(h, n);
  V3 s = v3(h.x - d * n.x, h.y - d * n.y, h.z - d * n.z);
  const float s_len = sqrtf(fmaxf(s.x * s.x + s.y * s.y + s.z * s.z, 0.0f));
  if (s_len > 1e-8f) {
    const float inv = 1.0f / fmaxf(s_len, 1e-20f);
    s = v3(s.x * inv, s.y * inv, s.z * inv);
    return {s, v3(n.y * s.z - n.z * s.y, n.z * s.x - n.x * s.z, n.x * s.y - n.y * s.x),
            n};
  }
  // Duff et al. branchless frame
  const float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + n.z);
  const float b = n.x * n.y * a;
  return {v3(1.0f + sign * n.x * n.x * a, sign * b, -sign * n.x),
          v3(b, sign + n.y * n.y * a, -n.y), n};
}

// --- GGX and Fresnel (ops/fused_bsdf.py) ---------------------------------------

__device__ float ggx_d(V3 h, float ax, float ay) {
  const float cos2 = h.z * h.z;
  const float cos4 = cos2 * cos2;
  const float e = (h.x * h.x / (ax * ax) + h.y * h.y / (ay * ay)) / fmaxf(cos2, 1e-12f);
  const float e1 = 1.0f + e;
  const float d = 1.0f / (kPi * ax * ay * fmaxf(cos4, 1e-12f) * (e1 * e1));
  return cos2 > 1e-12f ? d : 0.0f;
}

__device__ float ggx_lambda(V3 w, float ax, float ay) {
  const float cos2 = w.z * w.z;
  const float a2tan2 =
      (w.x * w.x * ax * ax + w.y * w.y * ay * ay) / fmaxf(cos2, 1e-12f);
  const float lam = 0.5f * (-1.0f + sqrtf(fmaxf(1.0f + a2tan2, 0.0f)));
  return cos2 > 1e-12f ? lam : 0.0f;
}

__device__ __forceinline__ float ggx_g(V3 wo, V3 wi, float ax, float ay) {
  return 1.0f / (1.0f + ggx_lambda(wo, ax, ay) + ggx_lambda(wi, ax, ay));
}

__device__ V3 ggx_sample_wh(V3 wo, float u0, float u1, float ax, float ay) {
  const V3 u = wo.z < 0.0f ? neg3(wo) : wo;
  const V3 v = normalize3(v3(ax * u.x, ay * u.y, u.z));
  const float lensq = v.x * v.x + v.y * v.y;
  const float inv_l = 1.0f / sqrtf(fmaxf(lensq, 1e-12f));
  const bool ok = lensq > 1e-12f;
  const float t1x = ok ? -v.y * inv_l : 1.0f;
  const float t1y = ok ? v.x * inv_l : 0.0f;
  const float t1z = 0.0f;
  const float t2x = v.y * t1z - v.z * t1y;
  const float t2y = v.z * t1x - v.x * t1z;
  const float t2z = v.x * t1y - v.y * t1x;
  const float r = sqrtf(fmaxf(u0, 0.0f));
  const float phi = kTwoPi * u1;
  const float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  const float sc = 0.5f * (1.0f + v.z);
  p2 = (1.0f - sc) * sqrtf(fmaxf(1.0f - p1 * p1, 0.0f)) + sc * p2;
  const float pz = sqrtf(fmaxf(1.0f - p1 * p1 - p2 * p2, 0.0f));
  const float nhx = p1 * t1x + p2 * t2x + pz * v.x;
  const float nhy = p1 * t1y + p2 * t2y + pz * v.y;
  const float nhz = p1 * t1z + p2 * t2z + pz * v.z;
  return normalize3(v3(ax * nhx, ay * nhy, fmaxf(nhz, 1e-6f)));
}

__device__ float ggx_pdf(V3 wo, V3 h, float ax, float ay) {
  const V3 u = wo.z < 0.0f ? neg3(wo) : wo;
  const float g1 = 1.0f / (1.0f + ggx_lambda(u, ax, ay));
  return ggx_d(h, ax, ay) * g1 * fmaxf(u.x * h.x + u.y * h.y + u.z * h.z, 0.0f) /
         fmaxf(fabsf(u.z), 1e-8f);
}

__device__ float fres_dielectric(float cos_i, float eta_t) {
  cos_i = clampf(cos_i, -1.0f, 1.0f);
  const bool entering = cos_i > 0.0f;
  const float ei = entering ? 1.0f : eta_t;
  const float et = entering ? eta_t : 1.0f;
  const float ci = fabsf(cos_i);
  const float sin_i = sqrtf(fmaxf(1.0f - ci * ci, 0.0f));
  const float sin_t = ei / et * sin_i;
  const float ct = sqrtf(fmaxf(1.0f - sin_t * sin_t, 0.0f));
  const float r_par = (et * ci - ei * ct) / fmaxf(et * ci + ei * ct, 1e-8f);
  const float r_perp = (ei * ci - et * ct) / fmaxf(ei * ci + et * ct, 1e-8f);
  return sin_t >= 1.0f ? 1.0f : 0.5f * (r_par * r_par + r_perp * r_perp);
}

__device__ float fres_conductor_1(float cos_i, float eta, float k) {
  const float ci = clampf(fabsf(cos_i), 0.0f, 1.0f);
  const float ci2 = ci * ci;
  const float si2 = 1.0f - ci2;
  const float eta2 = eta * eta;
  const float k2 = k * k;
  const float t0 = eta2 - k2 - si2;
  const float a2b2 = sqrtf(fmaxf(t0 * t0 + 4.0f * eta2 * k2, 0.0f));
  const float t1 = a2b2 + ci2;
  const float a = sqrtf(fmaxf(0.5f * (a2b2 + t0), 0.0f));
  const float t2 = 2.0f * a * ci;
  const float rs = (t1 - t2) / fmaxf(t1 + t2, 1e-8f);
  const float t3 = ci2 * a2b2 + si2 * si2;
  const float t4 = t2 * si2;
  const float rp = rs * (t3 - t4) / fmaxf(t3 + t4, 1e-8f);
  return 0.5f * (rp + rs);
}

__device__ __forceinline__ float schlick_w(float cos_t) {
  const float m = clampf(1.0f - cos_t, 0.0f, 1.0f);
  return (m * m) * (m * m) * m;
}

__device__ __forceinline__ float fres_schlick_1(float cos_i, float f0) {
  return f0 + (1.0f - f0) * schlick_w(fabsf(cos_i));
}

// --- the per-instance constants -------------------------------------------------

struct Inst {
  int stype;
  float c0[3], c1[3], c2[3], c3[3], p0, p1, ax, ay, d[6];
};

__device__ void load_inst(InstRow r, Inst& ic) {
  ic.stype = (int)r[0];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    ic.c0[k] = r[1 + k];
    ic.c1[k] = r[4 + k];
    ic.c2[k] = r[7 + k];
    ic.c3[k] = r[10 + k];
  }
  ic.p0 = r[13];
  ic.p1 = r[14];
  ic.ax = r[15];
  ic.ay = r[16];
#pragma unroll
  for (int k = 0; k < 6; ++k) ic.d[k] = r[25 + k];
}

struct Bsdf {
  float f[3];
  float pdf;
};

// --- per-type evaluation at a local wi, without side validation ------------------

__device__ Bsdf eval_matte(const Inst& ic, V3 wo, V3 wi) {
  const float cos_o = fabsf(wo.z);
  const float cos_i = fabsf(wi.z);
  const float sin_o = sqrtf(fmaxf(1.0f - wo.z * wo.z, 0.0f));
  const float sin_i = sqrtf(fmaxf(1.0f - wi.z * wi.z, 0.0f));
  const float inv_so = 1.0f / fmaxf(sin_o, 1e-20f);
  const float inv_si = 1.0f / fmaxf(sin_i, 1e-20f);
  const float cos_d_phi = (wi.x * inv_si) * (wo.x * inv_so) + (wi.y * inv_si) * (wo.y * inv_so);
  const float max_cos = (sin_i > 1e-4f && sin_o > 1e-4f) ? fmaxf(cos_d_phi, 0.0f) : 0.0f;
  const bool o_gt_i = cos_o > cos_i;
  const float sin_alpha = o_gt_i ? sin_i : sin_o;
  const float tan_beta =
      o_gt_i ? sin_o / fmaxf(cos_o, 1e-6f) : sin_i / fmaxf(cos_i, 1e-6f);
  const float on = ic.p0 + ic.p1 * max_cos * sin_alpha * tan_beta;
  const bool same = wo.z * wi.z > 0.0f;
  const float scale = same ? kInvPi * on * cos_i : 0.0f;
  return {{ic.c0[0] * scale, ic.c0[1] * scale, ic.c0[2] * scale},
          same ? cos_i * kInvPi : 0.0f};
}

__device__ Bsdf eval_mirror_metal(const Inst& ic, V3 wo, V3 wi, bool metal) {
  const V3 h = normalize3(v3(wo.x + wi.x, wo.y + wi.y, wo.z + wi.z));
  const bool same = wo.z * wi.z > 0.0f;
  const float cos_o = fabsf(wo.z);
  const float cos_i = fabsf(wi.z);
  const float d = ggx_d(h, ic.ax, ic.ay);
  const float g = ggx_g(wo, wi, ic.ax, ic.ay);
  const float dot_ih = wi.x * h.x + wi.y * h.y + wi.z * h.z;
  const float scale = d * g / fmaxf(4.0f * cos_o, 1e-8f);
  const float dot_oh = wo.x * h.x + wo.y * h.y + wo.z * h.z;
  const float pdf = ggx_pdf(wo, h, ic.ax, ic.ay) / fmaxf(4.0f * fabsf(dot_oh), 1e-8f);
  const bool valid = same && cos_o > 1e-6f && cos_i > 1e-6f;
  const float zed = valid ? scale : 0.0f;
  Bsdf out;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float f = metal ? ic.c0[k] * fres_conductor_1(dot_ih, ic.c2[k], ic.c3[k])
                          : fres_schlick_1(dot_ih, ic.c0[k]);
    out.f[k] = f * zed;
  }
  out.pdf = valid ? pdf : 0.0f;
  return out;
}

__device__ __forceinline__ float plastic_substrate_weight(const Inst& ic, float f_o) {
  const float w = ic.p1 * (1.0f - f_o);
  return w <= 0.0f ? 0.0f : w / fmaxf(w + f_o, 1e-8f);
}

__device__ Bsdf eval_plastic(const Inst& ic, V3 wo, V3 wi) {
  if (wo.z < 0.0f) {  // implicitly two-sided: flip the local z
    wo.z = -wo.z;
    wi.z = -wi.z;
  }
  const float eta = ic.p0;
  const float cos_o = fabsf(wo.z);
  const float cos_i = fabsf(wi.z);
  const bool same = wo.z * wi.z > 0.0f;
  const V3 h = normalize3(v3(wo.x + wi.x, wo.y + wi.y, wo.z + wi.z));
  const float d = ggx_d(h, ic.ax, ic.ay);
  const float g = ggx_g(wo, wi, ic.ax, ic.ay);
  const float f_h = fres_dielectric(wi.x * h.x + wi.y * h.y + wi.z * h.z, eta);
  const float f_coat = f_h * d * g / fmaxf(4.0f * cos_o * cos_i, 1e-8f);
  const float dot_oh = wo.x * h.x + wo.y * h.y + wo.z * h.z;
  const float pdf_coat = ggx_pdf(wo, h, ic.ax, ic.ay) / fmaxf(4.0f * fabsf(dot_oh), 1e-8f);
  const float f_i = fres_dielectric(cos_i, eta);
  const float f_o = fres_dielectric(cos_o, eta);
  const float a_exp = -(1.0f / fmaxf(cos_i, 1e-6f) + 1.0f / fmaxf(cos_o, 1e-6f));
  const float diff_base = (1.0f - f_i) * (1.0f - f_o) / fmaxf(eta * eta, 1e-8f) * kInvPi;
  const float w = plastic_substrate_weight(ic, f_o);
  const float pdf = (1.0f - w) * pdf_coat + w * (cos_i * kInvPi);
  Bsdf out;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    out.f[k] = same ? (f_coat + diff_base * expf(a_exp * ic.c1[k]) * ic.c0[k]) * cos_i : 0.0f;
  out.pdf = same ? pdf : 0.0f;
  return out;
}

__device__ __forceinline__ float glass_refl_prob(const Inst& ic, float f_wo) {
  const float r = ic.p1 * f_wo;
  const float t = (1.0f - ic.p1) * (1.0f - f_wo);
  return r <= 0.0f ? 0.0f : r / fmaxf(r + t, 1e-8f);
}

__device__ Bsdf eval_glass(const Inst& ic, V3 wo, V3 wi) {
  const float eta_t = ic.p0;
  const float cos_o = wo.z;
  const float cos_i = wi.z;
  const bool same = cos_o * cos_i > 0.0f;
  const float ratio = glass_refl_prob(ic, fres_dielectric(cos_o, eta_t));

  V3 h = normalize3(v3(wo.x + wi.x, wo.y + wi.y, wo.z + wi.z));
  if (h.z < 0.0f) h = neg3(h);
  const float d_r = ggx_d(h, ic.ax, ic.ay);
  const float g_r = ggx_g(wo, wi, ic.ax, ic.ay);
  const float dot_oh = wo.x * h.x + wo.y * h.y + wo.z * h.z;
  const float f_h = fres_dielectric(dot_oh, eta_t);
  const float refl_scale = f_h * d_r * g_r / fmaxf(4.0f * fabsf(cos_o), 1e-8f);
  const float pdf_refl =
      ggx_pdf(wo, h, ic.ax, ic.ay) / fmaxf(4.0f * fabsf(dot_oh), 1e-8f) * ratio;

  const float eta_rel = cos_o > 0.0f ? eta_t : 1.0f / eta_t;
  V3 t = normalize3(v3(wo.x + wi.x * eta_rel, wo.y + wi.y * eta_rel, wo.z + wi.z * eta_rel));
  if (t.z < 0.0f) t = neg3(t);
  const float dot_o = wo.x * t.x + wo.y * t.y + wo.z * t.z;
  const float dot_i = wi.x * t.x + wi.y * t.y + wi.z * t.z;
  const bool trans_ok = !same && dot_o * dot_i < 0.0f && fabsf(cos_o) > 1e-6f &&
                        fabsf(cos_i) > 1e-6f;
  const float g_t = ggx_g(wo, wi, ic.ax, ic.ay);
  const float d_t = ggx_d(t, ic.ax, ic.ay);
  const float f_ht = fres_dielectric(dot_o, eta_t);
  const float denom = dot_o + eta_rel * dot_i;
  const float trans_scale = (1.0f - f_ht) * d_t * g_t * fabsf(dot_i * dot_o) /
                            fmaxf(fabsf(cos_i * cos_o) * denom * denom, 1e-10f);
  const float q = eta_rel / fmaxf(fabsf(denom), 1e-8f);
  const float dwh_dwi = (q * q) * fabsf(dot_i);
  const float pdf_trans = ggx_pdf(wo, t, ic.ax, ic.ay) * dwh_dwi * (1.0f - ratio);

  const float abs_ci = fabsf(cos_i);
  const float refl_f = refl_scale * abs_ci;
  const float trans_f = trans_scale * abs_ci;
  Bsdf out;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    out.f[k] = same ? ic.c0[k] * refl_f : (trans_ok ? ic.c1[k] * trans_f : 0.0f);
  out.pdf = same ? pdf_refl : (trans_ok ? pdf_trans : 0.0f);
  return out;
}

__device__ __forceinline__ float gtr1(float cos_h, float alpha) {
  const float a2 = alpha * alpha;
  const float denom = kPi * logf(fmaxf(a2, 1e-8f)) * (1.0f + (a2 - 1.0f) * cos_h * cos_h);
  return (a2 - 1.0f) / (fabsf(denom) < 1e-12f ? 1e-12f : denom);
}

__device__ __forceinline__ float smith_g_sep_z(float wz, float alpha) {
  const float c2 = wz * wz;
  const float t2 = fmaxf(1.0f - c2, 0.0f) / fmaxf(c2, 1e-9f);
  return 2.0f / (1.0f + sqrtf(1.0f + alpha * alpha * t2));
}

__device__ Bsdf eval_disney(const Inst& ic, V3 wo, V3 wi) {
  const float met = ic.d[0];
  const bool same = wo.z * wi.z > 0.0f;
  const float cos_o = fabsf(wo.z);
  const float cos_i = fabsf(wi.z);
  V3 h = normalize3(v3(wo.x + wi.x, wo.y + wi.y, wo.z + wi.z));
  if (h.z < 0.0f) h = neg3(h);
  const float cos_d = wi.x * h.x + wi.y * h.y + wi.z * h.z;

  const float fo = schlick_w(cos_o);
  const float fi = schlick_w(cos_i);
  const float f_diffuse_s = (1.0f - 0.5f * fo) * (1.0f - 0.5f * fi);
  const float rr = 2.0f * ic.p1 * cos_d * cos_d;
  const float f_retro_s = rr * (fo + fi + fo * fi * (rr - 1.0f));
  const float dw = 1.0f - met;
  const float diff_s = kInvPi * (f_diffuse_s + f_retro_s) * dw;
  const float sheen_s = schlick_w(fabsf(cos_d)) * dw;

  const float d = ggx_d(h, ic.ax, ic.ay);
  const float g = ggx_g(wo, wi, ic.ax, ic.ay);
  const float f_diel = fres_dielectric(cos_d, ic.p0);
  const float spec_s = d * g / fmaxf(4.0f * cos_o * cos_i, 1e-6f);

  const float d_cc = gtr1(fabsf(h.z), ic.d[1]);
  const float f_cc_s = 0.04f + 0.96f * schlick_w(cos_d);
  const float g_cc = smith_g_sep_z(wo.z, 0.25f) * smith_g_sep_z(wi.z, 0.25f);
  const float cc =
      ic.d[2] * 0.25f * d_cc * f_cc_s * g_cc / fmaxf(4.0f * cos_o * cos_i, 1e-6f);

  const bool valid_r = same && cos_i > 1e-6f && cos_o > 1e-6f;
  Bsdf out;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float fres = (1.0f - met) * f_diel * ic.c3[k] + met * fres_schlick_1(cos_d, ic.c2[k]);
    const float f = ic.c0[k] * diff_s + ic.c1[k] * sheen_s + fres * spec_s + cc;
    out.f[k] = valid_r ? f * cos_i : 0.0f;
  }
  const float dot_oh = wo.x * h.x + wo.y * h.y + wo.z * h.z;
  const float pdf_spec = ggx_pdf(wo, h, ic.ax, ic.ay) / fmaxf(4.0f * fabsf(dot_oh), 1e-6f);
  const float pdf_cc = d_cc * fabsf(h.z) / fmaxf(4.0f * fabsf(dot_oh), 1e-6f);
  const float pdf = ic.d[3] * (cos_i * kInvPi) + ic.d[4] * pdf_spec + ic.d[5] * pdf_cc;
  out.pdf = (same && cos_o > 1e-6f) ? pdf : 0.0f;
  return out;
}

__device__ Bsdf eval_bsdf(const Inst& ic, V3 wo, V3 wi) {
  switch (ic.stype) {
    case ST_MIRROR: return eval_mirror_metal(ic, wo, wi, false);
    case ST_METAL: return eval_mirror_metal(ic, wo, wi, true);
    case ST_PLASTIC: return eval_plastic(ic, wo, wi);
    case ST_GLASS: return eval_glass(ic, wo, wi);
    case ST_DISNEY: return eval_disney(ic, wo, wi);
    default: return eval_matte(ic, wo, wi);
  }
}

// --- per-type direction sampling in the local frame ---------------------------------

struct Sample {
  V3 wi;
  int event;
  float eta;
  bool valid;
};

__device__ __forceinline__ V3 reflect_about(float d, V3 h, V3 w) {
  return v3(2.0f * d * h.x - w.x, 2.0f * d * h.y - w.y, 2.0f * d * h.z - w.z);
}

__device__ Sample sample_bsdf(const Inst& ic, V3 wo, float u_lobe, float u0, float u1) {
  Sample s{v3(0.0f, 0.0f, 1.0f), EV_REFLECT, 1.0f, true};
  switch (ic.stype) {
    case ST_MIRROR:
    case ST_METAL: {
      const V3 h = ggx_sample_wh(wo, u0, u1, ic.ax, ic.ay);
      s.wi = reflect_about(wo.x * h.x + wo.y * h.y + wo.z * h.z, h, wo);
      break;
    }
    case ST_PLASTIC: {
      const bool neg = wo.z < 0.0f;
      const V3 f = v3(wo.x, wo.y, neg ? -wo.z : wo.z);
      const bool pick_diffuse =
          u_lobe < plastic_substrate_weight(ic, fres_dielectric(fabsf(f.z), ic.p0));
      V3 w;
      if (pick_diffuse) {
        float dx, dy;
        concentric_disk(u0, u1, dx, dy);
        w = v3(dx, dy, sqrtf(fmaxf(1.0f - dx * dx - dy * dy, 0.0f)));
      } else {
        const V3 h = ggx_sample_wh(f, u0, u1, ic.ax, ic.ay);
        w = reflect_about(f.x * h.x + f.y * h.y + f.z * h.z, h, f);
      }
      s.wi = v3(w.x, w.y, neg ? -w.z : w.z);
      break;
    }
    case ST_GLASS: {
      const float eta_t = ic.p0;
      const bool pick_refl = u_lobe < glass_refl_prob(ic, fres_dielectric(wo.z, eta_t));
      V3 h = ggx_sample_wh(wo, u0, u1, ic.ax, ic.ay);
      if (wo.z < 0.0f) h = neg3(h);
      const float d = wo.x * h.x + wo.y * h.y + wo.z * h.z;
      s.eta = eta_t;
      if (pick_refl) {
        s.wi = reflect_about(d, h, wo);
      } else {
        const float eta = wo.z > 0.0f ? 1.0f / eta_t : eta_t;
        const V3 n = d < 0.0f ? neg3(h) : h;
        const float cos_i = n.x * wo.x + n.y * wo.y + n.z * wo.z;
        const float sin2_i = fmaxf(1.0f - cos_i * cos_i, 0.0f);
        const float sin2_t = eta * eta * sin2_i;
        const float cos_t = sqrtf(fmaxf(1.0f - sin2_t, 0.0f));
        const float coef = eta * cos_i - cos_t;
        s.wi = v3(eta * -wo.x + coef * n.x, eta * -wo.y + coef * n.y, eta * -wo.z + coef * n.z);
        s.event = wo.z > 0.0f ? EV_ENTER : EV_EXIT;
        s.valid = sin2_t < 1.0f;
      }
      break;
    }
    case ST_DISNEY: {
      const bool pick_diff = u_lobe < ic.d[3];
      const bool pick_spec = !pick_diff && u_lobe < ic.d[3] + ic.d[4];
      const float sign = wo.z < 0.0f ? -1.0f : 1.0f;
      s.eta = ic.p0;
      if (pick_diff) {
        float dx, dy;
        concentric_disk(u0, u1, dx, dy);
        s.wi = v3(dx, dy, sqrtf(fmaxf(1.0f - dx * dx - dy * dy, 0.0f)) * sign);
      } else if (pick_spec) {
        V3 h = ggx_sample_wh(wo, u0, u1, ic.ax, ic.ay);
        if (wo.z < 0.0f) h = neg3(h);
        s.wi = reflect_about(wo.x * h.x + wo.y * h.y + wo.z * h.z, h, wo);
      } else {
        const float a2 = ic.d[1] * ic.d[1];
        const float cos_h = sqrtf(fmaxf(
            (1.0f - powf(fmaxf(a2, 1e-12f), 1.0f - u0)) / fmaxf(1.0f - a2, 1e-6f), 0.0f));
        const float sin_h = sqrtf(fmaxf(1.0f - cos_h * cos_h, 0.0f));
        const float phi = kTwoPi * u1;
        const V3 h = v3(sin_h * cosf(phi), sin_h * sinf(phi), cos_h * sign);
        s.wi = reflect_about(wo.x * h.x + wo.y * h.y + wo.z * h.z, h, wo);
      }
      break;
    }
    default: {  // matte
      float dx, dy;
      concentric_disk(u0, u1, dx, dy);
      const float dz = sqrtf(fmaxf(1.0f - dx * dx - dy * dy, 0.0f));
      s.wi = v3(dx, dy, wo.z < 0.0f ? -dz : dz);
    }
  }
  return s;
}


// --- traces ------------------------------------------------------------------

// One triangle row against a ray, the reference's fused-kernel formula; ok
// excludes the t-range test.
__device__ __forceinline__ bool moller_trumbore(TriRow r, V3 o, V3 d, float& t, float& u,
                                                float& v) {
  const float v0x = r[0], v0y = r[1], v0z = r[2];
  const float e1x = r[3], e1y = r[4], e1z = r[5];
  const float e2x = r[6], e2y = r[7], e2z = r[8];
  const float px = d.y * e2z - d.z * e2y;
  const float py = d.z * e2x - d.x * e2z;
  const float pz = d.x * e2y - d.y * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;
  const float tx = o.x - v0x;
  const float ty = o.y - v0y;
  const float tz = o.z - v0z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (d.x * qx + d.y * qy + d.z * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return u >= 0.0f && v >= 0.0f && u + v <= 1.0f;
}

__device__ __forceinline__ void sphere_roots(SphRow r, V3 o, V3 d, float& disc, float& t0,
                                             float& t1) {
  const float ocx = o.x - r[0];
  const float ocy = o.y - r[1];
  const float ocz = o.z - r[2];
  const float b = ocx * d.x + ocy * d.y + ocz * d.z;
  const float c2 = ocx * ocx + ocy * ocy + ocz * ocz - r[3] * r[3];
  disc = b * b - c2;
  const float sq = sqrtf(fmaxf(disc, 0.0f));
  t0 = -b - sq;
  t1 = -b + sq;
}

__device__ bool occluded(const Smem& S, const FusedParams& P, V3 o, V3 d, float t_max) {
  for (int j = 0; j < P.n_tri; ++j) {
    const TriRow r{S.tri + j};
    if (r[9] == 0.0f || r[10] == 0.0f) continue;
    float t, u, v;
    if (moller_trumbore(r, o, d, t, u, v) && t > 0.0f && t < t_max) return true;
  }
  for (int j = 0; j < P.n_sph; ++j) {
    const SphRow r{S.sph + j};
    if (r[14] == 0.0f) continue;
    float disc, t0, t1;
    sphere_roots(r, o, d, disc, t0, t1);
    if (disc > 0.0f && ((t0 > 0.0f && t0 < t_max) || (t1 > 0.0f && t1 < t_max))) return true;
  }
  return false;
}

// --- the path ----------------------------------------------------------------

// A path's carried state. Its ray's t range is (0, kBig), as the camgen
// mode's camera ray and every continuation ray have it, except a ray-input
// path's first ray, whose range the trace phase reads from rays_in.
struct Path {
  V3 o, d;
  uint32_t st;
  float beta[3], L[3];
  bool active;
  float pdf_bsdf, eta_scale;
};

__device__ void gen_from_cam(const FusedParams& P, int px, int py, int si, Path& p) {
  uint32_t st = xxhash32_4((uint32_t)si, (uint32_t)px, (uint32_t)py, P.seed);
  const float u0 = lcg(st);
  const float u1 = lcg(st);
  const float fx = (float)px + 0.5f + (u0 * 2.0f - 1.0f) * P.radius;
  const float fy = (float)py + 0.5f + (u1 * 2.0f - 1.0f) * P.radius;
  const float pcx = (fx * 2.0f - P.resx) * P.s;
  const float pcy = (fy * 2.0f - P.resy) * P.s;
  const V3 dc = normalize3(v3(pcx, -pcy, 0.0f - 1.0f));
  const float* c = P.cam;
  p.d = normalize3(v3(c[0] * dc.x + c[1] * dc.y + c[2] * dc.z,
                      c[4] * dc.x + c[5] * dc.y + c[6] * dc.z,
                      c[8] * dc.x + c[9] * dc.y + c[10] * dc.z));
  p.o = v3(c[3], c[7], c[11]);
  p.st = st;
  p.beta[0] = p.beta[1] = p.beta[2] = 1.0f;
  p.L[0] = p.L[1] = p.L[2] = 0.0f;
  p.active = true;
  p.pdf_bsdf = 1e16f;
  p.eta_scale = 1.0f;
}

// Side validation (surfaces/base.py validate_sides); glass and disney skip it.
__device__ __forceinline__ bool side_ok(int stype, float wo_ng, float wo_ns, float wi_ng,
                                        float wi_ns) {
  return ((wo_ng * wi_ng > 0.0f) == (wo_ns * wi_ns > 0.0f)) || stype == ST_GLASS ||
         stype == ST_DISNEY;
}

// A closest hit: t, barycentrics and the triangle row (tri >= 0) or the
// sphere (sph >= 0); both -1 when the ray escapes.
struct Hit {
  float t, u, v;
  int tri, sph;
};

// The closest hit over the triangle rows, then the analytic spheres (strict
// t < best t, so the lowest row wins an exact tie, a triangle a tie with a
// sphere).
// The ray's t range is (t_min, t_max).
__device__ Hit trace_closest(const Smem& S, const FusedParams& P, V3 o, V3 d, float t_min,
                             float t_max) {
  Hit h{t_max, 0.0f, 0.0f, -1, -1};
  for (int j = 0; j < P.n_tri; ++j) {
    const TriRow r{S.tri + j};
    if (r[9] == 0.0f) continue;
    float t, u, v;
    if (moller_trumbore(r, o, d, t, u, v) && t > t_min && t < h.t) {
      h.t = t;
      h.u = u;
      h.v = v;
      h.tri = j;
    }
  }
  for (int j = 0; j < P.n_sph; ++j) {
    const SphRow r{S.sph + j};
    float disc, t0, t1;
    sphere_roots(r, o, d, disc, t0, t1);
    const float t = (t0 > t_min && t0 < h.t) ? t0 : t1;
    if (disc > 0.0f && t > t_min && t < h.t) {
      h.t = t;
      h.sph = j;
    }
  }
  return h;
}

// The instance a hit lands on.
__device__ __forceinline__ int hit_instance(const Smem& S, const Hit& h) {
  return h.sph >= 0 ? (int)SphRow{S.sph + h.sph}[13] : (int)TriRow{S.shade + h.tri}[15];
}

// What shades a hit: its instance's surface type (0..6), or kKeyEnd where
// the path ends at this hit (an escape, or an instance with no surface).
constexpr int kKeyEnd = 7;
constexpr int kKeys = 8;

__device__ __forceinline__ int shade_key(const Smem& S, const Hit& h) {
  if (h.tri < 0 && h.sph < 0) return kKeyEnd;
  const InstRow irow{S.inst + hit_instance(S, h)};
  return irow[18] > 0.5f ? (int)irow[0] : kKeyEnd;
}

// NEE's area-light sample (lightsamplers/uniform.py, lights/diffuse.py):
// the entry that u_area picks, a triangle of it by its alias table and
// u_l0, and a point on that triangle by u_l0's rest and u_l1; sets the
// point and the light's normal, and returns the entry's row.
__device__ __forceinline__ EntryRow area_light_point(const Smem& S, const FusedParams& P,
                                                     float u_area, float u_l0, float u_l1,
                                                     V3& lp, V3& lng) {
  const float ne = (float)P.n_entry;
  const float u_rel = clampf(u_area, 0.0f, kOneMinusEps);
  const int e = (int)fminf(floorf(u_rel * ne), ne - 1.0f);
  const EntryRow erow{S.entry + e};
  const float al_off = erow[0], tri_cnt = erow[1];
  const float ux = u_l0 * tri_cnt;
  const float i0 = fmaxf(fminf(floorf(ux), tri_cnt - 1.0f), 0.0f);
  const float up = ux - i0;
  LightRow lrow{S.light + (int)(al_off + i0)};
  if (up >= lrow[18]) lrow = LightRow{S.light + (int)(al_off + lrow[19])};
  const float su = sqrtf(fmaxf(up, 0.0f));
  const float b0 = 1.0f - su;
  const float b1 = u_l1 * su;
  const float b2 = 1.0f - b0 - b1;
  lp = v3(lrow[0] + b1 * lrow[3] + b2 * lrow[6], lrow[1] + b1 * lrow[4] + b2 * lrow[7],
          lrow[2] + b1 * lrow[5] + b2 * lrow[8]);
  lng = v3(lrow[9], lrow[10], lrow[11]);
  return erow;
}

// The vector from pos to the light point lp and its direction; returns its
// squared length.
__device__ __forceinline__ float toward(V3 pos, V3 lp, V3& wl, V3& wi) {
  wl = v3(lp.x - pos.x, lp.y - pos.y, lp.z - pos.z);
  const float wl2 = wl.x * wl.x + wl.y * wl.y + wl.z * wl.z;
  const float inv_wl = 1.0f / fmaxf(sqrtf(fmaxf(wl2, 0.0f)), 1e-12f);
  wi = v3(wl.x * inv_wl, wl.y * inv_wl, wl.z * inv_wl);
  return wl2;
}

// The solid-angle pdf of an area-light sample seen along wi at squared
// distance wl2, times the entry's pick probability; 0 where the light
// faces away (one-sided) or is seen edge on.
__device__ __forceinline__ float area_light_pdf(const FusedParams& P, EntryRow erow, V3 wi,
                                                V3 lng, float wl2) {
  const float cos_ll = dot3(neg3(wi), lng);
  const bool lit_l = cos_ll > 1e-6f || (erow[7] > 0.5f && fabsf(cos_ll) > 1e-6f);
  return lit_l ? wl2 / fmaxf(fabsf(cos_ll) * erow[2], 1e-12f) * P.p_light : 0.0f;
}

// NEE's shadow ray from pos toward the light point lp with normal lng
// (core/types.py spawn_ray_to): sets the BSDF's value toward the light and
// the MIS weight of a sample at pdf_nee, and returns whether the ray is
// open. The caller adds the light's contribution, f * Ln * w_mis, where it
// is.
__device__ __forceinline__ bool nee_shadow(const Smem& S, const FusedParams& P, const Inst& ic,
                                           const Frame& fr, V3 fn, V3 wol, float wo_ng,
                                           float wo_ns, V3 pos, V3 ng, V3 lp, V3 lng, V3 wl,
                                           V3 wi, float pdf_nee, Bsdf& fe, float& w_mis) {
  const float sgn_f = dot3(ng, wl) >= 0.0f ? 1.0f : -1.0f;
  const V3 so = v3(offset1(pos.x, sgn_f * ng.x), offset1(pos.y, sgn_f * ng.y),
                   offset1(pos.z, sgn_f * ng.z));
  const V3 bb = v3(so.x - lp.x, so.y - lp.y, so.z - lp.z);
  const float sgn_t = dot3(lng, bb) >= 0.0f ? 1.0f : -1.0f;
  const V3 se = v3(offset1(lp.x, sgn_t * lng.x), offset1(lp.y, sgn_t * lng.y),
                   offset1(lp.z, sgn_t * lng.z));
  V3 sd = v3(se.x - so.x, se.y - so.y, se.z - so.z);
  const float s_len = sqrtf(fmaxf(sd.x * sd.x + sd.y * sd.y + sd.z * sd.z, 0.0f));
  const float inv_s = 1.0f / fmaxf(s_len, 1e-20f);
  sd = v3(sd.x * inv_s, sd.y * inv_s, sd.z * inv_s);
  const float s_tmax = s_len * kShadowShrink;

  const V3 wil = v3(dot3(wi, fr.s), dot3(wi, fr.t), dot3(wi, fn));
  fe = eval_bsdf(ic, wol, wil);
  if (!side_ok(ic.stype, wo_ng, wo_ns, dot3(wi, ng), dot3(wi, fn))) {
    fe.f[0] = fe.f[1] = fe.f[2] = 0.0f;
    fe.pdf = 0.0f;
  }
  w_mis = safe_div(balance(pdf_nee, fe.pdf), pdf_nee);
  return !occluded(S, P, so, sd, s_tmax);
}

// The rest of one bounce of an active path at its closest hit h: the
// interaction, the emissive-hit MIS, NEE and its shadow ray, BSDF sampling
// and roulette; dep is its bounce depth. Counts the shadow ray in nrays.
// kEnv: the environment mode; env_cand holds the candidates, pix is the
// path's pixel.
template <bool kEnv>
__device__ void shade(const Smem& S, const FusedParams& P, Path& p, const Hit& h, float dep,
                      int& nrays, const float* env_cand, int pix) {
  if (h.tri < 0 && h.sph < 0) {  // the path escapes
    p.active = false;
    return;
  }

  // interaction (scene/geometry.py surface_interaction)
  V3 pos, ng, ns, tg;
  if (h.sph >= 0) {
    const SphRow r{S.sph + h.sph};
    const float rad = fmaxf(r[3], 1e-20f);
    const V3 n = normalize3(v3((p.o.x + h.t * p.d.x - r[0]) / rad,
                               (p.o.y + h.t * p.d.y - r[1]) / rad,
                               (p.o.z + h.t * p.d.z - r[2]) / rad));
    pos = v3(r[0] + r[3] * n.x, r[1] + r[3] * n.y, r[2] + r[3] * n.z);
    ng = n;
    ns = n;
    tg = v3(-n.y, n.x, 0.0f);
  } else {
    const TriRow tr{S.tri + h.tri};
    const TriRow sh{S.shade + h.tri};
    const float u = h.u, v = h.v;
    const float w = 1.0f - u - v;
    pos = v3(tr[0] + u * tr[3] + v * tr[6], tr[1] + u * tr[4] + v * tr[7],
             tr[2] + u * tr[5] + v * tr[8]);
    ng = v3(sh[0], sh[1], sh[2]);
    tg = v3(sh[12], sh[13], sh[14]);
    if (P.flat_normals) {
      ns = ng;
    } else {
      ns = v3(w * sh[3] + u * sh[6] + v * sh[9], w * sh[4] + u * sh[7] + v * sh[10],
              w * sh[5] + u * sh[8] + v * sh[11]);
      const float len2 = ns.x * ns.x + ns.y * ns.y + ns.z * ns.z;
      const float inv_ns = 1.0f / fmaxf(sqrtf(fmaxf(len2, 0.0f)), 1e-20f);
      ns = v3(ns.x * inv_ns, ns.y * inv_ns, ns.z * inv_ns);
      const bool ns_ok = len2 > 0.25f && isfinite(ns.x) && isfinite(ns.y) && isfinite(ns.z);
      if (!ns_ok) ns = ng;
      if (dot3(ns, ng) < 0.0f) ns = neg3(ns);
    }
  }
  const V3 wo = neg3(p.d);
  const InstRow irow{S.inst + hit_instance(S, h)};

  // emissive hit
  if (irow[19] > 0.5f) {
    const float cos_l = dot3(wo, ng);
    const bool lit = cos_l > 1e-6f || (irow[23] > 0.5f && fabsf(cos_l) > 1e-6f);
    if (lit) {
      const V3 dl = v3(p.o.x - pos.x, p.o.y - pos.y, p.o.z - pos.z);
      const float d2 = dl.x * dl.x + dl.y * dl.y + dl.z * dl.z;
      const float pdf_hit = d2 / fmaxf(fabsf(cos_l) * irow[24], 1e-12f) * P.p_light;
      const float w_mis = balance(p.pdf_bsdf, pdf_hit);
#pragma unroll
      for (int k = 0; k < 3; ++k) p.L[k] = p.L[k] + p.beta[k] * irow[20 + k] * w_mis;
    }
  }
  if (!(irow[18] > 0.5f)) {  // no surface: the path ends
    p.active = false;
    return;
  }
  Inst ic;
  load_inst(irow, ic);

  // the 7 draws of a bounce, in the reference's order
  const float u_sel = lcg(p.st);
  const float u_l0 = lcg(p.st);
  const float u_l1 = lcg(p.st);
  const float u_lobe = lcg(p.st);
  const float u_b0 = lcg(p.st);
  const float u_b1 = lcg(p.st);
  const float u_rr = lcg(p.st);

  // shading frame, flipped toward wo on two-sided surfaces
  Frame fr = frame_from_z_and_hint(ns, tg);
  V3 fn = ns;
  if (dot3(wo, fn) < 0.0f && irow[17] > 0.5f) {
    fr.t = neg3(fr.t);
    fn = neg3(fn);
  }
  const V3 wol = v3(dot3(wo, fr.s), dot3(wo, fr.t), dot3(wo, fn));
  const float wo_ng = dot3(wo, ng);
  const float wo_ns = dot3(wo, fn);

  // NEE. The environment mode picks the environment's candidate for this
  // bounce when u_sel < p_env, else an area light with u_sel's rest, and
  // then traces one shadow ray either way, so that a warp whose lanes pick
  // both runs the shadow ray once. The kernel without an environment takes
  // the area light in a branch of its own: sharing the environment mode's
  // branch costs it 4 registers (127 against 123). Both take their
  // arithmetic from the helpers above.
  if (kEnv) {
    const bool env_pick = u_sel < P.p_env;
    float ev[7];
    V3 lp = pos, lng = v3(0.0f, 0.0f, 1.0f);
    EntryRow erow{S.entry};
    if (env_pick) {
      // the candidate's target: a far point along it, facing back
      const float* c = env_cand + (size_t)((int)dep * 7) * P.n + pix;
#pragma unroll
      for (int k = 0; k < 7; ++k) ev[k] = c[(size_t)k * P.n];
      lp = v3(pos.x + ev[0] * P.env_distance, pos.y + ev[1] * P.env_distance,
              pos.z + ev[2] * P.env_distance);
      lng = v3(-ev[0], -ev[1], -ev[2]);
    } else if (P.n_entry > 0) {
      erow = area_light_point(S, P, (u_sel - P.p_env) * P.env_area_scale, u_l0, u_l1, lp, lng);
    }
    V3 wl, wi;
    const float wl2 = toward(pos, lp, wl, wi);
    float pdf_nee = 0.0f, Ln[3] = {0.0f, 0.0f, 0.0f};
    if (env_pick) {
      pdf_nee = ev[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) Ln[k] = ev[4 + k];
    } else if (P.n_entry > 0) {
      pdf_nee = area_light_pdf(P, erow, wi, lng, wl2);
#pragma unroll
      for (int k = 0; k < 3; ++k) Ln[k] = erow[4 + k];
    }
    if (pdf_nee > 0.0f) {
      nrays += 1;
      Bsdf fe;
      float w_mis;
      if (nee_shadow(S, P, ic, fr, fn, wol, wo_ng, wo_ns, pos, ng, lp, lng, wl, wi, pdf_nee, fe,
                     w_mis)) {
#pragma unroll
        for (int k = 0; k < 3; ++k) p.L[k] = p.L[k] + p.beta[k] * fe.f[k] * Ln[k] * w_mis;
      }
    }
  } else if (P.n_entry > 0) {
    V3 lp, lng;
    const EntryRow erow = area_light_point(S, P, u_sel, u_l0, u_l1, lp, lng);
    V3 wl, wi;
    const float wl2 = toward(pos, lp, wl, wi);
    const float pdf_nee = area_light_pdf(P, erow, wi, lng, wl2);
    if (pdf_nee > 0.0f) {
      nrays += 1;
      Bsdf fe;
      float w_mis;
      if (nee_shadow(S, P, ic, fr, fn, wol, wo_ng, wo_ns, pos, ng, lp, lng, wl, wi, pdf_nee, fe,
                     w_mis)) {
#pragma unroll
        for (int k = 0; k < 3; ++k) p.L[k] = p.L[k] + p.beta[k] * fe.f[k] * erow[4 + k] * w_mis;
      }
    }
  }

  // BSDF sampling
  const Sample smp = sample_bsdf(ic, wol, u_lobe, u_b0, u_b1);
  Bsdf fs = eval_bsdf(ic, wol, smp.wi);
  if (!smp.valid) fs.pdf = 0.0f;
  const V3 nw = v3(smp.wi.x * fr.s.x + smp.wi.y * fr.t.x + smp.wi.z * fn.x,
                   smp.wi.x * fr.s.y + smp.wi.y * fr.t.y + smp.wi.z * fn.y,
                   smp.wi.x * fr.s.z + smp.wi.y * fr.t.z + smp.wi.z * fn.z);
  if (!side_ok(ic.stype, wo_ng, wo_ns, dot3(nw, ng), dot3(nw, fn))) {
    fs.f[0] = fs.f[1] = fs.f[2] = 0.0f;
    fs.pdf = 0.0f;
  }
  const float sgn_r = dot3(ng, nw) >= 0.0f ? 1.0f : -1.0f;
  p.o = v3(offset1(pos.x, sgn_r * ng.x), offset1(pos.y, sgn_r * ng.y),
           offset1(pos.z, sgn_r * ng.z));
  p.d = nw;
  p.pdf_bsdf = fs.pdf;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float nb = p.beta[k] * safe_div(fs.f[k], fs.pdf);
    p.beta[k] = isfinite(nb) ? nb : 0.0f;
  }
  const float beta_max = fmaxf(p.beta[0], fmaxf(p.beta[1], p.beta[2]));
  if (smp.event == EV_ENTER) {
    p.eta_scale = p.eta_scale * smp.eta * smp.eta;
  } else if (smp.event == EV_EXIT) {
    p.eta_scale = p.eta_scale / fmaxf(smp.eta * smp.eta, 1e-12f);
  }
  bool active = fs.pdf > 0.0f && beta_max > 0.0f;

  // Russian roulette
  const float q = fmaxf(beta_max * p.eta_scale, 0.05f);
  if (active && dep + 1.0f >= (float)P.rr_depth && q < P.rr_threshold) {
    if (u_rr >= q) active = false;
    const float boost = 1.0f / fmaxf(q, 1e-6f);
#pragma unroll
    for (int k = 0; k < 3; ++k) p.beta[k] = p.beta[k] * boost;
  }
  p.active = active && dep + 1.0f < (float)P.max_depth;
}

// Copies a row-major (rows, cols) table into its column-major place.
template <int kRows>
__device__ void stage(const float* src, float* dst, int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += blockDim.x)
    dst[(i % cols) * kRows + i / cols] = src[i];
}

__device__ void stage_tables(Smem& S, const FusedParams& P, const float* tri,
                             const float* shade, const float* sph, const float* inst,
                             const float* entry, const float* light) {
  stage<kMaxTris>(tri, S.tri, P.n_tri, kRowCols);
  stage<kMaxTris>(shade, S.shade, P.n_tri, kRowCols);
  stage<kMaxSpheres>(sph, S.sph, P.n_sph, kRowCols);
  stage<kMaxInst>(inst, S.inst, P.n_inst, kInstCols);
  stage<kMaxEntries>(entry, S.entry, P.n_entry > 0 ? P.n_entry : 1, kEntryCols);
  stage<kMaxLightTris>(light, S.light, P.n_light_tri, kLightCols);
}

// Per-launch counters (optional; null on the main path), summed over the
// grid: the scheduler's lane use and the shade phase's divergence.
enum {
  STAT_LANE_SLOTS,   // 32 x warp passes of the trace phase
  STAT_TRACED,       // paths traced (bounces)
  STAT_SHADED,       // paths shaded at a surface (key != kKeyEnd)
  STAT_SHADE_SLOTS,  // 32 x warp passes of the shade phase
  STAT_KEYS,         // distinct keys summed over the shade phase's warp passes
  STAT_ROUNDS,       // rounds of the block loop, summed over blocks
  STAT_FETCHES,      // atomics on the work counter
  kStats
};

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

constexpr unsigned kFull = 0xffffffffu;

// --- the scheduler: persistent blocks over a pool of path slots ------------

constexpr int kThreads = 512;
constexpr int kSlots = 1536;  // a multiple of kThreads
constexpr int kWarps = kThreads / 32;
constexpr int kPasses = kSlots / kThreads;

// A slot's words, structure of arrays: word w of slot s at [w * kSlots + s].
// Floats are kept as their bits (__float_as_uint), so a path's state
// round-trips exactly.
enum {
  W_OX, W_OY, W_OZ, W_DX, W_DY, W_DZ, W_BETA0, W_BETA1, W_BETA2, W_L0, W_L1, W_L2,
  W_PDF, W_ETA, W_ST, W_DEP,                 // the path
  W_PIX, W_SAMP, W_ITER, W_ACC0, W_ACC1, W_ACC2, W_NRAYS,  // its pixel (W_PIX -1: empty)
  W_HT, W_HU, W_HV, W_HTRI, W_HSPH, W_KEY,   // its closest hit and shade key
  kWords
};
constexpr int kPoolBytes = (kWords + 2) * kSlots * 4;  // the words, the live and sorted lists

struct Pool {
  uint32_t* w;
  __device__ __forceinline__ uint32_t& u(int word, int s) const {
    return w[word * kSlots + s];
  }
  __device__ __forceinline__ float f(int word, int s) const {
    return __uint_as_float(u(word, s));
  }
  __device__ __forceinline__ void set(int word, int s, float x) const {
    u(word, s) = __float_as_uint(x);
  }
  __device__ __forceinline__ int i(int word, int s) const { return (int)u(word, s); }
  __device__ __forceinline__ void seti(int word, int s, int x) const {
    u(word, s) = (uint32_t)x;
  }
};

__device__ void store_path(const Pool& q, int s, const Path& p, float dep, int nrays) {
  q.set(W_OX, s, p.o.x);
  q.set(W_OY, s, p.o.y);
  q.set(W_OZ, s, p.o.z);
  q.set(W_DX, s, p.d.x);
  q.set(W_DY, s, p.d.y);
  q.set(W_DZ, s, p.d.z);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    q.set(W_BETA0 + k, s, p.beta[k]);
    q.set(W_L0 + k, s, p.L[k]);
  }
  q.set(W_PDF, s, p.pdf_bsdf);
  q.set(W_ETA, s, p.eta_scale);
  q.u(W_ST, s) = p.st;
  q.set(W_DEP, s, dep);
  q.seti(W_NRAYS, s, nrays);
}

__device__ void load_path(const Pool& q, int s, Path& p) {
  p.o = v3(q.f(W_OX, s), q.f(W_OY, s), q.f(W_OZ, s));
  p.d = v3(q.f(W_DX, s), q.f(W_DY, s), q.f(W_DZ, s));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p.beta[k] = q.f(W_BETA0 + k, s);
    p.L[k] = q.f(W_L0 + k, s);
  }
  p.pdf_bsdf = q.f(W_PDF, s);
  p.eta_scale = q.f(W_ETA, s);
  p.st = q.u(W_ST, s);
  p.active = true;
}

// Exclusive prefix sum of v over the block's threads in thread order; every
// thread calls it, and gets the block's sum in `total`.
__device__ int block_scan(int v, int* warp_sums, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) {
    const int t = warp_sums[k];
    before += k < warp ? t : 0;
    sum += t;
  }
  __syncthreads();
  total = sum;
  return before + x - v;
}

// Slot s takes pixel k: its first sample's camera ray. A megapath pixel at
// depth 0 is done at once (black, no ray) and leaves the slot empty.
// The environment mode's escape state of pixel i: the path's (beta,
// pdf_bsdf, dir) where it escaped, else 0 and dir (0, 0, 1).
__device__ __forceinline__ void write_escape(const FusedParams& P, float* esc_out, int i,
                                             const Path* p) {
  const size_t n = (size_t)P.n;
  const float w[7] = {p ? p->beta[0] : 0.0f, p ? p->beta[1] : 0.0f, p ? p->beta[2] : 0.0f,
                      p ? p->pdf_bsdf : 0.0f, p ? p->d.x : 0.0f, p ? p->d.y : 0.0f,
                      p ? p->d.z : 1.0f};
#pragma unroll
  for (int k = 0; k < 7; ++k) esc_out[k * n + i] = w[k];
}

// The ray-input mode's start of pixel k: its ray, camera weight and state
// from rays_in (word w of pixel k at [w * n + k]).
__device__ void load_ray(const FusedParams& P, const float* rays_in, int k, Path& p) {
  const size_t n = (size_t)P.n;
  p.o = v3(rays_in[k], rays_in[n + k], rays_in[2 * n + k]);
  p.d = v3(rays_in[3 * n + k], rays_in[4 * n + k], rays_in[5 * n + k]);
  const float beta0 = rays_in[8 * n + k];
  p.beta[0] = p.beta[1] = p.beta[2] = beta0;
  p.st = __float_as_uint(rays_in[9 * n + k]);
  p.L[0] = p.L[1] = p.L[2] = 0.0f;
  p.active = true;
  p.pdf_bsdf = 1e16f;
  p.eta_scale = 1.0f;
}

template <bool kEnv, bool kRays>
__device__ void start_pixel(const Pool& q, const FusedParams& P, const int* pixel_xy,
                            const float* rays_in, float* rgb_out, int* rays_out,
                            float* esc_out, int s, int k) {
  if (P.n_samples == 0 && P.max_depth == 0) {
    rgb_out[3 * k] = rgb_out[3 * k + 1] = rgb_out[3 * k + 2] = 0.0f;
    rays_out[k] = 0;
    if (kEnv) write_escape(P, esc_out, k, nullptr);
    return;
  }
  Path p;
  if (kRays)
    load_ray(P, rays_in, k, p);
  else
    gen_from_cam(P, pixel_xy[2 * k], pixel_xy[2 * k + 1], P.sample_index, p);
  store_path(q, s, p, 0.0f, 0);
  q.seti(W_PIX, s, k);
  q.seti(W_SAMP, s, 0);
  q.seti(W_ITER, s, 0);
  q.set(W_ACC0, s, 0.0f);
  q.set(W_ACC1, s, 0.0f);
  q.set(W_ACC2, s, 0.0f);
}

// One bounce's shading of the path in slot s, then its bookkeeping: a path
// that ends adds to its pixel's sum and, in persistent mode, starts the
// pixel's next sample; a pixel that is done writes its outputs and empties
// the slot.
template <bool kEnv>
__device__ void shade_slot(const Smem& S, const Pool& q, const FusedParams& P,
                           const int* pixel_xy, float* rgb_out, int* rays_out,
                           const float* env_cand, float* esc_out, int s) {
  Path p;
  load_path(q, s, p);
  const Hit h{q.f(W_HT, s), q.f(W_HU, s), q.f(W_HV, s), q.i(W_HTRI, s), q.i(W_HSPH, s)};
  float dep = q.f(W_DEP, s);
  int nrays = q.i(W_NRAYS, s) + 1;  // the closest ray
  // the environment mode reads the pixel's candidates; the other reads
  // the pixel after shading, as it did before the mode
  shade<kEnv>(S, P, p, h, dep, nrays, env_cand, kEnv ? q.i(W_PIX, s) : 0);
  const int i = q.i(W_PIX, s);
  if (P.n_samples == 0) {
    if (!p.active) {
      rgb_out[3 * i] = p.L[0];
      rgb_out[3 * i + 1] = p.L[1];
      rgb_out[3 * i + 2] = p.L[2];
      rays_out[i] = nrays;
      // an escape leaves the path's state as it was when it escaped
      if (kEnv) write_escape(P, esc_out, i, h.tri < 0 && h.sph < 0 ? &p : nullptr);
      q.seti(W_PIX, s, -1);
      return;
    }
    dep = dep + 1.0f;
  } else {
    const int it = q.i(W_ITER, s) + 1;
    float acc[3] = {q.f(W_ACC0, s), q.f(W_ACC1, s), q.f(W_ACC2, s)};
    if (p.active) {
      dep = dep + 1.0f;
    } else {
#pragma unroll
      for (int k = 0; k < 3; ++k) acc[k] = acc[k] + p.L[k];
      const int samp = q.i(W_SAMP, s) + 1;
      q.seti(W_SAMP, s, samp);
      if (samp < P.n_samples) {
        gen_from_cam(P, pixel_xy[2 * i], pixel_xy[2 * i + 1], P.sample_index + samp, p);
        dep = 0.0f;
      }
    }
    if (!p.active || it >= P.n_samples * P.max_depth + 8) {
      rgb_out[3 * i] = acc[0];
      rgb_out[3 * i + 1] = acc[1];
      rgb_out[3 * i + 2] = acc[2];
      rays_out[i] = nrays;
      q.seti(W_PIX, s, -1);
      return;
    }
    q.seti(W_ITER, s, it);
    q.set(W_ACC0, s, acc[0]);
    q.set(W_ACC1, s, acc[1]);
    q.set(W_ACC2, s, acc[2]);
  }
  store_path(q, s, p, dep, nrays);
}

template <bool kEnv, bool kRays>
__global__ void __launch_bounds__(kThreads)
    fused_path_kernel(const FusedParams P, const int* __restrict__ pixel_xy,
                      const float* __restrict__ rays_in, const float* __restrict__ tri,
                      const float* __restrict__ shade_t,
                      const float* __restrict__ sph, const float* __restrict__ inst,
                      const float* __restrict__ entry, const float* __restrict__ light,
                      const float* __restrict__ env_cand, float* __restrict__ rgb_out,
                      int* __restrict__ rays_out, float* __restrict__ esc_out,
                      int* __restrict__ work, unsigned long long* __restrict__ stats) {
  __shared__ Smem S;
  __shared__ int warp_sums[kWarps];
  __shared__ int fetched, count[kKeys], start[kKeys];
  extern __shared__ uint32_t pool_words[];
  const Pool q{pool_words};
  int* live = reinterpret_cast<int*>(pool_words + kWords * kSlots);
  int* order = live + kSlots;
  const int tid = threadIdx.x, lane = tid & 31;

  stage_tables(S, P, tri, shade_t, sph, inst, entry, light);
  for (int s = tid; s < kSlots; s += kThreads) q.seti(W_PIX, s, -1);
  __syncthreads();
  unsigned long long st[kStats] = {};
  bool exhausted = false;  // the same in every thread of the block
  for (;;) {
    // 1. refill: the empty slots take the next pixels, one atomicAdd a block
    if (!exhausted) {
      int empty[kPasses], n_empty = 0;
#pragma unroll
      for (int k = 0; k < kPasses; ++k) {
        empty[k] = q.i(W_PIX, kPasses * tid + k) < 0;
        n_empty += empty[k];
      }
      int total;
      int rank = block_scan(n_empty, warp_sums, total);
      if (total) {
        if (tid == 0) fetched = atomicAdd(work, total);
        __syncthreads();
        const int base = fetched;
        st[STAT_FETCHES] += tid == 0;
#pragma unroll
        for (int k = 0; k < kPasses; ++k) {
          if (empty[k] && base + rank < P.n)
            start_pixel<kEnv, kRays>(q, P, pixel_xy, rays_in, rgb_out, rays_out, esc_out,
                                     kPasses * tid + k, base + rank);
          rank += empty[k];
        }
        exhausted = base + total >= P.n;
      }
    }
    // 2. compact: the live slots, in slot order
    int alive[kPasses], n_alive = 0;
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      alive[k] = q.i(W_PIX, kPasses * tid + k) >= 0;
      n_alive += alive[k];
    }
    int n_live;
    int rank = block_scan(n_alive, warp_sums, n_live);
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      if (alive[k]) live[rank] = kPasses * tid + k;
      rank += alive[k];
    }
    if (n_live == 0) {
      if (exhausted) break;
      continue;
    }
    if (tid == 0) {
      st[STAT_ROUNDS] += 1;
      st[STAT_TRACED] += n_live;
      st[STAT_LANE_SLOTS] += 32 * ((n_live + 31) / 32);
    }
    if (tid < kKeys) count[tid] = 0;
    __syncthreads();

    // 3. trace: entry e of the live list on thread e mod kThreads
    for (int e = tid; e < n_live; e += kThreads) {
      const int s = live[e];
      float t_min = 0.0f, t_max = kBig;
      if (kRays && q.f(W_DEP, s) == 0.0f) {  // a ray-input path's first ray
        const size_t n = (size_t)P.n;
        const int k = q.i(W_PIX, s);
        t_min = rays_in[6 * n + k];
        const float tm = rays_in[7 * n + k];
        t_max = tm > kBig ? kBig : tm;  // min(t_max, 3e38); a NaN stays NaN
      }
      const Hit h = trace_closest(S, P, v3(q.f(W_OX, s), q.f(W_OY, s), q.f(W_OZ, s)),
                                  v3(q.f(W_DX, s), q.f(W_DY, s), q.f(W_DZ, s)), t_min, t_max);
      q.set(W_HT, s, h.t);
      q.set(W_HU, s, h.u);
      q.set(W_HV, s, h.v);
      q.seti(W_HTRI, s, h.tri);
      q.seti(W_HSPH, s, h.sph);
      q.seti(W_KEY, s, shade_key(S, h));
    }
    __syncthreads();

    // 4. group: a counting sort of the live list by key (warp-aggregated
    // shared-memory atomics; the order within a key does not matter)
    int key[kPasses], pos[kPasses];
#pragma unroll
    for (int k = 0; k < kPasses; ++k) {
      const int e = k * kThreads + tid;
      key[k] = e < n_live ? q.i(W_KEY, live[e]) : -1;
      const unsigned same = __match_any_sync(kFull, key[k]);
      const int leader = __ffs(same) - 1;
      int off = 0;
      if (lane == leader && key[k] >= 0) off = atomicAdd(&count[key[k]], __popc(same));
      pos[k] = __shfl_sync(kFull, off, leader) + __popc(same & lanemask_lt());
    }
    __syncthreads();
    if (tid == 0) {
      int a = 0;
#pragma unroll
      for (int k = 0; k < kKeys; ++k) {
        start[k] = a;
        a += count[k];
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPasses; ++k)
      if (key[k] >= 0) order[start[key[k]] + pos[k]] = live[k * kThreads + tid];
    __syncthreads();

    // 5. shade the sorted list; 6. retire finished pixels
    for (int base = 0; base < n_live; base += kThreads) {
      const int e = base + tid;
      const bool on = e < n_live;
      const unsigned lanes = __ballot_sync(kFull, on);
      if (!lanes) break;
      if (stats && on) {
        const int k = q.i(W_KEY, order[e]);
        const unsigned same = __match_any_sync(lanes, k);
        const unsigned first = __ballot_sync(lanes, (same & lanemask_lt()) == 0);
        if (lane == 0) {
          st[STAT_KEYS] += __popc(first);
          st[STAT_SHADE_SLOTS] += 32;
        }
        st[STAT_SHADED] += k != kKeyEnd;
      }
      if (on)
        shade_slot<kEnv>(S, q, P, pixel_xy, rgb_out, rays_out, env_cand, esc_out, order[e]);
    }
    __syncthreads();
  }
  if (stats) {
#pragma unroll
    for (int k = 0; k < kStats; ++k) {
      unsigned long long v = st[k];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
      if (lane == 0 && v) atomicAdd(stats + k, v);
    }
  }
}

// Blocks of fused_path_kernel<kEnv, kRays> resident on one SM of `device`,
// queried once (after raising the kernel's dynamic shared memory limit to
// its pool).
template <bool kEnv, bool kRays>
int blocks_per_sm(int device) {
  static int cached[64] = {};
  if (device < 0 || device >= 64) return 0;
  if (!cached[device]) {
    if (cudaSetDevice(device) != cudaSuccess) return 0;
    if (cudaFuncSetAttribute(fused_path_kernel<kEnv, kRays>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kPoolBytes) != cudaSuccess)
      return 0;
    int nb = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&nb, fused_path_kernel<kEnv, kRays>,
                                                      kThreads, kPoolBytes) != cudaSuccess)
      return 0;
    cached[device] = nb;
  }
  return cached[device];
}

}  // namespace

extern "C" {

// Blocks of the kernel resident on one SM of `device` (the environment
// mode's when env is nonzero, the ray-input mode's when rays is).
int fused_path_blocks_per_sm(int device, int env, int rays) {
  if (rays) return env ? blocks_per_sm<true, true>(device) : blocks_per_sm<false, true>(device);
  return env ? blocks_per_sm<true, false>(device) : blocks_per_sm<false, false>(device);
}

// Bytes of dynamic shared memory a block of fused_path_kernel takes (its
// slot pool; ptxas reports only the static tables).
int fused_path_pool_bytes() { return kPoolBytes; }

// Words of a pixel's escape state in the environment mode (beta.rgb,
// pdf_bsdf, dir.xyz); its presence marks this C interface.
int fused_path_env_words() { return 7; }

// Words of a pixel's ray in the ray-input mode (origin, direction, t_min,
// t_max, camera weight, sampler state); its presence marks this C
// interface.
int fused_path_ray_words() { return 10; }

// Launches on `stream` of device `device`, does not synchronise, and returns
// the first CUDA error (0 = success). `work` is one int of device scratch,
// zeroed here on the stream before the launch; `stats`, when not null,
// kStats uint64 counters the kernel adds to. With P.has_env (megapath only)
// env_cand holds the (max_depth, 7, n) candidates and esc_out receives the
// (7, n) escape state; both are ignored otherwise. With P.has_rays
// (megapath only) the paths start from rays_in, (10, n) floats, and
// pixel_xy is not read; without it rays_in is not read.
int fused_path(const FusedParams* params, const int* pixel_xy, const float* rays_in,
               const float* tri, const float* shade, const float* sph, const float* inst,
               const float* entry, const float* light, const float* env_cand,
               float* rgb_out, int* rays_out, float* esc_out, int* work,
               unsigned long long* stats, int device, void* stream) {
  const FusedParams& P = *params;
  if (P.n_tri < 1 || P.n_tri > kMaxTris || P.n_sph < 0 || P.n_sph > kMaxSpheres ||
      P.n_inst < 1 || P.n_inst > kMaxInst || P.n_entry < 0 || P.n_entry > kMaxEntries ||
      P.n_light_tri < 1 || P.n_light_tri > kMaxLightTris || P.n < 0 || P.max_depth < 0 ||
      P.n_samples < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (P.has_env && (P.n_samples != 0 || !env_cand || !esc_out))
    return static_cast<int>(cudaErrorInvalidValue);
  if (P.has_rays ? (P.n_samples != 0 || !rays_in) : !pixel_xy)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (P.n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(work, 0, sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_sm = fused_path_blocks_per_sm(device, P.has_env, P.has_rays);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int need = (P.n + kThreads - 1) / kThreads;
  const int blocks = need < per_sm * sms ? need : per_sm * sms;
#define FUSED_PATH_LAUNCH(kEnv, kRays)                                                  \
  fused_path_kernel<kEnv, kRays><<<blocks, kThreads, kPoolBytes, s>>>(                    \
      P, pixel_xy, rays_in, tri, shade, sph, inst, entry, light, env_cand, rgb_out, rays_out, \
      esc_out, work, stats)
  if (P.has_rays && P.has_env)
    FUSED_PATH_LAUNCH(true, true);
  else if (P.has_rays)
    FUSED_PATH_LAUNCH(false, true);
  else if (P.has_env)
    FUSED_PATH_LAUNCH(true, false);
  else
    FUSED_PATH_LAUNCH(false, false);
#undef FUSED_PATH_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
