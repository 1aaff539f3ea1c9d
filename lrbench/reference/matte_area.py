"""Plain reference of the megapath render of a scene of triangle meshes
with constant matte surfaces and constant diffuse area lights (the Cornell
box), in plain PyTorch.

It follows the fused kernel's documented semantics, term by term and in
the same operation order, so that a sample of a pixel traces the same path
as the program's sample of that pixel: the independent sampler (xxhash32
seed of sample index, pixel and sampler seed, then LCG draws: two for the
box filter, seven a bounce), the pinhole camera, Moller-Trumbore closest
hits (the first of equal minima), the emissive-hit MIS, NEE through the
light entry's area alias table with its shadow ray, the Oren-Nayar matte
BSDF (Lambert at sigma 0) and its cosine sample, Russian roulette, and the
colour film (relative clamp, NaN rejection, mean over the samples). The
arithmetic was frozen from the port's plain version of the fused kernel
(ops/fused_path.py paths_plain, ops/fused_bsdf.py, core/rng.py, ops/brute.py
mt_uvt) and its scene tables from scene/compiler.py and scene/geometry.py;
it imports nothing of the program and builds every table itself from the
scene dict, in scene order (not the program's BVH order, so an exact tie
in t between two triangles may pick the other one).

`precision="bf16"` is the control: every table and every stored
intermediate of a bounce (ray, hit, frame, BSDF values, throughput,
radiance) rounded to bfloat16, the arithmetic between them in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
PRIME32_2 = 2246822519
PRIME32_3 = 3266489917
PRIME32_4 = 668265263
PRIME32_5 = 374761393
LCG_A = 0x0019660D
LCG_C = 0x3C6EF35F
INV_U32 = 2.3283064365386963e-10
ONE_MINUS_EPSILON = 1.0 - 2.0 ** -24
INV_PI = 1.0 / math.pi
F32_BIG = 3e38
where = torch.where


# --- the independent sampler -------------------------------------------


def _u32(x):
    if not torch.is_tensor(x):
        return int(x) & MASK32
    return x.to(torch.int64) & MASK32


def _mul32(a, m):
    lo = m & 0xFFFF
    hi = (m >> 16) & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & MASK32


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & MASK32


def xxhash32(*words):
    words = [_u32(w) for w in words]
    h = _u32(PRIME32_5 + 4 * len(words))
    for w in words:
        h = (h + _mul32(w, PRIME32_3)) & MASK32
        h = _mul32(_rotl(h, 17), PRIME32_4)
    h = _mul32(h ^ (h >> 15), PRIME32_2)
    h = _mul32(h ^ (h >> 13), PRIME32_3)
    return h ^ (h >> 16)


def lcg_step(state):
    new = (_mul32(_u32(state), LCG_A) + LCG_C) & MASK32
    u = torch.clamp(new.to(torch.float32) * INV_U32, max=ONE_MINUS_EPSILON)
    return new, u


# --- small vector helpers ------------------------------------------------


def dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def normalize3(x, y, z, eps=1e-20):
    inv = 1.0 / torch.clamp(torch.sqrt(x * x + y * y + z * z), min=eps)
    return x * inv, y * inv, z * inv


def f32(x) -> float:
    return float(np.float32(x))


def offset1(p, n):
    """Robust ray-origin offset of one component (Ray Tracing Gems ch. 6)."""
    of_i = (256.0 * n).to(torch.int32)
    p_bits = p.contiguous().view(torch.int32)
    p_i = where(p < 0.0, p_bits - of_i, p_bits + of_i).view(torch.float32)
    return where(torch.abs(p) < 1.0 / 32.0, p + (1.0 / 65536.0) * n, p_i)


def make_frame(nx, ny, nz):
    sign = where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    return (1.0 + sign * nx * nx * a, sign * b, -sign * nx, b, sign + ny * ny * a, -ny)


def frame_from_z_and_hint(nx, ny, nz, hx, hy, hz):
    d = dot3(hx, hy, hz, nx, ny, nz)
    sx, sy, sz = hx - d * nx, hy - d * ny, hz - d * nz
    s_len = torch.sqrt(torch.clamp(sx * sx + sy * sy + sz * sz, min=0.0))
    fsx, fsy, fsz, ftx, fty, ftz = make_frame(nx, ny, nz)
    ok = s_len > 1e-8
    inv = 1.0 / torch.clamp(s_len, min=1e-20)
    sx, sy, sz = where(ok, sx * inv, fsx), where(ok, sy * inv, fsy), where(ok, sz * inv, fsz)
    return (sx, sy, sz, where(ok, ny * sz - nz * sy, ftx),
            where(ok, nz * sx - nx * sz, fty), where(ok, nx * sy - ny * sx, ftz))


def safe_div(a, b):
    ok = torch.abs(b) > 1e-20
    return where(ok, a / where(ok, b, 1.0), 0.0)


def balance(pdf_a, pdf_b):
    return pdf_a / torch.clamp(pdf_a + pdf_b, min=1e-20)


def mt_uvt(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, ox, oy, oz, dx, dy, dz):
    """Moller-Trumbore: (inside, t, u, v); the t range is the caller's."""
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    inv_det = where(torch.abs(det) > 1e-12, 1.0 / det, 0.0)
    tx, ty, tz = ox - v0x, oy - v0y, oz - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    return (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0), t, u, v


def concentric_disk(u0, u1):
    ux = 2.0 * u0 - 1.0
    uy = 2.0 * u1 - 1.0
    zero = (ux == 0.0) & (uy == 0.0)
    use_x = torch.abs(ux) > torch.abs(uy)
    r = where(use_x, ux, uy)
    theta = where(use_x, (math.pi / 4.0) * (uy / where(ux == 0.0, 1.0, ux)),
                  (math.pi / 2.0) - (math.pi / 4.0) * (ux / where(uy == 0.0, 1.0, uy)))
    return where(zero, 0.0, r * torch.cos(theta)), where(zero, 0.0, r * torch.sin(theta))


def eval_matte(kd, on_a, on_b, wo, wi):
    """Oren-Nayar (A, B) in the local frame: (f_r, f_g, f_b, pdf)."""
    wol_x, wol_y, wol_z = wo
    wil_x, wil_y, wil_z = wi
    cos_o, cos_i = torch.abs(wol_z), torch.abs(wil_z)
    sin_o = torch.sqrt(torch.clamp(1.0 - wol_z * wol_z, min=0.0))
    sin_i = torch.sqrt(torch.clamp(1.0 - wil_z * wil_z, min=0.0))
    inv_so = 1.0 / torch.clamp(sin_o, min=1e-20)
    inv_si = 1.0 / torch.clamp(sin_i, min=1e-20)
    cos_d_phi = (wil_x * inv_si) * (wol_x * inv_so) + (wil_y * inv_si) * (wol_y * inv_so)
    max_cos = where((sin_i > 1e-4) & (sin_o > 1e-4), torch.clamp(cos_d_phi, min=0.0), 0.0)
    o_gt_i = cos_o > cos_i
    sin_alpha = where(o_gt_i, sin_i, sin_o)
    tan_beta = where(o_gt_i, sin_o / torch.clamp(cos_o, min=1e-6),
                     sin_i / torch.clamp(cos_i, min=1e-6))
    on = on_a + on_b * max_cos * sin_alpha * tan_beta
    same = wol_z * wil_z > 0.0
    scale = where(same, INV_PI * on * cos_i, 0.0)
    pdf = where(same, cos_i * INV_PI, 0.0)
    return kd[0] * scale, kd[1] * scale, kd[2] * scale, pdf


# --- the scene tables, from the scene dict -------------------------------


class Tables(NamedTuple):
    tri: tuple  # 9 (P,) columns: v0, e1, e2
    shade: torch.Tensor  # (P, 16): ng, n0, n1, n2, tangent, instance
    inst: torch.Tensor  # (NI, 8): kd rgb, on_a, on_b, has_light, two_sided light, area
    emission: torch.Tensor  # (NI, 3)
    entry: torch.Tensor  # (NL, 8): alias offset, count, area, instance, emission, two_sided
    light: torch.Tensor  # (LT, 24): p0, e0, e1, ng, -, prob, alias
    n_entry: int
    flat_normals: bool
    cam: dict


def _const(node, key, default):
    """A constant texture's value, or the default where absent."""
    if node is None:
        return np.asarray(default, np.float32)
    if node.get("impl") != "constant":
        raise ValueError(f"the reference reads constant textures only, not {node.get('impl')}")
    return np.atleast_1d(np.asarray(node["prop"]["v"], np.float32))


def _vertex_normals(p, tris):
    fn = np.cross(p[tris[:, 1]] - p[tris[:, 0]], p[tris[:, 2]] - p[tris[:, 0]])
    vn = np.zeros_like(p)
    for k in range(3):
        np.add.at(vn, tris[:, k], fn)
    norm = np.linalg.norm(vn, axis=-1, keepdims=True)
    return (vn / np.maximum(norm, 1e-12)).astype(np.float32)


def _frame_tangent(n):
    nz = n[:, 2]
    sign = np.where(nz >= 0.0, np.float32(1.0), np.float32(-1.0))
    a = np.float32(-1.0) / (sign + nz)
    b = n[:, 0] * n[:, 1] * a
    return np.stack([1.0 + sign * n[:, 0] * n[:, 0] * a, sign * b, -sign * n[:, 0]],
                    axis=-1).astype(np.float32)


def _alias_table(weights):
    """Vose's alias table over the weights: (prob, alias)."""
    w = np.maximum(np.asarray(weights, np.float64).ravel(), 0.0)
    n = w.size
    total = w.sum()
    if total <= 0.0:
        w, total = np.ones_like(w), float(n)
    scaled = w / total * n
    prob = np.ones(n, np.float64)
    alias = np.arange(n, dtype=np.int64)
    small = [i for i in range(n) if scaled[i] < 1.0]
    large = [i for i in range(n) if scaled[i] >= 1.0]
    while small and large:
        s, big = small.pop(), large.pop()
        prob[s] = scaled[s]
        alias[s] = big
        scaled[big] = (scaled[big] + scaled[s]) - 1.0
        (small if scaled[big] < 1.0 else large).append(big)
    for i in large + small:
        prob[i] = 1.0
    return prob.astype(np.float32), alias.astype(np.int32)


def _camera(cam_node, resolution, sampler_seed):
    prop = cam_node["prop"]
    if cam_node["impl"] != "pinhole" or prop.get("filter", {}).get("impl", "box") != "box":
        raise ValueError("the reference makes pinhole cameras with a box filter only")
    view = prop["transform"]
    if view["impl"] != "view":
        raise ValueError("the reference reads a view transform only")
    vp = view["prop"]
    pos = np.asarray(vp.get("origin", vp.get("position", (0, 0, 0))), np.float64)
    front = np.asarray(vp.get("front", (0, 0, -1)), np.float64)
    up = np.asarray(vp.get("up", (0, 1, 0)), np.float64)
    f = front / max(np.linalg.norm(front), 1e-12)
    r = np.cross(f, up)
    r = r / max(np.linalg.norm(r), 1e-12)
    u = np.cross(r, f)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = r, u, -f, pos
    c2w = m.astype(np.float32)
    resx, resy = resolution
    tan_half = float(np.tan(np.deg2rad(float(prop.get("fov", 35.0))) * 0.5))
    radius = float(prop.get("filter", {}).get("prop", {}).get("radius", 0.5))
    cam = {"radius": f32(radius), "resx": f32(resx), "resy": f32(resy),
           "s": f32(tan_half / resy), "sampler_seed": int(sampler_seed) & MASK32}
    for i in range(3):
        for j in range(4):
            cam[f"c{i}{j}"] = f32(c2w[i, j])
    return cam


def build_tables(scene, resolution, sampler_seed, device, precision="fp32") -> Tables:
    """The reference's own tables of a scene dict: every shape an
    `inlinemesh` without a transform, with a constant `matte` surface and
    optionally a constant `diffuse` light."""
    all_p, all_n, all_t, all_ti = [], [], [], []
    inst_rows, emissions, entries, light_rows = [], [], [], []
    v_off = 0
    for inst_id, shape in enumerate(scene["render"]["shapes"]):
        prop = shape["prop"]
        if shape["impl"] != "inlinemesh" or "transform" in prop or "normals" in prop:
            raise ValueError("the reference reads inline meshes without transform or normals")
        p = np.asarray(prop["positions"], np.float32).reshape(-1, 3)
        tris = np.asarray(prop["indices"], np.int64).astype(np.int32).reshape(-1, 3)
        surf = prop["surface"]
        if surf["impl"] != "matte":
            raise ValueError("the reference shades matte surfaces only")
        sp = surf.get("prop", {})
        kd = np.clip(_const(sp.get("Kd"), "Kd", (1.0, 1.0, 1.0))[:3], 0.0, 1.0)
        sg = float(_const(sp.get("sigma"), "sigma", (0.0,))[0]) * (np.pi / 180.0)
        s2 = sg * sg
        row = np.zeros(8, np.float32)
        row[0:3] = kd
        row[3] = 1.0 - s2 / (2.0 * (s2 + 0.33))
        row[4] = 0.45 * s2 / (s2 + 0.09)
        em = np.zeros(3, np.float32)
        light = prop.get("light")
        if light is not None:
            if light["impl"] != "diffuse":
                raise ValueError("the reference reads diffuse lights only")
            lp = light.get("prop", {})
            em = np.maximum(_const(lp.get("emission"), "emission", (1.0, 1.0, 1.0))[:3], 0.0) \
                * np.float32(lp.get("scale", 1.0))
            e0 = p[tris[:, 1]] - p[tris[:, 0]]
            e1 = p[tris[:, 2]] - p[tris[:, 0]]
            areas = 0.5 * np.linalg.norm(np.cross(e0, e1), axis=-1)
            prob, alias = _alias_table(areas)
            total = float(areas.sum())
            two = 1.0 if lp.get("two_sided", False) else 0.0
            entries.append([float(sum(r.shape[0] for r in light_rows)), tris.shape[0], total,
                            inst_id, *em.tolist(), two])
            lt = np.zeros((tris.shape[0], 24), np.float32)
            lt[:, 0:3] = p[tris[:, 0]]
            lt[:, 3:6] = e0
            lt[:, 6:9] = e1
            ng_l = np.cross(e0, e1)
            lt[:, 9:12] = ng_l / np.maximum(np.linalg.norm(ng_l, axis=-1, keepdims=True), 1e-20)
            lt[:, 18] = prob
            lt[:, 19] = alias
            light_rows.append(lt)
            row[5], row[6], row[7] = 1.0, two, total
        inst_rows.append(row)
        emissions.append(em)
        all_p.append(p)
        all_n.append(_vertex_normals(p, tris))
        all_t.append(tris + v_off)
        all_ti.append(np.full(tris.shape[0], inst_id, np.int32))
        v_off += p.shape[0]
    vp = np.concatenate(all_p)
    vn = np.concatenate(all_n)
    tris = np.concatenate(all_t)
    tri_inst = np.concatenate(all_ti)
    v0, v1, v2 = vp[tris[:, 0]], vp[tris[:, 1]], vp[tris[:, 2]]
    e1, e2 = v1 - v0, v2 - v0
    ng_raw = np.cross(e1, e2)
    ng_len = np.sqrt(np.maximum((ng_raw * ng_raw).sum(-1), 0.0))
    ng = (ng_raw / np.maximum(ng_len, 1e-20)[:, None]).astype(np.float32)
    shade = np.zeros((tris.shape[0], 16), np.float32)
    shade[:, 0:3] = ng
    for k in range(3):
        shade[:, 3 + 3 * k:6 + 3 * k] = vn[tris[:, k]]
    shade[:, 12:15] = _frame_tangent(ng)  # no uvs: the degenerate tangent
    shade[:, 15] = tri_inst
    flat = bool((np.abs(shade[:, 3:12] - np.tile(shade[:, 0:3], 3)) < 1e-7).all())
    tri = np.concatenate([v0, e1, e2], axis=1).astype(np.float32)

    q = rounder(precision)
    dev = torch.device(device)

    def t(a):
        return q(torch.as_tensor(np.asarray(a, np.float32), device=dev))

    return Tables(
        tri=tuple(t(tri).unbind(-1)), shade=t(shade), inst=t(np.stack(inst_rows)),
        emission=t(np.stack(emissions)),
        entry=torch.as_tensor(np.asarray(entries, np.float32).reshape(-1, 8), device=dev),
        light=t(np.concatenate(light_rows) if light_rows else np.zeros((1, 24))),
        n_entry=len(entries), flat_normals=flat,
        cam=_camera(scene["render"]["cameras"][0], resolution, sampler_seed))


def rounder(precision):
    if precision == "fp32":
        return lambda x: x
    if precision == "bf16":
        return lambda x: x.to(torch.bfloat16).to(torch.float32) if x.is_floating_point() else x
    raise ValueError(precision)


# --- the paths -------------------------------------------------------------


class Counts:
    """The work the program must do for these paths (the fused bound's
    inputs): closest rays, shaded lanes by surface type, shadow rays open
    and occluded, over `lanes` paths of a scene of `rows` triangle rows."""

    def __init__(self):
        self.closest = 0
        self.shaded = 0
        self.shaded_by_type = {}
        self.shadow_open = 0
        self.shadow_occluded = 0
        self.lanes = 0
        self.rows = 0  # triangle rows a closest ray tests
        self.shadow_rows = 0  # rows that block a shadow ray

    def shade(self, kind, lanes):
        self.shaded_by_type[kind] = self.shaded_by_type.get(kind, 0) + int(lanes)


class _Paths:
    def __init__(self, tb: Tables, px, py, si, max_depth, rr_depth, rr_threshold, q, counts):
        self.tb, self.q, self.counts = tb, q, counts
        self.px, self.py, self.si = px, py, si
        self.max_depth = max_depth
        self.rr_depth = float(rr_depth)
        self.rr_threshold = f32(rr_threshold)
        self.p_light = f32(1.0 / max(tb.n_entry, 1))

    def camera(self):
        c, q = self.tb.cam, self.q
        st = xxhash32(self.si, self.px, self.py, c["sampler_seed"])
        st, u0 = lcg_step(st)
        st, u1 = lcg_step(st)
        fx = self.px.to(torch.float32) + 0.5 + (u0 * 2.0 - 1.0) * c["radius"]
        fy = self.py.to(torch.float32) + 0.5 + (u1 * 2.0 - 1.0) * c["radius"]
        pcx = (fx * 2.0 - c["resx"]) * c["s"]
        pcy = (fy * 2.0 - c["resy"]) * c["s"]
        dcx, dcy, dcz = normalize3(pcx, -pcy, torch.zeros_like(pcx) - 1.0)
        wd = [c[f"c{r}0"] * dcx + c[f"c{r}1"] * dcy + c[f"c{r}2"] * dcz for r in range(3)]
        d = tuple(q(x) for x in normalize3(*wd))
        o = tuple(q(torch.zeros_like(dcx) + c[f"c{r}3"]) for r in range(3))
        zero = torch.zeros_like(dcx)
        return {"o": o, "d": d, "tmin": zero, "tmax": zero + F32_BIG, "st": st,
                "beta": (zero + 1.0,) * 3, "L": (zero,) * 3, "active": zero < 1.0,
                "pdf_bsdf": zero + 1e16}

    def closest(self, o, d, tmin, tmax):
        tb = self.tb
        inside, tt, uu, vv = mt_uvt(*tb.tri, *(x[:, None] for x in (*o, *d)))
        cand = inside & (tt > tmin[:, None]) & (tt < tmax[:, None])
        t_m = where(cand, tt, float("inf"))
        k = torch.argmin(t_m, dim=1, keepdim=True)
        hit = cand.any(dim=1)
        best_t = where(hit, t_m.gather(1, k)[:, 0], tmax)
        best_u = where(hit, uu.gather(1, k)[:, 0], 0.0)
        best_v = where(hit, vv.gather(1, k)[:, 0], 0.0)
        j = k[:, 0]
        sh = where(hit[:, None], tb.shade[j], 0.0)
        tri = torch.stack([c[j] for c in tb.tri], dim=1)
        tri = where(hit[:, None], tri, 0.0)
        return hit, best_t, best_u, best_v, sh, tri

    def occluded(self, so, sd, s_tmax):
        inside, tq, _, _ = mt_uvt(*self.tb.tri, *(x[:, None] for x in (*so, *sd)))
        return (inside & (tq > 0.0) & (tq < s_tmax[:, None])).any(dim=1)

    def bounce(self, s, dep):
        tb, q, cnt = self.tb, self.q, self.counts
        o, d = s["o"], s["d"]
        active = s["active"]
        cnt.closest += int(active.sum())
        hitv, best_t, u_b, v_b, sh, tr = self.closest(o, d, s["tmin"], s["tmax"])
        best_t, u_b, v_b = q(best_t), q(u_b), q(v_b)
        w_b = 1.0 - u_b - v_b
        p = [q(tr[:, k] + u_b * tr[:, 3 + k] + v_b * tr[:, 6 + k]) for k in range(3)]
        ng = [sh[:, k] for k in range(3)]
        tg = [sh[:, 12 + k] for k in range(3)]
        if tb.flat_normals:
            ns = list(ng)
        else:
            ns = [w_b * sh[:, 3 + k] + u_b * sh[:, 6 + k] + v_b * sh[:, 9 + k] for k in range(3)]
            len2 = ns[0] * ns[0] + ns[1] * ns[1] + ns[2] * ns[2]
            inv_ns = 1.0 / torch.clamp(torch.sqrt(torch.clamp(len2, min=0.0)), min=1e-20)
            ns = [x * inv_ns for x in ns]
            ns_ok = (len2 > 0.25) & torch.isfinite(ns[0]) & torch.isfinite(ns[1]) & torch.isfinite(ns[2])
            ns = [where(ns_ok, a, b) for a, b in zip(ns, ng)]
            flip = dot3(*ns, *ng) < 0.0
            ns = [q(where(flip, -x, x)) for x in ns]
        wo = [-x for x in d]
        valid = hitv & active
        cnt.shaded += int(valid.sum())
        cnt.shade("matte", valid.sum())  # every instance has a matte surface
        inst = torch.clamp(sh[:, 15].to(torch.int64), 0, tb.inst.shape[0] - 1)
        irow = where(valid[:, None], tb.inst[inst], 0.0)
        erow_i = where(valid[:, None], tb.emission[inst], 0.0)
        kd = (irow[:, 0], irow[:, 1], irow[:, 2])
        on_a, on_b = irow[:, 3], irow[:, 4]
        has_light, l2s, l_area = irow[:, 5], irow[:, 6], irow[:, 7]

        # emissive hit, MIS against the light's area pdf
        L = list(s["L"])
        beta = list(s["beta"])
        cos_l = dot3(*wo, *ng)
        lit = (cos_l > 1e-6) | ((l2s > 0.5) & (torch.abs(cos_l) > 1e-6))
        dl = [o[k] - p[k] for k in range(3)]
        d2 = dl[0] * dl[0] + dl[1] * dl[1] + dl[2] * dl[2]
        pdf_hit = where(lit, d2 / torch.clamp(torch.abs(cos_l) * l_area, min=1e-12), 0.0) * self.p_light
        w_mis_hit = balance(s["pdf_bsdf"], pdf_hit)
        add = valid & (has_light > 0.5) & lit
        L = [q(where(add, L[k] + beta[k] * erow_i[:, k] * w_mis_hit, L[k])) for k in range(3)]
        active = valid

        st = s["st"]
        u = []
        for _ in range(7):
            st, uk = lcg_step(st)
            u.append(uk)
        u_sel, u_l0, u_l1, u_lobe, u_b0, u_b1, u_rr = u

        sx, sy, sz, tx, ty, tz = (q(x) for x in frame_from_z_and_hint(*ns, *tg))
        fn = ns  # matte surfaces are one-sided: the frame never flips
        wol = (dot3(*wo, sx, sy, sz), dot3(*wo, tx, ty, tz), dot3(*wo, *fn))
        wo_ng = dot3(*wo, *ng)
        wo_ns = dot3(*wo, *fn)

        if tb.n_entry > 0:
            ne = float(tb.n_entry)
            u_rel = torch.clamp(u_sel, 0.0, ONE_MINUS_EPSILON)
            entry_f = torch.clamp(torch.floor(u_rel * ne), max=ne - 1.0)
            erow = tb.entry[entry_f.to(torch.int64)]
            al_off, tri_cnt, tot_area = erow[:, 0], erow[:, 1], erow[:, 2]
            ux = u_l0 * tri_cnt
            i0 = torch.clamp(torch.minimum(torch.floor(ux), tri_cnt - 1.0), min=0.0)
            up = ux - i0
            g0 = (al_off + i0).to(torch.int64)
            lrow0 = tb.light[g0]
            take_alias = up >= lrow0[:, 18]
            g = where(take_alias, (al_off + lrow0[:, 19]).to(torch.int64), g0)
            lrow = tb.light[g]
            su = torch.sqrt(torch.clamp(up, min=0.0))
            b0 = 1.0 - su
            b1 = u_l1 * su
            b2 = 1.0 - b0 - b1
            lp = [q(lrow[:, k] + b1 * lrow[:, 3 + k] + b2 * lrow[:, 6 + k]) for k in range(3)]
            lng = [lrow[:, 9 + k] for k in range(3)]
            wl = [lp[k] - p[k] for k in range(3)]
            wl2 = wl[0] * wl[0] + wl[1] * wl[1] + wl[2] * wl[2]
            inv_wl = 1.0 / torch.clamp(torch.sqrt(torch.clamp(wl2, min=0.0)), min=1e-12)
            wi = [q(x * inv_wl) for x in wl]
            cos_ll = dot3(-wi[0], -wi[1], -wi[2], *lng)
            lit_l = (cos_ll > 1e-6) | ((erow[:, 7] > 0.5) & (torch.abs(cos_ll) > 1e-6))
            pdf_nee = q(where(lit_l, wl2 / torch.clamp(torch.abs(cos_ll) * tot_area, min=1e-12),
                              0.0) * self.p_light)
            Ln = [where(lit_l, erow[:, 4 + k], 0.0) for k in range(3)]
            pending = active & (pdf_nee > 0.0)

            # the shadow ray, offset at both ends
            sgn_f = where(dot3(*ng, *wl) >= 0.0, 1.0, -1.0)
            so = [offset1(p[k], sgn_f * ng[k]) for k in range(3)]
            bb = [so[k] - lp[k] for k in range(3)]
            sgn_t = where(dot3(*lng, *bb) >= 0.0, 1.0, -1.0)
            se = [offset1(lp[k], sgn_t * lng[k]) for k in range(3)]
            sd = [se[k] - so[k] for k in range(3)]
            s_len = torch.sqrt(torch.clamp(sd[0] * sd[0] + sd[1] * sd[1] + sd[2] * sd[2], min=0.0))
            inv_s = 1.0 / torch.clamp(s_len, min=1e-20)
            sd = [q(x * inv_s) for x in sd]
            so = [q(x) for x in so]
            s_tmax = q(where(pending, s_len * (1.0 - 1e-3), 0.0))

            wil = (dot3(*wi, sx, sy, sz), dot3(*wi, tx, ty, tz), dot3(*wi, *fn))
            fe_r, fe_g, fe_b, fe_pdf = eval_matte(kd, on_a, on_b, wol, wil)
            ok_side = (wo_ng * dot3(*wi, *ng) > 0.0) == (wo_ns * dot3(*wi, *fn) > 0.0)
            fe = [q(where(ok_side, x, 0.0)) for x in (fe_r, fe_g, fe_b)]
            fe_pdf = q(where(ok_side, fe_pdf, 0.0))
            w_mis = safe_div(balance(pdf_nee, fe_pdf), pdf_nee)
            occ = self.occluded(so, sd, s_tmax)
            cnt.shadow_open += int((pending & ~occ).sum())
            cnt.shadow_occluded += int((pending & occ).sum())
            nee_ok = pending & ~occ
            L = [q(where(nee_ok, L[k] + beta[k] * fe[k] * Ln[k] * w_mis, L[k])) for k in range(3)]

        # the BSDF sample: a cosine-weighted direction on wo's side
        ddx, ddy = concentric_disk(u_b0, u_b1)
        dz_l = torch.sqrt(torch.clamp(1.0 - ddx * ddx - ddy * ddy, min=0.0))
        smp = (ddx, ddy, where(wol[2] < 0.0, -dz_l, dz_l))
        fs_r, fs_g, fs_b, fs_pdf = eval_matte(kd, on_a, on_b, wol, smp)
        nw = [q(smp[0] * s_ + smp[1] * t_ + smp[2] * f_)
              for s_, t_, f_ in zip((sx, sy, sz), (tx, ty, tz), fn)]
        ok_side = (wo_ng * dot3(*nw, *ng) > 0.0) == (wo_ns * dot3(*nw, *fn) > 0.0)
        fs = [q(where(ok_side, x, 0.0)) for x in (fs_r, fs_g, fs_b)]
        fs_pdf = q(where(ok_side, fs_pdf, 0.0))

        sgn_r = where(dot3(*ng, *nw) >= 0.0, 1.0, -1.0)
        o = tuple(q(where(active, offset1(p[k], sgn_r * ng[k]), o[k])) for k in range(3))
        d = tuple(where(active, nw[k], d[k]) for k in range(3))
        tmin = where(active, 0.0, s["tmin"])
        tmax = where(active, F32_BIG, s["tmax"])
        pdf_bsdf = where(active, fs_pdf, s["pdf_bsdf"])
        nb = [beta[k] * safe_div(fs[k], fs_pdf) for k in range(3)]
        beta = [q(where(active, where(torch.isfinite(x), x, 0.0), b)) for x, b in zip(nb, beta)]
        beta_max = torch.maximum(beta[0], torch.maximum(beta[1], beta[2]))
        active = active & (fs_pdf > 0.0) & (beta_max > 0.0)

        # Russian roulette (the eta scale stays 1 on matte)
        qq = torch.clamp(beta_max * 1.0, min=0.05)
        do_rr = ((dep + 1.0) >= self.rr_depth) & active
        small_q = qq < self.rr_threshold
        kill = do_rr & small_q & (u_rr >= qq)
        boost = where(do_rr & small_q, 1.0 / torch.clamp(qq, min=1e-6), 1.0)
        beta = [q(x * boost) for x in beta]
        active = active & ~kill & ((dep + 1.0) < float(self.max_depth))
        s.update(o=o, d=d, tmin=tmin, tmax=tmax, st=st, beta=tuple(beta), L=tuple(L),
                 active=active, pdf_bsdf=pdf_bsdf)


def radiance(tb: Tables, px, py, si, *, max_depth, rr_depth, rr_threshold,
             precision="fp32", counts=None):
    """One path per lane: pixel (px, py) and sample index si, (N,) int64
    each. Returns (N, 3) float32 radiance."""
    counts = counts if counts is not None else Counts()
    counts.lanes += int(px.shape[0])
    pt = _Paths(tb, px, py, si, max_depth, rr_depth, rr_threshold, rounder(precision), counts)
    s = pt.camera()
    for i in range(max_depth):
        if not bool(s["active"].any()):
            break
        pt.bounce(s, float(i))
    return torch.stack(s["L"], dim=-1)


def film_mean(samples, clamp=256.0):
    """The colour film over (S, M, 3) samples of M pixels, in sample order:
    each sample clamped to [0, clamp * max(count so far, 1)], a sample with
    a channel that is not finite left out, then the mean (exposure 0)."""
    acc = torch.zeros(samples.shape[1:], dtype=torch.float32, device=samples.device)
    cnt = torch.zeros(samples.shape[1:2] + (1,), dtype=torch.float32, device=samples.device)
    for k in range(samples.shape[0]):
        rad = samples[k]
        finite = torch.isfinite(rad).all(dim=-1, keepdim=True)
        bound = clamp * torch.clamp(cnt, min=1.0)
        c = torch.minimum(torch.clamp(rad, min=0.0), bound)
        acc = acc + where(finite, c, 0.0)
        cnt = cnt + where(finite, 1.0, 0.0)
    return acc / torch.clamp(cnt, min=1e-8)


def render_pixels(scene, resolution, sampler_seed, spp, pixel_xy, device, *,
                  precision="fp32", counts=None, lanes_per_batch=1 << 19, clamp=256.0):
    """The film's value at each of the pixels (M, 2) (x, y) of a render of
    `spp` samples with this sampler seed: (M, 3) float32 on `device`."""
    integ = scene["render"]["integrator"]
    ip = integ.get("prop", {})
    if integ["impl"] not in ("megapath", "MegaPath", "path", "Path"):
        raise ValueError("the reference renders the megapath integrator only")
    tb = build_tables(scene, resolution, sampler_seed, device, precision)
    if counts is not None:
        counts.rows = counts.shadow_rows = int(tb.tri[0].shape[0])  # every row blocks
    kw = dict(max_depth=int(ip.get("depth", 10)), rr_depth=int(ip.get("rr_depth", 0)),
              rr_threshold=float(ip.get("rr_threshold", 0.95)))
    pxy = torch.as_tensor(pixel_xy, dtype=torch.int64, device=device)
    m = pxy.shape[0]
    out = torch.empty((spp, m, 3), dtype=torch.float32, device=device)
    per = max(1, lanes_per_batch // max(m, 1))
    for k0 in range(0, spp, per):
        k1 = min(spp, k0 + per)
        si = torch.arange(k0, k1, device=device).repeat_interleave(m)
        px = pxy[:, 0].repeat(k1 - k0)
        py = pxy[:, 1].repeat(k1 - k0)
        rad = radiance(tb, px, py, si, precision=precision, counts=counts, **kw)
        out[k0:k1] = rad.reshape(k1 - k0, m, 3)
    return film_mean(out, clamp)
