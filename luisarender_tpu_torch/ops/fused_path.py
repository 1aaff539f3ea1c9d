"""The fused whole-path kernel: one launch renders a sample of every pixel.

Counterpart of luisarender_tpu/ops/fused_path.py. For an eligible scene
(few triangles and analytic spheres, surfaces in {matte, mirror, metal,
plastic, glass, reflective disney} with constant parameters, diffuse area
lights, the independent sampler, the uniform light sampler, the fixed sRGB
spectrum) the whole bounce loop of a path runs in one kernel: the camera
ray and the sampler seed made in the kernel, the closest trace over the
triangle and sphere tables, the emissive-hit MIS, NEE with its alias light
pick and shadow ray, BSDF evaluation and sampling, Russian roulette, and
the independent sampler's 7 draws a bounce in the reference's order.

Three modes share the kernel:
  megapath    one sample per lane (`n_samples == 0`), its camera ray made
              in the kernel (a pinhole camera, a box filter, no clip plane:
              camgen_params);
  ray input   one sample per lane from rays the caller made (every other
              camera, filter or clip plane; the reference's `cam is None`
              entry, trace_paths_fused): per lane the origin, direction,
              t_min, t_max, the camera weight (which carries the filter's,
              and may be negative) and the sampler state past the camera's
              draws, packed by `pack_rays`; the first bounce tests t_min <
              t < min(t_max, 3e38), every later one (0, 3e38);
  persistent  `n_samples` samples per lane in one launch, each lane
              regenerating its pixel's next sample when a path ends (the
              megawave integrator, in-kernel cameras only); the output is
              the sum over the samples.

A scene with a spherical or directional environment runs the megapath or
ray-input mode with the environment inputs of the reference's kernel (its
`has_env` mode): the kernel never reads an environment table.
`env_nee_candidates` pre-samples, from each lane's own sampler stream (the
given states in the ray-input mode), the environment NEE candidate of
every bounce, [wi.xyz, pdf * p_env, L.rgb] (a (max_depth, 7, N) tensor);
the kernel picks the environment when u_sel < p_env, and writes
each pixel's escape state (beta.rgb, pdf_bsdf, dir.xyz; dir (0, 0, 1) where
the path never escapes) for `miss_pass`, which adds the environment's
radiance with its MIS weight afterwards. The persistent mode takes no
environment (its draw offsets per bounce are not static), as in the
reference.

On CUDA tensors `paths` launches csrc/fused_path.cu; on CPU tensors it runs
`paths_plain`, a batched PyTorch program over all lanes with the kernel's
operation order (ops/fused_bsdf.py holds its BSDF math). There is no
fallback: a CUDA tensor launches the kernel or raises. `launches`,
`env_launches`, `ray_launches`, `ray_env_launches` and
`persistent_launches` count kernel launches of the five forms (megapath
and ray input, each without and with an environment; persistent).

The kernel schedules paths, it does not change them. What bounds it on the
H100 is divergence: with one thread a pixel, a warp ran until its longest
path ended and through every surface type its lanes hit. So it runs
persistent blocks, each over a pool of path slots in shared memory; a
round refills the empty slots from a work counter, compacts the live ones,
traces them, groups them by the surface type they hit and shades them in
that order (see the source's note). A pixel's rgb and ray count depend on
the pixel alone (tests/test_torch_fused.py holds the plain version to
that), and every path keeps the plain version's arithmetic, so kernel and
plain version agree bit for bit on every lane. The wrapper passes one int
of scratch for the work counter, which the C function zeroes on the
launch's stream before every launch; `stats` receives the kernel's
counters (STATS: lane-slots, paths traced and shaded, distinct surface
types a warp shades).
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch

from ..core import rng
from ..core.colorspace import cie_y_of_srgb_np
from ..core.spectrum import SRGB_PEAK_WAVELENGTHS
from . import fused_bsdf as fb
from .brute import moller_trumbore

MAX_TRIS = 64
MAX_INSTANCES = 32
MAX_LIGHT_TRIS = 8
MAX_LIGHTS = 4
MAX_SPHERES = 16

# inst_table columns (one row per instance; a union over the surface types):
#   0 stype   1:4 c0   4:7 c1   7:10 c2   10:13 c3   13 p0   14 p1
#   15:17 GGX alpha x / y   17 surface two_sided   18 has_surface
#   19 has_light   20:23 emission   23 light two_sided   24 light area
#   25:31 disney d0..d5 (metallic, clearcoat alpha, clearcoat, lobe
#   weights diffuse / specular / clearcoat)
# matte: c0 kd, p0 / p1 Oren-Nayar A / B; mirror: c0 F0; metal: c0 tint,
# c2 n, c3 k; plastic: c0 kd, c1 sigma_a * thickness, p0 eta, p1 kd
# luminance; glass: c0 Kr, c1 Kt, p0 eta, p1 Kr luminance ratio; disney:
# c0 color, c1 sheen * csheen, c2 cspec0, c3 tint mix, p0 eta, p1 roughness
INST_COLS = 32
# entry_table columns: 0 alias offset, 1 triangle count, 2 total area,
# 3 instance, 4:7 emission, 7 two_sided
ENTRY_COLS = 8
# shade-table columns the kernel reads, in the order of its compact copy:
# ng, n0, n1, n2, tangent, instance
SHADE_COLS_USED = (9, 10, 11, 13, 14, 15, 16, 17, 18, 19, 20, 21, 28, 29, 30, 31)

_FUSED_SURFACES = ("matte", "mirror", "metal", "plastic", "glass", "disney")
_F32_BIG = 3e38

launches = 0
env_launches = 0
ray_launches = 0
ray_env_launches = 0
persistent_launches = 0

# the ray-input mode's words a lane (pack_rays): origin, direction, t_min,
# t_max, the camera weight, the sampler state's bits
RAY_WORDS = 10


# ---------------------------------------------------------------------------
# eligibility and the per-instance tables (host, numpy)
# ---------------------------------------------------------------------------


def _vec(row, name):
    return np.atleast_1d(np.asarray(row[name], np.float32))


def _fold_alpha(row):
    rough = _vec(row, "roughness")
    ch = float(row.get("roughness_channels", 1.0))
    r = rough[:2] if ch >= 1.5 else np.asarray([rough[0], rough[0]])
    if float(row.get("remap_roughness", 1.0)) > 0.5:
        a = np.maximum(r * r, 1e-4)
    else:
        a = np.maximum(r, 1e-4)
    return float(a[0]), float(a[1])


def _fold_surface(name, row, out):
    """Fill one inst_table row's surface columns from the surface's
    (constant-hoisted) parameter row; False if the fused kernel does not
    cover it."""
    if any(k.endswith("__h") and int(v) >= 0 for k, v in row.items()):
        return False  # a texture that varies: the kernel reads constants only
    if float(row.get("normal_map__p", 0.0)) > 0.5 or float(row.get("alpha__p", 0.0)) > 0.5:
        return False  # a normal map or an alpha texture, even a constant one
    out[17] = float(row.get("two_sided", 0.0))
    if name == "matte":
        sg = float(_vec(row, "sigma")[0]) * (np.pi / 180.0)
        s2 = sg * sg
        out[0] = fb.ST_MATTE
        out[1:4] = np.clip(_vec(row, "kd")[:3], 0.0, 1.0)
        out[13] = 1.0 - s2 / (2.0 * (s2 + 0.33))
        out[14] = 0.45 * s2 / (s2 + 0.09)
        return True
    out[15], out[16] = _fold_alpha(row)
    if name in ("mirror", "metal"):
        out[0] = fb.ST_MIRROR if name == "mirror" else fb.ST_METAL
        out[1:4] = np.clip(_vec(row, "kd")[:3], 0.0, 1.0)
        if name == "metal":
            n3, k3 = _vec(row, "eta_n"), _vec(row, "eta_k")
            if float(row.get("ld_valid", 0.0)) > 0.5:
                from ..surfaces.metal import ld_eta_k

                n3, k3 = (
                    x.numpy() for x in ld_eta_k(
                        torch.tensor(SRGB_PEAK_WAVELENGTHS, dtype=torch.float32),
                        *(torch.as_tensor(_vec(row, k)) for k in ("ld_wp", "ld_f", "ld_g", "ld_w")),
                    )
                )
            out[7:10] = n3
            out[10:13] = k3
        return True
    if name == "plastic":
        kd = _vec(row, "kd")
        out[0] = fb.ST_PLASTIC
        out[1:4] = np.clip(kd[:3], 0.0, 1.0)
        out[4:7] = _vec(row, "sigma_a")[:3] * float(_vec(row, "thickness")[0])
        out[13] = float(_vec(row, "eta")[0])
        out[14] = cie_y_of_srgb_np(kd[:3])
        out[17] = 0.0  # plastic flips its frame itself
        return True
    if name == "glass":
        kr, kt = _vec(row, "kr"), _vec(row, "kt")
        out[0] = fb.ST_GLASS
        out[1:4] = np.clip(kr[:3], 0.0, 1.0)
        out[4:7] = np.clip(kt[:3], 0.0, 1.0)
        lam_um2 = (SRGB_PEAK_WAVELENGTHS[0] * 1e-3) ** 2
        out[13] = float(row["cauchy_a"]) + float(row["cauchy_b"]) / lam_um2
        kr_lum = cie_y_of_srgb_np(kr[:3])
        kt_lum = cie_y_of_srgb_np(kt[:3])
        out[14] = 0.0 if kr_lum <= 0.0 else kr_lum / max(kr_lum + kt_lum, 1e-8)
        return True
    if name == "disney":
        # reflective subset only: thin, specular_trans and diffuse_trans
        # leave the scene to the general fork
        if float(row.get("thin", 0.0)) > 0.5:
            return False

        def scalar(pname):
            return float(_vec(row, pname)[0])

        color = _vec(row, "color")
        metallic = scalar("metallic")
        eta = scalar("eta")
        roughness = scalar("roughness")
        spec_tint = scalar("specular_tint")
        aniso = scalar("anisotropic")
        sheen = scalar("sheen")
        sheen_tint = scalar("sheen_tint")
        clearcoat = scalar("clearcoat")
        cc_gloss = scalar("clearcoat_gloss")
        if scalar("specular_trans") > 0.0 or scalar("diffuse_trans") > 0.0:
            return False
        color = np.clip(color[:3], 0.0, 1.0)
        eta = max(eta, 1.001)
        roughness = float(np.clip(roughness, 0.0, 1.0))
        lum = max(cie_y_of_srgb_np(color), 1e-6)
        tint = color / lum
        csheen = (1.0 - sheen_tint) + sheen_tint * tint
        f0 = ((eta - 1.0) / (eta + 1.0)) ** 2
        cspec0 = (1.0 - metallic) * f0 * (
            (1.0 - spec_tint) + spec_tint * tint
        ) + metallic * color
        ctint_mix = (1.0 - spec_tint) + spec_tint * tint
        aspect = float(np.sqrt(max(1.0 - 0.9 * aniso, 1e-4)))
        rr_ = roughness * roughness if float(row.get("remap_roughness", 1.0)) > 0.5 else roughness
        out[0] = fb.ST_DISNEY
        out[1:4] = color
        out[4:7] = sheen * csheen
        out[7:10] = cspec0
        out[10:13] = ctint_mix
        out[13] = eta
        out[14] = roughness
        out[15] = max(rr_ / aspect, 1e-4)
        out[16] = max(rr_ * aspect, 1e-4)
        out[25] = metallic
        out[26] = (1.0 - cc_gloss) * 0.1 + cc_gloss * 0.001
        out[27] = clearcoat
        w_diff = (1.0 - metallic) * lum
        w_spec = max(cie_y_of_srgb_np(np.clip(cspec0, 0.0, None)), 0.1)
        w_cc = 0.25 * clearcoat
        total = max(w_diff + w_spec + w_cc, 1e-6)
        out[28] = w_diff / total
        out[29] = w_spec / total
        out[30] = w_cc / total
        return True
    return False


def build_fused_pack(surface_types, surface_rows, light_types, light_rows,
                     instances, light_entries, spectrum, num_tris, all_opaque,
                     n_spheres=0, environment=None, two_level=False, has_media=False):
    """{"inst_table": (NI, INST_COLS), "entry_table": (max(NL, 1),
    ENTRY_COLS)} numpy tables when the scene qualifies for the fused
    kernel, else None. surface_rows / light_rows: per type, the list of
    hoisted parameter rows; instances / light_entries: the compiler's
    per-instance and per-light-entry columns; environment: the scene's
    environment node, if it has one (spherical and directional ones
    qualify: their candidates and miss pass run outside the kernel); a
    two-level scene never qualifies (the kernel traces one flat table), nor
    one with media (has_media, or an instance with a medium tag), as in the
    reference."""
    if two_level or has_media or not all_opaque:
        return None
    if environment is not None and type(environment).__name__ not in (
        "SphericalEnvironment", "DirectionalEnvironment"
    ):
        return None
    if num_tris > MAX_TRIS or n_spheres > MAX_SPHERES:
        return None
    if type(spectrum).__name__ != "SRGBSpectrum":
        return None
    ni = len(instances["surface_tag"])
    if ni == 0 or ni > MAX_INSTANCES:
        return None
    nl = len(light_entries["inst"])
    if nl > MAX_LIGHTS:
        return None
    if nl and int(np.sum(np.asarray(light_entries["tri_count"]))) > MAX_LIGHT_TRIS:
        return None
    if any(cls.impl_names[0] not in _FUSED_SURFACES for cls in surface_types):
        return None
    if any(cls.impl_names[0] != "diffuse" for cls in light_types):
        return None

    inst_table = np.zeros((ni, INST_COLS), np.float32)
    # the alpha floor everywhere: no lane divides by a zero alpha
    inst_table[:, 15:17] = 1e-4
    for i in range(ni):
        stag = int(instances["surface_tag"][i])
        if int(instances.get("medium_tag", [-1] * ni)[i]) >= 0:
            return None
        if stag >= 0:
            row = surface_rows[stag][int(instances["surface_index"][i])]
            if not _fold_surface(surface_types[stag].impl_names[0], row, inst_table[i]):
                return None
            inst_table[i, 18] = 1.0
        ltag = int(instances["light_tag"][i])
        if ltag >= 0:
            lrow = light_rows[ltag][int(instances["light_index"][i])]
            if int(lrow.get("emission__h", -1)) >= 0:
                return None  # a textured emission: the kernel reads constants only
            entry = int(instances["light_entry"][i])
            inst_table[i, 19] = 1.0
            inst_table[i, 20:23] = np.maximum(_vec(lrow, "emission")[:3], 0.0) * float(lrow["scale"])
            inst_table[i, 23] = float(lrow["two_sided"])
            inst_table[i, 24] = float(light_entries["total_area"][entry])

    entry_table = np.zeros((max(nl, 1), ENTRY_COLS), np.float32)
    for e in range(nl):
        inst = int(light_entries["inst"][e])
        entry_table[e, 0] = float(light_entries["alias_offset"][e])
        entry_table[e, 1] = float(light_entries["tri_count"][e])
        entry_table[e, 2] = float(light_entries["total_area"][e])
        entry_table[e, 3] = float(inst)
        entry_table[e, 4:7] = inst_table[inst, 20:23]
        entry_table[e, 7] = inst_table[inst, 23]
    return {"inst_table": inst_table, "entry_table": entry_table}


def use_fused(compiled, sampler, light_sampler) -> bool:
    """Whether a sample of this scene takes the fused fork: the compiled
    plan's flag, the independent sampler and the uniform light sampler,
    unless LUISARENDER_TPU_NO_FUSED is set (the reference's opt-out)."""
    if os.environ.get("LUISARENDER_TPU_NO_FUSED"):
        return False
    if not compiled.plan.fused_path:
        return False
    if type(sampler).__name__ != "IndependentSampler":
        return False
    return type(light_sampler).__name__ == "UniformLightSampler"


def camgen_params(camera, sampler_seed, time=0.0):
    """The in-kernel camera generation's scalars (pinhole camera, box
    filter, no clip plane), the camera posed at shutter time `time`, or
    None for a camera it cannot make."""
    if type(camera).__name__ != "PinholeCamera":
        return None
    if type(camera.filter).__name__ != "BoxFilter":
        return None
    if camera.clip_plane is not None:
        return None
    c2w = np.asarray(camera.camera_to_world(float(time)), np.float32)
    resx, resy = camera.film.resolution
    tan_half = float(np.tan(np.deg2rad(camera.fov) * 0.5))
    p = {
        "radius": float(camera.filter.radius),
        "resx": float(resx),
        "resy": float(resy),
        "s": float(tan_half / resy),
        "sampler_seed": int(sampler_seed) & 0xFFFFFFFF,
    }
    for r in range(3):
        for c in range(4):
            p[f"c{r}{c}"] = float(c2w[r, c])
    return p


class FusedTables(NamedTuple):
    """The kernel's scene tables on the scene's device."""

    tri: torch.Tensor  # (P, 16) brute-force layout: v0, e1, e2, valid, opaque
    shade: torch.Tensor  # (P, 16) shade-table columns SHADE_COLS_USED
    sph: torch.Tensor  # (S, 16) sphere rows (S may be 0)
    inst: torch.Tensor  # (NI, INST_COLS)
    entry: torch.Tensor  # (NL, ENTRY_COLS)
    light: torch.Tensor  # (LT, 24) emissive-triangle rows
    n_entry: int  # light-list entries (0: no NEE)
    flat_normals: bool  # authored normals equal the geometric ones
    stypes: tuple  # surface types present


def fused_tables(compiled) -> FusedTables:
    """The scene's kernel tables, built once per compiled scene."""
    cached = getattr(compiled, "_fused_tables", None)
    if cached is None:
        tr = compiled.arrays["trace"]
        shade = tr["shade_table"]
        valid = tr["prim_index"] >= 0
        sh = shade[valid]
        flat = bool(
            (torch.abs(sh[:, 13:22] - sh[:, 9:12].repeat(1, 3)) < 1e-7).all()
        ) if bool(valid.any()) else True
        inst = compiled.arrays["fused"]["inst_table"]
        stypes = sorted({int(t) for t in inst[inst[:, 18] > 0.5, 0].tolist()})
        sph = tr.get("sph")
        if sph is None:
            sph = shade.new_zeros((0, 16))
        cached = FusedTables(
            tri=tr["tri_table"],
            shade=shade[:, list(SHADE_COLS_USED)].contiguous(),
            sph=sph.contiguous(),
            inst=inst.contiguous(),
            entry=compiled.arrays["fused"]["entry_table"].contiguous(),
            light=compiled.arrays["light_tri_rows"].contiguous(),
            n_entry=compiled.plan.num_lights,
            flat_normals=flat,
            stypes=tuple(stypes or [fb.ST_MATTE]),
        )
        compiled._fused_tables = cached
    return cached


# ---------------------------------------------------------------------------
# the plain version: all lanes at once, the kernel's operation order
# ---------------------------------------------------------------------------


def _f32(x) -> float:
    """A Python float holding the float32 rounding of x."""
    return float(np.float32(x))


def _offset1(p, n):
    """Robust ray-origin offset of one component (core/types.py)."""
    of_i = (256.0 * n).to(torch.int32)
    p_bits = p.contiguous().view(torch.int32)
    p_i = torch.where(p < 0.0, p_bits - of_i, p_bits + of_i).view(torch.float32)
    return torch.where(torch.abs(p) < 1.0 / 32.0, p + (1.0 / 65536.0) * n, p_i)


def _make_frame(nx, ny, nz):
    sign = torch.where(nz >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + nz)
    b = nx * ny * a
    return (1.0 + sign * nx * nx * a, sign * b, -sign * nx, b, sign + ny * ny * a, -ny)


def _frame_from_z_and_hint(nx, ny, nz, hx, hy, hz):
    d = fb.dot3(hx, hy, hz, nx, ny, nz)
    sx = hx - d * nx
    sy = hy - d * ny
    sz = hz - d * nz
    s_len = torch.sqrt(torch.clamp(sx * sx + sy * sy + sz * sz, min=0.0))
    fsx, fsy, fsz, ftx, fty, ftz = _make_frame(nx, ny, nz)
    ok = s_len > 1e-8
    inv = 1.0 / torch.clamp(s_len, min=1e-20)
    sx = torch.where(ok, sx * inv, fsx)
    sy = torch.where(ok, sy * inv, fsy)
    sz = torch.where(ok, sz * inv, fsz)
    return (sx, sy, sz, torch.where(ok, ny * sz - nz * sy, ftx),
            torch.where(ok, nz * sx - nx * sz, fty), torch.where(ok, nx * sy - ny * sx, ftz))


def _sphere_roots(row, ox, oy, oz, dx, dy, dz):
    cx, cy, cz, r = row[0], row[1], row[2], row[3]
    ocx = ox - cx
    ocy = oy - cy
    ocz = oz - cz
    b = ocx * dx + ocy * dy + ocz * dz
    c2 = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    disc = b * b - c2
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    return disc, -b - sq, -b + sq


def _instance_consts(inst, idx, valid):
    """Per-lane instance-row columns as the named ic entries (zeros for
    lanes without a valid hit, as the reference's select gives)."""
    rows = inst[torch.clamp(idx, 0, inst.shape[0] - 1)]
    rows = torch.where(valid[:, None], rows, 0.0)
    col = rows.unbind(-1)
    ic = {"stype": col[0], "s2s": col[17], "has_surf": col[18], "has_light": col[19],
          "em": col[20:23], "l2s": col[23], "l_area": col[24],
          "p0": col[13], "p1": col[14], "ax": col[15], "ay": col[16]}
    for k, c in enumerate("rgb"):
        for g in range(4):
            ic[f"c{g}{c}"] = col[1 + 3 * g + k]
    for k in range(6):
        ic[f"d{k}"] = col[25 + k]
    return ic


def _dispatch_eval(stypes, ic, wo, wi):
    if len(stypes) == 1:
        return fb.eval_type(stypes[0], ic, wo, wi)
    zero = torch.zeros_like(wo[0])
    out = [zero, zero, zero, zero]
    for t in stypes:
        v = fb.eval_type(t, ic, wo, wi)
        m = ic["stype"] == float(t)
        out = [torch.where(m, v[k], out[k]) for k in range(4)]
    return tuple(out)


def _dispatch_sample(stypes, ic, wo, u_lobe, u0, u1):
    if len(stypes) == 1:
        return fb.sample_type(stypes[0], ic, wo, u_lobe, u0, u1)
    zero = torch.zeros_like(wo[0])
    wi = [zero, zero, zero + 1.0]
    ev, eta, valid = zero, zero + 1.0, zero < 1.0
    for t in stypes:
        (wx, wy, wz), e, et, ok = fb.sample_type(t, ic, wo, u_lobe, u0, u1)
        m = ic["stype"] == float(t)
        wi = [torch.where(m, a, b) for a, b in zip((wx, wy, wz), wi)]
        ev = torch.where(m, e, ev)
        eta = torch.where(m, et, eta)
        valid = torch.where(m, ok, valid)
    return tuple(wi), ev, eta, valid


def _side_ok(stypes, ic, wo_ng, wo_ns, wi_ng, wi_ns):
    """validate_sides; the glass and disney closures skip it."""
    ok = (wo_ng * wi_ng > 0.0) == (wo_ns * wi_ns > 0.0)
    for t in stypes:
        if t in (fb.ST_GLASS, fb.ST_DISNEY):
            ok = ok | (ic["stype"] == float(t))
    return ok


def _safe_div(a, b):
    ok = torch.abs(b) > 1e-20
    return torch.where(ok, a / torch.where(ok, b, 1.0), 0.0)


def _balance(pdf_a, pdf_b):
    return pdf_a / torch.clamp(pdf_a + pdf_b, min=1e-20)


class EnvInputs(NamedTuple):
    """The environment mode's inputs: the pre-sampled NEE candidates and the
    light sampler's split."""

    cand: torch.Tensor  # (max_depth, 7, N) float32: wi.xyz, pdf * p_env, L.rgb
    p_env: float  # probability of picking the environment for NEE
    env_distance: float  # an environment shadow ray ends this far away


class _Plain:
    """paths_plain's state: the scene tables as host floats where the
    kernel reads scalars, and the per-lane path carry."""

    def __init__(self, t: FusedTables, cam, pixel_xy, max_depth, rr_depth, rr_threshold,
                 env: EnvInputs = None, rays=None):
        self.t = t
        self.rays = rays
        if rays is None:
            self.cam = {k: (v if k == "sampler_seed" else _f32(v)) for k, v in cam.items()}
            self.px = pixel_xy[:, 0].to(torch.int64)
            self.py = pixel_xy[:, 1].to(torch.int64)
        self.max_depth = max_depth
        self.rr_depth = float(rr_depth)
        self.rr_threshold = _f32(rr_threshold)
        p_env = env.p_env if env is not None else 0.0
        self.p_light = _f32((1.0 - p_env) / max(t.n_entry, 1))
        self.env = env
        if env is not None:
            self.p_env = _f32(p_env)
            self.env_area_scale = _f32(1.0 / max(1.0 - p_env, 1e-8))
            self.env_distance = _f32(env.env_distance)
        # every triangle row as a (P,) column, against rays as (N, 1)
        # columns; moller_trumbore's ok excludes padding rows (col 9 == 0)
        self.tri_cols = t.tri.unbind(-1)
        self.sph_rows = [tuple(r) for r in t.sph.tolist()]

    def gen_from_cam(self, si):
        """Seed and camera ray of sample index si (a tensor per lane)."""
        c = self.cam
        st = rng.seed_pixels(self.px, self.py, si, c["sampler_seed"])
        st, u0 = rng.lcg_step(st)
        st, u1 = rng.lcg_step(st)
        fx = self.px.to(torch.float32) + 0.5 + (u0 * 2.0 - 1.0) * c["radius"]
        fy = self.py.to(torch.float32) + 0.5 + (u1 * 2.0 - 1.0) * c["radius"]
        pcx = (fx * 2.0 - c["resx"]) * c["s"]
        pcy = (fy * 2.0 - c["resy"]) * c["s"]
        dcx, dcy, dcz = fb.normalize3(pcx, -pcy, torch.zeros_like(pcx) - 1.0)
        wd = [c[f"c{r}0"] * dcx + c[f"c{r}1"] * dcy + c[f"c{r}2"] * dcz for r in range(3)]
        d = fb.normalize3(*wd)
        o = tuple(torch.zeros_like(dcx) + c[f"c{r}3"] for r in range(3))
        return st, o, d

    def fresh(self, si):
        """A path's start: the camera ray of sample index si, or in the
        ray-input mode the given ray, camera weight and state."""
        if self.rays is None:
            st, o, d = self.gen_from_cam(si)
            zero = torch.zeros_like(o[0])
            tmin, tmax, beta = zero, zero + _F32_BIG, (zero + 1.0,) * 3
        else:
            r = self.rays
            o, d = (r[0], r[1], r[2]), (r[3], r[4], r[5])
            zero = torch.zeros_like(r[0])
            tmin, tmax = r[6], torch.clamp(r[7], max=_F32_BIG)
            beta = (r[8],) * 3
            st = unpack_state(r[9])
        s = {"o": o, "d": d, "tmin": tmin, "tmax": tmax, "st": st,
             "beta": beta, "L": (zero,) * 3, "active": zero < 1.0,
             "pdf_bsdf": zero + 1e16, "eta_scale": zero + 1.0}
        if self.env is not None:
            # the escape state: beta.rgb, pdf_bsdf, dir.xyz
            s["esc"] = (zero,) * 6 + (zero + 1.0,)
        return s

    def closest(self, o, d, tmin, tmax):
        """Closest hit over the triangle rows, then the spheres: the
        lowest row wins an exact tie in t, a triangle a tie with a sphere."""
        t = self.t
        ok, tt, uu, vv = moller_trumbore(self.tri_cols, *(x[:, None] for x in (*o, *d)))
        cand = ok & (tt > tmin[:, None]) & (tt < tmax[:, None])
        t_m = torch.where(cand, tt, float("inf"))
        k = torch.argmin(t_m, dim=1, keepdim=True)  # the first of equal minima
        hit = cand.any(dim=1)
        best_t = torch.where(hit, t_m.gather(1, k)[:, 0], tmax)
        best_u = torch.where(hit, uu.gather(1, k)[:, 0], 0.0)
        best_v = torch.where(hit, vv.gather(1, k)[:, 0], 0.0)
        j = k[:, 0]
        sh = torch.where(hit[:, None], t.shade[j], 0.0)
        tr = torch.where(hit[:, None], t.tri[j], 0.0)
        inst_f = sh[:, 15]
        sph_hit = torch.zeros_like(hit)
        zero = torch.zeros_like(best_t)
        sc = [zero, zero, zero]
        sr = zero + 1.0
        for row in self.sph_rows:
            disc, t0, t1 = _sphere_roots(row, *o, *d)
            ts = torch.where((t0 > tmin) & (t0 < best_t), t0, t1)
            oks = (disc > 0.0) & (ts > tmin) & (ts < best_t)
            best_t = torch.where(oks, ts, best_t)
            hit = hit | oks
            sph_hit = sph_hit | oks
            sc = [torch.where(oks, row[k2], sc[k2]) for k2 in range(3)]
            sr = torch.where(oks, row[3], sr)
            inst_f = torch.where(oks, row[13], inst_f)
        return hit, best_t, best_u, best_v, sh, tr, inst_f, sph_hit, sc, sr

    def occluded(self, so, sd, s_tmax):
        """Shadow rays blocked by a row that blocks (col 10) or an opaque
        sphere (col 14) within (0, s_tmax)."""
        ok, tq, _, _ = moller_trumbore(self.tri_cols, *(x[:, None] for x in (*so, *sd)))
        blocks = self.tri_cols[10] > 0.0
        occ = (ok & blocks & (tq > 0.0) & (tq < s_tmax[:, None])).any(dim=1)
        for row in self.sph_rows:
            if row[14] == 0.0:
                continue
            disc, t0, t1 = _sphere_roots(row, *so, *sd)
            occ = occ | ((disc > 0.0) & (((t0 > 0.0) & (t0 < s_tmax)) | ((t1 > 0.0) & (t1 < s_tmax))))
        return occ

    def bounce(self, s, dep, nrays, dep_i=0):
        """One bounce of every lane; returns nrays. dep: per-lane depth;
        dep_i: the bounce (the environment mode's candidate row)."""
        t = self.t
        where = torch.where
        o, d = s["o"], s["d"]
        active = s["active"]
        nrays = nrays + active.to(torch.int32)
        hitv, best_t, u_b, v_b, sh, tr, inst_f, sph_hit, sc, sr = self.closest(
            o, d, s["tmin"], s["tmax"])

        # interaction (scene/geometry.py surface_interaction)
        w_b = 1.0 - u_b - v_b
        p = [tr[:, k] + u_b * tr[:, 3 + k] + v_b * tr[:, 6 + k] for k in range(3)]
        ng = [sh[:, k] for k in range(3)]
        tg = [sh[:, 12 + k] for k in range(3)]
        if t.flat_normals:
            ns = list(ng)
        else:
            ns = [w_b * sh[:, 3 + k] + u_b * sh[:, 6 + k] + v_b * sh[:, 9 + k] for k in range(3)]
            len2 = ns[0] * ns[0] + ns[1] * ns[1] + ns[2] * ns[2]
            inv_ns = 1.0 / torch.clamp(torch.sqrt(torch.clamp(len2, min=0.0)), min=1e-20)
            ns = [x * inv_ns for x in ns]
            ns_ok = (len2 > 0.25) & torch.isfinite(ns[0]) & torch.isfinite(ns[1]) & torch.isfinite(ns[2])
            ns = [where(ns_ok, a, b) for a, b in zip(ns, ng)]
            flip = fb.dot3(*ns, *ng) < 0.0
            ns = [where(flip, -x, x) for x in ns]
        if self.sph_rows:
            rad = torch.clamp(sr, min=1e-20)
            nr = fb.normalize3(*[(o[k] + best_t * d[k] - sc[k]) / rad for k in range(3)])
            p = [where(sph_hit, sc[k] + sr * nr[k], p[k]) for k in range(3)]
            ng = [where(sph_hit, nr[k], ng[k]) for k in range(3)]
            ns = [where(sph_hit, nr[k], ns[k]) for k in range(3)]
            tg = [where(sph_hit, -nr[1], tg[0]), where(sph_hit, nr[0], tg[1]),
                  where(sph_hit, 0.0, tg[2])]

        wo = [-x for x in d]
        valid = hitv & active
        if self.env is not None:
            # the escape latch: a path escapes at most once
            miss_now = active & ~hitv
            now = (*s["beta"], s["pdf_bsdf"], *d)
            s["esc"] = tuple(where(miss_now, a, b) for a, b in zip(now, s["esc"]))
        ic = _instance_consts(t.inst, inst_f.to(torch.int64), valid)

        # emissive hit
        L = list(s["L"])
        beta = list(s["beta"])
        cos_l = fb.dot3(*wo, *ng)
        lit = (cos_l > 1e-6) | ((ic["l2s"] > 0.5) & (torch.abs(cos_l) > 1e-6))
        dl = [o[k] - p[k] for k in range(3)]
        d2 = dl[0] * dl[0] + dl[1] * dl[1] + dl[2] * dl[2]
        pdf_hit = where(lit, d2 / torch.clamp(torch.abs(cos_l) * ic["l_area"], min=1e-12), 0.0) * self.p_light
        w_mis_hit = _balance(s["pdf_bsdf"], pdf_hit)
        add = valid & (ic["has_light"] > 0.5) & lit
        L = [where(add, L[k] + beta[k] * ic["em"][k] * w_mis_hit, L[k]) for k in range(3)]
        active = valid & (ic["has_surf"] > 0.5)

        st = s["st"]
        u = []
        for _ in range(7):
            st, uk = rng.lcg_step(st)
            u.append(uk)
        u_sel, u_l0, u_l1, u_lobe, u_b0, u_b1, u_rr = u

        # shading frame, flipped toward wo on two-sided surfaces
        sx, sy, sz, tx, ty, tz = _frame_from_z_and_hint(*ns, *tg)
        flip2 = (fb.dot3(*wo, *ns) < 0.0) & (ic["s2s"] > 0.5)
        tx, ty, tz = (where(flip2, -x, x) for x in (tx, ty, tz))
        fn = [where(flip2, -x, x) for x in ns]
        wol = (fb.dot3(*wo, sx, sy, sz), fb.dot3(*wo, tx, ty, tz), fb.dot3(*wo, *fn))
        wo_ng = fb.dot3(*wo, *ng)
        wo_ns = fb.dot3(*wo, *fn)

        env = self.env
        if t.n_entry > 0 or env is not None:
            zero = torch.zeros_like(u_sel)
            if env is not None:
                ev = env.cand[dep_i].unbind(0)  # this bounce's candidate
                pick_env = u_sel < self.p_env
            if t.n_entry > 0:
                u_area = u_sel
                if env is not None:
                    u_area = (u_sel - self.p_env) * self.env_area_scale
                ne = float(t.n_entry)
                u_rel = torch.clamp(u_area, 0.0, rng.ONE_MINUS_EPSILON)
                entry_f = torch.clamp(torch.floor(u_rel * ne), max=ne - 1.0)
                erow = t.entry[entry_f.to(torch.int64)]
                al_off, tri_cnt, tot_area = erow[:, 0], erow[:, 1], erow[:, 2]
                ux = u_l0 * tri_cnt
                i0 = torch.clamp(torch.minimum(torch.floor(ux), tri_cnt - 1.0), min=0.0)
                up = ux - i0
                g0 = (al_off + i0).to(torch.int64)
                lrow0 = t.light[g0]
                take_alias = up >= lrow0[:, 18]
                g = where(take_alias, (al_off + lrow0[:, 19]).to(torch.int64), g0)
                lrow = t.light[g]
                su = torch.sqrt(torch.clamp(up, min=0.0))
                b0 = 1.0 - su
                b1 = u_l1 * su
                b2 = 1.0 - b0 - b1
                lp = [lrow[:, k] + b1 * lrow[:, 3 + k] + b2 * lrow[:, 6 + k] for k in range(3)]
                lng = [lrow[:, 9 + k] for k in range(3)]
            else:
                lp = list(p)
                lng = [zero, zero, zero + 1.0]
            if env is not None:
                # the environment's target: a far point along the candidate,
                # facing back
                lp = [where(pick_env, p[k] + ev[k] * self.env_distance, lp[k]) for k in range(3)]
                lng = [where(pick_env, -ev[k], lng[k]) for k in range(3)]
            wl = [lp[k] - p[k] for k in range(3)]
            wl2 = wl[0] * wl[0] + wl[1] * wl[1] + wl[2] * wl[2]
            inv_wl = 1.0 / torch.clamp(torch.sqrt(torch.clamp(wl2, min=0.0)), min=1e-12)
            wi = [x * inv_wl for x in wl]
            if t.n_entry > 0:
                cos_ll = fb.dot3(-wi[0], -wi[1], -wi[2], *lng)
                lit_l = (cos_ll > 1e-6) | ((erow[:, 7] > 0.5) & (torch.abs(cos_ll) > 1e-6))
                pdf_nee = where(lit_l, wl2 / torch.clamp(torch.abs(cos_ll) * tot_area, min=1e-12), 0.0) * self.p_light
                Ln = [where(lit_l, erow[:, 4 + k], 0.0) for k in range(3)]
            else:
                pdf_nee = zero
                Ln = [zero, zero, zero]
            if env is not None:
                pdf_nee = where(pick_env, ev[3], pdf_nee)
                Ln = [where(pick_env, ev[4 + k], Ln[k]) for k in range(3)]
            pending = active & (pdf_nee > 0.0)
            nrays = nrays + pending.to(torch.int32)

            # shadow ray (core/types.py spawn_ray_to)
            sgn_f = where(fb.dot3(*ng, *wl) >= 0.0, 1.0, -1.0)
            so = [_offset1(p[k], sgn_f * ng[k]) for k in range(3)]
            bb = [so[k] - lp[k] for k in range(3)]
            sgn_t = where(fb.dot3(*lng, *bb) >= 0.0, 1.0, -1.0)
            se = [_offset1(lp[k], sgn_t * lng[k]) for k in range(3)]
            sd = [se[k] - so[k] for k in range(3)]
            s_len = torch.sqrt(torch.clamp(sd[0] * sd[0] + sd[1] * sd[1] + sd[2] * sd[2], min=0.0))
            inv_s = 1.0 / torch.clamp(s_len, min=1e-20)
            sd = [x * inv_s for x in sd]
            s_tmax = where(pending, s_len * (1.0 - 1e-3), 0.0)

            wil = (fb.dot3(*wi, sx, sy, sz), fb.dot3(*wi, tx, ty, tz), fb.dot3(*wi, *fn))
            fe_r, fe_g, fe_b, fe_pdf = _dispatch_eval(t.stypes, ic, wol, wil)
            ok_side = _side_ok(t.stypes, ic, wo_ng, wo_ns, fb.dot3(*wi, *ng), fb.dot3(*wi, *fn))
            fe = [where(ok_side, x, 0.0) for x in (fe_r, fe_g, fe_b)]
            fe_pdf = where(ok_side, fe_pdf, 0.0)
            w_mis = _safe_div(_balance(pdf_nee, fe_pdf), pdf_nee)
            nee_ok = pending & ~self.occluded(so, sd, s_tmax)
            L = [where(nee_ok, L[k] + beta[k] * fe[k] * Ln[k] * w_mis, L[k]) for k in range(3)]

        # BSDF sampling
        smp, ev_f, eta_smp, samp_ok = _dispatch_sample(t.stypes, ic, wol, u_lobe, u_b0, u_b1)
        fs_r, fs_g, fs_b, fs_pdf = _dispatch_eval(t.stypes, ic, wol, smp)
        fs_pdf = where(samp_ok, fs_pdf, 0.0)
        nw = [smp[0] * s_ + smp[1] * t_ + smp[2] * f_
              for s_, t_, f_ in zip((sx, sy, sz), (tx, ty, tz), fn)]
        ok_side = _side_ok(t.stypes, ic, wo_ng, wo_ns, fb.dot3(*nw, *ng), fb.dot3(*nw, *fn))
        fs = [where(ok_side, x, 0.0) for x in (fs_r, fs_g, fs_b)]
        fs_pdf = where(ok_side, fs_pdf, 0.0)

        sgn_r = where(fb.dot3(*ng, *nw) >= 0.0, 1.0, -1.0)
        o = tuple(where(active, _offset1(p[k], sgn_r * ng[k]), o[k]) for k in range(3))
        d = tuple(where(active, nw[k], d[k]) for k in range(3))
        tmin = where(active, 0.0, s["tmin"])
        tmax = where(active, _F32_BIG, s["tmax"])
        pdf_bsdf = where(active, fs_pdf, s["pdf_bsdf"])
        nb = [beta[k] * _safe_div(fs[k], fs_pdf) for k in range(3)]
        beta = [where(active, where(torch.isfinite(x), x, 0.0), b) for x, b in zip(nb, beta)]
        beta_max = torch.maximum(beta[0], torch.maximum(beta[1], beta[2]))
        es = s["eta_scale"]
        es_new = where(
            ev_f == float(fb.EVENT_ENTER), es * eta_smp * eta_smp,
            where(ev_f == float(fb.EVENT_EXIT), es / torch.clamp(eta_smp * eta_smp, min=1e-12), es),
        )
        es = where(active, es_new, es)
        active = active & (fs_pdf > 0.0) & (beta_max > 0.0)

        # Russian roulette
        q = torch.clamp(beta_max * es, min=0.05)
        do_rr = ((dep + 1.0) >= self.rr_depth) & active
        small_q = q < self.rr_threshold
        kill = do_rr & small_q & (u_rr >= q)
        boost = where(do_rr & small_q, 1.0 / torch.clamp(q, min=1e-6), 1.0)
        beta = [x * boost for x in beta]
        active = active & ~kill & ((dep + 1.0) < float(self.max_depth))
        s.update(o=o, d=d, tmin=tmin, tmax=tmax, st=st, beta=tuple(beta), L=tuple(L),
                 active=active, pdf_bsdf=pdf_bsdf, eta_scale=es)
        return nrays


def paths_plain(t: FusedTables, cam, pixel_xy, sample_index, n_samples, *,
                max_depth, rr_depth, rr_threshold, env: EnvInputs = None, rays=None):
    """Plain version of the kernel: (rgb (N, 3) float32, rays (N,) int32),
    and with `env` (megapath and ray input) the escape state (7, N) float32
    third. n_samples == 0: one sample, index sample_index; else the sum of
    n_samples samples from sample_index on, regenerated per lane. With
    `rays` (RAY_WORDS, N) (pack_rays; cam and pixel_xy None) the paths
    start from the given rays, weights and states."""
    if rays is not None and n_samples:
        raise ValueError("the persistent mode takes no rays")
    pl = _Plain(t, cam, pixel_xy, max_depth, rr_depth, rr_threshold, env, rays)
    n, dev = (pixel_xy.shape[0], pixel_xy.device) if rays is None else (rays.shape[1], rays.device)
    si0 = torch.full((n,), int(sample_index), dtype=torch.int64, device=dev)
    s = pl.fresh(si0)
    nrays = torch.zeros((n,), dtype=torch.int32, device=dev)
    if not n_samples:
        for i in range(max_depth):
            if not bool(s["active"].any()):
                break
            nrays = pl.bounce(s, float(i), nrays, i)
        if env is not None:
            return torch.stack(s["L"], dim=-1), nrays, torch.stack(s["esc"], dim=0)
        return torch.stack(s["L"], dim=-1), nrays
    if env is not None:
        raise ValueError("the persistent mode takes no environment")
    zero = torch.zeros((n,), dtype=torch.float32, device=dev)
    samp = torch.zeros_like(si0)
    dep = zero
    acc = [zero, zero, zero]
    max_iters = n_samples * max_depth + 8
    it = 0
    while it < max_iters and bool(s["active"].any()):
        was = s["active"]
        nrays = pl.bounce(s, dep, nrays)
        now = s["active"]
        died = was & ~now
        acc = [a + torch.where(died, x, 0.0) for a, x in zip(acc, s["L"])]
        samp = samp + died.to(torch.int64)
        regen = died & (samp < n_samples)
        new = pl.fresh(si0 + samp)
        for k, v in new.items():
            if isinstance(v, tuple):
                s[k] = tuple(torch.where(regen, a, b) for a, b in zip(v, s[k]))
            else:
                s[k] = torch.where(regen, v, s[k])
        dep = torch.where(regen, 0.0, dep + torch.where(now, 1.0, 0.0))
        it += 1
    return torch.stack(acc, dim=-1), nrays


# ---------------------------------------------------------------------------
# the kernel wrapper
# ---------------------------------------------------------------------------


class _Params(ctypes.Structure):
    """struct FusedParams of csrc/fused_path.cu."""

    _fields_ = [
        ("cam", ctypes.c_float * 12), ("s", ctypes.c_float), ("radius", ctypes.c_float),
        ("resx", ctypes.c_float), ("resy", ctypes.c_float),
        ("rr_threshold", ctypes.c_float), ("p_light", ctypes.c_float),
        ("seed", ctypes.c_uint32), ("sample_index", ctypes.c_int),
        ("n_samples", ctypes.c_int), ("max_depth", ctypes.c_int),
        ("rr_depth", ctypes.c_int), ("n", ctypes.c_int), ("n_tri", ctypes.c_int),
        ("n_sph", ctypes.c_int), ("n_inst", ctypes.c_int), ("n_entry", ctypes.c_int),
        ("n_light_tri", ctypes.c_int), ("flat_normals", ctypes.c_int),
        ("has_env", ctypes.c_int), ("p_env", ctypes.c_float),
        ("env_area_scale", ctypes.c_float), ("env_distance", ctypes.c_float),
        ("has_rays", ctypes.c_int),
    ]


_LIB = None

# the kernel's optional counters (csrc/fused_path.cu STAT_*), in order
STATS = ("lane_slots", "traced", "shaded", "shade_slots", "keys", "rounds", "fetches")


def _library():
    global _LIB
    if _LIB is None:
        from .build import load_library

        lib = load_library("fused_path")
        ptr = ctypes.c_void_p
        lib.fused_path.argtypes = [ptr] * 15 + [ctypes.c_int, ptr]
        lib.fused_path.restype = ctypes.c_int
        lib.fused_path_blocks_per_sm.argtypes = [ctypes.c_int] * 3
        lib.fused_path_blocks_per_sm.restype = ctypes.c_int
        lib.fused_path_pool_bytes.argtypes = []
        lib.fused_path_pool_bytes.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def blocks_per_sm(device, env=False, rays=False) -> int:
    """Blocks of the kernel (its environment mode with env, its ray-input
    mode with rays) resident on one SM of a CUDA device, as the occupancy
    query gives it (the launch sizes its grid from it)."""
    return _library().fused_path_blocks_per_sm(torch.device(device).index or 0, int(env),
                                               int(rays))


def pool_bytes() -> int:
    """Dynamic shared memory of one block of the kernel: its slot pool."""
    return _library().fused_path_pool_bytes()


def _check(t: FusedTables, dev, n, env=None, n_samples=0, max_depth=0):
    """Checks the tables, and the candidates with `env`, against the lanes'
    device and count."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if env is not None:
        c = env.cand
        if n_samples:
            raise ValueError("the persistent mode takes no environment")
        if (c.device != dev or c.dtype != torch.float32 or not c.is_contiguous()
                or tuple(c.shape) != (max_depth, 7, n)):
            raise ValueError(f"env candidates must be a contiguous float32 (max_depth, 7, N) "
                             f"tensor on {dev}, got {tuple(c.shape)} {c.dtype} on {c.device}")
    for name, x, cols, most in (
        ("tri", t.tri, 16, MAX_TRIS), ("shade", t.shade, 16, MAX_TRIS),
        ("sph", t.sph, 16, MAX_SPHERES), ("inst", t.inst, INST_COLS, MAX_INSTANCES),
        ("entry", t.entry, ENTRY_COLS, MAX_LIGHTS), ("light", t.light, 24, MAX_LIGHT_TRIS),
    ):
        if x.device != dev:
            raise ValueError(f"table {name} is on {x.device}, the lanes on {dev}")
        if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] != cols:
            raise ValueError(f"table {name} must be (R, {cols}) float32")
        if x.shape[0] > most:
            raise ValueError(f"table {name} has {x.shape[0]} rows; at most {most}")
        if not x.is_contiguous():
            raise ValueError(f"table {name} must be contiguous")
    if t.tri.shape[0] != t.shade.shape[0]:
        raise ValueError("tri and shade tables differ in rows")


def _check_pixels(pixel_xy):
    if pixel_xy.dtype != torch.int32 or pixel_xy.dim() != 2 or pixel_xy.shape[1] != 2:
        raise ValueError(f"pixel_xy must be (N, 2) int32, got {tuple(pixel_xy.shape)} {pixel_xy.dtype}")
    if not pixel_xy.is_contiguous():
        raise ValueError("pixel_xy must be contiguous")


def _check_rays(rays):
    if (rays.dtype != torch.float32 or rays.dim() != 2 or rays.shape[0] != RAY_WORDS
            or not rays.is_contiguous()):
        raise ValueError(f"rays must be a contiguous float32 ({RAY_WORDS}, N) tensor "
                         f"(pack_rays), got {tuple(rays.shape)} {rays.dtype}")


def params(t: FusedTables, cam, n, sample_index, n_samples, max_depth, rr_depth,
           rr_threshold, env: EnvInputs = None) -> _Params:
    """The kernel's FusedParams for n lanes; cam None: the ray-input mode."""
    prm = _Params()
    if cam is not None:
        for k, name in enumerate(f"c{r}{c}" for r in range(3) for c in range(4)):
            prm.cam[k] = cam[name]
        prm.s, prm.radius, prm.resx, prm.resy = cam["s"], cam["radius"], cam["resx"], cam["resy"]
        prm.seed = cam["sampler_seed"]
    else:
        prm.has_rays = 1
    prm.rr_threshold = rr_threshold
    p_env = env.p_env if env is not None else 0.0
    prm.p_light = (1.0 - p_env) / max(t.n_entry, 1)
    prm.sample_index = int(sample_index)
    prm.n_samples = int(n_samples)
    prm.max_depth, prm.rr_depth, prm.n = int(max_depth), int(rr_depth), n
    prm.n_tri, prm.n_sph, prm.n_inst = t.tri.shape[0], t.sph.shape[0], t.inst.shape[0]
    prm.n_entry, prm.n_light_tri = t.n_entry, t.light.shape[0]
    prm.flat_normals = int(t.flat_normals)
    if env is not None:
        prm.has_env = 1
        prm.p_env = p_env
        prm.env_area_scale = 1.0 / max(1.0 - p_env, 1e-8)
        prm.env_distance = env.env_distance
    return prm


def table_ptrs(t: FusedTables):
    """The six tables' device pointers, in the C function's order."""
    # a zero-row table still needs a valid pointer
    sph = t.sph if t.sph.shape[0] else t.sph.new_zeros((1, 16))
    return (t.tri.data_ptr(), t.shade.data_ptr(), sph.data_ptr(), t.inst.data_ptr(),
            t.entry.data_ptr(), t.light.data_ptr()), sph


def _launch(t, cam, n, dev, pixel_xy, rays, sample_index, n_samples, env, stats, kw):
    """One launch of the kernel on n lanes of CUDA device dev: the camgen
    or persistent mode from pixel_xy, the ray-input mode from rays. Returns
    (rgb, rays), and the escape state third with env."""
    global launches, env_launches, ray_launches, ray_env_launches, persistent_launches
    rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
    n_rays = torch.empty((n,), dtype=torch.int32, device=dev)
    esc = torch.empty((7, n), dtype=torch.float32, device=dev) if env is not None else None
    out = (rgb, n_rays) if env is None else (rgb, n_rays, esc)
    if n == 0:
        return out
    if stats is not None and (stats.device != dev or stats.dtype != torch.int64
                              or stats.shape != (len(STATS),) or not stats.is_contiguous()):
        raise ValueError(f"stats must be a contiguous int64 ({len(STATS)},) tensor on {dev}")
    prm = params(t, cam, n, sample_index, n_samples, env=env, **kw)
    ptrs, _sph = table_ptrs(t)
    work = torch.empty((1,), dtype=torch.int32, device=dev)  # zeroed by the C function
    err = _library().fused_path(
        ctypes.addressof(prm), None if pixel_xy is None else pixel_xy.data_ptr(),
        None if rays is None else rays.data_ptr(), *ptrs,
        None if env is None else env.cand.data_ptr(), rgb.data_ptr(), n_rays.data_ptr(),
        None if esc is None else esc.data_ptr(), work.data_ptr(),
        None if stats is None else stats.data_ptr(), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_path kernel launch failed: CUDA error {err}")
    if n_samples:
        persistent_launches += 1
    elif rays is not None:
        if env is not None:
            ray_env_launches += 1
        else:
            ray_launches += 1
    elif env is not None:
        env_launches += 1
    else:
        launches += 1
    return out


def paths(t: FusedTables, cam, pixel_xy, sample_index, n_samples=0, *,
          max_depth, rr_depth, rr_threshold, stats=None, env: EnvInputs = None):
    """The fused kernel on CUDA tensors, its plain version on CPU tensors:
    (rgb (N, 3) float32, rays (N,) int32), and with `env` the escape state
    (7, N) float32 third; see paths_plain. `stats`, a CUDA int64 tensor of
    len(STATS), receives the kernel's counters (added to it)."""
    dev = pixel_xy.device
    _check_pixels(pixel_xy)
    _check(t, dev, pixel_xy.shape[0], env, n_samples, max_depth)
    kw = dict(max_depth=max_depth, rr_depth=rr_depth, rr_threshold=rr_threshold)
    if dev.type == "cpu":
        return paths_plain(t, cam, pixel_xy, sample_index, n_samples, env=env, **kw)
    return _launch(t, cam, pixel_xy.shape[0], dev, pixel_xy, None, sample_index, n_samples,
                   env, stats, kw)


def paths_rays(t: FusedTables, rays, *, max_depth, rr_depth, rr_threshold, stats=None,
               env: EnvInputs = None):
    """The kernel's ray-input mode on CUDA tensors, its plain version on CPU
    tensors: one path a lane from rays (RAY_WORDS, N) (pack_rays). Returns
    as `paths` does."""
    _check_rays(rays)
    _check(t, rays.device, rays.shape[1], env, 0, max_depth)
    kw = dict(max_depth=max_depth, rr_depth=rr_depth, rr_threshold=rr_threshold)
    if rays.device.type == "cpu":
        return paths_plain(t, None, None, 0, 0, env=env, rays=rays, **kw)
    return _launch(t, None, rays.shape[1], rays.device, None, rays, 0, 0, env, stats, kw)


def pack_rays(ray, cam_weight, state):
    """The ray-input mode's lanes as one (RAY_WORDS, N) float32 tensor, a
    row a word (consecutive lanes in consecutive words): origin, direction,
    t_min, t_max, the camera weight, and the sampler state (a uint32 in an
    int64 tensor, core/rng.py) as its bits."""
    st = torch.where(state >= 2**31, state - 2**32, state).to(torch.int32)
    return torch.cat([ray.origin.T, ray.direction.T, ray.t_min[None], ray.t_max[None],
                      cam_weight[None].to(torch.float32), st.view(torch.float32)[None]]
                     ).contiguous()


def unpack_state(bits):
    """The sampler state (int64 holding a uint32) from its float32 bits."""
    return bits.contiguous().view(torch.int32).to(torch.int64) & rng.MASK32


# ---------------------------------------------------------------------------
# the environment mode's candidates and miss pass (PyTorch, before and after
# the launch)
# ---------------------------------------------------------------------------


def env_nee_candidates(compiled, cam, pixel_xy, sample_index, max_depth, p_env):
    """Each lane's environment NEE candidate of every bounce, (max_depth, 7,
    N) float32: wi.xyz, pdf * p_env, L.rgb, for the in-kernel camera: the
    pixel's seed, then the camera's 2 draws (env_nee_candidates_from_state)."""
    n = pixel_xy.shape[0]
    si = torch.full((n,), int(sample_index), dtype=torch.int64, device=pixel_xy.device)
    seed = rng.seed_pixels(pixel_xy[:, 0].to(torch.int64), pixel_xy[:, 1].to(torch.int64),
                           si, int(cam["sampler_seed"]))
    return env_nee_candidates_from_state(compiled, seed, max_depth, p_env, skip=2)


def env_nee_candidates_from_state(compiled, state, max_depth, p_env, skip=0):
    """The candidates of lanes whose paths start from sampler state `state`
    (N,) after `skip` more draws (the in-kernel camera's 2; 0 in the
    ray-input mode, whose state is past the camera's draws): (max_depth, 7,
    N) float32, wi.xyz, pdf * p_env, L.rgb. The kernel draws 7 uniforms a
    bounce (u_sel, u_light.xy, u_lobe, u_bsdf.xy, u_rr) from there, so the
    environment sample a bounce would draw is reproduced here from the same
    stream: draws 2-3 of bounce d are LCG steps 7d + 2 + skip and 7d + 3 +
    skip, jumped to directly (core/rng.py lcg_states) and sampled for every
    bounce at once. An environment's directions do not depend on the
    shading point, which makes the hoist exact."""
    env = compiled.scene.environment
    n = state.shape[0]
    dev = state.device
    ks = ([7 * d + 2 + skip for d in range(max_depth)]
          + [7 * d + 3 + skip for d in range(max_depth)])
    u = rng.uniform_u32_to_float(rng.lcg_states(state, ks))  # (2 * max_depth, N)
    u = torch.stack([u[:max_depth].reshape(-1), u[max_depth:].reshape(-1)], dim=-1)
    m = max_depth * n
    # the fused fork is sRGB only, whose wavelengths read no draw: any
    # (M, 1) tensor on the device stands in for them
    unused_u = u[:, :1]
    s = env.sample(compiled, torch.zeros((m, 3), dtype=torch.float32, device=dev), u,
                   compiled.spectrum.sample_wavelengths(unused_u))
    rows = torch.cat([s["wi"], (s["pdf"] * _f32(p_env))[:, None], s["L"]], dim=-1)
    return rows.reshape(max_depth, n, 7).transpose(1, 2).contiguous()


def miss_pass(compiled, rgb, esc, p_env):
    """rgb (N, 3) plus the environment's radiance at each pixel's escape
    direction, with its MIS weight against the escaping BSDF sample:
    beta * L_env * balance(pdf_bsdf, pdf_env * p_env). esc: the kernel's
    escape state (7, N)."""
    env = compiled.scene.environment
    n = rgb.shape[0]
    unused_u = rgb[:, :1]  # sRGB only: the wavelengths read no draw
    swl = compiled.spectrum.sample_wavelengths(unused_u)
    ev = env.evaluate(compiled, esc[4:7].T, swl)
    w = _balance(esc[3], ev["pdf"] * _f32(p_env))
    return rgb + esc[0:3].T * ev["L"] * w[..., None]


def trace_paths_fused_camgen(compiled, cam, pixel_xy, sample_index, *, max_depth,
                             rr_depth, rr_threshold, light_sampler=None):
    """One sample of each pixel of pixel_xy (N, 2) int32 in one launch:
    (rgb (N, 3), rays traced (a 0-dim int64 tensor)). A scene with an
    environment makes its candidates first and runs the miss pass after."""
    kw = dict(max_depth=max_depth, rr_depth=rr_depth, rr_threshold=rr_threshold)
    t = fused_tables(compiled)
    if not compiled.plan.has_environment:
        rgb, rays = paths(t, cam, pixel_xy, sample_index, 0, **kw)
        return rgb, rays.sum(dtype=torch.int64)
    p_env = light_sampler.selection_probs(compiled)[0]
    env = EnvInputs(
        cand=env_nee_candidates(compiled, cam, pixel_xy, sample_index, max_depth, p_env),
        p_env=p_env, env_distance=compiled.plan.env_distance,
    )
    rgb, rays, esc = paths(t, cam, pixel_xy, sample_index, 0, env=env, **kw)
    return miss_pass(compiled, rgb, esc, p_env), rays.sum(dtype=torch.int64)


def trace_paths_fused(compiled, ray, cam_weight, state0, *, max_depth, rr_depth,
                      rr_threshold, light_sampler=None):
    """One sample of each lane from caller-made camera rays in one launch of
    the ray-input mode: (rgb (N, 3), rays traced (a 0-dim int64 tensor)).
    ray: core/types.py Ray (N,); cam_weight (N,); state0 (N,) the sampler
    state past the filter's (and the lens's) draws, as the general fork's
    is when it enters its bounce loop. A scene with an environment makes
    its candidates from state0 first and runs the miss pass after."""
    kw = dict(max_depth=max_depth, rr_depth=rr_depth, rr_threshold=rr_threshold)
    t = fused_tables(compiled)
    rays = pack_rays(ray, cam_weight, state0)
    if not compiled.plan.has_environment:
        rgb, n_rays = paths_rays(t, rays, **kw)
        return rgb, n_rays.sum(dtype=torch.int64)
    p_env = light_sampler.selection_probs(compiled)[0]
    env = EnvInputs(
        cand=env_nee_candidates_from_state(compiled, state0, max_depth, p_env),
        p_env=p_env, env_distance=compiled.plan.env_distance,
    )
    rgb, n_rays, esc = paths_rays(t, rays, env=env, **kw)
    return miss_pass(compiled, rgb, esc, p_env), n_rays.sum(dtype=torch.int64)


def trace_paths_fused_persistent(compiled, cam, pixel_xy, sample_index0, n_samples, *,
                                 max_depth, rr_depth, rr_threshold):
    """n_samples samples of each pixel in one launch: (the SUM of their rgb
    (N, 3), rays traced). Scenes with an environment take the megapath
    mode instead: regeneration makes a lane's draw offsets depend on its
    path lengths, so no candidate could be pre-sampled."""
    if compiled.plan.has_environment:
        raise ValueError("the persistent fused mode does not take environments")
    rgb, rays = paths(fused_tables(compiled), cam, pixel_xy, sample_index0, n_samples,
                      max_depth=max_depth, rr_depth=rr_depth, rr_threshold=rr_threshold)
    return rgb, rays.sum(dtype=torch.int64)
