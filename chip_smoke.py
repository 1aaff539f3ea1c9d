#!/usr/bin/env python3
"""Drive luisarender_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero before the result:
  1 card     the device name and count, and nvidia-smi's name and power limit
  2 build    nvcc builds every kernel source of luisarender_tpu_torch/csrc
             (one nvcc per source, all started together, with g++ building
             the SAH builder beside them); ptxas's registers, static shared
             memory and spills per kernel, and the fused kernel's dynamic
             shared memory (its slot pool) and blocks per SM
  3 kernels  the brute-force traces against their plain PyTorch versions on
             every input of one sample of the general scene of phase 5 (512^2
             lanes, 352 rows: 8 bounces of rays and their shadow rays), on two
             bounces of scenes/cornell.json forced onto the general fork (32
             rows) and on a random 512-row table with a ragged ray count:
             slots, occlusion, t, u and v bit for bit; per input the device
             time, the bound (brute_work: each row test counted to its
             first failed check, the rays of live lanes only), the live
             share of lanes and the kernels' lane counters, and the sum
             over the 16 launches of a sample. The
             fused kernel against its plain version on one 512^2 sample
             of scenes/materials.json (depth 10) and of
             scenes/cornell.json (depth 8), and on a pass of 4 samples of
             each (persistent mode): rgb and ray counts bit for bit on every
             lane, and 20 launches queued back to back equal to the first;
             the persistent pass within 1e-6 of the sum of 4
             one-sample launches; its lane use from the kernel's counters
             beside the path-length SIMT share of one thread a pixel, and
             its bound with shading counted per surface type and, as this
             script counted it before, as matte for every lane. The fused
             kernel's environment mode against its plain version on one
             512^2 sample, depth 8, of testing.cornell_box with the
             reference's constant spherical environment, with a
             directional one, with the spherical one and no area light, and
             with the Nishita sky and an EXR sun map, which are not
             constant (env_scene): rgb, rays and the 7 escape words bit for bit on
             every lane, 20 launches back to back equal; its time, bound
             (the candidates and escape words in its bytes) and lane use,
             and the times of the candidates and the miss pass beside it
             (CUDA events around the calls, and the profiler's device
             time). The fused kernel's ray-input mode against its plain
             version on one 512^2 sample, depth 8, of each ray_scene:
             scenes/cornell.json with a thin lens and a gaussian filter,
             with a mitchell filter and a near clip plane, and
             testing.cornell_box with the constant spherical environment
             and the thin lens: rgb, rays (and the escape words) bit for
             bit on every lane, 20 launches back to back equal; its time,
             bound (the 40 B ray a lane in its bytes) and lane use, the
             camera generation's time (and the miss pass's) beside it;
             and the mode fed the camgen mode's own rays and states on
             scenes/cornell.json, bit for bit against the camgen kernel.
             The cluster
             traces against their plain version on the full mesh-heavy
             scene (512,004 triangles: camera rays, bounce-1 rays and the
             shadow rays of both bounces, 1280 x 720), on a random
             3,000-triangle soup and on a soup of 60 triangles 200 times
             each (exact ties in t, inside and across clusters), each with
             a ragged 100,003 rays, launched in caller order and through
             the reference's ray sort (launch_sorted below): t,
             slot, u, v, occlusion and the per-ray node pops, leaf visits
             and rows tested bit for bit; the kernel's time on caller-order
             and on sorted rays, the sorted wrapper's and the sort's alone
             (keys, sort, gathers, scatters; CUDA events around the calls,
             host dispatch included) and the kernel's lane counters.
             The wide8, subpacket and trace kernels against their plain
             versions on the same mesh-heavy rays (the scene compiled with
             the 8-wide tables) and on a random 8,000-triangle soup with a
             ragged 100,003 rays, every output and walk count bit for bit,
             the subpacket kernels also through the reference's ray sort
             (ops/subpacket.py launch_sorted), with the wide8, subpacket
             and trace kernels' lane counters (as the cluster kernel's,
             and for wide8 the pending leaves its box re-test dropped), the
             subpacket bound with a Woop row charged 13 columns and 22
             beside it, and for the trace kernel its child-pair table's
             rows and build time and the reference-order walk
             (ops/trace.py preorder_plain) beside its own: its walk, its
             bound, and its hits, which the kernel's must equal on every
             lane;
             and against the cluster kernel on the same rays: wide8 and
             trace the same slots on every lane but exact ties, subpacket
             by the reference's rule for it (under 0.5% of lanes flip
             between hit and miss, over 99.5% of slots agree, any-hit on
             99.8% of lanes, t within rtol 2e-4 / atol 1e-4 on the lanes
             whose slots agree; the lanes that differ are written to
             chiprun_out/subpacket_flips.npz for tests/subpacket_flips.py,
             which holds them against the reference's own kernel).
             Kernel wrappers timed with
             CUDA events around launches queued behind a spin kernel
             (device time, no host dispatch), and with torch.profiler's
             kernel time beside it where the profiler traces the card;
             plain versions with CUDA events around their calls (host
             dispatch included)
  4 main     through load_scene + render, nothing cut: scenes/materials.json
             (512^2, depth 10, 512 spp) with one fused launch a sample and
             no brute-force launch; scenes/cornell.json (512^2, depth 8,
             256 spp) the same, its image lit, red wall left and green wall
             right; testing.cornell_box(1024^2, 32 spp, depth 5) on the
             megawave integrator with one persistent launch a pass of
             samples_per_pass samples; testing.cornell_box with the constant
             spherical environment (512^2, depth 8, 256 spp) with one
             fused launch a sample in the environment mode and no other
             kernel launch, the image lit, and on the megawave integrator
             (256^2, 8 spp, depth 5) the per-pass route: no persistent
             launch; the ray-input mode: the thin-lens Cornell box
             (scenes/cornell.json, 512^2, depth 8, 256 spp) and the
             thin-lens env Cornell box (the same) with one ray-input launch
             a sample (its environment form for the second) and no other
             kernel launch, and the first on megawave (256^2, 8 spp, depth
             5) a sample a launch, no persistent pass;
             testing.mesh_heavy (1280 x 720, depth 5, 4 spp,
             512,004 triangles, its checkerboard floor and constant
             environment) on the general fork with the cluster kernels
             launched once a bounce each and no brute-force or fused
             launch, the image lit; the same scene on
             the opt-in routes, wide8 (one wide8 closest and any-hit
             launch a bounce, nothing else) and subpacket (one subpacket
             closest and one cluster any-hit launch a bounce), each image
             under 2% of pixels off the cluster route's by more than 1e-3
             and its mean within 0.5%. Seconds (the scene compile
             included, the kernel build not), rays, Mray/s, and the
             compile seconds on their own.
    twolevel the same scene compiled two-level (accel "twolevel": 27
             instances of 3 unique meshes, 20,484 unique triangles): its
             render with one cluster closest launch a visible instance a
             bounce and one any-hit launch a visible opaque one, nothing
             else, its image against the cluster route's by that rule,
             and its trace tables' bytes beside the flat scene's; the
             route on phase 3's mesh-heavy camera and bounce-1 rays and
             both bounces' shadow rays against the plain TLAS/BLAS walk
             on the card (hits, prims and instances on every lane but
             exact ties in t, t within 1e-5 relative, occlusion on every
             lane) and against the flat cluster kernel (at most
             TWOLEVEL_FLAT_SHARE of lanes differ), with its wall and
             profiler device ms a trace beside the flat kernel's; and
             testing.mesh_heavy(n=20) under accel "auto" (400
             icospheres, 8,192,004 flattened triangles), which must
             compile two-level without the flat tables and render one
             1280 x 720 sample at depth 5, 402 launches a bounce each
  5 general  the general fork: testing.cornell_box(512^2, depth 8) plus a
             subdivided icosphere (352 triangles, so the fused kernel does
             not cover it) through render at 32 spp (cut from 256 to save
             time): both brute-force kernels launched once a bounce, the
             fused kernel never
  6 profile  512^2 materials samples on the fused fork, a 512^2 Cornell
             sample, a 512^2 sample of phase 5's scene and a 1280 x 720
             mesh-heavy sample on the general fork, flat and two-level,
             under torch.profiler, per
             sample: device busy share and the kernels' share of it (not
             measured, and reported as null, if the profiler traces no
             device work)
  7 golden   testing.cornell_box(64^2, 8 spp, depth 5) through render (the
             fused fork) against tests/golden/cornell_64_8spp.exr, the
             reference's general fork: image mean within 0.5%, each sample
             of the fused fork against the general fork by the rule of
             phase 3, and the general fork's image under 2% of pixels off
             by more than 1e-3; testing.cornell_box with the constant
             spherical environment (64^2, 8 spp, depth 5; no golden), each
             sample of the fused fork against the general fork by that
             rule; the three ray-input scenes (64^2, 8 spp, depth 5; no
             golden) likewise; scenes/materials.json at 48^2, 8 spp,
             depth 5 through the general fork against
             tests/golden/materials_48_8spp.exr under that rule;
             testing.cornell_sphere (48^2, 8 spp, depth 5, 1,312
             triangles) on the cluster, wide8 and subpacket routes, each
             against tests/golden/cornell_sphere_48_8spp.exr under that
             rule
  8 spectral the hero-wavelength spectrum on the general fork:
             scenes/cornell_spectral.json (512^2, depth 8, 4 wavelengths a
             path; spp cut from 256 to SPECTRAL_SPP) through render, no
             fused pass, both brute kernels launched once a bounce and
             nothing else, and scenes/cornell.json (sRGB) on the general
             fork (LUISARENDER_TPU_NO_FUSED) at the same spp: seconds,
             compile seconds, rays, Mray/s, one sample under the profiler
             (device ms, busy share, the brute kernels' share) and the hero
             / sRGB ratios; the spectrum layer's operations on 512^2 lanes
             (wavelength sampling, the coefficient and per-ray decodes, the
             integration to sRGB); the brute kernels on the 16 inputs of
             one hero sample bit for bit against their plain versions; the
             48^2, 8-spp, depth-8 render against
             tests/golden/cornell_spectral_48_8spp.exr (under 2% of pixels
             off by more than 1e-3, the mean within 0.5%);
             testing.mesh_heavy (1280 x 720, depth 5, 4 spp) under hero,
             its Disney spheres plastic of the same colour (the reference
             cannot shade Disney under hero), with the cluster kernels
             launched once a bounce each and nothing else, against the same
             scene in sRGB by the reference's rule (tests/test_spectral.py:
             mean relative error under 0.25), with the same records
  9 textures image textures, the Nishita sky, textured emission and Loop
             subdivision (phase_textures): scenes/sky.json at its own 960 x
             540, depth 6 (thin lens, the sky through the spherical map's
             alias tables, a loopsubdiv glass, a copper sphere; spp cut
             from 256 to SKY_SPP) through render, both brute kernels
             launched once a bounce and nothing else, the records of
             phase 8, the brute kernels on one sample's first four
             bounces bit for bit against their plain versions, and the
             64 x 36, 8-spp render against tests/golden/sky_64x36_8spp.exr;
             testing.mesh_heavy(textured=True) (1280 x 720, depth 5, 4
             spp, nothing cut: 25 Disney spheres with one 256^2 PNG on the
             atlas, read at each hit's ray-cone level) with the cluster
             kernels once a bounce each, beside phase 4's untextured
             render, the atlas's bytes and the image lookups of a sample's
             first hits (CUDA events and the profiler), and its two-level
             form at 1 spp; the env Cornell box with the sky and with an
             EXR sun map (env_scene `nishitasky` and `image`, whose
             environment-mode kernel checks run in phase 3) at 512^2, depth
             8, 256 spp with one environment-mode launch a sample, and 8
             samples at 64^2 each against the general fork by the rule of
             phase 7; testing.cornell_textured (48^2, 8 spp, a textured
             back wall and a textured light, brute kernels once a bounce)
             against tests/golden/cornell_textured_48_8spp.exr
 10 surfaces mix and layered surfaces, normal maps, the text SDL, motion
             blur and checkpoints (phase_surfaces): testing.cornell_coated
             (512^2, depth 8, spp cut from 256 to COATED_SPP: coats in
             closed form and by the walk, a mix by a checkerboard, a
             normal-mapped floor, a glass sphere whose eta varies) through
             render on the general fork, both brute kernels once a bounce
             and nothing else, with the records of phase 8 and the brute
             kernels on one sample's first four bounces bit for bit against
             their plain versions; scenes/cornell.luisa through render_file
             (512^2, depth 8, 256 spp, one fused launch a sample) against
             scenes/cornell.json's render by the goldens' rule, their fused
             tables equal, and the fused kernel on one of its samples bit
             for bit; testing.cornell_motion (the short block under lerp,
             MOTION_BUCKETS shutter buckets, each compiled at its time and
             its compile timed, MOTION_SPP spp a bucket on the fused fork)
             and the fused kernel on one bucket bit for bit; a checkpoint
             interrupted after 4 of 8 spp at 64^2 and resumed, bit for bit
             the whole render
 11 samplers the five low-discrepancy samplers (phase_samplers): the Sobol
             direction table's first build (1,024 dimensions) timed; each
             sampler's testing.cornell_box (32^2, 4 spp, depth 4, the general
             fork, brute kernels once a bounce) against
             tests/golden/cornell_<impl>_32_4spp.exr; scenes/cornell.json
             (512^2, depth 8, spp cut from 256 to SAMPLER_SPP) under zsobol
             and pmj02bn with the records of phase 8 beside phase 8's
             independent render of it on the general fork; the brute kernels
             on one zsobol sample's 16 inputs bit for bit against their
             plain versions; each sampler's device ops and ms of start, a 1D
             and a 2D draw on 512^2 lanes; each sampler's states and draws
             on the card bit-equal with the CPU's
 12 wavefront the wavepath integrator (phase_wavefront): bench.py's Cornell
             configuration (1024^2, 4 spp, depth 5) on the fused pool, one
             persistent launch a tile and nothing else, the kernel on the
             tile's first WAVE_HELD_LANES lanes bit for bit against its plain
             version, the image bit-equal with megawave's, also in tiles of
             WAVE_SMALL_TILE pixels; bench.py's mesh
             configuration (testing.mesh_heavy flat, 4 spp, depth 5,
             state_count 2^20: one tile of 921,600 slots) on the general
             pool with the cluster kernels once an iteration each, its
             iterations, refills and host reads, against phase 4's megapath
             image by the goldens' rule; seconds and Mpaths/s of both; the
             wavepath golden (32^2, 8 spp, a pool of 256) on the general pool
             by the rule, on the fused pool by its mean and each sample
             against the general fork by the rule of phase 3
 13 display  testing.cornell_box 64^2 with the display film (aces, served on
             port 0): /, /frame.png and /stats.json from 127.0.0.1, the
             preview PNG in a temporary directory, a preview a pass
 14 media    participating media on megavpt (phase_media): scenes/fog.json
             through render_file (512^2, depth 10, spp cut from 256 to
             FOG_SPP; a homogeneous fog sphere of 5,120 null-surface
             triangles, 5,152 triangles on the cluster route) and
             testing.fog_grid (the sphere a 32^3 density grid, FOG_GRID_SPP
             spp), each with one cluster closest and two any-hit launches a
             loop iteration and nothing else: seconds, Mpaths/s, iterations
             and host reads a sample, one sample's wall and busy ms under the
             profiler; both 32^2 goldens (tests/golden/fog_32_8spp.exr,
             fog_grid_32_8spp.exr) by the goldens' rule; the cluster kernels
             bit for bit against their plain versions on one fog sample's
             bounce-1 rays and scatter-event shadow rays (their origins
             inside the sphere), with their times and bounds
 15 aux      the auxiliary integrators (phase_aux) on testing.cornell_box
             512^2, 4 spp: normal, direct in its three modes, aov's
             multi-buffer mode with the final dump into a temporary
             directory (all nine component files written and read back), a
             group of normal and direct; seconds and brute launches of each,
             nothing else launched; normal and direct at 32^2 on the card
             against the CPU render by the goldens' rule
 16 montecarlo the Monte Carlo variants (phase_montecarlo): bench.py's three
             long-tail configurations (photon mapping, PSSMLT, GPT) on
             testing.cornell_box at 128^2, 16 spp, depth 6 (GPT's 4),
             each rendered twice and the second render timed as bench.py
             times it: seconds, Msamples/s, the brute kernels' launches
             and nothing else (no fused launch under PSSMLT), one unit of
             the integrator's work in parts (photon: emission, grid,
             camera pass, gather; pssmlt: bootstrap, trace, mutation;
             gpt: a sample, the reconstruction); the three 32^2 goldens
             (tests/golden/photon_32_4spp.exr, pssmlt_32_4spp.exr,
             gpt_32_4spp.exr) by the goldens' rule; the brute closest
             kernel bit for bit against its plain version on the photon
             walk's first rays (origins on the light) and on GPT's 4N
             shifted camera rays, with its time and bound
 17 diff     differentiable rendering and the sharded pass (phase_diff):
             d mean(img) / d the constant-texture table of
             testing.cornell_box (16^2, 2 spp, depth 3) on the card
             against the CPU's (each entry within 1% or 1e-5), and
             tests/test_diff.py's checks on the card (finite, non-negative
             on the walls, two finite differences, emission linearity);
             its 48-step Adam recovery by that test's criteria; bench.py's
             two gradient configurations, grad_overhead (testing.cornell_box
             128^2, 2 spp, depth 4, remat) and grad_overhead_mesh
             (testing.mesh_heavy(textured=True) flat, 640 x 360, 1 spp,
             depth 4, no remat, the atlas), nothing cut: forward and
             forward + backward seconds (best of GRAD_CALLS), bench.py's
             ratio, peak allocated bytes, the trace kernels' launches in
             the forward and the backward and nothing else, and the atlas
             scatter-add's device ms (profiler) and a replay of its texels
             (CUDA events); render_sharded and make_sharded_grad_fn in a
             one-rank NCCL group against render and l2_loss_fn
 18 tools    the command line and the tools (phase_tools): cli.main (the
             card by default) on scenes/cornell.json at its own 512^2, depth
             8, 256 spp, its EXR bit-equal with render's image of the same
             file and 256 fused launches, nothing else, with the load,
             compile and render seconds it prints; the same on
             scenes/cornell.luisa with -D light_scale=2 and --spp 32 (cut
             from 256); tests/test_golden.py's Tungsten scene (a .wo3 floor,
             a rough copper sphere, a quad light, a gaussian filter; 48 x
             32, 8 spp) through tools/tungsten2scene.py, on the general fork
             against tests/golden/tungsten_converted_48x32_8spp.exr at that
             file's _check tolerance (mean |d| < 2e-5, max < 2e-3) with the
             brute kernels once a bounce and nothing else, the brute kernels
             on its first two bounces bit for bit against their plain
             versions; on its default route (the fused kernel's ray-input
             mode, one launch a sample, nothing else) by the fused goldens'
             rule (the mean within 0.5%, each sample against the general
             fork by the rule of phase 3), the kernel on one sample bit for
             bit; tools/tonemap.py's operators on the card against the CPU
             within 1e-6 and its main to a PNG
Then a {"kernels": [...]} line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, fp32 outside tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# arithmetic operations (add, sub, mul, div) of one Moller-Trumbore row test
FLOPS_PER_ROW = 46
# ... of a test that ends early (chip_smoke.py brute_work): p, det, tvec, the
# u numerator, 1 / det and u; then q and v; then u + v
OPS_TO_U, OPS_TO_V, OPS_TO_SUM = 24, 39, 40
# ... of one ray / sphere quadric test
FLOPS_PER_SPHERE = 17
# ... of one node pop of the cluster walk: safe-inverse-scaled slab test
# (6 sub, 6 mul, 12 min / max, 1 compare) and the child decode
FLOPS_PER_NODE = 20
# ... of one Woop row test (ops/subpacket.py woop_tests), a fused
# multiply-add counted as 2: o' 3 x 6, d' 3 x 5, t 1, u 2, v 2, u + v 1
FLOPS_PER_WOOP_ROW = 39
# float operations of one bounce's shading, counted by hand from
# csrc/fused_path.cu (+, -, *, /, sqrt and each transcendental one
# operation; where a draw picks one of several lobes, the cheapest): the
# part every surface type runs (interaction, emission, frame, NEE light
# sample and shadow-ray spawn, the continuation ray, throughput and
# roulette), and per type its two BSDF evaluations and one sample
FLOPS_SHADE_COMMON = 330
# ... of it, the area-light sample (csrc/fused_path.cu area_light_point and
# area_light_pdf: the entry and triangle picks, the point, the pdf), which
# the environment mode runs only where NEE picks an area light, and there
# with 2 more for u_sel's rest; and the environment pick's far point
FLOPS_AREA_PICK = 32
FLOPS_ENV_PICK = 6
FLOPS_BSDF = {"matte": 70, "mirror": 367, "metal": 511, "plastic": 480, "glass": 703,
              "disney": 544}
# the surface types' codes in the instance table (ops/fused_bsdf.py ST_*)
SURFACE_TYPES = {0: "matte", 1: "mirror", 2: "metal", 3: "plastic", 4: "glass", 6: "disney"}
# every shaded lane counted as matte (FLOPS_SHADE_COMMON + FLOPS_BSDF["matte"]),
# the bound this script gave before it counted types; fused_bound reports it
# beside the typed one, so the two stay comparable
FLOPS_SHADE_BOUNCE = 400
# the ray-input mode's ray a lane (ops/fused_path.py RAY_WORDS): origin,
# direction, t_min, t_max, camera weight, sampler state
RAY_BYTES = 40
# clock cycles of the spin kernel that the timed launches queue behind:
# ~0.1 s at the H100's 1.98 GHz boost clock
SPIN_CYCLES = 200_000_000
MAIN_SCENE = ROOT / "scenes" / "cornell.json"
MATERIALS = ROOT / "scenes" / "materials.json"
GOLDEN = ROOT / "tests" / "golden" / "cornell_64_8spp.exr"
MATERIALS_GOLDEN = ROOT / "tests" / "golden" / "materials_48_8spp.exr"
SPHERE_GOLDEN = ROOT / "tests" / "golden" / "cornell_sphere_48_8spp.exr"
MESH_HEAVY = dict(res=(1280, 720), spp=4, depth=5, n=5, subdiv=5)
GENERAL_SPHERE = {"impl": "sphere", "prop": {
    "analytic": False, "subdivision": 2, "surface": {"impl": "matte", "prop": {}},
    "transform": {"impl": "srt", "prop": {"scale": [100, 100, 100],
                                          "translate": [400, 100, 300]}}}}


def emit(obj):
    print(json.dumps(obj), flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def reset_counts(brute, fused_path):
    from luisarender_tpu_torch.ops import cluster, subpacket, trace, wide8

    brute.closest_launches = brute.any_launches = 0
    for mod in (cluster, wide8, subpacket):
        mod.closest_launches = mod.any_launches = 0
    trace.launches = 0
    fused_path.launches = fused_path.env_launches = fused_path.persistent_launches = 0
    fused_path.ray_launches = fused_path.ray_env_launches = 0


def read_counts(brute, fused_path):
    from luisarender_tpu_torch.ops import cluster, subpacket, trace, wide8

    counts = {"brute_closest": brute.closest_launches, "brute_any": brute.any_launches}
    for name, mod in (("cluster", cluster), ("wide8", wide8), ("subpacket", subpacket)):
        counts[f"{name}_closest"] = mod.closest_launches
        counts[f"{name}_any"] = mod.any_launches
    counts["trace_closest"] = trace.launches
    counts["fused_path"] = fused_path.launches
    counts["fused_path_env"] = fused_path.env_launches
    counts["fused_path_persistent"] = fused_path.persistent_launches
    counts["fused_path_rays"] = fused_path.ray_launches
    counts["fused_path_rays_env"] = fused_path.ray_env_launches
    return counts


@contextmanager
def routes(wide=False, sub=False):
    """The opt-in trace routes (LR_WIDE8 / LR_SUBPACKET) switched as given
    for the body, as the environment variables switch them at import."""
    from luisarender_tpu_torch.ops import subpacket, wide8

    saved = wide8.ENABLED, subpacket.ENABLED
    wide8.ENABLED, subpacket.ENABLED = wide, sub
    try:
        yield
    finally:
        wide8.ENABLED, subpacket.ENABLED = saved


def frac_off(a, b):
    return float((np.abs(np.asarray(a) - np.asarray(b)).max(-1) > 1e-3).mean())


# --------------------------------------------------------------------------
# phase 3 helpers
# --------------------------------------------------------------------------


def device_ms(torch, fn, iters=100):
    """Device time per call of fn, a kernel wrapper: CUDA events around
    `iters` calls queued behind a spin kernel, so that the interval holds
    the calls' device work and none of the host's dispatch. Fails when the
    card reached the first event before the host had queued every call,
    even behind a spin four times as long."""
    for _ in range(min(5, iters)):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for spin in (SPIN_CYCLES, 4 * SPIN_CYCLES):
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_in_time = not start.query()
        end.synchronize()
        if queued_in_time:
            return start.elapsed_time(end) / iters
    raise SmokeFailure("the host could not queue the timed launches ahead of the card")


def device_events(prof):
    """Averaged profiler events that ran on the card (kernels, copies)."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.device_time_total > 0]


def events_ms(torch, fn, iters):
    """Wall time per call of fn between CUDA events, host dispatch included
    (the plain versions are hundreds of small launches)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def brute_work(torch, brute, kind, o, d, t_min, t_max, table):
    """(rows, ops) per lane: the rows the function needs and the arithmetic
    operations of their tests. A live lane (closest: t_min < min(t_max,
    3e38); any-hit: t_min < t_max) tests, closest, every valid row; any-hit,
    the valid opaque rows (the only ones that can occlude) in table order up
    to and including the first occluder. A row's test ends at its first
    failed check of the plain arithmetic (ops/brute.py mt_uvt): u outside
    [0, 1] after OPS_TO_U operations, v < 0 after OPS_TO_V, u + v > 1 after
    OPS_TO_SUM, else FLOPS_PER_ROW. A dead lane needs none."""
    ox, oy, oz = o.unbind(-1)
    dx, dy, dz = d.unbind(-1)
    keep = table[:, 9] > 0.0
    if kind == "any":
        keep = keep & (table[:, 10] > 0.0)
        open_ = t_min < t_max
    else:
        open_ = t_min < torch.where(t_max < 3e38, t_max, 3e38)
    rows = torch.zeros(t_min.shape, dtype=torch.int64, device=o.device)
    ops = torch.zeros_like(rows)
    for r in brute.table_rows(table[keep]):
        _, inside, t, u, v = brute.mt_uvt(*r[:9], ox, oy, oz, dx, dy, dz)
        pu = (u >= 0.0) & (u <= 1.0)
        pv = pu & (v >= 0.0)
        ps = pv & (u + v <= 1.0)
        cost = (OPS_TO_U + (OPS_TO_V - OPS_TO_U) * pu.long() + (OPS_TO_SUM - OPS_TO_V) * pv.long()
                + (FLOPS_PER_ROW - OPS_TO_SUM) * ps.long())
        rows += open_.long()
        ops += torch.where(open_, cost, 0)
        if kind == "any":
            open_ = open_ & ~(inside & (t > t_min) & (t < t_max))
    return rows, ops


def kernel_bounds(torch, kind, rows, ops, table):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations over fp32 peak, counting what these inputs need (brute_work's
    rows and ops per lane): t_min, t_max and the outputs of every lane, the
    rays of live lanes only, the table once."""
    out_bytes = 16 if kind == "closest" else 1
    live = int((rows > 0).sum())
    nbytes = rows.shape[0] * (4 + 4 + out_bytes) + live * (12 + 12) + table.numel() * 4
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = int(ops.sum()) / PEAK_FP32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def brute_lanes(torch, brute, launch, device):
    """A brute kernel's lane counters on one launch(counters) (ops/brute.py
    COUNTERS), with the live share of the row loop's lane-slots and the
    share of warp row steps that went past the u test."""
    ctr = torch.zeros(len(brute.COUNTERS), dtype=torch.int64, device=device)
    launch(ctr)
    c = dict(zip(brute.COUNTERS, (int(x) for x in ctr.tolist())))
    c["live_share"] = c["tests"] / max(c["slots"], 1)
    c["deep_share"] = c["deep_slots"] / max(c["slots"], 1)
    return c


def compare_case(torch, brute, kind, args):
    """Kernel against plain on one input set. Both are built to do the same
    IEEE operations in the same order (nvcc --fmad=false, no fast math), so
    every output must agree bit for bit. Returns ([max |dt|, |du|, |dv|] or
    [max |d occ|], the hit fraction)."""
    if kind == "closest":
        kt, ks, ku, kv = brute.closest(*args)
        pt, ps, pu, pv = brute.closest_plain(*args)
        check(torch.equal(ks, ps), "closest: slots differ from the plain version")
        hit = ks >= 0
        check(torch.equal(torch.isinf(kt), ~hit), "closest: miss lanes without t = inf")
        errs = [float((kt[hit] - pt[hit]).abs().max()) if hit.any() else 0.0,
                float((ku - pu).abs().max()), float((kv - pv).abs().max())]
        check(max(errs) == 0.0 and torch.equal(kt, pt),
              f"closest: t, u, v differ from the plain version: {errs}")
        return errs, float(hit.float().mean())
    occ_k = brute.any_hit(*args)
    occ_p = brute.any_plain(*args)
    err = float((occ_k.long() - occ_p.long()).abs().max())
    check(err == 0.0, f"any: occlusion differs from the plain version "
                      f"on {int((occ_k != occ_p).sum())} lanes")
    return [err], float(occ_k.float().mean())


def hold_brute_inputs(torch, brute, cap):
    """The brute kernels on captured inputs (capture_main_path_inputs), bit
    for bit against their plain versions; device ms of each input."""
    kern = {}
    for kind in ("closest", "any"):
        fn_k = brute.closest if kind == "closest" else brute.any_hit
        errs, ms = [], []
        for args in cap[kind]:
            errs.append(max(compare_case(torch, brute, kind, args)[0]))
            ms.append(device_ms(torch, lambda: fn_k(*args), iters=20))
        kern[kind] = {"inputs": len(cap[kind]), "max_abs_err": max(errs), "ms": ms,
                      "sample_ms": sum(ms)}
    return kern


def random_case(torch, device, p, n, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    centers = torch.randn((p, 3), device=device, generator=gen) * 300.0
    verts = centers[:, None, :] + torch.randn((p, 3, 3), device=device, generator=gen) * 40.0
    table = torch.zeros((p, 16), device=device)
    table[:, 0:3] = verts[:, 0]
    table[:, 3:6] = verts[:, 1] - verts[:, 0]
    table[:, 6:9] = verts[:, 2] - verts[:, 0]
    table[:, 9] = 1.0
    table[:, 10] = (torch.rand(p, device=device, generator=gen) < 0.7).float()
    o = torch.randn((n, 3), device=device, generator=gen) * 400.0
    target = centers[torch.randint(0, p, (n,), device=device, generator=gen)]
    d = target - o
    d = d / d.norm(dim=-1, keepdim=True)
    t_min = torch.zeros(n, device=device)
    t_max = torch.full((n,), float("inf"), device=device)
    t_max[torch.rand(n, device=device, generator=gen) < 0.25] = 0.0
    return (o.contiguous(), d.contiguous(), t_min, t_max, table.contiguous())


def capture_main_path_inputs(torch, brute, compiled, scene, max_depth=2):
    """The trace kernels' inputs on the general fork (`brute` is the trace
    module the scene routes to: ops/brute.py or ops/cluster.py): one sample
    of every pixel, `max_depth` bounces; returns {'closest': [camera rays,
    bounce-1 rays, ...], 'any': [the shadow rays of bounce 0, of bounce 1,
    ...]}."""
    from luisarender_tpu_torch.integrators.mega_path import (
        general_path_trace_batch, pixel_grid,
    )

    captured = {"closest": [], "any": []}
    orig_closest, orig_any = brute.closest, brute.any_hit

    def rec_closest(*args):
        captured["closest"].append(tuple(a.clone() for a in args))
        return orig_closest(*args)

    def rec_any(*args):
        captured["any"].append(tuple(a.clone() for a in args))
        return orig_any(*args)

    w, h = scene.cameras[0].film.resolution
    pixel_xy = pixel_grid(w, h, compiled.device)
    integ = scene.integrator
    brute.closest, brute.any_hit = rec_closest, rec_any
    try:
        general_path_trace_batch(compiled, scene.cameras[0], integ.sampler,
                                 integ.light_sampler, pixel_xy, 0, max_depth=max_depth,
                                 rr_depth=integ.rr_depth, rr_threshold=integ.rr_threshold)
    finally:
        brute.closest, brute.any_hit = orig_closest, orig_any
    check(len(captured["closest"]) == max_depth == len(captured["any"]),
          f"expected {max_depth} bounces of inputs, got {len(captured['closest'])}")
    return captured


def general_scene(lt):
    """The general fork's brute-force scene: testing.cornell_box (512^2,
    depth 8) plus GENERAL_SPHERE, 352 triangles, more than the fused kernel
    covers and no more than the brute kernels take."""
    from luisarender_tpu_torch import testing

    d = testing.cornell_box(resolution=(512, 512), spp=32, depth=8)
    d["render"]["shapes"].append(GENERAL_SPHERE)
    return lt.Scene.from_dict(d)


def general_inputs(torch, lt, brute, device):
    """The brute kernels' inputs of one sample of the general scene, every
    bounce: {'closest': [8 inputs], 'any': [8 inputs]}, 512^2 lanes and 352
    rows each."""
    scene = general_scene(lt)
    compiled = lt.compile_scene(scene, device=device)
    check(not compiled.plan.fused_path and compiled.plan.num_tris == 352,
          f"general scene: fused {compiled.plan.fused_path}, {compiled.plan.num_tris} triangles")
    return capture_main_path_inputs(torch, brute, compiled, scene, max_depth=8)


def phase_brute_kernels(torch, lt, brute, device):
    """Both brute kernels on every input of one sample of the general scene
    (8 bounces: 8 closest, 8 any-hit inputs, 352 rows) and, as secondary
    cases, on two bounces of scenes/cornell.json (32 rows, the size of the
    golden phase's general-fork tables) and a random 512-row table with a
    ragged ray count: bit for bit against the plain versions; per 352-row
    input and 32-row input the device time, the bound, the live share of
    lanes and the kernel's lane counters beside the share one thread a lane
    would give (simt_share of the rows each lane needs). The sum over the 16
    352-row launches is the brute kernels' device time of one sample."""
    cap = general_inputs(torch, lt, brute, device)
    n_main = cap["closest"][0][0].shape[0]
    check(n_main == 512 * 512, f"main path has {n_main} rays, expected 512^2")
    scene = lt.load_scene(str(MAIN_SCENE))
    small = capture_main_path_inputs(torch, brute, lt.compile_scene(scene, device=device),
                                     scene)
    rnd = random_case(torch, device, p=512, n=512 * 512 - 77, seed=7)
    results = {}
    for kind in ("closest", "any"):
        fn_k = brute.closest if kind == "closest" else brute.any_hit
        fn_p = brute.closest_plain if kind == "closest" else brute.any_plain
        cases = {f"bounce{b}": args for b, args in enumerate(cap[kind])}
        cases.update({"cornell32_camera": small[kind][0], "cornell32_bounce1": small[kind][1],
                      "random512": rnd})
        errs, fracs, times = {}, {}, {}
        for name, args in cases.items():
            errs[name], fracs[name] = compare_case(torch, brute, kind, args)
            if name == "random512":
                continue
            rows, ops = brute_work(torch, brute, kind, *args)
            bound_ms, bound_by = kernel_bounds(torch, kind, rows, ops, args[4])
            times[name] = {"ms": device_ms(torch, lambda: fn_k(*args), iters=20),
                           "plain_ms": events_ms(torch, lambda: fn_p(*args), iters=2),
                           "bound_ms": bound_ms, "bound_by": bound_by,
                           "rows": int(args[4].shape[0]),
                           "live_share_of_lanes": float((rows > 0).float().mean()),
                           "lanes": brute_lanes(torch, brute,
                                                lambda ctr: fn_k(*args, counters=ctr), device),
                           "simt_share_one_thread_a_lane": simt_share(rows)}
        args = cases["bounce1"]
        times["bounce1"]["profiler_ms"] = profile_one(
            torch, lambda: fn_k(*args), (f"{kind}_kernel",), 100)["kernels_ms"]
        sample = [times[f"bounce{b}"] for b in range(len(cap[kind]))]
        results[kind] = {"errors": errs, "hit_fraction": fracs, "times": times,
                         "sample_ms": sum(t["ms"] for t in sample),
                         "sample_bound_ms": sum(t["bound_ms"] for t in sample),
                         "max_abs_err": max(max(v) for v in errs.values())}
        emit({"phase": "kernels", "kernel": kind, "n": n_main,
              "rows": int(cap[kind][0][4].shape[0]), **results[kind]})
    emit({"phase": "kernels", "kernel": "brute", "sample_launches": 16,
          "sample_ms": results["closest"]["sample_ms"] + results["any"]["sample_ms"],
          "sample_bound_ms": (results["closest"]["sample_bound_ms"]
                              + results["any"]["sample_bound_ms"])})
    return results


def simt_share(lane_bounces):
    """The share of lane-slots a one-thread-per-pixel kernel would issue to
    live paths: lanes in warps of 32 in pixel order, each warp running as
    many bounce iterations as its longest-running lane."""
    b = lane_bounces.double()
    b = np.pad(b.cpu().numpy(), (0, -b.shape[0] % 32)).reshape(-1, 32)
    return float(b.sum() / (32 * b.max(1).sum()))


@contextmanager
def plain_counted(torch, fp, tables, pxy, env=None):
    """Counts the work of the plain version's runs inside the block (its
    environment mode with `env`) that the kernel must do: closest rays,
    the lanes shaded (and those at a surface by its type), and shadow rays
    (occluded ones, which the kernel stops at their first occluder, count
    one row); with `env`, the surface lanes whose NEE picks the environment
    (u_sel < p_env, the bounce's first draw), those of them whose candidate
    has pdf > 0, and those that pick an area light; and the path-length
    SIMT share of one thread a pixel in pixel order (simt_share). Yields
    the counts, complete when the block ends."""
    from luisarender_tpu_torch.core import rng

    counts = {"closest": 0, "shaded": 0, "shadow_open": 0, "shadow_occluded": 0}
    if env is not None:
        counts.update(env_picked=0, env_pdf_positive=0, area_picked=0)
    by_type = torch.zeros(8, dtype=torch.int64, device=pxy.device)
    lane_bounces = torch.zeros(pxy.shape[0], dtype=torch.int64, device=pxy.device)
    orig_bounce, orig_closest, orig_occ = fp._Plain.bounce, fp._Plain.closest, fp._Plain.occluded

    def bounce(self, s, dep, nrays, dep_i=0):
        self._active = s["active"]
        self._dep_i = dep_i
        self._u_sel = rng.lcg_step(s["st"])[1]
        counts["closest"] += int(s["active"].sum())
        lane_bounces.add_(s["active"].long())
        return orig_bounce(self, s, dep, nrays, dep_i)

    def closest(self, o, d, tmin, tmax):
        out = orig_closest(self, o, d, tmin, tmax)
        hit = out[0] & self._active
        counts["shaded"] += int(hit.sum())
        rows = tables.inst[out[6].long().clamp(0, tables.inst.shape[0] - 1)]
        surf = hit & (rows[:, 18] > 0.5)
        by_type.add_(torch.bincount(rows[surf, 0].long(), minlength=8)[:8])
        if env is not None:
            pick = surf & (self._u_sel < self.p_env)
            counts["env_picked"] += int(pick.sum())
            counts["env_pdf_positive"] += int((pick & (env.cand[self._dep_i, 3] > 0.0)).sum())
            if tables.n_entry > 0:
                counts["area_picked"] += int((surf & ~pick).sum())
        return out

    def occluded(self, so, sd, s_tmax):
        occ = orig_occ(self, so, sd, s_tmax)
        pending = s_tmax > 0.0
        counts["shadow_open"] += int((pending & ~occ).sum())
        counts["shadow_occluded"] += int((pending & occ).sum())
        return occ

    fp._Plain.bounce, fp._Plain.closest, fp._Plain.occluded = bounce, closest, occluded
    try:
        yield counts
    finally:
        fp._Plain.bounce, fp._Plain.closest, fp._Plain.occluded = orig_bounce, orig_closest, orig_occ
    counts["shaded_by_type"] = {name: int(by_type[code]) for code, name in SURFACE_TYPES.items()
                                if int(by_type[code])}
    counts["simt_share_pixel_order"] = simt_share(lane_bounces)


def fused_work(torch, fp, tables, cam, pxy, n_samples, kw, env=None, rays=None):
    """The plain version's run (its environment mode with `env`, its
    ray-input mode from `rays`, pxy then only giving the lane count), timed
    with CUDA events, and its work counted (plain_counted). Returns
    (outputs, counts, ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with plain_counted(torch, fp, tables, pxy, env) as counts:
        start.record()
        out = fp.paths_plain(tables, cam, None if rays is not None else pxy, 0, n_samples,
                             env=env, rays=rays, **kw)
        end.record()
        end.synchronize()
    return out, counts, start.elapsed_time(end)


def fused_bound(tables, counts, n, env=False, rays=False):
    """The least time of the fused kernel's work: the larger of its
    operations over fp32 peak and its bytes over the memory rate (pixel ids
    in and rgb and a ray count out, 24 B a lane; in the ray-input mode the
    ray in place of the pixel ids, RAY_BYTES, so 56 B a lane; in the
    environment mode also the escape state written once, 7 words a lane,
    and the candidates that NEE picks read once: the pdf word of each, and
    the other 6 words where the pdf is > 0). Neither mode is charged the
    camera's arithmetic. Shading is counted per surface type of the
    shaded lanes (FLOPS_BSDF); in the environment mode the area-light
    sample only where NEE picks an area light, and the environment's far
    point where it picks the environment. `matte_*` counts every shaded
    lane as matte (the earlier bound). Returns {bound_ms, bound_by, flops,
    bytes, matte_bound_ms, matte_flops}."""
    tri = tables.tri
    rows = int((tri[:, 9] != 0).sum())
    shadow_rows = int(((tri[:, 9] != 0) & (tri[:, 10] != 0)).sum())
    n_sph = tables.sph.shape[0]
    trace = (counts["closest"] * (rows * FLOPS_PER_ROW + n_sph * FLOPS_PER_SPHERE)
             + counts["shadow_open"] * (shadow_rows * FLOPS_PER_ROW + n_sph * FLOPS_PER_SPHERE)
             + counts["shadow_occluded"] * FLOPS_PER_ROW)
    flops = trace + sum(k * (FLOPS_SHADE_COMMON + FLOPS_BSDF[name])
                        for name, k in counts["shaded_by_type"].items())
    matte = trace + counts["shaded"] * FLOPS_SHADE_BOUNCE
    n_bytes = n * (RAY_BYTES + 16 if rays else 24)
    if env:
        picks = (counts["area_picked"] * (FLOPS_AREA_PICK + 2)
                 + counts["env_picked"] * FLOPS_ENV_PICK
                 - sum(counts["shaded_by_type"].values()) * FLOPS_AREA_PICK)
        flops += picks
        matte += picks
        n_bytes += n * 7 * 4 + counts["env_picked"] * 4 + counts["env_pdf_positive"] * 6 * 4
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_PER_S * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "flops": flops, "bytes": n_bytes,
            "matte_bound_ms": max(matte / PEAK_FP32_PER_S * 1e3, t_bytes),
            "matte_flops": matte}


def lane_use(stats):
    """The fused kernel's counters (ops/fused_path.py STATS) as shares: live
    lanes of the trace phase's lane-slots, surface-shaded lanes of the shade
    phase's, and distinct shade keys a warp pass."""
    from luisarender_tpu_torch.ops.fused_path import STATS

    c = dict(zip(STATS, (int(x) for x in stats.tolist())))
    c["trace_lane_share"] = c["traced"] / max(c["lane_slots"], 1)
    c["shade_lane_share"] = c["shaded"] / max(c["shade_slots"], 1)
    c["keys_per_warp_pass"] = c["keys"] / max(c["shade_slots"] // 32, 1)
    return c


def fused_case(torch, lt, fp, path, depth, device):
    """(tables, camera parameters, pixel grid, keyword arguments) of one
    fused scene file at its own resolution and the given depth."""
    from luisarender_tpu_torch.integrators.mega_path import pixel_grid

    scene = lt.load_scene(str(path))
    compiled = lt.compile_scene(scene, device=device)
    check(compiled.plan.fused_path, f"{path.name}: the fused kernel does not cover it")
    cam = fp.camgen_params(scene.cameras[0], scene.integrator.sampler.seed)
    w, h = scene.cameras[0].film.resolution
    kw = dict(max_depth=depth, rr_depth=scene.integrator.rr_depth,
              rr_threshold=scene.integrator.rr_threshold)
    return fp.fused_tables(compiled), cam, pixel_grid(w, h, device), kw


def bit_equal(torch, what, rgb_k, rays_k, rgb_p, rays_p):
    """Kernel against plain on every lane: rgb and ray counts bit for bit
    (both do the same float32 operations in the same order per lane). Returns
    (share of lanes bit-equal, max |d rgb|, lanes whose ray count differs)."""
    share = float((rgb_k == rgb_p).all(-1).float().mean())
    err = float((rgb_k - rgb_p).abs().max())
    rays_off = int((rays_k != rays_p).sum())
    check(share == 1.0 and err == 0.0 and rays_off == 0,
          f"{what}: {share:.6f} of lanes bit-equal, max |d rgb| {err}, "
          f"{rays_off} lanes with other ray counts")
    return share, err, rays_off


def phase_fused_kernel(torch, lt, fp, device):
    """The fused kernel on one 512^2 sample of materials (depth 10) and
    cornell (depth 8), and on a pass of 4 samples (persistent mode): bit for
    bit against the plain version on every lane, the persistent pass within
    1e-6 of the sum of 4 one-sample launches; times, bounds (typed and
    matte-only), and lane use from the kernel's counters beside the
    path-length SIMT share of one thread a pixel (from the plain version)."""
    results = {}
    for path, depth in ((MATERIALS, 10), (MAIN_SCENE, 8)):
        tables, cam, pxy, kw = fused_case(torch, lt, fp, path, depth, device)
        rec = {"phase": "kernels", "kernel": "fused_path", "scene": path.name,
               "n": pxy.shape[0], "depth": depth}
        for mode, ns in (("megapath", 0), ("persistent", 4)):
            rgb_k, rays_k = fp.paths(tables, cam, pxy, 0, ns, **kw)
            torch.cuda.synchronize()
            (rgb_p, rays_p), counts, plain_ms = fused_work(torch, fp, tables, cam, pxy, ns, kw)
            share, err, _ = bit_equal(torch, f"fused {path.name} {mode}", rgb_k, rays_k,
                                      rgb_p, rays_p)
            check(bool(torch.isfinite(rgb_k).all()) and float(rgb_k.mean()) > 0.0,
                  f"fused {path.name} {mode}: non-finite or black")
            # launches queued back to back, each with its work counter reset
            again = [fp.paths(tables, cam, pxy, 0, ns, **kw) for _ in range(20)]
            torch.cuda.synchronize()
            check(all(torch.equal(a, rgb_k) and torch.equal(b, rays_k) for a, b in again),
                  f"fused {path.name} {mode}: back-to-back launches differ")
            del again
            stats = torch.zeros(len(fp.STATS), dtype=torch.int64, device=device)
            fp.paths(tables, cam, pxy, 0, ns, stats=stats, **kw)
            use = lane_use(stats)
            check(use["traced"] == counts["closest"],
                  f"fused {path.name} {mode}: traced {use['traced']} != {counts['closest']}")
            ms = device_ms(torch, lambda: fp.paths(tables, cam, pxy, 0, ns, **kw),
                           iters=20 if ns == 0 else 10)
            m = {"rays": int(rays_k.sum()), "rays_plain": int(rays_p.sum()),
                 "share_bit_equal": share, "max_abs_err": err, "work": counts,
                 "ms": ms, "plain_ms": plain_ms, **fused_bound(tables, counts, pxy.shape[0]),
                 "lane_use": use}
            if ns:
                # 4 samples in one launch == the sum of 4 one-sample launches
                tot = sum(fp.paths(tables, cam, pxy, s, 0, **kw)[0] for s in range(ns))
                m["max_abs_err_vs_sum"] = float((rgb_k - tot).abs().max())
                check(m["max_abs_err_vs_sum"] <= 1e-6, f"persistent {path.name}: off the "
                      f"summed samples by {m['max_abs_err_vs_sum']}")
                m["samples"] = ns
                rec["persistent"] = m
            else:
                m["profiler_ms"] = profile_one(
                    torch, lambda: fp.paths(tables, cam, pxy, 0, 0, **kw),
                    ("fused_path_kernel",), 20)["kernels_ms"]
                rec.update(m)
        emit(rec)
        results[path.name] = rec
    return results


def env_scene(lt, kind, res=512, spp=1, depth=8, integrator="megapath"):
    """testing.cornell_box with an environment: `spherical` the constant map
    of the reference's TestFusedEnvironment (tests/test_fused_path.py:
    269-277), `directional` a 10-degree cone of light into the box's open
    front, `env_only` the map [1.0, 0.8, 0.6] with the light quads removed
    (tests/test_fused_path.py:296-310), `nishitasky` the sky of
    scenes/sky.json, `image` an EXR sky with a bright sun (testing
    env_spot_exr): the last two are maps that are not constant, sampled
    through their alias tables."""
    from luisarender_tpu_torch import testing

    d = testing.cornell_box(resolution=(res, res), spp=spp, depth=depth, integrator=integrator)
    const = lambda v: {"impl": "constant", "prop": {"v": v}}  # noqa: E731
    if kind == "nishitasky":
        env = {"impl": "spherical", "prop": {"emission": {
            "impl": "nishitasky", "prop": {"sun_direction": [0.4, 0.35, 0.85]}}}}
    elif kind == "image":
        env = {"impl": "spherical", "prop": {"emission": {
            "impl": "image", "prop": {"file": testing.env_spot_exr()}}}}
    elif kind == "directional":
        env = {"impl": "directional", "prop": {"emission": const([3.0, 2.8, 2.5]),
                                                "direction": [0.15, 0.35, -1.0], "angle": 10.0}}
    elif kind == "env_only":
        d["render"]["shapes"] = [sh for sh in d["render"]["shapes"]
                                 if "light" not in sh.get("prop", {})]
        env = {"impl": "spherical", "prop": {"emission": const([1.0, 0.8, 0.6])}}
    else:
        env = {"impl": "spherical", "prop": {"emission": const([0.4, 0.5, 0.7])}}
    d["render"]["environment"] = env
    return lt.Scene.from_dict(d)


ENV_SCENES = ("spherical", "directional", "env_only", "nishitasky", "image")


def phase_fused_env(torch, lt, fp, device):
    """The fused kernel's environment mode against its plain version on one
    512^2 sample, depth 8, of each ENV_SCENES scene: rgb, rays and the
    7 escape words bit for bit on every lane, 20 launches queued back to
    back equal to the first; the kernel's device time, bound (the
    candidates and escape state counted in its bytes) and lane use, and the
    candidates' and the miss pass's device times beside it."""
    from luisarender_tpu_torch.integrators.mega_path import pixel_grid

    results = {}
    depth = 8
    for kind in ENV_SCENES:
        scene = env_scene(lt, kind, depth=depth)
        compiled = lt.compile_scene(scene, device=device)
        check(compiled.plan.fused_path and compiled.plan.has_environment,
              f"env {kind}: not on the fused kernel's environment mode")
        integ = scene.integrator
        cam = fp.camgen_params(scene.cameras[0], integ.sampler.seed)
        pxy = pixel_grid(512, 512, device)
        kw = dict(max_depth=depth, rr_depth=integ.rr_depth, rr_threshold=integ.rr_threshold)
        tables = fp.fused_tables(compiled)
        p_env = integ.light_sampler.selection_probs(compiled)[0]
        cand = fp.env_nee_candidates(compiled, cam, pxy, 0, depth, p_env)
        env = fp.EnvInputs(cand, p_env, compiled.plan.env_distance)
        rgb_k, rays_k, esc_k = fp.paths(tables, cam, pxy, 0, 0, env=env, **kw)
        torch.cuda.synchronize()
        (rgb_p, rays_p, esc_p), counts, plain_ms = fused_work(torch, fp, tables, cam, pxy, 0,
                                                              kw, env=env)
        share, err, _ = bit_equal(torch, f"fused env {kind}", rgb_k, rays_k, rgb_p, rays_p)
        esc_share = float((esc_k == esc_p).all(0).float().mean())
        esc_err = float((esc_k - esc_p).abs().max())
        check(esc_share == 1.0 and esc_err == 0.0,
              f"fused env {kind}: escape state {esc_share:.6f} of lanes bit-equal, "
              f"max diff {esc_err}")
        escaped = int((esc_k[3] > 0.0).sum())
        check(escaped > 0, f"fused env {kind}: no path escaped")
        rgb = fp.miss_pass(compiled, rgb_k, esc_k, p_env)
        check(bool(torch.isfinite(rgb).all()) and float(rgb.mean()) > 0.0,
              f"fused env {kind}: non-finite or black")
        again = [fp.paths(tables, cam, pxy, 0, 0, env=env, **kw) for _ in range(20)]
        torch.cuda.synchronize()
        check(all(torch.equal(a, rgb_k) and torch.equal(b, rays_k) and torch.equal(c, esc_k)
                  for a, b, c in again), f"fused env {kind}: back-to-back launches differ")
        del again
        stats = torch.zeros(len(fp.STATS), dtype=torch.int64, device=device)
        fp.paths(tables, cam, pxy, 0, 0, env=env, stats=stats, **kw)
        use = lane_use(stats)
        check(use["traced"] == counts["closest"],
              f"fused env {kind}: traced {use['traced']} != {counts['closest']}")
        ms = device_ms(torch, lambda: fp.paths(tables, cam, pxy, 0, 0, env=env, **kw), iters=20)
        # the candidates and the miss pass are PyTorch ops that wait for the
        # card on the way (a scalar's copy to it), so no spin can queue them:
        # CUDA events around the calls (host dispatch included), and the
        # profiler's device time of their kernels beside
        def candidates():
            return fp.env_nee_candidates(compiled, cam, pxy, 0, depth, p_env)

        def miss():
            return fp.miss_pass(compiled, rgb_k, esc_k, p_env)

        cand_ms = events_ms(torch, candidates, 5)
        miss_ms = events_ms(torch, miss, 20)
        cand_dev = profile_one(torch, candidates, ("",), 3)
        miss_dev = profile_one(torch, miss, ("",), 10)
        rec = {"phase": "kernels", "kernel": "fused_path_env", "scene": f"cornell_box+{kind}",
               "n": pxy.shape[0], "depth": depth, "p_env": p_env,
               "env_distance": compiled.plan.env_distance,
               "rays": int(rays_k.sum()), "rays_plain": int(rays_p.sum()),
               "escaped_lanes": escaped, "share_bit_equal": share, "max_abs_err": err,
               "escape_share_bit_equal": esc_share, "work": counts, "ms": ms,
               "plain_ms": plain_ms, **fused_bound(tables, counts, pxy.shape[0], env=True),
               "candidates_ms": cand_ms, "candidates_device_ms": cand_dev["device_busy_ms"],
               "candidates_device_ops": cand_dev["device_ops"],
               "candidate_bytes": cand.numel() * 4, "miss_pass_ms": miss_ms,
               "miss_pass_device_ms": miss_dev["device_busy_ms"], "lane_use": use,
               "blocks_per_sm": fp.blocks_per_sm(device, env=True)}
        emit(rec)
        results[kind] = rec
    return results


# the ray-input scenes' camera: a thin lens whose 33.6 mm focal length on
# the 24 mm sensor gives the pinhole's 39.3 degree field, focused on the
# box's centre, at f/0.005 (a lens radius of 3.36 scene units)
THINLENS = {"focal_length": 33.6, "focus_position": [278.0, 273.0, 279.6], "aperture": 0.005}
RAY_SCENES = ("thinlens", "mitchell_clip", "env_thinlens")


def ray_scene(lt, kind, res=512, spp=1, depth=8, integrator="megapath"):
    """The scenes of the fused kernel's ray-input mode: `thinlens`
    scenes/cornell.json with the thin-lens camera above and a gaussian
    filter (its defaults); `mitchell_clip` scenes/cornell.json with a
    mitchell filter and a clip plane at depth 1000 (the camera stands 800
    in front of the box, so the near plane culls its front fifth);
    `env_thinlens` testing.cornell_box with the constant spherical
    environment [0.4, 0.5, 0.7] and the thin-lens camera and gaussian
    filter."""
    from luisarender_tpu_torch import testing

    if kind == "env_thinlens":
        d = testing.cornell_box(resolution=(res, res), spp=spp, depth=depth,
                                integrator=integrator)
        d["render"]["environment"] = {"impl": "spherical", "prop": {
            "emission": {"impl": "constant", "prop": {"v": [0.4, 0.5, 0.7]}}}}
    else:
        d = json.loads(MAIN_SCENE.read_text())
        d["render"]["integrator"] = {"impl": integrator, "prop": {"depth": depth}}
    cam = d["render"]["cameras"][0]
    cam["prop"]["film"]["prop"]["resolution"] = [res, res]
    cam["prop"]["spp"] = spp
    if kind == "mitchell_clip":
        cam["prop"]["filter"] = {"impl": "mitchell", "prop": {}}
        cam["prop"]["clip"] = [1000.0, 1e10]
    else:
        cam["impl"] = "thinlens"
        cam["prop"].pop("fov")
        cam["prop"].update(THINLENS)
        cam["prop"]["filter"] = {"impl": "gaussian", "prop": {}}
    return lt.Scene.from_dict(d)


def ray_inputs(fp, compiled, scene, pxy, sample_index, depth):
    """One sample's ray-input lanes of a scene, as the fused fork makes them
    (integrators/mega_path.py camera_rays, ops/fused_path.py pack_rays):
    (rays, state0, env inputs or None)."""
    from luisarender_tpu_torch.integrators.mega_path import camera_rays

    integ = scene.integrator
    state0, ray, weight = camera_rays(scene.cameras[0], integ.sampler, pxy, sample_index)
    rays = fp.pack_rays(ray, weight, state0)
    env = None
    if compiled.plan.has_environment:
        p_env = integ.light_sampler.selection_probs(compiled)[0]
        env = fp.EnvInputs(fp.env_nee_candidates_from_state(compiled, state0, depth, p_env),
                           p_env, compiled.plan.env_distance)
    return rays, state0, env


def phase_fused_rays(torch, lt, fp, device):
    """The fused kernel's ray-input mode against its plain version on one
    512^2 sample, depth 8, of the three ray_scene scenes: rgb, rays (and the
    escape words with the environment) bit for bit on every lane, 20
    launches back to back equal to the first; its time, bound (the 40 B ray
    a lane in its bytes) and lane use, and beside it the camera
    generation's time (the seed, the filter's and the lens's draws, the
    rays, pack_rays; with the environment also its candidates) and the miss
    pass's. Then the ray-input mode fed the camgen mode's own rays and
    states on scenes/cornell.json against the camgen kernel, bit for bit."""
    from luisarender_tpu_torch.integrators.mega_path import pixel_grid

    results = {}
    depth = 8
    pxy = pixel_grid(512, 512, device)
    for kind in RAY_SCENES:
        scene = ray_scene(lt, kind, depth=depth)
        compiled = lt.compile_scene(scene, device=device)
        integ = scene.integrator
        check(compiled.plan.fused_path
              and fp.camgen_params(scene.cameras[0], integ.sampler.seed) is None,
              f"rays {kind}: not on the fused kernel's ray-input mode")
        kw = dict(max_depth=depth, rr_depth=integ.rr_depth, rr_threshold=integ.rr_threshold)
        tables = fp.fused_tables(compiled)
        rays, _, env = ray_inputs(fp, compiled, scene, pxy, 0, depth)
        out_k = fp.paths_rays(tables, rays, env=env, **kw)
        torch.cuda.synchronize()
        out_p, counts, plain_ms = fused_work(torch, fp, tables, None, pxy, 0, kw, env=env,
                                             rays=rays)
        share, err, _ = bit_equal(torch, f"fused rays {kind}", out_k[0], out_k[1], out_p[0],
                                  out_p[1])
        rec = {"phase": "kernels", "kernel": "fused_path_rays" + ("_env" if env else ""),
               "scene": kind, "n": pxy.shape[0], "depth": depth,
               "rays": int(out_k[1].sum()), "rays_plain": int(out_p[1].sum()),
               "share_bit_equal": share, "max_abs_err": err,
               "cam_weight_min": float(rays[8].min()), "cam_weight_max": float(rays[8].max())}
        rgb = out_k[0]
        if env is not None:
            esc_share = float((out_k[2] == out_p[2]).all(0).float().mean())
            esc_err = float((out_k[2] - out_p[2]).abs().max())
            check(esc_share == 1.0 and esc_err == 0.0,
                  f"fused rays {kind}: escape state {esc_share:.6f} of lanes bit-equal")
            rgb = fp.miss_pass(compiled, out_k[0], out_k[2], env.p_env)
            rec.update(escape_share_bit_equal=esc_share,
                       escaped_lanes=int((out_k[2][3] > 0.0).sum()))
        check(bool(torch.isfinite(rgb).all()) and float(rgb.mean()) > 0.0,
              f"fused rays {kind}: non-finite or black")
        again = [fp.paths_rays(tables, rays, env=env, **kw) for _ in range(20)]
        torch.cuda.synchronize()
        check(all(all(torch.equal(a, b) for a, b in zip(o, out_k)) for o in again),
              f"fused rays {kind}: back-to-back launches differ")
        del again
        stats = torch.zeros(len(fp.STATS), dtype=torch.int64, device=device)
        fp.paths_rays(tables, rays, env=env, stats=stats, **kw)
        use = lane_use(stats)
        check(use["traced"] == counts["closest"],
              f"fused rays {kind}: traced {use['traced']} != {counts['closest']}")
        ms = device_ms(torch, lambda: fp.paths_rays(tables, rays, env=env, **kw), iters=20)

        # the camera generation (and with the environment its candidates)
        # and the miss pass are PyTorch calls that wait for the card on the
        # way: CUDA events around the calls, host dispatch included, and
        # the profiler's device time beside
        def camera():
            return ray_inputs(fp, compiled, scene, pxy, 0, depth)

        cam_dev = profile_one(torch, camera, ("",), 5)
        rec.update({"work": counts, "ms": ms, "plain_ms": plain_ms,
                    **fused_bound(tables, counts, pxy.shape[0], env=env is not None,
                                  rays=True),
                    "profiler_ms": profile_one(
                        torch, lambda: fp.paths_rays(tables, rays, env=env, **kw),
                        ("fused_path_kernel",), 20)["kernels_ms"],
                    "camera_ms": events_ms(torch, camera, 10),
                    "camera_device_ms": cam_dev["device_busy_ms"],
                    "camera_device_ops": cam_dev["device_ops"], "lane_use": use,
                    "blocks_per_sm": fp.blocks_per_sm(device, env=env is not None, rays=True)})
        if env is not None:
            def miss():
                return fp.miss_pass(compiled, out_k[0], out_k[2], env.p_env)

            rec["miss_pass_ms"] = events_ms(torch, miss, 20)
            rec["miss_pass_device_ms"] = profile_one(torch, miss, ("",), 10)["device_busy_ms"]
        emit(rec)
        results[kind] = rec

    # the ray-input mode fed the camgen mode's rays and states
    tables, cam, pxy, kw = fused_case(torch, lt, fp, MAIN_SCENE, depth, device)
    pl = fp._Plain(tables, cam, pxy, depth, kw["rr_depth"], kw["rr_threshold"])
    st, o, d = pl.gen_from_cam(torch.zeros(pxy.shape[0], dtype=torch.int64, device=device))
    from luisarender_tpu_torch.core.types import make_ray

    ray = make_ray(torch.stack(o, -1), torch.stack(d, -1), 0.0, math.inf)
    rays = fp.pack_rays(ray, torch.ones(pxy.shape[0], device=device), st)
    rgb_r, rays_r = fp.paths_rays(tables, rays, **kw)
    rgb_c, rays_c = fp.paths(tables, cam, pxy, 0, 0, **kw)
    torch.cuda.synchronize()
    share, err, _ = bit_equal(torch, "ray input fed camgen's rays vs camgen", rgb_r, rays_r,
                              rgb_c, rays_c)
    rec = {"phase": "kernels", "kernel": "fused_path_rays", "scene": "cornell.json camgen rays",
           "n": pxy.shape[0], "depth": depth, "share_bit_equal_vs_camgen": share,
           "max_abs_err_vs_camgen": err, "rays": int(rays_r.sum()),
           "ms": device_ms(torch, lambda: fp.paths_rays(tables, rays, **kw), iters=20),
           "camgen_ms": device_ms(torch, lambda: fp.paths(tables, cam, pxy, 0, 0, **kw),
                                  iters=20)}
    emit(rec)
    results["camgen_rays"] = rec
    return results


def soup_case(torch, cluster, device, n_tris, n_rays, seed, trees=False, copies=1):
    """A random soup of small triangles in the unit cube, its cluster tables
    as the scene compiler builds them, and rays through it: a tenth dead
    (t_max = 0), a third with a finite t_max. With `copies` > 1 every
    triangle is there that many times (the same vertices, so hits tie
    exactly, across clusters where a triangle's copies fill more than one)
    and half the rays aim at a triangle. Returns (o, d, t_min, t_max, nodes,
    tris); with `trees`, also the soup's 8-wide tables and its binary SAH
    tree's trace arrays, as the compiler keeps them ({name: tensor}, keys of
    arrays["trace"])."""
    rs = np.random.RandomState(seed)
    c = rs.uniform(0.0, 1.0, (n_tris, 1, 3))
    verts = (c + rs.normal(0.0, 0.05, (n_tris, 3, 3))).astype(np.float32)
    positions = verts.transpose(1, 0, 2).reshape(-1, 3)
    idx = np.arange(n_tris)
    triangles = np.stack([idx, idx + n_tris, idx + 2 * n_tris], 1).astype(np.int32)
    triangles = np.repeat(triangles, copies, axis=0)
    n_tris *= copies
    opaque = rs.rand(n_tris) < 0.7
    canon = rs.permutation(n_tris)
    if trees:  # slots in the SAH order, as the compiler gives them
        from luisarender_tpu_torch.accel.native import build_bvh_sah

        bvh = build_bvh_sah(positions, triangles)
        canon[bvh.prim_index] = np.arange(n_tris)
    nodes, tris = cluster.build_cluster_tables(positions, triangles, opaque, canon)
    o = rs.uniform(-0.5, 1.5, (n_rays, 3))
    d = rs.randn(n_rays, 3)
    if copies > 1:
        aim = positions[triangles[rs.randint(0, n_tris, n_rays // 2)]].mean(axis=1)
        d[: n_rays // 2] = aim - o[: n_rays // 2]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_min = np.full(n_rays, 1e-4)
    t_max = np.where(rs.rand(n_rays) < 0.33, rs.rand(n_rays) * 2.0, np.inf)
    t_max[rs.rand(n_rays) < 0.1] = 0.0
    args = tuple(torch.as_tensor(np.asarray(x, np.float32), device=device).contiguous()
                 for x in (o, d, t_min, t_max, nodes, tris))
    if not trees:
        return args
    from luisarender_tpu_torch.ops import subpacket, wide8

    slab8, meta8 = subpacket.build_slab_meta(subpacket.build_bvh8(nodes))
    srt = triangles[bvh.prim_index]
    v0, v1, v2 = (positions[srt[:, k]] for k in range(3))
    tables = {"cluster_nodes": nodes, "cluster_tris": tris, "cluster_slab8": slab8,
              "cluster_meta8": meta8, "cluster_cboxes": wide8.build_cluster_boxes(nodes),
              "cluster_woop": subpacket.build_woop_table(tris), "tri_v0": v0,
              "tri_e1": v1 - v0, "tri_e2": v2 - v0, "prim_index": bvh.prim_index,
              "aabb_min": bvh.aabb_min, "aabb_max": bvh.aabb_max, "skip": bvh.skip,
              "node_first": bvh.node_first, "node_count": bvh.node_count}
    return args, {k: torch.as_tensor(v, device=device).contiguous() for k, v in tables.items()}


def launch_sorted(o, d, t_min, t_max, nodes, tris, any_hit, err, stats=None):
    """The route of the reference's wrapper for 32,768 rays or more, around
    the cluster kernel: ops/cluster.py launch on the rays in coherence_order,
    its outputs (and `stats`) scattered back to caller order. Measured here;
    the port's wrappers launch in caller order."""
    from luisarender_tpu_torch.ops import cluster, subpacket

    perm = cluster.coherence_order(o, d, t_min, t_max, nodes)
    rays = [x.index_select(0, perm) for x in (o, d, t_min, t_max)]
    walk = None if stats is None else stats.new_empty(stats.shape)
    out = cluster.launch(*rays, nodes, tris, any_hit, err, walk)
    if stats is not None:
        stats[perm] = walk
    return subpacket.unsort(out, perm)


def compare_cluster(torch, cluster, any_hit, args, plain=None, launch=None):
    """Kernel against plain on one input set; built to do the same IEEE
    operations in the same per-lane order, so every output and every walk
    count must agree bit for bit. `launch` is cluster.launch (caller order)
    or launch_sorted; `plain`, walk_plain's answer when already
    computed. Returns ([max |dt|, |du|, |dv|] or [max |d occ|], the hit
    fraction, the kernel's (N, 3) walk counts, the (C,) bool mask of
    clusters some ray tested, the distinct rows that won a closest hit (0
    for any-hit), walk_plain's answer)."""
    launch = launch or cluster.launch
    what = ("cluster_any" if any_hit else "cluster_closest") + (
        ", sorted" if launch is launch_sorted else "")
    n = args[0].shape[0]
    err = torch.zeros(1, dtype=torch.int32, device=args[0].device)
    walk_k = torch.zeros((n, 3), dtype=torch.int32, device=args[0].device)
    out_k = launch(*args, any_hit, err, walk_k)
    torch.cuda.synchronize()
    check(int(err.item()) == 0, f"{what}: error word {int(err.item())}")
    if plain is None:
        visited = torch.zeros(args[5].shape[0], dtype=torch.bool, device=args[0].device)
        plain = cluster.walk_plain(*args, any_hit, visited) + (visited,)
    t, slot, u, v, occ, walk_p, visited = plain
    check(torch.equal(walk_k, walk_p), f"{what}: the walk's counts differ from the plain "
                                       f"version on {int((walk_k != walk_p).any(1).sum())} lanes")
    if any_hit:
        occ_k = out_k > 0
        diff = float((occ_k.long() - occ.long()).abs().max())
        check(diff == 0.0, f"{what}: occlusion differs on {int((occ_k != occ).sum())} lanes")
        return [diff], float(occ_k.float().mean()), walk_k, visited, 0, plain
    kt, ks, ku, kv = out_k
    check(torch.equal(ks, slot), f"{what}: slots differ on {int((ks != slot).sum())} lanes")
    hit = ks >= 0
    check(torch.equal(torch.isinf(kt), ~hit), f"{what}: miss lanes without t = inf")
    errs = [float((kt[hit] - t[hit]).abs().max()) if hit.any() else 0.0,
            float((ku - u).abs().max()), float((kv - v).abs().max())]
    check(max(errs) == 0.0 and torch.equal(kt, t),
          f"{what}: t, u, v differ from the plain version: {errs}")
    return (errs, float(hit.float().mean()), walk_k, visited, int(torch.unique(ks[hit]).numel()),
            plain)


def cluster_bound(kind, args, walk, visited, winners):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations (the pops and rows this run's walk made) over fp32 peak.
    The bytes are what this run's walk must read and write once: rays in
    (32 B) and hits out (16 B closest, 4 B any), the node table (0.4 MB at
    512k triangles, counted whole), and of the clusters some ray tested
    the attributes the walk reads of every row: v0 / e1 / e2 and valid of
    each valid row, `valid` of each padding row. The slot (closest) or
    opacity (any-hit) column is read only on a row that a ray hits: the
    slots of the `winners` distinct rows that won a closest hit are
    counted, the opacities of the occluders, not known here, are not."""
    o, nodes, tris = args[0], args[4], args[5]
    n = o.shape[0]
    valid_rows = int((tris[visited, 9, :] > 0.0).sum())
    pad_rows = int(visited.sum()) * tris.shape[2] - valid_rows
    nbytes = (n * (32 + (16 if kind == "closest" else 4)) + nodes.numel() * 4
              + (valid_rows * 10 + pad_rows + winners) * 4)
    ops = int(walk[:, 0].sum()) * FLOPS_PER_NODE + int(walk[:, 2].sum()) * FLOPS_PER_ROW
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def walk_summary(walk):
    w = walk.double()
    return {"pops_per_ray": float(w[:, 0].mean()), "leaves_per_ray": float(w[:, 1].mean()),
            "rows_per_ray": float(w[:, 2].mean()), "max_pops": int(walk[:, 0].max())}


def mesh_heavy_inputs(torch, lt, cluster, device):
    """testing.mesh_heavy compiled with the opt-in routes' 8-wide tables,
    and the trace kernels' inputs on its general fork, captured on the
    default (cluster) route."""
    from luisarender_tpu_torch import testing

    scene = lt.Scene.from_dict(testing.mesh_heavy(**MESH_HEAVY))
    with routes(wide=True, sub=True):
        compiled = lt.compile_scene(scene, device=device)
    tr = compiled.arrays["trace"]
    check(compiled.plan.num_tris == 512_004 and not compiled.plan.fused_path
          and "cluster_nodes" in tr and "tri_table" not in tr and "cluster_woop" in tr,
          f"mesh_heavy: {compiled.plan.num_tris} triangles, tables {sorted(tr)}")
    cap = capture_main_path_inputs(torch, cluster, compiled, scene)
    w, h = MESH_HEAVY["res"]
    n_main = cap["closest"][0][0].shape[0]
    check(n_main == w * h, f"main path has {n_main} rays, expected {w * h}")
    return compiled, cap


def cluster_lanes(torch, mod, run, device):
    """The counters of a while-while kernel (the cluster, wide8 or subpacket
    kernel: `mod` is ops/cluster.py, ops/wide8.py or ops/subpacket.py) on one
    launch, `run(counters)`
    (mod.COUNTERS), and the shares they give: the walk's live lanes of its
    lane-slots, the leaf stage's tested rows of its row-slots, parked lanes
    and block loads a leaf round; for wide8, the share of pending leaves
    that the box re-test dropped."""
    ctr = torch.zeros(len(mod.COUNTERS), dtype=torch.int64, device=device)
    run(ctr)
    torch.cuda.synchronize()
    c = dict(zip(mod.COUNTERS, (int(x) for x in ctr.tolist())))
    rounds = max(c["rounds"], 1)
    c.update(walk_lane_share=c["pops"] / max(c["pop_slots"], 1),
             leaf_lane_share=c["rows"] / max(c["row_slots"], 1),
             parked_per_round=c["parked"] / rounds, loads_per_round=c["loads"] / rounds,
             rows_per_round=c["rows"] / rounds)
    if "culled" in c:
        c["culled_share"] = c["culled"] / max(c["culled"] + c["parked"], 1)
    return c


def phase_cluster_kernels(torch, cluster, device, compiled, cap):
    """The cluster traces on the mesh-heavy scene's general-fork inputs and
    on two random soups (one with every triangle 200 times), in caller
    order and through the sorted launch; times, lane counters and the
    sort's cost on the camera and bounce-1 inputs."""
    tr = compiled.arrays["trace"]
    n_main = cap["closest"][0][0].shape[0]
    soups = {"soup3000": soup_case(torch, cluster, device, 3000, 100_003, seed=5),
             "coincident": soup_case(torch, cluster, device, 60, 100_003, seed=7, copies=200)}
    results = {}
    for kind in ("closest", "any"):
        any_hit = kind == "any"
        cases = {"camera": cap[kind][0], "bounce1": cap[kind][1], **soups}
        errs, fracs, walks, times = {}, {}, {}, {}
        for name, args in cases.items():
            errs[name], fracs[name], walk, visited, winners, plain = compare_cluster(
                torch, cluster, any_hit, args)
            compare_cluster(torch, cluster, any_hit, args, plain, launch_sorted)
            del plain
            walks[name] = walk_summary(walk)
            if name in soups:
                continue
            err = torch.zeros(1, dtype=torch.int32, device=device)
            perm = cluster.coherence_order(*args[:5])
            srt = [x.index_select(0, perm) for x in args[:4]] + list(args[4:])
            ms = device_ms(torch, lambda: cluster.launch(*args, any_hit, err), iters=20)
            ms_sorted = device_ms(torch, lambda: cluster.launch(*srt, any_hit, err), iters=20)
            # the sort's own tensor operations keep the host from queueing
            # far ahead of the card: events around the calls, host included
            wrapper_ms = events_ms(torch, lambda: launch_sorted(*args, any_hit, err),
                                   iters=20)
            sort_ms = events_ms(torch, lambda: cluster.coherence_order(*args[:5]), iters=20)
            check(int(err.item()) == 0, f"cluster_{kind}: error word while timing")
            plain_ms = events_ms(torch, lambda: cluster.walk_plain(*args, any_hit), iters=1)
            bound_ms, bound_by = cluster_bound(kind, args, walk, visited, winners)
            # without the sort the wrapper is the kernel: ms
            times[name] = {"ms": ms, "ms_sorted": ms_sorted, "wrapper_ms": wrapper_ms,
                           "sort_ms": sort_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                           "bound_by": bound_by, "clusters_tested": int(visited.sum())}
            for key, rays in (("lanes", args), ("lanes_sorted", srt)):
                times[name][key] = cluster_lanes(
                    torch, cluster,
                    lambda ctr: cluster.launch(*rays, any_hit, err, counters=ctr), device)
        results[kind] = {"errors": errs, "hit_fraction": fracs, "walk": walks, "times": times,
                         "max_abs_err": max(max(v) for v in errs.values())}
        emit({"phase": "kernels", "kernel": f"cluster_{kind}", "n": n_main,
              "inputs": {"camera": "camera rays" if kind == "closest" else
                         "the shadow rays of bounce 0",
                         "bounce1": "bounce-1 rays" if kind == "closest" else
                         "the shadow rays of bounce 1"},
              "nodes": int(tr["cluster_nodes"].shape[0]),
              "clusters": int(tr["cluster_tris"].shape[0]), **results[kind]})
    return results


# the TraceGeometry fields that ops/trace.py pack_tables reads
TRACE_TREE_KEYS = ("tri_v0", "tri_e1", "tri_e2", "prim_index", "aabb_min", "aabb_max",
                   "skip", "node_first", "node_count")
# the tree kernels of slice 4: (module, modes, route of the render, TPU kernel)
TREE_KERNELS = (
    ("wide8", ("closest", "any"), "luisarender_tpu/ops/wide8_pallas.py:84"),
    ("subpacket", ("closest", "any"), "luisarender_tpu/ops/subpacket_pallas.py:322"),
    ("trace", ("closest",), "luisarender_tpu/ops/trace_pallas.py:83"),
)


def trace_tables(trace, tr, leaf_size):
    """ops/trace.py's node and triangle tables (pack_tables) of the trace
    arrays `tr`, the leaf size, the tree's stack bound and its child-pair
    table (build_pairs), made once a tree on the card, with the table's
    build time (CUDA events around the call, host dispatch included)."""
    import torch

    from luisarender_tpu_torch.accel.traverse import TraceGeometry

    geom = TraceGeometry(num_rows=tr["tri_v0"].shape[0], leaf_size=leaf_size,
                         **{k: tr[k] for k in TRACE_TREE_KEYS})
    nodes, tris = trace.pack_tables(geom)
    stack = trace.tree_stack(nodes)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    pairs = trace.build_pairs(nodes, leaf_size)
    end.record()
    end.synchronize()
    return (nodes, tris, leaf_size), stack, pairs, start.elapsed_time(end)


def tree_call(mods, name, tr, leaf_size):
    """(table arguments, launch(rays, any_hit, err, stats, counters=None),
    plain(rays, any_hit, visited) -> (outputs, stats), visited masks(device),
    the stack bound, {the trace kernel's pair rows and their build ms}) of
    one tree kernel over the trace arrays `tr`, the stack bound (and the
    trace kernel's pair table) made once a tree."""
    import torch

    mod = mods[name]
    if name == "trace":
        tables, stack, pairs, build_ms = trace_tables(mod, tr, leaf_size)

        def launch(rays, any_hit, err, stats, counters=None):
            return mod.launch(*rays, *tables, err, stats, stack=stack, counters=counters,
                              pairs=pairs)

        def plain(rays, any_hit, visited):
            out = mod.walk_plain(*rays, *tables, visited, stack=stack, pairs=pairs)
            return out[:4], out[4]

        def masks(dev):
            return (torch.zeros(pairs.shape[0], dtype=torch.bool, device=dev),
                    torch.zeros(tables[1].shape[0], dtype=torch.bool, device=dev))
        return (tables, launch, plain, masks, stack,
                {"pair_rows": int(pairs.shape[0]), "pair_build_ms": build_ms})
    leaf = ((tr["cluster_cboxes"], tr["cluster_tris"]) if name == "wide8"
            else (tr["cluster_woop"],))
    tables = (tr["cluster_slab8"], tr["cluster_meta8"]) + leaf
    walk = mod.wide8_plain if name == "wide8" else mod.subpacket_plain
    stack = mods["subpacket"].stack8_need(tr["cluster_meta8"].cpu().numpy())

    def launch(rays, any_hit, err, stats, counters=None):
        return mod.launch(*rays, *tables, any_hit, err, stats, stack=stack, counters=counters)

    def plain(rays, any_hit, visited):
        st = walk(*rays, *tables, any_hit, visited, stack=stack)
        if any_hit:
            return st.occ, st.stats
        t = torch.where(st.best_s >= 0, st.best_t, math.inf)
        out = (t, st.best_s, st.best_u, st.best_v) if name == "wide8" else (t, st.best_s)
        return out, st.stats

    def masks(dev):
        return (torch.zeros(tables[0].shape[0], dtype=torch.bool, device=dev),
                torch.zeros(leaf[-1].shape[0], dtype=torch.bool, device=dev))
    return tables, launch, plain, masks, stack, {}


def tree_bound(name, kind, tables, rays, walk, visited, winners, woop_cols=13):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and
    operations (this run's walk) over fp32 peak. Bytes, each read once:
    rays in (32 B) and hits out; of the nodes the walk popped the columns
    it reads; of the clusters (rows) it tested the columns it reads of every
    row: the binary tree's v0 / e1 / e2 and index, wide8's v0 / e1 / e2 and
    valid (and `valid` of a padding row), subpacket's `woop_cols` (13: the
    12 o' coefficients, which are also d''s, and the slot; 22, as the first
    port's bound counted it: o' 12, d' 9, slot) and the slot of a padding row. A column
    read only on a hit, wide8's slot (closest) or opacity (any-hit) and
    subpacket's opacity, counts for the `winners` distinct rows that won a
    closest hit and not at all for any-hit (its occluders are not known
    here). Operations: a binary node pop 20 (one box), an 8-wide pop 8
    boxes of 20, a wide8 cluster's box re-test 20, a Moller-Trumbore row 46,
    a Woop row 39. The binary tree: `trace` is the pair walk (ops/trace.py
    walk_plain: a visit reads a pair row's two boxes and two codes and tests
    both boxes), `trace_preorder` the reference's order (preorder_plain: a
    pop reads a node's box, skip, count and first and tests one box); both
    read v0 / e1 / e2 and the index of each row tested."""
    n = rays[0].shape[0]
    closest = kind == "closest"
    out = 16 if name.startswith("trace") else {"wide8": 16, "subpacket": 8}[name]
    out = out if closest else 4
    pops, leaves, rows = (int(walk[:, k].sum()) for k in range(3))
    nodes_read, blocks_read = int(visited[0].sum()), visited[1]
    if name.startswith("trace"):
        pair = name == "trace"
        node_bytes = nodes_read * (14 if pair else 9) * 4
        block_bytes = int(blocks_read.sum()) * 10 * 4  # v0, e1, e2, index
        ops = pops * (2 if pair else 1) * FLOPS_PER_NODE + rows * FLOPS_PER_ROW
    else:
        node_bytes = nodes_read * (48 + 9) * 4  # 48 plane bounds, 8 codes, leaf mask
        blk = tables[-1]
        if name == "wide8":
            valid_rows = int((blk[blocks_read, 9, :] > 0.0).sum())
            attrs, per_hit = 10, winners  # v0 / e1 / e2, valid; the winners' slots
            node_bytes += tables[2].shape[0] * 6 * 4  # the cluster boxes
            ops = (pops * 8 + leaves) * FLOPS_PER_NODE + rows * FLOPS_PER_ROW
        else:
            valid_rows = int((blk[blocks_read, 3, 6 * 128:7 * 128] >= 0.0).sum())
            attrs, per_hit = woop_cols, 0
            ops = pops * 8 * FLOPS_PER_NODE + rows * FLOPS_PER_WOOP_ROW
        pad_rows = int(blocks_read.sum()) * 128 - valid_rows
        block_bytes = (valid_rows * attrs + pad_rows + per_hit) * 4
    nbytes = n * (32 + out) + node_bytes + block_bytes
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def trace_preorder(torch, trace, tables, rays, stack, out_k, device):
    """The trace kernel's rays walked in the reference's order
    (ops/trace.py preorder_plain): its walk and its bound (tree_bound
    "trace_preorder"), beside the pair walk's, and the lanes whose hit
    (t, prim, u, v) differs from the kernel's, which meets the boxes in that
    order: 0 on a sound kernel."""
    visited = (torch.zeros(tables[0].shape[0], dtype=torch.bool, device=device),
               torch.zeros(tables[1].shape[0], dtype=torch.bool, device=device))
    *out_p, walk = trace.preorder_plain(*rays, *tables, visited, stack=stack)
    differ = torch.zeros_like(out_k[1], dtype=torch.bool)
    for a, b in zip(out_k, out_p):
        differ |= (a != b) & ~(torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() \
            else a != b
    winners = int(torch.unique(out_k[1][out_k[1] >= 0]).numel())
    bound_ms, bound_by = tree_bound("trace_preorder", "closest", tables, rays, walk, visited,
                                    winners)
    return {"preorder_differ": int(differ.sum()), "preorder_walk": walk_summary(walk),
            "preorder_bound_ms": bound_ms,
            "preorder_bound_by": bound_by, "preorder_nodes_read": int(visited[0].sum()),
            "preorder_rows_read": int(visited[1].sum())}


def max_abs_diff(torch, outs_k, outs_p):
    """The largest |kernel - plain| over every output's lanes: 0 where both
    are the same infinity, inf where only one is finite."""
    worst = 0.0
    for a, b in zip(outs_k, outs_p):
        a, b = a.double(), b.double()
        same = (a == b) | (torch.isnan(a) & torch.isnan(b))
        fin = torch.isfinite(a) & torch.isfinite(b)
        if bool((~same & ~fin).any()):
            return math.inf
        if bool(fin.any()):
            worst = max(worst, float((a[fin] - b[fin]).abs().max()))
    return worst


def against_cluster(torch, name, kind, kern, ref, rays, tr, flips_out=None):
    """The tree kernel's answer against the cluster kernel's on the same
    rays. wide8 and trace: equal slots on every lane but exact ties (both
    hit, t within 1e-5 relative: two triangles through one point, taken
    in another order), any-hit equal on every lane; subpacket: the
    reference's rule for it (tests/test_subpacket_trace.py), with t held on
    the lanes whose slots agree: where the ray passes within ~1e-5 of an
    edge shared by two triangles, the Woop test and Moller-Trumbore round
    differently, and either may take one of the two, or neither and hit a
    triangle behind (the reference's own kernel does the same on these
    lanes: tests/subpacket_flips.py; the record gives, for the subpacket
    winners of such lanes, Moller-Trumbore's least of u, v and 1 - u - v).
    `flips_out`,
    a dict, receives subpacket's lanes that differ from the cluster kernel
    (a hit / miss flip or another slot) as numpy arrays: the rays and both
    kernels' answers."""
    if kind == "any":
        n, differ = kern.numel(), int((kern != ref).sum())
        check(differ == 0 if name == "wide8" else differ <= 0.002 * n,
              f"{name}_any: differs from the cluster kernel on {differ} of {n} lanes")
        return {"lanes": n, "differ": differ, "agree": 1.0 - differ / n}
    t, slot = kern[0], kern[1]
    t_c, slot_c = ref[0], ref[1]
    hit, hit_c = slot >= 0, slot_c >= 0
    flips = int((hit != hit_c).sum())
    both = hit & hit_c
    rel = ((t - t_c).abs() / t_c.abs().clamp(min=1e-30))[both]
    diff = both & (slot != slot_c)
    rec = {"lanes": int(slot.numel()), "hit_miss_flips": flips,
           "slot_differs": int(diff.sum()),
           "max_rel_dt": float(rel.max()) if both.any() else 0.0}
    if name == "subpacket":
        from luisarender_tpu_torch.accel.traverse import intersect_tri

        n = slot.numel()
        same = both & ~diff
        ok_t = bool(((t - t_c).abs() <= 1e-4 + 2e-4 * t_c.abs())[same].all())
        rec["max_rel_dt_same_slot"] = float(rel[~diff[both]].max()) if same.any() else 0.0
        agree = 1.0 - rec["slot_differs"] / max(1, int(both.sum()))
        rec["slot_agree"] = agree
        if flips_out is not None:
            lanes = torch.nonzero((hit != hit_c) | diff).squeeze(1)
            named = {"lane": lanes, "o": rays[0][lanes], "d": rays[1][lanes],
                     "t_min": rays[2][lanes], "t_max": rays[3][lanes], "t": t[lanes],
                     "slot": slot[lanes], "cluster_t": t_c[lanes],
                     "cluster_slot": slot_c[lanes], "cluster_u": ref[2][lanes],
                     "cluster_v": ref[3][lanes]}
            flips_out.update({k: v.cpu().numpy() for k, v in named.items()})
        if diff.any():
            s = slot[diff].long()
            _, _, u, v = intersect_tri(rays[0][diff], rays[1][diff], tr["tri_v0"][s],
                                       tr["tri_e1"][s], tr["tri_e2"][s])
            margin = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
            rec["winner_flip_rel_dt"] = rel[diff[both]][:20].tolist()
            rec["winner_flip_mt_margin"] = margin[:20].tolist()
        check(flips < 0.005 * n and ok_t and agree > 0.995,
              f"subpacket_closest against the cluster kernel: {rec}")
    else:
        ties = ((t - t_c).abs() <= 1e-5 * t_c.abs())[diff]
        rec["ties"] = int(ties.sum())
        check(flips == 0 and bool(ties.all()) and bool(torch.equal(t[both & ~diff],
                                                                   t_c[both & ~diff])),
              f"{name}_closest against the cluster kernel: {rec}")
    return rec


def phase_tree_kernels(torch, mods, device, compiled, cap):
    """The wide8, subpacket and trace kernels against their plain versions
    on the mesh-heavy inputs of the cluster phase and a random 8,000-triangle
    soup (every output bit for bit, the walk counts too), and against the
    cluster kernel on the same rays; times on the camera and bounce-1
    inputs (the plain versions timed on their compare run, which marks the
    nodes and clusters it reads). Subpacket's closest hits that differ from
    the cluster kernel's are written, with their rays and a digest of the
    tables, to chiprun_out/subpacket_flips.npz (tests/subpacket_flips.py
    holds them against the reference's kernel)."""
    import hashlib

    cluster, subpacket = mods["cluster"], mods["subpacket"]
    tr = compiled.arrays["trace"]
    meta8 = tr["cluster_meta8"]
    shape = {"n8": int(meta8.shape[0]), "bvh8_depth": subpacket.bvh8_depth(meta8.cpu().numpy()),
             "stack8": subpacket.stack8_need(meta8.cpu().numpy()),
             "stack_binary": None, "clusters": int(tr["cluster_tris"].shape[0]),
             "woop_mb": tr["cluster_woop"].numel() * 4 / 1e6,
             "binary_nodes": int(tr["aabb_min"].shape[0])}
    check(shape["n8"] <= subpacket.MAX_SLAB8_NODES, f"mesh_heavy 8-wide tree: {shape}")
    soup_rays, soup_tr = soup_case(torch, cluster, device, 8000, 100_003, seed=6, trees=True)
    soup_rays = soup_rays[:4]
    leaf_size = compiled.plan.bvh_leaf_size
    check(compiled.plan.bvh8_stack == shape["stack8"],
          f"the plan's 8-wide stack bound {compiled.plan.bvh8_stack}: {shape}")
    flips = {}
    results = {}
    for name, kinds, _ in TREE_KERNELS:
        for kind in kinds:
            any_hit = kind == "any"
            key = f"{name}_{kind}"
            cases = {"camera": (cap[kind][0][:4], tr), "bounce1": (cap[kind][1][:4], tr),
                     "soup8000": (soup_rays, soup_tr)}
            rec = {"errors": {}, "hit_fraction": {}, "walk": {}, "vs_cluster": {}, "times": {}}
            for case, (rays, ctr) in cases.items():
                tables, launch, plain, masks, stack, info = tree_call(mods, name, ctr,
                                                                      leaf_size)
                if name == "trace" and case == "camera":
                    shape["stack_binary"] = stack
                    shape.update(info)
                n = rays[0].shape[0]
                err = torch.zeros(1, dtype=torch.int32, device=device)
                stats_k = torch.zeros((n, 3), dtype=torch.int32, device=device)
                out_k = launch(rays, any_hit, err, stats_k)
                torch.cuda.synchronize()
                check(int(err.item()) == 0, f"{key} {case}: error word {int(err.item())}")
                visited = masks(device)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out_p, stats_p = plain(rays, any_hit, visited)
                end.record()
                end.synchronize()
                plain_ms = start.elapsed_time(end)
                check(torch.equal(stats_k, stats_p),
                      f"{key} {case}: walk counts differ on "
                      f"{int((stats_k != stats_p).any(1).sum())} lanes")
                if name == "subpacket":  # the reference's sorted route, scattered back
                    stats_s = torch.zeros_like(stats_k)
                    out_s = subpacket.launch_sorted(*rays, *tables, any_hit, err, stats_s,
                                                    stack=stack)
                    torch.cuda.synchronize()
                    same = (torch.equal(out_s, out_k) if any_hit else
                            all(torch.equal(a, b) for a, b in zip(out_s, out_k)))
                    check(int(err.item()) == 0 and same and torch.equal(stats_s, stats_p),
                          f"{key} {case}: the sorted launch differs from caller order")
                if any_hit:
                    occ_k = out_k > 0
                    check(torch.equal(occ_k, out_p),
                          f"{key} {case}: occlusion differs on {int((occ_k != out_p).sum())}")
                    rec["errors"][case] = [max_abs_diff(torch, (occ_k,), (out_p,))]
                    rec["hit_fraction"][case] = float(occ_k.float().mean())
                    ref = cluster.any_hit(*rays, ctr["cluster_nodes"], ctr["cluster_tris"])
                    rec["vs_cluster"][case] = against_cluster(torch, name, kind, occ_k, ref,
                                                              rays, ctr)
                    winners = 0
                else:
                    for j, (a, b) in enumerate(zip(out_k, out_p)):
                        check(torch.equal(a, b), f"{key} {case}: output {j} differs on "
                                                 f"{int((a != b).sum())} lanes")
                    rec["errors"][case] = [max_abs_diff(torch, out_k, out_p)]
                    rec["hit_fraction"][case] = float((out_k[1] >= 0).float().mean())
                    ref = cluster.closest(*rays, ctr["cluster_nodes"], ctr["cluster_tris"])
                    dump = {} if name == "subpacket" else None
                    rec["vs_cluster"][case] = against_cluster(torch, name, kind, out_k, ref,
                                                              rays, ctr, dump)
                    if dump:
                        flips.update({f"{case}/{k}": v for k, v in dump.items()})
                    hit_k = out_k[1] >= 0
                    winners = int(torch.unique(out_k[1][hit_k]).numel())
                rec["walk"][case] = walk_summary(stats_k)
                if case == "soup8000":
                    continue
                ms = device_ms(torch, lambda: launch(rays, any_hit, err, None), iters=20)
                check(int(err.item()) == 0, f"{key}: error word while timing")
                bound_ms, bound_by = tree_bound(name, kind, tables, rays, stats_k, visited,
                                                winners)
                rec["times"][case] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                                      "bound_by": bound_by,
                                      "nodes_read": int(visited[0].sum()),
                                      "blocks_read": int(visited[1].sum())}
                if name == "subpacket":  # a Woop row charged 22 columns, as before
                    rec["times"][case]["bound_ms_22"], rec["times"][case]["bound_by_22"] = (
                        tree_bound(name, kind, tables, rays, stats_k, visited, winners,
                                   woop_cols=22))
                rec["times"][case]["lanes"] = cluster_lanes(
                    torch, mods[name], lambda c: launch(rays, any_hit, err, None, counters=c),
                    device)
                if name == "trace":  # the reference's order: its walk, bound and hits
                    rec["times"][case].update(trace_preorder(torch, mods["trace"], tables,
                                                             rays, stack, out_k, device))
                    check(rec["times"][case]["preorder_differ"] == 0,
                          f"{key} {case}: {rec['times'][case]['preorder_differ']} lanes' hits "
                          "differ from the walk in the reference's order")
            rec["max_abs_err"] = max(max(v) for v in rec["errors"].values())
            check(rec["max_abs_err"] == 0.0, f"{key}: kernel and plain version differ")
            results[key] = rec
            emit({"phase": "kernels", "kernel": key, "n": cap["closest"][0][0].shape[0],
                  "tables": shape, **rec})
    for case, ctr in (("camera", tr), ("soup8000", soup_tr)):
        for k in ("cluster_slab8", "cluster_meta8", "cluster_woop"):
            digest = hashlib.sha256(ctr[k].cpu().numpy().tobytes()).hexdigest()
            flips[f"{case}/sha256_{k}"] = np.array(digest)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    np.savez(out / "subpacket_flips.npz", **flips)
    return results


# --------------------------------------------------------------------------
# phases 4-7
# --------------------------------------------------------------------------


def render_counted(torch, lt, brute, fp, scene, device):
    """render() on the card with every kernel count set to 0 just before and
    read just after; returns (image, seconds, counts)."""
    reset_counts(brute, fp)
    t0 = time.perf_counter()
    images = lt.render(scene, device=device)  # compile + every sample
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts(brute, fp)
    return images[scene.cameras[0].file], seconds, counts


def check_image(img, w, h, what):
    check(img.shape == (h, w, 3), f"{what}: image shape {img.shape}")
    check(bool(np.isfinite(img).all()), f"{what}: non-finite pixels")
    check(img.mean() > 0.0, f"{what}: the image is black")


def phase_main(torch, lt, brute, fp, device, flat_trace):
    from luisarender_tpu_torch import testing

    recs = {}
    # scenes/materials.json, nothing cut
    scene = lt.load_scene(str(MATERIALS))
    cam, integ = scene.cameras[0], scene.integrator
    w, h = cam.film.resolution
    img, seconds, counts = render_counted(torch, lt, brute, fp, scene, device)
    check_image(img, w, h, "materials")
    check(counts["fused_path"] == cam.spp, f"materials: fused launches {counts} != spp {cam.spp}")
    check(counts["brute_closest"] == counts["brute_any"] == 0,
          f"materials: brute-force launches {counts}")
    recs["materials"] = {"phase": "main", "scene": "scenes/materials.json",
                         "resolution": [w, h], "depth": integ.max_depth, "spp": cam.spp,
                         "cut": None, "seconds": seconds, "rays": integ.rays_traced,
                         "mray_per_s": integ.rays_traced / seconds / 1e6,
                         "launches": counts, "image_mean": float(img.mean())}
    emit(recs["materials"])

    # scenes/cornell.json, nothing cut
    scene = lt.load_scene(str(MAIN_SCENE))
    cam, integ = scene.cameras[0], scene.integrator
    w, h = cam.film.resolution
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lt.compile_scene(scene, device=device)
    torch.cuda.synchronize()
    compile_seconds = time.perf_counter() - t0
    img, seconds, counts = render_counted(torch, lt, brute, fp, scene, device)
    check_image(img, w, h, "cornell")
    band = img[h // 4: 3 * h // 4]  # the walls' middle, clear of floor and ceiling
    left = band[:, : w // 10].reshape(-1, 3).mean(0)
    right = band[:, -(w // 10):].reshape(-1, 3).mean(0)
    check(left[0] > 1.5 * left[1] and left[0] > 1.5 * left[2], f"left wall not red: {left}")
    check(right[1] > 1.5 * right[0] and right[1] > 1.5 * right[2],
          f"right wall not green: {right}")
    check(counts["fused_path"] == cam.spp and counts["brute_closest"] == 0,
          f"cornell: launches {counts}, spp {cam.spp}")
    recs["cornell"] = {"phase": "main", "scene": "scenes/cornell.json", "resolution": [w, h],
                       "depth": integ.max_depth, "spp": cam.spp, "cut": None,
                       "seconds": seconds, "compile_seconds": compile_seconds,
                       "rays": integ.rays_traced,
                       "mray_per_s": integ.rays_traced / seconds / 1e6,
                       "launches": counts, "image_mean": float(img.mean()),
                       "left_rgb": left.tolist(), "right_rgb": right.tolist()}
    emit(recs["cornell"])

    # megawave: one persistent launch a pass
    scene = lt.Scene.from_dict(testing.cornell_box(resolution=(1024, 1024), spp=32, depth=5,
                                                   integrator="megawave"))
    cam, integ = scene.cameras[0], scene.integrator
    img, seconds, counts = render_counted(torch, lt, brute, fp, scene, device)
    check_image(img, 1024, 1024, "megawave")
    passes = math.ceil(cam.spp / integ.samples_per_pass)
    check(counts["fused_path_persistent"] == passes and counts["fused_path"] == 0
          and counts["brute_closest"] == 0, f"megawave: launches {counts}, passes {passes}")
    recs["megawave"] = {"phase": "main", "scene": "testing.cornell_box megawave",
                        "resolution": [1024, 1024], "depth": 5, "spp": cam.spp,
                        "samples_per_pass": integ.samples_per_pass, "seconds": seconds,
                        "rays": integ.rays_traced,
                        "mray_per_s": integ.rays_traced / seconds / 1e6,
                        "launches": counts, "image_mean": float(img.mean())}
    emit(recs["megawave"])

    # the Cornell box with a constant spherical environment: one fused
    # launch a sample in its environment mode, no trace kernel
    scene = env_scene(lt, "spherical", res=512, spp=256, depth=8)
    cam, integ = scene.cameras[0], scene.integrator
    img, seconds, counts = render_counted(torch, lt, brute, fp, scene, device)
    check_image(img, 512, 512, "env cornell")
    others = {k: v for k, v in counts.items() if k != "fused_path_env"}
    check(counts["fused_path_env"] == cam.spp and not any(others.values())
          and integ.bounces_run == 0, f"env cornell: launches {counts}, spp {cam.spp}")
    recs["env_cornell"] = {"phase": "main", "scene": "testing.cornell_box + spherical",
                           "resolution": [512, 512], "depth": 8, "spp": cam.spp, "cut": None,
                           "seconds": seconds, "rays": integ.rays_traced,
                           "mray_per_s": integ.rays_traced / seconds / 1e6,
                           "launches": counts, "image_mean": float(img.mean())}
    emit(recs["env_cornell"])

    # megawave on an environment scene: the per-pass route, no persistent
    # launch (the candidates need static draw offsets)
    scene = env_scene(lt, "spherical", res=256, spp=8, depth=5, integrator="megawave")
    cam, integ = scene.cameras[0], scene.integrator
    img, seconds, counts = render_counted(torch, lt, brute, fp, scene, device)
    check_image(img, 256, 256, "env megawave")
    check(counts["fused_path_persistent"] == 0 and counts["fused_path_env"] == cam.spp,
          f"env megawave: launches {counts}, spp {cam.spp}")
    recs["env_megawave"] = {"phase": "main", "scene": "testing.cornell_box + spherical megawave",
                            "resolution": [256, 256], "depth": 5, "spp": cam.spp,
                            "seconds": seconds, "rays": integ.rays_traced,
                            "launches": counts, "image_mean": float(img.mean())}
    emit(recs["env_megawave"])

    # the ray-input mode: scenes/cornell.json with the thin lens and a
    # gaussian filter, nothing cut, one ray-input launch a sample and no
    # other kernel launch; the env Cornell box with the same camera (one
    # launch a sample in the mode's environment form); and the first on
    # megawave, which renders a ray-input scene a sample a launch
    for key, kind, res, spp, depth, integrator, launch in (
        ("rays_cornell", "thinlens", 512, 256, 8, "megapath", "fused_path_rays"),
        ("rays_env_cornell", "env_thinlens", 512, 256, 8, "megapath", "fused_path_rays_env"),
        ("rays_megawave", "thinlens", 256, 8, 5, "megawave", "fused_path_rays"),
    ):
        scene = ray_scene(lt, kind, res=res, spp=spp, depth=depth, integrator=integrator)
        cam, integ = scene.cameras[0], scene.integrator
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lt.compile_scene(scene, device=device)
        torch.cuda.synchronize()
        compile_seconds = time.perf_counter() - t0
        img, seconds, counts = render_counted(torch, lt, brute, fp, scene, device)
        check_image(img, res, res, key)
        others = {k: v for k, v in counts.items() if k != launch}
        check(counts[launch] == cam.spp and not any(others.values())
              and integ.bounces_run == 0, f"{key}: launches {counts}, spp {cam.spp}")
        recs[key] = {"phase": "main", "scene": f"ray_scene {kind} {integrator}",
                     "resolution": [res, res], "depth": depth, "spp": cam.spp,
                     "cut": None if key != "rays_megawave" else "256^2, 8 spp, depth 5",
                     "seconds": seconds, "compile_seconds": compile_seconds,
                     "rays": integ.rays_traced,
                     "mray_per_s": integ.rays_traced / seconds / 1e6,
                     "launches": counts, "image_mean": float(img.mean())}
        emit(recs[key])

    # the mesh-heavy scene on the general fork: the cluster kernels
    scene = lt.Scene.from_dict(testing.mesh_heavy(**MESH_HEAVY))
    cam, integ = scene.cameras[0], scene.integrator
    w, h = cam.film.resolution
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compiled = lt.compile_scene(scene, device=device)
    torch.cuda.synchronize()
    compile_seconds = time.perf_counter() - t0
    check(compiled.plan.has_environment and compiled.plan.needs_uv
          and "checkerboard" in compiled.arrays["textures"],
          "mesh_heavy: its checkerboard floor or environment is missing")
    flat_bytes = table_bytes(compiled.arrays["trace"])
    del compiled
    emit({"phase": "main", "scene": "testing.mesh_heavy", "compile_seconds": compile_seconds,
          "trace_table_bytes": flat_bytes})
    img, seconds, counts = render_counted(torch, lt, brute, fp, scene, device)
    check_image(img, w, h, "mesh_heavy")
    check(integ.bounces_run > 0 and counts["cluster_closest"] == integ.bounces_run
          == counts["cluster_any"] and counts["brute_closest"] == counts["brute_any"] == 0
          and counts["fused_path"] == counts["fused_path_persistent"] == 0
          and counts["fused_path_env"] == 0,
          f"mesh_heavy: launches {counts}, bounces {integ.bounces_run}")
    recs["mesh_heavy"] = {"phase": "main", "scene": "testing.mesh_heavy",
                          "triangles": 512_004, "resolution": [w, h], "depth": integ.max_depth,
                          "spp": cam.spp, "cut": None,
                          "seconds": seconds, "compile_seconds": compile_seconds,
                          "trace_table_bytes": flat_bytes,
                          "rays": integ.rays_traced,
                          "mray_per_s": integ.rays_traced / seconds / 1e6,
                          "bounces": integ.bounces_run, "launches": counts,
                          "image_mean": float(img.mean())}
    emit(recs["mesh_heavy"])
    recs.update(phase_routes(torch, lt, brute, fp, device, img))
    recs.update(phase_twolevel(torch, lt, brute, fp, device, img, recs["mesh_heavy"], flat_trace))
    # the wavefront phase holds its mesh-heavy image against this one
    recs["mesh_heavy_image"] = img
    return recs


def phase_routes(torch, lt, brute, fp, device, img):
    """testing.mesh_heavy, nothing cut but as phase 4's, on the opt-in
    routes: wide8 for both traces, then subpacket closest hits with cluster
    any-hit; each image against the cluster route's (`img`) under the image
    rule."""
    from luisarender_tpu_torch import testing

    recs = {}
    w, h = MESH_HEAVY["res"]
    for route, flags, want in (
        ("wide8", {"wide": True}, {"wide8_closest": 1, "wide8_any": 1}),
        ("subpacket", {"sub": True}, {"subpacket_closest": 1, "cluster_any": 1}),
    ):
        with routes(**flags):
            scene = lt.Scene.from_dict(testing.mesh_heavy(**MESH_HEAVY))
            cam, integ = scene.cameras[0], scene.integrator
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lt.compile_scene(scene, device=device)
            torch.cuda.synchronize()
            compile_seconds = time.perf_counter() - t0
            rimg, seconds, counts = render_counted(torch, lt, brute, fp, scene, device)
        check_image(rimg, w, h, f"mesh_heavy {route}")
        others = {k: v for k, v in counts.items() if k not in want}
        check(integ.bounces_run > 0
              and all(counts[k] == integ.bounces_run for k in want)
              and not any(others.values()),
              f"mesh_heavy {route}: launches {counts}, bounces {integ.bounces_run}")
        off = frac_off(rimg, img)
        rel = float(rimg.mean() / img.mean() - 1.0)
        recs[f"mesh_heavy_{route}"] = {
            "phase": "main", "scene": "testing.mesh_heavy", "route": route,
            "triangles": 512_004, "resolution": [w, h], "depth": integ.max_depth,
            "spp": cam.spp, "cut": None,
            "seconds": seconds, "compile_seconds": compile_seconds,
            "rays": integ.rays_traced, "mray_per_s": integ.rays_traced / seconds / 1e6,
            "bounces": integ.bounces_run, "launches": counts,
            "image_mean": float(rimg.mean()), "frac_pixels_off_cluster_route": off,
            "mean_rel_diff_cluster_route": rel}
        emit(recs[f"mesh_heavy_{route}"])
        check(off < 0.02 and abs(rel) < 0.005,
              f"mesh_heavy {route}: {off:.4f} of pixels off the cluster route's image, "
              f"mean off by {rel:.5f}")
    return recs


# the 400-instance case of the twolevel phase: testing.mesh_heavy at n = 20,
# which `auto` sends to the two-level path (8,192,004 flattened triangles,
# 20,484 unique)
MESH_HEAVY_AUTO = dict(res=(1280, 720), spp=1, depth=5, n=20, subdiv=5, accel="auto")
# the share of lanes on which the two-level route and the flat cluster
# route may differ on phase 4's mesh-heavy rays (hit or miss, t beyond 1e-3
# relative / 1e-4 absolute, the instance hit, occlusion): world-space and
# object-space triangles round apart at edges. An H100 run measured at
# most 3 of 921,600 lanes (3.3e-6, camera rays); the gate is 3x that
TWOLEVEL_FLAT_SHARE = 1e-5


def table_bytes(tables):
    """Bytes of a scene's dict of trace tables (tensors)."""
    return sum(t.numel() * t.element_size() for t in tables.values())


def twolevel_launches(plan):
    """(closest, any-hit) cluster launches a bounce of a two-level scene:
    its visible instances, and of those the ones that block shadow rays."""
    vis = plan.tl_inst_visible
    return sum(vis), sum(v and o for v, o in zip(vis, plan.tl_inst_opaque))


def twolevel_trace(torch, compiled, flat_trace, device):
    """The two-level route (one cluster launch a visible instance) on phase
    4's camera and bounce-1 rays and the shadow rays of bounces 0 and 1,
    against the plain TLAS/BLAS walk on the card (every lane but exact ties
    in t; t within 1e-5 relative) and against the flat cluster kernel on
    the flattened scene (the share of lanes that differ); the route's wall
    and device ms a trace (the profiler's) beside the flat kernel's device
    ms."""
    from luisarender_tpu_torch.accel import twolevel
    from luisarender_tpu_torch.core.types import Ray
    from luisarender_tpu_torch.ops import cluster

    geom = compiled.trace_geometry()
    nodes, tris, slot_inst = flat_trace["nodes"], flat_trace["tris"], flat_trace["slot_inst"]
    err = torch.zeros(1, dtype=torch.int32, device=device)
    cases = {}
    for name, args, any_hit in (("camera", flat_trace["closest"][0], False),
                                ("bounce1", flat_trace["closest"][1], False),
                                ("shadow0", flat_trace["any"][0], True),
                                ("shadow1", flat_trace["any"][1], True)):
        rays = Ray(*args[:4])
        if any_hit:
            route = lambda: twolevel.trace_any_2l_cluster(geom, rays)  # noqa: E731
            occ, occ_plain = route(), twolevel.trace_any_2l(geom, rays)
            occ_flat = cluster.launch(*args[:4], nodes, tris, True, err) > 0
            check(torch.equal(occ, occ_plain), f"twolevel {name}: occlusion off the plain walk "
                  f"on {int((occ != occ_plain).sum())} lanes")
            off = occ != occ_flat
            rec = {"lanes": int(occ.numel()), "occluded": float(occ.float().mean()),
                   "ties": 0, "max_rel_t_plain": 0.0}
            plain = lambda: twolevel.trace_any_2l(geom, rays)  # noqa: E731
        else:
            route = lambda: twolevel.trace_closest_2l_cluster(geom, rays)  # noqa: E731
            hit, ref = route(), twolevel.trace_closest_2l(geom, rays)
            found = hit.prim >= 0
            differ = (hit.prim != ref.prim) | (hit.inst != ref.inst)
            tie = found & (ref.prim >= 0) & (hit.t == ref.t)
            check(torch.equal(found, ref.prim >= 0) and not bool((differ & ~tie).any()),
                  f"twolevel {name}: {int((differ & ~tie).sum())} lanes off the plain walk")
            rel = float(((hit.t - ref.t).abs() / ref.t.abs())[found].max()) if found.any() else 0.0
            check(rel <= 1e-5, f"twolevel {name}: t off the plain walk by {rel:.3g} relative")
            t_f, slot_f = cluster.launch(*args[:4], nodes, tris, False, err)[:2]
            found_f = slot_f >= 0
            inst_f = torch.where(found_f, slot_inst[torch.clamp(slot_f, min=0).long()], -1)
            close = torch.isclose(hit.t, t_f, rtol=1e-3, atol=1e-4)
            off = (found != found_f) | (found & ~close) | (hit.inst != inst_f)
            rec = {"lanes": int(found.numel()), "hit": float(found.float().mean()),
                   "ties": int((differ & tie).sum()), "max_rel_t_plain": rel}
            plain = lambda: twolevel.trace_closest_2l(geom, rays)  # noqa: E731
        flat = lambda: cluster.launch(*args[:4], nodes, tris, any_hit, err)  # noqa: E731
        # the route keeps the host busier than the card (~20 small ops an
        # instance beside its launch), so its launches cannot be queued
        # behind a spin as device_ms does: the profiler gives its device
        # time, the host clock its wall time
        kernel = f"cluster_{'any' if any_hit else 'closest'}_kernel"
        rec.update(lanes_off_flat=int(off.sum()), share_off_flat=float(off.float().mean()),
                   route=profile_one(torch, route, (kernel,), 5),
                   flat_ms=device_ms(torch, flat, iters=20),
                   plain_ms=events_ms(torch, plain, iters=1))
        cases[name] = rec
    check(int(err.item()) == 0, "twolevel: the flat kernel's error word set")
    rec = {"phase": "twolevel", "part": "trace", "launches_a_trace": twolevel_launches(compiled.plan),
           "share_gate": TWOLEVEL_FLAT_SHARE, "cases": cases}
    emit(rec)
    for name, c in cases.items():
        check(c["share_off_flat"] <= TWOLEVEL_FLAT_SHARE,
              f"twolevel {name}: {c['lanes_off_flat']} lanes ({c['share_off_flat']:.2e}) "
              f"off the flat cluster route, past {TWOLEVEL_FLAT_SHARE}")
    return rec


def twolevel_render(torch, lt, brute, fp, scene, device, what, expect, traced=None):
    """Compile `scene` on the card (timed), hold its plan to `expect`, run
    `traced(compiled)` if given, then render it counted: a finite image,
    and cluster launches of exactly the visible instances a bounce (any-hit:
    the visible opaque ones), no other kernel. Returns (the record's common
    fields, the image, traced's result)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compiled = lt.compile_scene(scene, device=device)
    torch.cuda.synchronize()
    compile_seconds = time.perf_counter() - t0
    plan = compiled.plan
    got = {"two_level": plan.two_level, "fused_path": plan.fused_path,
           "flat_tables_built": compiled.arrays["trace"] != {},
           "instances": len(plan.tl_inst_mesh), "unique_meshes": plan.tl_mesh_count,
           "triangles": plan.num_tris,
           "unique_triangles": int(compiled.arrays["trace2"]["tri_valid"].sum())}
    check(all(got[k] == v for k, v in expect.items()), f"{what}: plan {got}, expected {expect}")
    per_bounce = dict(zip(("cluster_closest", "cluster_any"), twolevel_launches(plan)))
    bytes_2l = table_bytes(compiled.arrays["trace2"])
    side = traced(compiled) if traced is not None else None
    del compiled
    cam, integ = scene.cameras[0], scene.integrator
    w, h = cam.film.resolution
    img, seconds, counts = render_counted(torch, lt, brute, fp, scene, device)
    check_image(img, w, h, what)
    others = {k: v for k, v in counts.items() if k not in per_bounce}
    check(integ.bounces_run > 0
          and all(counts[k] == v * integ.bounces_run for k, v in per_bounce.items())
          and not any(others.values()),
          f"{what}: launches {counts}, bounces {integ.bounces_run}")
    rec = {**{k: got[k] for k in ("instances", "unique_meshes", "triangles", "unique_triangles",
                                  "flat_tables_built")},
           "resolution": [w, h], "depth": integ.max_depth, "spp": cam.spp,
           "compile_seconds": compile_seconds, "seconds": seconds,
           "rays": integ.rays_traced, "mray_per_s": integ.rays_traced / seconds / 1e6,
           "bounces": integ.bounces_run, "launches": counts, "launches_per_bounce": per_bounce,
           "trace_table_bytes": bytes_2l, "image_mean": float(img.mean())}
    return rec, img, side


def phase_twolevel(torch, lt, brute, fp, device, img, flat_rec, flat_trace):
    """testing.mesh_heavy(accel="twolevel") at phase 4's size, nothing cut:
    27 instances of 3 unique meshes (the 25 icospheres share one). Its
    render (twolevel_render) against the flat cluster route's image `img`
    under the image rule; its traces (twolevel_trace); then
    testing.mesh_heavy(n=20, accel="auto"): 400 icospheres, past the
    threshold, so the compiler takes the two-level path and never builds
    the flat tables; one 1280 x 720 sample at depth 5."""
    from luisarender_tpu_torch import testing

    recs = {}
    scene = lt.Scene.from_dict(testing.mesh_heavy(**MESH_HEAVY, accel="twolevel"))
    rec, rimg, recs["twolevel_trace"] = twolevel_render(
        torch, lt, brute, fp, scene, device, "mesh_heavy twolevel",
        {"two_level": True, "fused_path": False, "flat_tables_built": False, "instances": 27,
         "unique_meshes": 3, "triangles": 512_004, "unique_triangles": 20_484},
        traced=lambda compiled: twolevel_trace(torch, compiled, flat_trace, device))
    off = frac_off(rimg, img)
    rel = float(rimg.mean() / img.mean() - 1.0)
    recs["mesh_heavy_twolevel"] = {
        "phase": "twolevel", "part": "render", "scene": "testing.mesh_heavy(accel='twolevel')",
        "cut": None, **rec, "flat_seconds": flat_rec["seconds"],
        "flat_trace_table_bytes": flat_rec["trace_table_bytes"],
        "frac_pixels_off_cluster_route": off, "mean_rel_diff_cluster_route": rel}
    emit(recs["mesh_heavy_twolevel"])
    check(off < 0.02 and abs(rel) < 0.005,
          f"mesh_heavy twolevel: {off:.4f} of pixels off the cluster route's image, "
          f"mean off by {rel:.5f}")
    scene = lt.Scene.from_dict(testing.mesh_heavy(**MESH_HEAVY_AUTO))
    rec = twolevel_render(
        torch, lt, brute, fp, scene, device, "mesh_heavy auto",
        {"two_level": True, "flat_tables_built": False, "instances": 402,
         "triangles": 8_192_004, "unique_triangles": 20_484})[0]
    recs["mesh_heavy_auto"] = {
        "phase": "twolevel", "part": "auto", "scene": "testing.mesh_heavy(n=20, accel='auto')",
        # mesh_heavy renders 4 samples; one is enough to drive every launch
        "cut": {"spp": [4, MESH_HEAVY_AUTO["spp"]]}, **rec,
        # the flat tables at phase 4's bytes a triangle
        "flat_bytes_at_phase4_rate": flat_rec["trace_table_bytes"] / 512_004 * 8_192_004}
    emit(recs["mesh_heavy_auto"])
    return recs


def phase_general(torch, lt, brute, fp, device):
    scene = general_scene(lt)
    compiled = lt.compile_scene(scene, device=device)
    check(not compiled.plan.fused_path and compiled.plan.num_tris == 352,
          f"general scene: fused {compiled.plan.fused_path}, {compiled.plan.num_tris} triangles")
    integ = scene.integrator
    img, seconds, counts = render_counted(torch, lt, brute, fp, scene, device)
    check_image(img, 512, 512, "general")
    check(integ.bounces_run > 0, "general: no bounce ran")
    check(counts["brute_closest"] == integ.bounces_run == counts["brute_any"]
          and counts["fused_path"] == counts["cluster_closest"] == counts["cluster_any"] == 0,
          f"general: launches {counts}, bounces {integ.bounces_run}")
    rec = {"phase": "general", "scene": "testing.cornell_box + icosphere(subdivision 2)",
           "triangles": compiled.plan.num_tris, "resolution": [512, 512], "depth": 8,
           "spp": 32, "cut": "spp 256 -> 32", "seconds": seconds,
           "rays": integ.rays_traced, "mray_per_s": integ.rays_traced / seconds / 1e6,
           "bounces": integ.bounces_run, "launches": counts,
           "image_mean": float(img.mean())}
    emit(rec)
    return rec


def profile_one(torch, fn, kernels, samples, device_only=False):
    """`samples` calls of fn() under torch.profiler, per sample: wall ms,
    device busy ms and share, the named kernels' device ms, device ops.
    The device numbers are None when the profiler traced no device work
    (the card's activity can be held by another tracer of the process);
    fails when it traced device work but none of the named kernels.
    device_only=True traces the card's activity alone, whose events are all
    this reads: a sample of 10^5 device ops also makes ~10^6 host events,
    which take the profiler minutes to aggregate."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] if device_only else [ProfilerActivity.CPU,
                                                               ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(samples):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / samples
    busy = kern_us = 0.0
    n_ops = 0
    for evt in device_events(prof):
        busy += evt.device_time_total / samples
        n_ops += evt.count
        if any(k in evt.key for k in kernels):
            kern_us += evt.device_time_total / samples
    if busy == 0.0:
        return {"samples": samples, "wall_ms": wall_ms, "device_busy_ms": None,
                "device_busy_share": None, "kernels_ms": None,
                "kernels_share_of_busy": None, "device_ops": None,
                "profiler": "traced no device work: not measured"}
    check(kern_us > 0, f"the profiler recorded no device time for {kernels}")
    return {"samples": samples, "wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e3 / wall_ms, "kernels_ms": kern_us / 1e3,
            "kernels_share_of_busy": kern_us / busy, "device_ops": n_ops / samples}


def phase_profile(torch, lt, device):
    """512^2 samples of materials on the fused fork (8, each a few ms), one
    of Cornell, one of the general scene (352 triangles, the brute kernels'
    main path) and one of the mesh-heavy scene on the general fork, flat
    and two-level, per sample."""
    from luisarender_tpu_torch import testing
    from luisarender_tpu_torch.integrators.mega_path import (
        general_path_trace_batch, path_trace_batch, pixel_grid,
    )

    recs = {}
    for label, name, make, fn_batch, kernels, samples in (
        ("fused", MATERIALS.name, lambda: lt.load_scene(str(MATERIALS)), path_trace_batch,
         ("fused_path_kernel",), 8),
        ("general", MAIN_SCENE.name, lambda: lt.load_scene(str(MAIN_SCENE)),
         general_path_trace_batch, ("closest_kernel", "any_kernel"), 1),
        ("general_352", "testing.cornell_box + icosphere", lambda: general_scene(lt),
         general_path_trace_batch, ("closest_kernel", "any_kernel"), 1),
        ("general_mesh_heavy", "testing.mesh_heavy",
         lambda: lt.Scene.from_dict(testing.mesh_heavy(**MESH_HEAVY)), general_path_trace_batch,
         ("cluster_closest_kernel", "cluster_any_kernel"), 1),
        ("general_mesh_heavy_twolevel", "testing.mesh_heavy(accel='twolevel')",
         lambda: lt.Scene.from_dict(testing.mesh_heavy(**MESH_HEAVY, accel="twolevel")),
         general_path_trace_batch, ("cluster_closest_kernel", "cluster_any_kernel"), 1),
    ):
        scene = make()
        compiled = lt.compile_scene(scene, device=device)
        integ = scene.integrator
        w, h = scene.cameras[0].film.resolution
        pxy = pixel_grid(w, h, device)
        counter = iter(range(1, 100))

        def one_sample():
            return fn_batch(compiled, scene.cameras[0], integ.sampler, integ.light_sampler,
                            pxy, next(counter), max_depth=integ.max_depth,
                            rr_depth=integ.rr_depth, rr_threshold=integ.rr_threshold)

        recs[label] = {"phase": "profile", "fork": label, "scene": name,
                       **profile_one(torch, one_sample, kernels, samples)}
        emit(recs[label])
    return recs


def phase_golden(torch, lt, device):
    from luisarender_tpu_torch import testing
    from luisarender_tpu_torch.integrators.mega_path import (
        general_path_trace_batch, path_trace_batch, pixel_grid,
    )
    from luisarender_tpu_torch.utils import imageio

    scene = lt.Scene.from_dict(testing.cornell_box(resolution=(64, 64), spp=8, depth=5))
    img = lt.render(scene, device=device)["cornell.exr"]
    check(scene.integrator.fused_passes == 8, "golden: the render did not take the fused fork")
    ref = imageio.load_exr(str(GOLDEN))
    rel = float(img.mean() / ref.mean() - 1.0)
    compiled = lt.compile_scene(scene, device=device)
    integ = scene.integrator
    pxy = pixel_grid(64, 64, device)
    kw = dict(max_depth=5, rr_depth=0, rr_threshold=0.95)
    acc, per_sample = 0.0, []
    for si in range(8):
        args = (compiled, scene.cameras[0], integ.sampler, integ.light_sampler, pxy, si)
        rgb_f, _, st_f = path_trace_batch(*args, with_stats=True, **kw)
        rgb_g, _, st_g = general_path_trace_batch(*args, **kw)
        rays_f, rays_g = int(st_f["rays"]), int(st_g["rays"])
        off = frac_off(rgb_f.cpu(), rgb_g.cpu())
        per_sample.append(off)
        check(abs(rays_f - rays_g) <= max(8, rays_g // 500),
              f"golden sample {si}: rays {rays_f} vs {rays_g}")
        check(off < 0.02, f"golden sample {si}: {off:.4f} of pixels off")
        acc = acc + rgb_g.cpu().numpy()
    frac_general = frac_off((acc / 8).reshape(64, 64, 3), ref)

    # the environment Cornell box (no golden): each sample of the fused fork
    # (its environment mode) against the general fork by the same rule
    escene = env_scene(lt, "spherical", res=64, spp=8, depth=5)
    ecompiled = lt.compile_scene(escene, device=device)
    einteg = escene.integrator
    env_per_sample = []
    for si in range(8):
        args = (ecompiled, escene.cameras[0], einteg.sampler, einteg.light_sampler, pxy, si)
        rgb_f, _, st_f = path_trace_batch(*args, with_stats=True, **kw)
        rgb_g, _, st_g = general_path_trace_batch(*args, **kw)
        rays_f, rays_g = int(st_f["rays"]), int(st_g["rays"])
        off = frac_off(rgb_f.cpu(), rgb_g.cpu())
        env_per_sample.append(off)
        check(st_f["fused"] == 1, f"env golden sample {si}: not on the fused fork")
        check(abs(rays_f - rays_g) <= max(8, rays_g // 500),
              f"env golden sample {si}: rays {rays_f} vs {rays_g}")
        check(off < 0.02, f"env golden sample {si}: {off:.4f} of pixels off")

    # the ray-input scenes: each sample of the fused fork (the ray-input
    # mode) against the general fork by the same rule
    ray_per_sample = {}
    for kind in RAY_SCENES:
        rscene = ray_scene(lt, kind, res=64, spp=8, depth=5)
        rcompiled = lt.compile_scene(rscene, device=device)
        rinteg = rscene.integrator
        offs = []
        for si in range(8):
            args = (rcompiled, rscene.cameras[0], rinteg.sampler, rinteg.light_sampler, pxy, si)
            rgb_f, _, st_f = path_trace_batch(*args, with_stats=True, **kw)
            rgb_g, _, st_g = general_path_trace_batch(*args, **kw)
            rays_f, rays_g = int(st_f["rays"]), int(st_g["rays"])
            off = frac_off(rgb_f.cpu(), rgb_g.cpu())
            offs.append(off)
            check(st_f["fused"] == 1, f"{kind} golden sample {si}: not on the fused fork")
            check(abs(rays_f - rays_g) <= max(8, rays_g // 500),
                  f"{kind} golden sample {si}: rays {rays_f} vs {rays_g}")
            check(off < 0.02, f"{kind} golden sample {si}: {off:.4f} of pixels off")
        ray_per_sample[kind] = offs

    d = json.load(open(MATERIALS))
    cam = d["render"]["cameras"][0]["prop"]
    cam["film"]["prop"]["resolution"] = [48, 48]
    cam["spp"] = 8
    d["render"]["integrator"]["prop"]["depth"] = 5
    os.environ["LUISARENDER_TPU_NO_FUSED"] = "1"
    try:
        mscene = lt.Scene.from_dict(d)
        mimg = lt.render(mscene, device=device)["materials.exr"]
    finally:
        del os.environ["LUISARENDER_TPU_NO_FUSED"]
    check(mscene.integrator.fused_passes == 0, "materials golden: took the fused fork")
    mref = imageio.load_exr(str(MATERIALS_GOLDEN))
    mfrac = frac_off(mimg, mref)
    mrel = float(mimg.mean() / mref.mean() - 1.0)

    # above 512 triangles: the cluster kernels
    from luisarender_tpu_torch.ops import brute
    from luisarender_tpu_torch.ops import fused_path as fp

    # above 512 triangles: the cluster kernels, and the opt-in routes
    sref = imageio.load_exr(str(SPHERE_GOLDEN))
    sphere = {}
    for route, flags, key in (("cluster", {}, "cluster_closest"),
                              ("wide8", {"wide": True}, "wide8_closest"),
                              ("subpacket", {"sub": True}, "subpacket_closest")):
        with routes(**flags):
            sscene = lt.Scene.from_dict(testing.cornell_sphere(resolution=(48, 48), spp=8,
                                                               depth=5))
            reset_counts(brute, fp)
            simg = lt.render(sscene, device=device)["cornell.exr"]
            scounts = read_counts(brute, fp)
        check(scounts[key] == sscene.integrator.bounces_run > 0
              and scounts["brute_closest"] == 0, f"sphere golden {route}: launches {scounts}")
        sphere[route] = (frac_off(simg, sref), float(simg.mean() / sref.mean() - 1.0))
    emit({"phase": "golden", "cornell_fused_frac_pixels_off": frac_off(img, ref),
          "cornell_fused_mean_rel_diff": rel, "cornell_per_sample_frac_off": per_sample,
          "cornell_general_frac_pixels_off": frac_general,
          "env_cornell_per_sample_frac_off": env_per_sample,
          **{f"rays_{k}_per_sample_frac_off": v for k, v in ray_per_sample.items()},
          "materials_general_frac_pixels_off": mfrac, "materials_mean_rel_diff": mrel,
          **{f"cornell_sphere{'' if r == 'cluster' else '_' + r}_frac_pixels_off": v[0]
             for r, v in sphere.items()},
          **{f"cornell_sphere{'' if r == 'cluster' else '_' + r}_mean_rel_diff": v[1]
             for r, v in sphere.items()}})
    check(abs(rel) < 0.005, f"golden: image mean off by {rel:.5f}")
    check(frac_general < 0.02, f"golden: general fork {frac_general:.4f} of pixels off")
    check(mfrac < 0.02 and abs(mrel) < 0.005,
          f"materials golden: {mfrac:.4f} of pixels off, mean off by {mrel:.5f}")
    for route, (sfrac, srel) in sphere.items():
        check(sfrac < 0.02 and abs(srel) < 0.005, f"cornell_sphere golden ({route} route): "
              f"{sfrac:.4f} of pixels off, mean off by {srel:.5f}")


# --------------------------------------------------------------------------
# phase 8: the hero spectrum on the general fork
# --------------------------------------------------------------------------

SPECTRAL_SCENE = ROOT / "scenes" / "cornell_spectral.json"
SPECTRAL_GOLDEN = ROOT / "tests" / "golden" / "cornell_spectral_48_8spp.exr"
# the spectral Cornell box's spp, cut from the file's 256 to fit the script's time
SPECTRAL_SPP = 32


def spectral_dict(path, res=None, spp=None, depth=None):
    with open(path) as f:
        d = json.load(f)
    cam = d["render"]["cameras"][0]["prop"]
    if res is not None:
        cam["film"]["prop"]["resolution"] = [res, res]
    if spp is not None:
        cam["spp"] = spp
    if depth is not None:
        d["render"]["integrator"]["prop"]["depth"] = depth
    return d


def timed_compile(torch, lt, scene, device):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compiled = lt.compile_scene(scene, device=device)
    torch.cuda.synchronize()
    return compiled, time.perf_counter() - t0


def spectral_render(torch, lt, brute, fp, scene, device, what, trace_key, no_fused=False):
    """compile (timed alone) and render() with the counts read around it,
    on the general fork with the `trace_key` kernels (brute or cluster)
    launched once a bounce each and nothing else; one sample under the
    profiler. Returns (record, image)."""
    from luisarender_tpu_torch.integrators.mega_path import general_path_trace_batch, pixel_grid

    cam, integ = scene.cameras[0], scene.integrator
    w, h = cam.film.resolution
    compiled, compile_seconds = timed_compile(torch, lt, scene, device)
    check(not fp.use_fused(compiled, integ.sampler, integ.light_sampler) or no_fused,
          f"{what}: takes the fused fork")
    if no_fused:
        os.environ["LUISARENDER_TPU_NO_FUSED"] = "1"
    try:
        img, seconds, counts = render_counted(torch, lt, brute, fp, scene, device)
    finally:
        os.environ.pop("LUISARENDER_TPU_NO_FUSED", None)
    check_image(img, w, h, what)
    others = {k: v for k, v in counts.items()
              if k not in (f"{trace_key}_closest", f"{trace_key}_any")}
    check(integ.fused_passes == 0 and integ.bounces_run > 0
          and counts[f"{trace_key}_closest"] == integ.bounces_run == counts[f"{trace_key}_any"]
          and not any(others.values()),
          f"{what}: fused passes {integ.fused_passes}, launches {counts}, "
          f"bounces {integ.bounces_run}")
    # every pixel's camera ray of every sample is traced
    check(integ.rays_traced >= w * h * cam.spp, f"{what}: {integ.rays_traced} rays")
    pxy = pixel_grid(w, h, device)
    kernels = (("closest_kernel", "any_kernel") if trace_key == "brute"
               else ("cluster_closest_kernel", "cluster_any_kernel"))
    prof = profile_one(torch, lambda: general_path_trace_batch(
        compiled, cam, integ.sampler, integ.light_sampler, pxy, 1, max_depth=integ.max_depth,
        rr_depth=integ.rr_depth, rr_threshold=integ.rr_threshold), kernels, 1)
    rec = {"phase": "spectral", "scene": what, "spectrum": type(compiled.spectrum).__name__,
           "spectral_dim": compiled.plan.spectral_dim, "resolution": [w, h],
           "depth": integ.max_depth, "spp": cam.spp, "seconds": seconds,
           "compile_seconds": compile_seconds, "rays": integ.rays_traced,
           "mray_per_s": integ.rays_traced / seconds / 1e6, "bounces": integ.bounces_run,
           "fused_passes": integ.fused_passes, "launches": counts,
           "image_mean": float(img.mean()), "profile_one_sample": prof}
    return rec, img


def spectrum_ops(torch, compiled, n, device):
    """The spectrum layer's operations on n lanes, each timed alone
    (call_ops). The coefficient decodes read the scene's first matte and
    light rows."""
    spec = compiled.spectrum
    gen = torch.Generator(device=device).manual_seed(5)
    u = torch.rand((n, 1), device=device, generator=gen)
    swl = spec.sample_wavelengths(u)
    rgb = torch.rand((n, 3), device=device, generator=gen)
    vals = torch.rand((n, spec.dimension), device=device, generator=gen)
    surf = compiled.arrays["surfaces"][0]
    light = compiled.arrays["lights"][0]
    pick = torch.zeros(n, dtype=torch.long, device=device)
    ca = surf["kd__ca"][pick]
    ci, cis = light["emission__ci"][pick], light["emission__cis"][pick]
    fns = {
        "sample_wavelengths": lambda: spec.sample_wavelengths(u),
        "decode_albedo_coeffs": lambda: spec.decode_albedo_coeffs(ca, swl),
        "decode_illuminant_coeffs": lambda: spec.decode_illuminant_coeffs(ci, cis, swl),
        "decode_albedo_per_ray": lambda: spec.decode_albedo(rgb, swl),
        "decode_illuminant_per_ray": lambda: spec.decode_illuminant(rgb, swl),
        "srgb": lambda: spec.srgb(vals, swl),
    }
    return call_ops(torch, fns)


def ratio(a, b):
    return None if a is None or b is None or b == 0 else a / b


def phase_spectral(torch, lt, brute, fp, device):
    """The hero spectrum on the general fork: (a) scenes/cornell_spectral.json
    at its own size (512^2, depth 8, hero of 4 wavelengths; spp cut to
    SPECTRAL_SPP) through render, beside scenes/cornell.json (sRGB) on the
    general fork at the same spp; (b) the brute kernels on the 16 inputs of
    one hero sample, bit for bit against their plain versions; (c) the
    48^2, 8-spp render against tests/golden/cornell_spectral_48_8spp.exr;
    (d) testing.mesh_heavy at full size under hero, its Disney spheres
    plastic of the same colour, against the same scene in sRGB by the
    reference's spectral-versus-RGB rule (mean relative error under 0.25)."""
    from luisarender_tpu_torch import testing
    from luisarender_tpu_torch.utils import imageio

    recs = {}
    # (a) the spectral Cornell box and the sRGB one, both on the general fork
    scene = lt.Scene.from_dict(spectral_dict(SPECTRAL_SCENE, spp=SPECTRAL_SPP))
    recs["cornell"], _ = spectral_render(torch, lt, brute, fp, scene, device,
                                         "scenes/cornell_spectral.json", "brute")
    check(recs["cornell"]["spectral_dim"] == 4, "spectral: not 4 wavelengths a path")
    recs["cornell"]["cut"] = {"spp": [256, SPECTRAL_SPP]}
    srgb_scene = lt.Scene.from_dict(spectral_dict(MAIN_SCENE, spp=SPECTRAL_SPP))
    recs["cornell_srgb"], _ = spectral_render(torch, lt, brute, fp, srgb_scene, device,
                                              "scenes/cornell.json", "brute", no_fused=True)
    recs["cornell_srgb"]["cut"] = {"spp": [256, SPECTRAL_SPP]}
    compiled = lt.compile_scene(scene, device=device)
    recs["cornell"]["spectrum_ops"] = spectrum_ops(torch, compiled, 512 * 512, device)

    # (b) the brute kernels on one hero sample's 16 inputs
    cap = capture_main_path_inputs(torch, brute, compiled, scene,
                                   max_depth=scene.integrator.max_depth)
    kern = {}
    for kind in ("closest", "any"):
        fn_k = brute.closest if kind == "closest" else brute.any_hit
        errs, fracs, ms = [], [], []
        for args in cap[kind]:
            err, frac = compare_case(torch, brute, kind, args)
            errs.append(max(err))
            fracs.append(frac)
            ms.append(device_ms(torch, lambda: fn_k(*args), iters=20))
        kern[kind] = {"inputs": len(cap[kind]), "max_abs_err": max(errs),
                      "hit_fraction": fracs, "ms": ms, "sample_ms": sum(ms)}
    del cap, compiled
    recs["kernels"] = {"phase": "spectral", "what": "brute kernels on one hero sample",
                       "n": 512 * 512, "rows": 32, **kern}

    # (c) the golden: the reference's CPU render
    gscene = lt.Scene.from_dict(spectral_dict(SPECTRAL_SCENE, res=48, spp=8, depth=8))
    gimg = lt.render(gscene, device=device)["cornell_spectral.exr"]
    check(gscene.integrator.fused_passes == 0, "spectral golden: took the fused fork")
    gref = imageio.load_exr(str(SPECTRAL_GOLDEN))
    check_image(gimg, 48, 48, "spectral golden")
    gfrac, grel = frac_off(gimg, gref), float(gimg.mean() / gref.mean() - 1.0)
    recs["golden"] = {"phase": "spectral", "what": "golden cornell_spectral 48^2, 8 spp",
                      "frac_pixels_off": gfrac, "mean_rel_diff": grel}

    # (d) the mesh-heavy scene at full size, hero and sRGB
    hscene = lt.Scene.from_dict(testing.hero(testing.mesh_heavy(**MESH_HEAVY)))
    recs["mesh_heavy"], himg = spectral_render(torch, lt, brute, fp, hscene, device,
                                               "testing.mesh_heavy, hero", "cluster")
    sscene = lt.Scene.from_dict(testing.plastic_for_disney(testing.mesh_heavy(**MESH_HEAVY)))
    recs["mesh_heavy_srgb"], simg = spectral_render(torch, lt, brute, fp, sscene, device,
                                                    "testing.mesh_heavy, sRGB", "cluster")
    rel_err = float(np.abs(himg - simg).mean() / max(float(np.abs(simg).mean()), 1e-6))
    recs["mesh_heavy"].update({"triangles": 512_004, "cut": None,
                               "mean_rel_err_vs_srgb": rel_err})

    for hero_key, srgb_key in (("cornell", "cornell_srgb"), ("mesh_heavy", "mesh_heavy_srgb")):
        ph = recs[hero_key]["profile_one_sample"]
        ps = recs[srgb_key]["profile_one_sample"]
        recs[hero_key]["hero_over_srgb"] = {
            "seconds": ratio(recs[hero_key]["seconds"], recs[srgb_key]["seconds"]),
            "device_ms_a_sample": ratio(ph["device_busy_ms"], ps["device_busy_ms"]),
            "wall_ms_a_sample": ratio(ph["wall_ms"], ps["wall_ms"]),
        }
    for key in ("cornell", "cornell_srgb", "kernels", "golden", "mesh_heavy", "mesh_heavy_srgb"):
        emit(recs[key])
    check(gfrac < 0.02 and abs(grel) < 0.005,
          f"spectral golden: {gfrac:.4f} of pixels off, mean off by {grel:.5f}")
    check(rel_err < 0.25, f"spectral mesh_heavy: mean relative error {rel_err:.4f} against sRGB")
    return recs


# --------------------------------------------------------------------------
# phase 9: image textures, the sky, textured emission, Loop subdivision
# --------------------------------------------------------------------------

SKY_SCENE = ROOT / "scenes" / "sky.json"
SKY_GOLDEN = ROOT / "tests" / "golden" / "sky_64x36_8spp.exr"
TEXTURED_GOLDEN = ROOT / "tests" / "golden" / "cornell_textured_48_8spp.exr"
# sky.json's spp, cut from the file's 256 as the other general-fork renders are cut
SKY_SPP = 32
TEXTURED_ENVS = ("nishitasky", "image")


def sky_dict(res=None, spp=None):
    with open(SKY_SCENE) as f:
        d = json.load(f)
    cam = d["render"]["cameras"][0]["prop"]
    if res is not None:
        cam["film"]["prop"]["resolution"] = list(res)
    if spp is not None:
        cam["spp"] = spp
    return d


def golden_check(img, path, w, h, what):
    """An image against a golden of the reference's CPU render: under 2% of
    pixels off by more than 1e-3, the mean within 0.5%."""
    from luisarender_tpu_torch.utils import imageio

    ref = imageio.load_exr(str(path))
    check_image(img, w, h, what)
    frac, rel = frac_off(img, ref), float(img.mean() / ref.mean() - 1.0)
    check(frac < 0.02 and abs(rel) < 0.005,
          f"{what}: {frac:.4f} of pixels off the golden, mean off by {rel:.5f}")
    return {"frac_pixels_off": frac, "mean_rel_diff": rel}


def texture_ops(torch, compiled, scene, device):
    """The image texture's lookups on the first hits of a sample's camera
    rays (every pixel's lane, with its ray-cone footprint), as the general
    fork makes them: evaluate_rows on every lane with the lane's Disney
    colour handle (lanes that hit no textured sphere read a clamped row),
    timed by CUDA events (host dispatch included) and the profiler's device
    time; and the lookups' calls in one sample of the render."""
    from luisarender_tpu_torch.accel import traverse
    from luisarender_tpu_torch.integrators.mega_path import (
        camera_rays, general_path_trace_batch, pixel_grid,
    )
    from luisarender_tpu_torch.scene.geometry import surface_interaction
    from luisarender_tpu_torch.textures.base import HANDLE_INDEX_MASK
    from luisarender_tpu_torch.textures.image import ImageTexture

    cam, integ = scene.cameras[0], scene.integrator
    w, h = cam.film.resolution
    pxy = pixel_grid(w, h, device)
    _, ray, _ = camera_rays(cam, integ.sampler, pxy, 0)
    hit = traverse.trace_closest(compiled.trace_geometry(), ray)
    width0, spread = cam.ray_cone()
    cone = width0 + spread * torch.where(torch.isfinite(hit.t), hit.t, 0.0)
    it = surface_interaction(compiled.arrays, hit, ray, needs_uv=True, cone_width=cone)
    inst = compiled.arrays["instances"]
    lane_inst = torch.clamp(it.inst, min=0).long()
    disney = [c.impl_names[0] for c in compiled.plan.surface_types].index("disney")
    rows = compiled.arrays["surfaces"][disney]["color__h"]
    sidx = torch.clamp(inst["surface_index"][lane_inst].long(), max=rows.shape[0] - 1)
    textured = it.valid & (inst["surface_tag"][lane_inst] == disney)
    handles = torch.where(textured, rows[sidx], -1)
    index = handles & HANDLE_INDEX_MASK

    def lookups():
        return ImageTexture.evaluate_rows(compiled, index, it)

    out = lookups()
    check(out.shape == (w * h, 4) and bool(torch.isfinite(out[textured]).all()),
          "textured mesh_heavy: image lookups not finite")
    prof = profile_one(torch, lookups, ("",), 10)
    calls = [0]
    orig = ImageTexture.evaluate_rows

    def counted(*args, **kw):
        calls[0] += 1
        return orig(*args, **kw)

    ImageTexture.evaluate_rows = staticmethod(counted)
    try:
        general_path_trace_batch(compiled, cam, integ.sampler, integ.light_sampler, pxy, 1,
                                 max_depth=integ.max_depth, rr_depth=integ.rr_depth,
                                 rr_threshold=integ.rr_threshold)
    finally:
        ImageTexture.evaluate_rows = staticmethod(orig)
    return {"lanes": w * h, "textured_first_hit_lanes": int(textured.sum()),
            "footprint_median_textured": float(it.footprint[textured].median()),
            "events_ms": events_ms(torch, lookups, 10),
            "device_ms": prof["device_busy_ms"], "device_ops": prof["device_ops"],
            "calls_a_sample": calls[0]}


def phase_textures(torch, lt, brute, fp, device, main_recs):
    """Image textures, the Nishita sky, textured emission and Loop
    subdivision: (a) scenes/sky.json at its own 960 x 540, depth 6 (thin
    lens, the sky, a loopsubdiv glass, a copper sphere; spp cut to SKY_SPP)
    through render on the general fork with the brute kernels, the brute
    kernels on the inputs of one sample's first four bounces bit for bit
    against their plain versions, and its 64 x 36, 8-spp render against tests/golden/
    sky_64x36_8spp.exr; (b) testing.mesh_heavy(textured=True) at 1280 x
    720, depth 5, 4 spp, nothing cut, on the cluster kernels beside phase
    4's untextured render, the image lookups of a sample's first hits, and
    its two-level form at 1 spp; (c) the env Cornell box with the sky and
    the EXR sun map (env_scene `nishitasky`, `image`; their kernel checks
    are phase 3's) through render at 512^2, depth 8, 256 spp with one
    environment-mode launch a sample, and each of 8 samples at 64^2 against
    the general fork; (d) testing.cornell_textured (48^2, 8 spp, a textured
    back wall and light) against tests/golden/cornell_textured_48_8spp.exr."""
    from luisarender_tpu_torch import testing
    from luisarender_tpu_torch.integrators.mega_path import (
        general_path_trace_batch, path_trace_batch, pixel_grid,
    )

    recs = {}
    # (a) scenes/sky.json; loading it precomputes the sky (numpy, the host)
    t0 = time.perf_counter()
    scene = lt.Scene.from_dict(sky_dict(spp=SKY_SPP))
    load_seconds = time.perf_counter() - t0
    rec, _ = spectral_render(torch, lt, brute, fp, scene, device, "scenes/sky.json", "brute")
    compiled = lt.compile_scene(scene, device=device)
    check(compiled.plan.num_tris == 258 and not scene.environment.constant
          and not compiled.plan.needs_footprint,
          f"sky.json: {compiled.plan.num_tris} triangles, constant sky "
          f"{scene.environment.constant}")
    # four bounces: every path of a sample may end before the file's depth 6
    cap = capture_main_path_inputs(torch, brute, compiled, scene, max_depth=4)
    kern = {}
    for kind in ("closest", "any"):
        errs = [max(compare_case(torch, brute, kind, args)[0]) for args in cap[kind]]
        kern[kind] = {"inputs": len(cap[kind]), "max_abs_err": max(errs)}
    del cap, compiled
    gscene = lt.Scene.from_dict(sky_dict(res=(64, 36), spp=8))
    gimg = lt.render(gscene, device=device)["sky.exr"]
    rec.update({"phase": "textures", "cut": {"spp": [256, SKY_SPP]}, "kernels": kern,
                "load_seconds_with_sky_precompute": load_seconds,
                "golden": golden_check(gimg, SKY_GOLDEN, 64, 36, "sky golden")})
    recs["sky"] = rec
    emit(rec)

    # (b) the textured mesh-heavy scene, flat and two-level
    scene = lt.Scene.from_dict(testing.mesh_heavy(**MESH_HEAVY, textured=True))
    rec, img = spectral_render(torch, lt, brute, fp, scene, device,
                               "testing.mesh_heavy(textured=True)", "cluster")
    compiled = lt.compile_scene(scene, device=device)
    check(compiled.plan.needs_footprint and compiled.plan.num_tris == 512_004,
          "textured mesh_heavy: no image texture or not 512,004 triangles")
    atlas = compiled.arrays["texture_atlas"]
    plain = main_recs["mesh_heavy"]
    rec.update({"phase": "textures", "cut": None, "triangles": 512_004,
                "atlas_shape": list(atlas.shape), "atlas_bytes": atlas.numel() * 4,
                "texture_ops": texture_ops(torch, compiled, scene, device),
                "untextured": {k: plain[k] for k in ("seconds", "mray_per_s", "rays",
                                                     "image_mean")},
                "mean_rel_vs_untextured": float(img.mean() / plain["image_mean"] - 1.0)})
    del compiled
    recs["mesh_heavy"] = rec
    emit(rec)
    tl = testing.mesh_heavy(**{**MESH_HEAVY, "spp": 1}, textured=True, accel="twolevel")
    tl_rec, _, _ = twolevel_render(torch, lt, brute, fp, lt.Scene.from_dict(tl), device,
                                   "textured mesh_heavy two-level",
                                   {"two_level": True, "fused_path": False})
    recs["mesh_heavy_twolevel"] = {"phase": "textures",
                                   "scene": "testing.mesh_heavy(textured=True, twolevel)",
                                   **tl_rec}
    emit(recs["mesh_heavy_twolevel"])

    # (c) the env Cornell box under maps that are not constant
    pxy = pixel_grid(64, 64, device)
    kw = dict(max_depth=5, rr_depth=0, rr_threshold=0.95)
    for kind in TEXTURED_ENVS:
        scene = env_scene(lt, kind, res=512, spp=256, depth=8)
        cam, integ = scene.cameras[0], scene.integrator
        img, seconds, counts = render_counted(torch, lt, brute, fp, scene, device)
        check_image(img, 512, 512, f"env cornell {kind}")
        others = {k: v for k, v in counts.items() if k != "fused_path_env"}
        check(counts["fused_path_env"] == cam.spp and not any(others.values())
              and not scene.environment.constant,
              f"env cornell {kind}: launches {counts}, spp {cam.spp}")
        escene = env_scene(lt, kind, res=64, spp=8, depth=5)
        ecompiled = lt.compile_scene(escene, device=device)
        offs = []
        for si in range(8):
            args = (ecompiled, escene.cameras[0], escene.integrator.sampler,
                    escene.integrator.light_sampler, pxy, si)
            rgb_f, _, st_f = path_trace_batch(*args, with_stats=True, **kw)
            rgb_g, _, st_g = general_path_trace_batch(*args, **kw)
            rays_f, rays_g = int(st_f["rays"]), int(st_g["rays"])
            off = frac_off(rgb_f.cpu(), rgb_g.cpu())
            offs.append(off)
            check(st_f["fused"] == 1, f"env {kind} sample {si}: not on the fused fork")
            check(abs(rays_f - rays_g) <= max(8, rays_g // 500),
                  f"env {kind} sample {si}: rays {rays_f} vs {rays_g}")
            check(off < 0.02, f"env {kind} sample {si}: {off:.4f} of pixels off")
        recs[f"env_{kind}"] = {
            "phase": "textures", "scene": f"testing.cornell_box + {kind}",
            "resolution": [512, 512], "depth": 8, "spp": cam.spp, "cut": None,
            "seconds": seconds, "rays": integ.rays_traced,
            "mray_per_s": integ.rays_traced / seconds / 1e6, "launches": counts,
            "image_mean": float(img.mean()), "per_sample_frac_off_64": offs}
        emit(recs[f"env_{kind}"])

    # (d) the textured Cornell box against its golden
    scene = lt.Scene.from_dict(testing.cornell_textured(resolution=(48, 48), spp=8, depth=5))
    img, seconds, counts = render_counted(torch, lt, brute, fp, scene, device)
    integ = scene.integrator
    check(integ.fused_passes == 0 and counts["brute_closest"] == integ.bounces_run
          == counts["brute_any"] > 0, f"textured cornell: launches {counts}")
    recs["cornell_textured"] = {"phase": "textures", "scene": "testing.cornell_textured",
                                "resolution": [48, 48], "spp": 8, "depth": 5,
                                "seconds": seconds, "launches": counts,
                                **golden_check(img, TEXTURED_GOLDEN, 48, 48,
                                               "textured cornell golden")}
    emit(recs["cornell_textured"])
    return recs


# --------------------------------------------------------------------------
# phase 10: mix and layered surfaces, normal maps, the text SDL, motion blur
# and checkpoints
# --------------------------------------------------------------------------

LUISA_SCENE = ROOT / "scenes" / "cornell.luisa"
# the coated and motion-blur Cornell boxes' spp, cut from 256 as the other
# general-fork renders are cut
COATED_SPP = 8
MOTION_SPP = 32
MOTION_BUCKETS = 6
# the motion-blur bucket whose fused launch is held against the plain version
MOTION_HELD_BUCKET = 2


def hold_fused_sample(torch, fp, compiled, scene, device, what, shutter_time=0.0):
    """The fused kernel on one sample of every pixel of a compiled scene,
    its camera posed at `shutter_time`, bit for bit against its plain
    version; its device time, the plain version's and the bound."""
    from luisarender_tpu_torch.integrators.mega_path import pixel_grid

    cam_node, integ = scene.cameras[0], scene.integrator
    check(compiled.plan.fused_path, f"{what}: the fused kernel does not cover it")
    cam = fp.camgen_params(cam_node, integ.sampler.seed, time=shutter_time)
    check(cam is not None, f"{what}: no in-kernel camera")
    w, h = cam_node.film.resolution
    pxy = pixel_grid(w, h, device)
    kw = dict(max_depth=integ.max_depth, rr_depth=integ.rr_depth,
              rr_threshold=integ.rr_threshold)
    tables = fp.fused_tables(compiled)
    rgb_k, rays_k = fp.paths(tables, cam, pxy, 0, 0, **kw)
    torch.cuda.synchronize()
    (rgb_p, rays_p), counts, plain_ms = fused_work(torch, fp, tables, cam, pxy, 0, kw)
    share, err, _ = bit_equal(torch, f"fused {what}", rgb_k, rays_k, rgb_p, rays_p)
    check(bool(torch.isfinite(rgb_k).all()) and float(rgb_k.mean()) > 0.0,
          f"fused {what}: non-finite or black")
    ms = device_ms(torch, lambda: fp.paths(tables, cam, pxy, 0, 0, **kw), iters=20)
    return {"n": pxy.shape[0], "depth": integ.max_depth, "rays": int(rays_k.sum()),
            "share_bit_equal": share, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **fused_bound(tables, counts, pxy.shape[0])}


def timed_compiles():
    """Wrap scene/compiler.py compile_scene, which the shutter buckets call
    (integrators/base.py), to record each call's shutter time and seconds;
    returns (records, undo)."""
    import torch
    from luisarender_tpu_torch.scene import compiler

    orig, recs, clock = compiler.compile_scene, [], time.perf_counter

    def timed(scene, device=None, time=0.0):
        torch.cuda.synchronize()
        t0 = clock()
        out = orig(scene, device=device, time=time)
        torch.cuda.synchronize()
        recs.append({"time": float(time), "seconds": clock() - t0})
        return out

    compiler.compile_scene = timed

    def undo():
        compiler.compile_scene = orig

    return recs, undo


def checkpoint_resume(torch, lt, device):
    """testing.cornell_box at 64^2, 8 spp, on the card: rendered whole, then
    interrupted after its first pass of 4 samples (the checkpoint written
    then), then resumed; the resumed image must equal the whole one bit for
    bit."""
    import tempfile

    from luisarender_tpu_torch import testing
    from luisarender_tpu_torch.integrators import mega_path

    class Interrupted(Exception):
        pass

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "film.npz")

        def scene():
            d = testing.cornell_box(resolution=(64, 64), spp=8, depth=5)
            d["render"]["integrator"]["prop"].update(
                {"checkpoint_file": ckpt, "checkpoint_interval": 4, "samples_per_pass": 4})
            return lt.Scene.from_dict(d)

        t0 = time.perf_counter()
        whole = lt.render(scene(), device=device)["cornell.exr"]
        whole_seconds = time.perf_counter() - t0
        os.remove(ckpt)
        orig = mega_path.path_trace_batch

        def interrupted(*args, **kw):
            if args[5] == 4:
                raise Interrupted
            return orig(*args, **kw)

        mega_path.path_trace_batch = interrupted
        try:
            lt.render(scene(), device=device)
            check(False, "checkpoint: the interrupted render ran to its end")
        except Interrupted:
            pass
        finally:
            mega_path.path_trace_batch = orig
        done_at_interrupt = int(np.load(ckpt)["done"])
        resumed_scene = scene()
        t0 = time.perf_counter()
        resumed = lt.render(resumed_scene, device=device)["cornell.exr"]
        resumed_seconds = time.perf_counter() - t0
    check(done_at_interrupt == 4, f"checkpoint: {done_at_interrupt} spp at the interrupt")
    check(resumed_scene.integrator.fused_passes == 4,
          f"checkpoint: the resumed render ran {resumed_scene.integrator.fused_passes} samples")
    equal = bool(np.array_equal(resumed, whole))
    check(equal, "checkpoint: the resumed image differs from the whole render "
                 f"(max |d| {float(np.abs(resumed - whole).max())})")
    check_image(whole, 64, 64, "checkpoint")
    return {"phase": "surfaces", "what": "checkpoint resume, testing.cornell_box 64^2, 8 spp",
            "done_at_interrupt": done_at_interrupt, "bit_equal": equal,
            "whole_seconds": whole_seconds, "resumed_seconds": resumed_seconds}


def phase_surfaces(torch, lt, brute, fp, device):
    """Mix and layered surfaces, normal maps, glass with a varying eta, the
    text SDL, motion blur and checkpoints: (i) testing.cornell_coated (512^2,
    depth 8, spp cut to COATED_SPP: a closed-form coat over gold, the
    stochastic walk over matte, a mix of matte and plastic by a checkerboard,
    a normal-mapped floor, a glass sphere with a checkerboard eta) through
    render on the general fork with both brute kernels once a bounce and
    nothing else, and the brute kernels on one sample's first four bounces
    bit for bit against their plain versions; (ii) scenes/cornell.luisa
    through render_file at its own 512^2, depth 8, 256 spp, one fused
    launch a sample, against scenes/cornell.json's render by the
    reference's rule, its fused tables equal to cornell.json's, and the
    fused kernel on one sample against its plain version; (iii)
    testing.cornell_motion (the short block under lerp, shutter [0, 1] in
    MOTION_BUCKETS buckets, 512^2, depth 8, MOTION_SPP spp): a compile and a
    fused render a bucket, each compile timed, and the fused kernel on one
    bucket's sample against its plain version; (iv) a checkpoint resume at
    64^2, 8 spp, bit for bit."""
    from luisarender_tpu_torch import testing

    recs = {}
    # (i) the coated Cornell box
    scene = lt.Scene.from_dict(testing.cornell_coated(spp=COATED_SPP))
    rec, _ = spectral_render(torch, lt, brute, fp, scene, device, "testing.cornell_coated",
                             "brute")
    compiled = lt.compile_scene(scene, device=device)
    names = [c.impl_names[0] for c in compiled.plan.surface_types]
    glass = compiled.arrays["surfaces"][names.index("glass")]
    check(compiled.plan.any_normal_maps and compiled.plan.num_tris == 32
          and compiled.plan.num_spheres == 1 and "layered<MatteSurface,k=10>" in names
          and "layered<MetalSurface,k=0>" in names
          and "mix<MatteSurface,PlasticSurface>" in names
          and float(glass["cauchy_a"][0]) == 1.5 and float(glass["cauchy_b"][0]) == 0.0,
          f"coated cornell: types {names}, plan {compiled.plan.any_normal_maps}")
    cap = capture_main_path_inputs(torch, brute, compiled, scene, max_depth=4)
    kern = hold_brute_inputs(torch, brute, cap)
    del cap, compiled
    rec.update({"phase": "surfaces", "surface_types": names, "cut": {"spp": [256, COATED_SPP]},
                "kernels": kern})
    recs["coated"] = rec
    emit(rec)

    # (ii) the text SDL's Cornell box beside the JSON one
    reset_counts(brute, fp)
    t0 = time.perf_counter()
    images = lt.render_file(str(LUISA_SCENE), save=False, device=device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts(brute, fp)
    luisa = lt.load_scene(str(LUISA_SCENE))
    cam = luisa.cameras[0]
    img = images[cam.file]
    check_image(img, 512, 512, "cornell.luisa")
    others = {k: v for k, v in counts.items() if k != "fused_path"}
    check(counts["fused_path"] == cam.spp == 256 and not any(others.values()),
          f"cornell.luisa: launches {counts}")
    json_scene = lt.load_scene(str(MAIN_SCENE))
    img_json, json_seconds, _ = render_counted(torch, lt, brute, fp, json_scene, device)
    frac, rel = frac_off(img, img_json), float(img.mean() / img_json.mean() - 1.0)
    t_luisa = fp.fused_tables(lt.compile_scene(luisa, device=device))
    compiled_json = lt.compile_scene(json_scene, device=device)
    t_json = fp.fused_tables(compiled_json)
    same_tables = all(torch.equal(getattr(t_luisa, k), getattr(t_json, k))
                      for k in ("tri", "shade", "sph", "inst", "entry", "light"))
    check(same_tables and len(luisa.shapes) == len(json_scene.shapes),
          "cornell.luisa: its fused tables differ from cornell.json's")
    compiled_luisa = lt.compile_scene(luisa, device=device)
    held = hold_fused_sample(torch, fp, compiled_luisa, luisa, device, "cornell.luisa")
    rays = held["rays"] * cam.spp  # a sample's rays, the same every sample in count
    recs["luisa"] = {"phase": "surfaces", "scene": "scenes/cornell.luisa (render_file)",
                     "resolution": [512, 512], "depth": 8, "spp": cam.spp, "cut": None,
                     "seconds": seconds, "launches": counts, "image_mean": float(img.mean()),
                     "json_seconds": json_seconds, "frac_pixels_off_vs_json": frac,
                     "mean_rel_diff_vs_json": rel,
                     "max_abs_diff_vs_json": float(np.abs(img - img_json).max()),
                     "fused_tables_equal_json": same_tables,
                     "mray_per_s_estimate": rays / seconds / 1e6, "kernel": held}
    emit(recs["luisa"])
    check(frac < 0.02 and abs(rel) < 0.005,
          f"cornell.luisa: {frac:.4f} of pixels off cornell.json's, mean off by {rel:.5f}")

    # (iii) motion blur: a compile and a fused render a shutter bucket
    scene = lt.Scene.from_dict(testing.cornell_motion(spp=MOTION_SPP,
                                                      shutter_samples=MOTION_BUCKETS))
    integ, cam = scene.integrator, scene.cameras[0]
    compiles, undo = timed_compiles()
    try:
        img, seconds, counts = render_counted(torch, lt, brute, fp, scene, device)
    finally:
        undo()
    check_image(img, 512, 512, "motion blur")
    times, _ = cam.shutter_weights(MOTION_BUCKETS)
    others = {k: v for k, v in counts.items() if k != "fused_path"}
    check([c["time"] for c in compiles] == [float(t) for t in times]
          and counts["fused_path"] == integ.fused_passes == MOTION_BUCKETS * MOTION_SPP
          and not any(others.values()),
          f"motion blur: compiles {compiles}, launches {counts}")
    t_held = float(times[MOTION_HELD_BUCKET])
    compiled_t = lt.compile_scene(scene, device=device, time=t_held)
    compiled_0 = lt.compile_scene(scene, device=device, time=0.0)

    def block_min_x(c):
        # the short block's (instance 5) rows of the trace table, whose order
        # follows the tree of each compile (shade_table column 31: instance)
        tr = c.arrays["trace"]
        return float(tr["tri_v0"][tr["shade_table"][:, 31].long() == 5, 0].min())

    moved = block_min_x(compiled_t) - block_min_x(compiled_0)
    check(abs(moved - 120.0 * t_held) < 1e-2, f"motion blur: the block moved {moved}")
    held = hold_fused_sample(torch, fp, compiled_t, scene, device,
                             f"motion blur bucket {MOTION_HELD_BUCKET}", shutter_time=t_held)
    recs["motion"] = {"phase": "surfaces", "scene": "testing.cornell_motion",
                      "resolution": [512, 512], "depth": 8, "spp": MOTION_SPP,
                      "buckets": MOTION_BUCKETS, "cut": {"spp": [256, MOTION_SPP]},
                      "seconds": seconds, "rays": integ.rays_traced,
                      "mray_per_s": integ.rays_traced / seconds / 1e6,
                      "bucket_compiles": compiles, "launches": counts,
                      "image_mean": float(img.mean()), "held_bucket_time": t_held,
                      "held_bucket_block_shift": moved, "kernel": held}
    emit(recs["motion"])

    # (iv) a checkpoint resume
    recs["checkpoint"] = checkpoint_resume(torch, lt, device)
    emit(recs["checkpoint"])
    return recs


# --------------------------------------------------------------------------
# phase 11: the low-discrepancy samplers
# --------------------------------------------------------------------------

SAMPLERS = ("paddedsobol", "sobol", "zsobol", "pmj02bn", "tileshared")
SAMPLER_GOLDEN = ROOT / "tests" / "golden" / "cornell_{}_32_4spp.exr"
# scenes/cornell.json's spp under a low-discrepancy sampler, cut from 256 as
# the other general-fork renders are cut (to 8, from 32, to make room for
# the media and aux phases)
SAMPLER_SPP = 8
# the draws a bounce takes (integrators/common.py bounce_step): u_sel,
# u_light, u_lobe, u_bsdf, u_rr
BOUNCE_DRAWS = ("1d", "2d", "1d", "2d", "1d")


def call_ops(torch, fns, iters=10):
    """Each fn of fns timed alone: the profiler's device ms and device ops a
    call (None where it traces no device work) and the CUDA events' ms a
    call, host dispatch included."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evts = device_events(prof)
        busy = sum(e.device_time_total for e in evts) / iters / 1e3
        out[name] = {"device_ms": busy or None,
                     "device_ops": sum(e.count for e in evts) / iters if busy else None,
                     "events_ms": events_ms(torch, fn, iters)}
    return out


def sampler_draws(sampler, pxy, sample_index):
    """A path's state and draws: start, the filter's 2D draw, one bounce's
    (BOUNCE_DRAWS); returns (state, [draws])."""
    state = sampler.start(pxy, sample_index)
    state, u = sampler.generate_pixel_2d(state)
    draws = [u]
    for op in BOUNCE_DRAWS:
        state, u = getattr(sampler, "generate_" + op)(state)
        draws.append(u)
    return state, draws


def phase_samplers(torch, lt, brute, fp, device, spectral):
    """The five low-discrepancy samplers (samplers/lds.py), on the general
    fork with the brute kernels: (i) the Sobol direction table's first
    build (1,024 dimensions, core/sobolgen.py) timed; (ii) each sampler's
    Cornell box (32^2, 4 spp, depth 4) against its golden; (iii)
    scenes/cornell.json (512^2, depth 8, spp cut to SAMPLER_SPP) under
    zsobol and pmj02bn through render, both brute kernels once a bounce and
    nothing else, with the records of phase 8 beside phase 8's independent
    render of the same scene on the general fork; (iv) the brute kernels on
    one zsobol sample's 16 inputs bit for bit against their plain versions;
    (v) each sampler's device ops and ms a call on 512^2 lanes; (vi) each
    sampler's states and draws on the card bit-equal with the same draws on
    the CPU (256^2 pixels, two sample indices)."""
    from luisarender_tpu_torch import testing
    from luisarender_tpu_torch.core import cache, sobolgen
    from luisarender_tpu_torch.integrators.mega_path import pixel_grid

    recs = {}
    # (i) the Sobol table: its first build on this machine's host
    path = cache.table_path("sobol_matrices_1024_20180813_jk64", ("sobolgen.py",))
    cached = path.exists()
    t0 = time.perf_counter()
    table = sobolgen.sobol_matrices(1024)
    recs["sobol_table"] = {"phase": "samplers", "what": "sobol_matrices(1024)",
                           "seconds": time.perf_counter() - t0, "was_cached": cached,
                           "shape": list(table.shape)}
    emit(recs["sobol_table"])

    # (ii) the goldens
    goldens = {}
    for impl in SAMPLERS:
        scene = lt.Scene.from_dict(testing.with_sampler(
            testing.cornell_box(resolution=(32, 32), spp=4, depth=4), impl))
        img, seconds, counts = render_counted(torch, lt, brute, fp, scene, device)
        integ = scene.integrator
        check(integ.fused_passes == 0 and counts["brute_closest"] == integ.bounces_run > 0,
              f"{impl} golden: fused passes {integ.fused_passes}, launches {counts}")
        goldens[impl] = {"seconds": seconds, **golden_check(
            img, str(SAMPLER_GOLDEN).format(impl), 32, 32, f"{impl} golden")}
    recs["goldens"] = {"phase": "samplers", "what": "cornell_box 32^2, 4 spp, depth 4",
                       **goldens}
    emit(recs["goldens"])

    # (iii) the 512^2 Cornell box under zsobol and pmj02bn
    for impl in ("zsobol", "pmj02bn"):
        scene = lt.Scene.from_dict(
            testing.with_sampler(spectral_dict(MAIN_SCENE, spp=SAMPLER_SPP), impl))
        rec, _ = spectral_render(torch, lt, brute, fp, scene, device,
                                 f"scenes/cornell.json, {impl}", "brute")
        indep = spectral["cornell_srgb"]
        rec.update({"phase": "samplers", "sampler": impl, "cut": {"spp": [256, SAMPLER_SPP]},
                    "independent": {k: indep[k] for k in ("seconds", "rays", "mray_per_s")},
                    "independent_profile_one_sample": indep["profile_one_sample"]})
        recs[impl] = rec
        emit(rec)

    # (iv) the brute kernels on one zsobol sample's inputs
    scene = lt.Scene.from_dict(testing.with_sampler(spectral_dict(MAIN_SCENE), "zsobol"))
    compiled = lt.compile_scene(scene, device=device)
    cap = capture_main_path_inputs(torch, brute, compiled, scene,
                                   max_depth=scene.integrator.max_depth)
    recs["kernels"] = {"phase": "samplers", "what": "brute kernels on one zsobol sample",
                       "n": 512 * 512, **hold_brute_inputs(torch, brute, cap)}
    del cap, compiled
    emit(recs["kernels"])

    # (v) device ops and ms a call on 512^2 lanes; (vi) card against CPU
    pxy = pixel_grid(512, 512, device)
    small = pixel_grid(256, 256, device)
    ops, same = {}, {}
    for impl in ("independent",) + SAMPLERS:
        sampler = lt.Scene.from_dict(testing.with_sampler(
            testing.cornell_box(resolution=(8, 8), spp=1), impl)).integrator.sampler
        st = sampler.start(pxy, 3)
        ops[impl] = call_ops(torch, {
            "start": lambda: sampler.start(pxy, 3),
            "generate_1d": lambda: sampler.generate_1d(st),
            "generate_2d": lambda: sampler.generate_2d(st)})
        ops[impl]["ops_per_draw_2d"] = ratio(ops[impl]["generate_2d"]["device_ops"], 2)
        if impl == "independent":
            continue
        for si in (0, 5):
            s_k, d_k = sampler_draws(sampler, small, si)
            s_c, d_c = sampler_draws(sampler, small.cpu(), si)
            equal = (all(a.device.type == "cuda" and torch.equal(a.cpu(), b)
                         for a, b in zip(d_k, d_c))
                     and all(torch.equal(s_k[k].cpu(), s_c[k]) for k in s_c))
            check(equal, f"{impl}: the card's draws differ from the CPU's at sample {si}")
        same[impl] = True
    recs["draws"] = {"phase": "samplers", "what": "sampler calls on 512^2 lanes",
                     "ops": ops, "card_equals_cpu_256sq": same}
    emit(recs["draws"])
    return recs


# --------------------------------------------------------------------------
# phase 12: the wavefront integrator
# --------------------------------------------------------------------------

WAVE_GOLDEN = ROOT / "tests" / "golden" / "wavepath_32_8spp.exr"
# bench.py's Cornell configuration (cornell_1024_wavefront_paths)
WAVE_CORNELL = dict(resolution=(1024, 1024), spp=4, depth=5)
# the persistent kernel's lanes held against its plain version
WAVE_HELD_LANES = 65_536
# a pool a quarter of the image: four tiles, three starting past pixel 0
WAVE_SMALL_TILE = 1 << 18


def wave_render(torch, lt, brute, fp, scene, device, what):
    """render() with the counts read around it; the record's seconds,
    paths and Mpaths/s, and the pool's counters."""
    cam, integ = scene.cameras[0], scene.integrator
    w, h = cam.film.resolution
    img, seconds, counts = render_counted(torch, lt, brute, fp, scene, device)
    check_image(img, w, h, what)
    paths = w * h * cam.spp
    rec = {"phase": "wavefront", "scene": what, "resolution": [w, h], "spp": cam.spp,
           "depth": integ.max_depth, "state_count": integ.state_count,
           "seconds": seconds, "paths": paths, "mpaths_per_s": paths / seconds / 1e6,
           "rays": integ.rays_traced, "mray_per_s": integ.rays_traced / seconds / 1e6,
           "iterations": integ.iterations_run, "refills": integ.refills,
           "host_reads": integ.host_reads, "persistent_launches": integ.fused_passes,
           "launches": counts, "image_mean": float(img.mean())}
    return rec, img


def phase_wavefront(torch, lt, brute, fp, device, main_recs):
    """The wavepath integrator (integrators/wave_path.py): (i) bench.py's
    Cornell configuration (testing.cornell_box 1024^2, 4 spp, depth 5) on
    the fused pool, one persistent launch a tile and nothing else, the
    kernel on the tile's first WAVE_HELD_LANES lanes bit for bit against its
    plain version (its counters' traced lanes equal to the plain version's
    rays), the image bit-equal with megawave's (samples_per_pass 4: one
    launch of the same lanes), and so with a pool of WAVE_SMALL_TILE (four
    tiles); (ii) bench.py's mesh configuration
    (testing.mesh_heavy 1280 x 720, 4 spp, depth 5, flat, state_count 2^20:
    one tile of 921,600 slots) on the general pool, the cluster kernels once
    an iteration each and nothing else, its image against phase 4's megapath
    render by the goldens' rule; (iii) the wavepath golden (32^2, 8 spp, a
    pool of 256) on the general pool by the rule and on the fused pool by
    its mean, its samples against the general fork's by the rule of phase
    3."""
    from luisarender_tpu_torch import testing
    from luisarender_tpu_torch.integrators.mega_path import (
        general_path_trace_batch, path_trace_batch, pixel_grid,
    )
    from luisarender_tpu_torch.utils import imageio

    recs = {}
    # (i) the fused pool on bench.py's Cornell box
    scene = lt.Scene.from_dict(testing.cornell_box(**WAVE_CORNELL, integrator="wavepath"))
    rec, img = wave_render(torch, lt, brute, fp, scene, device, "testing.cornell_box wavepath")
    w, h = WAVE_CORNELL["resolution"]
    tiles = -(-w * h // scene.integrator.state_count)
    others = {k: v for k, v in rec["launches"].items() if k != "fused_path_persistent"}
    check(rec["launches"]["fused_path_persistent"] == rec["persistent_launches"] == tiles
          and rec["iterations"] == 0 and not any(others.values()),
          f"wavepath cornell: launches {rec['launches']}, tiles {tiles}")
    mega = lt.Scene.from_dict(testing.cornell_box(**WAVE_CORNELL, integrator="megawave"))
    img_mega, mega_seconds, _ = render_counted(torch, lt, brute, fp, mega, device)
    # tiles smaller than the image: each launch starts past pixel 0
    small = lt.Scene.from_dict(testing.wavepath(testing.cornell_box(**WAVE_CORNELL),
                                                state_count=WAVE_SMALL_TILE))
    small_rec, img_small = wave_render(torch, lt, brute, fp, small, device,
                                       "testing.cornell_box wavepath, small tiles")
    small_tiles = -(-w * h // WAVE_SMALL_TILE)
    rec.update({"tiles": tiles, "megawave_seconds": mega_seconds,
                "bit_equal_megawave": bool(np.array_equal(img, img_mega)),
                "max_abs_diff_megawave": float(np.abs(img - img_mega).max()),
                "small_tiles": {k: small_rec[k] for k in (
                    "state_count", "seconds", "mpaths_per_s", "persistent_launches")},
                "small_tiles_bit_equal_megawave": bool(np.array_equal(img_small, img_mega))})
    check(small_rec["launches"]["fused_path_persistent"] == small_tiles,
          f"wavepath cornell, small tiles: launches {small_rec['launches']}")
    compiled = lt.compile_scene(scene, device=device)
    integ = scene.integrator
    cam = fp.camgen_params(scene.cameras[0], integ.sampler.seed)
    pxy = pixel_grid(w, h, device)[:WAVE_HELD_LANES].contiguous()
    kw = dict(max_depth=integ.max_depth, rr_depth=integ.rr_depth,
              rr_threshold=integ.rr_threshold)
    tables = fp.fused_tables(compiled)
    spp = scene.cameras[0].spp
    rgb_k, rays_k = fp.paths(tables, cam, pxy, 0, spp, **kw)
    torch.cuda.synchronize()
    (rgb_p, rays_p), counts, plain_ms = fused_work(torch, fp, tables, cam, pxy, spp, kw)
    share, err, _ = bit_equal(torch, "wavepath persistent", rgb_k, rays_k, rgb_p, rays_p)
    stats = torch.zeros(len(fp.STATS), dtype=torch.int64, device=device)
    fp.paths(tables, cam, pxy, 0, spp, stats=stats, **kw)
    use = lane_use(stats)
    check(use["traced"] == counts["closest"],
          f"wavepath persistent: traced {use['traced']} != {counts['closest']}")
    rec["kernel"] = {"n": WAVE_HELD_LANES, "samples": spp, "share_bit_equal": share,
                     "max_abs_err": err,
                     "ms": device_ms(torch, lambda: fp.paths(tables, cam, pxy, 0, spp, **kw),
                                     iters=10),
                     "plain_ms": plain_ms, **fused_bound(tables, counts, WAVE_HELD_LANES),
                     "lane_use": use}
    recs["cornell"] = rec
    emit(rec)
    check(rec["bit_equal_megawave"] and rec["small_tiles_bit_equal_megawave"],
          "wavepath cornell: the image differs from megawave's "
          f"by up to {rec['max_abs_diff_megawave']}")
    del compiled, tables

    # (ii) the general pool on bench.py's mesh-heavy scene
    d = testing.wavepath(testing.mesh_heavy(**{**MESH_HEAVY, "accel": "flat"}),
                         state_count=1 << 20)
    scene = lt.Scene.from_dict(d)
    rec, img = wave_render(torch, lt, brute, fp, scene, device, "testing.mesh_heavy wavepath")
    launches = rec["launches"]
    others = {k: v for k, v in launches.items() if k not in ("cluster_closest", "cluster_any")}
    check(launches["cluster_closest"] == launches["cluster_any"] == rec["iterations"] > 0
          and rec["refills"] > 0 and not any(others.values()),
          f"wavepath mesh_heavy: launches {launches}, iterations {rec['iterations']}")
    ref = main_recs["mesh_heavy_image"]
    frac, rel = frac_off(img, ref), float(img.mean() / ref.mean() - 1.0)
    rec.update({"triangles": 512_004, "cut": None,
                "megapath_seconds": main_recs["mesh_heavy"]["seconds"],
                "megapath_mray_per_s": main_recs["mesh_heavy"]["mray_per_s"],
                "frac_pixels_off_megapath": frac, "mean_rel_diff_megapath": rel,
                "share_pixels_bit_equal_megapath": float((img == ref).all(-1).mean()),
                "rays_megapath": main_recs["mesh_heavy"]["rays"]})
    recs["mesh_heavy"] = rec
    emit(rec)
    check(frac < 0.02 and abs(rel) < 0.005,
          f"wavepath mesh_heavy: {frac:.4f} of pixels off megapath's, mean off by {rel:.5f}")
    # slot i serves its pixel's samples in order, each seeded by (pixel,
    # sample): the pool's image and ray count are megapath's, bit for bit
    check(rec["share_pixels_bit_equal_megapath"] == 1.0
          and rec["rays"] == rec["rays_megapath"],
          f"wavepath mesh_heavy: {rec['share_pixels_bit_equal_megapath']} of pixels "
          f"bit-equal with megapath's, rays {rec['rays']} != {rec['rays_megapath']}")

    # (iii) the golden on both pools
    golden = {"phase": "wavefront", "what": "golden wavepath 32^2, 8 spp, pool 256"}
    for pool in ("general", "fused"):
        d = testing.wavepath(testing.cornell_box(resolution=(32, 32), spp=8, depth=4),
                             state_count=256, iterations_per_launch=4)
        scene = lt.Scene.from_dict(d)
        if pool == "general":
            os.environ["LUISARENDER_TPU_NO_FUSED"] = "1"
        try:
            img, seconds, counts = render_counted(torch, lt, brute, fp, scene, device)
        finally:
            os.environ.pop("LUISARENDER_TPU_NO_FUSED", None)
        integ = scene.integrator
        check((integ.fused_passes == 0 and integ.refills > 0) if pool == "general"
              else (counts["fused_path_persistent"] == integ.fused_passes == 4),
              f"wavepath golden {pool}: launches {counts}")
        if pool == "general":
            golden[pool] = golden_check(img, WAVE_GOLDEN, 32, 32, "wavepath golden, general")
            continue
        ref = imageio.load_exr(str(WAVE_GOLDEN))
        frac, rel = frac_off(img, ref), float(img.mean() / ref.mean() - 1.0)
        # the fused fork's paths flip on rounding now and then against the
        # general fork's: held by the mean, and each sample by the rule of
        # phase 3 (tests/test_torch_wavefront.py)
        compiled = lt.compile_scene(scene, device=device)
        grid = pixel_grid(32, 32, device)
        kw = dict(max_depth=integ.max_depth, rr_depth=integ.rr_depth,
                  rr_threshold=integ.rr_threshold)
        worst = 0.0
        for si in range(8):
            args = (compiled, scene.cameras[0], integ.sampler, integ.light_sampler, grid, si)
            rgb_f, _, st_f = path_trace_batch(*args, with_stats=True, **kw)
            rgb_g, _, st_g = general_path_trace_batch(*args, **kw)
            worst = max(worst, frac_off(rgb_f.cpu().numpy(), rgb_g.cpu().numpy()))
            check(st_f["fused"] == 1 and abs(int(st_f["rays"]) - int(st_g["rays"]))
                  <= max(8, int(st_g["rays"]) // 500), f"wavepath golden fused: sample {si}")
        golden[pool] = {"frac_pixels_off": frac, "mean_rel_diff": rel,
                        "worst_sample_frac_lanes_off_general": worst}
        check(abs(rel) < 0.005 and worst < 0.02,
              f"wavepath golden fused: mean off by {rel:.5f}, a sample {worst:.4f} off")
    recs["golden"] = golden
    emit(golden)
    return recs


# --------------------------------------------------------------------------
# phase 13: the display film
# --------------------------------------------------------------------------


def phase_display(torch, lt, device):
    """testing.cornell_box 64^2 with the display film (aces, served on port
    0): /, /frame.png and /stats.json fetched from 127.0.0.1, the preview
    PNG written in a temporary directory, a preview a pass."""
    import tempfile
    import urllib.request

    from luisarender_tpu_torch import testing

    with tempfile.TemporaryDirectory() as tmp:
        preview = Path(tmp) / "preview.png"
        d = testing.cornell_box(resolution=(64, 64), spp=8, depth=5)
        d["render"]["cameras"][0]["prop"]["film"] = {"impl": "display", "prop": {
            "resolution": [64, 64], "tone_mapping": "aces", "serve": True, "port": 0,
            "preview_file": str(preview), "target_fps": 1000.0}}
        scene = lt.Scene.from_dict(d)
        film = scene.cameras[0].film
        try:
            host = film._server._httpd.server_address[0]
            img = lt.render(scene, device=device)["cornell.exr"]

            def get(path):
                url = f"http://127.0.0.1:{film._server.port}{path}"
                return urllib.request.urlopen(url, timeout=10).read()

            page, frame = get("/"), get("/frame.png")
            stats = json.loads(get("/stats.json"))
        finally:
            film._server.close()
        png = preview.read_bytes()
    check_image(img, 64, 64, "display")
    passes = scene.integrator.fused_passes
    ok = (host == "127.0.0.1" and b"luisarender_tpu live" in page
          and frame[:8] == png[:8] == b"\x89PNG\r\n\x1a\n" and stats["frame"] >= 1
          and film._spp_seen == 2)
    rec = {"phase": "display", "scene": "testing.cornell_box 64^2, 8 spp, display (aces)",
           "bound_host": host, "frame_png_bytes": len(frame), "preview_png_bytes": len(png),
           "stats": stats, "passes_seen": film._spp_seen, "fused_passes": passes}
    emit(rec)
    check(ok, f"display: {rec}")
    return rec


# --------------------------------------------------------------------------
# phase 14: participating media (megavpt)
# --------------------------------------------------------------------------

FOG_GOLDENS = {"fog": ROOT / "tests" / "golden" / "fog_32_8spp.exr",
               "fog_grid": ROOT / "tests" / "golden" / "fog_grid_32_8spp.exr"}
# scenes/fog.json's 256 spp cut to FOG_SPP, testing.fog_grid's to FOG_GRID_SPP
FOG_SPP = 16
FOG_GRID_SPP = 4
# the centre and a radius inside the fog sphere's 5,120 triangles
FOG_CENTER = (275.0, 180.0, 280.0)
FOG_INNER_RADIUS = 118.0


def vpt_record(torch, compiled, scene, img, seconds, counts, what):
    """A megavpt render's record: seconds (compile included), Mpaths/s,
    loop iterations and host reads a sample, one sample's wall and busy ms
    under the profiler, and its launches: the cluster kernels only, one
    closest and two any-hit launches (scatter-event and surface NEE) an
    iteration."""
    from luisarender_tpu_torch.integrators.mega_vpt import vpt_trace_batch
    from luisarender_tpu_torch.integrators.mega_path import pixel_grid

    cam, integ = scene.cameras[0], scene.integrator
    w, h = cam.film.resolution
    check_image(img, w, h, what)
    others = {k: v for k, v in counts.items() if k not in ("cluster_closest", "cluster_any")}
    check(counts["cluster_closest"] == integ.iterations_run > 0
          and counts["cluster_any"] == 2 * integ.iterations_run and not any(others.values()),
          f"{what}: launches {counts}, iterations {integ.iterations_run}")
    pxy = pixel_grid(w, h, compiled.device)
    t0 = time.perf_counter()
    prof = profile_one(torch, lambda: vpt_trace_batch(
        compiled, cam, integ.sampler, integ.light_sampler, pxy, 1, max_depth=integ.max_depth,
        rr_depth=integ.rr_depth, rr_threshold=integ.rr_threshold),
        ("cluster_closest_kernel", "cluster_any_kernel"), 1, device_only=True)
    # the profile's own cost: a sample before it, the traced one, the
    # aggregation
    prof["seconds"] = time.perf_counter() - t0
    paths = w * h * cam.spp
    return {"phase": "media", "scene": what, "resolution": [w, h], "spp": cam.spp,
            "depth": integ.max_depth, "triangles": compiled.plan.num_tris,
            "medium_types": [c.__name__ for c in compiled.plan.medium_types],
            "seconds": seconds, "paths": paths, "mpaths_per_s": paths / seconds / 1e6,
            "rays": integ.rays_traced, "iterations": integ.iterations_run,
            "iterations_per_sample": integ.iterations_run / cam.spp,
            "host_reads": integ.host_reads, "host_reads_per_sample": integ.host_reads / cam.spp,
            "launches": counts, "image_mean": float(img.mean()), "profile_one_sample": prof}


def fog_inputs(torch, lt, cluster, device, iterations=3):
    """The cluster kernels' inputs of the first `iterations` iterations of
    one scenes/fog.json sample at 512^2: each iteration's closest rays, and
    its any-hit calls in order (the scatter events' shadow rays, then the
    surface NEE's)."""
    from luisarender_tpu_torch import testing
    from luisarender_tpu_torch.integrators.mega_path import pixel_grid
    from luisarender_tpu_torch.integrators.mega_vpt import vpt_trace_batch

    scene = lt.Scene.from_dict(testing.fog((512, 512), 1, 10))
    compiled = lt.compile_scene(scene, device=device)
    cap = {"closest": [], "any": []}
    orig = cluster.closest, cluster.any_hit

    def rec(kind, fn):
        def call(*args):
            if len(cap["closest"]) <= iterations:
                cap[kind].append(tuple(a.clone() for a in args[:6]))
            return fn(*args)
        return call

    cluster.closest, cluster.any_hit = rec("closest", orig[0]), rec("any", orig[1])
    try:
        integ = scene.integrator
        vpt_trace_batch(compiled, scene.cameras[0], integ.sampler, integ.light_sampler,
                        pixel_grid(512, 512, device), 0, max_depth=integ.max_depth,
                        rr_depth=integ.rr_depth, rr_threshold=integ.rr_threshold)
    finally:
        cluster.closest, cluster.any_hit = orig
    torch.cuda.synchronize()
    return cap


def hold_fog_kernels(torch, lt, cluster, device):
    """The cluster kernels bit for bit against their plain versions on one
    fog sample's bounce-1 closest rays and on the scatter events' shadow
    rays of the iteration with the most of them (their origins inside the
    sphere, whose 5,120 triangles block no shadow ray); each with its time,
    plain time and bound."""
    cap = fog_inputs(torch, lt, cluster, device)
    center = torch.tensor(FOG_CENTER, device=device)
    scatter = [a for i, a in enumerate(cap["any"]) if i % 2 == 0]
    live = [int((a[3] > 0).sum()) for a in scatter]
    shadow = scatter[int(np.argmax(live))]
    inside = int(((shadow[3] > 0)
                  & ((shadow[0] - center).norm(dim=-1) < FOG_INNER_RADIUS)).sum())
    check(max(live) > 0 and inside > 0.9 * max(live),
          f"fog kernels: {live} live scatter shadow rays, {inside} inside the sphere")
    out = {}
    for kind, args, what in (("closest", cap["closest"][1], "bounce-1 rays"),
                             ("any", shadow, "scatter-event shadow rays")):
        any_hit = kind == "any"
        errs, frac, walk, visited, winners, _ = compare_cluster(torch, cluster, any_hit, args)
        err = torch.zeros(1, dtype=torch.int32, device=device)
        ms = device_ms(torch, lambda: cluster.launch(*args, any_hit, err), iters=20)
        check(int(err.item()) == 0, f"fog cluster_{kind}: error word while timing")
        plain_ms = events_ms(torch, lambda: cluster.walk_plain(*args, any_hit), iters=1)
        bound_ms, bound_by = cluster_bound(kind, args, walk, visited, winners)
        out[kind] = {"input": what, "n": int(args[0].shape[0]),
                     "live": int((args[3] > 0).sum()), "max_abs_err": max(errs),
                     "hit_fraction": frac, "walk": walk_summary(walk), "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
    out["any"]["origins_inside_sphere"] = inside
    return out


def phase_media(torch, lt, brute, fp, device):
    """Participating media on megavpt (integrators/mega_vpt.py): (i)
    scenes/fog.json through render_file (512^2, depth 10, spp cut from 256
    to FOG_SPP; 5,152 triangles on the cluster route) and (ii)
    testing.fog_grid (its sphere a 32^3 density grid, FOG_GRID_SPP spp)
    through render, each with the cluster kernels only (vpt_record); (iii)
    the 32^2 goldens of both; (iv) the cluster kernels bit for bit on one
    fog sample's inputs (hold_fog_kernels)."""
    import tempfile

    from luisarender_tpu_torch import testing
    from luisarender_tpu_torch.ops import cluster

    recs = {}
    # (i) the scene file through render_file; the scene it loads kept
    loaded = {}
    load_scene = lt.load_scene

    def keep(path, macros=None):
        loaded["scene"] = load_scene(path, macros)
        return loaded["scene"]

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "fog.json"
        path.write_text(json.dumps(testing.fog(spp=FOG_SPP)))
        lt.load_scene = keep
        try:
            reset_counts(brute, fp)
            t0 = time.perf_counter()
            img = lt.render_file(str(path), save=False, device=device)["fog.exr"]
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = read_counts(brute, fp)
        finally:
            lt.load_scene = load_scene
    scene = loaded["scene"]
    compiled = lt.compile_scene(scene, device=device)
    rec = vpt_record(torch, compiled, scene, img, seconds, counts, "scenes/fog.json")
    rec["cut"] = {"spp": [256, FOG_SPP]}
    recs["fog"] = rec
    emit(rec)

    # (ii) the grid
    scene = lt.Scene.from_dict(testing.fog_grid((512, 512), FOG_GRID_SPP, 10))
    img, seconds, counts = render_counted(torch, lt, brute, fp, scene, device)
    compiled = lt.compile_scene(scene, device=device)
    rec = vpt_record(torch, compiled, scene, img, seconds, counts, "testing.fog_grid")
    rec["grid_dims"] = list(compiled.arrays["density_grids"].shape[1:])
    recs["fog_grid"] = rec
    emit(rec)
    del compiled

    # (iii) the goldens, (iv) the kernels on fog inputs
    goldens = {}
    for name, path in FOG_GOLDENS.items():
        d = testing.fog((32, 32), 8, 10) if name == "fog" else testing.fog_grid((32, 32), 8, 10)
        img, seconds, counts = render_counted(torch, lt, brute, fp, lt.Scene.from_dict(d), device)
        goldens[name] = {"seconds": seconds, **golden_check(img, path, 32, 32, f"{name} golden")}
    recs["kernels"] = {"phase": "media", "what": "goldens and cluster kernels on fog inputs",
                       "goldens": goldens, **hold_fog_kernels(torch, lt, cluster, device)}
    emit(recs["kernels"])
    return recs


# --------------------------------------------------------------------------
# phase 15: the auxiliary integrators
# --------------------------------------------------------------------------

AUX_CORNELL = dict(resolution=(512, 512), spp=4, depth=5)
AUX_INTEGRATORS = {
    "normal": {"impl": "normal", "prop": {}},
    "direct_light": {"impl": "direct", "prop": {"importance_sampling": "light"}},
    "direct_surface": {"impl": "direct", "prop": {"importance_sampling": "surface"}},
    "direct_both": {"impl": "direct", "prop": {"importance_sampling": "both"}},
    "aov": {"impl": "aov", "prop": {"noisy_count": 4, "dump": "final", "depth": 5}},
    "group": {"impl": "group", "prop": {"integrators": [
        {"impl": "normal", "prop": {}}, {"impl": "direct", "prop": {}}]}},
}
# brute launches a sample: (closest, any-hit) of the integrators that trace
# a fixed number of rays
AUX_LAUNCHES = {"normal": (1, 0), "direct_light": (1, 1), "direct_surface": (2, 0),
                "direct_both": (2, 1), "group": (3, 1)}


def aux_scene(lt, name, res, spp, out_dir=None):
    from luisarender_tpu_torch import testing

    d = testing.cornell_box(resolution=res, spp=spp, depth=AUX_CORNELL["depth"])
    d["render"]["integrator"] = json.loads(json.dumps(AUX_INTEGRATORS[name]))
    if out_dir is not None:
        d["render"]["cameras"][0]["prop"]["file"] = str(Path(out_dir) / "cornell.exr")
    return lt.Scene.from_dict(d)


def phase_aux(torch, lt, brute, fp, device):
    """The auxiliary integrators (integrators/aux.py) on testing.cornell_box
    (AUX_CORNELL: 512^2, 4 spp; the brute kernels): normal, direct in each
    importance_sampling mode, aov in multi-buffer mode with the final dump
    into a temporary directory (every component's file written and read
    back), and a group of normal and direct, each with its seconds and
    brute launches and nothing else launched; then normal and direct at
    32^2 on the card against the port's CPU render by the goldens' rule."""
    import tempfile

    from luisarender_tpu_torch.utils import imageio

    recs = {}
    res, spp = AUX_CORNELL["resolution"], AUX_CORNELL["spp"]
    for name in AUX_INTEGRATORS:
        with tempfile.TemporaryDirectory() as tmp:
            scene = aux_scene(lt, name, res, spp, tmp)
            reset_counts(brute, fp)
            t0 = time.perf_counter()
            images = scene.integrator.render(lt.compile_scene(scene, device=device),
                                             save=name == "aov")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            counts = read_counts(brute, fp)
            rec = {"phase": "aux", "integrator": name, "resolution": list(res), "spp": spp,
                   "seconds": seconds, "images": len(images), "launches": counts}
            others = {k: v for k, v in counts.items() if k not in ("brute_closest", "brute_any")}
            check(not any(others.values()) and counts["brute_closest"] > 0,
                  f"aux {name}: launches {counts}")
            if name in AUX_LAUNCHES:
                want = tuple(spp * k for k in AUX_LAUNCHES[name])
                check((counts["brute_closest"], counts["brute_any"]) == want,
                      f"aux {name}: launches {counts}, want {want}")
            for path, img in images.items():
                check(img.shape[:2] == (res[1], res[0]) and bool(np.isfinite(img).all()),
                      f"aux {name}: {path} {img.shape}")
            if name == "aov":
                comps = scene.integrator.COMPONENTS
                check(len(images) == len(comps), f"aov: {sorted(images)}")
                for path, img in images.items():
                    check(np.array_equal(imageio.load_exr(path), img), f"aov: {path} on disk")
                rec["files"] = sorted(Path(p).name for p in images)
                rec["sample_mean"] = float(images[str(Path(tmp) / "cornell_sample.exr")].mean())
            else:
                img = images[scene.cameras[0].file]
                check(img.mean() > 0.0, f"aux {name}: the image is black")
                rec["image_mean"] = float(img.mean())
        recs[name] = rec
        emit(rec)

    held = {}
    for name in ("normal", "direct_light", "direct_surface", "direct_both"):
        card, cpu = (lt.render(aux_scene(lt, name, (32, 32), 8), device=dev)["cornell.exr"]
                     for dev in (device, "cpu"))
        frac, rel = frac_off(card, cpu), float(card.mean() / cpu.mean() - 1.0)
        held[name] = {"frac_pixels_off": frac, "mean_rel_diff": rel}
        check(frac < 0.02 and abs(rel) < 0.005,
              f"aux {name}: the card's 32^2 render {frac:.4f} off the CPU's, mean {rel:.5f}")
    recs["held"] = {"phase": "aux", "what": "32^2, 8 spp on the card against the CPU",
                    **held}
    emit(recs["held"])
    return recs


# --------------------------------------------------------------------------
# phase 16: the Monte Carlo variants
# --------------------------------------------------------------------------

# bench.py's long-tail configurations (bench.py:583-587) on
# testing.cornell_box at MC_RES^2, MC_SPP spp, depth 6, nothing cut
MC_CONFIGS = {
    "photon_cornell": {"impl": "megapm", "prop": {"depth": 6}},
    "pssmlt_cornell": {"impl": "pssmlt", "prop": {"depth": 6}},
    "gpt_cornell": {"impl": "gpt", "prop": {"depth": 4}},
}
MC_RES, MC_SPP = 128, 16
# the 32^2, 4-spp goldens (the reference's CPU renders) and their integrators
MC_GOLDENS = {
    "photon": ({"impl": "photon", "prop": {"depth": 6}},
               ROOT / "tests" / "golden" / "photon_32_4spp.exr"),
    "pssmlt": ({"impl": "pssmlt", "prop": {"depth": 6, "chains": 1024, "bootstrap": 4096}},
               ROOT / "tests" / "golden" / "pssmlt_32_4spp.exr"),
    "gpt": ({"impl": "gpt", "prop": {"depth": 4}},
            ROOT / "tests" / "golden" / "gpt_32_4spp.exr"),
}


def mc_scene(lt, integrator, res, spp):
    from luisarender_tpu_torch import testing

    d = testing.cornell_box(resolution=(res, res), spp=spp, depth=6)
    d["render"]["integrator"] = json.loads(json.dumps(integrator))
    return lt.Scene.from_dict(d)


def synced_ms(torch, fn):
    """(fn's result, its wall ms to a synchronize of the card)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def mc_parts(torch, compiled, scene, name):
    """Wall ms of one unit of each integrator's work, each part to a
    synchronize: photon, one iteration's emission, grid build, camera pass
    (its gather inside) and the gather alone; pssmlt, the bootstrap, a
    trace of the chains and a mutation step; gpt, one sample and the
    reconstruction."""
    from luisarender_tpu_torch.integrators.gpt import reconstruct_l2
    from luisarender_tpu_torch.integrators.mega_path import pixel_grid
    from luisarender_tpu_torch.integrators.pssmlt import MUTATION_SALT, PSSSampler

    integ, cam = scene.integrator, scene.cameras[0]
    pxy = pixel_grid(MC_RES, MC_RES, compiled.device)
    if name == "photon_cornell":
        radius = integ.radii(compiled, 1)[0]
        photons, emit = synced_ms(torch, lambda: integ._emit_photons(compiled, 0))
        grid, build = synced_ms(torch, lambda: integ._build_grid(compiled, photons))
        _, camera = synced_ms(torch, lambda: integ._camera_pass(
            compiled, cam, pxy, 0, grid, radius, integ.photons_per_iter))
        gen = torch.Generator(device=compiled.device).manual_seed(0)
        gp = torch.rand((pxy.shape[0], 3), device=compiled.device, generator=gen) * 500.0
        ns = torch.nn.functional.normalize(
            torch.randn(gp.shape, device=compiled.device, generator=gen), dim=-1)
        _, gather = synced_ms(torch, lambda: integ._gather(
            compiled, gp, ns, torch.ones_like(gp), gp[:, 0] >= 0, grid, radius,
            integ.photons_per_iter))
        valid = int(photons[3].sum())
        return {"emit_ms": emit, "grid_ms": build, "camera_pass_ms": camera,
                "gather_ms_uniform_points": gather, "photons_valid": valid,
                "cells": int((grid[0] >= 0).sum())}
    if name == "pssmlt_cornell":
        sampler = PSSSampler(integ.dims() - 2)
        (b, u), boot = synced_ms(torch, lambda: integ.bootstrap_chains(compiled, cam, sampler))
        state, trace = synced_ms(torch, lambda: (u, *integ.trace(compiled, cam, sampler, u)))
        splat = torch.zeros((MC_RES, MC_RES, 3), device=compiled.device)
        _, mutate = synced_ms(torch, lambda: integ.mutate_step(
            compiled, cam, sampler, splat, state, MUTATION_SALT))
        return {"bootstrap_ms": boot, "trace_ms": trace, "mutation_ms": mutate,
                "chains": integ.chains, "b": float(b)}
    stats = {}
    out, sample = synced_ms(torch, lambda: integ.sample(compiled, cam, pxy, 0, stats))
    img = out["radiance"].reshape(MC_RES, MC_RES, 3)
    _, recon = synced_ms(torch, lambda: reconstruct_l2(img, img, img))
    return {"sample_ms": sample, "iterations_a_sample": stats["iterations"],
            "reconstruct_ms": recon}


def mc_held_rays(torch, lt, brute, device):
    """The brute kernels' inputs of this slice's new ray distributions: the
    photon walk's first rays (65,536, their origins on the light) and
    GPT's 4N shifted camera rays (a 128^2 sample: 65,536 rays, the
    border's off the film)."""
    from luisarender_tpu_torch.integrators.mega_path import pixel_grid

    calls = []
    orig = brute.closest

    def rec(*args):
        calls.append(tuple(a.clone() for a in args))
        return orig(*args)

    cases = {}
    brute.closest = rec
    try:
        scene = mc_scene(lt, MC_CONFIGS["photon_cornell"], MC_RES, MC_SPP)
        compiled = lt.compile_scene(scene, device=device)
        scene.integrator._emit_photons(compiled, 0)
        cases["photon_first_rays"] = calls[0]
        calls.clear()
        scene = mc_scene(lt, MC_CONFIGS["gpt_cornell"], MC_RES, MC_SPP)
        compiled = lt.compile_scene(scene, device=device)
        scene.integrator.sample(compiled, scene.cameras[0], pixel_grid(MC_RES, MC_RES, device), 0)
        # the main path's camera rays, then the shifted paths'
        cases["gpt_shifted_camera_rays"] = calls[1]
    finally:
        brute.closest = orig
    light_y = 548.0  # testing.cornell_box's light quad
    o = cases["photon_first_rays"][0]
    check(o.shape[0] == 65536 and bool(((o[:, 1] - light_y).abs() < 0.1).all()),
          "montecarlo: the photon walk's first rays do not start on the light")
    check(cases["gpt_shifted_camera_rays"][0].shape[0] == 4 * MC_RES * MC_RES,
          "montecarlo: GPT's shifted camera rays are not 4N")
    return cases


def hold_mc_kernels(torch, lt, brute, device):
    """The brute closest kernel bit for bit against its plain version on
    mc_held_rays, with its time, plain time and bound."""
    out = {}
    for what, args in mc_held_rays(torch, lt, brute, device).items():
        errs, frac = compare_case(torch, brute, "closest", args)
        rows, ops = brute_work(torch, brute, "closest", *args)
        bound_ms, bound_by = kernel_bounds(torch, "closest", rows, ops, args[4])
        out[what] = {"n": int(args[0].shape[0]), "rows": int(args[4].shape[0]),
                     "max_abs_err": max(errs), "hit_fraction": frac,
                     "ms": device_ms(torch, lambda: brute.closest(*args), iters=20),
                     "plain_ms": events_ms(torch, lambda: brute.closest_plain(*args), iters=2),
                     "bound_ms": bound_ms, "bound_by": bound_by}
    return out


def mc_launches_ok(name, counts, integ, spp):
    """The brute kernels and nothing else, at the counts the integrator's
    loops give: photon, per iteration 5 emission bounces and 4 camera
    bounces (closest) and the camera bounces' NEE (any-hit); pssmlt,
    closest and any-hit once a bounce of each trace, never the fused
    kernel; gpt, per sample the main and shifted camera rays, then per loop
    iteration two closest and four any-hit traces."""
    others = {k: v for k, v in counts.items() if k not in ("brute_closest", "brute_any")}
    if any(others.values()):
        return False
    c, a = counts["brute_closest"], counts["brute_any"]
    if name == "photon_cornell":
        cam = min(integ.max_depth, 4)
        return c == spp * (integ.photon_depth + cam) and a == spp * cam
    if name == "pssmlt_cornell":
        traces = max(integ.bootstrap // integ.chains, 1) + 1 + integ.mutations_run
        return c == a and traces <= c <= traces * integ.max_depth
    return c == 2 * spp + 2 * integ.iterations_run and a == 4 * integ.iterations_run


def phase_montecarlo(torch, lt, brute, fp, device):
    """The Monte Carlo variants (integrators/megapm.py, pssmlt.py, gpt.py):
    bench.py's three long-tail configurations at MC_RES^2, MC_SPP spp,
    depth 6, each rendered twice and the second render timed as bench.py
    times it (seconds, Msamples/s), its launches the brute kernels'
    only (mc_launches_ok: no fused launch), one unit of its work in parts
    (mc_parts); the three 32^2 goldens on the card by the goldens' rule;
    the brute closest kernel on this slice's new rays (hold_mc_kernels)."""
    recs = {}
    for name, integ_d in MC_CONFIGS.items():
        scene = mc_scene(lt, integ_d, MC_RES, MC_SPP)
        compiled = lt.compile_scene(scene, device=device)
        scene.integrator.render(compiled)  # warms the allocator and the caches
        reset_counts(brute, fp)
        t0 = time.perf_counter()
        img = scene.integrator.render(compiled)[scene.cameras[0].file]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = read_counts(brute, fp)
        integ = scene.integrator
        check_image(img, MC_RES, MC_RES, name)
        check(mc_launches_ok(name, counts, integ, MC_SPP), f"{name}: launches {counts}")
        samples = MC_RES * MC_RES * MC_SPP
        rec = {"phase": "montecarlo", "config": name, "integrator": integ_d,
               "resolution": [MC_RES, MC_RES], "spp": MC_SPP, "seconds": seconds,
               "msamples_per_s": samples / seconds / 1e6, "launches": counts,
               "image_mean": float(img.mean())}
        if name == "pssmlt_cornell":
            rec.update({"chains": integ.chains, "mutations": integ.mutations_run,
                        "paths_traced": integ.paths_traced})
        if name == "gpt_cornell":
            rec["iterations"] = integ.iterations_run
        rec["parts"] = mc_parts(torch, compiled, scene, name)
        recs[name] = rec
        emit(rec)
        del compiled
    goldens = {}
    for key, (integ_d, path) in MC_GOLDENS.items():
        img, seconds, counts = render_counted(torch, lt, brute, fp,
                                              mc_scene(lt, integ_d, 32, 4), device)
        check(counts["fused_path"] == 0, f"{key} golden: launches {counts}")
        goldens[key] = {"seconds": seconds, **golden_check(img, path, 32, 32, f"{key} golden")}
    recs["kernels"] = {"phase": "montecarlo", "what": "goldens and brute kernels on new rays",
                       "goldens": goldens, "closest": hold_mc_kernels(torch, lt, brute, device)}
    emit(recs["kernels"])
    return recs


# --------------------------------------------------------------------------
# phase 17: differentiable rendering and the sharded pass
# --------------------------------------------------------------------------

ALBEDO_PATH = ("textures", "constant", "value")
ATLAS_PATH = ("texture_atlas",)
# bench.py's two gradient configurations (bench.py:208-238, 386-426)
GRAD_CONFIGS = {
    "grad_overhead": dict(res=(128, 128), spp=2, depth=4, remat=True, path=ALBEDO_PATH,
                          kernels=("brute_closest", "brute_any")),
    "grad_overhead_mesh": dict(res=(640, 360), spp=1, depth=4, remat=False, path=ATLAS_PATH,
                               kernels=("cluster_closest", "cluster_any")),
}
GRAD_CALLS = 3  # timed calls of each pass after a warm-up; the best is kept


def grad_scene(lt, name):
    from luisarender_tpu_torch import testing

    if name == "grad_overhead":
        return lt.Scene.from_dict(testing.cornell_box(resolution=(128, 128), spp=2, depth=4))
    return lt.Scene.from_dict(testing.mesh_heavy(res=(640, 360), spp=1, depth=4, accel="flat",
                                                 textured=True))


def diff_cornell(lt, device):
    """tests/test_diff.py's scene: testing.cornell_box(16^2, 4 spp, depth 3)."""
    from luisarender_tpu_torch import testing

    scene = lt.Scene.from_dict(testing.cornell_box(resolution=(16, 16), spp=4, depth=3))
    return scene, lt.compile_scene(scene, device=device)


def mean_grad(torch, compiled, scene, path, spp, depth, remat=True):
    """(image, d mean(image) / d path) of the differentiable pass."""
    from luisarender_tpu_torch.diff.render import get_in, make_render_fn

    render = make_render_fn(compiled, scene.cameras[0], scene.integrator, spp=spp,
                            max_depth=depth, remat=remat)
    v = get_in(compiled.arrays, path).clone().requires_grad_(True)
    img = render({path: v}, compiled.arrays)
    img.mean().backward()
    return img.detach(), v.grad


def diff_checks(torch, lt, device):
    """The 16^2 gradient with respect to the constant-texture table (spp 2,
    depth 3) on the card against the CPU's, each entry within 1% or 1e-5
    (tests/test_torch_diff.py's rule); tests/test_diff.py's checks on the
    card: finite, the walls' rgb non-negative, the finite differences of
    two entries within max(0.15 |fd|, 2e-4), emission linearity to rtol
    1e-3."""
    from luisarender_tpu_torch.diff.render import make_render_fn

    grads = []
    for dev in (device, torch.device("cpu")):
        scene, compiled = diff_cornell(lt, dev)
        grads.append(mean_grad(torch, compiled, scene, ALBEDO_PATH, 2, 3)[1].cpu().numpy())
    g, g_cpu = grads
    gap = np.abs(g - g_cpu)
    check(bool(np.all((gap <= 0.01 * np.abs(g_cpu)) | (gap <= 1e-5))),
          f"diff: the card's gradient is off the CPU's by {float(gap.max())}")
    check(bool(np.isfinite(g).all()) and bool((g[:, :3] >= -1e-6).all()) and g.max() > 1e-5,
          "diff: the gradient is not finite, or negative on a wall's rgb")
    scene, compiled = diff_cornell(lt, device)
    render = make_render_fn(compiled, scene.cameras[0], scene.integrator, spp=2, max_depth=3)
    base = compiled.arrays["textures"]["constant"]["value"]

    def loss(v):
        with torch.no_grad():
            return float(render({ALBEDO_PATH: v}, compiled.arrays).mean())

    fd = {}
    for idx in [(0, 0), (1, 0)]:
        up, down = base.clone(), base.clone()
        up[idx] += 1e-3
        down[idx] -= 1e-3
        fd[str(idx)] = (loss(up) - loss(down)) / 2e-3
        check(abs(fd[str(idx)] - g[idx]) <= max(0.15 * abs(fd[str(idx)]), 2e-4),
              f"diff: finite difference {idx} {fd[str(idx)]} against {g[idx]}")
    emis_row = int(torch.argmax(base[:, :3].amax(dim=1)))
    scale = torch.ones((), device=device, requires_grad=True)
    v = torch.cat([base[:emis_row], base[emis_row:emis_row + 1] * scale, base[emis_row + 1:]])
    total = render({ALBEDO_PATH: v}, compiled.arrays).sum()
    total.backward()
    lin = float(scale.grad) / float(total.detach()) - 1.0
    check(abs(lin) <= 1e-3, f"diff: emission linearity off by {lin}")
    return {"max_gap_to_cpu": float(gap.max()), "grad_max": float(g.max()),
            "finite_differences": fd, "emission_linearity_rel": lin}


def diff_recovery(torch, lt, device):
    """tests/test_diff.py::test_recover_albedo on the card: 48 Adam steps
    (lr 8e-2, bounds (0, 32)) from grey walls against a 4-spp target, by
    that test's criteria."""
    from luisarender_tpu_torch.diff.optimize import recover
    from luisarender_tpu_torch.diff.render import get_in, make_render_fn

    scene, compiled = diff_cornell(lt, device)
    cam, integ = scene.cameras[0], scene.integrator
    true_t = get_in(compiled.arrays, ALBEDO_PATH)
    with torch.no_grad():
        target = make_render_fn(compiled, cam, integ, spp=4, max_depth=3)(
            {ALBEDO_PATH: true_t}, compiled.arrays)
    true = true_t.cpu().numpy()
    init = true.copy()
    emis_row = int(np.argmax(init[:, :3].max(axis=1)))
    for i in range(init.shape[0]):
        if i != emis_row:
            init[i, :3] = 0.5
    (params, losses), ms = synced_ms(torch, lambda: recover(
        compiled, cam, integ, target, {ALBEDO_PATH: init}, spp=4, max_depth=3, steps=48,
        learning_rate=8e-2, param_bounds=(0.0, 32.0)))
    rec = params[ALBEDO_PATH].cpu().numpy()
    red, green = 4, 3
    ok = (losses[-1] < losses[0] * 0.1
          and np.allclose(rec[0, :3], true[0, :3], rtol=0, atol=0.05)
          and np.allclose(rec[emis_row, :3], true[emis_row, :3], rtol=0.05, atol=0)
          and np.argmax(rec[red, :3]) == 0 and np.argmax(rec[green, :3]) == 1
          and abs(rec[red, 0] - true[red, 0]) <= 0.1
          and abs(rec[green, 1] - true[green, 1]) <= 0.1)
    check(ok, f"diff: the 48-step recovery missed: losses {losses[0]} -> {losses[-1]}, "
              f"rows {rec[:, :3].tolist()}")
    return {"steps": 48, "seconds": ms / 1e3, "loss_first": losses[0], "loss_last": losses[-1],
            "white": rec[0, :3].tolist(), "red": rec[red, :3].tolist(),
            "green": rec[green, :3].tolist(), "emission": rec[emis_row, :3].tolist()}


def atlas_scatter_us(prof, shape):
    """Device us of the atlas gradient's scatter-adds in a profiled pass:
    the index_put_ ops (with accumulate: indexing's backward) whose first
    input has the atlas's shape, their kernels and children's."""
    names = ("aten::index_put_", "aten::_index_put_impl_")

    def hit(e):
        return e.name in names and bool(e.input_shapes) and list(e.input_shapes[0]) == shape

    return sum(e.device_time_total for e in prof.events()
               if hit(e) and not (e.cpu_parent is not None and hit(e.cpu_parent)))


def atlas_scatter(torch, compiled, fwd_bwd):
    """The atlas gradient's scatter-add in one pass: its device ms under
    torch.profiler (None where the profiler traces no device work), and a
    replay of the pass's gathered texels (textures/image.py atlas_gather,
    recorded) into a zero atlas by index_put_ with accumulate, wall ms
    between CUDA events (host dispatch included), and beside it the same
    sums by index_add_ on the flattened atlas (atomic adds, a sum order
    that varies from run to run; the port does not call it)."""
    from torch.profiler import ProfilerActivity, profile

    from luisarender_tpu_torch.textures import image

    atlas = compiled.arrays["texture_atlas"]
    calls = []
    orig = image.atlas_gather

    def rec(a, ys, xs):
        calls.append((ys.detach().long(), xs.detach().long()))
        return orig(a, ys, xs)

    image.atlas_gather = rec
    try:
        fwd_bwd()
    finally:
        image.atlas_gather = orig
    texels = sum(int(ys.numel()) for ys, _ in calls)
    check(texels > 0, "diff: the mesh configuration gathered no texel")
    gen = torch.Generator(device=atlas.device).manual_seed(0)
    grads = [torch.rand((*ys.shape, atlas.shape[-1]), device=atlas.device, generator=gen)
             for ys, _ in calls]

    def replay():
        out = torch.zeros_like(atlas)
        for (ys, xs), g in zip(calls, grads):
            out.index_put_((ys, xs), g, accumulate=True)
        return out

    replay_ms = events_ms(torch, replay, iters=5)
    rows = [(ys * atlas.shape[1] + xs).reshape(-1) for ys, xs in calls]

    def replay_add():
        out = torch.zeros_like(atlas).view(-1, atlas.shape[-1])
        for r, g in zip(rows, grads):
            out.index_add_(0, r, g.reshape(-1, atlas.shape[-1]))
        return out

    add = replay_add().view_as(atlas)
    ref = replay()
    add_err = float((add - ref).abs().max() / ref.abs().max())
    add_ms = events_ms(torch, replay_add, iters=5)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fwd_bwd()
        torch.cuda.synchronize()
    us = atlas_scatter_us(prof, list(atlas.shape))
    busy = sum(e.device_time_total for e in device_events(prof))
    return {"gathers": len(calls), "texels": texels, "atlas_shape": list(atlas.shape),
            "scatter_add_device_ms": us / 1e3 if busy else None,
            "pass_device_busy_ms": busy / 1e3 if busy else None,
            "scatter_add_replay_ms": replay_ms, "index_add_replay_ms": add_ms,
            "index_add_rel_err": add_err}


def grad_config(torch, lt, brute, fp, device, name, cfg):
    """One of bench.py's gradient configurations: the forward (no graph)
    and the forward plus backward of mean(image), each the best of
    GRAD_CALLS calls after a warm-up, to a synchronize; bench.py's
    grad_pass_overhead (t_f + t_fb) / t_f; the peak of allocated device
    memory in each; the trace kernels' launches in the forward and in the
    backward (with remat, the backward's recompute re-launches them)."""
    from luisarender_tpu_torch.diff.render import get_in, make_render_fn

    scene = grad_scene(lt, name)
    compiled, compile_s = timed_compile(torch, lt, scene, device)
    render = make_render_fn(compiled, scene.cameras[0], scene.integrator, spp=cfg["spp"],
                            max_depth=cfg["depth"], resolution=cfg["res"], remat=cfg["remat"])
    path = cfg["path"]
    base = get_in(compiled.arrays, path)

    def fwd():
        with torch.no_grad():
            return render({path: base}, compiled.arrays).mean()

    def fwd_bwd():
        v = base.detach().requires_grad_(True)
        render({path: v}, compiled.arrays).mean().backward()
        return v.grad

    def best(fn):
        fn()
        times = []
        for _ in range(GRAD_CALLS):
            _, ms = synced_ms(torch, fn)
            times.append(ms / 1e3)
        return min(times), times

    t_f, f_all = best(fwd)
    t_fb, fb_all = best(fwd_bwd)
    peaks = {}
    for key, fn in (("forward", fwd), ("forward_backward", fwd_bwd)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        fn()
        torch.cuda.synchronize()
        peaks[key] = torch.cuda.max_memory_allocated(device)
    v = base.detach().requires_grad_(True)
    reset_counts(brute, fp)
    img = render({path: v}, compiled.arrays)
    torch.cuda.synchronize()
    launches_f = read_counts(brute, fp)
    reset_counts(brute, fp)
    img.mean().backward()
    torch.cuda.synchronize()
    launches_b = read_counts(brute, fp)
    g = v.grad
    check_image(img.detach().cpu().numpy(), cfg["res"][0], cfg["res"][1], name)
    check(bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0.0,
          f"{name}: the gradient is not finite or is zero")
    bounces = cfg["spp"] * (cfg["depth"] + 1)
    others = [k for k in launches_f if k not in cfg["kernels"] and (launches_f[k] or launches_b[k])]
    check(not others, f"{name}: launches of {others}")
    for k in cfg["kernels"]:
        check(launches_f[k] == bounces, f"{name}: {launches_f[k]} {k} launches in the forward, "
                                        f"not {bounces}")
        check(0 < launches_b[k] <= bounces if cfg["remat"] else launches_b[k] == 0,
              f"{name}: {launches_b[k]} {k} launches in the backward")
    rec = {"phase": "diff", "config": name, "resolution": list(cfg["res"]), "spp": cfg["spp"],
           "depth": cfg["depth"], "remat": cfg["remat"], "path": list(path),
           "compile_seconds": compile_s, "forward_seconds": t_f,
           "forward_backward_seconds": t_fb, "forward_seconds_all": f_all,
           "forward_backward_seconds_all": fb_all,
           "grad_pass_overhead": (t_f + t_fb) / t_f, "forward_backward_over_forward": t_fb / t_f,
           "peak_allocated_bytes": peaks,
           "launches_forward": {k: launches_f[k] for k in cfg["kernels"]},
           "launches_backward": {k: launches_b[k] for k in cfg["kernels"]},
           "image_mean": float(img.detach().mean()), "grad_abs_sum": float(g.abs().sum())}
    if path == ATLAS_PATH:
        rec["atlas_scatter_add"] = atlas_scatter(torch, compiled, fwd_bwd)
    emit(rec)
    return rec


def free_port():
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def diff_sharded(torch, lt, device):
    """The sharded pass (parallel/render.py) in a one-rank NCCL group:
    render_sharded against the integrator's render of testing.cornell_box
    (32^2, 2 spp, depth 3) within rtol 1e-5 / atol 1e-6 (the reference's
    rule, tests/test_parallel.py), and make_sharded_grad_fn against
    l2_loss_fn's loss and gradient on one device."""
    import torch.distributed as dist

    from luisarender_tpu_torch import testing
    from luisarender_tpu_torch.diff.render import get_in, l2_loss_fn, make_render_fn
    from luisarender_tpu_torch.parallel.render import (
        make_mesh, make_sharded_grad_fn, render_sharded,
    )

    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(device)
        scene = lt.Scene.from_dict(testing.cornell_box(resolution=(32, 32), spp=2, depth=3))
        compiled = lt.compile_scene(scene, device=device)
        cam, integ = scene.cameras[0], scene.integrator
        img = render_sharded(compiled, cam, integ, mesh, spp=2).cpu().numpy()
        single = integ.render(compiled)[cam.file]
        check(np.allclose(img, single, rtol=1e-5, atol=1e-6),
              f"diff: render_sharded is off the render by {float(np.abs(img - single).max())}")
        target = np.random.default_rng(0).uniform(0.0, 0.3, (32, 32, 3)).astype(np.float32)
        base = get_in(compiled.arrays, ALBEDO_PATH)
        loss_s, grads_s = make_sharded_grad_fn(compiled, cam, integ, target, mesh, spp=2,
                                               max_depth=3)({ALBEDO_PATH: base}, compiled.arrays)
        v = base.clone().requires_grad_(True)
        render = make_render_fn(compiled, cam, integ, spp=2, max_depth=3)
        loss = l2_loss_fn(render, torch.as_tensor(target, device=device))({ALBEDO_PATH: v},
                                                                         compiled.arrays)
        loss.backward()
        g_s, g = grads_s[ALBEDO_PATH].cpu().numpy(), v.grad.cpu().numpy()
        check(np.allclose(float(loss_s), float(loss.detach()), rtol=1e-5, atol=0.0)
              and np.allclose(g_s, g, rtol=1e-4, atol=1e-7),
              f"diff: the sharded loss / gradient is off one device's by "
              f"{abs(float(loss_s) - float(loss.detach()))} / {float(np.abs(g_s - g).max())}")
        return {"ranks": mesh.size(), "backend": dist.get_backend(),
                "image_max_abs_diff": float(np.abs(img - single).max()),
                "loss_rel_diff": float(loss_s) / float(loss.detach()) - 1.0,
                "grad_max_abs_diff": float(np.abs(g_s - g).max())}
    finally:
        dist.destroy_process_group()


def phase_diff(torch, lt, brute, fp, device):
    """Differentiable rendering and the sharded pass (diff/, parallel/):
    diff_checks, diff_recovery, bench.py's two gradient configurations
    (grad_config) and diff_sharded."""
    t0 = time.perf_counter()
    recs = {"checks": diff_checks(torch, lt, device)}
    recs["recovery"] = diff_recovery(torch, lt, device)
    emit({"phase": "diff", "what": "16^2 gradient, checks and the 48-step recovery",
          **{k: recs[k] for k in ("checks", "recovery")}})
    for name, cfg in GRAD_CONFIGS.items():
        recs[name] = grad_config(torch, lt, brute, fp, device, name, cfg)
    recs["sharded"] = diff_sharded(torch, lt, device)
    emit({"phase": "diff", "what": "the sharded pass, one NCCL rank", **recs["sharded"],
          "phase_seconds": time.perf_counter() - t0})
    return recs


# --------------------------------------------------------------------------
# phase 18: the command line and the tools
# --------------------------------------------------------------------------

TUNGSTEN_GOLDEN = ROOT / "tests" / "golden" / "tungsten_converted_48x32_8spp.exr"
# scenes/cornell.luisa's spp on the command line (--spp), and the macro that
# the file defines, overridden with -D
LUISA_CLI_SPP = 32
LUISA_CLI_DEFINE = "light_scale=2"


def cli_counted(torch, brute, fp, argv):
    """luisarender_tpu_torch.cli.main(argv) on the card (no device: its
    default), with every kernel count set to 0 just before and read just
    after; returns (printed paths, seconds, counts, the load, compile and
    render seconds it reports)."""
    import contextlib
    import io
    import re

    from luisarender_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    reset_counts(brute, fp)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts(brute, fp)
    check(rc == 0, f"cli {argv}: exit code {rc}")
    text = err.getvalue()
    parts = {}
    for key, pattern in (("load_seconds", r"scene loaded in ([0-9.]+)s"),
                         ("compile_seconds", r"compiled .* in ([0-9.]+)s"),
                         ("render_seconds", r"rendered in ([0-9.]+)s")):
        m = re.search(pattern, text)
        check(m is not None, f"cli {argv}: no '{pattern}' in its output: {text!r}")
        parts[key] = float(m.group(1))
    parts["compiled_line"] = re.search(r"compiled .*", text).group(0)
    return out.getvalue().split(), seconds, counts, parts


def tungsten_inputs(d):
    """tests/test_golden.py test_golden_tungsten_converted's Tungsten scene
    (a .wo3 floor, a rough copper sphere, a quad light; 48 x 32, 8 spp,
    4 bounces) written into directory d; returns its scene file."""
    import struct

    pos = np.array([[-2, 0, -2], [2, 0, -2], [2, 0, 2], [-2, 0, 2]], np.float32)
    nrm = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    tris = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    verts = np.concatenate([pos, nrm, uv], axis=1).astype(np.float32)
    quads = np.concatenate([tris, np.zeros((tris.shape[0], 1), np.int32)], axis=1)
    with open(d / "floor.wo3", "wb") as f:
        f.write(struct.pack("<Q", pos.shape[0]))
        f.write(verts.tobytes())
        f.write(struct.pack("<Q", tris.shape[0]))
        f.write(quads.tobytes())
    tscene = {
        "renderer": {"spp": 8},
        "integrator": {"type": "path_tracer", "max_bounces": 4},
        "camera": {"transform": {"position": [0, 1.5, -4.0], "look_at": [0, 0.3, 0],
                                 "up": [0, 1, 0]},
                   "resolution": [48, 32], "fov": 60},
        "bsdfs": [{"name": "white", "type": "lambert", "albedo": 0.7},
                  {"name": "metal", "type": "rough_conductor", "material": "Cu",
                   "roughness": 0.3}],
        "primitives": [
            {"type": "mesh", "file": "floor.wo3", "bsdf": "white"},
            {"type": "sphere", "transform": {"position": [0, 0.5, 0], "scale": 0.5},
             "bsdf": "metal"},
            {"type": "quad", "transform": {"position": [0, 3.0, 0], "scale": [2.0, 1.0, 2.0]},
             "emission": [6.0, 6.0, 6.0], "bsdf": "white"},
        ],
    }
    (d / "scene.json").write_text(json.dumps(tscene))
    return d / "scene.json"


@contextmanager
def no_fused():
    """The general fork for the body (LUISARENDER_TPU_NO_FUSED, which
    ops/fused_path.py use_fused reads at every call)."""
    os.environ["LUISARENDER_TPU_NO_FUSED"] = "1"
    try:
        yield
    finally:
        os.environ.pop("LUISARENDER_TPU_NO_FUSED", None)


def phase_tools_tungsten(torch, lt, brute, fp, device, d):
    """(c) of phase_tools: the Tungsten golden's scene converted by the
    port's tungsten2scene and rendered on the card by both routes."""
    from luisarender_tpu_torch.integrators.mega_path import (
        general_path_trace_batch, path_trace_batch, pixel_grid,
    )
    from luisarender_tpu_torch.tools import tungsten2scene
    from luisarender_tpu_torch.utils import imageio

    t0 = time.perf_counter()
    doc = tungsten2scene.convert(str(tungsten_inputs(d)), str(d / "converted.json"))
    convert_seconds = time.perf_counter() - t0
    ref = imageio.load_exr(str(TUNGSTEN_GOLDEN))
    rec = {"phase": "tools", "scene": "tests/test_golden.py's Tungsten scene through "
           "tools/tungsten2scene.py", "resolution": [48, 32], "spp": 8, "depth": 5,
           "cut": None, "convert_seconds": convert_seconds}

    # the general fork against the golden at tests/test_golden.py _check's
    # tolerance: the reference's general fork on the CPU made the golden
    scene = lt.Scene.from_dict(doc)
    with no_fused():
        img_g, seconds_g, counts_g = render_counted(torch, lt, brute, fp, scene, device)
    integ = scene.integrator
    check_image(img_g, 48, 32, "tungsten general fork")
    others = {k: v for k, v in counts_g.items() if k not in ("brute_closest", "brute_any")}
    check(integ.fused_passes == 0 and counts_g["brute_closest"] == integ.bounces_run > 0
          and 0 < counts_g["brute_any"] <= integ.bounces_run and not any(others.values()),
          f"tungsten general fork: launches {counts_g}, bounces {integ.bounces_run}")
    mad, mx = float(np.abs(img_g - ref).mean()), float(np.abs(img_g - ref).max())
    check(mad < 2e-5 and mx < 2e-3, f"tungsten general fork: mean |d| {mad}, max {mx}")
    rec["general"] = {"seconds": seconds_g, "launches": counts_g, "bounces": integ.bounces_run,
                      "mean_abs_diff_vs_golden": mad, "max_abs_diff_vs_golden": mx,
                      "image_mean": float(img_g.mean())}
    # the kernels the general fork reaches (the brute kernels: 4 triangles
    # and a sphere) on its first two bounces' rays, bit for bit
    compiled = lt.compile_scene(scene, device=device)
    check(compiled.plan.fused_path and compiled.plan.num_tris == 4
          and compiled.plan.num_spheres == 1,
          f"tungsten: plan fused {compiled.plan.fused_path}, {compiled.plan.num_tris} "
          f"triangles, {compiled.plan.num_spheres} spheres")
    cap = capture_main_path_inputs(torch, brute, compiled, scene, max_depth=2)
    rec["general"]["kernels"] = hold_brute_inputs(torch, brute, cap)
    del cap

    # the default route: the gaussian filter sends it to the fused kernel's
    # ray-input mode; held as the fused goldens are held
    scene = lt.Scene.from_dict(doc)
    img_f, seconds_f, counts_f = render_counted(torch, lt, brute, fp, scene, device)
    integ, cam = scene.integrator, scene.cameras[0]
    check_image(img_f, 48, 32, "tungsten default route")
    others = {k: v for k, v in counts_f.items() if k != "fused_path_rays"}
    check(fp.camgen_params(cam, integ.sampler.seed) is None
          and counts_f["fused_path_rays"] == integ.fused_passes == 8
          and not any(others.values()),
          f"tungsten default route: launches {counts_f}")
    rel = float(img_f.mean() / ref.mean() - 1.0)
    check(abs(rel) < 0.005, f"tungsten default route: mean off the golden by {rel:.5f}")
    pxy = pixel_grid(48, 32, device)
    kw = dict(max_depth=integ.max_depth, rr_depth=integ.rr_depth,
              rr_threshold=integ.rr_threshold)
    acc, per_sample = 0.0, []
    for si in range(8):
        args = (compiled, cam, integ.sampler, integ.light_sampler, pxy, si)
        rgb_f, _, st_f = path_trace_batch(*args, with_stats=True, **kw)
        rgb_g, _, st_g = general_path_trace_batch(*args, **kw)
        rays_f, rays_g = int(st_f["rays"]), int(st_g["rays"])
        off = frac_off(rgb_f.cpu(), rgb_g.cpu())
        per_sample.append(off)
        check(st_f["fused"] == 1, f"tungsten sample {si}: not on the fused fork")
        check(abs(rays_f - rays_g) <= max(8, rays_g // 500),
              f"tungsten sample {si}: rays {rays_f} vs {rays_g}")
        check(off < 0.02, f"tungsten sample {si}: {off:.4f} of pixels off")
        acc = acc + rgb_g.cpu().numpy()
    frac_general = frac_off((acc / 8).reshape(32, 48, 3), ref)
    check(frac_general < 0.02, f"tungsten: general samples {frac_general:.4f} off the golden")
    # the ray-input kernel on the first sample, bit for bit
    tables = fp.fused_tables(compiled)
    rays, _, _ = ray_inputs(fp, compiled, scene, pxy, 0, integ.max_depth)
    out_k = fp.paths_rays(tables, rays, **kw)
    torch.cuda.synchronize()
    out_p, work, plain_ms = fused_work(torch, fp, tables, None, pxy, 0, kw, rays=rays)
    share, err, _ = bit_equal(torch, "fused rays tungsten", out_k[0], out_k[1], out_p[0],
                              out_p[1])
    rec["default"] = {"seconds": seconds_f, "launches": counts_f, "rays": integ.rays_traced,
                      "mean_rel_diff_vs_golden": rel,
                      "frac_pixels_off_vs_golden": frac_off(img_f, ref),
                      "frac_pixels_off_per_sample_vs_general": per_sample,
                      "general_samples_frac_off_golden": frac_general,
                      "kernel": {"n": pxy.shape[0], "share_bit_equal": share,
                                 "max_abs_err": err, "plain_ms": plain_ms,
                                 "ms": device_ms(torch, lambda: fp.paths_rays(tables, rays, **kw),
                                                 iters=20),
                                 **fused_bound(tables, work, pxy.shape[0], rays=True)}}
    emit(rec)
    return rec


def phase_tools(torch, lt, brute, fp, device):
    """The command-line renderer and the tools (cli.py, tools/): (a)
    cli.main on scenes/cornell.json at its own 512^2, depth 8, 256 spp, the
    card by default, its EXR bit-equal with render_file's and 256 fused
    launches, nothing else; (b) the same on scenes/cornell.luisa with -D
    LUISA_CLI_DEFINE and --spp LUISA_CLI_SPP; (c) phase_tools_tungsten; (d)
    tools/tonemap.py tonemap_image of (a)'s image on the card against the
    CPU within 1e-6, each operator, and tonemap.main to a PNG."""
    import contextlib
    import io
    import tempfile

    from luisarender_tpu_torch.tools import tonemap
    from luisarender_tpu_torch.utils import imageio

    t_phase = time.perf_counter()
    recs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        d = Path(tmp)
        # (a) and (b)
        for key, scene_file, extra, spp, macros in (
                ("cornell_json", MAIN_SCENE, [], None, None),
                ("cornell_luisa", LUISA_SCENE,
                 ["-D", LUISA_CLI_DEFINE, "--spp", str(LUISA_CLI_SPP)], LUISA_CLI_SPP,
                 dict([LUISA_CLI_DEFINE.split("=", 1)]))):
            out = d / f"{key}.exr"
            argv = [str(scene_file), "-o", str(out)] + extra
            printed, seconds, counts, parts = cli_counted(torch, brute, fp, argv)
            scene = lt.load_scene(str(scene_file), macros)
            if spp is not None:
                scene.cameras[0].spp = spp
            want = spp or scene.cameras[0].spp
            others = {k: v for k, v in counts.items() if k != "fused_path"}
            check(printed == [str(out)] and counts["fused_path"] == want
                  and not any(others.values()), f"cli {key}: printed {printed}, launches {counts}")
            img = imageio.load_exr(out)
            # render_file of the same file; --spp has no render_file form
            images = (lt.render_file(str(scene_file), macros, save=False, device=device)
                      if spp is None else lt.render(scene, device=device))
            ref = images[scene.cameras[0].file]
            check_image(img, 512, 512, f"cli {key}")
            check(img.dtype == ref.dtype and np.array_equal(img, ref),
                  f"cli {key}: its EXR differs from render's image by up to "
                  f"{float(np.abs(img - ref).max())}")
            recs[key] = {"phase": "tools", "what": f"cli.main {' '.join(argv[1:])}",
                         "scene": str(scene_file.relative_to(ROOT)), "resolution": [512, 512],
                         "depth": scene.integrator.max_depth, "spp": want,
                         "cut": None if spp is None else {"spp": [256, spp]},
                         "seconds": seconds, **parts, "launches": counts,
                         "bit_equal_render": True, "image_mean": float(img.mean())}
            emit(recs[key])
            if key == "cornell_json":
                cli_img, cli_exr = img, out
        # (c)
        recs["tungsten"] = phase_tools_tungsten(torch, lt, brute, fp, device, d)
        # (d)
        tm = {}
        for op in ("none", "uncharted2", "aces"):
            for exposure in (0.0, -1.0):
                t0 = time.perf_counter()
                on_card = tonemap.tonemap_image(cli_img, op, exposure)
                card_ms = (time.perf_counter() - t0) * 1e3
                on_cpu = tonemap.tonemap_image(cli_img, op, exposure, device="cpu")
                err = float(np.abs(on_card - on_cpu).max())
                check(on_card.shape == cli_img.shape and bool(np.isfinite(on_card).all())
                      and err <= 1e-6, f"tonemap {op} {exposure}: card vs CPU {err}")
                tm[f"{op}_{exposure}"] = {"max_abs_diff_vs_cpu": err, "card_ms": card_ms}
        png = d / "tonemapped.png"
        with contextlib.redirect_stdout(io.StringIO()):
            tonemap.main([str(cli_exr), str(png), "--tonemap", "aces"])
        check(imageio.png_rgba8(png).shape == cli_img.shape[:2] + (4,),
              "tonemap.main: no PNG of (a)'s size")
        recs["tonemap"] = {"phase": "tools", "what": "tools/tonemap.py on (a)'s image",
                           "operators": tm}
        emit(recs["tonemap"])
    emit({"phase": "tools", "phase_seconds": time.perf_counter() - t_phase})
    return recs


def main():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: chip_smoke.py runs on a CUDA card")
    sys.path.insert(0, str(ROOT))
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch.accel import native
    from luisarender_tpu_torch.ops import brute, build, cluster, subpacket, trace, wide8
    from luisarender_tpu_torch.ops import fused_path as fp

    device = torch.device("cuda:0")
    card_kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi_line()
    emit({"phase": "card", "kind": card_kind, "count": count, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    sources = sorted(p.stem for p in build.CSRC_DIR.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=len(sources) + 1) as pool:
        jobs = [pool.submit(build.compile_library, src) for src in sources]
        jobs.append(pool.submit(native._load))  # g++, the SAH builder
        for job in jobs:
            job.result()
    emit({"phase": "build", "sources": sources + ["bvh_builder.cpp"],
          "seconds": time.perf_counter() - t0,
          "ptxas": {src: build.ptxas_report(src) for src in sources},
          "fused_path_dynamic_smem_bytes": fp.pool_bytes(),
          "fused_path_blocks_per_sm": fp.blocks_per_sm(device),
          "fused_path_blocks_per_sm_by_mode": {
              f"env={e},rays={r}": fp.blocks_per_sm(device, env=e, rays=r)
              for e in (False, True) for r in (False, True)}})

    brute_k = phase_brute_kernels(torch, lt, brute, device)
    fused_k = phase_fused_kernel(torch, lt, fp, device)
    fused_env = phase_fused_env(torch, lt, fp, device)
    fused_rays = phase_fused_rays(torch, lt, fp, device)
    compiled_mh, cap_mh = mesh_heavy_inputs(torch, lt, cluster, device)
    cluster_k = phase_cluster_kernels(torch, cluster, device, compiled_mh, cap_mh)
    mods = {"cluster": cluster, "wide8": wide8, "subpacket": subpacket, "trace": trace}
    tree_k = phase_tree_kernels(torch, mods, device, compiled_mh, cap_mh)
    # the twolevel phase traces phase 4's rays on the flat tables too
    tr_mh = compiled_mh.arrays["trace"]
    flat_trace = {"closest": [c[:4] for c in cap_mh["closest"]],
                  "any": [a[:4] for a in cap_mh["any"]],
                  "nodes": tr_mh["cluster_nodes"], "tris": tr_mh["cluster_tris"],
                  "slot_inst": tr_mh["shade_table"][:, 31].to(torch.int32)}
    del compiled_mh, cap_mh, tr_mh
    torch.cuda.empty_cache()
    main_recs = phase_main(torch, lt, brute, fp, device, flat_trace)
    del flat_trace
    general = phase_general(torch, lt, brute, fp, device)
    phase_profile(torch, lt, device)
    phase_golden(torch, lt, device)
    spectral = phase_spectral(torch, lt, brute, fp, device)
    textures = phase_textures(torch, lt, brute, fp, device, main_recs)
    surfaces = phase_surfaces(torch, lt, brute, fp, device)
    samplers = phase_samplers(torch, lt, brute, fp, device, spectral)
    wavefront = phase_wavefront(torch, lt, brute, fp, device, main_recs)
    phase_display(torch, lt, device)
    media = phase_media(torch, lt, brute, fp, device)
    aux = phase_aux(torch, lt, brute, fp, device)
    montecarlo = phase_montecarlo(torch, lt, brute, fp, device)
    diff = phase_diff(torch, lt, brute, fp, device)
    tools = phase_tools(torch, lt, brute, fp, device)

    entries = []
    for name, kind_key, line in (("brute_closest", "closest", 79),
                                 ("brute_any", "any", 101)):
        t = brute_k[kind_key]["times"]["bounce1"]
        entries.append({
            "name": name, "route": "cuda",
            "source": "luisarender_tpu_torch/csrc/brute.cu",
            "replaces": f"luisarender_tpu/ops/brute_pallas.py:{line}",
            "launches": general["launches"][name],
            # the hero spectral Cornell render's: one a bounce
            "launches_spectral": spectral["cornell"]["launches"][name],
            # the sky.json render's: one a bounce
            "launches_sky": textures["sky"]["launches"][name],
            # the coated Cornell box's: one a bounce
            "launches_coated": surfaces["coated"]["launches"][name],
            # scenes/cornell.json's under zsobol: one a bounce
            "launches_samplers": samplers["zsobol"]["launches"][name],
            # the auxiliary integrators' 512^2 renders together (phase 15)
            "launches_aux": sum(r["launches"][name] for k, r in aux.items() if k != "held"),
            # bench.py's long-tail renders, 128^2, 16 spp (phase 16)
            "launches_montecarlo": {k: montecarlo[k]["launches"][name] for k in MC_CONFIGS},
            # bench.py's grad_overhead (128^2, 2 spp, depth 4, remat): one a
            # bounce in the forward, the recompute's in the backward
            "launches_diff": {"forward": diff["grad_overhead"]["launches_forward"][name],
                              "backward": diff["grad_overhead"]["launches_backward"][name]},
            # the Tungsten golden's scene on the general fork, 48 x 32, 8 spp
            "launches_tungsten": tools["tungsten"]["general"]["launches"][name],
            "max_abs_err": brute_k[kind_key]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    mat = fused_k["materials.json"]
    for name, rec, launches in (
        ("fused_path", mat, main_recs["materials"]["launches"]["fused_path"]),
        ("fused_path_persistent", mat["persistent"],
         main_recs["megawave"]["launches"]["fused_path_persistent"]),
        ("fused_path_env", fused_env["spherical"],
         main_recs["env_cornell"]["launches"]["fused_path_env"]),
        ("fused_path_rays", fused_rays["thinlens"],
         main_recs["rays_cornell"]["launches"]["fused_path_rays"]),
        ("fused_path_rays_env", fused_rays["env_thinlens"],
         main_recs["rays_env_cornell"]["launches"]["fused_path_rays_env"]),
    ):
        entries.append({
            "name": name, "route": "cuda",
            "source": "luisarender_tpu_torch/csrc/fused_path.cu",
            "replaces": "luisarender_tpu/ops/fused_path.py:742",
            "launches": launches,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": None,
        })
        if name == "fused_path":
            # scenes/cornell.luisa's render (one a sample) and the
            # motion-blur render's (one a sample of each shutter bucket)
            entries[-1].update({"launches_luisa": surfaces["luisa"]["launches"][name],
                                "launches_motion": surfaces["motion"]["launches"][name],
                                # the command line's renders: cornell.json at
                                # its 256 spp, cornell.luisa at --spp 32
                                "launches_cli": {k: tools[k]["launches"][name]
                                                 for k in ("cornell_json", "cornell_luisa")}})
        if name == "fused_path_persistent":
            # the wavepath render of bench.py's Cornell box: one a tile
            entries[-1]["launches_wavefront"] = wavefront["cornell"]["launches"][name]
        if name == "fused_path_env":
            # the environment mode (fused_path.py has_env): the candidates
            # and the miss pass run beside the kernel
            entries[-1].update({"mode": "env", "candidates_ms": rec["candidates_ms"],
                                "candidates_device_ms": rec["candidates_device_ms"],
                                "miss_pass_ms": rec["miss_pass_ms"],
                                "miss_pass_device_ms": rec["miss_pass_device_ms"]})
        if name == "fused_path_rays":
            # the Tungsten golden's scene on its default route (a gaussian
            # filter): one a sample
            entries[-1]["launches_tungsten"] = tools["tungsten"]["default"]["launches"][name]
        if name.startswith("fused_path_rays"):
            # the ray-input mode (fused_path.py cam is None): the camera
            # rays are made beside the kernel
            entries[-1].update({"mode": "rays" + ("_env" if "env" in name else ""),
                                "camera_ms": rec["camera_ms"],
                                "camera_device_ms": rec["camera_device_ms"]})
            if "miss_pass_ms" in rec:
                entries[-1].update({"miss_pass_ms": rec["miss_pass_ms"],
                                    "miss_pass_device_ms": rec["miss_pass_device_ms"]})
    for name, kind_key in (("cluster_closest", "closest"), ("cluster_any", "any")):
        t = cluster_k[kind_key]["times"]["bounce1"]
        entries.append({
            "name": name, "route": "cuda",
            "source": "luisarender_tpu_torch/csrc/cluster.cu",
            "replaces": "luisarender_tpu/ops/cluster_pallas.py:339",
            "launches": main_recs["mesh_heavy"]["launches"][name],
            # the two-level render's launches: one a visible instance a bounce
            "launches_twolevel": main_recs["mesh_heavy_twolevel"]["launches"][name],
            # the hero mesh-heavy render's: one a bounce
            "launches_spectral": spectral["mesh_heavy"]["launches"][name],
            # the textured mesh-heavy render's: one a bounce
            "launches_textured": textures["mesh_heavy"]["launches"][name],
            # the wavepath mesh-heavy render's: one an iteration of the pool
            "launches_wavefront": wavefront["mesh_heavy"]["launches"][name],
            # scenes/fog.json's megavpt render: closest one an iteration, any
            # two (scatter-event and surface NEE); and testing.fog_grid's
            "launches_media": media["fog"]["launches"][name],
            "launches_media_grid": media["fog_grid"]["launches"][name],
            # bench.py's grad_overhead_mesh (640 x 360, 1 spp, depth 4, no
            # remat): one a bounce in the forward, none in the backward
            "launches_diff": {
                "forward": diff["grad_overhead_mesh"]["launches_forward"][name],
                "backward": diff["grad_overhead_mesh"]["launches_backward"][name]},
            "max_abs_err": cluster_k[kind_key]["max_abs_err"],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
        })
    for name, modes, replaces in TREE_KERNELS:
        for mode in modes:
            key = f"{name}_{mode}"
            t = tree_k[key]["times"]["bounce1"]
            # launches on the renders of the scene on the route that takes it
            # (the trace kernel is on no render's route, as in the reference)
            route = main_recs.get(f"mesh_heavy_{name}", main_recs["mesh_heavy"])
            entries.append({
                "name": key, "route": "cuda",
                "source": f"luisarender_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": route["launches"][key],
                "max_abs_err": tree_k[key]["max_abs_err"],
                "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": None,
            })
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": card_kind, "count": count}})


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
