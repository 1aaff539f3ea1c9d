#!/usr/bin/env python3
"""Time builds of the fused whole-path kernel's source against each other on
one CUDA card, with the committed build among them.

    python3 fused_ab.py [NAME=PATH.cu ...]

Each PATH is a CUDA source with csrc/fused_path.cu's C interface: another
design of the kernel, or the source of an earlier commit (unpacked with `git
archive` into a git-ignored directory). A library that exports
`fused_path_env_words` takes the interface of this tree (the environment
mode's candidate and escape pointers, the work counter and counters); one
that does not, the interface before the environment mode (work counter and
counters). The environment mode is not timed here: chip_smoke.py's fused
phase times it.
`committed` is csrc/fused_path.cu. Every build runs on one 512^2 sample of
scenes/materials.json (depth 10) and scenes/cornell.json (depth 8), on a
pass of 4 samples of each (persistent mode), and on a pass of chip_smoke.py's
megawave render (testing.cornell_box, 1024^2, depth 5, 4 samples a launch).
Per case it prints a JSON line:
each build's agreement with the plain version (lanes bit-equal, rays equal),
its device times in turns (the builds in order, then in reverse), its
counters where it has them (chip_smoke.py lane_use), the plain version's
path-length SIMT share and the bounds (chip_smoke.py fused_bound). The
lines also go to chiprun_out/fused_ab.json.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent


# (label, scene file, depth, modes): the chip_smoke.py fused phase's cases,
# and a pass of the megawave render of chip_smoke.py's main phase
# (testing.cornell_box at 1024^2, depth 5, 4 samples a launch)
MEGAWAVE = ROOT / "chiprun_out" / "megawave_1024.json"
BOTH = (("megapath", 0), ("persistent", 4))
CASES = (
    ("materials.json", ROOT / "scenes" / "materials.json", 10, BOTH),
    ("cornell.json", ROOT / "scenes" / "cornell.json", 8, BOTH),
    ("cornell_box 1024^2 megawave pass", MEGAWAVE, 5, (("persistent", 4),)),
)


def build_all(build, sources):
    """{name: (ctypes library, ptxas report)}, built in parallel into
    _build/ab/."""
    def one(item):
        name, src = item
        key = hashlib.sha256(src.read_bytes() + " ".join(build.NVCC_FLAGS).encode())
        out = build.BUILD_DIR / "ab" / f"lib{name}-{key.hexdigest()[:12]}.so"
        if not out.exists():
            build.compile_source(src, out)
        report = build.parse_ptxas(out.with_suffix(".ptxas.txt").read_text())
        return name, (ctypes.CDLL(str(out)), report)

    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        return dict(pool.map(one, sources.items()))


def launcher(torch, fp, lib, tables, cam, pxy, ns, kw):
    """A function (stats=None) -> (rgb, rays) that launches `lib` once."""
    ptr = ctypes.c_void_p
    env_iface = hasattr(lib, "fused_path_env_words")
    # the tables, pixels and outputs, with the environment mode's pointers
    # where the interface has them, the work counter and the counters; then
    # the device and the stream
    lib.fused_path.argtypes = [ptr] * (14 if env_iface else 12) + [ctypes.c_int, ptr]
    lib.fused_path.restype = ctypes.c_int
    dev = pxy.device
    n = pxy.shape[0]
    prm = fp.params(tables, cam, n, 0, ns, **kw)
    ptrs, sph = fp.table_ptrs(tables)
    work = torch.empty((1,), dtype=torch.int32, device=dev)

    def run(stats=None):
        rgb = torch.empty((n, 3), dtype=torch.float32, device=dev)
        rays = torch.empty((n,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        extra = (work.data_ptr(), None if stats is None else stats.data_ptr())
        if env_iface:
            outs = (None, rgb.data_ptr(), rays.data_ptr(), None)
        else:
            outs = (rgb.data_ptr(), rays.data_ptr())
        err = lib.fused_path(ctypes.addressof(prm), pxy.data_ptr(), *ptrs, *outs, *extra,
                             dev.index or 0, stream)
        if err != 0:
            raise RuntimeError(f"fused_path launch failed: CUDA error {err}")
        return rgb, rays

    run.keep = sph
    return run


def main(argv):
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fused_ab.py: no CUDA device")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import luisarender_tpu_torch as lt
    from luisarender_tpu_torch import testing
    from luisarender_tpu_torch.ops import build
    from luisarender_tpu_torch.ops import fused_path as fp

    sources = {"committed": build.CSRC_DIR / "fused_path.cu"}
    for arg in argv:
        name, _, path = arg.partition("=")
        sources[name] = Path(path).resolve()
    device = torch.device("cuda:0")
    MEGAWAVE.parent.mkdir(exist_ok=True)
    MEGAWAVE.write_text(json.dumps(testing.cornell_box(
        resolution=(1024, 1024), spp=32, depth=5, integrator="megawave")))
    smi = cs.nvidia_smi_line()
    libs = build_all(build, sources)
    lines = [{"card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "ptxas": {k: v[1] for k, v in libs.items()},
              "blocks_per_sm": {k: (v[0].fused_path_blocks_per_sm(0, 0)
                                    if hasattr(v[0], "fused_path_env_words")
                                    else v[0].fused_path_blocks_per_sm(0))
                                for k, v in libs.items()}}]
    cs.emit(lines[0])
    names = list(libs)
    for label, path, depth, modes in CASES:
        tables, cam, pxy, kw = cs.fused_case(torch, lt, fp, path, depth, device)
        for mode, ns in modes:
            (rgb_p, rays_p), counts, _ = cs.fused_work(torch, fp, tables, cam, pxy, ns, kw)
            runs = {k: launcher(torch, fp, libs[k][0], tables, cam, pxy, ns, kw) for k in names}
            rec = {"scene": label, "mode": mode, "n": pxy.shape[0], "depth": depth,
                   "samples": ns or 1, "work": counts,
                   **cs.fused_bound(tables, counts, pxy.shape[0]), "builds": {}}
            for k in names:
                rgb, rays = runs[k]()
                torch.cuda.synchronize()
                b = {"share_bit_equal": float((rgb == rgb_p).all(-1).float().mean()),
                     "max_abs_err": float((rgb - rgb_p).abs().max()),
                     "lanes_rays_differ": int((rays != rays_p).sum()), "ms": []}
                stats = torch.zeros(len(fp.STATS), dtype=torch.int64, device=device)
                runs[k](stats)
                b["lane_use"] = cs.lane_use(stats)
                rec["builds"][k] = b
            for order in (names, names[::-1]):
                for k in order:
                    rec["builds"][k]["ms"].append(
                        cs.device_ms(torch, runs[k], iters=20 if ns == 0 else 10))
            cs.emit(rec)
            lines.append(rec)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "fused_ab.json").write_text("\n".join(json.dumps(x) for x in lines) + "\n")


if __name__ == "__main__":
    main(sys.argv[1:])
