#!/usr/bin/env python3
"""Time chip_smoke.py's kernel phases (brute, fused, cluster and tree
kernels) of one checkout on one CUDA card; prints each kernel's ms on one
line of JSON that starts with "AB ".

    python3 kernels_ab.py TREE

TREE is the root of a checkout: this one, or an earlier commit unpacked
with `git archive` into a git-ignored directory. The kernels, chip_smoke.py
and the package are all imported from TREE. To compare two commits, run
parent, change, change, parent in one command on the same card.
"""
import json
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

root = Path(sys.argv[1]).resolve()
sys.path.insert(0, str(root))
import torch  # noqa: E402
import chip_smoke as cs  # noqa: E402
import luisarender_tpu_torch as lt  # noqa: E402
from luisarender_tpu_torch.accel import native  # noqa: E402
from luisarender_tpu_torch.ops import brute, build, cluster, subpacket, trace, wide8  # noqa: E402
from luisarender_tpu_torch.ops import fused_path as fp  # noqa: E402

assert Path(cs.__file__).resolve().parent == root and Path(lt.__file__).resolve().parent.parent == root
dev = torch.device("cuda:0")
sources = sorted(p.stem for p in build.CSRC_DIR.glob("*.cu"))
with ThreadPoolExecutor(len(sources) + 1) as pool:
    jobs = [pool.submit(build.compile_library, s) for s in sources] + [pool.submit(native._load)]
    for j in jobs:
        j.result()
t0 = time.perf_counter()
out = {}
bk = cs.phase_brute_kernels(torch, lt, brute, dev)
for kind in ("closest", "any"):
    out[f"brute_{kind}"] = bk[kind]["times"]["bounce1"]["ms"]
    out[f"brute_{kind}_sample"] = bk[kind]["sample_ms"]
fk = cs.phase_fused_kernel(torch, lt, fp, dev)
out["fused_path"] = fk["materials.json"]["ms"]
out["fused_path_persistent"] = fk["materials.json"]["persistent"]["ms"]
out["fused_path_env"] = cs.phase_fused_env(torch, lt, fp, dev)["spherical"]["ms"]
fr = cs.phase_fused_rays(torch, lt, fp, dev)
out["fused_path_rays"], out["fused_path_rays_env"] = fr["thinlens"]["ms"], fr["env_thinlens"]["ms"]
comp, cap = cs.mesh_heavy_inputs(torch, lt, cluster, dev)
ck = cs.phase_cluster_kernels(torch, cluster, dev, comp, cap)
for kind in ("closest", "any"):
    out[f"cluster_{kind}"] = ck[kind]["times"]["bounce1"]["ms"]
mods = {"cluster": cluster, "wide8": wide8, "subpacket": subpacket, "trace": trace}
tk = cs.phase_tree_kernels(torch, mods, dev, comp, cap)
for key, rec in tk.items():
    if isinstance(rec, dict) and "times" in rec:
        out[key] = rec["times"]["bounce1"]["ms"]
print("AB " + json.dumps({"root": str(root), "seconds": time.perf_counter() - t0, "ms": out}),
      flush=True)
